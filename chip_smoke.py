#!/usr/bin/env python3
"""Smoke test of dicp_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

0. device: a CUDA device is required (no CPU continuation); prints the card's
   name and power limit; checks that float32 matmuls run in full precision.
1. build: compiles the CUDA kernels of the checkout, one nvcc per source, all
   started together (csrc/tiled_nn.cu, cluster_search.cu, cluster_topk.cu,
   fused_gn.cu, score_nn.cu, threefry.cu (D1, the Gumbel draw), and
   graph_while.cu, the WHILE node's condition kernel and plumbing);
   prints K1's -Xptxas=-v report.
2. K1 against its plain PyTorch version on the card, bit for bit: indices and
   squared distances identical, at the main path's shapes and at edge cases
   (a duplicated nearest target split across K1's target-slice boundary, m
   not a multiple of the slice or stage width, fewer targets than slices,
   targets that are not 16-byte aligned); timed; and the share of (warp,
   query slot, 32-target chunk) triples in which some lane would find a new
   best, the re-scan rate of a chunked argmin, at the main path's shape.
3. the reference contract on the dense tier: the 65-point pair of tests/data
   at B=256, pt2pl, dim 2, trim 5, huber 1, tol 1e-6, f32; transform error
   against the known truth < 1e-3.
4. the main path at real size on the kernel tier: 8 pairs of a synthetic
   LiDAR-like scene, 12,288 source points against 16,000 target points with
   normals, pt2pl, dim 3; every pair's rotation and translation error < 1e-3,
   and K1 launched at least once per Gauss-Newton iteration.
5. the cluster kernels' -Xptxas=-v reports (K2 and K5: csrc/cluster_search.cu;
   K3: csrc/cluster_topk.cu), which must show no register spills, and K3's
   launch geometry at the cluster tier's block for each list length
   (warps, queries per warp, bound slices, staging, registers).
6. K2 and K5 against their plain PyTorch versions on the card, bit for bit
   (best, row, bound) at the two raw-scan shapes and at edge cases (among
   them a duplicated candidate split across K2's column-slice boundary, g = 7
   served by 4-byte copies, points that are not 16-byte aligned, g = 2000 in
   three staging passes, a NaN target point and a NaN query, which must leave
   their queries uncertified); timed; then a subprocess launches K2 with a
   group id outside [0, G) and must fail with a CUDA error (the kernel's
   __trap).
7. K3 against its plain version, bit for bit (d2, rows, bound), at 100k x
   100k (k = 16, 1, 2, 5, 32) and at edge cases: duplicated points across
   group boundaries, k beyond a query's finite candidates (the column-0
   fill), g = 7, g = 2000 (slabs read from global memory), points that are
   not 16-byte aligned, a NaN target point and a NaN
   query (held to the plain version as phase 6 holds K2), and what only the
   warp schedule can get wrong: a tie with the k-th entry that the
   nearest-box-first order reaches later in a lower column, every lane's
   queue full in the same step, fewer candidates than lanes, g = 37, k = 32
   with exactly 32 finite candidates, P = 40 (two chunks of groups); a
   subprocess launches K3 with a group id outside [0, G) and must fail with
   a CUDA error.  Timed call by call and back to back.
8. the single-pair raw-scan path: weighted PCA normals of a 100,000-point map
   (median angle to the exact normals < 2 deg), cluster k-NN normals (K3),
   and ICP.icp of the map's points, permuted and moved, through the cluster
   tier (K2 at least once per iteration; rotation and translation errors
   < 1e-3); then cluster_nn(use_pallas=True) (K5) equal to the K2 path.
9. batched raw scans: 8 pairs of 50,000 -> 60,000 points through the cluster
   tier; every pair's errors < 1e-3, K2 launched.
10. the whole-solve kernel K4's -Xptxas=-v report (csrc/fused_gn.cu, built in
    phase 1 with the others), which must show no register spills, and its
    launch geometry (lanes per point, threads, registers) at phase 11's two
    main shapes.
11. K4 against its plain version on the same card tensors: the headline's
    configuration (the reference pair at B=256, pt2pl, dim 2, trim 5,
    huber 1, tol 1e-6), the gate's largest shape (256 pairs of 256 -> 512
    points of the LiDAR-like scene, pt2pl, dim 3) and edge cases (pt2pt dim 3
    cauchy, prior weights with zeros, B=5, n=1, the trim loss at steepness 2,
    every loss with pt2pl dim 3 and with pt2pt dim 2, n=256 with m=512 at
    dim 2, m=1, n and m not multiples of the lane split); convergence,
    iterations and matched ratio equal, T within 1e-5, pc within 1e-4, two
    launches identical.  Timed call by call and back to back against the
    plain version, and the forward A/B: register(fused_small=True) against
    the loop, alternated in one process.
12. the headline path: the reference pair at B=256 through register_ift with
    K4 as the forward, value sum(T) and its gradient with respect to the
    sources; transform error < 1e-3, gradients finite and nonzero, cosine
    with the unrolled gradient > 0.99, K4 launched once per call.  Timed
    (registrations per second) alternated with the IFT on the loop forward
    and with the unrolled gradient, on dicp_tpu_torch.bench's clock
    (bench.time_alternated); phase 22 prints bench_suite's batch256 rows
    from these times.

13. the score-form 1-NN kernels K6 and K7 (csrc/score_nn.cu, built in phase 1):
    their -Xptxas=-v report, which must show no register spills, then each
    against its plain version on the same card tensors, bit for bit (indices
    and scores): 4096 x 4096 at every (tq, tm) of the A/B table, one
    100k x 100k call each, m < tm, m not a multiple of tm, K6 at tm not a
    multiple of 4 (4-byte copies), n = 1, n not a multiple of tq, duplicated
    targets (ties to the first copy), f64 inputs, a NaN target point (held
    to the plain version with that point out of reach: the kernels skip its
    column, the plain versions drop its target tile) and a NaN query
    ((inf, 0)).  Timed at 100k x 100k, call by call and back to back.
14. the A/B entry point itself, ``dicp_tpu_torch.benchmarks.exp_knn.main()``:
    v0 (K1), v1 (K6) and v2 (K7) correct within the tie tolerance at
    4096 x 4096 against an f64 argmin, then the seven rows timed at
    100k x 100k in this process.
15. Gumbel soft NN on the card: ICP.icp with use_gumbel=True at the headline
    configuration (the reference pair at B=256) with a seeded generator,
    finite with transform error < 0.5; one streamed gumbel_nn at phase 4's
    8 x 12,288 -> 16,000 shape, finite and inside the targets' bounding box,
    and equal to hard NN on a well-separated lattice at tau = 1e-3.
17. LiDAR odometry over raw scans (benchmarks/bench_suite.py:585-660): 64
    lidar_scene scans of 60,000 points moved along a constant step, written
    as .bin files and read back through ScanDataset(max_points=61440,
    workers=4, prefetch=4); pt2pt, trim 1, Huber 0.5, 30 iterations, tol
    1e-5, the cluster tier.  stream_odometry at W = 1 warm, W = 8 warm and
    cold (f32) and W = 1 warm quantized and weightless (pads replaced by real
    rows): frames/s (median of 3 runs after one) and rel err, <= 1e-4 (f32)
    and <= 1e-3 (quantized), K2 launched on every pair; W = 1 warm again
    with the scans read before the run (what ScanDataset in the loop
    costs); the 63 pairs in one
    batched odometry call (iterations and convergence equal to the cold
    W = 8 stream's, transforms within 1e-5; peak memory); K2 against its
    plain version bit for bit (best, row, bound) on the arguments of the
    first and last K2 call of each f32 stream's first run and of a batched
    odometry call, recorded as the solver passed them: padded targets, whose
    zero rows form groups of radius 0 at the origin, and the source pads as
    queries on them; the pose graph with
    loop closures (i, i+8) (ATE < 1e-3, two calls bit-equal); resume from a
    checkpoint (within 1e-5 of one shot); voxel_downsample of one scan (two
    calls bit-equal, the count equal to numpy's); pt2pt_svd_icp on the
    reference pair at B=256 (error < 1e-3) and the 180-degree Kabsch case in
    f64; the host preprocessing time per scan.
18. scan-to-map odometry at the JAX suite's deployment (benchmarks/
    bench_suite.py:688-840, no cut): 12 scans of a +-20 m wavy 60,000-point
    surface along a constant step against a 65,536-row fused voxel map
    (voxel 0.25; pt2pl, trim 2, Huber 0.5, 30 iterations, tol 1e-6, the
    cluster tier), run by dicp_tpu_torch.benchmarks.bench_suite's host loop,
    which prints its scan_to_map_60k, _sgd and _sgd_sub rows.
    scan_to_map_odometry with gn, sgd (2,048 per
    mini-batch, 30 iterations, a fixed seed), sgd with merge_subsample
    20,000, and quantized gn: frames/s (median of 3 runs after one, poses
    fetched), final-pose error and ATE against the exact truth, iterations
    and K2 launches per scan; gates: every scan converged, ATE < 1e-3 (gn),
    < 5e-3 (sgd), < max(5 x gn's, 2e-3) (quantized), four same-seed sgd
    runs bit-equal, K2 on every gn scan and never on the sgd path, whose
    mini-batches D2 draws on the card from JAX's per-scan keys.  K2
    against its plain version bit for bit on the first and last K2 call of
    the gn stream, whose targets hold groups of the map's sentinel rows (a
    gate).  A mature map built by map_step: at most 65,536 occupied rows,
    its empty rows beyond the occupied box; map_step with insert=True and
    insert=False and map_merge of one scan alone (CUDA events, median of 5).
    map_step and map_merge are captured programs, so these are the
    captured times (phase 24 times the eager forms beside them).
19. GICP and the multiscale pyramid at the JAX suite's deployments, run by
    dicp_tpu_torch.benchmarks.exp_gicp and exp_multiscale, which print their
    rows.  GICP
    (benchmarks/exp_gicp.py:27-100): B = 64 pairs of a 600-point saddle
    (seed 11), register_gicp (30 iterations, tol 1e-6; no kernel: a dense
    600 x 600 block per pair) timed and its error < 1e-3; the same-shape
    pt2pt register for the cost ratio; register_gicp_ift forward and
    backward, its gradient finite, nonzero and of cosine > 0.99 with the
    unrolled differentiable=True gradient; the f32 ~50 m radius case of
    tests/test_gicp.py:190 finite with error < 5e-4.  The pyramid
    (benchmarks/exp_multiscale.py:27-120): bench_suite's 100,000-point
    three-plane scene from the FAR init, pt2pl, trim 2, Huber 1, the cluster
    tier; single scale (40 iterations, tol 1e-5) against the pyramid (a 1 m,
    4,096-slot dense level of 15 iterations at tol 1e-3 and trim 8, then
    full resolution): ms per registration (CUDA events, median of 5 after
    one), both errors < 1e-3, level iterations and K2 launches per call;
    K2 against its plain version bit for bit on the first and last K2 call
    of the pyramid's full-resolution level.
20. closed-loop SLAM at real scan size: tests/test_slam.py:54-98's circuit
    (a 5 m circle, scan radius 6 m, noise 0.04, seed 3) with 60,000-point
    f32 scans drawn without replacement from a 1,000,000-point world, 2
    laps of 32 scans (65), the test's configuration with slam_odometry's
    default 8,192-row map: the front end on the tiled tier (K1), each
    closure against a 60,000-row anchor on the cluster tier (K2).  Frames/s
    (65 / wall s, refined poses fetched; median of 3 after one run),
    accepted closures of the attempts, front and refined ATE (align=False),
    the median closure error; ms per map_step, _closure_solve and
    refine_robust in the first run (CUDA events); K1 launches per scan and
    K2 per closure attempt.  Gates: a closure accepted, each with gap >= 24
    and ratio >= 0.5; median closure error < 0.03; refined ATE <= front ATE
    + 1e-3; K1 and K2 bit-equal to their plain versions on the first and
    last call of each recorded by the stream (K1's first target holds the
    map's empty rows, all on its sentinel: exact ties); a half lap accepts
    no closure.  Then refine_robust's first call in a fresh process
    (functorch's first use) against its second.  The front end's
    map_step, the closures, the anchors and the residual norms are
    captured programs: these are the captured stream's numbers, and K1 and
    K2 are held to their plain versions on the captured path's calls
    (phase 24 holds the run to an eager one).
21. dicp_tpu_torch.parallel in a world of one rank on NCCL (make_mesh((1, 1))
    on the card; the backend must be nccl; the group is destroyed at the
    end), eager and captured in one phase: each solve's eager call held to
    its reference, then its program to the eager call as phase 24 holds
    its cases (collectives counted apart: map_sharded_fn's fixed trip runs
    max_iterations masked steps, each with its all-reduce, K2 in run-once
    nodes), then eager against captured in turns.  register_map_sharded at phase 8's pair
    (converged, errors < 1e-3, T within 1e-4 of register's, K2 once per
    iteration and once in the final cost pass, bit-equal to its plain
    version on the eager call's first and last launch, iterations + 1
    all-reduces of <= 87 elements, max_iterations + 1 per replay;
    sharded_fused=False gives the same iterations and T within 1e-4);
    register_map_sharded_ift's forward captured and its gradient of
    sum(T * probe) into the source (the forward a replay: equal to the
    eager forward's bit for bit, finite, nonzero, cosine > 0.99 with the
    unrolled gradient; the collectives the backward adds);
    register_ring_sharded at phase 4's first pair (within 1e-5 of the dense
    map-sharded T, no kernel); register_batch_sharded at phase 9's batch
    (T bit-equal to register's, K2 launched, no collective; register_jit
    captured); the partitioned pose graph's program on phase 20's
    front-end graph (within 1e-4 of pose_graph_optimize) and
    refine_robust(mesh=...) (captured equal to eager over two calls; its
    positions within 1e-2 of the dense refine, ATE within 5%).
22. the headline bench entry, the suite and the examples:
    dicp_tpu_torch.bench.main() in this process (its gates, its JSON line);
    every row of dicp_tpu_torch.benchmarks.bench_suite.ALL at the JAX
    suite's sizes that no earlier phase measures (batch256 printed from
    phase 12's times, scan_to_map's step rows only, solvers' exp_sgd and AA
    rows), each printing its JSON line and raising on its gate; the four
    examples' main() with their checks; the kernels' launches per row and
    example; K1, K2 and K3 held to their plain versions bit for bit on the
    first two calls of each recorded from the large_cloud row, K4 with phase
    11's gates on the first two recorded from the capacity row; then
    utils.profiling.benchmark and trace (the trace must name K4's kernel)
    and visualization.plot_overlay of card tensors (where matplotlib is
    installed).  Each row's and example's seconds are printed.
23. (run after 22) the captured programs of dicp_tpu_torch.jit: register_jit
    at phases 3, 4, 8 and 9's solves, the headline unit captured forward and
    backward (bench.fwdbwd_jit) and the pipeline's window solve, each held
    to the eager port bit for bit in every field (T, pc, the histories,
    iterations, convergence, matched ratio; value and gradient) over two
    replays of one capture and the replay of a second, every replay under
    torch's sync debug mode "error" (a host wait raises) and launching each
    kernel as often as the eager call, with the first call's cost (the
    eager warm-up and the capture) beside the eager call's; phase 3's pair
    with batch_chunk=3 (86 device loops in one program); the W = 8 stream's
    relative poses, iterations, convergence and composed poses against the
    stream on register's eager loop; the same stream fed from host scans
    under "error", counting the windows enqueued while the previous one
    still ran (at least one); then eager against captured in turns: ms per
    call at phases 3, 4, 8 and 9, the headline unit's registrations/s, and
    frames/s of the W = 1 and W = 8 warm streams; each cached program's
    private pool memory.  Each of phases 3, 4, 8 and 9's solves and the
    headline unit also replays on fresh inputs of the same shapes
    (the source moved by seeded noise), held to a fresh eager call.
24. (run after 23) Anderson, map_step/map_merge, SLAM's closure programs
    and SVD-ICP captured (dicp_tpu_torch.jit), each against its eager form
    (jit.disable_jit, the solves on register's eager loop) as phase 23
    holds its cases, a replay on fresh inputs included: the bits of the
    capture repairs (Anderson's solve_ex at (256, m, m), its energy
    sentinel, _kabsch's seeds, se3._homogeneous's last row); Anderson m=3
    on the suite's pt2pt pair (register_anderson_jit), phase 4's slice
    (K1) and phase 9's batch (K2) through register_jit, and
    batch256_ift_aa_m3's forward (register_ift_jit) and unit
    (bench.fwdbwd_jit); each of the 11 steps of phase 18's gn stream, f32
    and quantized, through the captured map_step against the eager step,
    two captured streams against the eager one, map_merge alone at that
    size (its eager form run under sync debug mode "error"), and a stream
    whose scan length changes every scan (first-call costs, pools);
    _closure_solve (K2), _make_anchor, _edge_residual_norms and a SLAM
    front-end map_step (K1), and one SLAM lap of phase 20's circuit with
    captured programs against one with eager programs (trajectories,
    closures); pt2pt_svd_icp on the svd_pair inputs, early exit
    and fixed trip; K1 and K2 held to their plain versions on the captured
    Anderson solves' and map_step's own calls; then eager against captured
    in turns: ms per call, frames/s of the scan-to-map streams and of one
    SLAM lap.
25. (run after 24) batched odometry, the dense pose graph, GICP and SGD-ICP
    captured, each against its eager form as phase 24 holds its cases:
    odometry (one program: the batched solve's WHILE node and the prefix
    product) on phase 17's 64 raw scans (63 pairs, K2; the fresh input
    keeps the zero-row pads) and on bench_suite's odometry_64scans (dense
    tier; its ATE gate); pose_graph_optimize on phase 20's graph (25
    iterations unrolled) and refine_robust's two IRLS passes (a call from
    an empty cache captures once and replays for the second pass);
    register_gicp_jit at exp_gicp's batch with a 3-column target (normals
    inside the program) and with normals given; register_sgd_jit at
    exp_sgd's two rows with an int seed (D2 draws the mini-batches inside
    the program; the host's part of a captured call and of its key work
    printed) and at the 20k row with an explicit SeededSampler(0) (its
    plan's indices drawn before each call; no D2 launch); each step of
    phase 18's SGD stream through the captured
    map_step(solver="sgd"), four captured streams bit-equal to the eager
    one with phase 18's gates (ATE < 5e-3, no K2); one 'adam' and one 'sgd'
    step on the card bit-equal to the CPU's f32 step on the same plan; K2
    held to its plain version on the captured odometry call; then eager
    against captured in turns (refine_robust also as a one-shot captured
    call from an empty cache), the host's share of each captured SGD call,
    and the SGD stream's frames/s.
26. (run after 25) D2 (csrc/threefry.cu's randint) against its plain
    version bit for bit at a device iteration (exp_sgd's (1, 1024) and
    (1, 2048) rows, an (8, 512) batch, n = 2**31 - 1, a ragged shape, a
    span of 1), timed call by call and back to back through its wrapper
    and inside a CUDA graph of 100 launches, beside its plain version and
    its bound; the Gumbel solve on JAX's threefry streams captured,
    against its eager form as phase 24 holds its cases:
    register_jit(use_gumbel=True) at phase 15's headline (a new
    key, as a fresh input and as a key tensor, replays the one program;
    transform error < 0.5) and the draw of one iteration captured alone
    (its share of the captured solve); the streamed gumbel_nn at phase 4's
    shape; the same threefry draws on the card and on the CPU, bit for bit;
    then eager against captured in turns.  Since D1 these Gumbel cases
    draw through csrc/threefry.cu.
27. (run after 26) the unrolled gradient captured and the draw kernel D1:
    D1 against its plain version bit for bit (f32, f64) at the dense Gumbel
    block (256, 65, 65), a streamed chunk (8, 12,288, 1,365), counters past
    int32 and one stream over a whole shape, then one row of 2**32 + 8,192
    elements against the plain arithmetic on windows at 0, 2**31 and 2**32
    (the counter's high word); D1 timed call by call and back to back
    beside its plain version and its bound.  The captured unrolled units,
    each held to its uncaptured run as phase 24 holds its cases (a replay
    on fresh inputs too): bench.unrolled_jit at the headline (B = 256,
    dense tier), the same gradient through ICP.icp, bench.unrolled_jit at
    phase 4's shape (tiled tier: K1 once per executed step, held to its
    plain version on the uncaptured unit's first and last launch) and the
    Gumbel headline's unrolled gradient with an int key (D1 twice per
    executed step: the forward and the backward's recomputed step); a
    Gumbel solve that exits early (a skipped step draws nothing).
    Launches per replay, first-call cost, pools against the eager peak,
    eager against captured in turns.
28. (run after 27) .backward() through captured programs (jit's program
    pairs: a forward replay attached to the caller's inputs, a captured
    backward that .backward() replays): register_ift_jit at the headline
    (K4), register_jit(differentiable=True) at phase 3's and phase 4's
    shapes (K1), ICP.icp, register_gicp_jit(differentiable=True) at
    exp_gicp's row, register_sgd_jit(differentiable=True) at exp_sgd's
    20k row (D2 twice per executed step), the Gumbel headline's unrolled
    gradient into source and
    target (D1 twice per executed step) and the cluster tier at phase 8's
    pair (K2), each held bit for bit to the same call under disable_jit()
    in every output, the loss and every gradient (the Gumbel target
    gradient within 1e-5 of its largest entry): the first call, fresh
    inputs, two forwards with their backwards in reverse order, and a
    retained second backward, every replay under the sync debug mode's
    "error".  Then GICP's, SGD-ICP's (on a key, and on SeededSampler(0)'s
    drawn plan with no D2 launch) and the cluster tier's fixed trips
    inside one program held to the host loop as phase 24 holds its cases
    (K2 held to its plain version on the host loop's first and last
    launch; the cluster solve's certified share); eager against captured in turns,
    first-call cost, launches per replay, pools against the eager peak,
    and the headline's .backward() beside bench.fwdbwd_jit.  Then second
    derivatives: the Hessian-vector product of the headline
    (register_ift_jit, K4) and of phase 4's first pair
    (register_jit(differentiable=True), K1, 12 steps), each by a double
    backward through its program pair (the call's VJP a jitted call of its
    own: eager at its first sighting, a program pair from its second) and
    inside one program that calls torch.autograd.grad twice, bit-equal to
    disable_jit() in every output, the gradient and the HVP (the unrolled
    HVP's captured trip held to the forced trip, whose second-order sums
    group as the capture's), fresh inputs, no host wait, launches per
    replay, first-call cost, pools, then eager, pair and in-program in
    turns, all with the deterministic kernels.  Then, in an
    NCCL world of one, the map-sharded gradients at phase 8's pair (K2):
    register_map_sharded by .backward() through its program pair
    (map_sharded_fn's, the fixed trip split at its all-reduces) and inside
    one program that calls torch.autograd.grad, and
    register_map_sharded_ift the same two ways (its backward captured),
    each bit-equal to its uncaptured run (fresh inputs, no host wait), with
    K2 launches and collectives per replay (the unrolled forward
    max_iterations + 1 all-reduces, its backward max_iterations + a
    constant, the IFT backward a constant), first-call cost, pools, and
    eager against captured in turns.  In the same world, the ring's
    unrolled gradient at phase 4's first pair: register_ring_sharded
    differentiated into its source and its sharded target (the reverse
    ring), by .backward() through map_sharded_fn's program pair and inside
    one program, the same way (the target gradient finite and nonzero; a
    ring of one sends nothing).
16. (run after 17-28) a torch.profiler pass over 3 calls each of phases
    4 (captured, through ICP.icp, and eager register), 8 and 9 (captured),
    12 (eager and captured), one W = 1 warm stream of phase 17's first 9
    scans (captured windows and eager windows), one gn scan-to-map stream
    of phase 18's first 4 scans and one
    SLAM stream of phase 20's first 6 scans (each with captured programs
    and with eager ones) and 3 of phase 21's map-sharded
    calls (in a world of one of its own, NCCL's share of device time too):
    host wall time, device busy share, K1's or K2's share of device time,
    device ops per pair, scan or iteration. It comes last: host-bound
    timings taken after the profiler has been on in a process run slower.
    CUPTI's record of a WHILE node's body is unreliable (all iterations in
    one program's profile, only the first in another's): a captured loop's
    device time is read from phase 23's and 24's CUDA events.

Phases 2, 6, 7, 11 and 13 time K1, K2, K5, K3, K4, K6 and K7 call by call
through their wrappers, as runs before them did (the kernels line's ``ms``), and print
beside it the time back to back (20 launches between two CUDA events, median
of 7 rounds: the kernel's time, free of the host's launch overhead).

Each main path (phases 4, 8, 9, 12, 14, each run of 17 and 18, the pyramid of 19,
the first SLAM run of 20, phase 21's solves, each row and example of 22,
and phases 23's to 28's captured runs) is driven with
the kernels' launch counts set to 0 just before it and read just after.
ICP.icp, the pipeline, map_step (phases 18 and 20) and SLAM's closures
run captured programs (dicp_tpu_torch.jit): a
launch that runs at once counts on its wrapper's host count, a captured one
on the kernel's device counter, by an add captured beside the launch
(ops.launch_counts), so each replay, and each iteration a loop body runs,
counts once; a count is the sum of the two.  The
line before the last is a JSON object describing each kernel of the paths,
with its bound: the larger of its operations at the H100's f32 rate and its
bytes (each input read once, each output written once) at its memory rate,
for this run's inputs; K1's entry also holds its launches per SLAM scan
(phase 20), K2's its launches per streamed pair and per batched odometry
call (phase 17), per scan of each scan-to-map stream (phase 18), per SLAM
closure attempt (phase 20), per pyramid call (phase 19) and per map-sharded
call (phase 21); K1-K4's entries hold their launches per suite row and
example (phase 22); D1's entry (threefry_uniform, replacing XLA's threefry
inside jax.random.uniform: no Pallas kernel) its launches in phases 26 and
27, its bound the larger of its instructions at the issue rate and the
bytes it writes; D2's entry (threefry_randint, replacing XLA's threefry
inside jax.random.randint) its launches on the SGD paths of phases 18, 22,
25 and 28, its bound the larger of its instructions at the INT32 rate and
the int64 draws it writes.  The last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.

    python3 chip_smoke.py --ab DIR

times instead, on one card in one process, K1, K2, K5, K3, K4, K6 and K7
built from ``DIR/dicp_tpu_torch/csrc`` (another checkout, e.g. an earlier
commit unpacked with ``git archive``, whose launchers have this checkout's C
signatures: checked in the sources) against this checkout's, in turns
(DIR's, this, this, DIR's), at the main path's shapes (K3 at 100k -> 100k
and 8 x 50k -> 60k with k = 1, 2, 5, 16 and 32; K4 at the headline and at
256 x 256 -> 512;
K6 and K7 at 100k x 100k for 256 x 2048 and 512 x 4096, beside this
checkout's score_nn.cu built at the other slice count), after holding each
to the plain versions, call by call and back to back; then phases 4, 8, 9
and 12 end to end and K4 through its wrapper, each checkout's own, one
process each, in the same turns.  The last line holds every time as JSON.

    python3 chip_smoke.py --ab DIR --only score

times K6 and K7 alone that way: neither lies on a path.

    python3 chip_smoke.py --ab DIR --only gumbel

times phase 26's Gumbel programs captured (the headline solve, the draw of
one iteration, the streamed gumbel_nn), each checkout's own in a process
of its own, in the same turns; both must give one sum(T).

    python3 chip_smoke.py --ranks K

runs parallel/'s programs on K processes, one card each (NCCL; K cards
needed): map_sharded_fn's (map-sharded at phase 8's pair through K2, the
ring at phase 4's first pair, the sharded IFT's forward and gradient), the
batch-sharded solve and the partitioned pose graph, each against its
eager form bit for bit and the same on every rank, with their collectives
and times, and the IFT gradient against the same gradient in a world of
one and the unrolled one (dense tier: cosines > 0.999; cluster tier: > 0.99
on the rows both worlds certify); phase 28's map-sharded gradient programs
(register_map_sharded and register_map_sharded_ift, by .backward() and
inside one program) and the ring's unrolled gradient into the source and
the sharded target at phase 8's pair (by .backward() and inside one
program: K - 1 shifts and as many reverse shifts per ring call), each
bit-equal to its uncaptured run on every rank, with collectives per
replay; the Hessian-vector products of register_map_sharded and
of register_ring_sharded (into the source and the sharded target) at
phase 8's pair inside one program, and register_map_sharded's by a double
backward through its program pair, bit-equal on every rank to the
uncaptured fixed trip (the ring's second backward: K - 1 reverse shifts
and K - 1 gathers per ring call), beside the certified queries of each rank's
first search and of each rank alone; then tries a WHILE node whose body
holds an all-reduce and prints CUDA's answer.  The last line is the ranks' exit codes as JSON.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from dicp_tpu_torch import ICP, ICPConfig, anderson, bench, io, jit, knn, mapping, pipeline
from dicp_tpu_torch import pt2pt_svd_icp, register, register_anderson, register_ift
from dicp_tpu_torch import register_ift_jit, register_jit, se3, sgd_icp, slam, svd_icp
from dicp_tpu_torch.benchmarks import bench_suite, exp_gicp, exp_knn, exp_multiscale, exp_sgd
from dicp_tpu_torch.examples import large_cloud_demo, odometry_demo, serving_demo, slam_demo
from dicp_tpu_torch.convert import to_torch
from dicp_tpu_torch.gicp import register_gicp, register_gicp_jit
from dicp_tpu_torch.losses import VALID_LOSSES
from dicp_tpu_torch.mapping import empty_map, map_merge, map_step
from dicp_tpu_torch.odometry import (ate, odometry, odometry_pose_graph, pose_graph_optimize,
                                     resumable_odometry)
from dicp_tpu_torch.ops import _build, cluster_search, fused_gn, launch_counts, tiled_knn
from dicp_tpu_torch.ops import cluster_knn as ck
from dicp_tpu_torch.ops.normals import estimate_normals
from dicp_tpu_torch.ops.voxel import voxel_downsample
from dicp_tpu_torch.parallel import pose_graph as pg_mod
from dicp_tpu_torch.parallel import sharding
from dicp_tpu_torch.parallel import (_comm, make_mesh, pose_graph_optimize_partitioned,
                                     register_batch_sharded, register_map_sharded,
                                     register_map_sharded_ift, register_ring_sharded)
from dicp_tpu_torch.pipeline import stream_odometry, stream_registrations
from dicp_tpu_torch import registration as registration_mod
from dicp_tpu_torch.registration import _preprocess, _register_captured
from dicp_tpu_torch.sgd_icp import SeededSampler, plan_solve, register_sgd, register_sgd_jit
from dicp_tpu_torch import visualization
from dicp_tpu_torch.utils import profiling
from dicp_tpu_torch.utils.timing import cuda_median_ms

# the module (dicp_tpu_torch.odometry is also a name of the odometry function's)
odo_mod = importlib.import_module("dicp_tpu_torch.odometry")

ROOT = Path(__file__).resolve().parent
SEED = 0
B, N_SRC, M_TGT = 8, 12288, 16000  # phase 4: the slice at real size
TOL_POSE = 1e-3                    # rad and m, phases 3, 4, 8 and 9
KERNELS = ("tiled_nn", "cluster_search", "cluster_topk", "fused_gn", "score_nn",
           "graph_while", "threefry")
M_MAP = 100_000                    # phases 6-8: one raw scan against its map
B_RAW, N_RAW, M_RAW = 8, 50_000, 60_000  # phases 6 and 9: batched raw scans
PROBES, GROUP = 32, 128            # the cluster tier's defaults
TOL_NORMAL_DEG = 2.0               # phase 8: median weighted-normal angle
B_HEAD = 256                       # phases 11 and 12: bench.py's batch
N_GATE, M_GATE = 256, 512          # phase 11: the fused gate's largest pair
N_SCORE = 100_000                  # phases 13 and 14: the A/B's timing size
# (tq, tm) of the A/B's rows (benchmarks/exp_knn.py:277-285)
SCORE_TILES = ((256, 2048), (512, 4096), (256, 4096), (512, 2048))
SCORE_OPS = 7.0                    # per (query, column): 3 mul, 3 add, 1 compare
TOL_GUMBEL = 0.5                   # phase 15: tests/test_icp.py:189's bound
F32_FLOPS, HBM_BYTES = 67e12, 3.35e12  # H100 SXM: f32 non-tensor-core, HBM3 per s
# instructions per s the CUDA cores can issue: 132 SMs x 128 lanes x 1.98 GHz;
# built --fmad=false each f32 operation is one instruction
ISSUE_RATE = 132 * 128 * 1.98e9
# the headline configuration (bench.py): pt2pl, dim 2, trim 5, huber 1
HEAD = dict(icp_type="pt2pl", differentiable=True, max_iterations=100, tolerance=1e-6,
            dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0)


def _bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations at
    the f32 rate and the bytes at the memory rate."""
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase0_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    _check(torch.backends.cuda.matmul.allow_tf32 is False,
           "torch.backends.cuda.matmul.allow_tf32 is False")
    _check(torch.get_float32_matmul_precision() == "highest",
           "torch.get_float32_matmul_precision() == 'highest'")
    print(f"phase 0 ok: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return card


def _report(lib: Path) -> str:
    log = Path(str(lib) + ".log")
    return log.read_text().strip() if log.exists() else "(built earlier)"


def phase1_build() -> dict:
    t0 = time.perf_counter()
    libs = _build.build_all(KERNELS)
    tiled_knn._kernel()  # load and bind
    seconds = time.perf_counter() - t0
    print(f"phase 1 ok: built {', '.join(lib.name for lib in libs.values())} "
          f"in {seconds:.2f} s\n{_report(libs['tiled_nn'])}")
    return libs


def lidar_scene(rng: np.random.Generator, m: int) -> np.ndarray:
    """(m, 6) points with exact unit normals on a ground plane, four walls and
    a dozen yawed boxes in a 30 m square: a street-corner scan's surfaces."""
    planes = []  # (origin, u, v, normal, area)

    def rect(origin, u, v):
        origin, u, v = (np.asarray(a, np.float64) for a in (origin, u, v))
        normal = np.cross(u, v)
        area = np.linalg.norm(normal)
        planes.append((origin, u, v, normal / area, area))

    half, height = 15.0, 4.0
    rect([-half, -half, 0], [2 * half, 0, 0], [0, 2 * half, 0])           # ground
    for sx, sy in ((1, 0), (-1, 0), (0, 1), (0, -1)):                    # walls
        c = np.array([sx * half, sy * half, 0.0])
        along = np.array([-sy, sx, 0.0]) * 2 * half
        rect(c - along / 2, along, [0, 0, height])
    for _ in range(12):                                                   # boxes
        cx, cy = rng.uniform(-11, 11, size=2)
        w, d, h = rng.uniform(1, 4), rng.uniform(1, 4), rng.uniform(1, 3)
        yaw = rng.uniform(0, np.pi)
        ex = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        ey = np.array([-np.sin(yaw), np.cos(yaw), 0.0])
        c = np.array([cx, cy, 0.0])
        corner = c - ex * w / 2 - ey * d / 2
        rect(corner + [0, 0, h], ex * w, ey * d)                          # top
        rect(corner, [0, 0, h], ex * w)                                   # -ey face
        rect(corner + ey * d, ex * w, [0, 0, h])                          # +ey face
        rect(corner, ey * d, [0, 0, h])                                   # -ex face
        rect(corner + ex * w, [0, 0, h], ey * d)                          # +ex face
    areas = np.array([p[4] for p in planes])
    which = rng.choice(len(planes), size=m, p=areas / areas.sum())
    st = rng.uniform(0, 1, size=(m, 2))
    origin, u, v, normal = (np.stack([planes[i][k] for i in which]) for k in range(4))
    pts = origin + st[:, :1] * u + st[:, 1:] * v
    return np.hstack([pts, normal])


def random_transforms(rng: np.random.Generator, count: int, max_angle_deg: float,
                      max_shift: float) -> np.ndarray:
    """(count, 4, 4) rigid transforms, rotation <= max_angle_deg, shift <= max_shift."""
    out = np.tile(np.eye(4), (count, 1, 1))
    for i in range(count):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = np.deg2rad(rng.uniform(0.5, max_angle_deg))
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        out[i, :3, :3] = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
        shift = rng.normal(size=3)
        out[i, :3, 3] = shift / np.linalg.norm(shift) * rng.uniform(0.05, max_shift)
    return out


def scene_pairs(rng: np.random.Generator, batch: int, n: int, m: int):
    """Targets (batch, m, 6), sources (batch, n, 3) and the true source-to-
    target transforms (batch, 4, 4).  Each source is a random n-subset of its
    target moved by the inverse of its transform, so the truth is exact."""
    targets, sources = [], []
    T_true = random_transforms(rng, batch, max_angle_deg=5.0, max_shift=0.3)
    for i in range(batch):
        tgt = lidar_scene(rng, m)
        sub = tgt[rng.permutation(m)[:n], :3]
        R, t = T_true[i, :3, :3], T_true[i, :3, 3]
        sources.append((sub - t) @ R)  # R^T (q - t)
        targets.append(tgt)
    return (np.stack(sources).astype(np.float32), np.stack(targets).astype(np.float32),
            T_true)


def pose_errors(T_true: torch.Tensor, T_est: torch.Tensor):
    """(rotation error rad, translation error m) per batch element."""
    dR = T_true[:, :3, :3] @ T_est[:, :3, :3].transpose(-1, -2)
    rot = torch.linalg.vector_norm(se3.log_so3(dR), dim=-1)
    trans = torch.linalg.vector_norm(T_true[:, :3, 3] - T_est[:, :3, 3], dim=-1)
    return rot, trans


def _issue_ms(ops: float) -> float:
    """The no-FMA issue ceiling: one instruction per f32 operation."""
    return ops / ISSUE_RATE * 1e3


def _rescan_share(x: torch.Tensor, y: torch.Tensor, chunk: int = 32) -> float:
    """For K1's schedule (a warp's 32 lanes x LANE_Q query slots over one
    target slice), the share of (warp, slot, chunk) triples in which some lane
    finds a chunk minimum strictly below its running best: how often a chunked
    fminf argmin would have to re-scan a chunk."""
    B, n, m = x.shape[0], x.shape[1], y.shape[1]
    lanes, slots = 32, tiled_knn.LANE_Q
    width = tiled_knn.slice_width(m)
    hits = total = 0
    for b in range(B):
        for lo in range(0, m, width):
            d2 = _pairwise_d2(x[b], y[b, lo:lo + width])
            pad = -d2.shape[1] % chunk
            d2 = torch.nn.functional.pad(d2, (0, pad), value=float("inf"))
            mins = d2.reshape(n, -1, chunk).amin(-1)
            before = torch.cat([torch.full_like(mins[:, :1], float("inf")),
                                torch.cummin(mins, dim=1).values[:, :-1]], dim=1)
            better = mins < before
            qpad = -n % (lanes * slots)
            better = torch.nn.functional.pad(better, (0, 0, 0, qpad))
            per_warp = better.reshape(-1, slots, lanes, better.shape[1]).any(dim=2)
            hits += int(per_warp.sum())
            total += per_warp.numel()
    return hits / total


def _pairwise_d2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    diff = x[:, None, 0] - y[None, :, 0]
    d2 = diff * diff
    for c in (1, 2):
        diff = x[:, None, c] - y[None, :, c]
        d2 = d2 + diff * diff
    return d2


def phase2_kernel(device, sources: np.ndarray, targets: np.ndarray) -> dict:
    """K1 and its plain version on the same card tensors: exact agreement."""
    rng = np.random.default_rng(SEED + 2)
    near = rng.normal(size=(1, 4000, 3)).astype(np.float32)
    # K1 cuts m = 1000 targets into slices of 252: a duplicated nearest target
    # at 251 | 252 must resolve to 251
    dup = rng.normal(size=(1, 1000, 3))
    dup[0, 252] = dup[0, 251]
    cases = {
        "main path (8, 12288, 16000)": (sources, targets[..., :3]),
        "n=1, m=1": (rng.normal(size=(1, 1, 3)), rng.normal(size=(1, 1, 3))),
        "ragged n, m": (rng.normal(size=(3, 1000, 3)) * 5, rng.normal(size=(3, 3001, 3)) * 5),
        "all equidistant": (np.zeros((1, 7, 3)), np.ones((1, 2500, 3))),
        "far query": (np.full((1, 1, 3), 1e4), near),
        "duplicate across the slice boundary": (dup[:, [251, 251]] + [[[1e-3] * 3, [-1e-3] * 3]],
                                                dup),
        "m not a multiple of the slice or stage": (rng.normal(size=(2, 300, 3)),
                                                   rng.normal(size=(2, 1001, 3))),
        "m = 3, fewer targets than slices": (rng.normal(size=(1, 200, 3)),
                                             rng.normal(size=(1, 3, 3))),
    }
    cases = {name: (to_torch(x, device, torch.float32), to_torch(y, device, torch.float32))
             for name, (x, y) in cases.items()}
    # the ragged case's targets 4 bytes past a 16-byte boundary: 4-byte copies
    x, y = cases["ragged n, m"]
    buf = torch.empty(y.numel() + 1, dtype=torch.float32, device=device)
    buf[1:] = y.reshape(-1)
    cases["targets not 16-byte aligned"] = (x, buf[1:].view(y.shape))
    _check(buf[1:].data_ptr() % 16 != 0, "the moved targets are not 16-byte aligned")
    main_err = None
    for name, (x, y) in cases.items():
        idx_k, d2_k = tiled_knn.nn_distances(x, y)
        idx_p, d2_p = tiled_knn.nn_distances_plain(x, y)
        torch.cuda.synchronize()
        _check(torch.equal(idx_k, idx_p), f"K1 indices equal the plain version's ({name})")
        _check(torch.equal(d2_k, d2_p), f"K1 d2 bit-equal to the plain version's ({name})")
        err = float((d2_k - d2_p).abs().max())
        if name == "all equidistant":
            _check(bool((idx_k == 0).all()), "ties resolve to index 0")
        if name.startswith("duplicate"):
            _check(idx_k[0].tolist() == [251, 251], "the duplicate resolves to the lower index")
        if name.startswith("main"):
            main_err = err
        print(f"  K1 == plain: {name}: {tuple(x.shape)} x {tuple(y.shape)}, "
              f"max |d2 diff| {err}")

    x = to_torch(sources, device, torch.float32)
    y = to_torch(targets[..., :3], device, torch.float32)
    ms = cuda_median_ms(lambda: tiled_knn.nn_distances(x, y), warmup=3, iters=20)
    chain_ms = _chain_ms(lambda: tiled_knn.nn_distances(x, y))
    plain_ms = cuda_median_ms(lambda: tiled_knn.nn_distances_plain(x, y), warmup=1, iters=5)
    pairs = x.shape[0] * x.shape[1] * y.shape[1]
    # 9 flops per (query, target) pair; read both clouds, write idx and d2
    bound = _bound(9.0 * pairs, 4.0 * (x.numel() + y.numel()) + 8.0 * x.shape[0] * x.shape[1])
    share = _rescan_share(x, y)
    print(f"phase 2 ok: K1 {ms:.4f} ms call by call ({chain_ms:.4f} ms back to back), "
          f"plain {plain_ms:.4f} ms at "
          f"{tuple(x.shape)} x {tuple(y.shape)} ({pairs / chain_ms / 1e6:.1f} Gpair/s back "
          f"to back); bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), issue ceiling "
          f"{_issue_ms(9.0 * pairs):.4f} ms; a chunked argmin would re-scan "
          f"{share:.4f} of (warp, slot, 32-target chunk) triples")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": None}


def phase3_reference(device) -> None:
    """bench.py's configuration, forward only, on the dense tier."""
    scan = np.load(ROOT / "tests" / "data" / "points_scan.npy").astype(np.float32)
    mp = np.load(ROOT / "tests" / "data" / "points_map.npy").astype(np.float32)
    batch = 256
    _check(ICPConfig().resolved_nn_method(65, 65, device) == "dense",
           "the 65-point pair resolves to the dense tier")
    src = to_torch(np.stack([scan[:, :3]] * batch), device)
    tgt = to_torch(np.stack([mp] * batch), device)
    ti = to_torch(np.stack([np.eye(4, dtype=np.float32)] * batch), device)
    before = tiled_knn.launches
    solver = ICP(icp_type="pt2pl", differentiable=False, max_iterations=100,
                 tolerance=1e-6, device=device)
    res = solver.icp(src, tgt, ti, trim_dist=5.0,
                     loss_fn={"name": "huber", "metric": 1.0}, dim=2)
    torch.cuda.synchronize()
    _check(tiled_knn.launches == before, "the dense tier launches no K1")
    xi = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=torch.float64)
    T_true = se3.tran_inv(se3.vec2tran(xi)).to(device)
    T_est = res["T"].to(torch.float64)
    err = torch.linalg.vector_norm(
        se3.tran2vec(T_true @ torch.linalg.inv(T_est)), dim=-1)
    _check(bool(torch.isfinite(res["T"]).all()), "finite transforms")
    _check(float(err.max()) < TOL_POSE, f"reference pair error {float(err.max())} < {TOL_POSE}")
    print(f"phase 3 ok: B={batch} reference pair, max transform error "
          f"{float(err.max()):.3e}, iterations {float(res['stats']['iterations'].max())}")


def _reset_launches() -> None:
    launch_counts.reset()
    tiled_knn.launches = 0
    fused_gn.launches = 0
    cluster_search.fused_search.launches = 0
    cluster_search.block_search.launches = 0
    cluster_search.fused_topk.launches = 0
    exp_knn.nn_v1.launches = 0
    exp_knn.nn_v2.launches = 0
    knn.threefry_launches = 0
    knn.randint_launches = 0


def _launches() -> dict:
    """Each main-path kernel's launches: its wrapper's host count plus its
    captured launches that ran (a host wait)."""
    host = {"tiled_nn": tiled_knn.launches, "fused_gn": fused_gn.launches,
            "cluster_search": cluster_search.fused_search.launches,
            "cluster_block_search": cluster_search.block_search.launches,
            "cluster_topk": cluster_search.fused_topk.launches,
            "threefry_uniform": knn.threefry_launches,
            "threefry_randint": knn.randint_launches}
    return {name: n + launch_counts.read(name) for name, n in host.items()}


def phase4_slice(device, sources: np.ndarray, targets: np.ndarray, T_true: np.ndarray):
    """The main path at real size; returns (K1 launches in one solve, the solve)."""
    n, m = sources.shape[1], targets.shape[1]
    _check(ICPConfig().resolved_nn_method(n, m, device) == "pallas",
           f"({n}, {m}) resolves to the tiled kernel tier")
    src = to_torch(sources, device)
    tgt = to_torch(targets, device)
    ti = torch.eye(4, dtype=torch.float32, device=device).expand(len(sources), 4, 4)
    solver = ICP(icp_type="pt2pl", differentiable=False, max_iterations=50,
                 tolerance=1e-6, device=device)

    def solve():
        return solver.icp(src, tgt, ti, trim_dist=2.0,
                          loss_fn={"name": "huber", "metric": 0.5}, dim=3)

    _reset_launches()
    res = solve()
    torch.cuda.synchronize()
    launches = _launches()["tiled_nn"]

    iters = res["stats"]["iterations"]
    _check(res["T"].device.type == device.type and res["pc"].device.type == device.type,
           "results stay on the card")
    _check(res["T"].shape == (len(sources), 4, 4) and bool(torch.isfinite(res["T"]).all()),
           "finite (B, 4, 4) transforms")
    _check(launches >= int(iters.max()) >= 1,
           f"K1 launched {launches} times, at least once per iteration ({int(iters.max())})")
    rot, trans = pose_errors(torch.as_tensor(T_true, device=device),
                             res["T"].to(torch.float64))
    print(f"  per pair: iterations {iters.tolist()}, converged "
          f"{res['stats']['converged'].tolist()}")
    print(f"  rotation error (rad) {rot.tolist()}\n  translation error (m) {trans.tolist()}")
    _check(float(rot.max()) < TOL_POSE, f"rotation errors < {TOL_POSE} rad")
    _check(float(trans.max()) < TOL_POSE, f"translation errors < {TOL_POSE} m")
    ms = cuda_median_ms(solve, warmup=1, iters=5)
    print(f"phase 4 ok: {len(sources)} x {n} -> {m} pt2pl, {ms:.3f} ms per icp call "
          f"(median of 5), {float(iters.mean()):.2f} iterations per pair, "
          f"K1 launches {launches}")
    return launches, solve


def _ptxas(report: str) -> list:
    """(entry function, registers, spill bytes, stack bytes) for each kernel
    of a -Xptxas=-v report."""
    rows = []
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        stack = re.search(r"(\d+) bytes stack frame", block)
        _check(regs is not None and spill is not None, f"a ptxas report for {name}")
        rows.append((name, int(regs.group(1)), int(spill.group(1)) + int(spill.group(2)),
                     int(stack.group(1)) if stack else 0))
    return rows


def _no_spills(report: str, what: str) -> list:
    rows = _ptxas(report)
    _check(bool(rows), f"{what}: ptxas reported its kernels")
    for name, regs, spill, _ in rows:
        _check(spill == 0, f"{what}: no register spills in {name} ({spill} bytes)")
    return rows


def phase5_cluster_build(libs: dict) -> None:
    cluster_search._search_kernel()  # load and bind
    cluster_search._topk_kernel()
    for name in ("cluster_search", "cluster_topk"):
        print(f"  {libs[name].name}:\n{_report(libs[name])}")
    _no_spills(_report(libs["cluster_search"]), "cluster_search")
    regs = {}
    for name, r, _, _ in _no_spills(_report(libs["cluster_topk"]), "cluster_topk"):
        found = re.search(r"cluster_topk_kernelILi(\d+)ELb([01])E", name)
        regs[int(found.group(1)), found.group(2) == "1"] = r
    for k in (1, 2, 4, 8, 16, 32):
        plan = cluster_search.topk_plan(ck.FUSED_QBLOCK, k, GROUP, PROBES)
        print(f"  K3 at Qs = {ck.FUSED_QBLOCK}, P = {PROBES}, g = {GROUP}, k = {k}: list K = "
              f"{plan['K']} keys per warp, {plan['warps']} warps of {plan['queries_per_warp']} "
              f"queries, bound over {plan['bound_slices']} slices, "
              f"staged {plan['staged']}, {plan['boxes']} boxes; {regs[plan['K'], True]} "
              f"registers staged, {regs[plan['K'], False]} from global memory, no spills")
    print("phase 5 ok: cluster kernels built and bound, no register spills in K2/K5 or K3")


def raw_scan_pair(rng: np.random.Generator, m: int):
    """The single-pair path's inputs: a map (m, 6) with exact normals, the
    map's points permuted and moved by the inverse of a known transform
    (m, 3), and that transform (4, 4) (source to target, <= 5 deg, <= 0.3 m)."""
    mp = lidar_scene(rng, m)
    T_true = random_transforms(rng, 1, max_angle_deg=5.0, max_shift=0.3)[0]
    R, t = T_true[:3, :3], T_true[:3, 3]
    scan = (mp[rng.permutation(m), :3] - t) @ R
    return mp.astype(np.float32), scan.astype(np.float32), T_true


def _search_inputs(y: torch.Tensor, x: torch.Tensor, probes: int = PROBES,
                   group: int = GROUP):
    """What the cluster tier hands K2, K5 and K3 for queries x against
    targets y (both ([B,] n, 3)): the index and the query blocks with their
    selected groups, built on x's device as cluster_nn builds them."""
    index = ck.build_cluster_index(y, group)
    ix, xq, _ = ck._with_batch(index, x)
    xb, _, _ = ck._sorted_blocks(ix, xq, qblock=ck.FUSED_QBLOCK)
    bsel, _ = ck._block_select(ix, xb, probes)
    return ix, xb, bsel


def _max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|, counting equal entries (inf == inf included) as 0."""
    d = torch.where(a == b, torch.zeros_like(a), (a.double() - b.double()).abs().to(a.dtype))
    return float(d.max()) if d.numel() else 0.0


def _edge_cases(device, rng: np.random.Generator) -> dict:
    """name -> (targets (m, 3), queries (n, 3), probes, group)."""
    near = rng.uniform(-1, 1, (3000, 3))
    base = rng.uniform(-10, 10, (1500, 3))
    cases = {
        "P = G": (rng.uniform(-1, 1, (300, 3)), rng.uniform(-1, 1, (200, 3)), 8, 64),
        "m not a multiple of g": (rng.uniform(-5, 5, (777, 3)), rng.uniform(-5, 5, (300, 3)),
                                  3, 128),
        "one query": (near, rng.uniform(-1, 1, (1, 3)), 4, 128),
        "duplicate targets": (np.concatenate([base, base]),
                              base + rng.normal(scale=1e-3, size=base.shape), 4, 64),
        "all targets equidistant": (np.ones((2500, 3)), np.zeros((130, 3)), 4, 128),
        "far query": (near, np.full((1, 3), 1e4), 4, 128),
        "g = 7, not a multiple of 4 (4-byte copies)": (rng.uniform(-5, 5, (900, 3)),
                                                       rng.uniform(-5, 5, (300, 3)), 5, 7),
        "g = 2000: three staging passes": (rng.uniform(-5, 5, (14000, 3)),
                                           rng.uniform(-5, 5, (200, 3)), 5, 2000),
    }
    return {name: (to_torch(y, device, torch.float32), to_torch(x, device, torch.float32), p, g)
            for name, (y, x, p, g) in cases.items()}


def _raw_cases(device, rng: np.random.Generator, aligned_ix) -> dict:
    """name -> (index-like (points, centers, radius), xb, bsel) given directly."""
    # P = 8 groups of 64: 512 columns in K2's 8 slices of 64; one point at
    # columns 63 | 64 (the end of slice 0, the start of slice 1), queries on it
    G, g, P = 20, 64, 8
    pts = rng.uniform(-5, 5, (G, g, 3))
    sel = rng.permutation(G)[:P]
    pts[sel[1], 0] = pts[sel[0], 63]
    xb = rng.uniform(-5, 5, (1, 128, 3))
    xb[0, :4] = pts[sel[0], 63] + rng.normal(scale=1e-4, size=(4, 3))
    centers = pts.mean(axis=1)
    radius = np.linalg.norm(pts - centers[:, None], axis=-1).max(axis=1)
    f32 = lambda a: to_torch(a, device, torch.float32)  # noqa: E731
    dup = SimpleNamespace(points=f32(pts), centers=f32(centers), radius=f32(radius))
    bsel = torch.as_tensor(sel[None].astype(np.int32), device=device)
    # the same index with its points 4 bytes past a 16-byte boundary
    ix, xq, sq = aligned_ix
    buf = torch.empty(ix.points.numel() + 1, dtype=torch.float32, device=device)
    buf[1:] = ix.points.reshape(-1)
    moved = SimpleNamespace(points=buf[1:].view(ix.points.shape), centers=ix.centers,
                            radius=ix.radius)
    _check(moved.points.data_ptr() % 16 != 0, "the moved points are not 16-byte aligned")
    # compact groups with a NaN point in group 3, so its center and radius are
    # NaN (as the cluster index computes them), left out by block 1's
    # selection; and a NaN query in block 1
    nan_pts = rng.uniform(-0.5, 0.5, (G, g, 3)) + rng.uniform(-5, 5, (G, 1, 3))
    nan_pts[3, 5] = np.nan
    nan_xb = rng.uniform(-5, 5, (3, 128, 3))
    nan_xb[0, :8] = nan_pts[3, 6] + 1e-3
    nan_xb[1, 7] = np.nan
    nan_c = nan_pts.mean(axis=1)
    nan_r = np.linalg.norm(nan_pts - nan_c[:, None], axis=-1).max(axis=1)
    nan = SimpleNamespace(points=f32(nan_pts), centers=f32(nan_c), radius=f32(nan_r))
    nan_sel = torch.tensor([[3, 1, 2, 0], [4, 5, 6, 7], [8, 3, 9, 10]], dtype=torch.int32,
                           device=device)
    return {"duplicate across the column-slice boundary": (dup, f32(xb), bsel),
            "points not 16-byte aligned (4-byte copies)": (moved, xq, sq),
            NAN_CASE: (nan, f32(nan_xb), nan_sel)}


NAN_CASE = "a NaN target point and a NaN query"


def _nan_expected(args):
    """What K2 and K5 must give on NAN_CASE, where the plain bound is NaN for
    every query: the plain versions with each NaN point at inf (a NaN
    candidate loses like an inf one) and each NaN group given radius inf (a
    bound term of 0 unless the block selected it); a NaN query finds nothing
    (best inf, column 0's row for K2, row 0 for K5) and gets the bound 0."""
    points, centers, radius, xb, bsel = args
    finite = torch.where(torch.isnan(points), torch.inf, points)
    bad = torch.isnan(centers).any(-1) | torch.isnan(radius)
    best, row, bound = cluster_search.fused_search_plain(
        finite, torch.where(bad[:, None], 0.0, centers), torch.where(bad, torch.inf, radius),
        xb, bsel)
    best5, row5 = cluster_search.block_search_plain(finite, xb, bsel)
    lost = torch.isnan(xb).any(-1)
    first = (bsel[..., :1] * points.shape[-2]).expand_as(row)
    return ((torch.where(lost, torch.inf, best), torch.where(lost, first, row),
             torch.where(lost, 0.0, bound)),
            (torch.where(lost, torch.inf, best5), torch.where(lost, 0, row5)))


TRAP_SNIPPET = """
import sys, torch
from dicp_tpu_torch.ops import cluster_search
dev = torch.device("cuda", 0)
points = torch.zeros(10, 8, 3, device=dev)
centers, radius = torch.zeros(10, 3, device=dev), torch.zeros(10, device=dev)
xb = torch.zeros(2, 128, 3, device=dev)
bsel = torch.tensor([[0, 1], [2, 10]], dtype=torch.int32, device=dev)  # 10 is not in [0, 10)
if sys.argv[1] == "K2":
    cluster_search.fused_search(points, centers, radius, xb, bsel)
else:
    cluster_search.fused_topk(points, centers, radius, xb, bsel, 4)
print("launched", flush=True)
torch.cuda.synchronize()
print("no error", flush=True)
"""


def _trap_check(kernel: str) -> str:
    """K2 or K3 with a group id outside [0, G), in a process of its own: the
    launch is taken without a host check, and the kernel's __trap surfaces at
    the synchronisation as a CUDA error."""
    run = subprocess.run([sys.executable, "-c", TRAP_SNIPPET, kernel], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    errors = [line for line in run.stderr.splitlines() if "CUDA error" in line]
    _check(run.returncode != 0 and "launched" in run.stdout and "no error" not in run.stdout
           and bool(errors), f"{kernel}: an out-of-range group id fails with a CUDA error "
           f"(rc {run.returncode}, stdout {run.stdout!r}, stderr tail {run.stderr[-400:]!r})")
    return errors[-1]


def phase6_search_kernels(device, mp: np.ndarray, scan: np.ndarray,
                          raw_targets: np.ndarray, raw_sources: np.ndarray) -> dict:
    """K2 and K5 against their plain versions on the same card tensors."""
    shapes = {
        f"single pair {len(scan)} -> {len(mp)}": (to_torch(mp[:, :3], device),
                                                  to_torch(scan, device), PROBES, GROUP),
        f"batched {raw_sources.shape[0]} x {raw_sources.shape[1]} -> {raw_targets.shape[1]}": (
            to_torch(raw_targets[..., :3], device), to_torch(raw_sources, device), PROBES, GROUP),
    }
    rng = np.random.default_rng(SEED + 6)
    shapes.update(_edge_cases(device, rng))
    inputs = {name: _search_inputs(y, x, probes, group)
              for name, (y, x, probes, group) in shapes.items()}
    inputs.update(_raw_cases(device, rng, inputs["m not a multiple of g"]))
    err = {"cluster_search": 0.0, "cluster_block_search": 0.0}
    for name, (ix, xb, bsel) in inputs.items():
        args = (ix.points, ix.centers, ix.radius, xb, bsel)
        group = ix.points.shape[-2]
        k2 = cluster_search.fused_search(*args)
        k5 = cluster_search.block_search(ix.points, xb, bsel)
        if name == NAN_CASE:
            p2, p5 = _nan_expected(args)
        else:
            p2 = cluster_search.fused_search_plain(*args)
            p5 = cluster_search.block_search_plain(ix.points, xb, bsel)
        torch.cuda.synchronize()
        for what, a, b in zip(("best", "row", "bound"), k2, p2):
            _check(torch.equal(a, b), f"K2 {what} bit-equal to the plain version's ({name})")
        for what, a, b in zip(("best", "row"), k5, p5):
            _check(torch.equal(a, b), f"K5 {what} bit-equal to the plain version's ({name})")
        found = k2[0] < torch.inf  # else K2's row is column 0's, K5's row 0
        _check(torch.equal(k5[0], k2[0]) and torch.equal(k5[1][found], k2[1][found]),
               f"K5's argmin equals K2's ({name})")
        if name == "P = G":
            _check(bool(torch.isinf(k2[2]).all()), "every group selected: bound inf")
        if name == "all targets equidistant":
            _check(bool((k2[1] == bsel[..., :1] * group).all()),
                   "ties resolve to the first candidate column")
        if name.startswith("duplicate across"):
            _check(bool((k2[1][0, :4] == bsel[0, 0] * group + 63).all()),
                   "the duplicate resolves to the lower column")
        if name == NAN_CASE:
            past = (bsel != 3).all(-1)[:, None] | torch.isnan(xb).any(-1)
            _check(bool((k2[2][past] == 0).all()) and not bool((k2[0] <= k2[2])[past].any())
                   and bool((k2[2][~past] > 0).any()),
                   "no query is certified past the NaN group or for the NaN query")
        e2 = max(_max_abs_diff(k2[0], p2[0]), _max_abs_diff(k2[2], p2[2]))
        e5 = _max_abs_diff(k5[0], p5[0])
        err["cluster_search"] = max(err["cluster_search"], e2)
        err["cluster_block_search"] = max(err["cluster_block_search"], e5)
        print(f"  K2, K5 == plain: {name}: xb {tuple(xb.shape)}, bsel {tuple(bsel.shape)}, "
              f"G {ix.points.shape[-3]}, g {group}, max |diff| {e2}, {e5}")
    print(f"  out-of-range group id, in a subprocess: {_trap_check('K2')}")

    times = []
    for label in list(shapes)[:2]:  # the two raw-scan shapes
        ix, xb, bsel = inputs[label]
        args = (ix.points, ix.centers, ix.radius, xb, bsel)
        t = {
            "cluster_search": cuda_median_ms(lambda: cluster_search.fused_search(*args),
                                             warmup=3, iters=20),
            "cluster_search chain": _chain_ms(lambda: cluster_search.fused_search(*args)),
            "cluster_search plain": cuda_median_ms(
                lambda: cluster_search.fused_search_plain(*args), warmup=1, iters=5),
            "cluster_block_search": cuda_median_ms(
                lambda: cluster_search.block_search(ix.points, xb, bsel), warmup=3, iters=20),
            "cluster_block_search chain": _chain_ms(
                lambda: cluster_search.block_search(ix.points, xb, bsel)),
            "cluster_block_search plain": cuda_median_ms(
                lambda: cluster_search.block_search_plain(ix.points, xb, bsel),
                warmup=1, iters=5),
        }
        pairs = xb.shape[:-1].numel() * bsel.shape[-1] * ix.points.shape[-2]
        work2, work5 = _search_work(ix, xb, bsel, 1, True), _search_work(ix, xb, bsel, 1, False)
        k2_bound = _bound(*work2)
        print(f"  {label}: K2 {t['cluster_search']:.4f} ms call by call "
              f"({t['cluster_search chain']:.4f} ms back to back; plain "
              f"{t['cluster_search plain']:.4f}), K5 {t['cluster_block_search']:.4f} ms "
              f"({t['cluster_block_search chain']:.4f} back to back; plain "
              f"{t['cluster_block_search plain']:.4f}); {pairs:.3e} (query, candidate) pairs, "
              f"K2 {pairs / t['cluster_search chain'] / 1e6:.1f} Gpair/s back to back; "
              f"K2 bound {k2_bound['bound_ms']:.4f} ms ({k2_bound['bound_by']}), issue "
              f"ceiling {_issue_ms(work2[0]):.4f} ms; K5 bound "
              f"{_bound(*work5)['bound_ms']:.4f} ms, issue ceiling {_issue_ms(work5[0]):.4f} ms")
        times.append(t)
    single = times[0]
    ix, xb, bsel = inputs[list(shapes)[0]]
    bounds = {"cluster_search": _bound(*_search_work(ix, xb, bsel, 1, True)),
              "cluster_block_search": _bound(*_search_work(ix, xb, bsel, 1, False))}
    print(f"phase 6 ok: K2 and K5 bit-equal to their plain versions in every case; bounds "
          f"at the single pair {bounds}")
    return {name: {"max_abs_err": err[name], "ms": single[name],
                   "plain_ms": single[f"{name} plain"], **bounds[name], "library_ms": None}
            for name in ("cluster_search", "cluster_block_search")}


def _search_work(ix, xb, bsel, k: int, with_bound: bool):
    """(flops, bytes) a cluster search needs: 9 flops per (query, candidate)
    pair; with the bound, 13 per (query, non-selected group) (difference,
    norm, sqrt, the 1 - 8 eps scale, radius, clamp, square).  Bytes: the
    grouped points, the queries and the selection read once (centers and
    radii too with the bound); k (d2, row) pairs per query written, plus the
    bound."""
    G, g = ix.points.shape[-3], ix.points.shape[-2]
    queries = xb.shape[:-1].numel()
    P = bsel.shape[-1]
    flops = 9.0 * queries * P * g
    nbytes = 4.0 * (ix.points.numel() + xb.numel() + bsel.numel()) + 8.0 * queries * k
    if with_bound:
        flops += 13.0 * queries * (G - P)
        nbytes += 4.0 * (ix.centers.numel() + ix.radius.numel()) + 4.0 * queries
    return flops, nbytes


def _topk_work(ix, xb, bsel, k: int):
    """(flops, bytes, searched groups per query) K3 needs on these inputs:
    K2's bytes and bound work (_search_work), but the 9 flops of a (query,
    candidate) pair, its compare with the k-th key among them, only in the
    groups a query must search: those whose bounding box (NaN coordinates
    left out) lies within its k-th d2 from fused_topk_plain, in K3's f32
    order.  A group past it holds no candidate of the result, and one within
    it may hold a tie."""
    flops, nbytes = _search_work(ix, xb, bsel, k, True)
    G, g = ix.points.shape[-3], ix.points.shape[-2]
    queries = xb.shape[:-1].numel()
    P = bsel.shape[-1]
    kth = cluster_search.fused_topk_plain(ix.points, ix.centers, ix.radius, xb, bsel, k)[0]
    pts = ix.points.reshape(-1, G, g, 3)
    lo = torch.where(torch.isnan(pts), torch.inf, pts).amin(-2)
    hi = torch.where(torch.isnan(pts), -torch.inf, pts).amax(-2)
    sel = bsel.reshape(pts.shape[0], -1, P).long()
    batch = torch.arange(pts.shape[0], device=pts.device)[:, None, None]
    lo, hi = lo[batch, sel][:, :, None], hi[batch, sel][:, :, None]  # (B, nb, 1, P, 3)
    q = xb.reshape(pts.shape[0], -1, xb.shape[-2], 1, 3)
    e = torch.where(q < lo, q - lo, torch.where(q > hi, q - hi, 0.0))
    lb = (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) + e[..., 2] * e[..., 2]
    searched = int((lb <= kth.reshape(lb.shape[:-1] + (k,))[..., -1:]).sum())
    flops -= 9.0 * g * (queries * P - searched)
    return flops, nbytes, searched / queries


def _topk_nan_expected(args, k: int):
    """What K3 must give on NAN_CASE, as _nan_expected for K2: the plain
    version with each NaN point at inf and each NaN group at radius inf; a
    NaN query lists nothing (d2 inf, column 0's row) and gets the bound 0."""
    points, centers, radius, xb, bsel = args
    finite = torch.where(torch.isnan(points), torch.inf, points)
    bad = torch.isnan(centers).any(-1) | torch.isnan(radius)
    d2, rows, bound = cluster_search.fused_topk_plain(
        finite, torch.where(bad[:, None], 0.0, centers), torch.where(bad, torch.inf, radius),
        xb, bsel, k)
    lost = torch.isnan(xb).any(-1)
    first = (bsel[..., :1] * points.shape[-2])[..., None].expand_as(rows)
    return (torch.where(lost[..., None], torch.inf, d2), torch.where(lost[..., None], first, rows),
            torch.where(lost, 0.0, bound))


def _topk_cases(device, rng: np.random.Generator, main) -> list:
    """(name, (points, centers, radius, xb, bsel), k) for phase 7."""
    f32 = lambda a: to_torch(a, device, torch.float32)  # noqa: E731

    def index_of(pts):
        centers = pts.mean(axis=1)
        radius = np.linalg.norm(pts - centers[:, None], axis=-1).max(axis=1)
        return f32(pts), f32(centers), f32(radius)

    ix, xb, bsel = main
    cases = [(f"{M_MAP} -> {M_MAP}, k = {k}", (ix.points, ix.centers, ix.radius, xb, bsel), k)
             for k in (16, 1, 2, 5, 32)]
    # P = 8 groups of 64: points duplicated at columns 63 | 64 and 127 | 128
    G, g, P = 20, 64, 8
    pts = rng.uniform(-5, 5, (G, g, 3))
    sel = rng.permutation(G)[:P]
    pts[sel[1], 0] = pts[sel[0], 63]
    pts[sel[2], 0] = pts[sel[1], 63]
    q = rng.uniform(-5, 5, (1, 128, 3))
    q[0, :4] = pts[sel[0], 63] + rng.normal(scale=1e-4, size=(4, 3))
    q[0, 4:8] = pts[sel[1], 63] + rng.normal(scale=1e-4, size=(4, 3))
    dup = index_of(pts) + (f32(q), torch.as_tensor(sel[None].astype(np.int32), device=device))
    cases += [(f"duplicates across group boundaries, k = {k}", dup, k) for k in (5, 16)]
    # 3 selected groups of 32 with 3 finite points each: 9 finite candidates
    pts = rng.uniform(-5, 5, (6, 32, 3))
    pts[:, 3:] = 1e20
    few = index_of(pts) + (f32(rng.uniform(-5, 5, (2, 128, 3))),
                           torch.as_tensor(np.stack([rng.permutation(6)[:3] for _ in range(2)])
                                           .astype(np.int32), device=device))
    cases += [(f"k = {k} beyond the 9 finite candidates (column-0 fill)", few, k)
              for k in (16, 32)]
    searched = {}
    for name, (y, x, probes, group), k in (
            ("g = 7",
             (rng.uniform(-5, 5, (900, 3)), rng.uniform(-5, 5, (300, 3)), 5, 7), 16),
            ("g = 2000: slabs read from global memory",
             (rng.uniform(-5, 5, (14000, 3)), rng.uniform(-5, 5, (200, 3)), 5, 2000), 32),
            ("m not a multiple of g",
             (rng.uniform(-5, 5, (777, 3)), rng.uniform(-5, 5, (300, 3)), 3, 128), 8)):
        i, qb, sb = searched[name] = _search_inputs(f32(y), f32(x), probes, group)
        cases.append((name, (i.points, i.centers, i.radius, qb, sb), k))
    raw = _raw_cases(device, rng, searched["m not a multiple of g"])
    for name in ("points not 16-byte aligned (4-byte copies)", NAN_CASE):
        i, qb, sb = raw[name]
        cases.append((name, (i.points, i.centers, i.radius, qb, sb), 16))
    # what only the warp schedule can get wrong
    tie = index_of(_tie_points(rng)) + (f32(np.zeros((1, 4, 3))),
                                        torch.tensor([[0, 1, 2]], dtype=torch.int32,
                                                     device=device))
    cases.append((TIE_CASE, tie, 8))

    def groups(G, g, scale=5.0):
        return rng.uniform(-scale, scale, (G, g, 3))

    def given(pts, nq, sel, scale=5.0):
        return index_of(pts) + (f32(rng.uniform(-scale, scale, (len(sel), nq, 3))),
                                torch.as_tensor(np.asarray(sel, np.int32), device=device))

    shell = rng.normal(size=(64, 3))  # the first group visited: a sphere of radius 5
    shell = 5.0 * shell / np.linalg.norm(shell, axis=1, keepdims=True)
    full = index_of(np.stack([rng.uniform(1.0, 1.5, (64, 3)), shell])) + (
        f32(rng.normal(scale=1e-3, size=(1, 8, 3))),
        torch.tensor([[0, 1]], dtype=torch.int32, device=device))
    cases += [(f"every lane's queue full in the same step, k = {k}", full, k)
              for k in (1, 16, 32)]
    few = given(groups(5, 7), 64, [[4, 1]])
    cases += [(f"fewer candidates than lanes (P g = 14), k = {k}", few, k) for k in (1, 14)]
    cases.append(("g = 37, not a multiple of 4 or 32",
                  given(groups(11, 37), 128, [rng.permutation(11)[:6] for _ in range(2)]), 16))
    pts = groups(8, 16)
    pts[:, 4:] = 1e20
    cases.append((EXACT_CASE, given(pts, 128, [rng.permutation(8)]), 32))
    cases.append(("P = 40 > 32: two chunks of groups",
                  given(groups(70, 4, 20.0), 128, [rng.permutation(70)[:40]], 20.0), 16))
    return cases


TIE_CASE = "a tie with the k-th entry reached later in a lower column"
EXACT_CASE = "k = 32 with exactly 32 finite candidates"


def _tie_points(rng: np.random.Generator) -> np.ndarray:
    """Three groups of 64 (bsel = [0, 1, 2]) for queries at the origin:
    group 1, visited first (its box holds the queries), holds their 8 nearest
    points, the 8th at d2 = 1 exactly, and fills every lane's queue in two
    steps, so the list's 8th key is (1, column 71) before group 0 is visited;
    group 0 holds a copy of that point in column 0.  Only a lexicographic
    filter against the k-th key lists the copy."""
    near = rng.uniform(2, 3, (64, 3))
    near[:7] = rng.uniform(-0.4, 0.4, (7, 3)) * [1, 1, 0]
    near[7] = (1.0, 0.0, 0.0)
    far = rng.uniform(3, 4, (64, 3))
    far[:, 0] = rng.uniform(1.0, 4.0, 64)
    far[0] = near[7]
    return np.stack([far, near, rng.uniform(6, 8, (64, 3))])


def phase7_topk_kernel(device, mp: np.ndarray, scan: np.ndarray) -> dict:
    """K3 against its plain version on the same card tensors, bit for bit."""
    y, x = to_torch(mp[:, :3], device), to_torch(scan, device)
    ix, xb, bsel = _search_inputs(y, x)
    rng = np.random.default_rng(SEED + 7)
    err = 0.0
    for name, args, k in _topk_cases(device, rng, (ix, xb, bsel)):
        kern = cluster_search.fused_topk(*args, k)
        plain = _topk_nan_expected(args, k) if name == NAN_CASE \
            else cluster_search.fused_topk_plain(*args, k)
        torch.cuda.synchronize()
        for what, a, b in zip(("d2", "rows", "bound"), kern, plain):
            _check(torch.equal(a, b), f"K3 {what} bit-equal to the plain version's ({name})")
        if name.startswith("duplicates"):
            _check(bool((kern[0][0, :8, 0] == kern[0][0, :8, 1]).all()),
                   "duplicate distances are kept for later ranks")
        if "column-0 fill" in name:
            fill = ~torch.isfinite(kern[0])
            first = (args[4][..., :1] * args[0].shape[-2])[..., None].expand_as(kern[1])
            _check(bool(fill.any()) and torch.equal(kern[1][fill], first[fill]),
                   "past the finite candidates K3 fills with column 0's row")
        if name == NAN_CASE:
            past = (args[4] != 3).all(-1)[:, None] | torch.isnan(args[3]).any(-1)
            _check(bool((kern[2][past] == 0).all())
                   and not bool((kern[0][..., -1] <= kern[2])[past].any()),
                   "no query is certified past the NaN group or for the NaN query")
        if name == TIE_CASE:
            _check(bool((kern[1][..., -1] == 0).all()) and bool((kern[0][..., -1] == 1).all()),
                   "the tie with the 8th entry resolves to the lower column, reached later")
        if name == EXACT_CASE:
            _check(bool(torch.isfinite(kern[0]).all()), "all 32 finite candidates listed")
        e = max(_max_abs_diff(kern[0], plain[0]), _max_abs_diff(kern[2], plain[2]))
        err = max(err, e)
        print(f"  K3 == plain: {name}: xb {tuple(args[3].shape)}, P {args[4].shape[-1]}, "
              f"g {args[0].shape[-2]}, max |diff| {e}")
    print(f"  out-of-range group id, in a subprocess: {_trap_check('K3')}")
    args = (ix.points, ix.centers, ix.radius, xb, bsel, 16)
    ms = cuda_median_ms(lambda: cluster_search.fused_topk(*args), warmup=3, iters=20)
    chain_ms = _chain_ms(lambda: cluster_search.fused_topk(*args))
    plain_ms = cuda_median_ms(lambda: cluster_search.fused_topk_plain(*args), warmup=1, iters=3)
    flops, nbytes, searched = _topk_work(ix, xb, bsel, 16)
    bound = _bound(flops, nbytes)
    print(f"phase 7 ok: K3 {ms:.4f} ms call by call ({chain_ms:.4f} ms back to back), plain "
          f"{plain_ms:.4f} ms at {len(scan)} -> {len(mp)}, k = 16, P = {PROBES}; "
          f"{searched:.4f} of the {PROBES} groups per query must be searched; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), issue ceiling "
          f"{_issue_ms(flops):.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}


def _angles_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle between unit vectors up to sign, in degrees."""
    cos = torch.clamp(torch.abs(torch.sum(a.double() * b.double(), dim=-1)), max=1.0)
    return torch.rad2deg(torch.arccos(cos))


def phase8_single_pair(device, mp: np.ndarray, scan: np.ndarray, T_true: np.ndarray) -> dict:
    """The single-pair raw-scan path: normals for the map, then pt2pl through
    the cluster index.  Returns the launch counts of the path, the solve and
    its (source, target with normals) on the card."""
    pts = to_torch(mp[:, :3], device)
    exact = to_torch(mp[:, 3:6], device)
    src = to_torch(scan, device)
    n, m = src.shape[0], pts.shape[0]
    _check(ICPConfig().resolved_nn_method(n, m, device) == "cluster",
           f"({n}, {m}) resolves to the cluster tier")
    solver = ICP(icp_type="pt2pl", differentiable=False, max_iterations=30, tolerance=1e-5,
                 device=device, cluster_probes=PROBES, cluster_group=GROUP)
    ti = torch.eye(4, dtype=torch.float32, device=device)

    _reset_launches()
    normals = estimate_normals(pts, method="weighted")
    knn_normals = estimate_normals(pts, k=16, method="cluster")
    target = torch.cat([pts, normals], dim=-1)
    res = solver.icp(src, target, ti, trim_dist=2.0, loss_fn={"name": "huber", "metric": 1.0},
                     dim=3)
    index = ck.build_cluster_index(pts, GROUP)
    idx_k5, d2_k5, cert_k5 = ck.cluster_nn(index, src, probes=PROBES, use_pallas=True)
    torch.cuda.synchronize()
    launches = _launches()

    angle = _angles_deg(normals, exact)
    knn_angle = _angles_deg(knn_normals, exact)
    med = float(torch.median(angle))
    print(f"  weighted normals: median angle {med:.4f} deg, mean {float(angle.mean()):.4f} "
          f"deg; cluster k-NN (k = 16) normals: median {float(torch.median(knn_angle)):.4f} deg")
    _check(normals.shape == (m, 3) and bool(torch.isfinite(normals).all()),
           "finite (m, 3) weighted normals")
    _check(med < TOL_NORMAL_DEG, f"median weighted-normal angle {med} < {TOL_NORMAL_DEG} deg")
    _check(launches["cluster_topk"] >= 1, "estimate_normals(method='cluster') launched K3")

    iters = int(res["stats"]["iterations"].max())
    _check(res["T"].shape == (1, 4, 4) and bool(torch.isfinite(res["T"]).all()),
           "a finite (1, 4, 4) transform")
    _check(launches["cluster_search"] >= iters >= 1,
           f"K2 launched {launches['cluster_search']} times, at least once per iteration "
           f"({iters})")
    rot, trans = pose_errors(torch.as_tensor(T_true[None], device=device),
                             res["T"].to(torch.float64))
    print(f"  {n} -> {m} pt2pl: {iters} iterations, converged "
          f"{bool(res['stats']['converged'][0])}, rotation error {float(rot[0]):.3e} rad, "
          f"translation error {float(trans[0]):.3e} m")
    _check(float(rot.max()) < TOL_POSE, f"rotation error < {TOL_POSE} rad")
    _check(float(trans.max()) < TOL_POSE, f"translation error < {TOL_POSE} m")

    # the final correspondences as the solver computes them: queries ordered
    # once at T_init, then the certificate and the brute-force fix-up budget
    cfg = ICPConfig(cluster_probes=PROBES, cluster_group=GROUP)
    order = ck.query_order(index, src)
    T_est = res["T"][0]
    ps = src @ T_est[:3, :3].T + T_est[:3, 3]
    _, _, cert = ck.cluster_nn(index, ps, probes=PROBES, order=order)
    budget = cfg.resolved_cluster_fixup(n)
    unc = int((~cert).sum())
    print(f"  final correspondences: certified {float(cert.float().mean()):.6f} before the "
          f"fix-up; {unc} uncertified, {min(unc, budget)} brute-forced (budget {budget}), "
          f"{max(0, unc - budget)} left out")

    idx_k2, d2_k2, cert_k2 = ck.cluster_nn(index, src, probes=PROBES)
    _check(torch.equal(idx_k5, idx_k2) and torch.equal(d2_k5, d2_k2)
           and torch.equal(cert_k5, cert_k2), "cluster_nn(use_pallas=True) (K5) equals the K2 path")

    def solve():
        return solver.icp(src, target, ti, trim_dist=2.0,
                          loss_fn={"name": "huber", "metric": 1.0}, dim=3)

    ms = cuda_median_ms(solve, warmup=1, iters=5)
    normals_ms = cuda_median_ms(lambda: estimate_normals(pts, method="weighted"),
                                warmup=1, iters=5)
    print(f"phase 8 ok: {n} -> {m} pt2pl through the cluster tier, {ms:.3f} ms per icp call "
          f"(median of 5), weighted normals {normals_ms:.3f} ms; launches {launches}")
    return launches, solve, (src, target)


def phase9_batched(device, sources: np.ndarray, targets: np.ndarray, T_true: np.ndarray) -> dict:
    """Batched raw scans through the cluster tier; returns the launch counts
    and the solve."""
    n, m = sources.shape[1], targets.shape[1]
    _check(ICPConfig().resolved_nn_method(n, m, device) == "cluster",
           f"({n}, {m}) resolves to the cluster tier")
    src, tgt = to_torch(sources, device), to_torch(targets, device)
    ti = torch.eye(4, dtype=torch.float32, device=device).expand(len(sources), 4, 4)
    solver = ICP(icp_type="pt2pl", differentiable=False, max_iterations=30, tolerance=1e-5,
                 device=device, cluster_probes=PROBES, cluster_group=GROUP)

    def solve():
        return solver.icp(src, tgt, ti, trim_dist=2.0, loss_fn={"name": "huber", "metric": 1.0},
                          dim=3)

    _reset_launches()
    res = solve()
    torch.cuda.synchronize()
    launches = _launches()
    iters = res["stats"]["iterations"]
    _check(res["T"].shape == (len(sources), 4, 4) and bool(torch.isfinite(res["T"]).all()),
           "finite (B, 4, 4) transforms")
    _check(launches["cluster_search"] >= int(iters.max()) >= 1,
           f"K2 launched {launches['cluster_search']} times, at least once per iteration "
           f"({int(iters.max())})")
    rot, trans = pose_errors(torch.as_tensor(T_true, device=device), res["T"].to(torch.float64))
    print(f"  per pair: iterations {iters.tolist()}\n  rotation error (rad) {rot.tolist()}\n"
          f"  translation error (m) {trans.tolist()}")
    _check(float(rot.max()) < TOL_POSE, f"rotation errors < {TOL_POSE} rad")
    _check(float(trans.max()) < TOL_POSE, f"translation errors < {TOL_POSE} m")
    ms = cuda_median_ms(solve, warmup=1, iters=5)
    print(f"phase 9 ok: {len(sources)} x {n} -> {m} pt2pl through the cluster tier, "
          f"{ms:.3f} ms per icp call (median of 5); launches {launches}")
    return launches, solve


def phase10_fused_build(libs: dict) -> None:
    fused_gn._kernel()  # load and bind
    report = _report(libs["fused_gn"])
    print(f"  {libs['fused_gn'].name}:\n{report}")
    regs = {}
    for name, r, _, stack in _no_spills(report, "fused_gn"):
        found = re.search(r"fused_gn_kernelILi(\d)ELb([01])E", name)
        regs[(int(found.group(1)), found.group(2) == "1")] = (r, stack)
    for label, n, m, k in (("headline", 65, 65, 3), ("gate's largest", N_GATE, M_GATE, 6)):
        plan = fused_gn.launch_plan(n, m)
        r, stack = regs[(k, True)]
        print(f"  K4 at the {label} ({n} -> {m}, pt2pl, k = {k}): {plan['lanes']} lanes per "
              f"point, {plan['threads']} threads, {r} registers, {stack} bytes stack")
    print("phase 10 ok: K4 built and bound (four instances: pt2pl/pt2pt x dim 3/2), no "
          "register spills")


def reference_batch(device, batch: int = B_HEAD):
    """bench.py's inputs: the 65-point reference pair replicated to ``batch``
    (dicp_tpu_torch.bench.reference_batch)."""
    return bench.reference_batch(batch, device=device)


def random_pairs(rng: np.random.Generator, batch: int, n: int, m: int, dim: int,
                 normals: bool):
    """tests/test_fused_gn.py's scene: each target a permuted exact transform
    of its source plus far outliers (every query has a unique exact match)."""
    src = rng.uniform(-2.0, 2.0, (batch, n, 3))
    if dim == 2:
        src[..., 2] = 0.0
    tgts = []
    for b in range(batch):
        th = rng.uniform(-0.15, 0.15)
        C = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0],
                      [0.0, 0.0, 1.0]])
        t = np.array([0.1 * rng.normal(), 0.1 * rng.normal(), 0.0])
        pts = np.concatenate([src[b][rng.permutation(n)], rng.uniform(50, 60, (m - n, 3))])
        tgts.append(pts @ C.T + t)
    tgt = np.stack(tgts)
    if normals:
        nrm = rng.normal(size=(batch, m, 3))
        if dim == 2:
            nrm[..., 2] = 0.0
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
        tgt = np.concatenate([tgt, nrm], axis=-1)
    return src.astype(np.float32), tgt.astype(np.float32)


def _k4_args(cfg: ICPConfig, src, tgt, ti, weight=None):
    """What registration hands K4: the preprocessed solver tensors with
    per-point weights."""
    source, target, w, C, r = _preprocess(cfg, src, tgt, ti, weight)
    if cfg.icp_type == "pt2pt":
        w = w[:, ::3]
    return source[..., :3].contiguous(), target, w, C, r


def _k4_work(args, iters: torch.Tensor, tcols: int):
    """(flops, bytes) of the whole solves K4 ran: per executed iteration and
    source point, 8 flops per target (difference form) plus ~220 for the
    weights, the Jacobian row and its normal-equation products (the Pallas
    cost estimate's count); inputs read once, results written once."""
    source, target, w = args[:3]
    B, n, m = source.shape[0], source.shape[1], target.shape[1]
    flops = float(iters.double().sum()) * n * (8.0 * m + 220.0)
    nbytes = 4.0 * (B * n * 3 + B * m * tcols + B * n + B * 12) + 4.0 * (B * 16 + B * n)
    return flops, nbytes


def phase11_fused_kernel(device) -> dict:
    """K4 against its plain version on the same card tensors; timed; and the
    forward A/B of register(fused_small=True) against the loop."""
    rng = np.random.default_rng(SEED + 12)
    base = dict(differentiable=False, driver="while", collect_histories=False,
                max_iterations=40, tolerance=1e-5, nn_method="dense")
    main = _k4_main_inputs(device)
    (head_cfg, (src, tgt, ti)), (gate_cfg, gate) = main.values()
    cases = {"headline: reference pair B=256, pt2pl dim 2": (head_cfg, (src, tgt, ti, None)),
             "gate's largest: 256 x 256 -> 512 LiDAR-like, pt2pl dim 3": (gate_cfg,
                                                                          (*gate, None))}

    def edge(name, batch, n, m, dim, normals, weight=None, **kw):
        e_src, e_tgt = random_pairs(rng, batch, n, m, dim, normals)
        w = None if weight is None else to_torch(weight, device)
        cases[name] = (ICPConfig(**{**base, "dim": dim, "fused_small": True, **kw}),
                       (to_torch(e_src, device), to_torch(e_tgt, device),
                        torch.eye(4, device=device).expand(batch, 4, 4), w))

    edge("pt2pt dim 3 cauchy", 8, 40, 48, 3, False, icp_type="pt2pt", loss_name="cauchy",
         loss_metric=2.0)
    edge("prior weights with zeros, hard trim", 5, 40, 40, 2, False,
         weight=(rng.random((5, 40)) > 0.2).astype(np.float32), icp_type="pt2pt",
         trim_dist=3.0)
    edge("B=5 pt2pl dim 2", 5, 30, 30, 2, True, icp_type="pt2pl", loss_name="huber")
    edge("n=1 pt2pt dim 2", 3, 1, 8, 2, False, icp_type="pt2pt", loss_name="huber")
    edge("trim loss, steepness 2", 4, 40, 40, 2, False, icp_type="pt2pt", differentiable=True,
         loss_name="trim", loss_metric=2.0, tanh_steepness=2.0)
    for loss in VALID_LOSSES + (None,):
        edge(f"loss {loss}, pt2pl dim 3", 3, 48, 64, 3, True, icp_type="pt2pl",
             differentiable=True, loss_name=loss, loss_metric=2.0 if loss else 1.0,
             trim_dist=4.0)
    # the lane split's edges: the most threads, one target, ragged n and m
    edge("n=256, m=512 pt2pl dim 2", 4, N_GATE, M_GATE, 2, True, icp_type="pt2pl",
         loss_name="huber")
    # one target for 40 points (n = 1 would leave the rotation to the damping
    # alone, a singular solve): the translation fits the mean and the rotation
    # step vanishes, through one padded chunk of targets
    m1_src = rng.uniform(-2.0, 2.0, (3, 40, 3)).astype(np.float32)
    m1_tgt = rng.uniform(-2.0, 2.0, (3, 1, 3)).astype(np.float32)
    cases["m=1: 40 points against one target, pt2pt dim 3"] = (
        ICPConfig(**base, dim=3, fused_small=True, icp_type="pt2pt"),
        (to_torch(m1_src, device), to_torch(m1_tgt, device),
         torch.eye(4, device=device).expand(3, 4, 4), None))
    edge(f"n=37, m=43: not multiples of the lane split ({fused_gn.lanes_for(37, 43)} lanes) "
         f"or of {fused_gn.CHUNK}", 5, 37, 43, 3, True, icp_type="pt2pl", loss_name="huber")
    for loss in VALID_LOSSES + (None,):
        edge(f"loss {loss}, pt2pt dim 2", 3, 48, 64, 2, False, icp_type="pt2pt",
             differentiable=True, loss_name=loss, loss_metric=2.0 if loss else 1.0,
             trim_dist=4.0)

    err, work = 0.0, {}
    for name, (cfg, (s, t, i, w)) in cases.items():
        args = _k4_args(cfg, s, t, i, w)
        before = fused_gn.launches
        out = fused_gn.fused_gn_solve(*args, cfg)
        again = fused_gn.fused_gn_solve(*args, cfg)
        plain = fused_gn.fused_gn_solve_plain(*args, cfg)
        torch.cuda.synchronize()
        _check(fused_gn.launches == before + 2, f"K4 launched twice ({name})")
        for a, b in zip(out, again):
            _check(torch.equal(a, b), f"two K4 launches give identical outputs ({name})")
        C, r, conv, iters, ratio = out[:5]
        Cp, rp, convp, itersp, ratiop = plain[:5]
        for what, a, b in (("converged", conv, convp), ("iterations", iters, itersp),
                           ("matched ratio", ratio, ratiop)):
            _check(torch.equal(a, b), f"K4 {what} equal to the plain version's ({name}): "
                   f"{a.tolist()} vs {b.tolist()}")
        dT = max(float((C - Cp).abs().max()), float((r - rp).abs().max()))
        pc = torch.einsum("nij,npj->npi", C, args[0]) + r[:, None, :]
        pcp = torch.einsum("nij,npj->npi", Cp, args[0]) + rp[:, None, :]
        dpc = float((pc - pcp).abs().max())
        _check(dT < 1e-5, f"K4 T within 1e-5 of the plain version's ({name}): {dT}")
        _check(dpc < 1e-4, f"K4 pc within 1e-4 of the plain version's ({name}): {dpc}")
        _check(bool(torch.isfinite(C).all()), f"finite K4 rotations ({name})")
        err = max(err, dT)
        work[name] = (args, cfg, iters)
        print(f"  K4 == plain: {name}: {tuple(args[0].shape)} -> {tuple(args[1].shape)}, "
              f"iterations {sorted(set(iters.tolist()))}, converged "
              f"{int(conv.sum())}/{len(conv)}, max |T diff| {dT:.3e}, max |pc diff| {dpc:.3e}")

    timed = {}
    for name in list(cases)[:2]:
        args, cfg, iters = work[name]
        ms = cuda_median_ms(lambda: fused_gn.fused_gn_solve(*args, cfg), warmup=3, iters=20)
        chain_ms = _chain_ms(lambda: fused_gn.fused_gn_solve(*args, cfg))
        plain_ms = cuda_median_ms(lambda: fused_gn.fused_gn_solve_plain(*args, cfg),
                                  warmup=1, iters=5)
        bound = _bound(*_k4_work(args, iters, 6 if cfg.icp_type == "pt2pl" else 3))
        timed[name] = {"ms": ms, "plain_ms": plain_ms, **bound}
        print(f"  {name}: K4 {ms:.4f} ms call by call ({chain_ms:.4f} ms back to back through "
              f"the wrapper; the difference {ms - chain_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"bound {bound['bound_ms']:.6f} ms ({bound['bound_by']}), "
              f"{float(iters.sum()):.0f} element-iterations")

    # the forward A/B at the headline's configuration, alternated in one process
    ab_cfg = {fused: head_cfg.with_(fused_small=fused) for fused in (True, False)}

    def forward(fused):
        with torch.no_grad():
            return register(src, tgt, ti, None, ab_cfg[fused])

    before = fused_gn.launches
    res_k, res_l = forward(True), forward(False)
    torch.cuda.synchronize()
    _check(fused_gn.launches == before + 1, "register(fused_small=True) launches K4 once")
    _check(torch.equal(res_k.iterations, res_l.iterations), "K4 and loop iterations equal")
    dT = float((res_k.T - res_l.T).abs().max())
    _check(dT < 1e-5, f"K4 and loop transforms within 1e-5: {dT}")
    ab = {True: [], False: []}
    for fused in (True, False, False, True):
        ab[fused].append(cuda_median_ms(lambda: forward(fused), warmup=1, iters=5))
    print(f"  forward A/B at B={B_HEAD} (headline config): register(fused_small=True) "
          f"{ab[True]} ms, loop {ab[False]} ms (order K4, loop, loop, K4); "
          f"iterations {float(res_k.iterations.max())}, |T diff| {dT:.3e}")
    head = timed[list(cases)[0]]
    print(f"phase 11 ok: K4 matches its plain version in {len(cases)} cases; headline "
          f"K4 {head['ms']:.4f} ms vs plain {head['plain_ms']:.4f} ms")
    return {"max_abs_err": err, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": None}


def _profile(fn, label: str, calls: int = 3, focus: tuple = ()) -> float:
    """Device busy share of ``calls`` calls under torch.profiler: the kernels'
    summed device time over the host wall time of the window (the profiler's
    own overhead included), the launches per call, the top kernels, and the
    share of device time of each kernel named in ``focus``.  Returns the
    device ops per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device's own rows (kernels, copies): CPU-op rows repeat their time
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    shares = {name: sum(e.self_device_time_total for e in rows if name in e.key) / 1e3
              / max(busy_ms, 1e-9) for name in focus}
    print(f"  profile of {label} ({calls} calls): wall {wall_ms / calls:.3f} ms, device busy "
          f"{busy_ms / calls:.3f} ms per call, busy share {busy_ms / wall_ms:.3f}; "
          f"{launches / calls:.0f} device ops per call; share of device time "
          + ", ".join(f"{name} {share:.3f}" for name, share in shares.items())
          + "; top: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / calls:.3f} ms x"
                      f"{e.count / calls:.0f}" for e in top))
    return launches / calls


def phase12_headline(device):
    """bench.py's headline through dicp_tpu_torch.bench (register_ift with K4
    as the forward; BENCH_FULL's unrolled and forward-only rates beside it),
    with this phase's own checks on what it returns; returns K4's launches
    in one call and the call."""
    out = bench.run(device, full=True, log=sys.stdout)
    src, tgt, ti = reference_batch(device)
    cfg = bench.head_config()

    def call():
        return bench.fwdbwd(register_ift, cfg, src, tgt, ti)

    _reset_launches()
    call()
    torch.cuda.synchronize()
    launches = _launches()["fused_gn"]
    _check(launches == 1, f"K4 launched once per call ({launches})")

    res, grad, grad_u = out["result"], out["grad_ift"], out["grad_unrolled"]
    xi = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=torch.float64)
    T_true = se3.tran_inv(se3.vec2tran(xi)).to(device)
    err = torch.linalg.vector_norm(
        se3.tran2vec(T_true @ torch.linalg.inv(res.T.detach().double())), dim=-1)
    _check(float(err.max()) < TOL_POSE, f"headline transform error {float(err.max())} < "
           f"{TOL_POSE}")
    _check(bool((grad != 0).any()), "IFT gradient nonzero")
    _check(bool((grad_u != 0).any()), "unrolled gradient nonzero")
    _, value_l, grad_l = bench.fwdbwd(register_ift, cfg.with_(fused_small=False), src, tgt, ti)
    cos_l = bench.cosine(grad, grad_l)
    print(f"  B={B_HEAD}: transform error {float(err.max()):.3e}, iterations "
          f"{out['iterations']}, sum(T) {float(res.T.detach().sum()):.6f} (loop forward "
          f"{float(value_l):.6f}); gradient cosine with the unrolled {out['cosine']:.8f}, "
          f"with the loop-forward IFT {cos_l:.8f}")
    ms, rate = out["ms"], out["rate"]
    print(f"pt2pl_diff_B256_fwdbwd_registrations_per_s = {rate} registrations/s "
          f"({ms} ms per forward+backward, median of the K4-forward IFT calls)")
    print(f"phase 12 ok: register_ift with K4 as the forward, {ms:.4f} ms per "
          f"forward+backward at B={B_HEAD} ({rate:.1f} registrations/s); K4 launches "
          f"{launches}")
    return launches, call


def _score_bound(n: int, m: int) -> dict:
    """K6/K7's bound: SCORE_OPS f32 operations per (query, column) pair;
    the two clouds read once, the index and the score written once."""
    return _bound(SCORE_OPS * n * m, 12.0 * (n + m) + 8.0 * n)


def _score_cases(cloud) -> list:
    """(name, queries, targets, (tq, tm) list, targets for the plain
    version or None) for phase 13."""
    base = cloud(3000)
    first = [SCORE_TILES[0]]
    # a NaN coordinate in one target point: the kernels skip its column, the
    # plain versions drop its target tile, so they are held to the plain
    # version with the point moved out of reach (|y|^2 overflows to inf)
    nan_y = cloud(5000)
    nan_x = cloud(1000)
    nan_x[:4] = nan_y[11:15] + 1e-3
    nan_y[10, 1] = np.nan
    far = nan_y.copy()
    far[10] = 1e30
    nan_q = cloud(1000)
    nan_q[7, 2] = np.nan
    return [
        ("4096 x 4096", cloud(4096), cloud(4096), SCORE_TILES, None),
        (f"{N_SCORE} x {N_SCORE}", cloud(N_SCORE), cloud(N_SCORE), first, None),
        ("m < tm: 1000 x 300", cloud(1000), cloud(300), first, None),
        ("m not a multiple of tm: 777 x 5001", cloud(777), cloud(5001), SCORE_TILES, None),
        ("tm not a multiple of 4 (K6's 4-byte copies): 777 x 5001", cloud(777), cloud(5001),
         [(256, 2047), (64, 1001)], None),
        ("n = 1", cloud(1), cloud(5000), first, None),
        ("n not a multiple of tq: 1000 x 5000 at 64 x 256", cloud(1000), cloud(5000),
         [(64, 256)], None),
        ("duplicated targets", base[:1000] + cloud(1000) * 2e-4,
         np.concatenate([base, base]), first, None),
        ("f64 inputs", cloud(2000, np.float64), cloud(3000, np.float64), first, None),
        (NAN_TARGET, nan_x, nan_y, [SCORE_TILES[0], (64, 1001)], far),
        ("a NaN query", nan_q, cloud(5000), first, None),
    ]


NAN_TARGET = "a NaN target point"


def phase13_score_kernels(device, libs: dict) -> dict:
    """K6 and K7 against their plain versions on the same card tensors, bit
    for bit; no register spills; timed at 100k x 100k, call by call and back
    to back."""
    exp_knn._kernels()  # load and bind
    report = _report(libs["score_nn"])
    print(f"  {libs['score_nn'].name}:\n{report}")
    for name, regs, _, _ in _no_spills(report, "score_nn"):
        print(f"  {name}: {regs} registers, no spills")
    rng = np.random.default_rng(SEED + 13)

    def cloud(n, dtype=np.float32):
        return rng.uniform(-50, 50, (n, 3)).astype(dtype)

    err = {"score_nn_v1": 0.0, "score_nn_v2": 0.0}
    for name, x_np, y_np, tiles, y_plain in _score_cases(cloud):
        x, y = to_torch(x_np, device), to_torch(y_np, device)
        yp = y if y_plain is None else to_torch(y_plain, device)
        for tq, tm in tiles:
            runs = [("score_nn_v1", exp_knn.nn_v1, exp_knn.nn_v1_plain, {})]
            if tm % 4 == 0:  # K7 takes tm a multiple of 4
                runs.append(("score_nn_v2", exp_knn.nn_v2, exp_knn.nn_v2_plain, {}))
            if (tq, tm) == SCORE_TILES[0]:
                runs.append(("score_nn_v1", exp_knn.nn_v1, exp_knn.nn_v1_plain,
                             {"semantics": True}))
            for kname, fn, plain_fn, kw in runs:
                idx_k, s_k = fn(x, y, tq=tq, tm=tm, **kw)
                idx_p, s_p = plain_fn(x, yp, tq=tq, tm=tm, **kw)
                torch.cuda.synchronize()
                what = f"{kname} {tq}x{tm}{' semantics' if kw else ''} ({name})"
                _check(idx_k.shape == (x.shape[0],) and idx_k.dtype == torch.int32,
                       f"{what}: (n,) int32 indices")
                _check(torch.equal(idx_k, idx_p), f"{what}: indices equal the plain version's")
                _check(torch.equal(s_k, s_p), f"{what}: scores bit-equal to the plain version's")
                if y_plain is None:
                    err[kname] = max(err[kname], _max_abs_diff(s_k, s_p))
                if name == "duplicated targets":
                    _check(bool((idx_k < len(y_np) // 2).all()),
                           f"{what}: ties to the first copy")
                if name == NAN_TARGET:
                    _check(idx_k[:4].tolist() == [11, 12, 13, 14], f"{what}: nearest found")
                    dropped = int((plain_fn(x, y, tq=tq, tm=tm, **kw)[0] != idx_k).sum())
                    _check(dropped > 0, f"{what}: the plain version drops the NaN's tile")
                    print(f"    {what}: the plain version on the NaN targets differs in "
                          f"{dropped} of {len(idx_k)} queries (its tile dropped)")
                if name == "a NaN query":
                    _check(int(idx_k[7]) == 0 and float(s_k[7]) == float("inf"),
                           f"{what}: a NaN query gives (inf, 0)")
        print(f"  K6, K7 == plain: {name}: {tuple(x.shape)} x {tuple(y.shape)} {x.dtype}, "
              f"tiles {list(tiles)}")

    x, y = (to_torch(cloud(N_SCORE), device) for _ in range(2))
    out = {}
    bound = _score_bound(N_SCORE, N_SCORE)
    ops = SCORE_OPS * N_SCORE * N_SCORE
    for kname, fn, plain_fn in (("score_nn_v1", exp_knn.nn_v1, exp_knn.nn_v1_plain),
                                ("score_nn_v2", exp_knn.nn_v2, exp_knn.nn_v2_plain)):
        ms = cuda_median_ms(lambda: fn(x, y), warmup=3, iters=20)
        chain_ms = _chain_ms(lambda: fn(x, y))
        plain_ms = cuda_median_ms(lambda: plain_fn(x, y), warmup=1, iters=3)
        out[kname] = {"max_abs_err": err[kname], "ms": ms, "plain_ms": plain_ms, **bound,
                      "library_ms": None}
        print(f"  {kname} at {N_SCORE} x {N_SCORE}, 256 x 2048: {ms:.4f} ms call by call "
              f"({chain_ms:.4f} ms back to back), plain {plain_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, {SCORE_OPS:.0f} f32 "
              f"operations per pair; {bound['bound_ms'] / chain_ms:.3f} of it back to back), "
              f"issue ceiling {_issue_ms(ops):.4f} ms ({chain_ms / _issue_ms(ops):.2f} x)")
    print("phase 13 ok: K6 and K7 bit-equal to their plain versions in every case, no "
          "register spills")
    return out


def phase14_exp_knn() -> dict:
    """The A/B entry point; returns the launches of its run."""
    _reset_launches()
    result = exp_knn.main(time_n=N_SCORE)
    torch.cuda.synchronize()
    launches = {"score_nn_v1": exp_knn.nn_v1.launches, "score_nn_v2": exp_knn.nn_v2.launches,
                "tiled_nn": tiled_knn.launches}
    _check(all(result["correct"].values()) and list(result["correct"]) == ["v0", "v1", "v2"],
           f"v0, v1 and v2 correct at 4096 x 4096: {result['correct']}")
    _check(len(result["ms"]) == 7, "seven rows timed")
    for name, count in launches.items():
        _check(count > 0, f"{name} launched by exp_knn.main() ({count})")
    print(f"phase 14 ok: exp_knn.main() correct for {list(result['correct'])}, seven rows "
          f"timed at {N_SCORE} x {N_SCORE}; launches {launches}")
    return launches


def phase15_gumbel(device, sources: np.ndarray, targets: np.ndarray) -> None:
    """Gumbel soft NN on the card: the headline solve with a seeded
    generator, and the streamed soft neighbour at phase 4's shape."""
    src, tgt, ti = reference_batch(device)
    solver = ICP(icp_type="pt2pl", differentiable=True, max_iterations=HEAD["max_iterations"],
                 tolerance=HEAD["tolerance"], device=device, use_gumbel=True)
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    t0 = time.perf_counter()
    res = solver.icp(src, tgt, ti, trim_dist=HEAD["trim_dist"],
                     loss_fn={"name": "huber", "metric": HEAD["loss_metric"]}, dim=HEAD["dim"],
                     key=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    xi = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=torch.float64)
    T_true = se3.tran_inv(se3.vec2tran(xi)).to(device)
    err = torch.linalg.vector_norm(
        se3.tran2vec(T_true @ torch.linalg.inv(res["T"].to(torch.float64))), dim=-1)
    _check(bool(torch.isfinite(res["T"]).all()), "finite Gumbel transforms")
    _check(float(err.max()) < TOL_GUMBEL,
           f"Gumbel transform error {float(err.max())} < {TOL_GUMBEL}")
    print(f"  ICP.icp(use_gumbel=True) at B={B_HEAD}: transform error max "
          f"{float(err.max()):.4e}, median {float(err.median()):.4e}; iterations "
          f"{float(res['stats']['iterations'].max())}; {wall:.3f} s (host clock)")

    x, y = to_torch(sources, device), to_torch(targets, device)
    n, m = x.shape[-2], y.shape[-2]
    _check(n * m > knn.DENSE_MAX_ENTRIES, "the soft neighbour streams at phase 4's shape")
    soft = knn.gumbel_nn(x, y, SEED + 15)
    lo, hi = y.amin(dim=-2, keepdim=True), y.amax(dim=-2, keepdim=True)
    slack = 1e-4 * float(y.abs().max())
    _check(soft.shape == y.shape[:1] + (n, y.shape[-1]) and bool(torch.isfinite(soft).all()),
           "a finite (B, n, 6) soft neighbour")
    _check(bool((soft >= lo - slack).all() and (soft <= hi + slack).all()),
           "the soft neighbour lies inside the targets' bounding box")
    ms = cuda_median_ms(lambda: knn.gumbel_nn(x, y, SEED + 15), warmup=1, iters=3)

    # a lattice of spacing 30 m: every query's nearest target is far nearer
    # than its next, so the softmax at tau 1e-3 is one-hot whatever the noise
    rng = np.random.default_rng(SEED + 15)
    grid = np.stack(np.meshgrid(*[np.arange(26)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lat = np.stack([grid[rng.permutation(len(grid))[:m]] * 30.0 for _ in range(len(sources))])
    lat_y = np.concatenate([lat + rng.normal(scale=0.01, size=lat.shape),
                            rng.normal(size=lat.shape)], axis=-1)
    pick = rng.integers(0, m, size=(len(sources), n))
    lat_x = np.take_along_axis(lat, pick[..., None], axis=1) + rng.normal(scale=2.0,
                                                                         size=(len(sources), n, 3))
    ly, lx = to_torch(lat_y, device), to_torch(lat_x, device)
    soft = knn.gumbel_nn(lx, ly, SEED + 16, tau=1e-3)
    hard = knn.find_nn_normalized(lx, ly, use_pallas=True)
    gap = float((soft - hard).abs().max())
    _check(gap <= 1e-4 * float(ly.abs().max()), f"lattice: soft NN equals hard NN ({gap})")
    print(f"phase 15 ok: Gumbel solve at B={B_HEAD}; streamed gumbel_nn at "
          f"{tuple(x.shape)} -> {tuple(y.shape)} {ms:.3f} ms (median of 3), inside the "
          f"box; on the lattice max |soft - hard| {gap:.3e}")


# --- phase 17: LiDAR odometry over raw 60k-point scans ------------------------

# benchmarks/bench_suite.py:585-660 (pipeline_stream): 64 raw scans of 60,000
# points read through ScanDataset(max_points=61440), moved along a constant
# step (benchmarks/exp_pipeline.py:50-51), pt2pt on the cluster tier
S_SEQ, N_SCAN, MAX_POINTS = 64, 60_000, 61_440
STEP_XI = (0.04, 0.02, 0.01, 0.004, 0.002, 0.01)
ODO_CFG = ICPConfig(icp_type="pt2pt", differentiable=False, max_iterations=30, tolerance=1e-5,
                    dim=3, trim_dist=1.0, loss_name="huber", loss_metric=0.5,
                    nn_method="cluster")
# (window, warm start, quantized) of the streamed modes
STREAM_MODES = ((1, True, False), (8, True, False), (8, False, False), (1, True, True))
TOL_REL, TOL_REL_Q16 = 1e-4, 1e-3   # bench_suite.py:657's bar for the quantized stream
TOL_ODO = 1e-5                      # batched odometry and resume against the streams
TOL_ATE = 1e-3
CLOSURE_GAP = 8
PROFILE_SCANS = 9                   # phase 16's profiled stream: 8 pairs


def write_sequence(directory: Path, rng: np.random.Generator):
    """S_SEQ scans of one lidar_scene as 4-column .bin files (x, y, z, 0):
    scan i is the scene seen from pose step^i.  Returns the true poses
    (S_SEQ, 4, 4) f64 and the step."""
    scene = lidar_scene(rng, N_SCAN)[:, :3]
    step = se3.vec2tran(torch.tensor(STEP_XI, dtype=torch.float64)).numpy()
    poses, T = [], np.eye(4)
    for i in range(S_SEQ):
        Ti = np.linalg.inv(T)
        scan = (scene @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
        io.save_bin(str(directory / f"{i:04d}.bin"),
                    np.hstack([scan, np.zeros((N_SCAN, 1), np.float32)]))
        poses.append(T)
        T = T @ step
    return np.stack(poses), step


def _stream_items(ds, weightless: bool):
    """(points (n, 3), weight) per scan; weightless, the zero-row pads are
    replaced by real rows first (bench_suite.py:608-617): pads at the
    origin would act as real points."""
    for pts, w in ds:
        p = pts[:, :3]
        if weightless:
            p = p.copy()
            pad = w == 0
            p[pad] = p[~pad][:int(pad.sum())]
            yield p, None
        else:
            yield p, w


def _rel_errors(rel: torch.Tensor, step: np.ndarray) -> torch.Tensor:
    """|log(rel step^-1)| per pair, in f64 on the host."""
    step_inv = torch.as_tensor(np.linalg.inv(step))
    return torch.linalg.vector_norm(se3.tran2vec(rel.detach().cpu().double() @ step_inv), dim=-1)


# the launcher of each kernel that a main path reaches through a module
# attribute (so that a recorder can stand in for it)
RECORDERS = {"tiled_nn": (tiled_knn, "_nn_distances_cuda"),
             "cluster_search": (cluster_search, "fused_search"),
             "cluster_topk": (cluster_search, "fused_topk"),
             "fused_gn": (fused_gn, "_fused_gn_cuda")}


@contextlib.contextmanager
def _recording(name: str, calls: dict):
    """While active, kernel ``name``'s launcher (``RECORDERS[name]``) also
    keeps copies of the arguments of its first and its latest call under
    "first" and "last" (one device copy per tensor argument per call).  A
    wrapper that counts its launches on its own attribute keeps its count:
    the count moves to the recorder and back."""
    owner, attr = RECORDERS[name]
    kernel = getattr(owner, attr)

    def record(*args):
        calls["last"] = tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a
                              for a in args)
        calls.setdefault("first", calls["last"])
        return kernel(*args)

    counted = hasattr(kernel, "launches")
    if counted:
        record.launches = kernel.launches
    # a captured program replays without Python: the recorded path's first
    # call is a miss, which runs it eagerly once and captures it anew
    jit.clear_caches()
    setattr(owner, attr, record)
    try:
        yield calls
    finally:
        setattr(owner, attr, kernel)
        if counted:
            kernel.launches = record.launches
        # the programs captured meanwhile hold the recorder's copies: drop them
        # (what a replay recorded stays, in tensors that outlive the programs)
        jit.clear_caches()


def _k1_duplicates(x, y, idx) -> str:
    """The targets' duplicated rows (a map's empty rows all sit on its
    sentinel): exact ties that K1 resolves to the first index, as the plain
    version does."""
    rows = y.reshape(-1, 3)
    uniq, counts = torch.unique(rows, dim=0, return_counts=True)
    dup = int(counts[counts > 1].sum())
    on_dup = int(torch.isin(idx.reshape(-1), torch.nonzero(
        (rows[:, None, :] == uniq[counts > 1][None]).all(-1).any(-1))[:, 0]).sum()) \
        if dup else 0
    return (f"{tuple(x.shape)} queries, {tuple(y.shape)} targets of which {dup} rows are "
            f"duplicates ({int((counts > 1).sum())} distinct points), {on_dup} queries "
            f"matched to a duplicated row")


def _k2_pads(args, got, pad_point, pad_label: str):
    """K2's groups whose points all sit on the pad point (``pad_point(points)``,
    None for the origin: phase 17's zero-row pads): their count and a report."""
    points, _, radius, xb, _ = args
    pad = (torch.zeros(3, dtype=points.dtype, device=points.device)
           if pad_point is None else pad_point(points))
    on_pad = (points == pad).all(-1).all(-1)                  # (..., G)
    radii = radius[on_pad]
    at_pad = (xb == pad).all(-1)
    return int(on_pad.sum()), (
        f"{int(on_pad.sum())} groups of pad rows {pad_label} (radius "
        f"{float(radii.max()) if radii.numel() else float('nan'):.3e} at most), "
        f"{int(at_pad.sum())} queries {pad_label}, {int((got[0] == 0).sum())} queries at "
        f"distance 0")


def _held_to_plain(name: str, recorded: dict, pads=None) -> float:
    """Kernel ``name`` against its plain version on the same card tensors, on
    each call recorded by :func:`_recording` (``recorded``: label -> calls):
    K1, K2 and K3 bit for bit, K4 with phase 11's gates (iterations,
    convergence and ratio equal, T within 1e-5).  Returns the largest
    |difference| (0 when equal).  ``pads`` = (pad_point, label), K2 only:
    gates that some recorded target holds a group of pad rows and reports
    them (``_k2_pads``)."""
    launcher = getattr(*RECORDERS[name])
    plain_of = {"tiled_nn": (tiled_knn.nn_distances_plain, ("index", "d2")),
                "cluster_search": (cluster_search.fused_search_plain, ("best", "row", "bound")),
                "cluster_topk": (cluster_search.fused_topk_plain, ("d2", "rows", "bound"))}
    err, pad_groups = 0.0, 0
    for label, calls in recorded.items():
        _check("first" in calls, f"{name} launched and recorded in {label}")
        for which in ("first", "last"):
            if which == "last" and calls["last"] is calls["first"]:
                continue
            args = calls[which]
            got = launcher(*args)
            where = f"the {which} {name} call of {label}"
            if name == "fused_gn":
                plain = fused_gn.fused_gn_solve_plain(*args[:6])
                for what, a, b in zip(("converged", "iterations", "matched ratio"),
                                      got[2:5], plain[2:5]):
                    _check(torch.equal(a, b), f"K4 {what} equal to the plain version's on "
                           f"{where}")
                dT = max(_max_abs_diff(got[0], plain[0]), _max_abs_diff(got[1], plain[1]))
                _check(dT < 1e-5, f"K4 T within 1e-5 of the plain version's on {where}: {dT}")
                err = max(err, dT)
                print(f"  {name} == plain on {where}: {tuple(args[0].shape)} -> "
                      f"{tuple(args[1].shape)}, max |T diff| {dT:.3e}")
                continue
            plain_fn, names = plain_of[name]
            plain = plain_fn(*args)
            torch.cuda.synchronize()
            for what, a, b in zip(names, got, plain):
                _check(torch.equal(a, b), f"{name} {what} bit-equal to the plain version's on "
                       f"{where}")
            if name == "tiled_nn":
                err = max(err, _max_abs_diff(got[1], plain[1]))
                print(f"  {name} == plain on {where}: {_k1_duplicates(*args, got[0])}")
                continue
            err = max(err, _max_abs_diff(got[0], plain[0]), _max_abs_diff(got[-1], plain[-1]))
            detail = f"xb {tuple(args[3].shape)}, G {args[0].shape[-3]}"
            if name == "cluster_search":
                detail += f", {int((got[0] <= got[2]).sum())}/{got[0].numel()} certified"
            if pads is not None:
                n_pad, report = _k2_pads(args, got, *pads)
                pad_groups += n_pad
                detail += f", {report}"
            print(f"  {name} == plain on {where}: {detail}")
    _check(pads is None or pad_groups > 0,
           f"the recorded {name} calls hold groups of pad rows {pads[1] if pads else ''}")
    return err


def phase17_lidar_odometry(device, workdir: Path):
    """The raw-scan odometry front end of the serving path; returns K2's
    launch counts, the W = 1 warm stream (for phase 16's profile) and K2's
    largest |difference| to its plain version on the path's own calls."""
    t_phase = time.perf_counter()
    poses_true, step = write_sequence(workdir, np.random.default_rng(SEED + 17))
    ds = io.ScanDataset.from_dir(str(workdir), max_points=MAX_POINTS, voxel=None,
                                 workers=4, prefetch=4)
    pairs = S_SEQ - 1
    native = io.native_available()   # builds the host runtime on first use
    host = list(ds)
    _check(len(host) == S_SEQ and host[0][0].shape == (MAX_POINTS, 4),
           f"{S_SEQ} scans of ({MAX_POINTS}, 4) from the dataset")
    _check(all(np.all(np.any(p[w > 0, :3] != 0, axis=1)) for p, w in host),
           "no real point lies exactly at the origin (zero rows are the pads)")
    passes = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in ds:
            pass
        passes.append((time.perf_counter() - t0) * 1e3 / S_SEQ)
    print(f"  native runtime available: {native}; ScanDataset alone "
          f"{statistics.median(passes):.3f} ms per scan (4 workers, prefetch 4; median of 3 "
          f"passes: {', '.join(f'{t:.3f}' for t in passes)})")

    def stream(window, warm, quant, scans=ds):
        res = stream_odometry(_stream_items(scans, quant), ODO_CFG, window=window,
                              warm_start=warm, quantize=quant, device=device)
        return res._replace(rel_transforms=res.rel_transforms.cpu())  # the host fetch

    launches = {}
    streams = {}
    rates = {}
    recorded = {}
    for window, warm, quant in STREAM_MODES:
        label = f"W={window} {'warm' if warm else 'cold'}{' quantized' if quant else ' f32'}"
        _reset_launches()
        if quant:
            res = stream(window, warm, quant)
        else:
            with _recording("cluster_search",
                        recorded.setdefault(f"the {label} stream", {})):
                res = stream(window, warm, quant)
        torch.cuda.synchronize()
        k2 = _launches()["cluster_search"]
        _check(k2 >= pairs // window, f"{label}: K2 launched ({k2})")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            stream(window, warm, quant)
            times.append(time.perf_counter() - t0)
        err = float(_rel_errors(res.rel_transforms, step).max())
        tol = TOL_REL_Q16 if quant else TOL_REL
        print(f"  stream {label}: {S_SEQ / statistics.median(times):.3f} frames/s (median of "
              f"3 after one run; runs {', '.join(f'{t:.4f}' for t in times)} s), rel err "
              f"{err:.3e}, iterations {float(res.iterations.float().mean()):.3f} per pair, "
              f"{int(res.converged.sum())}/{pairs} converged, K2 {k2 / pairs:.3f} launches "
              f"per pair")
        _check(err <= tol, f"{label}: rel err {err} <= {tol}")
        launches[label] = k2
        streams[(window, warm, quant)] = res
        rates[label] = S_SEQ / statistics.median(times)
    times = []
    for _ in range(3):   # the same stream without ScanDataset in the loop
        t0 = time.perf_counter()
        stream(1, True, False, host)
        times.append(time.perf_counter() - t0)
    print(f"  stream W=1 warm f32, the {S_SEQ} scans read before the run: "
          f"{S_SEQ / statistics.median(times):.3f} frames/s (runs "
          f"{', '.join(f'{t:.4f}' for t in times)} s), through ScanDataset "
          f"{rates['W=1 warm f32']:.3f}")

    # odometry takes no weights: the flag gives its zero-row pads the weight 0
    # that ScanDataset's weights give them in the streams
    cfg = ODO_CFG.with_(source_zeroes_are_pad=True)
    scans = torch.as_tensor(np.stack([p[:, :3] for p, _ in host]), device=device)
    cold = streams[(8, False, False)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    _reset_launches()
    t0 = time.perf_counter()
    odo = odometry(scans, cfg)
    torch.cuda.synchronize()
    odo_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    k2_odo = _launches()["cluster_search"]
    launches["batched odometry"] = k2_odo
    diff = float((odo.rel_transforms.cpu() - cold.rel_transforms).abs().max())
    same_iters = torch.equal(odo.iterations.cpu(), cold.iterations.cpu())
    same_conv = torch.equal(odo.converged.cpu(), cold.converged.cpu())
    print(f"  batched odometry: {pairs} pairs in one register call, {odo_s * 1e3:.3f} ms, "
          f"peak memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB held before), K2 {k2_odo} launches per call; against the "
          f"cold W=8 stream: max |rel diff| {diff:.3e}, iterations equal {same_iters}, "
          f"converged equal {same_conv}")
    _check(k2_odo > 0, "batched odometry launched K2")
    _check(same_iters and same_conv, "batched odometry's iterations and convergence equal "
           "the cold W=8 stream's")
    _check(diff <= TOL_ODO, f"batched odometry within {TOL_ODO} of the cold W=8 stream")
    with _recording("cluster_search", recorded.setdefault("a batched odometry call", {})):
        odometry(scans, cfg)   # outside the counted runs: only to record K2's arguments
    k2_err = _held_to_plain("cluster_search", recorded, pads=(None, "at the origin"))
    del recorded

    li = torch.arange(0, S_SEQ - CLOSURE_GAP, CLOSURE_GAP)
    closures = (li, li + CLOSURE_GAP)
    truth = torch.as_tensor(poses_true, device=device)
    graphs, pg_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        graphs.append(odometry_pose_graph(scans, cfg, loop_closures=closures))
        torch.cuda.synchronize()
        pg_s.append(time.perf_counter() - t0)
    same_bits = torch.equal(graphs[0].poses, graphs[1].poses)
    err_pg = float(ate(graphs[0].poses.double(), truth, align=False))
    err_odo = float(ate(odo.poses.double(), truth, align=False))
    print(f"  pose graph: {len(li)} loop closures (i, i+{CLOSURE_GAP}), odometry_pose_graph "
          f"{pg_s[1] * 1e3:.3f} ms (the first call in the process {pg_s[0] * 1e3:.3f} ms); "
          f"ATE (align=False) {err_pg:.3e} (odometry alone {err_odo:.3e}); two calls "
          f"bit-equal: {same_bits}")
    _check(err_pg < TOL_ATE, f"pose-graph ATE {err_pg} < {TOL_ATE}")

    ckpt = workdir / "odometry.npz"
    half = S_SEQ // 2       # an interrupted run over scans [0, half]
    resumable_odometry(scans[:half + 1], cfg, checkpoint_path=str(ckpt), chunk=16)
    _check(int(np.load(ckpt)["step"]) == half, f"the interrupted run checkpointed {half} pairs")
    resumed = resumable_odometry(scans, cfg, checkpoint_path=str(ckpt), chunk=16)
    diff_resume = float((resumed.poses - odo.poses).abs().max())
    print(f"  resume: {half} pairs, then all {pairs} from the checkpoint in chunks of 16; "
          f"max |pose diff| to one-shot odometry {diff_resume:.3e}")
    _check(diff_resume <= TOL_ODO, f"resumed poses within {TOL_ODO} of one-shot odometry")

    pts = scans[0]
    vox = [voxel_downsample(pts, 0.1) for _ in range(2)]
    cells = len(np.unique(np.floor(pts.cpu().numpy() / np.float32(0.1)).astype(np.int32),
                          axis=0))
    same_vox = all(torch.equal(a, b) for a, b in zip(*vox))
    print(f"  voxel grid: {MAX_POINTS} points at 0.1 m -> {int(vox[0].count)} cells "
          f"(numpy {cells}); two calls bit-equal: {same_vox}")
    _check(same_vox, "voxel_downsample gives the same bits twice")
    _check(int(vox[0].count) == cells, "voxel count equals numpy's count of distinct cells")

    src, tgt, ti = reference_batch(device)
    t0 = time.perf_counter()
    svd = pt2pt_svd_icp(src, tgt[..., :3], ti, max_iterations=100, tolerance=1e-10,
                        differentiable=False)
    torch.cuda.synchronize()
    svd_ms = (time.perf_counter() - t0) * 1e3
    xi = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=torch.float64)
    T_true = se3.tran_inv(se3.vec2tran(xi)).to(device)
    err_svd = torch.linalg.vector_norm(
        se3.tran2vec(T_true @ torch.linalg.inv(svd.T.double())), dim=-1)
    # tests/test_icp.py:210-223 in f64 (in f32, 32 power-iteration steps
    # leave ~5e-4 of this case unconverged)
    p = torch.as_tensor(np.random.default_rng(SEED).normal(size=(1, 200, 3)), device=device)
    Rz = torch.diag(torch.tensor([-1.0, -1.0, 1.0], dtype=torch.float64, device=device))
    C, r = svd_icp._kabsch(p, p @ Rz.T, torch.ones((1, 200), dtype=torch.float64,
                                                    device=device))
    err_180 = float((C[0] - Rz).abs().max())
    print(f"  SVD-ICP: B={B_HEAD} reference pair (dense), {svd_ms:.3f} ms, max transform "
          f"error {float(err_svd.max()):.3e}, iterations {int(svd.iterations.max())}; "
          f"180-degree Kabsch (f64) max |C - Rz| {err_180:.3e}")
    _check(float(err_svd.max()) < TOL_POSE, f"SVD-ICP error < {TOL_POSE}")
    _check(err_180 < 1e-6, "Kabsch recovers the 180-degree rotation")
    print(f"phase 17 ok: {S_SEQ} raw scans, K2 launches {launches}, "
          f"{time.perf_counter() - t_phase:.1f} s")
    # the captured 63-pair odometry program holds ~10 GiB of pools (phase 25)
    jit.clear_caches()
    # the profile's W = 1 stream is cut to PROFILE_SCANS scans: the profiler's
    # own processing of the full stream's ~95,000 device ops took ~50 s
    head = io.ScanDataset(ds.paths[:PROFILE_SCANS], max_points=MAX_POINTS, voxel=None,
                          workers=4, prefetch=4)
    return launches, lambda: stream(1, True, False, head), k2_err, host


# phase 18: the JAX suite's scan_to_map deployment (benchmarks/bench_suite.py:688-840),
# no cut: bench_suite's deployment, 12 scans of a 60,000-point wavy surface
# against a 65,536-row map (dicp_tpu_torch/benchmarks/bench_suite.py, S2M_*)
S_S2M, N_S2M = bench_suite.S2M_S, bench_suite.S2M_N
CAP_S2M, VOXEL_S2M, S2M_CFG = bench_suite.S2M_CAP, bench_suite.S2M_VOXEL, bench_suite.S2M_CFG
PROFILE_S2M_SCANS = 4               # phase 16's profiled scan-to-map stream


def _sentinel(points: torch.Tensor) -> torch.Tensor:
    """The map's empty-row sentinel hi + 2 extent + 1: the coordinate-wise
    largest row of a map target (the index's own pads at 1e15 left out)."""
    rows = points.reshape(-1, 3)
    return rows[(rows < ck.SENTINEL).all(-1)].amax(0)


def phase18_scan_to_map(device):
    """Scan-to-map odometry at the JAX suite's deployment, through
    bench_suite's host loop (its scan_to_map_60k, _sgd and _sgd_sub rows);
    returns K2's launches per stream, K2's largest |difference| on the
    path's own calls, D2's launches per stream and a short gn stream for
    phase 16's profile."""
    t_phase = time.perf_counter()
    seq = bench_suite.scan_to_map_sequence()
    scans, poses_true, step = seq
    launches, d2, recorded = {}, {}, {}

    @contextlib.contextmanager
    def first_run(label):
        _reset_launches()
        with (_recording("cluster_search",
                         recorded.setdefault("the gn scan-to-map stream", {}))
              if label == "scan_to_map_60k" else contextlib.nullcontext()):
            yield
        torch.cuda.synchronize()
        counts = _launches()
        launches[label], d2[label] = counts["cluster_search"], counts["threefry_randint"]

    out = bench_suite.scan_to_map_host_loop(device, seq=seq, first_run=first_run)
    # the quantized stream's bar: tests/test_mapping.py:146's
    quantized = (("gn, quantized", dict(quantize=True),
                  max(5 * out["scan_to_map_60k"]["ate"], 2e-3)),)
    out.update(bench_suite.scan_to_map_host_loop(device, variants=quantized, seq=seq,
                                                 first_run=first_run, emit=False))
    for label, o in out.items():
        res, k2, draws = o["first"], launches[label], d2[label]
        its = res.iterations[1:].double()
        print(f"  stream {label}: {S_S2M / statistics.median(o['ms']) * 1e3:.3f} frames/s "
              f"(median of {len(o['ms'])} after one run; runs "
              f"{', '.join(f'{t:.2f}' for t in o['ms'])} ms), final-pose error "
              f"{o['final_pose_err']:.3e}, ATE (align=False) {o['ate']:.3e}, "
              f"{int(res.converged.sum())}/{S_S2M} converged, iterations per scan "
              f"{float(its.mean()):.3f} (min {float(its.min()):.0f}, max "
              f"{float(its.max()):.0f}), K2 {k2 / (S_S2M - 1):.3f} launches per scan, D2 "
              f"{draws / (S_S2M - 1):.3f}")
        if "sgd" in label:
            _check(k2 == 0, f"{label}: the SGD mini-batch search runs no kernel ({k2})")
            _check(draws > 0, f"{label}: the mini-batches are drawn on the card by D2 "
                   f"({draws} launches)")
            same = all(torch.equal(r.poses, res.poses) for r in o["runs"])
            print(f"  {label}: four runs with one seed give equal poses, bit for bit: {same}")
            _check(same, f"{label}: two runs with one seed give the same poses")
        else:
            _check(k2 >= S_S2M - 1, f"{label}: K2 launched on every solved scan ({k2})")
    k2_err = _held_to_plain("cluster_search", recorded,
                            pads=(_sentinel, "on the map's sentinel"))
    gn = out["scan_to_map_60k"]["first"]

    # a mature map built by map_step over scans 0-10 at the gn stream's poses
    # (bench_suite.py's chained step: insert=True against insert=False)
    dev_scans = [torch.as_tensor(s, device=device) for s in scans]
    m = map_merge(empty_map(CAP_S2M, torch.float32, device), dev_scans[0], VOXEL_S2M,
                  mode="mean")
    step_dev = torch.as_tensor(step, dtype=torch.float32, device=device)
    for k in range(1, S_S2M - 1):
        t_pred = gn.poses[k - 1].to(device) @ step_dev
        _, _, _, m = map_step(m, dev_scans[k], t_pred, None, S2M_CFG, VOXEL_S2M,
                              merge_mode="mean")
    t_pred = gn.poses[S_S2M - 2].to(device) @ step_dev
    last = dev_scans[-1]

    def step_call(insert):
        return lambda: map_step(m, last, t_pred, None, S2M_CFG, VOXEL_S2M, insert=insert,
                                merge_mode="mean")

    pose, ok, iters, final_map = step_call(True)()
    full_ms = cuda_median_ms(step_call(True), warmup=1, iters=5)
    solve_ms = cuda_median_ms(step_call(False), warmup=1, iters=5)
    merge_ms = cuda_median_ms(lambda: map_merge(m, last @ pose[:3, :3].T + pose[:3, 3],
                                                VOXEL_S2M, mode="mean"), warmup=1, iters=5)
    occupied = final_map.count > 0
    n_occ = int(occupied.sum())
    empty_rows, rows = final_map.pos[~occupied], final_map.pos[occupied]
    beyond = bool((empty_rows > rows.amax(0)).all()) if empty_rows.numel() else True
    print(f"  mature map after {S_S2M} scans: {n_occ}/{CAP_S2M} occupied rows, "
          f"{CAP_S2M - n_occ} empty rows beyond the occupied box: {beyond}; map_step of scan "
          f"{S_S2M - 1} ({float(iters):.0f} iterations, converged {bool(ok)}): insert=True "
          f"{full_ms:.3f} ms, insert=False {solve_ms:.3f} ms (merge by difference "
          f"{full_ms - solve_ms:.3f} ms), map_merge of the {N_S2M}-point scan alone "
          f"{merge_ms:.3f} ms (CUDA events, median of 5)")
    _check(n_occ <= CAP_S2M, "the map holds at most its capacity")
    _check(beyond, "the map's empty rows sit beyond its occupied bounding box")
    print(f"phase 18 ok: {S_S2M} scans of {N_S2M} points against a {CAP_S2M}-row map, K2 "
          f"launches {launches}, D2 launches {d2}, {time.perf_counter() - t_phase:.1f} s")
    profile_seq = (scans[:PROFILE_S2M_SCANS], poses_true[:PROFILE_S2M_SCANS], step)
    return launches, d2, k2_err, lambda: bench_suite.scan_to_map_host_loop(
        device, variants=(("gn", {}, bench_suite.TOL_ATE_GN),), seq=profile_seq, reps=0,
        emit=False)


# --- phase 19: GICP and the multiscale pyramid at the JAX suite's deployments -----

# dicp_tpu_torch/benchmarks/exp_gicp.py (B = 64 pairs of a 600-point saddle,
# seed 11) and exp_multiscale.py (100k points of bench_suite's scene, FAR init)


def _log_err(T_true: np.ndarray, T_est: torch.Tensor) -> torch.Tensor:
    """|log(T_true T_est^-1)| per element, in f64 on the host."""
    T_est = T_est.detach().cpu().double()
    return torch.linalg.vector_norm(
        se3.tran2vec(torch.as_tensor(T_true) @ torch.linalg.inv(T_est)), dim=-1)


def phase19_gicp_multiscale(device) -> dict:
    """GICP (exp_gicp's rows) and the pyramid (exp_multiscale's rows);
    returns K2's launches per pyramid call and its largest |difference| on
    the pyramid's own calls."""
    t_phase = time.perf_counter()
    gicp = exp_gicp.main(device)
    S, Tg, Ti = gicp["inputs"]
    g_ift = gicp["grad_ift"]
    a = S.clone().requires_grad_(True)
    unrolled = register_gicp(a, Tg, Ti, max_iterations=30, tolerance=1e-6, differentiable=True)
    g_unr = torch.autograd.grad(unrolled.T.sum(), a)[0]
    cos = bench.cosine(g_ift, g_unr)
    print(f"  register_gicp_ift's gradient: cosine with the unrolled differentiable=True "
          f"gradient {cos:.6f}")
    _check(bool(torch.isfinite(g_unr).all()) and float(g_unr.abs().max()) > 0,
           "GICP unrolled gradient finite and nonzero")
    _check(cos > 0.99, f"GICP IFT gradient cosine with the unrolled one {cos} > 0.99")

    # tests/test_gicp.py:190: ~50 m radius in f32, the equilibrated solve
    rng = np.random.default_rng(3)
    xy = rng.uniform(-50, 50, size=(800, 2))
    wide = np.column_stack([xy, 0.02 * (xy[:, 0] ** 2 - xy[:, 1] ** 2) / 50.0]).astype(np.float32)
    T_w = se3.vec2tran(torch.tensor([0.3, -0.2, 0.1, 0.004, -0.003, 0.006],
                                    dtype=torch.float64)).numpy()
    src_w = (wide.astype(np.float64) @ T_w[:3, :3].T + T_w[:3, 3]).astype(np.float32)
    res_w = register_gicp(torch.as_tensor(src_w[None], device=device),
                          torch.as_tensor(wide[None], device=device),
                          torch.eye(4, dtype=torch.float32, device=device)[None],
                          max_iterations=60, tolerance=1e-7)
    finite = bool(torch.isfinite(res_w.T).all())
    err_w = float(_log_err(np.linalg.inv(T_w), res_w.T)[0])
    print(f"  GICP f32 at ~50 m radius: finite {finite}, error {err_w:.3e}")
    _check(finite and err_w < 5e-4, f"GICP f32 realistic radius: finite, error {err_w} < 5e-4")

    launches, recorded = {}, {}

    @contextlib.contextmanager
    def first_call(label):
        _reset_launches()
        with (_recording("cluster_search",
                         recorded.setdefault("the pyramid's full-resolution level", {}))
              if label == "pyramid" else contextlib.nullcontext()):
            yield
        torch.cuda.synchronize()
        launches[label] = _launches()["cluster_search"]

    exp_multiscale.main(device, first_call=first_call)
    k2_single, k2_pyr = launches["single"], launches["pyramid"]
    k2_err = _held_to_plain("cluster_search", recorded)
    print(f"  multiscale: K2 launches per call: single scale {k2_single}, pyramid {k2_pyr}")
    _check(k2_single > 0 and k2_pyr > 0, "K2 launched on both full-resolution solves")
    print(f"phase 19 ok: GICP and the pyramid, {time.perf_counter() - t_phase:.1f} s")
    return {"launches_per_multiscale_call": k2_pyr, "launches_single": k2_single,
            "k2_err": k2_err}


# --- phase 20: closed-loop SLAM at real scan size -----------------------------

# tests/test_slam.py:44-98's circuit and configuration with 60,000-point scans
# drawn from a 1,000,000-point world, two laps, and slam_odometry's default
# capacity of 8,192 rows: the front end on the tiled tier (K1), the closures
# against 60,000-row anchors on the cluster tier (K2)
N_SLAM, WORLD_SLAM, LAPS_SLAM, PER_LAP = 60_000, 1_000_000, 2, 32
SLAM_CFG = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=50, tolerance=1e-5,
                     dim=3, trim_dist=2.0, loss_name="huber", loss_metric=0.5,
                     collect_histories=False)
SLAM_KW = dict(capacity=8192, voxel=0.25, anchor_every=4, closure_gap=24, detect_every=2,
               detect_radius=5.0, accept_ratio=0.5, max_closures=100, closure_info=30.0,
               refine_iterations=25)
PROFILE_SLAM_SCANS = 6              # phase 16's SLAM stream (~10,700 ops per scan)
FUNCTORCH_SNIPPET = """
import json, time, torch
from dicp_tpu_torch import se3
from dicp_tpu_torch.odometry import PoseGraph
from dicp_tpu_torch.slam import refine_robust
dev = torch.device("cuda", 0)
torch.linalg.solve(torch.eye(6, device=dev), torch.ones(6, device=dev))
xi = torch.zeros((65, 6), device=dev)
xi[:, 0] = torch.arange(65, device=dev) * 0.1
poses = se3.vec2tran(xi)
i = torch.arange(64, device=dev)
graph = PoseGraph(torch.cat([i, i[:8]]), torch.cat([i + 1, i[:8] + 32]),
                  torch.cat([se3.compose(se3.tran_inv(poses[:-1]), poses[1:]),
                             se3.compose(se3.tran_inv(poses[:8]), poses[32:40])]),
                  torch.ones(72, device=dev))
torch.cuda.synchronize()
times = []
for _ in range(2):
    t0 = time.perf_counter()
    refine_robust(poses, graph, iterations=25)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
print(json.dumps(times))
"""


def slam_circuit(laps: float, partial: bool = False):
    """tests/test_slam.py's _make_scans at N_SLAM points per scan: local-frame
    f32 scans along a 5 m circle (scan radius 6 m, noise 0.04, seed 3) drawn
    without replacement from a WORLD_SLAM-point wavy surface; returns the
    scans, the truth in the scan-0 gauge and the scan-0 pose."""
    R, r, noise = 5.0, 6.0, 0.04
    wrng = np.random.default_rng(0)
    world = np.empty((WORLD_SLAM, 3))
    world[:, 0] = wrng.uniform(-R - 8, R + 8, WORLD_SLAM)
    world[:, 1] = wrng.uniform(-R - 8, R + 8, WORLD_SLAM)
    world[:, 2] = np.sin(world[:, 0] * 0.6) * np.cos(world[:, 1] * 0.5) * 1.5
    rng = np.random.default_rng(3)
    n_scans = int(laps * PER_LAP) + (0 if partial else 1)
    poses, scans = [], []
    for k in range(n_scans):
        th = 2 * np.pi * k / PER_LAP
        t = np.array([R * np.cos(th), R * np.sin(th), 0.0])
        yaw = th + np.pi / 2 + 0.05 * np.sin(k * 0.3)
        c, s = np.cos(yaw), np.sin(yaw)
        Rm = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = Rm, t
        idx = np.flatnonzero(np.linalg.norm(world[:, :2] - t[None, :2], axis=1) < r)
        sel = rng.choice(idx, N_SLAM, replace=len(idx) < N_SLAM)
        local = (world[sel] - t) @ Rm + rng.normal(scale=noise, size=(N_SLAM, 3))
        scans.append(local.astype(np.float32))
        poses.append(T)
    P = np.stack(poses)
    return scans, np.einsum("ij,kjl->kil", np.linalg.inv(P[0]), P), P[0]


@contextlib.contextmanager
def _timed_calls(module, name: str, log: list, kernel_counts: bool = False):
    """While active, each call of ``module.name`` is timed with CUDA events
    (ms appended to ``log``; with ``kernel_counts``, K2's launches in the
    call too, captured ones included: a host wait)."""
    fn = getattr(module, name)

    def timed(*args, **kw):
        k2 = _launches()["cluster_search"] if kernel_counts else 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        end.synchronize()
        log.append((start.elapsed_time(end), _launches()["cluster_search"] - k2)
                   if kernel_counts else start.elapsed_time(end))
        return out

    setattr(module, name, timed)
    try:
        yield log
    finally:
        setattr(module, name, fn)


def phase20_slam(device):
    """slam_odometry over two laps of 60,000-point scans (its front end's
    map_step, closures, anchors and residual norms captured programs);
    returns K1's launches per scan, K2's per closure attempt, the largest
    |difference| of each kernel on the path's own calls, a short stream for
    phase 16, the first run's result with the truth (phase 21's pose graph)
    and the scans (phase 24)."""
    t_phase = time.perf_counter()
    scans, poses_true, T0 = slam_circuit(LAPS_SLAM)
    S = len(scans)
    truth = torch.as_tensor(poses_true)
    t_gen = time.perf_counter() - t_phase

    def run(count=S, src=scans):
        res = slam.slam_odometry(((p, None) for p in src[:count]), SLAM_CFG, device=device,
                                 **SLAM_KW)
        return res._replace(poses=res.poses.cpu(), poses_front=res.poses_front.cpu())

    rec1, rec2, closure_log, step_log, refine_log = {}, {}, [], [], []
    _reset_launches()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_recording("tiled_nn", rec1.setdefault("the SLAM front end", {})))
        stack.enter_context(_recording("cluster_search",
                                       rec2.setdefault("the SLAM closure solves", {})))
        stack.enter_context(_timed_calls(slam, "_closure_solve", closure_log, True))
        stack.enter_context(_timed_calls(slam, "map_step", step_log))
        stack.enter_context(_timed_calls(slam, "refine_robust", refine_log))
        t0 = time.perf_counter()
        res = run()
        first_s = time.perf_counter() - t0
    counts = _launches()
    k1, k2 = counts["tiled_nn"], counts["cluster_search"]
    attempts = len(closure_log)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    a_front = float(ate(res.poses_front.double(), truth, align=False))
    a_ref = float(ate(res.poses.double(), truth, align=False))
    # |log(T_true^-1 T_rel)| per closure, as tests/test_slam.py:108-115
    errs = [float(torch.linalg.vector_norm(se3.tran2vec(
        torch.as_tensor(np.linalg.inv(poses_true[c.anchor_idx]) @ poses_true[c.scan_idx]).inverse()
        @ c.T_rel.cpu().double()))) for c in res.closures]
    its = res.iterations[1:].double()
    print(f"  SLAM, {LAPS_SLAM} laps x {PER_LAP} scans ({S}) of {N_SLAM} points from a "
          f"{WORLD_SLAM}-point world (built in {t_gen:.1f} s), capacity "
          f"{SLAM_KW['capacity']}: {S / statistics.median(times):.3f} frames/s (median of 3 "
          f"after one; runs {', '.join(f'{t:.3f}' for t in times)} s; the instrumented first "
          f"run {first_s:.3f} s)")
    print(f"  closures: {len(res.closures)} accepted of {attempts} attempts, pairs "
          f"{[(c.anchor_idx, c.scan_idx) for c in res.closures]}, ratios min "
          f"{min((c.matched_ratio for c in res.closures), default=float('nan')):.3f}, median "
          f"closure error {float(np.median(errs)) if errs else float('nan'):.3e}; ATE "
          f"(align=False) front {a_front:.4f} m, refined {a_ref:.4f} m; front-end iterations "
          f"per scan {float(its.mean()):.2f} (max {float(its.max()):.0f}), converged "
          f"{int(res.converged.sum())}/{S}")
    step_ms = statistics.median(step_log)
    closure_ms = statistics.median(t for t, _ in closure_log) if closure_log else float("nan")
    print(f"  per call (CUDA events, the first run): map_step {step_ms:.3f} ms (median of "
          f"{len(step_log)}), _closure_solve {closure_ms:.3f} ms (median of {attempts}), "
          f"refine_robust {', '.join(f'{t:.1f}' for t in refine_log)} ms; K1 "
          f"{k1 / (S - 1):.3f} launches per scan ({k1}), K2 "
          f"{k2 / max(attempts, 1):.3f} per closure attempt ({k2}; per attempt "
          f"{[n for _, n in closure_log]})")
    _check(len(res.closures) >= 1, "SLAM accepted a closure")
    for c in res.closures:
        _check(c.scan_idx - c.anchor_idx >= SLAM_KW["closure_gap"]
               and c.matched_ratio >= SLAM_KW["accept_ratio"],
               f"closure {c.anchor_idx} -> {c.scan_idx}: gap and ratio")
    _check(float(np.median(errs)) < 0.03, "median closure error < 0.03")
    _check(a_ref <= a_front + 1e-3, f"refined ATE {a_ref} <= front ATE {a_front} + 1e-3")
    _check(k1 >= S - 1, f"K1 launched on every front-end solve ({k1})")
    _check(k2 > 0 and k2 == sum(n for _, n in closure_log), "K2 launched only by the closures")
    k1_err = _held_to_plain("tiled_nn", rec1)
    k2_err = _held_to_plain("cluster_search", rec2)

    half, _, _ = slam_circuit(0.5, partial=True)
    res_half = run(len(half), half)
    print(f"  half lap ({len(half)} scans): {len(res_half.closures)} closures, refined poses "
          f"equal the front end's: {torch.equal(res_half.poses, res_half.poses_front)}")
    _check(len(res_half.closures) == 0 and torch.equal(res_half.poses, res_half.poses_front),
           "no closure without a revisit")
    proc = subprocess.run([sys.executable, "-c", FUNCTORCH_SNIPPET], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    _check(proc.returncode == 0, f"the cold refine_robust subprocess ran: {proc.stderr[-2000:]}")
    cold = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"  refine_robust in a fresh process (65 poses, 72 edges, 25 iterations, 2 passes): "
          f"first call {cold[0] * 1e3:.1f} ms (functorch's first use), second "
          f"{cold[1] * 1e3:.1f} ms")
    print(f"phase 20 ok: SLAM, {len(res.closures)} closures, K1 {k1} and K2 {k2} launches, "
          f"{time.perf_counter() - t_phase:.1f} s")
    return ({"launches": k1, "launches_per_slam_scan": k1 / (S - 1), "k1_err": k1_err},
            {"launches": k2, "launches_per_slam_closure": k2 / max(attempts, 1),
             "k2_err": k2_err}, lambda: run(PROFILE_SLAM_SCANS), (res, truth), scans)


def _collectives() -> dict:
    """The collectives ``parallel._comm`` counted, at once and in captured
    programs' replays: (kind, ranks, elements) -> count."""
    return dict(_comm.collectives())


def phase21_parallel(device, pair, T_pair: np.ndarray, sources: np.ndarray,
                     targets: np.ndarray, T_true: np.ndarray, raw_inputs, T_raw: np.ndarray,
                     slam_case) -> dict:
    """dicp_tpu_torch.parallel in a world of one rank on NCCL (make_mesh((1, 1))
    on the card), eager and captured: each solve's eager call held to its
    reference, then its program to the eager call (_captured_equals_eager:
    bit for bit, fresh inputs, no host wait, launches; collectives apart),
    then eager against captured in turns.  The solves: the map-sharded
    solve of phase 8's pair (K2 in every iteration; the group scan too) and
    its IFT gradient (the forward a replay), the ring at phase 4's shape,
    the batch-sharded solve of phase 9's batch, and the partitioned pose
    graph and refine_robust(mesh=...) of phase 20's graph.  The group is
    destroyed at the end.  Returns the phase's launches, K2's largest
    |difference| to its plain version and its launches per eager
    map-sharded call, and the map-sharded call (on a mesh given) for phase
    16's profile."""
    t_phase = time.perf_counter()
    mesh = make_mesh((1, 1))
    _check(dist.get_backend() == "nccl", f"the world of one runs on NCCL ({dist.get_backend()})")
    try:
        _reset_launches()
        calls, rec, out = _map_sharded_cases(device, mesh, pair, T_pair, sources, targets,
                                             T_true, raw_inputs, T_raw)
        calls.update(_partitioned_cases(device, mesh, slam_case))
        launches = _launches()
        k2_err = _held_to_plain("cluster_search", rec)
        for label, (eager_call, jitted_call) in calls.items():
            heavy = "refine_robust" in label or "pose graph" in label
            _alternated(label, eager_call, jitted_call, rounds=2,
                        iters=TURN_ITERS_HEAVY if heavy else 5)
        for info in jit.programs():
            print(f"  cached program {info.name}: {info.pool_bytes / 2**20:.1f} MiB of private "
                  f"pools, {info.replays} replays, key {str(info.key)[:140]}")
    finally:
        jit.clear_caches()
        dist.destroy_process_group()
    print(f"phase 21 ok: dicp_tpu_torch.parallel on NCCL (world of one), each program equal "
          f"to its eager form bit for bit, no host wait in a replay (collectives: "
          f"map_sharded_fn's fixed trip max_iterations + 1 per replay, the pose graph's as "
          f"eager); launches {launches}; {time.perf_counter() - t_phase:.1f} s")
    return {**out, "launches": launches, "k2_err": k2_err}


def _map_sharded_cases(device, mesh, pair, T_pair, sources, targets, T_true, raw_inputs,
                       T_raw) -> tuple:
    """map_sharded_fn's programs (map-sharded at phase 8's pair through K2,
    the ring at phase 4's shape, the sharded IFT's forward) and the
    batch-sharded solve (register_jit) at phase 9's batch: each eager call
    held to its reference (register's T and bits, the dense tier, the
    poses), then its program against it.  A map_sharded_fn replay runs
    max_iterations steps, each with its all-reduce (the fixed trip: CUDA
    refuses NCCL's kernels in a conditional node's body), the eager call
    the iterations it needs: their collectives are checked apart.  K2
    recorded on the eager map-sharded call; the IFT gradient against the
    unrolled one.  Returns the (eager, captured) calls, K2's recordings and
    what phase 21 returns of the map-sharded call."""
    calls, rec = {}, {}
    src, target = pair
    n, m = src.shape[0], target.shape[0]
    ti = torch.eye(4, dtype=torch.float32, device=device)
    src2 = _fresh(src, 260)
    _check(CFG_MAP.resolved_nn_method(n, m, device) == "cluster", "phase 8's pair is cluster-tier")

    def ms(s=src, cfg=CFG_MAP):
        return register_map_sharded(mesh, s, target, ti, cfg=cfg)

    # the eager solve: K2 once per iteration and once in the final cost pass,
    # one all-reduce per iteration and one in the cost pass
    _comm.reset_counts()
    before = _launches()["cluster_search"]
    with _recording("cluster_search", rec.setdefault("the map-sharded solve", {})):
        res = _eager(ms)()
        torch.cuda.synchronize()
    k2_map = _launches()["cluster_search"] - before
    counts = _collectives()
    it = int(res.iterations)
    ref = register(src[None], target[None], ti[None], None, CFG_MAP)
    rot, trans = pose_errors(torch.as_tensor(T_pair[None], device=device),
                             res.T[None].to(torch.float64))
    diff = float((res.T - ref.T[0]).abs().max())
    print(f"  map-sharded {n} -> {m} pt2pl (cluster tier), eager: {it} iterations, converged "
          f"{bool(res.converged)}, rotation error {float(rot[0]):.3e} rad, translation error "
          f"{float(trans[0]):.3e} m, |T - register's T| {diff:.3e} (register: "
          f"{int(ref.iterations[0])} iterations); K2 {k2_map} launches; collectives {counts}")
    _check(bool(res.converged), "the map-sharded solve converged")
    _check(float(rot[0]) < TOL_POSE and float(trans[0]) < TOL_POSE,
           f"map-sharded errors < {TOL_POSE}")
    _check(diff < 1e-4, "map-sharded T within 1e-4 of register's (the same fixed point)")
    _check(k2_map == it + 1, f"K2 launched once per iteration and in the cost pass ({k2_map}, "
           f"{it} iterations)")
    _check(sum(counts.values()) == it + 1
           and all(kind == "all_reduce" and numel <= 2 * (36 + 6 + 1) + 1
                   for kind, _, numel in counts), "one all-reduce of <= 87 elements per "
           "iteration and one in the cost pass")
    res_x = _eager(lambda: ms(cfg=CFG_MAP.with_(sharded_fused=False)))()
    diff_x = float((res_x.T - res.T).abs().max())
    print(f"  sharded_fused=False (the group scan): {int(res_x.iterations)} iterations, "
          f"converged {bool(res_x.converged)}, |T - K2 path's T| {diff_x:.3e}")
    _check(int(res_x.iterations) == it and bool(res_x.converged) == bool(res.converged)
           and diff_x < 1e-4, "the group-scan path gives K2's T, iterations and convergence")
    label = (f"register_map_sharded, phase 8's {n} -> {m} pair (cluster tier, K2; NCCL world "
             f"of one)")
    calls[label] = (_eager(ms), ms)
    _captured_equals_eager(label, *calls[label], sharding.map_sharded_fn(mesh, CFG_MAP),
                           (_eager(lambda: ms(src2)), lambda: ms(src2)))
    _fixed_trip_collectives(label, calls[label], CFG_MAP)

    # the ring at phase 4's shape (the dense tile fits; no kernel)
    s4, t4 = to_torch(sources[0], device), to_torch(targets[0], device)
    s4b = _fresh(s4, 261)

    def ring(s=s4):
        return register_ring_sharded(mesh, s, t4, cfg=CFG_RING)

    _comm.reset_counts()
    before = _launches()
    ring_res = _eager(ring)()
    ring_counts, ring_launches = _collectives(), _delta(before, _launches())
    dense = _eager(lambda: register_map_sharded(mesh, s4, t4,
                                                cfg=CFG_RING.with_(nn_method="dense")))()
    rot4, trans4 = pose_errors(torch.as_tensor(T_true[:1], device=device),
                               ring_res.T[None].to(torch.float64))
    diff4 = float((ring_res.T - dense.T).abs().max())
    print(f"  ring {tuple(s4.shape)} -> {tuple(t4.shape)}, eager: {int(ring_res.iterations)} "
          f"iterations, |T - dense map-sharded T| {diff4:.3e}, rotation error "
          f"{float(rot4[0]):.3e}, translation error {float(trans4[0]):.3e}; collectives "
          f"{ring_counts}; kernel launches {ring_launches}")
    _check(diff4 < 1e-5, "ring T within 1e-5 of the dense map-sharded T")
    _check(float(rot4[0]) < TOL_POSE and float(trans4[0]) < TOL_POSE, "ring errors < 1e-3")
    _check(not ring_launches, "the ring runs no kernel")
    label_r = f"register_ring_sharded, phase 4's {tuple(s4.shape)} -> {tuple(t4.shape)}"
    calls[label_r] = (_eager(ring), ring)
    _captured_equals_eager(label_r, *calls[label_r],
                           sharding.map_sharded_fn(mesh, CFG_RING, target_sharded=True),
                           (_eager(lambda: ring(s4b)), lambda: ring(s4b)))
    _fixed_trip_collectives(label_r, calls[label_r], CFG_RING)

    # batch-sharded at phase 9's batch: register's bits, K2, no collective
    s9, t9 = raw_inputs
    ti9 = torch.eye(4, dtype=torch.float32, device=device).expand(s9.shape[0], 4, 4)
    s9b = _fresh(s9, 262)
    cfg9 = CFG_MAP.with_(collect_histories=True)

    def batch(s=s9):
        return register_batch_sharded(mesh, s, t9, ti9, cfg=cfg9)

    _comm.reset_counts()
    before = _launches()["cluster_search"]
    res_b = _eager(batch)()
    torch.cuda.synchronize()
    k2_batch, batch_counts = _launches()["cluster_search"] - before, _collectives()
    ref_b = register(s9, t9, ti9, None, cfg9)
    rot9, trans9 = pose_errors(torch.as_tensor(T_raw, device=device), res_b.T.to(torch.float64))
    print(f"  batch-sharded {tuple(s9.shape)} -> {tuple(t9.shape)}, eager: T bit-equal to "
          f"register's {torch.equal(res_b.T, ref_b.T)}, K2 {k2_batch} launches, collectives "
          f"{batch_counts}, max rotation error {float(rot9.max()):.3e}")
    _check(torch.equal(res_b.T, ref_b.T), "batch-sharded T bit-equal to register's")
    _check(k2_batch > 0, "K2 launched by the batch-sharded solve")
    _check(not batch_counts, "no collective in the batch-sharded solve")
    _check(float(rot9.max()) < TOL_POSE and float(trans9.max()) < TOL_POSE,
           "batch-sharded errors < 1e-3")
    label_b = f"register_batch_sharded, phase 9's {tuple(s9.shape)} -> {tuple(t9.shape)} (K2)"
    calls[label_b] = (_eager(batch), batch)
    _captured_equals_eager(label_b, *calls[label_b], _register_captured,
                           (_eager(lambda: batch(s9b)), lambda: batch(s9b)),
                           counter=_launches_and_collectives)

    # the sharded IFT: its forward a program, its gradient against the
    # unrolled one
    cfg_d = CFG_MAP.with_(differentiable=True)

    def ift(s=src):
        return register_map_sharded_ift(mesh, s, target, ti, cfg=cfg_d)

    label_i = "register_map_sharded_ift's forward, phase 8's pair"
    fn_d = sharding.map_sharded_fn(mesh, cfg_d.with_(driver="while"))
    calls[label_i] = (_eager(ift), ift)
    _captured_equals_eager(label_i, *calls[label_i], fn_d,
                           (_eager(lambda: ift(src2)), lambda: ift(src2)))
    _fixed_trip_collectives(label_i, calls[label_i], cfg_d)
    probe = torch.linspace(0.5, 1.5, 16, device=device).reshape(4, 4)

    def grad_of(fn):
        s = src.clone().requires_grad_(True)
        r = fn(mesh, s, target, ti, cfg=cfg_d)
        return torch.autograd.grad(torch.sum(r.T * probe), s)[0]

    _comm.reset_counts()
    with _eager_programs():
        s = src.clone().requires_grad_(True)
        r_i = register_map_sharded_ift(mesh, s, target, ti, cfg=cfg_d)
        fwd = _collectives()
        _comm.reset_counts()
        g_eager = torch.autograd.grad(torch.sum(r_i.T * probe), s)[0]
        torch.cuda.synchronize()
        bwd = _collectives()
        g_u = grad_of(register_map_sharded)
    prog = next(reversed(fn_d.cache.values()))
    replays = prog.replays
    g_i = grad_of(register_map_sharded_ift)
    _check(prog.replays == replays + 1, "the IFT gradient's forward replays the program")
    cos = bench.cosine(g_i, g_u)
    _check(torch.equal(g_i, g_eager), "the IFT gradient with a captured forward equals the "
           "eager forward's bit for bit")
    _check(bool(torch.isfinite(g_i).all()) and bool((g_i != 0).any()) and cos > 0.99,
           f"IFT gradient finite, nonzero, cosine {cos} > 0.99")
    print(f"  sharded IFT: {int(r_i.iterations)} iterations, converged {bool(r_i.converged)}; "
          f"the gradient with a captured forward equals the eager forward's bit for bit; "
          f"cosine with the unrolled one {cos:.6f}, |g| {float(g_i.norm()):.3e}; eager "
          f"forward collectives {fwd}, the backward added {bwd}")
    label_g = "register_map_sharded_ift forward + gradient (captured forward)"
    calls[label_g] = (_eager(lambda: grad_of(register_map_sharded_ift)),
                      lambda: grad_of(register_map_sharded_ift))
    return calls, rec, {"launches_per_map_sharded_call": k2_map, "iterations": it,
                        "call": lambda mesh_: register_map_sharded(mesh_, src, target, ti,
                                                                   cfg=CFG_MAP)}


# --- phase 22: the bench entry, the suite's rows and the examples ---------------

# rows of bench_suite.ALL measured by earlier phases: scan_to_map's host
# loop by phase 18, the exp_gicp and exp_multiscale rows of solvers by phase 19
SUITE_ROWS = ("svd_pair", "pt2pl_pair", "batch256", "large_cloud", "normals", "odometry",
              "capacity", "pipeline", "scan_to_map", "solvers")
# the rows and examples whose first and last call of each kernel they launch
# are recorded and held to the plain versions
RECORD_ROWS = {"large_cloud": ("tiled_nn", "cluster_search", "cluster_topk"),
               "normals": ("cluster_search",), "capacity": ("fused_gn",),
               "pipeline": ("tiled_nn", "cluster_search"),
               "large_cloud_demo": ("cluster_search",), "odometry_demo": ("tiled_nn",),
               "serving_demo": ("cluster_search",)}
EXAMPLES = {"large_cloud_demo": large_cloud_demo, "odometry_demo": odometry_demo,
            "serving_demo": serving_demo, "slam_demo": slam_demo}


def phase22_bench_suite_examples(device) -> dict:
    """dicp_tpu_torch.bench in this process, every row of bench_suite.ALL
    that no earlier phase measures, and the four examples; the kernels'
    launches per row and example, and K1-K4 held to their plain versions on
    the first and last calls recorded from the rows and examples of
    ``RECORD_ROWS``."""
    t_phase = time.perf_counter()
    per_row, seconds, errs = {}, {}, {}

    def counted(label, fn, record=()):
        _reset_launches()
        t0 = time.perf_counter()
        calls = {name: {} for name in record}
        with contextlib.ExitStack() as stack:
            for name in record:
                stack.enter_context(_recording(name, calls[name]))
            out = fn()
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        per_row[label] = {k: v for k, v in _launches().items() if v}
        print(f"  {label}: {seconds[label]:.1f} s, kernel launches {per_row[label]}", flush=True)
        for name, recorded in calls.items():
            errs[name] = max(errs.get(name, 0.0), _held_to_plain(name, {label: recorded}))
        return out

    line = counted("bench", lambda: bench.main(device))
    _check(line["metric"] == bench.METRIC and line["value"] > 0,
           f"dicp_tpu_torch.bench printed {bench.METRIC}: {line}")
    _check(per_row["bench"].get("fused_gn", 0) > 0, "K4 launched by dicp_tpu_torch.bench")
    rows = {}
    # one timed run of each pipeline configuration after its warm-up (the
    # suite's 3 would take ~40 s more)
    pipe_reps, bench_suite.PIPE_REPS = bench_suite.PIPE_REPS, 1
    for name in SUITE_ROWS:
        if name == "scan_to_map":
            fn = lambda: bench_suite.bench_scan_to_map(device, loop=False)   # noqa: E731
        elif name == "solvers":
            fn = lambda: bench_suite.bench_solvers(device, delegates=("exp_sgd",))  # noqa: E731
        else:
            fn = functools.partial(bench_suite.ALL[name], device)
        rows[name] = counted(name, fn, RECORD_ROWS.get(name, ()))
    bench_suite.PIPE_REPS = pipe_reps
    n_rows = sum(len(r) for r in rows.values())
    for name, kernels in (("large_cloud", ("tiled_nn", "cluster_search", "cluster_topk")),
                          ("capacity", ("fused_gn",))):
        for k in kernels:
            _check(per_row[name].get(k, 0) > 0, f"{k} launched by the {name} row")
    results = {}
    for name, module in EXAMPLES.items():
        results[name] = counted(name, lambda module=module: module.main(device),
                                RECORD_ROWS.get(name, ()))
    _check(per_row["large_cloud_demo"].get("cluster_search", 0) > 0,
           "K2 launched by the large-cloud demo")
    print(f"  examples: {json.dumps(results)}")

    # utils.profiling and visualization on card tensors, after every timing
    # of this phase (a profiler slows host-bound timings after it)
    src, tgt, ti = reference_batch(device)

    def head_call():
        return bench.fwdbwd(register_ift, bench.head_config(), src, tgt, ti)[2]

    stats = profiling.benchmark(head_call, n=5)
    print(f"  utils.profiling.benchmark of one headline fwd+bwd: {stats}")
    _check(stats["n"] == 5 and 0 < stats["min_s"] <= stats["mean_s"], "benchmark() statistics")
    with tempfile.TemporaryDirectory(prefix="dicp_trace_") as log_dir:
        with profiling.trace(log_dir):
            head_call()
            torch.cuda.synchronize()
        traces = sorted(Path(log_dir).rglob("*.pt.trace.json*"))
        text = "".join(f.read_text(errors="replace") for f in traces if f.suffix == ".json")
        print(f"  utils.profiling.trace wrote {[f.name for f in traces]} "
              f"({sum(f.stat().st_size for f in traces)} bytes)")
        _check(bool(traces) and "fused_gn_kernel" in text,
               "the trace holds K4 under its launcher's name (fused_gn_kernel)")
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print("  visualization: matplotlib is not installed here; plot_overlay not driven")
        else:
            png = Path(log_dir) / "overlay.png"
            visualization.plot_overlay(src[0], tgt[0, :, :3], file_name=str(png))
            _check(png.stat().st_size > 0, "plot_overlay wrote a PNG from card tensors")
            print(f"  visualization.plot_overlay of card tensors: {png.stat().st_size} bytes")
    print(f"phase 22 ok: dicp_tpu_torch.bench, {n_rows} suite rows of {len(SUITE_ROWS)} names "
          f"here (scan_to_map's host loop in phase 18, "
          f"exp_gicp and exp_multiscale in phase 19), the four examples; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": per_row, "seconds": seconds, "max_abs_err": errs}



# phase 23: the captured programs (dicp_tpu_torch.jit) against the eager port
STREAM_W = 8                        # phase 23's windows-in-flight stream
# phases 3, 4 and 8-9's solves in phases 23 and 24
CFG_REF = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=100, tolerance=1e-6,
                    dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0)
CFG_SLICE = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=50,
                      tolerance=1e-6, dim=3, trim_dist=2.0, loss_name="huber", loss_metric=0.5)
CFG_RAW = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30, tolerance=1e-5,
                    dim=3, trim_dist=2.0, loss_name="huber", loss_metric=1.0,
                    cluster_probes=PROBES, cluster_group=GROUP)


@contextlib.contextmanager
def _no_host_wait():
    """torch's sync debug mode at "error": a synchronising call raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _leaves(out, name: str = "") -> list:
    """(name, tensor) of every tensor in ``out``: a tensor, or a tuple of
    them, nested (NamedTuples by field, others by position)."""
    if isinstance(out, torch.Tensor):
        return [(name or "result", out)]
    if not isinstance(out, tuple):
        return []
    keys = out._fields if hasattr(out, "_fields") else [f"[{i}]" for i in range(len(out))]
    return [leaf for key, x in zip(keys, out)
            for leaf in _leaves(x, f"{name}.{key}" if name else key)]


def _fresh(x: torch.Tensor, seed: int, scale: float = 1e-3) -> torch.Tensor:
    """``x`` moved by seeded normal noise of ``scale``: a fresh input of the
    same shape, dtype and device."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    return x + scale * torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)


def _diff_fields(eager, got) -> dict:
    """Fields of ``got`` that differ from ``eager``, with their max |difference|."""
    return {name: _max_abs_diff(a.detach().double(), b.detach().double())
            for (name, a), (_, b) in zip(_leaves(eager), _leaves(got))
            if not torch.equal(a, b)}


def _delta(before: dict, after: dict) -> dict:
    """The counts that moved from ``before`` to ``after``, by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _counted(call, counter=None):
    """(call's result, the kernels' launches it ran (``counter``'s counts:
    default :func:`_launches`), host seconds to its end)."""
    counter = counter or _launches
    before = counter()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, _delta(before, counter()), seconds


def _captured_equals_eager(label: str, eager_call, jitted_call, jitted, fresh=None,
                           counter=None, replayed=None) -> int:
    """Two replays of a fresh capture and the replay of a second fresh
    capture equal the eager result bit for bit in every field, each replay
    run under the sync debug mode's "error" (a host wait raises), and each
    replay launches each kernel as often as the eager call (its captured
    launches count on the card, per replay and per loop iteration run).
    ``fresh`` = (eager call, jitted call) on other inputs of the same shapes:
    the jitted call must replay the second capture (no new program) and
    equal the eager call on those inputs, under the same gates.  Prints the
    cost of a first call (the eager warm-up and the capture) beside the
    eager call's and the program's pools.  Returns the host waits per
    replay (0).  ``counter``: what "launches" counts (default
    :func:`_launches`; :func:`_launches_and_collectives` adds the
    collectives).  ``replayed(launches)``: what a replay launches where an
    eager call launches ``launches`` (default the same)."""
    counter = counter or _launches
    replayed = replayed or (lambda launches: launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eager, want, eager_s = _counted(eager_call, counter)
    eager_peak = torch.cuda.max_memory_allocated() - base
    outs, firsts, pools = [], [], []
    for replays in (2, 1):
        jitted.cache_clear()
        _, first, first_s = _counted(jitted_call, counter)   # a miss: the eager warm-up, the capture
        firsts.append(first_s)
        pools.append(next(reversed(jitted.cache.values())).pool_bytes)
        _check(first == want, f"{label}: the first call launches what eager does "
               f"({first} vs {want})")
        for _ in range(replays):
            before = counter()
            with _no_host_wait():
                outs.append(jitted_call())
            got = _delta(before, counter())
            _check(got == replayed(want), f"{label}: a replay launches "
                   f"{replayed(want)} (eager {want}), got {got}")
    for k, got in enumerate(outs):
        diff = _diff_fields(eager, got)
        _check(not diff, f"{label}: replay {k} equals the eager call bit for bit "
               f"(differing: {diff})")
    fresh_note = ""
    if fresh is not None:
        eager_fresh, want_fresh, _ = _counted(fresh[0], counter)
        _check(bool(_diff_fields(eager, eager_fresh)), f"{label}: the fresh inputs give "
               f"other results")
        prog = next(reversed(jitted.cache.values()))
        programs, replays, before = len(jitted.cache), prog.replays, counter()
        with _no_host_wait():
            got = fresh[1]()
        launched = _delta(before, counter())
        _check(len(jitted.cache) == programs and prog.replays == replays + 1,
               f"{label}: the fresh inputs replay the program")
        _check(launched == replayed(want_fresh), f"{label}: the fresh replay launches "
               f"{replayed(want_fresh)} (eager {want_fresh}), got {launched}")
        diff = _diff_fields(eager_fresh, got)
        _check(not diff, f"{label}: the fresh replay equals the eager call on the fresh "
               f"inputs bit for bit (differing: {diff})")
        fresh_note = (f"; a replay on fresh inputs of the same shapes equals a fresh eager "
                      f"call bit for bit (launches {want_fresh}, as eager)")
    print(f"  {label}: {len(outs)} replays (two of one capture, one of a second) equal the "
          f"eager call bit for bit in {', '.join(n for n, _ in _leaves(eager))}{fresh_note}; "
          f"host waits per replay 0 (sync debug mode 'error'); launches per replay "
          f"{replayed(want)} (eager {want}); "
          f"first call (eager run + capture) {', '.join(f'{t * 1e3:.3f}' for t in firsts)} ms "
          f"against {eager_s * 1e3:.3f} ms eager (one call each, cold); program pools "
          f"{', '.join(f'{b / 2**20:.1f}' for b in pools)} MiB against the eager call's "
          f"peak of {eager_peak / 2**20:.1f} MiB above what it was given")
    return 0


def _capture_repairs(device, head_inputs, cfg3) -> None:
    """The capture-safety repairs on the card: solve_ex(check_errors=False)
    gives torch.linalg.solve's bits; the dim-2 mask and the absolute damping
    built on the card equal the host-built tensors they replace; and the
    reference pair with solve_method='lu' and tikhonov captured equals
    eager under the sync debug mode's "error"."""
    from dicp_tpu_torch.registration import _damping, _zmask

    rng = np.random.default_rng(SEED + 23)
    for dtype in (torch.float32, torch.float64):
        for k in (3, 6):
            J = torch.as_tensor(rng.normal(size=(B_HEAD, 40, k)), dtype=dtype, device=device)
            A = J.transpose(1, 2) @ J + 1e-3 * torch.eye(k, dtype=dtype, device=device)
            b = torch.as_tensor(rng.normal(size=(B_HEAD, k, 1)), dtype=dtype, device=device)
            _check(torch.equal(torch.linalg.solve(A, b),
                               torch.linalg.solve_ex(A, b, check_errors=False)[0]),
                   f"solve_ex has linalg.solve's bits ({dtype}, k = {k})")
        for cols in (3, 6):
            old = torch.tensor([1.0, 1.0, 0.0] * (cols // 3), dtype=dtype, device=device)
            _check(torch.equal(_zmask(cols, dtype, device), old), "the dim-2 mask's bits")
        A = torch.eye(6, dtype=dtype, device=device)[None]
        _check(torch.equal(_damping(ICPConfig(tikhonov=1e-9), A),
                           torch.tensor(1e-9, dtype=dtype, device=device)),
               "the absolute damping's bits")
    cfg = cfg3.with_(solve_method="lu", tikhonov=1e-9)
    _captured_equals_eager("phase 3's pair, solve_method='lu', tikhonov 1e-9",
                           functools.partial(register, *head_inputs, None, cfg),
                           functools.partial(register_jit, *head_inputs, None, cfg),
                           _register_captured)
    print("  repairs: solve_ex(check_errors=False) equals linalg.solve bit for bit (f32, "
          "f64; k = 3, 6); the dim-2 mask and the absolute damping built on the card "
          "equal the host-built tensors")


@contextlib.contextmanager
def _eager_windows():
    """pipeline's window solve uncaptured, on register's eager loop."""
    solve, program = pipeline._window_solve, pipeline._register_program
    pipeline._window_solve, pipeline._register_program = pipeline._window_program, register
    try:
        yield
    finally:
        pipeline._window_solve, pipeline._register_program = solve, program


def _stream_rel(host, window: int):
    res = stream_odometry(_stream_items(host, False), ODO_CFG, window=window, warm_start=True,
                          device=torch.device("cuda", 0))
    return res._replace(rel_transforms=res.rel_transforms.cpu(), poses=res.poses.cpu())


def _windows_in_flight(host, window: int):
    """A captured W-window stream fed from host scans under the sync debug
    mode's "error" (the upload ring's event wait is no torch sync); after
    each window is yielded (its replay enqueued), whether the previous
    window's completion event had not yet fired.  Returns (windows in
    flight, windows, rel transforms fetched after the loop)."""
    events, rels = [], []
    in_flight = 0
    with _no_host_wait():
        for T, _, _ in stream_registrations(_stream_items(host, False), ODO_CFG,
                                            window=window, warm_start=True,
                                            device=torch.device("cuda", 0)):
            if events and not events[-1].query():
                in_flight += 1
            event = torch.cuda.Event()
            event.record()
            events.append(event)
            rels.append(T)
    return in_flight, len(events), torch.cat(rels).cpu()   # the final fetch


TURN_BUDGET_MS = 400.0    # eager ms that one visit of the turns may spend


def _alternated(label: str, eager_call, jitted_call, unit: float = 0.0, what: str = "",
                rounds: int = 2, iters: int = 5) -> dict:
    """ms per call, eager and captured in turns (E C C E for ``rounds`` =
    2, ``iters`` calls a visit), CUDA events around each call
    (bench.time_alternated with max_ms=TURN_BUDGET_MS: one eager call timed
    first is eager's warm-up and sets the depth, a visit spends at most
    TURN_BUDGET_MS of eager calls, an eager call slower than that takes two
    rounds; the captured call is warmed up once, before its first visit)."""
    times = bench.time_alternated({"eager": eager_call, "captured": jitted_call},
                                  torch.device("cuda", 0), iters=iters, rounds=rounds,
                                  max_ms=TURN_BUDGET_MS)
    med = {k: statistics.median(v) for k, v in times.items()}
    rate = (f"; {unit / med['eager'] * 1e3:.1f} -> {unit / med['captured'] * 1e3:.1f} {what}"
            if unit else "")
    print(f"  {label}: eager {med['eager']:.4f} ms, captured {med['captured']:.4f} ms per call "
          f"(medians of {len(times['eager'])}; ranges {min(times['eager']):.4f}-"
          f"{max(times['eager']):.4f} and {min(times['captured']):.4f}-"
          f"{max(times['captured']):.4f}){rate}")
    return med


def phase23_captured(device, head_inputs, slice_inputs, pair, raw_inputs, host) -> dict:
    """register_jit, the headline unit captured (bench.fwdbwd_jit) and the
    pipeline's window solve against the eager port on the card; returns the
    launches of the captured programs and the programs' callables for
    phase 16's profiles."""
    t_phase = time.perf_counter()
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}: the solve's loop is a "
          f"CUDA graph conditional WHILE node (csrc/graph_while.cu)")
    cfg3, cfg4, cfg8 = CFG_REF, CFG_SLICE, CFG_RAW
    eye = lambda b: torch.eye(4, dtype=torch.float32, device=device).expand(b, 4, 4)  # noqa: E731
    src8, tgt8 = pair
    solves = {
        "phase 3 (B=256 reference pair, dense tier)": (*head_inputs, cfg3),
        f"phase 4 ({B} x {N_SRC} -> {M_TGT}, tiled tier)": (*slice_inputs, eye(B), cfg4),
        f"phase 8 ({src8.shape[0]} -> {tgt8.shape[0]}, cluster tier)":
            (src8[None], tgt8[None], eye(1), cfg8),
        f"phase 9 ({B_RAW} x {N_RAW} -> {M_RAW}, cluster tier)": (*raw_inputs, eye(B_RAW), cfg8),
    }
    _reset_launches()
    calls = {}
    for k, (label, (s, t, ti, cfg)) in enumerate(solves.items()):
        eager_call = functools.partial(register, s, t, ti, None, cfg)
        jitted_call = functools.partial(register_jit, s, t, ti, None, cfg)
        s2 = _fresh(s, 230 + k)
        fresh = (functools.partial(register, s2, t, ti, None, cfg),
                 functools.partial(register_jit, s2, t, ti, None, cfg))
        _captured_equals_eager(label, eager_call, jitted_call, _register_captured, fresh)
        calls[label] = (eager_call, jitted_call)
    # one device loop per batch chunk: a program of more than 64 loops
    hs3, ht3, hti3 = head_inputs
    cfg_chunks = cfg3.with_(batch_chunk=3)
    chunks = -(-hs3.shape[0] // cfg_chunks.batch_chunk)
    _check(chunks > 64, f"{chunks} chunks, more than 64 loops in one program")
    _captured_equals_eager(f"phase 3's pair, batch_chunk=3 ({chunks} device loops in one "
                           f"program)", functools.partial(register, hs3, ht3, hti3, None,
                                                          cfg_chunks),
                           functools.partial(register_jit, hs3, ht3, hti3, None, cfg_chunks),
                           _register_captured)
    # K2 sets its dynamic shared memory attribute at each launch, on the host:
    # an eager launch at phase 9's smaller size between phase 8's capture and
    # its replay must not break the replay
    label8, label9 = list(solves)[2:4]
    calls[label8][1]()                      # phase 8's program, captured anew
    register(*solves[label9][:3], None, solves[label9][3])
    with _no_host_wait():
        got = calls[label8][1]()
    _check(not _diff_fields(calls[label8][0](), got), "phase 8's replay after an eager "
           "phase-9 launch of K2 equals the eager call")
    print(f"  K2's cudaFuncSetAttribute: legal under capture, and phase 8's replay after an "
          f"eager phase-9 K2 launch (a smaller shared-memory size) equals the eager call")
    _capture_repairs(device, head_inputs, cfg3)
    hcfg = bench.head_config()
    hs, ht, hti = head_inputs[0], head_inputs[1], head_inputs[2]
    head_eager = functools.partial(bench.fwdbwd, register_ift, hcfg, hs, ht, hti)
    head_jitted = functools.partial(bench.fwdbwd_jit, hs, ht, hti, hcfg)
    hs2 = _fresh(hs, 234)
    _captured_equals_eager("phase 12 headline unit (register_ift fwd+bwd, K4 forward)",
                           head_eager, head_jitted, bench.fwdbwd_jit,
                           (functools.partial(bench.fwdbwd, register_ift, hcfg, hs2, ht, hti),
                            functools.partial(bench.fwdbwd_jit, hs2, ht, hti, hcfg)))

    with _eager_windows():
        eager_stream = _stream_rel(host, STREAM_W)
    pipeline._window_solve.cache_clear()
    captured = [_stream_rel(host, STREAM_W) for _ in range(2)]   # a miss, then replays
    for k, got in enumerate(captured):
        for field in ("rel_transforms", "iterations", "converged", "poses"):
            a, b = getattr(eager_stream, field), getattr(got, field).to(getattr(
                eager_stream, field).device)
            _check(torch.equal(a, b), f"W={STREAM_W} stream run {k}: captured {field} equal "
                   f"to the eager stream's ({_max_abs_diff(a.double(), b.double())})")
    print(f"  W={STREAM_W} stream of {S_SEQ} scans: every relative pose, iteration count, "
          f"convergence flag and composed pose of two captured runs (the first captures) "
          f"equal the eager stream's bit for bit")
    in_flight, windows, rel = _windows_in_flight(host, STREAM_W)
    _check(torch.equal(rel, eager_stream.rel_transforms),
           "the windows-in-flight stream's relative poses equal the eager stream's")
    print(f"  windows in flight: in {in_flight} of {windows - 1} windows the host enqueued "
          f"window w + 1 before window w's completion event had fired; the feed loop ran "
          f"under the sync debug mode's 'error' (no synchronising call but the upload ring's "
          f"event wait and the final fetch)")
    _check(in_flight >= 1, "at least one window enqueued while the previous one ran")

    # phase 17's 63-pair batched solve through register_jit: the eager solve's
    # peak memory beside the captured program's private pools
    scans = torch.as_tensor(np.stack([p[:, :3] for p, _ in host]), device=device)
    args = (scans[1:], scans[:-1], eye(S_SEQ - 1), None,
            ODO_CFG.with_(source_zeroes_are_pad=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    eager = register(*args)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated(device) - base
    _register_captured.cache_clear()
    register_jit(*args)
    program = jit.programs()[-1]
    with _no_host_wait():
        got = register_jit(*args)
    diff = _diff_fields(eager, got)
    _check(not diff, f"the 63-pair batched solve: captured equals eager ({diff})")
    print(f"  {S_SEQ - 1}-pair batched solve (phase 17's odometry): captured equals eager bit "
          f"for bit; eager peak {eager_peak / 2**30:.3f} GiB above the tensors held before, "
          f"the captured program's private pools {program.pool_bytes / 2**30:.3f} GiB")
    del scans, args, eager, got
    _register_captured.cache_clear()
    launches = _launches()

    # (d) times, eager against captured, alternated in one process
    for label, (eager_call, jitted_call) in calls.items():
        _alternated(label, eager_call, jitted_call)
    _alternated("phase 12 headline unit", head_eager, head_jitted, unit=B_HEAD,
                what="registrations/s")
    for window in (1, STREAM_W):
        def eager_run(w=window):
            with _eager_windows():
                return _stream_rel(host, w)
        _stream_turns(f"W={window} warm stream of {S_SEQ} host scans",
                      {"eager": eager_run, "captured": functools.partial(_stream_rel, host, window)},
                      S_SEQ)
    for info in jit.programs():
        print(f"  cached program {info.name}: {info.pool_bytes / 2**20:.1f} MiB of private "
              f"pools, {info.replays} replays, key {str(info.key)[:140]}")
    print(f"phase 23 ok: captured programs equal the eager port bit for bit, no host wait in "
          f"a replay, {in_flight} windows in flight; launches in the captured runs {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    first = next(iter(calls.values()))
    return {"launches": launches, "slice": calls[list(calls)[1]], "head": (head_eager, head_jitted),
            "first": first}


# phase 24: Anderson, scan-to-map's map_step/map_merge, SLAM's closure programs
# and SVD-ICP as captured programs against their eager forms

# the suite's pt2pt_pair_aa_m3 row and batch256_ift_aa_m3 unit
# (dicp_tpu_torch/benchmarks/bench_suite.py::bench_solvers)
AA_PAIR_CFG = ICPConfig(icp_type="pt2pt", differentiable=False, max_iterations=100,
                        tolerance=1e-6, dim=2, trim_dist=5.0, loss_name="huber",
                        loss_metric=1.0, collect_histories=False, anderson_m=3)
AA_IFT_CFG = ICPConfig(icp_type="pt2pl", differentiable=True, driver="while", max_iterations=100,
                       tolerance=1e-6, dim=2, trim_dist=5.0, loss_name="huber",
                       loss_metric=1.0, collect_histories=False, anderson_m=3)
VAR_STEP = 500                      # the variable-length stream: scan k has N_S2M - 500 k points
SLAM_TURN_SCANS = PER_LAP + 1       # SLAM's eager/captured turns: one lap


@contextlib.contextmanager
def _eager_programs():
    """The eager forms of the captured programs: every jitted function
    uncaptured (jit.disable_jit), and the solves of mapping's, slam's and
    odometry's programs on register's eager loop (as _eager_windows does for
    the pipeline)."""
    saved = mapping._register_program, slam._register_program, odo_mod._register_program
    mapping._register_program = slam._register_program = odo_mod._register_program = register
    try:
        with jit.disable_jit():
            yield
    finally:
        mapping._register_program, slam._register_program, odo_mod._register_program = saved


def _eager(call):
    """``call`` run under :func:`_eager_programs`."""
    def run():
        with _eager_programs():
            return call()
    return run


def _literal_repairs(device) -> None:
    """The host-literal repairs hold their bits on the card: Anderson's
    history solve through solve_ex(check_errors=False) against
    torch.linalg.solve at (N, m, m), m = 3, 4; its energy sentinel by
    torch.full against the copied literal; _kabsch's seeds built on the
    card against the copied literal rows; se3._homogeneous against its
    assignment of a host 1.0, unbatched and batched."""
    rng = np.random.default_rng(SEED + 24)
    for dtype in (torch.float32, torch.float64):
        for m in (3, 4):
            dF = torch.as_tensor(rng.normal(size=(B_HEAD, m, 6)), dtype=dtype, device=device)
            f = torch.as_tensor(rng.normal(size=(B_HEAD, 6)), dtype=dtype, device=device)
            A = torch.einsum("nme,nke->nmk", dF, dF)
            lam = 1e-8 * torch.amax(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1, keepdim=True)
            A = A + lam[..., None] * torch.eye(m, dtype=dtype, device=device)
            b = torch.einsum("nme,ne->nm", dF, f)[..., None]
            _check(torch.equal(torch.linalg.solve(A, b),
                               torch.linalg.solve_ex(A, b, check_errors=False)[0]),
                   f"solve_ex has linalg.solve's bits at Anderson's (N, {m}, {m}) ({dtype})")
        big = torch.finfo(dtype).max
        old = torch.tensor(big, dtype=dtype, device=device).expand(B_HEAD).clone()
        _check(torch.equal(torch.full((B_HEAD,), big, dtype=dtype, device=device), old),
               "Anderson's energy sentinel's bits")
        rows = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 1.0, 1.0], [0.0, 1.0, -1.0, 0.0],
                             [0.0, 1.0, 0.0, -1.0]], dtype=dtype, device=device)
        _check(torch.equal(svd_icp._seeds(dtype, device), rows / svd_icp._norm(rows)),
               "_kabsch's seeds' bits")
        for lead in ((), (B_HEAD,)):
            rot = torch.as_tensor(rng.normal(size=lead + (3, 3)), dtype=dtype, device=device)
            t = torch.as_tensor(rng.normal(size=lead + (3,)), dtype=dtype, device=device)
            top = torch.cat([rot, t[..., None]], dim=-1)
            bottom = torch.zeros_like(top[..., :1, :])
            bottom[..., 0, 3] = 1.0
            _check(torch.equal(se3._homogeneous(rot, t), torch.cat([top, bottom], dim=-2)),
                   f"se3._homogeneous's bits (batch {lead})")
    print("  repairs: solve_ex(check_errors=False) equals linalg.solve bit for bit at "
          "Anderson's (256, m, m), m = 3, 4 (f32, f64); the energy sentinel by torch.full, "
          "_kabsch's seeds and se3._homogeneous's [0, 0, 0, 1] row built on the card equal "
          "the host literals and host-scalar assignment they replace")


def _record_captured(name: str, label: str, call, recorded: dict) -> None:
    """Kernel ``name``'s first and last call recorded (:func:`_recording`)
    over a miss of ``call`` (the eager run, the capture) and one replay, so
    that the last holds what a replay launched."""
    with _recording(name, recorded.setdefault(label, {})):
        call()
        call()


STREAM_BUDGET_S = 5.0   # an eager stream slower than this is timed once


def _stream_turns(label: str, runs: dict, scans: int, warm: bool = True) -> dict:
    """frames/s of each run in ``runs`` (eager, captured), in turns E C C E,
    each visit one untimed run then one timed (``warm``), or one timed run
    (the programs already captured, or never reused); E C where the first
    timed eager run takes more than STREAM_BUDGET_S."""
    rates = {k: [] for k in runs}
    turns = ["eager", "captured", "captured", "eager"]
    while turns:
        turn = turns.pop(0)
        if warm:
            runs[turn]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[turn]()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rates[turn].append(scans / seconds)
        if turn == "eager" and len(rates["eager"]) == 1 and seconds > STREAM_BUDGET_S:
            turns = ["captured"]
    med = {k: statistics.median(v) for k, v in rates.items()}
    print(f"  {label}: eager {med['eager']:.3f}, captured {med['captured']:.3f} frames/s "
          f"(medians of {len(rates['eager'])} runs in turns; eager "
          f"{', '.join(f'{r:.2f}' for r in rates['eager'])}; captured "
          f"{', '.join(f'{r:.2f}' for r in rates['captured'])})")
    return med


def _steps_of(run) -> list:
    """(arguments, eager output, launches) of each map_step call of ``run()``
    under :func:`_eager_programs`, the tensors copied (the upload ring
    reuses its buffers)."""
    steps, fn = [], mapping.map_step

    def spy(*args, **kw):
        before = _launches()
        out = fn(*args, **kw)
        launched = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
        steps.append((pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                                      else x, (args, kw)), out, launched))
        return out

    mapping.map_step = spy
    try:
        with _eager_programs():
            result = run()
    finally:
        mapping.map_step = fn
    return steps, result


def _steps_replayed(label: str, steps: list) -> None:
    """Each recorded step through the captured map_step: the first a miss,
    each later one a replay on that step's inputs, under the sync debug
    mode's "error", equal to the eager step bit for bit and launching what
    it launched."""
    map_step.cache_clear()
    for k, ((args, kw), want, launched) in enumerate(steps):
        before = _launches()
        with _no_host_wait() if k else contextlib.nullcontext():
            got = map_step(*args, **kw)
        diff = _diff_fields(want, got)
        _check(not diff, f"{label}: step {k + 1} captured equals eager ({diff})")
        got_l = {n: v - before[n] for n, v in _launches().items() if v != before[n]}
        _check(got_l == launched, f"{label}: step {k + 1} launches ({got_l} vs {launched})")
    _check(len(map_step.cache) == 1, f"{label}: one program for the stream")
    print(f"  {label}: each of the {len(steps)} steps through the captured map_step (one "
          f"capture, {len(steps) - 1} replays on the next steps' inputs under sync debug mode "
          f"'error') equals the eager step bit for bit in pose, convergence, iterations and "
          f"every map field, with the eager step's launches")


def _scan_to_map_cases(device, record: dict):
    """The phase-18 gn stream, f32 and quantized: each step held, the
    streams held, map_merge alone and the variable-length stream; returns
    the (eager, captured) calls and streams for the turns."""
    scans, _, _ = bench_suite.scan_to_map_sequence()

    def stream(quantize=False, src=scans):
        res = mapping.scan_to_map_odometry(((s, None) for s in src), S2M_CFG,
                                           capacity=CAP_S2M, voxel=VOXEL_S2M,
                                           quantize=quantize, device=device)
        return tuple(a.cpu() for a in res)

    calls, streams = {}, {}
    for quantize in (False, True):
        label = f"scan-to-map gn stream{', quantized' if quantize else ''}"
        steps, eager = _steps_of(functools.partial(stream, quantize))
        _steps_replayed(label, steps)
        if not quantize:
            f32_steps = steps
            _record_captured("cluster_search", "the captured map_step",
                             functools.partial(map_step, *steps[5][0][0], **steps[5][0][1]),
                             record)
        for k in range(2):
            diff = _diff_fields(eager, stream(quantize))
            _check(not diff, f"{label}: captured run {k} equals the eager run ({diff})")
        print(f"  {label}: two captured runs of {S_S2M} scans equal the eager run bit for bit "
              f"in poses, relative poses, convergence and iterations")
        (args, kw), _, _ = steps[5]
        (args2, kw2), _, _ = steps[6]
        _captured_equals_eager(f"map_step, {label}, step 6", _eager(
            lambda: map_step(*args, **kw)), lambda: map_step(*args, **kw), map_step,
            (_eager(lambda: map_step(*args2, **kw2)), lambda: map_step(*args2, **kw2)))
        calls[f"{label}: map_step, step 6"] = (_eager(lambda a=args, k=kw: map_step(*a, **k)),
                                               lambda a=args, k=kw: map_step(*a, **k))
        streams[label] = {"eager": _eager(functools.partial(stream, quantize)),
                          "captured": functools.partial(stream, quantize)}

    # map_merge alone at the stream's size: a mature map and the posed scan
    (args, _), (pose, _, _, _), _ = f32_steps[-1]
    m = args[0]
    world = args[1][:, :3] @ pose[:3, :3].T + pose[:3, 3]
    (args2, _), (pose2, _, _, _), _ = f32_steps[-2]
    world2 = args2[1][:, :3] @ pose2[:3, :3].T + pose2[:3, 3]
    with _no_host_wait():
        map_merge.fn(m, world, VOXEL_S2M, mode="mean")
    print("  the eager map_merge (normals, three stable argsorts, searchsorted, "
          "segment_reduce(unsafe=True), scatter_reduce amax) ran under sync debug mode 'error': "
          "no host wait")
    merge = (_eager(lambda: map_merge(m, world, VOXEL_S2M, mode="mean")),
             lambda: map_merge(m, world, VOXEL_S2M, mode="mean"))
    _captured_equals_eager(f"map_merge of {N_S2M} points into a {CAP_S2M}-row map", *merge,
                           map_merge, (_eager(lambda: map_merge(args2[0], world2, VOXEL_S2M,
                                                                mode="mean")),
                                       lambda: map_merge(args2[0], world2, VOXEL_S2M,
                                                         mode="mean")))
    calls[f"map_merge of {N_S2M} points into a {CAP_S2M}-row map"] = merge

    # a stream whose scan length changes every scan: a program per length
    var = [s[:N_S2M - VAR_STEP * k] for k, s in enumerate(scans)]
    map_step.cache_clear()
    firsts = []
    with _timed_calls(mapping, "map_step", firsts):
        stream(src=var)
    pools = [p.pool_bytes for p in jit.programs() if p.name == "map_step"]
    eager_steps = []
    with _eager_programs(), _timed_calls(mapping, "map_step", eager_steps):
        stream(src=var)
    print(f"  variable-length stream ({S_S2M} scans of {N_S2M} - {VAR_STEP} k points): every "
          f"captured step a first call (eager run + capture), median "
          f"{statistics.median(firsts):.3f} ms (range {min(firsts):.3f}-{max(firsts):.3f}) "
          f"against eager steps' {statistics.median(eager_steps):.3f} ms; the {len(pools)} "
          f"programs the LRU keeps hold {', '.join(f'{b / 2**20:.1f}' for b in pools)} MiB")
    streams[f"variable-length scan-to-map stream ({S_S2M} scans)"] = {
        "eager": _eager(lambda: stream(src=var)), "captured": lambda: stream(src=var)}
    map_step.cache_clear()
    return calls, streams


def _slam_cases(device, slam_case, scans):
    """SLAM's programs on phase 20's circuit: _closure_solve (on two of
    phase 20's closures), _make_anchor, _edge_residual_norms and a
    front-end map_step (tiled tier) held one by one; then one lap with
    eager programs against one with captured programs (front-end and
    refined trajectories, convergence, iterations, closures).  Returns the
    (eager, captured) calls and the lap's runs for the turns."""
    res_c, _ = slam_case
    lap = scans[:SLAM_TURN_SCANS]

    def run(eager=False):
        call = lambda: slam.slam_odometry(((p, None) for p in lap), SLAM_CFG,  # noqa: E731
                                          device=device, **SLAM_KW)
        return (_eager(call) if eager else call)()

    poses = res_c.poses_front.to(device)
    dev_scans = [torch.as_tensor(p, device=device) for p in scans]
    closure_cfg = SLAM_CFG.with_(trim_dist=SLAM_CFG.trim_dist * 4.0)
    c1 = res_c.closures[0]
    c2 = res_c.closures[-1] if len(res_c.closures) > 1 else c1._replace(
        scan_idx=c1.scan_idx - SLAM_KW["detect_every"])
    calls = {}

    def closure_call(c):
        anchor = slam._make_anchor.fn(dev_scans[c.anchor_idx], poses[c.anchor_idx], True)
        args = (anchor, poses[c.anchor_idx], dev_scans[c.scan_idx], poses[c.scan_idx],
                closure_cfg, SLAM_CFG)
        return _eager(lambda: slam._closure_solve(*args)), lambda: slam._closure_solve(*args)

    calls["_closure_solve"] = closure_call(c1)
    _captured_equals_eager(f"_closure_solve ({N_SLAM} points against a {N_SLAM}-row anchor, "
                           f"two cluster-tier solves)", *calls["_closure_solve"],
                           slam._closure_solve, closure_call(c2))

    def anchor_call(j):
        args = (dev_scans[j], poses[j], True)
        return _eager(lambda: slam._make_anchor(*args)), lambda: slam._make_anchor(*args)

    calls["_make_anchor"] = anchor_call(0)
    _captured_equals_eager(f"_make_anchor ({N_SLAM} points, weighted normals)",
                           *calls["_make_anchor"], slam._make_anchor, anchor_call(4))
    graph = slam.build_pose_graph(poses, res_c.closures, SLAM_KW["closure_info"],
                                  converged=res_c.converged)

    def norms_call(p):
        args = (p, graph.edges_i, graph.edges_j, graph.t_meas)
        return (_eager(lambda: slam._edge_residual_norms(*args)),
                lambda: slam._edge_residual_norms(*args))

    calls["_edge_residual_norms"] = norms_call(poses)
    _captured_equals_eager(f"_edge_residual_norms ({graph.edges_i.shape[0]} edges)",
                           *calls["_edge_residual_norms"], slam._edge_residual_norms,
                           norms_call(res_c.poses.to(device)))

    # one lap, eager (its front-end step at scan k_step kept) and captured
    k_step, steps, fn = 20, [], slam.map_step

    def spy(*args, **kw):
        steps.append(pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                                     else x, (args, kw)) if len(steps) == k_step - 1 else None)
        return fn(*args, **kw)

    slam.map_step = spy
    try:
        res_e = run(eager=True)
    finally:
        slam.map_step = fn
    res_l = run()
    for field in ("poses_front", "poses", "converged", "iterations"):
        a, b = getattr(res_e, field).cpu(), getattr(res_l, field).cpu()
        _check(torch.equal(a, b), f"SLAM: the captured lap's {field} equals the eager lap's "
               f"({_max_abs_diff(a.double(), b.double())})")
    _check(len(res_e.closures) == len(res_l.closures) >= 1, "SLAM: as many closures, one or more")
    for ce, cc in zip(res_e.closures, res_l.closures):
        _check((ce.anchor_idx, ce.scan_idx, ce.matched_ratio)
               == (cc.anchor_idx, cc.scan_idx, cc.matched_ratio)
               and torch.equal(ce.T_rel.cpu(), cc.T_rel.cpu()),
               f"SLAM: closure {cc.anchor_idx} -> {cc.scan_idx} equal in both laps")
    print(f"  SLAM over one lap ({SLAM_TURN_SCANS} scans of phase 20's circuit): the captured "
          f"programs' front-end and refined trajectories, convergence, iterations and "
          f"{len(res_l.closures)} closures (pairs, T_rel, ratios) equal the eager programs' bit "
          f"for bit")
    args, kw = steps[k_step - 1]
    args2 = (args[0], dev_scans[k_step + 1]) + tuple(args[2:])
    calls["front-end map_step"] = (_eager(lambda: map_step(*args, **kw)),
                                   lambda: map_step(*args, **kw))
    _captured_equals_eager(f"SLAM front-end map_step, scan {k_step} ({N_SLAM} points against "
                           f"{SLAM_KW['capacity']} rows, tiled tier)",
                           *calls["front-end map_step"], map_step,
                           (_eager(lambda: map_step(*args2, **kw)),
                            lambda: map_step(*args2, **kw)))
    return calls, {"eager": lambda: run(eager=True), "captured": run}


def phase24_captured_solvers(device, slice_inputs, raw_inputs, slam_case, slam_scans) -> dict:
    """Anderson, map_merge/map_step, SLAM's closure programs and SVD-ICP
    captured, each against its eager form (:func:`_eager_programs`), then
    eager against captured in turns; returns the launches of the phase and
    K1's and K2's largest |difference| to their plain versions on the
    captured Anderson and map_step calls."""
    t_phase = time.perf_counter()
    _reset_launches()
    _literal_repairs(device)
    eye = lambda b: torch.eye(4, dtype=torch.float32, device=device).expand(b, 4, 4)  # noqa: E731
    scan, mp = bench_suite._pair()
    src1 = torch.as_tensor(scan[None, :, :3], device=device)
    tgt1 = torch.as_tensor(mp[None], device=device)
    srcB, tgtB, tiB = bench_suite._batch_inputs(B_HEAD, device)
    solves = {
        "Anderson m=3, the suite's pt2pt pair (register_anderson_jit)":
            (register_anderson, anderson.register_anderson_jit, anderson.register_anderson_jit,
             (src1, tgt1, eye(1)), (None, AA_PAIR_CFG, 3)),
        f"Anderson m=3, phase 4's {B} x {N_SRC} -> {M_TGT} (register_jit, tiled tier)":
            (register, register_jit, _register_captured, (*slice_inputs, eye(B)),
             (None, CFG_SLICE.with_(anderson_m=3, collect_histories=False))),
        f"Anderson m=3, phase 9's {B_RAW} x {N_RAW} -> {M_RAW} (register_jit, cluster tier)":
            (register, register_jit, _register_captured, (*raw_inputs, eye(B_RAW)),
             (None, CFG_RAW.with_(anderson_m=3, collect_histories=False))),
        f"Anderson m=3, batch256_ift_aa_m3's forward (register_ift_jit, B = {B_HEAD})":
            (register_ift, register_ift_jit, register_ift_jit, (srcB, tgtB, tiB),
             (None, AA_IFT_CFG)),
    }
    calls = {}
    for k, (label, (eager_fn, jit_fn, program, (s, t, ti), rest)) in enumerate(solves.items()):
        s2 = _fresh(s, 240 + k)
        calls[label] = (functools.partial(eager_fn, s, t, ti, *rest),
                        functools.partial(jit_fn, s, t, ti, *rest))
        _captured_equals_eager(label, *calls[label], program,
                               (functools.partial(eager_fn, s2, t, ti, *rest),
                                functools.partial(jit_fn, s2, t, ti, *rest)))
    unit = (functools.partial(bench.fwdbwd, register_ift, AA_IFT_CFG, srcB, tgtB, tiB),
            functools.partial(bench.fwdbwd_jit, srcB, tgtB, tiB, AA_IFT_CFG))
    srcB2 = _fresh(srcB, 244)
    _captured_equals_eager("batch256_ift_aa_m3's unit, forward and backward (bench.fwdbwd_jit)",
                           *unit, bench.fwdbwd_jit,
                           (functools.partial(bench.fwdbwd, register_ift, AA_IFT_CFG, srcB2,
                                              tgtB, tiB),
                            functools.partial(bench.fwdbwd_jit, srcB2, tgtB, tiB, AA_IFT_CFG)))
    calls["batch256_ift_aa_m3 unit"] = unit
    rec1, rec2 = {}, {}
    labels = list(solves)
    _record_captured("tiled_nn", "the captured Anderson solve on phase 4's slice",
                     calls[labels[1]][1], rec1)
    _record_captured("cluster_search", "the captured Anderson solve on phase 9's batch",
                     calls[labels[2]][1], rec2)

    s2m_calls, s2m_streams = _scan_to_map_cases(device, rec2)
    slam_calls, slam_runs = _slam_cases(device, slam_case, slam_scans)

    svd_in = (torch.as_tensor(scan[:, :3], device=device), torch.as_tensor(mp[:, :3],
                                                                           device=device))
    for differentiable in (False, True):
        def svd(src, d=differentiable):
            return pt2pt_svd_icp(src, svd_in[1], max_iterations=60, tolerance=1e-9,
                                 differentiable=d, device=device)
        label = f"pt2pt_svd_icp, the svd_pair inputs, differentiable={differentiable}"
        calls[label] = (_eager(lambda f=svd: f(svd_in[0])), lambda f=svd: f(svd_in[0]))
        src2 = _fresh(svd_in[0], 246 + differentiable, 1e-2)
        _captured_equals_eager(label, *calls[label], svd_icp._svd_icp_impl,
                               (_eager(lambda f=svd: f(src2)), lambda f=svd: f(src2)))
    launches = _launches()
    k1_err = _held_to_plain("tiled_nn", rec1)
    k2_err = _held_to_plain("cluster_search", rec2)

    # eager against captured, in turns
    for label, (eager_call, jitted_call) in {**calls, **s2m_calls}.items():
        _alternated(label, eager_call, jitted_call, rounds=2)
    for label, runs in s2m_streams.items():
        _stream_turns(label, runs, S_S2M, warm="variable" not in label)
    for label, (eager_call, jitted_call) in slam_calls.items():
        _alternated(f"SLAM {label}", eager_call, jitted_call, rounds=2)
    _stream_turns(f"SLAM over {SLAM_TURN_SCANS} scans (one lap)", slam_runs, SLAM_TURN_SCANS,
                  warm=False)
    for info in jit.programs():
        print(f"  cached program {info.name}: {info.pool_bytes / 2**20:.1f} MiB of private "
              f"pools, {info.replays} replays, key {str(info.key)[:140]}")
    jit.clear_caches()
    print(f"phase 24 ok: Anderson, map_step/map_merge, SLAM's programs and SVD-ICP captured "
          f"equal their eager forms bit for bit, no host wait in a replay; launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "k1_err": k1_err, "k2_err": k2_err,
            "s2m": s2m_streams["scan-to-map gn stream"], "slam": slam_runs}


# --- phase 25: the odometry back end, GICP and SGD as captured programs -------

TURN_ITERS_HEAVY = 1                # calls per visit in the turns of the slowest cases
SGD_RUNS = 4                        # captured SGD streams, bit-equal to each other


def _fresh_rows(x: torch.Tensor, seed: int, scale: float = 1e-3) -> torch.Tensor:
    """:func:`_fresh` that keeps all-zero rows (pads) at zero."""
    real = (x != 0).any(-1, keepdim=True)
    return torch.where(real, _fresh(x, seed, scale), x)


def _host_ms(call, reps: int = 5, wait: bool = True) -> float:
    """Median host ms of ``call()`` from an idle card to the card's end (or,
    ``wait=False``, to the call's return: the host's part of the call)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        if wait:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _key_host_ms(call, key_work) -> dict:
    """The host's part of a captured SGD call with a key (the bind, the
    key's element keys made by fills, the input copies, the replay and the
    output clones enqueued) and of its key work alone, median ms."""
    return {"call": _host_ms(call, wait=False), "key": _host_ms(key_work, wait=False)}


def _sgd_steps_card_equal_cpu(device) -> None:
    """One 'adam' and one 'sgd' update (sgd_icp._step_delta) on the card
    equal the CPU's f32 step bit for bit, on the same plan's schedule rows
    and the same inputs (H, g and the moments of 8 elements): the rules
    divide by the schedule's tensors, a true division on both devices."""
    gen = torch.Generator().manual_seed(SEED + 25)
    A = torch.randn((8, 6, 6), generator=gen)
    H = A @ A.transpose(-1, -2) + 0.1 * torch.eye(6)
    g, m1 = torch.randn((8, 6), generator=gen), torch.randn((8, 6), generator=gen)
    m2 = torch.rand((8, 6), generator=gen) + 0.1
    for optimizer, lr in (("adam", 0.05), ("sgd", 0.3)):
        kw = dict(iterations=40, minibatch=1024, optimizer=optimizer, lr=lr, lr_decay=0.02)
        plans = {dev: plan_solve(0, 8, 20_000, dev, torch.float32, **kw)
                 for dev in (device, torch.device("cpu"))}
        for it in (0, 7, 39):
            steps = {dev: sgd_icp._step_delta(
                H.to(dev), g.to(dev), m1.to(dev), m2.to(dev), None, optimizer=optimizer,
                lr=None, lr_decay=None, b1=0.9, b2=0.999, dt=torch.float32,
                sched=plan.schedule[it]) for dev, plan in plans.items()}
            card, cpu = steps[device], steps[torch.device("cpu")]
            _check(all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)),
                   f"the '{optimizer}' step at iteration {it} on the card equals the CPU's f32 "
                   f"step bit for bit")
    print("  the 'adam' and 'sgd' steps (iterations 0, 7, 39; 8 elements) on the card equal "
          "the CPU's f32 steps bit for bit on the same plan's schedule and inputs")


def _one_shot_turns(label: str, eager_call, one_shot_call, turns: int = 2) -> dict:
    """ms of an eager call and of a captured call whose program is new each
    time (the cache cleared before it), in turns E C C E; host clock to the
    card's end."""
    times = {"eager": [], "one-shot captured": []}
    for turn in ("eager", "one-shot captured", "one-shot captured", "eager") * (turns // 2):
        times[turn].append(_host_ms(eager_call if turn == "eager" else one_shot_call, reps=1))
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"  {label}: eager {med['eager']:.3f} ms, one-shot captured (eager warm-up, capture, "
          f"replays) {med['one-shot captured']:.3f} ms (medians of {len(times['eager'])} in "
          f"turns; eager {', '.join(f'{t:.1f}' for t in times['eager'])}; one-shot "
          f"{', '.join(f'{t:.1f}' for t in times['one-shot captured'])})")
    return med


def _odometry_cases(device, host) -> tuple:
    """Batched odometry on phase 17's raw scans (K2, held to its plain
    version on the captured call) and on bench_suite's odometry_64scans;
    returns the (eager, captured) calls and K2's largest |difference|."""
    calls = {}
    cfg = ODO_CFG.with_(source_zeroes_are_pad=True)
    scans = torch.as_tensor(np.stack([p[:, :3] for p, _ in host]), device=device)
    scans2 = _fresh_rows(scans, 250)
    label = (f"odometry, phase 17's {S_SEQ} raw scans of {MAX_POINTS} points ({S_SEQ - 1} "
             f"pairs, cluster tier, K2)")
    calls[label] = (_eager(lambda: odometry(scans, cfg)), lambda: odometry(scans, cfg))
    _captured_equals_eager(label, *calls[label], odo_mod._odometry_program,
                           (_eager(lambda: odometry(scans2, cfg)),
                            lambda: odometry(scans2, cfg)))
    rec = {}
    _record_captured("cluster_search", "the captured batched odometry call", calls[label][1],
                     rec)
    scans64, truth64, cfg64 = bench_suite.odometry_sequence(device)
    scans64b = _fresh(scans64, 251)
    label64 = f"odometry, bench_suite's odometry_64scans ({scans64.shape[0] - 1} pairs of " \
              f"{scans64.shape[1]} points, dense tier)"
    calls[label64] = (_eager(lambda: odometry(scans64, cfg64)), lambda: odometry(scans64, cfg64))
    _captured_equals_eager(label64, *calls[label64], odo_mod._odometry_program,
                           (_eager(lambda: odometry(scans64b, cfg64)),
                            lambda: odometry(scans64b, cfg64)))
    res = odometry(scans64, cfg64)
    err = float(ate(res.poses, truth64, align=False))
    print(f"  odometry_64scans captured: ATE (align=False) {err:.3e}, every pair converged "
          f"{bool(res.converged.all())}")
    _check(bool(res.converged.all()) and err < TOL_POSE, "odometry_64scans captured: "
           f"converged, ATE {err} < {TOL_POSE}")
    odo_mod._odometry_program.cache_clear()   # ~10 GiB of pools for the raw scans
    return calls, rec


def _pose_graph_cases(device, slam_case) -> dict:
    """The dense pose graph on phase 20's graph, and refine_robust's two
    passes (the second replays the first's program); returns the calls."""
    res_c, _ = slam_case
    poses = res_c.poses_front.to(device)
    poses2 = res_c.poses.to(device)
    graph = slam.build_pose_graph(poses, res_c.closures, SLAM_KW["closure_info"],
                                  converged=res_c.converged)
    its = SLAM_KW["refine_iterations"]
    V, E = poses.shape[0], graph.edges_i.shape[0]
    calls = {}

    def pg(p):
        return pose_graph_optimize(p, graph, iterations=its)

    label = f"pose_graph_optimize, phase 20's graph ({V} poses, {E} edges, {its} iterations)"
    calls[label] = (_eager(lambda: pg(poses)), lambda: pg(poses))
    _captured_equals_eager(label, *calls[label], odo_mod._pose_graph_program,
                           (_eager(lambda: pg(poses2)), lambda: pg(poses2)))

    def rr():
        return slam.refine_robust(poses, graph, iterations=its)

    label_rr = f"refine_robust, phase 20's graph (2 IRLS passes of {its} iterations)"
    calls[label_rr] = (_eager(rr), rr)
    _captured_equals_eager(label_rr, *calls[label_rr], odo_mod._pose_graph_program)
    odo_mod._pose_graph_program.cache_clear()
    rr()
    progs = list(odo_mod._pose_graph_program.cache.values())
    _check(len(progs) == 1 and progs[0].replays == 1,
           "refine_robust: the second pass replays the first pass's program")
    print(f"  refine_robust, one call from an empty cache: one program, the second pass a "
          f"replay of it ({progs[0].pool_bytes / 2**20:.1f} MiB of pools)")

    def one_shot():
        odo_mod._pose_graph_program.cache_clear()
        return rr()

    calls["one-shot " + label_rr] = (_eager(rr), one_shot)
    return calls


def _gicp_cases(device) -> dict:
    """register_gicp_jit at exp_gicp's batch, with the 3-column target
    (normals estimated inside the program) and with normals given."""
    S, Tg, Ti, T_true = exp_gicp.saddle_batch(device)
    S2 = _fresh(S, 252)
    Tg6 = torch.cat([Tg, estimate_normals(Tg)], dim=-1)
    kw = dict(max_iterations=30, tolerance=1e-6)
    calls = {}
    for what, tgt in (("3-column target, normals inside the program", Tg),
                      ("6-column target", Tg6)):
        label = f"register_gicp_jit, exp_gicp's B = {exp_gicp.B} x {exp_gicp.N}, {what}"
        calls[label] = (functools.partial(register_gicp, S, tgt, Ti, **kw),
                        functools.partial(register_gicp_jit, S, tgt, Ti, **kw))
        _captured_equals_eager(label, *calls[label], register_gicp_jit,
                               (functools.partial(register_gicp, S2, tgt, Ti, **kw),
                                functools.partial(register_gicp_jit, S2, tgt, Ti, **kw)))
        err = float(_log_err(T_true, register_gicp_jit(S, tgt, Ti, **kw).T).max())
        _check(err < TOL_POSE, f"{label}: transform error {err} < {TOL_POSE}")
    return calls


def _sgd_cases(device) -> tuple:
    """register_sgd_jit at exp_sgd's rows with an int seed (its mini-batches
    drawn inside the program by D2); returns the calls and the host ms of
    each captured call and of its key work."""
    calls, hosts = {}, {}
    for size, n, k, iters in exp_sgd.SIZES:
        S, Tg, Ti, T_np = exp_sgd.inputs(n, device)
        S2 = _fresh(S, 253)
        kw = dict(minibatch=k, iterations=iters, tolerance=1e-6)
        label = (f"register_sgd_jit, exp_sgd's {size} row (k = {k}, {iters} iterations, "
                 f"nn_method auto: {'cluster' if n >= 16384 else 'dense'})")
        calls[label] = (functools.partial(register_sgd, S, Tg, Ti, 0, **kw),
                        functools.partial(register_sgd_jit, S, Tg, Ti, 0, **kw))
        _captured_equals_eager(label, *calls[label], register_sgd_jit,
                               (functools.partial(register_sgd, S2, Tg, Ti, 0, **kw),
                                functools.partial(register_sgd_jit, S2, Tg, Ti, 0, **kw)))
        res = register_sgd_jit(S, Tg, Ti, 0, **kw)
        err = float(_log_err(np.linalg.inv(T_np), res.T).max())
        _check(err < exp_sgd.TOL_SGD, f"{label}: transform error {err} < {exp_sgd.TOL_SGD}")
        hosts[label] = _key_host_ms(lambda: register_sgd_jit(S, Tg, Ti, 0, **kw),
                                    lambda: knn.element_keys(0, 1, device))
        print(f"  {label}: transform error {err:.3e}, iterations "
              f"{float(res.iterations[0]):.0f}; no host draw: the host's part of a captured "
              f"call with a key {hosts[label]['call']:.3f} ms, its key's element keys "
              f"{hosts[label]['key']:.3f} ms (median of 5, from an idle card to the return)")
    _sgd_source_case(device)
    return calls, hosts


def _sgd_source_case(device) -> None:
    """register_sgd_jit at exp_sgd's 20k row with an explicit source
    (SeededSampler(0)): its plan's indices drawn on the host's request
    before each call and read by the WHILE body at the device counter;
    held to eager, also on fresh inputs, and drawing nothing by D2."""
    size, n, k, iters = exp_sgd.SIZES[0]
    S, Tg, Ti, _ = exp_sgd.inputs(n, device)
    S2 = _fresh(S, 254)
    kw = dict(minibatch=k, iterations=iters, tolerance=1e-6)
    source = SeededSampler(0)
    label = f"register_sgd_jit, exp_sgd's {size} row, an explicit SeededSampler(0)"
    before = _launches()["threefry_randint"]
    _captured_equals_eager(label, functools.partial(register_sgd, S, Tg, Ti, source, **kw),
                           functools.partial(register_sgd_jit, S, Tg, Ti, source, **kw),
                           register_sgd_jit,
                           (functools.partial(register_sgd, S2, Tg, Ti, source, **kw),
                            functools.partial(register_sgd_jit, S2, Tg, Ti, source, **kw)))
    d2 = _launches()["threefry_randint"] - before
    _check(d2 == 0, f"{label}: an explicit source launches no threefry_randint ({d2})")
    host = _host_ms(lambda: register_sgd_jit(S, Tg, Ti, source, **kw), wait=False)
    print(f"  {label}: threefry_randint launches 0; the host's part of a captured call "
          f"(its plan of {iters} x 1 streams of {k} drawn before the replay) {host:.3f} ms "
          f"(median of 5, from an idle card to the return)")
    register_sgd_jit.cache_clear()


def _sgd_stream_cases(device) -> tuple:
    """Each step of phase 18's SGD stream through the captured map_step; the
    captured stream's gates; returns the calls, the stream's runs and the
    host ms of a captured step and of its key work."""
    scans, poses_true, _ = bench_suite.scan_to_map_sequence()
    truth = torch.as_tensor(poses_true, dtype=torch.float64)
    skw = bench_suite.S2M_SGD

    def stream():
        res = mapping.scan_to_map_odometry(((s, None) for s in scans), S2M_CFG,
                                           capacity=CAP_S2M, voxel=VOXEL_S2M, seed=0,
                                           device=device, **skw)
        return tuple(a.cpu() for a in res)

    label = "scan-to-map sgd stream"
    steps, eager = _steps_of(stream)
    _steps_replayed(label, steps)
    before = _launches()["cluster_search"]
    runs = [stream() for _ in range(SGD_RUNS)]
    k2 = _launches()["cluster_search"] - before
    diff = [_diff_fields(eager, r) for r in runs]
    same = all(not d for d in diff)
    err = float(ate(runs[0][0].double(), truth, align=False))
    print(f"  {label}: {SGD_RUNS} captured runs of {S_S2M} scans (seed 0) equal the eager run "
          f"and each other bit for bit: {same}; ATE (align=False) {err:.3e}; every scan "
          f"converged {bool(runs[0][2].all())}; K2 launches {k2}")
    _check(same, f"{label}: the captured runs equal the eager run ({diff})")
    _check(err < bench_suite.TOL_ATE_SGD, f"{label}: ATE {err} < {bench_suite.TOL_ATE_SGD}")
    _check(k2 == 0, f"{label}: the SGD mini-batch search runs no kernel ({k2})")
    (args, kw), _, _ = steps[5]
    (args2, kw2), _, _ = steps[6]
    call = (_eager(lambda: map_step(*args, **kw)), lambda: map_step(*args, **kw))
    _captured_equals_eager(f"map_step sgd, {label}, step 6", *call, map_step,
                           (_eager(lambda: map_step(*args2, **kw2)),
                            lambda: map_step(*args2, **kw2)))
    _check(isinstance(kw["key"], np.ndarray) and kw["key"].shape == (2,),
           f"{label}: map_step takes scan 6's key data ({kw['key']!r})")
    host = _key_host_ms(lambda: map_step(*args, **kw),
                        lambda: knn.element_keys(mapping._scan_keys(0)(6), 1, device))
    print(f"  {label}: no host draw: the host's part of a captured step with a key "
          f"{host['call']:.3f} ms, its key work (fold_in(key(0), 6) and the element keys) "
          f"{host['key']:.3f} ms (median of 5, from an idle card to the return)")
    map_step.cache_clear()
    return ({f"{label}: map_step, step 6": call},
            {"eager": _eager(stream), "captured": stream}, host)


def phase25_captured_backend(device, host, slam_case) -> dict:
    """Batched odometry, the dense pose graph (and refine_robust), GICP and
    SGD-ICP (register_sgd_jit, map_step(solver="sgd")) captured, each
    against its eager form as phase 24 holds its cases; then eager against
    captured in turns.  Returns the launches of the phase and K2's largest
    |difference| to its plain version on the captured odometry call."""
    t_phase = time.perf_counter()
    _reset_launches()
    odo_calls, rec = _odometry_cases(device, host)
    pg_calls = _pose_graph_cases(device, slam_case)
    gicp_calls = _gicp_cases(device)
    sgd_calls, hosts = _sgd_cases(device)
    s2m_calls, s2m_runs, step_host = _sgd_stream_cases(device)
    launches = _launches()
    _check(launches["threefry_randint"] > 0,
           f"the SGD programs draw on the card by D2 ({launches['threefry_randint']})")
    _sgd_steps_card_equal_cpu(device)
    k2_err = _held_to_plain("cluster_search", rec, pads=(None, "at the origin"))

    # eager against captured, in turns (fewer calls a visit where eager takes
    # 0.7-3 s a call: the 63-pair odometry, the pose graph, SGD)
    light = list(odo_calls)[1:] + list(gicp_calls)
    for label, (eager_call, jitted_call) in {**odo_calls, **pg_calls}.items():
        if "one-shot" in label:
            _one_shot_turns(label, eager_call, jitted_call)
        else:
            _alternated(label, eager_call, jitted_call, rounds=2,
                        iters=5 if label in light else TURN_ITERS_HEAVY)
        jit.clear_caches()
    for label, (eager_call, jitted_call) in {**gicp_calls, **sgd_calls, **s2m_calls}.items():
        med = _alternated(label, eager_call, jitted_call, rounds=2,
                          iters=5 if label in light else TURN_ITERS_HEAVY)
        host = hosts.get(label, step_host if "map_step" in label else None)
        if host is not None:
            print(f"    the host's part {host['call']:.3f} ms = "
                  f"{host['call'] / med['captured']:.3f} of the captured call (no host draw)")
    _stream_turns(f"scan-to-map sgd stream, {S_S2M} scans", s2m_runs, S_S2M, warm=False)
    for info in jit.programs():
        print(f"  cached program {info.name}: {info.pool_bytes / 2**20:.1f} MiB of private "
              f"pools, {info.replays} replays, key {str(info.key)[:140]}")
    jit.clear_caches()
    print(f"phase 25 ok: batched odometry, the pose graph, GICP and SGD captured equal their "
          f"eager forms bit for bit, no host wait in a replay; launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "k2_err": k2_err}


# --- phase 26: Gumbel on threefry draws and parallel/'s programs, captured -----

GUMBEL_CFG = ICPConfig(use_gumbel=True, **HEAD)   # phase 15's headline solve
KEY_GUMBEL = SEED + 26
CFG_MAP = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30, tolerance=1e-5,
                    dim=3, trim_dist=2.0, loss_name="huber", loss_metric=1.0,
                    cluster_probes=PROBES, cluster_group=GROUP, collect_histories=False)
CFG_RING = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=50, tolerance=1e-6,
                     dim=3, trim_dist=2.0, loss_name="huber", loss_metric=0.5,
                     collect_histories=False)


def _launches_and_collectives() -> dict:
    """:func:`_launches` and the collectives ``parallel._comm`` counted (at
    once and in replays), keyed "collective <kind> <ranks> <elements>"."""
    return {**_launches(), **{f"collective {kind} {ranks} {numel}": n
                              for (kind, ranks, numel), n in _comm.collectives().items()}}


def _draws_card_equal_cpu(device) -> None:
    """The same threefry draws on the card and on the CPU, bit for bit (the
    CPU's are those tier-1 holds to jax.random.uniform): f32 and f64, the
    headline's (256, 65, 65) blocks at a device counter, streamed
    (n, chunk) blocks with a chunk folded in, one stream over a whole
    shape."""
    cases = ((list(range(B_HEAD)), 7, None, (B_HEAD, 65, 65)),
             (list(range(B)), 3, 11, (B, 512, 1365)),
             (None, None, 2, (3, 1000, 17)))
    for dtype in (torch.float32, torch.float64):
        for ids, it, chunk, shape in cases:
            it_card = None if it is None else torch.tensor(it, dtype=torch.int32, device=device)
            card = knn.ThreefryNoise(KEY_GUMBEL).uniform(ids, it_card, chunk, shape, dtype,
                                                         device)
            host = knn.ThreefryNoise(KEY_GUMBEL).uniform(ids, it, chunk, shape, dtype, "cpu")
            _check(torch.equal(card.cpu(), host), f"threefry draws on the card equal the CPU's "
                   f"({dtype}, {shape}, chunk {chunk})")
    print("  threefry draws on the card equal the CPU's bit for bit (f32, f64; (256, 65, 65) "
          "at a device counter, (8, 512, 1365) with a chunk folded in, one stream over "
          "(3, 1000, 17))")


# D2's instructions per sample (csrc/threefry.cu): two threefry blocks of D1's
# 72 (2 adds, 20 rounds of add, funnel-shift rotate and xor, 5 key injections
# of 2 adds), three u64 remainders counted at 20 integer instructions each (an
# estimate of the multiply-by-reciprocal sequence), and 6 to assemble the two
# 64-bit words and combine the remainders
D2_OPS = 2 * 72 + 3 * 20 + 6
# INT32 instructions per s: 132 SMs x 64 INT32 lanes x 1.98 GHz
INT32_RATE = 132 * 64 * 1.98e9


def _d2_bound(samples: int) -> dict:
    """D2's bound: its instructions at the INT32 issue rate, or its int64
    output written."""
    t_ops = D2_OPS * samples / INT32_RATE * 1e3
    t_bytes = samples * 8 / HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _d2_against_plain(device) -> dict:
    """D2 (knn.threefry_randint) against its plain version on the card, bit
    for bit, at a device iteration: exp_sgd's two rows ((1, 1024) at n =
    20,000, (1, 2048) at n = 100,000), an (8, 512) batch, n = 2**31 - 1 at an
    iteration past int32, a ragged (3, 1000) at n = 65,537 and a span of 1;
    then timed at exp_sgd's 100k row, call by call and back to back, beside
    the plain version and the bound.  Returns the kernels line's entry."""
    cases = (("exp_sgd's 20k row (1, 1024), n = 20,000", 1, 1024, 20_000, 3),
             ("exp_sgd's 100k row (1, 2048), n = 100,000", 1, 2048, 100_000, 39),
             ("an (8, 512) batch, n = 60,000", 8, 512, 60_000, 0),
             ("(8, 512), n = 2**31 - 1, iteration 2**31 + 5", 8, 512, 2**31 - 1, 2**31 + 5),
             ("a ragged (3, 1000), n = 65,537", 3, 1000, 65_537, 17),
             ("(2, 300), n = 1", 2, 300, 1, 4))
    for label, rows, k, n, it in cases:
        keys = knn.element_keys(SEED + 26, rows, device)
        k1, k2 = keys[:, 0].contiguous(), keys[:, 1].contiguous()
        it_t = torch.full((), knn._i32(it), dtype=torch.int32, device=device)
        got = knn.threefry_randint(k1, k2, it_t, k, n)
        want = knn.threefry_randint_plain(k1, k2, it_t, k, n)
        _check(got.dtype == torch.int64 and torch.equal(got, want),
               f"D2 bit-equal to its plain version: {label}")
        _check(bool((got >= 0).all()) and bool((got < max(n, 1)).all()),
               f"D2's draws lie in [0, {n}): {label}")
    print(f"  D2 == plain bit for bit at a device iteration: {'; '.join(c[0] for c in cases)}")
    label, rows, k, n, it = cases[1]
    keys = knn.element_keys(SEED + 26, rows, device)
    k1, k2 = keys[:, 0].contiguous(), keys[:, 1].contiguous()
    it_t = torch.full((), it, dtype=torch.int32, device=device)
    call = lambda: knn.threefry_randint(k1, k2, it_t, k, n)  # noqa: E731
    plain = lambda: knn.threefry_randint_plain(k1, k2, it_t, k, n)  # noqa: E731
    ms, chain = cuda_median_ms(call, warmup=3, iters=20), _chain_ms(call)
    plain_ms = cuda_median_ms(plain, warmup=1, iters=5)
    out = torch.empty((rows, k), dtype=torch.int64, device=device)

    def launch():
        err = knn._randint_kernel()(k1.data_ptr(), k2.data_ptr(), rows, it_t.data_ptr(), k, n,
                                    out.data_ptr(), device.index,
                                    torch.cuda.current_stream(device).cuda_stream)
        _check(err == 0, f"D2's launcher returned CUDA error {err}")

    graph = _graph_launch_ms(launch)
    _check(torch.equal(out, call()), "D2's graph launches wrote its draws")
    bound = _d2_bound(rows * k)
    print(f"  D2 at {label}: {ms:.4f} ms call by call, {chain:.4f} ms back to back (both "
          f"through the wrapper: host-bound), {graph:.5f} ms a launch in a CUDA graph of "
          f"{GRAPH_LAUNCHES} launches (device time); plain {plain_ms:.4f} ms; bound "
          f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}; {D2_OPS} instructions per sample "
          f"at {INT32_RATE:.4g}/s, {rows * k * 8} bytes at {HBM_BYTES:.4g} B/s); library: none "
          f"(torch.randint is Philox, another function)")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None,
            "ms_back_to_back": chain, "ms_in_graph": graph}


GRAPH_LAUNCHES = 100


def _graph_launch_ms(launch, rounds: int = 7) -> float:
    """Device ms per launch of ``launch()`` (a raw launcher on the current
    stream): GRAPH_LAUNCHES launches captured in one CUDA graph, replayed
    between two CUDA events, median of ``rounds`` (no host launch cost)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_LAUNCHES)
    del graph
    return statistics.median(times)


def _gumbel_cases(device, head_inputs, sources, targets) -> tuple:
    """register_jit(use_gumbel=True) at the headline and the streamed
    gumbel_nn at phase 4's shape, captured against eager (a new key replays
    the program); the draw alone, captured.  Returns the (eager, captured)
    calls and the draw's ms per iteration, captured and eager."""
    src, tgt, ti = head_inputs
    calls = {}

    def solve(key, captured=True):
        return (register_jit if captured else register)(src, tgt, ti, None, GUMBEL_CFG, key=key)

    label = (f"register_jit(use_gumbel=True), the headline pair at B={B_HEAD} (dense "
             f"(65, 65) draws per pair and iteration; key an int)")
    calls[label] = (lambda: solve(KEY_GUMBEL, False), lambda: solve(KEY_GUMBEL))
    _captured_equals_eager(label, *calls[label], _register_captured,
                           (lambda: solve(KEY_GUMBEL + 1, False), lambda: solve(KEY_GUMBEL + 1)))
    before = [(p.key, p.replays) for p in jit.programs() if p.name == "register_jit"]
    with _no_host_wait():
        res = solve(knn.key_data(KEY_GUMBEL + 2, device))
    after = [(p.key, p.replays) for p in jit.programs() if p.name == "register_jit"]
    _check([k for k, _ in after] == [k for k, _ in before]
           and sum(r for _, r in after) == sum(r for _, r in before) + 1,
           "a fresh key tensor replays the program: no new capture (jit.programs())")
    xi = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=torch.float64)
    T_true = se3.tran_inv(se3.vec2tran(xi)).to(device)
    err = torch.linalg.vector_norm(se3.tran2vec(T_true @ torch.linalg.inv(res.T.double())),
                                   dim=-1)
    _check(bool(torch.isfinite(res.T).all()) and float(err.max()) < TOL_GUMBEL,
           f"captured Gumbel transform error {float(err.max())} < {TOL_GUMBEL}")
    print(f"  a fresh key tensor replayed the program (programs {len(after)}, no new "
          f"capture); transform error max {float(err.max()):.4e}; iterations "
          f"{float(res.iterations.max())}")

    # the draw of one iteration alone, captured, beside its eager dispatch
    shape = tuple(src.shape[:2]) + (tgt.shape[1],)
    noise = knn.ThreefryNoise(knn.key_data(KEY_GUMBEL, device))
    ids = list(range(shape[0]))
    noise.pair_keys(ids, device)
    it = torch.tensor(7, dtype=torch.int32, device=device)
    draw = jit.jit(lambda it: noise.uniform(ids, it, None, shape, torch.float32, device),
                   name="gumbel_draw")
    _check(torch.equal(draw(it), draw(it)), "the captured draw repeats")
    draw_ms = cuda_median_ms(lambda: draw(it), warmup=3, iters=20)
    eager_draw_ms = cuda_median_ms(
        lambda: noise.uniform(ids, it, None, shape, torch.float32, device), warmup=3, iters=20)
    draw.cache_clear()

    x, y = to_torch(sources, device), to_torch(targets, device)
    gnn = jit.jit(lambda x, y, key: knn.gumbel_nn(x, y, key), name="gumbel_nn")

    def stream(key, captured=True):
        return gnn(x, y, knn.key_data(key, device)) if captured else knn.gumbel_nn(x, y, key)

    label_s = (f"gumbel_nn streamed, phase 4's {tuple(x.shape)} -> {tuple(y.shape)} (12 "
               f"chunks of 1365 targets, a draw each)")
    calls[label_s] = (lambda: stream(KEY_GUMBEL, False), lambda: stream(KEY_GUMBEL))
    _captured_equals_eager(label_s, *calls[label_s], gnn,
                           (lambda: stream(KEY_GUMBEL + 1, False),
                            lambda: stream(KEY_GUMBEL + 1)))
    _draws_card_equal_cpu(device)
    return calls, draw_ms, eager_draw_ms, float(res.iterations.max())


def _fixed_trip_collectives(label: str, calls, cfg: ICPConfig) -> int:
    """The collectives of an eager call (the iterations it needs, plus the
    cost pass) and of a replay (max_iterations masked steps, each with its
    all-reduce, plus the cost pass: the fixed trip); returns the eager
    call's iterations."""
    eager_call, jitted_call = calls
    jitted_call()                    # captured already: this replays
    counts = {}
    for form, call in (("eager", eager_call), ("replay", jitted_call)):
        _comm.reset_counts()
        res = call()
        torch.cuda.synchronize()
        counts[form] = _collectives()
    it = int(res.iterations)
    want = {"eager": it + 1, "replay": cfg.max_iterations + 1}
    for form, n in want.items():
        _check(sum(v for (kind, _, _), v in counts[form].items() if kind == "all_reduce") == n,
               f"{label}: all-reduces of the {form} call ({counts[form]}, {n} expected)")
    print(f"  {label}: collectives of the eager call {counts['eager']} ({it} iterations + the "
          f"cost pass), of a replay {counts['replay']} (the fixed trip: max_iterations "
          f"{cfg.max_iterations} + the cost pass)")
    return it


def _partitioned_cases(device, mesh, slam_case) -> dict:
    """The partitioned pose graph's program on phase 20's graph (its host
    partition done before) against eager and the dense pose graph;
    refine_robust(mesh=...) against the dense refine (positions, ATE) and
    captured against eager (the second IRLS pass replays the first's
    program); returns the calls."""
    res_c, truth = slam_case
    poses, poses2 = res_c.poses_front.to(device), res_c.poses.to(device)
    graph = slam.build_pose_graph(poses, res_c.closures, SLAM_KW["closure_info"],
                                  converged=res_c.converged)
    its = SLAM_KW["refine_iterations"]
    prog = pg_mod._partitioned_program(mesh.get_group("map"))
    inputs = pg_mod._partition_inputs(poses, graph, mesh)
    inputs2 = pg_mod._partition_inputs(poses2, graph, mesh)

    def pgp(inp):
        return prog(**inp, iterations=its, damping=1e-6)

    label = (f"the partitioned pose graph's program, phase 20's graph ({poses.shape[0]} poses, "
             f"{graph.edges_i.shape[0]} edges, {its} iterations)")
    calls = {label: (_eager(lambda: pgp(inputs)), lambda: pgp(inputs))}
    _captured_equals_eager(label, *calls[label], prog,
                           (_eager(lambda: pgp(inputs2)), lambda: pgp(inputs2)),
                           counter=_launches_and_collectives)
    dense, _ = pose_graph_optimize(poses, graph, iterations=its)
    diff = float((pgp(inputs) - dense).abs().max())
    _check(diff < 1e-4, f"partitioned program within 1e-4 of the dense pose graph ({diff})")

    def rr():
        return slam.refine_robust(poses, graph, mesh=mesh, iterations=its)

    eager = _eager(rr)()
    ref_dense = slam.refine_robust(poses, graph, iterations=its)
    pos_diff = float(torch.linalg.vector_norm(eager[:, :3, 3] - ref_dense[:, :3, 3],
                                              dim=-1).max())
    a_dense = float(ate(ref_dense.double().cpu(), truth, align=False))
    a_mesh = float(ate(eager.double().cpu(), truth, align=False))
    print(f"  refine_robust(mesh=...) against the dense refine, eager: position difference "
          f"{pos_diff:.3e} m, ATE {a_mesh:.5f} against {a_dense:.5f} m")
    _check(pos_diff < 1e-2, "refine_robust(mesh) positions within 1e-2 of the dense refine")
    _check(abs(a_mesh - a_dense) < 0.05 * max(a_dense, 1e-9), "ATE within 5% of the dense")
    prog.cache_clear()
    _comm.reset_counts()
    got = [rr(), rr()]
    progs = list(prog.cache.values())
    _check(all(torch.equal(g, eager) for g in got), "refine_robust(mesh=...) captured equals "
           "eager bit for bit (a first call and a replaying call)")
    _check(len(progs) == 1 and progs[0].replays == 3, "refine_robust(mesh=...): one program; "
           "the first call's second pass and both passes of the next replay it")
    print(f"  partitioned program within {diff:.3e} of the dense pose graph; "
          f"refine_robust(mesh=...) captured equals eager bit for bit over two calls (one "
          f"program, 3 replays; the wrapper reads the graph's edges on the host, as JAX's "
          f"does); collectives of the two calls {_collectives()}")
    calls[f"refine_robust(mesh=...), phase 20's graph (2 IRLS passes)"] = (_eager(rr), rr)
    return calls


def phase26_captured_gumbel(device, head_inputs, sources, targets) -> dict:
    """D2 against its plain version; the Gumbel solve on threefry draws
    captured, against its eager form (_captured_equals_eager); then eager
    against captured in turns and the draw's share of the captured solve.
    Returns the phase's launches and D2's entry of the kernels line."""
    t_phase = time.perf_counter()
    d2 = _d2_against_plain(device)
    _reset_launches()
    g_calls, draw_ms, eager_draw_ms, iters = _gumbel_cases(device, head_inputs, sources,
                                                           targets)
    launches = _launches()
    for label, (eager_call, jitted_call) in g_calls.items():
        med = _alternated(label, eager_call, jitted_call, rounds=2, iters=TURN_ITERS_HEAVY)
        if label.startswith("register_jit(use_gumbel"):
            share = draw_ms * iters / med["captured"]
            print(f"    the draw: {draw_ms:.4f} ms per iteration captured ({eager_draw_ms:.4f} "
                  f"eager), x {iters:.0f} iterations = {share:.3f} of the captured solve")
    jit.clear_caches()
    print(f"phase 26 ok: the Gumbel solve captured equals its eager form bit for bit, no host "
          f"wait in a replay, kernel launches as eager; launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "d2": d2}


# --- phase 27: the unrolled gradient captured, and the draw kernel D1 ---------

CFG_UNROLL_SLICE = CFG_SLICE.with_(differentiable=True)   # phase 4's solve, unrolled
# D1's instructions per element (csrc/threefry.cu): 2 adds, 20 rounds of add,
# funnel-shift rotate and xor, 5 key injections of 2 adds; then the float:
# f32 xor, shift, or and subtract, f64 two shifts, two ors and subtract
D1_OPS = {torch.float32: 2 + 20 * 3 + 5 * 2 + 4, torch.float64: 2 + 20 * 3 + 5 * 2 + 5}
D1_CHUNK = 1365                    # the streamed gumbel_nn's chunk at phase 4's shape
D1_LARGE_ROW = 2**32 + 8192        # one row past both words of D1's counter


def _d1_bound(elements: int, dtype) -> dict:
    """D1's bound: its instructions at the issue rate (the card's INT32
    pipes are half of it: a lower bound either way) or its bytes written."""
    t_ops = D1_OPS[dtype] * elements / ISSUE_RATE * 1e3
    t_bytes = elements * torch.finfo(dtype).bits / 8 / HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes"}


def _d1_against_plain(device) -> dict:
    """D1 against its plain version on the card, bit for bit (f32, f64): the
    dense Gumbel block, a streamed chunk, counters whose uint32 patterns are
    negative int32, one stream over a whole shape; then one row of
    D1_LARGE_ROW elements, held to the plain arithmetic on windows around
    2**31 and 2**32 (the counter's high word); timed at the streamed chunk
    and the dense block, call by call and back to back, beside the plain
    version and the bound.  Returns the kernels line's entry."""
    noise = knn.ThreefryNoise(KEY_GUMBEL)
    cases = ((f"the dense Gumbel block ({B_HEAD}, 65, 65), iteration 7", range(B_HEAD), 7,
              None, (65, 65)),
             (f"a streamed chunk ({B}, {N_SRC}, {D1_CHUNK}), iteration 3, chunk 11", range(B),
              3, 11, (N_SRC, D1_CHUNK)),
             ("iteration -1 and chunk 2**32 - 1 (uint32 words past int32)", (5, 9), -1,
              2**32 - 1, (3, 700)),
             ("one stream over (3, 1000, 17), no iteration, chunk 2", None, None, 2,
              (3, 1000, 17)))
    for dtype in (torch.float32, torch.float64):
        for label, ids, it, chunk, block in cases:
            if ids is None:
                k1, k2 = (w.reshape(1) for w in noise._key(device))
            else:
                k1, k2 = noise.pair_keys(list(ids), device)
            it_t = None if it is None else torch.tensor(it, dtype=torch.int32, device=device)
            got = knn.threefry_uniform(k1, k2, it_t, chunk, block, dtype)
            want = knn.threefry_uniform_plain(k1, k2, it_t, chunk, block, dtype)
            _check(torch.equal(got, want), f"D1 bit-equal to its plain version: {label} "
                   f"({dtype})")
    k1, k2 = noise.pair_keys([3], device)
    it_t = torch.tensor(2, dtype=torch.int32, device=device)
    big = knn.threefry_uniform(k1, k2, it_t, 1, (D1_LARGE_ROW,), torch.float32)
    f1, f2 = knn.fold_in(*knn.fold_in(k1, k2, it_t), 1)
    for lo, hi in ((0, 4096), (2**31 - 2048, 2**31 + 2048), (2**32 - 4096, D1_LARGE_ROW)):
        count = torch.arange(lo, hi, dtype=torch.int64, device=device)
        b1, b2 = knn.threefry2x32(f1, f2, (count >> 32).to(torch.int32), count.to(torch.int32))
        want = knn._uniform_from_bits(b1, b2, torch.float32).reshape(-1)
        _check(torch.equal(big[0, lo:hi], want), f"D1's row of {D1_LARGE_ROW} elements "
               f"equals the plain arithmetic on [{lo}, {hi})")
    del big
    torch.cuda.empty_cache()
    print(f"  D1 == plain bit for bit (f32, f64): {'; '.join(c[0] for c in cases)}; and one "
          f"row of {D1_LARGE_ROW} f32 elements on [0, 4096), 2**31 +- 2048 and "
          f"[2**32 - 4096, {D1_LARGE_ROW})")

    timed = {}
    for label, ids, it, chunk, block in cases[:2]:
        k1, k2 = noise.pair_keys(list(ids), device)
        it_t = torch.tensor(it, dtype=torch.int32, device=device)
        elements = len(ids) * math.prod(block)
        call = lambda: knn.threefry_uniform(k1, k2, it_t, chunk, block, torch.float32)  # noqa: E731
        plain = lambda: knn.threefry_uniform_plain(k1, k2, it_t, chunk, block,  # noqa: E731
                                                   torch.float32)
        ms, chain = cuda_median_ms(call, warmup=3, iters=20), _chain_ms(call)
        plain_ms = cuda_median_ms(plain, warmup=1, iters=5)
        bound = _d1_bound(elements, torch.float32)
        timed[label] = {"ms": ms, "ms_back_to_back": chain, "plain_ms": plain_ms, **bound}
        print(f"  D1 at {label}, f32: {ms:.4f} ms call by call, {chain:.4f} ms back to back; "
              f"plain {plain_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
              f"{D1_OPS[torch.float32]} instructions per element at {ISSUE_RATE:.4g}/s, "
              f"{elements * 4} bytes at {HBM_BYTES:.4g} B/s); library: none (torch.rand is "
              f"Philox, another function)")
    streamed = timed[cases[1][0]]
    return {"max_abs_err": 0.0, "ms": streamed["ms"], "plain_ms": streamed["plain_ms"],
            "bound_ms": streamed["bound_ms"], "bound_by": streamed["bound_by"],
            "library_ms": None, "ms_back_to_back": streamed["ms_back_to_back"],
            "dense_block": timed[cases[0][0]]}


def _unrolled_cases(device, head_inputs, sources, targets) -> tuple:
    """The captured unrolled units against their uncaptured runs
    (_captured_equals_eager): bench.unrolled_jit at the headline, the same
    through ICP.icp, bench.unrolled_jit at phase 4's shape (K1 recorded on
    the captured call) and the Gumbel headline's unrolled gradient with an
    int key.  Returns the (eager, captured) calls, K1's recordings and the
    iterations of each unit."""
    calls, rec, iters = {}, {}, {}
    src, tgt, ti = head_inputs
    cfg = ICPConfig(**HEAD)
    src_b = _fresh(src, 270)

    def unit(s=src):
        return bench.fwdbwd(register, cfg, s, tgt, ti)

    label = (f"bench.unrolled_jit, the headline pair at B={B_HEAD} (dense tier, "
             f"max_iterations {cfg.max_iterations})")
    calls[label] = (unit, lambda: bench.unrolled_jit(src, tgt, ti, cfg))
    _captured_equals_eager(label, *calls[label], bench.unrolled_jit,
                           (lambda: unit(src_b), lambda: bench.unrolled_jit(src_b, tgt, ti, cfg)))
    iters[label] = float(unit()[0].iterations.max())

    solver = ICP(icp_type="pt2pl", differentiable=True, max_iterations=HEAD["max_iterations"],
                 tolerance=HEAD["tolerance"], device=device, collect_histories=False)

    def icp_unit(s, t, t0):
        with torch.enable_grad():
            s = s.clone().requires_grad_(True)
            res = solver.icp(s, t, t0, trim_dist=HEAD["trim_dist"],
                             loss_fn={"name": "huber", "metric": HEAD["loss_metric"]},
                             dim=HEAD["dim"])
            value = res["T"].sum()
            (grad,) = torch.autograd.grad(value, s)
        return res["T"].detach(), res["stats"]["iterations"], value.detach(), grad

    icp_jit = jit.jit(icp_unit, name="icp_unrolled")
    label_i = f"ICP.icp(differentiable=True) unrolled gradient, the headline pair at B={B_HEAD}"
    calls[label_i] = (lambda: icp_unit(src, tgt, ti), lambda: icp_jit(src, tgt, ti))
    _captured_equals_eager(label_i, *calls[label_i], icp_jit,
                           (lambda: icp_unit(src_b, tgt, ti), lambda: icp_jit(src_b, tgt, ti)))

    s4, t4 = to_torch(sources, device), to_torch(targets, device)
    ti4 = torch.eye(4, dtype=torch.float32, device=device).expand(s4.shape[0], 4, 4)
    s4b = _fresh(s4, 271)
    cfg4 = CFG_UNROLL_SLICE

    def unit4(s=s4):
        return bench.fwdbwd(register, cfg4, s, t4, ti4)

    label4 = (f"bench.unrolled_jit, phase 4's {tuple(s4.shape)} -> {tuple(t4.shape)} (tiled "
              f"tier, K1; max_iterations {cfg4.max_iterations})")
    calls[label4] = (unit4, lambda: bench.unrolled_jit(s4, t4, ti4, cfg4))
    _captured_equals_eager(label4, *calls[label4], bench.unrolled_jit,
                           (lambda: unit4(s4b), lambda: bench.unrolled_jit(s4b, t4, ti4, cfg4)))
    # K1 recorded on the uncaptured unit's calls: the program's last captured
    # K1 launch lies in a step that a replay skips, whose buffers it never
    # writes; the program's K1 calls are the host loop's (bit-equal above)
    with _recording("tiled_nn", rec.setdefault("the unrolled unit at phase 4's shape", {})):
        calls[label4][0]()
    iters[label4] = float(unit4()[0].iterations.max())

    def gumbel_unit(s, t, t0, key):
        with torch.enable_grad():
            s = s.clone().requires_grad_(True)
            res = register(s, t, t0, None, GUMBEL_CFG, key=key)
            value = res.T.sum()
            (grad,) = torch.autograd.grad(value, s)
        return res, value.detach(), grad

    gumbel_jit = jit.jit(gumbel_unit, name="gumbel_unrolled")
    label_g = (f"the Gumbel headline's unrolled gradient at B={B_HEAD}, key an int (dense "
               f"(65, 65) draws per pair and executed step)")
    calls[label_g] = (lambda: gumbel_unit(src, tgt, ti, KEY_GUMBEL),
                      lambda: gumbel_jit(src, tgt, ti, KEY_GUMBEL))
    # the backward recomputes each executed step: its draw again (D1 twice)
    twice = lambda want: {k: 2 * v if k == "threefry_uniform" else v  # noqa: E731
                          for k, v in want.items()}
    _captured_equals_eager(label_g, *calls[label_g], gumbel_jit,
                           (lambda: gumbel_unit(src_b, tgt, ti, KEY_GUMBEL),
                            lambda: gumbel_jit(src_b, tgt, ti, KEY_GUMBEL)), replayed=twice)
    iters[label_g] = float(calls[label_g][0]()[0].iterations.max())

    # an early exit with Gumbel NN (near-hard at tau 0.01, a loose tolerance):
    # a skipped step draws nothing, forward or backward
    cfg_x = GUMBEL_CFG.with_(gumbel_tau=0.01, tolerance=0.1)

    def exit_unit(s):
        return bench.fwdbwd(lambda *a: register(*a, key=KEY_GUMBEL), cfg_x, s, tgt, ti)

    exit_jit = jit.jit(lambda s: exit_unit(s), name="gumbel_unrolled_exit")
    label_x = (f"the Gumbel unrolled gradient at B={B_HEAD}, tau 0.01, tolerance 0.1 (early "
               f"exit)")
    _captured_equals_eager(label_x, lambda: exit_unit(src), lambda: exit_jit(src), exit_jit,
                           replayed=twice)
    steps = float(exit_unit(src)[0].iterations.max())
    _check(steps < cfg_x.max_iterations, f"{label_x}: steps past the exit ({steps})")
    print(f"  {label_x}: {steps:.0f} executed steps of {cfg_x.max_iterations}; D1 launches "
          f"per replay 2 x {steps:.0f} (forward and the backward's recomputed step), none in "
          f"the {cfg_x.max_iterations - steps:.0f} skipped steps")
    return calls, rec, iters


def phase27_unrolled_captured(device, head_inputs, sources, targets) -> dict:
    """D1 against its plain version and timed; the captured unrolled units
    against their uncaptured runs; launches per replay; then eager against
    captured in turns.  Returns the phase's launches, D1's entry of the
    kernels line and K1's largest |difference| to its plain version."""
    t_phase = time.perf_counter()
    d1 = _d1_against_plain(device)
    _reset_launches()
    calls, rec, iters = _unrolled_cases(device, head_inputs, sources, targets)
    launches = _launches()
    k1_err = _held_to_plain("tiled_nn", rec)
    for label, (eager_call, jitted_call) in calls.items():
        jitted_call()        # _held_to_plain's recording cleared the caches: capture anew
        torch.cuda.synchronize()
        before = _launches()
        t0 = time.perf_counter()
        jitted_call()
        enqueue = time.perf_counter() - t0      # the call returns once the replay is enqueued
        torch.cuda.synchronize()
        per_replay = _delta(before, _launches())
        # the device's own time: a replay queued whole behind a 0.2 s spin
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(0.2 * 1.98e9))
        start.record()
        jitted_call()
        end.record()
        end.synchronize()
        steps = iters.get(label)
        note = (f"; {steps:.0f} executed steps of the trip" if steps is not None else "")
        print(f"  {label}: launches per replay {per_replay}{note}; host ms to enqueue one "
              f"replay {enqueue * 1e3:.3f}, device ms of one replay queued whole "
              f"{start.elapsed_time(end):.3f}")
        heavy = "phase 4" in label
        _alternated(label, eager_call, jitted_call, rounds=2,
                    iters=TURN_ITERS_HEAVY if heavy else 5)
    jit.clear_caches()
    print(f"phase 27 ok: D1 bit-equal to its plain version; the unrolled gradient captured "
          f"(a fixed trip of run-once steps, forward and backward) equals its uncaptured run "
          f"bit for bit, no host wait in a replay; launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "d1": d1, "k1_err": k1_err}


# ---- phase 28: .backward() through captured programs (program pairs) -----

class _BackwardCase(NamedTuple):
    """A jitted call whose inputs require grad, differentiated by
    ``.backward()``: ``call(*inputs)`` on leaves of ``inputs`` (those at
    ``wrt`` require grad), ``jitted`` the program behind it; ``fresh``
    other inputs of the same shapes; ``host_reads``: the call reads the
    host outside its program (``ICP.icp``'s slice of the histories);
    ``loose``: gradient positions in ``wrt`` held within a relative bound
    instead of bit for bit; ``replayed``: what a replay launches where the
    eager call launches ``launches``; ``counter``: what "launches" counts
    (default :func:`_launches`)."""

    label: str
    jitted: object
    call: object
    inputs: tuple
    fresh: tuple
    wrt: tuple = (0,)
    host_reads: bool = False
    loose: dict = {}
    replayed: object = None
    heavy: bool = False
    counter: object = None


def _recomputed_draws(want: dict) -> dict:
    """What a fixed trip's replay launches where the recorded host loop
    launches ``want``: D2 twice per executed step (the forward and the
    recomputing backward draw the same bits)."""
    return {k: 2 * v if k == "threefry_randint" else v for k, v in want.items()}


class _TPc(NamedTuple):
    T: torch.Tensor
    pc: torch.Tensor
    iterations: torch.Tensor


TOL_GUMBEL_TARGET_GRAD = 1e-5   # relative: the target's two uses per step summed inside it


def _loss(res) -> torch.Tensor:
    """The scalar every phase-28 case differentiates: sum(T * probe) (and
    0.01 sum(pc), 0.1 sum(cost) where the result has them)."""
    probe = torch.linspace(0.5, 1.5, 16, dtype=res.T.dtype, device=res.T.device).reshape(4, 4)
    value = torch.sum(res.T * probe)
    if hasattr(res, "pc"):
        value = value + 0.01 * torch.sum(res.pc)
    if hasattr(res, "cost"):
        value = value + 0.1 * torch.sum(res.cost)
    return value


def _leaf_inputs(case: _BackwardCase, inputs) -> list:
    return [x.detach().clone().requires_grad_(i in case.wrt) for i, x in enumerate(inputs)]


def _forward(case: _BackwardCase, leaves, strict: bool):
    with _no_host_wait() if strict and not case.host_reads else contextlib.nullcontext():
        return case.call(*leaves)


def _backward(case: _BackwardCase, leaves, res, strict: bool, retain: bool = False) -> tuple:
    """``.backward()`` of the case's loss: (result, loss, the gradients)."""
    value = _loss(res)
    with _no_host_wait() if strict else contextlib.nullcontext():
        value.backward(retain_graph=retain)
    return res, value.detach(), tuple(leaves[i].grad.clone() for i in case.wrt)


def _fwd_bwd(case: _BackwardCase, inputs, strict: bool = False) -> tuple:
    leaves = _leaf_inputs(case, inputs)
    return _backward(case, leaves, _forward(case, leaves, strict), strict)


def _same(case: _BackwardCase, what: str, want, got) -> float:
    """``got`` equals ``want`` bit for bit in every output, the loss and
    every gradient, except the ``loose`` gradients, held within their
    relative bound.  Returns the largest relative gap of a loose gradient
    (0.0 where there is none or it is bit-equal)."""
    diff, gap = _diff_fields(want, got), 0.0
    for j, bound in case.loose.items():
        name = f"[2].[{j}]"
        if name in diff:
            scale = float(want[2][j].abs().max())
            rel = diff.pop(name) / scale
            _check(rel <= bound, f"{case.label}, {what}: gradient {j} within {bound} of the "
                   f"uncaptured one relative to its largest entry ({rel:.3e})")
            gap = max(gap, rel)
    _check(not diff, f"{case.label}, {what}: equal to the disable_jit() run bit for bit "
           f"(differing: {diff})")
    return gap


def _backward_equals_eager(case: _BackwardCase) -> dict:
    """The case through its program pair against the same call under
    disable_jit(): the first call (eager: its key's first sighting
    captures nothing), the second (warm-up, the two captures, a replay),
    fresh inputs, two forwards then their backwards in reverse order (the
    older one's forward replayed again), and a second backward with
    retain_graph, every replay and backward under the sync debug mode's
    "error".  Returns the launches per forward + backward replay, the first
    and second calls' and eager host seconds, the program's pool, the eager
    peak and the largest relative gap of a loose gradient."""
    replayed = case.replayed or (lambda launches: launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with jit.disable_jit():
        want, _, eager_s = _counted(lambda: _fwd_bwd(case, case.inputs), case.counter)
        peak = torch.cuda.max_memory_allocated() - base
        want_fresh, launches_fresh, _ = _counted(lambda: _fwd_bwd(case, case.fresh),
                                                 case.counter)
    case.jitted.cache_clear()
    first, _, first_s = _counted(lambda: _fwd_bwd(case, case.inputs))
    _check(not case.jitted.cache, f"{case.label}: the first call captures nothing")
    gap = _same(case, "the first call (eager)", want, first)
    second, _, second_s = _counted(lambda: _fwd_bwd(case, case.inputs))
    prog = next(reversed(case.jitted.cache.values()))
    _check(prog.bwd_graph is not None and len(case.jitted.cache) == 1,
           f"{case.label}: one program pair")
    gap = max(gap, _same(case, "the second call (the captures)", want, second))
    replays = prog.replays
    got, per_replay, _ = _counted(lambda: _fwd_bwd(case, case.fresh, strict=True),
                                  case.counter)
    gap = max(gap, _same(case, "fresh inputs", want_fresh, got))
    _check(per_replay == replayed(launches_fresh), f"{case.label}: a forward and backward "
           f"replay launch {replayed(launches_fresh)} (eager {launches_fresh}), got {per_replay}")
    # two forwards, then their backwards in reverse order
    a, b = _leaf_inputs(case, case.inputs), _leaf_inputs(case, case.fresh)
    ra, rb = _forward(case, a, True), _forward(case, b, True)
    got_b = _backward(case, b, rb, True)
    got_a = _backward(case, a, ra, True)
    gap = max(gap, _same(case, "interleaved, the later call", want_fresh, got_b),
              _same(case, "interleaved, the earlier call (its forward replayed again)",
                    want, got_a))
    # a second backward through the retained graph
    leaves = _leaf_inputs(case, case.inputs)
    once = _backward(case, leaves, _forward(case, leaves, True), True, retain=True)
    with _no_host_wait():
        _loss(once[0]).backward()      # the loss anew: its own graph is spent
    gap = max(gap, _same(case, "retain_graph, the first backward", want, once))
    twice = tuple(leaves[i].grad for i in case.wrt)
    _check(all(torch.equal(t, 2 * g) for t, g in zip(twice, once[2])),
           f"{case.label}: a second backward through the retained graph adds the same gradient")
    _check(prog.replays - replays == 5 and len(case.jitted.cache) == 1,
           f"{case.label}: five forward replays, one program ({prog.replays - replays})")
    print(f"  {case.label}: .backward() through its program pair equals disable_jit() bit for "
          f"bit in {len(_leaves(want))} outputs, the loss and the gradients"
          f"{f' (the Gumbel target gradient within {TOL_GUMBEL_TARGET_GRAD}: largest relative gap {gap:.3e})' if case.loose else ''}: "
          f"the first call (eager), the second, fresh inputs, two forwards with their "
          f"backwards reversed (the earlier forward replayed again), a retained second "
          f"backward; host waits per "
          f"replay 0{' (the forward reads the host outside its program: ICP.icp slices its histories)' if case.host_reads else ''}; "
          f"launches per forward + backward replay {per_replay} (eager {launches_fresh}); "
          f"first call (eager) {first_s * 1e3:.1f} ms, second call (warm-up, two captures, "
          f"a replay) {second_s * 1e3:.1f} ms, each with its backward, against "
          f"{eager_s * 1e3:.1f} ms eager; pool {prog.pool_bytes / 2**20:.1f} MiB "
          f"against the eager peak of {peak / 2**20:.1f} MiB")
    return {"launches": per_replay, "first_ms": first_s * 1e3, "second_ms": second_s * 1e3,
            "eager_ms": eager_s * 1e3, "pool": prog.pool_bytes, "peak": peak, "gap": gap}


def _backward_cases(device, head_inputs, sources, targets, pair) -> list:
    """Phase 28's .backward() cases, each at its phase's full shape."""
    src, tgt, ti = head_inputs
    cases = [_BackwardCase(
        f"register_ift_jit, the headline pair at B={B_HEAD} (K4 forward)", register_ift_jit,
        lambda s: register_ift_jit(s, tgt, ti, None, bench.head_config()), (src,),
        (_fresh(src, 280),))]
    cfg3 = ICPConfig(**HEAD)
    cases.append(_BackwardCase(
        f"register_jit(differentiable=True), phase 3's pair at B={B_HEAD} (dense tier)",
        _register_captured, lambda s: register_jit(s, tgt, ti, None, cfg3), (src,),
        (_fresh(src, 281),)))
    s4, t4 = to_torch(sources, device), to_torch(targets, device)
    ti4 = torch.eye(4, dtype=torch.float32, device=device).expand(s4.shape[0], 4, 4)
    cases.append(_BackwardCase(
        f"register_jit(differentiable=True), phase 4's {tuple(s4.shape)} -> {tuple(t4.shape)} "
        f"(tiled tier, K1)", _register_captured,
        lambda s: register_jit(s, t4, ti4, None, CFG_UNROLL_SLICE), (s4,),
        (_fresh(s4, 282),), heavy=True))
    solver = ICP(icp_type="pt2pl", differentiable=True, max_iterations=HEAD["max_iterations"],
                 tolerance=HEAD["tolerance"], device=device, collect_histories=False)

    def icp(s):
        out = solver.icp(s, tgt, ti, trim_dist=HEAD["trim_dist"],
                         loss_fn={"name": "huber", "metric": HEAD["loss_metric"]},
                         dim=HEAD["dim"])
        return _TPc(out["T"], out["pc"], out["stats"]["iterations"])

    cases.append(_BackwardCase(f"ICP.icp(differentiable=True), the headline pair at "
                               f"B={B_HEAD}", _register_captured, icp, (src,),
                               (_fresh(src, 283),), host_reads=True))
    S, Tg, Ti, _ = exp_gicp.saddle_batch(device)
    gkw = dict(max_iterations=30, tolerance=1e-6, differentiable=True)
    cases.append(_BackwardCase(
        f"register_gicp_jit(differentiable=True), exp_gicp's B = {exp_gicp.B} x {exp_gicp.N} "
        f"(normals inside the program)", register_gicp_jit,
        lambda s: register_gicp_jit(s, Tg, Ti, **gkw), (S,), (_fresh(S, 284),)))
    size, n, k, iters = exp_sgd.SIZES[0]
    S2, Tg2, Ti2, _ = exp_sgd.inputs(n, device)
    skw = dict(minibatch=k, iterations=iters, tolerance=1e-6, differentiable=True)
    cases.append(_BackwardCase(
        f"register_sgd_jit(differentiable=True), exp_sgd's {size} row (k = {k}, {iters} "
        f"iterations; D2)", register_sgd_jit,
        lambda s: register_sgd_jit(s, Tg2, Ti2, 0, **skw), (S2,), (_fresh(S2, 285),),
        heavy=True, replayed=_recomputed_draws))
    tgt_g = tgt.clone()
    cases.append(_BackwardCase(
        f"register_jit, the Gumbel headline's unrolled gradient at B={B_HEAD} into the "
        f"source and the target (D1)", _register_captured,
        lambda s, t: register_jit(s, t, ti, None, GUMBEL_CFG, key=KEY_GUMBEL),
        (src, tgt_g), (_fresh(src, 286), _fresh(tgt_g, 287)), wrt=(0, 1),
        loose={1: TOL_GUMBEL_TARGET_GRAD}, heavy=True,
        replayed=lambda want: {k: 2 * v if k == "threefry_uniform" else v
                               for k, v in want.items()}))
    src8, tgt8 = pair
    ti8 = torch.eye(4, dtype=torch.float32, device=device)[None]
    cfg8 = CFG_RAW.with_(differentiable=True)
    cases.append(_BackwardCase(
        f"register_jit(differentiable=True), phase 8's {src8.shape[0]} -> {tgt8.shape[0]} "
        f"pair (cluster tier, K2)", _register_captured,
        lambda s: register_jit(s, tgt8[None], ti8, None, cfg8), (src8[None],),
        (_fresh(src8[None], 288),), heavy=True))
    return cases


def _evicted_pair_case(head_inputs) -> None:
    """A loss over CACHE_SIZE + 1 register_jit(differentiable=True) calls of
    different batch sizes (rows of the headline pair), each its key's second
    call: the first call's pair leaves the cache when the last is captured,
    yet its .backward() replays it; values and gradients equal disable_jit()
    bit for bit, and the dropped pair is released once the loss is gone."""
    src, tgt, ti = head_inputs
    cfg = ICPConfig(**HEAD)
    n = jit.CACHE_SIZE + 1
    sizes = [8 * (b + 1) for b in range(n)]

    def leaves():   # one per call: each gradient comes from one call
        return [src[:b].detach().clone().requires_grad_(True) for b in sizes]

    def loss(xs, first=None):
        # unscaled: a scaled sum's cotangent reaches the pair expanded (stride
        # 0) and is copied into a dense buffer, which may move the solve's
        # backward by an ulp (PERF.md §6)
        value = 0.0
        for k, (x, b) in enumerate(zip(xs, sizes)):
            res = register_jit(x, tgt[:b], ti[:b], None, cfg)
            value = value + _loss(res)
            if first is not None and k == 0:
                first.append(next(reversed(_register_captured.cache.values())))
        return value

    with jit.disable_jit():
        want_xs = leaves()
        want = loss(want_xs)
        want.backward()
    _register_captured.cache_clear()
    xs = leaves()
    for x, b in zip(xs, sizes):     # first sightings: eager, nothing captured
        register_jit(x, tgt[:b], ti[:b], None, cfg)
    _check(not _register_captured.cache, "first sightings capture nothing")
    first = []
    value = loss(xs, first)
    (dropped,) = first
    _check(len(_register_captured.cache) == jit.CACHE_SIZE and id(dropped) in jit._retired
           and all(p is not dropped for p in _register_captured.cache.values())
           and jit._holders.get(id(dropped)) == 1 and dropped.inputs,
           "the first pair out of the cache, held by its call, not released")
    with _no_host_wait():
        value.backward()
    _check(torch.equal(value.detach(), want.detach())
           and all(torch.equal(x.grad, w.grad) for x, w in zip(xs, want_xs)),
           "a loss over CACHE_SIZE + 1 program pairs equals disable_jit() bit for bit")
    del value
    gc.collect()
    _check(id(dropped) not in jit._holders and not dropped.inputs and not jit._released_later,
           "the dropped pair released once the loss is gone")
    print(f"  a loss over {n} register_jit(differentiable=True) calls of B = {sizes} (each "
          f"its key's second call; the first pair out of the cache before the backward): "
          f".backward() equals disable_jit() bit for bit, no host wait; the dropped pair "
          f"released once the loss is gone")
    _register_captured.cache_clear()


def _in_program_cases(device, pair, recorded: dict) -> None:
    """The repaired fixed trips inside one program (jit over a function that
    calls torch.autograd.grad) against the uncaptured host loop
    (_captured_equals_eager): GICP at exp_gicp's row, SGD at exp_sgd's 20k
    row (its key's element keys made before the call, D2 drawing in the
    trip's forward and recomputing backward; and an explicit source's plan,
    its indices drawn ahead and D2 not launched), and the cluster tier at phase 8's
    pair (K2 recorded on the host loop's calls), each then timed against
    eager in turns; prints the certified share of the cluster solve."""

    def unit(solve, *inputs):
        with torch.enable_grad():
            s = inputs[0].clone().requires_grad_(True)
            res = solve(s, *inputs[1:])
            value = _loss(res)
            (grad,) = torch.autograd.grad(value, s)
        return res, value.detach(), grad

    calls = {}
    S, Tg, Ti, _ = exp_gicp.saddle_batch(device)
    gkw = dict(max_iterations=30, tolerance=1e-6, differentiable=True)
    gicp_unit = functools.partial(unit, lambda s, t, t0: register_gicp(s, t, t0, **gkw))
    gicp_jit = jit.jit(gicp_unit, name="gicp_unrolled")
    label = f"GICP's fixed trip in one program, exp_gicp's B = {exp_gicp.B} x {exp_gicp.N}"
    calls[label] = (lambda: gicp_unit(S, Tg, Ti), lambda: gicp_jit(S, Tg, Ti))
    S_b = _fresh(S, 290)
    _captured_equals_eager(label, *calls[label], gicp_jit,
                           (lambda: gicp_unit(S_b, Tg, Ti), lambda: gicp_jit(S_b, Tg, Ti)))
    steps = float(calls[label][1]()[0].iterations.max())
    print(f"  {label}: {steps:.0f} executed steps of {gkw['max_iterations']}")
    _alternated(label, *calls[label], rounds=2, iters=1)
    gicp_jit.cache_clear()

    size, n, k, iters = exp_sgd.SIZES[0]
    S2, Tg2, Ti2, _ = exp_sgd.inputs(n, device)
    plan = plan_solve(0, S2.shape[0], n, device, S2.dtype, iterations=iters, minibatch=k)
    skw = dict(minibatch=k, iterations=iters, tolerance=1e-6, differentiable=True)
    sgd_unit = functools.partial(unit, lambda s, t, t0, p: register_sgd(s, t, t0, p, **skw))
    sgd_jit = jit.jit(sgd_unit, name="sgd_unrolled")
    label = f"SGD-ICP's fixed trip in one program, exp_sgd's {size} row"
    calls[label] = (lambda: sgd_unit(S2, Tg2, Ti2, plan), lambda: sgd_jit(S2, Tg2, Ti2, plan))
    S2_b = _fresh(S2, 291)
    _check(plan.keys is not None, f"{label}: an int seed's plan holds element keys")
    _captured_equals_eager(label, *calls[label], sgd_jit,
                           (lambda: sgd_unit(S2_b, Tg2, Ti2, plan),
                            lambda: sgd_jit(S2_b, Tg2, Ti2, plan)), replayed=_recomputed_draws)
    steps = float(calls[label][1]()[0].iterations.max())
    print(f"  {label}: frozen at {steps:.0f} of {iters} iterations")
    _alternated(label, *calls[label], rounds=2, iters=1)
    sgd_jit.cache_clear()
    # an explicit source's plan: its indices drawn ahead, read by each step
    drawn = plan_solve(SeededSampler(0), S2.shape[0], n, device, S2.dtype, iterations=iters,
                       minibatch=k)
    label = f"SGD-ICP's fixed trip in one program, exp_sgd's {size} row, SeededSampler(0)'s plan"
    _check(drawn.keys is None and drawn.indices is not None,
           f"{label}: an explicit source's plan holds its drawn indices")
    before = _launches()["threefry_randint"]
    _captured_equals_eager(label, lambda: sgd_unit(S2, Tg2, Ti2, drawn),
                           lambda: sgd_jit(S2, Tg2, Ti2, drawn), sgd_jit,
                           (lambda: sgd_unit(S2_b, Tg2, Ti2, drawn),
                            lambda: sgd_jit(S2_b, Tg2, Ti2, drawn)))
    d2 = _launches()["threefry_randint"] - before
    _check(d2 == 0, f"{label}: the drawn-ahead plan launches no threefry_randint ({d2})")
    sgd_jit.cache_clear()

    src8, tgt8 = pair
    ti8 = torch.eye(4, dtype=torch.float32, device=device)[None]
    cfg8 = CFG_RAW.with_(differentiable=True)
    cl_unit = functools.partial(unit, lambda s, t, t0: register(s, t, t0, None, cfg8))
    cl_jit = jit.jit(cl_unit, name="cluster_unrolled")
    label = (f"the cluster tier's unrolled gradient in one program, phase 8's "
             f"{src8.shape[0]} -> {tgt8.shape[0]} pair (K2)")
    calls[label] = (lambda: cl_unit(src8[None], tgt8[None], ti8),
                    lambda: cl_jit(src8[None], tgt8[None], ti8))
    src8_b = _fresh(src8[None], 292)
    _captured_equals_eager(label, *calls[label], cl_jit,
                           (lambda: cl_unit(src8_b, tgt8[None], ti8),
                            lambda: cl_jit(src8_b, tgt8[None], ti8)))
    _alternated(label, *calls[label], rounds=2, iters=1)
    # K2 recorded on the host loop's calls: the program's last captured K2
    # launch lies in a step that a replay skips, whose buffers it never
    # writes; the program's K2 calls are the host loop's (bit-equal above)
    with _recording("cluster_search", recorded.setdefault(label, {})):
        res = calls[label][0]()[0]
    index = ck.build_cluster_index(tgt8[:, :3], GROUP)
    ps = torch.einsum("ij,pj->pi", res.T[0, :3, :3], src8) + res.T[0, :3, 3]
    _, _, cert = ck.cluster_nn(index, ps, probes=PROBES)
    share = float(cert.float().mean())
    print(f"  {label}: {float(res.iterations.max()):.0f} executed steps of "
          f"{cfg8.max_iterations}; certified share at the final pose {share:.4f} "
          f"(probes {PROBES}, group {GROUP})")


HVP_SEED = 300   # phase 28's second-order directions and fresh inputs
# phase 4's unrolled solve cut to 12 of its 50 steps for its HVP (it converges
# in 4): each step costs ~0.4 s of the second order's captures
CFG_UNROLL_HVP = CFG_UNROLL_SLICE.with_(max_iterations=12)


def _direction(x: torch.Tensor, seed: int) -> torch.Tensor:
    """A seeded standard normal tensor shaped as ``x``: an HVP's direction."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    return torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)


@contextlib.contextmanager
def _deterministic():
    """torch.use_deterministic_algorithms(True, warn_only=True) within the
    block.  The IFT's second backward scatter-adds (functorch's batched
    JVPs, recorded under create_graph), by default with atomics whose
    order may move the HVP's last bit; the deterministic kernels rule that
    out, so that a captured HVP can be held to its eager run bit for bit.
    (The call-to-call differences seen on the card came from autograd's
    thread counters instead: :func:`_on_autograd_thread`.)"""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def _forced_trip():
    """Solves on which autograd records take the fixed trip of their capture
    while uncaptured (its run-once nodes then read their flags on the host),
    as the CPU tests force it: the eager form of a captured trip's second
    derivatives.  The host loop's second backward sums the same terms in
    another grouping (within rounding, not bit for bit); the first order's
    sums group alike."""
    mods = (registration_mod, sharding)
    saved = [m.capturing for m in mods]
    for m in mods:
        m.capturing = lambda x=None: True
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.capturing = f


def _hvp_loss(res) -> torch.Tensor:
    """sum(T * probe) + sum(pc * w), w = 0.01 sin(0, 1, 2, ...): every
    output's cotangent dense.  A scaled sum (``_loss``'s 0.01 sum(pc)) hands
    the outputs an expanded (stride-0) cotangent, which a program's static
    buffer holds dense; the second backward's bits follow that layout."""
    probe = torch.linspace(0.5, 1.5, 16, dtype=res.T.dtype, device=res.T.device).reshape(4, 4)
    w = 0.01 * torch.sin(torch.arange(res.pc.numel(), dtype=res.pc.dtype,
                                      device=res.pc.device)).reshape(res.pc.shape)
    return torch.sum(res.T * probe) + torch.sum(res.pc * w)


def _hvp(call, x, v, strict: bool = False) -> tuple:
    """(result, loss, gradient, Hessian-vector product) of
    :func:`_hvp_loss` through ``call`` at ``x`` along ``v``:
    torch.autograd.grad with create_graph, then torch.autograd.grad of
    sum(gradient * v); with ``strict`` under the sync debug mode's
    "error"."""
    s = x.detach().clone().requires_grad_(True)
    with _no_host_wait() if strict else contextlib.nullcontext():
        res = call(s)
        value = _hvp_loss(res)
        (g,) = torch.autograd.grad(value, s, create_graph=True)
        (h,) = torch.autograd.grad(torch.sum(g * v), s)
    return res, value.detach(), g.detach(), h


class _HvpCase(NamedTuple):
    """A Hessian-vector product through a jitted entry point: ``call(x)``
    runs it (a program pair where ``x`` requires grad), ``solve(x)`` its
    function (the in-program unit's); ``fresh`` other inputs of ``x``'s
    shape; ``trip``: autograd records the solve on the fixed trip under
    capture (its eager reference then forces the trip)."""

    label: str
    jitted: object
    call: object
    solve: object
    x: torch.Tensor
    fresh: torch.Tensor
    v: torch.Tensor
    trip: bool


def _on_autograd_thread(fn, device):
    """``fn()`` inside an autograd backward, on the engine's thread for
    ``device``, with grad mode on.  The engine runs ready nodes in the order
    of a per-thread creation counter.  A program pair's VJP builds a
    forward and its create_graph backward on that thread, in that order;
    an eager HVP called on this thread builds its forward here and its
    backward there, so its second backward's sums group by whichever
    thread's counter is ahead, and its last bits move with the process's
    history (on an H100 in the full script: 1.9e-9 of 3.8e-2 at the
    headline).  Run here, the eager HVP is built as the pair's is."""
    out = []

    class _Run(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, grad):
            with torch.enable_grad():
                out.append(fn())
            return grad

    x = torch.zeros((), device=device, requires_grad=True)
    torch.autograd.grad(_Run.apply(x), x)
    return out[0]


def _hvp_pair_equals_eager(case: _HvpCase) -> dict:
    """A double backward through the case's program pair against the same
    calls under disable_jit(), bit for bit in every output, the loss, the
    gradient and the HVP: the key's first call (eager: nothing captured),
    its second (the pair captured; the VJP call of the double backward
    eager, its key's first sighting), its third (the pair replayed; the VJP
    captured as a pair of its own) and fresh inputs (every program
    replayed, the sync debug mode at "error": no host wait).  The eager
    runs, the first call's included, run on autograd's thread
    (:func:`_on_autograd_thread`); the same HVP built on this thread is
    printed beside them.  Where the solve takes the fixed trip under
    capture, the calls whose VJP ran eagerly (the host loop) are held to
    the host loop's HVP and the others to the forced trip's
    (:func:`_forced_trip`); the two are printed apart.  Returns the
    launches per replayed HVP, the first, second and third calls' host ms,
    the eager ms, the two programs' pools and the eager peak."""
    device = case.x.device

    def eager(x, trip=False):
        def run():   # disable_jit holds for its own thread only
            with jit.disable_jit(), _forced_trip() if trip else contextlib.nullcontext():
                return _hvp(case.call, x, case.v)
        return _on_autograd_thread(run, device)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with jit.disable_jit():
        here, _, eager_s = _counted(lambda: _hvp(case.call, case.x, case.v))
    peak = torch.cuda.max_memory_allocated() - base
    host = eager(case.x)
    want = eager(case.x, case.trip)
    want_fresh, launches_fresh, _ = _counted(lambda: eager(case.fresh, case.trip))

    def rel(a, b):
        return _max_abs_diff(a[3].double(), b[3].double()) / float(b[3].abs().max())

    case.jitted.cache_clear()
    seconds = []
    calls = [lambda: _on_autograd_thread(lambda: _hvp(case.call, case.x, case.v), device)]
    calls += [lambda: _hvp(case.call, case.x, case.v)] * 2
    for k, (call, ref) in enumerate(zip(calls, (host, host, want))):
        got, _, sec = _counted(call)
        seconds.append(sec)
        diff = _diff_fields(ref, got)
        _check(not diff, f"{case.label}, call {k + 1}: equal to the disable_jit() run bit for "
               f"bit (differing: {diff})")
        _check(bool(torch.isfinite(got[3]).all()) and bool((got[3] != 0).any()),
               f"{case.label}, call {k + 1}: the HVP finite and nonzero")
        if k == 0:
            _check(not case.jitted.cache, f"{case.label}: the first call captures nothing")
    pair = next(reversed(case.jitted.cache.values()))
    vjp = next(reversed(case.jitted.vjp.cache.values()))
    _check(pair.bwd_graph is not None and vjp.bwd_graph is not None
           and len(case.jitted.cache) == 1 and len(case.jitted.vjp.cache) == 1,
           f"{case.label}: one program pair and one VJP pair")
    got, per_replay, _ = _counted(lambda: _hvp(case.call, case.fresh, case.v, strict=True))
    diff = _diff_fields(want_fresh, got)
    _check(not diff, f"{case.label}, fresh inputs: equal to the disable_jit() run bit for bit "
           f"(differing: {diff})")
    _check(per_replay == _twice(launches_fresh), f"{case.label}: a replayed HVP launches "
           f"{_twice(launches_fresh)} (eager {launches_fresh}), got {per_replay}")
    print(f"  {case.label}: a double backward through its program pair equals disable_jit() "
          f"bit for bit in {len(_leaves(want))} outputs, the loss, the gradient and the HVP "
          f"(first call eager; second: the pair captured, the VJP eager"
          f"{' on the host loop' if case.trip else ''}; third: the VJP captured as a pair"
          f"{', held to the forced trip' if case.trip else ''}; fresh inputs, every program "
          f"replayed, host waits 0; the eager runs on autograd's thread, the same HVP built "
          f"on the caller's thread {rel(here, host):.3e} relative from them)"
          f"{f'; the host loop HVP against the trip {rel(host, want):.3e} relative' if case.trip else ''}; "
          f"launches per replayed HVP {per_replay} (eager {launches_fresh}); first, second "
          f"and third call {', '.join(f'{t * 1e3:.1f}' for t in seconds)} ms against "
          f"{eager_s * 1e3:.1f} ms eager; pools {pair.pool_bytes / 2**20:.1f} MiB (the pair) "
          f"and {vjp.pool_bytes / 2**20:.1f} MiB (its VJP pair) against the eager peak of "
          f"{peak / 2**20:.1f} MiB")
    return {"launches": per_replay, "eager_launches": launches_fresh,
            "calls_ms": [t * 1e3 for t in seconds], "eager_ms": eager_s * 1e3,
            "pool": pair.pool_bytes, "vjp_pool": vjp.pool_bytes, "peak": peak,
            "host_gap": rel(host, want), "thread_gap": rel(here, host)}


def _twice(launches: dict) -> dict:
    """What a replayed double backward through a program pair launches
    where its eager run launches ``launches``: each kernel twice, since the
    VJP program runs the call's forward again (the eager HVP differentiates
    the forward's own graph)."""
    return {k: 2 * v for k, v in launches.items()}


def _second_order_cases(device, head_inputs, sources, targets) -> dict:
    """Phase 28's second derivatives: the headline HVP (register_ift_jit at
    B = 256, K4's forward) and the unrolled HVP at phase 4's first pair
    (register_jit(differentiable=True), the tiled tier, K1), each by a
    double backward through its program pair (:func:`_hvp_pair_equals_eager`)
    and inside one program (jit over a function that calls
    torch.autograd.grad twice; :func:`_captured_equals_eager`), then eager,
    pair and in-program in turns (CUDA events); every call with the
    deterministic kernels (:func:`_deterministic`).  Returns the
    measurements."""
    with _deterministic():
        return _second_order_checked(device, head_inputs, sources, targets)


def _second_order_checked(device, head_inputs, sources, targets) -> dict:
    src, tgt, ti = head_inputs
    cfg = bench.head_config()
    s4 = to_torch(sources[:1], device)
    t4 = to_torch(targets[:1], device)
    ti4 = torch.eye(4, dtype=torch.float32, device=device)[None]
    cases = [
        _HvpCase(f"register_ift_jit's HVP, the headline pair at B={B_HEAD} (K4 forward)",
                 register_ift_jit, lambda s: register_ift_jit(s, tgt, ti, None, cfg),
                 lambda s: register_ift(s, tgt, ti, None, cfg), src,
                 _fresh(src, HVP_SEED + 1), _direction(src, HVP_SEED), False),
        _HvpCase(f"register_jit(differentiable=True)'s HVP, phase 4's first pair "
                 f"{tuple(s4.shape)} -> {tuple(t4.shape)} (tiled tier, K1; "
                 f"{CFG_UNROLL_HVP.max_iterations} steps)", _register_captured,
                 lambda s: register_jit(s, t4, ti4, None, CFG_UNROLL_HVP),
                 lambda s: register(s, t4, ti4, None, CFG_UNROLL_HVP), s4,
                 _fresh(s4, HVP_SEED + 3), _direction(s4, HVP_SEED + 2), True)]
    out = {}
    for case in cases:
        checked = _hvp_pair_equals_eager(case)

        def unit(x, v, solve=case.solve):
            with torch.enable_grad():
                return _hvp(solve, x, v)

        program = jit.jit(unit, name="hvp_in_program")
        trip = _forced_trip if case.trip else contextlib.nullcontext

        def eager(x, unit=unit, trip=trip):
            with jit.disable_jit(), trip():
                return unit(x, case.v)

        label = case.label.replace("'s HVP", "'s HVP in one program")
        _captured_equals_eager(label, lambda: eager(case.x), lambda: program(case.x, case.v),
                               program, (lambda: eager(case.fresh),
                                         lambda: program(case.fresh, case.v)))
        case.jitted.cache_clear()
        _hvp(case.call, case.x, case.v)      # the key's first sighting: eager
        _hvp(case.call, case.x, case.v)      # the pair; its VJP's first sighting
        _hvp(case.call, case.x, case.v)      # the VJP's pair
        times = bench.time_alternated(
            {"eager": functools.partial(_eager_hvp, case),
             "pair": lambda: _hvp(case.call, case.x, case.v),
             "in one program": lambda: program(case.x, case.v)},
            device, iters=3, rounds=2, max_ms=TURN_BUDGET_MS)
        med = {name: statistics.median(v) for name, v in times.items()}
        print(f"  {case.label}: ms per forward + gradient + HVP (medians of "
              f"{len(times['eager'])}, in turns): "
              + "; ".join(f"{name} {t:.4f}" for name, t in med.items()))
        checked["ms"] = med
        out[case.label] = checked
        program.cache_clear()
        case.jitted.cache_clear()
    return out


def _eager_hvp(case: _HvpCase) -> tuple:
    with jit.disable_jit():
        return _hvp(case.call, case.x, case.v)


CFG_MAP_GRAD = CFG_MAP.with_(differentiable=True)   # phase 8's pair, map-sharded, differentiated
CFG_RING_GRAD = CFG_RING.with_(differentiable=True)  # phase 4's first pair, the ring differentiated


def _trip_replayed(cfg: ICPConfig, unrolled: bool, ranks: int = 1, ring: bool = False):
    """What a replay of a map-sharded solve's fixed trip launches where the
    uncaptured host loop launches ``want`` (K2 and collectives): K2 as the
    host loop (a skipped step searches nothing, the backward recomputes
    without a search); the forward's summands all-reduced max_iterations + 1
    times, not iterations + 1; with ``unrolled`` the backward's all-reduce
    of the pose's cotangent max_iterations times, not iterations times (once
    per step after the first, and the cost pass's); on the ``ring`` (whose
    summands carry no certificate) ranks - 1 shifts per step, and with its
    backward as many reverse shifts, max_iterations + 1 ring calls, not
    iterations + 1; everything else, the IFT backward's included, as the
    host loop."""
    k = 3 if cfg.dim == 2 else 6
    n_ne = k * k + k + 1
    summands = f"collective all_reduce {ranks} {n_ne if ring else 2 * n_ne + 1}"
    pose = f"collective all_reduce {ranks} 12"
    shifts = ("collective ring_shift ", "collective ring_shift_reverse ")

    def replayed(want: dict) -> dict:
        steps = want[summands] - 1    # the host loop's iterations
        moved = (summands, pose) if unrolled else (summands,)
        extra = cfg.max_iterations - steps
        return {key: n + extra if key in moved else
                n + (ranks - 1) * extra if key.startswith(shifts) else n
                for key, n in want.items()}
    return replayed


def _map_sharded_backward_cases(device, pair, ring_pair) -> dict:
    """The map-sharded gradients as programs at phase 8's pair (cluster
    tier, K2) in an NCCL world of one, each against its uncaptured run:
    register_map_sharded by .backward() through its program pair
    (map_sharded_fn's) and its fixed trip inside one program that calls
    torch.autograd.grad, and register_map_sharded_ift the same two ways (a
    jit over a call of it; its backward inside the pair's backward program).
    Collectives per replay (_trip_replayed): the unrolled forward
    max_iterations + 1, its backward max_iterations + a constant, the IFT
    backward a constant.  Then eager against captured in turns.  Then the
    ring's unrolled gradient into the source and the sharded target at
    ``ring_pair`` (phase 4's first pair) the same two ways (_ring_cases).
    Returns the .backward() cases' measurements."""
    src8, tgt8 = pair
    ti = torch.eye(4, dtype=torch.float32, device=device)
    cfg = CFG_MAP_GRAD
    mesh = make_mesh((1, 1))
    _check(dist.get_backend() == "nccl", f"the world of one runs on NCCL ({dist.get_backend()})")
    checked = {}
    try:
        ift_jit = jit.jit(lambda s: register_map_sharded_ift(mesh, s, tgt8, ti, cfg=cfg),
                          name="map_sharded_ift")
        cases = [
            _BackwardCase(f"register_map_sharded, phase 8's {src8.shape[0]} -> "
                          f"{tgt8.shape[0]} pair (cluster tier, K2; its fixed trip)",
                          sharding.map_sharded_fn(mesh, cfg),
                          lambda s: register_map_sharded(mesh, s, tgt8, ti, cfg=cfg), (src8,),
                          (_fresh(src8, 293),), heavy=True,
                          replayed=_trip_replayed(cfg, unrolled=True),
                          counter=_launches_and_collectives),
            _BackwardCase("register_map_sharded_ift in a jitted call, phase 8's pair (its "
                          "backward captured)", ift_jit, ift_jit, (src8,), (_fresh(src8, 294),),
                          heavy=True, replayed=_trip_replayed(cfg, unrolled=False),
                          counter=_launches_and_collectives)]
        for case in cases:
            checked[case.label] = _backward_equals_eager(case)
            checked[case.label]["turns"] = _alternated(
                f"{case.label}, forward + .backward()", functools.partial(_eager_fb, case),
                functools.partial(_fwd_bwd, case, case.inputs), rounds=2, iters=1)
            case.jitted.cache_clear()

        def unit(solve, s, t, t0):
            with torch.enable_grad():
                s = s.clone().requires_grad_(True)
                # the inner map_sharded_fn stays out of the program's warm-up
                # (a jitted call there would count as its key's first
                # sighting); inside the capture it is part of the program
                with jit.disable_jit():
                    res = solve(mesh, s, t, t0, cfg=cfg)
                value = _loss(res)
                (grad,) = torch.autograd.grad(value, s)
            return res, value.detach(), grad

        src8_b = _fresh(src8, 295)
        for solve, name, unrolled in ((register_map_sharded, "map_sharded_unrolled", True),
                                      (register_map_sharded_ift, "map_sharded_ift_grad", False)):
            call = functools.partial(unit, solve)
            jitted = jit.jit(call, name=name)
            label = (f"{solve.__name__}'s gradient in one program, phase 8's pair (K2; "
                     f"{'the fixed trip' if unrolled else 'the IFT backward'})")
            _captured_equals_eager(label, _eager(lambda: call(src8, tgt8, ti)),
                                   lambda: jitted(src8, tgt8, ti), jitted,
                                   (_eager(lambda: call(src8_b, tgt8, ti)),
                                    lambda: jitted(src8_b, tgt8, ti)),
                                   counter=_launches_and_collectives,
                                   replayed=_trip_replayed(cfg, unrolled))
            steps = int(jitted(src8, tgt8, ti)[0].iterations)
            print(f"  {label}: {steps} executed steps of {cfg.max_iterations}")
            _alternated(label, _eager(lambda: call(src8, tgt8, ti)),
                        lambda: jitted(src8, tgt8, ti), rounds=2, iters=1)
            jitted.cache_clear()
        checked.update(_ring_cases(mesh, ring_pair))
    finally:
        jit.clear_caches()
        dist.destroy_process_group()
    return checked


def _ring_cases(mesh, ring_pair) -> dict:
    """The ring's unrolled gradient (register_ring_sharded, differentiable,
    into the source and the sharded target; CFG_RING_GRAD) at ``ring_pair``
    on ``mesh``'s map axis, each against its uncaptured run as the
    map-sharded gradients are: by .backward() through map_sharded_fn's
    program pair (_backward_equals_eager) and inside one program that calls
    torch.autograd.grad (_captured_equals_eager), the target gradient
    finite and nonzero, collectives per replay by _trip_replayed (on a ring
    of one no shift), then eager against captured in turns.  Returns the
    .backward() case's measurements."""
    s4, t4 = ring_pair
    cfg = CFG_RING_GRAD
    ti = torch.eye(4, dtype=s4.dtype, device=s4.device)
    ranks = dist.get_world_size(mesh.get_group("map"))
    replayed = _trip_replayed(cfg, unrolled=True, ranks=ranks, ring=True)
    shape = f"{tuple(s4.shape)} -> {tuple(t4.shape)}"
    case = _BackwardCase(
        f"register_ring_sharded, phase 4's {shape} pair (the ring's fixed trip; into the "
        f"source and the sharded target)",
        sharding.map_sharded_fn(mesh, cfg, target_sharded=True),
        lambda s, t: register_ring_sharded(mesh, s, t, ti, cfg=cfg), (s4, t4),
        (_fresh(s4, 297), _fresh(t4, 298)), wrt=(0, 1), heavy=True, replayed=replayed,
        counter=_launches_and_collectives)
    g_target = _eager_fb(case)[2][1]
    _check(bool(torch.isfinite(g_target).all()) and bool((g_target != 0).any()),
           f"{case.label}: the target gradient finite and nonzero")
    checked = {case.label: _backward_equals_eager(case)}
    checked[case.label]["turns"] = _alternated(
        f"{case.label}, forward + .backward()", functools.partial(_eager_fb, case),
        functools.partial(_fwd_bwd, case, case.inputs), rounds=2, iters=1)
    case.jitted.cache_clear()
    print(f"  {case.label}: target gradient |g| {float(g_target.norm()):.3e}, rows with a "
          f"gradient {int((g_target.abs().sum(dim=-1) != 0).sum())} of {t4.shape[0]}")

    def unit(s, t):
        with torch.enable_grad():
            s, t = s.clone().requires_grad_(True), t.clone().requires_grad_(True)
            with jit.disable_jit():   # the inner program stays out of the warm-up
                res = register_ring_sharded(mesh, s, t, ti, cfg=cfg)
            value = _loss(res)
            grads = torch.autograd.grad(value, (s, t))
        return res, value.detach(), *grads

    jitted = jit.jit(unit, name="ring_sharded_unrolled")
    s4b, t4b = case.fresh
    label = f"register_ring_sharded's gradient in one program, phase 4's {shape} pair"
    _captured_equals_eager(label, _eager(lambda: unit(s4, t4)), lambda: jitted(s4, t4), jitted,
                           (_eager(lambda: unit(s4b, t4b)), lambda: jitted(s4b, t4b)),
                           counter=_launches_and_collectives, replayed=replayed)
    steps = int(jitted(s4, t4)[0].iterations)
    print(f"  {label}: {steps} executed steps of {cfg.max_iterations}")
    _alternated(label, _eager(lambda: unit(s4, t4)), lambda: jitted(s4, t4), rounds=2, iters=1)
    jitted.cache_clear()
    return checked


def phase28_backward(device, head_inputs, sources, targets, pair) -> dict:
    """.backward() through captured programs (jit's program pairs) against
    disable_jit(); GICP's, SGD's and the cluster tier's fixed trips inside
    one program against the host loop; then eager against captured in
    turns and the headline's .backward() beside bench.fwdbwd_jit.  Returns
    the phase's launches and K2's largest |difference| to its plain
    version."""
    t_phase = time.perf_counter()
    _reset_launches()
    checked, cases = {}, _backward_cases(device, head_inputs, sources, targets, pair)
    for case in cases:
        checked[case.label] = _backward_equals_eager(case)
        # timed while its program pair is cached
        checked[case.label]["turns"] = _alternated(
            f"{case.label}, forward + .backward()", functools.partial(_eager_fb, case),
            functools.partial(_fwd_bwd, case, case.inputs), rounds=2,
            iters=1 if case.heavy else 2)
    head = cases[0]
    _evicted_pair_case(head_inputs)
    recorded = {}
    _in_program_cases(device, pair, recorded)
    second = _second_order_cases(device, head_inputs, sources, targets)
    checked.update(_map_sharded_backward_cases(
        device, pair, (to_torch(sources[0], device), to_torch(targets[0], device))))
    launches = _launches()
    k2_err = _held_to_plain("cluster_search", recorded)
    src, tgt, ti = head_inputs
    cfg = bench.head_config()
    times = bench.time_alternated(
        {"eager": lambda: _eager_fb(head),
         ".backward() through register_ift_jit": lambda: _fwd_bwd(head, head.inputs),
         "bench.fwdbwd_jit (forward and backward in one program)":
             lambda: bench.fwdbwd_jit(src, tgt, ti, cfg)},
        device, iters=5, rounds=2)
    print(f"  the headline unit at B={B_HEAD}, ms per forward + gradient (medians of "
          f"{len(times['eager'])}, in turns): " + "; ".join(
              f"{name} {statistics.median(v):.4f} ({B_HEAD / statistics.median(v) * 1e3:.1f} "
              f"registrations/s)" for name, v in times.items()))
    jit.clear_caches()
    print(f"phase 28 ok: .backward() through every captured program pair equals its "
          f"disable_jit() run bit for bit (fresh inputs, interleaved forwards, retain_graph; "
          f"no host wait in a replay); the GICP, SGD, cluster-tier and map-sharded fixed "
          f"trips and the sharded IFT's backward in one program equal the host loop; the "
          f"headline's and phase 4's Hessian-vector products through their program pairs "
          f"and in one program equal disable_jit(); launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "k2_err": k2_err, "cases": checked, "second_order": second}


def _eager_fb(case: _BackwardCase) -> tuple:
    with jit.disable_jit():
        return _fwd_bwd(case, case.inputs)


def main() -> None:
    card = phase0_device()
    device = torch.device("cuda", 0)
    libs = phase1_build()
    sources, targets, T_true = scene_pairs(np.random.default_rng(SEED), B, N_SRC, M_TGT)
    k1 = phase2_kernel(device, sources, targets)
    phase3_reference(device)
    launches, slice_solve = phase4_slice(device, sources, targets, T_true)
    phase5_cluster_build(libs)
    mp, scan, T_pair = raw_scan_pair(np.random.default_rng(SEED + 8), M_MAP)
    raw_sources, raw_targets, T_raw = scene_pairs(np.random.default_rng(SEED + 9),
                                                  B_RAW, N_RAW, M_RAW)
    timed = phase6_search_kernels(device, mp, scan, raw_targets, raw_sources)
    timed["cluster_topk"] = phase7_topk_kernel(device, mp, scan)
    single, single_solve, pair = phase8_single_pair(device, mp, scan, T_pair)
    batched, batched_solve = phase9_batched(device, raw_sources, raw_targets, T_raw)
    phase10_fused_build(libs)
    k4 = phase11_fused_kernel(device)
    k4_launches, headline_call = phase12_headline(device)
    scored = phase13_score_kernels(device, libs)
    ab_launches = phase14_exp_knn()
    phase15_gumbel(device, sources, targets)
    with tempfile.TemporaryDirectory(prefix="dicp_smoke_scans_") as workdir:
        odo_launches, stream_w1, k2_err, host = phase17_lidar_odometry(device, Path(workdir))
        s2m_launches, s2m_d2, k2_err_s2m, s2m_stream = phase18_scan_to_map(device)
        pyramid = phase19_gicp_multiscale(device)
        slam_k1, slam_k2, slam_stream, slam_case, slam_scans = phase20_slam(device)
        par = phase21_parallel(device, pair, T_pair, sources, targets, T_true,
                               (to_torch(raw_sources, device), to_torch(raw_targets, device)),
                               T_raw, slam_case)
        suite = phase22_bench_suite_examples(device)
        captured = phase23_captured(device, reference_batch(device),
                                    (to_torch(sources, device), to_torch(targets, device)),
                                    pair, (to_torch(raw_sources, device),
                                           to_torch(raw_targets, device)), host)
        solvers = phase24_captured_solvers(
            device, (to_torch(sources, device), to_torch(targets, device)),
            (to_torch(raw_sources, device), to_torch(raw_targets, device)), slam_case,
            slam_scans)
        del slam_scans
        backend = phase25_captured_backend(device, host, slam_case)
        del host
        last = phase26_captured_gumbel(device, reference_batch(device), sources, targets)
        unrolled = phase27_unrolled_captured(device, reference_batch(device), sources, targets)
        backward = phase28_backward(device, reference_batch(device), sources, targets, pair)
        timed["cluster_search"]["max_abs_err"] = max(timed["cluster_search"]["max_abs_err"],
                                                     k2_err, k2_err_s2m, pyramid["k2_err"],
                                                     slam_k2["k2_err"], par["k2_err"],
                                                     solvers["k2_err"], backend["k2_err"],
                                                     backward["k2_err"])
        k1["max_abs_err"] = max(k1["max_abs_err"], slam_k1["k1_err"], solvers["k1_err"],
                                unrolled["k1_err"])
        for name, got in (("tiled_nn", k1), ("cluster_search", timed["cluster_search"]),
                          ("cluster_topk", timed["cluster_topk"]), ("fused_gn", k4)):
            got["max_abs_err"] = max(got["max_abs_err"], suite["max_abs_err"].get(name, 0.0))
        # last, so that no timing above runs after the profiler has been on
        # ICP.icp runs register_jit: phases 4, 8 and 9 profile captured programs;
        # phase 4's eager register, phase 12's captured unit and phase 17's
        # eager stream stand beside their other forms
        _profile(slice_solve, "phase 4, captured (ICP.icp)", focus=("tiled_nn_kernel",))
        _profile(captured["slice"][0], "phase 4, eager register", focus=("tiled_nn_kernel",))
        _profile(single_solve, "phase 8 (icp call), captured", focus=("cluster_search_kernel",))
        _profile(batched_solve, "phase 9, captured", focus=("cluster_search_kernel",))
        _profile(headline_call, "phase 12, IFT, K4 forward", focus=("fused_gn_kernel",))
        _profile(captured["head"][1], "phase 12, IFT unit captured (bench.fwdbwd_jit)",
                 focus=("fused_gn_kernel",))
        ops = _profile(stream_w1, f"phase 17, W=1 warm stream of {PROFILE_SCANS} scans, "
                       "captured windows", calls=1, focus=("cluster_search_kernel",))
        print(f"  phase 17 stream: {ops / (PROFILE_SCANS - 1):.1f} device ops per pair")
        with _eager_windows():
            ops = _profile(stream_w1, f"phase 17, W=1 warm stream of {PROFILE_SCANS} scans, "
                           "eager windows", calls=1, focus=("cluster_search_kernel",))
        print(f"  phase 17 eager stream: {ops / (PROFILE_SCANS - 1):.1f} device ops per pair")
        # phases 18 and 20 run captured programs (phase 24): each stream beside
        # its eager form
        for form, ctx in (("captured", contextlib.nullcontext), ("eager", _eager_programs)):
            with ctx():
                ops = _profile(s2m_stream, f"phase 18, gn scan-to-map stream of "
                               f"{PROFILE_S2M_SCANS} scans, {form} map_step", calls=1,
                               focus=("cluster_search_kernel",))
                print(f"  phase 18 stream, {form}: {ops / PROFILE_S2M_SCANS:.1f} device ops "
                      f"per scan")
                ops = _profile(slam_stream, f"phase 20, SLAM stream of {PROFILE_SLAM_SCANS} "
                               f"scans, {form} programs", calls=1,
                               focus=("tiled_nn_kernel", "cluster_search_kernel"))
                print(f"  phase 20 stream, {form}: {ops / PROFILE_SLAM_SCANS:.1f} device ops "
                      f"per scan")
        # phase 21's map-sharded call in a world of one of its own
        mesh = make_mesh((1, 1))
        try:
            ops = _profile(lambda: par["call"](mesh), "phase 21, map-sharded call on NCCL",
                           focus=("cluster_search_kernel", "nccl"))
        finally:
            dist.destroy_process_group()
        print(f"  phase 21 map-sharded: {ops / (par['iterations'] + 1):.1f} device ops per "
              f"iteration ({par['iterations']} iterations and the cost pass)")
    print("phase 16 ok: profiles of phases 4, 8, 9, 12, 17, 18, 20 and 21 (18 and 20 "
          "captured and eager)")

    def suite_launches(name):
        """Phase 22's launches of kernel ``name``: per row or example, and their sum."""
        rows = {label: c[name] for label, c in suite["launches"].items() if c.get(name)}
        return rows, sum(rows.values())
    kernels = [{
        "name": "tiled_nn",
        "route": "cuda",
        "source": "dicp_tpu_torch/csrc/tiled_nn.cu",
        "replaces": "dicp_tpu/ops/pallas_knn.py:50",
        **k1,
        "launches": (launches + slam_k1["launches"] + suite_launches("tiled_nn")[1]
                     + par["launches"]["tiled_nn"]
                     + captured["launches"]["tiled_nn"] + solvers["launches"]["tiled_nn"]
                     + backend["launches"]["tiled_nn"] + last["launches"]["tiled_nn"]
                     + unrolled["launches"]["tiled_nn"] + backward["launches"]["tiled_nn"]),
        "launches_in_phase21": par["launches"]["tiled_nn"],
        "launches_in_phase23": captured["launches"]["tiled_nn"],
        "launches_in_phase24": solvers["launches"]["tiled_nn"],
        "launches_in_phase25": backend["launches"]["tiled_nn"],
        "launches_in_phase26": last["launches"]["tiled_nn"],
        "launches_in_phase27": unrolled["launches"]["tiled_nn"],
        "launches_in_phase28": backward["launches"]["tiled_nn"],
        "launches_per_slam_scan": slam_k1["launches_per_slam_scan"],
        "launches_per_suite_row": suite_launches("tiled_nn")[0],
    }]
    sources_of = {"cluster_search": ("dicp_tpu_torch/csrc/cluster_search.cu",
                                     "dicp_tpu/ops/pallas_cluster.py:126"),
                  "cluster_block_search": ("dicp_tpu_torch/csrc/cluster_search.cu",
                                           "dicp_tpu/ops/pallas_cluster.py:33"),
                  "cluster_topk": ("dicp_tpu_torch/csrc/cluster_topk.cu",
                                   "dicp_tpu/ops/pallas_cluster.py:278")}
    for name, (source, replaces) in sources_of.items():
        count = single[name] + batched[name]
        _check(count > 0, f"{name} launched on the raw-scan paths ({count})")
        extra = {}
        if name == "cluster_search":
            count += (sum(odo_launches.values()) + sum(s2m_launches.values())
                      + pyramid["launches_single"] + pyramid["launches_per_multiscale_call"]
                      + slam_k2["launches"])
            extra = {"launches_per_streamed_pair": {
                         label: k / (S_SEQ - 1) for label, k in odo_launches.items()
                         if label != "batched odometry"},
                     "launches_per_batched_odometry_call": odo_launches["batched odometry"],
                     "launches_per_scan_to_map_scan": {
                         label: k / (S_S2M - 1) for label, k in s2m_launches.items()},
                     "launches_per_slam_closure": slam_k2["launches_per_slam_closure"],
                     "launches_per_multiscale_call": pyramid["launches_per_multiscale_call"],
                     "launches_per_map_sharded_call": par["launches_per_map_sharded_call"]}
        per_row, in_suite = suite_launches(name)
        in21 = par["launches"][name]
        in23, in24 = captured["launches"][name], solvers["launches"][name]
        in25, in26 = backend["launches"][name], last["launches"][name]
        in28 = backward["launches"][name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": count + in_suite + in21 + in23 + in24 + in25 + in26 + in28,
                        **timed[name], **extra, "launches_per_suite_row": per_row,
                        "launches_in_phase21": in21, "launches_in_phase23": in23, "launches_in_phase24": in24,
                        "launches_in_phase25": in25, "launches_in_phase26": in26,
                        "launches_in_phase28": in28})
    _check(k4_launches > 0, f"fused_gn launched on the headline path ({k4_launches})")
    kernels.append({"name": "fused_gn", "route": "cuda",
                    "source": "dicp_tpu_torch/csrc/fused_gn.cu",
                    "replaces": "dicp_tpu/ops/fused_gn.py:167",
                    "launches": (k4_launches + suite_launches("fused_gn")[1]
                                 + par["launches"]["fused_gn"]
                                 + captured["launches"]["fused_gn"]
                                 + solvers["launches"]["fused_gn"]
                                 + backend["launches"]["fused_gn"]
                                 + last["launches"]["fused_gn"]
                                 + backward["launches"]["fused_gn"]), **k4,
                    "launches_in_phase21": par["launches"]["fused_gn"],
                    "launches_in_phase23": captured["launches"]["fused_gn"],
                    "launches_in_phase24": solvers["launches"]["fused_gn"],
                    "launches_in_phase25": backend["launches"]["fused_gn"],
                    "launches_in_phase26": last["launches"]["fused_gn"],
                    "launches_in_phase28": backward["launches"]["fused_gn"],
                    "launches_per_suite_row": suite_launches("fused_gn")[0]})
    for name, replaces in (("score_nn_v1", "benchmarks/exp_knn.py:69"),
                           ("score_nn_v2", "benchmarks/exp_knn.py:137")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "dicp_tpu_torch/csrc/score_nn.cu", "replaces": replaces,
                        "launches": ab_launches[name], **scored[name]})
    d1_launches = (last["launches"]["threefry_uniform"]
                   + unrolled["launches"]["threefry_uniform"]
                   + backward["launches"]["threefry_uniform"])
    _check(d1_launches > 0, f"threefry_uniform launched on the Gumbel paths ({d1_launches})")
    kernels.append({"name": "threefry_uniform", "route": "cuda",
                    "source": "dicp_tpu_torch/csrc/threefry.cu",
                    "replaces": "jax.random.uniform (XLA threefry2x32; no Pallas kernel)",
                    "launches": d1_launches, **unrolled["d1"],
                    "launches_in_phase26": last["launches"]["threefry_uniform"],
                    "launches_in_phase27": unrolled["launches"]["threefry_uniform"],
                    "launches_in_phase28": backward["launches"]["threefry_uniform"]})
    d2_launches = {"phase 18 (scan-to-map sgd streams, first runs)": sum(s2m_d2.values()),
                   "phase 22 (the suite's rows)": suite_launches("threefry_randint")[1],
                   "phase 25": backend["launches"]["threefry_randint"],
                   "phase 28": backward["launches"]["threefry_randint"]}
    _check(all(d2_launches.values()), f"threefry_randint launched on every SGD path "
           f"({d2_launches})")
    kernels.append({"name": "threefry_randint", "route": "cuda",
                    "source": "dicp_tpu_torch/csrc/threefry.cu",
                    "replaces": "jax.random.randint (XLA threefry2x32; no Pallas kernel)",
                    "launches": sum(d2_launches.values()), **last["d2"],
                    "launches_by_phase": d2_launches,
                    "launches_per_scan_to_map_scan": {
                        label: k / (S_S2M - 1) for label, k in s2m_d2.items() if k},
                    "launches_per_suite_row": suite_launches("threefry_randint")[0]})
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def _chain_ms(fn, reps: int = 20, rounds: int = 7) -> float:
    """Median over ``rounds`` of the device ms per call of ``reps`` calls
    queued back to back between two CUDA events (the host's launch overhead
    hides behind the queue)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _launch_signature(source: Path, name: str) -> str:
    """The ``extern "C"`` declaration of ``name`` in a kernel source,
    whitespace collapsed."""
    found = re.search(rf'extern "C" int {name}\(([^)]*)\)', source.read_text())
    _check(found is not None, f"{source} declares {name}")
    return " ".join(found.group(1).split())


AB_KERNELS = ("tiled_nn", "cluster_search", "cluster_topk", "fused_gn", "score_nn")
AB_TOPK_K = (1, 2, 5, 16, 32)  # K3's k in --ab
# each source's launchers, bound with this checkout's argtypes
LAUNCHERS = {"tiled_nn": ("tiled_nn",), "cluster_search": ("cluster_search",),
             "cluster_topk": ("cluster_topk",), "fused_gn": ("fused_gn",),
             "score_nn": ("score_nn_v1", "score_nn_v2")}


def _argtypes() -> dict:
    v1, v2 = exp_knn._kernels()
    return {"tiled_nn": tiled_knn._kernel().argtypes,
            "cluster_search": cluster_search._search_kernel().argtypes,
            "cluster_topk": cluster_search._topk_kernel().argtypes,
            "fused_gn": fused_gn._kernel().argtypes,
            "score_nn_v1": v1.argtypes, "score_nn_v2": v2.argtypes}


def _build_other(root: Path, names) -> dict:
    """The launchers of ``names`` built from ``root``'s sources with this
    checkout's flags, one nvcc each, started together:
    {launcher without "_launch": function}.  Each launcher must have this
    checkout's C signature (checked in the sources), and is bound with it."""
    import ctypes

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        lib = _build.BUILD_DIR / f"other-lib{name}.so"
        src = root / "dicp_tpu_torch" / "csrc" / f"{name}.cu"
        for fn in LAUNCHERS[name]:
            mine = _launch_signature(ROOT / "dicp_tpu_torch" / "csrc" / f"{name}.cu",
                                     f"{fn}_launch")
            _check(_launch_signature(src, f"{fn}_launch") == mine,
                   f"{src}'s {fn}_launch has this checkout's signature ({mine})")
        jobs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                        str(lib), str(src)], stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), lib)
    fns, argtypes = {}, _argtypes()
    for name, (proc, lib) in jobs.items():
        _, err = proc.communicate()
        _check(proc.returncode == 0, f"nvcc built {name} from {root}: {err[-2000:]}")
        for fn in LAUNCHERS[name]:
            fns[fn] = getattr(ctypes.CDLL(str(lib)), f"{fn}_launch")
            fns[fn].argtypes = argtypes[fn]
            fns[fn].restype = ctypes.c_int
    return fns


PATHS_SNIPPET = """
import numpy as np, torch
import chip_smoke as c
from dicp_tpu_torch import ICPConfig
from dicp_tpu_torch.ops import fused_gn
dev = torch.device("cuda", 0)
src, tgt, T = c.scene_pairs(np.random.default_rng(c.SEED), c.B, c.N_SRC, c.M_TGT)
c.phase4_slice(dev, src, tgt, T)
mp, scan, Tp = c.raw_scan_pair(np.random.default_rng(c.SEED + 8), c.M_MAP)
c.phase8_single_pair(dev, mp, scan, Tp)
rs, rt, Tr = c.scene_pairs(np.random.default_rng(c.SEED + 9), c.B_RAW, c.N_RAW, c.M_RAW)
c.phase9_batched(dev, rs, rt, Tr)
c.phase12_headline(dev)
cfg = ICPConfig(**c.HEAD, driver="while", collect_histories=False, fused_small=True)
args = c._k4_args(cfg, *c.reference_batch(dev))
call = lambda: fused_gn.fused_gn_solve(*args, cfg)
print("K4 wrapper ms", c.cuda_median_ms(call, warmup=3, iters=20), c._chain_ms(call))
"""


GUMBEL_SNIPPET = """
import numpy as np, torch
import chip_smoke as c
from dicp_tpu_torch import jit, knn, register_jit
dev = torch.device("cuda", 0)
src, tgt, ti = c.reference_batch(dev)
solve = lambda: register_jit(src, tgt, ti, None, c.GUMBEL_CFG, key=c.KEY_GUMBEL)
T_sum = float(solve().T.double().sum())
shape = tuple(src.shape[:2]) + (tgt.shape[1],)
noise = knn.ThreefryNoise(knn.key_data(c.KEY_GUMBEL, dev))
ids = list(range(shape[0]))
noise.pair_keys(ids, dev)
it = torch.tensor(7, dtype=torch.int32, device=dev)
draw = jit.jit(lambda it: noise.uniform(ids, it, None, shape, torch.float32, dev), name="draw")
draw(it)
xs, ys, _ = c.scene_pairs(np.random.default_rng(c.SEED), c.B, c.N_SRC, c.M_TGT)
x, y, key = c.to_torch(xs, dev), c.to_torch(ys, dev), knn.key_data(c.KEY_GUMBEL, dev)
gnn = jit.jit(lambda x, y, key: knn.gumbel_nn(x, y, key), name="gumbel_nn")
gnn(x, y, key)
print("Gumbel ms", c.cuda_median_ms(solve, warmup=2, iters=10),
      c.cuda_median_ms(lambda: draw(it), warmup=3, iters=20),
      c.cuda_median_ms(lambda: gnn(x, y, key), warmup=1, iters=3), "sum(T)", T_sum)
"""


def _ab_gumbel(parent: Path) -> dict:
    """Phase 26's Gumbel programs captured, each checkout in a process of its
    own, in turns (parent, this, this, parent): the headline solve
    (register_jit(use_gumbel=True), median of 10), the draw of one
    iteration (median of 20) and the streamed gumbel_nn at phase 4's shape
    (median of 3); both checkouts' solves must give one sum(T)."""
    names = ("Gumbel headline solve", "the draw of one iteration", "streamed gumbel_nn")
    rows = {name: {"parent": [], "this": []} for name in names}
    sums = set()
    for who in ("parent", "this", "this", "parent"):
        run = subprocess.run([sys.executable, "-c", GUMBEL_SNIPPET],
                             cwd=parent if who == "parent" else ROOT, capture_output=True,
                             text=True, timeout=600)
        _check(run.returncode == 0, f"the Gumbel programs of {who}: {run.stderr[-2000:]}")
        got = re.search(r"^Gumbel ms ([\d.]+) ([\d.]+) ([\d.]+) sum\(T\) (\S+)", run.stdout,
                        flags=re.M)
        _check(got is not None, f"the Gumbel programs timed ({who})")
        for name, ms in zip(names, got.groups()[:3]):
            rows[name][who].append(float(ms))
        sums.add(got.group(4))
    _check(len(sums) == 1, f"both checkouts' Gumbel solves give one sum(T) ({sums})")
    for name, times in rows.items():
        print(f"  {name}: parent {times['parent']} ms, this {times['this']} ms (order parent, "
              f"this, this, parent; one process each; captured, CUDA events)")
    return rows


def _ab_paths(parent: Path) -> dict:
    """Phases 4, 8 and 9 end to end (ms per icp call, median of 5), phase 12's
    registrations/s, and K4 through its wrapper at the headline (call by
    call and back to back), each checkout in a process of its own, in turns
    (parent, this, this, parent)."""
    rows = {name: {"parent": [], "this": []}
            for name in ("phase 4 icp call", "phase 8 icp call", "phase 9 icp call",
                         "phase 12 registrations/s", "K4 wrapper, call by call",
                         "K4 wrapper, back to back")}
    for who in ("parent", "this", "this", "parent"):
        run = subprocess.run([sys.executable, "-c", PATHS_SNIPPET],
                             cwd=parent if who == "parent" else ROOT, capture_output=True,
                             text=True, timeout=600)
        _check(run.returncode == 0, f"phases 4, 8, 9, 12 of {who}: {run.stderr[-2000:]}")
        for k, ms in re.findall(r"^phase (\d) ok: .*?([\d.]+) ms per icp call", run.stdout,
                                flags=re.M):
            rows[f"phase {k} icp call"][who].append(float(ms))
        rate = re.search(r"^pt2pl_diff_B256_fwdbwd_registrations_per_s = ([\d.]+)", run.stdout,
                         flags=re.M)
        wrapper = re.search(r"^K4 wrapper ms ([\d.]+) ([\d.]+)", run.stdout, flags=re.M)
        _check(rate is not None and wrapper is not None, f"phase 12 and K4 timed ({who})")
        rows["phase 12 registrations/s"][who].append(float(rate.group(1)))
        rows["K4 wrapper, call by call"][who].append(float(wrapper.group(1)))
        rows["K4 wrapper, back to back"][who].append(float(wrapper.group(2)))
    for name, times in rows.items():
        _check(all(len(t) == 2 for t in times.values()), f"{name} timed twice each")
        print(f"  {name}: parent {times['parent']}, this {times['this']} "
              f"(order parent, this, this, parent; one process each)")
    return rows


def _k4_main_inputs(device) -> dict:
    """K4's two main shapes (phase 11 and --ab): label -> (config, (source,
    target, T_init))."""
    head_cfg = ICPConfig(**HEAD, driver="while", collect_histories=False, fused_small=True)
    g_src, g_tgt, _ = scene_pairs(np.random.default_rng(SEED + 11), B_HEAD, N_GATE, M_GATE)
    gate_cfg = ICPConfig(differentiable=False, driver="while", collect_histories=False,
                         max_iterations=40, tolerance=1e-5, nn_method="dense", icp_type="pt2pl",
                         dim=3, trim_dist=2.0, loss_name="huber", loss_metric=0.5,
                         fused_small=True)
    return {f"headline B={B_HEAD}, 65 -> 65": (head_cfg, reference_batch(device)),
            f"{B_HEAD} x {N_GATE} -> {M_GATE}": (
                gate_cfg, (to_torch(g_src, device), to_torch(g_tgt, device),
                           torch.eye(4, device=device).expand(B_HEAD, 4, 4)))}


def main_ab(parent: Path, only: str | None = None) -> None:
    """K1, K2, K5, K3, K4, K6 and K7 of ``parent`` against this checkout's,
    on one card, in turns (parent, this, this, parent) at the main path's
    shapes (K6/K7 at the A/B's), each launcher called directly on the same
    tensors after holding both to the plain versions: timed call by call (as
    phases 2, 6, 7, 11 and 13 time the wrappers) and back to back.  Then the
    paths end to end (_ab_paths).  ``only="score"`` times K6 and K7 alone
    (neither lies on a path); ``only="gumbel"`` times phase 26's Gumbel
    programs alone (_ab_gumbel)."""
    card = phase0_device()
    if only == "gumbel":
        rows = _ab_gumbel(parent)
        print(f"card: {card}")
        print(json.dumps({"card": card, "parent": str(parent), "runs": rows}))
        return
    device = torch.device("cuda", 0)
    names = ("score_nn",) if only == "score" else AB_KERNELS
    _build.build_all(names)
    other = _build_other(parent, names)
    stream = torch.cuda.current_stream(device).cuda_stream
    rows = {}

    def record(name, calls, check):
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        check()
        order = list(calls) + list(calls)[::-1]
        for how, timer in (("call by call", lambda f: cuda_median_ms(f, warmup=3, iters=20)),
                           ("back to back", _chain_ms)):
            times = {who: [] for who in calls}
            for who in order:
                times[who].append(timer(calls[who]))
            rows[f"{name}, {how}"] = times
            print(f"  {name}, {how}: " + ", ".join(f"{who} {t} ms" for who, t in times.items())
                  + f" (order {', '.join(order)})")

    if only != "score":
        _ab_main_kernels(record, other, device, stream)
    mine = dict(zip(LAUNCHERS["score_nn"], exp_knn._kernels()))
    _ab_score(record, {"parent": other, "this": mine}, device, stream)
    if only != "score":
        rows.update(_ab_paths(parent))
    summary = {"card": card, "parent": str(parent),
               "ms": {name: {who: statistics.median(t) for who, t in times.items()}
                      for name, times in rows.items()}, "runs": rows}
    print(f"card: {card}")
    print(json.dumps(summary))


def _ab_main_kernels(record, other: dict, device, stream) -> None:
    """K1, K2, K5, K3 (at each k of AB_TOPK_K) and K4 of the parent and this
    checkout, at the main paths' shapes."""
    _ab_k1(record, other, device, stream)
    shapes = _cluster_shapes(device)
    for label, args in shapes.items():
        Bq, nbq, Qs = args[3].shape[:3]
        G, g, P = args[0].shape[1], args[0].shape[2], args[4].shape[-1]
        for with_bound, kname in ((1, "K2"), (0, "K5")):
            res = {who: [torch.empty(Bq, nbq, Qs, device=device),
                         torch.empty(Bq, nbq, Qs, dtype=torch.int32, device=device),
                         torch.empty(Bq, nbq, Qs, device=device)] for who in ("parent", "this")}

            def k2(fn, who, with_bound=with_bound, res=res, args=args):
                ptrs = [t.data_ptr() for t in args]
                outs = [t.data_ptr() for t in res[who]]
                return lambda: fn(*ptrs, Bq, G, g, nbq, Qs, P, with_bound, *outs, 0, stream)

            def k2_check(with_bound=with_bound, res=res, args=args, kname=kname):
                if with_bound:
                    ref = cluster_search.fused_search_plain(*args)
                else:
                    ref = cluster_search.block_search_plain(args[0], args[3], args[4])
                for who in ("parent", "this"):
                    _check(all(torch.equal(a, b) for a, b in zip(res[who], ref)),
                           f"{kname} ({who}) equals the plain version ({label})")

            record(f"{kname} {label}", {"parent": k2(other["cluster_search"], "parent"),
                                        "this": k2(cluster_search._search_kernel(), "this")},
                   k2_check)
    _ab_topk(record, {"parent": other["cluster_topk"], "this": cluster_search._topk_kernel()},
             shapes, device, stream)
    _ab_k4(record, other, device, stream)


def _cluster_shapes(device) -> dict:
    """Phase 7's single pair and phase 9's batch as the cluster tier hands
    them to K2, K5 and K3: label -> contiguous (points, centers, radius, xb,
    bsel)."""
    mp, scan, _ = raw_scan_pair(np.random.default_rng(SEED + 8), M_MAP)
    raw_sources, raw_targets, _ = scene_pairs(np.random.default_rng(SEED + 9), B_RAW, N_RAW,
                                              M_RAW)
    shapes = {f"{len(scan)} -> {len(mp)}": (mp[:, :3], scan),
              f"{B_RAW} x {N_RAW} -> {M_RAW}": (raw_targets[..., :3], raw_sources)}
    out = {}
    for label, (y_np, x_np) in shapes.items():
        ix, xb, bsel = _search_inputs(to_torch(y_np, device), to_torch(x_np, device))
        out[label] = [t.contiguous() for t in (ix.points, ix.centers, ix.radius, xb, bsel)]
    return out


def _ab_topk(record, contenders: dict, shapes: dict, device, stream) -> None:
    """K3 launchers ({who: cluster_topk_launch}) at each shape and each k of
    AB_TOPK_K, every one held to the plain version bit for bit."""
    for label, args in shapes.items():
        Bq, nbq, Qs = args[3].shape[:3]
        G, g, P = args[0].shape[1], args[0].shape[2], args[4].shape[-1]
        for k in AB_TOPK_K:
            res3 = {who: [torch.empty(Bq, nbq, Qs, k, device=device),
                          torch.empty(Bq, nbq, Qs, k, dtype=torch.int32, device=device),
                          torch.empty(Bq, nbq, Qs, device=device)]
                    for who in contenders}

            def k3(fn, who, res=res3, args=args, k=k):
                ptrs = [t.data_ptr() for t in args]
                outs = [t.data_ptr() for t in res[who]]
                return lambda: fn(*ptrs, Bq, G, g, nbq, Qs, P, k, *outs, 0, stream)

            def k3_check(res=res3, args=args, k=k):
                ref = cluster_search.fused_topk_plain(*args, k)
                for who in contenders:
                    _check(all(torch.equal(a, b) for a, b in zip(res[who], ref)),
                           f"K3 ({who}) equals the plain version ({label}, k = {k})")

            record(f"K3 {label}, k = {k}", {who: k3(fn, who) for who, fn in contenders.items()},
                   k3_check)


def _ab_k1(record, other: dict, device, stream) -> None:
    """K1 of the parent and this checkout at phase 4's shape."""
    sources, targets, _ = scene_pairs(np.random.default_rng(SEED), B, N_SRC, M_TGT)
    x = to_torch(sources, device, torch.float32).contiguous()
    y = to_torch(targets[..., :3], device, torch.float32).contiguous()
    nb, n, m = x.shape[0], x.shape[1], y.shape[1]
    out = {who: (torch.empty(nb, n, dtype=torch.int32, device=device),
                 torch.empty(nb, n, device=device)) for who in ("parent", "this")}

    def k1(fn, who):
        return lambda: fn(x.data_ptr(), y.data_ptr(), nb, n, m, out[who][0].data_ptr(),
                          out[who][1].data_ptr(), 0, stream)

    def k1_check():
        ref = tiled_knn.nn_distances_plain(x, y)
        for who in ("parent", "this"):
            _check(all(torch.equal(a, b) for a, b in zip(out[who], ref)),
                   f"K1 ({who}) equals the plain version")

    record(f"K1 ({nb}, {n}, {m})", {"parent": k1(other["tiled_nn"], "parent"),
                                    "this": k1(tiled_knn._kernel(), "this")}, k1_check)


def _ab_k4(record, other: dict, device, stream) -> None:
    """K4 of the parent and this checkout at its two main shapes."""
    for label, (cfg, inputs) in _k4_main_inputs(device).items():
        kargs = _k4_args(cfg, *inputs)
        source, target = kargs[0], kargs[1]
        nbk, n, m = source.shape[0], source.shape[1], target.shape[1]
        tcols = 6 if cfg.icp_type == "pt2pl" else 3
        ins = [t.detach().float().contiguous()
               for t in (source, target[..., :tcols], kargs[2], kargs[3], kargs[4])]
        res4 = {who: [torch.empty(nbk, 3, 3, device=device), torch.empty(nbk, 3, device=device)]
                + [torch.empty(nbk, device=device) for _ in range(3)]
                + [torch.empty(nbk, n, device=device), torch.empty(nbk, device=device)]
                for who in ("parent", "this")}

        def k4(fn, who, res=res4, ins=ins, cfg=cfg, shape=(nbk, n, m)):
            ptrs = [t.data_ptr() for t in ins] + [t.data_ptr() for t in res[who]]
            flags = (int(cfg.icp_type == "pt2pl"), cfg.dim, fused_gn._LOSS_CODES[cfg.loss_name],
                     int(cfg.differentiable), int(cfg.trim_dist is not None),
                     int(cfg.tikhonov is not None))
            values = (0.0 if cfg.trim_dist is None else cfg.trim_dist, cfg.loss_metric,
                      cfg.tanh_steepness, cfg.tolerance, cfg.match_ratio_thresh,
                      0.0 if cfg.tikhonov is None else cfg.tikhonov)
            return lambda: fn(*ptrs, *shape, *flags, *values, cfg.max_iterations, 0, stream)

        def k4_check(res=res4, kargs=kargs, cfg=cfg, label=label):
            ref = fused_gn.fused_gn_solve_plain(*kargs, cfg)
            for who in ("parent", "this"):
                C, r, conv, iters, ratio = res[who][:5]
                _check(torch.equal(conv > 0, ref[2]) and torch.equal(iters, ref[3])
                       and torch.equal(ratio, ref[4])
                       and float((C - ref[0]).abs().max()) < 1e-5
                       and float((r - ref[1]).abs().max()) < 1e-5,
                       f"K4 ({who}) matches the plain version ({label})")

        record(f"K4 {label}", {"parent": k4(other["fused_gn"], "parent"),
                               "this": k4(fused_gn._kernel(), "this")}, k4_check)


def _ab_score(record, contenders: dict, device, stream) -> None:
    """K6 and K7 of each contender ({who: {"score_nn_v1": launcher,
    "score_nn_v2": launcher}}) at 100k x 100k for 256 x 2048 and 512 x 4096,
    after holding each to the plain versions, bit for bit."""
    rng = np.random.default_rng(SEED + 13)
    x, y = (to_torch(rng.uniform(-50, 50, (N_SCORE, 3)).astype(np.float32), device)
            for _ in range(2))
    n = N_SCORE
    for tq, tm in SCORE_TILES[:2]:
        m_pad = -(-n // tm) * tm
        y4 = exp_knn._pack_y8(y, m_pad)[:4].contiguous()
        for kname, label, plain_fn in (("score_nn_v1", "K6", exp_knn.nn_v1_plain),
                                       ("score_nn_v2", "K7", exp_knn.nn_v2_plain)):
            res = {who: (torch.full((n,), -1, dtype=torch.int32, device=device),
                         torch.full((n,), float("nan"), device=device),
                         torch.empty((m_pad // tm, n), device=device),
                         torch.empty((m_pad // tm, n), dtype=torch.int32, device=device))
                   for who in contenders}

            def call(who, kname=kname, res=res, m_pad=m_pad, y4=y4, tq=tq, tm=tm):
                fn = contenders[who][kname]
                idx, s, part_s, part_i = (t.data_ptr() for t in res[who])
                args = (part_s, part_i, idx, s) if kname == "score_nn_v1" else (idx, s)
                what = f"{kname} ({who}) launched at {tq} x {tm}"

                def launch():
                    _check(fn(x.data_ptr(), y4.data_ptr(), n, m_pad, tq, tm, *args, 0,
                              stream) == 0, what)
                return launch

            def check(res=res, plain_fn=plain_fn, tq=tq, tm=tm, label=label):
                ref = plain_fn(x, y, tq=tq, tm=tm)
                for who in contenders:
                    _check(torch.equal(res[who][0], ref[0]) and torch.equal(res[who][1], ref[1]),
                           f"{label} ({who}) equals the plain version ({tq} x {tm})")

            record(f"{label} {n} x {n}, {tq} x {tm}", {who: call(who) for who in contenders},
                   check)


# --- --ranks K: parallel/'s programs on K cards ------------------------------

RANKS_DEADLINE_S = 600.0


def main_ranks(ranks: int) -> None:
    """parallel/'s programs on ``ranks`` processes, one card each (NCCL), each
    against its eager form: builds the kernels once, starts the ranks
    (``--rank-worker``), waits for them (killing them past the deadline)
    and exits non-zero unless every rank passed."""
    phase0_device()
    _check(torch.cuda.device_count() >= ranks, f"{ranks} cards ({torch.cuda.device_count()})")
    phase1_build()
    port = _free_port()
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(ranks), RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(ranks))
        procs.append(subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                       "--rank-worker"], cwd=ROOT, env=env))
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < RANKS_DEADLINE_S and any(p.poll() is None for p in procs):
        time.sleep(1)
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    codes = [proc.returncode for proc in procs]
    print(json.dumps({"ranks": ranks, "exit_codes": codes,
                      "seconds": time.perf_counter() - t0}))
    if any(codes):
        raise SystemExit(1)


def _free_port() -> int:
    """A free TCP port on localhost (the ranks' rendezvous)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_worker() -> None:
    """One rank of --ranks: map_sharded_fn's programs (map-sharded at phase
    8's 100,000-point pair through K2, the ring at phase 4's first pair, the
    sharded IFT's forward and gradient), the batch-sharded solve at 2 of
    phase 9's pairs per rank and the partitioned pose graph (65 poses, 25
    iterations), each: eager (jit.disable_jit) against a capture and two
    replays bit for bit, the same on every rank, collectives per call and
    per replay, ms eager and captured (CUDA events, rank 0's); the IFT
    gradient with a captured forward against the eager forward's; against
    the same gradient in a world of one (each rank alone in a group) and
    the unrolled one, at the solve's tolerance and with both solves run
    max_iterations, on the cluster tier (cosine > 0.99 on the rows both
    worlds certify) and the dense tier (cosines > 0.999); the map-sharded
    gradient programs (_rank_gradient_programs).  Then a WHILE node whose
    body holds an all-reduce, and CUDA's answer."""
    from dicp_tpu_torch.odometry import PoseGraph
    from dicp_tpu_torch.parallel.multihost import initialize_distributed
    from dicp_tpu_torch.registration import _register_captured as register_program

    initialize_distributed()
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh_map, mesh_batch = make_mesh((1, world)), make_mesh((world, 1))
    group = mesh_map.get_group("map")

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    def same_on_ranks(t: torch.Tensor) -> bool:
        t = t.to(torch.float64).contiguous()
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t, group=group)
        return all(torch.equal(o, out[0]) for o in out)

    def check(label, call, jitted, trip=None, replicated=True):
        _comm.reset_counts()
        with jit.disable_jit():
            eager = call()
        torch.cuda.synchronize()
        eager_counts = _collectives()
        jitted.cache_clear()
        outs = [call()]
        for _ in range(2):
            _comm.reset_counts()
            outs.append(call())
            torch.cuda.synchronize()
            replay_counts = _collectives()
        want = (eager_counts if trip is None else
                {key: trip + 1 for key in eager_counts if key[0] == "all_reduce"})
        _check({k: v for k, v in replay_counts.items()
                if trip is None or k[0] == "all_reduce"} == want,
               f"{label}: collectives per replay {replay_counts} ({want} expected)")
        for got in outs:
            _check(not _diff_fields(eager, got), f"{label}: captured equals eager bit for bit")
        if replicated:
            _check(all(same_on_ranks(t) for _, t in _leaves(outs[-1])),
                   f"{label}: the same on every rank")
        with jit.disable_jit():
            eager_ms = cuda_median_ms(call, warmup=1, iters=3)
        captured_ms = cuda_median_ms(call, warmup=1, iters=5)
        say(f"  {label}: a capture and two replays equal eager bit for bit"
            f"{', the same on every rank' if replicated else ''}; collectives of an eager call "
            f"{eager_counts}, of a replay {replay_counts}; eager {eager_ms:.3f} ms, captured "
            f"{captured_ms:.3f} ms (rank 0, CUDA events, medians of 3 and 5)")
        return outs[-1]

    say(f"--ranks: {world} ranks, one {torch.cuda.get_device_name(dev)} each, NCCL")
    mp, scan, T_pair = raw_scan_pair(np.random.default_rng(SEED + 8), M_MAP)
    pts = to_torch(mp[:, :3], dev)
    target = torch.cat([pts, estimate_normals(pts, method="weighted")], dim=-1)
    _check(same_on_ranks(target), "the weighted normals are the same on every rank")
    src, ti = to_torch(scan, dev), torch.eye(4, dtype=torch.float32, device=dev)
    res = check(f"register_map_sharded {tuple(src.shape)} -> {tuple(target.shape)} (K2)",
                lambda: register_map_sharded(mesh_map, src, target, ti, cfg=CFG_MAP),
                sharding.map_sharded_fn(mesh_map, CFG_MAP), trip=CFG_MAP.max_iterations)
    rot, trans = pose_errors(torch.as_tensor(T_pair[None], device=dev),
                             res.T[None].to(torch.float64))
    _check(bool(res.converged) and float(rot[0]) < TOL_POSE and float(trans[0]) < TOL_POSE,
           "map-sharded: converged, errors < 1e-3")
    sources, targets, _ = scene_pairs(np.random.default_rng(SEED), 1, N_SRC, M_TGT)
    s4, t4 = to_torch(sources[0], dev), to_torch(targets[0], dev)
    ring = check(f"register_ring_sharded {tuple(s4.shape)} -> {tuple(t4.shape)}",
                 lambda: register_ring_sharded(mesh_map, s4, t4, cfg=CFG_RING),
                 sharding.map_sharded_fn(mesh_map, CFG_RING, target_sharded=True),
                 trip=CFG_RING.max_iterations)
    dense = register_map_sharded(mesh_map, s4, t4, cfg=CFG_RING.with_(nn_method="dense"))
    _check(float((ring.T - dense.T).abs().max()) < 1e-5, "ring within 1e-5 of the dense T")
    cfg_d = CFG_MAP.with_(differentiable=True)
    check("register_map_sharded_ift forward",
          lambda: register_map_sharded_ift(mesh_map, src, target, ti, cfg=cfg_d),
          sharding.map_sharded_fn(mesh_map, cfg_d.with_(driver="while")),
          trip=cfg_d.max_iterations)
    probe = torch.linspace(0.5, 1.5, 16, device=dev).reshape(4, 4)

    def grad_of(fn, cfg=cfg_d, mesh=mesh_map, source=src):
        s = source.clone().requires_grad_(True)
        return torch.autograd.grad(torch.sum(fn(mesh, s, target, ti, cfg=cfg).T * probe), s)[0]

    g_i = grad_of(register_map_sharded_ift)
    with jit.disable_jit():
        g_eager = grad_of(register_map_sharded_ift)
    _check(torch.equal(g_i, g_eager) and same_on_ranks(g_i)
           and bool(torch.isfinite(g_i).all()) and bool((g_i != 0).any()),
           "the IFT gradient with a captured forward equals the eager forward's, finite, "
           "nonzero, the same on every rank")
    # the same gradients in a world of one: each rank alone in a group of
    # its own (every rank makes every group, as new_group requires), at the
    # solve's tolerance and with both solves run all of max_iterations; on
    # the cluster tier (phase 8's pair) and on the dense tier (exact
    # correspondences, no certificate gate; every 10th source point), the
    # programs dropped after each pair of gradients (their pools)
    from torch.distributed.device_mesh import DeviceMesh

    alone = [dist.new_group([r]) for r in range(world)][rank]
    mesh_one = DeviceMesh.from_group(alone, "cuda", mesh_dim_names=("map",))
    cfg_dense = cfg_d.with_(nn_method="dense")
    grads = {}
    for tier, c0, s_in in (("cluster", cfg_d, src), ("dense", cfg_dense, src[::10])):
        for c in (c0, c0.with_(tolerance=0.0)):
            for ranks, m in ((world, mesh_map), (1, mesh_one)):
                grads[tier, c.tolerance, ranks] = [
                    grad_of(fn, c, m, s_in)
                    for fn in (register_map_sharded_ift, register_map_sharded)]
                jit.clear_caches()
                torch.cuda.empty_cache()
    _check(torch.equal(grads["cluster", cfg_d.tolerance, world][0], g_i),
           "the IFT gradient replays")

    def rows(g):
        return g.abs().sum(dim=-1) != 0

    # the gates: on the dense tier the IFT gradient on several ranks is one
    # rank's and the unrolled one's limit (> 0.999); on the cluster tier
    # each rank sorts and blocks its own queries, the certified rows are
    # not one world's (the certificate gate zeroes the others), and the
    # gradients are held where both worlds certify the row (> 0.99)
    for (tier, tol, ranks), (g_ift, g_unrolled) in grads.items():
        cos_unrolled = bench.cosine(g_ift, g_unrolled)
        line = (f"  sharded IFT gradient, {tier} tier, {ranks} rank(s), tolerance {tol:g}: "
                f"cosine with the unrolled gradient {cos_unrolled:.6f}")
        if ranks == world:
            g1_ift, g1_unrolled = grads[tier, tol, 1]
            both = rows(g_ift) & rows(g1_ift)
            cos_one, cos_both = bench.cosine(g_ift, g1_ift), bench.cosine(g_ift[both],
                                                                          g1_ift[both])
            line += (f"; against one rank's: IFT {cos_one:.6f}, unrolled "
                     f"{bench.cosine(g_unrolled, g1_unrolled):.6f}; source rows with a "
                     f"gradient {int(rows(g_ift).sum())} here, {int(rows(g1_ift).sum())} on "
                     f"one rank, {int(both.sum())} on both, IFT cosine on those "
                     f"{cos_both:.6f}")
            if tier == "dense":
                _check(min(cos_one, cos_unrolled) > 0.999,
                       f"dense tier, tolerance {tol:g}: the IFT gradient on {world} ranks "
                       f"against one rank's ({cos_one:.6f}) and the unrolled one "
                       f"({cos_unrolled:.6f}), cosines > 0.999")
            else:
                _check(cos_both > 0.99, f"cluster tier, tolerance {tol:g}: the IFT gradient "
                       f"on {world} ranks against one rank's on the rows both certify, "
                       f"cosine {cos_both:.6f} > 0.99")
        say(line)
    _rank_gradient_programs(mesh_map, mesh_one, src, target, ti, say, same_on_ranks)
    _rank_second_order(mesh_map, src, target, ti, say, same_on_ranks)
    s9, t9, _ = scene_pairs(np.random.default_rng(SEED + 9), 2 * world, N_RAW, M_RAW)
    s9, t9 = to_torch(s9, dev), to_torch(t9, dev)
    ti9 = torch.eye(4, dtype=torch.float32, device=dev).expand(s9.shape[0], 4, 4)
    check(f"register_batch_sharded {tuple(s9.shape)} -> {tuple(t9.shape)} (K2)",
          lambda: register_batch_sharded(mesh_batch, s9, t9, ti9, cfg=CFG_MAP),
          register_program, replicated=False)
    V = 65
    rng = np.random.default_rng(SEED + 26)
    steps = se3.vec2tran(torch.as_tensor(rng.normal(scale=0.05, size=(V - 1, 6))))
    truth = [torch.eye(4, dtype=torch.float64)]
    for k in range(V - 1):
        truth.append(truth[-1] @ steps[k])
    truth = torch.stack(truth)
    noise = rng.normal(scale=0.01, size=(V, 6))
    noise[0] = 0.0
    front = (truth @ se3.vec2tran(torch.as_tensor(noise))).float().to(dev)
    ei = list(range(V - 1)) + list(range(0, 33, 3))
    ej = list(range(1, V)) + [j + 32 for j in range(0, 33, 3)]
    tm = torch.stack([se3.tran_inv(truth[i]) @ truth[j] for i, j in zip(ei, ej)]).float()
    graph = PoseGraph(torch.as_tensor(ei, device=dev), torch.as_tensor(ej, device=dev),
                      tm.to(dev), torch.ones(len(ei), device=dev))
    prog = pg_mod._partitioned_program(group)
    inputs = pg_mod._partition_inputs(front, graph, mesh_map)
    out = check(f"partitioned pose graph ({V} poses, {len(ei)} edges, 25 iterations)",
                lambda: prog(**inputs, iterations=25, damping=1e-6), prog)
    dense_pg, _ = pose_graph_optimize(front, graph, iterations=25)
    _check(float((out - dense_pg).abs().max()) < 1e-4, "within 1e-4 of the dense pose graph")

    # the first design: the loop's all-reduce inside a WHILE node's body
    acc = torch.ones(87, device=dev)

    def reduce_in_while(x):
        y, it = x.clone(), torch.zeros((), dtype=torch.int32, device=dev)
        flag = torch.ones((), dtype=torch.bool, device=dev)

        def body():
            y.copy_(_comm.psum(y, group) * 0.5)
            it.add_(1)
            flag.copy_(it < 3)

        jit.device_while(flag, body)
        return y

    probe_prog = jit.jit(reduce_in_while, name="reduce_in_while")
    try:
        probe_prog(acc)
        answer = "captured"
    except RuntimeError as exc:   # CUDA's refusal is the finding printed here
        answer = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
    torch.cuda.synchronize()
    say(f"  a WHILE node whose body holds an all-reduce, on {world} ranks: {answer}")
    jit.clear_caches()
    dist.barrier(group=group)
    dist.destroy_process_group()
    say("--ranks ok")


def _rank_gradient_programs(mesh, mesh_one, src, target, ti, say, same_on_ranks) -> None:
    """One rank of --ranks: the map-sharded gradients as programs at phase
    8's pair (phase 28's four: register_map_sharded and
    register_map_sharded_ift, by .backward() through a program pair and
    inside one program that calls torch.autograd.grad; and the ring's
    unrolled gradient, register_ring_sharded into the source and the
    sharded target, the same two ways), each against its uncaptured run bit
    for bit on every rank (T, the loss, the gradients), the same on every
    rank, with its K2 launches and collectives per replay (_trip_replayed:
    on the ring K - 1 shifts and as many reverse shifts per ring call); and
    the certified queries of the map-sharded solve's first search on each
    rank, beside each rank alone's."""
    world = dist.get_world_size()
    cfg = CFG_MAP_GRAD
    src_b = _fresh(src, 296)

    def certified(m) -> list:
        search, counts = sharding.cluster_nn, []

        def spy(*args, **kwargs):
            out = search(*args, **kwargs)
            counts.append(out[2].sum().reshape(1).double())
            return out

        sharding.cluster_nn = spy
        try:
            with jit.disable_jit():
                register_map_sharded(m, src, target, ti, cfg=CFG_MAP)
        finally:
            sharding.cluster_nn = search
        every = [torch.empty_like(counts[0]) for _ in range(world)]
        dist.all_gather(every, counts[0])
        return [int(c) for c in every]

    say(f"  certified queries of the map-sharded solve's first search (at T_init), by rank: "
        f"{certified(mesh)} of {src.shape[0] // world} each on {world} ranks; each rank alone "
        f"(a world of one): {certified(mesh_one)} of {src.shape[0]}")

    def backward_form(fn):
        def call(s_in):
            s = s_in.detach().clone().requires_grad_(True)
            res = fn(s)
            value = _loss(res)
            value.backward()
            return res.T.detach(), value.detach(), s.grad
        return call

    def ring_backward(s_in):
        s = s_in.detach().clone().requires_grad_(True)
        t = target.detach().clone().requires_grad_(True)
        res = register_ring_sharded(mesh, s, t, ti, cfg=cfg)
        value = _loss(res)
        value.backward()
        return res.T.detach(), value.detach(), s.grad, t.grad

    def ring_unit(s, t, t0):
        with torch.enable_grad():
            s, t = s.clone().requires_grad_(True), t.clone().requires_grad_(True)
            with jit.disable_jit():   # the inner program stays out of the warm-up
                res = register_ring_sharded(mesh, s, t, t0, cfg=cfg)
            value = _loss(res)
            grads = torch.autograd.grad(value, (s, t))
        return res.T.detach(), value.detach(), *grads

    def in_program(solve):
        def unit(s, t, t0):
            with torch.enable_grad():
                s = s.clone().requires_grad_(True)
                with jit.disable_jit():   # the inner program stays out of the warm-up
                    res = solve(mesh, s, t, t0, cfg=cfg)
                value = _loss(res)
                (grad,) = torch.autograd.grad(value, s)
            return res.T.detach(), value.detach(), grad
        return unit

    ift_jit = jit.jit(lambda s: register_map_sharded_ift(mesh, s, target, ti, cfg=cfg),
                      name="map_sharded_ift")
    cases = [("register_map_sharded, .backward() through its program pair",
              sharding.map_sharded_fn(mesh, cfg),
              backward_form(lambda s: register_map_sharded(mesh, s, target, ti, cfg=cfg)), True,
              False),
             ("register_map_sharded_ift in a jitted call, .backward()", ift_jit,
              backward_form(ift_jit), False, False)]
    for solve, unrolled in ((register_map_sharded, True), (register_map_sharded_ift, False)):
        jitted = jit.jit(in_program(solve), name=f"{solve.__name__}_grad")
        cases.append((f"{solve.__name__}'s gradient in one program", jitted,
                      lambda s, jitted=jitted: jitted(s, target, ti), unrolled, False))
    ring_jit = jit.jit(ring_unit, name="ring_sharded_grad")
    cases += [("register_ring_sharded into the source and the sharded target, .backward() "
               "through its program pair", sharding.map_sharded_fn(mesh, cfg, target_sharded=True),
               ring_backward, True, True),
              ("register_ring_sharded's gradient into the source and the sharded target in one "
               "program", ring_jit, lambda s: ring_jit(s, target, ti), True, True)]
    for label, jitted, call, unrolled, ring in cases:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with jit.disable_jit():
            eager = call(src)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            eager_b, want_b, _ = _counted(lambda: call(src_b), _launches_and_collectives)
        jitted.cache_clear()
        # a pair: eager at its first sighting, captured at its second; a
        # program over autograd.grad: captured at its first call
        outs, first_s = [], []
        for _ in range(2):
            out, _, seconds = _counted(lambda: call(src))
            outs.append(out)
            first_s.append(seconds)
        pool = next(reversed(jitted.cache.values())).pool_bytes

        def strict(call=call):
            with _no_host_wait():
                return call(src_b)

        got, per_replay, _ = _counted(strict, _launches_and_collectives)
        replayed = _trip_replayed(cfg, unrolled, world, ring=ring)
        _check(per_replay == replayed(want_b), f"{label}: a replay launches "
               f"{replayed(want_b)} (eager {want_b}), got {per_replay}")
        for what, a, b in [("the first calls", eager, o) for o in outs] + [("fresh inputs",
                                                                            eager_b, got)]:
            _check(all(torch.equal(x, y) for x, y in zip(a, b)),
                   f"{label}, {what}: equal to the uncaptured run bit for bit")
        _check(all(same_on_ranks(x) for x in got), f"{label}: the same on every rank")
        if ring:
            _check(bool(torch.isfinite(got[3]).all()) and bool((got[3] != 0).any()),
                   f"{label}: the target gradient finite and nonzero")
        with jit.disable_jit():
            eager_ms = cuda_median_ms(lambda: call(src), warmup=1, iters=3)
        captured_ms = cuda_median_ms(lambda: call(src), warmup=1, iters=3)
        say(f"  {label}, {world} ranks: equal to the uncaptured run bit for bit on every "
            f"rank (two calls, a fresh-input replay under the sync debug mode's 'error'), "
            f"the same on every rank; per replay {per_replay} (eager {want_b}); eager "
            f"{eager_ms:.3f} ms, captured {captured_ms:.3f} ms (rank 0, CUDA events, medians "
            f"of 3); first and second call {first_s[0] * 1e3:.1f} and {first_s[1] * 1e3:.1f} "
            f"ms (host clock); pool {pool / 2**20:.1f} MiB against the eager peak of "
            f"{peak / 2**20:.1f} MiB")
        jitted.cache_clear()


def _rank_second_order(mesh, src, target, ti, say, same_on_ranks) -> None:
    """One rank of --ranks: second derivatives through the map-sharded and
    the ring solve at phase 8's pair (K2): Hessian-vector products (the
    gradient of sum(gradient * v), the first gradient taken with
    create_graph) of register_map_sharded into the source and of
    register_ring_sharded into the source and the sharded target, each
    inside one program (jit over the two torch.autograd.grad calls), and
    register_map_sharded's by a double backward through its program pair;
    each bit-equal on every rank to its uncaptured run on the fixed trip
    (:func:`_forced_trip`; the host loop's second backward groups its sums
    otherwise, and the gap is printed) and the same on every rank, with
    its collectives per replay (the ring's second backward: K - 1 reverse
    shifts and K - 1 gathers per ring call) and eager (the host loop)
    against captured ms; every call with the deterministic kernels
    (:func:`_deterministic`)."""
    with _deterministic():
        _rank_second_order_checked(mesh, src, target, ti, say, same_on_ranks)


def _rank_second_order_checked(mesh, src, target, ti, say, same_on_ranks) -> None:
    world = dist.get_world_size()
    cfg = CFG_MAP_GRAD
    v_s, v_t = _direction(src, HVP_SEED + 4), _direction(target, HVP_SEED + 5)

    def hvp_of(call, into_target: bool):
        def unit(s_in, t_in):
            with torch.enable_grad():
                s = s_in.detach().clone().requires_grad_(True)
                t = t_in.detach().clone().requires_grad_(into_target)
                xs, vs = ((s, t), (v_s, v_t)) if into_target else ((s,), (v_s,))
                res = call(s, t)
                value = _loss(res)
                gs = torch.autograd.grad(value, xs, create_graph=True)
                hs = torch.autograd.grad(sum(torch.sum(g * v) for g, v in zip(gs, vs)), xs)
            return (res.T.detach(), value.detach(), *(g.detach() for g in gs), *hs)
        return unit

    def inner(solve):
        def call(s, t):
            with jit.disable_jit():   # the inner program stays out of the warm-up
                return solve(mesh, s, t, ti, cfg=cfg)
        return call

    def held(label, got, want):
        _check(not _diff_fields(want, got), f"{label}: equal to the uncaptured fixed trip "
               f"bit for bit (differing: {_diff_fields(want, got)})")
        _check(all(same_on_ranks(t) for _, t in _leaves(got)),
               f"{label}: the same on every rank")
        hvps = got[2 + (len(got) - 2) // 2:]   # (T, loss, the gradients, the HVPs)
        _check(all(bool(torch.isfinite(h).all()) and bool((h != 0).any()) for h in hvps),
               f"{label}: the HVP finite and nonzero")

    def reference(unit):
        with jit.disable_jit():
            unit(src, target)     # warm-up: the first HVPs move the threads' counters
            host = unit(src, target)
            _comm.reset_counts()
            with _forced_trip():
                want = unit(src, target)
            torch.cuda.synchronize()
            counts = _collectives()
        gap = max(_max_abs_diff(a.double(), b.double()) / float(b.abs().max())
                  for a, b in zip(host[-2:], want[-2:]))
        return host, want, counts, gap

    for label, unit in (
            ("register_map_sharded's HVP into the source in one program",
             hvp_of(inner(register_map_sharded), False)),
            ("register_ring_sharded's HVP into the source and the sharded target in one "
             "program", hvp_of(inner(register_ring_sharded), True))):
        host, want, eager_counts, gap = reference(unit)
        jitted = jit.jit(unit, name="rank_hvp")
        jitted(src, target)                       # the miss: warm-up and capture
        for _ in range(2):
            _comm.reset_counts()
            with _no_host_wait():
                got = jitted(src, target)
            torch.cuda.synchronize()
            counts = _collectives()
            held(label, got, want)
        with jit.disable_jit():
            eager_ms = cuda_median_ms(lambda: unit(src, target), warmup=0, iters=1)
        captured_ms = cuda_median_ms(lambda: jitted(src, target), warmup=0, iters=3)
        pool = next(reversed(jitted.cache.values())).pool_bytes
        jitted.cache_clear()
        del got
        gc.collect()
        say(f"  {label}, {world} ranks: two replays equal the uncaptured fixed trip bit for "
            f"bit on every rank (no host wait), the same on every rank; the host loop's HVP "
            f"against the trip's {gap:.3e} relative; collectives of the trip's eager run "
            f"{eager_counts}, of a replay {counts}; eager (host loop) {eager_ms:.3f} ms, "
            f"captured {captured_ms:.3f} ms (rank 0, CUDA events); pool {pool / 2**20:.1f} MiB; "
            f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated once it is released")

    # a double backward through map_sharded_fn's program pair
    label = "register_map_sharded's HVP into the source through its program pair"
    pair_fn = sharding.map_sharded_fn(mesh, cfg)
    unit = hvp_of(lambda s, t: register_map_sharded(mesh, s, t, ti, cfg=cfg), False)
    # the eager runs and the first call on autograd's thread, where the
    # pair's VJP builds its graph (_on_autograd_thread)
    def eager(trip: bool):
        def run():   # disable_jit holds for its own thread only
            with jit.disable_jit(), _forced_trip() if trip else contextlib.nullcontext():
                return unit(src, target)
        return _on_autograd_thread(run, src.device)

    host, want = eager(False), eager(True)
    pair_fn.cache_clear()
    held(f"{label}, call 1", _on_autograd_thread(lambda: unit(src, target), src.device), host)
    for k, ref in enumerate((host, want), 2):
        held(f"{label}, call {k}", unit(src, target), ref)
    _comm.reset_counts()
    with _no_host_wait():
        got = unit(src, target)
    torch.cuda.synchronize()
    counts = _collectives()
    held(f"{label}, a replay", got, want)
    _check(len(pair_fn.cache) == 1 and len(pair_fn.vjp.cache) == 1,
           f"{label}: one program pair and one VJP pair")
    say(f"  {label}, {world} ranks: the first call (eager) and the second (the pair captured, "
        f"its VJP eager) equal the host loop, the third (the VJP captured) and a replay the "
        f"uncaptured fixed trip, bit for bit on every rank, the same on every rank, no host "
        f"wait; collectives per replayed HVP {counts}")
    jit.clear_caches()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        main_ab(Path(sys.argv[2]).resolve())
    elif sys.argv[1:2] == ["--ab"] and sys.argv[3:4] == ["--only"] and \
            sys.argv[4:] in (["score"], ["gumbel"]):
        main_ab(Path(sys.argv[2]).resolve(), only=sys.argv[4])
    elif sys.argv[1:2] == ["--ranks"] and len(sys.argv) == 3:
        main_ranks(int(sys.argv[2]))
    elif sys.argv[1:] == ["--rank-worker"]:
        _rank_worker()
    elif len(sys.argv) > 1:
        raise SystemExit("usage: python3 chip_smoke.py [--ab DIR [--only score|gumbel] | "
                         "--ranks K]")
    else:
        main()
