"""On-card smoke run of the PyTorch/CUDA port (pdmpflux_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels build for sm_90a) and ``nvcc``.
Phases, one line each; any failure raises and exits non-zero:

1. build the kernels (K1 fused Zig-Zag chunk, K6 its sticky variant, K4 the
   Speed-Up Zig-Zag chunk, K3/K5 the scalar-rate chunk, K2 event-row
   compaction) from
   ``pdmpflux_tpu_torch/csrc`` with nvcc, one compile per source, all started
   together; ptxas's registers, stack frame and spills of every kernel, and
   no stack frame in any instantiation of K1.  Meanwhile a thread lowers
   every gradient of phases 36-47 and then builds their user libraries
   beside phases 2-35, one nvcc per core but the first core's, at the
   lowest priority (``UserBuilds``); phase 36 waits for the last;
2. K1 against its plain PyTorch version on the card, float64, from the same
   state: integer outputs equal, floats to rtol 1e-9 (atol 1e-12 for values
   near zero such as the Kahan compensation), at d=10/B=8192 (gauss),
   d=10/B=1024 (banana), d=1000/B=256, a ragged B=1001 and grid_size 2, 33
   and 64 (B=512), each with the lanes per chain K1 takes there;
3. K2 against its plain version: random fills with offsets and an init
   record at d=10 and d=1000 (f32 and f64, with and without an activity
   stream), a ragged B=1001, W=1 and W below off + kept, outputs
   bit-identical;
4. the main path: ``sample_skeleton`` of ZigZag(10, grad_gauss), 8192
   chains x 2048 points, float32, warm then timed; every chain complete,
   both kernels launched, pooled moments in bench.py's bands; then (4b) the
   fill and the compaction timed apart, and each kernel checked against its
   plain version at exactly these shapes and float32 (K2 bit-identical, K1
   as ``compare_f32`` states, at least 99% of chains with equal decisions)
   and timed beside it;
5. a large-d run: ZigZag(1000), 256 chains x 512 points, float32, started
   in stationarity; complete, coordinate-pooled moments in band;
6. K6 (the sticky chunk kernel) against its plain version, float64, two
   K=32 chunks from one state near the axes with some chains capped, at
   gauss d=10/B=1024, banana d=10/B=1024, gauss d=1000/B=128 (a coordinate
   per thread), d=1500/B=32 (two tiles), d=1, banana d=33, grid_size 2, 33
   and 64 (B=512) and the largest d K6 takes in float64 (B=4): integers and
   activity equal, floats to rtol 1e-9 (atol 1e-12); one coordinate more is
   refused;
7. the sticky path at full width: the ``sticky_zigzag_d1000`` deployment,
   StickyZigZagAD(1000, gauss, kappa=10), 128 chains x 2048 points, float32,
   x0 = 0.3, v0 = 1, warm then timed; every chain complete, K6 and K2
   launched, every stick row freezes one coordinate at exactly 0.0, every
   thaw row releases one, |v| = 1, t non-decreasing, sticks and thaws occur;
   four more warm calls give the spread and the median wall time;
   then (7b) its fill and compaction timed apart, K2 checked bit for bit
   against its plain version on this path's own fill (activity stream and
   init row included) with its bound, and one K=32 chunk of K6 checked against its plain
   version at exactly this shape in float32 (as ``compare_f32`` states:
   every chain that leaves the plain trajectory must do so at an f32
   rounding tie), each timed beside its plain version; and (7c) the median
   warm call split into K6 launches x ms, K2 and the rest (host work, during
   which the card idles);
8. a law check: StickyZigZag(10, grad_gauss, kappa=1), 4096 chains x 2048
   points, float32; the coordinate-pooled frozen fraction of equal-time
   samples within 0.02 of p(0)/(1+p(0)) = 0.2852, the variance within 0.03
   of 0.7148;
9. K3 (BPS, Boomerang) and K5 (Forward ECMC), the scalar-rate chunk kernel,
   against its plain version in float64, two K=32 chunks from one random
   state with some chains capped: BPS gauss d=10 (signed), BPS aniso d=10
   (unsigned, gaussian_velocity), Boomerang banana d=10, ECMC gauss d=10 in
   three jump variants (all B=1024), BPS gauss d=100 (B=256), and BPS aniso,
   Boomerang banana and ECMC gauss at grid_size 2, 33 and 64 (B=512, the
   envelope's edges across the warp's lanes); integers equal, floats bit
   for bit;
10. the ``bps_anisotropic_gauss_d10`` deployment: BPSAD(10,
   anisotropic_gauss(linspace(0.5, 3, 10)), refresh_rate=0.5), 512 chains x
   8192 points, float32, x0 = 0, v0 = 1; one warm call, then five timed warm
   calls (median and spread), the first counted and checked: complete, K3 and
   K2 launched, t non-decreasing and finite, pooled moments |mean_i| < 0.1
   s_i and |var_i / s_i^2 - 1| < 0.1; then (10b) its fill and compaction
   timed apart, K2 checked bit for bit on this fill, one K=32 chunk of K3
   checked against its plain version at this shape in float32 (as
   ``compare_f32`` states) and each timed beside its plain version; and
   (10c) the median call split into K3, K2 and the rest;
11. ``boomerang_gauss_d10``: Boomerang(10, grad_gauss, refresh_rate=0.5), 512
   chains x 1024 points; complete, fills counted, moments of N(0, I); one
   K=32 chunk of K3 checked against its plain version at this shape in
   float32 (as ``compare_f32`` states);
12. ``ecmc_gauss_d10``: ForwardECMCAD(10, gauss), 512 chains x 2048 points,
   x0 ~ N(0, I) (see ``phase_ecmc``), v0 = 1/sqrt(10); complete, K5
   launched, |v| = 1 on every row within 1e-5, moments of N(0, I); one K=32
   chunk of K5 checked against its plain version at this shape in float32
   (as ``compare_f32`` states) and timed beside it;
13. K7, the horizon mode of the chunk kernels, against the plain version in
   float64, two K=32 chunks from one random state with some chains capped
   and the float32 clock target at the median clock an event-count run
   reaches (about half of the lanes freeze inside): K1 gauss d=10 B=4096 and
   B=1001, K6 gauss d=10 B=1024, d=1000 B=128 and d=1500 B=32, K3 BPS aniso
   and Boomerang banana, K5
   ECMC gauss (d=10, B=1024); K1 and K6 to rtol 1e-9 (atol 1e-12) as in
   phases 2 and 6, K3/K5 bit for bit;
14. the ``zigzag_gauss_d10_horizon`` deployment: ZigZagAD(10, gauss), 4096
   chains, T = 500, init_capacity 4096, float32, x0 = 0, v0 = 1; one warm
   call, then five timed warm calls (median and spread), the first counted
   and checked: K1 in horizon mode and K2 launched, every chain's last row
   at t == 500.0 exactly with kind EV_TERMINAL, no kept row past T, t
   non-decreasing, pooled moments in bench.py's bands, mean events per chain
   beside the expected 10 / sqrt(2 pi) * 500; then (14b) the fill, K2 and
   the finalize timed apart, K2 checked bit for bit on this fill, one K=32
   horizon chunk of K1 checked against its plain version at this shape in
   float32 (as ``compare_f32`` states) and K1 timed beside its plain
   version; and (14c) the median call split into K1, K2, finalize and the
   rest;
15. time-horizon checks, not timed cells: ``sticky_zigzag_d1000`` (T = 0.5),
   ``bps_anisotropic_gauss_d10`` (T = 290) and ``ecmc_gauss_d10`` (T = 645),
   about 256 events per chain each, with the contracts of phase 14 (and
   frozen coordinates at exactly 0.0 in the sticky terminal rows); each
   path's horizon-mode kernel timed per K=32 launch at its shape beside its
   plain version;
16. K4 (the Speed-Up Zig-Zag chunk kernel) against its plain version in
   float64, two K=32 chunks from one random state with some chains capped, at
   gauss and banana d=10/B=1024, in events and in horizon mode (target at the
   median clock), at grid_size 2, 33 and 64 (B=512), and at d=3700 (B=8,
   K=4), where K4 reads x and v in place: integers equal, floats bit for
   bit;
17. the ``suzz_gauss_d10`` deployment: SpeedUpZigZagAD(10, gauss), 512 chains
   x 2048 points, float32, x0 = 0, v0 = 1; one warm call, then five timed
   warm calls (median and spread), the first counted and checked: complete,
   K4 and K2 launched, t non-decreasing and finite, pooled moments in
   bench.py's bands; then (17b) its fill and compaction timed apart, K2
   checked bit for bit on this fill, one K=32 chunk of K4 checked against its
   plain version at this shape in float32 (as ``compare_f32`` states, at least
   99% of chains with identical decisions) and each timed beside its plain
   version, and the median call split into K4, K2 and the rest;
18. a time-horizon run of the same deployment, T the median clock of phase
   17's skeleton at 256 events, with the time-horizon contracts of phase 14;
   K4's horizon mode timed per K=32 launch beside its plain version;
19. the ``sticky_zigzag_d1000_streaming`` deployment
   (``benchmarks/exp_streaming_d1000.py`` defaults): StickyZigZagAD(1000,
   gauss, kappa=10), 128 chains, x0 = 0.3, v0 = 1, float32; a calibration
   ``sample_streaming_stats`` run (T = 2048 / 500, 1024 grid points, 16
   windows, seed 1) gives the event rate, then the gated run to T = 524288 /
   rate (65536 grid points, 128 windows, seed 2, no early stop), its
   launches counted from zero, K6's launches and the folds timed by CUDA
   events inside the run; gates: every chain at T, split-R-hat under 1.02,
   max |pooled mean| < 0.05, the mean pooled variance within 0.01 of
   1 - w = 0.9616, the final frozen share within 0.005 of w =
   p(0) / (kappa + p(0)) = 0.0384; events/s, ESS/s of the worst coordinate,
   fills and the split (K6 launches x the time one launch takes alone,
   folds, rest); then one K=32 horizon chunk of K6 checked against its plain
   version at this shape in float32 (as ``compare_f32`` states);
20. the ``zigzag_banana_d50_streaming`` deployment
   (``benchmarks/exp_streaming_banana50.py``): ZigZag(50, grad_banana,
   grid_size=0), 256 chains, x0 = v0 = 1, float32; calibration at T = 50,
   ``grid_chunk`` from the script's formula, one warm run (seed 2), then the
   timed run (seed 3, 32768 grid points, 64 windows, stop_when_converged,
   check_every=1) counted and split as phase 19; gates: converged, max
   |pooled mean| < 0.1, the pooled variance within 10% of (1, 3, 1, ...); one
   K=32 horizon chunk of K1 checked against its plain version in float32;
21. checkpoint/resume on the card, each run interrupted by
   ``PDMPFLUX_FAIL_AFTER_FILLS`` (only that error is caught) and resumed
   from its file, bit for bit against the unbroken run: (a) the sticky d =
   1000 event-count deployment (128 chains, 2048 points) at 512-row fills,
   at least four of them, interrupted after 2; (b)
   ``zigzag_gauss_d10_horizon`` at T = 64 (about 256 events per chain),
   init_capacity 256, interrupted after 2; (c) a streaming run of phase 19's
   sampler at about 4096 events per chain (16384 grid points, 64 windows,
   checkpoint_every=8, at least four groups of 8 fills), interrupted after
   16 fills: accumulators, events and fills; then (d)
   ``sample_skeleton_with_diagnostic`` at ``zigzag_gauss_d10_horizon`` (U =
   gauss, 1000 batches): each chain's RV within rtol 1e-4 of
   ``RV_diagnostic`` on a host copy of the same skeleton;
22. the transition engine (``core/engine.py``, plain torch) on the card
   against the engine on the CPU, float64, from one state and keys, 32
   transitions (cut from 256, then 128, then 64) of 256 chains at d = 10 on the Gaussian, one
   case per family:
   the Zig-Zag with scalar and vectorized bounds, ``grid_size=0`` and
   finite-difference tangents, the Sticky Zig-Zag with scalar and vectorized
   bounds, the Speed-Up Zig-Zag, BPS, the Boomerang, Forward ECMC in its
   three jump variants and RHMC: step by step (every CPU input state through
   the card's transition at once) equal kinds and floats within rtol 1e-9
   (atol 1e-12), decisions apart only at rounding ties; free-running, at
   least 99% of the chains take every decision alike with every float of
   every event row within rtol 1e-9 (1e-6 for finite differences and ECMC's
   normal variant, see ``phase_engine_agreement``), a parting chain parts at
   a rounding tie; the card's time per transition and the torch ops one
   transition dispatches; the ops whose card output differs from the CPU's
   on bit-equal inputs, in the first transition whose floats part;
23. the ``rhmc_gauss_d10`` deployment (``benchmarks/run_baselines.py:124-127``
   at scale 1): RHMCAD(10, gauss, refresh_rate=1.0), 512 chains x 256
   points (cut from 1024 for phases 45's and 46's time), float32, x0 = 0,
   v0 = 1; one
   warm call at 64 points, then one timed call,
   the first counted and checked: complete, K2 launched, engine transitions
   counted, no chunk kernel, pooled moments in bench.py's bands,
   split-R-hat (``diagnostics.split_rhat``) < 1.02; the median call's events/s
   and its split (engine chunks by CUDA events, K2 launches x K2's time on
   this path's first fill, the rest); K2 checked bit for bit on that fill
   and timed beside its plain version; a time-horizon call at T = 200,
   every chain at t == T exactly with EV_TERMINAL;
24. ``zigzag_banana_d10_fd`` and ``zigzag_banana_d10_jvp``
   (``benchmarks/run_baselines.py:146-158`` at scale 1): ZigZagAD(10,
   banana) with finite-difference or jvp tangents, ``backend="xla_stream"``,
   512 chains x 1024 points (cut from the deployment's 4096, then 2048, for
   the script's time), float32, x0 = v0 = 1; one timed call each:
   complete, K2 launched, engine transitions counted, no chunk kernel,
   |mean_i| < 0.1 and |var_i / truth_i - 1| < 0.1 with truth (1, 3, 1, ...);
   events/s, the split, K2 checked on the first fill as in phase 23;
25. routing under ``backend="auto"``: a tagged Zig-Zag
   launches K1 and runs no engine transition; RHMC and a
   ``vectorized_bound=False`` Zig-Zag run the engine and no chunk kernel;
   ``"pallas"`` on RHMC raises; an untagged Zig-Zag (``lambda x: x``) is
   lowered and takes K1 alone; a running product (``cumprod``) raises
   ``LoweringError`` under ``"auto"`` before any launch, naming
   ``aten.cumprod`` and ``backend="xla_stream"``, and runs under it; then an engine
   ``sample_streaming_stats`` of RHMC at B = 512 (T = 300, 4096 grid points,
   32 windows) with pooled moments in bench.py's bands;
26. host accumulation at ``sticky_zigzag_d1000`` (128 chains x 2048 points, a
   2.38 GB skeleton): (a) forced by ``PDMPFLUX_STREAM_HOST_ACC=1`` at the
   default fill rows, (b) forced by ``PDMPFLUX_DEVICE_BYTES`` = 1 GiB, JAX's
   sizing then 64-row fills (about 33); each a CPU skeleton equal bit for
   bit to the device path's at the same fill rows, with the sticky
   contracts; K2 checked on the path's first fill; wall, events/s and the
   split (K6 launches x phase 7b's time, K2, the copies to the host and
   their bytes, the placement, the rest);
27. host accumulation at ``zigzag_gauss_d10_horizon`` (the flag): ``n_valid``
   and every row up to it equal to the device path's, width
   ``n_valid.max()``, every chain at t == T with EV_TERMINAL; K2 checked on
   the first fill; wall and split;
28. ``sample_skeleton_sharded`` of the flagship on ``make_mesh()`` (one
   card): bit for bit ``sample_skeleton``, its stats those of the skeleton;
   then in a one-process NCCL group from ``parallel.initialize``: the same
   run, ``host_all_gather_stats`` and ``pooled_moments(mesh=)`` through NCCL,
   the group destroyed; wall and split;
29. ``zigzag_banana_d50_streaming`` with ``mesh=make_mesh()``: accumulators,
   events and fills equal to phase 20's timed run without a mesh;
30. one warm flagship ``sample_skeleton`` inside ``profiling.annotate``,
   traced by ``profiling.trace``: the exported trace holds the span, K1's
   kernel events equal its launch count's increase and K2's four kernels
   are there, each once per K2 launch; the card's busy share of the span
   (kernels, copies and sets, which run one after another on the one
   stream) and the summed time of each kernel name; ``profiling.timed`` of
   the same call;
31. ``plotting._anim_points`` on a chain of that skeleton on the card equal to
   the host copy's, also through the sampler's flow; ``plot_traj``'s line
   data equal to the skeleton's points where matplotlib is installed (the
   line says which);
32. ``sample_skeleton_gspmd`` of ``BPS(10_000, grad_gauss, refresh_rate=0.5)``
   and ``ZigZag(10_000, grad_gauss)``, 32 chains x 32 events (256 before
   phases 33-35 came, 128 before phase 44, 64 before phase 45, cut for the
   script's time), float64,
   x0 = 0, v0 = 1, seed 0 (the transition engine and K2, as JAX's GSPMD
   path runs no Pallas kernel): without a group, then on a one-process NCCL
   group's mesh whose coordinate group is made a one-part ``ShardedDims``
   (a dim axis of 1 runs every coordinate locally; this drives the
   collectives through NCCL on the card; bit for bit the run without a
   group), then
   with a dim axis of 2 over two processes on the one card, which gloo
   joins (NCCL takes one rank per device): each process's block equal to
   the dim-1 run at rtol 1e-9 (integers equal); every call's time.  The
   two processes run this file with ``--gspmd-worker PORT RANK OUTDIR``,
   beside phase 33 (which times nothing), and are checked after it (32b);
33. every chunk kernel against its plain version in f64 on each device tag
   added for the JAX package's test potentials (``cauchy``, ``ridged``,
   ``funnel``, ``neal_funnel``) and on ``aniso`` where K1, K6 and K4 took
   it: K1 at d = 1000 (one chunk, cut from two for phase 44's time) and in
   place at d = 8000, K6 (one chunk; the funnels at d = 1000, whose chain
   moments take its two-level reduction), K4 at
   d = 10 and in place at d = 3700, K3 (BPS, the Boomerang) and K5 at
   d = 10, and a horizon case per kernel on a funnel; K1 and K6 to ``RTOL``,
   K4 and K3/K5 bit for bit (a part in a math function of ``ridged`` or
   ``neal_funnel`` printed and held to ``RTOL``);
34. ``suzz_cauchy_d10``: SpeedUpZigZagAD(10, cauchy), 512 chains x 2048
   points, float32, x0 = 0, v0 = 1 (``suzz_gauss_d10``'s shape on
   ``tests/test_integration.py:91``'s heavy-tailed target); one warm call,
   five timed; 1000 samples per chain pooled over chains and coordinates:
   |median| < 0.1, quartiles within 0.15 of -1 and 1, each coordinate's
   within 0.25, max |x| > 5; (34b) the fill and K2 timed apart, one f32
   K=32 chunk of K4 against its plain version, the split;
35. ``zigzag_neal_funnel_d10``: ZigZagAD(10, neal_funnel), 8192 chains x
   2048 points, float32, x0 = 0, v0 = 1 (the flagship's shape on Neal's
   funnel); five timed calls on the kernels, then one call of each route at
   512 points (cut from 2048 for phase 44's time, from 1024 for 45's), the
   kernels and the
   transition engine (``backend="xla_stream"``): x[0]'s pooled means within
   0.15 and variances within 10% of each other and the engine's time over
   the kernels', the truth (0, 9) printed; (35b) as 34b for K1;
36. the slice's main path on gradients of the user's own (``ops/cuda/
   lower.py`` lowers them into a generated potential, id 7, built into a
   library of its own): bench.py's ``ZigZag(10, lambda x: x)`` and the
   README's ``ZigZagAD(10, lambda x: torch.sum(x**2) / 2)``, 8192 chains x
   2048 points, float32, x0 = 0, v0 = 1, ``backend="auto"``, five timed
   calls each, the first counted: K1 and K2 launched, no engine chunk,
   every skeleton field bit for bit phase 4's tagged ``grad_gauss`` run
   from the same seed, bench.py's moment bands; one f32 K=32 chunk of K1 on
   each against its plain version (``compare_f32``), timed; the user
   libraries' build seconds, registers and spills;
37. a gradient no tag covers on every chunk kernel, the Student-t with
   nu = 5 (``3 sum log1p(x^2 / 5)``): K1 at the flagship shape, K6 at
   ``sticky_zigzag_d1000`` (kappa = 10, x0 = 0.3), K3 (BPS, refresh 0.5) at
   ``bps_anisotropic_gauss_d10``'s shape and K4 at ``suzz_gauss_d10``'s,
   and a user-written anisotropic Gaussian with closed-over scales
   linspace(0.5, 3, 10) (hoisted into the parameters) on K3; each kernel
   against its plain version fed the IR's torch pair in f64 (two K=32
   chunks from a random state: K3 and K4 bit for bit, K1 and K6 to
   ``RTOL``), one warm and one counted call per deployment (its kernel and
   K2, no engine chunk), the law: |mean| < 0.1 and the coordinate-pooled
   variance within 10% of 5/3 (K6: of (1 - w) 5/3, w the atom at 0, from a
   streaming run of 131072 events per chain), the anisotropic one as phase
   10's gate; one f32 K=32 chunk each against its plain version, timed;
38. a user-written Neal funnel (``x[0]``, ``torch.sum(x[1:]**2)``,
   ``torch.exp(-x[0])``, one sum over the coordinates) on K1 at
   ``zigzag_neal_funnel_d10``'s shape, against phase 35's tagged run, and on
   K4 at ``suzz_gauss_d10``'s shape, against the tagged Speed-Up Zig-Zag:
   x[0]'s means within 0.15 and variances within 10%; each kernel against
   its plain version in f64 and one f32 chunk, as phase 37; K6 at
   ``sticky_zigzag_d1000``'s shape on a hierarchical mean
   (``sum((x[1:] - x[0])**2)``, a sum that reads coordinate 0 in every warp)
   against its plain version in f64 to ``RTOL``; then a dense ``A @ x`` (a
   seeded 10 x 10 SPD matrix) takes K1 and K2 (512 chains x 256 points),
   and a running product (``cumprod``) raises ``LoweringError`` under ``"auto"``
   before any build or launch, naming the aten op and
   ``backend="xla_stream"``, and runs on the engine there;
39. products with a constant matrix at every point: ``zigzag_corr_gauss_d10``
   (``ZigZagAD(10, 0.5 x P x)``, ``P`` the inverse of 0.9^|i-j|, the
   flagship's shape) and ``bps_corr_gauss_d10`` (BPSAD, refresh 0.5, at
   ``bps_anisotropic_gauss_d10``'s shape): each kernel against its plain
   version in f64 (one launch of ``DENSE_PARITY_K`` = 16 transitions at
   the deployment's shape from a random state; K3 bit for bit, K1 to
   ``RTOL``),
   the route (its kernel and K2, no
   engine chunk, no ``LoweringError``) and five timed warm calls, the gate
   on the second half of each chain (|mean| < 0.1, variances within 10% of
   1, lag-one correlations within 0.05 of 0.9), one f32 launch timed (the
   plain version timed on the f64 parity launch);
40. ``zigzag_logistic_d20_n1000``: a Bayesian logistic regression (d = 20,
   n = 1000 rows, an intercept and N(0, 1) covariates, seeded labels, a
   N(0, 10^2 I) prior) on K1, K3 (BPS, refresh 1.0) and K4 at B = 1024,
   2048 points from the MAP (Newton in numpy f64), as phase 39 but with
   one timed warm call (``LOGISTIC_CALLS``, cut from five), gated on
   the second half of each chain: means within 0.2 Laplace sd of the
   posterior mean (importance sampling from the Laplace law), variances
   within 20% of the Laplace variances, K1's and K3's means within 0.2 sd;
41. the kernel against its plain version on the other kinds, each with its
   route, one timed call and an f32 launch timed: the Boomerang and Forward ECMC
   (K5) and the Sticky Zig-Zag (K6, kappa 1) on the logistic regression,
   K6 at ``sticky_zigzag_d1000``'s shape on a dense 1000 x 1000 AR(1)
   precision (rho 0.5), the quartic sum ``|x|^2 / 2 + log1p(sum x^4)`` on K1
   (the flagship's shape) and K6 (d = 1000);
42. gradients that read other coordinates, through the kernels' accessor:
   the AR(1) prior in its innovation form (``x[0]^2 / 2 + sum((x[1:] - rho
   x[:-1])^2) / (2 (1 - rho^2))``, a band) at ``sticky_dense_ar1_d1000``'s
   shape (rho 0.5) on K6 and on K1 (where the dense form now takes the
   kernel too, phase 43):
   its pair against the dense ``P x`` at 64 points (rtol 1e-12), each kernel
   against its plain version in f64 in events and horizon mode, the route
   under ``"auto"`` (0 engine chunks), one timed call and an f32 launch with
   its bound beside phase 41's dense K6 launch; at rho 0.9 and d = 10 on K1
   and K3 at phase 39's shapes with phase 39's gate; phase 38's Neal funnel
   with its scale at ``x[-1]`` on K1 at ``zigzag_neal_funnel_d10``'s shape,
   x[-1]'s mean and variance against phase 38's x[0], and on K3, K5 and K4
   bit for bit against their plain versions;
43. products with a constant matrix formed once per transition: the dense
   AR(1) Gaussian ``0.5 x P x`` (rho 0.5, ``P`` 1000 x 1000) at
   ``sticky_dense_ar1_d1000``'s shape (128 chains x 2048 points, x0 = 0.3)
   on K1 (``zigzag_dense_ar1_d1000``) and K3 (``bps_dense_ar1_d1000``, BPS
   refresh 0.5): each kernel against its plain version in f64 (K1 to
   ``RTOL``, K3 bit for bit), the route under ``"auto"`` (its kernel and
   K2, no engine chunk) with one timed warm call and an f32 launch with its
   bound; an f64 K1 launch of the dense form against the banded form of
   phase 42 from the same state and keys (integers equal, floats within
   1e-9); one engine chunk (64 transitions) of the dense K1 sampler timed
   by CUDA events, for the record;
44. log-sum-exp, softmax and small matrix views of the chain: every kernel
   (K1, K6, K4, K3 BPS and Boomerang, K5) against its plain version in f64
   (64 chains, one launch of 4 transitions, K4's of 32; K3/K5 and K4 bit for
   bit, K1 and K6 to ``RTOL``) on the JAX package's bimodal target at d = 10
   (K1 also at d = 1), the 4-component Gaussian mixture at d = 100 written
   with ``x[None, :] - MU`` and with ``MU @ x``, and the 5-class softmax
   regression (d = 100, ``X`` 1000 x 20) as ``log_softmax(X @ x.reshape(20,
   5), 1)`` and as ``X @ x.reshape(5, 20).T`` with ``logsumexp``, K1 and K3
   also in horizon mode on the regression; where a lane cannot hold the
   regression's f64 context (``lower.LANE_BYTES``), ``"auto"`` takes the
   engine, the line says why, and the kernel runs on ``X``'s first 10
   columns (d = 50) instead, every other f64 route the kernel; then
   ``zigzag_bimodal_d1`` (ZigZagAD(1, U) of ``tests/test_integration.py``,
   1024 chains x 6000 points, x0 = 0, v0 = 1: the JAX test's bands and the
   share of x > 0 within 0.05 of 0.5), ``zigzag_mixture4_d100`` and
   ``bps_mixture4_d100`` (refresh 1, 1024 chains x 2048 points, chain b from
   mu_{b mod 4}, v0 = 1: |mean| < 0.2, variances within 10% of 5 on x0, x1 and
   of 1 elsewhere), ``zigzag_softmax_d100_n1000`` and
   ``bps_softmax_d100_n1000`` (1024 chains x 2048 points from the MAP: means
   within 0.2 Laplace sd of the importance-sampled posterior mean, the class
   contrasts' variances within 20% of the Laplace law's, K1's and K3's means
   within 0.2 Laplace sd of each other), each one call under ``"auto"`` (its
   kernel and K2, no engine chunk) with an f32 launch and its bound, the
   regression's also with one engine chunk (64 transitions) timed, the
   route ``"auto"`` did not take; one f32 launch each of K6, K4 and K5 on
   the mixture, and of K1 on ``|x|^2 / 2 + logsumexp(x)`` at d = 1000 (a max
   over the coordinates: K1 in point mode) beside the tagged Gaussian at
   that shape;
45. running sums, flips and periodic shifts (``cumsum``, ``flip``,
   ``roll``): every kernel (K1, K6, K4, K3 BPS and Boomerang, K5) against
   its plain version in f64 (64 chains, one launch of 4 transitions, K4's
   of 32; K3/K5 and K4 bit for bit, K1 and K6 within 1e-12), each taking
   its kernel under ``"auto"``, on the local level model of Durbin &
   Koopman in non-centred form (``sqrt(q) cumsum(z)``, q = 1469.1 / 15099,
   ``y`` drawn from the model; a prefix and a suffix running sum) and
   Poisson counts on a random-walk log-intensity (a suffix running sum of
   an ``exp``), both at d = 100, and the phi^4 action of Albergo et al. on
   an 8 x 8 periodic lattice (``torch.roll`` along both axes), and the
   local level at d = 1000 on K1, K6, K3 (BPS) and K5 (the timed cells'
   shape, where K1's lanes and K3's warp split the scans into longer
   runs), K1 and K3 also in horizon mode on
   the local level; then
   ``zigzag_local_level_d1000`` and ``bps_local_level_d1000`` (128 chains x
   2048 points from exact posterior draws: every coordinate's pooled mean
   within 5 / sqrt(B) sd and variance within 5 sqrt(2 / (B - 1)) of the
   exact Gaussian posterior's) and ``zigzag_phi4_l8`` and ``bps_phi4_l8``
   (1024 chains x 2048 points from x0 = 0: <phi^2> and <phi^4> on each
   chain's second half within 5 combined batch-mean errors of each other
   and of one engine call, ``backend="xla_stream"``, 256 chains x 512
   points, timed), each one call under ``"auto"`` (its kernel and K2, no
   engine chunk) with an f32 launch and its bound; one f32 launch each of
   K6 and K5 on the local level at d = 1000 and of K4 at d = 100 from
   exact posterior draws;
46. reads at a constant index array (``x[idx]``, ``index_select``,
   ``gather``, ``take``) and their scatter-add backward: every kernel
   against its plain version in f64 as in 45 on the varying-intercept radon
   model of Gelman & Hill (d = 89: 85 counties, 919 houses drawn from the
   seed at the survey's shape; with the scales fixed, d = 87, on K1 and
   K3) and on the ICAR prior of Morris et al. on a 32 x 32 triangulated
   grid relabelled by a seeded permutation (d = 1024, 2945 edges; K3/K5 on
   a 24 x 24 grid, under their f64 shared-memory limit; K4 with its first
   horizon at 0.02), K1 and K3 also in horizon mode on the ICAR, each
   taking its kernel under ``"auto"``; then ``zigzag_radon_d87`` and
   ``bps_radon_d87`` (the scales fixed, 1024 chains x 2048 points) and
   ``zigzag_icar_d1024`` and ``bps_icar_d1024`` (128 chains x 2048 points),
   from exact posterior draws, gated as 45's local level, each one call
   under ``"auto"`` (its kernel and K2, no engine chunk) with an f32 launch
   and its bound (``bps_icar_d1024``'s f32 library also against its plain
   version, B = 64, K = 4); one f32 launch each of K6, K5 and K4 on the
   ICAR, and K4's at its default first horizon (2.0), whose envelope
   rejects nearly every transition there;
47. hierarchical regressions (coefficient blocks of x against data rows;
   gathers, shifts and scatter-adds of a stage's output) on Gelman &
   Hill's radon model with house- and county-level covariate matrices,
   non-centred (d = 94: 85 counties, 919 houses, X 919 x 4, Z 85 x 2 drawn
   from the seed; with the scales fixed, d = 92): K1, K6, K4, K3 and K5
   against their plain versions in f64 on both (64 chains, one launch of 2
   transitions, K4's of 24; K3/K5 and K4 bit for bit, K1 and K6 within
   rtol 1e-9), each taking its kernel under ``"auto"``; K6 with its first
   warp delayed before the last product's rows, with the barriers after
   products read at other rows (matches) and without them (must fail);
   then ``zigzag_radon_x_d92`` and ``bps_radon_x_d92`` (the scales fixed,
   1024 chains x 2048 points from exact posterior draws, gated as 45's
   local level), each the median of three warm calls under ``"auto"`` (its
   kernel and K2, no engine chunk), its launches a call, an f32 launch, its
   bound and the call's split; one f32 launch of the free-scale model on
   each kernel.  The script prints its clock after each group of phases,
   and phases 22 and 33 their own seconds.

Then one JSON line of per-kernel results (launches counted in the timed run
of each kernel's path: phase 4 for K1 and K2, phase 7 for K6, phase 10 for
K3, phase 12 for K5, phase 14 for K1 in horizon mode, phase 15 for K6, K3
and K5 in horizon mode, phase 17 for K4, phase 18 for K4 in horizon mode,
phases 19 and 20 for the entries of K6 and K1 in horizon mode named
after the streaming deployments, and phases 23 and 24 for the entries of K2
named after the engine deployments, phase 28 for K1's entry named after the
sharded flagship, phases 26b and 27 for K2's entries named after the host
paths, phase 30 for the entries of K1 and K2 named after the profiled
flagship, phase 32 (dim 1) for K2's entry named after the gspmd
deployment, phases 34 and 35 for the entries of K4, K1 and K2 named after
their deployments, 35 (the engine route) for K2's entry named
``engine:zigzag_neal_funnel_d10_n512`` (its 512-point run), phases
36-47 for the entries ``<kernel>[user:<path>]`` of each generated potential's path (and K2's on
phase 36's two paths, timed at their shapes in phase 4b); max_abs_err the largest of the kernel's comparisons
with its plain version, f64 and f32; the bound of each timed launch computed
from its shape and this run's data; phases 39-47's entries carry
``plain_of``: their plain time is a parity launch's on the same kernel,
model and d (f64, or for ``bps_icar_d1024`` f32), their ``ms`` an f32
launch's), the card's name and power limit, and the status line.
"""

import difflib
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from contextlib import nullcontext
from concurrent.futures import ThreadPoolExecutor
from functools import cache
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import pdmpflux_tpu_torch as pt
from pdmpflux_tpu_torch import api, plotting, streaming
from pdmpflux_tpu_torch.core import engine, rng
from pdmpflux_tpu_torch.core.dims import ShardedDims
from pdmpflux_tpu_torch.core.types import EV_INIT, Skeleton, event_from_state
from pdmpflux_tpu_torch.ops.cuda import build
from pdmpflux_tpu_torch.ops.cuda import compact as k2
from pdmpflux_tpu_torch.ops.cuda import driver
from pdmpflux_tpu_torch.ops.cuda import lower
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as k3
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as k1
from pdmpflux_tpu_torch.parallel import distributed
from pdmpflux_tpu_torch.utils import profiling

DEV = torch.device("cuda")
RTOL, ATOL = 1e-9, 1e-12
MAIN = (10, 8192, 2048)    # d, chains, skeleton points: the bench flagship
LARGE = (1000, 256, 512)   # the large-d run
STICKY = (1000, 128, 2048, 10.0)  # d, chains, points, kappa: sticky_zigzag_d1000
STICKY_CALLS = 5  # timed warm calls of the sticky path
STICKY_LAW = (10, 4096, 2048, 1.0)
BPS_D10 = (10, 512, 8192, 0.5)    # d, chains, points, refresh: bps_anisotropic_gauss_d10
BPS_CALLS = 5  # timed warm calls of the BPS path
BOOMERANG_D10 = (10, 512, 1024, 0.5)  # boomerang_gauss_d10
ECMC_D10 = (10, 512, 2048)            # ecmc_gauss_d10
HORIZON_D10 = (10, 4096, 500.0, 4096)  # d, chains, T, init_capacity: zigzag_gauss_d10_horizon
HORIZON_CALLS = 5  # timed warm calls of the horizon path
HORIZON_CHECK_T = {"sticky": 0.5, "bps": 290.0, "ecmc": 645.0}  # ~256 events per chain
SUZZ_D10 = (10, 512, 2048)  # d, chains, skeleton points: suzz_gauss_d10
SUZZ_CALLS = 5  # timed warm calls of the Speed-Up Zig-Zag path
SUZZ_HORIZON_EVENTS = 256  # events per chain phase 18 aims its T at
# sticky_zigzag_d1000_streaming (benchmarks/exp_streaming_d1000.py defaults):
# chains, d, kappa, calibration events, events per chain, grid points, windows
STREAM_STICKY = (128, 1000, 10.0, 2048, 524288, 65536, 128)
# zigzag_banana_d50_streaming (benchmarks/exp_streaming_banana50.py): chains,
# d, calibration T, events-per-chain budget, grid points, windows
STREAM_BANANA = (256, 50, 50.0, 65536, 32768, 64)
CK_STICKY_T_CAP = 512     # phase 21a: fill rows, so the 2047 events take >= 4 fills
CK_HORIZON = (4096, 64.0, 256)  # 21b: chains, T (~256 events per chain), init_capacity
CK_STREAM = (4096, 16384, 64, 8, 16)  # 21c: events per chain, grid, windows, every, fail
RV_BATCHES = 1000         # 21d: RV batches
HOST_BUDGET = 1 << 30     # 26b: PDMPFLUX_DEVICE_BYTES, below the sticky skeleton's 2.38 GB
TRACE_SPAN = "flagship_sample_skeleton"  # phase 30's annotate span
# K2's kernels by name in a trace: the four of csrc/compact.cu
K2_KERNELS = ("count_kernel", "scan_kernel", "copy_kernel", "tail_kernel")
GSPMD = (10_000, 32, 32)   # phase 32: d, chains, events (cut from 256 for 33-35's time,
                           # from 128 for 44's, from 64 for 45's)
GSPMD_RTOL = 1e-9          # phase 32: dim 2 against dim 1
SUZZ_CAUCHY_D10 = (10, 512, 2048)  # phase 34: d, chains, points: suzz_cauchy_d10
NEAL_D10 = (10, 8192, 2048)        # phase 35: d, chains, points: zigzag_neal_funnel_d10
NEAL_ROUTES = 512                  # phase 35: points of the two routes' comparison (the
                                   # engine route cut from 2048 for phase 44's time, from
                                   # 1024 for 45's)
TAG_CALLS = 5                      # timed warm calls of each of the two
CAUCHY_SAMPLES = 1000              # phase 34: equal-time samples per chain for the gate

H100_BYTES_S = 3.35e12  # HBM3 rate of the H100 SXM (NVIDIA data sheet)
H100_F32_OPS_S = 67e12  # float32 rate outside the tensor cores (the same sheet)
THREEFRY_OPS = 115      # one Threefry-2x32 block: 20 rounds of add, rotate, xor + 5 key adds
MATH_OPS = 40           # a log, sqrt, cos or sin, as instruction sequences


def sync():
    torch.cuda.synchronize(DEV)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (after one warm call)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops):
    """(bound_ms, bound_by, bytes side ms, operations side ms): the least
    time of a kernel's work on the card, the larger of its bytes over the
    memory rate and its operations over the float32 rate (integer work,
    Threefry's included, counted at that rate)."""
    t_bytes, t_ops = nbytes / H100_BYTES_S * 1e3, ops / H100_F32_OPS_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_bytes, t_ops


def bound_text(b):
    return f"{b[0]:.6f} ms ({b[1]}; bytes {b[2]:.6f} ms, operations {b[3]:.6f} ms)"


def chunk_bytes(st, fill):
    """A chunk launch reads the state once and writes it and its rows once."""
    state = sum(a.numel() * a.element_size() for a in st if a is not None)
    return 2 * state + sum(a.numel() * a.element_size() for a in fill if a is not None)


def chunk_ops(cfg, d, live, jumps):
    """Operations of ``live`` chain-transitions with ``jumps`` jumps among
    them, counted from the kernel sources.  Per transition: the envelope
    (Zig-Zag: per grid point and coordinate the gradient and its tangent, the
    rate pair and the segment maximum with one divide, ~20; scalar rate: per
    grid point and coordinate ~8 for the gradient, the two products and the
    two ordered adds, plus ~15 per grid point for the segment; the elliptic
    flow adds ~6 per coordinate and a cos and a sin per grid point), the
    prefix sums and inversion (~3 per grid point), the thinning rate (~6 per
    coordinate), the flow (2 per coordinate) and two Threefry blocks (the
    acceptance uniform, the Exp clock).  Per jump: Zig-Zag one Threefry block
    and two passes over the flip rates (~12 per coordinate); K3 per
    coordinate one Box-Muller normal (two uniforms, each one Threefry block,
    and a log, a sqrt and a cos) and ~12 for the gradient, three products and
    the reflection; K5 per coordinate three normals (``bm(0)``-``bm(2)``) and
    ~60 for its frame with ``switch``, else two normals and ~30."""
    n_grid = cfg.n_grid
    normal = 2 * THREEFRY_OPS + 3 * MATH_OPS
    per = 3 * n_grid + 8 * d + 2 * THREEFRY_OPS
    # the potential's own work beyond the Gaussian's, per grid point: per
    # coordinate (a divide, counted as 10, for the Cauchy; a cos and a sin for
    # the ridges; the funnels' chain sums) and once (the funnels' coordinate
    # 0: divides, or an exp)
    coord, point = {"cauchy": (10, 0), "ridged": (2 * MATH_OPS, 0),
                    "funnel": (4, 40), "neal_funnel": (4, MATH_OPS)}.get(
                        cfg.device_potential, (0, 0))
    trans = 0
    if cfg.user is not None:
        coord, point, trans = user_cost(cfg.user)
    per += n_grid * (coord * d + point) + trans
    if cfg.kind == "zigzag":
        per += n_grid * d * 20
        jump = THREEFRY_OPS + 12 * d
    elif cfg.kind == "suzz":
        # per grid point the flow's exp and sqrt(1 + |x_t|^2) and ~15 scalar
        # operations, per grid point and coordinate ~40 (x_t and its two
        # sums 8, the gradient 2, the effective rate 4 and its tangent 9 with
        # three divides, the segment 15); the flow's terms (~6 per
        # coordinate and a sqrt), and the thinning and final flows (~16 per
        # coordinate, two exps and two sqrts)
        per += n_grid * (40 * d + 2 * MATH_OPS + 15) + 22 * d + 5 * MATH_OPS + 30
        jump = THREEFRY_OPS + 16 * d
    else:
        per += n_grid * (8 * d + 15)
        if cfg.kind == "boomerang":
            per += n_grid * (6 * d + 2 * MATH_OPS)
        if cfg.kind == "ecmc":
            switch = cfg.ecmc_params[2]
            jump = d * (3 * normal + 60) if switch else d * (2 * normal + 30)
        else:
            jump = d * (normal + 12)
    return live * per + jumps * jump


MATH_FNS = {"exp", "expm1", "log", "log1p", "sqrt", "sin", "cos", "tanh", "sinh", "cosh",
            "pow"}
"""The IR ops that call a CUDA math function (``ops/cuda/lower.py``)."""


def user_cost(low):
    """(per coordinate, per point, per transition) operations of a generated
    potential beyond the Gaussian's (2, ``x + v t``), counted from its IR:
    each op of the gradient and its tangent once (a divide 10, a math
    function ``MATH_OPS``), averaged over the coordinates; where the kernel
    forms its stages at every point (``low.point``: K3/K5 and K4 always, K1
    and K6 past the chain moments), each stage formed there: each summand's
    and each product input's value and tangent per element, and each
    product's ``2 rows cols`` operations, doubled for the tangent (a
    running sum's two adds per element); and per transition each product
    formed once per transition (``low.trans``): per row and column its
    input's value and tangent and the two products and adds (a running
    sum's per element)."""
    def ops(*roots):
        seen, n = set(), 0
        for r in roots:
            for x in (lower._nodes(r, rows=False) if r is not None else ()):
                if x.id in seen or not x.args:
                    continue
                seen.add(x.id)
                if x.op == "seg":  # a segment walk: its mean rows' terms, an add and a read
                    n += x.attr[3] / x.attr[2] * (ops(*x.args) + 2)
                    continue
                n += (10 if x.op == "div" else MATH_OPS if x.op in MATH_FNS else 1)
        return n

    d = low.d
    coord = sum((p.b - p.a) * ops(p.e, dp) for p, dp in zip(low.out, low.d_out)) / d - 2
    point = trans = 0
    for m in low.trans:
        pr = low.products[m]
        trans += (1 if pr.scan else pr.rows) * sum((ops(p.e, dp) + 4) * (p.b - p.a)
                                                   for p, dp in zip(pr.vec.pieces, low.d_mv[m]))
    if low.point:
        for kind, s in low.stages:
            if kind == "mv" and s in low.toff:
                continue
            pieces, tangents = ((low.reductions[s], low.d_red[s]) if kind == "red" else
                                (low.products[s].vec.pieces, low.d_mv[s]))
            point += sum((ops(p.e, dp) + 2) * (p.b - p.a) for p, dp in zip(pieces, tangents))
            if kind == "mv":
                pr = low.products[s]
                point += 2 * pr.rows if pr.scan else 4 * pr.rows * pr.cols
    return max(coord, 0.0), point, trans


def chunk_bound(cfg, st, fill, live):
    """The bound of a chunk launch: its state and rows, and the potential's
    parameters (a generated potential's hoisted matrices) read once."""
    jumps = int((fill.kind[:, 0] == pt.EV_JUMP).sum())
    prm = 0 if cfg.pot_params is None else cfg.pot_params.numel() * cfg.pot_params.element_size()
    return bound(chunk_bytes(st, fill) + prm, chunk_ops(cfg, st.x.shape[0], live, jumps))


def k2_bound(fill, counts, W):
    """K2 reads every row's event kind, then the kept rows of the fill, and
    writes them behind the init row (column 0, so the kept rows start at
    column 1), the init row and the zeroed tail (columns 1 + kept to W - 1
    of each chain) into the skeleton; the bytes are counted on this fill's
    kept rows."""
    T, B = fill.rows, fill.kind.shape[-1]
    kept = torch.clamp_max(counts.long(), W - 1)
    tail = int((W - 1 - kept).sum())
    kept = int(kept.sum())
    d, it = fill.x.shape[1], fill.x.element_size()
    act = d if fill.act is not None else 0
    row_in = 3 * 4 + (2 * d + 3 + 5) * it + act        # kind rows 1-3, x, v, fs, ring
    row_out = 4 * 4 + (2 * d + 3 + 5) * it + d          # + is_active bytes
    return bound(T * B * 4 + kept * row_in + (kept + B + tail) * row_out, 0)


def random_state(sampler, B, dtype, seed, scale=1.0):
    """Positions N(0, scale^2 I) (the funnel's ``x[0]`` moved to 0.5 + |x[0]|,
    where it is defined) and +-1 velocities."""
    rs = np.random.default_rng(seed)
    x0 = rs.normal(size=(B, sampler.dim)) * scale
    if sampler.device_potential == "funnel":
        x0[:, 0] = 0.5 + np.abs(x0[:, 0])
    v0 = rs.choice([-1.0, 1.0], size=(B, sampler.dim))
    return sampler.init_state_batch(x0, v0, seed, dtype, DEV)


TAG_POTENTIALS = {"cauchy": "cauchy", "ridged": "ridged_gauss", "funnel": "funnel",
                  "neal_funnel": "neal_funnel"}
"""The device tags of the JAX package's test potentials besides gauss, banana and
aniso, and the potentials carrying them."""


def tag_potential(tag, d):
    """The test potential ``U`` of a device tag (``aniso``: the scales
    linspace(0.5, 3, d))."""
    if tag == "aniso":
        return pt.potentials.anisotropic_gauss(np.linspace(0.5, 3.0, d))
    return getattr(pt.potentials, TAG_POTENTIALS[tag])


def clone_state(st):
    return k1.ChunkState(*(None if a is None else a.clone() for a in st))


def ptxas_kernels(log):
    """{kernel: (registers, stack frame bytes, spill store bytes, spill load
    bytes)} from ``nvcc -Xptxas -v``'s log, names demangled where
    ``c++filt`` is found and cut to the kernel and its template arguments."""
    props, regs, entry, fn = {}, {}, None, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "Function properties for" in ln:
            fn = ln.split("Function properties for")[1].strip()
        elif "bytes stack frame" in ln and fn:
            props[fn] = tuple(int(w) for w in re.findall(r"(\d+) bytes", ln))
        elif (m := re.search(r"Used (\d+) registers", ln)) and entry:
            regs[entry] = int(m.group(1))
            entry = None
    names = list(regs)
    shown = names
    if shutil.which("c++filt") and names:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True).stdout.splitlines()
        if len(out) == len(names):
            shown = [s.split(">(")[0].replace("void (anonymous namespace)::", "")
                     .replace("pdmp::", "") + (">" if ">(" in s else "") for s in out]
    return {s: (regs[n], *props.get(n, (0, 0, 0))) for s, n in zip(shown, names)}


def phase_build():
    t0 = time.perf_counter()
    build.library()
    secs = time.perf_counter() - t0
    kernels = ptxas_kernels(build.BUILD_INFO.get("log", ""))
    text = "; ".join(f"{k}: {r} registers, {f} B stack frame, {st}/{ld} B spill "
                     f"stores/loads" for k, (r, f, st, ld) in kernels.items())
    print(f"phase 1 build: {secs:.2f} s ({build.BUILD_INFO['path']}); ptxas: {text}",
          flush=True)
    # K1 indexes no array at run time, so nothing of its own lands in local
    # memory; CUDA's sin and cos keep a small local array for the reduction
    # of large arguments, so Ridged's instantiations may carry that frame,
    # but no spills
    framed = [k for k, (_, frame, st, ld) in kernels.items()
              if "zigzag_chunk_kernel" in k and (st or ld or (frame and "Ridged" not in k))]
    if framed:
        raise AssertionError(f"K1 keeps a stack frame (local memory) in {framed}")


K1_NAMES = k1.ChunkState._fields + tuple("ev_" + f for f in k1.RawFill._fields)


def chunk_outputs(st, fill):
    """(name, tensor) of a chunk's state and rows; a non-sticky chunk has no
    activity tensors."""
    return [(n, a) for n, a in zip(K1_NAMES, (*st, *fill)) if a is not None]


def float_err(what, name, a, b, rtol, atol):
    """Max abs difference of two float tensors with the same non-finite
    pattern; raises past ``rtol``/``atol``."""
    fin = torch.isfinite(b)
    if not torch.equal(fin, torch.isfinite(a)) or not torch.equal(a[~fin], b[~fin]):
        raise AssertionError(f"{what}: non-finite pattern of {name} differs")
    if not torch.allclose(a[fin], b[fin], rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: {name} off by "
                             f"{float((a[fin] - b[fin]).abs().max())}")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def median_target(run, st, cfg, K, n_chunks, seed0):
    """The float32 clock target at the median clock that ``n_chunks``
    event-count chunks of the kernel (checked in that mode by phases 2, 6 and
    9) reach from ``st``: a horizon run from the same state freezes about
    half of the lanes inside."""
    probe = clone_state(st)
    d, B = st.x.shape
    fill = k1.empty_fill(K * n_chunks, d, B, st.x.dtype, DEV, st.act is not None)
    for it in range(n_chunks):
        run(seed0 + it * 1000003, probe, fill, it * K, cfg)
    return k1.f32_target(float(probe.fs[k1.F_T].median()))


def target_share(st, cfg):
    """Share of the lanes whose clock reached the horizon target (None in
    events mode); a horizon check wants it well inside (0, 1)."""
    if not cfg.horizon:
        return None
    share = float((st.fs[k1.F_T] >= cfg.t_target).double().mean())
    if not 0.2 < share < 0.9:
        raise AssertionError(f"the horizon target {cfg.t_target} froze {share:.3f} of the "
                             "lanes; the check wants it inside the run")
    return share


def k1_runs(d, B, K, n_chunks, pot, horizon=False, suzz=False, dtype=torch.float64, **kw):
    """K1, or K4 for the Speed-Up Zig-Zag (``suzz``), and its plain version,
    ``n_chunks`` chunks each from one random state with every fifth chain
    capped inside the run, in horizon mode (K7) when asked; ``kw`` goes to
    the sampler.  Returns the kernel's state and fill, then the plain
    version's, and the config."""
    if pot in ("gauss", "banana"):
        grad = {"gauss": pt.potentials.grad_gauss, "banana": pt.potentials.grad_banana}[pot]
        sampler = (pt.SpeedUpZigZag if suzz else pt.ZigZag)(d, grad, **kw)
    else:
        sampler = (pt.SpeedUpZigZagAD if suzz else pt.ZigZagAD)(d, tag_potential(pot, d), **kw)
    state = random_state(sampler, B, dtype, d + B)
    counts = torch.zeros(B, dtype=torch.int32, device=DEV)
    counts[::5] = 40  # some chains freeze inside the run
    cfg = card_config(sampler, K, 48, dtype)
    st_k = driver.chunk_state(state, counts)
    if horizon:
        cfg = cfg._replace(t_target=median_target(k1.run_chunk, st_k, cfg, K, n_chunks,
                                                  -1234567))
    st_p = clone_state(st_k)
    fill_k = k1.empty_fill(K * n_chunks, d, B, dtype, DEV)
    fill_p = k1.empty_fill(K * n_chunks, d, B, dtype, DEV)
    for it in range(n_chunks):
        seed = -1234567 + it * 1000003
        k1.run_chunk(seed, st_k, fill_k, it * K, cfg)
        k1.run_chunk_plain(seed, st_p, fill_p, it * K, cfg)
    sync()
    return st_k, fill_k, st_p, fill_p, cfg


def k1_compare(d, B, K, n_chunks, pot, horizon=False, suzz=False, **kw):
    """:func:`k1_runs` in f64 with integers equal, floats held to rtol
    ``RTOL`` (atol ``ATOL``) for K1, built with FMA contraction, and bit for
    bit for K4 (:func:`bit_tolerance` for a tag whose gradient calls a math
    function); returns (max abs err, events, share frozen by the target)."""
    what = f"{'K4' if suzz else 'K1'} {pot} d={d} {kw or ''}"
    st_k, fill_k, st_p, fill_p, cfg = k1_runs(d, B, K, n_chunks, pot, horizon, suzz, **kw)
    rtol, atol = bit_tolerance(what, pot, st_k, fill_k, st_p, fill_p) if suzz else (RTOL, ATOL)
    err = 0.0
    for (name, a), (_, b) in zip(chunk_outputs(st_k, fill_k), chunk_outputs(st_p, fill_p)):
        if a.dtype == torch.int32:
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: integer output {name} differs "
                                     f"at {int((a != b).sum())} places")
        else:
            err = max(err, float_err(what, name, a, b, rtol, atol))
    n_ev = int((fill_k.kind[:, 0] > 0).sum())
    if n_ev < B:
        raise AssertionError(f"{what}: only {n_ev} events in the check")
    return err, n_ev, target_share(st_k, cfg)


# K1's edges: the grid's (one segment; segments past a group's lanes), a
# ragged B (1001 chains leave part of the last warp empty whatever L is),
# d = 1000, where a lane's run of coordinates is long, and d = 8000, where
# two chains' f64 x and v exceed a block's shared memory and K1 reads them
# in place (the default horizon rejects every proposal there, hence tmax)
K1_CASES = [(10, 8192, 3, "gauss", {}), (10, 1024, 2, "banana", {}),
            (1000, 256, 2, "gauss", {}), (10, 1001, 2, "gauss", {}),
            (8000, 3, 1, "gauss", dict(tmax=0.01))]
K1_CASES += [(10, 512, 2, pot, dict(grid_size=grid))
             for pot, grid in (("gauss", 2), ("banana", 33), ("gauss", 64))]


def lanes(B):
    """The lanes per chain K1 takes at B chains."""
    return build.library().zigzag_chunk_lanes(B)


def phase_k1():
    parts, err = [], 0.0
    for d, B, n_chunks, pot, kw in K1_CASES:
        e, n, _ = k1_compare(d, B, 32, n_chunks, pot, **kw)
        err = max(err, e)
        parts.append(f"{pot} d={d} B={B} (L={lanes(B)}) {kw or ''} max_abs_err={e:.3e} "
                     f"({n} events)")
    print(f"phase 2 K1 vs plain (f64): {'; '.join(parts)}; ints equal, rtol {RTOL} "
          f"atol {ATOL}", flush=True)
    return err


def f32_agreement(what, st_k, fill_k, st_p, fill_p, v_rtol=0.0):
    """Shared part of the f32 checks of a chunk kernel against its plain
    version: event kinds must agree on at least 99% of (transition, chain)
    pairs, and the chains that take identical decisions (integer outputs and
    activity equal, and velocities, which record the jumps, equal within
    ``v_rtol``: 0 for the +-1 Zig-Zag velocities) must agree in their floats
    to rtol 1e-3, atol 1e-4 (f32 rounding order over 32 transitions).
    Returns (kind agreement, mask of those chains, max abs err on them)."""
    agree = float((fill_k.kind[:, 0] == fill_p.kind[:, 0]).float().mean())
    if agree < 0.99:
        raise AssertionError(f"{what}: event kinds agree on only {agree:.4f}")
    outs_k, outs_p = chunk_outputs(st_k, fill_k), chunk_outputs(st_p, fill_p)
    same = torch.ones(st_k.x.shape[1], dtype=torch.bool, device=st_k.x.device)
    for (name, a), (_, b) in zip(outs_k, outs_p):
        if not a.is_floating_point():
            same &= (a == b).reshape(-1, a.shape[-1]).all(dim=0)
        elif name in ("v", "ev_v"):
            near = (a - b).abs() <= v_rtol * b.abs()
            same &= near.reshape(-1, a.shape[-1]).all(dim=0)
    err = 0.0
    for (name, a), (_, b) in zip(outs_k, outs_p):
        if a.is_floating_point():
            err = max(err, float_err(what, name, a[..., same], b[..., same],
                                     1e-3, 1e-4))
    return agree, same, err


F32_EPS = 2.0 ** -24
K1_F32_SHARE = 0.99
K6_F32_SHARE = 0.95
K3_F32_SHARE = 0.95
K3_V_RTOL = 1e-3
K4_F32_SHARE = 0.99


def divergence(b, v0, fill_k, fill_p, cfg, seed, v_rtol=0.0):
    """Where chain ``b`` of two f32 fills from one state first takes another
    decision, and whether f32 rounding explains it.  A Zig-Zag flip (the
    Speed-Up Zig-Zag's on its effective gradient):
    recomputed in float64 at the kernel's post-flow x, u * total lies within
    d * 2**-24 of the total (the rounding bound of a sum of d non-negative f32
    terms) from a prefix sum between the two picked coordinates.  A bounce
    against a refresh (BPS, linear flow): recomputed in float64, the bounce
    probability lies within 8 d * 2**-24 of the uniform that decides it.  An
    accept against a reject: the uniform lies between the two sides'
    acceptance ratios, which agree to 1e-4.  In horizon mode, one side
    frozen: the two committed clocks agree to 1e-4 and lie on either side of
    the target.  Velocities count as equal within ``v_rtol``.  Returns
    (text, explained)."""
    B, d = fill_k.kind.shape[-1], fill_k.x.shape[1]
    kk, kp = fill_k.kind[:, 0, b], fill_p.kind[:, 0, b]
    vk, vp = fill_k.v[:, :, b], fill_p.v[:, :, b]
    differs = ((fill_k.kind[:, :, b] != fill_p.kind[:, :, b]).any(1)
               | ((vk - vp).abs() > v_rtol * vp.abs()).any(1))
    if fill_k.act is not None:
        differs |= (fill_k.act[:, :, b] != fill_p.act[:, :, b]).any(1)
    if not bool(differs.any()):
        return f"chain {b}: no event row differs, only the final state", False
    k = int(differs.nonzero()[0, 0])
    at = f"chain {b} transition {k}"
    seeds = rng.lane_seeds(seed, B, cfg.tile, DEV)
    same_act = fill_k.act is None or torch.equal(fill_k.act[k, :, b], fill_p.act[k, :, b])
    v_prev = (v0 if k == 0 else fill_k.v[k - 1])[:, b]
    if (int(kk[k]) == int(kp[k]) == pt.EV_JUMP and same_act
            and cfg.kind in ("zigzag", "suzz")):
        m_k = int((fill_k.v[k, :, b] != v_prev).nonzero()[0, 0])
        m_p = int((fill_p.v[k, :, b] != v_prev).nonzero()[0, 0])
        if m_k == m_p:
            return f"{at}: both flip coordinate {m_k}, yet the rows differ", False
        va = v_prev.double()
        if fill_k.act is not None:
            va = va * fill_k.act[k, :, b]   # a jump keeps the mask
        rates = torch.clamp_min(
            k1.flow_and_rates(cfg)[1](fill_k.x[k, :, b, None].double(), va[:, None])[:, 0], 0.0)
        c = torch.cumsum(rates, 0)
        u = float(rng.uniform(seeds, k, 2, cfg.tile, torch.float32)[b])
        total = float(c[-1])
        lo, hi = sorted((m_k, m_p))
        gap = float((c[lo:hi] - u * total).abs().min()) / total
        return (f"{at}: flips coordinate {m_k} (kernel) vs {m_p} (plain); in f64, "
                f"u*total={u * total:.6f} lies {gap:.2e} of total={total:.3f} from a "
                f"prefix sum between them (bound d*2^-24={d * F32_EPS:.2e})",
                gap <= d * F32_EPS)
    if int(kk[k]) == int(kp[k]) == pt.EV_JUMP and cfg.kind == "bps":
        g = cfg.grad(fill_k.x[k, :, b, None].double())[:, 0]
        br = max(0.0, float(torch.dot(g, v_prev.double())))
        prob = br / (br + cfg.refresh_rate) if br + cfg.refresh_rate > 0 else 0.0
        u = float(rng.uniform(seeds, k, 2, cfg.tile, torch.float32)[b])
        return (f"{at}: the kernel and the plain version part at the bounce draw; in "
                f"f64 the bounce probability is {prob:.8f}, the uniform {u:.8f} "
                f"(bound 8*d*2^-24={8 * d * F32_EPS:.2e})",
                abs(u - prob) <= 8 * d * F32_EPS)
    events = (kk[:k] > 0).nonzero()
    if cfg.horizon and 0 in (int(kk[k]), int(kp[k])) and len(events):
        # one side froze at the clock target: both committed clocks are the
        # last event row's time (ts is 0 there), on either side of it
        j = int(events[-1, 0])
        t_k, t_p, tt = float(fill_k.fs[j, 0, b]), float(fill_p.fs[j, 0, b]), cfg.t_target
        return (f"{at}: one side froze at the clock target {tt!r}: committed clocks "
                f"{t_k!r} (kernel) vs {t_p!r} (plain)",
                (t_k >= tt) != (t_p >= tt) and abs(t_k - t_p) <= 1e-4 * max(1.0, tt))
    if sorted((int(kk[k]), int(kp[k]))) == [0, pt.EV_JUMP]:
        ar_k, ar_p = float(fill_k.fs[k, 2, b]), float(fill_p.fs[k, 2, b])
        u = float(rng.uniform(seeds, k, 1, cfg.tile, torch.float32)[b])
        return (f"{at}: kinds {int(kk[k])} (kernel) vs {int(kp[k])} (plain); u={u:.8f}, "
                f"acceptance ratios {ar_k:.8f} vs {ar_p:.8f}",
                (u - ar_k) * (u - ar_p) <= 0 and abs(ar_k - ar_p) <= 1e-4)
    return (f"{at}: kinds {int(kk[k])} (kernel) vs {int(kp[k])} (plain), or the "
            "activity differs", False)


def compare_f32(what, v0, st_k, fill_k, st_p, fill_p, cfg, seed, share_min, v_rtol=0.0):
    """A chunk kernel against its plain version from one f32 state
    (velocities ``v0``): a rounding difference may flip a decision (thinning,
    a Zig-Zag flip coordinate, a bounce against a refresh) and send a chain
    down another valid path.  Event kinds must agree on at least 99% of
    (transition, chain) pairs; at least ``share_min`` of the chains must take
    identical decisions and agree in their floats as :func:`f32_agreement`
    states; every other chain must have left at a rounding tie
    (:func:`divergence`).  Returns (kind agreement, share, max abs err,
    divergence texts)."""
    agree, same, err = f32_agreement(what, st_k, fill_k, st_p, fill_p, v_rtol)
    share = float(same.float().mean())
    texts = []
    for b in (~same).nonzero()[:, 0].tolist():
        text, explained = divergence(b, v0, fill_k, fill_p, cfg, seed, v_rtol)
        if not explained:
            raise AssertionError(f"{what}: unexplained divergence, {text}")
        texts.append(text)
    if share < share_min:
        raise AssertionError(f"{what}: only {share:.4f} of the chains took equal "
                             f"decisions (want >= {share_min}); {'; '.join(texts)}")
    return agree, share, err, texts


def random_fill(T, d, B, dtype, seed, sticky=False):
    g = torch.Generator(device=DEV).manual_seed(seed)
    kind = torch.where(torch.rand((T, 4, B), generator=g, device=DEV) < 0.6, 2, 0)
    kind[:, 1:] = torch.randint(0, 50, (T, 3, B), generator=g, device=DEV)
    kind = kind.to(torch.int32)
    kind[:, 0, 0] = 0  # a chain without events
    f = lambda *s: torch.randn(s, generator=g, device=DEV, dtype=dtype)  # noqa: E731
    act = (torch.rand((T, d, B), generator=g, device=DEV) < 0.7) if sticky else None
    return k1.RawFill(kind=kind, x=f(T, d, B), v=f(T, d, B), fs=f(T, 3, B),
                      ring=f(T, 5, B), act=act)


def random_init(d, B, dtype, seed):
    sampler = pt.ZigZag(d, pt.potentials.grad_gauss)
    return event_from_state(random_state(sampler, B, dtype, seed), EV_INIT)


def k2_outputs_equal(what, out_k, out_p):
    """K2 is exact: every field bit-identical.  Returns the max abs
    difference of the float fields (0.0 when it passes)."""
    err = 0.0
    for name, a, b in zip(pt.Skeleton._fields, out_k, out_p):
        if not torch.equal(a, b):
            raise AssertionError(f"K2 {what}: {name} differs")
        if a.is_floating_point() and a.numel():
            err = max(err, float((a - b).abs().max()))
    return err


def k2_compare(d, B, T, W, dtype, sticky=False):
    """K2 against its plain version on a random fill behind an init record,
    with no offset, and at random per-chain offsets in [1, max(2, W // 2)),
    where off + kept passes W for many chains (the clamp)."""
    fill = random_fill(T, d, B, dtype, d, sticky)
    init = random_init(d, B, dtype, d + 1)
    err = 0.0
    for off, ini in ((torch.ones(B, dtype=torch.int32, device=DEV), init),
                     (None, None),
                     (torch.randint(1, max(2, W // 2), (B,), dtype=torch.int32, device=DEV),
                      None)):
        base = k2.empty_rows(B, W, d, dtype, DEV)
        for a in base[:-1]:
            a.zero_()  # merges keep the columns below the offsets
        outs = []
        for fn in (k2.compact_rows, k2.compact_rows_plain):
            out = pt.Skeleton(*(a.clone() for a in base))
            kind, specs = k2.fill_specs(fill, out, ini)
            fn(kind, specs, off)
            outs.append(out)
        sync()
        err = max(err, k2_outputs_equal(
            f"d={d} B={B} T={T} W={W} off={off is not None} init={ini is not None}", *outs))
    return err


K2_CASES = [  # d, B, T, W, dtype, sticky
    (10, 512, 700, 480, torch.float32, False),
    (10, 256, 300, 200, torch.float64, False),
    (1000, 64, 300, 200, torch.float32, False),
    (1000, 64, 300, 200, torch.float32, True),
    (10, 1001, 333, 150, torch.float32, True),   # a ragged chain group, T not a tile multiple
    (1000, 48, 300, 200, torch.float64, True),   # f64 d = 1000: 8-byte lines, split fields
    (10, 33, 70, 1, torch.float32, True),        # W = 1: the init record alone
    (10, 100, 64, 20, torch.float64, False),     # W far below off + kept
]


def phase_k2():
    err = max(k2_compare(*c) for c in K2_CASES)
    print(f"phase 3 K2 vs plain: {len(K2_CASES)} fills (d=10 and 1000, f32 and f64, with "
          "and without an activity stream, B=1001, W=1 and W clamps) with offsets and "
          f"init, bit-identical (max_abs_err={err})", flush=True)
    return err


def moments_ok(mean, var):
    return bool((mean.abs() < 0.2).all()) and bool(((var - 1.0).abs() < 0.3).all())


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_main(card_name):
    d, B, n_sk = MAIN
    sampler = pt.ZigZag(d, pt.potentials.grad_gauss)
    x0, v0 = np.zeros((B, d)), np.ones((B, d))
    kw = dict(seed=0, dtype=torch.float32, device=DEV)
    pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)  # warm: build, allocator
    sync()
    build.reset_launches()
    t0 = time.perf_counter()
    skel = pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    nv = skel.n_valid.cpu()
    if not bool((nv == n_sk).all()):
        raise AssertionError(f"main path incomplete: n_valid min {int(nv.min())}")
    if launches["zigzag_chunk"] < 1 or launches["compact_rows"] < 1:
        raise AssertionError(f"main path missed a kernel: {launches}")
    if not bool(torch.isfinite(skel.x).all() and torch.isfinite(skel.t).all()):
        raise AssertionError("main path produced non-finite values")
    mean, var = pt.pooled_moments(skel, sampler, 256)
    if not moments_ok(mean, var):
        raise AssertionError(f"main path moments off: mean {mean.tolist()} "
                             f"var {var.tolist()}")
    events = int(nv.sum()) - B
    print(f"phase 4 main path: ZigZag({d}) B={B} n_sk={n_sk} f32 wall={wall:.4f} s "
          f"events={events} events/s={events / wall:.1f} launches={launches} "
          f"max|mean|={float(mean.abs().max()):.4f} "
          f"max|var-1|={float((var - 1).abs().max()):.4f} ({card_name})", flush=True)
    del skel
    return sampler, launches


def phase_breakdown(sampler):
    """Fill and compaction timed apart at the main-path shapes, and each
    kernel checked and timed against its plain version there."""
    d, B, n_sk = MAIN
    target = n_sk - 1
    dtype = torch.float32
    t_cap = api.fill_rows(sampler, target, B, d, dtype, DEV)
    state = sampler.init_state_batch(np.zeros((B, d)), np.ones((B, d)), 0, dtype, DEV)
    init = event_from_state(state, EV_INIT)
    run = driver.make_stream_runner(sampler, t_cap, target)
    sync()
    t0 = time.perf_counter()
    res = run(state, torch.zeros(B, dtype=torch.int32, device=DEV))
    sync()
    fill_s = time.perf_counter() - t0
    off = torch.ones(B, dtype=torch.int32, device=DEV)
    outs = []
    for fn in (k2.compact_rows, k2.compact_rows_plain):
        out = k2.empty_rows(B, target + 1, d, dtype, DEV)
        kind, specs = k2.fill_specs(res.fill, out, init)
        fn(kind, specs, off)
        outs.append(out)
    sync()
    k2_err = k2_outputs_equal("main path", *outs)
    del outs, out
    k2_ms = cuda_ms(lambda: k2.compact_rows(kind, specs, off), 5)
    k2_plain_ms = cuda_ms(lambda: k2.compact_rows_plain(kind, specs, off), 2)
    k2_b = k2_bound(res.fill, res.counts, target + 1)
    del res, specs, kind

    K = 32
    cfg = driver.chunk_config(sampler, K, 1 << 30, 128)
    st = driver.chunk_state(state, torch.zeros(B, dtype=torch.int32, device=DEV))
    st_p = clone_state(st)
    v0 = st.v.clone()
    fill, fill_p = (k1.empty_fill(K, d, B, dtype, DEV) for _ in range(2))
    k1.run_chunk(7, st, fill, 0, cfg)
    k1.run_chunk_plain(7, st_p, fill_p, 0, cfg)
    sync()
    k1_agree, k1_share, k1_err, k1_texts = compare_f32(
        "K1 f32", v0, st, fill, st_p, fill_p, cfg, 7, K1_F32_SHARE)
    del st_p, fill_p
    k1_b = chunk_bound(cfg, st, fill, K * B)
    k1_ms = cuda_ms(lambda: k1.run_chunk(7, st, fill, 0, cfg), 20)
    k1_plain_ms = cuda_ms(lambda: k1.run_chunk_plain(7, st, fill, 0, cfg), 3)
    print(f"phase 4b breakdown (B={B}, d={d}, f32): fill {fill_s:.4f} s over "
          f"{t_cap} rows ({t_cap // K} K1 launches); K1 chunk (K={K}) "
          f"{k1_ms:.4f} ms vs plain {k1_plain_ms:.4f} ms, kinds agree on "
          f"{k1_agree:.6f}, max_abs_err {k1_err:.3e} on the {k1_share:.4f} of chains "
          f"with equal decisions (want >= {K1_F32_SHARE}); the others left at f32 "
          f"rounding ties: {'; '.join(k1_texts) or 'none'}; K2 "
          f"compaction (T={t_cap}, W={target + 1}) {k2_ms:.4f} ms vs plain "
          f"{k2_plain_ms:.4f} ms, bit-identical; bounds: K1 {bound_text(k1_b)}, "
          f"K2 {bound_text(k2_b)}", flush=True)
    return k1_ms, k1_plain_ms, k2_ms, k2_plain_ms, k2_err, k1_b, k2_b


def phase_large_d():
    d, B, n_sk = LARGE
    sampler = pt.ZigZag(d, pt.potentials.grad_gauss)
    rs = np.random.default_rng(1)
    x0 = rs.normal(size=(B, d))  # stationary start: 511 events barely move a d=1000 chain
    v0 = rs.choice([-1.0, 1.0], size=(B, d))
    sync()
    t0 = time.perf_counter()
    skel = pt.sample_skeleton(sampler, n_sk, x0, v0, seed=1, dtype=torch.float32,
                              device=DEV)
    sync()
    wall = time.perf_counter() - t0
    if not bool((skel.n_valid == n_sk).all()):
        raise AssertionError("large-d run incomplete")
    mean, var = pt.pooled_moments(skel, sampler, 256)
    m, v = float(mean.mean()), float(var.mean())
    if not (abs(m) < 0.05 and abs(v - 1.0) < 0.1):
        raise AssertionError(f"large-d pooled moments off: mean {m} var {v}")
    print(f"phase 5 large d: ZigZag({d}) B={B} n_sk={n_sk} f32 wall={wall:.4f} s "
          f"(first call, includes allocation) coordinate-pooled mean={m:.4f} "
          f"var={v:.4f}", flush=True)


def card_config(sampler, K, cap, dtype):
    """The sampler's chunk config with its kappa and its potential's
    parameters on the card in ``dtype``, as ``ops/cuda/driver.py`` hands them over."""
    cfg = driver.chunk_config(sampler, K, cap, 128)
    return cfg._replace(
        kappa=None if cfg.kappa is None else cfg.kappa.to(DEV, dtype),
        pot_params=None if cfg.pot_params is None else cfg.pot_params.to(DEV, dtype))



def k6_compare(d, B, pot, kappa, K=32, n_chunks=2, horizon=False, **kw):
    """K6 and its plain version from one f64 state near the axes, in horizon
    mode (K7) when asked; ``kw`` goes to the sampler.  Returns (max abs err,
    events, sticks, thaws, share frozen by the target)."""
    if pot in ("gauss", "banana"):
        grad = {"gauss": pt.potentials.grad_gauss, "banana": pt.potentials.grad_banana}[pot]
        sampler = pt.StickyZigZag(d, grad, np.full(d, kappa), **kw)
    else:
        sampler = pt.StickyZigZagAD(d, tag_potential(pot, d), np.full(d, kappa), **kw)
    state = random_state(sampler, B, torch.float64, d + B, scale=0.3)
    counts = torch.zeros(B, dtype=torch.int32, device=DEV)
    counts[::5] = 50  # some chains reach the cap of 64 inside the run
    cfg = card_config(sampler, K, 64, torch.float64)
    st_k = driver.chunk_state(state, counts, sticky=True)
    if horizon:
        cfg = cfg._replace(t_target=median_target(k1.run_chunk, st_k, cfg, K, n_chunks,
                                                  424242))
    st_p = clone_state(st_k)
    fill_k, fill_p = (k1.empty_fill(K * n_chunks, d, B, torch.float64, DEV, sticky=True)
                      for _ in range(2))
    for it in range(n_chunks):
        seed = 424242 + it * 1000003
        k1.run_chunk(seed, st_k, fill_k, it * K, cfg)
        k1.run_chunk_plain(seed, st_p, fill_p, it * K, cfg)
    sync()
    what = f"K6 {pot} d={d} {kw or ''}"
    err = 0.0
    for (name, a), (_, b) in zip(chunk_outputs(st_k, fill_k), chunk_outputs(st_p, fill_p)):
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: output {name} differs at "
                                     f"{int((a != b).sum())} places")
        else:
            err = max(err, float_err(what, name, a, b, RTOL, ATOL))
    kinds = fill_k.kind[:, 0]
    n_ev = int((kinds > 0).sum())
    n_stick, n_thaw = int((kinds == pt.EV_STICK).sum()), int((kinds == pt.EV_THAW).sum())
    if n_stick == 0 or n_thaw == 0 or not bool((st_k.iscal[k1.I_CNT] == 64).any()):
        raise AssertionError(f"{what}: the check saw {n_stick} sticks, {n_thaw} "
                             "thaws, or no capped chain")
    return err, n_ev, n_stick, n_thaw, target_share(st_k, cfg)


# K6's edges: the grid's; d = 1 and 33 (one warp, and one lane past it);
# d = 1000 (a coordinate per thread), 1500 (two tiles of 1024); and the
# largest d the kernel takes in float64 (seven tiles, the shared memory full)
K6_CASES = [("gauss", 10, 1024, 2.0, {}), ("banana", 10, 1024, 2.0, {}),
            ("gauss", 1000, 128, 10.0, {}), ("gauss", 1500, 32, 10.0, {}),
            ("gauss", 1, 1024, 2.0, {}), ("banana", 33, 512, 2.0, {})]
K6_CASES += [(pot, 10, 512, 2.0, dict(grid_size=grid))
             for pot, grid in (("gauss", 2), ("banana", 33), ("gauss", 64))]


def phase_k6():
    d_max = k1.sticky_max_dim(torch.float64)
    parts, err = [], 0.0
    for pot, d, B, kappa, kw in K6_CASES + [("gauss", d_max, 4, 10.0, {})]:
        e, n, ns, nt, _ = k6_compare(d, B, pot, kappa, **kw)
        err = max(err, e)
        parts.append(f"{pot} d={d} B={B} {kw or ''} max_abs_err={e:.3e} ({n} events, "
                     f"{ns} sticks, {nt} thaws)")
    # one coordinate more than the shared memory holds: the wrapper raises
    big = pt.StickyZigZag(d_max + 1, pt.potentials.grad_gauss)
    state = big.init_state_batch(np.zeros((2, d_max + 1)), np.ones((2, d_max + 1)), 0,
                                 torch.float64, DEV)
    st = driver.chunk_state(state, torch.zeros(2, dtype=torch.int32, device=DEV), sticky=True)
    try:
        k1.run_chunk(0, st, k1.empty_fill(4, d_max + 1, 2, torch.float64, DEV, True), 0,
                     card_config(big, 4, 10, torch.float64))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"K6 ran d={d_max + 1}, past its sticky_chunk_max_dim")
    print(f"phase 6 K6 vs plain (f64, 2 x K=32): {'; '.join(parts)}; ints and "
          f"activity equal, rtol {RTOL} atol {ATOL}; sticky_chunk_max_dim "
          f"{k1.sticky_max_dim(torch.float32)} (f32), {d_max} (f64), d={d_max + 1} "
          f"refused: {refused}", flush=True)
    return err


def check_sticky_skeleton(skel, n_sk):
    """The sticky path's contracts on a complete skeleton; returns the counts
    of jump, stick and thaw events."""
    if not bool((skel.n_valid == n_sk).all()):
        raise AssertionError(f"sticky path incomplete: n_valid min {int(skel.n_valid.min())}")
    kind, act, x = skel.kind[:, 1:], skel.is_active, skel.x
    stick, thaw = kind == pt.EV_STICK, kind == pt.EV_THAW
    dn = act[:, 1:].sum(-1) - act[:, :-1].sum(-1)
    if not (bool((dn[stick] == -1).all()) and bool((dn[thaw] == 1).all())
            and bool((dn[~(stick | thaw)] == 0).all())):
        raise AssertionError("a stick row did not freeze exactly one coordinate, or a "
                             "thaw row did not release exactly one")
    newly = act[:, :-1] & ~act[:, 1:]
    if not bool((x[:, 1:][newly] == 0.0).all()) or not bool((x[~act] == 0.0).all()):
        raise AssertionError("a frozen coordinate is not exactly at 0.0")
    if not bool((skel.v.abs() == 1.0).all()):
        raise AssertionError("|v| != 1 somewhere")
    if not bool((skel.t[:, 1:] >= skel.t[:, :-1]).all()):
        raise AssertionError("t decreases somewhere")
    if not bool(torch.isfinite(x).all()):
        raise AssertionError("non-finite positions")
    n_jump, n_stick, n_thaw = (int((kind == k).sum()) for k in (pt.EV_JUMP, pt.EV_STICK,
                                                                pt.EV_THAW))
    if n_stick == 0 or n_thaw == 0:
        raise AssertionError(f"sticky path: {n_stick} sticks, {n_thaw} thaws")
    return n_jump, n_stick, n_thaw


def phase_sticky(card_name):
    d, B, n_sk, kappa = STICKY
    sampler = pt.StickyZigZagAD(d, pt.potentials.gauss, np.full(d, kappa))
    x0, v0 = np.full((B, d), 0.3), np.ones((B, d))
    kw = dict(seed=0, dtype=torch.float32, device=DEV)
    pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)  # warm: allocator, fill ratio
    sync()
    build.reset_launches()
    t0 = time.perf_counter()
    skel = pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if launches["sticky_chunk"] < 1 or launches["compact_rows"] < 1:
        raise AssertionError(f"sticky path missed a kernel: {launches}")
    n_jump, n_stick, n_thaw = check_sticky_skeleton(skel, n_sk)
    events = int(skel.n_valid.sum()) - B
    frozen = 1.0 - float(skel.is_active[:, -1].float().mean())
    del skel
    walls = [wall]
    for _ in range(STICKY_CALLS - 1):  # the spread of warm calls
        t0 = time.perf_counter()
        pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)
        sync()
        walls.append(time.perf_counter() - t0)
    med = float(np.median(walls))
    print(f"phase 7 sticky path: StickyZigZagAD({d}, gauss, kappa={kappa}) B={B} "
          f"n_sk={n_sk} f32 wall={wall:.4f} s events={events} "
          f"events/s={events / wall:.1f} launches={launches} jumps={n_jump} "
          f"sticks={n_stick} thaws={n_thaw} frozen share at the end={frozen:.4f}; "
          f"stick/thaw rows change one coordinate, frozen x == 0.0, |v| == 1, "
          f"t non-decreasing; {STICKY_CALLS} warm calls "
          f"{' '.join(f'{w:.4f}' for w in walls)} s, median {med:.4f} s "
          f"({events / med:.1f} events/s) ({card_name})", flush=True)
    return sampler, launches, med


def phase_sticky_breakdown(sampler, k6_launches, wall):
    """The sticky path's fill and compaction timed apart, and K6 checked and
    timed against its plain version at exactly this shape; then the median
    warm call (``wall``, phase 7) split into K6 (its ``k6_launches`` at the
    timed rate), K2 and the rest (host work, during which the card idles)."""
    d, B, n_sk, _ = STICKY
    target = n_sk - 1
    dtype = torch.float32
    t_cap = api.fill_rows(sampler, target, B, d, dtype, DEV)
    state = sampler.init_state_batch(np.full((B, d), 0.3), np.ones((B, d)), 0, dtype, DEV)
    init = event_from_state(state, EV_INIT)
    run = driver.make_stream_runner(sampler, t_cap, target)
    zeros = torch.zeros(B, dtype=torch.int32, device=DEV)
    sync()
    t0 = time.perf_counter()
    res = run(state, zeros)
    sync()
    fill_s = time.perf_counter() - t0
    n_launch = res.transitions // 32
    off = torch.ones(B, dtype=torch.int32, device=DEV)
    outs, secs = [], []
    for fn in (k2.compact_rows, k2.compact_rows_plain):
        out = k2.empty_rows(B, target + 1, d, dtype, DEV)
        for a in out[:-1]:
            a.zero_()  # columns past a short chain's rows stay equal
        kind, specs = k2.fill_specs(res.fill, out, init)
        sync()
        t0 = time.perf_counter()
        fn(kind, specs, off)
        sync()
        secs.append(time.perf_counter() - t0)
        outs.append(out)
    k2_err = k2_outputs_equal("sticky path", *outs)
    del outs, out
    k2_ms = cuda_ms(lambda: k2.compact_rows(kind, specs, off), 3)
    k2_plain_ms = cuda_ms(lambda: k2.compact_rows_plain(kind, specs, off), 2)
    k2_b = k2_bound(res.fill, res.counts, target + 1)
    del res, specs, kind

    K, seed = 32, 7
    cfg = card_config(sampler, K, 1 << 30, dtype)
    st = driver.chunk_state(state, zeros, sticky=True)
    st_p = clone_state(st)
    v0 = st.v.clone()
    fill, fill_p = (k1.empty_fill(K, d, B, dtype, DEV, sticky=True) for _ in range(2))
    k1.run_chunk(seed, st, fill, 0, cfg)
    k1.run_chunk_plain(seed, st_p, fill_p, 0, cfg)
    sync()
    agree, share, err, texts = compare_f32("K6 f32", v0, st, fill, st_p, fill_p, cfg,
                                           seed, K6_F32_SHARE)
    del st_p, fill_p
    k6_b = chunk_bound(cfg, st, fill, K * B)
    k6_ms = cuda_ms(lambda: k1.run_chunk(seed, st, fill, 0, cfg), 20)
    k6_plain_ms = cuda_ms(lambda: k1.run_chunk_plain(seed, st, fill, 0, cfg), 2)
    print(f"phase 7b sticky breakdown (B={B}, d={d}, f32): fill {fill_s:.4f} s over "
          f"{t_cap} rows, {n_launch} K6 launches ({n_launch * k6_ms / 1e3:.4f} s "
          f"of K6 at the timed rate); K2 compaction (T={t_cap}, W={target + 1}, with "
          f"the activity stream) {secs[0]:.4f} s wall, {k2_ms:.4f} ms by CUDA events "
          f"vs plain {k2_plain_ms:.4f} ms ({secs[1]:.4f} s wall), bit-identical, bound "
          f"{bound_text(k2_b)}; K6 "
          f"chunk (K={K}) {k6_ms:.4f} ms vs plain {k6_plain_ms:.4f} ms, kinds agree on "
          f"{agree:.6f}, max_abs_err {err:.3e} on the {share:.4f} of chains with equal "
          f"decisions (want >= {K6_F32_SHARE}); the others left at f32 rounding ties: "
          f"{'; '.join(texts) or 'none'}; K6 bound {bound_text(k6_b)}", flush=True)
    wall_ms, k6_total = wall * 1e3, k6_launches * k6_ms
    rest = wall_ms - k6_total - k2_ms
    print(f"phase 7c sticky time split of the median warm call ({wall_ms:.4f} ms): "
          f"K6 {k6_launches} x {k6_ms:.4f} = {k6_total:.4f} ms "
          f"({k6_total / wall_ms:.1%}); K2 {k2_ms:.4f} ms ({k2_ms / wall_ms:.1%}); "
          f"rest (host, card idle) {rest:.4f} ms ({rest / wall_ms:.1%})", flush=True)
    return k6_ms, k6_plain_ms, k2_ms, k2_plain_ms, k2_err, k6_b


def phase_sticky_law():
    d, B, n_sk, kappa = STICKY_LAW
    sampler = pt.StickyZigZag(d, pt.potentials.grad_gauss, np.full(d, kappa))
    t0 = time.perf_counter()
    skel = pt.sample_skeleton(sampler, n_sk, np.full((B, d), 0.3), np.ones((B, d)),
                              seed=2, dtype=torch.float32, device=DEV)
    sync()
    wall = time.perf_counter() - t0
    if not bool((skel.n_valid == n_sk).all()):
        raise AssertionError("sticky law run incomplete")
    xs = pt.sample_from_skeleton_batch(sampler, 256, skel).double()
    phi0 = 1.0 / np.sqrt(2 * np.pi)
    expected = phi0 / (kappa + phi0)
    frozen = float((xs == 0.0).mean(dtype=torch.float64))
    var = float(xs.reshape(-1, d).var(dim=0).mean())
    if abs(frozen - expected) >= 0.02 or abs(var - (1 - expected)) >= 0.03:
        raise AssertionError(f"sticky law off: frozen {frozen} (want {expected:.4f} "
                             f"+- 0.02), var {var} (want {1 - expected:.4f} +- 0.03)")
    print(f"phase 8 sticky law: StickyZigZag({d}, kappa={kappa}) B={B} n_sk={n_sk} f32 "
          f"wall={wall:.4f} s (first call); frozen fraction {frozen:.4f} "
          f"(theory {expected:.4f}), variance {var:.4f} (theory {1 - expected:.4f})",
          flush=True)


def scalar_sampler(kind, pot, d, **kw):
    if pot not in ("gauss", "banana"):
        return {"bps": pt.BPSAD, "boomerang": pt.BoomerangAD,
                "ecmc": pt.ForwardECMCAD}[kind](d, tag_potential(pot, d), **kw)
    grad = {"gauss": pt.potentials.grad_gauss, "banana": pt.potentials.grad_banana}[pot]
    return {"bps": pt.BPS, "boomerang": pt.Boomerang, "ecmc": pt.ForwardECMC}[kind](
        d, grad, **kw)


def scalar_f32_check(what, sampler, state, K=32, seed=7):
    """One K=32 chunk of K3/K5 and of its plain version from one float32
    ``state`` of a driven path, held as :func:`compare_f32` states (at least
    ``K3_F32_SHARE`` of the chains with equal decisions).  Returns (config,
    the kernel's state and fill, for timing, and the comparison's text and
    max abs err)."""
    d, B = state.x.shape[1], state.x.shape[0]
    cfg = card_config(sampler, K, 1 << 30, torch.float32)
    st = driver.chunk_state(state, torch.zeros(B, dtype=torch.int32, device=DEV))
    st_p = clone_state(st)
    v0 = st.v.clone()
    fill, fill_p = (k1.empty_fill(K, d, B, torch.float32, DEV) for _ in range(2))
    k3.run_chunk(seed, st, fill, 0, cfg)
    k3.run_chunk_plain(seed, st_p, fill_p, 0, cfg)
    sync()
    agree, share, err, texts = compare_f32(what, v0, st, fill, st_p, fill_p, cfg, seed,
                                           K3_F32_SHARE, K3_V_RTOL)
    text = (f"kinds agree on {agree:.6f}, max_abs_err {err:.3e} on the {share:.4f} of "
            f"chains with equal decisions (want >= {K3_F32_SHARE}); the others left at "
            f"f32 rounding ties: {'; '.join(texts) or 'none'}")
    return cfg, st, fill, text, err


def k3_runs(kind, pot, d, B, kw, K=32, n_chunks=2, horizon=False):
    """K3/K5 and their plain version, ``n_chunks`` chunks each from one f64
    state: random positions, unit velocities (Gaussian for the Boomerang),
    every 13th chain with x parallel to v (ECMC's degenerate frame), every
    5th capped inside the run; in horizon mode (K7) when asked.  Returns the
    kernel's state and fill, then the plain version's, and the config."""
    sampler = scalar_sampler(kind, pot, d, **kw)
    rs = np.random.default_rng(d + B)
    x0, v0 = rs.normal(size=(B, d)), rs.normal(size=(B, d))
    if kind != "boomerang":
        v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    x0[::13] = 0.5 * v0[::13]
    if pot == "funnel":
        x0[:, 0] = 0.5 + np.abs(x0[:, 0])
    state = sampler.init_state_batch(x0, v0, d + B, torch.float64, DEV)
    counts = torch.zeros(B, dtype=torch.int32, device=DEV)
    counts[::5] = 50  # some chains reach the cap of 64 inside the run
    cfg = card_config(sampler, K, 64, torch.float64)
    st_k = driver.chunk_state(state, counts)
    if horizon:
        cfg = cfg._replace(t_target=median_target(k3.run_chunk, st_k, cfg, K, n_chunks,
                                                  271828))
    st_p = clone_state(st_k)
    fill_k, fill_p = (k1.empty_fill(K * n_chunks, d, B, torch.float64, DEV)
                      for _ in range(2))
    for it in range(n_chunks):
        seed = 271828 + it * 1000003
        k3.run_chunk(seed, st_k, fill_k, it * K, cfg)
        k3.run_chunk_plain(seed, st_p, fill_p, it * K, cfg)
    sync()
    return st_k, fill_k, st_p, fill_p, cfg


def k3_compare(kind, pot, d, B, kw, horizon=False):
    """K3/K5 against their plain version (:func:`k3_runs`), bit for bit:
    integers equal, floats to rtol 0, atol 0.  Returns (max abs err, events,
    share frozen by the target)."""
    st_k, fill_k, st_p, fill_p, cfg = k3_runs(kind, pot, d, B, kw, horizon=horizon)
    what = f"{k3.launch_name(kind)} {kind} {pot} d={d} {kw}"
    rtol, atol = bit_tolerance(what, pot, st_k, fill_k, st_p, fill_p)
    err = 0.0
    for (name, a), (_, b) in zip(chunk_outputs(st_k, fill_k), chunk_outputs(st_p, fill_p)):
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: output {name} differs at "
                                     f"{int((a != b).sum())} places")
        else:
            err = max(err, float_err(what, name, a, b, rtol, atol))
    n_ev = int((fill_k.kind[:, 0] == pt.EV_JUMP).sum())
    if n_ev < B or not bool((st_k.iscal[k1.I_CNT] == 64).any()):
        raise AssertionError(f"{what}: {n_ev} events, or no capped chain")
    return err, n_ev, target_share(st_k, cfg)


K3_CASES = [
    ("bps", "gauss", 10, 1024, {}),
    ("bps", "aniso", 10, 1024, dict(signed_bound=False, gaussian_velocity=True)),
    ("boomerang", "banana", 10, 1024, {}),
    ("ecmc", "gauss", 10, 1024, dict(switch=True, ran_p=False, positive=True, normal=False)),
    ("ecmc", "gauss", 10, 1024, dict(switch=True, ran_p=True, positive=False, normal=False)),
    ("ecmc", "gauss", 10, 1024, dict(switch=False, ran_p=False, positive=True, normal=True)),
    ("bps", "gauss", 100, 256, {}),
]
# the envelope's edges: one grid point per lane (2), and lanes owning two
# grid points with lane 31 handing its pair across (33, 64)
K3_CASES += [(kind, pot, 10, 512, dict(kw, grid_size=grid))
             for grid in (2, 33, 64)
             for kind, pot, kw in (("bps", "aniso", dict(signed_bound=False)),
                                   ("boomerang", "banana", {}),
                                   ("ecmc", "gauss", dict(switch=True, ran_p=True)))]


def phase_k3():
    parts, errs = [], {"bps_chunk": 0.0, "ecmc_chunk": 0.0}
    for kind, pot, d, B, kw in K3_CASES:
        err, n_ev, _ = k3_compare(kind, pot, d, B, kw)
        name = k3.launch_name(kind)
        errs[name] = max(errs[name], err)
        parts.append(f"{kind} {pot} d={d} B={B} {kw or ''} max_abs_err={err:.3e} "
                     f"({n_ev} events)")
    print(f"phase 9 K3/K5 vs plain (f64, 2 x K=32): {'; '.join(parts)}; ints equal, "
          "floats bit for bit", flush=True)
    return errs


def bps_deployment():
    d, B, n_sk, refresh = BPS_D10
    scales = np.linspace(0.5, 3.0, d)
    sampler = pt.BPSAD(d, pt.potentials.anisotropic_gauss(scales), refresh_rate=refresh)
    return sampler, scales, np.zeros((B, d)), np.ones((B, d))


def phase_bps(card_name):
    """The bps_anisotropic_gauss_d10 deployment (benchmarks/run_baselines.py:115-119
    at scale 1, x0 = 0, v0 = 1 as at :193-200): one warm call, then five timed
    warm calls, the first of them counted and checked."""
    d, B, n_sk, refresh = BPS_D10
    sampler, scales, x0, v0 = bps_deployment()
    kw = dict(seed=0, dtype=torch.float32, device=DEV)
    pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)  # warm: allocator, fill ratio
    sync()
    walls = []
    for call in range(BPS_CALLS):
        if call == 0:
            build.reset_launches()
        t0 = time.perf_counter()
        skel = pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)
        sync()
        walls.append(time.perf_counter() - t0)
        if call == 0:
            launches = dict(build.LAUNCHES)
            checked = skel
    skel = checked
    if launches["bps_chunk"] < 1 or launches["compact_rows"] < 1:
        raise AssertionError(f"BPS path missed a kernel: {launches}")
    if not bool((skel.n_valid == n_sk).all()):
        raise AssertionError(f"BPS path incomplete: n_valid min {int(skel.n_valid.min())}")
    if not bool(torch.isfinite(skel.x).all() and torch.isfinite(skel.t).all()):
        raise AssertionError("BPS path produced non-finite values")
    if not bool((skel.t[:, 1:] >= skel.t[:, :-1]).all()):
        raise AssertionError("BPS path: t decreases somewhere")
    mean, var = (a.double().cpu().numpy() for a in pt.pooled_moments(skel, sampler, 256))
    rel_var = var / scales ** 2 - 1.0
    if not (np.all(np.abs(mean) < 0.1 * scales) and np.all(np.abs(rel_var) < 0.1)):
        raise AssertionError(f"BPS moments off: mean {mean.tolist()} var/s^2 - 1 "
                             f"{rel_var.tolist()}")
    events = int(skel.n_valid.sum()) - B
    del skel, checked
    med = float(np.median(walls))
    print(f"phase 10 bps_anisotropic_gauss_d10: BPSAD({d}, anisotropic_gauss(linspace(0.5, "
          f"3, {d})), refresh_rate={refresh}) B={B} n_sk={n_sk} f32 events={events} "
          f"launches={launches}; complete, t non-decreasing and finite, "
          f"max|mean/s|={float(np.max(np.abs(mean) / scales)):.4f} "
          f"max|var/s^2-1|={float(np.max(np.abs(rel_var))):.4f}; {BPS_CALLS} warm calls "
          f"{' '.join(f'{w:.4f}' for w in walls)} s, median {med:.4f} s "
          f"({events / med:.1f} events/s), spread {min(walls):.4f}-{max(walls):.4f} s "
          f"({card_name})", flush=True)
    return sampler, launches, med


def phase_bps_breakdown(sampler, k3_launches, wall):
    """The BPS path's fill and compaction timed apart, K2 checked bit for bit
    on this fill, one K=32 chunk of K3 checked against its plain version at
    exactly this shape in float32 and each kernel timed beside its plain
    version; then the median warm call split into K3, K2 and the rest."""
    d, B, n_sk, _ = BPS_D10
    target = n_sk - 1
    dtype = torch.float32
    _, _, x0, v0 = bps_deployment()
    t_cap = api.fill_rows(sampler, target, B, d, dtype, DEV)
    state = sampler.init_state_batch(x0, v0, 0, dtype, DEV)
    init = event_from_state(state, EV_INIT)
    run = driver.make_stream_runner(sampler, t_cap, target)
    zeros = torch.zeros(B, dtype=torch.int32, device=DEV)
    sync()
    t0 = time.perf_counter()
    res = run(state, zeros)
    sync()
    fill_s = time.perf_counter() - t0
    off = torch.ones(B, dtype=torch.int32, device=DEV)
    outs = []
    for fn in (k2.compact_rows, k2.compact_rows_plain):
        out = k2.empty_rows(B, target + 1, d, dtype, DEV)
        for a in out[:-1]:
            a.zero_()  # columns past a short chain's rows stay equal
        kind, specs = k2.fill_specs(res.fill, out, init)
        fn(kind, specs, off)
        outs.append(out)
    sync()
    k2_err = k2_outputs_equal("BPS path", *outs)
    del outs, out
    k2_ms = cuda_ms(lambda: k2.compact_rows(kind, specs, off), 5)
    k2_plain_ms = cuda_ms(lambda: k2.compact_rows_plain(kind, specs, off), 2)
    k2_b = k2_bound(res.fill, res.counts, target + 1)
    complete = int((res.counts >= target).sum())
    del res, specs, kind

    K, seed = 32, 7
    cfg, st, fill, f32_text, f32_err = scalar_f32_check("K3 BPS f32", sampler, state, K, seed)
    k3_b = chunk_bound(cfg, st, fill, K * B)
    k3_ms = cuda_ms(lambda: k3.run_chunk(seed, st, fill, 0, cfg), 20)
    k3_plain_ms = cuda_ms(lambda: k3.run_chunk_plain(seed, st, fill, 0, cfg), 2)
    print(f"phase 10b BPS breakdown (B={B}, d={d}, f32): fill {fill_s:.4f} s over {t_cap} "
          f"rows ({complete} of {B} chains complete in it); K2 compaction (T={t_cap}, "
          f"W={target + 1}) {k2_ms:.4f} ms vs plain {k2_plain_ms:.4f} ms, bit-identical, "
          f"bound {bound_text(k2_b)}; K3 chunk (K={K}) {k3_ms:.4f} ms vs plain "
          f"{k3_plain_ms:.4f} ms, bound {bound_text(k3_b)}; {f32_text}", flush=True)
    wall_ms, k3_total = wall * 1e3, k3_launches * k3_ms
    rest = wall_ms - k3_total - k2_ms
    print(f"phase 10c BPS time split of the median warm call ({wall_ms:.4f} ms): "
          f"K3 {k3_launches} x {k3_ms:.4f} = {k3_total:.4f} ms ({k3_total / wall_ms:.1%}); "
          f"K2 {k2_ms:.4f} ms ({k2_ms / wall_ms:.1%}); rest (host, card idle) "
          f"{rest:.4f} ms ({rest / wall_ms:.1%})", flush=True)
    return k3_ms, k3_plain_ms, k3_b, k2_err, f32_err


def phase_boomerang(card_name):
    """boomerang_gauss_d10 (benchmarks/run_baselines.py:120-123): grad U_eff is
    0 on this target, so the run holds the elliptic flow and the Gaussian
    refresh; each fill is one K2 launch."""
    d, B, n_sk, refresh = BOOMERANG_D10
    sampler = pt.Boomerang(d, pt.potentials.grad_gauss, refresh_rate=refresh)
    build.reset_launches()
    t0 = time.perf_counter()
    skel = pt.sample_skeleton(sampler, n_sk, np.zeros((B, d)), np.ones((B, d)), seed=0,
                              dtype=torch.float32, device=DEV)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if not bool((skel.n_valid == n_sk).all()) or launches["bps_chunk"] < 1:
        raise AssertionError(f"Boomerang path incomplete or off the kernel: {launches}")
    mean, var = pt.pooled_moments(skel, sampler, 256)
    if not (bool((mean.abs() < 0.1).all()) and bool(((var - 1).abs() < 0.1).all())):
        raise AssertionError(f"Boomerang moments off: mean {mean.tolist()} var {var.tolist()}")
    del skel
    state = sampler.init_state_batch(np.zeros((B, d)), np.ones((B, d)), 0, torch.float32, DEV)
    *_, f32_text, f32_err = scalar_f32_check("K3 Boomerang f32", sampler, state)
    print(f"phase 11 boomerang_gauss_d10: Boomerang({d}, grad_gauss, refresh_rate={refresh}) "
          f"B={B} n_sk={n_sk} f32 wall={wall:.4f} s (first call) launches={launches} "
          f"({launches['compact_rows']} fills); complete, max|mean|="
          f"{float(mean.abs().max()):.4f} max|var-1|={float((var - 1).abs().max()):.4f}; "
          f"one K=32 chunk of K3 against its plain version at this shape: {f32_text} "
          f"({card_name})", flush=True)
    return f32_err


def phase_ecmc(card_name):
    """ecmc_gauss_d10 (benchmarks/run_baselines.py:131-134, v0 = 1/sqrt(10)):
    the K5 path, counted; then one K=32 chunk of K5 at this shape timed beside
    its plain version.  x0 is drawn from N(0, I), not 0 as there: from x0 = 0
    every chain's first event has x parallel to v, and in float32 the
    orthogonal component is rounding noise above the 1e-10 degenerate
    threshold, so that jump leaves |v| != 1, in the JAX package as here
    (ROADMAP Queue 3)."""
    d, B, n_sk = ECMC_D10
    sampler = pt.ForwardECMCAD(d, pt.potentials.gauss)
    x0 = np.random.default_rng(12).normal(size=(B, d))
    v0 = np.full((B, d), 1.0 / np.sqrt(d))
    kw = dict(seed=0, dtype=torch.float32, device=DEV)
    pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)  # warm: allocator, fill ratio
    sync()
    build.reset_launches()
    t0 = time.perf_counter()
    skel = pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if not bool((skel.n_valid == n_sk).all()) or launches["ecmc_chunk"] < 1:
        raise AssertionError(f"ECMC path incomplete or off the kernel: {launches}")
    speed_err = float((torch.linalg.norm(skel.v.double(), dim=-1) - 1.0).abs().max())
    if speed_err > 1e-5:
        raise AssertionError(f"ECMC: |v| off 1 by {speed_err}")
    mean, var = pt.pooled_moments(skel, sampler, 256)
    if not (bool((mean.abs() < 0.1).all()) and bool(((var - 1).abs() < 0.1).all())):
        raise AssertionError(f"ECMC moments off: mean {mean.tolist()} var {var.tolist()}")
    events = int(skel.n_valid.sum()) - B
    del skel

    K, seed = 32, 7
    state = sampler.init_state_batch(x0, v0, 0, torch.float32, DEV)
    cfg, st, fill, f32_text, f32_err = scalar_f32_check("K5 f32", sampler, state, K, seed)
    k5_b = chunk_bound(cfg, st, fill, K * B)
    k5_ms = cuda_ms(lambda: k3.run_chunk(seed, st, fill, 0, cfg), 20)
    k5_plain_ms = cuda_ms(lambda: k3.run_chunk_plain(seed, st, fill, 0, cfg), 2)
    print(f"phase 12 ecmc_gauss_d10: ForwardECMCAD({d}, gauss) B={B} n_sk={n_sk} f32 "
          f"wall={wall:.4f} s events={events} ({events / wall:.1f} events/s) "
          f"launches={launches}; complete, max||v|-1|={speed_err:.2e}, "
          f"max|mean|={float(mean.abs().max()):.4f} max|var-1|="
          f"{float((var - 1).abs().max()):.4f}; K5 chunk (K={K}) {k5_ms:.4f} ms vs plain "
          f"{k5_plain_ms:.4f} ms, bound {bound_text(k5_b)}; {f32_text} ({card_name})",
          flush=True)
    return launches, k5_ms, k5_plain_ms, k5_b, f32_err


def phase_k7():
    """K7, the horizon mode of K1, K6 and K3/K5, against the plain version
    from one f64 state (K1 and K6 to ``RTOL``/``ATOL``, K3/K5 bit for bit);
    returns the max abs err of each kernel's horizon mode."""
    errs = {"zigzag_chunk_horizon": 0.0, "sticky_chunk_horizon": 0.0,
            "bps_chunk_horizon": 0.0, "ecmc_chunk_horizon": 0.0}
    parts = []
    for B in (4096, 1001):
        e, n, s = k1_compare(10, B, 32, 2, "gauss", horizon=True)
        errs["zigzag_chunk_horizon"] = max(errs["zigzag_chunk_horizon"], e)
        parts.append(f"K1 gauss d=10 B={B} (L={lanes(B)}) max_abs_err={e:.3e} ({n} events, "
                     f"{s:.3f} of the lanes at the target)")
    for pot, d, B, kappa in (("gauss", 10, 1024, 2.0), ("gauss", 1000, 128, 10.0),
                             ("gauss", 1500, 32, 10.0)):
        e, n, ns, nt, s = k6_compare(d, B, pot, kappa, horizon=True)
        errs["sticky_chunk_horizon"] = max(errs["sticky_chunk_horizon"], e)
        parts.append(f"K6 {pot} d={d} B={B} max_abs_err={e:.3e} ({n} events, {ns} sticks, "
                     f"{nt} thaws, {s:.3f} at the target)")
    for kind, pot, kw in (("bps", "aniso", dict(signed_bound=False, gaussian_velocity=True)),
                          ("boomerang", "banana", {}), ("ecmc", "gauss", {})):
        e, n, s = k3_compare(kind, pot, 10, 1024, kw, horizon=True)
        name = k3.launch_name(kind) + "_horizon"
        errs[name] = max(errs[name], e)
        parts.append(f"{'K5' if kind == 'ecmc' else 'K3'} {kind} {pot} d=10 B=1024 "
                     f"max_abs_err={e:.3e} ({n} events, {s:.3f} at the target)")
    print(f"phase 13 K7 (horizon mode) vs plain (f64, 2 x K=32, float32 target at the "
          f"median clock of an event-count run): {'; '.join(parts)}; ints equal, K1/K6 "
          f"to rtol {RTOL} atol {ATOL}, K3/K5 bit for bit", flush=True)
    return errs


MATH_TAGS = {"ridged": "cos and sin", "neal_funnel": "exp", "logistic": "exp and log1p"}
"""Tags whose gradient calls a CUDA math function, in the kernel and in
torch's op alike."""
MATH_NOTES = []
"""Where a bit-for-bit kernel parted from its plain version on a tag of
``MATH_TAGS``: the first differing output, printed by phase 33."""


def bit_tolerance(what, pot, st_k, fill_k, st_p, fill_p):
    """(rtol, atol) of a bit-for-bit kernel's check (K3/K5, K4): (0, 0).  On
    a tag of ``MATH_TAGS`` the two may part where CUDA's math function in the
    kernel and torch's differ in a bit; there the first differing output is
    recorded in ``MATH_NOTES`` and the check takes K1's ``RTOL``/``ATOL``."""
    if pot not in MATH_TAGS:
        return 0.0, 0.0
    for (name, a), (_, b) in zip(chunk_outputs(st_k, fill_k), chunk_outputs(st_p, fill_p)):
        if not a.is_floating_point():
            continue
        same = (a == b) | (a.isnan() & b.isnan())
        if bool(same.all()):
            continue
        i = np.unravel_index(int((~same).reshape(-1).nonzero()[0, 0]), tuple(a.shape))
        row = f" (transition {i[0]}, chain {i[-1]})" if name.startswith("ev_") else ""
        MATH_NOTES.append(f"{what}: first parts at {name}{list(i)}{row}: kernel "
                          f"{float(a[i]):.17g}, plain {float(b[i]):.17g} (the gradient calls "
                          f"{MATH_TAGS[pot]}); held to rtol {RTOL} atol {ATOL}")
        return RTOL, ATOL
    return 0.0, 0.0


K1_TAG_D = 1000                  # phase 33: K1 at phase 5's d, B = 256
TAG_CHUNKS = 1                   # phase 33: chunks of K1 at K1_TAG_D and of K6 (cut from 2
                                 # for phase 44's time)
K1_IN_PLACE = (8000, 3)          # phase 33: d, B where K1 reads x and v in place (f64)
K6_TAG_CASES = {"funnel": (1000, 128, 10.0), "neal_funnel": (1000, 128, 10.0),
                "cauchy": (10, 1024, 2.0), "ridged": (10, 1024, 2.0),
                "aniso": (10, 1024, 2.0)}
"""Phase 33's K6 shapes per tag: d, chains, kappa (the funnels at d = 1000,
where the chain moments take K6's two-level reduction)."""


def phase_tags():
    """Every chunk kernel against its plain version in f64 from one state on
    the device tags ``cauchy``, ``ridged``, ``funnel`` and ``neal_funnel``,
    and on ``aniso`` for K1, K6 and K4 (phase 9 holds K3/K5 on it): K1 at
    d = 1000 and in place (d = 8000, x and v at stride B), K6 (the funnels
    at d = 1000), K4 at d = 10 and in place, K3 (BPS, the Boomerang) and K5
    at d = 10; one horizon-mode case per kernel on a funnel.  K1 and K6 to ``RTOL``/``ATOL``, K4 and K3/K5 bit for bit
    (:func:`bit_tolerance`).  Returns the max abs err of each kernel name."""
    errs, parts = Counter(), []
    t0, t_chunks = time.perf_counter(), 0.0

    def keep(name, e, text):
        errs[name] = max(errs[name], e)
        parts.append(text)

    for tag in list(TAG_POTENTIALS) + ["aniso"]:
        t1 = time.perf_counter()
        e, n, _ = k1_compare(K1_TAG_D, 256, 32, TAG_CHUNKS, tag)
        t_chunks += time.perf_counter() - t1
        keep("zigzag_chunk", e, f"K1 {tag} d={K1_TAG_D} B=256 max_abs_err={e:.3e} ({n} events)")
        d, B = K1_IN_PLACE
        K = 8 if "funnel" in tag else 32  # the plain funnels add 8000 terms per point
        e, n, _ = k1_compare(d, B, K, 1, tag, tmax=0.01)
        keep("zigzag_chunk", e, f"K1 {tag} d={d} B={B} K={K} in place max_abs_err={e:.3e} "
                                f"({n} events)")
        d, B, kappa = K6_TAG_CASES[tag]
        t1 = time.perf_counter()
        e, n, ns, nt, _ = k6_compare(d, B, tag, kappa, n_chunks=TAG_CHUNKS)
        t_chunks += time.perf_counter() - t1
        keep("sticky_chunk", e, f"K6 {tag} d={d} B={B} max_abs_err={e:.3e} ({n} events, "
                                f"{ns} sticks, {nt} thaws)")
        e, n, _ = k1_compare(10, 512, 32, 2, tag, suzz=True)
        keep("suzz_chunk", e, f"K4 {tag} d=10 B=512 max_abs_err={e:.3e} ({n} events)")
        e, n, _ = k1_compare(K4_IN_PLACE_D, 8, 4, 1, tag, suzz=True, tmax=0.01)
        keep("suzz_chunk", e, f"K4 {tag} d={K4_IN_PLACE_D} B=8 K=4 in place "
                              f"max_abs_err={e:.3e} ({n} events)")
        if tag == "aniso":  # phase 9 holds K3/K5 on it
            continue
        for kind in ("bps", "boomerang", "ecmc"):
            e, n, _ = k3_compare(kind, tag, 10, 1024, {})
            keep(k3.launch_name(kind), e, f"{'K5' if kind == 'ecmc' else 'K3'} {kind} {tag} "
                                          f"d=10 B=1024 max_abs_err={e:.3e} ({n} events)")
    # horizon mode (K7) on a funnel in every kernel
    e, n, sh = k1_compare(10, 1024, 32, 2, "neal_funnel", horizon=True)
    keep("zigzag_chunk_horizon", e, f"K1 horizon neal_funnel d=10 B=1024 max_abs_err={e:.3e} "
                                    f"({n} events, {sh:.3f} at the target)")
    e, n, ns, nt, sh = k6_compare(1000, 128, "funnel", 10.0, horizon=True)
    keep("sticky_chunk_horizon", e, f"K6 horizon funnel d=1000 B=128 max_abs_err={e:.3e} "
                                    f"({n} events, {sh:.3f} at the target)")
    e, n, sh = k1_compare(10, 512, 32, 2, "funnel", horizon=True, suzz=True)
    keep("suzz_chunk_horizon", e, f"K4 horizon funnel d=10 B=512 max_abs_err={e:.3e} "
                                  f"({n} events, {sh:.3f} at the target)")
    for kind, tag in (("bps", "neal_funnel"), ("ecmc", "funnel")):
        e, n, sh = k3_compare(kind, tag, 10, 1024, {}, horizon=True)
        keep(k3.launch_name(kind) + "_horizon", e,
             f"{'K5' if kind == 'ecmc' else 'K3'} horizon {kind} {tag} d=10 B=1024 "
             f"max_abs_err={e:.3e} ({n} events, {sh:.3f} at the target)")
    notes = "; ".join(MATH_NOTES) or "none"
    print(f"phase 33 every chunk kernel on the new device tags vs plain (f64, K=32): "
          f"{'; '.join(parts)}; ints equal, K1/K6 to rtol {RTOL} atol {ATOL}, K4 and K3/K5 "
          f"bit for bit; bit-for-bit checks that parted in a math function: {notes}; "
          f"{time.perf_counter() - t0:.1f} s, {t_chunks:.1f} s of it in the {TAG_CHUNKS}-chunk "
          f"checks of K1 at d={K1_TAG_D} and of K6", flush=True)
    return dict(errs)


def check_horizon_skeleton(what, skel, T):
    """The time-horizon contracts on every chain of a batch skeleton: the
    last valid row at t == T exactly with kind EV_TERMINAL, no valid row past
    T, t non-decreasing over the valid rows, x finite.  Returns the events
    (valid rows besides the initial and the terminal one)."""
    nv = skel.n_valid.long()
    B, W = skel.t.shape
    rows = torch.arange(B, device=nv.device)
    t = skel.t
    if not bool((t[rows, nv - 1] == T).all()):
        raise AssertionError(f"{what}: a chain's last row is not at t == {T}")
    if not bool((skel.kind[rows, nv - 1] == pt.EV_TERMINAL).all()):
        raise AssertionError(f"{what}: a chain's last row is not EV_TERMINAL")
    valid = torch.arange(W, device=t.device)[None, :] < nv[:, None]
    if not bool((t[valid] <= T).all()):
        raise AssertionError(f"{what}: a kept row lies past T = {T}")
    if not bool(((t[:, 1:] >= t[:, :-1]) | ~valid[:, 1:]).all()):
        raise AssertionError(f"{what}: t decreases somewhere")
    if not bool(torch.isfinite(skel.x).all()):
        raise AssertionError(f"{what}: non-finite positions")
    return int(nv.sum()) - 2 * B


def horizon_deployment():
    """zigzag_gauss_d10_horizon (benchmarks/run_baselines.py:100-104 at scale
    1, x0 = 0, v0 = 1 as at :193-200)."""
    d, B, _, _ = HORIZON_D10
    return pt.ZigZagAD(d, pt.potentials.gauss), np.zeros((B, d)), np.ones((B, d))


def phase_horizon(card_name):
    """The zigzag_gauss_d10_horizon deployment: one warm call, then five
    timed warm calls, the first of them counted and checked."""
    d, B, T, cap = HORIZON_D10
    sampler, x0, v0 = horizon_deployment()
    kw = dict(seed=0, dtype=torch.float32, device=DEV, init_capacity=cap)
    pt.sample_skeleton(sampler, T, x0, v0, **kw)  # warm: allocator
    sync()
    walls = []
    for call in range(HORIZON_CALLS):
        if call == 0:
            build.reset_launches()
        t0 = time.perf_counter()
        skel = pt.sample_skeleton(sampler, T, x0, v0, **kw)
        sync()
        walls.append(time.perf_counter() - t0)
        if call == 0:
            launches = dict(build.LAUNCHES)
            checked = skel
    skel = checked
    if launches["zigzag_chunk_horizon"] < 1 or launches["compact_rows"] < 1:
        raise AssertionError(f"horizon path missed a kernel: {launches}")
    events = check_horizon_skeleton("horizon path", skel, T)
    mean, var = pt.pooled_moments(skel, sampler, 256)
    if not moments_ok(mean, var):
        raise AssertionError(f"horizon path moments off: mean {mean.tolist()} "
                             f"var {var.tolist()}")
    width = skel.t.shape[1]
    del skel, checked
    per_chain = events / B
    expected = d / np.sqrt(2 * np.pi) * T  # sum_i E max(0, x_i v_i) = d / sqrt(2 pi)
    med = float(np.median(walls))
    print(f"phase 14 zigzag_gauss_d10_horizon: ZigZagAD({d}, gauss) B={B} T={T} "
          f"init_capacity={cap} f32 events={events} launches={launches}; every chain ends "
          f"at t == {T} with EV_TERMINAL, no kept row past T, t non-decreasing, width "
          f"{width}; events per chain {per_chain:.2f} (expected {expected:.2f}, "
          f"{per_chain / expected - 1:+.3%}); max|mean|={float(mean.abs().max()):.4f} "
          f"max|var-1|={float((var - 1).abs().max()):.4f}; {HORIZON_CALLS} warm calls "
          f"{' '.join(f'{w:.4f}' for w in walls)} s, median {med:.4f} s "
          f"({events / med:.1f} events/s), spread {min(walls):.4f}-{max(walls):.4f} s "
          f"({card_name})", flush=True)
    return sampler, launches, med


def phase_horizon_breakdown(sampler, launches, wall):
    """The horizon path's fill, K2 and finalize timed apart (K2 checked bit
    for bit on this fill), one K=32 horizon chunk of K1 checked against its
    plain version at this shape in float32 and timed beside it; then the
    median warm call split into K1, K2, finalize and the rest."""
    d, B, T, t_cap = HORIZON_D10
    dtype = torch.float32
    _, x0, v0 = horizon_deployment()
    state = sampler.init_state_batch(x0, v0, 0, dtype, DEV)
    init = event_from_state(state, EV_INIT)
    run = driver.make_stream_runner(sampler, t_cap, t_cap, mode="horizon")
    zeros = torch.zeros(B, dtype=torch.int32, device=DEV)
    sync()
    t0 = time.perf_counter()
    res = run(state, zeros, T)
    sync()
    fill_s = time.perf_counter() - t0
    complete = int((res.state.t >= T).sum())
    off = torch.ones(B, dtype=torch.int32, device=DEV)
    outs = []
    for fn in (k2.compact_rows, k2.compact_rows_plain):
        out = k2.empty_rows(B, 1 + t_cap, d, dtype, DEV)
        kind, specs = k2.fill_specs(res.fill, out, init)
        fn(kind, specs, off)
        outs.append(out)
    sync()
    k2_err = k2_outputs_equal("horizon path", *outs)
    acc = outs[0]._replace(n_valid=(1 + res.counts).to(torch.int32))
    del outs, out
    k2_ms = cuda_ms(lambda: k2.compact_rows(kind, specs, off), 3)
    k2_plain_ms = cuda_ms(lambda: k2.compact_rows_plain(kind, specs, off), 2)
    k2_b = k2_bound(res.fill, res.counts, 1 + t_cap)
    out_w = min(t_cap + 2, -(-(2 + int(res.counts.max())) // 256) * 256)
    fin_ms = cuda_ms(lambda: engine.finalize_horizon_rows(sampler.flow, acc, T, out_w), 3)
    del res, specs, kind, acc

    K, seed = 32, 7
    cfg = driver.chunk_config(sampler, K, 1 << 30, 128)
    st = driver.chunk_state(state, zeros)
    cfg_c = cfg._replace(t_target=median_target(k1.run_chunk, st, cfg, K, 1, seed))
    st_p = clone_state(st)
    v0c = st.v.clone()
    fill, fill_p = (k1.empty_fill(K, d, B, dtype, DEV) for _ in range(2))
    k1.run_chunk(seed, st, fill, 0, cfg_c)
    k1.run_chunk_plain(seed, st_p, fill_p, 0, cfg_c)
    sync()
    agree, share, err, texts = compare_f32("K7 K1 f32", v0c, st, fill, st_p, fill_p, cfg_c,
                                           seed, K1_F32_SHARE)
    froze = target_share(st, cfg_c)
    del st_p, fill_p
    # timed at the path's own target, which no lane reaches in the timing run
    cfg_t = cfg._replace(t_target=k1.f32_target(T))
    k1_ms = cuda_ms(lambda: k1.run_chunk(seed, st, fill, 0, cfg_t), 20)
    k1_b = chunk_bound(cfg_t, st, fill, K * B)
    k1_plain_ms = cuda_ms(lambda: k1.run_chunk_plain(seed, st, fill, 0, cfg_t), 2)
    print(f"phase 14b horizon breakdown (B={B}, d={d}, f32): fill {fill_s:.4f} s over "
          f"{t_cap} rows ({complete} of {B} chains at T in it); K2 compaction "
          f"(T={t_cap}, W={1 + t_cap}) {k2_ms:.4f} ms vs plain {k2_plain_ms:.4f} ms, "
          f"bit-identical, bound {bound_text(k2_b)}; finalize (width {out_w}) "
          f"{fin_ms:.4f} ms; K1 horizon chunk (K={K}) {k1_ms:.4f} ms vs plain "
          f"{k1_plain_ms:.4f} ms, bound {bound_text(k1_b)}; f32 check at target "
          f"{cfg_c.t_target!r} ({froze:.3f} of the lanes reach it): kinds agree on "
          f"{agree:.6f}, max_abs_err {err:.3e} on the {share:.4f} of chains with equal "
          f"decisions (want >= {K1_F32_SHARE}); the others left at f32 rounding ties: "
          f"{'; '.join(texts) or 'none'}", flush=True)
    wall_ms = wall * 1e3
    k1_total = launches["zigzag_chunk_horizon"] * k1_ms
    k2_total = launches["compact_rows"] * k2_ms
    rest = wall_ms - k1_total - k2_total - fin_ms
    print(f"phase 14c horizon time split of the median warm call ({wall_ms:.4f} ms): K1 "
          f"{launches['zigzag_chunk_horizon']} x {k1_ms:.4f} = {k1_total:.4f} ms "
          f"({k1_total / wall_ms:.1%}); K2 {launches['compact_rows']} x {k2_ms:.4f} = "
          f"{k2_total:.4f} ms ({k2_total / wall_ms:.1%}); finalize {fin_ms:.4f} ms "
          f"({fin_ms / wall_ms:.1%}); rest (host, card idle) {rest:.4f} ms "
          f"({rest / wall_ms:.1%})", flush=True)
    return k1_ms, k1_plain_ms, k1_b, k2_err, err


def phase_horizon_checks(card_name):
    """Time-horizon runs of the sticky, BPS and ECMC deployments (about 256
    events per chain), their contracts checked; each path's horizon-mode
    kernel timed per K=32 launch at its shape beside its plain version.
    Returns {launch name: (launches, ms, plain ms, bound)}."""
    d_s, B_s, _, kappa = STICKY
    bps, _, x_b, v_b = bps_deployment()
    d_e, B_e, _ = ECMC_D10
    cases = [
        ("sticky", pt.StickyZigZagAD(d_s, pt.potentials.gauss, np.full(d_s, kappa)),
         np.full((B_s, d_s), 0.3), np.ones((B_s, d_s))),
        ("bps", bps, x_b, v_b),
        ("ecmc", pt.ForwardECMCAD(d_e, pt.potentials.gauss),
         np.random.default_rng(12).normal(size=(B_e, d_e)), np.full((B_e, d_e), d_e ** -0.5)),
    ]
    out, parts = {}, []
    for name, sampler, x0, v0 in cases:
        T, sticky = HORIZON_CHECK_T[name], name == "sticky"
        B, d = x0.shape
        launch = ("sticky_chunk" if sticky else k3.launch_name(name)) + "_horizon"
        build.reset_launches()
        t0 = time.perf_counter()
        skel = pt.sample_skeleton(sampler, T, x0, v0, seed=0, dtype=torch.float32, device=DEV)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        if launches[launch] < 1 or launches["compact_rows"] < 1:
            raise AssertionError(f"{name} horizon run missed a kernel: {launches}")
        events = check_horizon_skeleton(f"{name} horizon", skel, T)
        extra = ""
        if sticky:
            rows, last = torch.arange(B, device=DEV), skel.n_valid.long() - 1
            stuck = ~skel.is_active[rows, last]
            if not bool(stuck.any()) or not bool((skel.x[rows, last][stuck] == 0.0).all()):
                raise AssertionError("sticky horizon: no frozen coordinate at the terminal "
                                     "rows, or one not at exactly 0.0")
            extra = f", {int(stuck.sum())} frozen coordinates at exactly 0.0 in the terminal rows"
        if name == "ecmc":
            valid = (torch.arange(skel.t.shape[1], device=DEV)[None, :]
                     < skel.n_valid[:, None])
            speed = torch.linalg.norm(skel.v.double(), dim=-1)[valid]
            if float((speed - 1.0).abs().max()) > 1e-5:
                raise AssertionError("ECMC horizon: |v| off 1")
            extra = ", |v| == 1 within 1e-5"
        del skel
        state = sampler.init_state_batch(x0, v0, 0, torch.float32, DEV)
        # a target no lane reaches in the timing run
        cfg = card_config(sampler, 32, 1 << 30, torch.float32)._replace(
            t_target=k1.f32_target(1e6))
        st = driver.chunk_state(state, torch.zeros(B, dtype=torch.int32, device=DEV), sticky)
        fill = k1.empty_fill(32, d, B, torch.float32, DEV, sticky)
        run, plain = ((k1.run_chunk, k1.run_chunk_plain) if sticky
                      else (k3.run_chunk, k3.run_chunk_plain))
        ms = cuda_ms(lambda: run(7, st, fill, 0, cfg), 10)
        b = chunk_bound(cfg, st, fill, 32 * B)
        plain_ms = cuda_ms(lambda: plain(7, st, fill, 0, cfg), 1)
        out[launch] = (launches[launch], ms, plain_ms, b)
        parts.append(f"{name} d={d} B={B} T={T}: {events / B:.1f} events per chain, "
                     f"{launches[launch]} {launch} launches, {wall:.4f} s (first call){extra}; "
                     f"{launch} (K=32) {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
                     f"{bound_text(b)}")
    print(f"phase 15 horizon checks (f32; every chain ends at t == T with EV_TERMINAL, no "
          f"kept row past T, t non-decreasing): {'; '.join(parts)} ({card_name})", flush=True)
    return out


# the envelope's edges (one grid point per lane; lanes owning two, lane 31
# handing its pair across); at two grid points the default horizon leaves the
# envelope so loose that 64 transitions see no event, hence a shorter tmax
K4_GRID_CASES = [("gauss", dict(grid_size=2, tmax=0.1)), ("banana", dict(grid_size=33)),
                 ("gauss", dict(grid_size=64, signed_bound=False))]
# 4 chains' f64 x and v exceed a block's 227 KB of shared memory; at this d the
# default horizon rejects every proposal of a short run, hence tmax = 0.01
K4_IN_PLACE_D = 3700


def phase_k4():
    """K4, the Speed-Up Zig-Zag chunk kernel, against its plain version from
    one f64 state (:func:`k1_compare`, bit for bit), in events and in horizon
    mode (K7), and at the grid sizes of ``K4_GRID_CASES``; returns the max
    abs err of each mode."""
    errs, parts = {}, []
    cases = [(h, pot, {}, 1024) for h in (False, True) for pot in ("gauss", "banana")]
    cases += [(False, pot, kw, 512) for pot, kw in K4_GRID_CASES]
    for horizon, pot, kw, B in cases:
        name = "suzz_chunk" + ("_horizon" if horizon else "")
        e, n, share = k1_compare(10, B, 32, 2, pot, horizon=horizon, suzz=True, **kw)
        errs[name] = max(errs.get(name, 0.0), e)
        at = f", {share:.3f} of the lanes at the target" if horizon else ""
        parts.append(f"{'horizon' if horizon else 'events'} {pot} d=10 B={B} {kw or ''} "
                     f"max_abs_err={e:.3e} ({n} events{at})")
    # past the shared memory of a block K4 reads x and v in place
    e, n, _ = k1_compare(K4_IN_PLACE_D, 8, 4, 1, "gauss", suzz=True, tmax=0.01)
    errs["suzz_chunk"] = max(errs["suzz_chunk"], e)
    parts.append(f"events gauss d={K4_IN_PLACE_D} B=8 K=4 tmax=0.01 (x and v in place) "
                 f"max_abs_err={e:.3e} ({n} events)")
    print(f"phase 16 K4 vs plain (f64, 2 x K=32): {'; '.join(parts)}; ints equal, floats "
          "bit for bit", flush=True)
    return errs


def suzz_deployment():
    """suzz_gauss_d10 (benchmarks/run_baselines.py:137-140 at scale 1, x0 = 0,
    v0 = 1 as at :193-200)."""
    d, B, _ = SUZZ_D10
    return pt.SpeedUpZigZagAD(d, pt.potentials.gauss), np.zeros((B, d)), np.ones((B, d))


def phase_suzz(card_name):
    """The suzz_gauss_d10 deployment: one warm call, then five timed warm
    calls, the first of them counted and checked (:func:`tag_calls`).
    Returns the sampler, the counted launches, the median wall time and phase
    18's horizon: the median clock at ``SUZZ_HORIZON_EVENTS`` events, to
    three digits."""
    d, B, n_sk = SUZZ_D10
    sampler, x0, v0 = suzz_deployment()
    skel, launches, walls = tag_calls("Speed-Up Zig-Zag path", sampler, n_sk, x0, v0,
                                      SUZZ_CALLS)
    if launches["suzz_chunk"] < 1 or launches["compact_rows"] < 1:
        raise AssertionError(f"Speed-Up Zig-Zag path missed a kernel: {launches}")
    mean, var = pt.pooled_moments(skel, sampler, 256)
    if not moments_ok(mean, var):
        raise AssertionError(f"Speed-Up Zig-Zag moments off: mean {mean.tolist()} "
                             f"var {var.tolist()}")
    events = int(skel.n_valid.sum()) - B
    T = float(f"{float(skel.t[:, SUZZ_HORIZON_EVENTS].median()):.3g}")
    del skel
    print(f"phase 17 suzz_gauss_d10: SpeedUpZigZagAD({d}, gauss) B={B} n_sk={n_sk} f32 "
          f"events={events} launches={launches}; complete, t non-decreasing and finite, "
          f"max|mean|={float(mean.abs().max()):.4f} max|var-1|="
          f"{float((var - 1).abs().max()):.4f}; {walls_text(walls, events)} ({card_name})",
          flush=True)
    return sampler, launches, float(np.median(walls)), T


def phase_suzz_breakdown(sampler, launches, wall):
    """The Speed-Up Zig-Zag path's fill and compaction timed apart, one f32
    K=32 chunk of K4 against its plain version, and the median warm call's
    split (:func:`tag_breakdown`).  Returns (K4 ms, plain ms, bound, K2
    err, f32 err)."""
    _, x0, v0 = suzz_deployment()
    ms, plain_ms, b, k2_err, _, _, _, err, _ = tag_breakdown(
        "phase 17b suzz_gauss_d10", sampler, x0, v0, SUZZ_D10[2], launches, wall,
        K4_F32_SHARE)
    return ms, plain_ms, b, k2_err, err


def phase_suzz_horizon(card_name, sampler, T):
    """A time-horizon run of the suzz_gauss_d10 deployment at phase 17's ``T``
    (about ``SUZZ_HORIZON_EVENTS`` events per chain) with the time-horizon
    contracts of phase 14; K4's horizon mode timed per K=32 launch at this
    shape beside its plain version.  Returns (launches, ms, plain ms,
    bound)."""
    d, B, _ = SUZZ_D10
    _, x0, v0 = suzz_deployment()
    build.reset_launches()
    t0 = time.perf_counter()
    skel = pt.sample_skeleton(sampler, T, x0, v0, seed=0, dtype=torch.float32, device=DEV)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if launches["suzz_chunk_horizon"] < 1 or launches["compact_rows"] < 1:
        raise AssertionError(f"Speed-Up Zig-Zag horizon run missed a kernel: {launches}")
    events = check_horizon_skeleton("Speed-Up Zig-Zag horizon", skel, T)
    del skel
    state = sampler.init_state_batch(x0, v0, 0, torch.float32, DEV)
    # a target no lane reaches in the timing run
    cfg = driver.chunk_config(sampler, 32, 1 << 30, 128)._replace(t_target=k1.f32_target(1e6))
    st = driver.chunk_state(state, torch.zeros(B, dtype=torch.int32, device=DEV))
    fill = k1.empty_fill(32, d, B, torch.float32, DEV)
    ms = cuda_ms(lambda: k1.run_chunk(7, st, fill, 0, cfg), 10)
    b = chunk_bound(cfg, st, fill, 32 * B)
    plain_ms = cuda_ms(lambda: k1.run_chunk_plain(7, st, fill, 0, cfg), 1)
    n = launches["suzz_chunk_horizon"]
    print(f"phase 18 suzz_gauss_d10 time horizon: T={T} (phase 17's median clock at "
          f"{SUZZ_HORIZON_EVENTS} events) B={B} f32: {events / B:.1f} events per chain, "
          f"{n} suzz_chunk_horizon launches, {launches['compact_rows']} K2, {wall:.4f} s "
          f"(first call); every chain ends at t == T with EV_TERMINAL, no kept row past T, "
          f"t non-decreasing; suzz_chunk_horizon (K=32) {ms:.4f} ms vs plain "
          f"{plain_ms:.4f} ms, bound {bound_text(b)} ({card_name})", flush=True)
    return n, ms, plain_ms, b

class DeviceTimes:
    """CUDA events around every call of ``owner.name`` while the context is
    open (``fold``: the function ``owner.name`` returns is wrapped instead).
    The events are recorded on the current stream and read after the run,
    so the timing adds no synchronisation."""

    def __init__(self, owner, name, fold=False):
        self.owner, self.name, self.fold, self.pairs = owner, name, fold, []

    def _timed(self, fn):
        def run(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **k)
            end.record()
            self.pairs.append((start, end))
            return out

        return run

    def __enter__(self):
        self.orig = getattr(self.owner, self.name)
        if self.fold:
            setattr(self.owner, self.name,
                    lambda *a, **k: self._timed(self.orig(*a, **k)))
        else:
            setattr(self.owner, self.name, self._timed(self.orig))
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)

    def total_ms(self):
        sync()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def stream_kernel_check(what, sampler, state, share_min, seed=7):
    """One K=32 horizon chunk of the path's kernel from ``state`` (f32) held
    against its plain version as :func:`compare_f32` states, the target at
    the median clock one chunk reaches; then the kernel's time at this shape
    by CUDA events beside the plain version's, and its bound.  Returns (max
    abs err, ms, plain ms, bound, text)."""
    B = state.x.shape[0]
    cfg = driver.chunk_config(sampler, 32, 1 << 30, 128)
    if cfg.sticky:
        cfg = cfg._replace(kappa=cfg.kappa.to(DEV, torch.float32))
    st = driver.chunk_state(state, torch.zeros(B, dtype=torch.int32, device=DEV), cfg.sticky)
    cfg_c = cfg._replace(t_target=median_target(k1.run_chunk, st, cfg, 32, 1, seed))
    st_p = clone_state(st)
    v0 = st.v.clone()
    d = st.x.shape[0]
    fill, fill_p = (k1.empty_fill(32, d, B, torch.float32, DEV, cfg.sticky) for _ in range(2))
    k1.run_chunk(seed, st, fill, 0, cfg_c)
    k1.run_chunk_plain(seed, st_p, fill_p, 0, cfg_c)
    sync()
    agree, share, err, texts = compare_f32(what, v0, st, fill, st_p, fill_p, cfg_c, seed,
                                           share_min)
    froze = target_share(st, cfg_c)
    del st_p, fill_p
    cfg_t = cfg._replace(t_target=k1.f32_target(1e6))  # no lane reaches it while timed
    ms = cuda_ms(lambda: k1.run_chunk(seed, st, fill, 0, cfg_t), 10)
    b = chunk_bound(cfg_t, st, fill, 32 * B)
    plain_ms = cuda_ms(lambda: k1.run_chunk_plain(seed, st, fill, 0, cfg_t), 1)
    text = (f"{what} (K=32, target {cfg_c.t_target!r}, {froze:.3f} of the lanes reach it): "
            f"kinds agree on {agree:.6f}, max_abs_err {err:.3e} on the {share:.4f} of chains "
            f"with equal decisions (want >= {share_min}); the others left at f32 rounding "
            f"ties: {'; '.join(texts) or 'none'}; {ms:.4f} ms alone vs plain {plain_ms:.4f} "
            f"ms, bound {bound_text(b)}")
    return err, ms, plain_ms, b, text


def timed_stream_run(sampler, T, x0, v0, launch, **kw):
    """``sample_streaming_stats`` on the card with its launches counted from
    zero, its kernel's launches and its folds timed by CUDA events in the
    run.  Returns (run, wall s, launches, kernel ms, fold ms, folds)."""
    sync()
    build.reset_launches()
    with DeviceTimes(k1, "run_chunk") as kt, \
            DeviceTimes(streaming, "make_fold_chunk", fold=True) as ft:
        t0 = time.perf_counter()
        run = pt.sample_streaming_stats(sampler, T, x0, v0, dtype=torch.float32, device=DEV,
                                        **kw)
        sync()
        wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if launches[launch] < 1:
        raise AssertionError(f"the streaming run missed {launch}: {launches}")
    if launches[launch] != len(kt.pairs):
        raise AssertionError(f"{launch}: {launches[launch]} counted, {len(kt.pairs)} timed")
    return run, wall, launches, kt.total_ms(), ft.total_ms(), len(ft.pairs)


def split_text(wall, launch, n, k_ms, alone_ms, fold_ms, folds):
    """The call split into the kernel (its launches at the time one launch
    takes alone), the folds (CUDA events around each fold in the run) and the
    rest; ``k_ms`` is the kernel's launches timed inside the run, each window
    also holding the launch's host preparation while the card waits."""
    wall_ms = wall * 1e3
    kern = n * alone_ms
    rest = wall_ms - kern - fold_ms
    return (f"split of the {wall_ms:.1f} ms call: {launch} {n} x {alone_ms:.4f} = "
            f"{kern:.1f} ms ({kern / wall_ms:.1%}); fold {folds} x {fold_ms / folds:.4f} = "
            f"{fold_ms:.1f} ms ({fold_ms / wall_ms:.1%}); rest (host, card idle) "
            f"{rest:.1f} ms ({rest / wall_ms:.1%}); {launch} windows in the run "
            f"{k_ms / n:.4f} ms per launch ({k_ms:.1f} ms)")


def sticky_stream_deployment():
    B, d, kappa = STREAM_STICKY[:3]
    return (pt.StickyZigZagAD(d, pt.potentials.gauss, np.full(d, kappa)),
            np.full((B, d), 0.3), np.ones((B, d)))


def sticky_stream_gates(run, summ, T, kappa):
    """{gate text: passed} of the gated sticky run: every chain at T, split-R-hat,
    the pooled mean, the mean pooled variance against 1 - w and the final
    frozen share against w = p(0) / (kappa + p(0)), p(0) = 1 / sqrt(2 pi)."""
    w = 1.0 / np.sqrt(2.0 * np.pi) / (kappa + 1.0 / np.sqrt(2.0 * np.pi))
    frozen = 1.0 - float(run.state.is_active.float().mean())
    mean_max = float(np.abs(summ["pooled_mean"]).max())
    var_mean = float(summ["pooled_var"].mean())
    return {"every chain at T": bool((run.state.t >= np.float32(T)).all()),
            f"rhat_max {summ['rhat_max']:.4f} < {pt.diagnostics.RHAT_THRESHOLD}":
            summ["converged"],
            f"max|pooled mean| {mean_max:.4f} < 0.05": mean_max < 0.05,
            f"mean pooled var {var_mean:.4f} within 0.01 of 1 - w = {1 - w:.4f}":
            abs(var_mean - (1 - w)) < 0.01,
            f"frozen share {frozen:.4f} within 0.005 of w = {w:.4f}": abs(frozen - w) < 0.005}


def phase_stream_sticky(card_name):
    """sticky_zigzag_d1000_streaming: the calibration run, then the gated run
    to T (no early stop), timed and split; its five gates; then K6's horizon
    mode checked against its plain version at this shape.  Returns (K6
    launches, ms per launch in the run, plain ms, max abs err, bound, the
    calibrated rate)."""
    B, d, kappa, cal_events, events_goal, n_samples, n_batches = STREAM_STICKY
    torch.cuda.empty_cache()  # the fill size follows the card's free memory
    sampler, x0, v0 = sticky_stream_deployment()
    T_cal = cal_events / (0.5 * d)
    t0 = time.perf_counter()
    cal = pt.sample_streaming_stats(sampler, T_cal, x0, v0, n_samples=1024, n_batches=16,
                                    seed=1, dtype=torch.float32, device=DEV)
    sync()
    cal_wall = time.perf_counter() - t0
    rate = cal.events / B / T_cal
    T = events_goal / rate
    sampler, x0, v0 = sticky_stream_deployment()
    run, wall, launches, k_ms, fold_ms, folds = timed_stream_run(
        sampler, T, x0, v0, "sticky_chunk_horizon", n_samples=n_samples,
        n_batches=n_batches, seed=2)
    summ = pt.streaming_summary(run)
    gates = sticky_stream_gates(run, summ, T, kappa)
    failed = [g for g, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"sticky_zigzag_d1000_streaming gates failed: {failed}")
    n = launches["sticky_chunk_horizon"]
    err, ms, plain_ms, b, check = stream_kernel_check(
        "K6 horizon f32", sampler, sampler.init_state_batch(x0, v0, 2, torch.float32, DEV),
        K6_F32_SHARE)
    print(f"phase 19 sticky_zigzag_d1000_streaming: StickyZigZagAD({d}, gauss, kappa={kappa}) "
          f"B={B} f32; calibration T={T_cal:.4g} {cal.events} events {cal.fills} fills "
          f"{cal_wall:.2f} s, rate {rate:.2f} events per chain per unit time; gated run T={T:.6g} "
          f"n_samples={n_samples} n_batches={n_batches}: {run.events} events "
          f"({run.events / B:.0f} per chain), {run.fills} fills, wall {wall:.3f} s, events/s "
          f"{run.events / wall:.1f}, ESS/s of the worst coordinate "
          f"{summ['ess_total_worst_coord'] / wall:.2f} (ESS {summ['ess_total_worst_coord']:.1f}); "
          f"gates: {'; '.join(gates)}; {split_text(wall, 'K6', n, k_ms, ms, fold_ms, folds)}; "
          f"launches {launches}; {check} ({card_name})", flush=True)
    return n, ms, plain_ms, err, b, rate


def phase_stream_banana(card_name):
    """zigzag_banana_d50_streaming: calibration at T = 50, grid_chunk from the
    script's formula, one warm run (seed 2), then the timed run (seed 3) with
    stop_when_converged and check_every=1, split; its gates; K1's horizon
    mode checked against its plain version at this shape."""
    B, d, T_cal, budget, n_samples, n_batches = STREAM_BANANA
    torch.cuda.empty_cache()

    def make():
        return pt.ZigZag(d, pt.potentials.grad_banana, grid_size=0)

    x0, v0 = np.ones((B, d)), np.ones((B, d))
    cal = pt.sample_streaming_stats(make(), T_cal, x0, v0, n_samples=1024, n_batches=16,
                                    seed=1, dtype=torch.float32, device=DEV)
    rate = cal.events / B / T_cal
    T = budget / rate
    # exp_streaming_banana50.py:82-91: the fold window sized to the grid
    # points one 8192-row fill covers
    points_per_fill = n_samples * (8192 / (rate * 1.1)) / T
    G = int(min(8192, max(512, 1.3 * points_per_fill)))
    kw = dict(n_samples=n_samples, n_batches=n_batches, stop_when_converged=True,
              check_every=1, grid_chunk=G)
    sampler = make()
    pt.sample_streaming_stats(sampler, T, x0, v0, seed=2, dtype=torch.float32, device=DEV,
                              **kw)
    run, wall, launches, k_ms, fold_ms, folds = timed_stream_run(
        sampler, T, x0, v0, "zigzag_chunk_horizon", seed=3, **kw)
    summ = pt.streaming_summary(run)
    truth = np.concatenate([[1.0, 3.0], np.ones(d - 2)])
    mean_max = float(np.abs(summ["pooled_mean"]).max())
    var_rel = float(np.abs(summ["pooled_var"] / truth - 1.0).max())
    if not (summ["converged"] and mean_max < 0.1 and var_rel < 0.1):
        raise AssertionError(f"zigzag_banana_d50_streaming: converged={summ['converged']} "
                             f"rhat_max={summ['rhat_max']:.4f} max|mean|={mean_max:.4f} "
                             f"max|var/truth-1|={var_rel:.4f}")
    n = launches["zigzag_chunk_horizon"]
    err, ms, plain_ms, b, check = stream_kernel_check(
        "K1 horizon f32", sampler, sampler.init_state_batch(x0, v0, 3, torch.float32, DEV),
        K1_F32_SHARE)
    print(f"phase 20 zigzag_banana_d50_streaming: ZigZag({d}, grad_banana, grid_size=0) B={B} "
          f"f32; calibration rate {rate:.3f} events per chain per unit time, T budget "
          f"{T:.6g}, grid_chunk {G}; timed run (seed 3, stop_when_converged, check_every=1): "
          f"{run.events} events ({run.events / B:.0f} per chain), {run.fills} fills, wall "
          f"{wall:.3f} s, events/s {run.events / wall:.1f}, ESS/s of the worst coordinate "
          f"{summ['ess_total_worst_coord'] / wall:.2f} (ESS "
          f"{summ['ess_total_worst_coord']:.1f}); converged, rhat_max {summ['rhat_max']:.4f}, "
          f"max|pooled mean| {mean_max:.4f} < 0.1, max|pooled var / (1, 3, 1, ...) - 1| "
          f"{var_rel:.4f} < 0.1; {split_text(wall, 'K1', n, k_ms, ms, fold_ms, folds)}; "
          f"launches {launches}; {check} ({card_name})", flush=True)
    return n, ms, plain_ms, err, b, (T, x0, v0, kw, run)


def injected(fn):
    """``fn()`` with ``PDMPFLUX_FAIL_AFTER_FILLS`` set by the caller: it must
    raise the injected failure and nothing else."""
    try:
        fn()
    except RuntimeError as e:
        if "fault injection" not in str(e):
            raise
    else:
        raise AssertionError("the injected failure did not fire")


def resume_check(what, run, every, fail_after, tmp):
    """``run(checkpoint_path, every)`` unbroken (its launches counted), then
    interrupted after ``fail_after`` fills, then resumed from its file.
    Returns the unbroken and the resumed result, the unbroken run's launches
    and the checkpoint's size in bytes."""
    build.reset_launches()
    ref = run(None, every)
    launches = dict(build.LAUNCHES)
    path = os.path.join(tmp, f"{what}.npz")
    os.environ["PDMPFLUX_FAIL_AFTER_FILLS"] = str(fail_after)
    try:
        injected(lambda: run(path, every))
    finally:
        del os.environ["PDMPFLUX_FAIL_AFTER_FILLS"]
    size = os.path.getsize(path)
    return ref, run(path, every), launches, size


def skeletons_equal(what, a, b):
    for f, x, y in zip(pt.Skeleton._fields, a, b):
        if x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{what}: the resumed skeleton's {f} differs")


def phase_checkpoints(card_name, rate):
    """Checkpoint/resume on the card, every resume bit for bit: (a) the
    sticky d = 1000 event-count deployment at 512-row fills, (b)
    zigzag_gauss_d10_horizon at ~256 events per chain, (c) a streaming run of
    phase 19's sampler (at its calibrated ``rate``) interrupted after 16 fills;
    then (d) sample_skeleton_with_diagnostic's RV against RV_diagnostic on a
    host copy of its skeleton."""
    parts = []
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        d, B, n_sk, kappa = STICKY
        x0, v0 = np.full((B, d), 0.3), np.ones((B, d))

        def sticky_run(path, every):
            s = pt.StickyZigZagAD(d, pt.potentials.gauss, np.full(d, kappa))
            return pt.sample_skeleton(s, n_sk, x0, v0, seed=0, dtype=torch.float32,
                                      device=DEV, t_cap=CK_STICKY_T_CAP,
                                      checkpoint_path=path, checkpoint_every=every)

        ref, got, launches, size = resume_check("sticky_events", sticky_run, 1, 2, tmp)
        fills = -(-launches["sticky_chunk"] * 32 // CK_STICKY_T_CAP)
        skeletons_equal("21a sticky event count", got, ref)
        if not bool((ref.n_valid == n_sk).all()) or fills < 4:
            raise AssertionError(f"21a: the unbroken run is incomplete or took {fills} < 4 "
                                 "fills")
        parts.append(f"(a) StickyZigZagAD({d}) B={B} n_sk={n_sk} t_cap={CK_STICKY_T_CAP}: "
                     f"{fills} fills ({launches['sticky_chunk']} K6 launches), interrupted "
                     f"after 2, resumed bit for bit (checkpoint {size / 2**30:.2f} GiB)")
        del ref, got

        Bh, T, cap = CK_HORIZON
        zz = pt.ZigZagAD(10, pt.potentials.gauss)
        xh, vh = np.zeros((Bh, 10)), np.ones((Bh, 10))

        def horizon_run(path, every):
            return pt.sample_skeleton(zz, T, xh, vh, seed=0, dtype=torch.float32, device=DEV,
                                      init_capacity=cap, checkpoint_path=path,
                                      checkpoint_every=every)

        ref, got, launches, size = resume_check("horizon", horizon_run, 1, 2, tmp)
        skeletons_equal("21b horizon", got, ref)
        events = check_horizon_skeleton("21b horizon", ref, T)
        parts.append(f"(b) zigzag_gauss_d10_horizon B={Bh} T={T} init_capacity={cap}: "
                     f"{events / Bh:.1f} events per chain ({launches['zigzag_chunk_horizon']} "
                     f"K1 launches), interrupted after 2 fills, resumed bit for bit "
                     f"(checkpoint {size / 2**20:.1f} MiB)")
        del ref, got

        ev, n_samples, n_batches, every, fail = CK_STREAM
        Ts = ev / rate

        def stream_run(path, every):
            s, xs, vs = sticky_stream_deployment()
            return pt.sample_streaming_stats(s, Ts, xs, vs, n_samples=n_samples,
                                             n_batches=n_batches, seed=4, dtype=torch.float32,
                                             device=DEV, checkpoint_path=path,
                                             checkpoint_every=every)

        ref, got, launches, size = resume_check("stream", stream_run, every, fail, tmp)
        if ref.fills < 4 * every:
            raise AssertionError(f"21c: the run took {ref.fills} fills, under four groups")
        for f, a, b in zip(streaming.StreamingStats._fields, got.stats, ref.stats):
            if not torch.equal(a, b):
                raise AssertionError(f"21c: the resumed accumulator {f} differs")
        if (got.events, got.fills) != (ref.events, ref.fills):
            raise AssertionError(f"21c: events/fills {got.events}/{got.fills} vs "
                                 f"{ref.events}/{ref.fills}")
        parts.append(f"(c) streaming StickyZigZagAD({STREAM_STICKY[1]}) T={Ts:.4g} ({ref.events / B:.0f} "
                     f"events per chain) n_samples={n_samples} n_batches={n_batches} "
                     f"checkpoint_every={every}: {ref.fills} fills, interrupted after {fail}, "
                     f"resumed: accumulators, events and fills bit for bit (checkpoint "
                     f"{size / 2**20:.1f} MiB)")
        del ref, got

    d, B, T, cap = HORIZON_D10
    sampler, x0, v0 = horizon_deployment()
    skel, rv = pt.sample_skeleton_with_diagnostic(
        sampler, T, x0, v0, pt.potentials.gauss, B=RV_BATCHES, seed=0, dtype=torch.float32,
        device=DEV, init_capacity=cap)
    host = pt.Skeleton(*(a.cpu() for a in skel))
    ref = pt.RV_diagnostic(host, pt.potentials.gauss, RV_BATCHES)
    if not (rv.device.type == DEV.type and rv.shape == (B,)
            and bool(torch.isfinite(rv).all())):
        raise AssertionError("21d: the RV is not a finite (B,) tensor on the card")
    if not torch.allclose(rv.cpu(), ref, rtol=1e-4, atol=0):
        raise AssertionError(f"21d: RV off by {float((rv.cpu() / ref - 1).abs().max()):.3e}")
    parts.append(f"(d) sample_skeleton_with_diagnostic at zigzag_gauss_d10_horizon (B={B}, "
                 f"T={T}, U=gauss, {RV_BATCHES} batches): RV per chain mean "
                 f"{float(rv.mean()):.4f}, within rtol 1e-4 of RV_diagnostic on the host copy "
                 f"(max rel diff {float((rv.cpu() / ref - 1).abs().max()):.2e})")
    print(f"phase 21 checkpoint/resume and RV on the card (f32): {'; '.join(parts)} "
          f"({card_name})", flush=True)


# ---------------------------------------------------------------------------
# Phases 22-25: the transition engine (core/engine.py), plain torch on the
# card, with K2 compacting every fill
# ---------------------------------------------------------------------------

ENGINE_AGREE = (256, 10, 32)   # phase 22: chains, d, transitions per family (cut from 256
                               # for 43's time, from 128 for 44's, from 64 for 45's)
ENGINE_SHARE = 0.99            # phase 22: chains that must take every decision alike
ENGINE_RTOL = {"zigzag_fd": 1e-6, "ecmc_normal": 1e-6}  # phase 22: else 1e-9
ENGINE_FAMILIES = {            # phase 22: one case per family, f64 on the Gaussian
    "zigzag_scalar": lambda d: pt.ZigZagAD(d, pt.potentials.gauss, vectorized_bound=False),
    "zigzag_vect": lambda d: pt.ZigZagAD(d, pt.potentials.gauss),
    "zigzag_const": lambda d: pt.ZigZagAD(d, pt.potentials.gauss, grid_size=0),
    "zigzag_fd": lambda d: pt.ZigZagAD(d, pt.potentials.gauss, AD_backend="FiniteDiff"),
    "sticky_scalar": lambda d: pt.StickyZigZagAD(d, pt.potentials.gauss, np.full(d, 0.7),
                                                 vectorized_bound=False),
    "sticky_vect": lambda d: pt.StickyZigZagAD(d, pt.potentials.gauss, np.full(d, 0.7)),
    "suzz": lambda d: pt.SpeedUpZigZagAD(d, pt.potentials.gauss),
    "bps": lambda d: pt.BPSAD(d, pt.potentials.gauss, refresh_rate=0.5),
    "boomerang": lambda d: pt.BoomerangAD(d, pt.potentials.gauss, refresh_rate=0.5),
    "ecmc_switch": lambda d: pt.ForwardECMCAD(d, pt.potentials.gauss),
    "ecmc_refresh": lambda d: pt.ForwardECMCAD(d, pt.potentials.gauss, switch=False),
    "ecmc_normal": lambda d: pt.ForwardECMCAD(d, pt.potentials.gauss, normal=True, ran_p=True),
    "rhmc": lambda d: pt.RHMCAD(d, pt.potentials.gauss),
}
RHMC_D10 = (10, 512, 256, 1.0)   # d, chains, points (cut from 1024 for phase 45's
                                 # time, from 512 for 46's), refresh: rhmc_gauss_d10
RHMC_CALLS = 1                   # timed warm calls of the RHMC path (3 before phase 33)
RHMC_HORIZON_T = 200.0           # its time-horizon call (~200 events per chain)
BANANA_D10 = (10, 512, 1024)     # d, chains, points (cut from 4096, and from 2048 for phase
                                 # 44's time): zigzag_banana_d10_fd / _jvp
ROUTE_STREAM = (512, 10, 300.0, 1024, 32)  # phase 25: chains, d, T, grid, windows


class OpCount(TorchDispatchMode):
    """Counts the torch ops dispatched inside it (views included)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class OpTrace(TorchDispatchMode):
    """Records every torch op dispatched inside it: its name and host copies
    of its tensor inputs (before it runs) and outputs.  Fresh allocations
    are zeroed, so that memory the op will overwrite compares equal."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        def copies(tree):
            if isinstance(tree, (tuple, list)):
                return [c for a in tree for c in copies(a)]
            if isinstance(tree, torch.Tensor) and not tree.is_meta:
                return [tree.detach().to("cpu", copy=True)]
            return []

        ins = copies(list(args) + list((kwargs or {}).values()))
        out = func(*args, **(kwargs or {}))
        if "empty" in str(func):  # no garbage: equal allocations on both devices
            out.zero_()
        self.ops.append((str(func), ins, copies(out)))
        return out


def bit_equal(a, b):
    """Per element: ``a`` and ``b`` hold the same bits (NaN equals NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return torch.zeros((), dtype=torch.bool)
    if a.is_floating_point():
        return (a == b) | (a.isnan() & b.isnan())
    return a == b


def first_bit_differences(sampler, state, t_max):
    """One transition of ``state`` (CPU, f64) on the CPU and on the card,
    every dispatched op recorded: the ops whose card output differs in some
    bit from the CPU's although their inputs were bit-equal (the ops that
    originate a card/CPU difference; every other difference is carried), as
    ``{op: (elements, largest ulp distance)}``, the first of them with one
    element's input, card and CPU values, and the ops that only one device
    dispatches (the two sequences are aligned by op name with ``difflib``)."""
    traces = []
    for dev in ("cpu", DEV):
        st = type(state)(*(a.to(dev) for a in state))
        with OpTrace() as tr:
            engine.make_transition(sampler)(st, t_max)
        traces.append(tr.ops)
    cpu_ops, card_ops = traces
    names = [[o[0] for o in ops] for ops in traces]
    blocks = difflib.SequenceMatcher(None, *names, autojunk=False).get_matching_blocks()
    pairs = [(blk.a + j, blk.b + j) for blk in blocks for j in range(blk.size)]
    one_side = {dev: dict(Counter(names[s]) - Counter(names[s][p[s]] for p in pairs))
                for s, dev in enumerate(("CPU", "card"))}
    origins, first = {}, None
    for i, j in pairs:
        (name, ins_c, outs_c), (_, ins_k, outs_k) = cpu_ops[i], card_ops[j]
        if not all(bool(bit_equal(a, b).all()) for a, b in zip(ins_c, ins_k)):
            continue
        for oc, ok in zip(outs_c, outs_k):
            same = bit_equal(oc, ok)
            if bool(same.all()):
                continue
            ulp = 0
            if oc.dtype == torch.float64 and oc.shape == ok.shape:
                ulp = int((oc.view(torch.int64) - ok.view(torch.int64)).abs().max())
            n_el, worst = origins.get(name, (0, 0))
            origins[name] = (n_el + int((~same).sum()), max(worst, ulp))
            if first is None:
                e = int((~same).reshape(-1).nonzero()[0, 0])
                arg = ", ".join(f"{float(a.reshape(-1)[e]):.17g}" for a in ins_c
                                if a.is_floating_point() and a.shape == oc.shape)
                first = (f"op {i} of {len(cpu_ops)} {name}({arg or '...'}) = card "
                         f"{float(ok.reshape(-1)[e]):.17g}, CPU {float(oc.reshape(-1)[e]):.17g}")
    return origins, first, one_side


def run_t_max(sampler, state, n):
    """The flow bound of ``n`` transitions from ``state``: the runner's host
    bound, here once for the run; None where the flow takes none."""
    if not sampler.flow_takes_bound:
        return None
    return float(torch.maximum(state.horizon, state.bound_h).max()) * (
        engine.HORIZON_GROW ** n if sampler.adaptive else 1.0)


def engine_run(sampler, state, n):
    """``n`` engine transitions of a batch from ``state``: every event
    stacked ``(n, B, ...)`` and each transition's input state (on the CPU)."""
    tr = engine.make_transition(sampler)
    evs, ins = [], []
    t_max = run_t_max(sampler, state, n)
    for _ in range(n):
        if state.x.device.type == "cpu":
            ins.append(state)
        state, ev = tr(state, t_max)
        evs.append(ev)
    return type(evs[0])(*(torch.stack(f) for f in zip(*evs))), ins


def engine_margin(sampler, s, k, b, ev):
    """The decision margins of chain ``b`` at transition ``k`` from its
    float64 input state ``s`` (CPU): the thinning uniform against the
    acceptance ratio, and for a flip the gap between the two best Gumbel
    scores; a rounding tie makes one of them ~1e-15."""
    one = type(s)(*(a[b:b + 1] for a in s))
    keys = rng.split(one.key, 6)
    u = float(rng.key_uniform(keys[:, 2], torch.float64)[0])
    ar = float(ev.ar[k, b])
    margins = [abs(u - ar) / max(abs(ar), 1e-300)]
    if hasattr(sampler, "_flip_rates"):
        x_new = ev.x[k, b:b + 1].cpu()
        lam = sampler._flip_rates(x_new, one.v, one.is_active)[0]
        u_g = rng.uniform_shaped(keys[:, 3], lam.shape, torch.float64,
                                 torch.finfo(torch.float64).tiny, 1.0)[0]
        score = torch.where(lam > 0, torch.log(torch.where(lam > 0, lam, torch.ones_like(lam))),
                            torch.full_like(lam, -float("inf"))) - torch.log(-torch.log(u_g))
        top = torch.topk(score, 2).values
        if bool(torch.isfinite(top).all()):
            margins.append(float((top[0] - top[1]).abs() / top[0].abs().clamp_min(1.0)))
    return min(margins)


def float_diffs(ev_k, ev_p, rtol):
    """Per (transition, chain) of two stacked event records: whether a float
    lies past ``rtol`` (atol 1e-12), the largest relative difference (over
    magnitudes of at least 1e-3), and per chain the largest absolute one."""
    n, B = ev_p.t.shape
    bad = torch.zeros((n, B), dtype=torch.bool)
    rel = torch.zeros((n, B), dtype=torch.float64)
    err = torch.zeros(B, dtype=torch.float64)
    for f in ("x", "v", "t", "horizon", "ar", "error_value_ar"):
        a, p = getattr(ev_k, f), getattr(ev_p, f)
        fin = torch.isfinite(p)
        mag = p.abs().where(fin, torch.zeros_like(p))
        diff = torch.where(fin, (a - p).abs(), torch.zeros_like(p))
        ok = (diff <= rtol * mag + 1e-12) & (torch.isfinite(a) == fin)
        bad |= ~ok.reshape(n, B, -1).all(2)
        rel = torch.maximum(rel, (diff / mag.clamp_min(1e-3)).reshape(n, B, -1).amax(2))
        err = torch.maximum(err, diff.reshape(n, B, -1).amax((0, 2)))
    return bad, rel, err


def phase_engine_agreement():
    """Phase 22: the engine on the card against the engine on the CPU, f64,
    from one state and keys, ``ENGINE_AGREE`` transitions per family.

    (a) Step by step: every input state of the CPU's run goes through the
    card's transition at once; each event and next state equals the CPU's,
    kinds exactly, floats to rtol 1e-9 (atol 1e-12), except where a decision
    margin below 1e-8 (a rounding tie) lets the card decide otherwise.
    (b) Free-running: at least ``ENGINE_SHARE`` of the chains take every
    decision alike (event kinds, activity) with every float of every event
    row within the family's rtol, and a chain that decides otherwise parts
    at a rounding tie: its decision margin lies below 1e-8, or below 10
    times the relative difference its floats had reached before.  The rtol
    is 1e-9, and 1e-6 (``ENGINE_RTOL``) for two families whose arithmetic
    widens the card's last-bit differences from the CPU over a run:
    finite-difference tangents (a step of sqrt(eps) max(1, |t|) turns one
    into a relative envelope difference of about 1e-8) and ECMC's normal
    variant (its speed sqrt(|v_o|^2 - rho^2) cancels).
    (c) Where those differences come from: the first free-running
    transition whose floats differ in any bit, run again from its input
    state on both devices with every op recorded
    (:func:`first_bit_differences`), printed, not gated.  Returns the largest float difference of (a)."""
    B, d, n = ENGINE_AGREE
    t_phase = time.perf_counter()
    rs = np.random.default_rng(22)
    texts, worst = [], 0.0
    for name, make in ENGINE_FAMILIES.items():
        sampler = make(d)
        x0 = rs.normal(size=(B, d))
        if name.startswith(("zigzag", "sticky", "suzz")):
            v0 = rs.choice([-1.0, 1.0], size=(B, d))
        else:
            v0 = rs.normal(size=(B, d))
            if name.startswith("ecmc"):
                v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
        st_cpu = sampler.init_state_batch(x0, v0, 22, torch.float64, "cpu")
        st_dev = type(st_cpu)(*(a.to(DEV) for a in st_cpu))
        ev_p, ins = engine_run(sampler, st_cpu, n)
        t0 = time.perf_counter()
        ev_k, _ = engine_run(sampler, st_dev, n)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / n
        with OpCount() as ops:
            engine.make_transition(sampler)(st_dev)
        sync()
        ev_k = type(ev_k)(*(a.cpu() for a in ev_k))

        # (a) step by step, every CPU input state through the card at once
        flat = type(st_cpu)(*(torch.cat(f).to(DEV) for f in zip(*ins)))
        t_max = None
        if sampler.flow_takes_bound:
            t_max = float(torch.maximum(flat.horizon, flat.bound_h).max())
        _, ev_s = engine.make_transition(sampler)(flat, t_max)
        ev_s = type(ev_s)(*(a.cpu().reshape((n, B) + a.shape[1:]) for a in ev_s))
        s_rtol = 1e-9
        s_bad, _, s_err = float_diffs(ev_s, ev_p, s_rtol)
        flips = (ev_s.kind != ev_p.kind) | (ev_s.is_active != ev_p.is_active).any(-1)
        for k, b in flips.nonzero().tolist():
            margin = engine_margin(sampler, ins[k], k, b, ev_p)
            if margin > 1e-8:
                raise AssertionError(f"phase 22 {name} step by step: transition {k} chain "
                                     f"{b} decides otherwise with a margin of {margin:.3e}")
        if bool((s_bad & ~flips).any()):
            k, b = (s_bad & ~flips).nonzero()[0].tolist()
            raise AssertionError(f"phase 22 {name} step by step: transition {k} chain {b} "
                                 f"differs past rtol {s_rtol:g}")
        worst = max(worst, float(s_err.max()))

        # (b) free-running
        rtol = ENGINE_RTOL.get(name, 1e-9)
        bad, rel, err = float_diffs(ev_k, ev_p, rtol)
        kinds_same = (ev_k.kind == ev_p.kind).all(0) & (ev_k.rejected == ev_p.rejected).all(0)
        decided = kinds_same & (ev_k.is_active == ev_p.is_active).reshape(n, B, -1).all(2).all(0)
        same = decided & ~bad.any(0)
        share = float(same.double().mean())
        parted, drifted = [], []
        for b in (~same).nonzero()[:, 0].tolist():
            if bool(decided[b]):  # every decision alike; floats past the rtol
                k = int(bad[:, b].nonzero()[0, 0])
                drifted.append(f"chain {b} from transition {k} (to {float(rel[:, b].max()):.1e})")
                continue
            k = int(((ev_k.kind[:, b] != ev_p.kind[:, b])
                     | (ev_k.is_active[:, b] != ev_p.is_active[:, b]).any(-1)).nonzero()[0, 0])
            pre = float(rel[:k, b].max()) if k else 0.0
            margin = engine_margin(sampler, ins[k], k, b, ev_p)
            if margin > max(1e-8, 10 * pre):
                raise AssertionError(f"phase 22 {name}: chain {b} parts at transition {k} "
                                     f"with a decision margin of {margin:.3e} after a float "
                                     f"difference of {pre:.1e}: not a tie")
            parted.append(f"chain {b} at transition {k} (margin {margin:.1e}, floats {pre:.1e} "
                          "apart before)")
        if share < ENGINE_SHARE:
            raise AssertionError(f"phase 22 {name}: only {share:.4f} of the chains agree at "
                                 f"rtol {rtol:g}; {'; '.join(parted + drifted)[:2000]}")
        # (c) where card and CPU first differ: the first free-running transition
        # with a float apart in any bit, traced from its (bit-equal) input state
        apart = torch.zeros(n, dtype=torch.bool)
        for f in ("x", "v", "t", "horizon", "ar", "error_value_ar"):
            apart |= (~bit_equal(getattr(ev_k, f), getattr(ev_p, f))).reshape(n, -1).any(1)
        k0 = int(apart.nonzero()[0, 0]) if bool(apart.any()) else 0
        origins, first, one_side = first_bit_differences(sampler, ins[k0],
                                                         run_t_max(sampler, st_cpu, n))
        origin_text = (", ".join(f"{op} x{n_el} (<= {ulp} ulp)"
                                 for op, (n_el, ulp) in origins.items())
                       + f"; first: {first}") if origins else "none"
        if any(one_side.values()):
            origin_text += f"; ops of one device only: {one_side}"
        jumps = int((ev_p.kind == pt.EV_JUMP).sum())
        texts.append(f"{name}: step by step max_abs_err {float(s_err.max()):.2e} at rtol "
                     f"{s_rtol:g}, {int(flips.sum())} tie decisions; free-running {share:.4f} "
                     f"of chains at rtol {rtol:g}, max_abs_err {float(err[same].max()):.2e} "
                     f"({jumps} jumps; card {ms:.3f} ms per transition, {ops.n} torch ops "
                     f"dispatched per transition"
                     f"{'; parted at a tie: ' + ', '.join(parted) if parted else ''}"
                     f"{'; same decisions, floats apart: ' + ', '.join(drifted) if drifted else ''}"
                     f"; transition {k0}"
                     f"{', the first with a float apart,' if bool(apart.any()) else ' (no float apart)'}"
                     f" traced: ops whose card output differs from the CPU's on bit-equal "
                     f"inputs: {origin_text})")
    print(f"phase 22 the engine on the card against the engine on the CPU (f64, B={B}, d={d}, "
          f"{n} transitions from one state and keys, Gaussian) — {'; '.join(texts)}; "
          f"step-by-step max_abs_err {worst:.3e}; {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return worst


def engine_call(sampler, n_or_T, x0, v0, **kw):
    """One timed ``sample_skeleton`` call with its counts: (skeleton, wall,
    K2 launches, engine chunks, transitions, engine ms by CUDA events, the
    arguments of its first K2 call)."""
    first = []
    compact_fill = k2.compact_fill

    def spy(fill, out, off=None, init=None):
        if not first:
            first.append((fill, out.t.shape[1], off, init))
        return compact_fill(fill, out, off, init)

    build.reset_launches()
    engine.reset_counts()
    engine.CHUNK_EVENTS = []
    k2.compact_fill = spy
    sync()
    try:
        t0 = time.perf_counter()
        skel = pt.sample_skeleton(sampler, n_or_T, x0, v0, dtype=torch.float32, device=DEV,
                                  **kw)
        sync()
        wall = time.perf_counter() - t0
    finally:
        k2.compact_fill = compact_fill
        spans, engine.CHUNK_EVENTS = engine.CHUNK_EVENTS, None
    eng_ms = sum(a.elapsed_time(b) for a, b in spans)
    launches = dict(build.LAUNCHES)
    if any(n for k, n in launches.items() if k != "compact_rows"):
        raise AssertionError(f"an engine path launched a chunk kernel: {launches}")
    if launches["compact_rows"] < 1 or engine.COUNTS["transitions"] < 1:
        raise AssertionError(f"engine path missed K2 or the engine: {launches}, "
                             f"{dict(engine.COUNTS)}")
    return (skel, wall, launches["compact_rows"], engine.COUNTS["chunks"],
            engine.COUNTS["transitions"], eng_ms, first[0])


def engine_k2_check(what, first):
    """K2 on the first fill of an engine call (``engine_call``'s last item):
    checked bit for bit against its plain version on fresh outputs, timed
    beside it, and its bound.  Returns (err, ms, plain_ms, bound)."""
    fill, W, off, init = first
    B, d = fill.kind.shape[-1], fill.x.shape[1]
    outs = []
    for fn in (k2.compact_rows, k2.compact_rows_plain):
        out = k2.empty_rows(B, W, d, fill.x.dtype, DEV)
        for a in out[:-1]:
            a.zero_()  # columns past a short chain's rows stay equal
        kind, specs = k2.fill_specs(fill, out, init)
        fn(kind, specs, off)
        outs.append(out)
    sync()
    err = k2_outputs_equal(what, *outs)
    del outs, out
    ms = cuda_ms(lambda: k2.compact_rows(kind, specs, off), 5)
    plain_ms = cuda_ms(lambda: k2.compact_rows_plain(kind, specs, off), 2)
    counts = (fill.kind[:, 0] > 0).sum(0)
    return err, ms, plain_ms, k2_bound(fill, counts, W)


def check_complete(what, skel, n_sk):
    if not bool((skel.n_valid == n_sk).all()):
        raise AssertionError(f"{what} incomplete: n_valid min {int(skel.n_valid.min())}")
    if not bool(torch.isfinite(skel.x).all() and torch.isfinite(skel.t).all()):
        raise AssertionError(f"{what} produced non-finite values")
    if not bool((skel.t[:, 1:] >= skel.t[:, :-1]).all()):
        raise AssertionError(f"{what}: t decreases somewhere")


def engine_split(wall, k2_n, k2_ms, eng_ms):
    wall_ms = wall * 1e3
    k2_total = k2_n * k2_ms
    rest = wall_ms - eng_ms - k2_total
    return (f"split of {wall_ms:.2f} ms: engine chunks (CUDA events) {eng_ms:.2f} ms "
            f"({eng_ms / wall_ms:.1%}), K2 {k2_n} x {k2_ms:.4f} = {k2_total:.4f} ms "
            f"({k2_total / wall_ms:.1%}), rest {rest:.2f} ms ({rest / wall_ms:.1%})")


def phase_rhmc(card_name):
    """Phase 23: ``rhmc_gauss_d10`` (``benchmarks/run_baselines.py:124-127``
    at scale 1): RHMCAD(10, gauss, refresh_rate=1.0), 512 chains x 512
    points (cut from 1024), float32, x0 = 0, v0 = 1; one warm call (64 points),
    ``RHMC_CALLS`` timed calls, the first counted and checked (complete, K2 launched, engine
    transitions counted, no chunk kernel, pooled moments in bench.py's bands,
    split-R-hat < 1.02); the median call's split; K2 checked on this path's
    fill; a time-horizon call at ``RHMC_HORIZON_T``.  Returns the kernels
    line's K2 entry inputs."""
    d, B, n_sk, lam = RHMC_D10
    sampler = pt.RHMCAD(d, pt.potentials.gauss, refresh_rate=lam)
    x0, v0 = np.zeros((B, d)), np.ones((B, d))
    # warm at 64 points: the same ops and allocations as a whole call
    pt.sample_skeleton(sampler, 64, x0, v0, seed=0, dtype=torch.float32, device=DEV)
    calls = [engine_call(sampler, n_sk, x0, v0, seed=0) for _ in range(RHMC_CALLS)]
    skel, _, k2_n, chunks, transitions, _, first = calls[0]
    check_complete("rhmc_gauss_d10", skel, n_sk)
    mean, var = pt.pooled_moments(skel, sampler, 256)
    if not moments_ok(mean, var):
        raise AssertionError(f"rhmc_gauss_d10 moments off: mean {mean.tolist()} "
                             f"var {var.tolist()}")
    xs = pt.sample_from_skeleton_batch(sampler, 256, skel).cpu().numpy()
    rhat = pt.diagnostics.split_rhat(xs)
    if not (rhat < 1.02).all():
        raise AssertionError(f"rhmc_gauss_d10 split-R-hat {rhat.tolist()}")
    events = int(skel.n_valid.sum()) - B
    del skel, xs
    walls = [c[1] for c in calls]
    med_i = int(np.argsort(walls)[len(walls) // 2])
    _, wall, k2_med, chunks_med, _, eng_ms, _ = calls[med_i]
    del calls
    chunk_ms = eng_ms / chunks_med
    err, ms, plain_ms, b = engine_k2_check("rhmc_gauss_d10", first)
    del first
    hz, hz_wall, hz_k2, _, hz_tr, _, _ = engine_call(sampler, RHMC_HORIZON_T, x0, v0, seed=1)
    last = hz.n_valid.long() - 1
    rows = torch.arange(B, device=DEV)
    if not (bool((hz.t[rows, last] == RHMC_HORIZON_T).all())
            and bool((hz.kind[rows, last] == pt.EV_TERMINAL).all())):
        raise AssertionError("rhmc_gauss_d10 horizon: a chain does not end at t == T "
                             "with EV_TERMINAL")
    hz_events = int(hz.n_valid.sum()) - 2 * B
    del hz
    print(f"phase 23 rhmc_gauss_d10: RHMCAD({d}, gauss, refresh_rate={lam}) tmax="
          f"{sampler.tmax} B={B} n_sk={n_sk} f32 events={events}; complete, finite, t "
          f"non-decreasing, max|mean|={float(mean.abs().max()):.4f} max|var-1|="
          f"{float((var - 1).abs().max()):.4f}, split-R-hat max {float(rhat.max()):.5f} < 1.02; "
          f"first timed call: {k2_n} K2 launches, {chunks} engine chunks, {transitions} "
          f"transitions, no chunk kernel; {RHMC_CALLS} timed warm calls "
          f"{' '.join(f'{w:.4f}' for w in walls)} s, median {wall:.4f} s "
          f"({events / wall:.1f} events/s); {engine_split(wall, k2_med, ms, eng_ms)}; "
          f"engine {chunk_ms:.3f} ms per chunk of 64 transitions (CUDA events, median call); "
          f"K2 on its first fill {ms:.4f} ms vs plain {plain_ms:.4f} ms, bit-identical, bound "
          f"{bound_text(b)}; time horizon T={RHMC_HORIZON_T}: every chain ends at t == T with "
          f"EV_TERMINAL, {hz_events} events, {hz_tr} transitions, {hz_k2} K2 launches, wall "
          f"{hz_wall:.4f} s ({card_name})", flush=True)
    return k2_n, err, ms, plain_ms, b


def phase_banana_engine(card_name, tderiv):
    """Phase 24: ``zigzag_banana_d10_fd`` / ``_jvp``
    (``benchmarks/run_baselines.py:146-158`` at scale 1): ZigZagAD(10,
    banana) with finite-difference or jvp tangents, ``backend="xla_stream"``,
    512 chains x 1024 points (cut from 4096, then 2048: the script's time), float32,
    x0 = v0 = 1; one timed call: complete,
    K2 launched, engine transitions counted, no chunk kernel, |mean_i| < 0.1
    and |var_i / truth_i - 1| < 0.1 with truth (1, 3, 1, ...); events/s and
    the split; K2 checked on this path's first fill."""
    d, B, n_sk = BANANA_D10
    kw = dict(AD_backend="FiniteDiff") if tderiv == "fd" else {}
    sampler = pt.ZigZagAD(d, pt.potentials.banana, **kw)
    name = f"zigzag_banana_d10_{tderiv}"
    x0, v0 = np.ones((B, d)), np.ones((B, d))
    skel, wall, k2_n, chunks, transitions, eng_ms, first = engine_call(
        sampler, n_sk, x0, v0, seed=0, backend="xla_stream")
    check_complete(name, skel, n_sk)
    mean, var = pt.pooled_moments(skel, sampler, 1024)
    truth = torch.tensor([1.0, 3.0] + [1.0] * (d - 2), device=var.device, dtype=var.dtype)
    mean_max = float(mean.abs().max())
    var_rel = float((var / truth - 1).abs().max())
    if not (mean_max < 0.1 and var_rel < 0.1):
        raise AssertionError(f"{name}: max|mean| {mean_max:.4f}, max|var/truth-1| {var_rel:.4f}")
    events = int(skel.n_valid.sum()) - B
    del skel
    err, ms, plain_ms, b = engine_k2_check(name, first)
    del first
    chunk_ms = eng_ms / chunks
    print(f"phase 24 {name}: ZigZagAD({d}, banana, tderiv={sampler.tderiv!r}) "
          f"backend='xla_stream' B={B} n_sk={n_sk} (cut from 4096) f32 events={events}; "
          f"complete, finite, t "
          f"non-decreasing, max|mean| {mean_max:.4f} < 0.1, max|var / (1, 3, 1, ...) - 1| "
          f"{var_rel:.4f} < 0.1; {k2_n} K2 launches, {chunks} engine chunks, {transitions} "
          f"transitions, no chunk kernel; one timed call {wall:.4f} s ({events / wall:.1f} "
          f"events/s); {engine_split(wall, k2_n, ms, eng_ms)}; engine {chunk_ms:.3f} ms per "
          f"chunk of 64 transitions (CUDA events); K2 on its first fill "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bit-identical, bound {bound_text(b)} "
          f"({card_name})", flush=True)
    return k2_n, err, ms, plain_ms, b


def phase_routing(card_name):
    """Phase 25: ``backend="auto"`` routing on the card.  A tagged Zig-Zag
    launches K1 and runs no engine transition; RHMC and a
    ``vectorized_bound=False`` Zig-Zag run the engine (and no chunk kernel);
    ``"pallas"`` on RHMC raises; an untagged Zig-Zag (``lambda x: x``) is
    lowered and takes K1 alone; a running product (``cumprod``) raises
    ``LoweringError`` under ``"auto"`` before any launch, naming
    ``aten.cumprod`` and ``backend="xla_stream"``, and runs under it.  Then an engine
    ``sample_streaming_stats`` of RHMC at B = 512, pooled moments in bench.py's
    bands."""
    d, n_sk = 10, 256
    x0, v0 = np.zeros((512, d)), np.ones((512, d))
    kw = dict(seed=5, dtype=torch.float32, device=DEV)
    texts = []

    def counted(sampler, **extra):
        build.reset_launches()
        engine.reset_counts()
        skel = pt.sample_skeleton(sampler, n_sk, x0, v0, **kw, **extra)
        sync()
        if not bool((skel.n_valid == n_sk).all()):
            raise AssertionError(f"phase 25: {type(sampler).__name__} incomplete")
        return dict(build.LAUNCHES), engine.COUNTS["transitions"]

    launches, tr = counted(pt.ZigZag(d, pt.potentials.grad_gauss))
    if launches["zigzag_chunk"] < 1 or tr != 0:
        raise AssertionError(f"phase 25: a tagged Zig-Zag did not take K1 alone: "
                             f"{launches}, {tr} engine transitions")
    texts.append(f"tagged ZigZag: {launches['zigzag_chunk']} K1 launches, 0 engine transitions")
    for s in (pt.RHMC(d, pt.potentials.grad_gauss),
              pt.ZigZag(d, pt.potentials.grad_gauss, vectorized_bound=False)):
        launches, tr = counted(s)
        chunk = sum(n for k, n in launches.items() if k != "compact_rows")
        if tr < 1 or chunk or launches["compact_rows"] < 1:
            raise AssertionError(f"phase 25: {type(s).__name__} did not take the engine: "
                                 f"{launches}, {tr} transitions")
        texts.append(f"{type(s).__name__}(vectorized_bound={s.vectorized_bound}): {tr} "
                     f"engine transitions, {launches['compact_rows']} K2 launches")
    try:
        pt.sample_skeleton(pt.RHMC(d, pt.potentials.grad_gauss), n_sk, x0, v0, **kw,
                           backend="pallas")
        raise AssertionError("phase 25: backend='pallas' ran RHMC")
    except ValueError as e:
        texts.append(f"pallas on RHMC raises ({e})")
    launches, tr = counted(pt.ZigZag(d, lambda x: x))
    if launches["zigzag_chunk"] < 1 or tr != 0:
        raise AssertionError(f"phase 25: an untagged Zig-Zag did not take K1 alone: "
                             f"{launches}, {tr} engine transitions")
    texts.append(f"untagged ZigZag(lambda x: x): lowered, {launches['zigzag_chunk']} K1 "
                 "launches, 0 engine transitions")
    refused = pt.ZigZag(d, running_product)
    build.reset_launches()
    try:
        pt.sample_skeleton(refused, n_sk, x0, v0, **kw)
        raise AssertionError("phase 25: a running product ran under backend='auto'")
    except lower.LoweringError as e:
        if "backend='xla_stream'" not in str(e) or "aten.cumprod" not in str(e):
            raise
        if any(build.LAUNCHES.values()):
            raise AssertionError(f"phase 25: the refusal came after a launch: "
                                 f"{dict(build.LAUNCHES)}") from e
    launches, tr = counted(refused, backend="xla_stream")
    if tr < 1 or launches["compact_rows"] < 1:
        raise AssertionError(f"phase 25: cumprod under xla_stream: {launches}, {tr}")
    texts.append(f"ZigZag(x + 0.1 cumprod(tanh(x))): 'auto' raises LoweringError naming "
                 f"aten.cumprod and backend='xla_stream' before any launch; 'xla_stream' ran "
                 f"{tr} engine transitions")
    B, d, T, n_samples, n_batches = ROUTE_STREAM
    sampler = pt.RHMCAD(d, pt.potentials.gauss)
    engine.reset_counts()
    t0 = time.perf_counter()
    run = pt.sample_streaming_stats(sampler, T, np.zeros((B, d)), np.ones((B, d)),
                                    n_samples=n_samples, n_batches=n_batches, seed=6,
                                    dtype=torch.float32, device=DEV)
    sync()
    wall = time.perf_counter() - t0
    summ = pt.streaming_summary(run)
    mean_max = float(np.abs(summ["pooled_mean"]).max())
    var_dev = float(np.abs(summ["pooled_var"] - 1.0).max())
    if not (engine.COUNTS["transitions"] > 0 and mean_max < 0.2 and var_dev < 0.3):
        raise AssertionError(f"phase 25 streaming RHMC: {dict(engine.COUNTS)}, max|mean| "
                             f"{mean_max:.4f}, max|var-1| {var_dev:.4f}")
    texts.append(f"streaming RHMC (B={B}, T={T}): {run.events} events, {run.fills} fills, "
                 f"{engine.COUNTS['transitions']} engine transitions, wall {wall:.3f} s, "
                 f"max|mean| {mean_max:.4f}, max|var-1| {var_dev:.4f}, rhat_max "
                 f"{summ['rhat_max']:.4f}")
    print(f"phase 25 routing on the card: {'; '.join(texts)} ({card_name})", flush=True)


def host_call(sampler, n_or_T, x0, v0, **kw):
    """One timed ``sample_skeleton`` call on host accumulation: (skeleton,
    wall s, launches, ``api.HOST_ACC`` of the call, the arguments of its
    first K2 call)."""
    first = []
    compact_fill = k2.compact_fill

    def spy(fill, out, off=None, init=None):
        if not first:
            first.append((fill, out.t.shape[1], off, init))
        return compact_fill(fill, out, off, init)

    build.reset_launches()
    api.HOST_ACC.clear()
    k2.compact_fill = spy
    sync()
    try:
        t0 = time.perf_counter()
        skel = pt.sample_skeleton(sampler, n_or_T, x0, v0, dtype=torch.float32, device=DEV,
                                  **kw)
        sync()
        wall = time.perf_counter() - t0
    finally:
        k2.compact_fill = compact_fill
    return skel, wall, dict(build.LAUNCHES), dict(api.HOST_ACC), first[0]


def equal_to_device(what, host, dev):
    """A host-accumulated skeleton (CPU tensors) against the device path's:
    ``n_valid`` equal, every field equal bit for bit up to its width."""
    if host.t.device.type != "cpu":
        raise AssertionError(f"{what}: host accumulation returned {host.t.device} tensors")
    W = host.t.shape[1]
    for f, a, b in zip(host._fields, host, dev):
        b = b.cpu() if f == "n_valid" else b[:, :W].cpu()
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{what}: {f} differs from the device path")


def host_split(wall, kernel, n, k_ms, k2_n, k2_ms, acc):
    """The call split into the chunk kernel (launches at the time one takes
    alone), K2 (launches at its time on the path's first fill), the copies
    to the host and the placement (host clock), and the rest."""
    wall_ms = wall * 1e3
    parts = [(f"{kernel} {n} x {k_ms:.4f}", n * k_ms), (f"K2 {k2_n} x {k2_ms:.4f}", k2_n * k2_ms),
             (f"copy to host ({acc['bytes'] / 2**20:.1f} MiB in {acc['fills']} copies)",
              acc["copy_s"] * 1e3), ("host placement", acc["place_s"] * 1e3)]
    rest = wall_ms - sum(ms for _, ms in parts)
    return (f"split of {wall_ms:.2f} ms: "
            + ", ".join(f"{name} = {ms:.2f} ms ({ms / wall_ms:.1%})" for name, ms in parts)
            + f", rest {rest:.2f} ms ({rest / wall_ms:.1%})")


def phase_host_sticky(card_name, sampler, k6_ms):
    """Phase 26: host accumulation at ``sticky_zigzag_d1000`` (128 chains x
    2048 points, a 2.38 GB skeleton): (a) forced by PDMPFLUX_STREAM_HOST_ACC
    at the default fill rows, (b) forced by a 1 GiB device budget, which
    sizes 64-row fills; each against the device path at the same fill rows,
    bit for bit; K2 checked on the path's first fill."""
    d, B, n_sk, _ = STICKY
    x0, v0 = np.full((B, d), 0.3), np.ones((B, d))
    kw = dict(seed=0, dtype=torch.float32, device=DEV)
    out = {}
    for label, env, value in (("a", "PDMPFLUX_STREAM_HOST_ACC", "1"),
                              ("b", "PDMPFLUX_DEVICE_BYTES", str(HOST_BUDGET))):
        os.environ[env] = value
        try:
            t_cap = api.fill_rows(sampler, n_sk - 1, B, d, torch.float32, DEV)
            skel, wall, launches, acc, first = host_call(sampler, n_sk, x0, v0, t_cap=t_cap,
                                                         seed=0)
        finally:
            del os.environ[env]
        if acc["fills"] < (30 if label == "b" else 1) or launches["sticky_chunk"] < 1:
            raise AssertionError(f"26{label}: host path not taken: {acc}, {launches}")
        check_sticky_skeleton(skel, n_sk)
        equal_to_device(f"26{label}", skel, pt.sample_skeleton(sampler, n_sk, x0, v0,
                                                                t_cap=t_cap, **kw))
        del skel
        err, k2_ms, k2_plain_ms, b = engine_k2_check(f"26{label} host K2", first)
        first_w = first[1]
        del first
        events = B * (n_sk - 1)
        print(f"phase 26{label} host accumulation at sticky_zigzag_d1000 "
              f"({'PDMPFLUX_STREAM_HOST_ACC=1' if label == 'a' else f'PDMPFLUX_DEVICE_BYTES={HOST_BUDGET}'}"
              f", t_cap={t_cap}, {acc['fills']} fills): CPU skeleton bit for bit the device "
              f"path's at the same fill rows; wall {wall:.4f} s, events/s {events / wall:.1f}; "
              f"{host_split(wall, 'K6', launches['sticky_chunk'], k6_ms, launches['compact_rows'], k2_ms, acc)}; "
              f"K2 on the first fill (W={first_w}) {k2_ms:.4f} ms vs plain "
              f"{k2_plain_ms:.4f} ms, bit-identical, bound {bound_text(b)} ({card_name})",
              flush=True)
        out[label] = (launches["compact_rows"], err, k2_ms, k2_plain_ms, b)
    return out["b"]


def phase_host_horizon(card_name, sampler, k7_ms):
    """Phase 27: host accumulation at ``zigzag_gauss_d10_horizon`` (forced by
    the flag) against the device path: ``n_valid`` and every row up to it
    bit for bit, width ``n_valid.max()``, every chain at t == T with
    EV_TERMINAL."""
    d, B, T, cap = HORIZON_D10
    _, x0, v0 = horizon_deployment()
    kw = dict(seed=0, init_capacity=cap)
    os.environ["PDMPFLUX_STREAM_HOST_ACC"] = "1"
    try:
        skel, wall, launches, acc, first = host_call(sampler, T, x0, v0, **kw)
    finally:
        del os.environ["PDMPFLUX_STREAM_HOST_ACC"]
    if acc["fills"] < 1:
        raise AssertionError(f"27: host path not taken: {acc}")
    events = check_horizon_skeleton("27 host horizon", skel, T)
    width = skel.t.shape[1]
    if width != int(skel.n_valid.max()):
        raise AssertionError(f"27: width {width}, n_valid.max() {int(skel.n_valid.max())}")
    dev = pt.sample_skeleton(sampler, T, x0, v0, dtype=torch.float32, device=DEV, **kw)
    equal_to_device("27", skel, dev)
    dev_width = dev.t.shape[1]
    del skel, dev
    err, k2_ms, k2_plain_ms, b = engine_k2_check("27 host K2", first)
    del first
    n = launches["zigzag_chunk_horizon"]
    print(f"phase 27 host accumulation at zigzag_gauss_d10_horizon (PDMPFLUX_STREAM_HOST_ACC=1, "
          f"{acc['fills']} fills): CPU skeleton equal to the device path's up to n_valid, "
          f"width {width} = n_valid.max() (device path {dev_width}), every chain at t == {T} "
          f"with EV_TERMINAL; wall {wall:.4f} s, events/s {events / wall:.1f}; "
          f"{host_split(wall, 'K1', n, k7_ms, launches['compact_rows'], k2_ms, acc)} "
          f"(rest: the terminal flow, finalize and allocation); K2 on the fill "
          f"{k2_ms:.4f} ms vs plain {k2_plain_ms:.4f} ms, bit-identical, bound {bound_text(b)} "
          f"({card_name})", flush=True)
    return launches["compact_rows"], err, k2_ms, k2_plain_ms, b


def stats_direct(skel):
    """The skeleton statistics computed from the skeleton directly."""
    valid = torch.arange(skel.t.shape[1], device=skel.t.device)[None, :] < skel.n_valid[:, None]

    def total(a):
        return float(torch.where(valid, a, 0).double().sum())

    events = int(skel.n_valid.long().sum())
    ar = total(skel.ar)
    return {"events": events, "ar_sum": ar, "rejected": int(total(skel.rejected)),
            "errored_bound": int(total(skel.errored_bound)),
            "hitting_horizon": int(total(skel.hitting_horizon)), "mean_ar": ar / max(events, 1)}


def stats_agree(what, got, want):
    for k, v in want.items():
        if (got[k] != v) if isinstance(v, int) else abs(got[k] - v) > 1e-9 * abs(v):
            raise AssertionError(f"{what}: stats[{k!r}] {got[k]} vs {v}")


def phase_sharded(card_name, k1_ms, k2_ms):
    """Phase 28: ``sample_skeleton_sharded`` of the flagship on
    ``make_mesh()`` (one card): bit for bit ``sample_skeleton``, its stats
    those of the skeleton; then inside a one-process NCCL group formed by
    ``initialize`` (``host_all_gather_stats`` and ``pooled_moments(mesh=)``
    through NCCL), the group destroyed afterwards."""
    d, B, n_sk = MAIN
    sampler = pt.ZigZag(d, pt.potentials.grad_gauss)
    x0, v0 = np.zeros((B, d)), np.ones((B, d))
    ref = pt.sample_skeleton(sampler, n_sk, x0, v0, seed=0, dtype=torch.float32, device=DEV)
    par = pt.parallel
    mesh = par.make_mesh()
    if mesh.shape[par.CHAIN_AXIS] != torch.cuda.device_count():
        raise AssertionError(f"make_mesh(): {mesh}")
    par.sample_skeleton_sharded(sampler, n_sk, x0, v0, mesh=mesh, seed=0,
                                dtype=torch.float32)  # warm
    sync()
    build.reset_launches()
    t0 = time.perf_counter()
    run = par.sample_skeleton_sharded(sampler, n_sk, x0, v0, mesh=mesh, seed=0,
                                      dtype=torch.float32)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for f, a, b in zip(ref._fields, run.skeleton, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"28: sharded {f} differs from sample_skeleton's")
    stats_agree("28", run.stats, stats_direct(ref))
    mean, var = par.pooled_moments(run.skeleton, sampler, 256)
    if not moments_ok(mean, var):
        raise AssertionError(f"28: moments off {mean.tolist()} {var.tolist()}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    if not distributed.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl"):
        raise AssertionError("28: initialize formed no group")
    try:
        gmesh = distributed.global_mesh()
        grun = par.sample_skeleton_sharded(sampler, n_sk, x0, v0, mesh=gmesh, seed=0,
                                           dtype=torch.float32)
        for f, a, b in zip(ref._fields, grun.skeleton, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"28: the NCCL group's {f} differs")
        stats_agree("28 NCCL", grun.stats, run.stats)
        stats_agree("28 host_all_gather_stats", distributed.host_all_gather_stats(run.stats),
                    run.stats)
        gmean, gvar = par.pooled_moments(grun.skeleton, sampler, 256, mesh=gmesh)
        if not (torch.equal(gmean, mean) and torch.equal(gvar, var)):
            raise AssertionError("28: pooled_moments(mesh=) through NCCL differs")
        backend = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    events = int(run.skeleton.n_valid.sum()) - B
    n = launches["zigzag_chunk"]
    wall_ms = wall * 1e3
    rest = wall_ms - n * k1_ms - launches["compact_rows"] * k2_ms
    print(f"phase 28 sharded flagship: sample_skeleton_sharded(ZigZag({d}, grad_gauss)) "
          f"B={B} n_sk={n_sk} f32 on {mesh}: bit for bit sample_skeleton, stats "
          f"{run.stats} equal the skeleton's, transitions {run.transitions.tolist()}; wall "
          f"{wall:.4f} s, events/s {events / wall:.1f}; split of {wall_ms:.2f} ms: K1 {n} x "
          f"{k1_ms:.4f} = {n * k1_ms:.2f} ms ({n * k1_ms / wall_ms:.1%}), K2 "
          f"{launches['compact_rows']} x {k2_ms:.4f} ms, rest {rest:.2f} ms "
          f"({rest / wall_ms:.1%}); in a one-process {backend} group from initialize: the "
          f"same skeleton and stats, host_all_gather_stats and pooled_moments(mesh=) equal "
          f"({card_name})", flush=True)
    return n


def phase_stream_mesh(card_name, banana):
    """Phase 29: ``zigzag_banana_d50_streaming`` with ``mesh=make_mesh()``
    against phase 20's timed run without a mesh: accumulators, events and
    fills equal."""
    T, x0, v0, kw, want = banana
    d = x0.shape[1]
    sampler = pt.ZigZag(d, pt.potentials.grad_banana, grid_size=0)
    sync()
    t0 = time.perf_counter()
    got = pt.sample_streaming_stats(sampler, T, x0, v0, seed=3, dtype=torch.float32,
                                    device=DEV, mesh=pt.parallel.make_mesh(), **kw)
    sync()
    wall = time.perf_counter() - t0
    if (got.events, got.fills) != (want.events, want.fills):
        raise AssertionError(f"29: events/fills {got.events}/{got.fills} vs "
                             f"{want.events}/{want.fills}")
    for f, a, b in zip(got.stats._fields, got.stats, want.stats):
        if not torch.equal(a, b):
            raise AssertionError(f"29: accumulator {f} differs from the run without a mesh")
    print(f"phase 29 zigzag_banana_d50_streaming with mesh=make_mesh(): {got.events} events, "
          f"{got.fills} fills, accumulators equal to phase 20's run without a mesh; wall "
          f"{wall:.3f} s, events/s {got.events / wall:.1f} ({card_name})", flush=True)


def kernel_name(name):
    """A trace's kernel name without return type, namespace, template
    arguments and parameters."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return re.split(r"[<(]", name)[0].strip()


def phase_profiled(card_name, sampler):
    """Phase 30: one warm flagship ``sample_skeleton`` inside
    ``profiling.annotate``, traced by ``profiling.trace`` into a temporary
    directory; the exported trace's span, K1's events against the launch
    count, K2's four kernels, the card's busy share of the span and each
    kernel name's summed time; then ``profiling.timed`` of the same call.
    Returns (skeleton, launches in the traced call)."""
    d, B, n_sk = MAIN
    x0, v0 = np.zeros((B, d)), np.ones((B, d))

    def call():
        return pt.sample_skeleton(sampler, n_sk, x0, v0, seed=0, dtype=torch.float32,
                                  device=DEV)

    call()
    sync()
    logdir = tempfile.mkdtemp(prefix="pdmp_trace_")
    try:
        build.reset_launches()
        with profiling.trace(logdir):
            with profiling.annotate(TRACE_SPAN):
                skel = call()
                sync()
        launches = dict(build.LAUNCHES)
        files = sorted(os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs
                       if f.endswith(".pt.trace.json"))
        if not files:
            raise AssertionError(f"30: profiling.trace wrote no trace under {logdir}")
        with open(files[-1]) as f:
            events = json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(files[-1])
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    spans = [e for e in events if e.get("name") == TRACE_SPAN
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise AssertionError(f"30: the trace holds {len(spans)} {TRACE_SPAN} spans")
    lo, span_us = float(spans[0]["ts"]), float(spans[0]["dur"])
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and lo <= float(e["ts"]) <= lo + span_us]
    per = {}
    for e in device:
        k = kernel_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
        ms, n = per.get(k, (0.0, 0))
        per[k] = (ms + float(e["dur"]) / 1e3, n + 1)
    k1_n = per.get("zigzag_chunk_kernel", (0.0, 0))[1]
    if k1_n != launches["zigzag_chunk"] or k1_n < 1:
        raise AssertionError(f"30: {k1_n} K1 kernel events in the trace, "
                             f"{launches['zigzag_chunk']} launches counted")
    for k in K2_KERNELS:
        if per.get(k, (0.0, 0))[1] != launches["compact_rows"]:
            raise AssertionError(f"30: K2's {k} in the trace {per.get(k)}, "
                                 f"{launches['compact_rows']} K2 launches counted")
    busy = sum(ms for ms, _ in per.values())
    span_ms = span_us / 1e3
    r = profiling.timed(call, repeats=3)
    if set(r) != {"first_call_s", "steady_state_s", "compile_overhead_s", "result"}:
        raise AssertionError(f"30: timed keys {sorted(r)}")
    top = sorted(per.items(), key=lambda kv: -kv[1][0])
    print(f"phase 30 profiled flagship: profiling.trace ({trace_bytes} bytes of trace) around "
          f"sample_skeleton(ZigZag({d}, grad_gauss)) B={B} n_sk={n_sk} f32 inside "
          f"annotate({TRACE_SPAN!r}): span {span_ms:.3f} ms, card busy {busy:.3f} ms "
          f"({busy / span_ms:.1%} of the span, host {1 - busy / span_ms:.1%}); K1 events "
          f"{k1_n} = launches, K2's four kernels x {launches['compact_rows']}; per name: "
          + ", ".join(f"{k} {ms:.4f} ms x {n}" for k, (ms, n) in top)
          + f"; timed: first {r['first_call_s']:.4f} s, steady {r['steady_state_s']:.4f} s, "
          f"overhead {r['compile_overhead_s']:.4f} s ({card_name})", flush=True)
    return skel, launches


def phase_plots(card_name, sampler, skel):
    """Phase 31: ``plotting._anim_points`` on chain 0 of the card's skeleton
    equal to the host copy's and, to float32's rtol 1e-6 (the linear frames
    are numpy's products in the skeleton's float32, the flow's torch's in
    float64), to the frames through the sampler's flow; ``plot_traj``'s
    line data equal to the skeleton's first points where matplotlib is
    installed."""
    one = Skeleton(*(a[0] for a in skel))
    host = Skeleton(*(a.cpu() for a in one))
    got = plotting._anim_points(one, 200, 0.05, None, (0, 1))
    want = plotting._anim_points(host, 200, 0.05, None, (0, 1))
    flowed = plotting._anim_points(one, 200, 0.05, sampler.flow, (0, 1))
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
        raise AssertionError("31: _anim_points on the card's skeleton differ from the host's")
    if not np.allclose(flowed[0], got[0], rtol=1e-6, atol=1e-6):
        raise AssertionError("31: frames through the sampler's flow differ")
    try:
        import matplotlib  # noqa: F401
        drawn = True
    except ImportError:
        drawn = False
    if drawn:
        xy = plotting.plot_traj(one, 500).axes[0].lines[0].get_xydata()
        if not np.array_equal(xy, host.x[:500, :2].numpy()):
            raise AssertionError("31: plot_traj's line data differ from the skeleton")
    print(f"phase 31 plotting on the card's skeleton (chain 0 of phase 30): {len(got[0])} "
          f"animation frames equal to the host copy's and through ZigZag.flow; "
          + ("plot_traj drawn, its line data the skeleton's first 500 points"
             if drawn else "matplotlib is not installed here: frames only, nothing drawn")
          + f" ({card_name})", flush=True)


def gspmd_samplers():
    d = GSPMD[0]
    return {"bps": pt.BPS(d, pt.potentials.grad_gauss, refresh_rate=0.5),
            "zigzag": pt.ZigZag(d, pt.potentials.grad_gauss)}


def gspmd_call(sampler, mesh):
    """One timed ``sample_skeleton_gspmd`` of phase 32's deployment on
    ``mesh``: (run, wall)."""
    d, B, n = GSPMD
    sync()
    t0 = time.perf_counter()
    run = pt.parallel.sample_skeleton_gspmd(sampler, n, np.zeros((B, d)), np.ones((B, d)),
                                            mesh=mesh, seed=0, dtype=torch.float64)
    sync()
    return run, time.perf_counter() - t0


def gspmd_worker(port, rank, out):
    """One of phase 32's two processes: a gloo group on the one card, a
    ``make_mesh(1, 2)`` mesh, each family's run, its block and its wall
    written to ``out``."""
    torch.cuda.set_device(0)
    distributed.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    try:
        mesh = pt.parallel.make_mesh(1, 2)
        walls = {}
        for name, sampler in gspmd_samplers().items():
            run, walls[name] = gspmd_call(sampler, mesh)
            for rec, tag in ((run.skeleton, "skel"), (run.state, "state")):
                for f, a in zip(rec._fields, rec):
                    np.save(os.path.join(out, f"{name}.{tag}.{f}.rank{rank}.npy"), a.cpu().numpy())
            np.save(os.path.join(out, f"{name}.transitions.rank{rank}.npy"),
                    run.transitions.numpy())
            del run
        dims = mesh.dims(GSPMD[0])
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"walls": walls, "cols": [dims.lo, dims.hi]}, f)
    finally:
        torch.distributed.destroy_process_group()


def gspmd_block_err(name, rec, tag, out, rank, cols):
    """Rank ``rank``'s block against the dim-1 record ``rec``'s: floats to
    ``GSPMD_RTOL`` (atol 1e-12; the Kahan residue ``t_comp`` holds rounding
    only and is not compared), integers equal.  Returns (the largest
    absolute difference, the largest relative one where |dim 1| > 1e-6)."""
    err = [0.0, 0.0]
    for f, a in zip(rec._fields, rec):
        b = torch.from_numpy(np.load(os.path.join(out, f"{name}.{tag}.{f}.rank{rank}.npy")))
        a = a.cpu()
        if f in ("x", "v", "is_active"):
            a = a[..., cols[0]:cols[1]]
        if a.shape != b.shape:
            raise AssertionError(f"32 {name}: {tag}.{f} block {tuple(b.shape)}, "
                                 f"want {tuple(a.shape)}")
        if a.is_floating_point() and f != "t_comp":
            if not torch.allclose(b, a, rtol=GSPMD_RTOL, atol=1e-12, equal_nan=True):
                raise AssertionError(f"32 {name}: dim 2's {tag}.{f} differs from dim 1's")
            fin = torch.isfinite(a)
            diff = (b - a).abs()[fin]
            if diff.numel():
                err[0] = max(err[0], float(diff.max()))
                big = fin & (a.abs() > 1e-6)
                if bool(big.any()):
                    err[1] = max(err[1], float(((b - a).abs()[big] / a.abs()[big]).max()))
        elif not a.is_floating_point() and not torch.equal(a, b):
            raise AssertionError(f"32 {name}: dim 2's {tag}.{f} differs from dim 1's")
    return err


def phase_gspmd(card_name):
    """Phase 32: ``sample_skeleton_gspmd`` of the large-d deployment
    (``GSPMD``) for BPS and Zig-Zag: without a group; in a one-process NCCL
    group whose mesh reduces through a one-part ``ShardedDims`` (dim 1, its
    collectives through NCCL; bit for bit the run without a group); then
    starts :func:`gspmd_dim2`.  Returns the ``k2_paths`` entry of the
    Zig-Zag's dim-1 run (K2 checked and timed on its first fill) and dim 2's
    ``finish``."""
    d, B, n = GSPMD
    samplers = gspmd_samplers()
    par = pt.parallel
    walls, runs, first = {}, {}, []
    compact_fill = k2.compact_fill

    def spy(fill, out, off=None, init=None):
        if not first:
            first.append((fill, out.t.shape[1], off, init))
        return compact_fill(fill, out, off, init)

    plain = {}
    for name, sampler in samplers.items():
        run, walls[f"{name} no group"] = gspmd_call(sampler, par.make_mesh())
        check_complete(f"32 {name}", run.skeleton, n)
        plain[name] = run
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    if not distributed.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl"):
        raise AssertionError("32: initialize formed no group")
    try:
        mesh = par.make_mesh()
        if mesh.shape != {"chains": 1, "dim": 1} or mesh.dims(d).sharded:
            raise AssertionError(f"32: the NCCL group's mesh {mesh} is not one slice of "
                                 "local coordinates")
        # a dim axis of 1 reduces locally; one part of a ShardedDims instead
        # sends every reduction through NCCL's collectives on the card
        mesh.dims = lambda d_: ShardedDims(d_, 0, 1, torch.distributed.group.WORLD)
        for name, sampler in samplers.items():
            if name == "zigzag":
                build.reset_launches()
                k2.compact_fill = spy
            try:
                run, walls[f"{name} dim 1"] = gspmd_call(sampler, mesh)
            finally:
                k2.compact_fill = compact_fill
            if name == "zigzag":
                k2_n = build.LAUNCHES["compact_rows"]
            for rec, want, tag in ((run.skeleton, plain[name].skeleton, "skeleton"),
                                   (run.state, plain[name].state, "state")):
                for f, a, b in zip(rec._fields, rec, want):
                    if not torch.equal(a, b):
                        raise AssertionError(f"32 {name}: dim 1's {tag}.{f} differs from "
                                             "the run without a group")
            if int(run.transitions) != int(plain[name].transitions):
                raise AssertionError(f"32 {name}: transitions differ")
            runs[name] = run
    finally:
        torch.distributed.destroy_process_group()
    del plain
    err, ms, plain_ms, b = engine_k2_check("32 K2 on the gspmd fill", first[0])
    del first
    trans = {name: int(run.transitions) for name, run in runs.items()}
    print(f"phase 32 sample_skeleton_gspmd: BPS({d}, grad_gauss, refresh_rate=0.5) and "
          f"ZigZag({d}, grad_gauss), B={B}, {n} events, f64, x0=0, v0=1, seed 0; "
          f"transitions {trans}; dim 1 (one NCCL "
          f"part) bit for bit the run without a group; walls (s): "
          + ", ".join(f"{k} {w:.3f}" for k, w in walls.items())
          + f"; K2 on the Zig-Zag's first fill bit for bit its plain version, {ms:.4f} ms "
          f"(plain {plain_ms:.4f} ms, bound {bound_text(b)}), {k2_n} launches in the dim-1 "
          f"call ({card_name})", flush=True)
    return (k2_n, err, ms, plain_ms, b), gspmd_dim2(card_name, runs)


def gspmd_dim2(card_name, runs):
    """Phase 32b: two processes on the one card over gloo, each a slice of
    the coordinates, each block held to the dim-1 ``runs`` at
    ``GSPMD_RTOL``.  Starts the processes and returns ``finish(failed)``,
    which waits for them, checks and prints (``failed``: kills them
    instead), so that phase 33 runs meanwhile: it times nothing, and the
    two processes' walls are a correctness run's, not a speed one's."""
    d = GSPMD[0]
    out = tempfile.mkdtemp(prefix="pdmp_gspmd_")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gspmd-worker",
                               str(port), str(r), out], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]

    def finish(failed=False):
        try:
            if failed:
                return
            logs = [p.communicate(timeout=600)[0] for p in procs]
            procs_s = time.perf_counter() - t0
            if [p.returncode for p in procs] != [0, 0]:
                raise AssertionError("32: a dim-2 process failed:\n" + "\n".join(logs))
            meta = []
            for r in range(2):
                with open(os.path.join(out, f"rank{r}.json")) as f:
                    meta.append(json.load(f))
            errs, walls = {}, {}
            for name, run in runs.items():
                errs[name] = [0.0, 0.0]
                for r in range(2):
                    cols = meta[r]["cols"]
                    if cols != [r * d // 2, (r + 1) * d // 2]:
                        raise AssertionError(f"32: rank {r} holds {cols}")
                    for rec, tag in ((run.skeleton, "skel"), (run.state, "state")):
                        e = gspmd_block_err(name, rec, tag, out, r, cols)
                        errs[name] = [max(a, b) for a, b in zip(errs[name], e)]
                    tr = int(np.load(os.path.join(out, f"{name}.transitions.rank{r}.npy")))
                    if tr != int(run.transitions):
                        raise AssertionError(f"32 {name}: dim 2 ran {tr} transitions, dim 1 "
                                             f"{int(run.transitions)}")
                for r in range(2):
                    walls[f"{name} rank {r}"] = meta[r]["walls"][name]
            print(f"phase 32b sample_skeleton_gspmd dim 2 over two gloo processes on the card "
                  f"(host-staged collectives: a correctness run, not a speed one, beside phase "
                  f"33) equal to dim 1 at rtol {GSPMD_RTOL}: largest absolute, and relative "
                  "where |dim 1| > 1e-6, differences "
                  + ", ".join(f"{k} {a:.3e}, {r:.3e}" for k, (a, r) in errs.items())
                  + "; walls (s): " + ", ".join(f"{k} {w:.3f}" for k, w in walls.items())
                  + f"; the two processes {procs_s:.1f} s with start-up ({card_name})",
                  flush=True)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
            shutil.rmtree(out, ignore_errors=True)

    return finish


def tag_calls(what, sampler, n_sk, x0, v0, calls):
    """A deployment's kernel route: one warm call, then ``calls`` timed warm
    calls (f32), the launches counted over the first of them (every count
    set to 0 just before it), which is checked complete, finite and with
    non-decreasing t.  Returns (that call's skeleton, its launches, the
    walls)."""
    kw = dict(seed=0, dtype=torch.float32, device=DEV)
    pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)  # warm: allocator, fill ratio
    sync()
    walls = []
    for call in range(calls):
        if call == 0:
            build.reset_launches()
        t0 = time.perf_counter()
        skel = pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)
        sync()
        walls.append(time.perf_counter() - t0)
        if call == 0:
            launches, checked = dict(build.LAUNCHES), skel
    check_complete(what, checked, n_sk)
    return checked, launches, walls


def walls_text(walls, events):
    med = float(np.median(walls))
    return (f"{len(walls)} warm calls {' '.join(f'{w:.4f}' for w in walls)} s, median "
            f"{med:.4f} s ({events / med:.1f} events/s), spread {min(walls):.4f}-"
            f"{max(walls):.4f} s")


def tag_breakdown(what, sampler, x0, v0, n_sk, launches, wall, share_min):
    """A deployment's fill and compaction timed apart, K2 checked bit for bit
    on its first fill, one K=32 chunk of its chunk kernel (K1 or K4) checked
    against its plain version at this shape in float32 (``compare_f32``), the
    kernel and K2 timed beside their plain versions; then the median warm
    call (``wall``) split into the chunk kernel's launches x its time, K2 and
    the rest.  Returns (kernel ms, plain ms, bound, K2 err, ms, plain ms,
    bound, f32 err, the split's text)."""
    B, d = x0.shape
    target = n_sk - 1
    dtype = torch.float32
    t_cap = api.fill_rows(sampler, target, B, d, dtype, DEV)
    state = sampler.init_state_batch(x0, v0, 0, dtype, DEV)
    init = event_from_state(state, EV_INIT)
    run = driver.make_stream_runner(sampler, t_cap, target)
    zeros = torch.zeros(B, dtype=torch.int32, device=DEV)
    sync()
    t0 = time.perf_counter()
    res = run(state, zeros)
    sync()
    fill_s = time.perf_counter() - t0
    off = torch.ones(B, dtype=torch.int32, device=DEV)
    outs = []
    for fn in (k2.compact_rows, k2.compact_rows_plain):
        out = k2.empty_rows(B, target + 1, d, dtype, DEV)
        for a in out[:-1]:
            a.zero_()  # columns past a short chain's rows stay equal
        kind, specs = k2.fill_specs(res.fill, out, init)
        fn(kind, specs, off)
        outs.append(out)
    sync()
    k2_err = k2_outputs_equal(what, *outs)
    del outs, out
    k2_ms = cuda_ms(lambda: k2.compact_rows(kind, specs, off), 5)
    k2_plain_ms = cuda_ms(lambda: k2.compact_rows_plain(kind, specs, off), 2)
    k2_b = k2_bound(res.fill, res.counts, target + 1)
    del res, specs, kind

    K, seed = 32, 7
    cfg = card_config(sampler, K, 1 << 30, dtype)
    name = k1.launch_name(cfg)
    st = driver.chunk_state(state, zeros)
    st_p = clone_state(st)
    v0c = st.v.clone()
    fill, fill_p = (k1.empty_fill(K, d, B, dtype, DEV) for _ in range(2))
    k1.run_chunk(seed, st, fill, 0, cfg)
    k1.run_chunk_plain(seed, st_p, fill_p, 0, cfg)
    sync()
    agree, share, err, texts = compare_f32(f"{what} {name} f32", v0c, st, fill, st_p, fill_p,
                                           cfg, seed, share_min)
    del st_p, fill_p
    b = chunk_bound(cfg, st, fill, K * B)
    ms = cuda_ms(lambda: k1.run_chunk(seed, st, fill, 0, cfg), 20)
    plain_ms = cuda_ms(lambda: k1.run_chunk_plain(seed, st, fill, 0, cfg), 2)
    wall_ms = wall * 1e3
    k_total, k2_total = launches[name] * ms, launches["compact_rows"] * k2_ms
    rest = wall_ms - k_total - k2_total
    split = (f"split of the median warm call ({wall_ms:.4f} ms): {name} {launches[name]} x "
             f"{ms:.4f} = {k_total:.4f} ms ({k_total / wall_ms:.1%}); K2 "
             f"{launches['compact_rows']} x {k2_ms:.4f} = {k2_total:.4f} ms "
             f"({k2_total / wall_ms:.1%}); rest (host, card idle) {rest:.4f} ms "
             f"({rest / wall_ms:.1%})")
    print(f"{what} breakdown (B={B}, d={d}, f32): fill {fill_s:.4f} s over {t_cap} rows; "
          f"K2 (T={t_cap}, W={target + 1}) {k2_ms:.4f} ms vs plain {k2_plain_ms:.4f} ms, "
          f"bit-identical, bound {bound_text(k2_b)}; {name} (K={K}) {ms:.4f} ms vs plain "
          f"{plain_ms:.4f} ms, bound {bound_text(b)}; kinds agree on {agree:.6f}, "
          f"max_abs_err {err:.3e} on the {share:.4f} of chains with equal decisions (want "
          f">= {share_min}); the others left at f32 rounding ties: "
          f"{'; '.join(texts) or 'none'}; {split}", flush=True)
    return ms, plain_ms, b, k2_err, k2_ms, k2_plain_ms, k2_b, err, split


def phase_suzz_cauchy(card_name):
    """Phase 34, ``suzz_cauchy_d10``: SpeedUpZigZagAD(10, cauchy), 512 chains
    x 2048 points, x0 = 0, v0 = 1, f32 (``suzz_gauss_d10``'s shape on the
    heavy-tailed target of ``tests/test_integration.py:91``), K4 and K2 on
    the card.  Gate on ``CAUCHY_SAMPLES`` equal-time samples per chain,
    pooled over chains and coordinates: |median| < 0.1, the quartiles within
    0.15 of -1 and 1, each coordinate's within 0.25, and max |x| > 5 (the
    tails visited).  Then the breakdown and the split (34b).  Returns the
    counted launches and :func:`tag_breakdown`'s numbers."""
    d, B, n_sk = SUZZ_CAUCHY_D10
    what = "phase 34 suzz_cauchy_d10"
    sampler = pt.SpeedUpZigZagAD(d, pt.potentials.cauchy)
    x0, v0 = np.zeros((B, d)), np.ones((B, d))
    skel, launches, walls = tag_calls(what, sampler, n_sk, x0, v0, TAG_CALLS)
    if launches["suzz_chunk"] < 1 or launches["compact_rows"] < 1:
        raise AssertionError(f"{what}: the path missed a kernel: {launches}")
    xs = pt.sample_from_skeleton_batch(sampler, CAUCHY_SAMPLES, skel).float()  # (B, n, d)
    if not bool(torch.isfinite(xs).all()):
        raise AssertionError(f"{what}: non-finite samples")
    q = torch.tensor([0.25, 0.5, 0.75], device=xs.device)
    pooled = torch.quantile(xs.reshape(-1)[::7], q)  # a stride keeps torch.quantile's limit
    per = torch.stack([torch.quantile(xs[..., i].reshape(-1), q) for i in range(d)])
    want = torch.tensor([-1.0, 0.0, 1.0], device=xs.device)
    med, q_err = float(pooled[1].abs()), float((pooled - want)[[0, 2]].abs().max())
    per_err = float((per - want)[:, [0, 2]].abs().max())
    x_max = float(xs.abs().max())
    if not (med < 0.1 and q_err < 0.15 and per_err < 0.25 and x_max > 5.0):
        raise AssertionError(f"{what}: |median| {med:.4f}, quartiles {pooled.tolist()}, "
                             f"per-coordinate quartiles off by {per_err:.4f}, max|x| {x_max}")
    events = int(skel.n_valid.sum()) - B
    del skel, xs
    print(f"{what}: SpeedUpZigZagAD({d}, cauchy) B={B} n_sk={n_sk} f32 events={events} "
          f"launches={launches}; complete, finite, t non-decreasing; {CAUCHY_SAMPLES} "
          f"samples per chain: |median| {med:.4f} < 0.1, quartiles "
          f"{float(pooled[0]):.4f} {float(pooled[2]):.4f} within {q_err:.4f} < 0.15 of -1 "
          f"and 1, each coordinate's within {per_err:.4f} < 0.25, max|x| {x_max:.1f} > 5; "
          f"{walls_text(walls, events)} ({card_name})", flush=True)
    out = tag_breakdown("phase 34b suzz_cauchy_d10", sampler, x0, v0, n_sk, launches,
                        float(np.median(walls)), K4_F32_SHARE)
    return launches, out


def phase_neal_funnel(card_name):
    """Phase 35, ``zigzag_neal_funnel_d10``: ZigZagAD(10, neal_funnel), 8192
    chains x 2048 points, x0 = 0, v0 = 1, f32 (the flagship's shape on
    Neal's funnel), K1 and K2 on the card; then the kernel route and the
    transition engine (``backend="xla_stream"``, the route a user of this
    target took before the funnels had a device tag; same seed, independent
    trajectories) at ``NEAL_ROUTES`` points, one call each, the engine's
    timed.  Gate: the two routes' pooled means of x[0] there differ by < 0.15
    and their variances by < 10%; the 2048-point kernel route's
    mean and variance against the truth (0, 9) printed, without a gate (the
    Zig-Zag's bias in the funnel's neck at 2048 events).  Then the kernel
    route's breakdown and split (35b).  Returns the counted launches,
    :func:`tag_breakdown`'s numbers, the engine route's K2 entry and the
    kernel route's x[0] mean and variance (phase 38's reference)."""
    d, B, n_sk = NEAL_D10
    what = "phase 35 zigzag_neal_funnel_d10"
    sampler = pt.ZigZagAD(d, pt.potentials.neal_funnel)
    x0, v0 = np.zeros((B, d)), np.ones((B, d))
    skel, launches, walls = tag_calls(what, sampler, n_sk, x0, v0, TAG_CALLS)
    if launches["zigzag_chunk"] < 1 or launches["compact_rows"] < 1:
        raise AssertionError(f"{what}: the path missed a kernel: {launches}")
    mean_k, var_k = pt.pooled_moments(skel, sampler, 256)
    events = int(skel.n_valid.sum()) - B
    del skel
    # the two routes compared at NEAL_ROUTES points: the kernel route again there
    t0 = time.perf_counter()
    kskel = pt.sample_skeleton(sampler, NEAL_ROUTES, x0, v0, seed=0, dtype=torch.float32,
                               device=DEV)
    sync()
    k_wall = time.perf_counter() - t0
    check_complete(f"{what} at {NEAL_ROUTES} points", kskel, NEAL_ROUTES)
    mean_r, var_r = pt.pooled_moments(kskel, sampler, 256)
    del kskel
    eskel, e_wall, k2_n, chunks, transitions, eng_ms, first = engine_call(
        sampler, NEAL_ROUTES, x0, v0, seed=0, backend="xla_stream")
    check_complete(f"{what} engine route", eskel, NEAL_ROUTES)
    e_events = int(eskel.n_valid.sum()) - B
    mean_e, var_e = pt.pooled_moments(eskel, sampler, 256)
    del eskel
    m_k, v_k = float(mean_k[0]), float(var_k[0])
    m_r, m_e, v_r, v_e = (float(a[0]) for a in (mean_r, mean_e, var_r, var_e))
    if not (abs(m_r - m_e) < 0.15 and abs(v_r / v_e - 1) < 0.1):
        raise AssertionError(f"{what}: x[0] mean {m_r:.4f} (kernel) vs {m_e:.4f} (engine), "
                             f"variance {v_r:.4f} vs {v_e:.4f} at {NEAL_ROUTES} points")
    k2e = engine_k2_check(f"{what} engine route", first)
    del first
    print(f"{what}: ZigZagAD({d}, neal_funnel) B={B} n_sk={n_sk} f32 events={events} "
          f"launches={launches}; complete, finite, t non-decreasing; "
          f"{walls_text(walls, events)}; x[0] mean {m_k:.4f}, variance {v_k:.4f} "
          f"(truth 0, 9; not gated); at {NEAL_ROUTES} points (cut from {n_sk}) the kernel "
          f"route's x[0] mean {m_r:.4f}, variance {v_r:.4f}, and the engine route "
          f"(backend='xla_stream'): one call "
          f"{e_wall:.4f} s ({e_events / e_wall:.1f} events/s), {chunks} chunks, {transitions} "
          f"transitions, {engine_split(e_wall, k2_n, k2e[1], eng_ms)}, x[0] mean {m_e:.4f}, "
          f"variance {v_e:.4f}: the means differ by {abs(m_r - m_e):.4f} < 0.15, the "
          f"variances by {abs(v_r / v_e - 1):.2%} < 10%; the engine route's time is "
          f"{e_wall / k_wall:.1f}x the kernel route's there ({k_wall:.4f} s, one call) "
          f"({card_name})",
          flush=True)
    out = tag_breakdown("phase 35b zigzag_neal_funnel_d10", sampler, x0, v0, n_sk, launches,
                        float(np.median(walls)), K1_F32_SHARE)
    return launches, out, (k2_n, *k2e), (m_k, v_k)


# ---------------------------------------------------------------------------
# Phases 36-38: gradients of the user's own, lowered into generated potentials
# (ops/cuda/lower.py) that every chunk kernel takes (potential id 7)
# ---------------------------------------------------------------------------

STUDENT_NU = 5.0
STUDENT_VAR = STUDENT_NU / (STUDENT_NU - 2.0)  # 5/3
STUDENT_P0 = math.exp(math.lgamma(3.0) - math.lgamma(2.5)) / math.sqrt(5.0 * math.pi)
"""The Student-t (nu = 5) density at 0, which sets the sticky target's atom."""
STICKY_STUDENT_STREAM = (131072, 16384, 32)  # phase 37: K6's law run: events per chain,
                                             # grid points, windows
USER_CALLS = 5                  # phase 36: timed warm calls of each user gradient
USER_SCALES = np.linspace(0.5, 3.0, 10)  # phase 37: the user-written anisotropic Gaussian
DENSE_RUN = (512, 256)          # phase 38: chains, points of the dense and refused gradients' runs


def student_t(x):
    """Student-t with 5 degrees of freedom, written by a user:
    ``U = 3 sum log1p(x^2 / 5)``; no device tag covers it."""
    return 3.0 * torch.sum(torch.log1p(x * x / 5.0))


def user_neal_funnel(x):
    """Neal's funnel as a user writes it (``x[0]``, a sum over ``x[1:]`` and
    ``exp(-x[0])``), untagged."""
    return (x[0] * x[0] / 18.0 + 0.5 * (x.shape[0] - 1) * x[0]
            + 0.5 * torch.sum(x[1:] ** 2) * torch.exp(-x[0]))


def user_hierarchical(x):
    """A hierarchical mean: ``U = x0^2 / 2 + sum((x[1:] - x[0])^2) / 2``;
    coordinate 0's gradient sums ``x_j - x_0``, a sum that reads coordinate
    0 at every coordinate, which every warp of K6 reads."""
    return x[0] ** 2 / 2 + torch.sum((x[1:] - x[0]) ** 2) / 2


def dense_gradient():
    """``g = A x`` for a seeded 10 x 10 SPD ``A`` closed over on the card (phase
    38's dense coupling, which K1 forms at every point)."""
    rs = np.random.default_rng(38)
    a = rs.normal(size=(10, 10))
    A = torch.as_tensor(a @ a.T / 10 + np.eye(10), dtype=torch.float32, device=DEV)
    return lambda x: A.to(x) @ x


def running_product(x):
    """A gradient the lowering refuses: a running product (``aten.cumprod``)."""
    return x + 0.1 * torch.cumprod(torch.tanh(x), 0)


def user_aniso():
    """The anisotropic Gaussian with scales ``USER_SCALES`` closed over as a
    tensor on the card: the lowering hoists them into the parameters."""
    s = torch.as_tensor(USER_SCALES, device=DEV)
    return lambda x: torch.sum((x / s.to(x)) ** 2) / 2


USER_PATHS = {
    "bench_zigzag_d10": (lambda: pt.ZigZag(10, lambda x: x), MAIN),
    "readme_zigzag_ad_d10": (lambda: pt.ZigZagAD(10, lambda x: torch.sum(x ** 2) / 2), MAIN),
    "student_t_zigzag_d10": (lambda: pt.ZigZagAD(10, student_t), MAIN),
    "student_t_sticky_d1000": (lambda: pt.StickyZigZagAD(STICKY[0], student_t,
                                                         np.full(STICKY[0], STICKY[3])),
                               STICKY[:3]),
    "student_t_bps_d10": (lambda: pt.BPSAD(10, student_t, refresh_rate=BPS_D10[3]),
                          BPS_D10[:3]),
    "student_t_suzz_d10": (lambda: pt.SpeedUpZigZagAD(10, student_t), SUZZ_D10),
    "user_aniso_bps_d10": (lambda: pt.BPSAD(10, user_aniso(), refresh_rate=BPS_D10[3]),
                           BPS_D10[:3]),
    "user_neal_zigzag_d10": (lambda: pt.ZigZagAD(10, user_neal_funnel), NEAL_D10),
    "user_neal_suzz_d10": (lambda: pt.SpeedUpZigZagAD(10, user_neal_funnel), SUZZ_D10),
    "user_hier_sticky_d1000": (lambda: pt.StickyZigZagAD(STICKY[0], user_hierarchical,
                                                         np.full(STICKY[0], STICKY[3])),
                               STICKY[:3]),
    "user_dense_zigzag_d10": (lambda: pt.ZigZag(10, dense_gradient()), (10, *DENSE_RUN)),
}
"""Phases 36-38's deployments of gradients of the user's own: the sampler
and (d, chains, points), each at the shape of the repo deployment it names."""
# one sampler per path, so that the phases find ``user_lowerings``' work done
USER_PATHS = {path: (cache(make), shape) for path, (make, shape) in USER_PATHS.items()}


def user_lowerings():
    """Every gradient of phases 36-47 lowered as its phase runs it (float32
    for the runs, float64 for the checks against the plain version), on the
    samplers the phases take (the path functions are cached), so that the
    phases find each lowering done; a lane past ``LANE_BYTES`` is never
    launched (its sampler takes the engine) and is left out."""
    samplers = [make() for make, _ in USER_PATHS.values()]
    samplers += [s for s, *_ in dense_paths().values()]
    samplers += [s for s, *_ in band_paths().values()] + list(neal_last_parity()[0].values())
    samplers += [s for s, *_ in dense_ar1_paths().values()]
    pairs = [(s, dt) for s in samplers for dt in (torch.float32, torch.float64)]
    # phase 44: its runs in float32, its parity launches in float64
    pairs += [(s, torch.float32) for s, *_ in lse_paths().values()]
    pairs += [(s, torch.float32) for s in lse_launch_samplers().values()]
    pairs += [(lse_coords_sampler(), torch.float32)]
    for _, s, _, fit in lse_parity_samplers():
        pairs += [(s, torch.float64)] + ([] if fit is None else [(fit, torch.float64)])
    # phase 45: its runs in float32, its parity launches in float64
    pairs += [(s, torch.float32) for s, _ in scan_paths().values()]
    pairs += [(s, torch.float32) for s in scan_launch_samplers().values()]
    pairs += [(s, torch.float64) for _, s, _, _ in scan_parity_samplers()]
    # phase 46: its runs in float32, its parity launches in float64
    pairs += [(s, torch.float32) for s, _ in gather_paths().values()]
    pairs += [(s, torch.float32) for s in gather_launch_samplers().values()]
    pairs += [(gather_stall_sampler(), torch.float32)]
    pairs += [(s, torch.float64) for _, s, _, _ in gather_parity_samplers()]
    # phase 47: its runs in float32, its parity launches in float64
    pairs += [(s, torch.float32) for s, _ in regression_paths().values()]
    pairs += [(s, torch.float32) for s in regression_launch_samplers().values()]
    pairs += [(s, torch.float64) for _, s, _ in regression_parity_samplers()]
    lows = [lower.lower_sampler(s, driver.kernel_kind(s), s.dim, dt, DEV) for s, dt in pairs]
    return [low for low in lows if lower.lane_fits(low)] + list(regression_barrier()[1].values())


def build_cpus():
    """The host's cores the user builds take: all this process may run on
    but the first core and its hyperthread siblings (read from sysfs), which
    stay free for the phases' host loop; all of them on a host of two or
    fewer."""
    cpus = sorted(os.sched_getaffinity(0))
    first = {cpus[0]}
    try:
        text = Path(f"/sys/devices/system/cpu/cpu{cpus[0]}/topology/"
                    "thread_siblings_list").read_text()
        for part in text.strip().split(","):
            a, _, b = part.partition("-")
            first |= set(range(int(a), int(b or a) + 1))
    except (OSError, ValueError):
        pass
    if len(first) == 1 and len(cpus) > 1:
        first.add(cpus[1])
    rest = [c for c in cpus if c not in first]
    return rest if rest else cpus


class UserBuilds:
    """Phases 36-47's user libraries, made beside phases 1-35: a thread
    lowers every gradient (:func:`user_lowerings`) while phase 1's ``nvcc``
    runs, then builds the libraries one ``nvcc`` per core of
    :func:`build_cpus`, each ``nvcc`` at the lowest priority and held to
    those cores, so that the phases' host loop keeps a core of its own.
    The main thread waits for :attr:`lowered` before its next card work and
    for :meth:`result` before phase 36; a library a phase needs earlier is
    built once (``build.user_library`` locks each)."""

    def __init__(self):
        self.lowered = threading.Event()
        self.cpus = build_cpus()
        self.lows, self.error, self.stop = [], None, False
        self.t0 = time.perf_counter()
        self.wall = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _background(self):
        """A pool thread's own priority and cores (Linux keeps both per
        thread), which the ``nvcc`` it starts inherits."""
        tid = threading.get_native_id()
        os.setpriority(os.PRIO_PROCESS, tid, 19)
        os.sched_setaffinity(tid, self.cpus)

    def _build(self, low):
        if not self.stop:
            low.library()

    def _run(self):
        try:
            self.lows = user_lowerings()
        except BaseException as exc:  # handed to the main thread by wait_lowered/result
            self.error = exc
            return
        finally:
            self.lowered.set()
        try:
            with ThreadPoolExecutor(len(self.cpus), initializer=self._background) as ex:
                list(ex.map(self._build, self.lows))
        except BaseException as exc:
            self.error = exc
        self.wall = time.perf_counter() - self.t0

    def wait_lowered(self):
        self.lowered.wait()
        if self.error is not None:
            raise self.error

    def result(self):
        """Wait for the builds; returns (seconds from the start to the last
        library, seconds the main thread waited here, cores, {library:
        seconds}, ptxas text)."""
        t0 = time.perf_counter()
        self.thread.join()
        waited = time.perf_counter() - t0
        if self.error is not None:
            raise self.error
        secs, texts = {}, []
        for path, info in build.BUILD_INFO["user"].items():
            name = Path(path).name
            secs[name] = info["seconds"]
            kernels = ptxas_kernels(info["log"])
            spills = sum(st for _, _, st, _ in kernels.values())
            texts.append(f"{name}: {info['seconds'] or 0:.1f} s, registers "
                         f"{sorted({r for r, *_ in kernels.values()})}, stack frames "
                         f"{sorted({f for _, f, _, _ in kernels.values()})} B, {spills} B "
                         "spill stores")
        return self.wall, waited, len(self.cpus), secs, "; ".join(texts)

    def close(self):
        """Start no further ``nvcc`` and wait for those running (a failed
        phase leaves no compile behind)."""
        self.stop = True
        self.thread.join()


def user_config(sampler, K, cap, dtype):
    """The card config of a user gradient's sampler: :func:`card_config`
    made the generated potential's (``driver.lowered_config``)."""
    cfg = card_config(sampler, K, cap, dtype)
    return driver.lowered_config(cfg, sampler, sampler.dim, dtype, DEV)


def path_launch(sampler):
    """The :data:`build.LAUNCHES` key of a sampler's chunk kernel."""
    kind = driver.kernel_kind(sampler)
    if kind in k3.KINDS:
        return k3.launch_name(kind)
    return k1.launch_name(card_config(sampler, 32, 1, torch.float32))


def chunk_fns(cfg):
    return ((k3.run_chunk, k3.run_chunk_plain) if cfg.kind in k3.KINDS
            else (k1.run_chunk, k1.run_chunk_plain))


def user_compare(what, sampler, B, bitwise, math_tag=None, n_chunks=2, horizon=False, K=32,
                 user=None):
    """A user gradient's kernel against its plain version fed the IR's torch
    pair, ``n_chunks`` chunks of ``K`` from one f64 random state (every fifth
    chain capped inside the run; in horizon mode, K7, a float32 target at the
    median clock that freezes a share of the lanes inside the run): integers
    equal, floats bit for bit where
    ``bitwise`` (K3/K5, K4: where the math function of ``math_tag``'s
    gradient, as :func:`bit_tolerance` reads it, parts the two a bit, the
    first part is printed and the check takes ``RTOL``) else to
    ``RTOL``/``ATOL`` (K1, K6); ``user``: the lowered potential the card's
    kernel takes, in place of the sampler's (a library built otherwise).
    Returns (max abs err, events, ms of the plain version's first chunk by
    CUDA events)."""
    d = sampler.dim
    scale = 0.3 if sampler.sticky else 1.0
    state = random_state(sampler, B, torch.float64, d + B, scale=scale)
    if driver.kernel_kind(sampler) in k3.KINDS:
        v = state.v / state.v.norm(dim=1, keepdim=True)
        state = state._replace(v=v)
    counts = torch.zeros(B, dtype=torch.int32, device=DEV)
    counts[::5] = 40
    cfg = user_config(sampler, K, 48, torch.float64)
    run, plain = chunk_fns(cfg)
    st_k = driver.chunk_state(state, counts, sampler.sticky)
    if horizon:
        cfg = cfg._replace(t_target=median_target(run, st_k, cfg, K, n_chunks, 314159))
    kcfg = cfg if user is None else cfg._replace(user=user)
    st_p = clone_state(st_k)
    fill_k, fill_p = (k1.empty_fill(K * n_chunks, d, B, torch.float64, DEV, sampler.sticky)
                      for _ in range(2))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for it in range(n_chunks):
        seed = 314159 + it * 1000003
        run(seed, st_k, fill_k, it * K, kcfg)
        sync()
        if it == 0:
            start.record()
        plain(seed, st_p, fill_p, it * K, cfg)
        if it == 0:
            end.record()
    sync()
    plain_ms = start.elapsed_time(end)
    rtol, atol = RTOL, ATOL
    if bitwise:
        rtol, atol = bit_tolerance(what, math_tag, st_k, fill_k, st_p, fill_p)
    err = 0.0
    for (name, a), (_, b) in zip(chunk_outputs(st_k, fill_k), chunk_outputs(st_p, fill_p)):
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: output {name} differs at "
                                     f"{int((a != b).sum())} places")
        else:
            err = max(err, float_err(what, name, a, b, rtol, atol))
    n_ev = int((fill_k.kind[:, 0] > 0).sum())
    if n_ev < B // 2:
        raise AssertionError(f"{what}: only {n_ev} events in the check")
    target_share(st_k, cfg)
    return err, n_ev, plain_ms


def user_chunk(what, sampler, x0, v0, share_min, K=32, reps=20, plain_reps=2):
    """One f32 chunk of ``K`` transitions of a user gradient's kernel at its
    deployment's shape and start against its plain version
    (``compare_f32``), each timed (the plain version on that compared
    launch where ``plain_reps`` is 0), and the bound.  Returns (ms, plain
    ms, bound, max abs err, text)."""
    B, d = x0.shape
    seed = 7
    state = sampler.init_state_batch(x0, v0, 0, torch.float32, DEV)
    cfg = user_config(sampler, K, 1 << 30, torch.float32)
    run, plain = chunk_fns(cfg)
    st = driver.chunk_state(state, torch.zeros(B, dtype=torch.int32, device=DEV),
                            sampler.sticky)
    st_p = clone_state(st)
    vc = st.v.clone()
    fill, fill_p = (k1.empty_fill(K, d, B, torch.float32, DEV, sampler.sticky)
                    for _ in range(2))
    run(seed, st, fill, 0, cfg)
    sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    plain(seed, st_p, fill_p, 0, cfg)
    end.record()
    sync()
    agree, share, err, texts = compare_f32(f"{what} f32", vc, st, fill, st_p, fill_p, cfg,
                                           seed, share_min)
    del st_p, fill_p
    b = chunk_bound(cfg, st, fill, K * B)
    ms = cuda_ms(lambda: run(seed, st, fill, 0, cfg), reps)
    plain_ms = (cuda_ms(lambda: plain(seed, st, fill, 0, cfg), plain_reps) if plain_reps
                else start.elapsed_time(end))
    text = (f"f32 chunk (K={K}) {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
            f"{bound_text(b)}; kinds agree on {agree:.6f}, max_abs_err {err:.3e} on the "
            f"{share:.4f} of chains with equal decisions (want >= {share_min}); the others "
            f"left at f32 rounding ties: {'; '.join(texts) or 'none'}")
    return ms, plain_ms, b, err, text


def user_call(what, sampler, n_or_T, x0, v0, calls, device_ms=None, **kw):
    """A user gradient's ``sample_skeleton`` under ``backend="auto"``: one
    warm call (its lowering; its library is built), then ``calls`` timed
    calls, the launches and engine counts of the first set to 0 just before
    it; that call must take its chunk kernel and K2 and no engine chunk.
    ``device_ms``: a list that takes each timed call's chunk-kernel time,
    CUDA events around every launch (:class:`DeviceTimes`).  Returns (the
    counted call's skeleton, launches, walls)."""
    kw = dict(seed=0, dtype=torch.float32, device=DEV, **kw)
    pt.sample_skeleton(sampler, n_or_T, x0, v0, **kw)
    sync()
    walls = []
    chunk = k3 if driver.kernel_kind(sampler) in k3.KINDS else k1
    for call in range(calls):
        if call == 0:
            build.reset_launches()
            engine.reset_counts()
        with (nullcontext() if device_ms is None else DeviceTimes(chunk, "run_chunk")) as times:
            t0 = time.perf_counter()
            skel = pt.sample_skeleton(sampler, n_or_T, x0, v0, **kw)
            sync()
            walls.append(time.perf_counter() - t0)
        if device_ms is not None:
            device_ms.append(times.total_ms())
        if call == 0:
            launches, chunks, checked = dict(build.LAUNCHES), engine.COUNTS["chunks"], skel
    name = path_launch(sampler)
    others = {k: n for k, n in launches.items() if n and k not in (name, "compact_rows")}
    if launches[name] < 1 or launches["compact_rows"] < 1 or others or chunks:
        raise AssertionError(f"{what}: the path did not take {name} and K2 alone: "
                             f"{launches}, {chunks} engine chunks")
    check_complete(what, checked, n_or_T)
    return checked, launches, walls


def skeleton_diff(a, b):
    """None where two skeletons are equal bit for bit, else the first field
    that differs and where."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor) and not torch.equal(x, y):
            i = np.unravel_index(int((x != y).reshape(-1).nonzero()[0, 0]), tuple(x.shape))
            return f"{f}{list(i)}: {x[i].item()!r} vs {y[i].item()!r}"
    return None


def phase_user_main(card_name, builds):
    """Phase 36, the slice's main path at full width: ``bench.py``'s
    ``ZigZag(10, lambda x: x)`` and the README's ``ZigZagAD(10, lambda x:
    torch.sum(x**2) / 2)``, 8192 chains x 2048 points, float32, x0 = 0,
    v0 = 1, ``backend="auto"``: each lowered (``g = y``, ``dg = v``; the 2
    and 1/2 of the README's are exact), each taking K1 and K2 and no engine
    chunk, each held bit for bit against phase 4's tagged ``grad_gauss`` run
    from the same seed, and passing bench.py's moment bands; five timed
    calls each; then one f32 K=32 chunk of K1 on each potential against its
    plain version, timed.  Returns {path: (launches, ms, plain ms, bound,
    err)}."""
    d, B, n_sk = MAIN
    x0, v0 = np.zeros((B, d)), np.ones((B, d))
    tagged = pt.sample_skeleton(pt.ZigZag(d, pt.potentials.grad_gauss), n_sk, x0, v0,
                                seed=0, dtype=torch.float32, device=DEV)
    out, texts = {}, []
    for path in ("bench_zigzag_d10", "readme_zigzag_ad_d10"):
        sampler = USER_PATHS[path][0]()
        skel, launches, walls = user_call(f"phase 36 {path}", sampler, n_sk, x0, v0,
                                          USER_CALLS)
        diff = skeleton_diff(skel, tagged)
        if diff is not None:
            raise AssertionError(f"phase 36 {path}: differs from the tagged grad_gauss run "
                                 f"at {diff}")
        mean, var = pt.pooled_moments(skel, sampler, 256)
        if not moments_ok(mean, var):
            raise AssertionError(f"phase 36 {path}: moments off: mean {mean.tolist()} "
                                 f"var {var.tolist()}")
        events = int(skel.n_valid.sum()) - B
        del skel
        ms, plain_ms, b, err, chunk_text = user_chunk(f"phase 36 {path} K1", sampler, x0, v0,
                                                      K1_F32_SHARE)
        out[path] = (launches, ms, plain_ms, b, err)
        header = lower.lower_sampler(sampler, "zigzag", d, torch.float32, DEV)
        texts.append(
            f"{path} ({'ZigZag(10, lambda x: x)' if path.startswith('bench') else 'ZigZagAD(10, lambda x: torch.sum(x**2) / 2)'}; "
            f"generated g = {header.out[0].e.text()}): K1 {launches['zigzag_chunk']} launches, "
            f"K2 {launches['compact_rows']}, 0 engine chunks; every skeleton field bit for bit "
            f"the tagged grad_gauss run's; max|mean| {float(mean.abs().max()):.4f}, "
            f"max|var-1| {float((var - 1).abs().max()):.4f} (bench.py's bands); "
            f"{walls_text(walls, events)}; K1 {chunk_text}")
    del tagged
    wall, waited, cores, secs, ptx = builds
    print(f"phase 36 the main path on gradients of the user's own (B={B}, d={d}, "
          f"n_sk={n_sk}, f32, backend='auto'): {'; '.join(texts)}; user builds (phases "
          f"36-46, {len(secs)} libraries, lowered and built beside phases 1-35, one nvcc per "
          f"core on {cores} cores at nice 19): done {wall:.1f} s after the "
          f"script's start, phase 36 waited {waited:.1f} s for them; {ptx} "
          f"({card_name})", flush=True)
    return out


def t5_law(what, mean, var, w=0.0, per_coordinate=True):
    """The Student-t gate: |mean| < 0.1 (each coordinate's, or the
    coordinate-pooled mean where ``per_coordinate`` is False) and the
    coordinate-pooled variance within 10% of (1 - w) 5/3 (w the sticky
    target's atom at 0).  Returns its text."""
    mean, var = mean.double().cpu(), var.double().cpu()
    want = (1.0 - w) * STUDENT_VAR
    m = float(mean.abs().max()) if per_coordinate else abs(float(mean.mean()))
    v = float(var.mean())
    if not (m < 0.1 and abs(v / want - 1.0) < 0.1):
        raise AssertionError(f"{what}: Student-t law off: |mean| {m:.4f}, pooled variance "
                             f"{v:.4f} against {want:.4f}")
    return (f"{'max' if per_coordinate else 'pooled'} |mean| {m:.4f} < 0.1, pooled variance "
            f"{v:.4f} within {abs(v / want - 1):.2%} < 10% of {want:.4f}; each coordinate's "
            f"variance within {float((var / want - 1).abs().max()):.2%}")


def phase_user_kernels(card_name):
    """Phase 37, a gradient no tag covers on every chunk kernel: the
    Student-t (nu = 5) on K1 at the flagship shape, K6 at
    ``sticky_zigzag_d1000`` (kappa = 10), K3 at ``bps_anisotropic_gauss_d10``'s
    shape (refresh 0.5) and K4 at ``suzz_gauss_d10``'s, and a user-written
    anisotropic Gaussian whose scales are hoisted into the parameters on K3.
    Each kernel against its plain version fed the IR's pair in f64 (K3 and K4
    bit for bit, K1 and K6 to ``RTOL``); each deployment one warm and one
    counted call (x0 = 0, v0 = 1; K6 x0 = 0.3) with its law: the Student-t's
    |mean| < 0.1 and variance within 10% of 5/3 (K6: of (1 - w) 5/3 from a
    streaming run of ``STICKY_STUDENT_STREAM``'s events per chain, the
    coordinate-pooled mean, and the frozen share printed beside w), the
    anisotropic one as phase 10's BPS gate.  Then one f32 K=32 chunk per path
    against its plain version, timed.  Returns {path: (launches, ms, plain ms,
    bound, err)}."""
    out, texts = {}, []
    cases = (("student_t_zigzag_d10", False, K1_F32_SHARE),
             ("student_t_sticky_d1000", False, K6_F32_SHARE),
             ("student_t_bps_d10", True, K3_F32_SHARE),
             ("student_t_suzz_d10", True, K4_F32_SHARE),
             ("user_aniso_bps_d10", True, K3_F32_SHARE))
    for path, bitwise, share in cases:
        make, (d, B, n_sk) = USER_PATHS[path]
        sampler = make()
        what = f"phase 37 {path}"
        err64, n_ev, _ = user_compare(what, sampler, B, bitwise)
        x0 = np.full((B, d), 0.3) if sampler.sticky else np.zeros((B, d))
        v0 = np.ones((B, d))
        skel, launches, walls = user_call(what, sampler, n_sk, x0, v0, 1)
        events = int(skel.n_valid.sum()) - B
        if path.startswith("user_aniso"):
            mean, var = (a.double().cpu().numpy() for a in pt.pooled_moments(skel, sampler, 256))
            rel = var / USER_SCALES ** 2 - 1.0
            if not (np.all(np.abs(mean) < 0.1 * USER_SCALES) and np.all(np.abs(rel) < 0.1)):
                raise AssertionError(f"{what}: moments off: mean {mean.tolist()} var/s^2 - 1 "
                                     f"{rel.tolist()}")
            law = (f"max|mean/s| {float(np.max(np.abs(mean) / USER_SCALES)):.4f} < 0.1, "
                   f"max|var/s^2-1| {float(np.max(np.abs(rel))):.4f} < 0.1; parameters "
                   f"{sampler._lowered[('bps', d, torch.float32)].params.numel()} hoisted")
        elif sampler.sticky:
            t_end = float(skel.t[:, -1].double().median())
            rate = (n_sk - 1) / t_end
            events_goal, n_samples, n_batches = STICKY_STUDENT_STREAM
            T = events_goal / rate
            t0 = time.perf_counter()
            build.reset_launches()
            run = pt.sample_streaming_stats(sampler, T, x0, v0, n_samples=n_samples,
                                            n_batches=n_batches, seed=2, dtype=torch.float32,
                                            device=DEV)
            sync()
            s_wall = time.perf_counter() - t0
            s_launches = build.LAUNCHES["sticky_chunk_horizon"]
            summ = pt.streaming_summary(run)
            w = STUDENT_P0 / (sampler.kappa[0].item() + STUDENT_P0)
            frozen = 1.0 - float(run.state.is_active.float().mean())
            law = (t5_law(what, torch.as_tensor(summ["pooled_mean"]),
                          torch.as_tensor(summ["pooled_var"]), w, per_coordinate=False)
                   + f"; frozen share {frozen:.4f} beside w = {w:.4f}; from a streaming run "
                   f"to T = {T:.6g} ({run.events / B:.0f} events per chain, {run.fills} fills, "
                   f"{s_launches} sticky_chunk_horizon launches, {s_wall:.3f} s)")
            if s_launches < 1:
                raise AssertionError(f"{what}: the streaming run missed K6")
        else:
            law = t5_law(what, *pt.pooled_moments(skel, sampler, 256))
        del skel
        ms, plain_ms, b, err32, chunk_text = user_chunk(what, sampler, x0, v0, share)
        name = path_launch(sampler)
        out[path] = (launches, ms, plain_ms, b, max(err64, err32))
        texts.append(f"{path} ({type(sampler).__name__} d={d} B={B} n_sk={n_sk}): {name} vs "
                     f"plain f64 {'bit for bit' if bitwise else f'rtol {RTOL}'} "
                     f"max_abs_err={err64:.3e} ({n_ev} events); counted call {name} "
                     f"{launches[name]} launches, K2 {launches['compact_rows']}, 0 engine "
                     f"chunks, {events} events in {walls[0]:.4f} s; {law}; {chunk_text}")
    print(f"phase 37 a gradient no tag covers on every chunk kernel: {'; '.join(texts)} "
          f"({card_name})", flush=True)
    return out


def phase_user_reductions(card_name, neal_tagged):
    """Phase 38, sums over coordinates and a refusal.  A user-written Neal
    funnel (``x[0]``, ``torch.sum(x[1:]**2)``, ``torch.exp(-x[0])``): on K1
    at ``zigzag_neal_funnel_d10``'s shape (8192 chains x 2048 points) held
    against phase 35's tagged run (``neal_tagged``: x[0]'s mean and variance),
    and on K4 at ``suzz_gauss_d10``'s shape against the tagged
    SpeedUpZigZagAD(10, neal_funnel) from the same seed: x[0]'s means within
    0.15, variances within 10%; each kernel against its plain version in f64
    (K1 to ``RTOL``; K4 bit for bit, where exp parts the two a bit, the first
    part printed and ``RTOL``).  K6 at ``sticky_zigzag_d1000``'s shape on a
    hierarchical mean, whose sum reads coordinate 0 in every warp, against
    its plain version in f64 to ``RTOL``.  Then a dense ``A @ x`` (A a seeded
    10 x 10 SPD matrix) takes K1 and K2 under ``"auto"``, and a running product
    (``cumprod``) raises ``LoweringError`` there before any build or launch,
    naming the aten op and ``backend="xla_stream"``, and runs on the engine
    under that backend.  Returns {path: (launches, ms, plain ms, bound,
    err)}, and the K1 funnel's x[0] mean and variance (phase 42's reference)."""
    out, texts, moments = {}, [], {}
    refs = {"user_neal_zigzag_d10": neal_tagged}
    d, B, n_sk = SUZZ_D10
    x0, v0 = np.zeros((B, d)), np.ones((B, d))
    tagged = pt.sample_skeleton(pt.SpeedUpZigZagAD(d, pt.potentials.neal_funnel), n_sk, x0,
                                v0, seed=0, dtype=torch.float32, device=DEV)
    mean, var = pt.pooled_moments(tagged, pt.SpeedUpZigZagAD(d, pt.potentials.neal_funnel),
                                  256)
    refs["user_neal_suzz_d10"] = (float(mean[0]), float(var[0]))
    del tagged
    for path, bitwise, share in (("user_neal_zigzag_d10", False, K1_F32_SHARE),
                                 ("user_neal_suzz_d10", True, K4_F32_SHARE)):
        make, (d, B, n_sk) = USER_PATHS[path]
        sampler = make()
        what = f"phase 38 {path}"
        err64, n_ev, _ = user_compare(what, sampler, B, bitwise, math_tag="neal_funnel")
        x0, v0 = np.zeros((B, d)), np.ones((B, d))
        skel, launches, walls = user_call(what, sampler, n_sk, x0, v0, 1)
        mean, var = pt.pooled_moments(skel, sampler, 256)
        events = int(skel.n_valid.sum()) - B
        del skel
        m, v = float(mean[0]), float(var[0])
        moments[path] = (m, v)
        m_t, v_t = refs[path]
        if not (abs(m - m_t) < 0.15 and abs(v / v_t - 1.0) < 0.1):
            raise AssertionError(f"{what}: x[0] mean {m:.4f} vs the tag's {m_t:.4f}, "
                                 f"variance {v:.4f} vs {v_t:.4f}")
        ms, plain_ms, b, err32, chunk_text = user_chunk(what, sampler, x0, v0, share)
        name = path_launch(sampler)
        low = lower.lower_sampler(sampler, driver.kernel_kind(sampler), d, torch.float32, DEV)
        out[path] = (launches, ms, plain_ms, b, max(err64, err32))
        texts.append(f"{path} ({type(sampler).__name__} d={d} B={B} n_sk={n_sk}; sums "
                     f"{[[p.e.text() for p in r] for r in low.reductions]}): {name} vs plain "
                     f"f64 max_abs_err={err64:.3e} ({n_ev} events); counted call {name} "
                     f"{launches[name]} launches, 0 engine chunks, {events} events in "
                     f"{walls[0]:.4f} s; x[0] mean {m:.4f} vs the tag's {m_t:.4f} (within "
                     f"{abs(m - m_t):.4f} < 0.15), variance {v:.4f} vs {v_t:.4f} (within "
                     f"{abs(v / v_t - 1):.2%} < 10%); {chunk_text}")
    # K6 on a sum that reads coordinate 0 in every warp, against its plain
    # version in f64 (a read of coordinate 0 before the flow that moved it
    # shows here)
    path = "user_hier_sticky_d1000"
    make, (d, B, _) = USER_PATHS[path]
    sampler = make()
    low = lower.lower_sampler(sampler, "sticky", d, torch.float64, DEV)
    if "reads_others = true" not in low.header():
        raise AssertionError(f"phase 38 {path}: its sum reads coordinate 0 but reads_others "
                             "is false")
    err_h, n_ev_h, _ = user_compare(f"phase 38 {path}", sampler, B, False)
    texts.append(f"{path} (StickyZigZagAD d={d} B={B}, U = x0^2/2 + sum((x[1:] - x[0])^2)/2; "
                 f"sums {[[p.e.text() for p in r] for r in low.reductions]}): sticky_chunk "
                 f"vs plain f64 max_abs_err={err_h:.3e} ({n_ev_h} events)")
    notes = "; ".join(n for n in MATH_NOTES if n.startswith("phase 38")) or "none"
    # a dense A @ x takes K1; the refusal: a running product
    d, (B, n_sk) = 10, DENSE_RUN
    x0, v0 = np.zeros((B, d)), np.ones((B, d))
    dense = USER_PATHS["user_dense_zigzag_d10"][0]()
    _, d_launches, d_walls = user_call("phase 38 dense A @ x", dense, n_sk, x0, v0, 1)
    refused = pt.ZigZag(d, running_product)
    builds_before = len(build.BUILD_INFO["user"])
    build.reset_launches()
    engine.reset_counts()
    try:
        pt.sample_skeleton(refused, n_sk, x0, v0, seed=0, dtype=torch.float32, device=DEV)
        raise AssertionError("phase 38: a running product ran under backend='auto'")
    except lower.LoweringError as e:
        msg = str(e)
    if ("aten.cumprod" not in msg or "backend='xla_stream'" not in msg
            or any(build.LAUNCHES.values()) or engine.COUNTS["transitions"]
            or len(build.BUILD_INFO["user"]) != builds_before):
        raise AssertionError(f"phase 38: the running product's refusal: {msg}; launches "
                             f"{dict(build.LAUNCHES)}")
    skel, e_wall, k2_n, chunks, transitions, _, _ = engine_call(refused, n_sk, x0, v0, seed=0,
                                                                backend="xla_stream")
    check_complete("phase 38 running product on the engine", skel, n_sk)
    del skel
    print(f"phase 38 sums and a refusal: {'; '.join(texts)}; bit-for-bit checks that parted "
          f"in exp: {notes}; dense A @ x (10 x 10 SPD, ZigZag(10, lambda x: A @ x), B={B}, "
          f"n_sk={n_sk}): K1 {d_launches['zigzag_chunk']} launches, K2 "
          f"{d_launches['compact_rows']}, 0 engine chunks, {d_walls[0]:.4f} s; a running "
          f"product (cumprod): 'auto' raises before any build or launch ({msg}); "
          f"backend='xla_stream' "
          f"ran it: {chunks} engine chunks, {transitions} transitions, {k2_n} K2 launches, "
          f"{e_wall:.3f} s ({card_name})", flush=True)
    return out, moments["user_neal_zigzag_d10"]


# ---------------------------------------------------------------------------
# Phases 39-41: gradients that couple coordinates through a constant matrix
# (A @ x, X^T sigma(X x)), and sums of any degree, formed at every point by
# the chunk kernels' generated potential
# ---------------------------------------------------------------------------

CORR_RHO = 0.9                      # phase 39: Sigma_ij = rho^|i - j|
LOGISTIC = (20, 1000, 1024, 2048)   # phase 40: d, rows, chains, points
LOGISTIC_PRIOR_SD = 10.0
DENSE_AR = (1000, 128, 2048, 10.0, 0.5)  # phase 41: d, chains, points, kappa, rho
DENSE_CALLS = 5                     # timed warm calls of each gated deployment
DENSE_PARITY_K = 16                 # phases 39-43: transitions of the f64 parity launch (cut
                                    # from 32 for phase 46's time)
LOGISTIC_CALLS = 1                  # phase 40's (cut from DENSE_CALLS for the script's time)


def ar1_precision(d, rho):
    """The inverse of the AR(1) covariance ``rho^|i - j|`` (float64, dense)."""
    idx = np.arange(d)
    return np.linalg.inv(rho ** np.abs(np.subtract.outer(idx, idx)))


def quadratic_form(P):
    """``U = x P x / 2`` as a user writes it, ``P`` closed over on the card."""
    Pt = torch.as_tensor(P, device=DEV)
    return lambda x: 0.5 * x @ (Pt.to(x) @ x)


def logistic_data():
    """The logistic regression's data from a fixed seed: ``X`` (an intercept
    column of ones and ``d - 1`` N(0, 1) covariates), labels drawn from
    Bernoulli(sigma(X b*)) with b* ~ N(0, 0.5^2 I)."""
    d, n, _, _ = LOGISTIC
    rs = np.random.default_rng(1000)
    X = np.concatenate([np.ones((n, 1)), rs.normal(size=(n, d - 1))], 1)
    beta = rs.normal(size=d) * 0.5
    y = (rs.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, y


def logistic_potential(X, y):
    """``U(b) = sum softplus(X b) - y . X b + |b|^2 / (2 10^2)``: the Bayesian
    logistic regression with a N(0, 10^2 I) prior, ``X`` and ``y`` closed
    over on the card."""
    Xt, yt = torch.as_tensor(X, device=DEV), torch.as_tensor(y, device=DEV)
    c = 1.0 / (2.0 * LOGISTIC_PRIOR_SD ** 2)

    def U(b):
        z = Xt.to(b) @ b
        return torch.sum(torch.nn.functional.softplus(z) - yt.to(b) * z) + c * (b @ b)

    return U


def logistic_laplace(X, y):
    """The MAP by Newton's method in float64 and the Laplace covariance (the
    inverse Hessian there)."""
    b = np.zeros(X.shape[1])
    for _ in range(50):
        p = 1.0 / (1.0 + np.exp(-X @ b))
        g = X.T @ (p - y) + b / LOGISTIC_PRIOR_SD ** 2
        H = X.T @ (X * (p * (1.0 - p))[:, None]) + np.eye(len(b)) / LOGISTIC_PRIOR_SD ** 2
        step = np.linalg.solve(H, g)
        b = b - step
        if np.max(np.abs(step)) < 1e-14:
            break
    return b, np.linalg.inv(H)


def quartic_sum(x):
    """``U = |x|^2 / 2 + log1p(sum x^4)``: a sum of degree 4 in x, which K1
    and K6 form at every point."""
    return x @ x / 2.0 + torch.log1p(torch.sum(x ** 4))


@cache
def dense_paths():
    """Phases 39-41's deployments: name -> (sampler, (d, chains, points),
    bit for bit against the plain version, math tag, start)."""
    X, y = logistic_data()
    logi = logistic_potential(X, y)
    corr = quadratic_form(ar1_precision(10, CORR_RHO))
    d, _, B, n_sk = LOGISTIC
    dd, dB, dn, kappa, rho = DENSE_AR
    dense = quadratic_form(ar1_precision(dd, rho))
    bps_d, bps_B, bps_n, bps_refresh = BPS_D10
    return {
        "zigzag_corr_gauss_d10": (pt.ZigZagAD(10, corr), MAIN, False, None, "ones"),
        "bps_corr_gauss_d10": (pt.BPSAD(10, corr, refresh_rate=bps_refresh),
                               (bps_d, bps_B, bps_n), True, None, "ones"),
        "zigzag_logistic_d20_n1000": (pt.ZigZagAD(d, logi), (d, B, n_sk), False,
                                      "logistic", "map"),
        "bps_logistic_d20_n1000": (pt.BPSAD(d, logi, refresh_rate=1.0), (d, B, n_sk), True,
                                   "logistic", "map"),
        "suzz_logistic_d20_n1000": (pt.SpeedUpZigZagAD(d, logi), (d, B, n_sk), True,
                                    "logistic", "map"),
        "boomerang_logistic_d20_n1000": (pt.BoomerangAD(d, logi, refresh_rate=1.0),
                                         (d, B, n_sk), True, "logistic", "map"),
        "ecmc_logistic_d20_n1000": (pt.ForwardECMCAD(d, logi), (d, B, n_sk), True,
                                    "logistic", "map"),
        "sticky_logistic_d20_n1000": (pt.StickyZigZagAD(d, logi, np.ones(d)), (d, B, n_sk),
                                      False, "logistic", "map"),
        "sticky_dense_ar1_d1000": (pt.StickyZigZagAD(dd, dense, np.full(dd, kappa)),
                                   (dd, dB, dn), False, None, "sticky"),
        "zigzag_quartic_d10": (pt.ZigZagAD(10, quartic_sum), MAIN, False, None,
                               "ones"),
        "sticky_quartic_d1000": (pt.StickyZigZagAD(dd, quartic_sum, np.full(dd, kappa)),
                                 (dd, dB, dn), False, None, "sticky"),
    }


def dense_start(sampler, start, B, d, b_map):
    """x0 and v0 of a deployment: x0 = 0 and v0 = 1 (phase 36's), x0 = 0.3
    (the sticky deployment's; ``"ar1"``: with v0 = 1 / sqrt(d) for the
    scalar-rate samplers), or x0 at the logistic MAP with v0 = +-1 from the
    seed (a unit normal for the scalar-rate samplers)."""
    if start == "ones":
        return np.zeros((B, d)), np.ones((B, d))
    if start == "sticky":
        return np.full((B, d), 0.3), np.ones((B, d))
    if start == "ar1":  # the sticky start with a unit velocity for the scalar-rate samplers
        unit = driver.kernel_kind(sampler) in k3.KINDS
        return np.full((B, d), 0.3), np.full((B, d), 1.0 / math.sqrt(d) if unit else 1.0)
    rs = np.random.default_rng(40)
    x0 = np.broadcast_to(b_map, (B, d)).copy()
    if driver.kernel_kind(sampler) in k3.KINDS:
        v0 = rs.normal(size=(B, d))
        return x0, v0 / np.linalg.norm(v0, axis=1, keepdims=True)
    return x0, rs.choice([-1.0, 1.0], size=(B, d))


def second_half(xs):
    """The second half of each chain's equal-time samples ``(B, n, d)``, as
    float64 rows of one sample each (the first half is the chains' way from
    their common start)."""
    return xs[:, xs.shape[1] // 2:].double().reshape(-1, xs.shape[-1])


def corr_gate(what, xs, rho):
    """The correlated Gaussian's gate on the second half of each chain's
    equal-time samples ``(B, n, d)``: |pooled mean_i| < 0.1, each variance
    within 10% of 1, each lag-one correlation ``corr(x_i, x_{i+1})`` within
    0.05 of ``rho``; the whole run's mean and variance printed beside."""
    full = xs.double().reshape(-1, xs.shape[-1])
    x = second_half(xs)
    mean, var = x.mean(0), x.var(0)
    z = (x - mean) / var.sqrt()
    lag = (z[:, :-1] * z[:, 1:]).mean(0)
    m, v, c = float(mean.abs().max()), float((var - 1).abs().max()), float((lag - rho).abs().max())
    if not (m < 0.1 and v < 0.1 and c < 0.05):
        raise AssertionError(f"{what}: moments off: max|mean| {m:.4f}, max|var-1| {v:.4f}, "
                             f"lag-one correlations {lag.tolist()}")
    return (f"second half: max|mean| {m:.4f} < 0.1, max|var-1| {v:.4f} < 0.1, lag-one "
            f"correlations {float(lag.min()):.4f}-{float(lag.max()):.4f} (max|corr-{rho}| "
            f"{c:.4f} < 0.05); whole run: max|mean| {float(full.mean(0).abs().max()):.4f}, "
            f"max|var-1| {float((full.var(0) - 1).abs().max()):.4f}")


def logistic_reference(X, y, b_map, cov, draws=400_000):
    """The posterior mean by importance sampling from the Laplace law
    widened by 1.1, in float64 (draws from numpy's seeded generator, the
    potential evaluated by plain torch on the card): a reference independent
    of the samplers.  Returns (the mean, the effective sample size)."""
    L = np.linalg.cholesky(cov)
    rs = np.random.default_rng(4000)
    Xt, yt = (torch.as_tensor(a, device=DEV) for a in (X, y))
    c = 1.0 / (2.0 * LOGISTIC_PRIOR_SD ** 2)

    def U(B):
        Z = B @ Xt.T
        return (torch.nn.functional.softplus(Z) - yt * Z).sum(1) + c * (B * B).sum(1)

    bm = torch.as_tensor(b_map, device=DEV)
    u_map = U(bm[None])[0]
    first, w_all = torch.zeros_like(bm), []
    for _ in range(draws // 20_000):
        z = torch.as_tensor(rs.normal(size=(20_000, len(b_map))), device=DEV)
        B = bm + 1.1 * z @ torch.as_tensor(L.T, device=DEV)
        w = torch.exp(u_map - U(B) + 0.5 * (z * z).sum(1))
        first += w @ B
        w_all.append(w)
    w = torch.cat(w_all)
    return (first / w.sum()).cpu().numpy(), float(w.sum() ** 2 / (w * w).sum())


def logistic_gate(what, xs, ref_mean, cov):
    """The logistic regression's gate on the second half of each chain's
    equal-time samples: each coordinate's pooled mean within 0.2 Laplace sd
    of the importance-sampled posterior mean and its variance within 20% of
    the Laplace variance.  Returns (the pooled means, text)."""
    x = second_half(xs).cpu().numpy()
    mean, var = x.mean(0), x.var(0)
    sd = np.sqrt(np.diag(cov))
    dm, dv = np.abs(mean - ref_mean) / sd, np.abs(var / sd ** 2 - 1.0)
    if not (np.all(dm < 0.2) and np.all(dv < 0.2)):
        raise AssertionError(f"{what}: off the posterior: |mean - E| / sd {dm.tolist()}, "
                             f"|var / var_Laplace - 1| {dv.tolist()}")
    return mean, (f"max|mean - E[b]| / sd {float(dm.max()):.4f} < 0.2, max|var / var_Laplace "
                  f"- 1| {float(dv.max()):.4f} < 0.2")


def kernel_chunk(sampler, x0, v0, config=None, reps=20, events=False):
    """One f32 K=32 launch of a generated potential's kernel (or, with
    ``config`` :func:`card_config`, a tagged sampler's) at its deployment's
    shape and start, timed (the mean of ``reps`` after a warm one), and its
    bound.  Returns (ms, bound), and with ``events`` the event rows and
    rejections of the first launch."""
    B, d = x0.shape
    K, seed = 32, 7
    state = sampler.init_state_batch(x0, v0, 0, torch.float32, DEV)
    cfg = (config or user_config)(sampler, K, 1 << 30, torch.float32)
    run, _ = chunk_fns(cfg)
    st = driver.chunk_state(state, torch.zeros(B, dtype=torch.int32, device=DEV),
                            sampler.sticky)
    fill = k1.empty_fill(K, d, B, torch.float32, DEV, sampler.sticky)
    run(seed, st, fill, 0, cfg)
    sync()
    b = chunk_bound(cfg, st, fill, K * B)
    counts = (int((fill.kind[:, 0] > 0).sum()), int(st.iscal[1].sum()))
    ms = cuda_ms(lambda: run(seed, st, fill, 0, cfg), reps)
    return (ms, b, counts) if events else (ms, b)


def phase_dense(card_name, names, title, calls, b_map=None, cov=None, ref_mean=None,
                paths=None, gates=None):
    """One deployment of ``dense_paths`` after another: the kernel against
    its plain version in f64 at the deployment's shape (one launch of
    ``DENSE_PARITY_K`` transitions from a random state, K3/K5 and K4 bit for
    bit, K1 and K6 to ``RTOL``); the
    route under ``backend="auto"`` (its chunk kernel and K2, no engine chunk,
    no ``LoweringError``) with ``calls`` timed warm calls; the gates; one f32
    K=32 launch timed (``kernel_chunk``; the plain version's time is its
    f64 parity launch's, whose ordered 1000-term sums take seconds).
    ``paths`` (default ``dense_paths()``) holds the deployments, ``gates``
    a gate ``(what, sampler, skeleton) -> text`` per path beside the ones
    here.  Returns ({path: (launches, ms, plain ms, bound, err)}, {path:
    pooled means of the second halves})."""
    paths = dense_paths() if paths is None else paths
    gates = gates or {}
    out, means, texts = {}, {}, []
    for path in names:
        sampler, (d, B, n_sk), bitwise, tag, start = paths[path]
        what = f"{title} {path}"
        t0 = time.perf_counter()
        err64, n_ev, plain_ms = user_compare(what, sampler, B, bitwise, math_tag=tag,
                                             n_chunks=1, K=DENSE_PARITY_K)
        t_cmp = time.perf_counter() - t0
        x0, v0 = dense_start(sampler, start, B, d, b_map)
        skel, launches, walls = user_call(what, sampler, n_sk, x0, v0, calls)
        events = int(skel.n_valid.sum()) - B
        name = path_launch(sampler)
        gate = ""
        if path in gates:
            gate = gates[path](what, sampler, skel)
        elif "corr_gauss" in path:
            gate = corr_gate(what, pt.sample_from_skeleton_batch(sampler, 256, skel), CORR_RHO)
        elif path in ("zigzag_logistic_d20_n1000", "bps_logistic_d20_n1000",
                      "suzz_logistic_d20_n1000"):
            means[path], gate = logistic_gate(what, pt.sample_from_skeleton_batch(
                sampler, 256, skel), ref_mean, cov)
        del skel
        ms, b = kernel_chunk(sampler, x0, v0)
        out[path] = (launches, ms, plain_ms, b, err64)
        low = lower.lower_sampler(sampler, driver.kernel_kind(sampler), d, torch.float32, DEV)
        stages = ", ".join(
            f"{low.products[s].rows} x {low.products[s].cols} product" if kind == "mv" else
            "sum of degree past 2 in t" if max(p.e.deg for p in low.reductions[s]) > 2 else
            "quadratic sum" for kind, s in low.stages) or "none"
        texts.append(
            f"{path} ({type(sampler).__name__} d={d} B={B} n_sk={n_sk}; stages: {stages}; "
            f"{low.params.numel()} parameters, {low.lane_bytes()} B per lane, "
            f"{low.shared_values() if low.kernel == 'sticky' else 0} shared values): {name} vs "
            f"plain f64 {'bit for bit' if bitwise else f'rtol {RTOL}'} max_abs_err="
            f"{err64:.3e} ({n_ev} events, {t_cmp:.1f} s); route {name} "
            f"{launches[name]} launches per call, K2 {launches['compact_rows']}, 0 engine "
            f"chunks, {events} events; {walls_text(walls, events)}; {gate or 'parity only'}; "
            f"f32 chunk (K=32) {ms:.4f} ms at the deployment's start, bound {bound_text(b)}; "
            f"plain version (the f64 parity launch) {plain_ms:.1f} ms")
    notes = "; ".join(n for n in MATH_NOTES if n.startswith(title)) or "none"
    print(f"{title} {', '.join(names)}: {'; '.join(texts)}; bit-for-bit checks that parted "
          f"in a math function: {notes} ({card_name})", flush=True)
    return out, means


def phase_dense_corr(card_name):
    """Phase 39, ``zigzag_corr_gauss_d10`` (the flagship's shape: 8192 chains
    x 2048 points, x0 = 0, v0 = 1) and ``bps_corr_gauss_d10`` (BPS refresh
    0.5 at ``bps_anisotropic_gauss_d10``'s shape): ``U = x P x / 2`` with
    ``P = Sigma^-1``, ``Sigma_ij = 0.9^|i-j|``, a 10 x 10 product (two, the
    gradient's ``P x`` and ``P^T x``) at every point of K1 and K3."""
    out, _ = phase_dense(card_name, ["zigzag_corr_gauss_d10", "bps_corr_gauss_d10"],
                         "phase 39", DENSE_CALLS)
    return out


def phase_dense_logistic(card_name):
    """Phase 40, ``zigzag_logistic_d20_n1000``: the Bayesian logistic
    regression (d = 20, n = 1000 rows, ``X`` 80 KB in f32) on K1 (ZigZagAD),
    K3 (BPSAD, refresh 1.0) and K4 (SpeedUpZigZagAD), 1024 chains x 2048
    points from the MAP; the gates on the second half of each chain's time,
    and K1's and K3's means within 0.2 Laplace sd of each other."""
    X, y = logistic_data()
    b_map, cov = logistic_laplace(X, y)
    ref_mean, ess = logistic_reference(X, y, b_map, cov)
    names = ["zigzag_logistic_d20_n1000", "bps_logistic_d20_n1000", "suzz_logistic_d20_n1000"]
    out, means = phase_dense(card_name, names, "phase 40", LOGISTIC_CALLS, b_map, cov, ref_mean)
    sd = np.sqrt(np.diag(cov))
    gap = np.abs(means["zigzag_logistic_d20_n1000"] - means["bps_logistic_d20_n1000"]) / sd
    if not np.all(gap < 0.2):
        raise AssertionError(f"phase 40: K1's and K3's means apart by {gap.tolist()} sd")
    print(f"phase 40 K1 and K3 logistic means within {float(gap.max()):.4f} < 0.2 Laplace sd "
          f"of each other; the importance-sampled posterior mean (ESS {ess:.0f}) lies "
          f"{np.round((ref_mean - b_map) / sd, 3).tolist()} Laplace sd from the MAP "
          f"{np.round(b_map, 4).tolist()}; Laplace sd {np.round(sd, 4).tolist()} "
          f"({card_name})", flush=True)
    return out


def phase_dense_parity(card_name):
    """Phase 41, the kernel against its plain version on the other kinds:
    the Boomerang and Forward ECMC (K5) and the sticky Zig-Zag (K6, kappa 1)
    on the logistic regression from its MAP; K6 at ``sticky_zigzag_d1000``'s
    shape (kappa 10, x0 = 0.3) on a dense AR(1) Gaussian (rho 0.5, ``A``
    1000 x 1000, 4 MB in f32); the quartic sum on K1 (flagship shape) and K6
    (d = 1000).  Each with its route, one timed call and an f32 launch."""
    X, y = logistic_data()
    b_map, _ = logistic_laplace(X, y)
    names = ["boomerang_logistic_d20_n1000", "ecmc_logistic_d20_n1000",
             "sticky_logistic_d20_n1000", "sticky_dense_ar1_d1000", "zigzag_quartic_d10",
             "sticky_quartic_d1000"]
    out, _ = phase_dense(card_name, names, "phase 41", 1, b_map)
    return out


# ---------------------------------------------------------------------------
# Phase 42: gradients that read other coordinates (a neighbour at a fixed
# offset, x[k] past coordinate 1), read through the kernels' accessor
# ---------------------------------------------------------------------------


def ar1_band(rho):
    """The AR(1) prior with unit marginal variance as users write it, in its
    innovation form: ``U = x0^2 / 2 + sum((x[1:] - rho x[:-1])^2) / (2 (1 -
    rho^2))``; its precision is :func:`ar1_precision`'s, tridiagonal."""
    c = 1.0 / (2.0 * (1.0 - rho ** 2))
    return lambda x: x[0] ** 2 / 2 + c * torch.sum((x[1:] - rho * x[:-1]) ** 2)


def user_neal_last(x):
    """Phase 38's Neal funnel with its scale last: ``x[-1]`` in place of
    ``x[0]``, a read of coordinate d - 1 at every coordinate."""
    return (x[-1] * x[-1] / 18.0 + 0.5 * (x.shape[0] - 1) * x[-1]
            + 0.5 * torch.sum(x[:-1] ** 2) * torch.exp(-x[-1]))


@cache
def band_paths():
    """Phase 42's deployments (as :func:`dense_paths`): the banded AR(1) at
    ``sticky_dense_ar1_d1000``'s shape on K6 and K1 (rho 0.5), at rho 0.9 on
    ``zigzag_corr_gauss_d10``'s and ``bps_corr_gauss_d10``'s shapes, and the
    funnel with its scale last at ``zigzag_neal_funnel_d10``'s."""
    dd, dB, dn, kappa, rho = DENSE_AR
    bps_d, bps_B, bps_n, bps_refresh = BPS_D10
    wide, mixing = ar1_band(rho), ar1_band(CORR_RHO)
    return {
        "sticky_band_ar1_d1000": (pt.StickyZigZagAD(dd, wide, np.full(dd, kappa)),
                                  (dd, dB, dn), False, None, "sticky"),
        "zigzag_band_ar1_d1000": (pt.ZigZagAD(dd, wide), (dd, dB, dn), False, None, "sticky"),
        "zigzag_band_ar1_d10": (pt.ZigZagAD(10, mixing), MAIN, False, None, "ones"),
        "bps_band_ar1_d10": (pt.BPSAD(10, mixing, refresh_rate=bps_refresh),
                             (bps_d, bps_B, bps_n), True, None, "ones"),
        "zigzag_neal_last_d10": (pt.ZigZagAD(10, user_neal_last), NEAL_D10, False,
                                 "neal_funnel", "ones"),
    }


@cache
def neal_last_parity():
    """The funnel with its scale last on the walking kernels (K3, K5, K4), at
    phase 38's K4 shape: held bit for bit against their plain versions."""
    d, B, _ = SUZZ_D10
    return {"bps": pt.BPSAD(d, user_neal_last, refresh_rate=BPS_D10[3]),
            "ecmc": pt.ForwardECMCAD(d, user_neal_last),
            "suzz": pt.SpeedUpZigZagAD(d, user_neal_last)}, B


def band_pair(what, sampler, P, n=64):
    """The banded gradient's lowered pair against the dense ``P x`` and ``P
    v`` in f64 at ``n`` seeded random points on the card, rtol 1e-12 (atol
    1e-12).  Returns the max abs err."""
    d = sampler.dim
    low = lower.lower_sampler(sampler, driver.kernel_kind(sampler), d, torch.float64, DEV)
    rs = np.random.default_rng(d + n)
    x, v = (torch.as_tensor(rs.normal(size=(d, n)), device=DEV) for _ in range(2))
    Pt = torch.as_tensor(P, device=DEV)
    err = 0.0
    for got, want in zip(low.grad_jvp(x, v), (Pt @ x, Pt @ v)):
        bad = (got - want).abs() > 1e-12 + 1e-12 * want.abs()
        if bool(bad.any()):
            raise AssertionError(f"{what}: the banded pair parts from the dense P x at "
                                 f"{int(bad.sum())} places")
        err = max(err, float((got - want).abs().max()))
    return err


def phase_band(card_name, dense_k6, neal_user):
    """Phase 42, gradients that read other coordinates.  The AR(1) prior in
    its innovation form (a band: every coordinate reads ``x[i - 1]`` and
    ``x[i + 1]``) at ``sticky_dense_ar1_d1000``'s shape (d = 1000, 128 chains
    x 2048 points, rho 0.5, x0 = 0.3) on K6 (kappa 10) and on K1, where the
    dense ``0.5 x P x`` takes the kernel too (its products formed once per
    transition, phase 43): the pair against the dense ``P x`` at 64 points,
    then as :func:`phase_dense` (the f64 parity launch to ``RTOL``, the
    route with one timed call, an f32 launch with its bound) beside phase
    41's dense K6 launch ``dense_k6`` (ms, bound); a horizon launch of each
    against its plain version.  At rho 0.9 and d = 10 on K1 and K3 at
    phase 39's shapes, ``corr_gate``.  Phase 38's Neal funnel with its scale
    at ``x[-1]`` on K1 at ``zigzag_neal_funnel_d10``'s shape: x[-1]'s mean
    within 0.15 and variance within 10% of phase 38's x[0] (``neal_user``),
    and K3, K5 and K4 on it bit for bit (where exp parts the two a bit, the
    first part printed and ``RTOL``), K4 in horizon mode too.  Returns
    {path: (launches, ms, plain ms, bound, err)}."""
    paths = band_paths()
    dd, _, _, _, rho = DENSE_AR
    P = ar1_precision(dd, rho)
    pair_errs = {path: band_pair(f"phase 42 {path}", paths[path][0], P)
                 for path in ("sticky_band_ar1_d1000", "zigzag_band_ar1_d1000")}
    dense_route = api.pick_backend(pt.ZigZagAD(dd, quadratic_form(P)), "auto", dd,
                                   torch.float32, DEV)
    if dense_route != "kernel":
        raise AssertionError(f"phase 42: the dense AR(1) on K1 at d={dd} took {dense_route}")

    def corr(what, sampler, skel):
        return corr_gate(what, pt.sample_from_skeleton_batch(sampler, 256, skel), CORR_RHO)

    def funnel(what, sampler, skel):
        mean, var = pt.pooled_moments(skel, sampler, 256)
        m, v = float(mean[-1]), float(var[-1])
        m_t, v_t = neal_user
        if not (abs(m - m_t) < 0.15 and abs(v / v_t - 1.0) < 0.1):
            raise AssertionError(f"{what}: x[-1] mean {m:.4f} vs phase 38's x[0] {m_t:.4f}, "
                                 f"variance {v:.4f} vs {v_t:.4f}")
        return (f"x[-1] mean {m:.4f} vs phase 38's x[0] {m_t:.4f} (within {abs(m - m_t):.4f} "
                f"< 0.15), variance {v:.4f} vs {v_t:.4f} (within {abs(v / v_t - 1):.2%} < 10%)")

    gates = {"zigzag_band_ar1_d10": corr, "bps_band_ar1_d10": corr,
             "zigzag_neal_last_d10": funnel}
    out, _ = phase_dense(card_name, list(paths), "phase 42", 1, paths=paths, gates=gates)
    texts = [f"pairs against the dense P x (64 points, f64): "
             f"{', '.join(f'{p} {e:.3e}' for p, e in pair_errs.items())}; the dense form on K1 "
             f"at d={dd} routes to the {dense_route}"]
    # horizon mode (K7) of K6 and K1 on the band, against the plain versions
    for path in ("sticky_band_ar1_d1000", "zigzag_band_ar1_d1000", "bps_band_ar1_d10"):
        sampler, (d, B, _), bitwise, _, _ = paths[path]
        e, n_ev, _ = user_compare(f"phase 42 {path} horizon", sampler, B, bitwise, n_chunks=1,
                                  horizon=True)
        launches, ms, plain_ms, b, err = out[path]
        out[path] = (launches, ms, plain_ms, b, max(err, e))
        texts.append(f"{path} horizon vs plain f64 max_abs_err={e:.3e} ({n_ev} events)")
    parity, B = neal_last_parity()
    for kind, sampler in parity.items():
        for horizon in ((False, True) if kind == "suzz" else (False,)):
            e, n_ev, _ = user_compare(f"phase 42 {kind}_neal_last_d10", sampler, B, True,
                                      math_tag="neal_funnel", n_chunks=1, horizon=horizon)
            texts.append(f"{kind}_neal_last_d10{' horizon' if horizon else ''} (B={B}) vs "
                         f"plain f64 bit for bit max_abs_err={e:.3e} ({n_ev} events)")
    k6_ms, k6_b = out["sticky_band_ar1_d1000"][1], out["sticky_band_ar1_d1000"][3]
    texts.append(f"K6 f32 launch at d={dd}: banded {k6_ms:.4f} ms (bound {bound_text(k6_b)}) "
                 f"vs phase 41's dense A @ x {dense_k6[0]:.4f} ms (bound "
                 f"{bound_text(dense_k6[1])}), {dense_k6[0] / k6_ms:.1f}x")
    # K1 at this shape on the tagged Gaussian, from the same start: what K1
    # costs at d = 1000 with 128 chains whatever the potential
    k1_ms = out["zigzag_band_ar1_d1000"][1]
    _, (_, dB, _), _, _, _ = paths["zigzag_band_ar1_d1000"]
    g_ms, g_b = kernel_chunk(pt.ZigZag(dd, pt.potentials.grad_gauss), np.full((dB, dd), 0.3),
                             np.ones((dB, dd)), config=card_config)
    texts.append(f"K1 f32 launch at d={dd}, B={dB} (L={lanes(dB)}): banded {k1_ms:.4f} ms vs "
                 f"the tagged Gaussian {g_ms:.4f} ms (bound {bound_text(g_b)}), "
                 f"{k1_ms / g_ms:.2f}x")
    notes = "; ".join(n for n in MATH_NOTES if n.startswith("phase 42")) or "none"
    print(f"phase 42 reads of other coordinates: {'; '.join(texts)}; bit-for-bit checks that "
          f"parted in exp: {notes} ({card_name})", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 43: products with a constant matrix formed once per transition
# ---------------------------------------------------------------------------


@cache
def dense_ar1_paths():
    """Phase 43's deployments (as :func:`dense_paths`): the dense AR(1)
    Gaussian ``0.5 x P x`` (rho 0.5, ``P`` 1000 x 1000, 4 MB in f32) at
    ``sticky_dense_ar1_d1000``'s shape on K1 and on K3 (BPS, refresh 0.5),
    its two products (``P x``, ``P^T x``) formed once per transition."""
    dd, dB, dn, _, rho = DENSE_AR
    dense = quadratic_form(ar1_precision(dd, rho))
    return {
        "zigzag_dense_ar1_d1000": (pt.ZigZagAD(dd, dense), (dd, dB, dn), False, None, "ar1"),
        "bps_dense_ar1_d1000": (pt.BPSAD(dd, dense, refresh_rate=BPS_D10[3]), (dd, dB, dn),
                                True, None, "ar1"),
    }


def dense_band_launch(dense, band, B, seed=271828):
    """One f64 K=32 K1 launch of the dense form and one of the banded form
    from the same random state and keys: integers equal, floats within
    1e-9 (rtol and atol).  Returns (max abs err, events)."""
    d, K = dense.dim, 32
    state = random_state(dense, B, torch.float64, d + B + 1, scale=0.3)
    counts = torch.zeros(B, dtype=torch.int32, device=DEV)
    outs, events = [], []
    for sampler in (dense, band):
        cfg = user_config(sampler, K, 1 << 30, torch.float64)
        st = driver.chunk_state(state, counts)
        fill = k1.empty_fill(K, d, B, torch.float64, DEV)
        k1.run_chunk(seed, st, fill, 0, cfg)
        outs.append(chunk_outputs(st, fill))
        events.append(int((fill.kind[:, 0] > 0).sum()))
    sync()
    if events[0] < B // 2:
        raise AssertionError(f"phase 43: only {events[0]} events in the dense-banded check")
    err = 0.0
    for (name, a), (_, b) in zip(*outs):
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"phase 43: dense and banded K1 output {name} differ at "
                                     f"{int((a != b).sum())} places")
        else:
            err = max(err, float_err("phase 43 dense vs banded K1", name, a, b, 1e-9, 1e-9))
    return err, events[0]


def engine_chunk_ms(sampler, x0, v0):
    """One engine chunk (``engine.CHUNK`` transitions) of ``sampler`` from
    its f32 start, after a warm one, timed by CUDA events: the route the
    dense form took before its products were formed once per transition."""
    B = x0.shape[0]
    state = sampler.init_state_batch(x0, v0, 0, torch.float32, DEV)
    run = engine.make_stream_runner(sampler, engine.CHUNK, 1 << 30)
    counts = torch.zeros(B, dtype=torch.int32, device=DEV)
    run(state, counts)
    sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run(state, counts)
    end.record()
    sync()
    return start.elapsed_time(end)


def phase_transition_products(card_name):
    """Phase 43, the dense AR(1) Gaussian at d = 1000 on the chunk kernels:
    ``zigzag_dense_ar1_d1000`` (K1) and ``bps_dense_ar1_d1000`` (K3) as
    :func:`phase_dense` (the f64 parity launch, K3 bit for bit and K1 to
    ``RTOL``; the route under ``"auto"``, its kernel and K2 with no engine
    chunk, and one timed warm call; an f32 launch with its bound); the dense
    K1 launch against the banded one (phase 42's form) from one state; one
    engine chunk of the dense K1 sampler timed, for the record.  Returns
    {path: (launches, ms, plain ms, bound, err)}."""
    paths = dense_ar1_paths()
    out, _ = phase_dense(card_name, list(paths), "phase 43", 1, paths=paths)
    dense = paths["zigzag_dense_ar1_d1000"][0]
    band = band_paths()["zigzag_band_ar1_d1000"][0]
    d, B, _ = paths["zigzag_dense_ar1_d1000"][1]
    err, n_ev = dense_band_launch(dense, band, B)
    launches, ms, plain_ms, b, e = out["zigzag_dense_ar1_d1000"]
    out["zigzag_dense_ar1_d1000"] = (launches, ms, plain_ms, b, max(e, err))
    x0, v0 = dense_start(dense, "ar1", B, d, None)
    eng_ms = engine_chunk_ms(dense, x0, v0)
    print(f"phase 43 products formed once per transition: the dense K1 launch (f64, K=32, "
          f"B={B}) against the banded one from one state max_abs_err={err:.3e} ({n_ev} "
          f"events, integers equal); one engine "
          f"chunk ({engine.CHUNK} transitions) of the dense K1 sampler (f32, B={B}, d={d}) "
          f"{eng_ms:.2f} ms by CUDA events, the f32 K=32 launch {ms:.4f} ms: "
          f"{eng_ms / (engine.CHUNK / 32) / ms:.1f}x per transition ({card_name})", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 44: log-sum-exp, softmax and small matrix views of the chain, lowered
# into the chunk kernels (a max stage, a short axis of K vectors)
# ---------------------------------------------------------------------------

BIMODAL = (1, 1024, 6000)            # phase 44: d, chains, points (the JAX test's 6000)
BIMODAL_SAMPLES = 10_000             # equal-time samples per chain (the JAX test's)
MIXTURE = (100, 1024, 2048)          # d, chains, points
SOFTMAX = (20, 5, 1000, 1024, 2048)  # features p, classes K, rows, chains, points
SOFTMAX_PRIOR_SD = 10.0
LSE_PARITY = (64, 4)                 # parity launches: chains, transitions (K4: 8x)
SOFTMAX_FIT_P = 10                   # features of the softmax whose f64 context a lane holds
LSE_COORDS = (1000, 128)             # d, chains: K1 on |x|^2 / 2 + logsumexp(x) (point mode)


def bimodal(x):
    """``tests/test_integration.py:39-43`` as written there."""
    a = -torch.sum((x - 2.0) ** 2) / 2
    b = -torch.sum((x + 2.0) ** 2) / 2
    return -torch.logsumexp(torch.stack([a, b]), 0)


def mixture_means(d):
    """mu_k = (+-2, +-2, 0, ..., 0), the four sign patterns."""
    mu = np.zeros((4, d))
    mu[:, :2] = 2.0 * np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]])
    return mu


def mixture_broadcast(mu):
    """The equal-weight, unit-covariance mixture as ``-logsumexp(-|x -
    mu_k|^2 / 2)`` with the broadcast ``x[None, :] - MU``."""
    M = torch.as_tensor(mu, device=DEV)
    return lambda x: -torch.logsumexp(-((x[None, :] - M.to(x)) ** 2).sum(1) / 2, 0)


def mixture_matrix(mu):
    """The same mixture as ``|x|^2 / 2 - logsumexp(MU x - |mu_k|^2 / 2)``."""
    M = torch.as_tensor(mu, device=DEV)
    half = torch.as_tensor((mu * mu).sum(1) / 2, device=DEV)
    return lambda x: x @ x / 2 - torch.logsumexp(M.to(x) @ x - half.to(x), 0)


def softmax_data():
    """``X`` (rows, p): an intercept column and N(0, 1) columns; one-hot
    labels ``Y`` (rows, K) drawn from the softmax of ``X B*`` for a seeded
    ``B*`` (the CPU tests' ``regression_data(1000, 20, 5, seed=44)``)."""
    p, k, n = SOFTMAX[:3]
    rs = np.random.default_rng(44)
    X = np.concatenate([np.ones((n, 1)), rs.normal(size=(n, p - 1))], 1)
    logits = X @ rs.normal(size=(p, k))
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob /= prob.sum(1, keepdims=True)
    labels = (prob.cumsum(1) > rs.random((n, 1))).argmax(1)
    return X, np.eye(k)[labels]


def softmax_pk(X, Y):
    """``U = -(Y * log_softmax(X @ x.reshape(p, K), 1)).sum() + |x|^2 / 200``."""
    p, k = X.shape[1], Y.shape[1]
    Xt, Yt = (torch.as_tensor(a, device=DEV) for a in (X, Y))
    c = 1.0 / (2.0 * SOFTMAX_PRIOR_SD ** 2)
    return lambda x: (-(Yt.to(x) * torch.log_softmax(Xt.to(x) @ x.reshape(p, k), 1)).sum()
                      + c * (x @ x))


def softmax_kp(X, Y):
    """The ``(K, p)`` layout: ``Z = X @ x.reshape(K, p).T``, ``U = -(Y * Z).sum()
    + logsumexp(Z, 1).sum() + |x|^2 / 200``."""
    p, k = X.shape[1], Y.shape[1]
    Xt, Yt = (torch.as_tensor(a, device=DEV) for a in (X, Y))
    c = 1.0 / (2.0 * SOFTMAX_PRIOR_SD ** 2)

    def U(x):
        Z = Xt.to(x) @ x.reshape(k, p).T
        return -(Yt.to(x) * Z).sum() + torch.logsumexp(Z, 1).sum() + c * (x @ x)

    return U


@cache
def lse_paths():
    """Phase 44's gated deployments (as :func:`dense_paths`): name -> (sampler,
    (d, chains, points), bit for bit against the plain version, math tag,
    start)."""
    d1, B1, n1 = BIMODAL
    d, B, n_sk = MIXTURE
    mix = mixture_broadcast(mixture_means(d))
    X, Y = softmax_data()
    soft = softmax_pk(X, Y)
    p, k, _, sB, sn = SOFTMAX
    return {
        "zigzag_bimodal_d1": (pt.ZigZagAD(d1, bimodal), (d1, B1, n1), False, None, "ones"),
        "zigzag_mixture4_d100": (pt.ZigZagAD(d, mix), (d, B, n_sk), False, None, "modes"),
        "bps_mixture4_d100": (pt.BPSAD(d, mix, refresh_rate=1.0), (d, B, n_sk), True, None,
                              "modes"),
        "zigzag_softmax_d100_n1000": (pt.ZigZagAD(p * k, soft), (p * k, sB, sn), False,
                                      None, "map"),
        "bps_softmax_d100_n1000": (pt.BPSAD(p * k, soft, refresh_rate=1.0), (p * k, sB, sn),
                                   True, None, "map"),
    }


@cache
def lse_launch_samplers():
    """K6 (kappa 1), K4 and K5 on the broadcast mixture at d = 100: each
    timed on one f32 launch from the modes (phase 44 runs no deployment of
    theirs)."""
    d = MIXTURE[0]
    mix = mixture_broadcast(mixture_means(d))
    return {"sticky": pt.StickyZigZagAD(d, mix, np.ones(d)), "suzz": pt.SpeedUpZigZagAD(d, mix),
            "ecmc": pt.ForwardECMCAD(d, mix)}


@cache
def lse_parity_samplers():
    """Phase 44's parity launches: (name, sampler, bit for bit, the same
    kernel's sampler on the softmax's first ``SOFTMAX_FIT_P`` features or
    None) for each target, (a) the bimodal U at d = 10 (and K1 at d = 1),
    (b) the mixture at d = 100 in both forms, (c) the softmax regression in
    both layouts, on K1, K6, K4, K3 (BPS, Boomerang) and K5."""
    X, Y = softmax_data()
    Xs = X[:, :SOFTMAX_FIT_P]
    mu = mixture_means(MIXTURE[0])
    d_s, d_f = X.shape[1] * Y.shape[1], Xs.shape[1] * Y.shape[1]
    targets = {"bimodal_d10": (10, bimodal, None),
               "mixture4_broadcast_d100": (MIXTURE[0], mixture_broadcast(mu), None),
               "mixture4_matrix_d100": (MIXTURE[0], mixture_matrix(mu), None),
               "softmax_pk_d100": (d_s, softmax_pk(X, Y), (d_f, softmax_pk(Xs, Y))),
               "softmax_kp_d100": (d_s, softmax_kp(X, Y), (d_f, softmax_kp(Xs, Y)))}
    makes = [("zigzag", pt.ZigZagAD, False),
             ("sticky", lambda d, U: pt.StickyZigZagAD(d, U, np.ones(d)), False),
             ("suzz", pt.SpeedUpZigZagAD, True),
             ("bps", lambda d, U: pt.BPSAD(d, U, refresh_rate=1.0), True),
             ("boomerang", lambda d, U: pt.BoomerangAD(d, U, refresh_rate=1.0), True),
             ("ecmc", pt.ForwardECMCAD, True)]
    out = [("zigzag_bimodal_d1", pt.ZigZagAD(1, bimodal), False, None)]
    for target, (d, U, fit) in targets.items():
        out += [(f"{kind}_{target}", make(d, U), bitwise,
                 None if fit is None else make(*fit)) for kind, make, bitwise in makes]
    return out


@cache
def lse_coords_sampler():
    """K1 on ``|x|^2 / 2 + logsumexp(x)`` at ``LSE_COORDS``' d: a max over the
    coordinates, which K1 takes in point mode (each lane walks every
    coordinate at each of its points)."""
    return pt.ZigZagAD(LSE_COORDS[0], lambda x: x @ x / 2 + torch.logsumexp(x, 0))


def engine_reason(sampler, dtype):
    """Why ``"auto"`` sends a sampler's lowered gradient to the engine: its
    lane's context past ``LANE_BYTES``, or K6's d past the limit its build
    reports with the potential's context in shared memory; raises where
    neither holds."""
    kind, d = driver.kernel_kind(sampler), sampler.dim
    low = lower.lower_sampler(sampler, kind, d, dtype, DEV)
    if not lower.lane_fits(low):
        return lower.lane_message(low)
    if sampler.sticky and d > (lim := k1.sticky_max_dim(dtype, low)):
        return f"d={d} past K6's {lim} with {low.shared_values()} shared values"
    raise AssertionError(f"{type(sampler).__name__} d={d} takes the engine, but its "
                         "context fits its kernel")


def softmax_laplace(X, Y):
    """The MAP of the softmax regression by Newton's method (float64, from
    0) and the inverse Hessian there (the Laplace covariance), coordinates in
    ``x.reshape(p, K)``'s order."""
    p, k = X.shape[1], Y.shape[1]
    prec = 1.0 / SOFTMAX_PRIOR_SD ** 2
    w = np.zeros(p * k)
    for _ in range(60):
        Z = X @ w.reshape(p, k)
        P = np.exp(Z - Z.max(1, keepdims=True))
        P /= P.sum(1, keepdims=True)
        g = (X.T @ (P - Y)).reshape(-1) + prec * w
        S = P[:, :, None] * np.eye(k)[None] - P[:, :, None] * P[:, None, :]
        H = np.einsum("nj,nl,nkm->jklm", X, X, S).reshape(p * k, p * k) + prec * np.eye(p * k)
        step = np.linalg.solve(H, g)
        w -= step
        if np.abs(step).max() < 1e-12:
            break
    return w, np.linalg.inv(H)


def softmax_reference(X, Y, w_map, cov, draws=400_000):
    """The posterior mean by importance sampling from the Laplace law widened
    by 1.1 (:func:`logistic_reference`'s method), float64 on the card.
    Returns (the mean, the effective sample size)."""
    p, k = X.shape[1], Y.shape[1]
    L = np.linalg.cholesky(cov)
    rs = np.random.default_rng(4400)
    Xt, Yt = (torch.as_tensor(a, device=DEV) for a in (X, Y))
    c = 1.0 / (2.0 * SOFTMAX_PRIOR_SD ** 2)

    def U(W):
        Z = torch.einsum("nj,mjk->mnk", Xt, W.reshape(-1, p, k))
        return -(Yt * torch.log_softmax(Z, 2)).sum((1, 2)) + c * (W * W).sum(1)

    wm = torch.as_tensor(w_map, device=DEV)
    u_map = U(wm[None])[0]
    first, w_all = torch.zeros_like(wm), []
    for _ in range(draws // 10_000):
        z = torch.as_tensor(rs.normal(size=(10_000, p * k)), device=DEV)
        W = wm + 1.1 * z @ torch.as_tensor(L.T, device=DEV)
        wt = torch.exp(u_map - U(W) + 0.5 * (z * z).sum(1))
        first += wt @ W
        w_all.append(wt)
    wt = torch.cat(w_all)
    return (first / wt.sum()).cpu().numpy(), float(wt.sum() ** 2 / (wt * wt).sum())


def contrasts(k):
    """The class contrasts ``W[j, c] - mean_c W[j, :]`` of ``x.reshape(p, K)``
    as a matrix on x (per feature ``I - 1 1^T / K``)."""
    p = SOFTMAX[0]
    return np.kron(np.eye(p), np.eye(k) - np.ones((k, k)) / k)


def softmax_gate(what, xs, ref_mean, cov):
    """The softmax regression's gate on the second half of each chain's
    equal-time samples: each coordinate's pooled mean within 0.2 Laplace sd
    of the importance-sampled posterior mean; each class contrast's variance
    within 20% of its Laplace variance (the class means, a direction the
    likelihood leaves flat, carry the prior's sd alone and are printed).
    Returns (the pooled means, text)."""
    x = second_half(xs).cpu().numpy()
    mean, var = x.mean(0), x.var(0)
    sd = np.sqrt(np.diag(cov))
    C = contrasts(SOFTMAX[1])
    cvar, cvar_lap = (x @ C.T).var(0), np.diag(C @ cov @ C.T)
    dm, dv = np.abs(mean - ref_mean) / sd, np.abs(cvar / cvar_lap - 1.0)
    if not (np.all(dm < 0.2) and np.all(dv < 0.2)):
        raise AssertionError(f"{what}: off the posterior: |mean - E| / sd {dm.tolist()}, "
                             f"|var / var_Laplace - 1| of the contrasts {dv.tolist()}")
    return mean, (f"max|mean - E[x]| / sd {float(dm.max()):.4f} < 0.2, contrasts' max|var / "
                  f"var_Laplace - 1| {float(dv.max()):.4f} < 0.2; each coordinate's var / "
                  f"var_Laplace {float((var / sd ** 2).min()):.4f}-"
                  f"{float((var / sd ** 2).max()):.4f} (not gated: the class means' prior "
                  f"sd {SOFTMAX_PRIOR_SD / math.sqrt(SOFTMAX[1]):.2f} per coordinate)")


def bimodal_gate(what, sampler, skel):
    """``test_bimodal_mode_coverage``'s bands on the pooled samples (0.2 <
    share of x > 0 < 0.8, each mode's unit window holding > 0.1 of them),
    the share within 0.05 of its 0.5 by symmetry; the share of chains that
    pass the bands alone printed."""
    x = pt.sample_from_skeleton_batch(sampler, BIMODAL_SAMPLES, skel)[..., 0].double()
    pos = float((x > 0).double().mean())
    near = [float(((x - m).abs() < 1.0).double().mean()) for m in (2.0, -2.0)]
    per = (x > 0).double().mean(1)
    chain_ok = ((per > 0.2) & (per < 0.8) & (((x - 2.0).abs() < 1.0).double().mean(1) > 0.1)
                & (((x + 2.0).abs() < 1.0).double().mean(1) > 0.1))
    if not (0.2 < pos < 0.8 and min(near) > 0.1 and abs(pos - 0.5) < 0.05):
        raise AssertionError(f"{what}: modes not covered: share of x > 0 {pos:.4f}, within 1 "
                             f"of +2 and -2 {near}")
    return (f"pooled share of x > 0 {pos:.4f} (|. - 0.5| < 0.05), within 1 of +2 "
            f"{near[0]:.4f} and of -2 {near[1]:.4f} (> 0.1); "
            f"{float(chain_ok.double().mean()):.4f} of chains pass the JAX test's bands alone")


def mixture_gate(what, sampler, skel):
    """The mixture's law on the second half of each chain's equal-time
    samples: |pooled mean| < 0.2 on every coordinate, variance within 10%
    of 5 on coordinates 0 and 1 (the modes' spread 4 and 1) and of 1
    elsewhere."""
    x = second_half(pt.sample_from_skeleton_batch(sampler, 256, skel))
    mean, var = x.mean(0), x.var(0)
    want = torch.ones_like(var)
    want[:2] = 5.0
    m, v = float(mean.abs().max()), float(((var - want) / want).abs().max())
    if not (m < 0.2 and v < 0.1):
        raise AssertionError(f"{what}: off the mixture: max|mean| {m:.4f}, variances "
                             f"{var[:4].tolist()}..., max|var / want - 1| {v:.4f}")
    return (f"second half: max|mean| {m:.4f} < 0.2, var of x0, x1 {float(var[0]):.4f}, "
            f"{float(var[1]):.4f} (5), of the rest {float(var[2:].min()):.4f}-"
            f"{float(var[2:].max()):.4f} (1), max|var / want - 1| {v:.4f} < 0.1")


def lse_start(sampler, start, B, d, w_map):
    """x0 and v0: ``"modes"`` chain b at mu_{b mod 4} with v0 = 1, else
    :func:`dense_start`'s."""
    if start == "modes":
        return mixture_means(d)[np.arange(B) % 4], np.ones((B, d))
    return dense_start(sampler, start, B, d, w_map)


def phase_lse(card_name):
    """Phase 44: (a) the JAX package's bimodal target, ``ZigZagAD(1, U)`` of
    ``tests/test_integration.py``; (b) a 4-component Gaussian mixture at d =
    100 on K1 and K3 (BPS, refresh 1.0), chain b from mu_{b mod 4}; (c) a
    5-class softmax regression (d = 100, ``X`` 1000 x 20) on K1 and K3 from
    the MAP, gated against the Laplace law and importance sampling, K1's and
    K3's means within 0.2 Laplace sd of each other.  First every kernel
    against its plain version in f64 (``LSE_PARITY``: 64 chains, one launch
    of 8 transitions from a random state) on (a) at d = 10, (b) in both forms
    and (c) in both layouts, each taking its kernel under ``"auto"``; K1 and
    K3 also in horizon mode on (c) (the per-transition route, K7; K4's launch
    takes eight times as many transitions, its events being rarer); then each
    deployment's route with one timed call (its library built before, so
    the call is the first), its gate and an f32 launch with its bound.
    Returns {path: (launches, ms, plain ms, bound, err)}."""
    B, K = LSE_PARITY
    t0 = time.perf_counter()
    errs, plain = {}, {}
    texts = []
    for name, sampler, bitwise, fit in lse_parity_samplers():
        route = api.pick_backend(sampler, "auto", sampler.dim, torch.float64, DEV)
        if route != "kernel":
            # a context its kernel cannot hold at this size: the engine
            # under "auto", and the same kernel on a softmax that fits
            why = engine_reason(sampler, torch.float64)
            if route != "engine" or fit is None or api.pick_backend(
                    fit, "auto", fit.dim, torch.float64, DEV) != "kernel":
                raise AssertionError(f"phase 44 {name}: the f64 route is {route} ({why})")
            texts.append(f"{name} takes the engine under 'auto' in f64 ({why}), its kernel "
                         f"on X's first {SOFTMAX_FIT_P} columns (d={fit.dim}) instead")
            name, sampler = f"{name.rsplit('_', 1)[0]}_d{fit.dim}", fit
        modes = [False, True] if name.startswith(("zigzag_softmax_pk", "bps_softmax_pk")) \
            else [False]
        for horizon in modes:
            what = f"phase 44 {name}{' horizon' if horizon else ''}"
            k = 8 * K if driver.kernel_kind(sampler) == "suzz" else K  # K4: fewer events
            err, n_ev, ms = user_compare(what, sampler, B, bitwise, n_chunks=1,
                                         horizon=horizon, K=k)
            key = name + ("_horizon" if horizon else "")
            errs[key], plain[key] = err, ms
            texts.append(f"{key} {'bit for bit' if bitwise else f'{err:.3e}'} ({n_ev} events)")
    t_par = time.perf_counter() - t0
    print(f"phase 44 parity (f64, B={B}, K={K}, one launch each; K3/K5 and K4 bit for bit, K1 "
          f"and K6 rtol {RTOL}; every route the kernel but those named): {'; '.join(texts)} "
          f"({t_par:.1f} s, {card_name})", flush=True)

    X, Y = softmax_data()
    w_map, cov = softmax_laplace(X, Y)
    ref_mean, ess = softmax_reference(X, Y, w_map, cov)
    paths = lse_paths()
    out, means, texts = {}, {}, []
    for path, (sampler, (d, Bp, n_sk), bitwise, _, start) in paths.items():
        what = f"phase 44 {path}"
        x0, v0 = lse_start(sampler, start, Bp, d, w_map)
        kw = dict(seed=0, dtype=torch.float32, device=DEV)
        build.reset_launches()
        engine.reset_counts()
        t1 = time.perf_counter()
        skel = pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)
        sync()
        wall = time.perf_counter() - t1
        launches, chunks = dict(build.LAUNCHES), engine.COUNTS["chunks"]
        name = path_launch(sampler)
        others = {k: n for k, n in launches.items() if n and k not in (name, "compact_rows")}
        if launches[name] < 1 or launches["compact_rows"] < 1 or others or chunks:
            raise AssertionError(f"{what}: the path did not take {name} and K2 alone: "
                                 f"{launches}, {chunks} engine chunks")
        check_complete(what, skel, n_sk)
        events = int(skel.n_valid.sum()) - Bp
        if "bimodal" in path:
            gate = bimodal_gate(what, sampler, skel)
        elif "mixture" in path:
            gate = mixture_gate(what, sampler, skel)
        else:
            means[path], gate = softmax_gate(
                what, pt.sample_from_skeleton_batch(sampler, 256, skel), ref_mean, cov)
        del skel
        ms, b = kernel_chunk(sampler, x0, v0, reps=3 if "softmax" in path else 20)
        # its f64 parity launches: on the softmax at d = 100, or on the one
        # that fits where the lane cannot hold d = 100's context in f64
        target = {"bimodal": "bimodal_d1", "mixture": "mixture4_broadcast_d100",
                  "softmax": "softmax_pk_d"}[path.split("_")[1].rstrip("4")]
        keys = [k for k in errs if k.startswith(f"{path.split('_')[0]}_{target}")]
        out[path] = (launches, ms, plain[min(keys, key=len)], b, max(errs[k] for k in keys))
        low = lower.lower_sampler(sampler, driver.kernel_kind(sampler), d, torch.float32, DEV)
        eng = ""
        if "softmax" in path:  # the route "auto" did not take, for the record
            eng_ms = engine_chunk_ms(sampler, x0, v0)
            eng = (f"; one engine chunk ({engine.CHUNK} transitions, f32, B={Bp}) "
                   f"{eng_ms:.2f} ms by CUDA events, "
                   f"{eng_ms / (engine.CHUNK / 32) / ms:.2f}x the kernel per transition")
        texts.append(
            f"{path} ({type(sampler).__name__} d={d} B={Bp} n_sk={n_sk}; "
            f"{len(low.stages)} stages ({low.red_kind.count('max')} max), "
            f"{'moments' if not low.point else 'point context'}, {low.n_trans} values per "
            f"transition, {low.lane_bytes()} B per lane): route {name} {launches[name]} "
            f"launches, K2 {launches['compact_rows']}, 0 engine chunks, {events} events in "
            f"{wall:.4f} s ({events / wall:.1f} events/s, one call, the first); {gate}; f32 "
            f"chunk (K=32) {ms:.4f} ms at the deployment's start, bound {bound_text(b)}{eng}")
    d, Bm, _ = MIXTURE
    x0 = mixture_means(d)[np.arange(Bm) % 4]
    for kind, sampler in lse_launch_samplers().items():
        v0 = np.full((Bm, d), 1.0 / math.sqrt(d)) if kind == "ecmc" else np.ones((Bm, d))
        ms, b = kernel_chunk(sampler, x0, v0)
        key = f"{kind}_mixture4_broadcast_d100"
        texts.append(f"{kind}_mixture4_d100 (no deployment: {type(sampler).__name__} d={d} "
                     f"B={Bm}): f32 chunk (K=32) {ms:.4f} ms from the modes, bound "
                     f"{bound_text(b)}; its f64 parity launch {errs[key]:.3e}, plain "
                     f"{plain[key]:.1f} ms")
    # a max over the coordinates puts K1 in point mode: what that costs at
    # d = 1000 beside the tagged Gaussian at the same shape and start
    d, Bc = LSE_COORDS
    x0, v0 = np.full((Bc, d), 0.3), np.ones((Bc, d))
    c_ms, c_b = kernel_chunk(lse_coords_sampler(), x0, v0, reps=3)
    g_ms, g_b = kernel_chunk(pt.ZigZag(d, pt.potentials.grad_gauss), x0, v0,
                             config=card_config)
    texts.append(f"zigzag_lse_coords_d{d} (no deployment: ZigZagAD(|x|^2 / 2 + logsumexp(x)) "
                 f"B={Bc}, point mode): f32 chunk (K=32) {c_ms:.4f} ms, bound "
                 f"{bound_text(c_b)}; the tagged Gaussian {g_ms:.4f} ms (bound "
                 f"{bound_text(g_b)}), {c_ms / g_ms:.1f}x")
    sd = np.sqrt(np.diag(cov))
    gap = np.abs(means["zigzag_softmax_d100_n1000"] - means["bps_softmax_d100_n1000"]) / sd
    if not np.all(gap < 0.2):
        raise AssertionError(f"phase 44: K1's and K3's softmax means apart by {gap.tolist()} sd")
    print(f"phase 44 deployments: {'; '.join(texts)}; K1 and K3 softmax means within "
          f"{float(gap.max()):.4f} < 0.2 Laplace sd of each other, the importance-sampled "
          f"mean (ESS {ess:.0f}) {float((np.abs(ref_mean - w_map) / sd).max()):.3f} Laplace sd "
          f"from the MAP at most, Laplace sd {float(sd.min()):.4f}-{float(sd.max()):.4f} "
          f"({card_name})", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 45: running sums, flips and periodic shifts (cumsum, flip, roll)
# lowered into the chunk kernels
# ---------------------------------------------------------------------------

LOCAL_LEVEL_Q = 1469.1 / 15099.0       # Durbin & Koopman's Nile signal-to-noise ratio
LOCAL_LEVEL = (1000, 128, 2048)         # phase 45: d, chains, points
POISSON_RW = (math.log(5.0), 0.05)      # the log-intensity's level and step sd
PHI4 = (8, -4.0, 8.0, 1024, 2048)       # L, M2, lambda (Albergo et al.), chains, points
PHI4_ENGINE = (256, 512)                # chains, points of the engine call
SCAN_PARITY_D = 100                     # d of the local level and Poisson walk parity launches
SCAN_BATCHES = 32                       # batches of chains behind the phi^4 gate's bands


def scan_data(d, seed=19):
    """``y`` of the local level model and of the Poisson walk, each drawn
    from its model at length 1000 with a numpy seed; a target at d reads the
    first d (the walk's prefix is the model at d)."""
    rs = np.random.default_rng(seed)
    s = math.sqrt(LOCAL_LEVEL_Q)
    level = s * np.cumsum(rs.normal(size=1000)) + rs.normal(size=1000)
    a, sig = POISSON_RW
    counts = rs.poisson(np.exp(a + sig * np.cumsum(rs.normal(size=1000)))).astype(float)
    return level[:d], counts[:d]


def local_level(d):
    """The local level model of Durbin & Koopman (2012, ch. 2) in
    non-centred form, sigma_eps = 1, sigma_eta = sqrt(q): ``|z|^2 / 2 +
    sum((y - sigma_eta cumsum(z))^2) / 2``."""
    y = torch.as_tensor(scan_data(d)[0], device=DEV)
    s = math.sqrt(LOCAL_LEVEL_Q)
    return lambda z: (z @ z / 2 + torch.sum((y.to(z) - s * torch.cumsum(z, 0)) ** 2) / 2)


def poisson_rw(d):
    """Poisson counts on the random-walk log-intensity ``a + s cumsum(z)``."""
    y = torch.as_tensor(scan_data(d)[1], device=DEV)
    a, s = POISSON_RW

    def U(z):
        eta = a + s * torch.cumsum(z, 0)
        return z @ z / 2 + torch.sum(torch.exp(eta) - y.to(z) * eta)

    return U


def phi4_2d(x):
    """``ScalarPhi4Action`` of Albergo et al. (arXiv:2101.08176) on the L x L
    periodic lattice ``x.reshape(L, L)``, its published L = 8, M2 = -4,
    lambda = 8."""
    L, m2, lam = PHI4[:3]
    p = x.reshape(L, L)
    action = m2 * p * p + lam * p ** 4
    for mu in (0, 1):
        action = action + 2 * p * p - p * torch.roll(p, -1, mu) - p * torch.roll(p, 1, mu)
    return torch.sum(action)


def local_level_posterior(d):
    """The exact Gaussian posterior: precision ``P = I + q L^T L`` (``L`` the
    lower-triangular matrix of ones), mean ``P^-1 sqrt(q) L^T y``; returns
    (mean, covariance), float64 numpy."""
    L = np.tril(np.ones((d, d)))
    P = np.eye(d) + LOCAL_LEVEL_Q * L.T @ L
    cov = np.linalg.inv(P)
    return cov @ (math.sqrt(LOCAL_LEVEL_Q) * L.T @ scan_data(d)[0]), cov


@cache
def scan_paths():
    """Phase 45's timed cells: name -> (sampler, (d, chains, points))."""
    d, B, n_sk = LOCAL_LEVEL
    L, _, _, Bp, n_p = PHI4
    ll = local_level(d)
    return {"zigzag_local_level_d1000": (pt.ZigZagAD(d, ll), (d, B, n_sk)),
            "bps_local_level_d1000": (pt.BPSAD(d, ll, refresh_rate=1.0), (d, B, n_sk)),
            "zigzag_phi4_l8": (pt.ZigZagAD(L * L, phi4_2d), (L * L, Bp, n_p)),
            "bps_phi4_l8": (pt.BPSAD(L * L, phi4_2d, refresh_rate=1.0), (L * L, Bp, n_p))}


@cache
def scan_launch_samplers():
    """K6 (kappa 1) and K5 on the local level at d = 1000, K4 on it at
    ``SCAN_PARITY_D`` (its lane keeps both running sums at the point, past
    ``LANE_BYTES`` at d = 1000): each timed on one f32 launch from exact
    posterior draws (phase 45 runs no deployment of theirs)."""
    d, dk = LOCAL_LEVEL[0], SCAN_PARITY_D
    ll = local_level(d)
    return {"sticky": pt.StickyZigZagAD(d, ll, np.ones(d)),
            "suzz": pt.SpeedUpZigZagAD(dk, local_level(dk)), "ecmc": pt.ForwardECMCAD(d, ll)}


def scan_start(sampler, B, exact, seed=45):
    """x0 from B exact draws of the local level's posterior at the
    sampler's d (``exact``), else 0; v0 = +-1 (a unit normal for the
    scalar-rate samplers)."""
    d = sampler.dim
    rs = np.random.default_rng(seed)
    x0 = np.zeros((B, d))
    if exact:
        mean, cov = local_level_posterior(d)
        x0 = mean + rs.normal(size=(B, d)) @ np.linalg.cholesky(cov).T
    if driver.kernel_kind(sampler) in k3.KINDS:
        v0 = rs.normal(size=(B, d))
        return x0, v0 / np.linalg.norm(v0, axis=1, keepdims=True)
    return x0, rs.choice([-1.0, 1.0], size=(B, d))


@cache
def scan_parity_samplers():
    """Phase 45's parity launches: (name, sampler, bit for bit, horizon
    modes) for the local level and the Poisson walk at ``SCAN_PARITY_D`` and
    the phi^4 lattice at L = 8 on K1, K6, K4, K3 (BPS, Boomerang) and K5, and
    the local level at ``LOCAL_LEVEL``'s d on K1, K6, K3 (BPS) and K5; K1 and
    K3 also in horizon mode on the local level."""
    d = SCAN_PARITY_D
    targets = {f"local_level_d{d}": (d, local_level(d)), f"poisson_rw_d{d}": (d, poisson_rw(d)),
               "phi4_l8": (PHI4[0] ** 2, phi4_2d)}
    makes = [("zigzag", pt.ZigZagAD, False),
             ("sticky", lambda d, U: pt.StickyZigZagAD(d, U, np.ones(d)), False),
             ("suzz", pt.SpeedUpZigZagAD, True),
             ("bps", lambda d, U: pt.BPSAD(d, U, refresh_rate=1.0), True),
             ("boomerang", lambda d, U: pt.BoomerangAD(d, U, refresh_rate=1.0), True),
             ("ecmc", pt.ForwardECMCAD, True)]
    out = [(f"{kind}_{target}", make(dt, U), bitwise,
            [False, True] if kind in ("zigzag", "bps") and "local_level" in target
            else [False])
           for target, (dt, U) in targets.items() for kind, make, bitwise in makes]
    # the local level at the timed cells' d, where K1's lanes and K3's warp
    # split the scans into longer runs: every kernel the cells and the
    # timed launches take but K4 (its lane is past LANE_BYTES there)
    dl = LOCAL_LEVEL[0]
    ll = local_level(dl)
    return out + [(f"{kind}_local_level_d{dl}", make(dl, ll), bitwise,
                   [False, True] if kind in ("zigzag", "bps") else [False])
                  for kind, make, bitwise in makes if kind in ("zigzag", "sticky", "bps",
                                                                "ecmc")]


def local_level_gate(what, sampler, skel, mean, cov, x0):
    """Pooled mean and variance of every coordinate against the exact
    posterior.  The chains start from B exact draws, so every time's law is
    the posterior: each coordinate's pooled mean is off by at most sd_i /
    sqrt(B) in sd and its variance ratio by sqrt(2 / (B - 1)), whatever the
    mixing; the bands are 5 of those (the starting draws' own printed)."""
    B = x0.shape[0]
    sd = np.sqrt(np.diag(cov))
    m_band, v_band = 5 / math.sqrt(B), 5 * math.sqrt(2 / (B - 1))
    got_m, got_v = (a.double().cpu().numpy() for a in pt.pooled_moments(skel, sampler, 256))
    dm, dv = np.abs(got_m - mean) / sd, np.abs(got_v / sd ** 2 - 1)
    sm, sv = np.abs(x0.mean(0) - mean) / sd, np.abs(x0.var(0) / sd ** 2 - 1)
    if not (dm.max() < m_band and dv.max() < v_band):
        raise AssertionError(f"{what}: off the posterior: max|mean - mu| {dm.max():.4f} sd "
                             f"(band {m_band:.4f}), max|var / s^2 - 1| {dv.max():.4f} (band "
                             f"{v_band:.4f})")
    return (f"every coordinate's pooled mean within {dm.max():.4f} sd of the exact mean (band "
            f"{m_band:.4f} = 5 / sqrt(B); the {B} starting draws {sm.max():.4f}), its variance "
            f"within {dv.max():.4%} (band {v_band:.4f} = 5 sqrt(2 / (B - 1)); the starting "
            f"draws {sv.max():.4%}), posterior sd {sd.min():.4f}-{sd.max():.4f}")


def phi4_moments(sampler, skel):
    """Each chain's site averages of phi^2 and phi^4 over the second half of
    its equal-time samples, as float64 ``(B, 2)``."""
    xs = pt.sample_from_skeleton_batch(sampler, 256, skel)
    xs = xs[:, xs.shape[1] // 2:].double()
    return torch.stack([(xs ** 2).mean((1, 2)), (xs ** 4).mean((1, 2))], 1).cpu().numpy()


def batch_means(per_chain):
    """The mean of ``(B, k)`` per-chain values and its standard error from
    ``SCAN_BATCHES`` batch means of consecutive chains."""
    b = per_chain[:per_chain.shape[0] // SCAN_BATCHES * SCAN_BATCHES]
    means = b.reshape(SCAN_BATCHES, -1, b.shape[1]).mean(1)
    return means.mean(0), means.std(0, ddof=1) / math.sqrt(SCAN_BATCHES)


def phase_scan(card_name):
    """Phase 45: running sums, flips and periodic shifts.  First every kernel
    against its plain version in f64 (64 chains, one launch of 4
    transitions, K4's of 32; K3/K5 and K4 bit for bit, K1 and K6 within
    1e-12) on the local level model and the
    Poisson walk at d = 100, on the phi^4 lattice at L = 8 and on the local
    level at d = 1000 (all but K4), each taking its kernel under ``"auto"``,
    K1 and K3 also in horizon mode on the local level; then
    ``zigzag_local_level_d1000``/``bps_local_level_d1000`` (128 chains x 2048
    points from exact posterior draws, gated on every coordinate's pooled
    mean and variance) and ``zigzag_phi4_l8``/``bps_phi4_l8`` (1024 chains x
    2048 points from x0 = 0, their <phi^2> and <phi^4> against each other
    and against one engine call, ``backend="xla_stream"``, 256 chains x 512
    points, timed), each one call under ``"auto"`` (its library built
    before; no ``LoweringError``, launches on its kernel and K2 alone) with
    an f32 launch and its bound; one f32 launch each of K6 and K5 on the
    local level at d = 1000 and of K4 at d = 100.  Returns {path:
    (launches, ms, plain ms, bound, err)}."""
    B, K = LSE_PARITY
    t0 = time.perf_counter()
    errs, plain, texts = {}, {}, []
    for name, sampler, bitwise, modes in scan_parity_samplers():
        route = api.pick_backend(sampler, "auto", sampler.dim, torch.float64, DEV)
        if route != "kernel":
            raise AssertionError(f"phase 45 {name}: the f64 route is {route}")
        for horizon in modes:
            what = f"phase 45 {name}{' horizon' if horizon else ''}"
            k = 8 * K if driver.kernel_kind(sampler) == "suzz" else K  # K4: fewer events
            err, n_ev, ms = user_compare(what, sampler, B, bitwise, n_chunks=1,
                                         horizon=horizon, K=k)
            if err > 1e-12:
                raise AssertionError(f"{what}: max_abs_err {err:.3e} past 1e-12")
            key = name + ("_horizon" if horizon else "")
            errs[key], plain[key] = err, ms
            texts.append(f"{key} {'bit for bit' if bitwise else f'{err:.3e}'} ({n_ev} events)")
    print(f"phase 45 parity (f64, B={B}, K={K}, one launch each; K3/K5 and K4 bit for bit, K1 "
          f"and K6 within 1e-12; every route the kernel): {'; '.join(texts)} "
          f"({time.perf_counter() - t0:.1f} s, {card_name})", flush=True)

    mean, cov = local_level_posterior(LOCAL_LEVEL[0])
    out, phi, texts = {}, {}, []
    for path, (sampler, (dp, Bp, n_sk)) in scan_paths().items():
        what = f"phase 45 {path}"
        kind = driver.kernel_kind(sampler)
        x0, v0 = scan_start(sampler, Bp, "local_level" in path)
        route = api.pick_backend(sampler, "auto", dp, torch.float32, DEV)
        if route != "kernel":
            raise AssertionError(f"{what}: 'auto' takes {route}")
        build.reset_launches()
        engine.reset_counts()
        t1 = time.perf_counter()
        skel = pt.sample_skeleton(sampler, n_sk, x0, v0, seed=0, dtype=torch.float32,
                                  device=DEV)
        sync()
        wall = time.perf_counter() - t1
        launches, chunks = dict(build.LAUNCHES), engine.COUNTS["chunks"]
        name = path_launch(sampler)
        others = {k: n for k, n in launches.items() if n and k not in (name, "compact_rows")}
        if launches[name] < 1 or launches["compact_rows"] < 1 or others or chunks:
            raise AssertionError(f"{what}: the path did not take {name} and K2 alone: "
                                 f"{launches}, {chunks} engine chunks")
        check_complete(what, skel, n_sk)
        events = int(skel.n_valid.sum()) - Bp
        if "local_level" in path:
            gate = local_level_gate(what, sampler, skel, mean, cov, x0)
        else:
            phi[path] = batch_means(phi4_moments(sampler, skel))
            gate = (f"<phi^2> {phi[path][0][0]:.5f} +- {phi[path][1][0]:.5f}, <phi^4> "
                    f"{phi[path][0][1]:.5f} +- {phi[path][1][1]:.5f} (batch means)")
        del skel
        ms, b = kernel_chunk(sampler, x0, v0)
        target = f"local_level_d{dp}" if "local_level" in path else "phi4_l8"
        key = f"{path.split('_')[0]}_{target}"
        out[path] = (launches, ms, plain[key], b, errs[key])
        low = lower.lower_sampler(sampler, kind, dp, torch.float32, DEV)
        texts.append(
            f"{path} ({type(sampler).__name__} d={dp} B={Bp} n_sk={n_sk}; "
            f"{len(low.products)} running sums ({len(low.trans)} per transition), "
            f"{'moments' if not low.point else 'point context'}, {low.n_trans} values per "
            f"transition, {low.lane_bytes()} B per lane): route {name} {launches[name]} "
            f"launches, K2 {launches['compact_rows']}, 0 engine chunks, {events} events in "
            f"{wall:.4f} s ({events / wall:.1f} events/s, one call, the first); {gate}; f32 "
            f"chunk (K=32) {ms:.4f} ms at the deployment's start, bound {bound_text(b)}")
    B = LOCAL_LEVEL[1]
    for kind, sampler in scan_launch_samplers().items():
        x0, v0 = scan_start(sampler, B, True)
        ms, b = kernel_chunk(sampler, x0, v0)
        key = f"{kind}_local_level_d{sampler.dim}"
        texts.append(f"{kind}_local_level_d{sampler.dim} (no deployment: "
                     f"{type(sampler).__name__} d={sampler.dim} B={B}): f32 chunk (K=32) "
                     f"{ms:.4f} ms from exact posterior draws, bound {bound_text(b)}; its f64 "
                     f"parity launch (same d) {errs[key]:.3e}, plain {plain[key]:.1f} ms")
    # the phi^4 lattice on the engine: the route "auto" did not take
    Be, ne = PHI4_ENGINE
    sampler = pt.ZigZagAD(PHI4[0] ** 2, phi4_2d)
    x0, v0 = np.zeros((Be, sampler.dim)), np.ones((Be, sampler.dim))
    skel, e_wall, k2_n, e_chunks, transitions, eng_ms, _ = engine_call(
        sampler, ne, x0, v0, seed=0, backend="xla_stream")
    check_complete("phase 45 phi4 on the engine", skel, ne)
    phi["engine"] = batch_means(phi4_moments(sampler, skel))
    del skel
    bands = []
    for a, c in (("zigzag_phi4_l8", "bps_phi4_l8"), ("zigzag_phi4_l8", "engine")):
        (ma, sa), (mc, sc) = phi[a], phi[c]
        gap, band = np.abs(ma - mc), 5 * np.sqrt(sa ** 2 + sc ** 2)
        if not np.all(gap < band):
            raise AssertionError(f"phase 45: <phi^2>, <phi^4> of {a} {ma.tolist()} and {c} "
                                 f"{mc.tolist()} apart by {gap.tolist()} (bands {band.tolist()})")
        bands.append(f"{a} and {c} apart by {gap[0]:.5f}, {gap[1]:.5f} (bands 5 combined "
                     f"errors: {band[0]:.5f}, {band[1]:.5f})")
    print(f"phase 45 deployments: {'; '.join(texts)}; the phi^4 lattice on the engine "
          f"(ZigZagAD, backend='xla_stream', B={Be}, n_sk={ne}, second half): <phi^2> "
          f"{phi['engine'][0][0]:.5f} +- {phi['engine'][1][0]:.5f}, <phi^4> "
          f"{phi['engine'][0][1]:.5f} +- {phi['engine'][1][1]:.5f}, {e_chunks} engine chunks "
          f"({transitions} transitions, {eng_ms:.2f} ms by CUDA events, "
          f"{eng_ms / max(e_chunks, 1):.2f} a chunk), K2 {k2_n}, call {e_wall:.3f} s; "
          f"{'; '.join(bands)} ({card_name})", flush=True)
    return out


RADON = (1024, 2048)                    # phase 46: chains, points of the radon cells
RADON_TRUTH = (1.46, -0.69, 0.76, 0.33)  # mu_alpha, beta, sigma_y, sigma_alpha (Gelman & Hill)
ICAR = (32, 128, 2048)                  # grid side L (d = L^2), chains, points
ICAR_SCALAR_F64 = 24                    # grid side of the ICAR's K3/K5 f64 parity
ICAR_SUZZ_TMAX = 0.02                   # K4's first horizon on the ICAR (the default 2.0 stalls)


def radon_data(J=85, n=919):
    """(county, floor, y) of the Minnesota radon survey's shape (Gelman &
    Hill 2007, ch. 12): ``J`` county sizes summing to ``n`` houses (each at
    least 1, the rest on lognormal(0, 1.6) weights: at 85 and 919 a median
    of 5 houses, three counties past 50, the largest 118), the houses in a
    seeded order, a first-floor indicator with probability 0.17 and ``y``
    drawn from the varying-intercept model at the book's estimates.  The
    port's tests draw their smaller data here too."""
    mu, beta, sy, sa = RADON_TRUTH
    rs = np.random.default_rng(20)
    w = rs.lognormal(0.0, 1.6, size=J)
    sizes = 1 + rs.multinomial(n - J, w / w.sum())
    county = rs.permutation(np.repeat(np.arange(J), sizes))
    floor = (rs.random(n) < 0.17).astype(float)
    alpha = mu + sa * rs.normal(size=J)
    return county, floor, alpha[county] + beta * floor + sy * rs.normal(size=n)


def radon(fixed=False):
    """The varying-intercept model: ``y_r ~ N(alpha[county_r] + beta
    floor_r, sigma_y^2)``, ``alpha_j ~ N(mu_alpha, sigma_alpha^2)``, N(0, 10^2)
    on mu_alpha and beta; ``x = (alpha, mu_alpha, beta, log sigma_alpha, log
    sigma_y)`` with N(0, 1) on the log scales (d = 89), or with both scales
    fixed at the book's estimates (``fixed``: d = 87, a Gaussian
    posterior)."""
    county, floor, y = (torch.as_tensor(a, device=DEV) for a in radon_data())
    J, n = int(county.max()) + 1, y.shape[0]
    sy, sa = RADON_TRUTH[2:]

    def U(x):
        a, mu, b = x[:J], x[J], x[J + 1]
        r = y.to(x) - a[county.to(x.device)] - b * floor.to(x)
        prior = mu * mu / 200 + b * b / 200
        if fixed:
            return (torch.sum(r * r) / (2 * sy ** 2) + torch.sum((a - mu) ** 2) / (2 * sa ** 2)
                    + prior)
        lsa, lsy = x[J + 2], x[J + 3]
        return (0.5 * torch.sum(r * r) * torch.exp(-2 * lsy) + n * lsy
                + 0.5 * torch.sum((a - mu) ** 2) * torch.exp(-2 * lsa) + J * lsa
                + prior + 0.5 * (lsa * lsa + lsy * lsy))

    return U


def radon_posterior():
    """``radon_fixed``'s exact Gaussian posterior: precision ``A^T A /
    sigma_y^2 + C^T C / sigma_alpha^2`` plus the priors' (``A`` the houses'
    design, ``C`` the intercepts less mu_alpha), mean ``P^-1 A^T y /
    sigma_y^2``; returns (mean, covariance), float64 numpy."""
    county, floor, y = radon_data()
    J, n = int(county.max()) + 1, len(y)
    sy, sa = RADON_TRUTH[2:]
    A = np.zeros((n, J + 2))
    A[np.arange(n), county] = 1.0
    A[:, J + 1] = floor
    C = np.concatenate([np.eye(J), -np.ones((J, 1)), np.zeros((J, 1))], 1)
    P = A.T @ A / sy ** 2 + C.T @ C / sa ** 2 + np.diag([0.0] * J + [0.01, 0.01])
    cov = np.linalg.inv(P)
    return cov @ (A.T @ y / sy ** 2), cov


RADON_X_COEF = ((-0.69, 0.25, -0.15, 0.1), (0.72, -0.3))
"""beta (the floor's, Gelman & Hill's -0.69, then three seeded house-level
columns') and gamma (county log-uranium's, the book's 0.72, then a seeded
county-level column's) of :func:`radon_x_data`."""


def radon_x_data(J=85, n=919):
    """(county, X, Z, y) of Gelman & Hill's radon model with individual- and
    group-level predictors (2007, ch. 12.6), each widened to a covariate
    matrix: :func:`radon_data`'s counties and floor, ``X`` the floor and
    three more seeded house-level columns (n x 4), ``Z`` a seeded county
    log-uranium column and one more seeded column (J x 2), and ``y`` drawn
    from ``y_r ~ N(alpha[county_r] + X_r beta, sigma_y^2)``, ``alpha = mu +
    Z gamma + sigma_alpha eta``, ``eta ~ N(0, I)``, at ``RADON_TRUTH`` and
    ``RADON_X_COEF``."""
    county, floor, _ = radon_data(J, n)
    mu, _, sy, sa = RADON_TRUTH
    beta, gamma = (np.array(c) for c in RADON_X_COEF)
    rs = np.random.default_rng(21)
    X = np.concatenate([floor[:, None], rs.normal(size=(n, 3))], 1)
    Z = np.stack([rs.normal(0.0, 0.35, size=J), rs.normal(size=J)], 1)
    alpha = mu + Z @ gamma + sa * rs.normal(size=J)
    return county, X, Z, alpha[county] + X @ beta + sy * rs.normal(size=n)


def radon_x_model(data, np_=torch, fixed=False, const=None):
    """The non-centred radon model on ``data`` as a user writes it, in the
    numpy-like module ``np_`` (``const`` makes its constants): ``x = (eta,
    mu, beta, gamma, log sigma_alpha, log sigma_y)`` with N(0, 10^2) on mu,
    beta and gamma and N(0, 1) on the log scales (d = J + 9), or with both
    scales fixed at ``RADON_TRUTH`` (``fixed``: d = J + 7, a Gaussian
    posterior)."""
    county, X, Z, y = data
    J, n = Z.shape[0], len(y)
    sy, sa = RADON_TRUTH[2:]
    const = const or (lambda a: torch.as_tensor(a, device=DEV))
    c, Xc, Zc, yc = (const(a) for a in (county, X, Z, y))

    def U(x):
        eta, mu, b, g = x[:J], x[J], x[J + 1:J + 5], x[J + 5:J + 7]
        cx = c.to(x.device) if np_ is torch else c
        Xx, Zx, yx = ((a.to(x) for a in (Xc, Zc, yc)) if np_ is torch else (Xc, Zc, yc))
        prior = (mu * mu + np_.sum(b * b) + np_.sum(g * g)) / 200 + 0.5 * np_.sum(eta * eta)
        if fixed:
            r = yx - (mu + Zx @ g + sa * eta)[cx] - Xx @ b
            return 0.5 * np_.sum(r * r) / sy ** 2 + prior
        lsa, lsy = x[J + 7], x[J + 8]
        r = yx - (mu + Zx @ g + np_.exp(lsa) * eta)[cx] - Xx @ b
        return (0.5 * np_.sum(r * r) * np_.exp(-2 * lsy) + n * lsy + prior
                + 0.5 * (lsa * lsa + lsy * lsy))

    return U


def radon_x(fixed=False):
    """:func:`radon_x_model` at full size (d = 94, or 92 with the scales
    fixed), its data on the card."""
    return radon_x_model(radon_x_data(), fixed=fixed)


def radon_x_posterior(data=None):
    """``radon_x(fixed=True)``'s exact Gaussian posterior: ``r = y - A x``
    with ``A`` the houses' design (sigma_alpha at each house's county's eta,
    1 at mu, X at beta, Z at the house's county at gamma), precision ``A^T A
    / sigma_y^2`` plus the priors' (1 on eta, 1/100 on mu, beta, gamma), mean
    ``P^-1 A^T y / sigma_y^2``; returns (mean, covariance), float64 numpy."""
    county, X, Z, y = radon_x_data() if data is None else data
    J, n = Z.shape[0], len(y)
    sy, sa = RADON_TRUTH[2:]
    A = np.zeros((n, J + 7))
    A[np.arange(n), county] = sa
    A[:, J] = 1.0
    A[:, J + 1:J + 5] = X
    A[:, J + 5:] = Z[county]
    P = A.T @ A / sy ** 2 + np.diag([1.0] * J + [0.01] * 7)
    cov = np.linalg.inv(P)
    return cov @ (A.T @ y / sy ** 2), cov


def icar_graph(L):
    """(edges, y) of an areal map without a band: an L x L grid
    triangulated by one diagonal per cell, its direction drawn from the seed
    (``2 L (L - 1) + (L - 1)^2`` edges: 2945 at L = 32, mean degree 5.75),
    the areas relabelled by a seeded permutation, and unit-noise
    observations of a smooth field at each area.  The port's tests build
    their smaller graphs here too."""
    rs = np.random.default_rng(20)
    lab = rs.permutation(L * L).reshape(L, L)
    edges = [(lab[i, j], lab[i, j + 1]) for i in range(L) for j in range(L - 1)]
    edges += [(lab[i, j], lab[i + 1, j]) for i in range(L - 1) for j in range(L)]
    for i in range(L - 1):
        for j in range(L - 1):
            edges.append((lab[i, j], lab[i + 1, j + 1]) if rs.random() < 0.5
                         else (lab[i, j + 1], lab[i + 1, j]))
    grid = np.arange(L) * 2 * np.pi / L
    field = np.sin(grid)[:, None] + np.cos(grid)[None, :]
    y = np.empty(L * L)
    y[lab.reshape(-1)] = (field + rs.normal(size=(L, L))).reshape(-1)
    return np.array(edges), y


def icar(L=None):
    """The ICAR prior as the Stan case study on the BYM model writes it
    (Morris et al., Spatial and Spatio-temporal Epidemiology 31, 2019):
    ``0.5 sum((phi[node1] - phi[node2])^2)`` plus the soft sum-to-zero ``0.5
    (sum(phi) / (0.001 d))^2``, with unit-noise observations ``0.5 sum((y -
    phi)^2)`` at each area of :func:`icar_graph` at side ``L`` (``ICAR``'s
    by default)."""
    edges, y = icar_graph(L or ICAR[0])
    E, y = torch.as_tensor(edges, device=DEV), torch.as_tensor(y, device=DEV)

    def U(phi):
        Ed = E.to(phi.device)
        dphi = phi[Ed[:, 0]] - phi[Ed[:, 1]]
        return (0.5 * torch.sum(dphi ** 2) + 0.5 * (torch.sum(phi) / (0.001 * phi.shape[0])) ** 2
                + 0.5 * torch.sum((y.to(phi) - phi) ** 2))

    return U


def icar_posterior():
    """The ICAR target's exact Gaussian posterior: precision the graph's
    Laplacian plus ``1 1^T / (0.001 d)^2`` plus the identity, mean ``P^-1
    y``; returns (mean, covariance), float64 numpy."""
    edges, y = icar_graph(ICAR[0])
    d = len(y)
    P = np.eye(d) + np.ones((d, d)) / (0.001 * d) ** 2
    np.add.at(P, (edges[:, 0], edges[:, 0]), 1.0)
    np.add.at(P, (edges[:, 1], edges[:, 1]), 1.0)
    np.add.at(P, (edges[:, 0], edges[:, 1]), -1.0)
    np.add.at(P, (edges[:, 1], edges[:, 0]), -1.0)
    cov = np.linalg.inv(P)
    return cov @ y, cov


@cache
def gather_paths():
    """Phase 46's timed cells: name -> (sampler, (d, chains, points))."""
    B, n_sk = RADON
    L, Bi, ni = ICAR
    Uf, Ui = radon(fixed=True), icar()
    return {"zigzag_radon_d87": (pt.ZigZagAD(87, Uf), (87, B, n_sk)),
            "bps_radon_d87": (pt.BPSAD(87, Uf, refresh_rate=1.0), (87, B, n_sk)),
            "zigzag_icar_d1024": (pt.ZigZagAD(L * L, Ui), (L * L, Bi, ni)),
            "bps_icar_d1024": (pt.BPSAD(L * L, Ui, refresh_rate=1.0), (L * L, Bi, ni))}


GATHER_PLAIN_OF = {
    "zigzag_radon_d87": "the f64 parity launch (B={B}, K={K}) from a random state on the same "
                        "kernel, model (the scales fixed) and d",
    "bps_radon_d87": "the f64 parity launch (B={B}, K={K}) from a random state on the same "
                     "kernel, model (the scales fixed) and d",
    "zigzag_icar_d1024": "the f64 parity launch (B={B}, K={K}) from a random state on the "
                         "same kernel, target and d",
    "bps_icar_d1024": "an f32 parity launch (B={B}, K={K}) of the library timed, from the "
                      "deployment's first {B} starts",
}
"""What each phase-46 path's ``plain_ms`` and ``max_abs_err`` come from
(``ms`` is an f32 launch from the deployment's start)."""


@cache
def gather_launch_samplers():
    """K6 (kappa 1), K5 and K4 on the ICAR target at d = 1024, each timed on
    one f32 launch from exact posterior draws (phase 46 runs no deployment
    of theirs); K4 with its first envelope's horizon at ``ICAR_SUZZ_TMAX``
    (the default 2.0 stalls there: :func:`phase_gather`)."""
    d, Ui = ICAR[0] ** 2, icar()
    return {"sticky": pt.StickyZigZagAD(d, Ui, np.ones(d)), "ecmc": pt.ForwardECMCAD(d, Ui),
            "suzz": pt.SpeedUpZigZagAD(d, Ui, tmax=ICAR_SUZZ_TMAX)}


@cache
def gather_stall_sampler():
    """K4 on the ICAR target at d = 1024 at its default first horizon
    (``tmax`` 2.0), launched once to show its envelope's rejections."""
    return pt.SpeedUpZigZagAD(ICAR[0] ** 2, icar())


@cache
def gather_parity_samplers():
    """Phase 46's parity launches: (name, sampler, bit for bit, horizon
    modes): the full radon model (d = 89) on K1, K6, K4, K3 (BPS,
    Boomerang) and K5; the radon model with its scales fixed (d = 87, the
    timed cells' model) on K1 and K3; the ICAR target on K1, K6 and K4 (its
    first horizon ``ICAR_SUZZ_TMAX``) at d = 1024 and on K3 and K5 at
    ``ICAR_SCALAR_F64`` = 24 x 24 (in float64 their shared memory holds d <=
    605 for a potential with no per-transition values, so ``"auto"`` takes
    the engine at d = 1024; :func:`phase_gather` holds the f32 library of
    ``bps_icar_d1024`` at d = 1024), K1 and K3 also in horizon mode."""
    makes = [("zigzag", pt.ZigZagAD, False),
             ("sticky", lambda d, U: pt.StickyZigZagAD(d, U, np.ones(d)), False),
             ("suzz", pt.SpeedUpZigZagAD, True),
             ("bps", lambda d, U: pt.BPSAD(d, U, refresh_rate=1.0), True),
             ("boomerang", lambda d, U: pt.BoomerangAD(d, U, refresh_rate=1.0), True),
             ("ecmc", pt.ForwardECMCAD, True)]
    Ls, Li = ICAR_SCALAR_F64, ICAR[0]
    icar_suzz = lambda d, U: pt.SpeedUpZigZagAD(d, U, tmax=ICAR_SUZZ_TMAX)  # noqa: E731
    targets = {"radon_d89": (89, radon(), [k for k, _, _ in makes]),
               "radon_d87": (87, radon(fixed=True), ["zigzag", "bps"]),
               f"icar_d{Li ** 2}": (Li ** 2, icar(), ["zigzag", "sticky", "suzz"]),
               f"icar_d{Ls ** 2}": (Ls ** 2, icar(Ls), ["bps", "boomerang", "ecmc"])}
    return [(f"{kind}_{target}",
             (icar_suzz if kind == "suzz" and "icar" in target else make)(d, U), bitwise,
             [False, True] if kind in ("zigzag", "bps") and "icar" in target else [False])
            for target, (d, U, kinds) in targets.items() for kind, make, bitwise in makes
            if kind in kinds]


def gather_start(sampler, B):
    """x0 from B exact posterior draws of the sampler's Gaussian target
    (``radon_fixed`` at d = 87, the ICAR at d = 1024); v0 = +-1 (a unit
    normal for the scalar-rate samplers)."""
    d = sampler.dim
    rs = np.random.default_rng(46)
    mean, cov = radon_posterior() if d == 87 else icar_posterior()
    x0 = mean + rs.normal(size=(B, d)) @ np.linalg.cholesky(cov).T
    if driver.kernel_kind(sampler) in k3.KINDS:
        v0 = rs.normal(size=(B, d))
        return x0, v0 / np.linalg.norm(v0, axis=1, keepdims=True)
    return x0, rs.choice([-1.0, 1.0], size=(B, d))


def phase_gather(card_name):
    """Phase 46: reads at a constant index array and their scatter-adds.
    First every kernel against its plain version in f64 (``LSE_PARITY``: 64
    chains, one launch of 4 transitions, on the radon model of 2 but K5's, K4's
    of 16; K3/K5
    and K4 bit for bit, K1 and K6 within 1e-12) on the radon model (d = 89;
    d = 87 on K1 and K3) and on the ICAR target (K1, K6 and K4 at d = 1024,
    K3/K5 at d = 576: :func:`gather_parity_samplers`), each taking its
    kernel under ``"auto"``, K1 and K3 also in horizon mode on the ICAR; then
    ``zigzag_radon_d87`` and ``bps_radon_d87`` (1024 chains x 2048 points)
    and ``zigzag_icar_d1024`` and ``bps_icar_d1024`` (128 chains x 2048
    points), each one call under ``"auto"`` from exact posterior draws (its
    library built before; no ``LoweringError``, launches on its kernel and
    K2 alone), gated on every coordinate's pooled mean and variance against
    the exact posterior (:func:`local_level_gate`'s bands), with an f32
    launch and its bound, ``bps_icar_d1024``'s f32 library also against its
    plain version (``GATHER_PLAIN_OF``); one f32 launch each of K6, K5 and K4
    on the ICAR, and K4's first launch at the default first horizon (2.0),
    whose envelope rejects nearly every transition there.  Returns {path:
    (launches, ms, plain ms, bound, err)}."""
    B, K = LSE_PARITY
    t0 = time.perf_counter()
    errs, plain, texts = {}, {}, []
    for name, sampler, bitwise, modes in gather_parity_samplers():
        route = api.pick_backend(sampler, "auto", sampler.dim, torch.float64, DEV)
        if route != "kernel":
            raise AssertionError(f"phase 46 {name}: the f64 route is {route}")
        for horizon in modes:
            what = f"phase 46 {name}{' horizon' if horizon else ''}"
            # the radon model at half the transitions (cut for the script's time), K4
            # at its default first horizon with few events a transition at 8x, K5,
            # whose launch of 4 gives 71 events, at 4
            k = K if "icar" in name or name.startswith("ecmc") else K // 2
            k = 8 * k if name == "suzz_radon_d89" else k
            err, n_ev, ms = user_compare(what, sampler, B, bitwise, n_chunks=1,
                                         horizon=horizon, K=k)
            if err > 1e-12:
                raise AssertionError(f"{what}: max_abs_err {err:.3e} past 1e-12")
            key = name + ("_horizon" if horizon else "")
            errs[key], plain[key] = err, ms
            texts.append(f"{key} {'bit for bit' if bitwise else f'{err:.3e}'} ({n_ev} events, "
                         f"plain {ms:.1f} ms)")
    print(f"phase 46 parity (f64, B={B}, K={K}, the radon model's {K // 2} but K5's, K4's "
          f"{4 * K}, one launch each; K3/K5 and K4 bit for bit, K1 "
          f"and K6 within 1e-12; every route the kernel): {'; '.join(texts)} "
          f"({time.perf_counter() - t0:.1f} s, {card_name})", flush=True)

    posteriors = {87: radon_posterior(), ICAR[0] ** 2: icar_posterior()}
    out, texts = {}, []
    for path, (sampler, (dp, Bp, n_sk)) in gather_paths().items():
        what = f"phase 46 {path}"
        kind = driver.kernel_kind(sampler)
        x0, v0 = gather_start(sampler, Bp)
        route = api.pick_backend(sampler, "auto", dp, torch.float32, DEV)
        if route != "kernel":
            raise AssertionError(f"{what}: 'auto' takes {route}")
        build.reset_launches()
        engine.reset_counts()
        t1 = time.perf_counter()
        skel = pt.sample_skeleton(sampler, n_sk, x0, v0, seed=0, dtype=torch.float32,
                                  device=DEV)
        sync()
        wall = time.perf_counter() - t1
        launches, chunks = dict(build.LAUNCHES), engine.COUNTS["chunks"]
        name = path_launch(sampler)
        others = {k: n for k, n in launches.items() if n and k not in (name, "compact_rows")}
        if launches[name] < 1 or launches["compact_rows"] < 1 or others or chunks:
            raise AssertionError(f"{what}: the path did not take {name} and K2 alone: "
                                 f"{launches}, {chunks} engine chunks")
        check_complete(what, skel, n_sk)
        events = int(skel.n_valid.sum()) - Bp
        gate = local_level_gate(what, sampler, skel, *posteriors[dp], x0)
        del skel
        ms, b = kernel_chunk(sampler, x0, v0)
        key = f"{path.rsplit('_d', 1)[0]}_d{dp}"
        if key in errs:  # an f64 parity launch on the same kernel, model and d
            err, plain_ms = errs[key], plain[key]
            parity = f"its f64 parity launch {err:.3e}, plain {plain_ms:.1f} ms"
        else:  # the f32 library timed, against its plain version
            _, plain_ms, _, err, parity = user_chunk(what, sampler, x0[:B], v0[:B],
                                                     K3_F32_SHARE, K=K, reps=1, plain_reps=0)
            parity = f"its f32 parity launch (B={B}, K={K}): {parity}"
        out[path] = (launches, ms, plain_ms, b, err)
        low = lower.lower_sampler(sampler, kind, dp, torch.float32, DEV)
        walks = sum(1 for p in low.out for x in lower._nodes(p.e, rows=False)
                    if x.op == "seg")
        texts.append(
            f"{path} ({type(sampler).__name__} d={dp} B={Bp} n_sk={n_sk}; {walks} segment "
            f"walks per coordinate, {len(low.reductions)} sums "
            f"({sum(s != 'c' for s in low.red_space)} over data rows), "
            f"{'moments' if not low.point else 'point context'}, {low.lane_bytes()} B per "
            f"lane, {low.params.numel()} parameters): route {name} {launches[name]} launches, "
            f"K2 {launches['compact_rows']}, 0 engine chunks, {events} events in {wall:.4f} s "
            f"({events / wall:.1f} events/s, one call, the first); {gate}; f32 chunk (K=32) "
            f"{ms:.4f} ms at the deployment's start, bound {bound_text(b)}; {parity}")
    Bl = ICAR[1]
    for kind, sampler in gather_launch_samplers().items():
        x0, v0 = gather_start(sampler, Bl)
        ms, b, (n_ev, n_rej) = kernel_chunk(sampler, x0, v0, events=True)
        key = next(k for k in errs if k.startswith(f"{kind}_icar_d"))
        texts.append(f"{kind}_icar_d{sampler.dim} (no deployment: {type(sampler).__name__} "
                     f"d={sampler.dim} B={Bl}{f', tmax={sampler.tmax}' if kind == 'suzz' else ''}"
                     f"): f32 chunk (K=32) {ms:.4f} ms from exact posterior draws ({n_ev} event "
                     f"rows, {n_rej} rejections in its first launch), bound {bound_text(b)}; its "
                     f"f64 parity launch ({key}) {errs[key]:.3e}, plain {plain[key]:.1f} ms")
        if kind == "suzz":
            stall = gather_stall_sampler()
            _, _, (n_ev, n_rej) = kernel_chunk(stall, x0, v0, reps=1, events=True)
            texts.append(f"the same launch at the default first horizon tmax = {stall.tmax}: "
                         f"{n_ev} event rows, {n_rej} rejections (the speed-up flow's "
                         f"envelope over [0, {stall.tmax}] is far above the rate; not timed)")
    print(f"phase 46 deployments: {'; '.join(texts)} ({card_name})", flush=True)
    return out


RADON_X = (1024, 2048)       # phase 47: chains, points of the radon_x cells
RADON_X_CALLS = 3            # timed warm calls of each cell (after one warm call)
RADON_X_PARITY = (64, 2)     # parity launches: chains, transitions (K4's 12x)
REGRESSION_KINDS = {
    "zigzag": pt.ZigZagAD, "sticky": lambda d, U: pt.StickyZigZagAD(d, U, np.ones(d)),
    "suzz": pt.SpeedUpZigZagAD, "bps": lambda d, U: pt.BPSAD(d, U, refresh_rate=1.0),
    "ecmc": pt.ForwardECMCAD}
"""Phase 47's samplers of K1, K6, K4, K3 and K5 on a target of dimension d."""
BARRIER_MARK = "__syncthreads();  // its rows are read at other indices"
"""The generated K6 barrier after a product whose rows other threads read
(``lower.Lowered._read_barrier``): phase 47's mutant drops it."""


@cache
def regression_paths():
    """Phase 47's timed cells: name -> (sampler, (d, chains, points))."""
    B, n_sk = RADON_X
    U = radon_x(fixed=True)
    return {"zigzag_radon_x_d92": (pt.ZigZagAD(92, U), (92, B, n_sk)),
            "bps_radon_x_d92": (pt.BPSAD(92, U, refresh_rate=1.0), (92, B, n_sk))}


@cache
def regression_launch_samplers():
    """``radon_x`` (d = 94) on K1, K6, K4, K3 and K5, each timed on one f32
    launch (phase 47 runs no deployment of it)."""
    U = radon_x()
    return {kind: make(94, U) for kind, make in REGRESSION_KINDS.items()}


@cache
def regression_parity_samplers():
    """Phase 47's f64 parity launches: (name, sampler, bit for bit) of
    ``radon_x`` (d = 94) and ``radon_x_fixed`` (d = 92) on K1, K6, K4, K3 and
    K5."""
    targets = {"radon_x_d94": (94, radon_x()), "radon_x_fixed_d92": (92, radon_x(fixed=True))}
    return [(f"{kind}_{target}", make(d, U), kind not in ("zigzag", "sticky"))
            for target, (d, U) in targets.items() for kind, make in REGRESSION_KINDS.items()]


def regression_start(sampler, B, seed=47):
    """x0 from B exact draws of ``radon_x_fixed``'s posterior (for ``radon_x``,
    d = 94, its log scales at ``RADON_TRUTH``'s plus N(0, 0.1^2) noise); v0
    = +-1 (a unit normal for the scalar-rate samplers)."""
    d = sampler.dim
    rs = np.random.default_rng(seed)
    mean, cov = radon_x_posterior()
    x0 = mean + rs.normal(size=(B, len(mean))) @ np.linalg.cholesky(cov).T
    if d == len(mean) + 2:
        x0 = np.concatenate([x0, np.log(RADON_TRUTH[3:1:-1]) + 0.1 * rs.normal(size=(B, 2))], 1)
    if driver.kernel_kind(sampler) in k3.KINDS:
        v0 = rs.normal(size=(B, d))
        return x0, v0 / np.linalg.norm(v0, axis=1, keepdims=True)
    return x0, rs.choice([-1.0, 1.0], size=(B, d))


@cache
def regression_barrier():
    """K6 on ``radon_x`` (d = 94) and its generated potential twice, from its
    header with the first warp delayed 20 us before it writes the rows of
    the last product other threads read (``__nanosleep``): with the
    barriers after such products (the control) and without them (the
    mutant).  Returns (the sampler, {name: a copy of its f64 lowering whose
    ``header`` is that text}); ``user_lowerings`` builds them beside the
    early phases."""
    import copy

    sampler = next(s for n, s, _ in regression_parity_samplers() if n == "sticky_radon_x_d94")
    low = lower.lower_sampler(sampler, "zigzag", 94, torch.float64, DEV)
    lines = low.header().split("\n")
    last = max(k for k, line in enumerate(lines) if line.endswith(BARRIER_MARK))
    rows = max(k for k in range(last) if lines[k].startswith("    for (int r = tid; r < "))
    lines.insert(rows, "    if ((threadIdx.x >> 5) == 0) __nanosleep(20000);")
    control = "\n".join(lines)
    mutant = "\n".join(line for line in lines if not line.endswith(BARRIER_MARK))
    out = {}
    for name, text in (("control", control), ("mutant", mutant)):
        out[name] = copy.copy(low)
        out[name].header = lambda text=text: text
        out[name]._lib = None
    return sampler, out


def phase_regression(card_name):
    """Phase 47: hierarchical regressions (coefficient blocks of x against
    data rows; gathers, shifts and scatter-adds of a stage's output) on the
    non-centred radon model with covariate matrices.  First every kernel
    against its plain version in f64 at full size (``RADON_X_PARITY``: 64
    chains, one launch of 2 transitions, K4's of 24; K3/K5 and K4 bit for
    bit, K1 and K6 within rtol 1e-9) on ``radon_x`` (d = 94) and
    ``radon_x_fixed`` (d = 92), each taking its kernel under ``"auto"``;
    then K6 on ``radon_x`` with its first warp delayed before the last
    product's rows, with the barriers behind reads at other rows (must
    match) and without them (must not); then ``zigzag_radon_x_d92`` and
    ``bps_radon_x_d92`` (1024 chains x 2048 points from exact posterior
    draws, one warm call and ``RADON_X_CALLS`` timed ones under ``"auto"``,
    the first of them counted: its kernel and K2 alone, no engine chunk),
    gated on every coordinate's pooled mean and variance against the exact
    posterior (:func:`local_level_gate`), each call's median, launches, an
    f32 launch and its bound; one f32 launch of ``radon_x`` on each kernel.
    Returns {path: (launches, ms, plain ms, bound, err)}."""
    B, K = RADON_X_PARITY
    t0 = time.perf_counter()
    errs, plain, texts = {}, {}, []
    for name, sampler, bitwise in regression_parity_samplers():
        route = api.pick_backend(sampler, "auto", sampler.dim, torch.float64, DEV)
        if route != "kernel":
            raise AssertionError(f"phase 47 {name}: the f64 route is {route}")
        what = f"phase 47 {name}"
        err, n_ev, ms = user_compare(what, sampler, B, bitwise, n_chunks=1,
                                     K=12 * K if name.startswith("suzz") else K)
        if err > 1e-9:
            raise AssertionError(f"{what}: max_abs_err {err:.3e} past 1e-9")
        errs[name], plain[name] = err, ms
        texts.append(f"{name} {'bit for bit' if bitwise else f'{err:.3e}'} ({n_ev} events, "
                     f"plain {ms:.1f} ms)")
    t1 = time.perf_counter()
    sticky, libs = regression_barrier()
    marks = sum(line.endswith(BARRIER_MARK) for line in libs["control"].header().split("\n"))
    for name, mut in libs.items():
        try:
            user_compare(f"phase 47 K6 {name}", sticky, B, False, n_chunks=1, K=K, user=mut)
            failed = None
        except AssertionError as exc:
            failed = str(exc).splitlines()[0][:200]
        if (failed is None) != (name == "control"):
            raise AssertionError(f"phase 47 K6 barrier {name}: "
                                 f"{'failed: ' + failed if failed else 'matched its plain version'}")
        texts.append(f"K6 {name} (the {marks} marked barriers after products read at "
                     f"other rows {'kept' if name == 'control' else 'dropped'}; first warp "
                     f"delayed 20 us): "
                     f"{'matches its plain version' if failed is None else 'fails: ' + failed}")
    print(f"phase 47 parity (f64, B={B}, K={K}, K4 {12 * K}, one launch each; K3/K5 and K4 bit "
          f"for bit, K1 and K6 within rtol 1e-9; every route the kernel): {'; '.join(texts)} "
          f"({t1 - t0:.1f} s parity, {time.perf_counter() - t1:.1f} s barrier; {card_name})",
          flush=True)

    mean, cov = radon_x_posterior()
    out, texts = {}, []
    for path, (sampler, (dp, Bp, n_sk)) in regression_paths().items():
        what = f"phase 47 {path}"
        x0, v0 = regression_start(sampler, Bp)
        route = api.pick_backend(sampler, "auto", dp, torch.float32, DEV)
        if route != "kernel":
            raise AssertionError(f"{what}: 'auto' takes {route}")
        dev = []
        skel, launches, walls = user_call(what, sampler, n_sk, x0, v0, RADON_X_CALLS,
                                          device_ms=dev)
        name = path_launch(sampler)
        events = int(skel.n_valid.sum()) - Bp
        gate = local_level_gate(what, sampler, skel, mean, cov, x0)
        del skel
        ms, b = kernel_chunk(sampler, x0, v0)
        med = int(np.argsort(walls)[len(walls) // 2])
        wall, kern = walls[med], dev[med] / 1e3
        key = f"{path.split('_')[0]}_radon_x_fixed_d92"
        out[path] = (launches, ms, plain[key], b, errs[key])
        low = lower.lower_sampler(sampler, driver.kernel_kind(sampler), dp, torch.float32, DEV)
        texts.append(
            f"{path} ({type(sampler).__name__} d={dp} B={Bp} n_sk={n_sk}; {len(low.trans)} "
            f"products per transition, {len(low.slot)} in slots, {len(low.reductions)} sums, "
            f"{low.lane_bytes()} B per lane, {low.params.numel()} parameters): route {name} "
            f"{launches[name]} launches a call, K2 {launches['compact_rows']}, 0 engine chunks, "
            f"{events} events; calls {', '.join(f'{w:.4f}' for w in walls)} s, median {wall:.4f} "
            f"s ({events / wall:.1f} events/s); split of the median call: {name} "
            f"{launches[name]} launches {kern:.4f} s by CUDA events around each "
            f"({kern / launches[name] * 1e3:.4f} ms a launch, {kern / wall:.1%}), the rest "
            f"{wall - kern:.4f} s; {gate}; f32 chunk (K=32) alone {ms:.4f} ms at the "
            f"deployment's start, bound {bound_text(b)}; its "
            f"f64 parity launch ({key}) {errs[key]:.3e}, plain {plain[key]:.1f} ms")
    Bl = RADON_X[0]
    for kind, sampler in regression_launch_samplers().items():
        x0, v0 = regression_start(sampler, Bl)
        low = lower.lower_sampler(sampler, "zigzag" if kind == "sticky" else kind, 94,
                                  torch.float32, DEV)
        route = api.pick_backend(sampler, "auto", 94, torch.float32, DEV)
        if route != "kernel":
            raise AssertionError(f"phase 47 {kind}_radon_x_d94: 'auto' takes {route} "
                                 f"({low.lane_bytes()} B per lane)")
        ms, b, (n_ev, n_rej) = kernel_chunk(sampler, x0, v0, events=True)
        key = f"{kind}_radon_x_d94"
        context = (f"{low.shared_values()} values in shared memory" if kind == "sticky"
                   else f"{low.lane_bytes()} B per lane")
        texts.append(f"{key} (no deployment: {type(sampler).__name__} d=94 B={Bl}, "
                     f"{context}): f32 chunk (K=32) {ms:.4f} ms from near "
                     f"the posterior ({n_ev} event rows, {n_rej} rejections in its first "
                     f"launch), bound {bound_text(b)}; its f64 parity launch {errs[key]:.3e}, "
                     f"plain {plain[key]:.1f} ms")
    print(f"phase 47 deployments: {'; '.join(texts)} ({card_name})", flush=True)
    return out

def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, b, plain_of=None):
    """One entry of the kernels line; ``plain_of`` says which launch
    ``plain_ms`` timed where it is not the launch ``ms`` timed."""
    entry = {"name": name, "route": "cuda", "source": f"pdmpflux_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
             # no single PyTorch call computes a chunk of PDMP transitions or a
             # per-chain stable compaction with offsets (see PERF.md)
             "library_ms": None}
    if plain_of is not None:
        entry["plain_of"] = plain_of
    return entry


def main():
    card_name = card()
    t_start = time.perf_counter()

    def at(phase):
        """The script's clock after a phase, for its time budget."""
        print(f"[after phase {phase}: {time.perf_counter() - t_start:.1f} s]", flush=True)

    builds = UserBuilds()  # phases 36-47's libraries, lowered and built beside 1-35
    try:
        phase_build()
        at(1)
        builds.wait_lowered()
        run_phases(card_name, at, builds)
    finally:
        builds.close()


def run_phases(card_name, at, builds):
    """Phases 2-47 and the kernels line."""
    k1_err = phase_k1()
    k2_err = phase_k2()
    at(3)
    sampler, launches = phase_main(card_name)
    (k1_ms, k1_plain_ms, k2_ms, k2_plain_ms, k2_main_err, k1_b,
     k2_b) = phase_breakdown(sampler)
    phase_large_d()
    at(5)
    k6_err = phase_k6()
    sticky, sticky_launches, sticky_wall = phase_sticky(card_name)
    k6_ms, k6_plain_ms, _, _, k2_sticky_err, k6_b = phase_sticky_breakdown(
        sticky, sticky_launches["sticky_chunk"], sticky_wall)
    phase_sticky_law()
    at(8)
    k35_err = phase_k3()
    bps, bps_launches, bps_wall = phase_bps(card_name)
    k3_ms, k3_plain_ms, k3_b, k2_bps_err, k3_bps_f32_err = phase_bps_breakdown(
        bps, bps_launches["bps_chunk"], bps_wall)
    k3_boomerang_f32_err = phase_boomerang(card_name)
    ecmc_launches, k5_ms, k5_plain_ms, k5_b, k5_f32_err = phase_ecmc(card_name)
    at(12)
    k7_errs = phase_k7()
    hz, hz_launches, hz_wall = phase_horizon(card_name)
    k7_ms, k7_plain_ms, k7_b, k2_hz_err, k7_f32_err = phase_horizon_breakdown(
        hz, hz_launches, hz_wall)
    checks = phase_horizon_checks(card_name)
    at(15)
    k4_errs = phase_k4()
    suzz, suzz_launches, suzz_wall, suzz_T = phase_suzz(card_name)
    k4_ms, k4_plain_ms, k4_b, k2_suzz_err, k4_f32_err = phase_suzz_breakdown(
        suzz, suzz_launches, suzz_wall)
    k4h_n, k4h_ms, k4h_plain_ms, k4h_b = phase_suzz_horizon(card_name, suzz, suzz_T)
    at(18)
    k6s_n, k6s_ms, k6s_plain_ms, k6s_err, k6s_b, rate = phase_stream_sticky(card_name)
    k1s_n, k1s_ms, k1s_plain_ms, k1s_err, k1s_b, banana = phase_stream_banana(card_name)
    at(20)
    phase_checkpoints(card_name, rate)
    at(21)
    phase_engine_agreement()
    k2_paths = {"rhmc_gauss_d10": phase_rhmc(card_name)}
    for tderiv in ("fd", "jvp"):
        k2_paths[f"zigzag_banana_d10_{tderiv}"] = phase_banana_engine(card_name, tderiv)
    phase_routing(card_name)
    at(25)
    k2_paths["host:sticky_zigzag_d1000"] = phase_host_sticky(card_name, sticky, k6_ms)
    k2_paths["host:zigzag_gauss_d10_horizon"] = phase_host_horizon(card_name, hz, k7_ms)
    k1_sharded = phase_sharded(card_name, k1_ms, k2_ms)
    phase_stream_mesh(card_name, banana)
    at(29)
    traced, traced_launches = phase_profiled(card_name, sampler)
    phase_plots(card_name, sampler, traced)
    del traced
    k2_paths["gspmd:zigzag_d10000"], gspmd_finish = phase_gspmd(card_name)
    at(32)
    try:
        tag_errs = phase_tags()
    except BaseException:
        gspmd_finish(failed=True)
        raise
    gspmd_finish()
    at("33 and 32b")
    cauchy_launches, cauchy = phase_suzz_cauchy(card_name)
    at(34)
    neal_launches, neal, k2_paths[f"engine:zigzag_neal_funnel_d10_n{NEAL_ROUTES}"], \
        neal_x0 = phase_neal_funnel(card_name)
    at(35)
    user = phase_user_main(card_name, builds.result())
    at(36)
    user.update(phase_user_kernels(card_name))
    at(37)
    reductions, neal_user = phase_user_reductions(card_name, neal_x0)
    user.update(reductions)
    at(38)
    user.update(phase_dense_corr(card_name))
    at(39)
    user.update(phase_dense_logistic(card_name))
    at(40)
    parity = phase_dense_parity(card_name)
    user.update(parity)
    at(41)
    dense_k6 = parity["sticky_dense_ar1_d1000"]
    user.update(phase_band(card_name, (dense_k6[1], dense_k6[3]), neal_user))
    at(42)
    user.update(phase_transition_products(card_name))
    at(43)
    user.update(phase_lse(card_name))
    at(44)
    user.update(phase_scan(card_name))
    at(45)
    user.update(phase_gather(card_name))
    at(46)
    user.update(phase_regression(card_name))
    at(47)
    zz = "pdmpflux_tpu/ops/pallas/zigzag_chunk.py:854"
    k7 = 'pdmpflux_tpu/ops/pallas/zigzag_chunk.py:343 mode="horizon"'
    kernels = [
        kernel_entry("zigzag_chunk", "zigzag_chunk.cu", zz, launches["zigzag_chunk"],
                     max(k1_err, tag_errs["zigzag_chunk"]), k1_ms, k1_plain_ms, k1_b),
        kernel_entry("compact_rows", "compact.cu", "pdmpflux_tpu/ops/pallas/compact.py:132",
                     launches["compact_rows"],
                     max(k2_err, k2_main_err, k2_sticky_err, k2_bps_err, k2_hz_err,
                         k2_suzz_err),
                     k2_ms, k2_plain_ms, k2_b),
        kernel_entry("sticky_chunk", "sticky_chunk.cu", zz, sticky_launches["sticky_chunk"],
                     max(k6_err, tag_errs["sticky_chunk"]), k6_ms, k6_plain_ms, k6_b),
        kernel_entry("bps_chunk", "scalar_chunk.cu", zz + ' kind="bps"/"boomerang"',
                     bps_launches["bps_chunk"],
                     max(k35_err["bps_chunk"], k3_bps_f32_err, k3_boomerang_f32_err,
                         tag_errs["bps_chunk"]),
                     k3_ms, k3_plain_ms, k3_b),
        kernel_entry("ecmc_chunk", "scalar_chunk.cu", zz + ' kind="ecmc"',
                     ecmc_launches["ecmc_chunk"],
                     max(k35_err["ecmc_chunk"], k5_f32_err, tag_errs["ecmc_chunk"]),
                     k5_ms, k5_plain_ms, k5_b),
        kernel_entry("zigzag_chunk_horizon", "zigzag_chunk.cu", k7,
                     hz_launches["zigzag_chunk_horizon"],
                     max(k7_errs["zigzag_chunk_horizon"], k7_f32_err,
                         tag_errs["zigzag_chunk_horizon"]), k7_ms, k7_plain_ms, k7_b),
    ]
    for name, source in (("sticky_chunk_horizon", "sticky_chunk.cu"),
                         ("bps_chunk_horizon", "scalar_chunk.cu"),
                         ("ecmc_chunk_horizon", "scalar_chunk.cu")):
        n, ms, plain_ms, b = checks[name]
        kernels.append(kernel_entry(name, source, k7, n, max(k7_errs[name], tag_errs[name]),
                                    ms, plain_ms, b))
    kernels += [
        kernel_entry("suzz_chunk", "suzz_chunk.cu", zz + ' kind="suzz"',
                     suzz_launches["suzz_chunk"],
                     max(k4_errs["suzz_chunk"], k4_f32_err, tag_errs["suzz_chunk"]),
                     k4_ms, k4_plain_ms, k4_b),
        kernel_entry("suzz_chunk_horizon", "suzz_chunk.cu", k7, k4h_n,
                     max(k4_errs["suzz_chunk_horizon"], tag_errs["suzz_chunk_horizon"]),
                     k4h_ms, k4h_plain_ms, k4h_b),
        # the streaming paths' launches, each timed inside its run
        kernel_entry("sticky_chunk_horizon[sticky_zigzag_d1000_streaming]", "sticky_chunk.cu",
                     k7, k6s_n, max(k7_errs["sticky_chunk_horizon"], k6s_err), k6s_ms,
                     k6s_plain_ms, k6s_b),
        kernel_entry("zigzag_chunk_horizon[zigzag_banana_d50_streaming]", "zigzag_chunk.cu",
                     k7, k1s_n, max(k7_errs["zigzag_chunk_horizon"], k1s_err), k1s_ms,
                     k1s_plain_ms, k1s_b),
    ]
    kernels.append(kernel_entry("zigzag_chunk[sharded_flagship]", "zigzag_chunk.cu", zz,
                                k1_sharded, k1_err, k1_ms, k1_plain_ms, k1_b))
    # the profiled flagship's launches (phase 30), timed at its shapes in phase 4b
    kernels += [
        kernel_entry("zigzag_chunk[profiled_flagship]", "zigzag_chunk.cu", zz,
                     traced_launches["zigzag_chunk"], k1_err, k1_ms, k1_plain_ms, k1_b),
        kernel_entry("compact_rows[profiled_flagship]", "compact.cu",
                     "pdmpflux_tpu/ops/pallas/compact.py:132", traced_launches["compact_rows"],
                     max(k2_err, k2_main_err), k2_ms, k2_plain_ms, k2_b),
    ]
    # the two deployments of the new device tags (phases 34, 35), each kernel
    # timed at its shape and checked there in f32 and in phase 33 in f64
    for path, deploy, (name, source, replaces) in (
            ("suzz_cauchy_d10", (cauchy_launches, cauchy),
             ("suzz_chunk", "suzz_chunk.cu", zz + ' kind="suzz"')),
            ("zigzag_neal_funnel_d10", (neal_launches, neal),
             ("zigzag_chunk", "zigzag_chunk.cu", zz))):
        n, (ms, plain_ms, b, k2e, k2ms, k2pms, k2b, f32e, _) = deploy
        kernels += [
            kernel_entry(f"{name}[{path}]", source, replaces, n[name],
                         max(tag_errs[name], f32e), ms, plain_ms, b),
            kernel_entry(f"compact_rows[{path}]", "compact.cu",
                         "pdmpflux_tpu/ops/pallas/compact.py:132", n["compact_rows"], k2e,
                         k2ms, k2pms, k2b)]
    # the generated potentials' paths (phases 36-43), each kernel timed at its
    # shape and checked there in f32 and, in phases 37-43, against its plain
    # version in f64; their K2 launches compact fills of the flagship's shapes
    # (phase 4b's K2 numbers) or of their own deployments' shapes
    sources = {"zigzag_chunk": ("zigzag_chunk.cu", zz), "sticky_chunk": ("sticky_chunk.cu", zz),
               "bps_chunk": ("scalar_chunk.cu", zz + ' kind="bps"/"boomerang"'),
               "ecmc_chunk": ("scalar_chunk.cu", zz + ' kind="ecmc"'),
               "suzz_chunk": ("suzz_chunk.cu", zz + ' kind="suzz"')}
    # phases 39-43 time the kernel on an f32 launch from the deployment's
    # start and the plain version on the f64 parity launch from a random state
    dense = set(dense_paths()) | set(band_paths()) | set(dense_ar1_paths()) | set(lse_paths())
    scan = set(scan_paths())
    for path, (n, ms, plain_ms, b, err) in user.items():
        name = next(k for k in sources if n.get(k))
        plain_of = ("the f64 parity launch from a random state; ms: an f32 launch from the "
                    "deployment's start" if path in dense else None)
        if path in scan:
            plain_of = (f"the f64 parity launch (B={LSE_PARITY[0]}, K={LSE_PARITY[1]}) from a "
                        "random state on the same kernel, target and d; ms: an f32 launch "
                        "from the deployment's start")
        if path in gather_paths():
            plain_of = (GATHER_PLAIN_OF[path].format(B=LSE_PARITY[0], K=LSE_PARITY[1])
                        + "; ms: an f32 launch from the deployment's start")
        if path in regression_paths():
            B, K = RADON_X_PARITY
            plain_of = (f"the f64 parity launch (B={B}, K={K}) from a random state on the same "
                        "kernel, model and d; ms: an f32 launch from the deployment's start")
        kernels.append(kernel_entry(
            f"{name}[user:{path}]", *sources[name], n[name], err, ms, plain_ms, b, plain_of))
        if path in ("bench_zigzag_d10", "readme_zigzag_ad_d10"):
            kernels.append(kernel_entry(f"compact_rows[user:{path}]", "compact.cu",
                                        "pdmpflux_tpu/ops/pallas/compact.py:132",
                                        n["compact_rows"], max(k2_err, k2_main_err), k2_ms,
                                        k2_plain_ms, k2_b))
    # the engine and host paths' K2 launches, each checked and timed on its own fill
    for path, (n, err, ms, plain_ms, b) in k2_paths.items():
        kernels.append(kernel_entry(f"compact_rows[{path}]", "compact.cu",
                                    "pdmpflux_tpu/ops/pallas/compact.py:132", n, err, ms,
                                    plain_ms, b))
    print(json.dumps({"kernels": kernels}))
    print(card_name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--gspmd-worker"]:
        gspmd_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
