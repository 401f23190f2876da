#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--only dense|tiles|tables|hash|grid|gridviews|window|split|sched|general|posed|parallel|close|soak|fit]

Drives the port's main paths once each, at the headline configurations:
the dense-grid tiled render at 512^2 rays over a 64^3 Gaussian-blob grid
with 128 stratified steps (seed 3; the scene ``bench.py::_scene`` builds,
rebuilt here in numpy) through ``Renderer.forward``, its gradients
through ``Renderer.backward``, and a few SGD training steps through
autograd of ``render_tiled``; the same grid with bfloat16 and float16
packed tables and as sparse bricks (float32 and bfloat16); then the
hash-MLP field (the L=8, T=128
spec of ``tools/hashmlp_bench.py``) rendered at 512^2 with 128
stratified steps (seed 5) through ``Renderer.forward`` and fitted with
``fit_hash_mlp`` (4 views at 96^2, 64 steps, Adam lr 8e-3); then the
NGP-scale hash grid path (``tools/hashmlp_bench.py``'s grid spec: L=4,
F=2, T=4096, resolutions 4-8-16-32) at 512^2 with 128 stratified steps
(seed 5) through ``render_hash_grid_tiled`` and 10 Adam steps through its
autograd; then the sub-tiled and supercell schedules of the cascade:
``tools/finegrid_bench.py``'s fine-grid scene (512^2 over a 128^3 blob,
256 stratified steps, seed 3) in float32 and bfloat16, and the eight
views of ``tools/fit_benchmark.py``'s fit flagship (96^2 over 64^3, 96
steps); then the grid path over those eight views (the grid spec at
finest 32 and at finest 64, the cascade's 8 and 4 px sub-tiles),
``fit_dense_grid`` at the flagship on the views' merged schedule, then
the windowed path with the per-ray integrator K9f / K9b: the dense
headline through ``Renderer(use_window=True)``, the fine grid at 16 px
cells with its windowed fallback, and ``fit_dense_grid``'s windowed and
plain modes at the flagship; and last the split tiled backward
(``DVREN_BWD_SPLIT=pallas``: K2's bank-block form and K6) on the dense
stack, the sparse float32 field and ``fit_dense_grid``. Phases, each fatal
when it fails:

1. print the card's name and power limit; build the CUDA kernels from
   ``dvren_tpu_torch/csrc`` and print the build time;
2. K3 (packed-table build) against its plain twin at 64^3: bit-exact,
   as 32-bit words;
3. build the headline schedule (no overflow rays allowed);
4. K1 (fused tile forward), one launch over every tile group, against
   its plain twin run group by group: bit for bit;
5. ``Renderer(Context.create(device="cuda"), plan).forward(field)``: the
   kernels' launch counts rise, the planes are finite with opacity > 0
   somewhere and match the plain path on the card; the small test scene
   rendered on the card matches the plain path on the CPU;
6. times, with CUDA events, after warm-up: the forward per frame (the
   schedule excluded) and its stages, and each kernel beside its plain
   twin; K3 also on the device alone (``device_ms``: the stream sleeps
   while the host queues the calls) beside its time as issued;
7. K2 (fused tile backward), one launch over every tile group, against
   its plain twin run group by group, with and without the camera
   adjoint, for a seeded random cotangent: bit for bit, two runs too; its
   distance from the twin summing in float64 printed;
8. K4 (table-gradient unpack) against its plain twin at 64^3: bit-exact;
   timed in phase 10 on the device alone and as issued;
9. ``Renderer.backward`` under ``torch.use_deterministic_algorithms``:
   finite, nonzero grid and camera gradients, within tolerance of the
   plain path on the card, two calls equal bit for bit; the small test
   scene's backward on the card matches the CPU's;
10. four SGD steps (MSE against a zero target, as ``bench.py`` trains)
    through autograd of ``render_tiled``, at bench's lr 1e-3 and at that
    lr times the image's 512*512*3 values (at 1e-3 the updates are below
    float32 resolution): the loss is finite and falls at the scaled lr,
    K1-K4 each launch once in every step; then the step time (forward,
    backward, update) at lr 1e-3 over 10 steps with CUDA events, its
    stages beside their plain twins, and peak device memory;
11. K7f (fused hash-MLP forward) against its plain twin at the hash
    headline, the field from a seeded ``torch.Generator``: within 5e-6
    after ``finalize_heads`` (depth 1e-4); the hash schedule's build and
    upload times; K7f's and K7b's registers, shared memory per block,
    local memory and blocks per SM (the CUDA runtime's occupancy query;
    K7b also its warps per block); the samples K7 processes (each ray's
    steps before its stop, from the plain twin's recurrence: the count
    K7's bounds use);
12. ``Renderer(Context.create(device="cuda"), plan).forward(hash_field)``:
    the K7f launch count rises, the planes are finite with opacity > 0
    somewhere and match the plain path on the card; the small hash test
    scene (24x20) rendered on the card matches the CPU twin;
13. K7b (fused hash-MLP backward) against its plain twin for a seeded
    random cotangent on a subset of the headline's tiles: d(table) and
    d(MLP) within 2e-5 x scale; two runs on the full frame equal bit for
    bit;
14. ``fit_hash_mlp`` for 25 Adam steps (``sync_every=25``) toward a
    teacher field of the same spec rendered by the port from the same
    cameras: the loss is finite and falls, K7f and K7b recorded once each
    in the step's CUDA graph (their counters moved by its warm-up and
    recording only: the replays launch through no wrapper),
    ``steady_step_ms`` > 0; then K7f and K7b against their twins at
    the fit's shapes (its four-view stack schedule, a seeded random
    cotangent), for the fitted student and for the teacher made opaque
    (sigma_b2 + 5), on which some rays must stop early: K7f within 5e-6
    after ``finalize_heads`` (depth 1e-4), K7b within 2e-5 x scale; at
    each, K7f's and K7b's times and bounds by processed samples;
15. times with CUDA events after warm-up, each beside its plain twin's:
    the hash forward per frame and Mrays/s (schedule excluded), K7f, K7b,
    the fit step (forward, backward, Adam), and the peak device memory
    each adds to what the earlier phases hold; the occupancy again;
16. the grid headline schedule (16 px tiles, 0 overflow rays, 8 groups;
    its build and upload times), K8f's and K8b's registers, shared memory
    per block, local memory and blocks per SM (the CUDA runtime's
    occupancy query; also at enc 64 / hidden 8, the widest spec
    ``grid_path_ok`` admits), and K8f (fused hash-grid forward) in one
    launch over every group against its plain twin run group by group:
    within 5e-6 after ``finalize_heads`` (depth 1e-4) and bit for bit;
17. ``render_hash_grid_tiled`` on the card against the plain path on the
    card: K8f launches once over the schedule's groups, the planes are
    finite with opacity > 0 somewhere; the small grid test scene
    (tests/test_hash_grid.py's 32^2 / 16 steps, L=3 / T=4096) on the card
    matches the CPU twin;
18. K8b (fused hash-grid backward) in one launch against its plain twin
    for a seeded random cotangent on every tile of the headline: slot rows
    and d(MLP) within 2e-5 x scale, a repeat equal bit for bit; under
    ``torch.use_deterministic_algorithms`` two full-frame backwards
    through autograd equal bit for bit, d(hash_table) included;
19. 10 Adam steps (lr 8e-3) through autograd of ``render_hash_grid_tiled``
    toward a teacher of the same spec (``torch.Generator`` seed 2, table
    std 1.0) rendered by the port: the loss is finite and falls, K8f and
    K8b launch once in every step (printed);
20. times with CUDA events after warm-up, each beside its plain twin's
    where there is one: the grid forward per frame and Mrays/s (schedule
    excluded), the table build, the bank gather, K8f, K8b, the slot
    reduction, the table adjoint, the training step, and the peak device
    memory each adds;
21. K5a (16-bit packed-table build) against its plain twin at 64^3, for
    bfloat16 and float16: bit-exact;
22. ``Renderer.forward`` on the headline field with
    ``packed_dtype="bfloat16"`` and ``"float16"`` (the schedule, keyed by
    the dtype, rebuilt: the headline's 16 px cells): K5a launches once
    and K3 not, K1 once;
    the planes match the plain path on the card within 5e-6 (depth 1e-4)
    and the float32 frame within 5e-3;
23. K5b (16-bit table-gradient unpack) against its plain twin on the
    headline's table gradient (phase 7's K2 rows through the 16-bit
    reduction): bit-exact;
24. ``Renderer.backward`` on both 16-bit fields under
    ``torch.use_deterministic_algorithms``: K2, K5a and K5b once;
    finite, nonzero, two calls equal bit for bit, within c * ulp x scale
    of the plain path (c the largest slot class);
25. four SGD steps on the bfloat16 field at lr 1e-3 x 512*512*3: K1, K2,
    K5a and K5b launch once every step, K3 and K4 never; the loss falls;
26. ``SparseGridField.from_dense(headline, threshold=0)`` in float32 and
    bfloat16 (all 512 bricks kept) through ``Renderer.forward``: K1 alone,
    the frame equal to the dense frame of the same type; ``.backward``
    deterministic and repeat-equal, within 2e-6 (float32) or c * ulp x
    scale (bfloat16) of the plain path; four SGD steps on the float32
    bricks (K1 and K2 alone; the loss falls);
27. times with CUDA events: the 16-bit and sparse frames and steps beside
    their plain paths, K5a and K5b (on the device alone, and as issued)
    beside their twins and the one PyTorch call that computes the TPU
    kernel's function (a transpose:
    ``stack.t().contiguous()`` of the (32, R) 16-bit stack,
    ``rows.t().contiguous()`` of the (R, 32) float32 rows), and the peak
    device memory each adds;
28. the fine-grid scene through ``Renderer.forward``'s cascade (16 px
    supercells, 0 overflow rays): K1 once and no table kernel;
    the frame against the plain path on the card; the schedule's form,
    groups, banks, live samples and build time;
29. K1 and K2 in that form against their twins on the first 8 tiles of
    every group: bit for bit, repeats too; two deterministic
    ``Renderer.backward`` calls equal; four SGD steps at lr 1e-3 x
    786,432 (the loss falls, K2 once each step); the frame, the step,
    K1 and K2 beside their twins (CUDA events; the twins once);
30. the same with ``packed_dtype="bfloat16"`` (8 px cells): K5a once a
    frame, K5a and K5b once a backward and a step; then K5a and K5b at
    128^3 (the field, a seeded table gradient) against their twins as
    16-bit / 32-bit words, each timed on the device alone and as issued
    beside its twin and its transpose;
31. the fit flagship's eight views, each through the cascade (8 px
    supercells): K1 and K2, one launch per view, against their twins on
    every group, bit for bit;
32. 10 Adam steps (lr 5e-2, the flagship's) from a flat student on the
    summed loss of the eight views (the loss falls); view 0's grid and
    camera gradients against the plain path, two runs equal; times;
33. view 0 at 4 px (0 overflow rays): frame and backward against the
    plain path, the frame equal to the 8 px supercell frame bit for bit,
    two deterministic backwards equal, K1 and K2 against their twins on
    every group, times;
34. the grid spec of ``tools/hashmlp_bench.py`` (finest 32) over the
    flagship's eight 96^2 views, each through ``build_hash_grid_schedule``'s
    cascade (8 px, 0 overflow rays; groups, banks and build times
    printed; the kernels' registers, shared memory and blocks per SM):
    K8f at subs 4, one launch per view over all its groups, equal to its
    twin bit for bit on every group, K8b within 2e-5 x scale on every tile
    and repeat-equal (each twin run once, timed); view 0's
    ``render_hash_grid_tiled`` against the plain path; 10 Adam steps (lr
    8e-3) on the summed loss of the views toward a teacher
    (``torch.Generator`` seed 2, table std 1.0): the loss falls, K8f and
    K8b launch once per view in every step (printed); times with CUDA
    events;
35. the same at finest 64 (resolutions 8-16-32-64): 4 px, K8 at subs 16,
    at most 77 banks per tile (the gathered tables' size printed first);
36. ``fit_dense_grid`` at the fit flagship (``tools/fit_benchmark.py``'s
    scene and cameras, Adam lr 5e-2, target PSNR 35, ``sync_every=32``,
    at most 300 steps), toward phase 31's per-view frames: the auto mode
    keeps "tiled", the views merge into one 8 px supercell group (its
    shape printed), the stack equals the per-view frames within 5e-6, K1
    and K2 equal their twins on the group's first 8 tiles and are recorded
    once each in the fit's step graph (counters moved by its warm-up and
    recording only); the steps to PSNR 35, ``schedule_build_s``,
    ``first_step_s``, ``steady_step_ms``, ``wall_clock_s``, and the
    replayed Adam step with CUDA events beside phase 32's (each view its
    own schedule);
37. K9f and K9b against their twins on every group of the dense
    headline's windowed schedule (a seeded cotangent), and on the same
    lattice with sigma x 10, whose rays stop early (their count printed,
    > 0): tests/test_pallas_parity.py's bounds, repeats bit for bit;
    their times on the device alone and as issued beside the twins',
    their bounds and waves (every K9 shape below reports the same);
38. ``Renderer(Context.create(device="cuda"), plan,
    RenderOptions(use_window=True))`` on the dense headline: K9f once
    per group; the planes finite, within 5e-6 (depth 1e-4) of the plain
    path on the card and within 1e-5 of the tiled frame (depth over
    every ray within 1e-4 + 4 ulps x t_far / opacity: depth = wd /
    opacity, see ``depth_error``);
    ``Renderer.backward`` under ``torch.use_deterministic_algorithms``:
    K9b once per group, grid and camera gradients finite and nonzero, two
    calls bit for bit; the frame and the backward timed; then the packed
    evaluation's kernels (``csrc/packed_eval.cu``) on the headline's
    first windowed group (32,768 rays x its budget over the 63^3 float32
    stencil: ``blob64.fit4x512w``'s group and table), a seeded cotangent
    masked as ``eval_fields`` masks it: the forward's planes, the table's
    and the positions' cotangents within 1e-6 x scale (the positions'
    2e-6) of ``eval_packed_trilinear(use_kernel=False)``'s, a repeat
    backward bit for bit, one launch each (``graph.launch_counts``); the
    device ms of each beside the twin's and a byte bound;
39. the fine grid (512^2 over 128^3, 256 steps) at 16 px cells: its
    fallback count equal to JAX's builder's (151,552 of 262,144 rays);
    ``render_tiled`` with K1 once and K9f once per
    fallback group, within 1e-5 (depth as in 38) of the 16 px supercell
    frame (phase 28's form); its autograd backward (K2 and K9b launch) twice,
    bit for bit; four SGD steps at lr 1e-3 x 786,432 (the loss falls);
    times and peak device memory; K9f / K9b on the fallback groups
    against their twins; K3 and K4 at 128^3 (the fine grid's
    field, a seeded table gradient) against their twins as 32-bit words,
    each timed on the device alone and as issued beside its twin;
40. ``fit_dense_grid(mode="windowed")`` at the flagship (phase 36's
    scene, targets, rate and cap): K9f and K9b recorded once per stack
    group and the packed evaluation once per evaluation in the step's
    graph (every kernel counter, ``graph.launch_counts``, moved by its
    warm-up and recording only), the loss falls; steps to PSNR 35,
    ``schedule_build_s``, ``steady_step_ms``, ``wall_clock_s``, the eager
    step's kernels under ``torch.profiler``; then ``mode="plain"`` for 10
    steps (K9 and the packed evaluation recorded once per view, every
    counter moved by the warm-up and recording only; the loss falls);
    K9f / K9b on
    view 0's 9,216 x 96 lattice against their twins, in this process;
41. K1 and K2 in their supercell, subs 16 form on the flagship's view 0
    (4 px, ``cell_scale=2``): one frame and backward (one launch each),
    the twins bit for bit on the first 8 tiles of every group, times
    beside the twins' and the bounds;
42. K6 (bank blocks -> slot rows) against its twin, as 32-bit words, on
    the dense headline's 14 groups (K2's bank-form cotangents of a seeded
    random ``gs``, one launch) and on blocks holding -0.0, subnormals,
    +-inf and NaN payloads; its time beside the twin's,
    ``banks.transpose(1, 2).contiguous()`` (``library_ms``) and its
    bound;
43. K2's bank form against its rows form, transposed, and its repeat, bit
    for bit, and within 2e-6 x scale of its twin's bank form, one launch
    over every group: at subs 1 (the headline), subs 4 (the flagship's
    eight views at 8 px cells, merged; groups and fallback rays printed)
    and subs 16
    (view 0 at 4 px cells, a one-view merge), with one backward of
    ``render_tiled_stack`` under "pallas" at subs 4 and 16 (K2 and K6
    once); times beside the rows form's;
44. the dense headline as a one-view ``merge_view_schedules`` through
    ``render_tiled_stack``: four SGD steps at lr 1e-3 x 786,432 under
    "xla" and under "pallas", the losses and d_sigma / d_color equal bit
    for bit at every step, K6 once per step under "pallas" and never
    under "xla", the loss falling; the step timed under both (xla,
    pallas, pallas, xla);
45. in a child process started with ``DVREN_BWD_SPLIT=pallas`` (the flag
    read at import; a failing child fails the script):
    ``SparseGridField.from_dense(headline, threshold=0)`` in float32
    through ``Renderer.backward`` under ``torch.use_deterministic_
    algorithms`` with both values of the flag, the gradients equal bit
    for bit between the routes and between calls, K6 once under
    "pallas"; four SGD steps on the bricks under "pallas" (the loss
    falls); the step timed under both;
46. ``fit_dense_grid(mode="tiled")`` on two 512^2 views of the headline
    (its camera, and that camera moved +0.05 in x) toward the headline
    field's frames rendered by the port, from a flat student (0.5), Adam
    lr 5e-2, 8 steps, ``sync_every=4``, once per value of the flag: the
    cascade keeps 16 px cells (else the phase fails: K6 would be off the
    path), the loss histories and final parameters equal bit for bit, K6
    recorded once in the step graph under "pallas";
    ``schedule_build_s`` and ``steady_step_ms`` of each.

``--only dense`` runs phases 1-10, ``--only tiles`` phases 1-10, 28-33,
36, 41 and 42-46 (every phase that times K1 / K2, in every form),
``--only tables`` phases 1-10, 21-27 and 28-30 (every phase that runs
K5a / K5b),
``--only hash`` phases 1 and 11-15 (K7f and K7b), ``--only grid`` phases
1 and 16-20,
``--only gridviews`` phases 1 and 34-35, ``--only window`` phases 1 and
37-41, ``--only split`` phases 1 and 42-46, ``--only sched`` phases 1 and
47-51, ``--only general`` phases 1 and 52-57, ``--only parallel`` phases
1 and 62-64, ``--only close`` phases 1 and 65-69, ``--only fit`` phases 1
and 73: each alone, to time two trees against each other in one call.

Phases 47-51 drive every option of the tile schedule builder and
the modules that wait on them: the native scheduler core against the
numpy builder (schedule digests equal, the build seconds of each) on the
dense headline at 16 / 8 / 4 px, the fine grid's cascade and
``tools/sparse_bench.py``'s 512^3 SDF shell with occupancy at 8 px;
pitch 2 at the dense headline through ``RenderOptions(tile_pitch=2)``
(frames, backwards and an SGD step bit-equal to pitch 1, float32 and
bfloat16; K1 / K2 bit-equal to their twins on its schedule; the bank
gather at both pitches); the shell through ``use_occupancy`` (its frame
within 5e-6 of the untrimmed one, its backward, K1 / K2 against their
twins on the trimmed schedule and its pitch-2 form); six orbit poses
through ``MovingCameraRenderer`` bit-equal to each pose's own schedule,
with one schedule structure; and 4 + 4 Adam steps around
``save_train_state`` / ``load_train_state`` bit-equal to 8.

Phases 52-57 (last) drive the Renderer's general paths over the per-ray
integrator K9f / K9b, each fatal when it fails:

52. the dense headline through ``RenderOptions(use_tiles=False)``: the
    streamed mode, K9f once per block of 32,768 rays (8); the frame
    within 5e-6 of ``use_kernel=False`` on the card (depth 1e-4) and of
    the tiled frame (depth by phase 38's per-ray bound), the backward
    (two calls under ``torch.use_deterministic_algorithms``, bit-equal)
    within 2e-6 x scale of the tiled backward, camera rtol 2e-3 / atol
    1e-4, K9b launched; K9f / K9b against their twins on the 8 blocks;
    a ``torch.profiler`` breakdown of the streamed step;
53. the same with ``streaming=False`` (fused) and ``use_fused_path=
    False`` (staged): frames bit-equal to each other and within 5e-6 of
    phase 52's, the staged stage times positive, K9f once; the backward
    (``per_sample_grads``, one K9b launch, ``accumulate_sample_
    gradients``, ``camera_grads``) within 2e-6 x scale of phase 52's and
    bit-equal across two calls; ``per_sample_gradients()`` equal to the
    backward's per-sample gradients; K9f / K9b on the 262,144 x 128
    lattice against their twins; the headline streamed in two blocks
    (K9f and K9b twice each), K9f / K9b on the first 131,072 x 128 block;
54. the headline grid with nearest interpolation and with clamp OOB
    under the default options on the card: the streamed mode (the tiles
    refuse them), frame and backward against ``use_kernel=False``;
55. an override bundle of two rays a pixel (+-0.25 px, 524,288 rays,
    ``max_rays`` 524,288): the compose on the card against the CPU's on
    the same per-ray values (hitmask equal, the rest within 5e-6), two
    frames and two backwards bit-equal, the camera gradient zero, K9f /
    K9b on its lattice against their twins;
56. the hash headline through ``use_tiles=False``: streamed, K9f 8
    times, within 5e-6 of the K7f frame (depth by the same bound);
57. ``opt.fit.render_views`` over the fit flagship's eight views,
    bit-equal to ``pipeline.render`` at each pose.

Phases 58-61 (last; ``--only posed`` runs phases 1 and 58-61 alone)
drive the device-built pose schedule, graph capture, the tiled stage
timings and the CLI, each fatal when it fails:

58. ``PosedRenderer`` over the dense headline and phase 50's six orbit
    poses (pins from a probe over them): the split mode (the main path:
    the build kernel PB, K3 and K1 once a pose) within 5e-6 (depth 1e-4)
    of the ``use_kernel=False`` twin and within 1e-5 of the pose's host-built
    tiled frame (``MovingCameraRenderer``) and of its windowed frame;
    repeats and graph mode bit-equal to the split mode, one graph;
59. ``render_sweep`` bit-equal to the per-pose renders; per pose the
    device build and the render (split), the replay (graph) beside the
    host build, upload and render, with CUDA events; the graph records
    and ``torch.profiler`` finds PB, K1 and K3 once in one replay; PB's
    schedule arrays and diagnostics bit-equal to the torch twin's at
    every pose, a repeat build the same bits; PB, K1 and K3 on the posed
    schedule against their twins, timed;
60. ``enable_graph`` at the headline: the tiled frame and the backward's
    grid and camera gradients bit-equal to eager, a new field object
    re-recording, an in-place edit replaying; the eager and replayed
    frame and step times, the busy share of the replayed step, and K1-K4
    found by the profiler in it; the windowed and streamed frames and
    gradients, the fused frame and the hash-tiled frame bit-equal to
    eager;
61. the tiled stage times at the headline, and the CLI on
    ``examples/simple_volume.json`` and ``smoke_volume.json`` (graph on)
    on the card: its image within 5e-6 of the CPU run's, its PPM
    byte-equal, and ``python -m dvren_tpu_torch.cli`` writing the same
    bytes.

Phases 62-64 (last; ``--only parallel`` runs phases 1 and 62-64 alone)
drive ``dvren_tpu_torch.parallel`` on ranks spawned by its ``launch``
(``parallel_rank``), each fatal when it fails:

62. D = 1 over NCCL: at the dense headline, ``render_tiled_sharded``
    bit-equal to ``render_tiled``, a tile-DP step's gradients within 2e-6
    x scale of autograd through ``render_tiled`` and a repeat step
    bit-identical, ``render_sharded`` bit-equal to ``pipeline.render``
    with no host jitter table read, ``render_zsharded`` within 2e-5 of it
    (depth by phase 38's per-ray bound); at the fit flagship's eight
    views (96^2 over 64^3, one merged 8 px supercell group), the
    multi-view tile-DP step against ``render_tiled_stack``'s gradients
    and ``make_dp_train_step`` against ``render_views``' (2e-6 x scale;
    the view-DP path runs those views with 96 stratified steps, seed 3,
    so that it hashes its jitter);
    every kernel of the main path launched, the jitter kernel included;
    the three steps recorded as CUDA graphs, the all-reduce inside, and
    replayed (``par_graph_steps``): the headline's tile-DP step, the
    flagship's multi-view and view-DP steps with Adam, 10 replays each
    bit-equal to the eager capturable body (losses, parameters, Adam's
    state), within 1e-4 of a non-capturable Adam's, the counters moved by
    the warm-up and the recording only (K3, K1, K2, K4; K1, K2; K9f, K9b
    and the jitter kernel), replayed and eager ms (median of 10);
    ``fit_dense_grid_tile_dp`` and ``fit_dense_grid_dp`` 10 steps each,
    recorded once and bit-equal to those steps; the sharded and
    single-card frames and steps timed (CUDA events, median of 10,
    min-max), and ``shard_tiled_schedule``'s host seconds;
63. D = 2 over gloo, two ranks sharing the card: the same checks, the
    results equal to D = 1's within those bounds, every step eager (no
    graph: gloo sums on the host) with its 10 losses within 1e-4 of
    D = 1's replayed ones, each rank's K1, K2, K3, K4, K9f, K9b and
    jitter launches on the main path (a sharded frame, a tile-DP step, a
    ray-sharded frame, a view-DP step) above 0, K1 / K2 on rank 0's shard
    bit-equal to their twins and timed (the kernels line adds
    ``fused_tiles[_bwd]:rank_shard_d2``), K9f / K9b on rank 0's ray shard
    and on its first view-DP view against their twins at phase 52's
    bounds and timed (``integrate[_bwd]:ray_shard_d2`` and
    ``:view_dp_d2``), the jitter kernel at rank 0's ray shard against its
    twin and timed (``stratified_jitter:ray_shard_d2``); the times are
    two ranks on one card, not a scaling figure;
64. ``dryrun_multichip(2, backend="gloo")``.

Phases 65-69 (last; ``--only close`` runs phases 1 and 65-69 alone), each
fatal when it fails:

65. the jitter kernel (``csrc/jitter.cu``) at the headline's 262,144 x
    128 lattice, bit-equal to its twin on the card and to the host table,
    timed (device and as issued) beside the twin;
66. ``pipeline.render`` with no jitter table at the headline: the jitter
    kernel and K9f once each (the counts set to 0 just before), the frame
    bit-equal to the uploaded table's; median of 5 against the resident
    table and the host gather route the kernel replaces;
67. the headline schedule at ``bank_aligned=True``: bank and group
    counts against the dense packing, the frame and the grid and camera
    gradients through ``render_tiled`` bit-equal to it, K1 / K2 bit-equal
    to their twins and timed beside the dense packing's (the kernels line
    adds ``fused_tiles[_bwd]:bank_aligned``);
68. the fit flagship's merged schedule through
    ``make_train_block_scheduled``: a block of 8 Adam steps (8 replays of
    the step's graph) bit-equal to 8 single steps, K1 / K2 recorded once
    each in the graph, no counter moved by a warm block, which is timed;
69. ``utils/roofline.forward_roofline`` of the headline schedule beside
    its measured frame (median of 10).

Phases 70-72 (last; ``--only soak`` runs phases 1 and 70-72 alone), the
port's counterpart of ``tools/soak.py`` and of the pose refinement of
``tests/test_scenes.py``, each fatal when it fails:

70. 960x720 over the 64^3 sphere shell (radius 0.3, width 0.05), 64 steps
    of 2/64 (``dvren_tpu_torch/utils/scenes.py``): through
    ``Renderer(enable_graph=True)`` (the tiled path: K3, K1, a recorded
    graph replayed) and through ``use_window=True`` (K9f per group); the
    first frame, then sigma x 1.0001 in place and 10 steady frames
    (median, CUDA events); two replays byte-equal; 12 pixels against
    ``tests/oracle.py`` (image 3e-3, depth 1e-2 off the knife edge);
71. 120 frames at 192x144 over a 24^3 blob whose sigma is made on the
    card every frame: through ``pipeline.render`` under stratified
    sampling (K9f and the jitter kernel once a frame; frames per second
    between CUDA events), then the same frames with fixed steps through
    one ``Renderer`` (the tiled path: K3 and K1 every frame), with the
    per-frame invariants and the oracle on frames 0, 29, 59, 89 and 119;
72. pose refinement of c2w's translation through its camera gradients:
    80 Adam steps through ``pipeline.render`` at 20x16, 60 through
    ``render_tiled`` at 32x32 (K1, K2 with the camera adjoint, the
    schedule rebuilt every 10 steps), each meeting the tests'
    convergence bounds, and 20 at 960x720 over the 64^3 shell, which must
    lower the loss; ms a step. Then K3, K1 and K9f at the 960x720 frame,
    K2 at the wide pose step, the jitter kernel at the animation's
    lattice and K9f / K9b at the 20x16 step against their twins, timed,
    with bounds (the kernels line adds ``fused_tiles:soak_960x720``,
    ``packed_table:soak_64``, ``fused_tiles_bwd:pose_960x720``,
    ``integrate:soak_960x720``, ``stratified_jitter:animation`` and
    ``integrate[_bwd]:pose_20x16``).

Phase 73 (last; ``--only fit`` runs phases 1 and 73 alone), fatal when
it fails: the fits' training steps recorded as CUDA graphs and replayed
(``opt/fit.py``; JAX's jitted step and ``lax.scan`` block), at the fit
flagship (phase 36's scene and views) in the tiled, windowed and plain
modes and at phase 14's hash fit: per mode, 10 replayed steps bit-equal
to the eager capturable step's body in losses, parameters and Adam's
state, the launch counters moved by the warm-up and the recording only
(twice the recorded launches); the graphed fit from the same start
bit-equal to those steps, its 10 losses within rtol 1e-4 of 10 eager
steps with a non-capturable Adam; the replayed and the eager step timed
(median of 10, CUDA events) and their device-busy shares over 5 steps
(``torch.profiler``; the replays in a child process that records its
own steps while the parent checks);
then ``fit_dense_grid`` auto at the flagship, graphed, to PSNR 35 (its
steps and ``wall_clock_s``).

Each mode's ``Renderer.forward`` and ``.backward`` is timed over 10 warm
runs between CUDA events (median and spread), beside the peak device
memory; the kernels line adds ``integrate[_bwd]:streamed_headline``,
``:fused_headline``, ``:rays_131072`` and ``:override`` (phases 39 and
40 add ``:fallback_16px`` and ``:view_96``), each with ``ms_per_launch``;
every K9 entry's ``ms`` is its device time, ``issued_ms`` its time as
issued, ``waves`` its blocks over the SMs' resident blocks.

Prints a JSON line of per-kernel results (each with its bound: the larger
of the bytes its inputs and outputs take over the H100's 3.35 TB/s and
its float operations over 67 TFLOP/s, the H100 SXM's published
peaks; ``library_ms`` is null where no single PyTorch call computes the
function, the transpose's time for K5a, K5b and K6), then the card line, and
as the last line
``{"ok": true, "device": {...}}``. Exits nonzero, without that
line, when CUDA is missing, a kernel does not build, or any check fails.
Imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# The benchmark's frozen counts and the card's peaks: one copy, read here.
from bench_port.counts import tiles as tile_counts
from bench_port.counts import windowed as k9_counts
from bench_port.lib import kernels as peaks

TOL = 5e-6          # radiance, transmittance, opacity
TOL_DEPTH = 1e-4    # depth is a ratio: wd / opacity
GRID_TOL = 2e-6     # gradients and d(table), x max |reference|
HASH_GRAD_TOL = 2e-5  # K7b, x max |reference| (tests/test_hash_tiled.py)
HASH_SUBSET = 64    # headline tiles the K7b twin is compared on
FIT_STEPS = 25
OPAQUE_BIAS = 5.0   # added to the teacher's sigma_b2: rays stop early
GRID_STEPS = 10     # Adam steps on the grid path
GRID_GROUPS = 8     # tile groups of the grid headline's schedule
GRID_OPAQUE_BIAS = 30.0   # added to the grid teacher's sigma_b2 (5 stops no ray)
# tools/hashmlp_bench.py's grid spec (:133-143)
GRID_SPEC = dict(n_levels=4, features_per_level=2, table_size=4096,
                 hidden_dim=8, base_resolution=4.0, finest_resolution=32.0,
                 resolutions=(4, 8, 16, 32))
# encoding_dim 64, hidden 8: the widest spec grid_path_ok admits
GRID_EDGE_SPEC = dict(n_levels=8, features_per_level=8, table_size=4096,
                      resolutions=(1, 1, 2, 2, 4, 4, 8, 8))
RAYT_TOL = 1e-5     # d(rayt), x max |reference|
CAM_RTOL, CAM_ATOL = 2e-3, 1e-4   # camera gradients
FRAMES = 30         # timed forward frames
STEPS = 10          # timed training steps
LR = 1e-3           # bench.py's SGD step


# Float operations per processed sample that each function needs from its
# inputs (exp as one; integer and comparison work not counted), counted
# from each kernel's source but without the work a kernel's own design
# adds: a backward counts the forward once (not pass 1's recompute), the
# adjoint, and a product and an add per slot-row column (not the weights
# its window sums recompute). The dense stencil's K1 and K2 counts are
# the benchmark's (``tile_counts.FWD_OPS``, ``BWD_OPS``, ``SUPER_OPS``);
# here the recurrence and the adjoint's transmittance part.
RECUR_OPS = 15
ADJ_OPS = 20


def enc_ops_hash(spec) -> int:
    """K7's per-sample encoding: per level 3 scales, floors and fractions,
    19 for the corner weights, 16 per feature for the corner sum."""
    return spec.n_levels * (9 + 19 + 16 * spec.features_per_level)


def enc_ops_grid(spec) -> int:
    """K8's: the finest coordinates (9), then per level 12 for the level
    fractions, 19 for the weights, 16 per feature for the corner sum."""
    return 9 + spec.n_levels * (12 + 19 + 16 * spec.features_per_level)


def mlp_fwd_ops(spec) -> int:
    h, e = spec.hidden_dim, spec.encoding_dim
    return 4 * h * e + 4 * h + 8 * h + 8


def sigma_ops(spec) -> int:
    h, e = spec.hidden_dim, spec.encoding_dim
    return 2 * h * e + 4 * h + 2


def mlp_bwd_ops(spec) -> int:
    """The heads' adjoint, d(encoding) and the MLP gradient products."""
    h, e = spec.hidden_dim, spec.encoding_dim
    n_sc = 2 * h * e + 6 * h + 4
    return 12 + 10 * h + 4 * h * e + 2 * n_sc


def k7f_ops(spec) -> int:
    return enc_ops_hash(spec) + mlp_fwd_ops(spec) + RECUR_OPS


def k7b_ops(spec) -> int:
    """The forward once (K7f's count), the adjoint, the MLP adjoint and a
    product and an add for each of the 8*L*F table products."""
    table = 2 * 8 * spec.n_levels * spec.features_per_level
    return k7f_ops(spec) + ADJ_OPS + mlp_bwd_ops(spec) + table


def k8f_ops(spec) -> int:
    return enc_ops_grid(spec) + mlp_fwd_ops(spec) + RECUR_OPS


def k8b_ops(spec) -> int:
    """As K7b's, with K8's encoding and C = L*8*F slot-row columns."""
    cols = spec.n_levels * 8 * spec.features_per_level
    return k8f_ops(spec) + ADJ_OPS + mlp_bwd_ops(spec) + 2 * cols


def live_samples(samp) -> int:
    """Masked-in samples of a (T, nc, 3, 16, 128) u16 sample block: bit
    15 of the lane plane (the sign bit of its int16 view). Refuses any
    other block: the hash schedule's (T, nc, 16, 128) float32 sample
    depths carry no mask (count K7's samples with hash_processed)."""
    import torch

    if samp.dtype != torch.uint16 or samp.dim() != 5 or samp.shape[2] != 3:
        raise TypeError(f"live_samples counts a (T, nc, 3, 16, 128) uint16 "
                        f"block, not {samp.dtype} {tuple(samp.shape)}")
    return int((samp[:, :, 2].view(torch.int16) < 0).sum())


def hash_processed(hash_tiles, samp, rayt, table, sc, prm) -> int:
    """The samples K7f and K7b process at these inputs: each ray's steps
    before its stop (T <= stop) or the end of its live lattice, summed
    (``hash_tiles.processed_steps``, the plain twin's recurrence)."""
    return int(hash_tiles.processed_steps(samp, rayt, table, sc, prm).sum())


def take(x, idx):
    """x[idx] along dim 0, contiguous; CUDA indexes no uint16 tensor, so
    those go through their int16 view."""
    import torch

    if x.dtype == torch.uint16:
        return x.view(torch.int16)[idx].contiguous().view(torch.uint16)
    return x[idx].contiguous()


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate (the H100
    SXM's published peaks, ``bench_port/lib/kernels.py``)."""
    by_bytes = n_bytes / peaks.HBM_BYTES_S * 1e3
    by_ops = ops / peaks.F32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def headline_scene(P, width=512, height=512, grid_n=64, max_steps=128,
                   tx=0.5, ty=0.5):
    zs, ys, xs = np.meshgrid(
        np.linspace(0, 1, grid_n), np.linspace(0, 1, grid_n),
        np.linspace(0, 1, grid_n), indexing="ij")
    r2 = (xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
    sigma = (12.0 * np.exp(-r2 / 0.05)).astype(np.float32)
    color = np.stack([xs, ys, 1.0 - zs], axis=-1).astype(np.float32)
    plan = P.Plan.create(P.PlanConfig(
        width=width, height=height, t_near=0.2, t_far=2.2, seed=3,
        camera=P.CameraConfig(
            k=(width * 1.2, 0.0, width / 2, 0.0, width * 1.2, height / 2,
               0.0, 0.0, 1.0),
            c2w=(1, 0, 0, tx, 0, 1, 0, ty, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / max_steps, max_steps=max_steps,
                                  mode=P.SamplingMode.STRATIFIED)))
    config = P.DenseGridConfig(resolution=(grid_n,) * 3,
                               sigma=sigma.reshape(-1),
                               color=color.reshape(-1))
    return plan, config


def small_scene(P, seed=3):
    """The tests' scene (tests/test_tiled.py::scene): 48x32 rays, 8^3."""
    rng = np.random.default_rng(seed)
    n, width, height = 8, 48, 32
    plan = P.Plan.create(P.PlanConfig(
        width=width, height=height, t_near=0.1, t_far=3.1, seed=17,
        camera=P.CameraConfig(
            k=(width * 1.25, 0, width / 2, 0, width * 1.25, height / 2,
               0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.55, 0, 0, 1, -1.1)),
        sampling=P.SamplingConfig(dt=0.05, max_steps=60,
                                  mode=P.SamplingMode.STRATIFIED)))
    config = P.DenseGridConfig(
        resolution=(n, n, n), sigma=rng.uniform(0.5, 8.0, n ** 3),
        color=rng.uniform(0, 1, 3 * n ** 3),
        bbox_min=(0.3, 0.3, 0.2), bbox_max=(0.8, 0.9, 0.7))
    return plan, config


def timed_once(torch, fn):
    """(``fn()``, its ms): one cold run between CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean ms per call of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters, warmup=2):
    """Mean device ms per call of ``fn``: the stream first sleeps on the
    card while the host queues the timed calls behind it, so the events
    time the launches back to back, without the host's cost of issuing
    them (which ``cuda_ms`` includes when a call is short)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)     # ~0.1 s at the H100's clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def packed_times(torch, kernel, plain, iters=50):
    """(device ms, issued ms) of a packed-table kernel's wrapper and the
    device ms of its plain twin: a 40 us kernel's back-to-back calls can
    be paced by the wrapper's host cost, so its row reports the device."""
    return (device_ms(torch, kernel, iters), cuda_ms(torch, kernel, iters),
            device_ms(torch, plain, 10))


def head_errors(torch, fused_tiles, plan, a, b):
    """(max |diff| over r, g, b, T, opacity; max |diff| of depth)."""
    (ra, ga, ba), ta, oa, da = fused_tiles.finalize_heads(plan, a)
    (rb, gb, bb), tb, ob, db = fused_tiles.finalize_heads(plan, b)
    err = max(float((x - y).abs().max())
              for x, y in ((ra, rb), (ga, gb), (ba, bb), (ta, tb), (oa, ob)))
    return err, float((da - db).abs().max())


def planes_errors(planes, ref):
    """Max |diff| of ForwardResult-style flat arrays against ImagePlanes."""
    err = max(float(np.abs(getattr(planes, k)
                           - getattr(ref, k).cpu().numpy().reshape(-1)).max())
              for k in ("image", "transmittance", "opacity"))
    depth = float(np.abs(planes.depth
                         - ref.depth.cpu().numpy().reshape(-1)).max())
    hit = np.array_equal(planes.hitmask,
                         ref.hitmask.cpu().numpy().reshape(-1))
    return err, depth, hit


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                 1e-30)


# The kernels each phase reads the launch counters of, by their names in
# the program's kernel table (utils/trace.py::KERNELS).
DENSE = ("fused_tiles", "fused_tiles_bwd", "packed_table", "packed_table_bwd",
         "packed_table16", "packed_table16_bwd", "banks_to_rows")
DENSE_F32 = ("fused_tiles", "packed_table", "fused_tiles_bwd",
             "packed_table_bwd")    # the float32 route's kernels
HASH = ("hash_tiles", "hash_tiles_bwd")
GRID = ("hash_grid", "hash_grid_bwd")
WINDOW = ("integrate", "integrate_bwd")
POSED = DENSE + ("posed_build",)
JITTER_K9F = ("stratified_jitter", "integrate")
SOAK = ("fused_tiles", "fused_tiles_bwd", "packed_table", "integrate",
        "integrate_bwd", "stratified_jitter")


def counts_of(names) -> dict:
    """The launch counters (``render/graph.py::launch_counts``) of the
    kernels ``names``; ``graph.reset_launch_counts`` sets every kernel's
    to 0."""
    from dvren_tpu_torch.render import graph

    counts = graph.launch_counts()
    return {k: counts[k] for k in names}


def tiled_grads(torch, P, tiled, plan, field, sched, dl_img, use_kernel):
    """d sum(image * dl_img) in (sigma, color, c2w, k), or (bricks, c2w,
    k) for a sparse field, through ``render_tiled``: what
    ``Renderer.backward`` computes, with the kernels or with their plain
    twins."""
    from dvren_tpu_torch.ops.raygen import camera_arrays

    k, c2w, _ = camera_arrays(plan, dl_img.device)
    k.requires_grad_(True)
    c2w.requires_grad_(True)
    if hasattr(field, "bricks"):
        leaf = field.with_params(field.bricks.detach().clone())
        params = (leaf.bricks,)
    else:
        leaf = field.with_params(field.sigma.detach().clone(),
                                 field.color.detach().clone())
        params = (leaf.sigma, leaf.color)
    planes = tiled.render_tiled(plan, leaf, sched, use_kernel=use_kernel,
                                k=k, c2w=c2w)
    return torch.autograd.grad(torch.sum(planes.image * dl_img),
                               params + (c2w, k))


def run_tables(torch, P, dev, plan, config, renderer, f32_result,
               k2_rows) -> tuple[list, dict]:
    """Phases 21-27: the dense headline with 16-bit packed tables (K5a,
    K5b) and as sparse bricks, through Renderer.forward, .backward and
    SGD steps. ``renderer`` holds the headline's schedule (the dtype does
    not change it), ``f32_result`` is its float32 frame and ``k2_rows``
    K2's slot rows for a seeded cotangent (phase 7)."""
    from dvren_tpu_torch.ops import packed_transpose
    from dvren_tpu_torch.ops.grid import _shift_stack_fullpitch
    from dvren_tpu_torch.opt.fit import mse
    from dvren_tpu_torch.render import graph, tiled

    sched = renderer._tiled_schedule
    base = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    sigma, color = base.sigma, base.color
    n_rows = packed_transpose.fullpitch_rows(sigma.shape)
    dtypes = {"bfloat16": torch.bfloat16, "float16": torch.float16}
    c_max = max(c_k for _, _, c_k in sched.gather_plan.meta)
    ulp = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
    gen = torch.Generator(device=dev).manual_seed(21)
    counts = functools.partial(counts_of, DENSE)
    reset = graph.reset_launch_counts
    report = {}

    # 21. K5a against its twin at 64^3, bfloat16 and float16
    k5a_err = 0.0
    for name, dt in dtypes.items():
        got = packed_transpose.build_rows16(sigma, color, dt)
        torch.cuda.synchronize()
        want = packed_transpose.build_rows16_plain(sigma, color, dt)
        require(got.dtype == dt and torch.equal(got.view(torch.int16),
                                                want.view(torch.int16)),
                f"K5a differs from its plain twin ({name})")
        k5a_err = max(k5a_err, float((got.float() - want.float()).abs().max()))
    print(f"K5a == plain, bit for bit, bfloat16 and float16: "
          f"{tuple(got.shape)}", flush=True)

    # 22. Renderer.forward on the 16-bit fields (the headline's schedule)
    fields16 = {name: base.with_packed_dtype(name) for name in dtypes}
    fwd16 = {}
    for name, f16 in fields16.items():
        reset()
        res = renderer.forward(f16)
        c = counts()
        print(f"{name} Renderer.forward: {res.stats.total_ms:.3f} ms, "
              f"launches {c}, notes {res.stats.notes}", flush=True)
        # the Renderer keys its schedule by the table's dtype (the
        # cascade depends on it), so it builds one: the same 16 px cells
        s16 = renderer._tiled_schedule
        require(c["packed_table16"] == 1 and c["packed_table"] == 0
                and c["fused_tiles"] == 1
                and "kernel_launches=packed_table16:1" in res.stats.notes
                and (s16.tile_px, s16.cell_scale) == (16, 1)
                and torch.equal(s16.hostmap_all, sched.hostmap_all),
                f"the {name} forward did not launch K5a and K1 once on the "
                f"headline's schedule")
        for key in ("image", "transmittance", "opacity", "depth"):
            require(bool(np.isfinite(getattr(res, key)).all()),
                    f"{name} {key} not finite")
        with torch.no_grad():
            plain = tiled.render_tiled(plan, f16, sched, use_kernel=False)
        err, depth, hit = planes_errors(res, plain)
        vs32 = max(float(np.abs(getattr(res, k) - getattr(f32_result, k))
                         .max()) for k in ("image", "transmittance",
                                           "opacity"))
        print(f"{name} forward vs plain path: planes {err:.3e}, depth "
              f"{depth:.3e}, hitmask equal {hit}; vs the float32 frame "
              f"{vs32:.3e}", flush=True)
        require(err <= TOL and depth <= TOL_DEPTH and hit,
                f"the {name} forward differs from the plain path")
        require(vs32 <= 5e-3, f"the {name} frame is off the float32 frame")
        fwd16[name] = {"result": res, "vs_plain": err, "vs_f32": vs32,
                       "launches": c}

    # 23. K5b against its twin on the headline's table gradient (K2's slot
    # rows through the 16-bit reduction)
    tg16 = {name: tiled.slot_rows_to_table_as(k2_rows, sched.gather_plan,
                                              n_rows, dt)
            for name, dt in dtypes.items()}
    k5b_err = 0.0
    for name, tg in tg16.items():
        got = packed_transpose.table16_grad_to_params(tg, sigma.shape)
        torch.cuda.synchronize()
        want = packed_transpose.table16_grad_to_params_plain(tg, sigma.shape)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"K5b differs from its plain twin ({name})")
        k5b_err = max(k5b_err, max(float((a - b).abs().max())
                                   for a, b in zip(got, want)))
    print("K5b == plain, bit for bit, bfloat16 and float16", flush=True)

    # 24. Renderer.backward on the 16-bit fields, deterministic
    dl = (torch.rand((plan.ray_count, 3), generator=gen, device=dev) * 2
          - 1).cpu().numpy()
    dl_img = renderer._dl_image(dl)
    bwd16 = {}
    for name, f16 in fields16.items():
        renderer.forward(f16)
        reset()
        torch.use_deterministic_algorithms(True)
        try:
            g1 = renderer.backward(f16, dl)
            c = counts()
            g2 = renderer.backward(f16, dl)
        finally:
            torch.use_deterministic_algorithms(False)
        require(c["fused_tiles_bwd"] == 1
                and c["packed_table16"] == 1
                and c["packed_table16_bwd"] == 1
                and c["packed_table"] == 0 and c["packed_table_bwd"] == 0,
                f"the {name} backward did not launch K2, K5a and K5b once: "
                f"{c}")
        for key in ("sigma", "color", "camera", "camera_k"):
            x = getattr(g1, key)
            require(bool(np.isfinite(x).all()) and float(np.abs(x).max()) > 0,
                    f"{name} backward {key} not finite or zero")
            require(np.array_equal(x, getattr(g2, key)),
                    f"{name} backward {key} differs between two calls")
        plain_g = tiled_grads(torch, P, tiled, plan, f16, sched, dl_img,
                              use_kernel=False)
        errs = [rel_err(torch.from_numpy(getattr(g1, k)),
                        plain_g[i].reshape(-1).cpu())
                for i, k in enumerate(("sigma", "color"))]
        tol = c_max * ulp[name]
        print(f"{name} Renderer.backward: launches {c}; vs plain path sigma "
              f"{errs[0]:.3e}, color {errs[1]:.3e} x scale (bound c * ulp = "
              f"{tol:.3e}, c = {c_max}); two calls equal", flush=True)
        require(max(errs) <= tol,
                f"the {name} backward differs from the plain path")
        bwd16[name] = {"launches": c, "vs_plain": errs}

    # 25. bfloat16 training steps through autograd of render_tiled
    target = torch.zeros((plan.height, plan.width, 3), device=dev)
    n_values = plan.height * plan.width * 3

    def sgd_trainer(field_t, sched_t, lr, use_kernel=True):
        opt = torch.optim.SGD(field_t.parameters(), lr=lr)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = mse(tiled.render_tiled(plan, field_t, sched_t,
                                          use_kernel=use_kernel).image,
                       target)
            loss.backward()
            opt.step()
            return loss

        return step

    def four_steps(field_t, sched_t, expect):
        step = sgd_trainer(field_t, sched_t, LR * n_values)
        losses = []
        reset()
        for _ in range(4):
            before = counts()
            losses.append(float(step().detach()))
            after = counts()
            delta = {k: after[k] - before[k] for k in after}
            require(all(delta[k] == (k in expect) for k in delta),
                    f"a step did not launch each of {expect} once and "
                    f"nothing else: {delta}")
        require(all(np.isfinite(losses))
                and all(b < a for a, b in zip(losses, losses[1:])),
                f"the loss does not fall: {losses}")
        return losses, counts()

    bf16_losses, bf16_launches = four_steps(
        P.DenseGridField.create(config, device=dev).with_packed_dtype(
            "bfloat16"), sched,
        ("fused_tiles", "fused_tiles_bwd", "packed_table16",
         "packed_table16_bwd"))
    print(f"4 SGD steps on the bfloat16 table at lr {LR} x {n_values}: loss "
          f"{bf16_losses}; launches {bf16_launches}", flush=True)

    # 26. sparse bricks at threshold 0: every brick is kept
    t0 = time.perf_counter()
    sp32 = P.SparseGridField.from_dense(base, threshold=0.0, device=dev)
    from_dense_s = time.perf_counter() - t0
    sp16 = P.SparseGridField.from_dense(base, threshold=0.0,
                                        dtype="bfloat16", device=dev)
    sp32.requires_grad_(False)
    sp16.requires_grad_(False)
    print(f"SparseGridField.from_dense {from_dense_s:.3f} s: "
          f"{sp32.occupied_bricks} of {sp32.total_bricks} bricks occupied, "
          f"{sp32.memory_bytes() / 1e6:.1f} MB (f32), "
          f"{sp16.memory_bytes() / 1e6:.1f} MB (bf16)", flush=True)
    require(sp32.occupied_bricks == sp32.total_bricks,
            "threshold 0 dropped a brick of a field positive everywhere")
    s_renderer = P.Renderer(P.Context.create(device="cuda"), plan)
    sp_res = {}
    for name, sp in (("float32", sp32), ("bfloat16", sp16)):
        reset()
        res = s_renderer.forward(sp)
        c = counts()
        print(f"sparse {name} Renderer.forward: {res.stats.total_ms:.3f} ms, "
              f"launches {c}, notes {res.stats.notes}", flush=True)
        require(c["fused_tiles"] == 1 and c["packed_table"] == 0
                and c["packed_table16"] == 0,
                f"the sparse {name} forward did not launch K1 alone")
        require(s_renderer._tiled_schedule.table_kind == "sparse",
                "the sparse forward did not take a sparse schedule")
        ref = f32_result if name == "float32" else fwd16[name]["result"]
        diff = max(float(np.abs(getattr(res, k) - getattr(ref, k)).max())
                   for k in ("image", "transmittance", "opacity", "depth"))
        print(f"sparse {name} frame vs dense {name} frame: max |diff| "
              f"{diff:.3e}", flush=True)
        require(diff == 0.0,
                f"the sparse {name} frame differs from the dense one")
        sp_res[name] = {"result": res, "vs_dense": diff, "launches": c}
    s_sched = s_renderer._tiled_schedule
    s_c = max(c_k for _, _, c_k in s_sched.gather_plan.meta)
    sp_bwd = {}
    for name, sp in (("float32", sp32), ("bfloat16", sp16)):
        s_renderer.forward(sp)
        reset()
        torch.use_deterministic_algorithms(True)
        try:
            g1 = s_renderer.backward(sp, dl)
            c = counts()
            g2 = s_renderer.backward(sp, dl)
        finally:
            torch.use_deterministic_algorithms(False)
        require(g1.bricks.shape == tuple(sp.bricks.shape)
                and g1.sigma.size == 0, "sparse backward shapes")
        for key in ("bricks", "camera", "camera_k"):
            x = getattr(g1, key)
            require(bool(np.isfinite(x).all()) and float(np.abs(x).max()) > 0,
                    f"sparse {name} backward {key} not finite or zero")
            require(np.array_equal(x, getattr(g2, key)),
                    f"sparse {name} backward {key} differs between calls")
        plain_g = tiled_grads(torch, P, tiled, plan, sp, s_sched, dl_img,
                              use_kernel=False)
        err = rel_err(torch.from_numpy(g1.bricks), plain_g[0].float().cpu())
        tol = GRID_TOL if name == "float32" else s_c * ulp[name]
        print(f"sparse {name} Renderer.backward: launches {c}; d(bricks) vs "
              f"plain path {err:.3e} x scale (bound {tol:.3e}); two calls "
              f"equal", flush=True)
        require(c["fused_tiles_bwd"] == 1 and c["packed_table_bwd"] == 0
                and c["packed_table16_bwd"] == 0,
                f"the sparse backward launched other kernels: {c}")
        require(err <= tol, f"the sparse {name} backward differs from the "
                            f"plain path")
        sp_bwd[name] = {"vs_plain": err, "launches": c}
    sp_losses, sp_launches = four_steps(
        P.SparseGridField.from_dense(base, threshold=0.0, device=dev),
        s_sched, ("fused_tiles", "fused_tiles_bwd"))
    print(f"4 SGD steps on the float32 bricks at lr {LR} x {n_values}: loss "
          f"{sp_losses}; launches {sp_launches}", flush=True)

    # 27. times (CUDA events) and the peak device memory each adds
    def peak_from_here():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def added_peak_mb(base_bytes):
        return (torch.cuda.max_memory_allocated() - base_bytes) / 2 ** 20

    times, peaks = {}, {}
    with torch.no_grad():
        for name, f, sch in (("bfloat16", fields16["bfloat16"], sched),
                             ("float16", fields16["float16"], sched),
                             ("sparse_float32", sp32, s_sched),
                             ("sparse_bfloat16", sp16, s_sched)):
            b0 = peak_from_here()
            times[f"frame_{name}"] = cuda_ms(
                torch, lambda f=f, sch=sch: tiled.render_tiled(plan, f, sch),
                FRAMES, warmup=3)
            peaks[f"frame_{name}"] = added_peak_mb(b0)
        times["plain_frame_bfloat16"] = cuda_ms(
            torch, lambda: tiled.render_tiled(plan, fields16["bfloat16"],
                                              sched, use_kernel=False),
            1, warmup=1)
        times["plain_frame_sparse_float32"] = cuda_ms(
            torch, lambda: tiled.render_tiled(plan, sp32, s_sched,
                                              use_kernel=False), 1, warmup=1)
    for name, make, sch in (
            ("bfloat16", lambda: P.DenseGridField.create(
                config, device=dev).with_packed_dtype("bfloat16"), sched),
            ("sparse_float32", lambda: P.SparseGridField.from_dense(
                base, threshold=0.0, device=dev), s_sched)):
        b0 = peak_from_here()
        times[f"step_{name}"] = cuda_ms(torch, sgd_trainer(make(), sch, LR),
                                        STEPS, warmup=2)
        peaks[f"step_{name}"] = added_peak_mb(b0)
        times[f"plain_step_{name}"] = cuda_ms(
            torch, sgd_trainer(make(), sch, LR, use_kernel=False), 1,
            warmup=1)
    k5 = {}
    for name, dt in dtypes.items():
        stack = _shift_stack_fullpitch(sigma, color, n_rows).to(dt)
        rows32 = tg16[name].float()
        k5a, k5a_issued, k5a_plain = packed_times(
            torch, lambda dt=dt: packed_transpose.build_rows16(
                sigma, color, dt),
            lambda dt=dt: packed_transpose.build_rows16_plain(
                sigma, color, dt))
        k5b, k5b_issued, k5b_plain = packed_times(
            torch, lambda tg=tg16[name]:
            packed_transpose.table16_grad_to_params(tg, sigma.shape),
            lambda tg=tg16[name]:
            packed_transpose.table16_grad_to_params_plain(tg, sigma.shape))
        k5[name] = {
            "k5a": k5a, "k5a_issued": k5a_issued, "k5a_plain": k5a_plain,
            "k5a_library": device_ms(torch,
                                     lambda s=stack: s.t().contiguous(), 50),
            "k5b": k5b, "k5b_issued": k5b_issued, "k5b_plain": k5b_plain,
            "k5b_library": device_ms(torch,
                                     lambda r=rows32: r.t().contiguous(), 50)}
    n_rays = plan.ray_count
    print("16-bit and sparse times ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    print("Mrays/s: " + ", ".join(
        f"{k} {n_rays / v / 1e3:.3f}" for k, v in times.items()
        if not k.startswith("plain")), flush=True)
    print("peak device memory added MiB: " + ", ".join(
        f"{k} {v:.1f}" for k, v in peaks.items()), flush=True)
    for name, t in k5.items():
        print(f"{name}, device ms: K5a {t['k5a']:.4f} ({t['k5a_issued']:.4f}"
              f" as issued; plain {t['k5a_plain']:.4f}, "
              f"stack.t().contiguous() {t['k5a_library']:.4f}); K5b "
              f"{t['k5b']:.4f} ({t['k5b_issued']:.4f} as issued; plain "
              f"{t['k5b_plain']:.4f}, rows.t().contiguous() "
              f"{t['k5b_library']:.4f})", flush=True)

    t16 = packed_transpose.build_rows16(sigma, color, torch.bfloat16)
    k5b_out = packed_transpose.table16_grad_to_params(tg16["bfloat16"],
                                                      sigma.shape)
    kernels = [
        {"name": "packed_table16", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/packed_table.cu",
         "replaces": "dvren_tpu/ops/packed_transpose.py:40",
         "launches": fwd16["bfloat16"]["launches"]["packed_table16"],
         "max_abs_err": k5a_err, "ms": k5["bfloat16"]["k5a"],
         "issued_ms": k5["bfloat16"]["k5a_issued"],
         "plain_ms": k5["bfloat16"]["k5a_plain"],
         **bound(nbytes(sigma, color, t16), 0),
         "library_ms": k5["bfloat16"]["k5a_library"]},
        {"name": "packed_table16_bwd", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/packed_table_bwd.cu",
         "replaces": "dvren_tpu/ops/packed_transpose.py:63",
         "launches": bf16_launches["packed_table16_bwd"],
         "max_abs_err": k5b_err, "ms": k5["bfloat16"]["k5b"],
         "issued_ms": k5["bfloat16"]["k5b_issued"],
         "plain_ms": k5["bfloat16"]["k5b_plain"],
         **bound(nbytes(tg16["bfloat16"], *k5b_out),
                 8 * sum(x.numel() for x in k5b_out)),
         "library_ms": k5["bfloat16"]["k5b_library"]},
    ]
    report.update({
        "times_ms": times, "added_peak_mib": peaks, "k5_ms": k5,
        "forward16_vs_plain": {k: v["vs_plain"] for k, v in fwd16.items()},
        "forward16_vs_f32": {k: v["vs_f32"] for k, v in fwd16.items()},
        "backward16_vs_plain": {k: v["vs_plain"] for k, v in bwd16.items()},
        "sparse_vs_dense": {k: v["vs_dense"] for k, v in sp_res.items()},
        "sparse_backward_vs_plain": {k: v["vs_plain"]
                                     for k, v in sp_bwd.items()},
        "bf16_losses": bf16_losses, "sparse_losses": sp_losses,
        "sparse_from_dense_s": from_dense_s,
        "sparse_memory_mb": [sp32.memory_bytes() / 1e6,
                             sp16.memory_bytes() / 1e6],
        "slot_class_max": [c_max, s_c]})
    return kernels, report


def hash_headline(P, width=512, max_steps=128):
    """tools/hashmlp_bench.py's plan (seed 5, stratified) and spec."""
    plan = P.Plan.create(P.PlanConfig(
        width=width, height=width, t_near=0.2, t_far=2.2, seed=5,
        camera=P.CameraConfig(
            k=(width * 1.2, 0, width / 2, 0, width * 1.2, width / 2, 0, 0,
               1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / max_steps, max_steps=max_steps,
                                  mode=P.SamplingMode.STRATIFIED)))
    spec = P.HashMLPSpec(n_levels=8, table_size=128, base_resolution=2.0,
                         finest_resolution=48.0)
    return plan, spec


def hash_fit_setup(P, views=4, width=96):
    """tools/hashmlp_bench.py's fit: 4 views at 96^2 on a y-axis orbit of
    radius 1.5 around (0.5, 0.5, 0.5), 64 fixed steps."""
    plan = P.Plan.create(P.PlanConfig(
        width=width, height=width, t_near=0.2, t_far=2.2, seed=5,
        camera=P.CameraConfig(
            k=(width * 1.2, 0, width / 2, 0, width * 1.2, width / 2, 0, 0,
               1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / 64, max_steps=64)))
    center = np.array([0.5, 0.5, 0.5], np.float32)
    cams = []
    for v in range(views):
        th = 2 * np.pi * v / views
        eye = center + 1.5 * np.array([np.sin(th), 0.0, -np.cos(th)],
                                      np.float32)
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(np.array([0.0, 1.0, 0.0], np.float32), fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        c2w = np.concatenate([np.stack([right, up, fwd], axis=1),
                              eye.reshape(3, 1)], axis=1)
        cams.append(P.CameraConfig(
            k=plan.camera.k, c2w=tuple(float(x) for x in c2w.reshape(-1))))
    return plan, cams


def hash_small_scene(P, device=None):
    """tests/test_hash_tiled.py's stratified case: 24x20, default spec."""
    plan = P.Plan.create(P.PlanConfig(
        width=24, height=20, t_near=0.2, t_far=1.8, seed=11,
        sampling=P.SamplingConfig(dt=0.05, max_steps=24,
                                  mode=P.SamplingMode.STRATIFIED)))
    spec = P.HashMLPSpec()
    flat = np.random.default_rng(5).uniform(
        -0.5, 0.5, spec.param_count).astype(np.float32)
    return plan, P.HashMLPField.create(P.HashMLPConfig(spec=spec,
                                                       params=flat),
                                       device=device)


def hash_occupancy(hash_tiles, spec, what) -> dict:
    """Print and return K7f's and K7b's registers, shared memory per
    block, local memory per thread and blocks per SM at ``spec`` (CUDA
    runtime)."""
    occ = hash_tiles.kernel_occupancy(spec)
    for name, o in occ.items():
        extra = (f", {o['warps_per_block']} warps per block, "
                 f"{o['tiles_per_lane']} product tiles per lane"
                 if "warps_per_block" in o else "")
        print(f"{what}: {name} {o['registers']} registers, "
              f"{o['static_smem'] + o['dynamic_smem']} B shared memory per "
              f"block, {o['local_bytes']} B local memory per thread, "
              f"{o['blocks_per_sm']} blocks per SM{extra}", flush=True)
    return occ


def run_hash(torch, P, dev) -> tuple[list, dict]:
    """Phases 11-15: the hash-MLP field's forward, backward and fit."""
    from dvren_tpu_torch.ops import fused_tiles, hash_tiles
    from dvren_tpu_torch.opt import fit
    from dvren_tpu_torch.render import graph, hash_tiled

    # 11. K7f against its plain twin at the hash headline
    plan, spec = hash_headline(P)
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(0),
                                       spec=spec, device=dev)
    field.requires_grad_(False)
    t0 = time.perf_counter()
    sched_host = hash_tiled.build_hash_schedule(plan)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sched = sched_host.to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    print(f"hash schedule build {build_s:.3f} s, upload {upload_s:.3f} s: "
          f"{sched.n_tiles} tiles x {sched.n_chunks} chunks, sample_t "
          f"{sched.samp.numel() * 4 / 2 ** 20:.1f} MiB", flush=True)
    params = dict(field.params)
    prm = hash_tiles.hash_tile_params(plan, spec, sched.n_chunks)
    table = params["hash_table"].contiguous()
    sc = hash_tiles.pack_mlp_scalars(params, spec)
    args = (sched.samp, sched.rayt, table, sc, prm)
    out_k = hash_tiles.hash_tile_forward(*args)
    torch.cuda.synchronize()
    out_p = hash_tiles.hash_tile_forward_plain(*args)
    require(bool(torch.isfinite(out_k).all()), "K7f output not finite")
    k7f_err, k7f_depth = head_errors(torch, fused_tiles, plan, out_k, out_p)
    k7f_raw = float((out_k - out_p).abs().max())
    print(f"K7f vs plain: heads {k7f_err:.3e}, depth {k7f_depth:.3e}, raw "
          f"{k7f_raw:.3e}", flush=True)
    require(k7f_err <= TOL and k7f_depth <= TOL_DEPTH,
            "K7f differs from its plain twin beyond tolerance")
    occ = hash_occupancy(hash_tiles, spec, "hash headline")
    proc = hash_processed(hash_tiles, *args)
    print(f"hash headline: {proc} processed of {sched.samp.numel()} "
          f"scheduled samples", flush=True)

    # 12. Renderer.forward on the hash field, end to end
    renderer = P.Renderer(P.Context.create(device="cuda"), plan)
    graph.reset_launch_counts()
    result = renderer.forward(field)
    fwd_launches = counts_of(HASH)
    print(f"hash Renderer.forward: {result.stats.total_ms:.3f} ms (schedule "
          f"included), launches {fwd_launches}, notes "
          f"{result.stats.notes}", flush=True)
    require(fwd_launches["hash_tiles"] == 1
            and "hash_tiled_path" in result.stats.notes
            and "kernel_launches=hash_tiles:1" in result.stats.notes,
            "the hash Renderer.forward did not launch K7f")
    for name in ("image", "transmittance", "opacity", "depth"):
        require(bool(np.isfinite(getattr(result, name)).all()),
                f"hash {name} not finite")
    require(float(result.opacity.max()) > 0.0, "hash opacity is 0 "
            "everywhere")
    with torch.no_grad():
        plain = hash_tiled.render_hash_tiled(plan, field,
                                             renderer._hash_schedule,
                                             use_kernel=False)
    e2e_err, e2e_depth, hit_ok = planes_errors(result, plain)
    print(f"hash forward vs plain path: planes {e2e_err:.3e}, depth "
          f"{e2e_depth:.3e}, hitmask equal {hit_ok}; opacity max "
          f"{float(result.opacity.max()):.6f} mean "
          f"{float(result.opacity.mean()):.6f}", flush=True)
    require(e2e_err <= TOL and e2e_depth <= TOL_DEPTH and hit_ok,
            "hash forward differs from the plain path")
    s_plan, s_field = hash_small_scene(P, dev)
    s_out = P.Renderer(P.Context.create(device="cuda"), s_plan).forward(
        s_field)
    s_ref = P.Renderer(P.Context.create(device="cpu"), s_plan,
                       P.RenderOptions(use_tiles=True)).forward(
        hash_small_scene(P, "cpu")[1])
    s_err = max(float(np.abs(getattr(s_out, k) - getattr(s_ref, k)).max())
                for k in ("image", "transmittance", "opacity"))
    s_depth = float(np.abs(s_out.depth - s_ref.depth).max())
    print(f"small hash scene, card vs CPU plain: planes {s_err:.3e}, depth "
          f"{s_depth:.3e}", flush=True)
    require(s_err <= TOL and s_depth <= TOL_DEPTH
            and np.array_equal(s_out.hitmask, s_ref.hitmask),
            "small hash scene on the card differs from the CPU")

    # 13. K7b against its plain twin (tile subset); repeats on the frame
    gen = torch.Generator(device=dev).manual_seed(7)
    gs = torch.randn((sched.n_tiles, 5, 16, 16), generator=gen, device=dev)
    step = sched.n_tiles // HASH_SUBSET
    sub = torch.arange(0, sched.n_tiles, step, device=dev)[:HASH_SUBSET]
    sub_args = (sched.samp[sub].contiguous(), sched.rayt[sub].contiguous(),
                table, sc)
    b_tab, b_sc = hash_tiles.hash_tile_backward(*sub_args, gs[sub].contiguous(),
                                                prm)
    torch.cuda.synchronize()
    p_tab, p_sc = hash_tiles.hash_tile_backward_plain(
        *sub_args, gs[sub].contiguous(), prm)
    k7b_tab_err, k7b_sc_err = rel_err(b_tab, p_tab), rel_err(b_sc, p_sc)
    k7b_raw = max(float((b_tab - p_tab).abs().max()),
                  float((b_sc - p_sc).abs().max()))
    full1 = hash_tiles.hash_tile_backward(*args[:4], gs, prm)
    full2 = hash_tiles.hash_tile_backward(*args[:4], gs, prm)
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(x).all()) for x in full1),
            "K7b not finite")
    require(all(torch.equal(a, b) for a, b in zip(full1, full2)),
            "K7b differs between two runs")
    print(f"K7b vs plain on {HASH_SUBSET} tiles: d(table) {k7b_tab_err:.3e} "
          f"x scale, d(MLP) {k7b_sc_err:.3e} x scale (max |diff| "
          f"{k7b_raw:.3e}); two full-frame runs equal", flush=True)
    require(k7b_tab_err <= HASH_GRAD_TOL and k7b_sc_err <= HASH_GRAD_TOL,
            "K7b differs from its plain twin beyond tolerance")

    # 14. fit_hash_mlp toward a teacher of the same spec
    f_plan, cams = hash_fit_setup(P)
    # a denser teacher than the default initialisation (table std 1, not
    # 1e-2), so the targets are not near-empty images
    teacher = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                         spec=spec, table_std=1.0,
                                         device=dev)
    stack = hash_tiled.build_hash_schedule_stack(
        fit.view_plans(f_plan, cams), device=dev)
    with torch.no_grad():
        targets = hash_tiled.render_hash_tiled_stack(f_plan, teacher, stack)
    student = P.HashMLPField.init_random(torch.Generator().manual_seed(3),
                                         spec=spec, device=dev)
    config = fit.FitConfig(steps=FIT_STEPS, sync_every=FIT_STEPS,
                           learning_rate=8e-3, target_psnr=None)
    graph.reset_launch_counts()
    res = fit.fit_hash_mlp(f_plan, student, cams, targets, config)
    fit_launches = counts_of(HASH)
    losses = res.loss_history
    print(f"fit_hash_mlp: {res.steps_run} steps, loss {losses[0]:.6e} -> "
          f"{losses[-1]:.6e} (psnr {res.psnr_history[0]:.3f} -> "
          f"{res.psnr_history[-1]:.3f} dB), recorded in the step graph "
          f"{res.recorded_launches} (capture {res.capture_ms:.1f} ms), "
          f"launches {fit_launches}, "
          f"schedule {res.schedule_build_s:.3f} s, first step "
          f"{res.first_step_s:.3f} s, steady {res.steady_step_ms:.4f} "
          f"ms/step, wall {res.wall_clock_s:.3f} s", flush=True)
    require(res.steps_run == FIT_STEPS and np.all(np.isfinite(losses)),
            "fit loss not finite")
    require(losses[-1] < losses[0], "fit loss does not fall")
    require(res.recorded_launches == {"hash_tiles": 1, "hash_tiles_bwd": 1}
            and fit_launches == {"hash_tiles": 2, "hash_tiles_bwd": 2},
            f"the fit's step graph did not record K7f / K7b once each, or a "
            f"replay launched through a wrapper (the warm-up and the "
            f"recording launch each once): recorded "
            f"{res.recorded_launches}, counters {fit_launches}")
    require(res.steady_step_ms > 0.0, "steady_step_ms is 0")

    # K7f and K7b against their twins at the fit's shapes, for the fitted
    # student and an opaque teacher. A ray stopped early when its optical
    # depth with the stop threshold is below the one without it.
    f_prm = hash_tiles.hash_tile_params(f_plan, spec, stack.n_chunks)
    f_gs = torch.randn((stack.samp.shape[0], 5, 16, 16), generator=gen,
                       device=dev)
    opaque = {k: v.detach().clone() for k, v in teacher.params.items()}
    opaque["sigma_b2"] += OPAQUE_BIAS
    fit_cmp = {}
    with torch.no_grad():
        for name, prms in (("student", res.field.params),
                           ("opaque teacher", opaque)):
            f_args = (stack.samp, stack.rayt,
                      prms["hash_table"].detach().contiguous(),
                      hash_tiles.pack_mlp_scalars(prms, spec))
            o_k = hash_tiles.hash_tile_forward(*f_args, f_prm)
            g_k = hash_tiles.hash_tile_backward(*f_args, f_gs, f_prm)
            torch.cuda.synchronize()
            o_p = hash_tiles.hash_tile_forward_plain(*f_args, f_prm)
            g_p = hash_tiles.hash_tile_backward_plain(*f_args, f_gs, f_prm)
            no_stop = hash_tiles.hash_tile_forward_plain(
                *f_args, dataclasses.replace(f_prm, stop=0.0))
            early = int((o_p[:, 4] < no_stop[:, 4]).sum())
            f_proc = hash_processed(hash_tiles, *f_args, f_prm)
            err, depth = head_errors(torch, fused_tiles, f_plan, o_k, o_p)
            cmp = {"heads": err, "depth": depth, "processed": f_proc,
                   "k7f_bound": bound(nbytes(*f_args, o_k),
                                      f_proc * k7f_ops(spec)),
                   "k7b_bound": bound(nbytes(*f_args, f_gs, *g_k),
                                      f_proc * k7b_ops(spec)),
                   "k7f_ms": cuda_ms(torch, lambda: hash_tiles.
                                     hash_tile_forward(*f_args, f_prm), 20),
                   "k7b_ms": cuda_ms(torch, lambda: hash_tiles.
                                     hash_tile_backward(*f_args, f_gs,
                                                        f_prm), 20),
                   "f_raw": float((o_k - o_p).abs().max()),
                   "table": rel_err(g_k[0], g_p[0]),
                   "mlp": rel_err(g_k[1], g_p[1]),
                   "b_raw": max(float((g_k[0] - g_p[0]).abs().max()),
                                float((g_k[1] - g_p[1]).abs().max())),
                   "early": early}
            fit_cmp[name] = cmp
            print(f"fit shapes, {name}: K7f vs plain heads {err:.3e}, depth "
                  f"{depth:.3e}, raw {cmp['f_raw']:.3e}; K7b vs plain "
                  f"d(table) {cmp['table']:.3e} x scale, d(MLP) "
                  f"{cmp['mlp']:.3e} x scale (max |diff| {cmp['b_raw']:.3e}); "
                  f"{early} of {f_plan.ray_count * len(cams)} rays stop early, "
                  f"{f_proc} of {stack.samp.numel()} samples processed; K7f "
                  f"{cmp['k7f_ms']:.4f} ms (bound "
                  f"{cmp['k7f_bound']['bound_ms']:.4f}), K7b "
                  f"{cmp['k7b_ms']:.4f} ms (bound "
                  f"{cmp['k7b_bound']['bound_ms']:.4f})", flush=True)
            require(err <= TOL and depth <= TOL_DEPTH,
                    f"K7f differs from its twin at the fit's shapes ({name})")
            require(cmp["table"] <= HASH_GRAD_TOL
                    and cmp["mlp"] <= HASH_GRAD_TOL,
                    f"K7b differs from its twin at the fit's shapes ({name})")
    require(fit_cmp["opaque teacher"]["early"] > 0,
            "no ray of the opaque teacher stops early")

    # 15. times; peak device memory above what the earlier phases still
    # hold (the dense scene, both schedules, the teacher's targets)
    def added_peak_mb(base):
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 20

    base = torch.cuda.memory_allocated()
    print(f"allocated before the hash timings {base / 2 ** 20:.1f} MiB",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: hash_tiled.render_hash_tiled(
            plan, field, sched), FRAMES, warmup=3)
        peak_mb = added_peak_mb(base)
        plain_fwd_ms = cuda_ms(torch, lambda: hash_tiled.render_hash_tiled(
            plan, field, sched, use_kernel=False), 1, warmup=1)
    k7f_ms = cuda_ms(torch, lambda: hash_tiles.hash_tile_forward(*args), 20)
    k7f_plain_ms = cuda_ms(
        torch, lambda: hash_tiles.hash_tile_forward_plain(*args), 1,
        warmup=1)
    torch.cuda.reset_peak_memory_stats()
    k7b_ms = cuda_ms(torch, lambda: hash_tiles.hash_tile_backward(
        *args[:4], gs, prm), 5, warmup=1)
    bwd_peak_mb = added_peak_mb(base)
    k7b_plain_ms = cuda_ms(torch, lambda: hash_tiles.hash_tile_backward_plain(
        *args[:4], gs, prm), 1, warmup=0)
    k7b_sub_ms = cuda_ms(torch, lambda: hash_tiles.hash_tile_backward(
        *sub_args, gs[sub].contiguous(), prm), 20)
    k7b_sub_plain_ms = cuda_ms(
        torch, lambda: hash_tiles.hash_tile_backward_plain(
            *sub_args, gs[sub].contiguous(), prm), 1, warmup=1)
    n_rays = plan.ray_count
    print(f"hash forward {fwd_ms:.4f} ms/frame = "
          f"{n_rays / fwd_ms / 1e3:.3f} Mrays/s over {FRAMES} frames (plain "
          f"path {plain_fwd_ms:.4f} ms); K7f {k7f_ms:.4f} ms (plain "
          f"{k7f_plain_ms:.4f}); K7b {k7b_ms:.4f} ms (plain "
          f"{k7b_plain_ms:.4f}), on {HASH_SUBSET} tiles {k7b_sub_ms:.4f} ms "
          f"(plain {k7b_sub_plain_ms:.4f}); peak device memory added: "
          f"forward {peak_mb:.1f} MiB, K7b {bwd_peak_mb:.1f} MiB",
          flush=True)

    hash_occupancy(hash_tiles, spec, "hash timings")

    trained = student.with_params({k: v.detach().clone()
                                   for k, v in student.params.items()})

    def fit_step(use_kernel, opt, f):
        def step():
            opt.zero_grad(set_to_none=True)
            loss = fit.mse(hash_tiled.render_hash_tiled_stack(
                f_plan, f, stack, use_kernel=use_kernel), targets)
            loss.backward()
            opt.step()
        return step

    opt = torch.optim.Adam(trained.parameters(), lr=8e-3)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fit_ms = cuda_ms(torch, fit_step(True, opt, trained), 20, warmup=2)
    fit_peak_mb = added_peak_mb(base)
    plain_fit_ms = cuda_ms(torch, fit_step(False, opt, trained), 1,
                           warmup=1)
    fit_rays = len(cams) * f_plan.ray_count
    print(f"fit step {fit_ms:.4f} ms/step = {fit_rays / fit_ms / 1e3:.3f} "
          f"Mrays/s over 20 steps (plain path {plain_fit_ms:.4f} ms/step); "
          f"peak device memory added {fit_peak_mb:.1f} MiB", flush=True)
    profile = device_breakdown(torch, fit_step(True, opt, trained), steps=5)
    if profile is not None:
        kern_ms, wall_ms, top = profile
        print(f"fit step under torch.profiler: kernels {kern_ms:.4f} ms of "
              f"{wall_ms:.4f} ms wall per step (idle share "
              f"{1.0 - kern_ms / wall_ms:.3f}); "
              + ", ".join(f"{n} {ms:.4f} ms x{c}" for n, ms, c in top),
              flush=True)

    kernels = [
        {"name": "hash_tiles", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/hash_tiles.cu",
         "replaces": "dvren_tpu/ops/hash_tiles.py:288",
         "launches": fwd_launches["hash_tiles"],
         "max_abs_err": max([k7f_raw] + [c["f_raw"]
                                         for c in fit_cmp.values()]),
         "ms": k7f_ms, "plain_ms": k7f_plain_ms,
         **bound(nbytes(*args[:4], out_k), proc * k7f_ops(spec))},
        {"name": "hash_tiles_bwd", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/hash_tiles_bwd.cu",
         "replaces": "dvren_tpu/ops/hash_tiles.py:339",
         "launches": fit_launches["hash_tiles_bwd"],
         "max_abs_err": max([k7b_raw] + [c["b_raw"]
                                         for c in fit_cmp.values()]),
         "ms": k7b_ms, "plain_ms": k7b_plain_ms,
         **bound(nbytes(*args[:4], gs, *full1), proc * k7b_ops(spec))},
    ]
    report = {
        "hash_forward_ms": fwd_ms, "hash_forward_mrays_s":
            n_rays / fwd_ms / 1e3,
        "hash_plain_forward_ms": plain_fwd_ms,
        "hash_schedule_build_s": build_s, "hash_schedule_upload_s": upload_s,
        "hash_processed_samples": proc, "k7_occupancy": occ,
        "hash_forward_added_peak_mib": peak_mb,
        "k7b_added_peak_mib": bwd_peak_mb,
        "k7f_ms": k7f_ms, "k7b_ms": k7b_ms,
        "k7b_subset_ms": k7b_sub_ms, "k7b_subset_plain_ms": k7b_sub_plain_ms,
        "k7b_rel_err": [k7b_tab_err, k7b_sc_err],
        "fit_shape_compares": fit_cmp,
        "hash_forward_vs_plain": e2e_err,
        "fit_step_ms": fit_ms, "fit_plain_step_ms": plain_fit_ms,
        "fit_step_profile": profile,
        "fit_mrays_s": fit_rays / fit_ms / 1e3,
        "fit_added_peak_mib": fit_peak_mb,
        "fit_losses": [losses[0], losses[-1]],
        "fit_steady_step_ms": res.steady_step_ms,
        "fit_first_step_s": res.first_step_s,
        "fit_schedule_build_s": res.schedule_build_s}
    return kernels, report


def grid_small_scene(torch, P, device=None):
    """tests/test_hash_grid.py's scene: 32^2, 16 fixed steps, L=3 / F=2 /
    T=4096 on the 2-4-8 ladder, a field from a seeded generator."""
    w, steps = 32, 16
    plan = P.Plan.create(P.PlanConfig(
        width=w, height=w, t_near=0.2, t_far=2.2, seed=5,
        camera=P.CameraConfig(
            k=(w * 1.2, 0, w / 2, 0, w * 1.2, w / 2, 0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / steps, max_steps=steps)))
    spec = P.HashMLPSpec(n_levels=3, features_per_level=2, table_size=4096,
                         base_resolution=2.0, finest_resolution=8.0,
                         resolutions=(2, 4, 8))
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(4),
                                       spec=spec, table_std=0.5,
                                       device=device)
    return plan, field


def image_errors(a, b):
    """(max |diff| over image, transmittance, opacity; depth; hitmask
    equal) of two ImagePlanes."""
    def diff(k):
        return (getattr(a, k).cpu() - getattr(b, k).cpu()).abs().max()

    err = max(float(diff(k)) for k in ("image", "transmittance", "opacity"))
    return (err, float(diff("depth")),
            bool((a.hitmask.cpu() == b.hitmask.cpu()).all()))


def grid_tiles_args(plan, spec, sched, params) -> tuple:
    """(packed table, (flat bank tables, TileSet, sc, GridParams)): the
    one-launch K8f / K8b arguments of ``sched`` for detached ``params``."""
    from dvren_tpu_torch.ops import hash_grid, hash_tiles
    from dvren_tpu_torch.render import tiled

    table = hash_grid.build_hash_grid_table(params, spec)
    tabs = tiled._gather_banks_flat(table, sched.gathermap_all)
    sc = hash_tiles.pack_mlp_scalars(params, spec)
    return table, (tabs, sched.tiles, sc,
                   hash_grid.tiles_op_params(plan, spec, sched.tiles))


def grid_occupancy(hash_grid, spec, subs, what) -> dict:
    """Print and return K8f's and K8b's registers, shared memory per block,
    local memory per thread and blocks per SM at ``spec`` (CUDA runtime)."""
    occ = hash_grid.kernel_occupancy(spec, subs)
    for name, o in occ.items():
        extra = (f", staged group g {o['g']}, panel {o['panel']}"
                 if "g" in o else "")
        print(f"{what}: {name} (subs {subs}) {o['registers']} registers, "
              f"{o['static_smem'] + o['dynamic_smem']} B shared memory per "
              f"block, {o['local_bytes']} B local memory per thread, "
              f"{o['blocks_per_sm']} blocks per SM{extra}", flush=True)
    return occ


def run_grid(torch, P, dev) -> tuple[list, dict]:
    """Phases 16-20: the NGP-scale hash grid path."""
    from dvren_tpu_torch.ops import fused_tiles, gather_plan, hash_grid
    from dvren_tpu_torch.opt.fit import mse
    from dvren_tpu_torch.render import graph, hash_tiled, tiled

    # 16. the grid headline's schedule; K8f against its twin on every group
    print(card_line(), flush=True)
    plan, _ = hash_headline(P)
    spec = P.HashMLPSpec(**GRID_SPEC)
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                       spec=spec, device=dev)
    t0 = time.perf_counter()
    sched_host = hash_tiled.build_hash_grid_schedule(plan, field)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sched = sched_host.to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    groups = sched.groups
    n_groups = len(groups)
    lanes = sum(g.n_tiles * g.banks for g in groups) * 128
    print(f"grid schedule build {build_s:.3f} s, upload {upload_s:.3f} s: "
          f"{sched.tile_px} px tiles, (n_chunks, n_tiles, banks) "
          f"{[(g.n_chunks, g.n_tiles, g.banks) for g in groups]}, {lanes} "
          f"bank lanes, {sched.tiled_samples} of "
          f"{sched.full_lattice_samples} samples live, fallback_rays "
          f"{sched.fallback_rays}", flush=True)
    require(sched.tile_px == 16 and sched.fallback_rays == 0
            and n_groups == GRID_GROUPS,
            "the grid headline's schedule is not 16 px tiles in "
            f"{GRID_GROUPS} groups without overflow")
    occ = grid_occupancy(hash_grid, spec, 1, "grid headline")
    occ_edge = grid_occupancy(hash_grid, P.HashMLPSpec(**GRID_EDGE_SPEC), 1,
                              "enc 64, hidden 8")

    def kernel_args(params):
        return grid_tiles_args(plan, spec, sched, params)

    teacher = P.HashMLPField.init_random(torch.Generator().manual_seed(2),
                                         spec=spec, table_std=1.0,
                                         device=dev)
    student_p = {k: v.detach() for k, v in field.params.items()}
    opaque_p = {k: v.detach().clone() for k, v in teacher.params.items()}
    opaque_p["sigma_b2"] += GRID_OPAQUE_BIAS
    cmp = {}
    for name, params in (("student", student_p), ("opaque teacher", opaque_p)):
        _, a = kernel_args(params)
        out_k = hash_grid.hash_grid_forward_tiles(*a)
        torch.cuda.synchronize()
        out_p = hash_grid.hash_grid_forward_tiles_plain(*a)
        require(bool(torch.isfinite(out_k).all()), "K8f output not finite")
        err, depth = head_errors(torch, fused_tiles, plan, out_k, out_p)
        c = {"heads": err, "depth": depth,
             "f_raw": float((out_k - out_p).abs().max()),
             "bit_equal": bool(torch.equal(out_k, out_p)), "early": 0}
        if name != "student":
            no_stop = hash_grid.hash_grid_forward_tiles_plain(
                *a[:3], dataclasses.replace(a[3], stop=0.0))
            c["early"] = int((out_p[:, 4] < no_stop[:, 4]).sum())
        cmp[name] = c
        print(f"K8f (one launch over {n_groups} groups) vs plain, {name}: "
              f"heads {c['heads']:.3e}, depth {c['depth']:.3e}, raw "
              f"{c['f_raw']:.3e}, bit for bit {c['bit_equal']}"
              + (f"; {c['early']} rays stop early"
                 if name != "student" else ""), flush=True)
        require(c["heads"] <= TOL and c["depth"] <= TOL_DEPTH,
                f"K8f differs from its plain twin beyond tolerance ({name})")
        require(c["bit_equal"],
                f"K8f is not bit-equal to its twins group by group ({name})")
    require(cmp["opaque teacher"]["early"] > 0,
            "no ray of the opaque teacher stops early")

    # 17. render_hash_grid_tiled on the card against the plain path there
    field.requires_grad_(False)
    graph.reset_launch_counts()
    with torch.no_grad():
        out = hash_tiled.render_hash_grid_tiled(plan, field, sched)
        fwd_launches = counts_of(GRID)
        plain = hash_tiled.render_hash_grid_tiled(plan, field, sched,
                                                  use_kernel=False)
    require(fwd_launches == {"hash_grid": 1, "hash_grid_bwd": 0},
            f"render_hash_grid_tiled did not launch K8f once over its "
            f"{n_groups} groups: {fwd_launches}")
    require(all(bool(torch.isfinite(getattr(out, k)).all())
                for k in ("image", "transmittance", "opacity", "depth")),
            "grid planes not finite")
    require(float(out.opacity.max()) > 0.0, "grid opacity is 0 everywhere")
    e2e_err, e2e_depth, hit_ok = image_errors(out, plain)
    print(f"render_hash_grid_tiled: launches {fwd_launches}; vs plain path "
          f"planes {e2e_err:.3e}, depth {e2e_depth:.3e}, hitmask equal "
          f"{hit_ok}; opacity max {float(out.opacity.max()):.6f} mean "
          f"{float(out.opacity.mean()):.6f}", flush=True)
    require(e2e_err <= TOL and e2e_depth <= TOL_DEPTH and hit_ok,
            "the grid forward differs from the plain path")
    s_plan, s_field = grid_small_scene(torch, P, dev)
    _, s_cpu = grid_small_scene(torch, P, "cpu")
    with torch.no_grad():
        s_out = hash_tiled.render_hash_grid_tiled(
            s_plan, s_field,
            hash_tiled.build_hash_grid_schedule(s_plan, s_field, device=dev))
        s_ref = hash_tiled.render_hash_grid_tiled(
            s_plan, s_cpu,
            hash_tiled.build_hash_grid_schedule(s_plan, s_cpu,
                                                device="cpu"))
    s_err, s_depth, s_hit = image_errors(s_out, s_ref)
    print(f"small grid scene, card vs CPU plain: planes {s_err:.3e}, depth "
          f"{s_depth:.3e}", flush=True)
    require(s_err <= TOL and s_depth <= TOL_DEPTH and s_hit,
            "small grid scene on the card differs from the CPU")

    # 18. K8b against its twin on every tile; deterministic backwards
    gen = torch.Generator(device=dev).manual_seed(9)
    gs = torch.randn((sched.tiles.n_tiles, 5, 16, 16), generator=gen,
                     device=dev)
    k8b_plain_ms = None
    for name, params in (("student", student_p), ("opaque teacher", opaque_p)):
        _, a = kernel_args(params)
        c = cmp[name]
        d_rows, d_sc = hash_grid.hash_grid_backward_tiles(*a[:3], gs, a[3])
        again = hash_grid.hash_grid_backward_tiles(*a[:3], gs, a[3])
        torch.cuda.synchronize()
        (p_rows, p_sc), ms = timed_once(
            torch, lambda: hash_grid.hash_grid_backward_tiles_plain(
                *a[:3], gs, a[3]))
        if name == "student":
            k8b_plain_ms = ms
        require(bool(torch.isfinite(d_rows).all()
                     and torch.isfinite(d_sc).all()), "K8b not finite")
        require(torch.equal(again[0], d_rows) and torch.equal(again[1], d_sc),
                f"K8b differs between two runs ({name})")
        c["rows"] = rel_err(d_rows, p_rows)
        c["mlp"] = rel_err(d_sc, p_sc)
        c["b_raw"] = max(float((d_rows - p_rows).abs().max()),
                         float((d_sc - p_sc).abs().max()))
        print(f"K8b (one launch) vs plain on all {gs.shape[0]} tiles, {name}: "
              f"slot rows {c['rows']:.3e} x scale, d(MLP) {c['mlp']:.3e} x "
              f"scale (max |diff| {c['b_raw']:.3e}); repeat equal",
              flush=True)
        require(c["rows"] <= HASH_GRAD_TOL and c["mlp"] <= HASH_GRAD_TOL,
                f"K8b differs from its plain twin beyond tolerance ({name})")

    dl_img = torch.randn((plan.height, plan.width, 3), generator=gen,
                         device=dev)
    keys = sorted(field.params)

    def frame_grads():
        leaf = field.with_params({k: v.detach().clone()
                                  for k, v in field.params.items()})
        img = hash_tiled.render_hash_grid_tiled(plan, leaf, sched).image
        return torch.autograd.grad(torch.sum(img * dl_img),
                                   [leaf.params[k] for k in keys])

    torch.use_deterministic_algorithms(True)
    try:
        g1, g2 = frame_grads(), frame_grads()
    finally:
        torch.use_deterministic_algorithms(False)
    require(all(bool(torch.isfinite(x).all()) for x in g1),
            "grid gradients not finite")
    require(all(torch.equal(a, b) for a, b in zip(g1, g2)),
            "two grid backwards differ")
    require(float(g1[keys.index("hash_table")].abs().max()) > 0.0,
            "d(hash_table) is 0")
    print("two full-frame grid backwards under deterministic algorithms: "
          "equal bit for bit, d(hash_table) included", flush=True)

    # 19. Adam steps through autograd of render_hash_grid_tiled
    with torch.no_grad():
        target = hash_tiled.render_hash_grid_tiled(plan, teacher, sched).image
    student = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                         spec=spec, device=dev)

    def trainer(f, use_kernel=True):
        opt = torch.optim.Adam(f.parameters(), lr=8e-3)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = mse(hash_tiled.render_hash_grid_tiled(
                plan, f, sched, use_kernel=use_kernel).image, target)
            loss.backward()
            opt.step()
            return loss

        return step

    step = trainer(student)
    graph.reset_launch_counts()
    losses = []
    for _ in range(GRID_STEPS):
        before = counts_of(GRID)
        losses.append(float(step().detach()))
        after = counts_of(GRID)
        require(all(after[k] - before[k] == 1 for k in after),
                f"K8f / K8b did not launch once in a step: {before} -> "
                f"{after}")
    train_launches = counts_of(GRID)
    print(f"{GRID_STEPS} Adam steps (lr 8e-3) toward the teacher: loss "
          f"{losses[0]:.6e} -> {losses[-1]:.6e}; launches {train_launches}: "
          f"K8f and K8b once per step each over the {n_groups} groups",
          flush=True)
    require(all(np.isfinite(losses)), "grid training loss not finite")
    require(losses[-1] < losses[0], "grid training loss does not fall")

    # 20. times; peak device memory above what is held before each
    def added_peak_mb(base):
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 20

    def peak_from_here():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    base = peak_from_here()
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: hash_tiled.render_hash_grid_tiled(
            plan, field, sched), FRAMES, warmup=3)
        fwd_peak = added_peak_mb(base)
        plain_fwd_ms = cuda_ms(
            torch, lambda: hash_tiled.render_hash_grid_tiled(
                plan, field, sched, use_kernel=False), 1, warmup=0)
    table, a = kernel_args(student_p)
    table_ms = cuda_ms(torch, lambda: hash_grid.build_hash_grid_table(
        student_p, spec), 50)
    gather_ms = cuda_ms(torch, lambda: tiled._gather_banks_flat(
        table, sched.gathermap_all), 20)
    k8f_ms = cuda_ms(torch, lambda: hash_grid.hash_grid_forward_tiles(*a),
                     20)
    k8f_plain_ms = cuda_ms(
        torch, lambda: hash_grid.hash_grid_forward_tiles_plain(*a), 1,
        warmup=0)
    base = peak_from_here()
    k8b_ms = cuda_ms(torch, lambda: hash_grid.hash_grid_backward_tiles(
        *a[:3], gs, a[3]), 5, warmup=1)
    k8b_peak = added_peak_mb(base)
    rows, d_sc = hash_grid.hash_grid_backward_tiles(*a[:3], gs, a[3])
    n_rows = int(table.shape[0])
    reduce_ms = cuda_ms(torch, lambda: gather_plan.slot_rows_to_table(
        rows, sched.gather_plan, n_rows), 20)
    tg = gather_plan.slot_rows_to_table(rows, sched.gather_plan, n_rows)
    adjoint_ms = cuda_ms(torch, lambda: hash_grid.hash_grid_table_grad(
        tg, spec), 20)
    base = peak_from_here()
    step_ms = cuda_ms(torch, step, STEPS, warmup=2)
    step_peak = added_peak_mb(base)
    plain_student = student.with_params({k: v.detach().clone()
                                         for k, v in student.params.items()})
    plain_step_ms = cuda_ms(torch, trainer(plain_student, use_kernel=False),
                            1, warmup=0)
    n_rays = plan.ray_count
    print(f"grid forward {fwd_ms:.4f} ms/frame = {n_rays / fwd_ms / 1e3:.3f} "
          f"Mrays/s over {FRAMES} frames (plain path {plain_fwd_ms:.4f} ms); "
          f"training step {step_ms:.4f} ms/step = "
          f"{n_rays / step_ms / 1e3:.3f} Mrays/s over {STEPS} steps (plain "
          f"path {plain_step_ms:.4f} ms/step)", flush=True)
    print(f"grid stages ms: table build {table_ms:.4f}, bank gather "
          f"{gather_ms:.4f}, K8f {k8f_ms:.4f} in 1 launch over {n_groups} "
          f"groups (plain {k8f_plain_ms:.4f}), K8b {k8b_ms:.4f} in 1 launch "
          f"(plain {k8b_plain_ms:.4f}), slot reduction {reduce_ms:.4f}, "
          f"table adjoint {adjoint_ms:.4f}; peak device memory added: "
          f"forward {fwd_peak:.1f} MiB, K8b {k8b_peak:.1f} MiB, step "
          f"{step_peak:.1f} MiB", flush=True)

    live = sched.tiled_samples
    f_in = nbytes(a[0], a[1].samp, a[1].base, a[1].rayt, a[1].ke,
                  a[1].bank0, a[2])
    f_out = a[1].n_tiles * 5 * 256 * 4
    b_bytes = f_in + nbytes(gs) + nbytes(rows) + nbytes(d_sc)
    kernels = [
        {"name": "hash_grid", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/hash_grid.cu",
         "replaces": "dvren_tpu/ops/hash_grid.py:223",
         "launches": train_launches["hash_grid"],
         "max_abs_err": max(c["f_raw"] for c in cmp.values()),
         "ms": k8f_ms, "plain_ms": k8f_plain_ms,
         **bound(f_in + f_out, live * k8f_ops(spec))},
        {"name": "hash_grid_bwd", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/hash_grid_bwd.cu",
         "replaces": "dvren_tpu/ops/hash_grid.py:282",
         "launches": train_launches["hash_grid_bwd"],
         "max_abs_err": max(c["b_raw"] for c in cmp.values()),
         "ms": k8b_ms, "plain_ms": k8b_plain_ms,
         **bound(b_bytes, live * k8b_ops(spec))},
    ]
    report = {
        "schedule_build_s": build_s, "schedule_upload_s": upload_s,
        "forward_ms": fwd_ms, "forward_mrays_s": n_rays / fwd_ms / 1e3,
        "plain_forward_ms": plain_fwd_ms, "forward_vs_plain": e2e_err,
        "stages_ms": {"table_build": table_ms, "bank_gather": gather_ms,
                      "hash_grid": k8f_ms, "hash_grid_bwd": k8b_ms,
                      "slot_reduction": reduce_ms,
                      "table_adjoint": adjoint_ms},
        "plain_stages_ms": {"hash_grid": k8f_plain_ms,
                            "hash_grid_bwd": k8b_plain_ms},
        "step_ms": step_ms, "plain_step_ms": plain_step_ms,
        "step_mrays_s": n_rays / step_ms / 1e3,
        "launches_per_step": {k: v / GRID_STEPS
                              for k, v in train_launches.items()},
        "occupancy": occ, "occupancy_enc64": occ_edge,
        "added_peak_mib": {"forward": fwd_peak, "hash_grid_bwd": k8b_peak,
                           "step": step_peak},
        "losses": losses, "compares": cmp}
    return kernels, report


SUBSET = 8          # tiles per group the sub-tile phases hold to the twins
FIT_VIEWS = 8       # tools/fit_benchmark.py's flagship: 8 views, 96^2, 64^3
FIT_ADAM_STEPS = 10
FIT_LR = 5e-2       # tools/fit_benchmark.py's Adam rate


def flagship_views(P, views=FIT_VIEWS, res=96, grid=64, mode="FIXED"):
    """tools/fit_benchmark.py:58-82 rebuilt in numpy: the truth field (a
    64^3 Gaussian blob), the 96^2 plan (96 fixed steps; ``mode=
    "STRATIFIED"``: 96 stratified steps, the headline's seed 3) and its
    per-view plans on a translation orbit."""
    import math

    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, grid)] * 3), indexing="ij")
    r2 = (xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
    sigma = (10.0 * np.exp(-r2 / 0.06)).astype(np.float32)
    color = np.stack([xs, ys, 1 - zs], axis=-1).astype(np.float32)
    config = P.DenseGridConfig(resolution=(grid,) * 3,
                               sigma=sigma.reshape(-1),
                               color=color.reshape(-1))
    plan = P.Plan.create(P.PlanConfig(
        width=res, height=res, t_near=0.2, t_far=2.2,
        seed=3 if mode == "STRATIFIED" else 0,
        camera=P.CameraConfig(k=(res * 1.2, 0, res / 2, 0, res * 1.2,
                                 res / 2, 0, 0, 1)),
        sampling=P.SamplingConfig(dt=2.0 / 96, max_steps=96,
                                  mode=getattr(P.SamplingMode, mode))))
    cams = []
    for i in range(views):
        ang = 2 * math.pi * i / views
        cams.append(P.CameraConfig(c2w=(
            1, 0, 0, 0.5 + 0.25 * math.sin(ang),
            0, 1, 0, 0.5 + 0.15 * math.cos(ang),
            0, 0, 1, -1.0)))
    from dvren_tpu_torch.opt.fit import view_plans
    return view_plans(plan, cams), config


def schedule_line(sched, build_s) -> str:
    return (f"(tile_px, cell_scale) = ({sched.tile_px}, {sched.cell_scale}), "
            f"{len(sched.groups)} groups, "
            f"{sum(g.n_tiles for g in sched.groups)} tiles, banks <= "
            f"{max(g.banks for g in sched.groups)}, {sched.tiled_samples} "
            f"live samples, fallback rays {sched.fallback_rays}, build "
            f"{build_s:.3f} s")


def build_ms(notes) -> float:
    for n in notes:
        if n.startswith("tiled_schedule_build_ms="):
            return float(n.split("=", 1)[1])
    return float("nan")


def variant_args(torch, plan, field, sched):
    """K1's one-launch arguments over ``sched`` on the card: (flat bank
    tables, the schedule's tile set, the launch's TileParams), the bank
    tables from the field's table (the supercell table for cell_scale 2,
    else the field's float32 or 16-bit rows)."""
    from dvren_tpu_torch.ops import fused_tiles, packed_transpose
    from dvren_tpu_torch.ops.grid import build_supercell_stencil, table_dtype
    from dvren_tpu_torch.render import tiled

    sigma, color = field.sigma.detach(), field.color.detach()
    if sched.cell_scale == 2:
        table = build_supercell_stencil(sigma, color)
    elif field.packed_dtype == "float32":
        table = packed_transpose.build_rows(sigma, color)
    else:
        table = packed_transpose.build_rows16(
            sigma, color, table_dtype(field.packed_dtype))
    tabs = tiled._gather_banks_flat(table, sched.gathermap_all, sched.pitch)
    geom = (sched.bbox[0], sched.bbox[1], sched.grid_shape)
    stencil = "super" if sched.cell_scale == 2 else "cell"
    return (tabs, sched.tiles,
            fused_tiles.tiles_op_params(plan, geom, sched.tiles, stencil))


def subset_args(torch, a, n_tiles):
    """The first ``n_tiles`` tiles of every group of a one-launch call's
    arguments, as a tile set of their own."""
    from types import SimpleNamespace

    from dvren_tpu_torch.ops import fused_tiles

    tabs, tiles, prm = a
    groups, parts = [], []
    for (n, nc, nb), (g_tabs, samp, base, rayt, ke, bank0) in zip(
            tiles.shapes, tiles.group_views(tabs)):
        t = min(n_tiles, n)
        groups.append(SimpleNamespace(
            n_tiles=t, n_chunks=nc, banks=nb, samp=samp[:t], base=base[:t],
            rayt=rayt[:t], k_enter=ke[:t],
            bank0=bank0[:t * nc * tiles.subs]))
        parts.append(g_tabs[:t].reshape((-1,) + tuple(tabs.shape[1:])))
    return (torch.cat(parts).contiguous(),
            fused_tiles.tile_set(groups, tiles.subs), prm)


def twin64(torch, a, gs):
    """K2's plain twin summing in float64 (slot rows, d(rayt))."""
    import dataclasses as dc

    from dvren_tpu_torch.ops import fused_tiles

    tabs, tiles, prm = a
    t64 = dc.replace(tiles, base=tiles.base.double(),
                     rayt=tiles.rayt.double())
    return fused_tiles.tile_backward_set_plain(tabs.double(), t64,
                                               gs.double(), prm, cam=True)


def twins_bit_equal(torch, args, gen, n_tiles=None, f64_first=None):
    """K1 and K2 (with the camera adjoint), one launch per schedule of
    ``args`` (the first ``n_tiles`` tiles of every group, when given),
    against their twins run group by group: heads, slot rows and d(rayt)
    equal bit for bit, K2's repeat too; and K2's distance from its
    float64 twin (printed: float32 sums in the twin's order, not held to a
    bound) on every schedule, or on the first ``f64_first``. Returns the
    largest |kernel - twin| (0.0) over K1 and over K2."""
    from dvren_tpu_torch.ops import fused_tiles

    k1_err = k2_err = 0.0
    for i, a in enumerate(args):
        if n_tiles is not None:
            a = subset_args(torch, a, n_tiles)
        tabs, tiles, prm = a
        out = fused_tiles.tile_forward(tabs, tiles, prm)
        gs = torch.randn((tiles.n_tiles, 5, 16, 16), generator=gen,
                         device=tabs.device)
        rows, d_rayt = fused_tiles.tile_backward(tabs, tiles, gs, prm,
                                                 cam=True)
        rows2, d_rayt2 = fused_tiles.tile_backward(tabs, tiles, gs, prm,
                                                   cam=True)
        torch.cuda.synchronize()
        p_out = fused_tiles.tile_forward_set_plain(tabs, tiles, prm)
        p_rows, p_rayt = fused_tiles.tile_backward_set_plain(
            tabs, tiles, gs, prm, cam=True)
        require(bool(torch.isfinite(out).all() and torch.isfinite(rows).all()),
                "K1 / K2 output not finite")
        k1_err = max(k1_err, float((out - p_out).abs().max()))
        k2_err = max(k2_err, float((rows - p_rows).abs().max()),
                     float((d_rayt - p_rayt).abs().max()))
        require(torch.equal(out, p_out),
                f"K1 ({prm.subs} sub-tiles, {prm.stencil}) differs from "
                f"its twin")
        require(torch.equal(rows, p_rows) and torch.equal(d_rayt, p_rayt),
                f"K2 ({prm.subs} sub-tiles, {prm.stencil}) differs from "
                f"its twin")
        require(torch.equal(rows2, rows) and torch.equal(d_rayt2, d_rayt),
                "K2 differs between two runs")
        if f64_first is not None and i >= f64_first:
            continue
        rows64, rayt64 = twin64(torch, a, gs)
        print(f"  K2 ({prm.subs} sub-tiles, {prm.stencil}) vs its float64 "
              f"twin: d(table) {rel_err(rows.double(), rows64):.3e}, d(rayt) "
              f"{rel_err(d_rayt.double(), rayt64):.3e} x scale", flush=True)
    return k1_err, k2_err


def variant_times(torch, args, gss):
    """(K1 ms, K2 ms, K1 twin ms, K2 twin ms) over every schedule of
    ``args``, one launch each: the kernels after warm-up, the twins
    (group by group) once."""
    from dvren_tpu_torch.ops import fused_tiles

    k1 = cuda_ms(torch, lambda: [fused_tiles.tile_forward(*a) for a in args],
                 10)
    k2 = cuda_ms(torch, lambda: [fused_tiles.tile_backward(
        a[0], a[1], gs, a[2]) for a, gs in zip(args, gss)], 10)
    k1p = cuda_ms(torch, lambda: [fused_tiles.tile_forward_set_plain(*a)
                                  for a in args], 1, warmup=0)
    k2p = cuda_ms(torch, lambda: [fused_tiles.tile_backward_set_plain(
        a[0], a[1], gs, a[2]) for a, gs in zip(args, gss)], 1, warmup=0)
    return k1, k2, k1p, k2p


def tile_gss(torch, args, gen):
    """A seeded cotangent (T, 5, 16, 16) of K1's output per schedule."""
    return [torch.randn((a[1].n_tiles, 5, 16, 16), generator=gen,
                        device=a[0].device) for a in args]


def tile_in_bytes(a) -> int:
    """The bytes K1 reads: bank tables, the tile set's arrays. (The
    benchmark's ``tile_counts.tile_inputs`` also counts the launch order,
    4 bytes a tile, which K1 and K2 read too.)"""
    tabs, tiles, _ = a
    return nbytes(tabs, tiles.samp, tiles.base, tiles.rayt, tiles.ke,
                  tiles.bank0, tiles.desc)


def variant_kernels(form, args, gss, sched, launches, errs, times) -> list:
    """The ``kernels`` entries of K1 and K2 in one form."""
    live = sched.tiled_samples
    extra = tile_counts.SUPER_OPS if sched.cell_scale == 2 else 0
    k1_in = sum(tile_in_bytes(a) for a in args)
    out = sum(a[1].n_tiles * 5 * 256 * 4 for a in args)
    rows = sum(a[1].n_bank_rows * 128 * a[2].cols * 4 for a in args)
    return [
        {"name": f"fused_tiles:{form}", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:656",
         "launches": launches[0], "max_abs_err": errs[0],
         "ms": times[0], "plain_ms": times[2],
         **bound(k1_in + out, live * (tile_counts.FWD_OPS + extra))},
        {"name": f"fused_tiles_bwd:{form}", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles_bwd.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:714",
         "launches": launches[1], "max_abs_err": errs[1],
         "ms": times[1], "plain_ms": times[3],
         **bound(k1_in + sum(nbytes(g) for g in gss) + rows,
                 live * (tile_counts.BWD_OPS + extra))}]


def table16_128(torch, packed_transpose, field, gen, card, launches,
                report) -> list:
    """Phase 30's K5a and K5b at 128^3: the bfloat16 fine grid's field
    and a seeded table gradient, held to their twins as 16-bit / 32-bit
    words and timed on the device alone and as issued beside the twins
    and the transposes; their ``kernels`` entries, with the launches of
    the phase's frame and backward."""
    dt = getattr(torch, field.packed_dtype)
    sigma, color = field.sigma, field.color
    n_rows = packed_transpose.fullpitch_rows(sigma.shape)
    tg = torch.randn((n_rows, 32), generator=gen,
                     device=sigma.device).to(dt)
    table = packed_transpose.build_rows16(sigma, color, dt)
    grads = packed_transpose.table16_grad_to_params(tg, sigma.shape)
    torch.cuda.synchronize()
    require(torch.equal(table.view(torch.int16), packed_transpose
                        .build_rows16_plain(sigma, color, dt)
                        .view(torch.int16)),
            "K5a differs from its plain twin at 128^3")
    require(all(torch.equal(words(a), words(b)) for a, b in zip(
        grads, packed_transpose.table16_grad_to_params_plain(tg, sigma.shape))),
            "K5b differs from its plain twin at 128^3")
    k5a = packed_times(
        torch, lambda: packed_transpose.build_rows16(sigma, color, dt),
        lambda: packed_transpose.build_rows16_plain(sigma, color, dt))
    k5b = packed_times(
        torch, lambda: packed_transpose.table16_grad_to_params(tg, sigma.shape),
        lambda: packed_transpose.table16_grad_to_params_plain(tg,
                                                              sigma.shape))
    stack = packed_transpose._shift_stack_fullpitch(sigma, color,
                                                    n_rows).to(dt)
    lib_a = device_ms(torch, lambda: stack.t().contiguous(), 50)
    del stack
    rows32 = tg.float()
    lib_b = device_ms(torch, lambda: rows32.t().contiguous(), 50)
    del rows32
    print(f"K5a and K5b == plain at 128^3 ({dt}), as 16-bit / 32-bit words; "
          f"ms [{card}]: K5a {k5a[0]:.4f} on the device, {k5a[1]:.4f} as "
          f"issued (plain {k5a[2]:.4f}, stack.t().contiguous() {lib_a:.4f}); "
          f"K5b {k5b[0]:.4f}, {k5b[1]:.4f} (plain {k5b[2]:.4f}, "
          f"rows.t().contiguous() {lib_b:.4f}); launches: frame "
          f"{launches[0]} K5a, backward {launches[1]} K5b", flush=True)
    report["packed16_128"] = {"k5a": k5a, "k5b": k5b,
                              "library": [lib_a, lib_b]}
    return [{"name": f"{name}:128", "route": "cuda",
             "source": f"dvren_tpu_torch/csrc/{src}",
             "replaces": f"dvren_tpu/ops/packed_transpose.py:{line}",
             "launches": n, "max_abs_err": 0.0, "ms": ms,
             "issued_ms": issued, "plain_ms": plain_ms,
             **bound(n_bytes, ops), "library_ms": lib}
            for name, src, line, (ms, issued, plain_ms), n, n_bytes, ops, lib
            in (("packed_table16", "packed_table.cu", 40, k5a, launches[0],
                 nbytes(sigma, color, table), 0, lib_a),
                ("packed_table16_bwd", "packed_table_bwd.cu", 63, k5b,
                 launches[1], nbytes(tg, *grads),
                 8 * sum(x.numel() for x in grads), lib_b))]


def run_subtiles(torch, P, dev, card,
                 fine_only: bool = False) -> tuple[list, dict]:
    """Phases 28-33: the sub-tiled and supercell schedules of the cascade,
    with K1 and K2 in their subs 4 / 16 and supercell forms: the fine-grid
    scene (float32: 16 px supercells; bfloat16: 8 px cells, with K5a and
    K5b at 128^3), the fit flagship's eight views (8 px supercells) and
    its view 0 at 4 px; ``fine_only``: phases 28-30 alone."""
    from dvren_tpu_torch.ops import packed_transpose
    from dvren_tpu_torch.opt.fit import mse
    from dvren_tpu_torch.render import graph, tiled

    counts = functools.partial(counts_of, DENSE)
    reset = graph.reset_launch_counts
    gen = torch.Generator(device=dev).manual_seed(28)
    kernels, report = [], {}
    t_phase = time.perf_counter()

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        report.setdefault("phase_s", {})[name] = now - t_phase
        t_phase = now

    def sgd_steps(plan, field_t, sched, lr):
        target = torch.zeros((plan.height, plan.width, 3), device=dev)
        opt = torch.optim.SGD(field_t.parameters(), lr=lr)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = mse(tiled.render_tiled(plan, field_t, sched).image, target)
            loss.backward()
            opt.step()
            return loss

        return step

    def fine_phase(name, dtype, want_note):
        # 28 / 30. the fine-grid scene through Renderer.forward's cascade
        plan, config = headline_scene(P, grid_n=128, max_steps=256)
        field = P.DenseGridField.create(config, device=dev).with_packed_dtype(
            dtype).requires_grad_(False)
        renderer = P.Renderer(P.Context.create(device="cuda"), plan)
        reset()
        res = renderer.forward(field)
        c = counts()
        sched = renderer._tiled_schedule
        build_s = build_ms(res.stats.notes) / 1e3
        print(f"fine-grid {name} Renderer.forward: {res.stats.total_ms:.3f} "
              f"ms (schedule included), launches {c}; "
              f"{schedule_line(sched, build_s)}; notes {res.stats.notes}",
              flush=True)
        require(want_note in res.stats.notes and sched.fallback_rays == 0,
                f"the fine-grid {name} cascade did not land on {want_note}")
        require(c["fused_tiles"] == 1 and c["packed_table"] == 0
                and c["packed_table16"] == (0 if dtype == "float32" else 1),
                f"the fine-grid {name} forward launched {c}")
        for key in ("image", "transmittance", "opacity", "depth"):
            require(bool(np.isfinite(getattr(res, key)).all()),
                    f"fine-grid {key} not finite")
        require(float(res.opacity.max()) > 0.0, "opacity is 0 everywhere")
        with torch.no_grad():
            t0 = time.perf_counter()
            plain = tiled.render_tiled(plan, field, sched, use_kernel=False)
            torch.cuda.synchronize()
            plain_frame_s = time.perf_counter() - t0
        err, depth, hit = planes_errors(res, plain)
        print(f"fine-grid {name} forward vs plain path: planes {err:.3e}, "
              f"depth {depth:.3e}, hitmask equal {hit} (plain frame "
              f"{plain_frame_s:.2f} s)", flush=True)
        require(err <= TOL and depth <= TOL_DEPTH and hit,
                f"the fine-grid {name} frame differs from the plain path")

        # 29 / 30. K1 and K2 in this form against their twins, first SUBSET
        # tiles of every group; backward deterministic; SGD steps
        args = [variant_args(torch, plan, field, sched)]
        errs = twins_bit_equal(torch, args, gen, SUBSET)
        print(f"fine-grid {name}: K1 and K2 == twins bit for bit on the "
              f"first {SUBSET} tiles of all {len(sched.groups)} groups, one "
              f"launch; repeats equal", flush=True)
        dl = (torch.rand((plan.ray_count, 3), generator=gen, device=dev) * 2
              - 1).cpu().numpy()
        torch.use_deterministic_algorithms(True)
        try:
            reset()
            g1 = renderer.backward(field, dl)
            bwd_c = counts()
            g2 = renderer.backward(field, dl)
        finally:
            torch.use_deterministic_algorithms(False)
        if dtype != "float32":
            require(bwd_c["packed_table16"] == 1
                    and bwd_c["packed_table16_bwd"] == 1,
                    f"the fine-grid {name} backward launched {bwd_c}")
        for key in ("sigma", "color", "camera", "camera_k"):
            x = getattr(g1, key)
            require(bool(np.isfinite(x).all()) and float(np.abs(x).max()) > 0,
                    f"fine-grid backward {key} not finite or zero")
            require(np.array_equal(x, getattr(g2, key)),
                    f"fine-grid backward {key} differs between two calls")
        n_values = plan.height * plan.width * 3
        step = sgd_steps(plan, P.DenseGridField.create(
            config, device=dev).with_packed_dtype(dtype), sched,
            LR * n_values)
        reset()
        losses = [float(step().detach()) for _ in range(4)]
        step_c = counts()
        print(f"fine-grid {name}: 4 SGD steps at lr {LR} x {n_values}: loss "
              f"{losses}; launches {step_c}; two deterministic backwards "
              f"equal", flush=True)
        require(all(np.isfinite(losses))
                and all(b < a for a, b in zip(losses, losses[1:])),
                f"the fine-grid {name} loss does not fall")
        require(step_c["fused_tiles_bwd"] == 4,
                "K2 did not launch once in every step")
        if dtype != "float32":
            require(step_c["packed_table16"] == 4
                    and step_c["packed_table16_bwd"] == 4,
                    "K5a and K5b did not launch once in every step")

        # times
        with torch.no_grad():
            frame_ms = cuda_ms(torch, lambda: tiled.render_tiled(
                plan, field, sched), 10, warmup=2)
        step_ms = cuda_ms(torch, sgd_steps(plan, P.DenseGridField.create(
            config, device=dev).with_packed_dtype(dtype), sched, LR), 5,
            warmup=1)
        gss = tile_gss(torch, args, gen)
        times = variant_times(torch, args, gss)
        print(f"fine-grid {name} times ms [{card}]: frame {frame_ms:.4f} = "
              f"{plan.ray_count / frame_ms / 1e3:.3f} Mrays/s, SGD step "
              f"{step_ms:.4f}; K1 {times[0]:.4f} over {len(args)} launches "
              f"(plain {times[2]:.4f}), K2 {times[1]:.4f} (plain "
              f"{times[3]:.4f})", flush=True)
        form = (f"supercell_{sched.tile_px}px" if sched.cell_scale == 2
                else f"subtiled_{sched.tile_px}px")
        kernels.extend(variant_kernels(
            form, args, gss, sched, (c["fused_tiles"],
                                     step_c["fused_tiles_bwd"]), errs, times))
        if dtype != "float32":
            kernels.extend(table16_128(torch, packed_transpose, field, gen,
                                       card, (c["packed_table16"],
                                              bwd_c["packed_table16_bwd"]),
                                       report))
        report[f"finegrid_{name}"] = {
            "tile_px": sched.tile_px, "cell_scale": sched.cell_scale,
            "groups": len(sched.groups),
            "banks_max": max(g.banks for g in sched.groups),
            "live_samples": sched.tiled_samples, "build_s": build_s,
            "frame_ms": frame_ms, "step_ms": step_ms, "k1_ms": times[0],
            "k2_ms": times[1], "k1_plain_ms": times[2],
            "k2_plain_ms": times[3], "plain_frame_s": plain_frame_s,
            "vs_plain": err, "losses": losses}

    fine_phase("float32", "float32", "tiled_supercell_16px")
    lap("28-29")
    fine_phase("bfloat16", "bfloat16", "tiled_subtiled_8px")
    lap("30")
    if fine_only:
        return kernels, report

    # 31-32. the fit flagship: each view through the cascade, Adam steps
    # on the summed loss of the eight views, camera gradients on view 0
    plans, config = flagship_views(P)
    truth = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    scheds, targets, notes, builds = [], [], [], []
    t0 = time.perf_counter()
    reset()
    for pv in plans:
        r = P.Renderer(P.Context.create(device="cuda"), pv)
        res = r.forward(truth)
        scheds.append(r._tiled_schedule)
        builds.append(build_ms(res.stats.notes) / 1e3)
        notes.append([n for n in res.stats.notes if n.startswith("tiled_")
                      and "=" not in n])
        with torch.no_grad():
            targets.append(tiled.render_tiled(pv, truth, scheds[-1]).image)
    fwd_c = counts()
    fit_build_s = time.perf_counter() - t0
    n_groups = sum(len(s.groups) for s in scheds)
    print(f"fit flagship: {len(plans)} views through the cascade in "
          f"{fit_build_s:.3f} s (schedules and two frames each), notes "
          f"{notes}; launches {fwd_c}", flush=True)
    for v, (s, b) in enumerate(zip(scheds, builds)):
        print(f"  view {v}: {schedule_line(s, b)}", flush=True)
    require(all(s.tile_px == 8 and s.cell_scale == 2 and s.fallback_rays == 0
                for s in scheds),
            "a flagship view did not land on 8 px supercells without overflow")
    require(fwd_c["fused_tiles"] == 2 * len(plans)
            and fwd_c["packed_table"] == 0,
            f"the flagship forwards launched {fwd_c}")
    fit_args = [variant_args(torch, pv, truth, s)
                for pv, s in zip(plans, scheds)]
    fit_errs = twins_bit_equal(torch, fit_args, gen, f64_first=1)
    print(f"fit flagship: K1 and K2 (8 px supercells) == twins bit for bit "
          f"on all {n_groups} groups of the {len(plans)} views, one launch "
          f"per view (K2's float64 twin on view 0)", flush=True)

    student = P.DenseGridField.create(dataclasses.replace(
        config, sigma=np.full(len(config.sigma), 0.5, np.float32),
        color=np.full(len(config.color), 0.5, np.float32)), device=dev)
    opt = torch.optim.Adam(student.parameters(), lr=FIT_LR)

    def fit_step():
        opt.zero_grad(set_to_none=True)
        loss = sum(mse(tiled.render_tiled(pv, student, s).image, tg)
                   for pv, s, tg in zip(plans, scheds, targets))
        loss.backward()
        opt.step()
        return loss

    reset()
    fit_losses = [float(fit_step().detach()) for _ in range(FIT_ADAM_STEPS)]
    fit_c = counts()
    print(f"fit flagship: {FIT_ADAM_STEPS} Adam steps (lr {FIT_LR}) on the "
          f"summed loss of {len(plans)} views: loss {fit_losses}; launches "
          f"{fit_c}", flush=True)
    require(all(np.isfinite(fit_losses)) and fit_losses[-1] < fit_losses[0],
            "the flagship fit loss does not fall")
    require(fit_c["fused_tiles"] == FIT_ADAM_STEPS * len(plans)
            and fit_c["fused_tiles_bwd"] == FIT_ADAM_STEPS * len(plans),
            f"the fit steps launched {fit_c}")
    fit_step_ms = cuda_ms(torch, fit_step, 5, warmup=1)

    def view0_grads(use_kernel, sched0):
        from dvren_tpu_torch.ops.raygen import camera_arrays

        k, c2w, _ = camera_arrays(plans[0], dev)
        k.requires_grad_(True)
        c2w.requires_grad_(True)
        leaf = student.with_params(student.sigma.detach().clone(),
                                   student.color.detach().clone())
        img = tiled.render_tiled(plans[0], leaf, sched0,
                                 use_kernel=use_kernel, k=k, c2w=c2w).image
        dl0 = torch.linspace(-1, 1, img.numel(), device=dev).reshape(img.shape)
        return torch.autograd.grad(torch.sum(img * dl0),
                                   (leaf.sigma, leaf.color, c2w, k))

    torch.use_deterministic_algorithms(True)
    try:
        cam_k = view0_grads(True, scheds[0])
        cam_k2 = view0_grads(True, scheds[0])
    finally:
        torch.use_deterministic_algorithms(False)
    cam_p = view0_grads(False, scheds[0])
    require(all(torch.equal(a, b) for a, b in zip(cam_k, cam_k2)),
            "view 0's gradients differ between two runs")
    require(float(cam_k[2].abs().max()) > 0.0, "view 0's d(c2w) is zero")
    cam_ok = all(torch.allclose(a, b, rtol=CAM_RTOL, atol=CAM_ATOL)
                 for a, b in zip(cam_k[2:], cam_p[2:]))
    grid_err = max(rel_err(a, b) for a, b in zip(cam_k[:2], cam_p[:2]))
    print(f"fit flagship view 0 camera gradients: d(c2w) max "
          f"{float(cam_k[2].abs().max()):.4e}, vs plain path "
          f"{float((cam_k[2] - cam_p[2]).abs().max()):.3e}; grids "
          f"{grid_err:.3e} x scale; two runs equal", flush=True)
    require(cam_ok and grid_err <= GRID_TOL,
            "view 0's gradients differ from the plain path")
    fit_gss = tile_gss(torch, fit_args, gen)
    fit_times = variant_times(torch, fit_args, fit_gss)
    with torch.no_grad():
        fit_frames_ms = cuda_ms(torch, lambda: [tiled.render_tiled(
            pv, student, s) for pv, s in zip(plans, scheds)], 10)
    print(f"fit flagship times ms [{card}]: {len(plans)} frames "
          f"{fit_frames_ms:.4f}, Adam step {fit_step_ms:.4f}; K1 "
          f"{fit_times[0]:.4f} over {len(fit_args)} launches (plain "
          f"{fit_times[2]:.4f}), K2 {fit_times[1]:.4f} (plain "
          f"{fit_times[3]:.4f})", flush=True)
    live = sum(s.tiled_samples for s in scheds)
    merged = dataclasses.replace(scheds[0], tiled_samples=live)
    kernels.extend(variant_kernels(
        "supercell_8px", fit_args, fit_gss, merged,
        (fit_c["fused_tiles"], fit_c["fused_tiles_bwd"]), fit_errs, fit_times))

    lap("31-32")

    # 33. view 0 at 4 px: frame and backward
    t0 = time.perf_counter()
    s4 = tiled.build_tiled_schedule(plans[0], student, tile_px=4).to(dev)
    s4_s = time.perf_counter() - t0
    print(f"fit view 0 at 4 px: {schedule_line(s4, s4_s)}", flush=True)
    require(s4.fallback_rays == 0, "view 0 overflows at 4 px")
    reset()
    with torch.no_grad():
        f4 = tiled.render_tiled(plans[0], student, s4)
    leaf = student.with_params(student.sigma.detach().clone(),
                               student.color.detach().clone())
    img4 = tiled.render_tiled(plans[0], leaf, s4).image
    g4 = torch.autograd.grad(mse(img4, targets[0]), (leaf.sigma, leaf.color))
    c4 = counts()
    print(f"fit view 0 at 4 px: frame and backward launches {c4}", flush=True)
    require(c4["fused_tiles"] == 2 and c4["fused_tiles_bwd"] == 1
            and c4["packed_table"] == 2 and c4["packed_table_bwd"] == 1,
            f"the 4 px frame and backward launched {c4}")
    with torch.no_grad():
        p4 = tiled.render_tiled(plans[0], student, s4, use_kernel=False)
    plain_leaf = student.with_params(student.sigma.detach().clone(),
                                     student.color.detach().clone())
    pg4 = torch.autograd.grad(
        mse(tiled.render_tiled(plans[0], plain_leaf, s4,
                               use_kernel=False).image, targets[0]),
        (plain_leaf.sigma, plain_leaf.color))
    e4 = max(float((getattr(f4, k) - getattr(p4, k)).abs().max())
             for k in ("image", "transmittance", "opacity"))
    ge4 = max(rel_err(a, b) for a, b in zip(g4, pg4))
    vs8 = float((f4.image - tiled.render_tiled(plans[0], student,
                                               scheds[0]).image.detach())
                .abs().max())
    print(f"fit view 0 at 4 px vs plain path: planes {e4:.3e}, grids "
          f"{ge4:.3e} x scale; vs the 8 px supercell frame {vs8:.3e}",
          flush=True)
    require(e4 <= TOL and ge4 <= GRID_TOL,
            "the 4 px frame or backward differs from the plain path")
    require(vs8 == 0.0, "the 4 px frame differs from the 8 px supercell one")
    args4 = [variant_args(torch, plans[0], student, s4)]
    errs4 = twins_bit_equal(torch, args4, gen)
    gss4 = tile_gss(torch, args4, gen)
    times4 = variant_times(torch, args4, gss4)
    with torch.no_grad():
        frame4_ms = cuda_ms(torch, lambda: tiled.render_tiled(
            plans[0], student, s4), 20)

    def bwd4():
        lf = student.with_params(student.sigma.detach().clone(),
                                 student.color.detach().clone())
        mse(tiled.render_tiled(plans[0], lf, s4).image,
            targets[0]).backward()

    torch.use_deterministic_algorithms(True)
    try:
        g4a = view0_grads(True, s4)
        g4b = view0_grads(True, s4)
    finally:
        torch.use_deterministic_algorithms(False)
    require(all(torch.equal(a, b) for a, b in zip(g4a, g4b)),
            "view 0's 4 px backward differs between two runs")
    bwd4_ms = cuda_ms(torch, bwd4, 10)
    print(f"fit view 0 at 4 px times ms [{card}]: frame {frame4_ms:.4f}, "
          f"forward + backward {bwd4_ms:.4f}; K1 {times4[0]:.4f} over "
          f"{len(args4)} launch (plain {times4[2]:.4f}), K2 "
          f"{times4[1]:.4f} (plain {times4[3]:.4f}); K1 and K2 == twins bit "
          f"for bit on all {len(s4.groups)} groups; two deterministic "
          f"backwards equal",
          flush=True)
    kernels.extend(variant_kernels(
        "subtiled_4px", args4, gss4, s4,
        (c4["fused_tiles"], c4["fused_tiles_bwd"]), errs4, times4))
    report["fit_flagship"] = {
        "views": len(plans), "notes": notes,
        "groups": [len(s.groups) for s in scheds],
        "banks_max": [max(g.banks for g in s.groups) for s in scheds],
        "live_samples": [s.tiled_samples for s in scheds],
        "cascade_and_frames_s": fit_build_s, "build_s": builds,
        "losses": fit_losses,
        "adam_step_ms": fit_step_ms, "frames_ms": fit_frames_ms,
        "k1_ms": fit_times[0], "k2_ms": fit_times[1],
        "k1_plain_ms": fit_times[2], "k2_plain_ms": fit_times[3],
        "view0_dc2w_vs_plain": float((cam_k[2] - cam_p[2]).abs().max()),
        "px4": {"groups": len(s4.groups), "build_s": s4_s,
                "frame_ms": frame4_ms, "fwd_bwd_ms": bwd4_ms,
                "k1_ms": times4[0], "k2_ms": times4[1],
                "k1_plain_ms": times4[2], "k2_plain_ms": times4[3]}}
    lap("33")
    print(f"phases 28-33 s: {report['phase_s']}", flush=True)
    return kernels, report


GRID_VIEW_LR = 8e-3      # the grid path's Adam rate (phase 19's)
GRID_VIEW_BANKS = 77     # the widest 4 px tile of the finest-64 views
FLAGSHIP_STEPS = 300     # fit_dense_grid's step cap at the flagship
FLAGSHIP_PSNR = 35.0     # tools/fit_benchmark.py's target
FLAGSHIP_SYNC = 32       # tools/fit_benchmark.py's sync_every


def grid_view_spec(finest: int) -> dict:
    """tools/hashmlp_bench.py's grid spec on a four-level ladder ending at
    ``finest`` (32: the spec as it is; 64: the finest grid_path_ok admits)."""
    res = tuple(finest >> (3 - i) for i in range(4))
    return dict(GRID_SPEC, resolutions=res, base_resolution=float(res[0]),
                finest_resolution=float(finest))


def run_grid_views(torch, P, dev, card, finest) -> tuple[list, dict]:
    """Phase 34 (finest 32: 8 px sub-tiles, K8 at subs 4) or 35 (finest 64:
    4 px, subs 16): the hash grid path over the fit flagship's eight 96^2
    views, each through ``build_hash_grid_schedule``'s cascade; K8f and
    K8b run once per view over all of its tile groups."""
    from dvren_tpu_torch.ops import hash_grid
    from dvren_tpu_torch.opt.fit import mse
    from dvren_tpu_torch.render import graph, hash_tiled

    want_px = {32: 8, 64: 4}[finest]
    subs = (16 // want_px) ** 2
    form = f"subs{subs}"
    name = f"grid views (finest {finest}, {want_px} px)"
    plans, _ = flagship_views(P)
    spec = P.HashMLPSpec(**grid_view_spec(finest))
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                       spec=spec, device=dev)
    field.requires_grad_(False)
    teacher = P.HashMLPField.init_random(torch.Generator().manual_seed(2),
                                         spec=spec, table_std=1.0, device=dev)
    teacher.requires_grad_(False)

    # the cascade, view by view; the gathered tables reckoned before K8f
    scheds, builds = [], []
    for pv in plans:
        t0 = time.perf_counter()
        host = hash_tiled.build_hash_grid_schedule(pv, field)
        builds.append(time.perf_counter() - t0)
        scheds.append(host.to(dev))
    for v, (s, b) in enumerate(zip(scheds, builds)):
        print(f"{name}, view {v}: {schedule_line(s, b)}", flush=True)
    require(all(s.tile_px == want_px and s.fallback_rays == 0 for s in scheds),
            f"a {name} schedule is not {want_px} px without overflow")
    banks = max(g.banks for s in scheds for g in s.groups)
    require(finest == 32 or banks <= GRID_VIEW_BANKS,
            f"a {name} tile holds {banks} banks")
    cols = hash_grid.packed_cols(spec)
    table_gb = [sum(g.n_tiles * g.banks for g in s.groups) * cols * 128 * 4
                / 1e9 for s in scheds]
    print(f"{name}: gathered bank tables {min(table_gb):.3f}-"
          f"{max(table_gb):.3f} GB per view ({cols} columns)", flush=True)
    n_groups = sum(len(s.groups) for s in scheds)
    occ = grid_occupancy(hash_grid, spec, subs, name)

    # K8f (one launch per view) against its twins on every group (bit for
    # bit), K8b on every tile (2e-5 x scale) and its repeat
    params = {k: v.detach() for k, v in field.params.items()}
    args = [grid_tiles_args(pv, spec, s, params)[1]
            for pv, s in zip(plans, scheds)]
    gen = torch.Generator(device=dev).manual_seed(finest)
    gss = [torch.randn((a[1].n_tiles, 5, 16, 16), generator=gen, device=dev)
           for a in args]
    # each twin runs once, timed: that run is both the reference of the
    # check and the kernels line's plain_ms
    outs = [hash_grid.hash_grid_forward_tiles(*a) for a in args]
    bwds = [hash_grid.hash_grid_backward_tiles(*a[:3], gs, a[3])
            for a, gs in zip(args, gss)]
    again = [hash_grid.hash_grid_backward_tiles(*a[:3], gs, a[3])
             for a, gs in zip(args, gss)]
    plains, k8f_plain_ms = timed_once(torch, lambda: [
        hash_grid.hash_grid_forward_tiles_plain(*a) for a in args])
    p_bwds, k8b_plain_ms = timed_once(torch, lambda: [
        hash_grid.hash_grid_backward_tiles_plain(*a[:3], gs, a[3])
        for a, gs in zip(args, gss)])
    f_err = b_rows = b_mlp = b_raw = 0.0
    for out, plain, (d_rows, d_sc), rep, (p_rows, p_sc) in zip(
            outs, plains, bwds, again, p_bwds):
        require(bool(torch.isfinite(out).all() and torch.isfinite(d_rows).all()
                     and torch.isfinite(d_sc).all()),
                f"K8f / K8b ({form}) not finite")
        f_err = max(f_err, float((out - plain).abs().max()))
        require(torch.equal(out, plain), f"K8f ({form}) differs from its twin")
        require(torch.equal(rep[0], d_rows) and torch.equal(rep[1], d_sc),
                f"K8b ({form}) differs between two runs")
        b_rows = max(b_rows, rel_err(d_rows, p_rows))
        b_mlp = max(b_mlp, rel_err(d_sc, p_sc))
        b_raw = max(b_raw, float((d_rows - p_rows).abs().max()),
                    float((d_sc - p_sc).abs().max()))
    del outs, plains, bwds, again, p_bwds
    print(f"{name}: K8f ({form}, one launch per view) == twin bit for bit on "
          f"all {n_groups} groups of the {len(plans)} views; K8b vs twin on "
          f"every tile: slot rows {b_rows:.3e}, d(MLP) {b_mlp:.3e} x scale "
          f"(max |diff| {b_raw:.3e}); repeats equal", flush=True)
    require(b_rows <= HASH_GRAD_TOL and b_mlp <= HASH_GRAD_TOL,
            f"K8b ({form}) differs from its twin beyond tolerance")

    # render_hash_grid_tiled against the plain path on view 0 (the twin
    # has matched K8f on every group above)
    with torch.no_grad():
        out = hash_tiled.render_hash_grid_tiled(plans[0], field, scheds[0])
        plain = hash_tiled.render_hash_grid_tiled(plans[0], field, scheds[0],
                                                  use_kernel=False)
        frame_err, frame_depth, hit = image_errors(out, plain)
        require(all(bool(torch.isfinite(getattr(out, k)).all())
                    for k in ("image", "opacity", "depth"))
                and float(out.opacity.max()) > 0.0 and hit,
                f"the {name} frame is not finite or empty")
        targets = [hash_tiled.render_hash_grid_tiled(pv, teacher, s).image
                   for pv, s in zip(plans, scheds)]
    print(f"{name}: render_hash_grid_tiled vs plain path on view 0: planes "
          f"{frame_err:.3e}, depth {frame_depth:.3e}", flush=True)
    require(frame_err <= TOL and frame_depth <= TOL_DEPTH,
            f"the {name} frame differs from the plain path")

    # the main path: Adam steps on the summed loss of the views
    student = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                         spec=spec, device=dev)
    opt = torch.optim.Adam(student.parameters(), lr=GRID_VIEW_LR)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = sum(mse(hash_tiled.render_hash_grid_tiled(pv, student, s).image,
                       tg) for pv, s, tg in zip(plans, scheds, targets))
        loss.backward()
        opt.step()
        return loss

    graph.reset_launch_counts()
    losses = []
    for _ in range(GRID_STEPS):
        before = counts_of(GRID)
        losses.append(float(step().detach()))
        after = counts_of(GRID)
        require(all(after[k] - before[k] == len(plans) for k in after),
                f"K8f / K8b did not launch once per view in a {name} step: "
                f"{before} -> {after}")
    launches = counts_of(GRID)
    print(f"{name}: {GRID_STEPS} Adam steps (lr {GRID_VIEW_LR}) on the summed "
          f"loss of {len(plans)} views: loss {losses[0]:.6e} -> "
          f"{losses[-1]:.6e}; launches {launches}: K8f and K8b once per view "
          f"per step each ({len(plans)} per step over {n_groups} groups)",
          flush=True)
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"the {name} loss does not fall")

    # times: kernels after warm-up (the twins' above)
    step_ms = cuda_ms(torch, step, 5, warmup=1)
    with torch.no_grad():
        frames_ms = cuda_ms(torch, lambda: [hash_tiled.render_hash_grid_tiled(
            pv, field, s) for pv, s in zip(plans, scheds)], 10)
    k8f_ms = cuda_ms(torch, lambda: [hash_grid.hash_grid_forward_tiles(*a)
                                     for a in args], 10)
    k8b_ms = cuda_ms(torch, lambda: [hash_grid.hash_grid_backward_tiles(
        *a[:3], gs, a[3]) for a, gs in zip(args, gss)], 5, warmup=1)
    print(f"{name} times ms [{card}]: {len(plans)} frames {frames_ms:.4f}, "
          f"Adam step {step_ms:.4f}; K8f {k8f_ms:.4f} over {len(plans)} "
          f"launches (plain {k8f_plain_ms:.4f}), K8b {k8b_ms:.4f} over "
          f"{len(plans)} launches (plain {k8b_plain_ms:.4f})", flush=True)

    live = sum(s.tiled_samples for s in scheds)
    f_in = sum(nbytes(a[0], a[1].samp, a[1].base, a[1].rayt, a[1].ke,
                      a[1].bank0, a[2]) for a in args)
    f_out = sum(a[1].n_tiles * 5 * 256 * 4 for a in args)
    rows = sum(int(a[0].shape[0]) * 128 * cols * 4 for a in args)
    b_bytes = f_in + sum(nbytes(g) for g in gss) + rows + 4 * len(args[0][2])
    kernels = [
        {"name": f"hash_grid:{form}", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/hash_grid.cu",
         "replaces": "dvren_tpu/ops/hash_grid.py:223",
         "launches": launches["hash_grid"], "max_abs_err": f_err,
         "ms": k8f_ms, "plain_ms": k8f_plain_ms,
         **bound(f_in + f_out, live * k8f_ops(spec))},
        {"name": f"hash_grid_bwd:{form}", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/hash_grid_bwd.cu",
         "replaces": "dvren_tpu/ops/hash_grid.py:282",
         "launches": launches["hash_grid_bwd"], "max_abs_err": b_raw,
         "ms": k8b_ms, "plain_ms": k8b_plain_ms,
         **bound(b_bytes, live * k8b_ops(spec))}]
    report = {
        "tile_px": want_px, "groups": [len(s.groups) for s in scheds],
        "tiles": [sum(g.n_tiles for g in s.groups) for s in scheds],
        "banks_max": banks, "live_samples": live, "build_s": builds,
        "table_gb": table_gb, "frames_ms": frames_ms, "step_ms": step_ms,
        "k8f_ms": k8f_ms, "k8b_ms": k8b_ms, "k8f_plain_ms": k8f_plain_ms,
        "k8b_plain_ms": k8b_plain_ms, "losses": losses,
        "launches_per_step": {k: v / GRID_STEPS for k, v in launches.items()},
        "occupancy": occ, "k8b_rel_err": [b_rows, b_mlp]}
    return kernels, report


def run_fit_flagship(torch, P, dev, card,
                     per_view_step_ms) -> tuple[list, dict]:
    """Phase 36: ``fit_dense_grid`` at the fit flagship
    (tools/fit_benchmark.py's scene, cameras and settings): the views
    merged into one schedule, K1 and K2 once per step; its Adam step
    beside ``per_view_step_ms``, phase 32's with a schedule per view."""
    from dvren_tpu_torch.opt import fit
    from dvren_tpu_torch.render import graph, tiled

    counts = functools.partial(counts_of, DENSE)
    reset = graph.reset_launch_counts
    plans, config = flagship_views(P)
    truth = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    cams = [P.CameraConfig(c2w=pv.camera.c2w) for pv in plans]
    # the targets: phase 31's frames, each view through its own cascade
    frames = []
    for pv in plans:
        s, _ = tiled.build_tiled_schedule_auto(pv, truth)
        with torch.no_grad():
            frames.append(tiled.render_tiled(pv, truth, s.to(dev)).image)
    targets = torch.stack(frames)
    init = truth.with_params(torch.full_like(truth.sigma, 0.5),
                             torch.full_like(truth.color, 0.5))

    t0 = time.perf_counter()
    views = fit._scheduled_views(plans[0], cams, init, "tiled")
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    merged, render_stack = views[1], views[2]
    sched = merged.sched
    shapes = [(g.n_chunks, g.n_tiles, g.banks) for g in sched.groups]
    print(f"fit flagship merged: {schedule_line(sched, merge_s)} (eight "
          f"builds, the merge and one upload); (n_chunks, n_tiles, banks) "
          f"{shapes}", flush=True)
    require(len(shapes) == 1 and sched.tile_px == 8 and sched.cell_scale == 2
            and sched.fallback_rays == 0,
            "the flagship's views did not merge into one 8 px supercell group")
    with torch.no_grad():
        stack = render_stack(truth, merged)
    stack_err = float((stack - targets).abs().max())
    print(f"fit flagship: render_tiled_stack vs the per-view frames "
          f"{stack_err:.3e}", flush=True)
    require(stack_err <= TOL, "the stack differs from the per-view frames")
    gen = torch.Generator(device=dev).manual_seed(36)
    args = [variant_args(torch, plans[0], truth, sched)]
    errs = twins_bit_equal(torch, args, gen, SUBSET)
    print(f"fit flagship merged group: K1 and K2 == twins bit for bit on its "
          f"first {SUBSET} tiles; repeats equal", flush=True)

    # the main path: fit_dense_grid in its auto mode
    cfg = fit.FitConfig(learning_rate=FIT_LR, steps=FLAGSHIP_STEPS,
                        target_psnr=FLAGSHIP_PSNR, log_every=100,
                        sync_every=FLAGSHIP_SYNC)
    reset()
    res = fit.fit_dense_grid(plans[0], init, cams, targets, cfg)
    c = counts()
    reached = next((i + 1 for i, p in enumerate(res.psnr_history)
                    if p >= FLAGSHIP_PSNR), None)
    print(f"fit_dense_grid at the flagship: mode {res.mode}, {res.steps_run} "
          f"steps, PSNR {res.psnr_history[0]:.4f} -> "
          f"{res.psnr_history[-1]:.4f} dB, PSNR {FLAGSHIP_PSNR} first at step "
          f"{reached} (checked every {FLAGSHIP_SYNC}), reached "
          f"{res.reached_target}; schedule_build_s {res.schedule_build_s:.4f}, "
          f"first_step_s {res.first_step_s:.4f}, steady_step_ms "
          f"{res.steady_step_ms:.4f}, wall_clock_s {res.wall_clock_s:.4f}; "
          f"recorded in the step graph {res.recorded_launches}, launches "
          f"{c}", flush=True)
    require(res.mode == "tiled", f"the auto mode chose {res.mode}")
    require(res.recorded_launches == {"fused_tiles": 1, "fused_tiles_bwd": 1}
            and c["fused_tiles"] == 2 and c["fused_tiles_bwd"] == 2
            and c["packed_table"] == 0 and c["packed_table_bwd"] == 0,
            f"the fit's step graph did not record K1 and K2 once each, or a "
            f"replay launched through a wrapper: recorded "
            f"{res.recorded_launches}, counters {c}")
    require(all(np.isfinite(res.loss_history))
            and res.loss_history[-1] < res.loss_history[0],
            "the flagship fit loss does not fall")
    require(float(res.field.sigma.min()) >= 0.0
            and float(res.field.color.max()) <= 1.0,
            "the fitted grid left the projection's bounds")

    # times: the Adam step with CUDA events; K1 and K2 at the merged group
    student = init.with_params(init.sigma.detach().clone(),
                               init.color.detach().clone())
    opt = torch.optim.Adam(student.parameters(), lr=FIT_LR, betas=(0.9, 0.999),
                           eps=1e-8, capturable=True)
    step = fit.make_train_step_scheduled(plans[0], cams, student, opt,
                                         views=views)   # recorded, replayed
    step_ms = cuda_ms(torch, lambda: step(student, targets), 10, warmup=2)
    gss = tile_gss(torch, args, gen)
    times = variant_times(torch, args, gss)
    with torch.no_grad():
        stack_ms = cuda_ms(torch, lambda: render_stack(student, merged), 10)
    print(f"fit flagship times ms [{card}]: Adam step replayed {step_ms:.4f} (each "
          f"view its own schedule: {per_view_step_ms:.4f}), {len(plans)}-view "
          f"stack {stack_ms:.4f}; K1 {times[0]:.4f} (plain {times[2]:.4f}), "
          f"K2 {times[1]:.4f} (plain {times[3]:.4f}), one launch each",
          flush=True)
    kernels = variant_kernels(
        "merged_supercell_8px", args, gss, sched,
        (c["fused_tiles"], c["fused_tiles_bwd"]), errs, times)
    report = {
        "mode": res.mode, "shape": shapes, "merge_s": merge_s,
        "stack_vs_frames": stack_err, "steps_run": res.steps_run,
        "psnr_first": res.psnr_history[0], "psnr_last": res.psnr_history[-1],
        "psnr_target_step": reached, "reached": res.reached_target,
        "schedule_build_s": res.schedule_build_s,
        "first_step_s": res.first_step_s,
        "steady_step_ms": res.steady_step_ms,
        "wall_clock_s": res.wall_clock_s, "adam_step_ms": step_ms,
        "stack_ms": stack_ms, "k1_ms": times[0], "k2_ms": times[1],
        "k1_plain_ms": times[2], "k2_plain_ms": times[3]}
    return kernels, report


# Float operations per processed step that the per-ray integrator needs:
# od (2), the prefix add, exp, the weight (1 each), r, g, b (6), the depth
# cursor and midpoint (5), w * mid (2). Its radiance adjoint adds dot (5),
# dot * w and the suffix add (2), dL/dod (2), d_sigma (2), d_colour (3).
K9F_OPS = 18
K9B_OPS = K9F_OPS + 14
FINE_FALLBACK_RAYS = 151552   # JAX's builder at 16 px over the fine grid


DEPTH_ULPS = 4   # ulps of 1 that T and sum(w * mid) may differ by per ray


def depth_error(depth, ref_depth, ref_opacity, t_far) -> tuple:
    """(max |depth - ref| over every ray, the largest share of its bound
    that a ray's difference takes, the ulps that the worst ray's
    difference past 1e-4 stands for). Frames of two formulations (a
    tile's running T against the windowed path's last P) differ in T and
    in wd = sum(w * mid) by an ulp or two of 1; depth = wd / opacity turns
    that into up to ulps * 2^-23 * t_far / opacity, past 1e-4 where the
    opacity is small. So each ray is held to
        1e-4 + DEPTH_ULPS * 2^-23 * t_far / max(opacity, OPACITY_EPS)."""
    def flat(x):
        return np.asarray(x.detach().cpu() if hasattr(x, "detach")
                          else x, np.float64).reshape(-1)

    diff = np.abs(flat(depth) - flat(ref_depth))
    scale = 2.0 ** -23 * t_far / np.maximum(flat(ref_opacity), 1e-6)
    share = diff / (TOL_DEPTH + DEPTH_ULPS * scale)
    ulps = np.maximum(diff - TOL_DEPTH, 0.0) / scale
    return float(diff.max()), float(share.max()), float(ulps.max())


def device_breakdown(torch, fn, steps: int = 3, top: int = 8):
    """``fn`` run ``steps`` times under ``torch.profiler`` after one warm
    run: (kernel ms per step, wall ms per step, the ``top`` kernels by time
    per step as (name, ms, launches)); kernel time over wall time is the
    busy share (the profiler's own overhead is in the wall time). None
    when the profiler records no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    gc.collect()        # dead CUDA graphs are destroyed before the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue    # a host operator: its kernels have rows of their own
        own = getattr(ev, "self_device_time_total", None)
        if own is None:
            own = getattr(ev, "self_cuda_time_total", 0.0)
        if own > 0:
            rows.append((ev.key[:60], own / 1e3 / steps, ev.count // steps))
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), wall, rows[:top]


def window_group_inputs(torch, plan, field, sched):
    """Per windowed group, the integrator's inputs as the path builds
    them: (sigma, (r, g, b), dt, mask, t_origin), the field evaluated at
    the group's window of samples."""
    from dvren_tpu_torch.ops.raygen import generate_rays
    from dvren_tpu_torch.ops.sampling import generate_samples
    from dvren_tpu_torch.render.pipeline import eval_fields

    out = []
    with torch.no_grad():
        for budget, ids, ke, jit in sched.groups:
            rays = generate_rays(plan, ids=ids)
            lat = generate_samples(plan, rays, jitter=jit, step_offset=ke,
                                   num_steps=budget)
            sigma, color = eval_fields(field, lat)
            origin = plan.t_near + ke.to(torch.float32) * plan.sampling.dt
            out.append((sigma.contiguous(),
                        tuple(c.contiguous() for c in color),
                        lat.dt.contiguous(), lat.mask.contiguous(),
                        origin.contiguous()))
    return out


def processed_steps(torch, inputs) -> tuple[int, int]:
    """(processed steps, rays that stop early: a live step left
    unprocessed because T fell to the threshold), the work K9 needs."""
    from dvren_tpu_torch.ops.integrate import STOP_THRESHOLD, scan_prefix

    proc = early = 0
    for sigma, _, dt, mask, _ in inputs:
        od = torch.clamp_min(sigma * dt, 0.0) * mask
        p = torch.exp(-scan_prefix(od))
        tb = torch.cat([torch.ones_like(p[:, :1]), p[:, :-1]], dim=1)
        done = mask & (tb <= STOP_THRESHOLD)
        proc += int((mask & (tb > STOP_THRESHOLD)).sum())
        early += int(done.any(dim=1).sum())
    return proc, early


def k9_against_twins(torch, inputs, gs, what, t_near, t_far):
    """K9f and K9b against their twins on every group, at
    tests/test_pallas_parity.py's bounds, and each repeat bit for bit.
    Returns (max |K9f - twin|, max |K9b - twin|)."""
    from dvren_tpu_torch.ops import integrate_fused as fz

    f_err = b_err = 0.0
    for (sigma, planes, dt, mask, origin), g in zip(inputs, gs):
        out = fz.integrate_forward(sigma, planes, dt, mask, t_near, t_far,
                                   origin)
        again = fz.integrate_forward(sigma, planes, dt, mask, t_near, t_far,
                                     origin)
        ds, dc = fz.radiance_vjp(sigma, planes, dt, mask, g)
        ds2, dc2 = fz.radiance_vjp(sigma, planes, dt, mask, g)
        torch.cuda.synchronize()
        want = fz.integrate_forward_plain(sigma, planes, dt, mask, t_near,
                                          t_far, origin)
        ps, pc = fz.radiance_vjp_plain(sigma, planes, dt, mask, g)
        require(torch.equal(out, again) and torch.equal(ds, ds2)
                and all(torch.equal(a, b) for a, b in zip(dc, dc2)),
                f"K9 differs between two runs ({what})")
        require(bool(torch.isfinite(out).all() and torch.isfinite(ds).all()),
                f"K9 output not finite ({what})")

        k = sigma.shape[1]
        bounds = ((slice(0, 3), 1e-5, 1e-6), (slice(3, 5), 1e-5, 1e-7),
                  (slice(5, 6), 1e-4 if k >= 128 else 1e-5, 1e-5))
        for cols, rtol, atol in bounds:
            a, b = out[:, cols], want[:, cols]
            excess = (a - b).abs() - (atol + rtol * b.abs())
            if float(excess.max()) > 0:
                ray, col = divmod(int(excess.argmax()), a.shape[1])
                raise AssertionError(
                    f"K9f differs from its twin beyond tolerance ({what}): "
                    f"ray {ray} column {cols.start + col}: kernel "
                    f"{out[ray].tolist()}, twin {want[ray].tolist()}, "
                    f"{int(mask[ray].sum())} live steps of {k}")
        for a, b, atol in ((ds, ps, 1e-6),) + tuple(
                (x, y, 1e-7) for x, y in zip(dc, pc)):
            excess = (a - b).abs() - (atol + 1e-4 * b.abs())
            if float(excess.max()) > 0:
                ray, step = divmod(int(excess.argmax()), a.shape[1])
                raise AssertionError(
                    f"K9b differs from its twin beyond tolerance ({what}): "
                    f"ray {ray} step {step}: kernel {float(a[ray, step])}, "
                    f"twin {float(b[ray, step])}, sigma "
                    f"{float(sigma[ray, step])}, {int(mask[ray].sum())} live "
                    f"steps of {a.shape[1]}")
        f_err = max(f_err, float((out - want).abs().max()))
        b_err = max(b_err, float((ds - ps).abs().max()),
                    *(float((a - b).abs().max()) for a, b in zip(dc, pc)))
    return f_err, b_err


def k9_times(torch, inputs, gs, t_near, t_far) -> dict:
    """K9f and K9b over every group, each on the device alone
    (``device_ms``: the stream sleeps while the host queues the launches)
    and as issued (``cuda_ms``: the wrapper's host cost included where a
    launch is short), and their twins' ms."""
    from dvren_tpu_torch.ops import integrate_fused as fz

    def fwd(f):
        return lambda: [f(s, pl, d, m, t_near, t_far, o)
                        for s, pl, d, m, o in inputs]

    def bwd(f):
        return lambda: [f(s, pl, d, m, g)
                        for (s, pl, d, m, _), g in zip(inputs, gs)]

    return {"k9f_ms": device_ms(torch, fwd(fz.integrate_forward), 20),
            "k9f_issued_ms": cuda_ms(torch, fwd(fz.integrate_forward), 20),
            "k9b_ms": device_ms(torch, bwd(fz.radiance_vjp), 20),
            "k9b_issued_ms": cuda_ms(torch, bwd(fz.radiance_vjp), 20),
            "k9f_plain_ms": cuda_ms(torch, fwd(fz.integrate_forward_plain),
                                    3, warmup=1),
            "k9b_plain_ms": cuda_ms(torch, bwd(fz.radiance_vjp_plain), 3,
                                    warmup=1)}


def k9_waves(torch, inputs) -> dict:
    """Waves of K9f's and K9b's launches over these groups, summed: each
    launch's blocks (``integrate_fused.launch_geometry``) over the SMs
    times the blocks resident on one (the runtime's occupancy query)."""
    from dvren_tpu_torch.ops import integrate_fused as fz

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    waves = {"integrate": 0.0, "integrate_bwd": 0.0}
    for sigma, *_ in inputs:
        n, k = sigma.shape
        blocks = fz.launch_geometry(n, k)[1]
        occ = fz.kernel_occupancy(k)
        for name in waves:
            waves[name] += blocks / (sms * occ[name]["blocks_per_sm"])
    return waves


def k9_bounds(torch, inputs, proc) -> tuple[dict, dict]:
    """Bounds of K9f and K9b at these inputs: the benchmark's bytes
    (``bench_port/counts/windowed.py``: each processed step's sigma, dt,
    colours and mask byte read once, the outputs written once) and the
    operations per processed step. ``bound_is_floor`` is false where
    those bytes fit in the card's L2: the timed launches repeat on the
    same inputs, so they may find them in L2 and beat the HBM bound."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    steps = k9_counts.Steps(
        processed=proc, rays=sum(int(x[0].shape[0]) for x in inputs),
        slots=sum(int(x[0].numel()) for x in inputs))
    return tuple({**bound(n_bytes, ops), "bound_is_floor": n_bytes > l2}
                 for n_bytes, ops in (
                     (k9_counts.k9f_bytes(steps), proc * K9F_OPS),
                     (k9_counts.k9b_bytes(steps), proc * K9B_OPS)))


PE_TOL = 1e-6             # x scale: the packed evaluation against its twin
PE_POS_TOL = 2e-6         # x scale: its position cotangent (autograd's order)


def packed_eval_entries(torch, plan, field, sched, gen, card) -> tuple:
    """The packed evaluation's kernels (``ops/packed_eval.py``) on the
    first group of the windowed schedule ``sched``: the forward, the
    backward into the table, and into the table and the positions,
    against ``eval_packed_trilinear(use_kernel=False)`` on the same
    tensors, a repeat backward bit for bit, the launches read through
    ``graph.launch_counts``; device ms beside the twin's and byte bounds.
    (kernel entries, report)."""
    from dvren_tpu_torch.ops import grid as grid_ops
    from dvren_tpu_torch.ops import packed_eval
    from dvren_tpu_torch.ops.raygen import generate_rays
    from dvren_tpu_torch.ops.sampling import generate_samples
    from dvren_tpu_torch.render import graph

    budget, ids, ke, jit = sched.groups[0]
    with torch.no_grad():
        lat = generate_samples(plan, generate_rays(plan, ids=ids),
                               jitter=jit, step_offset=ke, num_steps=budget)
        pts = tuple(p.contiguous() for p in lat.position_planes)
        table = grid_ops.build_packed_stencil(field.sigma, field.color)
    shape = field.grid_shape
    geom = packed_eval.geometry(shape, field.bbox_min, field.bbox_max,
                                field.oob)
    maskf = lat.mask.to(torch.float32)
    grads = tuple(torch.randn(pts[0].shape, generator=gen,
                              device=pts[0].device) * maskf
                  for _ in range(4))
    n = pts[0].numel()

    def twin(positions=False):
        leaf = table.detach().requires_grad_(True)
        p = tuple(x.detach().requires_grad_(positions) for x in pts)
        planes = grid_ops.eval_packed_trilinear(
            leaf, shape, *p, field.bbox_min, field.bbox_max, field.oob,
            use_kernel=False)
        wrt = (leaf,) + (p if positions else ())
        return (tuple(x.detach() for x in planes),
                torch.autograd.grad(planes, wrt, grads))

    graph.reset_launch_counts()
    planes = packed_eval.packed_eval_forward(table, *pts, geom)
    d_table, *_ = packed_eval.packed_eval_backward(*pts, grads, table, geom)
    again, *d_pos = packed_eval.packed_eval_backward(
        *pts, grads, table, geom, position_grad=True)
    torch.cuda.synchronize()
    moved = {k: v for k, v in graph.launch_counts().items() if v}
    require(moved == {"packed_eval": 1, "packed_eval_bwd": 2},
            f"the packed evaluation launched {moved}, not one forward and "
            f"two backwards")
    want_planes, (want_table, *want_pos) = twin(positions=True)
    scale = float(table.abs().max())
    f_err = max(float((a - b).abs().max())
                for a, b in zip(planes, want_planes))
    t_scale = float(want_table.abs().max())
    b_err = float((d_table - want_table.reshape(d_table.shape)).abs().max())
    p_scale = float(max(d.abs().max() for d in want_pos))
    p_err = max(float((a - b).abs().max()) for a, b in zip(d_pos, want_pos))
    print(f"packed evaluation on the headline's first windowed group ({n} "
          f"samples: {ids.shape[0]} rays x {budget} steps, a {tuple(shape)} "
          f"grid's {table.shape[0] * table.shape[1] * table.shape[2]} rows): "
          f"planes {f_err:.3e} of scale {scale:.3e}, table cotangent "
          f"{b_err:.3e} of {t_scale:.3e}, position cotangent {p_err:.3e} of "
          f"{p_scale:.3e} against the twin", flush=True)
    require(f_err <= PE_TOL * scale and b_err <= PE_TOL * t_scale
            and p_err <= PE_POS_TOL * p_scale,
            "the packed evaluation differs from its twin")
    require(torch.equal(again, d_table),
            "a repeat packed backward gave other bits")
    del want_planes, want_table, want_pos
    torch.cuda.empty_cache()

    def fwd():
        return packed_eval.packed_eval_forward(table, *pts, geom)

    def bwd():
        return packed_eval.packed_eval_backward(*pts, grads, table, geom)

    def twin_fwd():
        with torch.no_grad():
            return grid_ops.eval_packed_trilinear(
                table, shape, *pts, field.bbox_min, field.bbox_max,
                field.oob, use_kernel=False)

    f_ms, b_ms = device_ms(torch, fwd, 20), device_ms(torch, bwd, 20)
    f_plain = cuda_ms(torch, twin_fwd, 3, warmup=1)
    fb_plain = cuda_ms(torch, twin, 3, warmup=1)
    # every position read and every plane written once, the table once
    # (it stays in L2); the backward: positions and cotangents read once,
    # the (key, index) pairs written and read once, the rows written once
    f_bound = bound(nbytes(*pts, *planes, table), 0)
    b_bound = bound(nbytes(*pts, *grads, d_table) + 16 * n, 0)
    print(f"packed evaluation ms [{card}]: forward {f_ms:.4f} on the device "
          f"(twin {f_plain:.4f}; bound {f_bound['bound_ms']:.4f} by "
          f"{f_bound['bound_by']}), backward into the table {b_ms:.4f} "
          f"(twin's forward and backward {fb_plain:.4f}; bound "
          f"{b_bound['bound_ms']:.4f}); a repeat backward the same bits",
          flush=True)
    kernels = [
        {"name": "packed_eval:windowed", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/packed_eval.cu",
         "replaces": "dvren_tpu/ops/grid.py:525 (XLA ops, no Pallas "
                     "kernel)",
         "launches": moved["packed_eval"], "max_abs_err": f_err,
         "ms": f_ms, "plain_ms": f_plain, **f_bound},
        {"name": "packed_eval_bwd:windowed", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/packed_eval.cu",
         "replaces": "dvren_tpu/ops/grid.py:525 (autodiff's scatter-add, "
                     "no Pallas kernel)",
         "launches": moved["packed_eval_bwd"],
         "max_abs_err": max(b_err, p_err), "ms": b_ms,
         "plain_ms": fb_plain, **b_bound}]
    report = {"samples": n, "rays": int(ids.shape[0]), "budget": budget,
              "forward_ms": f_ms, "backward_ms": b_ms,
              "twin_forward_ms": f_plain, "twin_fwd_bwd_ms": fb_plain,
              "forward_bound_ms": f_bound["bound_ms"],
              "backward_bound_ms": b_bound["bound_ms"],
              "planes_err": f_err, "table_err": b_err,
              "position_err": p_err}
    return kernels, report


def run_window(torch, P, dev, card) -> tuple[list, dict]:
    """Phases 37-41: the windowed path and the tiled schedule's windowed
    fallback with K9f / K9b, the windowed and plain fit modes, and K1 / K2
    in their 4 px supercell form."""
    from dvren_tpu_torch.ops import packed_transpose
    from dvren_tpu_torch.opt import fit
    from dvren_tpu_torch.opt.fit import mse
    from dvren_tpu_torch.render import graph, pipeline, tiled, windowed
    from dvren_tpu_torch.render.pipeline import plan_jitter_table

    counts = functools.partial(counts_of, WINDOW)
    reset = graph.reset_launch_counts
    tcounts = functools.partial(counts_of, DENSE)
    gen = torch.Generator(device=dev).manual_seed(37)
    kernels, report = [], {}

    # 37. K9f / K9b against their twins on the dense headline's windowed
    # schedule, and on the same lattice with sigma x 10 (rays stop early)
    plan, config = headline_scene(P)
    field = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    t0 = time.perf_counter()
    wsched = windowed.build_schedule(plan, field.bbox_min, field.bbox_max,
                                     jitter=plan_jitter_table(plan),
                                     device=dev)
    wbuild_s = time.perf_counter() - t0
    budgets = [g[0] for g in wsched.groups]
    print(f"windowed headline schedule: {len(wsched.groups)} groups, budgets "
          f"{budgets}, {wsched.windowed_samples} of "
          f"{wsched.full_lattice_samples} lattice samples, skipped rays "
          f"{wsched.skipped_rays}, build {wbuild_s:.3f} s", flush=True)
    inputs = window_group_inputs(torch, plan, field, wsched)
    gs = [torch.rand((x[0].shape[0], 3), generator=gen, device=dev) * 2 - 1
          for x in inputs]
    proc, early = processed_steps(torch, inputs)
    span = (plan.t_near, plan.t_far)
    errs = k9_against_twins(torch, inputs, gs, "headline", *span)
    dense = [(s * 10.0, pl, d, m, o) for s, pl, d, m, o in inputs]
    proc10, early10 = processed_steps(torch, dense)
    errs10 = k9_against_twins(torch, dense, gs, "sigma x 10", *span)
    print(f"K9f / K9b vs twins over {len(inputs)} groups: K9f {errs[0]:.3e}, "
          f"K9b {errs[1]:.3e} ({proc} processed steps, {early} rays stop "
          f"early); sigma x 10: K9f {errs10[0]:.3e}, K9b {errs10[1]:.3e} "
          f"({proc10} processed steps, {early10} rays stop early); repeats "
          f"equal", flush=True)
    require(early10 > 0, "no ray stops early at sigma x 10")
    times = k9_times(torch, inputs, gs, *span)
    times10 = k9_times(torch, dense, gs, *span)
    fb, bb = k9_bounds(torch, inputs, proc)
    fb10, bb10 = k9_bounds(torch, dense, proc10)
    waves = k9_waves(torch, inputs)
    print(f"K9 times ms [{card}], device / issued: K9f {times['k9f_ms']:.4f} "
          f"/ {times['k9f_issued_ms']:.4f} (twin {times['k9f_plain_ms']:.4f}, "
          f"bound {fb['bound_ms']:.4f} by {fb['bound_by']}), K9b "
          f"{times['k9b_ms']:.4f} / {times['k9b_issued_ms']:.4f} (twin "
          f"{times['k9b_plain_ms']:.4f}, bound {bb['bound_ms']:.4f} by "
          f"{bb['bound_by']}); sigma x 10: K9f {times10['k9f_ms']:.4f} / "
          f"{times10['k9f_issued_ms']:.4f} (bound {fb10['bound_ms']:.4f}), "
          f"K9b {times10['k9b_ms']:.4f} / {times10['k9b_issued_ms']:.4f} "
          f"(bound {bb10['bound_ms']:.4f}); {len(inputs)} launches each, "
          f"waves K9f {waves['integrate']:.3f}, K9b "
          f"{waves['integrate_bwd']:.3f}", flush=True)

    # 38. Renderer(use_window=True) on the dense headline: forward and a
    # deterministic backward, K9f / K9b once per group
    renderer = P.Renderer(P.Context.create(device="cuda"), plan,
                          P.RenderOptions(use_window=True))
    reset()
    res = renderer.forward(field)
    fwd_c = counts()
    n_groups = len(renderer._window_schedule.groups)
    print(f"windowed Renderer.forward: {res.stats.total_ms:.3f} ms (schedule "
          f"included), launches {fwd_c}, notes {res.stats.notes}", flush=True)
    require(fwd_c["integrate"] == n_groups and fwd_c["integrate_bwd"] == 0,
            f"the windowed forward did not launch K9f once per group: "
            f"{fwd_c}")
    for key in ("image", "transmittance", "opacity", "depth"):
        require(bool(np.isfinite(getattr(res, key)).all()),
                f"windowed {key} not finite")
    with torch.no_grad():
        plain = windowed.render_windowed(plan, field,
                                         renderer._window_schedule,
                                         use_kernel=False)
        ts, _ = tiled.build_tiled_schedule_auto(plan, field)
        tframe = tiled.render_tiled(plan, field, ts.to(dev))
    err, depth, hit = planes_errors(res, plain)
    t_err, t_depth_all, t_hit = planes_errors(res, tframe)
    t_depth, t_share, t_ulps = depth_error(res.depth, tframe.depth,
                                           tframe.opacity, plan.t_far)
    print(f"windowed frame vs the plain path on the card: planes {err:.3e}, "
          f"depth {depth:.3e}, hitmask {hit}; vs the tiled frame (phase 5's "
          f"path): planes {t_err:.3e}, depth {t_depth:.3e} over every ray, "
          f"{t_share:.3f} of the largest share of its bound (1e-4 + "
          f"{DEPTH_ULPS} ulps x t_far / opacity) a ray takes, {t_ulps:.3f} "
          f"ulps past 1e-4 at most; hitmask {t_hit}", flush=True)
    require(err <= TOL and depth <= TOL_DEPTH and hit,
            "the windowed frame differs from the plain path")
    require(t_err <= 1e-5 and t_share <= 1.0 and t_hit,
            "the windowed frame differs from the tiled frame")
    dl = (torch.rand((plan.ray_count, 3), generator=gen, device=dev) * 2
          - 1).cpu().numpy()
    reset()
    torch.use_deterministic_algorithms(True)
    try:
        g1 = renderer.backward(field, dl)
        bwd_c = counts()
        g2 = renderer.backward(field, dl)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"windowed Renderer.backward launches {bwd_c} (K9f too: the "
          f"backward replays the forward)", flush=True)
    require(bwd_c["integrate_bwd"] == n_groups,
            "the windowed backward did not launch K9b once per group")
    for key in ("sigma", "color", "camera", "camera_k"):
        x = getattr(g1, key)
        require(bool(np.isfinite(x).all()) and float(np.abs(x).max()) > 0,
                f"windowed backward {key} not finite or zero")
        require(np.array_equal(x, getattr(g2, key)),
                f"windowed backward {key} differs between two calls")
    sched_w = renderer._window_schedule
    with torch.no_grad():
        frame_ms = cuda_ms(torch, lambda: windowed.render_windowed(
            plan, field, sched_w), 10, warmup=2)
    bwd_ms = cuda_ms(torch, lambda: renderer.backward(field, dl), 5,
                     warmup=1)
    print(f"windowed headline times ms [{card}]: frame {frame_ms:.4f} = "
          f"{plan.ray_count / frame_ms / 1e3:.3f} Mrays/s, Renderer.backward "
          f"{bwd_ms:.4f} (host copies included); two deterministic "
          f"backwards equal", flush=True)
    kernels += [
        {"name": "integrate", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/integrate.cu",
         "replaces": "dvren_tpu/ops/integrate_pallas.py:62",
         "launches": fwd_c["integrate"], "max_abs_err": max(errs[0],
                                                            errs10[0]),
         "ms": times["k9f_ms"], "issued_ms": times["k9f_issued_ms"],
         "plain_ms": times["k9f_plain_ms"], "waves": waves["integrate"],
         **fb},
        {"name": "integrate_bwd", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/integrate_bwd.cu",
         "replaces": "dvren_tpu/ops/integrate_pallas.py:105",
         "launches": bwd_c["integrate_bwd"],
         "max_abs_err": max(errs[1], errs10[1]),
         "ms": times["k9b_ms"], "issued_ms": times["k9b_issued_ms"],
         "plain_ms": times["k9b_plain_ms"], "waves": waves["integrate_bwd"],
         **bb}]
    report["window_headline"] = {
        "groups": n_groups, "budgets": budgets,
        "windowed_samples": wsched.windowed_samples,
        "processed": proc, "early": early, "processed_x10": proc10,
        "early_x10": early10, **times, "waves": waves,
        "k9f_ms_x10": times10["k9f_ms"], "k9b_ms_x10": times10["k9b_ms"],
        "k9f_issued_ms_x10": times10["k9f_issued_ms"],
        "k9b_issued_ms_x10": times10["k9b_issued_ms"],
        "k9f_bound_ms": fb["bound_ms"], "k9b_bound_ms": bb["bound_ms"],
        "frame_ms": frame_ms, "backward_ms": bwd_ms, "vs_plain": err,
        "vs_tiled": t_err, "vs_tiled_depth": t_depth,
        "vs_tiled_depth_share": t_share, "build_s": wbuild_s}
    pe_kernels, report["packed_eval"] = packed_eval_entries(
        torch, plan, field, wsched, gen, card)
    kernels += pe_kernels

    # 39. the fine grid at 16 px cells: most rays fall back
    fplan, fconfig = headline_scene(P, grid_n=128, max_steps=256)
    ffield = P.DenseGridField.create(fconfig, device=dev).requires_grad_(False)
    t0 = time.perf_counter()
    fsched = tiled.build_tiled_schedule(fplan, ffield, tile_px=16).to(dev)
    fbuild_s = time.perf_counter() - t0
    n_fb = len(fsched.fallback.groups) if fsched.fallback else 0
    print(f"fine grid at 16 px cells: {schedule_line(fsched, fbuild_s)}; "
          f"{fsched.fallback_rays} of {fsched.total_rays} rays fall back "
          f"(JAX's builder: {FINE_FALLBACK_RAYS}) in {n_fb} windowed groups",
          flush=True)
    require(fsched.fallback_rays == FINE_FALLBACK_RAYS and n_fb > 0,
            "the fine grid at 16 px does not fall back as JAX's builder does")
    reset()
    with torch.no_grad():
        fframe = tiled.render_tiled(fplan, ffield, fsched)
    c_t, c_w = tcounts(), counts()
    require(c_t["fused_tiles"] == 1 and c_w["integrate"] == n_fb,
            f"the fallback frame launched {c_t} {c_w}")
    with torch.no_grad():
        ssched = tiled.build_tiled_schedule(fplan, ffield, tile_px=16,
                                            cell_scale=2).to(dev)
        sframe = tiled.render_tiled(fplan, ffield, ssched)
    f_err = max(float((getattr(fframe, k) - getattr(sframe, k)).abs().max())
                for k in ("image", "transmittance", "opacity"))
    f_depth, f_share, f_ulps = depth_error(fframe.depth, sframe.depth,
                                           sframe.opacity, fplan.t_far)
    print(f"fallback frame vs phase 28's 16 px supercell frame: planes "
          f"{f_err:.3e}, depth {f_depth:.3e} over every ray, {f_share:.3f} "
          f"of the largest share of its bound (1e-4 + {DEPTH_ULPS} ulps x "
          f"t_far / opacity) a ray takes, {f_ulps:.3f} ulps past 1e-4 at "
          f"most; launches {c_t['fused_tiles']} K1, {c_w['integrate']} K9f",
          flush=True)
    require(f_err <= 1e-5 and f_share <= 1.0,
            "the fallback frame differs from the supercell frame")
    dl_img = torch.rand((fplan.height, fplan.width, 3), generator=gen,
                        device=dev) * 2 - 1

    def fgrads():
        leaf = ffield.with_params(ffield.sigma.detach().clone(),
                                  ffield.color.detach().clone())
        img = tiled.render_tiled(fplan, leaf, fsched).image
        return torch.autograd.grad(torch.sum(img * dl_img),
                                   (leaf.sigma, leaf.color))

    reset()
    torch.use_deterministic_algorithms(True)
    try:
        ga = fgrads()
        b_t, b_w = tcounts(), counts()
        gb_ = fgrads()
    finally:
        torch.use_deterministic_algorithms(False)
    require(b_t["fused_tiles_bwd"] == 1 and b_w["integrate_bwd"] == n_fb,
            f"the fallback backward launched {b_t} {b_w}")
    require(all(torch.equal(a, b) for a, b in zip(ga, gb_))
            and all(bool(torch.isfinite(a).all()) for a in ga),
            "the fallback backward differs between two runs")
    n_values = fplan.height * fplan.width * 3
    student = P.DenseGridField.create(fconfig, device=dev)
    opt = torch.optim.SGD(student.parameters(), lr=LR * n_values)
    target = torch.zeros((fplan.height, fplan.width, 3), device=dev)

    def fstep():
        opt.zero_grad(set_to_none=True)
        loss = mse(tiled.render_tiled(fplan, student, fsched).image, target)
        loss.backward()
        opt.step()
        return loss

    torch.cuda.reset_peak_memory_stats()
    flosses = [float(fstep().detach()) for _ in range(4)]
    fpeak = torch.cuda.max_memory_allocated() / 2 ** 20
    require(all(np.isfinite(flosses))
            and all(b < a for a, b in zip(flosses, flosses[1:])),
            "the fallback training loss does not fall")
    with torch.no_grad():
        fframe_ms = cuda_ms(torch, lambda: tiled.render_tiled(
            fplan, ffield, fsched), 5, warmup=1)
    fstep_ms = cuda_ms(torch, fstep, 3, warmup=1)
    print(f"fallback: backward K2 x {b_t['fused_tiles_bwd']}, K9b x "
          f"{b_w['integrate_bwd']}, two deterministic runs equal; 4 SGD steps "
          f"at lr {LR} x {n_values}: loss {flosses}; times ms [{card}]: frame "
          f"{fframe_ms:.4f}, SGD step {fstep_ms:.4f}; peak device memory "
          f"{fpeak:.1f} MiB", flush=True)
    fb_inputs = window_group_inputs(torch, fplan, ffield, fsched.fallback)
    fb_gs = [torch.rand((x[0].shape[0], 3), generator=gen, device=dev) * 2
             - 1 for x in fb_inputs]
    kernels += k9_entries(torch, "fallback_16px", fb_inputs, fb_gs,
                          {"integrate": c_w["integrate"],
                           "integrate_bwd": b_w["integrate_bwd"]},
                          (fplan.t_near, fplan.t_far), card)
    del fb_inputs, fb_gs
    # K3 and K4 at 128^3 against their twins, as 32-bit words, and timed
    fsig, fcol = ffield.sigma, ffield.color
    ftg = torch.randn((packed_transpose.fullpitch_rows(fsig.shape), 32),
                      generator=gen, device=dev)
    ftable = packed_transpose.build_rows(fsig, fcol)
    fgrad = packed_transpose.table_grad_to_params(ftg, fsig.shape)
    torch.cuda.synchronize()
    require(torch.equal(words(ftable), words(
        packed_transpose.build_rows_plain(fsig, fcol))),
            "K3 differs from its plain twin at 128^3")
    require(all(torch.equal(words(a), words(b)) for a, b in zip(
        fgrad, packed_transpose.table_grad_to_params_plain(ftg, fsig.shape))),
            "K4 differs from its plain twin at 128^3")
    fk3 = packed_times(torch, lambda: packed_transpose.build_rows(fsig, fcol),
                       lambda: packed_transpose.build_rows_plain(fsig, fcol))
    fk4 = packed_times(
        torch, lambda: packed_transpose.table_grad_to_params(ftg, fsig.shape),
        lambda: packed_transpose.table_grad_to_params_plain(ftg, fsig.shape))
    print(f"K3 and K4 == plain at 128^3, as 32-bit words; ms [{card}]: K3 "
          f"{fk3[0]:.4f} on the device, {fk3[1]:.4f} as issued (plain "
          f"{fk3[2]:.4f}); K4 {fk4[0]:.4f}, {fk4[1]:.4f} (plain "
          f"{fk4[2]:.4f}); launches: frame {c_t['packed_table']} K3, "
          f"backward {b_t['packed_table_bwd']} K4", flush=True)
    require(c_t["packed_table"] == 1 and b_t["packed_table_bwd"] == 1,
            "the fallback frame and backward did not launch K3 and K4 once")
    for name, src, line, (ms, issued, plain_ms), launches, n_bytes in (
            ("packed_table", "packed_table.cu", 81, fk3, c_t["packed_table"],
             nbytes(fsig, fcol, ftable)),
            ("packed_table_bwd", "packed_table_bwd.cu", 119, fk4,
             b_t["packed_table_bwd"], nbytes(ftg, *fgrad))):
        kernels.append({
            "name": f"{name}:128", "route": "cuda",
            "source": f"dvren_tpu_torch/csrc/{src}",
            "replaces": f"dvren_tpu/ops/packed_transpose.py:{line}",
            "launches": launches, "max_abs_err": 0.0, "ms": ms,
            "issued_ms": issued, "plain_ms": plain_ms,
            **bound(n_bytes, 0)})
    report["packed_128"] = {"k3": fk3, "k4": fk4}
    del ftable, fgrad, ftg
    report["fallback_16px"] = {
        "fallback_rays": fsched.fallback_rays, "fallback_groups": n_fb,
        "tile_groups": len(fsched.groups), "build_s": fbuild_s,
        "vs_supercell": f_err, "vs_supercell_depth": f_depth,
        "vs_supercell_depth_share": f_share, "frame_ms": fframe_ms,
        "step_ms": fstep_ms, "losses": flosses, "peak_mib": fpeak}
    del fsched, ssched, ga, gb_, student, opt

    # 40. fit_dense_grid at the flagship in the windowed mode, then plain
    plans, vconfig = flagship_views(P)
    truth = P.DenseGridField.create(vconfig, device=dev).requires_grad_(False)
    cams = [P.CameraConfig(c2w=pv.camera.c2w) for pv in plans]
    frames = []
    for pv in plans:
        s, _ = tiled.build_tiled_schedule_auto(pv, truth)
        with torch.no_grad():
            frames.append(tiled.render_tiled(pv, truth, s.to(dev)).image)
    targets = torch.stack(frames)
    init = truth.with_params(torch.full_like(truth.sigma, 0.5),
                             torch.full_like(truth.color, 0.5))
    stack = windowed.build_stack_schedule(plans, truth.bbox_min,
                                          truth.bbox_max, device=dev)
    n_stack = len(stack.groups)
    cfg = fit.FitConfig(learning_rate=FIT_LR, steps=FLAGSHIP_STEPS,
                        target_psnr=FLAGSHIP_PSNR, log_every=100,
                        sync_every=FLAGSHIP_SYNC)
    graph.reset_launch_counts()
    res_w = fit.fit_dense_grid(plans[0], init, cams, targets, cfg,
                               mode="windowed")
    c = {k: v for k, v in graph.launch_counts().items() if v}
    reached = next((i + 1 for i, p in enumerate(res_w.psnr_history)
                    if p >= FLAGSHIP_PSNR), None)
    print(f"fit_dense_grid(mode='windowed') at the flagship: {n_stack} stack "
          f"groups, {res_w.steps_run} steps, PSNR {res_w.psnr_history[0]:.4f} "
          f"-> {res_w.psnr_history[-1]:.4f} dB, PSNR {FLAGSHIP_PSNR} first at "
          f"step {reached}, reached {res_w.reached_target}; schedule_build_s "
          f"{res_w.schedule_build_s:.4f}, first_step_s "
          f"{res_w.first_step_s:.4f}, steady_step_ms "
          f"{res_w.steady_step_ms:.4f}, wall_clock_s "
          f"{res_w.wall_clock_s:.4f} [{card}]; recorded in the step graph "
          f"{res_w.recorded_launches}, launches {c}", flush=True)
    require(res_w.mode == "windowed", f"the fit ran {res_w.mode}")
    rec = res_w.recorded_launches
    require(rec.get("integrate_bwd") == n_stack
            and rec.get("integrate", 0) >= n_stack
            and rec.get("packed_eval") == rec.get("integrate")
            and rec.get("packed_eval_bwd") == n_stack
            and c == {k: 2 * v for k, v in rec.items()},
            f"the windowed fit's step graph did not record K9f / K9b and "
            f"the packed evaluation once per stack group, or a replay "
            f"launched through a wrapper: recorded {rec}, counters {c}")
    require(all(np.isfinite(res_w.loss_history))
            and res_w.loss_history[-1] < res_w.loss_history[0],
            "the windowed fit loss does not fall")
    student = init.with_params(init.sigma.detach().clone(),
                               init.color.detach().clone())
    adam = torch.optim.Adam(student.parameters(), lr=FIT_LR,
                            betas=(0.9, 0.999), eps=1e-8, capturable=True)
    wstep = fit.make_train_step_scheduled(
        plans[0], cams, student, adam, mode="windowed",
        views=fit._scheduled_views(plans[0], cams, student, "windowed"))
    breakdown = device_breakdown(torch, lambda: wstep.body(student, targets))
    if breakdown is None:
        print("windowed fit step: the profiler recorded no device time",
              flush=True)
    else:
        dev_ms, wall_ms, rows = breakdown
        print(f"windowed fit step (eager) under torch.profiler [{card}]: kernels "
              f"{dev_ms:.4f} ms of {wall_ms:.4f} ms wall per step (busy "
              f"share {dev_ms / wall_ms:.3f}); kernels by time per step: "
              + "; ".join(f"{name} {ms:.4f} ms x {n}"
                          for name, ms, n in rows), flush=True)
    graph.reset_launch_counts()
    res_p = fit.fit_dense_grid(plans[0], init, cams, targets,
                               fit.FitConfig(learning_rate=FIT_LR, steps=10,
                                             target_psnr=None),
                               mode="plain")
    cp = {k: v for k, v in graph.launch_counts().items() if v}
    print(f"fit_dense_grid(mode='plain'): 10 steps, loss "
          f"{res_p.loss_history[0]:.6e} -> {res_p.loss_history[-1]:.6e}, "
          f"steady_step_ms {res_p.steady_step_ms:.4f} [{card}]; recorded in "
          f"the step graph {res_p.recorded_launches}, launches {cp}",
          flush=True)
    require(res_p.mode == "plain"
            and res_p.loss_history[-1] < res_p.loss_history[0],
            "the plain fit loss does not fall")
    require(res_p.recorded_launches == {"integrate": len(plans),
                                        "integrate_bwd": len(plans),
                                        "packed_eval": len(plans),
                                        "packed_eval_bwd": len(plans)}
            and cp == {k: 2 * v for k, v in res_p.recorded_launches.items()},
            f"the plain fit's step graph did not record K9 once per view, or "
            f"a replay launched through a wrapper: recorded "
            f"{res_p.recorded_launches}, counters {cp}")
    # K9 at one view's lattice (9,216 x 96), as the plain fit launches it
    with torch.no_grad():
        v_in = outputs_inputs(pipeline.render(plans[0], truth))
    v_gs = [torch.rand((v_in[0][0].shape[0], 3), generator=gen, device=dev)
            * 2 - 1]
    kernels += k9_entries(torch, "view_96", v_in, v_gs, cp,
                          (plans[0].t_near, plans[0].t_far),
                          f"{card}; one process")
    del v_in, v_gs
    report["fit_windowed"] = {
        "stack_groups": n_stack, "steps_run": res_w.steps_run,
        "psnr_first": res_w.psnr_history[0],
        "psnr_last": res_w.psnr_history[-1], "psnr_target_step": reached,
        "schedule_build_s": res_w.schedule_build_s,
        "first_step_s": res_w.first_step_s,
        "steady_step_ms": res_w.steady_step_ms,
        "wall_clock_s": res_w.wall_clock_s,
        "plain_losses": [res_p.loss_history[0], res_p.loss_history[-1]],
        "plain_steady_step_ms": res_p.steady_step_ms,
        "step_device_breakdown": breakdown}

    sc_kernels, report["supercell_4px"] = run_supercell4(torch, P, dev,
                                                         card)
    kernels.extend(sc_kernels)
    return kernels, report


def run_supercell4(torch, P, dev, card) -> tuple[list, dict]:
    """Phase 41: K1 and K2 in their supercell, subs 16 form (the cascade
    never picks it): the flagship's view 0 at 4 px supercells."""
    from dvren_tpu_torch.render import graph, tiled

    gen = torch.Generator(device=dev).manual_seed(41)
    plans, config = flagship_views(P)
    truth = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    t0 = time.perf_counter()
    s4 = tiled.build_tiled_schedule(plans[0], truth, tile_px=4,
                                    cell_scale=2).to(dev)
    s4_build = time.perf_counter() - t0
    print(f"flagship view 0, 4 px supercells: {schedule_line(s4, s4_build)}",
          flush=True)
    student4 = truth.with_params(truth.sigma.detach().clone(),
                                 truth.color.detach().clone())
    graph.reset_launch_counts()
    tiled.render_tiled(plans[0], student4, s4).image.sum().backward()
    c4 = counts_of(DENSE)
    args = [variant_args(torch, plans[0], truth, s4)]
    errs4 = twins_bit_equal(torch, args, gen, SUBSET)
    gss = tile_gss(torch, args, gen)
    times4 = variant_times(torch, args, gss)
    print(f"K1 / K2 supercell subs 16: == twins bit for bit on the first "
          f"{SUBSET} tiles of {len(s4.groups)} groups; times ms [{card}]: K1 "
          f"{times4[0]:.4f} (plain {times4[2]:.4f}), K2 {times4[1]:.4f} "
          f"(plain {times4[3]:.4f}), one launch each", flush=True)
    require(c4["fused_tiles"] == 1 and c4["fused_tiles_bwd"] == 1,
            f"a 4 px supercell frame and backward launched {c4}")
    kernels = variant_kernels(
        "supercell_4px", args, gss, s4,
        (c4["fused_tiles"], c4["fused_tiles_bwd"]), errs4, times4)
    return kernels, {"groups": len(s4.groups), "k1_ms": times4[0],
                     "k2_ms": times4[1], "k1_plain_ms": times4[2],
                     "k2_plain_ms": times4[3]}


SPLIT_STEPS = 4          # SGD steps per route (phases 44 and 45)
SPLIT_FIT_STEPS = 8      # fit_dense_grid steps per route (phase 46)
SPLIT_FIT_SYNC = 4
SPLIT_VIEW_DX = 0.05     # phase 46's second view: the headline camera + x
# -0.0, subnormals, +-inf, NaNs with payloads (quiet and signalling)
SPECIAL_WORDS = (0x80000000, 0x00000001, 0x807FFFFF, 0x00400000, 0x7F800000,
                 0xFF800000, 0x7FC00001, 0xFFC12345, 0x7F800001, 0xFFA00000)


def words(x):
    """A float32 tensor's 32-bit words, for comparisons bit for bit."""
    import torch

    return x.contiguous().view(torch.int32)


def special_blocks(torch, dev, n_blocks=3, seed=42):
    """Seeded (B, 32, 128) f32 bank blocks of normal values with
    SPECIAL_WORDS at random places in every block."""
    rng = np.random.default_rng(seed)
    banks = rng.normal(size=(n_blocks, 32, 128)).astype(np.float32)
    bits = banks.view(np.uint32).reshape(n_blocks, -1)
    for b in range(n_blocks):
        cols = rng.choice(32 * 128, size=len(SPECIAL_WORDS), replace=False)
        bits[b, cols] = np.array(SPECIAL_WORDS, np.uint32)
    return torch.from_numpy(banks).to(dev)


def bank_form_check(torch, args, gss, what):
    """K2's bank form against its rows form, transposed, and its repeat,
    bit for bit, one launch per schedule of ``args``; then its twin's bank
    form, group by group, once. Returns (max |kernel - twin|, x scale, the
    twin's ms, bank-form ms, rows-form ms)."""
    from dvren_tpu_torch.ops import fused_tiles

    outs = []
    for (tabs, tiles, prm), gs in zip(args, gss):
        rows, _ = fused_tiles.tile_backward(tabs, tiles, gs, prm)
        banks, _ = fused_tiles.tile_backward(tabs, tiles, gs, prm,
                                             emit="banks")
        again, _ = fused_tiles.tile_backward(tabs, tiles, gs, prm,
                                             emit="banks")
        torch.cuda.synchronize()
        require(bool(torch.isfinite(banks).all()),
                f"K2's bank form not finite ({what})")
        require(torch.equal(banks, rows.transpose(1, 2)),
                f"K2's bank form differs from its rows form transposed "
                f"({what})")
        require(torch.equal(again, banks),
                f"K2's bank form differs between two runs ({what})")
        outs.append(banks)
    plain, plain_ms = timed_once(torch, lambda: [
        fused_tiles.tile_backward_set_plain(a[0], a[1], gs, a[2],
                                            emit="banks")[0]
        for a, gs in zip(args, gss)])
    err = max(float((b - p).abs().max()) for b, p in zip(outs, plain))
    rel = max(rel_err(b, p) for b, p in zip(outs, plain))
    require(rel <= GRID_TOL,
            f"K2's bank form differs from its twin's ({what}): {rel:.3e}")
    banks_ms = cuda_ms(torch, lambda: [fused_tiles.tile_backward(
        a[0], a[1], gs, a[2], emit="banks") for a, gs in zip(args, gss)], 10)
    rows_ms = cuda_ms(torch, lambda: [fused_tiles.tile_backward(
        a[0], a[1], gs, a[2]) for a, gs in zip(args, gss)], 10)
    return err, rel, plain_ms, banks_ms, rows_ms


@contextlib.contextmanager
def split_route(tiled, value):
    """``tiled.BWD_SPLIT`` set to ``value`` inside the block, as it was
    after."""
    before, tiled.BWD_SPLIT = tiled.BWD_SPLIT, value
    try:
        yield
    finally:
        tiled.BWD_SPLIT = before


def stack_split_backward(torch, tiled, plan, field, merged, counts, reset):
    """One backward through render_tiled_stack under BWD_SPLIT "pallas":
    the launches of K2 and K6, each once over every merged group."""
    leaf = field.with_params(field.sigma.detach().clone(),
                             field.color.detach().clone())
    with split_route(tiled, "pallas"):
        reset()
        img = tiled.render_tiled_stack(plan, leaf, merged)
        img.square().sum().backward()
        torch.cuda.synchronize()
        c = counts()
    require(c["fused_tiles_bwd"] == 1 and c["banks_to_rows"] == 1,
            f"render_tiled_stack's split backward did not launch K2 and K6 "
            f"once over its {len(merged.sched.groups)} groups: {c}")
    require(float(leaf.sigma.grad.abs().max()) > 0,
            "the split backward's d_sigma is zero")
    return c


def run_split(torch, P, dev, card, headline=None) -> tuple[list, dict]:
    """Phases 42-46: the split tiled backward (``DVREN_BWD_SPLIT=pallas``):
    K6 and K2's bank form against their twins and the rows form, the dense
    stack's SGD steps, the sparse Renderer.backward (in a child process
    that reads the flag from its environment) and fit_dense_grid, each
    under both values of the flag. ``headline``: phase 3's (plan, config,
    field, numpy schedule), else built here."""
    from dvren_tpu_torch.ops import fused_tiles, packed_transpose
    from dvren_tpu_torch.opt import fit
    from dvren_tpu_torch.opt.fit import mse
    from dvren_tpu_torch.render import graph, tiled

    counts = functools.partial(counts_of, DENSE)
    reset = graph.reset_launch_counts
    kernels, report = [], {}
    if headline is None:
        plan, config = headline_scene(P)
        field = P.DenseGridField.create(config, device=dev)
        field.requires_grad_(False)
        t0 = time.perf_counter()
        sched_host, _ = tiled.build_tiled_schedule_auto(plan, field)
        print(f"headline schedule build {time.perf_counter() - t0:.3f} s",
              flush=True)
    else:
        plan, config, field, sched_host = headline
    sched = sched_host.to(dev)
    args = [variant_args(torch, plan, field, sched)]
    n_groups = len(sched.groups)
    gen = torch.Generator(device=dev).manual_seed(42)
    gss = tile_gss(torch, args, gen)

    # 42. K6 against its twin on the headline's bank cotangents, every
    # group's blocks in one launch
    (tabs, tiles, prm), = args
    banks = fused_tiles.tile_backward(tabs, tiles, gss[0], prm,
                                      emit="banks")[0]
    n_blocks = int(banks.shape[0])
    out = packed_transpose.banks_to_rows(banks)
    torch.cuda.synchronize()
    twin = packed_transpose.banks_to_rows_plain(banks)
    require(torch.equal(words(out), words(twin)),
            "K6 differs from its twin on the headline's cotangents")
    special = special_blocks(torch, dev)
    got = packed_transpose.banks_to_rows(special)
    torch.cuda.synchronize()
    require(torch.equal(words(got),
                        words(packed_transpose.banks_to_rows_plain(special))),
            "K6 differs from its twin on -0.0, subnormals, inf and NaNs")
    k6_fns = {
        "kernel": lambda: packed_transpose.banks_to_rows(banks),
        "plain": lambda: packed_transpose.banks_to_rows_plain(banks),
        "library": lambda: banks.transpose(1, 2).contiguous()}
    k6_dev = {k: device_ms(torch, fn, 20) for k, fn in k6_fns.items()}
    k6_host = {k: cuda_ms(torch, fn, 50) for k, fn in k6_fns.items()}
    k6_ms, k6_plain_ms, k6_lib_ms = (k6_dev["kernel"], k6_dev["plain"],
                                     k6_dev["library"])
    k6_bound = bound(2 * nbytes(banks), 0)
    print(f"K6 == plain, bit for bit, on {n_groups} groups ({n_blocks} bank "
          f"blocks, {2 * nbytes(banks) / 1e6:.1f} MB moved) and on a block "
          f"of -0.0, subnormals, +-inf and NaN payloads; device ms, one "
          f"launch: K6 {k6_ms:.4f}, twin {k6_plain_ms:.4f}, "
          f"banks.transpose(1, 2).contiguous() {k6_lib_ms:.4f}, bound "
          f"{k6_bound['bound_ms']:.4f}; issued from the host one after "
          f"another: K6 {k6_host['kernel']:.4f}, twin {k6_host['plain']:.4f},"
          f" transpose {k6_host['library']:.4f} ({card})", flush=True)
    report["k6"] = {"device_ms": k6_dev, "host_issued_ms": k6_host,
                    "bank_blocks": n_blocks,
                    "bound_ms": k6_bound["bound_ms"]}

    # 43. K2's bank form against its rows form: subs 1 (the headline),
    # subs 4 (the flagship's eight views at 8 px cells, merged) and subs 16
    # (view 0 at 4 px cells, a one-view merge)
    forms = {}

    def bank_entry(form, f_args, f_gss, f_sched, launches, res):
        err, rel, plain_ms, banks_ms, rows_ms = res
        live = f_sched.tiled_samples
        k_in = sum(tile_in_bytes(a) for a in f_args)
        rows_b = sum(a[1].n_bank_rows * 128 * 32 * 4 for a in f_args)
        forms[form] = {"banks_ms": banks_ms, "rows_ms": rows_ms,
                       "plain_ms": plain_ms, "rel_err": rel,
                       "groups": len(f_sched.groups)}
        print(f"K2 bank form, {form}: == rows form transposed and its repeat "
              f"over {len(f_sched.groups)} groups in one launch, vs twin "
              f"{rel:.3e} x scale; "
              f"{banks_ms:.4f} ms (rows form {rows_ms:.4f}, twin "
              f"{plain_ms:.4f}) ({card})", flush=True)
        return {"name": f"fused_tiles_bwd:banks_{form}", "route": "cuda",
                "source": "dvren_tpu_torch/csrc/fused_tiles_bwd.cu",
                "replaces": "dvren_tpu/ops/fused_tiles.py:714",
                "launches": launches, "max_abs_err": err, "ms": banks_ms,
                "plain_ms": plain_ms,
                **bound(k_in + sum(nbytes(g) for g in f_gss) + rows_b,
                        live * tile_counts.BWD_OPS)}

    subs1 = bank_form_check(torch, args, gss, "subs 1")
    fl_plans, fl_config = flagship_views(P)
    fl_field = P.DenseGridField.create(fl_config, device=dev)
    fl_field.requires_grad_(False)
    sub_entries = []
    for form, px, plans in (("subs4", 8, fl_plans), ("subs16", 4,
                                                     fl_plans[:1])):
        t0 = time.perf_counter()
        views = [tiled.build_tiled_schedule(p, fl_field, tile_px=px,
                                            quantize=True) for p in plans]
        merged = tiled.merge_view_schedules(views, plans=plans).to(dev)
        build_s = time.perf_counter() - t0
        print(f"{form}: {len(plans)} view(s) at {px} px cells, merged: "
              f"{schedule_line(merged.sched, build_s)}", flush=True)
        f_args = [variant_args(torch, plans[0], fl_field, merged.sched)]
        f_gss = tile_gss(torch, f_args, gen)
        res = bank_form_check(torch, f_args, f_gss, form)
        c = stack_split_backward(torch, tiled, plans[0], fl_field, merged,
                                 counts, reset)
        sub_entries.append(bank_entry(form, f_args, f_gss, merged.sched,
                                      c["fused_tiles_bwd"], res))
        forms[form]["fallback_rays"] = merged.sched.fallback_rays

    # 44. the dense headline as a one-view merge through render_tiled_stack:
    # SGD steps under both values of the flag
    merged = tiled.merge_view_schedules([sched_host], plans=[plan]).to(dev)
    n_values = plan.height * plan.width * 3
    target = torch.zeros((1, plan.height, plan.width, 3), device=dev)

    def stack_trainer(lr):
        f = P.DenseGridField.create(config, device=dev)
        opt = torch.optim.SGD(f.parameters(), lr=lr)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = mse(tiled.render_tiled_stack(plan, f, merged), target)
            loss.backward()
            opt.step()
            return loss

        return f, step

    def stack_steps(split):
        f, step = stack_trainer(LR * n_values)
        losses, grads, per_step = [], [], []
        with split_route(tiled, split):
            reset()
            for _ in range(SPLIT_STEPS):
                before = counts()
                losses.append(float(step().detach()))
                after = counts()
                per_step.append({k: after[k] - before[k] for k in after})
                grads.append((f.sigma.grad.clone(), f.color.grad.clone()))
        return losses, grads, per_step, counts()

    runs = {s: stack_steps(s) for s in ("xla", "pallas")}
    for split, (losses, _, per_step, _) in runs.items():
        print(f"{SPLIT_STEPS} SGD steps through render_tiled_stack under "
              f"{split!r} at lr {LR} x {n_values}: loss {losses}; launches "
              f"per step {per_step[0]}", flush=True)
        want_k6 = 1 if split == "pallas" else 0
        require(all(c["banks_to_rows"] == want_k6
                    and c["fused_tiles_bwd"] == 1 for c in per_step),
                f"under {split!r} K6 did not launch {want_k6} times and K2 "
                f"once per step (over {n_groups} groups)")
        require(all(b < a for a, b in zip(losses, losses[1:])),
                f"the stack's loss does not fall under {split!r}")
    require(runs["xla"][0] == runs["pallas"][0],
            "the losses differ between the routes")
    for (xs, xc), (ps, pc) in zip(runs["xla"][1], runs["pallas"][1]):
        require(torch.equal(words(xs), words(ps))
                and torch.equal(words(xc), words(pc)),
                "d_sigma / d_color differ between the routes")
    print("the routes' losses, d_sigma and d_color equal bit for bit at "
          "every step", flush=True)
    stack_ms = {}
    for key in ("xla", "pallas", "pallas_again", "xla_again"):
        with split_route(tiled, key.split("_")[0]):
            stack_ms[key] = cuda_ms(torch, stack_trainer(LR)[1], STEPS,
                                    warmup=2)
    print(f"stack SGD step (lr {LR}): 'xla' {stack_ms['xla']:.4f} / "
          f"{stack_ms['xla_again']:.4f} ms, 'pallas' {stack_ms['pallas']:.4f}"
          f" / {stack_ms['pallas_again']:.4f} ms over {STEPS} steps "
          f"({card})", flush=True)
    report["stack"] = {"losses": runs["pallas"][0], "step_ms": stack_ms}
    k6_launches = runs["pallas"][3]["banks_to_rows"]
    k2_launches = runs["pallas"][3]["fused_tiles_bwd"]

    # 45. the sparse float32 field through Renderer.backward, in a child
    # process that reads DVREN_BWD_SPLIT=pallas at import
    env = dict(os.environ, DVREN_BWD_SPLIT="pallas")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--split-child"], env=env, capture_output=True,
                          text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"  [45] {line}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
        raise AssertionError(f"phase 45's child exited {proc.returncode}")
    report["sparse"] = json.loads(lines[-1])

    # 46. fit_dense_grid(mode="tiled") on two 512^2 views of the headline
    cams = [P.CameraConfig(c2w=tuple(plan.camera.c2w))]
    c2w = list(plan.camera.c2w)
    c2w[3] += SPLIT_VIEW_DX
    cams.append(P.CameraConfig(c2w=tuple(c2w)))
    t0 = time.perf_counter()
    _, t_merged, render_stack = fit._scheduled_views(plan, cams, field,
                                                     "tiled")
    with torch.no_grad():
        targets = render_stack(field, t_merged)
    ts = t_merged.sched
    print(f"fit views' merged schedule (the fit builds the same from the "
          f"same plans, bbox and grid): "
          f"{schedule_line(ts, time.perf_counter() - t0)}", flush=True)
    require(ts.tile_px == 16 and ts.cell_scale == 1,
            f"the cascade chose ({ts.tile_px} px, cell_scale "
            f"{ts.cell_scale}), not 16 px cells: K6 is not on this fit's path")
    student = field.with_params(torch.full_like(field.sigma, 0.5),
                                torch.full_like(field.color, 0.5))
    fits = {}
    for split in ("xla", "pallas"):
        with split_route(tiled, split):
            reset()
            res = fit.fit_dense_grid(
                plan, student, cams, targets,
                fit.FitConfig(learning_rate=5e-2, steps=SPLIT_FIT_STEPS,
                              target_psnr=None, sync_every=SPLIT_FIT_SYNC),
                mode="tiled")
            torch.cuda.synchronize()
            c = counts()
        # K6 recorded once in the step graph under "pallas": the warm-up
        # and the recording launch it through its wrapper, no replay does
        want_k6 = 1 if split == "pallas" else 0
        print(f"fit_dense_grid under {split!r}: mode {res.mode}, loss "
              f"{res.loss_history[0]:.6f} -> {res.loss_history[-1]:.6f}, "
              f"schedule_build_s {res.schedule_build_s:.4f}, steady_step_ms "
              f"{res.steady_step_ms:.4f}, recorded in the step graph "
              f"{res.recorded_launches}, launches {c} ({card})", flush=True)
        require(res.mode == "tiled" and res.steps_run == SPLIT_FIT_STEPS,
                f"the fit ran {res.mode} for {res.steps_run} steps")
        require(res.recorded_launches.get("banks_to_rows", 0) == want_k6
                and c["banks_to_rows"] == 2 * want_k6,
                f"the fit under {split!r} recorded K6 "
                f"{res.recorded_launches.get('banks_to_rows', 0)} times and "
                f"launched it {c['banks_to_rows']} times, not {want_k6} and "
                f"{2 * want_k6}")
        require(res.loss_history[-1] < res.loss_history[0],
                f"the fit's loss does not fall under {split!r}")
        fits[split] = res
    require(fits["xla"].loss_history == fits["pallas"].loss_history,
            "the fits' loss histories differ between the routes")
    for name in ("sigma", "color"):
        require(torch.equal(words(getattr(fits["xla"].field, name).detach()),
                            words(getattr(fits["pallas"].field, name)
                                  .detach())),
                f"the fits' final {name} differ between the routes")
    print("the fits' loss histories and final parameters equal bit for bit",
          flush=True)
    report["fit"] = {s: {"loss_history": r.loss_history,
                         "schedule_build_s": r.schedule_build_s,
                         "steady_step_ms": r.steady_step_ms}
                     for s, r in fits.items()}
    report["k2_bank_forms"] = forms

    kernels.append({
        "name": "banks_to_rows", "route": "cuda",
        "source": "dvren_tpu_torch/csrc/banks_to_rows.cu",
        "replaces": "dvren_tpu/ops/packed_transpose.py:153",
        "launches": k6_launches, "max_abs_err": 0.0, "ms": k6_ms,
        "plain_ms": k6_plain_ms, **k6_bound, "library_ms": k6_lib_ms})
    kernels.append(bank_entry("subs1", args, gss, sched, k2_launches, subs1))
    kernels += sub_entries
    return kernels, report


def run_split_child(torch, P, dev) -> dict:
    """Phase 45, in a process started with DVREN_BWD_SPLIT=pallas: the
    sparse float32 headline through Renderer.backward under both values
    of the flag (deterministic algorithms), four SGD steps on the bricks
    under "pallas", and the step under both."""
    from dvren_tpu_torch.opt.fit import mse
    from dvren_tpu_torch.render import graph, tiled

    counts = functools.partial(counts_of, DENSE)
    reset = graph.reset_launch_counts
    print(f"BWD_SPLIT read from the environment: {tiled.BWD_SPLIT!r}",
          flush=True)
    require(tiled.BWD_SPLIT == "pallas",
            "the child did not read DVREN_BWD_SPLIT=pallas at import")
    plan, config = headline_scene(P)
    base = P.DenseGridField.create(config, device=dev)
    sp = P.SparseGridField.from_dense(base, threshold=0.0, device=dev)
    sp.requires_grad_(False)
    require(sp.bricks.dtype == torch.float32
            and sp.occupied_bricks == sp.total_bricks,
            "the sparse field is not float32 with every brick")
    renderer = P.Renderer(P.Context.create(device="cuda"), plan)
    renderer.forward(sp)
    s_sched = renderer._tiled_schedule
    n = len(s_sched.groups)
    require(s_sched.table_kind == "sparse" and s_sched.cell_scale == 1,
            "the sparse forward did not take a sparse cell schedule")
    dl = np.random.default_rng(45).uniform(
        -1.0, 1.0, plan.ray_count * 3).astype(np.float32)
    grads = {}
    for split in ("xla", "pallas"):
        with split_route(tiled, split):
            renderer.forward(sp)
            reset()
            torch.use_deterministic_algorithms(True)
            try:
                g1 = renderer.backward(sp, dl)
                c = counts()
                g2 = renderer.backward(sp, dl)
            finally:
                torch.use_deterministic_algorithms(False)
        print(f"sparse Renderer.backward under {split!r}: launches {c}",
              flush=True)
        want = 1 if split == "pallas" else 0
        require(c["banks_to_rows"] == want and c["fused_tiles_bwd"] == 1,
                f"under {split!r} K6 did not launch {want} times and K2 once "
                f"(over {n} groups)")
        for key in ("bricks", "camera", "camera_k"):
            x = getattr(g1, key)
            require(bool(np.isfinite(x).all()) and float(np.abs(x).max()) > 0,
                    f"sparse backward {key} not finite or zero")
            require(np.array_equal(x.view(np.int32),
                                   getattr(g2, key).view(np.int32)),
                    f"sparse backward {key} differs between calls")
        grads[split] = g1
    for key in ("bricks", "camera", "camera_k"):
        require(np.array_equal(getattr(grads["xla"], key).view(np.int32),
                               getattr(grads["pallas"], key).view(np.int32)),
                f"sparse backward {key} differs between the routes")
    print("sparse d(bricks) and camera gradients equal bit for bit between "
          "the routes and between calls", flush=True)

    n_values = plan.height * plan.width * 3
    target = torch.zeros((plan.height, plan.width, 3), device=dev)

    def trainer(lr):
        f = P.SparseGridField.from_dense(base, threshold=0.0, device=dev)
        opt = torch.optim.SGD(f.parameters(), lr=lr)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = mse(tiled.render_tiled(plan, f, s_sched).image, target)
            loss.backward()
            opt.step()
            return loss

        return step

    step = trainer(LR * n_values)
    reset()
    losses = [float(step().detach()) for _ in range(SPLIT_STEPS)]
    c = counts()
    print(f"{SPLIT_STEPS} SGD steps on the bricks under 'pallas' at lr {LR} "
          f"x {n_values}: loss {losses}; launches {c}", flush=True)
    require(c["banks_to_rows"] == SPLIT_STEPS,
            "K6 did not launch once in every step")
    require(all(b < a for a, b in zip(losses, losses[1:])),
            "the sparse loss does not fall")
    step_ms = {}
    for key in ("xla", "pallas", "pallas_again", "xla_again"):
        with split_route(tiled, key.split("_")[0]):
            step_ms[key] = cuda_ms(torch, trainer(LR), STEPS, warmup=2)
    print(f"sparse SGD step (lr {LR}): 'xla' {step_ms['xla']:.4f} / "
          f"{step_ms['xla_again']:.4f} ms, 'pallas' {step_ms['pallas']:.4f} / "
          f"{step_ms['pallas_again']:.4f} ms over {STEPS} steps ({card_line()})",
          flush=True)
    return {"groups": n, "losses": losses, "step_ms": step_ms}


SHELL_N = 512       # tools/sparse_bench.py:50-82: the 512^3 SDF shell
SHELL_STEPS = 192
ORBIT_POSES = 6     # tools/animation_bench.py:114-135's orbit
ORBIT_NUMPY_POSES = 1   # poses timed again with the numpy builder
RESUME_STEPS = 4    # Adam steps before and after the train-state restore


@contextlib.contextmanager
def native_sched(flag: str):
    """DVREN_NATIVE_SCHED set to ``flag`` inside the block."""
    old = os.environ.get("DVREN_NATIVE_SCHED")
    os.environ["DVREN_NATIVE_SCHED"] = flag
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("DVREN_NATIVE_SCHED")
        else:
            os.environ["DVREN_NATIVE_SCHED"] = old


def schedule_digest(sched) -> str:
    """SHA-256 over every array and static of a numpy schedule: its
    groups, tile set, gather plan, canonical tile order and fallback."""
    import hashlib

    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, np.ndarray):
            h.update(str((x.shape, x.dtype)).encode())
            h.update(np.ascontiguousarray(x).tobytes())
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                h.update(f.name.encode())
                walk(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        else:
            h.update(repr(x).encode())

    walk(sched)
    return h.hexdigest()[:16]


def shell_scene(torch, P, dev, n=SHELL_N, width=512, steps=SHELL_STEPS):
    """tools/sparse_bench.py's scene: a thin SDF shell (sigma 30 where
    |r - 0.33| < 0.02) at n^3, its bricks built on the host from the
    numpy arrays (the dense field never goes to the card), and the plan
    (width^2, fixed steps, t 0.2-2.2, seed 3). Returns (plan, field,
    brick build s)."""
    from dvren_tpu_torch.fields.sparse_grid import build_bricks

    t0 = time.perf_counter()
    lin = np.linspace(0, 1, n, dtype=np.float32)
    zs, ys, xs = lin[:, None, None], lin[None, :, None], lin[None, None, :]
    r = np.sqrt((xs - .5) ** 2 + (ys - .5) ** 2 + (zs - .5) ** 2)
    sigma = np.where(np.abs(r - 0.33) < 0.02, 30.0, 0.0).astype(np.float32)
    del r
    color = np.empty((n, n, n, 3), np.float32)
    color[..., 0] = xs
    color[..., 1] = ys
    color[..., 2] = 1.0 - zs
    bricks, occupancy = build_bricks(sigma, color, 0.0)
    del sigma, color
    field = P.SparseGridField(torch.from_numpy(bricks).to(dev),
                              torch.from_numpy(occupancy).to(dev),
                              (n, n, n))
    del bricks
    build_s = time.perf_counter() - t0
    plan = P.Plan.create(P.PlanConfig(
        width=width, height=width, t_near=0.2, t_far=2.2, seed=3,
        camera=P.CameraConfig(
            k=(width * 1.2, 0, width / 2, 0, width * 1.2, width / 2,
               0, 0, 1),
            c2w=(1, 0, 0, .5, 0, 1, 0, .5, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / steps, max_steps=steps)))
    return plan, field, build_s


def table_args(torch, plan, table, sched):
    """K1's one-launch arguments over ``sched`` from any (R, C) table."""
    from dvren_tpu_torch.ops import fused_tiles
    from dvren_tpu_torch.render import tiled

    tabs = tiled._gather_banks_flat(table, sched.gathermap_all, sched.pitch)
    geom = (sched.bbox[0], sched.bbox[1], sched.grid_shape)
    return (tabs, sched.tiles,
            fused_tiles.tiles_op_params(plan, geom, sched.tiles, "cell"))


def frames_equal(a, b) -> bool:
    """Two Renderer results (or ImagePlanes) equal bit for bit."""
    def host(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else x
    return all(np.array_equal(host(getattr(a, k)), host(getattr(b, k)))
               for k in ("image", "transmittance", "opacity", "depth"))


def run_sched(torch, P, dev, card) -> tuple[list, dict]:
    """Phases 47-51: every option of the tile schedule builder and the
    modules that wait on them. 47: the native scheduler core against the
    numpy builder (schedule digests equal; build seconds of each) on the
    dense headline at 16 / 8 / 4 px, the fine grid's cascade and the
    512^3 SDF shell with occupancy at 8 px; 48: pitch 2 through
    ``Renderer(RenderOptions(tile_pitch=2))`` at the dense headline,
    float32 and bfloat16, frames, backwards and an SGD step bit-equal to
    pitch 1, K1 / K2 bit-equal to their twins on its schedule, the bank
    gather timed at both pitches; 49: the SDF shell through
    ``Renderer(RenderOptions(use_occupancy=True))``, its frame against the
    untrimmed one, its backward, K1 / K2 against their twins on the
    trimmed schedule, and pitch 2 on the shell; 50: the moving camera,
    six orbit poses through ``MovingCameraRenderer`` bit-equal to each
    pose's own schedule, one structure, host build / upload / render ms
    with each builder; 51: 4 Adam steps, ``save_train_state``, a restore
    into a fresh field and optimizer and 4 more, bit-equal to 8 steps."""
    from dvren_tpu_torch import native
    from dvren_tpu_torch.io.checkpoint import (load_train_state,
                                               save_train_state)
    from dvren_tpu_torch.ops import packed_transpose
    from dvren_tpu_torch.opt.fit import mse
    from dvren_tpu_torch.render import animate, graph, tiled

    counts = functools.partial(counts_of, DENSE)
    reset = graph.reset_launch_counts
    gen = torch.Generator(device=dev).manual_seed(47)
    kernels, report = [], {}
    t_phase = time.perf_counter()

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        report.setdefault("phase_s", {})[name] = now - t_phase
        t_phase = now

    # 47. the native core against the numpy builder
    t0 = time.perf_counter()
    native.library()
    print(f"native scheduler core build {time.perf_counter() - t0:.3f} s "
          f"(g++ {native.build_seconds} s)", flush=True)
    plan, config = headline_scene(P)
    field = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    fplan, fconfig = headline_scene(P, grid_n=128, max_steps=256)
    ffield = P.DenseGridField.create(fconfig, device=dev).requires_grad_(
        False)
    splan, sfield, brick_s = shell_scene(torch, P, dev)
    print(f"SDF shell {SHELL_N}^3: {sfield.occupied_bricks} of "
          f"{sfield.total_bricks} bricks kept, {sfield.memory_bytes() / 1e9:.3f}"
          f" GB on the card, bricks built in {brick_s:.1f} s", flush=True)
    builds = {f"headline_{px}px": (lambda px=px: tiled.build_tiled_schedule(
        plan, field, tile_px=px)) for px in (16, 8, 4)}
    builds["finegrid_cascade"] = (
        lambda: tiled.build_tiled_schedule_auto(fplan, ffield)[0])
    builds["shell_8px_occupancy"] = lambda: tiled.build_tiled_schedule(
        splan, sfield, tile_px=8, occupancy=True)
    report["builders"] = {}
    for name, build in builds.items():
        out = {}
        for flag in ("1", "0"):
            with native_sched(flag):
                t0 = time.perf_counter()
                sched = build()
                out[flag] = (time.perf_counter() - t0, schedule_digest(sched))
        row = {"schedule_build_s": {"native": out["1"][0],
                                    "numpy": out["0"][0]},
               "digest": out["1"][1], "groups": len(sched.groups),
               "tile_px": sched.tile_px, "cell_scale": sched.cell_scale,
               "tiled_samples": sched.tiled_samples,
               "fallback_rays": sched.fallback_rays}
        report["builders"][name] = row
        print(f"schedule {name}: native {out['1'][0]:.3f} s, numpy "
              f"{out['0'][0]:.3f} s, digests {out['1'][1]} / {out['0'][1]}; "
              f"{schedule_line(sched, out['1'][0])}", flush=True)
        require(out["1"][1] == out["0"][1],
                f"the native and numpy builders differ on {name}")
    del builds, ffield
    lap("47")

    # 48. pitch 2 at the dense headline, float32 and bfloat16
    n_values = plan.height * plan.width * 3
    dl = (torch.rand((plan.ray_count, 3), generator=gen, device=dev) * 2
          - 1).cpu().numpy()
    target = torch.zeros((plan.height, plan.width, 3), device=dev)
    report["pitch2"] = {}
    for dtype in ("float32", "bfloat16"):
        f = P.DenseGridField.create(config, device=dev).with_packed_dtype(
            dtype).requires_grad_(False)
        ctx = P.Context.create(device="cuda")
        r1 = P.Renderer(ctx, plan)
        r2 = P.Renderer(ctx, plan, P.RenderOptions(tile_pitch=2))
        a = r1.forward(f)
        reset()
        b = r2.forward(f)
        fwd_c = counts()
        s1, s2 = r1._tiled_schedule, r2._tiled_schedule
        print(f"pitch 2 {dtype}: pitch 1 {schedule_line(s1, 0)}; pitch 2 "
              f"{schedule_line(s2, build_ms(b.stats.notes) / 1e3)}; forward "
              f"launches {fwd_c}", flush=True)
        require(s2.pitch == 2 and s1.fallback_rays == s2.fallback_rays == 0,
                f"the {dtype} pitch-2 headline schedule has overflow rays")
        require(frames_equal(a, b),
                f"the {dtype} pitch-2 frame differs from pitch 1")
        torch.use_deterministic_algorithms(True)
        try:
            g1 = r1.backward(f, dl)
            reset()
            g2 = r2.backward(f, dl)
            bwd_c = counts()
        finally:
            torch.use_deterministic_algorithms(False)
        for key in ("sigma", "color", "camera", "camera_k"):
            require(float(np.abs(getattr(g1, key)).max()) > 0
                    and np.array_equal(getattr(g1, key), getattr(g2, key)),
                    f"the {dtype} pitch-2 backward {key} differs from pitch 1")
        stepped = []
        for s in (s1, s2):
            student = P.DenseGridField.create(
                config, device=dev).with_packed_dtype(dtype)
            opt = torch.optim.SGD(student.parameters(), lr=LR * n_values)
            reset()
            opt.zero_grad(set_to_none=True)
            mse(tiled.render_tiled(plan, student, s).image,
                target).backward()
            opt.step()
            step_c = counts()
            stepped.append(student)
        require(torch.equal(stepped[0].sigma, stepped[1].sigma)
                and torch.equal(stepped[0].color, stepped[1].color)
                and not torch.equal(stepped[1].sigma, f.sigma),
                f"the {dtype} pitch-2 SGD step differs from pitch 1")
        table_k = ("packed_table", "packed_table_bwd") if dtype == "float32" \
            else ("packed_table16", "packed_table16_bwd")
        require(fwd_c["fused_tiles"] > 0 and fwd_c[table_k[0]] > 0
                and bwd_c["fused_tiles_bwd"] > 0 and bwd_c[table_k[1]] > 0
                and step_c["fused_tiles_bwd"] > 0,
                f"the {dtype} pitch-2 path skipped a kernel: forward {fwd_c}"
                f", backward {bwd_c}")
        args = [variant_args(torch, plan, f, s2)]
        errs = twins_bit_equal(torch, args, gen, SUBSET)
        if dtype == "float32":
            table = packed_transpose.build_rows(f.sigma, f.color)
        else:
            table = packed_transpose.build_rows16(
                f.sigma, f.color, getattr(torch, dtype))
        gather = [cuda_ms(torch, lambda s=s: tiled._gather_banks_flat(
            table, s.gathermap_all, s.pitch), 20) for s in (s1, s2)]
        with torch.no_grad():
            frame = [cuda_ms(torch, lambda s=s: tiled.render_tiled(
                plan, f, s), 10) for s in (s1, s2)]
        row = {"groups": [len(s1.groups), len(s2.groups)],
               "lanes": [int(s1.hostmap_all.numel()),
                         int(s2.hostmap_all.numel())],
               "gather_ms": gather, "frame_ms": frame,
               "build_s": build_ms(b.stats.notes) / 1e3}
        print(f"pitch 2 {dtype} [{card}]: frames, backwards (sigma, colour, "
              f"camera) and an SGD step at lr {LR} x {n_values} bit-equal to "
              f"pitch 1; K1 / K2 == twins on the first {SUBSET} tiles of "
              f"every group; bank gather ms pitch 1 / 2 {gather[0]:.4f} / "
              f"{gather[1]:.4f} over {row['lanes'][0]} / {row['lanes'][1]} "
              f"lanes; frame ms {frame[0]:.4f} / {frame[1]:.4f}", flush=True)
        if dtype == "float32":
            gss = tile_gss(torch, args, gen)
            times = variant_times(torch, args, gss)
            row.update(k1_ms=times[0], k2_ms=times[1])
            print(f"pitch 2 K1 {times[0]:.4f} ms (plain {times[2]:.4f}), K2 "
                  f"{times[1]:.4f} (plain {times[3]:.4f})", flush=True)
            kernels.extend(variant_kernels(
                f"pitch2_{s2.tile_px}px", args, gss, s2,
                (fwd_c["fused_tiles"], step_c["fused_tiles_bwd"]), errs,
                times))
        report["pitch2"][dtype] = row
        del r1, r2, a, b, g1, g2, stepped, table, args
    lap("48")

    # 49. the SDF shell with occupancy, through the cascade
    ctx = P.Context.create(device="cuda")
    r_occ = P.Renderer(ctx, splan, P.RenderOptions(use_occupancy=True))
    reset()
    res = r_occ.forward(sfield)
    occ_c = counts()
    sched = r_occ._tiled_schedule
    r_full = P.Renderer(ctx, splan)
    full = r_full.forward(sfield)
    sched_full = r_full._tiled_schedule
    err = max(float(np.abs(getattr(res, k) - getattr(full, k)).max())
              for k in ("image", "transmittance", "opacity"))
    depth = float(np.abs(res.depth - full.depth).max())
    hit = np.array_equal(res.hitmask, full.hitmask)
    bit_equal = frames_equal(res, full)
    print(f"shell use_occupancy: {schedule_line(sched, build_ms(res.stats.notes) / 1e3)}"
          f"; untrimmed {sched_full.tiled_samples} live samples, fallback "
          f"rays {sched_full.fallback_rays}; notes {res.stats.notes}; "
          f"launches {occ_c}; frame vs untrimmed: planes {err:.3e}, depth "
          f"{depth:.3e}, hitmask equal {hit}, bit-equal {bit_equal}",
          flush=True)
    require(err <= TOL and hit, "the trimmed shell frame differs from the "
            "untrimmed one")
    require(sched.tiled_samples < sched_full.tiled_samples,
            "occupancy trimmed no sample of the shell")
    require(float(res.opacity.max()) > 0.5, "the shell is not visible")
    require(occ_c["fused_tiles"] > 0, "K1 did not launch on the shell")
    sdl = (torch.rand((splan.ray_count, 3), generator=gen, device=dev) * 2
           - 1).cpu().numpy()
    torch.use_deterministic_algorithms(True)
    try:
        reset()
        t0 = time.perf_counter()
        g = r_occ.backward(sfield, sdl)
        bwd_s = time.perf_counter() - t0
        sbwd_c = counts()
        g_again = r_occ.backward(sfield, sdl)
    finally:
        torch.use_deterministic_algorithms(False)
    require(bool(np.isfinite(g.bricks).all())
            and float(np.abs(g.bricks).max()) > 0
            and np.array_equal(g.bricks, g_again.bricks),
            "the shell backward is not finite, zero or repeatable")
    require(sbwd_c["fused_tiles_bwd"] > 0, "K2 did not launch on the shell")
    table = sfield.bricks.detach().reshape(-1, 32)
    args = [table_args(torch, splan, table, sched)]
    errs = twins_bit_equal(torch, args, gen, SUBSET)
    # pitch 2 at tools/sparse_bench.py's 8 px (at the cascade's 4 px the
    # inflated lanes pass the 15-bit lane id, which build_tiled_schedule
    # refuses)
    s1 = tiled.build_tiled_schedule(splan, sfield, tile_px=8,
                                    occupancy=True).to(dev)
    s2 = tiled.build_tiled_schedule(splan, sfield, tile_px=8,
                                    occupancy=True, pitch=2).to(dev)
    with torch.no_grad():
        p1 = tiled.render_tiled(splan, sfield, s1)
        p2 = tiled.render_tiled(splan, sfield, s2)
    err2 = max(float((getattr(p1, k) - getattr(p2, k)).abs().max())
               for k in ("image", "transmittance", "opacity"))
    require(s2.pitch == 2, "the shell's pitch-2 schedule demoted")
    require(err2 <= TOL and (s2.fallback_rays != s1.fallback_rays
                             or frames_equal(p1, p2)),
            "the shell's pitch-2 frame differs from pitch 1")
    twins_bit_equal(torch, [table_args(torch, splan, table, s2)], gen, SUBSET)
    gss = tile_gss(torch, args, gen)
    times = variant_times(torch, args, gss)
    with torch.no_grad():
        frame = [cuda_ms(torch, lambda s=s: tiled.render_tiled(
            splan, sfield, s), 5) for s in (sched, sched_full)]
    report["shell"] = {
        "bricks": sfield.occupied_bricks, "brick_build_s": brick_s,
        "tile_px": sched.tile_px, "groups": len(sched.groups),
        "tiled_samples": sched.tiled_samples,
        "tiled_samples_untrimmed": sched_full.tiled_samples,
        "fallback_rays": sched.fallback_rays,
        "fallback_rays_untrimmed": sched_full.fallback_rays,
        "vs_untrimmed": err, "bit_equal": bit_equal,
        "frame_ms": frame[0], "frame_ms_untrimmed": frame[1],
        "backward_s": bwd_s, "k1_ms": times[0], "k2_ms": times[1],
        "pitch1_8px_fallback_rays": s1.fallback_rays,
        "pitch2_8px_fallback_rays": s2.fallback_rays,
        "pitch2_vs_pitch1": err2, "pitch2_frame_equal": frames_equal(p1, p2)}
    print(f"shell [{card}]: trimmed frame {frame[0]:.4f} ms, untrimmed "
          f"{frame[1]:.4f}; backward {bwd_s:.3f} s (host copy included); K1 "
          f"{times[0]:.4f} (plain {times[2]:.4f}), K2 {times[1]:.4f} (plain "
          f"{times[3]:.4f}); K1 / K2 == twins on the trimmed schedule and on "
          f"the 8 px pitch-2 one (fallback rays {s2.fallback_rays}, pitch 1 "
          f"{s1.fallback_rays}; frame vs pitch 1 {err2:.3e}, bit-equal "
          f"{report['shell']['pitch2_frame_equal']})", flush=True)
    kernels.extend(variant_kernels(
        f"shell_occupancy_{sched.tile_px}px", args, gss, sched,
        (occ_c["fused_tiles"], sbwd_c["fused_tiles_bwd"]), errs, times))
    del r_occ, r_full, res, full, g, g_again, args, gss, s1, s2, p1, p2
    del sched, sched_full, table, sfield
    torch.cuda.empty_cache()
    lap("49")

    # 50. the moving camera over the dense headline
    def orbit(i):
        ang = 2 * np.pi * i / ORBIT_POSES
        return headline_scene(P, tx=0.5 + 0.1 * np.sin(ang),
                              ty=0.5 + 0.05 * np.cos(ang))[0]

    mover = animate.MovingCameraRenderer(plan, field)
    poses = []
    reset()
    for i in range(ORBIT_POSES):
        p_i = orbit(i)
        t0 = time.perf_counter()
        host = mover.host_schedule(p_i, field)
        t1 = time.perf_counter()
        dev_sched = host.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.no_grad():
            planes = tiled.render_tiled(plan, field, dev_sched)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        poses.append({"build_ms": (t1 - t0) * 1e3,
                      "upload_ms": (t2 - t1) * 1e3,
                      "render_ms": (t3 - t2) * 1e3})
        with torch.no_grad():
            ref = tiled.render_tiled(p_i, field, tiled.build_tiled_schedule(
                p_i, field).to(dev))
        require(frames_equal(planes, ref),
                f"orbit pose {i} differs from its own schedule's frame")
    orbit_c = counts()
    require(mover.cache_size() == 1, "the orbit met more than one schedule "
            "structure")
    require(orbit_c["fused_tiles"] > 0 and orbit_c["packed_table"] > 0,
            f"the orbit skipped a kernel: {orbit_c}")
    numpy_ms = []
    with native_sched("0"):
        for i in range(ORBIT_NUMPY_POSES):
            p_i = orbit(i)
            t0 = time.perf_counter()
            mover.host_schedule(p_i, field)
            numpy_ms.append((time.perf_counter() - t0) * 1e3)
    report["orbit"] = {"uniform_shape": list(mover.uniform_shape),
                       "poses": poses, "numpy_build_ms": numpy_ms,
                       "structures": mover.cache_size()}
    print(f"orbit [{card}]: {ORBIT_POSES} poses bit-equal to their own "
          f"schedules, uniform_shape {mover.uniform_shape}, one structure; "
          f"per pose ms (host build, upload, render) "
          f"{[(round(p['build_ms'], 3), round(p['upload_ms'], 3), round(p['render_ms'], 3)) for p in poses]}; "
          f"numpy host build ms {[round(x, 3) for x in numpy_ms]}; "
          f"launches {orbit_c}", flush=True)
    lap("50")

    # 51. the train-state checkpoint: 4 + 4 Adam steps against 8
    import tempfile

    sched = tiled.build_tiled_schedule(plan, field).to(dev)
    with torch.no_grad():
        teacher = tiled.render_tiled(plan, field, sched).image

    def student():
        s = P.DenseGridField.create(config, device=dev)
        with torch.no_grad():
            s.sigma.fill_(0.5)
            s.color.fill_(0.5)
        return s, torch.optim.Adam(s.parameters(), lr=5e-2)

    def adam(s, opt, n):
        for _ in range(n):
            opt.zero_grad(set_to_none=True)
            mse(tiled.render_tiled(plan, s, sched).image, teacher).backward()
            opt.step()

    straight, opt = student()
    adam(straight, opt, 2 * RESUME_STEPS)
    first, opt = student()
    adam(first, opt, RESUME_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_state.npz")
        t0 = time.perf_counter()
        save_train_state(path, {"params": first.state_dict(),
                                "optim": opt.state_dict()},
                         {"step": RESUME_STEPS})
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        resumed, opt2 = student()
        t0 = time.perf_counter()
        state, header = load_train_state(
            path, {"params": resumed.state_dict(),
                   "optim": opt2.state_dict()})
        resumed.load_state_dict(state["params"])
        opt2.load_state_dict(state["optim"])
        load_s = time.perf_counter() - t0
    reset()
    adam(resumed, opt2, RESUME_STEPS)
    resume_c = counts()
    require(header == {"step": RESUME_STEPS}
            and torch.equal(resumed.sigma, straight.sigma)
            and torch.equal(resumed.color, straight.color)
            and not torch.equal(first.sigma, straight.sigma),
            "the resumed Adam run differs from the uninterrupted one")
    require(resume_c["fused_tiles_bwd"] == RESUME_STEPS
            and resume_c["packed_table_bwd"] == RESUME_STEPS,
            f"the resumed steps skipped a kernel: {resume_c}")
    report["train_state"] = {"bytes": size, "save_s": save_s,
                             "load_s": load_s}
    print(f"train state: {RESUME_STEPS} Adam steps, saved ({size} bytes, "
          f"{save_s:.3f} s), restored into a fresh field and optimizer "
          f"({load_s:.3f} s), {RESUME_STEPS} more: bit-equal to "
          f"{2 * RESUME_STEPS} uninterrupted steps; launches {resume_c}",
          flush=True)
    lap("51")
    return kernels, report


# ------------------------------------------------------ phases 52-57: general

GENERAL_RUNS = 10        # timed runs per frame and backward (median, spread)
OVERRIDE_OFFSET = 0.25   # px: phase 55's two rays per pixel sit at +- this


def event_times(torch, fn, runs=GENERAL_RUNS, warmup=1) -> dict:
    """``fn`` timed ``runs`` times after ``warmup`` runs, each after a
    synchronize between its own CUDA events (``utils/timing.time_calls``):
    the median, least and largest ms."""
    from dvren_tpu_torch.utils import timing

    t = timing.time_calls(fn, [()], runs, warmup, cuda=True)
    return {"median": t["median_s"] * 1e3, "min": t["min_s"] * 1e3,
            "max": t["max_s"] * 1e3, "runs": runs}


def spread(t: dict) -> str:
    return (f"{t['median']:.4f} ({t['min']:.4f}-{t['max']:.4f}, "
            f"{t['runs']} runs)")


def lattice_blocks(torch, plan, field, jitter, tile):
    """The integrator's inputs per block of ``tile`` generated rays, as
    ``render_streamed`` builds them: (sigma, (r, g, b), dt, mask, None)."""
    from dvren_tpu_torch.ops.raygen import generate_rays
    from dvren_tpu_torch.ops.sampling import generate_samples
    from dvren_tpu_torch.render.pipeline import eval_fields

    out = []
    pad = -(-plan.ray_count // tile) * tile - jitter.shape[0]
    if pad > 0:
        jitter = torch.cat([jitter, jitter.new_zeros((pad, jitter.shape[1]))])
    with torch.no_grad():
        for start in range(0, plan.ray_count, tile):
            rays = generate_rays(plan, start=start, count=tile,
                                 device=field.device)
            lat = generate_samples(plan, rays, ray_index_offset=start,
                                   jitter=jitter[start:start + tile])
            sigma, color = eval_fields(field, lat)
            out.append((sigma, color, lat.dt, lat.mask, None))
    return out


def outputs_inputs(outputs):
    """A fused, staged or override forward's integrator inputs."""
    return [(outputs.sigma, outputs.color, outputs.lattice.dt,
             outputs.lattice.mask, None)]


def no_floor(b: dict) -> str:
    return "" if b["bound_is_floor"] else " (its bytes fit in L2: no floor)"


def k9_entries(torch, form, inputs, gs, launches, span, per_frame):
    """K9f / K9b against their twins on ``inputs`` (one launch per block),
    timed on the device and as issued, with bounds over the processed
    steps and waves: the kernels line's two entries for this form."""
    errs = k9_against_twins(torch, inputs, gs, form, *span)
    proc, early = processed_steps(torch, inputs)
    t = k9_times(torch, inputs, gs, *span)
    fb, bb = k9_bounds(torch, inputs, proc)
    waves = k9_waves(torch, inputs)
    n = len(inputs)
    print(f"K9 at {form} [{per_frame}]: {n} launch(es) over "
          f"{tuple(inputs[0][0].shape)}; ms device / issued: K9f "
          f"{t['k9f_ms']:.4f} / {t['k9f_issued_ms']:.4f} ("
          f"{t['k9f_ms'] / n:.4f} per launch; twin {t['k9f_plain_ms']:.4f}, "
          f"bound {fb['bound_ms']:.4f} by {fb['bound_by']}, "
          f"{fb['bound_ms'] / t['k9f_ms']:.3f} of it{no_floor(fb)}; waves "
          f"{waves['integrate']:.3f}), K9b {t['k9b_ms']:.4f} / "
          f"{t['k9b_issued_ms']:.4f} ({t['k9b_ms'] / n:.4f} per launch; twin "
          f"{t['k9b_plain_ms']:.4f}, bound {bb['bound_ms']:.4f}, "
          f"{bb['bound_ms'] / t['k9b_ms']:.3f} of it{no_floor(bb)}; waves "
          f"{waves['integrate_bwd']:.3f}); {proc} processed steps, {early} "
          f"rays stop early; vs twins K9f {errs[0]:.3e}, K9b {errs[1]:.3e}",
          flush=True)
    return [
        {"name": f"integrate:{form}", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/integrate.cu",
         "replaces": "dvren_tpu/ops/integrate_pallas.py:158",
         "launches": launches["integrate"], "max_abs_err": errs[0],
         "ms": t["k9f_ms"], "issued_ms": t["k9f_issued_ms"],
         "ms_per_launch": t["k9f_ms"] / n, "plain_ms": t["k9f_plain_ms"],
         "waves": waves["integrate"], **fb},
        {"name": f"integrate_bwd:{form}", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/integrate_bwd.cu",
         "replaces": "dvren_tpu/ops/integrate_pallas.py:192",
         "launches": launches["integrate_bwd"], "max_abs_err": errs[1],
         "ms": t["k9b_ms"], "issued_ms": t["k9b_issued_ms"],
         "ms_per_launch": t["k9b_ms"] / n, "plain_ms": t["k9b_plain_ms"],
         "waves": waves["integrate_bwd"], **bb}]


def override_bundle(torch, P, plan, dev):
    """(the override plan, its Rays): two rays a pixel of ``plan``, its
    pixel centres moved by -+OVERRIDE_OFFSET px."""
    from dvren_tpu_torch.ops.raygen import Rays, generate_rays

    n_over = 2 * plan.ray_count
    oplan = P.Plan.create(dataclasses.replace(plan.descriptor(),
                                              max_rays=n_over, max_samples=0))
    parts = []
    for dx in (-OVERRIDE_OFFSET, OVERRIDE_OFFSET):
        k = list(plan.camera.k)
        k[2] -= dx                  # cx: the ray's pixel centre moves dx
        shifted = plan.with_camera(dataclasses.replace(plan.camera,
                                                       k=tuple(k)))
        parts.append(generate_rays(shifted, device=dev))
    return oplan, Rays(*(torch.cat([getattr(p, f) for p in parts]) for f in
                         ("origins", "directions", "t_near", "t_far",
                          "pixel_ids")))


def grads_error(torch, got, ref) -> float:
    """The largest grid-gradient difference over max |ref|, sigma and
    colour."""
    return max(rel_err(torch.from_numpy(getattr(got, k)),
                       torch.from_numpy(getattr(ref, k)))
               for k in ("sigma", "color"))


def camera_close(got, ref) -> bool:
    return (np.allclose(got.camera, ref.camera, rtol=CAM_RTOL, atol=CAM_ATOL)
            and np.allclose(got.camera_k, ref.camera_k, rtol=CAM_RTOL,
                            atol=CAM_ATOL))


def results_equal(a, b, keys) -> bool:
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in keys)


FRAME_KEYS = ("image", "transmittance", "opacity", "depth", "hitmask")
GRAD_KEYS = ("sigma", "color", "camera", "camera_k")


def deterministic_backward(torch, renderer, field, dl, counts, reset):
    """Two ``Renderer.backward`` calls under
    ``torch.use_deterministic_algorithms``: (first, second, the first's
    launch counts)."""
    reset()
    torch.use_deterministic_algorithms(True)
    try:
        g1 = renderer.backward(field, dl)
        c = counts()
        g2 = renderer.backward(field, dl)
    finally:
        torch.use_deterministic_algorithms(False)
    for key in GRAD_KEYS:
        require(bool(np.isfinite(getattr(g1, key)).all()),
                f"backward {key} not finite")
    return g1, g2, c


def run_general(torch, P, dev, card) -> tuple[list, dict]:
    """Phases 52-57: the Renderer's general paths on the card (streamed,
    fused, staged, override; fields the tiles refuse; the hash field
    streamed; ``render_views``) over K9f / K9b."""
    from dvren_tpu_torch.ops.compose import compose
    from dvren_tpu_torch.opt import fit
    from dvren_tpu_torch.render import graph, pipeline

    counts = functools.partial(counts_of, WINDOW)
    reset = graph.reset_launch_counts
    gen = torch.Generator(device=dev).manual_seed(52)
    kernels, report = [], {}
    ctx = P.Context.create(device="cuda")

    # 52. the dense headline streamed: use_tiles=False at 512^2 x 128 is
    # past the streaming budget (33,554,432 > 4,194,304 samples)
    plan, config = headline_scene(P)
    field = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    span = (plan.t_near, plan.t_far)
    tiled_r = P.Renderer(ctx, plan)
    tframe = tiled_r.forward(field)
    streamed = P.Renderer(ctx, plan, P.RenderOptions(use_tiles=False))
    torch.cuda.reset_peak_memory_stats()
    reset()
    res = streamed.forward(field)
    fwd_c = counts()
    peak_fwd = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"streamed Renderer.forward: mode {streamed._last_mode}, "
          f"{res.stats.total_ms:.3f} ms, launches {fwd_c}, notes "
          f"{res.stats.notes}, peak {peak_fwd:.1f} MiB", flush=True)
    tile = pipeline.default_ray_tile(plan)
    n_blocks = -(-plan.ray_count // tile)
    require(streamed._last_mode == "streamed" and n_blocks == 8
            and fwd_c["integrate"] == n_blocks
            and fwd_c["integrate_bwd"] == 0,
            f"the streamed headline did not launch K9f once per block "
            f"({n_blocks} of {tile} rays): {fwd_c}")
    jitter = streamed._device_jitter()
    with torch.no_grad():
        plain = pipeline.render_streamed(plan, field, jitter=jitter,
                                         use_kernel=False)
    err, depth, hit = planes_errors(res, plain)
    t_err, _, t_hit = planes_errors(res, tiled_frame_planes(torch, tframe,
                                                            plan))
    t_depth, t_share, t_ulps = depth_error(res.depth, tframe.depth,
                                           tframe.opacity, plan.t_far)
    print(f"streamed frame vs use_kernel=False on the card: planes "
          f"{err:.3e}, depth {depth:.3e}, hitmask {hit}; vs the tiled frame: "
          f"planes {t_err:.3e}, depth {t_depth:.3e} ({t_share:.3f} of its "
          f"per-ray bound 1e-4 + {DEPTH_ULPS} ulps x t_far / opacity, "
          f"{t_ulps:.3f} ulps past 1e-4), hitmask {t_hit}", flush=True)
    require(err <= TOL and depth <= TOL_DEPTH and hit,
            "the streamed frame differs from the plain path")
    require(t_err <= TOL and t_share <= 1.0 and t_hit,
            "the streamed frame differs from the tiled frame")
    dl = (torch.rand((plan.ray_count, 3), generator=gen, device=dev) * 2
          - 1).cpu().numpy()
    tiled_g = tiled_r.backward(field, dl)
    torch.cuda.reset_peak_memory_stats()
    sg1, sg2, s_bwd_c = deterministic_backward(torch, streamed, field, dl,
                                               counts, reset)
    peak_bwd = torch.cuda.max_memory_allocated() / 2 ** 20
    s_err = grads_error(torch, sg1, tiled_g)
    print(f"streamed Renderer.backward launches {s_bwd_c} (K9f: the blocks "
          f"recomputed), peak {peak_bwd:.1f} MiB; vs the tiled backward: "
          f"grids {s_err:.3e} x scale, camera "
          f"{float(np.abs(sg1.camera - tiled_g.camera).max()):.3e}, camera_k "
          f"{float(np.abs(sg1.camera_k - tiled_g.camera_k).max()):.3e}",
          flush=True)
    require(s_bwd_c["integrate_bwd"] > 0, "the streamed backward ran no K9b")
    require(s_err <= GRID_TOL and camera_close(sg1, tiled_g),
            "the streamed backward differs from the tiled backward")
    require(results_equal(sg1, sg2, GRAD_KEYS),
            "the streamed backward differs between two calls")
    s_frame = event_times(torch, lambda: streamed.forward(field))
    s_back = event_times(torch, lambda: streamed.backward(field, dl))
    s_blocks = lattice_blocks(torch, plan, field, jitter, tile)
    s_gs = [torch.rand((tile, 3), generator=gen, device=dev) * 2 - 1
            for _ in s_blocks]
    kernels += k9_entries(torch, "streamed_headline", s_blocks, s_gs,
                          {"integrate": fwd_c["integrate"],
                           "integrate_bwd": s_bwd_c["integrate_bwd"]},
                          span, card)
    del s_blocks
    breakdown = device_breakdown(torch, lambda: (streamed.forward(field),
                                                 streamed.backward(field, dl)),
                                 steps=2)
    if breakdown is None:
        print("streamed step under torch.profiler: no device time recorded",
              flush=True)
    else:
        busy, wall, rows = breakdown
        print(f"streamed step (forward + backward) under torch.profiler "
              f"[{card}]: kernels {busy:.3f} of {wall:.3f} ms wall (busy "
              f"{busy / wall:.3f}); top: "
              + "; ".join(f"{name} {ms:.3f} ms x{n}" for name, ms, n in rows),
              flush=True)
    print(f"streamed headline times ms [{card}]: Renderer.forward "
          f"{spread(s_frame)}, Renderer.backward {spread(s_back)}",
          flush=True)
    report["streamed"] = {
        "frame_ms": s_frame, "backward_ms": s_back, "vs_plain": err,
        "vs_tiled": t_err, "vs_tiled_depth": t_depth,
        "vs_tiled_grads": s_err, "peak_fwd_mib": peak_fwd,
        "peak_bwd_mib": peak_bwd,
        "profile": None if breakdown is None else {
            "busy_ms": breakdown[0], "wall_ms": breakdown[1],
            "top": breakdown[2]}}

    # 53. the headline fused and staged: the whole lattice at once
    frames, grads, renderers = {}, {}, {}
    for mode, opts in (("fused", dict(use_tiles=False, streaming=False)),
                       ("staged", dict(use_tiles=False, streaming=False,
                                       use_fused_path=False))):
        r = P.Renderer(ctx, plan, P.RenderOptions(**opts))
        torch.cuda.reset_peak_memory_stats()
        reset()
        frames[mode] = r.forward(field)
        c = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        st = frames[mode].stats
        print(f"{mode} Renderer.forward: {st.total_ms:.3f} ms, launches {c}, "
              f"stages ms ray {st.ray_ms:.3f} sample {st.sample_ms:.3f} "
              f"integrate {st.integrate_ms:.3f} compose {st.compose_ms:.3f}, "
              f"peak {peak:.1f} MiB", flush=True)
        require(r._last_mode == "fused" and c["integrate"] == 1,
                f"the {mode} forward did not launch K9f once: {c}")
        torch.cuda.reset_peak_memory_stats()
        g1, g2, bc = deterministic_backward(torch, r, field, dl, counts,
                                            reset)
        bpeak = torch.cuda.max_memory_allocated() / 2 ** 20
        print(f"{mode} Renderer.backward launches {bc}, peak {bpeak:.1f} "
              f"MiB", flush=True)
        require(bc["integrate_bwd"] == 1 and bc["integrate"] == 0,
                f"the {mode} backward did not launch K9b once: {bc}")
        require(results_equal(g1, g2, GRAD_KEYS),
                f"the {mode} backward differs between two calls")
        grads[mode], renderers[mode] = g1, r
        report[mode] = {"peak_fwd_mib": peak, "peak_bwd_mib": bpeak,
                        "forward_launches": c, "backward_launches": bc}
    st = frames["staged"].stats
    require(min(st.ray_ms, st.sample_ms, st.integrate_ms, st.compose_ms) > 0,
            "a staged stage time is not positive")
    require(results_equal(frames["fused"], frames["staged"], FRAME_KEYS),
            "the fused and staged frames differ")
    f_err, f_depth, f_hit = planes_errors(frames["fused"],
                                          tiled_frame_planes(torch, res, plan))
    g_err = grads_error(torch, grads["fused"], sg1)
    print(f"fused == staged bit for bit; fused vs streamed: planes "
          f"{f_err:.3e}, depth {f_depth:.3e}, hitmask {f_hit}; grads "
          f"{g_err:.3e} x scale, staged grads equal to fused "
          f"{results_equal(grads['fused'], grads['staged'], GRAD_KEYS)}",
          flush=True)
    require(f_err <= TOL and f_depth <= TOL_DEPTH and f_hit,
            "the fused frame differs from the streamed frame")
    require(g_err <= GRID_TOL and camera_close(grads["fused"], sg1)
            and grads_error(torch, grads["staged"], sg1) <= GRID_TOL,
            "the fused or staged backward differs from the streamed one")
    fused = renderers["fused"]
    outputs = fused.last_outputs
    with torch.no_grad():
        d_sigma, d_color = fused._sample_grads(outputs, dl)
        mask = outputs.lattice.mask
        want_s, want_c = d_sigma[mask].cpu().numpy(), d_color[mask].cpu().numpy()
    got_s, got_c = fused.per_sample_gradients(dl)
    require(np.array_equal(got_s, want_s) and np.array_equal(got_c, want_c),
            "per_sample_gradients differs from the backward's d_sigma / "
            "d_color")
    print(f"per_sample_gradients == the backward's per-sample gradients: "
          f"{got_s.shape[0]} live samples", flush=True)
    del d_sigma, d_color
    for mode in ("fused", "staged"):
        r = renderers[mode]
        report[mode]["frame_ms"] = event_times(torch, lambda: r.forward(field))
        report[mode]["backward_ms"] = event_times(
            torch, lambda: r.backward(field, dl))
        print(f"{mode} headline times ms [{card}]: Renderer.forward "
              f"{spread(report[mode]['frame_ms'])}, Renderer.backward "
              f"{spread(report[mode]['backward_ms'])}", flush=True)
    f_gs = [torch.rand((plan.ray_count, 3), generator=gen, device=dev) * 2
            - 1]
    kernels += k9_entries(
        torch, "fused_headline", outputs_inputs(outputs), f_gs,
        {"integrate": report["fused"]["forward_launches"]["integrate"],
         "integrate_bwd":
             report["fused"]["backward_launches"]["integrate_bwd"]},
        span, card)
    del renderers, outputs, f_gs
    torch.cuda.empty_cache()
    # K9 at 131,072 x 128: the headline streamed in two blocks, forward
    # and backward (the blocks recomputed), then the first block timed
    half = plan.ray_count // 2
    leaf = field.with_params(field.sigma.detach().clone().requires_grad_(),
                             field.color.detach().clone().requires_grad_())
    reset()
    img = pipeline.render_streamed(plan, leaf, ray_tile=half,
                                   jitter=jitter).image
    h_fwd = counts()["integrate"]
    torch.autograd.grad(img.sum(), (leaf.sigma, leaf.color))
    h_c = {"integrate": h_fwd, "integrate_bwd": counts()["integrate_bwd"]}
    require(h_c == {"integrate": 2, "integrate_bwd": 2},
            f"the two-block stream launched {h_c}")
    del img, leaf
    h_blocks = lattice_blocks(torch, plan, field, jitter, half)[:1]
    h_gs = [torch.rand((half, 3), generator=gen, device=dev) * 2 - 1]
    kernels += k9_entries(torch, "rays_131072", h_blocks, h_gs, h_c, span,
                          card)
    del h_blocks, h_gs
    torch.cuda.empty_cache()

    # 54. fields the tiles refuse, under the default options on the card
    for name, change in (("nearest", dict(interp=P.InterpMode.NEAREST)),
                         ("clamp", dict(oob=P.OobPolicy.CLAMP))):
        f2 = P.DenseGridField.create(dataclasses.replace(config, **change),
                                     device=dev).requires_grad_(False)
        r = P.Renderer(ctx, plan)
        reset()
        got = r.forward(f2)
        c = counts()
        require(r._last_mode == "streamed" and c["integrate"] == n_blocks,
                f"the {name} field did not take the streamed path: "
                f"{r._last_mode}, {c}")
        with torch.no_grad():
            want = pipeline.render_streamed(plan, f2, jitter=jitter,
                                            use_kernel=False)
        e, d, h = planes_errors(got, want)
        g, _, bc = deterministic_backward(torch, r, f2, dl, counts, reset)
        ref = r._backward_replay(
            f2, dl.reshape(-1, 3), None,
            lambda leaf, k0, c2w0: pipeline.render_streamed(
                plan, leaf, k=k0, c2w=c2w0, jitter=jitter,
                use_kernel=False))
        ge = grads_error(torch, g, ref)
        print(f"{name} field (default options): mode {r._last_mode}, "
              f"launches {c}; frame vs use_kernel=False planes {e:.3e}, "
              f"depth {d:.3e}, hitmask {h}; backward launches {bc}, grads "
              f"{ge:.3e} x scale", flush=True)
        require(e <= TOL and d <= TOL_DEPTH and h,
                f"the {name} frame differs from the plain path")
        require(bc["integrate_bwd"] > 0 and ge <= GRID_TOL
                and camera_close(g, ref),
                f"the {name} backward differs from the plain path")
        report[name] = {"vs_plain": e, "grads_vs_plain": ge}
        del f2, r

    # 55. an override bundle at full width: two rays a pixel, +-0.25 px
    oplan, bundle = override_bundle(torch, P, plan, dev)
    n_over = 2 * plan.ray_count
    over = P.Renderer(ctx, oplan)
    torch.cuda.reset_peak_memory_stats()
    reset()
    o1 = over.forward(field, rays=bundle)
    o_c = counts()
    o_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    o2 = over.forward(field, rays=bundle)
    print(f"override bundle of {n_over} rays: launches {o_c}, "
          f"{o1.sample_count} samples, peak {o_peak:.1f} MiB, notes "
          f"{o1.stats.notes}", flush=True)
    require(over._last_mode == "override" and o_c["integrate"] == 1,
            f"the override forward did not launch K9f once: {o_c}")
    require(results_equal(o1, o2, FRAME_KEYS),
            "the override frame differs between two calls")
    intl = over.last_outputs.intl
    cpu = compose(*(x.cpu() for x in (bundle.pixel_ids, intl.radiance,
                                      intl.transmittance, intl.opacity,
                                      intl.depth)),
                  plan.width, plan.height, plan.t_far, unique_pixels=False)
    c_err = max(float(np.abs(getattr(o1, k) - getattr(cpu, k).numpy()
                             .reshape(-1)).max())
                for k in ("image", "transmittance", "opacity", "depth"))
    c_hit = np.array_equal(o1.hitmask, cpu.hitmask.numpy().reshape(-1))
    print(f"override compose on the card vs the CPU: {c_err:.3e}, hitmask "
          f"equal {c_hit}; two calls equal", flush=True)
    require(c_err <= TOL and c_hit,
            "the override compose differs from the CPU's")
    dl2 = (torch.rand((n_over, 3), generator=gen, device=dev) * 2
           - 1).cpu().numpy()
    torch.cuda.reset_peak_memory_stats()
    og1, og2, o_bc = deterministic_backward(torch, over, field, dl2, counts,
                                            reset)
    ob_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"override Renderer.backward launches {o_bc}, peak {ob_peak:.1f} "
          f"MiB, camera zero {not og1.camera.any() and not og1.camera_k.any()}",
          flush=True)
    require(o_bc["integrate_bwd"] == 1, "the override backward ran no K9b")
    require(not og1.camera.any() and not og1.camera_k.any(),
            "the override backward's camera gradient is not zero")
    require(results_equal(og1, og2, GRAD_KEYS),
            "the override backward differs between two calls")
    require(float(np.abs(og1.sigma).max()) > 0, "override grads are zero")
    o_frame = event_times(torch, lambda: over.forward(field, rays=bundle))
    o_back = event_times(torch, lambda: over.backward(field, dl2))
    print(f"override times ms [{card}]: Renderer.forward {spread(o_frame)}, "
          f"Renderer.backward {spread(o_back)}", flush=True)
    o_gs = [torch.rand((n_over, 3), generator=gen, device=dev) * 2 - 1]
    kernels += k9_entries(torch, "override", outputs_inputs(
        over.last_outputs), o_gs, {"integrate": o_c["integrate"],
                                   "integrate_bwd": o_bc["integrate_bwd"]},
        span, card)
    report["override"] = {"rays": n_over, "frame_ms": o_frame,
                          "backward_ms": o_back, "peak_fwd_mib": o_peak,
                          "peak_bwd_mib": ob_peak, "compose_vs_cpu": c_err}
    del over, o_gs, bundle
    torch.cuda.empty_cache()

    # 56. the hash headline streamed, against the K7f frame
    hplan, spec = hash_headline(P)
    hfield = P.HashMLPField.init_random(torch.Generator().manual_seed(0),
                                        spec=spec, device=dev)
    hfield.requires_grad_(False)
    k7_frame = P.Renderer(ctx, hplan).forward(hfield)
    hr = P.Renderer(ctx, hplan, P.RenderOptions(use_tiles=False))
    reset()
    hres = hr.forward(hfield)
    h_c = counts()
    h_err, _, h_hit = planes_errors(hres, tiled_frame_planes(
        torch, k7_frame, hplan))
    h_depth, h_share, h_ulps = depth_error(hres.depth, k7_frame.depth,
                                           k7_frame.opacity, hplan.t_far)
    print(f"hash headline streamed: mode {hr._last_mode}, launches {h_c}; vs "
          f"the K7f frame planes {h_err:.3e}, depth {h_depth:.3e} "
          f"({h_share:.3f} of its per-ray bound, {h_ulps:.3f} ulps past "
          f"1e-4), hitmask {h_hit}", flush=True)
    require(hr._last_mode == "streamed" and h_c["integrate"] == n_blocks,
            f"the hash headline did not stream through K9f: {h_c}")
    require(h_err <= TOL and h_share <= 1.0 and h_hit,
            "the streamed hash frame differs from the K7f frame")
    h_frame = event_times(torch, lambda: hr.forward(hfield))
    print(f"hash streamed frame ms [{card}]: {spread(h_frame)}", flush=True)
    report["hash_streamed"] = {"frame_ms": h_frame, "vs_k7f": h_err,
                               "vs_k7f_depth": h_depth}
    del hfield, hr

    # 57. render_views over the fit flagship's eight views
    vplans, vconfig = flagship_views(P)
    vfield = P.DenseGridField.create(vconfig, device=dev)
    cams = [p.camera for p in vplans]
    reset()
    with torch.no_grad():
        views = fit.render_views(vplans[0], vfield, cams)
    v_c = counts()
    with torch.no_grad():
        ok = all(torch.equal(views[i], pipeline.render(p, vfield)
                             .planes.image) for i, p in enumerate(vplans))
    print(f"render_views: {tuple(views.shape)}, launches {v_c}, each view "
          f"equal to pipeline.render at its pose {ok}", flush=True)
    require(ok and v_c["integrate"] == len(vplans),
            "render_views differs from pipeline.render per view")
    with torch.no_grad():
        v_ms = event_times(torch, lambda: fit.render_views(vplans[0], vfield,
                                                           cams))
    print(f"render_views ms [{card}]: {spread(v_ms)}", flush=True)
    report["render_views"] = {"views": len(vplans), "ms": v_ms}
    return kernels, report


POSED_TOL = 1e-5    # posed frame against the host-built and windowed frames
KERNEL_NAMES = {"K1": "fused_tiles", "K2": "fused_tiles_bwd",
                "K3": "packed_table", "K4": "packed_table_bwd",
                "PB": "posed_build"}
POSED_ARRAYS = ("samp", "base", "rayt", "bank0", "k_enter", "hostmap")


def kernel_names(torch, fn) -> dict:
    """The CUDA kernels ``torch.profiler`` records while ``fn()`` runs
    once (after one warm run), by name: how many times each ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count for ev in prof.key_averages()
            if getattr(ev, "device_type", None) == DeviceType.CUDA}


def kernel_symbol(short) -> str:
    """The CUDA symbol (``utils/trace.py::KERNELS``) of kernel ``short``,
    the name a profiler's trace shows."""
    from dvren_tpu_torch.utils import trace

    (symbol,) = [k.symbol for k in trace.KERNELS
                 if k.name == KERNEL_NAMES[short]]
    return symbol


def require_kernels(names, want, what):
    for short in want:
        require(any(kernel_symbol(short) in n for n in names),
                f"{what}: the profiler saw no {short} ({kernel_symbol(short)})"
                f" kernel; it saw {sorted(names)}")


def kernel_count(names, short) -> int:
    """How many times ``names`` (from :func:`kernel_names`) ran kernel
    ``short``."""
    return sum(c for n, c in names.items() if kernel_symbol(short) in n)


def graph_equal_run(torch, P, plan, field, options, dl, backward):
    """One Renderer mode eager and under ``enable_graph``: (eager result,
    graph result, second graph result, eager grads, graph grads, graph
    renderer, eager renderer); the backwards under
    ``torch.use_deterministic_algorithms``."""
    out = {}
    for graph in (False, True):
        r = P.Renderer(P.Context.create(device="cuda"), plan,
                       P.RenderOptions(enable_graph=graph, **options))
        first = r.forward(field)
        again = r.forward(field)
        grads = None
        if backward:
            torch.use_deterministic_algorithms(True)
            try:
                grads = r.backward(field, dl)
            finally:
                torch.use_deterministic_algorithms(False)
        out[graph] = (first, again, grads, r)
    (e, _, ge, re_), (g, g2, gg, rg) = out[False], out[True]
    return e, g, g2, ge, gg, rg, re_


def tensor_errors(a, b):
    """Max |diff| of two ImagePlanes: (radiance, T and opacity; depth;
    hitmask equal)."""
    err = max(float((getattr(a, k) - getattr(b, k)).abs().max())
              for k in ("image", "transmittance", "opacity"))
    return (err, float((a.depth - b.depth).abs().max()),
            bool((a.hitmask == b.hitmask).all()))


def results_bit_equal(a, b, keys) -> bool:
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in keys)


def run_posed(torch, P, dev, card) -> tuple[list, dict]:
    """Phases 58-61: the device-built pose schedule (``PosedRenderer``),
    graph capture under ``enable_graph``, the tiled stage timings and the
    CLI, at the dense headline."""
    import tempfile

    from dvren_tpu_torch import cli
    from dvren_tpu_torch.ops import fused_tiles, packed_transpose
    from dvren_tpu_torch.ops import posed_build as pb
    from dvren_tpu_torch.ops.raygen import generate_rays
    from dvren_tpu_torch.render import animate, graph, posed, tiled, windowed
    from dvren_tpu_torch.render.pipeline import plan_jitter_table

    report, kernels = {}, []
    plan, config = headline_scene(P)
    field = P.DenseGridField.create(config, device=dev).requires_grad_(False)

    counts = functools.partial(counts_of, POSED)
    reset = graph.reset_launch_counts

    def orbit(i):   # phase 50's poses (tools/animation_bench.py:114-135)
        ang = 2 * np.pi * i / ORBIT_POSES
        return headline_scene(P, tx=0.5 + 0.1 * np.sin(ang),
                              ty=0.5 + 0.05 * np.cos(ang))[0]

    poses = [orbit(i) for i in range(ORBIT_POSES)]

    # 58. the posed orbit: split, graph, twin, host-built, windowed
    t0 = time.perf_counter()
    split = posed.PosedRenderer(plan, field, fused=False, probe_plans=poses)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pins = dict(nc_pin=split.nc_pin, nb_pin=split.nb_pin,
                ez_pin=split.ez_pin)
    graphed = posed.PosedRenderer(plan, field, fused=True, **pins)
    twin = posed.PosedRenderer(plan, field, fused=False, use_kernel=False,
                               **pins)
    print(f"posed pins [{card}]: nc_pin {split.nc_pin}, nb_pin "
          f"{split.nb_pin}, ez_pin {split.ez_pin} (probe over the base pose "
          f"and {ORBIT_POSES} orbit poses, {init_s:.3f} s with the "
          f"constants' upload)", flush=True)
    reset()
    frames = []
    for p in poses:                       # the main path: split renders
        frames.append(split.render(p, field))
    torch.cuda.synchronize()
    posed_c = counts()
    require(posed_c["fused_tiles"] == ORBIT_POSES
            and posed_c["packed_table"] == ORBIT_POSES
            and posed_c["posed_build"] == ORBIT_POSES,
            f"the posed orbit did not launch PB, K1 and K3 once a pose: "
            f"{posed_c}")
    mover = animate.MovingCameraRenderer(plan, field)
    host_times, errs = [], []
    graph_frames = []
    for i, p in enumerate(poses):
        a = frames[i]
        b = twin.render(p, field)
        e, d, h = tensor_errors(a, b)
        require(e <= TOL and d <= TOL_DEPTH and h,
                f"posed pose {i}: kernel frame vs twin {e:.3e} / {d:.3e}")
        require(frames_equal(split.render(p, field), a),
                f"posed pose {i}: two renders differ")
        g = graphed.render(p, field)
        require(frames_equal(g, a), f"posed pose {i}: graph mode differs "
                                    f"from the split mode")
        graph_frames.append(g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = mover.host_schedule(p, field)
        t1 = time.perf_counter()
        dev_sched = host.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.no_grad():
            ref = tiled.render_tiled(plan, field, dev_sched)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host_times.append({"build_ms": (t1 - t0) * 1e3,
                           "upload_ms": (t2 - t1) * 1e3,
                           "render_ms": (t3 - t2) * 1e3})
        ws = windowed.build_schedule(p, field.bbox_min, field.bbox_max,
                                     jitter=plan_jitter_table(p), device=dev)
        with torch.no_grad():
            wref = windowed.render_windowed(p, field, ws)
        e_t = float((a.image - ref.image).abs().max())
        e_w = float((a.image - wref.image).abs().max())
        errs.append({"vs_twin": e, "vs_host_tiled": e_t,
                     "vs_windowed": e_w})
        require(e_t < POSED_TOL and e_w < POSED_TOL,
                f"posed pose {i}: vs host-built tiled {e_t:.3e}, vs "
                f"windowed {e_w:.3e} (bound {POSED_TOL})")
        del ref, wref, dev_sched, ws, b
    require(graphed.cache_size() == 1, f"the orbit recorded "
            f"{graphed.cache_size()} graphs")
    print(f"posed orbit [{card}]: {ORBIT_POSES} poses, split frames vs "
          f"twin / host-built tiled / windowed max "
          f"{max(x['vs_twin'] for x in errs):.3e} / "
          f"{max(x['vs_host_tiled'] for x in errs):.3e} / "
          f"{max(x['vs_windowed'] for x in errs):.3e}; repeats and graph "
          f"mode bit-equal; one graph; launches {posed_c}", flush=True)
    report["posed"] = {"pins": pins, "init_s": init_s, "errors": errs,
                       "launches": posed_c}
    lap_posed = time.perf_counter()

    # 59. the sweep, the per-pose times, a profiled replay
    images, diags = graphed.render_sweep(poses, field)
    require(all(torch.equal(images[i], graph_frames[i].image)
                for i in range(ORBIT_POSES)),
            "render_sweep differs from the per-pose renders")
    times = []
    for i, p in enumerate(poses):
        cam = split._cam_arrays(p)
        with torch.no_grad():
            sched, build_ms = timed_once(
                torch, lambda: split._build_schedule(*cam)[0])
            _, render_ms = timed_once(
                torch, lambda: tiled.render_tiled(plan, field, sched))
            graphed.render(p, field, check_diag=False)
            _, replay_ms = timed_once(
                torch, lambda: graphed.render(p, field, check_diag=False))
            _, graph_ms = timed_once(torch, graphed.captured.graph.replay)
        times.append({"device_build_ms": build_ms, "render_ms": render_ms,
                      "replay_ms": replay_ms, "graph_replay_ms": graph_ms,
                      **host_times[i]})
    graphed.check_ok()
    recorded = graphed.captured.launches
    require(recorded == {"fused_tiles": 1, "packed_table": 1,
                         "posed_build": 1},
            f"the posed graph recorded {recorded}, not one PB, one K1 and "
            f"one K3")
    names = kernel_names(torch, graphed.captured.graph.replay)
    require_kernels(names, ("PB", "K1", "K3"), "a replayed posed frame")
    replayed = {s: kernel_count(names, s) for s in ("PB", "K1", "K3")}
    require(replayed == {"PB": 1, "K1": 1, "K3": 1},
            f"one replayed posed frame ran {replayed}, not one PB, one K1 "
            f"and one K3")
    print(f"posed per pose ms [{card}] (device build, render; replay with "
          f"the camera copy and the output copy, the graph alone | host "
          f"build, upload, render):", flush=True)
    for i, t in enumerate(times):
        print(f"  pose {i}: {t['device_build_ms']:.3f}, "
              f"{t['render_ms']:.3f}; {t['replay_ms']:.3f}, "
              f"{t['graph_replay_ms']:.3f} | {t['build_ms']:.1f}, "
              f"{t['upload_ms']:.2f}, {t['render_ms']:.3f}", flush=True)
    print(f"  a replayed posed frame ran {sum(names.values())} kernels "
          f"({len(names)} distinct), PB, K1 and K3 once each (profiler "
          f"{replayed}; recorded in the graph {recorded})", flush=True)
    b = device_breakdown(torch, graphed.captured.graph.replay, top=12)
    if b is not None:
        print(f"  replayed posed frame: kernels {b[0]:.4f} ms of {b[1]:.4f} "
              f"ms wall (busy {b[0] / b[1]:.3f}); top "
              f"{[(n, round(ms, 4), c) for n, ms, c in b[2]]}", flush=True)
    report["posed"]["times"] = times
    report["posed"]["replay_breakdown"] = None if b is None else {
        "kernel_ms": b[0], "wall_ms": b[1],
        "top": [list(r) for r in b[2]]}

    # K1 and K3 on the posed schedule, against their twins, timed
    sched, _ = split._build_schedule(*split._cam_arrays(poses[0]))
    args = variant_args(torch, plan, field, sched)
    with torch.no_grad():
        out = fused_tiles.tile_forward(*args)
        p_out = fused_tiles.tile_forward_set_plain(*args)
    k1_err = float((out - p_out).abs().max())
    require(torch.equal(out, p_out), "K1 on the posed schedule differs from "
                                     "its twin")
    k1_ms = cuda_ms(torch, lambda: fused_tiles.tile_forward(*args), 10)
    k1_plain = cuda_ms(torch, lambda: fused_tiles.tile_forward_set_plain(
        *args), 1, warmup=0)
    sigma, color = field.sigma, field.color
    rows_k = packed_transpose.build_rows(sigma, color)
    rows_p = packed_transpose.build_rows_plain(sigma, color)
    require(torch.equal(words(rows_k), words(rows_p)), "K3 differs from its "
                                                       "twin")
    k3_ms, k3_issued, k3_plain = packed_times(
        torch, lambda: packed_transpose.build_rows(sigma, color),
        lambda: packed_transpose.build_rows_plain(sigma, color))
    samp = sched.tiles.samp.view(torch.int16).to(torch.int32)
    live = int(((samp[:, 2] >> 15) & 1).sum())

    # PB by its wrapper on the pose's rays, against the twin's build
    t_near, t_far, dt, nudge, lo, inv, _ = split._lattice_consts()

    def pb_rays(p):
        k, c2w = split._cam_arrays(p)
        return generate_rays(plan, k=k, c2w=c2w[:3], ortho_scale=c2w[3, 0])

    def pb_build(rays):
        return pb.posed_build(
            rays.origins, rays.directions, split._jt_k,
            tiles_x=split._tx_n, n_tiles=split._t_cnt,
            k_max=plan.sampling.max_steps, nc=split.nc_pin,
            nb=split.nb_pin, ez=split.ez_pin, grid=split._grid,
            consts=(t_near, t_far, dt, nudge, lo, inv))

    def pb_bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    with torch.no_grad():
        for i, p in enumerate(poses):
            rays = pb_rays(p)
            got = pb_build(rays)
            again = pb_build(rays)
            want, want_diag = twin._build_schedule(*split._cam_arrays(p))
            wants = [getattr(want.groups[0], n) for n in POSED_ARRAYS]
            for name, a, b, c in zip(POSED_ARRAYS + ("diag",), got, again,
                                     wants + [want_diag]):
                require(a.dtype == c.dtype and a.shape == c.shape
                        and torch.equal(pb_bits(a), pb_bits(c)),
                        f"PB at posed pose {i}: {name} differs from the "
                        f"twin's")
                require(torch.equal(pb_bits(a), pb_bits(b)),
                        f"PB at posed pose {i}: a repeat build's {name} "
                        f"differs")
        rays = pb_rays(poses[0])
        pb_out = pb_build(rays)
        pb_ms = cuda_ms(torch, lambda: pb_build(rays), 20)
        pb_path_ms = cuda_ms(
            torch, lambda: split._build_schedule(*split._cam_arrays(
                poses[0])), 20)
        pb_plain = cuda_ms(
            torch, lambda: twin._build_schedule(*split._cam_arrays(
                poses[0])), 3, warmup=1)
    jt = () if split._jt_k is None else (split._jt_k,)
    pb_bound = bound(nbytes(rays.origins, rays.directions, *jt, *pb_out), 0)
    print(f"posed PB [{card}]: schedule arrays and diagnostics bit-equal to "
          f"the twin's at {ORBIT_POSES} poses, repeat builds the same bits; "
          f"{pb_ms:.4f} ms on the device (raygen and PB {pb_path_ms:.4f}, "
          f"the twin's build {pb_plain:.4f}; bound {pb_bound['bound_ms']:.4f} "
          f"by {pb_bound['bound_by']}: rays and the jitter table read once, "
          f"every output written once)", flush=True)
    kernels += [
        {"name": "posed_build:posed", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/posed_build.cu",
         "replaces": "dvren_tpu/render/posed.py:383 (XLA ops, no Pallas "
                     "kernel)",
         "launches": posed_c["posed_build"], "max_abs_err": 0.0,
         "graph_launches_per_replay": {"recorded": recorded["posed_build"],
                                       "profiled": replayed["PB"]},
         "ms": pb_ms, "path_ms": pb_path_ms, "plain_ms": pb_plain,
         **pb_bound},
        {"name": "fused_tiles:posed", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:656",
         "launches": posed_c["fused_tiles"], "max_abs_err": k1_err,
         "graph_launches_per_replay": {"recorded": recorded["fused_tiles"],
                                       "profiled": replayed["K1"]},
         "ms": k1_ms, "plain_ms": k1_plain,
         **bound(tile_in_bytes(args) + nbytes(out),
                 live * tile_counts.FWD_OPS)},
        {"name": "packed_table:posed", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/packed_table.cu",
         "replaces": "dvren_tpu/ops/packed_transpose.py:81",
         "launches": posed_c["packed_table"],
         "max_abs_err": float((rows_k - rows_p).abs().max()),
         "graph_launches_per_replay": {"recorded": recorded["packed_table"],
                                       "profiled": replayed["K3"]},
         "ms": k3_ms, "issued_ms": k3_issued, "plain_ms": k3_plain,
         **bound(nbytes(sigma, color, rows_k), 0)}]
    print(f"posed K1 [{card}]: {k1_ms:.4f} ms (twin {k1_plain:.4f}) over "
          f"{sched.tiles.n_tiles} tiles x {split.nc_pin} chunks x "
          f"{split.nb_pin} banks, {live} live samples; K3 {k3_ms:.4f} ms "
          f"on the device, {k3_issued:.4f} as issued", flush=True)
    del args, out, p_out, rows_k, rows_p, sched, samp, frames, graph_frames
    del images, split, twin, graphed, rays, pb_out, got, again, want
    torch.cuda.empty_cache()
    print(f"phases 58-59 took {time.perf_counter() - lap_posed:.1f} s after "
          f"the orbit", flush=True)

    # 60. enable_graph at the headline
    dl = np.random.default_rng(11).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    e, g, g2, ge, gg, rg, re_ = graph_equal_run(
        torch, P, plan, field, dict(use_tiles=True), dl, True)
    require(rg._last_mode == "tiled" and "graph_executed" in g.stats.notes
            and any(n.startswith("graph_captured_bwd_compile_ms=")
                    for n in g.stats.notes)
            and "kernel_launches=captured_in_graph" in g2.stats.notes,
            f"the tiled graph did not run: {g.stats.notes}")
    require(results_bit_equal(g, e, ("image", "transmittance", "opacity",
                                     "depth", "hitmask"))
            and results_bit_equal(g2, e, ("image", "depth")),
            "the replayed tiled frame differs from eager")
    require(results_bit_equal(gg, ge, GRAD_KEYS),
            "the replayed tiled backward differs from eager")
    captured = {k: v[1].launches for k, v in rg._graphs.items()}
    print(f"enable_graph tiled [{card}]: frame and grid / camera gradients "
          f"bit-equal to eager; recorded launches {captured}; notes "
          f"{[n for n in g.stats.notes if n.startswith('graph')]}",
          flush=True)
    other = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    res = rg.forward(other)
    require(any(n.startswith("graph_captured_aot") for n in res.stats.notes),
            "a new field object did not record a new graph")
    with torch.no_grad():
        other.sigma.mul_(1.5)
    res = rg.forward(other)
    require(not any(n.startswith("graph_captured") for n in res.stats.notes)
            and np.array_equal(res.image, re_.forward(other).image),
            "an in-place edit did not replay the graph with the new values")
    rg.forward(field)                       # back on the first field
    dl_img = rg._dl_image(dl.reshape(-1, 3))
    fwd_graph = rg._graphs["tiled"][1].graph
    bwd_graph = rg._graphs["tiled_bwd"][1].graph
    eager_sched = re_._tiled_schedule

    def eager_frame():
        with torch.no_grad():
            tiled.render_tiled(plan, field, eager_sched)

    eager_grads = re_._grads_fn(field, re_._replay_render("tiled"), dl_img)

    def eager_step():
        eager_frame()
        eager_grads()

    def replay_step():
        fwd_graph.replay()
        bwd_graph.replay()

    t_e = event_times(torch, eager_frame)
    t_g = event_times(torch, fwd_graph.replay)
    s_e = event_times(torch, eager_step)
    s_g = event_times(torch, replay_step)
    names = kernel_names(torch, replay_step)
    require_kernels(names, ("K1", "K2", "K3", "K4"), "a replayed tiled step")
    busy = device_breakdown(torch, replay_step)
    busy_e = device_breakdown(torch, eager_step)
    k1_rep = device_breakdown(torch, fwd_graph.replay)
    print(f"tiled frame ms [{card}]: eager {spread(t_e)}, replay "
          f"{spread(t_g)}; step (forward + backward): eager {spread(s_e)}, "
          f"replay {spread(s_g)}", flush=True)
    for what, b in (("replayed step", busy), ("eager step", busy_e),
                    ("replayed frame", k1_rep)):
        if b is None:
            print(f"  {what}: the profiler recorded no kernel", flush=True)
            continue
        print(f"  {what}: kernels {b[0]:.4f} ms of {b[1]:.4f} ms wall "
              f"(busy {b[0] / b[1]:.3f}); top {[(n, round(ms, 4), c) for n, ms, c in b[2]]}",
              flush=True)
    report["enable_graph"] = {
        "tiled_frame_ms": {"eager": t_e, "replay": t_g},
        "tiled_step_ms": {"eager": s_e, "replay": s_g},
        "busy_share_replayed_step": (None if busy is None
                                     else busy[0] / busy[1]),
        "recorded_launches": captured}
    del rg, re_, eager_grads, other, g, g2, e, gg, ge
    torch.cuda.empty_cache()
    modes = {"windowed": (dict(use_window=True), True),
             "streamed": (dict(use_tiles=False, streaming=True), True),
             "fused": (dict(use_tiles=False, streaming=False), False)}
    for mode, (options, backward) in modes.items():
        e, g, g2, ge, gg, rg, re_ = graph_equal_run(
            torch, P, plan, field, options, dl, backward)
        require(rg._last_mode == mode and "graph_executed" in g2.stats.notes,
                f"{mode}: the graph did not run ({rg._last_mode}, "
                f"{g2.stats.notes})")
        require(results_bit_equal(g, e, ("image", "transmittance", "opacity",
                                         "depth", "hitmask"))
                and results_bit_equal(g2, e, ("image", "depth")),
                f"the replayed {mode} frame differs from eager")
        if backward:
            require(results_bit_equal(gg, ge, GRAD_KEYS),
                    f"the replayed {mode} backward differs from eager")
        fwd = rg._graphs[mode][1]
        t_g = event_times(torch, fwd.graph.replay, runs=5)
        print(f"enable_graph {mode} [{card}]: frame"
              f"{' and gradients' if backward else ''} bit-equal to eager; "
              f"replayed frame {spread(t_g)} ms; recorded {fwd.launches}",
              flush=True)
        report["enable_graph"][mode] = {"replay_ms": t_g,
                                        "recorded": fwd.launches}
        del e, g, g2, ge, gg, rg, re_, fwd
        torch.cuda.empty_cache()
    h_plan, spec = hash_headline(P)
    h_field = P.HashMLPField.init_random(torch.Generator().manual_seed(0),
                                         spec=spec, device=dev)
    h_field.requires_grad_(False)
    e, g, g2, _, _, rg, _ = graph_equal_run(
        torch, P, h_plan, h_field, dict(use_tiles=True), None, False)
    require(rg._last_mode == "hash_tiled"
            and "graph_executed" in g2.stats.notes
            and results_bit_equal(g, e, ("image", "transmittance",
                                         "opacity", "depth"))
            and results_bit_equal(g2, e, ("image",)),
            "the replayed hash-tiled frame differs from eager")
    print(f"enable_graph hash_tiled [{card}]: frame bit-equal to eager; "
          f"recorded {rg._graphs['hash_tiled'][1].launches}", flush=True)
    del rg, e, g, g2, h_field
    torch.cuda.empty_cache()

    # 61. the tiled stage timings and the CLI
    r = P.Renderer(P.Context.create(device="cuda"), plan,
                   P.RenderOptions(use_tiles=True, capture_stats=True))
    st = r.forward(field).stats
    require(min(st.sample_ms, st.integrate_ms, st.compose_ms) > 0,
            f"tiled stage times not filled: {st}")
    print(f"tiled stage ms [{card}]: sample (table + bank gather) "
          f"{st.sample_ms:.4f}, integrate (K1) {st.integrate_ms:.4f}, "
          f"compose {st.compose_ms:.4f}", flush=True)
    report["stage_ms"] = {"sample": st.sample_ms,
                          "integrate": st.integrate_ms,
                          "compose": st.compose_ms}
    del r
    repo = os.path.dirname(os.path.abspath(__file__))
    real_write = cli.write_ppm
    cli_report = {}
    with tempfile.TemporaryDirectory(dir=repo) as tmp:
        for name in ("simple_volume", "smoke_volume"):
            path = os.path.join(repo, "examples", name + ".json")
            images = {}

            def keep(p, image, images=images):
                images[p] = np.asarray(image)
                real_write(p, image)

            outs = {d: os.path.join(tmp, f"{name}_{d}.ppm")
                    for d in ("card", "cpu")}
            cli.write_ppm = keep
            try:
                rc_card = cli.main([path, outs["card"]])
                rc_cpu = cli.main([path, outs["cpu"]], device="cpu")
            finally:
                cli.write_ppm = real_write
            require(rc_card == 0 and rc_cpu == 0,
                    f"the CLI failed on {name}: {rc_card}, {rc_cpu}")
            err = float(np.abs(images[outs["card"]]
                               - images[outs["cpu"]]).max())
            with open(outs["card"], "rb") as f1, open(outs["cpu"], "rb") as f2:
                card_bytes, cpu_bytes = f1.read(), f2.read()
            diff = int(np.sum(np.frombuffer(card_bytes, np.uint8)
                              != np.frombuffer(cpu_bytes, np.uint8)))
            print(f"CLI {name} [{card}]: card image vs CPU {err:.3e}, PPM "
                  f"bytes differing {diff}", flush=True)
            require(err <= TOL and diff == 0,
                    f"the CLI's card image differs from the CPU's on {name}")
            cli_report[name] = {"vs_cpu": err, "ppm_bytes_differing": diff}
        proc = subprocess.run(
            [sys.executable, "-m", "dvren_tpu_torch.cli",
             os.path.join(repo, "examples", "smoke_volume.json"),
             os.path.join(tmp, "smoke_module.ppm")],
            cwd=repo, capture_output=True, text=True, timeout=300)
        print(f"python -m dvren_tpu_torch.cli smoke_volume.json: rc "
              f"{proc.returncode}; {proc.stdout.strip()}", flush=True)
        with open(os.path.join(tmp, "smoke_module.ppm"), "rb") as f:
            same = f.read() == card_bytes
        require(proc.returncode == 0 and same,
                f"the module CLI failed or wrote other bytes: "
                f"{proc.stderr[-2000:]}")
    report["cli"] = cli_report
    return kernels, report


def tiled_frame_planes(torch, result, plan):
    """A ForwardResult's flat arrays as (H, W) planes of tensors, for
    :func:`planes_errors`."""
    h, w = plan.height, plan.width

    class Planes:
        image = torch.from_numpy(result.image.reshape(h, w, 3))
        transmittance = torch.from_numpy(result.transmittance.reshape(h, w))
        opacity = torch.from_numpy(result.opacity.reshape(h, w))
        depth = torch.from_numpy(result.depth.reshape(h, w))
        hitmask = torch.from_numpy(result.hitmask.reshape(h, w)
                                   .astype(np.int32))

    return Planes


# ------------------------------------------------------ phases 62-64: parallel

PAR_COUNTERS = {"K1": "fused_tiles", "K2": "fused_tiles_bwd",
                "K3": "packed_table", "K4": "packed_table_bwd",
                "K9f": "integrate", "K9b": "integrate_bwd",
                "J": "stratified_jitter"}
PAR_PLANES_TOL = 2e-5     # z-sharded planes against pipeline.render
PAR_GRAPH_STEPS = 10      # each sharded step's replays held to its body,
#                           and the sharded fits' steps
PAR_RUNS = 10             # timed runs of each sharded path (median, spread)
# the kernels each sharded step records (D = 1, NCCL): the headline's
# tile-DP step (16 px cells: K3, K1, K2, K4), the flagship's multi-view
# step (8 px supercells: K1, K2) and its view-DP step (per view K9f, K9b,
# the jitter kernel)
PAR_RECORDED = {"tile_dp": {"fused_tiles", "fused_tiles_bwd", "packed_table",
                            "packed_table_bwd"},
                "multiview": {"fused_tiles", "fused_tiles_bwd"},
                "view_dp": {"integrate", "integrate_bwd", "stratified_jitter",
                            "packed_eval", "packed_eval_bwd"}}


def _leaf_copy(field):
    return field.with_params(field.sigma.detach().clone(),
                             field.color.detach().clone())


def _grads(field) -> list:
    return [field.sigma.grad.detach().clone(),
            field.color.grad.detach().clone()]


@contextlib.contextmanager
def no_jitter_table():
    """``pipeline.plan_jitter_table`` refused for the duration: a path run
    inside reads no host jitter table."""
    from dvren_tpu_torch.render import pipeline

    real = pipeline.plan_jitter_table

    def refuse(*args, **kwargs):
        raise AssertionError("the host jitter table was read")

    pipeline.plan_jitter_table = refuse
    try:
        yield
    finally:
        pipeline.plan_jitter_table = real


def par_graph_steps(mesh, cases, fits) -> dict:
    """The three sharded steps with Adam (lr FIT_LR, the fits'
    projection), each from its start (``cases``: name -> (make(f, opt) ->
    (step, inputs), fresh())): PAR_GRAPH_STEPS calls of the step against
    the eager body of a twin step with a capturable Adam (losses,
    parameters, Adam's state bit for bit) and against the body with a
    non-capturable Adam (losses within FIT_GRAPH_RTOL). On an NCCL mesh
    the step is recorded once (the counters move by the warm-up and the
    recording only, over PAR_RECORDED's kernels) and replayed, and the
    replayed and eager steps are timed; on gloo it stays eager (``graph``
    None). ``fits``: name -> fit() -> losses, each held bit for bit to its
    step's losses (and recorded once, on NCCL)."""
    import torch

    from dvren_tpu_torch.render import graph

    recorded_mesh = mesh.backend == "nccl"
    out = {}

    def adam(f, capturable=True):
        return torch.optim.Adam(f.parameters(), lr=FIT_LR, betas=(0.9, 0.999),
                                eps=1e-8, capturable=capturable)

    for name, (make, fresh) in cases.items():
        fa, fb, fc = fresh(), fresh(), fresh()
        oa, ob, oc = adam(fa), adam(fb), adam(fc, False)
        (sa, inputs), (sb, _), (sc, _) = (make(f, o) for f, o in (
            (fa, oa), (fb, ob), (fc, oc)))
        graph.reset_launch_counts()
        got = torch.stack([sa(*inputs) for _ in range(PAR_GRAPH_STEPS)])
        torch.cuda.synchronize()
        moved = {k: v for k, v in graph.launch_counts().items() if v}
        want = torch.stack([sb.body(*inputs) for _ in range(PAR_GRAPH_STEPS)])
        plain = torch.stack([sc.body(*inputs)
                             for _ in range(PAR_GRAPH_STEPS)])
        torch.cuda.synchronize()
        pa, pb = list(fa.parameters()), list(fb.parameters())
        require(torch.equal(words(got), words(want))
                and all(torch.equal(words(a.detach()), words(b.detach()))
                        for a, b in zip(pa, pb))
                and all(torch.equal(a, b) for a, b in zip(
                    adam_state_words(oa, pa), adam_state_words(ob, pb))),
                f"{name}: {PAR_GRAPH_STEPS} steps differ from the eager "
                f"capturable body in losses, parameters or Adam's state")
        rel = float(((got - plain).abs() / plain.abs()).max())
        require(rel <= FIT_GRAPH_RTOL,
                f"{name}: the steps differ from the non-capturable Adam's by "
                f"{rel:.3e} relative")
        require(bool(got[-1] < got[0]), f"{name}: the loss does not fall")
        row = {"losses": got.tolist(), "vs_non_capturable": rel,
               "moved": moved}
        if recorded_mesh:
            rec = dict(sa.graph.launches)
            require(set(rec) == PAR_RECORDED[name]
                    and moved == {k: 2 * v for k, v in rec.items()},
                    f"{name}: recorded {rec} (want {PAR_RECORDED[name]}), "
                    f"the counters moved by {moved}, not twice that")
            row.update(recorded=rec, capture_ms=sa.graph.capture_ms,
                       replayed_ms=event_times(torch, lambda: sa(*inputs),
                                               PAR_RUNS),
                       eager_ms=event_times(torch, lambda: sb.body(*inputs),
                                            PAR_RUNS))
        else:
            require(sa.graph is None and sb.graph is None,
                    f"{name}: a step recorded a graph on a {mesh.backend} "
                    f"mesh")
        out[name] = row
        del fa, fb, fc, oa, ob, oc, sa, sb, sc
    for name, fit in fits.items():
        graph.reset_launch_counts()
        losses = fit()
        torch.cuda.synchronize()
        moved = {k: v for k, v in graph.launch_counts().items() if v}
        step = out[name]
        require(list(losses) == step["losses"],
                f"the {name} fit's losses differ from its steps': "
                f"{list(losses)} against {step['losses']}")
        if recorded_mesh:
            require(moved == {k: 2 * v for k, v in step["recorded"].items()},
                    f"the {name} fit moved the counters by {moved}: not "
                    f"recorded once")
        step["fit_moved"] = moved
    return out


def parallel_rank(mesh, sched_host, fit_views):
    """One rank of phases 62-63: the headline's tile-sharded frame and
    tile-DP step, the ray- and z-sharded frames, the flagship's multi-view
    tile-DP step, view-DP step and ``fit_dense_grid_tile_dp``, each
    against its single-card counterpart on rank 0; the main path's kernel
    launches on every rank; times with CUDA events; K1 / K2 on rank 0's
    shard against their twins. Every rank runs the sharded calls (they sum
    over the ranks); a failed check raises, which fails the launch."""
    import torch

    import dvren_tpu_torch as P
    from dvren_tpu_torch.ops import fused_tiles, packed_transpose
    from dvren_tpu_torch.opt.fit import _scheduled_views, mse, render_views
    from dvren_tpu_torch.parallel import shard
    from dvren_tpu_torch.parallel.mesh import all_reduce_sum
    from dvren_tpu_torch.render import graph, pipeline, tiled

    dev, n_dev, lead = mesh.device, mesh.size, mesh.rank == 0
    out = {"device": str(dev), "backend": mesh.backend, "ranks": n_dev}
    plan, config = headline_scene(P)
    field = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    t0 = time.perf_counter()
    shards = shard.shard_tiled_schedule(sched_host, n_dev)
    out["shard_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rs = shard._rank_tiles(sched_host, shards, mesh)    # built and kept
    torch.cuda.synchronize()
    out["rank_schedule_s"] = time.perf_counter() - t0
    out["rank_tiles"] = [int(shard.live_tiles_per_rank(g)[mesh.rank])
                         for g in shards]
    fplans, fconfig = flagship_views(P, views=fit_views)
    fplan = fplans[0]
    # the view-DP path at the flagship's views with stratified steps: its
    # fixed steps launch no jitter kernel
    splan = flagship_views(P, views=fit_views, mode="STRATIFIED")[0][0]
    fcams = [P.CameraConfig(c2w=tuple(p.camera.c2w)) for p in fplans]
    ffield = P.DenseGridField.create(fconfig, device=dev).requires_grad_(False)
    _, merged, render_stack = _scheduled_views(fplan, fcams, ffield, "tiled")
    require(merged.sched.fallback_rays == 0 and merged.sched.cell_scale == 2
            and merged.sched.tile_px == 8,
            "the flagship's merged schedule is not 8 px supercells")
    with torch.no_grad():
        ftargets = 0.7 * render_stack(ffield, merged)
    c2ws = torch.tensor([c.c2w for c in fcams], dtype=torch.float32,
                        device=dev).reshape(-1, 3, 4)
    target = torch.zeros((plan.height, plan.width, 3), device=dev)

    # the main path, counted: a sharded frame, a tile-DP step, a
    # ray-sharded frame and a view-DP step
    t_field = _leaf_copy(field)
    t_step = shard.make_tile_dp_train_step(
        plan, t_field, torch.optim.SGD(t_field.parameters(), lr=LR), mesh,
        sched_host)
    v_field = _leaf_copy(ffield)
    v_step = shard.make_dp_train_step(
        splan, v_field, torch.optim.SGD(v_field.parameters(), lr=LR), mesh)
    graph.reset_launch_counts()
    with torch.no_grad():
        frame = shard.render_tiled_sharded(plan, field, sched_host, mesh,
                                           shards=shards)
    t_loss = t_step(shards, target)
    with no_jitter_table():       # the jitter hashed on the card
        with torch.no_grad():
            rframe = shard.render_sharded(plan, field, mesh)
        v_loss = v_step(c2ws, ftargets)
    torch.cuda.synchronize()
    rows = torch.zeros((n_dev, len(PAR_COUNTERS)), device=dev)
    rows[mesh.rank] = torch.tensor(
        [float(v) for v in counts_of(PAR_COUNTERS.values()).values()],
        device=dev)
    out["launches"] = all_reduce_sum(mesh, rows).int().tolist()
    out["step_graphs"] = {"tile_dp": t_step.graph is not None,
                          "view_dp": v_step.graph is not None}
    t_grads = _grads(t_field)
    v_grads = _grads(v_field)
    # the ranks' parameters after the step, equal bit for bit: each rank's
    # row of a zero (D, n) array, one sum
    flat = torch.cat([t_field.sigma.detach().reshape(-1),
                      t_field.color.detach().reshape(-1)])
    prow = torch.zeros((n_dev, flat.numel()), device=dev)
    prow[mesh.rank] = flat
    prow = all_reduce_sum(mesh, prow)
    out["ranks_agree"] = bool((prow == prow[0:1]).all())
    require(out["ranks_agree"], "the ranks' parameters differ after a step")
    out["frame"] = frame.image.cpu().numpy()
    out["tile_dp_grads"] = [g.cpu().numpy() for g in t_grads]
    out["view_dp_grads"] = [g.cpu().numpy() for g in v_grads]
    out["losses"] = {"tile_dp": float(t_loss), "view_dp": float(v_loss)}

    # a repeat tile-DP step from the same start: the same bits
    r_field = _leaf_copy(field)
    shard.make_tile_dp_train_step(
        plan, r_field, torch.optim.SGD(r_field.parameters(), lr=LR), mesh,
        sched_host)(shards, target)
    out["repeat_equal"] = all(torch.equal(a, b)
                              for a, b in zip(_grads(r_field), t_grads))
    require(out["repeat_equal"], "a repeat tile-DP step differs")

    with torch.no_grad():
        zframe = shard.render_zsharded(plan, field, mesh)
    out["zframe"] = zframe.image.cpu().numpy()

    # the flagship's multi-view tile-DP step (SGD at lr 1)
    m_field = _leaf_copy(ffield)
    m_step, m_shards = shard.make_tile_dp_multiview_step(
        fplan, m_field, torch.optim.SGD(m_field.parameters(), lr=1.0), mesh,
        merged)
    m_loss = float(m_step(m_shards, ftargets))
    m_grads = _grads(m_field)
    out["multiview_grads"] = [g.cpu().numpy() for g in m_grads]

    # the three steps with Adam, recorded and replayed on NCCL, eager on
    # gloo, against their eager bodies; the two sharded fits against them
    flat = ffield.with_params(torch.full_like(ffield.sigma, 1.0),
                              torch.full_like(ffield.color, 0.5))
    h_target = 0.7 * frame.image

    def mv_make(f, opt):
        step, mv_shards = shard.make_tile_dp_multiview_step(
            fplan, f, opt, mesh, merged, project=shard._project_field)
        return step, (mv_shards, ftargets)

    cases = {
        "tile_dp": (lambda f, opt: (shard.make_tile_dp_train_step(
            plan, f, opt, mesh, sched_host, project=shard._project_field),
            (shards, h_target)), lambda: _leaf_copy(field)),
        "multiview": (mv_make, lambda: _leaf_copy(flat)),
        "view_dp": (lambda f, opt: (shard.make_dp_train_step(
            splan, f, opt, mesh, project=shard._project_field),
            (c2ws, ftargets)), lambda: _leaf_copy(flat))}
    fits = {"multiview": lambda: shard.fit_dense_grid_tile_dp(
                fplan, flat, fcams, ftargets, mesh, steps=PAR_GRAPH_STEPS)[1],
            "view_dp": lambda: shard.fit_dense_grid_dp(
                splan, flat, fcams, ftargets, mesh, steps=PAR_GRAPH_STEPS)[1]}
    out["graph"] = par_graph_steps(mesh, cases, fits)
    out["fit_losses"] = out["graph"]["multiview"]["losses"]

    if lead:
        # the single-card counterparts
        sched = sched_host.to(dev)
        with torch.no_grad():
            ref = tiled.render_tiled(plan, field, sched)
            ray_ref = pipeline.render(plan, field).planes
        out["frame_bit_equal"] = all(
            torch.equal(getattr(frame, k), getattr(ref, k))
            for k in ("image", "transmittance", "opacity", "depth",
                      "hitmask"))
        require(out["frame_bit_equal"],
                "render_tiled_sharded differs from render_tiled")
        out["ray_bit_equal"] = all(
            torch.equal(getattr(rframe, k), getattr(ray_ref, k))
            for k in ("image", "transmittance", "opacity", "depth",
                      "hitmask"))
        require(out["ray_bit_equal"],
                "render_sharded differs from pipeline.render")
        z_err = max(float((getattr(zframe, k) - getattr(ray_ref, k))
                          .abs().max())
                    for k in ("image", "transmittance", "opacity"))
        z_depth = depth_error(zframe.depth, ray_ref.depth, ray_ref.opacity,
                              plan.t_far)
        out["zsharded"] = {"planes": z_err, "depth": z_depth[0],
                           "depth_share": z_depth[1]}
        require(z_err <= PAR_PLANES_TOL and z_depth[1] <= 1.0
                and torch.equal(zframe.hitmask, ray_ref.hitmask),
                f"render_zsharded differs from pipeline.render: planes "
                f"{z_err:.3e}, depth {z_depth}")

        ref_t = _leaf_copy(field)
        single_loss = mse(tiled.render_tiled(plan, ref_t, sched).image,
                          target)
        single_loss.backward()
        out["tile_dp_err"] = max(rel_err(a, b)
                                 for a, b in zip(t_grads, _grads(ref_t)))
        out["tile_dp_bit_equal"] = all(
            torch.equal(a, b) for a, b in zip(t_grads, _grads(ref_t)))
        require(out["tile_dp_err"] <= GRID_TOL
                and abs(float(t_loss) - float(single_loss.detach()))
                <= 1e-5 * abs(float(single_loss.detach())),
                f"tile-DP step against render_tiled: grads "
                f"{out['tile_dp_err']:.3e} x scale")

        ref_m = _leaf_copy(ffield)
        stack_loss = mse(render_stack(ref_m, merged), ftargets)
        stack_loss.backward()
        out["multiview_err"] = max(rel_err(a, b)
                                   for a, b in zip(m_grads, _grads(ref_m)))
        require(out["multiview_err"] <= GRID_TOL
                and abs(m_loss - float(stack_loss.detach()))
                <= 1e-5 * abs(float(stack_loss.detach())),
                f"multi-view step against render_tiled_stack: grads "
                f"{out['multiview_err']:.3e} x scale")

        ref_v = _leaf_copy(ffield)
        views_loss = mse(render_views(splan, ref_v, fcams), ftargets)
        views_loss.backward()
        out["view_dp_err"] = max(rel_err(a, b)
                                 for a, b in zip(v_grads, _grads(ref_v)))
        require(out["view_dp_err"] <= GRID_TOL
                and abs(float(v_loss) - float(views_loss.detach()))
                <= 1e-5 * abs(float(views_loss.detach())),
                f"view-DP step against render_views: grads "
                f"{out['view_dp_err']:.3e} x scale")

    # times: each rank's sharded calls; the single-card paths at D = 1
    times = {}
    s_field = _leaf_copy(field)
    s_step = shard.make_tile_dp_train_step(
        plan, s_field, torch.optim.SGD(s_field.parameters(), lr=LR), mesh,
        sched_host)
    with torch.no_grad():
        times["tiled_frame"] = event_times(
            torch, lambda: shard.render_tiled_sharded(
                plan, field, sched_host, mesh, shards=shards), PAR_RUNS)
        times["ray_frame"] = event_times(
            torch, lambda: shard.render_sharded(plan, field, mesh), PAR_RUNS)
        times["z_frame"] = event_times(
            torch, lambda: shard.render_zsharded(plan, field, mesh),
            PAR_RUNS)
    times["tile_dp_step"] = event_times(
        torch, lambda: s_step(shards, target), PAR_RUNS)
    times["multiview_step"] = event_times(
        torch, lambda: m_step(m_shards, ftargets), PAR_RUNS)
    times["view_dp_step"] = event_times(
        torch, lambda: v_step(c2ws, ftargets), PAR_RUNS)
    if lead and n_dev == 1:
        sched = sched_host.to(dev)
        one = _leaf_copy(field)
        one_opt = torch.optim.SGD(one.parameters(), lr=LR)

        def one_step():
            one_opt.zero_grad(set_to_none=True)
            mse(tiled.render_tiled(plan, one, sched).image, target).backward()
            one_opt.step()

        mv = _leaf_copy(ffield)
        mv_opt = torch.optim.SGD(mv.parameters(), lr=1.0)

        def mv_step():
            mv_opt.zero_grad(set_to_none=True)
            mse(render_stack(mv, merged), ftargets).backward()
            mv_opt.step()

        with torch.no_grad():
            times["single_tiled_frame"] = event_times(
                torch, lambda: tiled.render_tiled(plan, field, sched),
                PAR_RUNS)
            times["single_ray_frame"] = event_times(
                torch, lambda: pipeline.render(plan, field), PAR_RUNS)
        times["single_tile_step"] = event_times(torch, one_step, PAR_RUNS)
        times["single_multiview_step"] = event_times(torch, mv_step,
                                                     PAR_RUNS)
    out["times"] = times

    if lead and n_dev > 1:
        # K1 and K2 on this rank's shard against their twins, timed
        table = packed_transpose.build_rows(field.sigma, field.color)
        tabs = tiled._gather_banks_flat(table, rs.gathermap_all)
        geom = (rs.bbox[0], rs.bbox[1], rs.grid_shape)
        prm = fused_tiles.tiles_op_params(plan, geom, rs.tiles)
        args = (tabs, rs.tiles, prm)
        k1 = fused_tiles.tile_forward(*args)
        k1p = fused_tiles.tile_forward_set_plain(*args)
        gen = torch.Generator(device=dev).manual_seed(62)
        gs = torch.randn((rs.tiles.n_tiles, 5, 16, 16), generator=gen,
                         device=dev)
        k2, _ = fused_tiles.tile_backward(tabs, rs.tiles, gs, prm)
        k2p, _ = fused_tiles.tile_backward_set_plain(tabs, rs.tiles, gs, prm)
        torch.cuda.synchronize()
        require(torch.equal(k1, k1p) and torch.equal(k2, k2p),
                "K1 / K2 on the rank's shard differ from their twins")
        k1_in = tile_in_bytes(args)
        out["shard_kernels"] = {
            "tiles": rs.tiles.n_tiles, "groups": len(rs.groups),
            "live": rs.tiled_samples,
            "k1_err": float((k1 - k1p).abs().max()),
            "k2_err": float((k2 - k2p).abs().max()),
            "k1_ms": cuda_ms(torch, lambda: fused_tiles.tile_forward(*args),
                             20),
            "k1_plain_ms": cuda_ms(
                torch, lambda: fused_tiles.tile_forward_set_plain(*args), 1,
                warmup=1),
            "k2_ms": cuda_ms(torch, lambda: fused_tiles.tile_backward(
                tabs, rs.tiles, gs, prm), 20),
            "k2_plain_ms": cuda_ms(
                torch, lambda: fused_tiles.tile_backward_set_plain(
                    tabs, rs.tiles, gs, prm), 1, warmup=1),
            "k1_bytes": k1_in + nbytes(k1),
            "k2_bytes": k1_in + nbytes(gs) + nbytes(k2)}
        # K9f / K9b on this rank's ray shard (render_sharded) and on its
        # first view of the view-DP step, against their twins, timed
        k9_launches = {"integrate": out["launches"][0][4],
                       "integrate_bwd": out["launches"][0][5]}
        with torch.no_grad():
            start, count, sigma, color, lattice = shard.ray_shard_lattice(
                plan, field, mesh)
            ray_in = [(sigma, color, lattice.dt, lattice.mask, None)]
            view_in = outputs_inputs(pipeline.render(
                splan, ffield, c2w=shard.batch_sharded(mesh, c2ws)[0]))
        out["k9_entries"] = []
        for form, inputs, (t_near, t_far) in (
                ("ray_shard_d2", ray_in, (plan.t_near, plan.t_far)),
                ("view_dp_d2", view_in, (splan.t_near, splan.t_far))):
            gk = [torch.rand((x[0].shape[0], 3), generator=gen, device=dev)
                  * 2 - 1 for x in inputs]
            out["k9_entries"] += k9_entries(
                torch, form, inputs, gk, k9_launches, (t_near, t_far),
                f"rank 0 of 2, {tuple(inputs[0][0].shape)}")
            del inputs, gk
        del ray_in, view_in, sigma, color, lattice
        # the jitter kernel at rank 0's ray shard, against its twin
        from dvren_tpu_torch.ops import rng

        k_steps = plan.sampling.max_steps
        rays_i = torch.arange(start, start + count, dtype=torch.int64,
                              device=dev)[:, None]
        steps_i = torch.arange(k_steps, dtype=torch.int32, device=dev)[
            None, :].expand(count, k_steps)
        bounds = (plan.ray_count, k_steps)
        jit_k = rng.stratified_jitter(plan.seed, rays_i, steps_i,
                                      bounds=bounds)
        jit_p = rng.stratified_jitter_plain(plan.seed, rays_i, steps_i,
                                            bounds)
        torch.cuda.synchronize()
        require(torch.equal(jit_k, jit_p), "the jitter kernel differs from "
                "its twin at rank 0's ray shard")
        out["j_entry"] = {
            "name": "stratified_jitter:ray_shard_d2", "route": "cuda",
            "source": "dvren_tpu_torch/csrc/jitter.cu",
            "replaces": "dvren_tpu/ops/rng.py:80 (no Pallas kernel: the "
                        "in-graph jitter)",
            "launches": out["launches"][0][6],
            "max_abs_err": float((jit_k - jit_p).abs().max()),
            "ms": device_ms(torch, lambda: rng.stratified_jitter(
                plan.seed, rays_i, steps_i, bounds=bounds), 20),
            "issued_ms": cuda_ms(torch, lambda: rng.stratified_jitter(
                plan.seed, rays_i, steps_i, bounds=bounds), 20),
            "plain_ms": cuda_ms(torch, lambda: rng.stratified_jitter_plain(
                plan.seed, rays_i, steps_i, bounds), 3, warmup=1),
            **bound(count * k_steps * 4 + count * 8 + k_steps * 4, 0)}
        del jit_k, jit_p
    return out


def _par_line(tag, r) -> str:
    t = r["times"]
    return (f"{tag}: shard {r['shard_s']:.4f} s host, rank schedule "
            f"{r['rank_schedule_s']:.4f} s (build and upload), rank 0's "
            f"live tiles per group {r['rank_tiles']}; ms median (min-max) "
            f"per rank: tiled frame {spread(t['tiled_frame'])}, tile-DP "
            f"step {spread(t['tile_dp_step'])}, ray frame "
            f"{spread(t['ray_frame'])}, z frame {spread(t['z_frame'])}, "
            f"multi-view step {spread(t['multiview_step'])}, view-DP step "
            f"{spread(t['view_dp_step'])}")


def run_parallel(torch, P, dev, card, sched_host=None) -> tuple[list, dict]:
    """Phases 62-64: the sharded paths of ``dvren_tpu_torch.parallel``.

    62. D = 1 over NCCL (one spawned rank on the card), at the dense
        headline and the fit flagship's eight views (``parallel_rank``),
        the three training steps and the two fits recorded as CUDA graphs
        and replayed (``par_graph_steps``);
    63. D = 2 over gloo, two ranks sharing the card (both ``cuda:0``; NCCL
        refuses two ranks on one GPU): the same checks with every step
        eager, results equal to D = 1's within their bounds, each rank's
        K1, K2, K3, K4, K9f, K9b and jitter launches on the main path
        above 0, K1 / K2 on rank 0's shard and K9f / K9b and the jitter
        kernel on its ray shard (K9 also on its first view-DP view)
        against their twins and timed;
    64. ``dryrun_multichip(2, backend="gloo")``.

Phases 65-69 (last; ``--only close`` runs phases 1 and 65-69 alone), each
fatal when it fails:

65. the jitter kernel (``csrc/jitter.cu``) at the headline's 262,144 x
    128 lattice, bit-equal to its twin on the card and to the host table,
    timed (device and as issued) beside the twin;
66. ``pipeline.render`` with no jitter table at the headline: the jitter
    kernel and K9f once each (the counts set to 0 just before), the frame
    bit-equal to the uploaded table's; median of 5 against the resident
    table and the host gather route the kernel replaces;
67. the headline schedule at ``bank_aligned=True``: bank and group
    counts against the dense packing, the frame and the grid and camera
    gradients through ``render_tiled`` bit-equal to it, K1 / K2 bit-equal
    to their twins and timed beside the dense packing's (the kernels line
    adds ``fused_tiles[_bwd]:bank_aligned``);
68. the fit flagship's merged schedule through
    ``make_train_block_scheduled``: a block of 8 Adam steps (8 replays of
    the step's graph) bit-equal to 8 single steps, K1 / K2 recorded once
    each in the graph, no counter moved by a warm block, which is timed;
69. ``utils/roofline.forward_roofline`` of the headline schedule beside
    its measured frame (median of 10).
    Times at D = 2 are two ranks sharing one card, not a scaling figure.
    The kernels were built by phase 1: the ranks load the library."""
    from dvren_tpu_torch.parallel import launch, shard
    from dvren_tpu_torch.parallel.dryrun import dryrun_multichip
    from dvren_tpu_torch.render import tiled

    report, t_all = {}, time.perf_counter()
    if sched_host is None:
        plan, config = headline_scene(P)
        field = P.DenseGridField.create(config, device=dev)
        sched_host, _ = tiled.build_tiled_schedule_auto(plan, field)
    shard_s = {}
    for d in (1, 2, 4, 8):
        t0 = time.perf_counter()
        shard.shard_tiled_schedule(sched_host, d)
        shard_s[d] = time.perf_counter() - t0
    report["shard_tiled_schedule_s"] = shard_s
    print(f"phase 62: shard_tiled_schedule host s at D = 1, 2, 4, 8: "
          f"{[round(v, 4) for v in shard_s.values()]}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r1 = launch(parallel_rank, 1, sched_host, FIT_VIEWS, backend="nccl")
    report["d1_s"] = time.perf_counter() - t0
    t = r1["times"]
    print(f"phase 62 (D = 1, {r1['backend']}, {r1['device']}, "
          f"{report['d1_s']:.1f} s): frame bit-equal "
          f"{r1['frame_bit_equal']}, ray frame bit-equal "
          f"{r1['ray_bit_equal']}, z-sharded {r1['zsharded']}, tile-DP "
          f"grads {r1['tile_dp_err']:.3e} x scale (bit-equal "
          f"{r1['tile_dp_bit_equal']}), repeat equal {r1['repeat_equal']}, "
          f"ranks agree {r1['ranks_agree']}, "
          f"multi-view {r1['multiview_err']:.3e}, view-DP "
          f"{r1['view_dp_err']:.3e}, fit losses {r1['fit_losses']}; "
          f"launches {dict(zip(PAR_COUNTERS, r1['launches'][0]))}",
          flush=True)
    names = list(PAR_COUNTERS)
    require(all(v > 0 for v in r1["launches"][0])
            and all(r1["step_graphs"].values()),
            f"D = 1: a kernel did not launch on the main path "
            f"({dict(zip(names, r1['launches'][0]))}) or a step was not "
            f"recorded ({r1['step_graphs']})")
    for name, g in r1["graph"].items():
        print(f"phase 62 {name} step recorded ({g['capture_ms']:.1f} ms "
              f"warm-up and capture; recorded {g['recorded']}, counters "
              f"moved {g['moved']}) and replayed: {PAR_GRAPH_STEPS} steps "
              f"bit-equal to the eager capturable body (losses "
              f"{g['losses'][0]:.6e} -> {g['losses'][-1]:.6e}, parameters, "
              f"Adam state), {g['vs_non_capturable']:.3e} relative from the "
              f"non-capturable Adam's"
              + (f"; the graphed fit bit-equal, counters moved "
                 f"{g['fit_moved']}" if "fit_moved" in g else "")
              + f"; ms a step replayed {spread(g['replayed_ms'])}, eager "
              f"{spread(g['eager_ms'])} [{card}]", flush=True)
    print(_par_line("phase 62 times", r1), flush=True)
    print(f"phase 62 single card: tiled frame "
          f"{spread(t['single_tiled_frame'])}, tiled step "
          f"{spread(t['single_tile_step'])}, pipeline.render "
          f"{spread(t['single_ray_frame'])}, merged-stack step "
          f"{spread(t['single_multiview_step'])}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r2 = launch(parallel_rank, 2, sched_host, FIT_VIEWS, backend="gloo",
                device="cuda:0")
    report["d2_s"] = time.perf_counter() - t0
    for rank, row in enumerate(r2["launches"]):
        print(f"phase 63 rank {rank} launches on the main path: "
              f"{dict(zip(names, row))}", flush=True)
        require(all(v > 0 for v in row),
                f"rank {rank} did not launch every kernel: "
                f"{dict(zip(names, row))}")
    require(np.array_equal(r2["frame"], r1["frame"]),
            "the D = 2 frame differs from D = 1's")
    d12 = {}
    for key in ("tile_dp_grads", "multiview_grads", "view_dp_grads"):
        d12[key] = max(rel_err(torch.from_numpy(a), torch.from_numpy(b))
                       for a, b in zip(r2[key], r1[key]))
    d12["zframe"] = float(np.abs(r2["zframe"] - r1["zframe"]).max())
    print(f"phase 63 (D = 2, {r2['backend']}, two ranks on "
          f"{r2['device']}, {report['d2_s']:.1f} s): frame bit-equal "
          f"{r2['frame_bit_equal']} (and to D = 1's), ray frame bit-equal "
          f"{r2['ray_bit_equal']}, z-sharded {r2['zsharded']}, tile-DP "
          f"grads {r2['tile_dp_err']:.3e} x scale, repeat equal "
          f"{r2['repeat_equal']}, ranks agree {r2['ranks_agree']}, "
          f"multi-view {r2['multiview_err']:.3e}, "
          f"view-DP {r2['view_dp_err']:.3e}, fit losses "
          f"{r2['fit_losses']}; against D = 1: {d12}", flush=True)
    require(max(v for k, v in d12.items() if k != "zframe") <= GRID_TOL
            and d12["zframe"] <= PAR_PLANES_TOL,
            f"D = 2 results differ from D = 1's: {d12}")
    require(not any(r2["step_graphs"].values()),
            f"D = 2 over gloo recorded a step: {r2['step_graphs']}")
    for name, g in r2["graph"].items():
        rel = float(np.max(np.abs(np.subtract(g["losses"],
                                              r1["graph"][name]["losses"]))
                           / np.abs(r1["graph"][name]["losses"])))
        d12[f"{name}_losses"] = rel
        print(f"phase 63 {name} step eager over gloo (no graph): "
              f"{PAR_GRAPH_STEPS} steps equal to the eager capturable body, "
              f"{g['vs_non_capturable']:.3e} relative from the "
              f"non-capturable Adam's, {rel:.3e} relative from D = 1's "
              f"replayed losses"
              + ("; the fit equal to the steps" if name != "tile_dp"
                 else ""), flush=True)
        require(rel <= FIT_GRAPH_RTOL,
                f"{name}: the D = 2 losses differ from D = 1's by {rel:.3e}")
    print(_par_line("phase 63 times (two ranks sharing one card, not a "
                    "scaling figure)", r2), flush=True)
    sk = r2["shard_kernels"]
    print(f"phase 63 rank 0's shard ({sk['tiles']} tiles in "
          f"{sk['groups']} groups, {sk['live']} live samples): K1 "
          f"{sk['k1_ms']:.4f} ms (plain {sk['k1_plain_ms']:.4f}), K2 "
          f"{sk['k2_ms']:.4f} ms (plain {sk['k2_plain_ms']:.4f}), both "
          f"bit-equal to their twins", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, backend="gloo")
    report["dryrun_s"] = time.perf_counter() - t0
    print(f"phase 64: dryrun_multichip(2, gloo) {report['dryrun_s']:.1f} s: "
          f"{dry}", flush=True)
    report.update(d1=_par_summary(r1), d2=_par_summary(r2), d2_vs_d1=d12,
                  dryrun=dry, card=card,
                  total_s=time.perf_counter() - t_all)
    kernels = [
        {"name": "fused_tiles:rank_shard_d2", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:656",
         "launches": r2["launches"][0][0], "max_abs_err": sk["k1_err"],
         "ms": sk["k1_ms"], "plain_ms": sk["k1_plain_ms"],
         **bound(sk["k1_bytes"], sk["live"] * tile_counts.FWD_OPS)},
        {"name": "fused_tiles_bwd:rank_shard_d2", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles_bwd.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:714",
         "launches": r2["launches"][0][1], "max_abs_err": sk["k2_err"],
         "ms": sk["k2_ms"], "plain_ms": sk["k2_plain_ms"],
         **bound(sk["k2_bytes"], sk["live"] * tile_counts.BWD_OPS)},
    ] + r2["k9_entries"] + [r2["j_entry"]]
    return kernels, report


def _par_summary(r) -> dict:
    """A rank result without its arrays."""
    return {k: v for k, v in r.items()
            if k not in ("frame", "zframe", "tile_dp_grads",
                         "multiview_grads", "view_dp_grads", "k9_entries",
                         "j_entry")}


CLOSE_BLOCK = 8          # steps in phase 68's fit block
CLOSE_RUNS = 5           # timed runs of the lattice renders (median, spread)
PARENT_RUNS = 3          # timed runs of the host jitter route


def parent_jitter_rows(torch, plan, rays):
    """The stratified jitter as ``pipeline.render(jitter=None)`` drew it
    before the jitter kernel: the (N, K) ray and step indices copied to
    the host, clipped into the plan's host table, gathered there and
    uploaded (``ops/sampling.py::_host_jitter_rows`` as it was)."""
    from dvren_tpu_torch.render.pipeline import plan_jitter_table

    n, k = rays.count, plan.sampling.max_steps
    dev = rays.origins.device
    steps2d = torch.arange(k, dtype=torch.int32, device=dev)[None, :].expand(
        n, k)
    ray_idx = torch.arange(n, dtype=torch.int64, device=dev)[:, None].expand(
        n, k)
    table = plan_jitter_table(plan)
    rows = np.clip(ray_idx.cpu().numpy(), 0, table.shape[0] - 1)
    cols = np.clip(steps2d.cpu().numpy(), 0, table.shape[1] - 1)
    return torch.from_numpy(np.ascontiguousarray(table[rows, cols])).to(dev)


def frame_grads(torch, tiled, plan, field, sched):
    """(the four planes, d_sigma, d_color, d_c2w, d_k) of
    sum(img * 0.001 + img^2 * 0.01) through ``render_tiled``."""
    from dvren_tpu_torch.ops.raygen import camera_arrays

    f = field.with_params(field.sigma.detach().clone().requires_grad_(),
                          field.color.detach().clone().requires_grad_())
    k, c2w, _ = camera_arrays(plan, field.device)
    k.requires_grad_(True)
    c2w.requires_grad_(True)
    planes = tiled.render_tiled(plan, f, sched, k=k, c2w=c2w)
    img = planes.image
    grads = torch.autograd.grad(torch.sum(img * 0.001 + img ** 2 * 0.01),
                                (f.sigma, f.color, c2w, k))
    return (planes.image.detach(), planes.transmittance.detach(),
            planes.opacity.detach(), planes.depth.detach()) + grads


def run_close(torch, P, dev, card, headline=None) -> tuple[list, dict]:
    """Phases 65-69: the stratified jitter on the card, ``pipeline.render``
    without a table, bank-aligned packing, the fit block and the
    headline's byte floor."""
    from dvren_tpu_torch.ops import fused_tiles, packed_transpose, rng
    from dvren_tpu_torch.ops.raygen import generate_rays
    from dvren_tpu_torch.opt import fit
    from dvren_tpu_torch.render import graph, pipeline, tiled
    from dvren_tpu_torch.utils import roofline

    report = {}
    if headline is None:
        plan, config = headline_scene(P)
        field = P.DenseGridField.create(config, device=dev).requires_grad_(
            False)
    else:
        plan, config, field, _ = headline
    n, k_steps = plan.ray_count, plan.sampling.max_steps

    # 65. the jitter kernel at the headline's lattice
    t0 = time.perf_counter()
    table = pipeline.plan_jitter_table(plan)
    table_s = time.perf_counter() - t0
    rays_i = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    steps = torch.arange(k_steps, dtype=torch.int32, device=dev)[
        None, :].expand(n, k_steps)
    bounds = (n, k_steps)
    got = rng.stratified_jitter(plan.seed, rays_i, steps, bounds=bounds)
    twin = rng.stratified_jitter_plain(plan.seed, rays_i, steps, bounds)
    torch.cuda.synchronize()
    require(torch.equal(got, twin), "the jitter kernel differs from its twin")
    require(np.array_equal(got.cpu().numpy(), table),
            "the jitter kernel differs from the host table")
    jit_ms = device_ms(torch, lambda: rng.stratified_jitter(
        plan.seed, rays_i, steps, bounds=bounds), 50)
    jit_issued_ms = cuda_ms(torch, lambda: rng.stratified_jitter(
        plan.seed, rays_i, steps, bounds=bounds), 50)
    jit_plain_ms = cuda_ms(torch, lambda: rng.stratified_jitter_plain(
        plan.seed, rays_i, steps, bounds), 5, warmup=1)
    jit_bytes = n * k_steps * 4 + n * 8 + k_steps * 4
    print(f"65. jitter kernel at {n} x {k_steps} ({n * k_steps} values): "
          f"bit-equal to its twin on the card and to the host table "
          f"({table_s:.3f} s to build on the host); {jit_ms:.4f} ms on the "
          f"device, {jit_issued_ms:.4f} as issued (twin {jit_plain_ms:.4f}); "
          f"bound {jit_bytes / peaks.HBM_BYTES_S * 1e3:.4f} ms "
          f"({jit_bytes} bytes) "
          f"[{card}]", flush=True)

    # 66. pipeline.render without a table: the main path of the kernel
    table_dev = torch.from_numpy(np.array(table)).to(dev)
    graph.reset_launch_counts()
    with torch.no_grad():
        out = pipeline.render(plan, field)
        jit_launches, k9_launches = counts_of(JITTER_K9F).values()
        ref = pipeline.render(plan, field, jitter=table_dev)
        torch.cuda.synchronize()
        require(jit_launches == 1 and k9_launches == 1,
                f"pipeline.render launched the jitter kernel {jit_launches} "
                f"times and K9f {k9_launches} times")
        for key in ("image", "transmittance", "opacity", "depth"):
            require(torch.equal(getattr(out.planes, key),
                                getattr(ref.planes, key)),
                    f"pipeline.render without a table differs in {key}")
        require(bool(torch.isfinite(out.planes.image).all())
                and float(out.planes.opacity.max()) > 0.0,
                "pipeline.render's frame is not finite or empty")
        new_t = event_times(torch, lambda: pipeline.render(plan, field),
                            CLOSE_RUNS)
        table_t = event_times(torch, lambda: pipeline.render(
            plan, field, jitter=table_dev), CLOSE_RUNS)

        def parent_route():
            rays = generate_rays(plan, device=dev)
            return pipeline.render(plan, field, jitter=parent_jitter_rows(
                torch, plan, rays))

        parent_t = event_times(torch, parent_route, PARENT_RUNS)
    print(f"66. pipeline.render(jitter=None) at the headline: launches "
          f"jitter {jit_launches}, K9f {k9_launches}; bit-equal to the "
          f"uploaded table's frame; ms {spread(new_t)}; with the table "
          f"resident {spread(table_t)}; the host gather route it replaces "
          f"{spread(parent_t)} [{card}]", flush=True)
    report["pipeline_render_ms"] = {"device_jitter": new_t,
                                    "resident_table": table_t,
                                    "host_gather": parent_t}

    # 67. the headline at bank_aligned=True against the dense packing
    scheds = {}
    for aligned in (False, True):
        t0 = time.perf_counter()
        s = tiled.build_tiled_schedule(plan, field, bank_aligned=aligned)
        scheds[aligned] = (s, time.perf_counter() - t0)
    (s_dense, dense_s), (s_al, al_s) = scheds[False], scheds[True]

    def banks(s):
        return int(sum(g.n_tiles * g.banks for g in s.groups))

    b0 = np.concatenate([g.bank0.reshape(-1) for g in s_al.groups])
    flags = int(((b0 >> 30) & 1).sum())
    require(flags > 0, "no run carries the ALIGNED bit")
    d_dev, a_dev = s_dense.to(dev), s_al.to(dev)
    counts = functools.partial(counts_of, DENSE)
    graph.reset_launch_counts()
    aligned_out = frame_grads(torch, tiled, plan, field, a_dev)
    al_launches = counts()
    dense_out = frame_grads(torch, tiled, plan, field, d_dev)
    torch.cuda.synchronize()
    names = ("image", "T", "opacity", "depth", "d_sigma", "d_color", "d_c2w",
             "d_k")
    for name, x, y in zip(names, aligned_out, dense_out):
        require(torch.equal(x, y),
                f"bank-aligned {name} differs from the dense packing")
    require(al_launches["fused_tiles"] >= 1
            and al_launches["fused_tiles_bwd"] >= 1,
            f"the bank-aligned frame and backward did not launch K1 / K2: "
            f"{al_launches}")
    rows = packed_transpose.build_rows(field.sigma.detach(),
                                       field.color.detach())
    gen = torch.Generator(device=dev).manual_seed(67)
    times, al_entries = {}, []
    for label, s in (("dense", d_dev), ("aligned", a_dev)):
        tabs = tiled._gather_banks_flat(rows, s.gathermap_all)
        prm = fused_tiles.tiles_op_params(
            plan, (s.bbox[0], s.bbox[1], s.grid_shape), s.tiles)
        gs = torch.randn((s.tiles.n_tiles, 5, 16, 16), generator=gen,
                         device=dev)
        k1 = cuda_ms(torch, lambda: fused_tiles.tile_forward(
            tabs, s.tiles, prm), 20)
        k2 = cuda_ms(torch, lambda: fused_tiles.tile_backward(
            tabs, s.tiles, gs, prm, cam=True), 20)
        times[label] = (k1, k2)
        if label == "aligned":
            out_k = fused_tiles.tile_forward(tabs, s.tiles, prm)
            b_rows, b_rayt = fused_tiles.tile_backward(tabs, s.tiles, gs,
                                                       prm, cam=True)
            torch.cuda.synchronize()
            p_rows, p_rayt = fused_tiles.tile_backward_set_plain(
                tabs, s.tiles, gs, prm, cam=True)
            require(torch.equal(out_k, fused_tiles.tile_forward_set_plain(
                tabs, s.tiles, prm)) and torch.equal(b_rows, p_rows)
                and torch.equal(b_rayt, p_rayt),
                "bank-aligned K1 / K2 differ from their twins")
            k1_plain = cuda_ms(torch, lambda: fused_tiles.tile_forward_set_plain(
                tabs, s.tiles, prm), 1, warmup=1)
            k2_plain = cuda_ms(torch, lambda: fused_tiles.tile_backward_set_plain(
                tabs, s.tiles, gs, prm, cam=True), 1, warmup=1)
            k1_in = tile_in_bytes((tabs, s.tiles, prm))
            live = s.tiled_samples
            al_entries = [
                {"name": "fused_tiles:bank_aligned", "route": "cuda",
                 "source": "dvren_tpu_torch/csrc/fused_tiles.cu",
                 "replaces": "dvren_tpu/ops/fused_tiles.py:656",
                 "launches": al_launches["fused_tiles"], "max_abs_err": 0.0,
                 "ms": k1, "plain_ms": k1_plain,
                 **bound(k1_in + s.tiles.n_tiles * 5 * 256 * 4,
                         live * tile_counts.FWD_OPS)},
                {"name": "fused_tiles_bwd:bank_aligned", "route": "cuda",
                 "source": "dvren_tpu_torch/csrc/fused_tiles_bwd.cu",
                 "replaces": "dvren_tpu/ops/fused_tiles.py:714",
                 "launches": al_launches["fused_tiles_bwd"],
                 "max_abs_err": 0.0, "ms": k2, "plain_ms": k2_plain,
                 **bound(k1_in + nbytes(gs, b_rows, b_rayt),
                         live * tile_counts.BWD_OPS)}]
    print(f"67. bank_aligned at the headline: {len(s_al.groups)} groups, "
          f"{banks(s_al)} banks (dense {len(s_dense.groups)} groups, "
          f"{banks(s_dense)} banks: x{banks(s_al) / banks(s_dense):.4f}), "
          f"banks <= {max(g.banks for g in s_al.groups)} (dense "
          f"{max(g.banks for g in s_dense.groups)}), {flags} ALIGNED runs; "
          f"built in {al_s:.3f} s (dense {dense_s:.3f}); frame, grid and "
          f"camera gradients bit-equal to the dense packing; K1 "
          f"{times['aligned'][0]:.4f} ms (dense {times['dense'][0]:.4f}), "
          f"K2 {times['aligned'][1]:.4f} ms (dense {times['dense'][1]:.4f}), "
          f"both bit-equal to their twins [{card}]", flush=True)
    report["bank_aligned"] = {
        "banks": banks(s_al), "dense_banks": banks(s_dense),
        "groups": len(s_al.groups), "dense_groups": len(s_dense.groups),
        "aligned_runs": flags, "k1_ms": times["aligned"][0],
        "k1_dense_ms": times["dense"][0], "k2_ms": times["aligned"][1],
        "k2_dense_ms": times["dense"][1]}

    # 68. the fit flagship through the K-step block
    plans, fconfig = flagship_views(P)
    truth = P.DenseGridField.create(fconfig, device=dev).requires_grad_(False)
    cams = [P.CameraConfig(c2w=pv.camera.c2w) for pv in plans]
    views = fit._scheduled_views(plans[0], cams, truth, "tiled")
    with torch.no_grad():
        targets = views[2](truth, views[1])

    def trained():
        f = truth.with_params(torch.full_like(truth.sigma, 0.5),
                              torch.full_like(truth.color, 0.5))
        return f, torch.optim.Adam(f.parameters(), lr=FIT_LR,
                                   betas=(0.9, 0.999), eps=1e-8,
                                   capturable=True)

    fa, opt_a = trained()
    block = fit.make_train_block_scheduled(plans[0], cams, fa, opt_a,
                                           CLOSE_BLOCK, views=views)
    graph.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = block(fa, targets)
    torch.cuda.synchronize()
    first_block_s = time.perf_counter() - t0
    blk_launches = counts()
    fb, opt_b = trained()
    step = fit.make_train_step_scheduled(plans[0], cams, fb, opt_b,
                                         views=views)
    singles = torch.stack([step(fb, targets) for _ in range(CLOSE_BLOCK)])
    torch.cuda.synchronize()
    require(losses.shape == (CLOSE_BLOCK,) and torch.equal(losses, singles)
            and torch.equal(fa.sigma, fb.sigma)
            and torch.equal(fa.color, fb.color),
            "the fit block differs from its steps")
    recorded = block.step.graph.launches
    require(recorded == {"fused_tiles": 1, "fused_tiles_bwd": 1}
            and blk_launches["fused_tiles"] == 2
            and blk_launches["fused_tiles_bwd"] == 2,
            f"the block's step graph did not record K1 / K2 once each, or a "
            f"replay launched through a wrapper (the warm-up and the "
            f"recording launch each once): recorded {recorded}, counters "
            f"{blk_launches}")
    require(float(losses[-1]) < float(losses[0]), "the block's loss rose")
    graph.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block(fa, targets)
    torch.cuda.synchronize()
    block_ms = (time.perf_counter() - t0) * 1e3
    require(not any(counts().values()),
            f"a warm block's replays launched through a wrapper: {counts()}")
    print(f"68. fit flagship block of {CLOSE_BLOCK} Adam steps: losses "
          f"{losses.tolist()}, bit-equal to {CLOSE_BLOCK} single steps; "
          f"recorded in the step graph {recorded}, launches {blk_launches} "
          f"(the warm-up and the recording), none in a warm block; first "
          f"block {first_block_s:.4f} s (the capture included), a "
          f"warm block {block_ms:.4f} ms ({block_ms / CLOSE_BLOCK:.4f} "
          f"ms/step) [{card}]", flush=True)
    report["fit_block"] = {"k": CLOSE_BLOCK, "block_ms": block_ms,
                           "step_ms": block_ms / CLOSE_BLOCK}

    # 69. the headline frame's byte floor
    with torch.no_grad():
        frame = event_times(torch, lambda: tiled.render_tiled(
            plan, field, d_dev), 10, warmup=2)
    line = roofline.forward_roofline(d_dev, measured_ms=frame["median"],
                                     pixels=plan.pixel_count)
    print("69. roofline " + json.dumps(line) + f" [{card}]", flush=True)
    report["roofline"] = line

    jitter_entry = {
        "name": "stratified_jitter", "route": "cuda",
        "source": "dvren_tpu_torch/csrc/jitter.cu",
        "replaces": "dvren_tpu/ops/rng.py:80 (no Pallas kernel: the "
                    "in-graph jitter)",
        "launches": jit_launches,
        "max_abs_err": float((got - twin).abs().max()), "ms": jit_ms,
        "issued_ms": jit_issued_ms, "plain_ms": jit_plain_ms,
        **bound(jit_bytes, 0)}
    return [jitter_entry] + al_entries, report


SOAK_W, SOAK_H, SOAK_GRID = 960, 720, 64   # tools/soak.py:58-79's scale
SOAK_STEPS = 64
SOAK_RUNS = 10           # steady frames timed (median)
SOAK_PIXELS = 12         # oracle pixels of a high-res frame
ANIM_FRAMES = 120        # tests/test_soak.py's frame count
ANIM_GRID = 24           # tools/soak.py's animation grid
ANIM_ORACLE_FRAMES = (0, 29, 59, 89, 119)
ANIM_SEED = 21           # the stratified animation plan's seed
POSE_LR = 1e-2
POSE_STEPS = 80          # tests/test_scenes.py's pipeline refinement
POSE_TILED_STEPS = 60    # and its tiled one
POSE_WIDE_STEPS = 20     # the tiled refinement at the soak's width
POSE_REBUILD = 10        # steps between schedule rebuilds


def soak_oracle(plan, image, depth, sigma, color, pixels, img_tol=3e-3,
                depth_tol=1e-2, seed=None) -> float:
    """tests/test_torch_scenes.py::subset_oracle_check on a frame's flat
    planes: each pixel against ``tests/oracle.py``'s scalar integrator
    (with ``seed``'s stratified jitter when given), depth skipped where
    the oracle's opacity sits within 4 * OPACITY_EPS of the depth rule's
    edge. Returns the largest image error."""
    import importlib.util

    from dvren_tpu_torch.ops.integrate import OPACITY_EPS
    from dvren_tpu_torch.ops.rng import stratified_jitter_py

    # tests/oracle.py by its path: another package named ``tests`` on the
    # path must not shadow it
    spec = importlib.util.spec_from_file_location("dvren_scalar_oracle", (
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                     "oracle.py")))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    kmat = np.asarray(plan.camera.k).reshape(3, 3)
    img = np.asarray(image).reshape(plan.height, plan.width, 3)
    dep = np.asarray(depth).reshape(plan.height, plan.width)
    worst = 0.0
    for px, py in pixels:
        px, py = int(px), int(py)
        jitter_fn = None
        if seed is not None:
            ray = py * plan.width + px
            jitter_fn = (lambda s, r=ray: stratified_jitter_py(seed, r, s))
        o, d = oracle.pinhole_ray(px, py, kmat, plan.camera.c2w)
        exp = oracle.integrate_pixel(
            o, d, plan.t_near, plan.t_far, plan.sampling.dt,
            plan.sampling.max_steps, sigma, color, (0, 0, 0), (1, 1, 1),
            jitter_fn=jitter_fn)
        err = float(np.abs(img[py, px] - exp["radiance"]).max())
        require(err < img_tol, f"pixel ({px}, {py}) differs from the "
                f"oracle by {err:.3e} (tolerance {img_tol})")
        knife = abs(exp["opacity"] - OPACITY_EPS) < 4 * OPACITY_EPS
        require(knife or abs(float(dep[py, px]) - exp["depth"]) < depth_tol,
                f"pixel ({px}, {py})'s depth {float(dep[py, px])} differs "
                f"from the oracle's {exp['depth']}")
        worst = max(worst, err)
    return worst


def frame_checks(fr, n_px, what):
    """A ForwardResult's invariants: finite planes, opacity in [0, 1],
    T >= 0, every pixel a ray."""
    for key in ("image", "transmittance", "opacity", "depth"):
        require(bool(np.isfinite(getattr(fr, key)).all()),
                f"{what}: {key} not finite")
    require(float(fr.opacity.max()) <= 1.0 + 1e-6
            and float(fr.opacity.min()) >= -1e-6
            and float(fr.transmittance.min()) >= -1e-6,
            f"{what}: opacity or T out of range")
    require(int(fr.hitmask.sum()) == n_px, f"{what}: pixels without a ray")


def run_soak(torch, P, dev, card) -> tuple[list, dict]:
    """Phases 70-72: the reference-scale soak (tools/soak.py) and pose
    refinement (tests/test_scenes.py) on the card."""
    from dvren_tpu_torch.ops import fused_tiles, packed_transpose, rng
    from dvren_tpu_torch.render import graph, pipeline, tiled
    from dvren_tpu_torch.utils import roofline
    from dvren_tpu_torch.utils.scenes import (blob_color, blob_sigma,
                                              dense_field, grid_coords,
                                              make_plan, sphere_shell_volume)

    reset = graph.reset_launch_counts
    read = functools.partial(counts_of, SOAK)

    report, phase_launches = {}, {}
    ctx = P.Context.create(device=dev)
    t_soak = time.perf_counter()

    # 70. 960x720 over the 64^3 shell: tiled with graphs, then windowed
    sigma_np, color_np = sphere_shell_volume(SOAK_GRID, radius=0.3,
                                             width=0.05)
    plan = make_plan(SOAK_W, SOAK_H, dt=2.0 / SOAK_STEPS,
                     max_steps=SOAK_STEPS)
    n_px = SOAK_W * SOAK_H
    pick = np.random.default_rng(3)
    pixels = list(zip(pick.integers(0, SOAK_W, SOAK_PIXELS),
                      pick.integers(0, SOAK_H, SOAK_PIXELS)))
    highres, renderers = {}, {}
    reset()
    for label, options in (("tiled", dict(enable_graph=True)),
                           ("windowed", dict(use_window=True))):
        r = P.Renderer(ctx, plan, P.RenderOptions(**options))
        f = dense_field(sigma_np, color_np, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = r.forward(f)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            f.sigma.mul_(1.0001)       # in place: a graph replays it
        steady = r.forward(f)
        again = r.forward(f)
        steady_t = event_times(torch, lambda: r.forward(f), SOAK_RUNS)
        path = "tiled_path" if label == "tiled" else "windowed_path"
        require(path in steady.stats.notes,
                f"the {label} soak frame took another path: "
                f"{steady.stats.notes}")
        if label == "tiled":
            require(any(n.startswith("graph_captured")
                        for n in first.stats.notes)
                    and "graph_executed" in steady.stats.notes
                    and not any(n.startswith("graph_captured")
                                for n in steady.stats.notes),
                    f"the soak frame was not replayed from its graph: "
                    f"{steady.stats.notes}")
        for key in ("image", "transmittance", "opacity", "depth",
                    "hitmask"):
            require(getattr(steady, key).tobytes()
                    == getattr(again, key).tobytes(),
                    f"two {label} soak frames differ in {key}")
        frame_checks(steady, n_px, f"{label} soak frame")
        require(float(steady.image.std()) > 0.01, "the soak frame is flat")
        err = soak_oracle(plan, steady.image, steady.depth,
                          f.sigma.detach().cpu().numpy(), color_np, pixels)
        notes = [n for n in first.stats.notes if not n.startswith(
            ("kernel_launches", "stage_ms"))]
        highres[label] = {"first_ms": first_ms, "steady_ms": steady_t,
                          "oracle_max_err": err, "notes": notes}
        renderers[label] = (r, f)
        print(f"70. {label} {SOAK_W}x{SOAK_H} over {SOAK_GRID}^3, "
              f"{SOAK_STEPS} steps: first frame {first_ms:.1f} ms, steady "
              f"Renderer.forward {spread(steady_t)} ms; notes {notes}; "
              f"{SOAK_PIXELS} pixels within {err:.3e} of the oracle, "
              f"replays byte-equal [{card}]", flush=True)
    phase_launches["70"] = read()
    report["highres"] = highres

    # 71. 120 frames at 192x144 over 24^3, sigma made on the card
    aplan = make_plan(192, 144, dt=0.0625, max_steps=32)
    splan = P.Plan.create(dataclasses.replace(
        aplan.descriptor(), seed=ANIM_SEED,
        sampling=dataclasses.replace(aplan.sampling,
                                     mode=P.SamplingMode.STRATIFIED)))
    coords = grid_coords(ANIM_GRID, dev)
    acolor = blob_color(coords).contiguous()
    color_a = acolor.cpu().numpy()
    ts = [i / float(ANIM_FRAMES) for i in range(ANIM_FRAMES)]

    def blob_field(t):
        return P.DenseGridField(blob_sigma(coords, t), acolor)

    pick = np.random.default_rng(7)
    with torch.no_grad():
        anim_err = 0.0
        for i in ANIM_ORACLE_FRAMES:         # checked, and warm
            f = blob_field(ts[i])
            planes = pipeline.render(splan, f).planes
            anim_err = max(anim_err, soak_oracle(
                splan, planes.image.cpu().numpy(),
                planes.depth.cpu().numpy(), f.sigma.cpu().numpy(), color_a,
                list(zip(pick.integers(0, 192, 5), pick.integers(0, 144, 5))),
                img_tol=4e-3, seed=ANIM_SEED))
        sums = torch.empty(ANIM_FRAMES, device=dev)
        moved = torch.empty(ANIM_FRAMES, device=dev)
        torch.cuda.synchronize()
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        prev = None
        for i, t in enumerate(ts):
            img = pipeline.render(splan, blob_field(t)).planes.image
            sums[i] = img.sum()
            moved[i] = 1.0 if prev is None else (img - prev).abs().max()
            prev = img
        end.record()
        end.synchronize()
        pipe_launches = read()
    anim_ms = start.elapsed_time(end)
    fps = ANIM_FRAMES / (anim_ms / 1e3)
    require(bool(torch.isfinite(sums).all()), "an animation frame is not "
            "finite")
    require(float(moved.min()) > 1e-6, "two consecutive animation frames "
            "are equal")
    require(pipe_launches["integrate"] == ANIM_FRAMES
            and pipe_launches["stratified_jitter"] == ANIM_FRAMES,
            f"the animation did not launch K9f and the jitter kernel once a "
            f"frame: {pipe_launches}")
    print(f"71. {ANIM_FRAMES} frames at 192x144 over {ANIM_GRID}^3 "
          f"(stratified, 32 steps) through pipeline.render: {anim_ms:.2f} "
          f"ms = {fps:.1f} frames/s (CUDA events, warm); launches "
          f"{pipe_launches}; frames {ANIM_ORACLE_FRAMES} within "
          f"{anim_err:.3e} of the oracle [{card}]", flush=True)

    r_anim = P.Renderer(ctx, aplan)
    pick = np.random.default_rng(7)
    reset()
    prev = None
    renderer_err = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, t in enumerate(ts):
        f = blob_field(t)
        fr = r_anim.forward(f)
        frame_checks(fr, 192 * 144, f"animation frame {i}")
        if i in ANIM_ORACLE_FRAMES:
            renderer_err = max(renderer_err, soak_oracle(
                aplan, fr.image, fr.depth, f.sigma.detach().cpu().numpy(),
                color_a, list(zip(pick.integers(0, 192, 5),
                                  pick.integers(0, 144, 5))),
                img_tol=4e-3))
        if prev is not None:
            require(float(np.abs(fr.image - prev).max()) > 1e-6,
                    f"animation frame {i} equals the one before")
        prev = fr.image
    renderer_s = time.perf_counter() - t0
    r_launches = read()
    require("tiled_path" in fr.stats.notes
            and r_launches["fused_tiles"] >= ANIM_FRAMES
            and r_launches["packed_table"] >= ANIM_FRAMES,
            f"the Renderer's animation did not run K3 and K1 every frame: "
            f"{r_launches}, {fr.stats.notes}")
    print(f"71. the same {ANIM_FRAMES} frames (fixed steps) through one "
          f"Renderer (tiled): {renderer_s:.3f} s = "
          f"{ANIM_FRAMES / renderer_s:.1f} frames/s (host clock, the "
          f"invariants and host copies included); launches {r_launches}; "
          f"frames {ANIM_ORACLE_FRAMES} within {renderer_err:.3e} of the "
          f"oracle [{card}]", flush=True)
    phase_launches["71"] = {k: pipe_launches[k] + r_launches[k]
                            for k in SOAK}
    report["animation"] = {"frames": ANIM_FRAMES, "pipeline_ms": anim_ms,
                           "pipeline_fps": fps, "renderer_s": renderer_s,
                           "renderer_fps": ANIM_FRAMES / renderer_s,
                           "oracle_max_err": max(anim_err, renderer_err)}

    # 72. pose refinement: the translation of c2w from its camera gradients
    def with_t(c2w, tv):
        return torch.cat([c2w[:, :3], tv[:, None]], dim=1)

    def refine(plan_p, steps, offset, render, rebuild=None,
               target_sched=None):
        """Adam on c2w's translation toward ``render``'s frame at the
        true camera (over ``target_sched``, else a schedule ``rebuild``
        makes there); ``rebuild(c2w)`` makes the schedule every
        POSE_REBUILD steps. Returns (first loss, last loss, errors before
        and after, ms a step (median), rebuild s, the last schedule)."""
        true_c2w = torch.tensor(plan_p.camera.c2w, dtype=torch.float32,
                                device=dev).reshape(3, 4)
        sched = target_sched
        if sched is None and rebuild is not None:
            sched = rebuild(true_c2w)
        with torch.no_grad():
            target = render(true_c2w, sched).detach()
        t_true = true_c2w[:, 3]
        t_start = t_true + torch.tensor(offset, device=dev)
        tv = t_start.clone().requires_grad_(True)
        opt = torch.optim.Adam([tv], lr=POSE_LR)
        losses, step_ms, rebuild_s = [], [], 0.0
        for it in range(steps):
            if rebuild and it % POSE_REBUILD == 0:
                t0 = time.perf_counter()
                sched = rebuild(with_t(true_c2w, tv.detach()))
                rebuild_s += time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = torch.mean((render(with_t(true_c2w, tv), sched)
                               - target) ** 2)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        err0 = float((t_start - t_true).abs().max())
        err1 = float((tv.detach() - t_true).abs().max())
        return (losses[0], losses[-1], err0, err1,
                float(np.median(step_ms)), rebuild_s, sched)

    sigma_p, color_p = sphere_shell_volume(12, radius=0.3, width=0.08)
    pose = {}
    reset()
    pplan = make_plan(20, 16, dt=0.0625, max_steps=32)
    pfield = dense_field(sigma_p, color_p, dev).requires_grad_(False)
    l0, l1, e0, e1, ms, _, _ = refine(
        pplan, POSE_STEPS, [0.06, -0.05, 0.0],
        lambda c2w, _: pipeline.render(pplan, pfield, c2w=c2w).planes.image)
    pipe_pose_launches = read()
    require(l1 < 0.2 * l0 and e1 < 0.5 * e0,
            f"the pipeline pose refinement did not converge: loss {l0} -> "
            f"{l1}, error {e0} -> {e1}")
    pose["pipeline"] = {"loss": [l0, l1], "error": [e0, e1], "step_ms": ms}

    def tiled_refinement(plan_t, field_t, steps, offset, target_sched=None):
        k0 = torch.tensor(plan_t.camera.k, dtype=torch.float32,
                          device=dev).reshape(3, 3)

        def rebuild(c2w):
            cam = dataclasses.replace(
                plan_t.camera, c2w=tuple(c2w.reshape(-1).tolist()))
            return tiled.build_tiled_schedule(plan_t.with_camera(cam),
                                              field_t).to(dev)

        return refine(plan_t, steps, offset,
                      lambda c2w, s: tiled.render_tiled(
                          plan_t, field_t, s, k=k0, c2w=c2w).image,
                      rebuild=rebuild, target_sched=target_sched)

    reset()
    tplan = make_plan(32, 32, dt=0.0625, max_steps=32)
    tfield = dense_field(sigma_p, color_p, dev).requires_grad_(False)
    l0, l1, e0, e1, ms, rb, _ = tiled_refinement(
        tplan, tfield, POSE_TILED_STEPS, [0.05, -0.04, 0.0])
    tiled_pose_launches = read()
    require(l1 < 0.5 * l0 and e1 < 0.5 * e0,
            f"the tiled pose refinement did not converge: loss {l0} -> "
            f"{l1}, error {e0} -> {e1}")
    pose["tiled"] = {"loss": [l0, l1], "error": [e0, e1], "step_ms": ms,
                     "rebuild_s": rb}
    reset()
    wfield = dense_field(sigma_np, color_np, dev).requires_grad_(False)
    l0, l1, e0, e1, ms, rb, wsched = tiled_refinement(
        plan, wfield, POSE_WIDE_STEPS, [0.05, -0.04, 0.0],
        target_sched=renderers["tiled"][0]._tiled_schedule)
    require(l1 < l0, f"the {SOAK_W}x{SOAK_H} pose steps did not lower the "
            f"loss: {l0} -> {l1}")
    pose["wide"] = {"loss": [l0, l1], "error": [e0, e1], "step_ms": ms,
                    "rebuild_s": rb}
    wide_launches = read()
    for name in pose:
        print(f"72. pose refinement, {name}: loss {pose[name]['loss'][0]:.4e}"
              f" -> {pose[name]['loss'][1]:.4e}, translation error "
              f"{pose[name]['error'][0]:.4f} -> {pose[name]['error'][1]:.4f};"
              f" {pose[name]['step_ms']:.3f} ms a step (median, host clock "
              f"after a synchronize)"
              + (f", schedule rebuilds {pose[name]['rebuild_s']:.3f} s"
                 if "rebuild_s" in pose[name] else "") + f" [{card}]",
              flush=True)
    phase_launches["72"] = {k: pipe_pose_launches[k]
                            + tiled_pose_launches[k] + wide_launches[k]
                            for k in SOAK}
    report["pose"] = pose
    report["phases_s"] = time.perf_counter() - t_soak
    launches = {k: sum(p[k] for p in phase_launches.values())
                for k in SOAK}
    for name in SOAK:
        require(launches[name] > 0, f"phases 70-72 never launched {name}")
    # K9f's entry at the soak counts phases 70-71; phase 72's pipeline
    # refinement (K9f and K9b at 20x16) has entries of its own
    soak_k9f = phase_launches["70"]["integrate"] + phase_launches[
        "71"]["integrate"]

    # the kernels at the soak's shapes against their twins, timed
    r_tiled, f_tiled = renderers["tiled"]
    sched = r_tiled._tiled_schedule
    with torch.no_grad():
        sig, col = f_tiled.sigma.detach(), f_tiled.color.detach()
        rows_k = packed_transpose.build_rows(sig, col)
        rows_p = packed_transpose.build_rows_plain(sig, col)
        torch.cuda.synchronize()
        require(torch.equal(words(rows_k), words(rows_p)),
                "K3 differs from its twin at the soak's grid")
        k3_ms, k3_issued, k3_plain = packed_times(
            torch, lambda: packed_transpose.build_rows(sig, col),
            lambda: packed_transpose.build_rows_plain(sig, col))
        tabs = tiled._gather_banks_flat(rows_k, sched.gathermap_all)
        prm = fused_tiles.tiles_op_params(
            plan, (sched.bbox[0], sched.bbox[1], sched.grid_shape),
            sched.tiles)
        args = (tabs, sched.tiles, prm)
        out_k = fused_tiles.tile_forward(*args)
        out_p = fused_tiles.tile_forward_set_plain(*args)
        torch.cuda.synchronize()
        require(torch.equal(out_k, out_p),
                "K1 differs from its twin at the soak's frame")
        k1_ms = device_ms(torch, lambda: fused_tiles.tile_forward(*args), 20)
        k1_issued = cuda_ms(torch, lambda: fused_tiles.tile_forward(*args),
                            20)
        k1_plain = cuda_ms(torch, lambda: fused_tiles.tile_forward_set_plain(
            *args), 1, warmup=1)
        frame_t = event_times(torch, lambda: tiled.render_tiled(
            plan, f_tiled, sched), SOAK_RUNS, warmup=2)
    streams = roofline.forward_streams(sched)["phases"]
    extra = tile_counts.SUPER_OPS if sched.cell_scale == 2 else 0
    k1_bound = bound(streams["kernel"]["bytes"],
                     sched.tiled_samples * (tile_counts.FWD_OPS + extra))
    k3_bound = bound(nbytes(sig, col, rows_k), 0)

    r_win, f_win = renderers["windowed"]
    inputs = window_group_inputs(torch, plan, f_win, r_win._window_schedule)
    gen = torch.Generator(device=dev).manual_seed(70)
    gs = [torch.rand((int(x[0].shape[0]), 3), generator=gen, device=dev)
          for x in inputs]
    k9_errs = k9_against_twins(torch, inputs, gs, "soak", plan.t_near,
                               plan.t_far)
    proc, early = processed_steps(torch, inputs)
    k9 = k9_times(torch, inputs, gs, plan.t_near, plan.t_far)
    k9f_bound = k9_bounds(torch, inputs, proc)[0]

    # K2 with the camera adjoint at the wide pose step's last schedule
    with torch.no_grad():
        wtabs = tiled._gather_banks_flat(packed_transpose.build_rows(
            wfield.sigma, wfield.color), wsched.gathermap_all)
        wprm = fused_tiles.tiles_op_params(
            plan, (wsched.bbox[0], wsched.bbox[1], wsched.grid_shape),
            wsched.tiles)
        wgs = torch.randn((wsched.tiles.n_tiles, 5, 16, 16), generator=gen,
                          device=dev)
        b_rows, b_rayt = fused_tiles.tile_backward(wtabs, wsched.tiles, wgs,
                                                   wprm, cam=True)
        p_rows, p_rayt = fused_tiles.tile_backward_set_plain(
            wtabs, wsched.tiles, wgs, wprm, cam=True)
        torch.cuda.synchronize()
        k2_err, k2_cam_err = rel_err(b_rows, p_rows), rel_err(b_rayt, p_rayt)
        require(k2_err <= GRID_TOL and k2_cam_err <= RAYT_TOL,
                f"K2 differs from its twin at the wide pose step: d(table) "
                f"{k2_err:.3e}, d(rayt) {k2_cam_err:.3e}")
        k2_ms = device_ms(torch, lambda: fused_tiles.tile_backward(
            wtabs, wsched.tiles, wgs, wprm, cam=True), 20)
        k2_issued = cuda_ms(torch, lambda: fused_tiles.tile_backward(
            wtabs, wsched.tiles, wgs, wprm, cam=True), 20)
        k2_plain = cuda_ms(torch, lambda: fused_tiles.tile_backward_set_plain(
            wtabs, wsched.tiles, wgs, wprm, cam=True), 1, warmup=1)
    # the jitter kernel at the animation's lattice
    n_a, k_a = splan.ray_count, splan.sampling.max_steps
    rays_i = torch.arange(n_a, dtype=torch.int64, device=dev)[:, None]
    steps_i = torch.arange(k_a, dtype=torch.int32, device=dev)[
        None, :].expand(n_a, k_a)
    jit_k = rng.stratified_jitter(ANIM_SEED, rays_i, steps_i,
                                  bounds=(n_a, k_a))
    jit_p = rng.stratified_jitter_plain(ANIM_SEED, rays_i, steps_i,
                                        (n_a, k_a))
    torch.cuda.synchronize()
    require(torch.equal(jit_k, jit_p), "the jitter kernel differs from its "
            "twin at the animation's lattice")
    jit_ms = device_ms(torch, lambda: rng.stratified_jitter(
        ANIM_SEED, rays_i, steps_i, bounds=(n_a, k_a)), 50)
    jit_issued = cuda_ms(torch, lambda: rng.stratified_jitter(
        ANIM_SEED, rays_i, steps_i, bounds=(n_a, k_a)), 50)
    jit_plain = cuda_ms(torch, lambda: rng.stratified_jitter_plain(
        ANIM_SEED, rays_i, steps_i, (n_a, k_a)), 5, warmup=1)
    jit_bytes = n_a * k_a * 4 + n_a * 8 + k_a * 4

    # K9f / K9b at the pipeline refinement's 20x16 lattice
    with torch.no_grad():
        pose_out = pipeline.render(pplan, pfield)
    pose_inputs = outputs_inputs(pose_out)
    pose_gs = [torch.rand((pplan.ray_count, 3), generator=gen, device=dev)]
    pose_k9 = k9_entries(torch, "pose_20x16", pose_inputs, pose_gs,
                         phase_launches["72"], (pplan.t_near, pplan.t_far),
                         "a pipeline pose step")

    k2_extra = tile_counts.SUPER_OPS if wsched.cell_scale == 2 else 0
    k2_bound = bound(tile_in_bytes((wtabs, wsched.tiles, wprm))
                     + nbytes(wgs, b_rows, b_rayt),
                     wsched.tiled_samples
                     * (tile_counts.BWD_OPS + k2_extra))
    print(f"70-72 kernels at the soak's shapes: K3 {k3_ms:.4f} device / "
          f"{k3_issued:.4f} issued (twin {k3_plain:.4f}, bound "
          f"{k3_bound['bound_ms']:.4f}); K1 over {len(sched.groups)} groups "
          f"({schedule_line(sched, 0.0)}) {k1_ms:.4f} / {k1_issued:.4f} "
          f"(twin {k1_plain:.4f}, bound {k1_bound['bound_ms']:.4f}), "
          f"render_tiled {spread(frame_t)}; K9f over "
          f"{len(inputs)} windowed groups {k9['k9f_ms']:.4f} / "
          f"{k9['k9f_issued_ms']:.4f} (twin {k9['k9f_plain_ms']:.4f}, "
          f"bound {k9f_bound['bound_ms']:.4f}{no_floor(k9f_bound)}; {proc} "
          f"processed steps, {early} rays stop early); K2 with the camera "
          f"adjoint at the wide pose step {k2_ms:.4f} / {k2_issued:.4f} "
          f"(twin {k2_plain:.4f}, bound {k2_bound['bound_ms']:.4f}; vs twin "
          f"{k2_err:.3e}, d(rayt) {k2_cam_err:.3e}); launches {launches}; "
          f"phases 70-72 took {report['phases_s']:.1f} s [{card}]",
          flush=True)
    report["kernels_ms"] = {
        "packed_table": [k3_ms, k3_issued], "fused_tiles": [k1_ms, k1_issued],
        "render_tiled": frame_t, "integrate": [k9["k9f_ms"],
                                               k9["k9f_issued_ms"]],
        "fused_tiles_bwd": [k2_ms, k2_issued]}
    report["launches"] = phase_launches
    kernels = [
        {"name": "fused_tiles:soak_960x720", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:1131",
         "launches": launches["fused_tiles"],
         "max_abs_err": float((out_k - out_p).abs().max()), "ms": k1_ms,
         "issued_ms": k1_issued, "plain_ms": k1_plain, **k1_bound},
        {"name": "packed_table:soak_64", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/packed_table.cu",
         "replaces": "dvren_tpu/ops/packed_transpose.py:107",
         "launches": launches["packed_table"],
         "max_abs_err": float((rows_k - rows_p).abs().max()), "ms": k3_ms,
         "issued_ms": k3_issued, "plain_ms": k3_plain, **k3_bound},
        {"name": "fused_tiles_bwd:pose_960x720", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles_bwd.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:1181",
         "launches": launches["fused_tiles_bwd"],
         "max_abs_err": float((b_rows - p_rows).abs().max()), "ms": k2_ms,
         "issued_ms": k2_issued, "plain_ms": k2_plain, **k2_bound},
        {"name": "integrate:soak_960x720", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/integrate.cu",
         "replaces": "dvren_tpu/ops/integrate_pallas.py:170",
         "launches": soak_k9f, "max_abs_err": k9_errs[0],
         "ms": k9["k9f_ms"], "issued_ms": k9["k9f_issued_ms"],
         "plain_ms": k9["k9f_plain_ms"], **k9f_bound},
        {"name": "stratified_jitter:animation", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/jitter.cu",
         "replaces": "dvren_tpu/ops/rng.py:80 (no Pallas kernel: the "
                     "in-graph jitter)",
         "launches": launches["stratified_jitter"],
         "max_abs_err": float((jit_k - jit_p).abs().max()), "ms": jit_ms,
         "issued_ms": jit_issued, "plain_ms": jit_plain,
         **bound(jit_bytes, 0)}]
    return kernels + pose_k9, report


FIT_GRAPH_STEPS = 10     # phase 73: steps graphed against eager, per mode
FIT_GRAPH_RTOL = 1e-4    # tests/test_torch_fit.py's LOSS_RTOL
FIT_GRAPH_RUNS = 10      # replayed and eager steps timed (median)
FIT_GRAPH_PROFILED = 5   # replays under torch.profiler (busy share)
FIT_EAGER_PROFILED = 2   # eager steps under torch.profiler
HASH_FIT_LR = 8e-3       # tools/hashmlp_bench.py's fit rate


def adam_state_words(opt, params) -> list:
    """Every state tensor of ``opt`` for ``params``, as 32-bit words."""
    return [words(t.reshape(-1).float())
            for p in params for _, t in sorted(opt.state[p].items())]


def fit_graph_cases(torch, P, dev) -> dict:
    """Phase 73's four training steps: per mode (plan, cameras, a fresh
    field, targets, the learning rate, ``make(f, opt)`` giving the step
    over ``f``, ``run_fit(f, config)`` the fit): the flagship's merged
    tiled and windowed schedules and its plain lattice, and
    tools/hashmlp_bench.py's hash fit."""
    from dvren_tpu_torch.opt import fit
    from dvren_tpu_torch.render import hash_tiled

    plans, fconfig = flagship_views(P)
    truth = P.DenseGridField.create(fconfig, device=dev).requires_grad_(False)
    cams = [P.CameraConfig(c2w=pv.camera.c2w) for pv in plans]
    tviews = fit._scheduled_views(plans[0], cams, truth, "tiled")
    wviews = fit._scheduled_views(plans[0], cams, truth, "windowed")
    with torch.no_grad():
        targets = tviews[2](truth, tviews[1])

    def flat():
        return truth.with_params(torch.full_like(truth.sigma, 0.5),
                                 torch.full_like(truth.color, 0.5))

    def dense(mode, views):
        def make(f, opt):
            if mode == "plain":
                return fit.make_train_step(plans[0], cams, f, opt)
            return fit.make_train_step_scheduled(plans[0], cams, f, opt,
                                                 mode=mode, views=views)

        def run_fit(f, config):
            return fit.fit_dense_grid(plans[0], f, cams, targets, config,
                                      mode=mode)

        return (plans[0], cams, flat, targets, FIT_LR, make, run_fit)

    spec = P.HashMLPSpec()
    h_plan, h_cams = hash_fit_setup(P)
    teacher = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                         spec=spec, table_std=1.0,
                                         device=dev)
    stack = hash_tiled.build_hash_schedule_stack(
        fit.view_plans(h_plan, h_cams), device=dev)
    with torch.no_grad():
        h_targets = hash_tiled.render_hash_tiled_stack(h_plan, teacher, stack)

    def student():
        return P.HashMLPField.init_random(torch.Generator().manual_seed(3),
                                          spec=spec, device=dev)

    return {"tiled": dense("tiled", tviews),
            "windowed": dense("windowed", wviews),
            "plain": dense("plain", None),
            "hash": (h_plan, h_cams, student, h_targets, HASH_FIT_LR,
                     lambda f, opt: fit._hash_train_step(h_plan, stack, opt),
                     lambda f, config: fit.fit_hash_mlp(
                         h_plan, f, h_cams, h_targets, config))}


def run_fit_busy_child(torch, P, dev) -> dict:
    """Phase 73's child process: each mode's step recorded, then, once
    the parent writes a line (its own checks done, so that nothing else
    runs on the card), FIT_GRAPH_PROFILED replays of each under
    ``torch.profiler``: kernel ms, wall ms and the top kernels per replay,
    by mode. A fresh process: in the parent, tracing a step's replays
    after the earlier traces crashed the process inside
    ``cudaGraphLaunch`` (``PERF.md``, the fits' step graphs); a process
    that records its graphs and then traces only their replays did not."""
    steps = {}
    for mode, (_, _, fresh, targets, lr, make, _) in fit_graph_cases(
            torch, P, dev).items():
        f = fresh()
        opt = torch.optim.Adam(f.parameters(), lr=lr, betas=(0.9, 0.999),
                               eps=1e-8, capturable=True)
        step = make(f, opt)
        step(f, targets)
        steps[mode] = (step, f, targets)
    torch.cuda.synchronize()
    print("ready", flush=True)
    sys.stdin.readline()
    return {mode: device_breakdown(torch, lambda: step.loss(f, targets),
                                   steps=FIT_GRAPH_PROFILED)
            for mode, (step, f, targets) in steps.items()}


def start_fit_busy_child():
    """:func:`run_fit_busy_child` started in a child process, which sets
    up and records while the parent checks."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--fit-busy-child"], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def fit_busy_from_child(child) -> dict:
    """Let the child trace its replays, alone on the card; its result, or
    ``{"error": ...}`` when it failed (a measurement, not a check: the
    phase goes on without the replays' busy shares)."""
    out, err = child.communicate(input="go\n", timeout=600)
    lines = out.strip().splitlines()
    if child.returncode != 0 or not lines:
        print(f"73. the profiler's child exited {child.returncode}: "
              f"{err[-2000:]}", flush=True)
        return {"error": f"child exited {child.returncode}"}
    return json.loads(lines[-1])


def run_fit_graph(torch, P, dev, card) -> dict:
    """Phase 73: the fits' steps recorded as CUDA graphs and replayed. For
    the flagship's tiled, windowed and plain modes and the hash fit:
    FIT_GRAPH_STEPS graphed steps bit-equal to the eager capturable body
    (losses, parameters, Adam's state), the launch counters moved by the
    warm-up and the recording only; the graphed fit's losses bit-equal to
    those steps' (the same recording from the same start) and within
    FIT_GRAPH_RTOL of eager steps with a non-capturable Adam; replayed
    and eager ms a step (median of FIT_GRAPH_RUNS, CUDA events) and the
    busy share over FIT_GRAPH_PROFILED replays (``torch.profiler``, in a
    child process: :func:`run_fit_busy_child`) and eager steps. Then
    ``fit_dense_grid`` auto at the flagship to PSNR 35."""
    from dvren_tpu_torch.opt import fit
    from dvren_tpu_torch.render import graph

    t_phase = time.perf_counter()
    report, kept, spent = {}, {}, {}
    child = start_fit_busy_child()
    try:
        cases = fit_graph_cases(torch, P, dev)
        spent["setup"] = time.perf_counter() - t_phase
        for mode, (plan, cams, fresh, targets, lr, make, run_fit) in \
                cases.items():
            t_mode = time.perf_counter()
            def adam(f, capturable=True):
                return torch.optim.Adam(f.parameters(), lr=lr,
                                        betas=(0.9, 0.999), eps=1e-8,
                                        capturable=capturable)

            fa, fb, fc = fresh(), fresh(), fresh()
            opt_a, opt_b, opt_c = adam(fa), adam(fb), adam(fc, False)
            step_g, step_e, step_c = (make(fa, opt_a), make(fb, opt_b),
                                      make(fc, opt_c))
            graph.reset_launch_counts()
            got = torch.stack([step_g(fa, targets)
                               for _ in range(FIT_GRAPH_STEPS)])
            torch.cuda.synchronize()
            moved = {k: v for k, v in graph.launch_counts().items() if v}
            recorded = dict(step_g.graph.launches)
            want = torch.stack([step_e.body(fb, targets)
                                for _ in range(FIT_GRAPH_STEPS)])
            plain = torch.stack([step_c.body(fc, targets)
                                 for _ in range(FIT_GRAPH_STEPS)])
            torch.cuda.synchronize()
            pa, pb = list(fa.parameters()), list(fb.parameters())
            require(torch.equal(words(got), words(want)),
                    f"{mode}: graphed losses differ from the eager step's: "
                    f"{got.tolist()} against {want.tolist()}")
            require(all(torch.equal(words(a.detach()), words(b.detach()))
                        for a, b in zip(pa, pb)),
                    f"{mode}: graphed parameters differ from the eager "
                    f"step's")
            require(all(torch.equal(a, b) for a, b in zip(
                adam_state_words(opt_a, pa),
                adam_state_words(opt_b, pb))),
                f"{mode}: graphed Adam state differs from the eager step's")
            require(bool(recorded)
                    and moved == {k: 2 * v for k, v in recorded.items()},
                    f"{mode}: the counters moved by {moved}, not twice the "
                    f"recorded {recorded} (the warm-up and the recording): "
                    f"a replay launched through a wrapper")
            rel = float(((got - plain).abs() / plain.abs()).max())
            require(rel <= FIT_GRAPH_RTOL,
                    f"{mode}: graphed losses differ from the non-capturable "
                    f"eager steps by {rel:.3e} relative")
            config = fit.FitConfig(learning_rate=lr, steps=FIT_GRAPH_STEPS,
                                   target_psnr=None,
                                   sync_every=FIT_GRAPH_STEPS)
            graph.reset_launch_counts()
            res = run_fit(fresh(), config)
            fit_moved = {k: v for k, v in graph.launch_counts().items()
                         if v}
            require(res.recorded_launches == recorded
                    and fit_moved == {k: 2 * v for k, v in recorded.items()},
                    f"{mode}: the fit recorded {res.recorded_launches} and "
                    f"moved the counters by {fit_moved}")
            require(res.loss_history == got.tolist()
                    and all(torch.equal(words(a.detach()), words(b.detach()))
                            for a, b in zip(res.field.parameters(), pa)),
                    f"{mode}: the graphed fit differs from the graphed steps "
                    f"from the same start")
            print(f"73. {mode} step recorded ({step_g.graph.capture_ms:.1f} "
                  f"ms warm-up and capture; recorded {recorded}) and "
                  f"replayed: {FIT_GRAPH_STEPS} steps bit-equal to the eager "
                  f"capturable body (losses {got[0].item():.6e} -> "
                  f"{got[-1].item():.6e}, parameters, Adam state) and to "
                  f"the graphed fit; against the non-capturable steps "
                  f"{rel:.3e} relative; fit first_step_s "
                  f"{res.first_step_s:.4f}, steady_step_ms "
                  f"{res.steady_step_ms:.4f} [{card}]", flush=True)
            report[mode] = {
                "recorded_launches": recorded,
                "capture_ms": step_g.graph.capture_ms,
                "losses": got.tolist(), "vs_non_capturable": rel,
                "first_step_s": res.first_step_s,
                "steady_step_ms": res.steady_step_ms}
            kept[mode] = (step_g, fa, step_e, fb, targets)
            del fc, opt_c, step_c, res
            spent[f"checks_{mode}"] = time.perf_counter() - t_mode
        t_child = time.perf_counter()
        busy_replayed = fit_busy_from_child(child)
        spent["child_wait"] = time.perf_counter() - t_child
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    report["busy_child"] = busy_replayed.get("error", "ok")
    t_times = time.perf_counter()
    for mode, (step_g, fa, step_e, fb, targets) in kept.items():
        replayed = event_times(torch, lambda: step_g(fa, targets),
                               FIT_GRAPH_RUNS)
        eager = event_times(torch, lambda: step_e.body(fb, targets),
                            FIT_GRAPH_RUNS)
        busy = busy_replayed.get(mode)
        busy_e = device_breakdown(torch, lambda: step_e.body(fb, targets),
                                  steps=FIT_EAGER_PROFILED)
        shares = [None if b is None else b[0] / b[1] for b in (busy, busy_e)]
        print(f"73. {mode} ms a step replayed {spread(replayed)}, eager "
              f"{spread(eager)}; busy share over {FIT_GRAPH_PROFILED} "
              f"replays {shares[0]} (kernels "
              f"{None if busy is None else round(busy[0], 4)} ms of "
              f"{None if busy is None else round(busy[1], 4)} ms wall), "
              f"eager over {FIT_EAGER_PROFILED} steps {shares[1]} (kernels "
              f"{None if busy_e is None else round(busy_e[0], 4)} ms of "
              f"{None if busy_e is None else round(busy_e[1], 4)} ms) "
              f"[{card}]", flush=True)
        report[mode].update({
            "replayed_ms": replayed, "eager_ms": eager,
            "busy_share_replayed": shares[0], "busy_share_eager": shares[1],
            "busy_replayed": busy, "busy_eager": busy_e})
    del kept
    spent["times"] = time.perf_counter() - t_times

    # fit_dense_grid in its auto mode at the flagship, to PSNR 35
    plan, cams, fresh, targets = cases["tiled"][:4]
    cfg = fit.FitConfig(learning_rate=FIT_LR, steps=FLAGSHIP_STEPS,
                        target_psnr=FLAGSHIP_PSNR, log_every=100,
                        sync_every=FLAGSHIP_SYNC)
    graph.reset_launch_counts()
    res = fit.fit_dense_grid(plan, fresh(), cams, targets, cfg)
    moved = {k: v for k, v in graph.launch_counts().items() if v}
    reached = next((i + 1 for i, p in enumerate(res.psnr_history)
                    if p >= FLAGSHIP_PSNR), None)
    print(f"73. fit_dense_grid auto at the flagship, graphed: mode "
          f"{res.mode}, {res.steps_run} steps, PSNR {FLAGSHIP_PSNR} first at "
          f"step {reached} (checked every {FLAGSHIP_SYNC}), wall_clock_s "
          f"{res.wall_clock_s:.4f} (schedule_build_s "
          f"{res.schedule_build_s:.4f}, first_step_s {res.first_step_s:.4f} "
          f"with the capture {res.capture_ms:.1f} ms, steady_step_ms "
          f"{res.steady_step_ms:.4f}); recorded {res.recorded_launches}, "
          f"counters moved {moved} [{card}]", flush=True)
    require(res.mode == "tiled" and res.reached_target,
            f"the auto fit ran {res.mode} and reached PSNR "
            f"{FLAGSHIP_PSNR}: {res.reached_target}")
    require(res.recorded_launches == {"fused_tiles": 1, "fused_tiles_bwd": 1}
            and moved == {"fused_tiles": 2, "fused_tiles_bwd": 2},
            f"the auto fit recorded {res.recorded_launches}, moved {moved}")
    report["auto"] = {
        "mode": res.mode, "steps_run": res.steps_run,
        "psnr_target_step": reached, "wall_clock_s": res.wall_clock_s,
        "schedule_build_s": res.schedule_build_s,
        "first_step_s": res.first_step_s, "capture_ms": res.capture_ms,
        "steady_step_ms": res.steady_step_ms}
    report["phase_s"] = time.perf_counter() - t_phase
    report["spent_s"] = spent
    print(f"phase 73 took {report['phase_s']:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()), flush=True)
    return report


def run(only: str = "all") -> dict:
    import torch

    import dvren_tpu_torch as P
    from dvren_tpu_torch import _build
    from dvren_tpu_torch.ops import fused_tiles, gather_plan, packed_transpose
    from dvren_tpu_torch.render import graph, tiled

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report = {}
    t_start = time.perf_counter()

    def elapsed(phases):
        print(f"phases {phases} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    # 1. card and build
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build {time.perf_counter() - t0:.3f} s "
          f"(nvcc {_build.build_seconds} s)", flush=True)
    for line in _build.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if only == "hash":
        hash_kernels, hash_report = run_hash(torch, P, dev)
        elapsed("11-15")
        print(json.dumps({"kernels": hash_kernels}), flush=True)
        print(json.dumps({**hash_report, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device
    if only == "grid":
        grid_kernels, grid_report = run_grid(torch, P, dev)
        print(json.dumps({"kernels": grid_kernels}), flush=True)
        print(json.dumps({**grid_report, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device
    if only == "gridviews":
        kernels, views = [], {}
        for phase, finest in ((34, 32), (35, 64)):
            view_kernels, views[f"grid_views_{finest}"] = run_grid_views(
                torch, P, dev, card, finest)
            kernels += view_kernels
            elapsed(str(phase))
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({**views, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device
    if only == "window":
        win_kernels, win_report = run_window(torch, P, dev, card)
        elapsed("37-41")
        print(json.dumps({"kernels": win_kernels}), flush=True)
        print(json.dumps({**win_report, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device
    if only == "split":
        split_kernels, split_report = run_split(torch, P, dev, card)
        elapsed("42-46")
        print(json.dumps({"kernels": split_kernels}), flush=True)
        print(json.dumps({**split_report, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device
    if only == "sched":
        sched_kernels, sched_report = run_sched(torch, P, dev, card)
        elapsed("47-51")
        print(json.dumps({"kernels": sched_kernels}), flush=True)
        print(json.dumps({**sched_report, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device
    if only == "general":
        gen_kernels, gen_report = run_general(torch, P, dev, card)
        elapsed("52-57")
        print(json.dumps({"kernels": gen_kernels}), flush=True)
        print(json.dumps({**gen_report, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device
    if only == "posed":
        posed_kernels, posed_report = run_posed(torch, P, dev, card)
        elapsed("58-61")
        print(json.dumps({"kernels": posed_kernels}), flush=True)
        print(json.dumps({**posed_report, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device
    if only == "close":
        close_kernels, close_report = run_close(torch, P, dev, card)
        elapsed("65-69")
        print(json.dumps({"kernels": close_kernels}), flush=True)
        print(json.dumps({**close_report, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device
    if only == "parallel":
        par_kernels, par_report = run_parallel(torch, P, dev, card)
        elapsed("62-64")
        print(json.dumps({"kernels": par_kernels}), flush=True)
        print(json.dumps({**par_report, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device
    if only == "fit":
        fit_report = run_fit_graph(torch, P, dev, card)
        elapsed("73")
        print(json.dumps({"kernels": []}), flush=True)
        print(json.dumps({"fit_graph": fit_report, "card": card}),
              flush=True)
        print(card_line(), flush=True)
        return device
    if only == "soak":
        soak_kernels, soak_report = run_soak(torch, P, dev, card)
        elapsed("70-72")
        print(json.dumps({"kernels": soak_kernels}), flush=True)
        print(json.dumps({**soak_report, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device

    # 2. K3 against its plain twin at 64^3
    plan, config = headline_scene(P)
    field = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    sigma, color = field.sigma, field.color
    rows_k = packed_transpose.build_rows(sigma, color)
    rows_p = packed_transpose.build_rows_plain(sigma, color)
    torch.cuda.synchronize()
    require(torch.equal(words(rows_k), words(rows_p)),
            "K3 differs from its plain twin")
    print(f"K3 == plain, bit for bit: {tuple(rows_k.shape)}", flush=True)

    # 3. the headline schedule
    t0 = time.perf_counter()
    sched_host, _ = tiled.build_tiled_schedule_auto(plan, field)
    build_s = time.perf_counter() - t0
    sched = sched_host.to(dev)
    n_tiles = sum(g.n_tiles for g in sched.groups)
    print(f"schedule build {build_s:.3f} s: {len(sched.groups)} groups, "
          f"{n_tiles} tiles, chunks "
          f"{sorted({g.n_chunks for g in sched.groups})}, banks <= "
          f"{max(g.banks for g in sched.groups)}, "
          f"{sched.tiled_samples} of {sched.full_lattice_samples} samples "
          f"live, fallback_rays {sched.fallback_rays}", flush=True)
    require(sched.fallback_rays == 0, "schedule has fallback rays")
    report["schedule_build_s"] = build_s

    # 4. K1, one launch over every group, against its plain twin run group
    # by group
    geom = (sched.bbox[0], sched.bbox[1], sched.grid_shape)
    tiles = sched.tiles
    tabs = tiled._gather_banks_flat(rows_k, sched.gathermap_all)
    prm = fused_tiles.tiles_op_params(plan, geom, tiles)
    args = (tabs, tiles, prm)
    n_groups = len(sched.groups)
    out_k = fused_tiles.tile_forward(*args)
    out_p = fused_tiles.tile_forward_set_plain(*args)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out_k).all()), "K1 output not finite")
    k1_err, k1_depth = head_errors(torch, fused_tiles, plan, out_k, out_p)
    k1_raw = float((out_k - out_p).abs().max())
    print(f"K1 (one launch) vs plain over {n_groups} groups: heads "
          f"{k1_err:.3e}, depth {k1_depth:.3e}, raw {k1_raw:.3e}; equal bit "
          f"for bit {torch.equal(out_k, out_p)}", flush=True)
    require(torch.equal(out_k, out_p),
            "K1 differs from its plain twin")

    # 5. the main path, end to end
    renderer = P.Renderer(P.Context.create(device="cuda"), plan)
    graph.reset_launch_counts()
    result = renderer.forward(field)
    launches = counts_of(("fused_tiles", "packed_table"))
    print(f"Renderer.forward: {result.stats.total_ms:.3f} ms (schedule "
          f"included), launches {launches}, notes {result.stats.notes}",
          flush=True)
    require(launches["fused_tiles"] > 0 and launches["packed_table"] > 0,
            "the main path did not launch both kernels")
    n_px = plan.width * plan.height
    require(result.image.shape == (n_px * 3,)
            and result.opacity.shape == (n_px,), "unexpected plane shapes")
    for name in ("image", "transmittance", "opacity", "depth"):
        require(bool(np.isfinite(getattr(result, name)).all()),
                f"{name} not finite")
    require(float(result.opacity.max()) > 0.0, "opacity is 0 everywhere")
    with torch.no_grad():
        plain = tiled.render_tiled(plan, field, renderer._tiled_schedule,
                                   use_kernel=False)
    e2e_err, e2e_depth, hit_ok = planes_errors(result, plain)
    print(f"forward vs plain path: planes {e2e_err:.3e}, depth "
          f"{e2e_depth:.3e}, hitmask equal {hit_ok}; opacity max "
          f"{float(result.opacity.max()):.6f} mean "
          f"{float(result.opacity.mean()):.6f}", flush=True)
    require(e2e_err <= TOL and e2e_depth <= TOL_DEPTH and hit_ok,
            "forward differs from the plain path")

    s_plan, s_config = small_scene(P)
    s_field = P.DenseGridField.create(s_config, device=dev)
    s_out = P.Renderer(P.Context.create(device="cuda"), s_plan).forward(
        s_field)
    cpu_field = P.DenseGridField.create(s_config, device="cpu")
    s_ref = P.Renderer(P.Context.create(device="cpu"), s_plan,
                       P.RenderOptions(use_tiles=True)).forward(cpu_field)
    s_err = max(float(np.abs(getattr(s_out, k) - getattr(s_ref, k)).max())
                for k in ("image", "transmittance", "opacity"))
    s_depth = float(np.abs(s_out.depth - s_ref.depth).max())
    print(f"small scene, card vs CPU plain: planes {s_err:.3e}, depth "
          f"{s_depth:.3e}", flush=True)
    require(s_err <= TOL and s_depth <= TOL_DEPTH
            and np.array_equal(s_out.hitmask, s_ref.hitmask),
            "small scene on the card differs from the CPU")

    # 6. times
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: tiled.render_tiled(plan, field, sched),
                         FRAMES, warmup=3)
        plain_fwd_ms = cuda_ms(
            torch, lambda: tiled.render_tiled(plan, field, sched,
                                              use_kernel=False), 3, warmup=1)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        renderer.forward(field)
    host_ms = (time.perf_counter() - t0) / FRAMES * 1e3
    n_rays = plan.ray_count
    print(f"forward {fwd_ms:.4f} ms/frame = {n_rays / fwd_ms / 1e3:.3f} "
          f"Mrays/s over {FRAMES} frames (plain path {plain_fwd_ms:.4f} "
          f"ms); Renderer.forward with host copies {host_ms:.4f} ms/frame; "
          f"peak device memory {peak_mb:.1f} MiB", flush=True)

    k3_ms, k3_issued_ms, k3_plain_ms = packed_times(
        torch, lambda: packed_transpose.build_rows(sigma, color),
        lambda: packed_transpose.build_rows_plain(sigma, color))
    gather_ms = cuda_ms(
        torch, lambda: tiled._gather_banks_flat(rows_k, sched.gathermap_all),
        20)
    k1_ms = cuda_ms(torch, lambda: fused_tiles.tile_forward(*args), 20)
    k1_plain_ms = cuda_ms(
        torch, lambda: fused_tiles.tile_forward_set_plain(*args), 3, warmup=1)
    raw = fused_tiles.tile_forward(*args)
    ids = [g.tile_ids for g in sched.groups]
    compose_ms = cuda_ms(torch, lambda: tiled._compose_tiles(plan, [raw], ids),
                         20)
    print(f"stages ms/frame: K3 {k3_issued_ms:.4f} as issued, "
          f"{k3_ms:.4f} on the device (plain {k3_plain_ms:.4f}), "
          f"bank gather {gather_ms:.4f}, K1 {k1_ms:.4f} in 1 launch over "
          f"{n_groups} groups (plain {k1_plain_ms:.4f}), compose "
          f"{compose_ms:.4f}", flush=True)

    # 7. K2, one launch over every group, against its plain twin run group
    # by group (bit for bit) and its float64 twin
    gen = torch.Generator(device=dev).manual_seed(7)
    gs = torch.randn((tiles.n_tiles, 5, 16, 16), generator=gen, device=dev)
    gss = [gs]
    b_rows, b_rayt = fused_tiles.tile_backward(tabs, tiles, gs, prm, cam=True)
    b_rows_nc, none = fused_tiles.tile_backward(tabs, tiles, gs, prm)
    b_rows2, b_rayt2 = fused_tiles.tile_backward(tabs, tiles, gs, prm,
                                                 cam=True)
    torch.cuda.synchronize()
    p_rows, p_rayt = fused_tiles.tile_backward_set_plain(tabs, tiles, gs, prm,
                                                         cam=True)
    rows64, rayt64 = twin64(torch, args, gs)
    require(bool(torch.isfinite(b_rows).all()
                 and torch.isfinite(b_rayt).all()), "K2 not finite")
    require(none is None and torch.equal(b_rows_nc, b_rows),
            "K2 without the camera differs from K2 with it")
    require(torch.equal(b_rows2, b_rows) and torch.equal(b_rayt2, b_rayt),
            "K2 differs between two runs")
    k2_err = rel_err(b_rows, p_rows)
    k2_cam_err = rel_err(b_rayt, p_rayt)
    k2_raw = float((b_rows - p_rows).abs().max())
    k2_err64 = rel_err(b_rows.double(), rows64)
    k2_cam_err64 = rel_err(b_rayt.double(), rayt64)
    print(f"K2 (one launch) over {n_groups} groups vs plain twin: d(table) "
          f"{k2_err:.3e} x scale (max |diff| {k2_raw:.3e}), d(rayt) "
          f"{k2_cam_err:.3e} x scale; vs its float64 twin d(table) "
          f"{k2_err64:.3e}, d(rayt) {k2_cam_err64:.3e} x scale (float32 "
          f"sums in the twin's order); repeat runs equal", flush=True)
    require(torch.equal(b_rows, p_rows) and torch.equal(b_rayt, p_rayt),
            "K2 differs from its plain twin")

    # 8. K4 against its plain twin at 64^3
    n_rows = packed_transpose.fullpitch_rows(sigma.shape)
    all_rows = b_rows.reshape(-1, 32)
    tg = gather_plan.slot_rows_to_table(all_rows, sched.gather_plan, n_rows)
    k4_out = packed_transpose.table_grad_to_params(tg, sigma.shape)
    torch.cuda.synchronize()
    k4_plain = packed_transpose.table_grad_to_params_plain(tg, sigma.shape)
    require(all(torch.equal(x, y) for x, y in zip(k4_out, k4_plain)),
            "K4 differs from its plain twin")
    k4_err = max(float((x - y).abs().max()) for x, y in zip(k4_out, k4_plain))
    print(f"K4 == plain, bit for bit: d_sigma {tuple(k4_out[0].shape)}, "
          f"d_color {tuple(k4_out[1].shape)}", flush=True)

    # 9. Renderer.backward, deterministic
    dl = torch.rand((plan.ray_count, 3), generator=gen, device=dev) * 2 - 1
    dl = dl.cpu().numpy()
    graph.reset_launch_counts()
    torch.use_deterministic_algorithms(True)
    try:
        bwd = renderer.backward(field, dl)
        bwd_launches = counts_of(DENSE)
        bwd2 = renderer.backward(field, dl)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"Renderer.backward launches {bwd_launches}", flush=True)
    require(bwd_launches["fused_tiles_bwd"] == 1
            and bwd_launches["packed_table_bwd"] == 1,
            "Renderer.backward did not launch K2 and K4 once")
    for name in ("sigma", "color", "camera", "camera_k"):
        x = getattr(bwd, name)
        require(bool(np.isfinite(x).all()) and float(np.abs(x).max()) > 0,
                f"backward {name} not finite or zero")
        require(np.array_equal(x, getattr(bwd2, name)),
                f"backward {name} differs between two calls")
    dl_img = renderer._dl_image(dl)
    plain_g = [g.cpu().numpy() for g in tiled_grads(
        torch, P, tiled, plan, field, sched, dl_img, use_kernel=False)]
    bwd_errs = {
        "sigma": rel_err(torch.from_numpy(bwd.sigma),
                         torch.from_numpy(plain_g[0].reshape(-1))),
        "color": rel_err(torch.from_numpy(bwd.color),
                         torch.from_numpy(plain_g[1].reshape(-1)))}
    cam_ok = (np.allclose(bwd.camera, plain_g[2], rtol=CAM_RTOL,
                          atol=CAM_ATOL)
              and np.allclose(bwd.camera_k, plain_g[3], rtol=CAM_RTOL,
                              atol=CAM_ATOL))
    print(f"backward vs plain path: sigma {bwd_errs['sigma']:.3e} x scale, "
          f"color {bwd_errs['color']:.3e} x scale, camera "
          f"{float(np.abs(bwd.camera - plain_g[2]).max()):.3e}, camera_k "
          f"{float(np.abs(bwd.camera_k - plain_g[3]).max()):.3e}; two "
          f"calls equal", flush=True)
    require(max(bwd_errs.values()) <= GRID_TOL and cam_ok,
            "backward differs from the plain path")

    s_dl = np.random.default_rng(3).uniform(
        -1, 1, s_plan.ray_count * 3).astype(np.float32)
    s_card = P.Renderer(P.Context.create(device="cuda"), s_plan)
    s_card.forward(s_field)
    s_got = s_card.backward(s_field, s_dl)
    s_cpu = P.Renderer(P.Context.create(device="cpu"), s_plan,
                       P.RenderOptions(use_tiles=True))
    s_cpu.forward(cpu_field)
    s_want = s_cpu.backward(cpu_field, s_dl)
    s_bwd_err = max(rel_err(torch.from_numpy(getattr(s_got, k)),
                            torch.from_numpy(getattr(s_want, k)))
                    for k in ("sigma", "color"))
    print(f"small scene backward, card vs CPU: grids {s_bwd_err:.3e} x "
          f"scale, camera {float(np.abs(s_got.camera - s_want.camera).max()):.3e}",
          flush=True)
    require(s_bwd_err <= GRID_TOL
            and np.allclose(s_got.camera, s_want.camera, rtol=CAM_RTOL,
                            atol=CAM_ATOL)
            and np.allclose(s_got.camera_k, s_want.camera_k, rtol=CAM_RTOL,
                            atol=CAM_ATOL),
            "small scene backward on the card differs from the CPU")

    # 10. training steps through autograd of render_tiled
    from dvren_tpu_torch.opt.fit import mse, psnr

    target = torch.zeros((plan.height, plan.width, 3), device=dev)

    def trainer(lr):
        field_t = P.DenseGridField.create(config, device=dev)
        opt = torch.optim.SGD(field_t.parameters(), lr=lr)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = mse(tiled.render_tiled(plan, field_t, sched).image,
                       target)
            loss.backward()
            opt.step()
            return loss

        return field_t, step

    def four_steps(lr):
        field_t, step = trainer(lr)
        losses = []
        for _ in range(4):
            before = counts_of(DENSE)
            losses.append(float(step().detach()))
            after = counts_of(DENSE)
            require(all(after[k] == before[k] + 1 for k in DENSE_F32),
                    f"a kernel did not launch once in a training step: "
                    f"{after}")
        moved = max(float((field_t.sigma.detach() - sigma).abs().max()),
                    float((field_t.color.detach() - color).abs().max()))
        return losses, moved

    # bench.py's loop as it is: at lr 1e-3 the mean over 512*512*3 values
    # makes every update smaller than half an ulp of the parameters, so
    # they do not move in float32. The loss must fall at a learning rate
    # scaled by that count (the same steps on the summed squared error).
    graph.reset_launch_counts()
    losses, moved = four_steps(LR)
    train_launches = counts_of(DENSE)
    n_values = plan.height * plan.width * 3
    losses_n, moved_n = four_steps(LR * n_values)
    print(f"4 SGD steps at lr {LR}: loss {losses}, largest parameter "
          f"change {moved:.3e}; launches {train_launches}", flush=True)
    print(f"4 SGD steps at lr {LR} x {n_values}: loss {losses_n} (psnr "
          f"{float(psnr(torch.tensor(losses_n[-1]))):.4f} dB), largest "
          f"parameter change {moved_n:.3e}", flush=True)
    require(all(np.isfinite(losses + losses_n)),
            "training loss is not finite")
    require(all(b < a for a, b in zip(losses_n, losses_n[1:])),
            "training loss does not fall")
    _, step = trainer(LR)

    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(torch, step, STEPS, warmup=2)
    train_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    plain_train = P.DenseGridField.create(config, device=dev)
    plain_opt = torch.optim.SGD(plain_train.parameters(), lr=LR)

    def plain_step():
        plain_opt.zero_grad(set_to_none=True)
        loss = mse(tiled.render_tiled(plan, plain_train, sched,
                                      use_kernel=False).image, target)
        loss.backward()
        plain_opt.step()

    plain_step_ms = cuda_ms(torch, plain_step, 1, warmup=1)
    k2_ms = cuda_ms(torch, lambda: fused_tiles.tile_backward(
        tabs, tiles, gs, prm), 20)
    k2_plain_ms = cuda_ms(torch, lambda: fused_tiles.tile_backward_set_plain(
        tabs, tiles, gs, prm), 1, warmup=1)
    reduce_ms = cuda_ms(torch, lambda: gather_plan.slot_rows_to_table(
        all_rows, sched.gather_plan, n_rows), 20)
    k4_ms, k4_issued_ms, k4_plain_ms = packed_times(
        torch, lambda: packed_transpose.table_grad_to_params(tg, sigma.shape),
        lambda: packed_transpose.table_grad_to_params_plain(tg, sigma.shape))
    print(f"training step {step_ms:.4f} ms/step = "
          f"{n_rays / step_ms / 1e3:.3f} Mrays/s over {STEPS} steps (plain "
          f"path {plain_step_ms:.4f} ms/step); peak device memory "
          f"{train_peak_mb:.1f} MiB", flush=True)
    print(f"backward stages ms/step: K2 {k2_ms:.4f} in 1 launch over "
          f"{n_groups} groups (plain {k2_plain_ms:.4f}), slot reduction "
          f"{reduce_ms:.4f}, K4 {k4_issued_ms:.4f} as issued, {k4_ms:.4f} "
          f"on the device (plain {k4_plain_ms:.4f})",
          flush=True)

    # bounds: each kernel's inputs and outputs at this run's shapes, and
    # its operations per live sample (K3 and K4 copy and add: bytes)
    k1_in = tile_in_bytes(args)
    k1_out = tiles.n_tiles * 5 * 256 * 4
    k2_out = nbytes(b_rows)
    live = sched.tiled_samples
    from dvren_tpu_torch.utils import roofline

    streams = roofline.forward_streams(sched)["phases"]
    require(streams["kernel"]["bytes"] == k1_in + k1_out
            and streams["table"]["bytes"] == nbytes(sigma, color, rows_k),
            "utils/roofline.py's K1 / K3 bytes differ from the kernels' "
            "inputs and outputs")
    kernels = [
        {"name": "fused_tiles", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:656",
         "launches": launches["fused_tiles"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         **bound(streams["kernel"]["bytes"], live * tile_counts.FWD_OPS)},
        {"name": "packed_table", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/packed_table.cu",
         "replaces": "dvren_tpu/ops/packed_transpose.py:81",
         "launches": launches["packed_table"],
         "max_abs_err": float((rows_k - rows_p).abs().max()),
         "ms": k3_ms, "issued_ms": k3_issued_ms, "plain_ms": k3_plain_ms,
         **bound(streams["table"]["bytes"], 0)},
        {"name": "fused_tiles_bwd", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles_bwd.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:714",
         "launches": train_launches["fused_tiles_bwd"],
         "max_abs_err": k2_raw, "ms": k2_ms, "plain_ms": k2_plain_ms,
         **bound(k1_in + sum(nbytes(g) for g in gss) + k2_out,
                 live * tile_counts.BWD_OPS)},
        {"name": "packed_table_bwd", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/packed_table_bwd.cu",
         "replaces": "dvren_tpu/ops/packed_transpose.py:119",
         "launches": train_launches["packed_table_bwd"],
         "max_abs_err": k4_err, "ms": k4_ms, "issued_ms": k4_issued_ms,
         "plain_ms": k4_plain_ms,
         **bound(nbytes(tg, *k4_out), 8 * sum(x.numel() for x in k4_out))},
    ]
    if only in ("dense", "tiles", "tables"):
        extra = {}
        if only == "tables":
            elapsed("1-10")
            table_kernels, extra["tables"] = run_tables(
                torch, P, dev, plan, config, renderer, result, all_rows)
            elapsed("21-27")
            fine_kernels, extra["subtiles"] = run_subtiles(
                torch, P, dev, card, fine_only=True)
            elapsed("28-30")
            kernels += table_kernels + fine_kernels
        if only == "tiles":
            elapsed("1-10")
            sub_kernels, extra["subtiles"] = run_subtiles(torch, P, dev, card)
            elapsed("28-33")
            fit_kernels, extra["fit_dense_grid"] = run_fit_flagship(
                torch, P, dev, card,
                extra["subtiles"]["fit_flagship"]["adam_step_ms"])
            elapsed("36")
            sc_kernels, extra["supercell_4px"] = run_supercell4(torch, P, dev,
                                                                card)
            elapsed("41")
            split_kernels, extra["split"] = run_split(
                torch, P, dev, card, headline=(plan, config, field,
                                               sched_host))
            elapsed("42-46")
            kernels += sub_kernels + fit_kernels + sc_kernels + split_kernels
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({
            **extra, "forward_ms": fwd_ms, "stages_ms": {
                "packed_table": k3_issued_ms, "bank_gather": gather_ms,
                "fused_tiles": k1_ms, "compose": compose_ms},
            "train_step_ms": step_ms, "backward_stages_ms": {
                "fused_tiles_bwd": k2_ms, "slot_reduction": reduce_ms,
                "packed_table_bwd": k4_issued_ms}, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device
    elapsed("1-10")
    table_kernels, table_report = run_tables(
        torch, P, dev, plan, config, renderer, result, all_rows)
    kernels += table_kernels
    elapsed("21-27")
    hash_kernels, hash_report = run_hash(torch, P, dev)
    kernels += hash_kernels
    elapsed("11-15")
    grid_kernels, grid_report = run_grid(torch, P, dev)
    kernels += grid_kernels
    elapsed("16-20")
    sub_kernels, sub_report = run_subtiles(torch, P, dev, card)
    kernels += sub_kernels
    elapsed("28-33")
    for phase, finest in ((34, 32), (35, 64)):
        view_kernels, hash_report[f"grid_views_{finest}"] = run_grid_views(
            torch, P, dev, card, finest)
        kernels += view_kernels
        elapsed(str(phase))
    fit_kernels, hash_report["fit_dense_grid"] = run_fit_flagship(
        torch, P, dev, card, sub_report["fit_flagship"]["adam_step_ms"])
    kernels += fit_kernels
    elapsed("36")
    win_kernels, hash_report["window"] = run_window(torch, P, dev, card)
    kernels += win_kernels
    elapsed("37-41")
    split_kernels, hash_report["split"] = run_split(
        torch, P, dev, card, headline=(plan, config, field, sched_host))
    kernels += split_kernels
    elapsed("42-46")
    sched_kernels, hash_report["sched"] = run_sched(torch, P, dev, card)
    kernels += sched_kernels
    elapsed("47-51")
    gen_kernels, hash_report["general"] = run_general(torch, P, dev, card)
    kernels += gen_kernels
    elapsed("52-57")
    posed_kernels, hash_report["posed"] = run_posed(torch, P, dev, card)
    kernels += posed_kernels
    elapsed("58-61")
    par_kernels, hash_report["parallel"] = run_parallel(
        torch, P, dev, card, sched_host=sched_host)
    kernels += par_kernels
    elapsed("62-64")
    close_kernels, hash_report["close"] = run_close(
        torch, P, dev, card, headline=(plan, config, field, sched_host))
    kernels += close_kernels
    elapsed("65-69")
    soak_kernels, hash_report["soak"] = run_soak(torch, P, dev, card)
    kernels += soak_kernels
    elapsed("70-72")
    hash_report["fit_graph"] = run_fit_graph(torch, P, dev, card)
    elapsed("73")
    hash_report["grid"] = grid_report
    hash_report["tables"] = table_report
    hash_report["subtiles"] = sub_report
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({**hash_report,
        "forward_ms": fwd_ms, "forward_mrays_s": n_rays / fwd_ms / 1e3,
        "plain_forward_ms": plain_fwd_ms, "renderer_forward_ms": host_ms,
        "stages_ms": {"packed_table": k3_issued_ms, "bank_gather": gather_ms,
                      "fused_tiles": k1_ms, "compose": compose_ms},
        "schedule_build_s": build_s, "peak_mib": peak_mb,
        "forward_vs_plain": e2e_err, "depth_vs_plain": e2e_depth,
        "train_step_ms": step_ms, "train_mrays_s": n_rays / step_ms / 1e3,
        "plain_train_step_ms": plain_step_ms, "train_losses": losses,
        "train_losses_scaled_lr": losses_n,
        "train_peak_mib": train_peak_mb,
        "backward_stages_ms": {"fused_tiles_bwd": k2_ms,
                               "slot_reduction": reduce_ms,
                               "packed_table_bwd": k4_issued_ms},
        "packed_device_ms": {"packed_table": k3_ms,
                             "packed_table_bwd": k4_ms},
        "k2_rel_err": k2_err, "k2_rayt_rel_err": k2_cam_err,
        "k2_rel_err_float64": k2_err64,
        "k2_rayt_rel_err_float64": k2_cam_err64,
        "backward_vs_plain": bwd_errs, "card": card}), flush=True)
    print(card_line(), flush=True)
    return device


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--only", choices=("all", "dense", "tiles", "tables", "hash",
                           "grid", "gridviews", "window", "split", "sched",
                           "general", "posed", "parallel", "close",
                           "soak", "fit"),
        default="all",
        help="'dense': phases 1-10 alone (the dense headline); 'tiles': "
             "phases 1-10, 28-33, 36, 41 and 42-46 (K1 and K2 in every "
             "form, K6); 'tables': phases 1-10, 21-27 and 28-30 (the "
             "16-bit tables, K5a and K5b at 64^3 and 128^3); 'hash': "
             "phase 1 and phases 11-15 (the hash "
             "headline, K7f and K7b); 'grid': phase "
             "1 and phases 16-20 (the grid headline); 'gridviews': phase 1 "
             "and phases 34-35 (the grid path over eight views at 8 and 4 "
             "px); 'window': phase 1 and "
             "phases 37-41 (the windowed path, its fallback and K9); "
             "'split': phase 1 and phases 42-46 (the split backward, K6); "
             "'sched': phase 1 and phases 47-51 (the native scheduler core, "
             "pitch 2, occupancy on the SDF shell, the moving camera, the "
             "train-state checkpoint); 'general': phase 1 and phases "
             "52-57 (the Renderer's streamed, fused, staged and override "
             "paths over K9f / K9b, render_views); 'posed': phase 1 and "
             "phases 58-61 (the device-built pose schedule, enable_graph's "
             "CUDA graphs, the tiled stage timings, the CLI); 'parallel': "
             "phase 1 and phases 62-64 (the sharded paths over "
             "torch.distributed at D = 1 over NCCL and D = 2 sharing the "
             "card over gloo, dryrun_multichip); 'close': phase 1 and "
             "phases 65-69 (the jitter kernel, pipeline.render without a "
             "table, bank-aligned K1 / K2, the fit block, the roofline); "
             "'soak': phase 1 and phases 70-72 (the 960x720 soak frame, "
             "the 120-frame animation, pose refinement); 'fit': phase 1 "
             "and phase 73 (the fits' steps recorded as CUDA graphs and "
             "replayed, against their eager steps); "
             "each for timing two trees against each other in one call")
    parser.add_argument("--split-child", action="store_true",
                        help=argparse.SUPPRESS)   # phase 45's child process
    parser.add_argument("--fit-busy-child", action="store_true",
                        help=argparse.SUPPRESS)   # phase 73's child process
    args = parser.parse_args()
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: no torch: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if args.fit_busy_child:
        try:
            import dvren_tpu_torch as P

            dev = torch.device("cuda", 0)
            torch.cuda.set_device(dev)
            print(json.dumps(run_fit_busy_child(torch, P, dev)), flush=True)
        except Exception:  # the parent reports the failure and goes on
            traceback.print_exc()
            return 1
        return 0
    if args.split_child:
        try:
            import dvren_tpu_torch as P

            dev = torch.device("cuda", 0)
            torch.cuda.set_device(dev)
            print(json.dumps(run_split_child(torch, P, dev)), flush=True)
        except Exception:  # the parent reports the failure and fails
            traceback.print_exc()
            return 1
        return 0
    try:
        device = run(args.only)
    except Exception:  # report any failed phase, then fail the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
