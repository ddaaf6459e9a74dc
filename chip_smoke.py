#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main paths and holds each hand-written kernel
against its plain PyTorch version on the card. The paper's slot loop,
`simulate` and `serve_loop`, with `CarbonIntensityPolicy` (Algorithm 1)
and the paper's `QueueLengthPolicy` baseline, runs at M=4096 task types
x N=256 clouds, its arrivals drawn from JAX's threefry stream by the
draw kernel; the scenario fleet, `simulate_fleet`, at the JAX bench's
512 lanes of M5xN5 and at 16 lanes of M4096xN256; `simulate_vsweep` on
the paper's Fig. 2 setup; the WAN route-aware slot loop, `simulate(graph=)` with
`NetworkAwareDPPPolicy` and its transfer-blind baseline
`StaticRoutePolicy(CarbonIntensityPolicy)`, at M=4096 x N=256 x L=512
routes; the WAN fleet, `simulate_fleet` on fleets with a stacked graph,
at the JAX bench's 64 lanes of M5xN5 per topology and at 16 lanes of
M4096xN256xL512; the forecast layer, `simulate_fleet(forecaster=)`
with `LookaheadDPPPolicy`, at the JAX bench's rows and at 16 lanes of
M4096xN256; LM serving, `greedy_generate` (prefill + KV-cache decode), for
GLM-4-9B at full width and depth in bf16, batch 8, 4096-token prompts,
64 generated tokens; SSM serving, the same `greedy_generate` (prefill +
state decode), for mamba2-1.3B at full width and depth in bf16 at the
same batch and lengths; the fault layer, `simulate_fleet` on fleets with
a fault axis, at the JAX bench's rows and at fleet B's and W2's widths;
the deadline layer, `simulate_fleet` on fleets with a deadline axis
(SlackThreshold, WaitAwhile, EDD), at the JAX bench's rows and at fleet
B's width, and a deadline-aware `serve_loop`; the telemetry layer
(`telemetry=` on `simulate` and `simulate_fleet`, batch and streamed) at
the JAX benches' rows, on the fault rows and W1, and at the main path's
and fleet B's width; MoE serving, the same `greedy_generate`, for
Qwen1.5-MoE-A2.7B at full width and depth and Snowflake Arctic at full
width and one layer, in bf16 at the same batch and lengths; VLM serving,
`Model.prefill` and `Model.decode_step` on a batch of image patch
embeddings and text tokens, for PaliGemma-3B at full size in bf16 at the
same batch and lengths; enc-dec serving, `Model.prefill` on a batch of
speech frame embeddings and `Model.decode_step`, for SeamlessM4T-medium at
full size in bf16 at the same batch and generated tokens; training,
`Model.loss` under `launch.train.train_loop`, for Qwen1.5-0.5B and
mamba2-1.3B at full size in bf16, 8 x 4096 tokens a step.
Phases, one or more lines each, run in the order 1-4c, 4d, 4e, 4f, 4g,
4h, 4i, 5-6, 10, 11, 12, 13, 13s, 8, 9, 7 (phase 7 times every kernel
with the launch counts of all paths; phases 10, 11, 12, 13 and 13s free
their models before phase 8 builds GLM-4-9B, which phase 7 keeps). Each phase prints its wall
seconds on a line of its own when it ends ("[<phase> wall]"), and the run
ends with all of them and its total ("[wall]"):

1. device: name, compute capability (must be 9.0) and the nvidia-smi
   name / power limit;
2. build: every kernel source in csrc/ (`build.SOURCES`) compiled with
   nvcc, in parallel;
3. kernels vs plain versions on the card, bitwise, at the main paths'
   shapes and at small, ragged and degenerate ones (route_scores in both
   of its rounding modes); for greedy_fill also the classified walk's
   edges (4096 lanes of 2 items with P0 on, one ulp below and one ulp
   above the first item's T and U from `fill_thresholds` on the card), a
   4096-item lane at the least budget `fill_certified` passes and one
   ulp short of it (certified, and walking every item), M 16384 and 16383
   (16385 refused), non-integer, negative and NaN caps, and budgets of
   inf and NaN; carbon_scores with a lane axis (F16 x M4096 x N256 and
   F512 x M5 x N5 with one V a lane, F3 ragged) and F = 1 equal to the
   [M, N] call; route_scores with a lane axis in both modes (F16 x M4096
   x L512, F64 x M5 x L10 with one V a lane, F3 ragged) and F = 1 equal
   to the [M, L] call;
3e. threefry_draw vs its plain version, bitwise: keys PRNGKey(0),
   PRNGKey(-1), PRNGKey(2**31-1) at n 1, 5, 4096 and split lanes [512, 5]
   and [16, 4096]; t none, 0, 1, 191, 1999, 2**31-1; raw bits, uniform
   (three ranges), randint (spans 1, 2, 401, 701, 2**31-1), the
   RandomCarbonSource and RandomPolicy splits, the UK source's fold per
   region, the fleet's floor(u * (amax + 1)) and poisson's key walks
   (chain); over slot ranges (the loops' block draws), every walk (a
   plain table, seg, paths, fold_each, chain) with every finish (bits,
   uniform, floor, randint, randint_f32, normal) at slots none, 0 x 1,
   191 x 64 (rows 0 and 63 also equal to the kernel's single-slot draws)
   and 2**32-3 x 5 (wrapping), keys PRNGKey(-1) n 1030, PRNGKey(0) n 257,
   16 lanes n 4096, 512 lanes n 5; and known answers of jax 0.9.0 pasted
   below (THREEFRY_KNOWN, CHAIN_KNOWN, NORMAL_KNOWN);
3f. knapsack_dp (ExactDPPPolicy's DP) vs its plain version, bitwise:
   random instances at grids 16 to 1024 (K 1-40 knapsacks of M 1-16,
   integral scores in every third: ties), the CPU tests' edge cases
   (positives, caps past 2**n_splits - 1, items wider than the grid,
   ties, weights near 0 with caps past int32, NaN, budgets 0, < 0, NaN,
   inf), the crafted cases of the reference's rounding points with jax
   0.9.0's counts (KP_CRAFTED), a fleet-A-shaped launch (512 lanes x 6
   knapsacks of M5, grid 512, from the policy's score pass) and one slot
   at the main width (M4096 x N256, grid 512: 257 knapsacks, the edge's
   and the first cloud's held to the plain version); launches of 1, 6
   and 3,072 of fleet A's rows (held to the plain version) and of the
   main slot's rows (the first 2 held to the plain version, the rest to
   the slot's launch), which pick other group sizes; every kernel instance
   (cells a thread, a warp or a group, records in shared memory or
   streamed) through the inputs that pick it (KP_PLAN_GRIDS x KP_PLAN_KS,
   M5 and a streamed M), held to the plain version; 70 types past the
   staged 64 and grids past 4096 up to the kernel's limit (KP_WIDE),
   held to the plain version;
3c. the attention kernels vs their plain versions on the card, within
   |err| <= 2e-5 + 2e-5*|plain| in f32 (tests/test_kernels.py's) and
   1e-4 + 2**-7*|plain| in bf16 (one bf16 rounding step): flash_attention at the prefill shape (B 8,
   H 32, K 2, S 4096, hd 128, bf16) in all three masks, MHA, MQA,
   ragged, Sq > Skv, strided (the model's layout, hd 128 and 64) and
   f32; for the bf16 tensor-core route also each hd (16, 32, 64, 128)
   off the 128-row tiles, prefix_len off a tile edge and past Sq,
   causal Sq > Skv and a single block (B 1, H 1, S 64); flash_decode
   at B 8, H 32, K 2, S 4161, hd 128 for pos 0, 127, 128 (a tile edge),
   511, 512, 527, 528 (a split edge), 4095, 4160, G = 1, 8 and 32, hd
   16, 32, 64 off the 128-key tile, B = 1 and f32; PaliGemma's heads at
   hd 256 (MQA, H 8 on K 1) in bf16 and f32: flash_attention at B 2, S
   256, 1000 and 4096, causal, prefix_len 1, 255, 256, 257 and 1000,
   full, Sq 128 against Skv 1000, causal Sq > Skv and strided views, and
   the hd 256 instance's edges: Sq 127, 128, 129, 255, 257 (either side
   of its 128-row blocks), prefix_len 79, 80, 81, 159, 160, 161 (either
   side of its 80-key tiles) and 127, 129; flash_decode at S 4161 for
   pos 0, 63, 64, 127, 128 (either side of its 64-key tiles), 271, 272
   (of its 272-position splits at B 8), 4095, 4160, G 1, 8 and 32 and B
   1; the profiler naming attention_tc<256> and decode_tc<256>; and the
   LM layers' emulations of XLA:CPU (rope_angles at positions 0-32767 for every
   dense config, gelu_tanh, apply_rope) bitwise equal to the CPU's;
   SeamlessM4T's heads (hd 64, MHA: H 16 on K 16) in bf16 and f32:
   flash_attention at the encoder's shape (B 8, S 4096, full), the
   decode step's cross-attention (one query row against 4,096 source
   positions: 127 of the tensor-core block's 128 rows out of bounds),
   1, 2, 63 and 65 query rows against 1,000 and 4,095 keys, the
   teacher-forced decoder's cross (64 queries) and causal self-attention,
   causal G 1 at S 1000 and at 1, the encoder's and the cross step's
   strided [B,S,H,hd] views; flash_decode at G 1, hd 64, S 4161, pos 0,
   1 and 63;
   and the attention backward, flash_attention_bwd (`attention_bwd_cases`),
   against its plain version: Qwen1.5-0.5B's training shape (B 8, H 16 on
   K 16, S 4096, hd 64, causal) and GLM-4-9B's heads (B 8, H 32 on K 2,
   hd 128, S 1024), hd 16 and 32, the full mask with Sq < Skv, 63 and 65
   query rows against 1,000 and 4,095 keys, prefix_len 1, 255, 256, 257
   and 1000, B 1; float32 within 2e-5 x (sum|terms| + |plain|), bf16 (the
   tensor cores, from the forward kernel's lse and float32 output) each
   gradient's error from the float32 plain gradient at most 1.5 x the
   plain bf16 path's; every case twice, bitwise equal; the forward's
   output with those statistics bitwise its output without; the model's
   strided [B,S,H,hd] views bitwise the call on contiguous copies;
3d. ssd_chunk_intra vs its plain version on the card, within
   |err| <= 2e-5 * max(1, sum|terms|) + 2e-5*|plain| (sum|terms|: the plain
   version on |x|, |B|, |C|), `total` bitwise (the prefix sums' order),
   at mamba2-1.3B's prefill shape (B 8, nc 16,
   l 256, H 64, P 64, N 128) with strong, weak and the init's decays, a
   ragged chunk (l 100), H not a multiple of the 8-head group, B = nc = 1,
   and small, ragged and l = 1 shapes; and at the kernel's tile edges
   (64-row y tiles, 16- and 32-position steps, 128-state S_c passes,
   16-column x blocks, 32 heads a y block, 2 an S_c block): l 64, 65,
   128, 255; N 8, 136; P 8, 48; H 1, 3, 40 (with N 256); and inputs taken
   every other head from a 26-head tensor (H 13, a strided view the
   wrapper refuses, then its contiguous copy); x, B and C 4 bytes off a
   16-byte boundary (rows moved 4 bytes at a time); at the prefill shape
   y_diag and S_c bitwise equal to the plain version's (the kernel sums
   in its order: phase 9's float32 gate needs the same bits);
   ssd_chunk_intra_bwd vs its plain version within the same bound (each
   output's sum|terms| from `ssd_chunk_intra_bwd_terms`) at mamba2-1.3B's
   training shape (B 8, nc 16, l 256, H 64, P 64, N 128) with the init's,
   strong and weak decays, l 1, 16, 17, 255, P 16 and N 16, B = nc = 1, a
   ragged shape, N 256, a zero dS and a zero dy, l 250 with H 60 (a row
   tile off the tensor cores' 8-deep steps, a head group of 4); every
   case twice, bitwise equal;
4. main path, M4096xN256: `simulate` for both policies (T=64, summary
   records) under `torch.cuda.set_sync_debug_mode("error")`, launch
   counters checked (threefry_draw once a run: the arrivals' 64 slots
   one block draw), ms per
   slot from CUDA events, then again in turns (A, B, B, A); then T=16 on
   the card and through the CPU plain versions: queues bitwise,
   emissions within rtol 1e-6;
4b. WAN path, M4096xN256xL512 on the congested-uplink topology: the same
   for both WAN policies (T=64, launch counters per policy, idle share),
   then T=8 on the card and through the CPU plain versions: Qe, Qc, Qt
   bitwise, emissions within rtol 1e-6;
4c. the scenario fleet: A, `build_fleet(["diurnal"], per_kind=512)`
   (M5xN5, T=192, the JAX bench's fleet_summary/F512), and B, four kinds
   x 4 lanes at M4096xN256 (T=64), with CarbonIntensity (V=0.05) and
   QueueLength (B): each once under sync debug mode "error" with its
   launches per slot, then in turns (ms per slot, us per lane-slot),
   device busy and idle share per slot (profiler, 8 slots); A's summary
   scalars equal to its full record; B's lanes 0 and 15 equal to each
   instance run alone through `simulate`, and B's first two lanes on the
   card equal to the CPU plain path (T=4), queues and counts bitwise,
   emissions within rtol 1e-6; the kernels' times at both fleets'
   shapes; the registry fleet (6 kinds x 16, T=200) and its mean
   emission reduction held to JAX's within 1e-3 points;
4d. the WAN fleet: W1, `build_network_fleet([kind], per_kind=64)` for
   congested-uplink and multi-region-uk-wan (M5xN5, L 10, T=192, V=0.1,
   the JAX bench's network rows), NetworkAwareDPP and
   StaticRoute(CarbonIntensity), each once under sync debug mode "error"
   with its launches per slot, in turns and profiled (congested-uplink),
   then with record=T//8: the mean reduction held to jax 0.9.0's
   (WAN_JAX, within 1e-3 points on both topologies); W2,
   congested-uplink x 16 at M4096xN256xL512, T=64: launches, in turns,
   idle share and top kernels, lanes 0 and 15 equal to each instance run
   alone through `simulate(graph=)`, the first two lanes on the card
   equal to the CPU plain path (T=4; Qe, Qc, Qt and the counts bitwise,
   emissions within rtol 1e-6); route_scores timed at both fleets'
   shapes;
4e. forecasts: LookaheadDPPPolicy's discount ** arange(H) equal on the
   card and the CPU (discounts 0.98, 1.0; H 1-16); the rows of the JAX
   bench's bench_forecast_lookahead (diurnal and diurnal-slack, F16,
   T=192, V=0.2: la_H{1,4,8,16}_perfect, la_H8_noisy20,
   la_H8_persistence, la_H8_seasonal) under sync debug mode with their
   launches, each row's mean reduction against CarbonIntensity held to
   jax 0.9.0's (FORECAST_JAX, within 1e-3 points; the H=1 rows bitwise
   CarbonIntensity's run); then
   LookaheadDPP(H=8) on fleet B fed ClairvoyantTableForecaster(H=8) and
   RidgeARForecaster(H=8), in turns with CarbonIntensity (ms/slot),
   profiled; the clairvoyant run's lanes 0 and 15 equal to each instance
   alone and its first two lanes card vs CPU (T=4) bitwise; one RidgeAR
   predict with a full window timed;
4f. the fault layer: threefry_draw(paths=...) (the fault slot's six
   uniforms, one launch for every lane) bitwise equal to its plain
   version at F16 x M5 x N5 (L 10 and none), F16 x M4096 x N256 x L512
   and a path deeper than two with segments of length 1 and 0; the rows
   of the JAX bench's bench_fault_robustness (regional-blackout and
   telemetry-brownout on build_fleet(["diurnal-slack"]), flappy-uplink on
   build_network_fleet(["congested-uplink"]), F16, T=192, V=0.05, qlen /
   carbon / guard, with_faults(seed=0)) under sync debug mode with their
   launches (the fault stream one threefry_draw a slot, the arrivals one
   a run), each row's
   recovery and completed % equal to jax 0.9.0's and its emission
   reduction within 1e-3 points (FAULT_JAX), exact conservation on every
   lane and slot, the guard recovering faster than carbon and emitting
   less than qlen; no_faults fleets bitwise the fault-free fleets (both
   score routes) and the guard under no faults bitwise its inner policy;
   at full width fleet B (regional-blackout, telemetry-brownout; carbon,
   guard) and W2 (flappy-uplink; aware, guard), T=64: launches a slot, in
   turns against the same fleet without faults, idle share and top
   kernels, the guard's lanes 0 and 15 equal to each instance alone, F2
   card vs CPU (T=4) with queues, retry pool and counts bitwise; the
   paths draw timed at three fault slots beside the six per-segment
   draws it replaces, its plain version and its bound;
4g. the deadline layer: the rows of the JAX bench's bench_deadline_pareto
   (build_fleet(["diurnal-slack"]) and ["overload"], F16 x M5 x N5,
   T=192, V=0.2, H=16 with ClairvoyantTableForecaster, record="summary",
   PRNGKey(0): CarbonIntensity, LookaheadDPP, SlackThreshold, WaitAwhile
   and EDD on generous-slack, SlackThreshold unshedded and shed on the
   overload, the guard over SlackThreshold through a regional blackout)
   under sync debug mode with their launches, each row's missed, shed
   and admitted counts (and the blackout rows' mean final backlog) equal
   to jax 0.9.0's and its reduction and waiting within 1e-3 points
   (DEADLINE_JAX), the bench's acceptance (the shed lane held to JAX's
   own misses), the rings re-summing to Qe and exact conservation on
   every lane; SlackThreshold on a no_deadlines fleet bitwise
   LookaheadDPP; fleet B's first two lanes card vs CPU (T=4;
   SlackThreshold on tight-uniform and shed-overload, EDD): queues,
   rings and counts bitwise, conservation exact; fleet B under
   tight-uniform deadlines (T=64), CarbonIntensity (the deadline step
   alone) and SlackThreshold, in turns against CarbonIntensity without
   deadlines, with idle shares, top kernels and the aten calls and device
   time each adds a slot;
4h. the telemetry layer: (a) bench_telemetry_overhead's fleet
   (build_fleet(["diurnal-slack"], per_kind=32), M5xN5, CarbonIntensity
   V=0.05, T=192, summary) taps off and on under sync debug mode with
   their launches (tap_probe once a slot, tap_scan once a run), every
   other field bitwise the taps-off run, the manifest held to jax 0.9.0's
   (TELEMETRY_JAX: alert records and peak exactly, totals within rtol
   1e-6), us per lane-slot off and on in turns beside the bench's 5%
   budget (printed); (b) bench_stream_overhead's instance (M2048 x N64, UK
   source, T=192) taps-only against StreamConfig(flush_every=16): every
   result and frame field bitwise, tap_scan 1 and 12 launches and
   tap_probe 192, the channel's reassembly bitwise the batch series,
   FollowedRun's JSONL and Prometheus validated, the overhead in turns
   beside the bench's 10% budget (printed), the card's manifest held to
   JAX's (STREAM_JAX: its backlog passes 2**24, where the probe's sums in
   XLA:CPU's order give JAX's bits, ROADMAP hazard 34); (c) the nine fault
   rows and W1's congested-uplink fleet with taps, manifests held to
   FAULT_MANIFEST_JAX; (d) the main path (T=64) and fleet B (F16, T=64)
   with taps: taps-off fields bitwise, launches (main: tap_probe 64,
   tap_scan 1), overhead in turns, the aten calls taps add a slot and the
   card's kernels and memsets they add a slot (profiler; no memset);
   tap_scan bitwise its plain version on the card on every run's probe
   series above (whole and in chunks from the carried state), on a
   synthetic series past 2**24 with lanes one float below, at and above
   each threshold, and past its 256-slot tiles (F1, F32 and F512 at T 64,
   192, 2000 and 4100, whole and in chunks ending mid-tile and on tile
   edges, a lane whose peak is the +0 among -0s); its time at each shape
   against its byte bound; tap_probe bitwise its plain version on inputs
   whose sums depend on their order at the main, fleet B, W2, bench fleet,
   fleet A, W1 and stream shapes and off the 32-grid, every sum at once
   (the landings by cloud, the arrivals, Qe, Qc, the WAN loop's Qt and the
   faulted loops' retry pool); at main and fleet B, two plans launched in
   turns on one stream for 64 slots each in one CUDA graph, every slot
   bitwise (the counters reset themselves); on main with taps (profiler)
   one tap_probe kernel a slot, no cooperative launch, no memset; and each
   loop's probe timed against the one torch.sum call a
   sum that it replaced, beside its byte bound and its serial floor;
4i. the scheduler's extensions: ExactDPPPolicy (grid 512) on the Fig. 2
   setup, T=2000, under sync debug mode with its launches (one
   carbon_scores and one knapsack_dp a slot, no greedy_fill), its
   reduction against QueueLength held to jax 0.9.0's (EXACT_JAX, within
   1e-3 points), card vs CPU (T=64; ThresholdPolicy too: queues and
   counts bitwise, conservation on every slot), in turns against
   CarbonIntensity (ms/slot), profiled, and with the plain DP swapped in
   on the card (ms/slot, aten calls a slot: what the kernel replaces);
   every oracle bound (`oracle_emissions_for_work`, the horizon bound at
   8 and the full trace) at most the emissions of ExactDPP, QueueLength,
   CarbonIntensity and ThresholdPolicy(200); ExactDPP on fleet A's
   shape (F512 x M5 x N5, T=192): one knapsack_dp a slot, conservation on
   every lane and slot, lanes 0 and 511 equal to each instance alone, F2
   card vs CPU; ThresholdPolicy(200) at the main width (T=64, launches,
   conservation from the backlog, T=16 card vs CPU); ExactDPP at the main
   width (M4096 x N256, grid 512, T=16: one knapsack_dp of 257 knapsacks a
   slot, conservation from the backlog, slot 0's edge and first-cloud
   counts held to the plain DP) in turns with CarbonIntensity on the same
   instance (ms/slot, idle share); the AdaptiveVController loop of
   tests/test_extensions.py (T=250, target 30000) with V and the backlog
   equal card vs CPU every slot;
5. paper headline: `paper_spec()`, T=2000, V=0.05, both policies on the
   UK-regional source; the emission reduction (the paper reports 54%);
   then Fig. 2 on JAX's streams (RandomCarbonSource, UniformArrivals,
   PRNGKey(0)): the reductions at V 0.01 and 0.05 held to JAX's
   (FIG2_JAX), and `simulate_vsweep` over six V values, card vs CPU
   bitwise and each lane equal to its single-V run;
5b. WAN headline: the first 8 lanes of W1's congested-uplink fleet,
   each run alone through `simulate(graph=)` with its lane's key, table
   and arrivals and held bitwise to its lane (queues and counts;
   emissions within rtol 1e-6); route-aware vs transfer-blind emission
   reduction over the 8 (must exceed 5%);
6. `serve_loop` at M4096xN256 for 32 slots: p50/p95/p99 decision latency
   and tasks/sec; its trajectory bitwise equal to `simulate` on the card;
   then deadline-aware (SlackThreshold, deadline 4, shedding on): missed,
   shed, queue-age percentiles, and its queues, rings and counts bitwise
   equal to `simulate(deadlines=)`;
8. LM serving, GLM-4-9B (`configs/glm4_9b.py`, 9.4 B parameters, the
   port's own seeded init), batch 8, prompts of 4096 tokens from SEED,
   64 greedy tokens, cache 4161: `greedy_generate` once under sync debug
   mode "error" (prefill, every decode step and argmax: the loop never
   syncs), launch counters checked (flash_attention 40, flash_decode
   40 x 64); then timed with CUDA events (prefill ms, decode ms/step,
   tokens/s, peak memory), the two timed runs' prefills bitwise equal
   (logits, the caches at the prompt's positions), one decode step
   profiled (device idle share, top kernels); then against the plain
   attention versions on the card
   (swapped in for this comparison only), prefill logits and 4
   teacher-forced decode steps: with float32 activations over the same
   bf16 weights, kernels vs plain within a relative L2 of 1e-4; in bf16,
   each path against the float32 plain one, the kernels' relative L2
   error at most 1.5 x the plain path's; and the greedy tokens'
   agreement with the plain path; the comparisons (not the timed runs)
   on the model's first 10 of its 40 layers (COMPARE_LAYERS: the same
   widths and kernel shapes, a quarter of the depth);
9. SSM serving, mamba2-1.3B (`configs/mamba2_1_3b.py`, 1.45 B parameters,
   the port's seeded init): as phase 8, with ssd_chunk_intra 48 launches
   (one per layer of the prefill; the decode step runs no kernel) and
   the plain SSD intra-chunk step swapped in for the comparison (its
   state cache advances in place, so no prefill repeat is compared), the
   comparisons on its first 12 of 48 layers;
10. MoE serving: first flash_attention and flash_decode at the two MoE
   configs' serving shapes (H 16 K 16: G 1; H 56 K 8: G 7; hd 128, bf16)
   held to their plain versions within phase 3c's tolerance, and the
   profiler's kernel names showing the tensor-core routes
   (`attention_tc`, `decode_tc`); then as phase 8 (the same launch
   checks, timing, profiles and logit bounds), for Qwen1.5-MoE-A2.7B
   (`configs/qwen2_moe_a2_7b.py`, 60 experts padded to 64, top 4, 4
   shared; 15.1 B parameters held; flash_attention 24, flash_decode
   24 x 64) and Arctic (`configs/arctic_480b.py` cut to one layer: 128
   experts top 2 of width 4864 at d_model 7168 and the dense residual
   FFN; flash_attention 1, flash_decode 64), each freed before the next;
   before the comparisons, for one prefill each layer's (token, slot)
   routing choices that differ between the kernel and the plain path (bf16
   and float32 activations), the pairs dropped per layer at the prefill
   (of 131,072 and 65,536) and a decode step (of 32 and 16), and the
   bounds from the shapes (prefill operations, a decode step's bytes);
11. VLM serving, PaliGemma-3B (`configs/paligemma_3b.py`, 2.51 B
   parameters, the port's seeded init; head_dim 256, MQA, GeGLU, tied
   embeddings): prompts of 256 patch embeddings from SEED (numpy's
   normal in bf16, the SigLIP frontend's stub, as JAX's dummy_batch
   draws it) and 3,840 text tokens, 4,096 positions under the prefix
   mask, through `Model.prefill` and `Model.decode_step` (the serve CLI,
   as JAX's, takes decoder-only LMs); as phase 8 (flash_attention 18,
   flash_decode 18 x 64 launches under sync debug mode "error", timing,
   the prefills of the two timed runs bitwise equal, profiles, the logit
   bounds against the plain attention versions, the greedy tokens'
   agreement; the comparisons on its first 4 of 18 layers), the GELU's
   and the tied unembedding's cost, and the bounds from the shapes;
12. enc-dec serving, SeamlessM4T-medium (`configs/seamless_m4t_medium.py`,
   877 M parameters, the port's seeded init: a 12-layer encoder and a
   12-layer decoder with cross-attention, d 1024, H 16 on K 16, hd 64,
   LayerNorm, GELU, vocab 256,206 untied): 4,096 frame embeddings a
   sequence from SEED (numpy's normal in bf16, the speech frontend's
   stub), 64 greedy tokens from the zero BOS logits, self cache 4161,
   through `Model.prefill` and `Model.decode_step`: as phase 8
   (flash_attention 12 + 12 x 64 = 780 launches, one a layer of the
   encoder and one a decoder layer a step for the one-query
   cross-attention, flash_decode 12 x 64, under sync debug mode "error";
   the BOS logits exactly 0; the two timed runs' cross caches bitwise
   equal; timing, profiles), the GELU's cost on one encoder layer, the
   bounds from the shapes, and kernels vs plain attention (float32 and
   bf16 gates as phase 8) on the encoder's output, the cross caches of
   every layer, 4 teacher-forced decode steps' logits and
   `decoder_forward_encdec`'s output over the 64 generated tokens, at
   full depth; the greedy tokens' agreement;
13. training, Qwen1.5-0.5B (`configs/qwen1_5_0_5b.py`, 463,987,712
   parameters, the port's seeded bf16 init; remat "block", logit_chunk
   2048) at batch 8 x 4096 tokens from the synthetic stream
   (`train_phase`): (a) one step's loss and every leaf's gradient through
   the kernels and with the plain attention swapped in, float32 within a
   relative L2 of 1e-4 a leaf, bf16 each leaf's error from the float32
   plain gradient at most 1.5 x the plain path's, every gradient nonzero;
   (b) 4 steps of `launch.train.train_loop` with AdamW and the cosine
   schedule after a warm step, 48 flash_attention and 24
   flash_attention_bwd launches a step, step ms (CUDA events), tokens/s,
   peak memory, MFU, one step profiled (idle share, top kernels) beside
   the step's bound (`train_bounds`); (c) two steps from one state
   bitwise equal; (d) the GreenOrchestrator on the card: the SMOKE
   restart bit-exact, then 4 slots with two full-size jobs (8 x 1024
   tokens, one step a task, one task a cloud a slot) with carbon_scores
   and greedy_fill once a slot; (e) kWh a task from the step time and
   the power limit beside `lm_task_energy_kwh`;
13s. training, mamba2-1.3B (`configs/mamba2_1_3b.py`, 1,446,205,440
   parameters, 48 layers, the port's seeded bf16 init) at the same
   batch, `train_steps` (a)-(c) as phase 13's: the kernels' gradients vs
   the plain SSD step and its plain backward swapped in
   (`ops.ssd_chunk_intra_with`) on its first 12 layers, 96 ssd_chunk_intra (48 and
   48 remat recomputes) and 48 ssd_chunk_intra_bwd launches a step, the
   step's bound with the SSD steps' float32 work;
7. each kernel's median time (CUDA events) at its main path's shapes
   beside its bound, its plain version's time and, for the attention
   kernels, `F.scaled_dot_product_attention`'s (timed here only; the port
   never calls it), the attention kernels also at PaliGemma's hd 256
   shapes (prefill B 8, H 8, K 1, S 4096, prefix 256; decode pos 4160)
   and at SeamlessM4T's (the rows' "other_shapes": the encoder, B 8 H 16
   K 16 S 4096 hd 64 full; the cross step, Sq 1 against 4,096, with
   flash_decode over the same cross cache at pos 4095 beside it, the
   same function; the decode step, pos 63 of 4161; each with SDPA eager
   and replayed)
   with the hd 256 instances' ptxas registers and spills (a spill store
   in either fails the run); flash_decode
   and SDPA also in turns (A, B, B, A),
   both from CUDA-graph replay, with the decode kernel's ptxas
   registers and spills; ssd_chunk_intra (its two launches timed
   together; phase 9's prefill profile names each) with its bound on the
   float32 CUDA cores and beside it the bytes' bound and the bound of the
   same work as 3xTF32 on the tensor cores, ptxas registers and spills,
   and the count of its SASS's FFMA
   and tf32 tensor-core (HGMMA/HMMA ...TF32) instructions (cuobjdump);
   flash_attention_bwd at the training shape from the forward's
   statistics (SDPA's backward beside it), its issued tensor-core work
   and the ptxas registers and spills of its three bf16 entries (a spill
   store fails the run); ssd_chunk_intra_bwd at phase 13s's training
   shape (its four launches timed together; no PyTorch call computes it)
   against the work it issues (its products 3xTF32 on the tensor cores,
   the rest on the CUDA cores; the row's bound, above the bytes'), with
   the float32 bound beside it (every operation on the CUDA cores) and
   the ptxas registers and spills of its four entries;
   greedy_fill with the QueueLength inputs too, its parts (every budget
   0: no walk; every score non-negative: keys only), each input's longest
   uncertified walk and its exact steps from `fill_walk_profile`, with
   that walk's chain at 4 cycles a step at clocks.max.sm, a class A
   step's measured cost (one lane walking all of its items against the
   same lane certified), and its ptxas registers and spills.

Phase 7's route_scores row also carries its times at the WAN fleets'
shapes (phase 4d: F64 x M5 x L10 and F16 x M4096 x L512) with their
byte bounds. Phase 7 also times threefry_draw's block draw of the main path's
arrivals (64 slots x 4096 randints, one launch) in turns against the 64
per-slot draws it replaces, and one slot alone (its bound: the draw's
own integer operations at a quarter of the float32 rate) and, from
phase 4c, carbon_scores, greedy_fill and the arrivals' block draw at
both fleets' shapes in turns against their per-slot draws (the rows'
"fleet" entries), the fault stream's paths draw from phase 4f in turns
against the six per-segment draws (threefry_draw's "paths" entries), the
launches of phase 4g's runs (the "deadlines" entries of carbon_scores,
greedy_fill and threefry_draw), tap_scan's row from phase 4h (its time
at bench_telemetry_overhead's fleet, the other shapes beside it, each
with its serial floor, T adds of 4 cycles at clocks.max.sm, beside the
byte bound; its launches those of the main path's run with taps on, the
phase's total and a streamed run's beside them), tap_probe's row from
phase 4h (the main path's probe, the other loops' beside it, each with
the one-torch.sum-a-sum path as the library time and the serial floor,
the plan's longest chain of dependent adds at 4 cycles, beside the byte
bound; its launches the main path's with taps on), knapsack_dp's row from phases 3f and 4i (its time
at fleet A's shape, the paper's lane and the main width's slot beside
it, each with its byte and operation bound and its serial floor, and
the one-block-a-knapsack kernel's times printed beside them
(KP_BLOCK_KERNEL); its launches those of 4i's
ExactDPP run on the Fig. 2 setup, one a slot; the slot's ms with the
kernel and with the plain DP), and a
PoissonArrivals slot at M4096 (two chain draws), beside the same slot on
the plain walk.

The last three lines are the JSON kernel table, the nvidia-smi name and
power limit, and the JSON device record. Any failure ends the run with a non-zero exit; nothing
falls back to the CPU. The main-path configuration: the spec of the
repo's M4096xN256 bench rows (`benchmarks/paper_benches.py`
`_random_instance`: pe~U(1,8), pc~U(2,100) kWh) with budgets scaled to
the paper's loads (edge 0.86, clouds 0.33 at a_m(t)~U{0..400}), starting
from that instance's backlog Qe, Qc~U{0..999}; carbon from a numpy
`diurnal_table`; arrivals U{0..400} from `UniformArrivals` (JAX's
stream, the same numbers on the CPU and the card). The WAN
configuration is the WAN subsystem's acceptance scenario, `configs/fleet_scenarios.py::congested_uplink` (Table-I spec
tiled to M x N, two routes per cloud, the clean alternates' bandwidth at
the offered load, arrivals U{0..240}) seeded as `build_network_fleet`
seeds lane 0, from a backlog Qe, Qc~U{0..999} and empty links.
The WAN fleet's and the forecasts' configurations are the JAX
benches' (`benchmarks/paper_benches.py` bench_network_routing,
bench_forecast_lookahead), uncut at M5xN5, and at the main path's width
cut to 16 lanes and T=64. Everything is made from SEED.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

T_START = time.perf_counter()

SEED = 0
M_MAIN, N_MAIN = 4096, 256
A_MAX = 400
T_MAIN, T_CPU, T_PAPER, T_SERVE = 64, 16, 2000, 32
# the fleet (phase 4c): A is the JAX bench's fleet_summary/F512 row (512
# diurnal lanes of M5xN5, T=192); B four kinds x 4 lanes at the main
# path's width; the registry fleet the bench's fleet/F96xT200 row
T_FLEET_A, FLEET_A_LANES, T_FLEET_B, FLEET_B_PER_KIND = 192, 512, 64, 4
FLEET_B_KINDS = ("diurnal", "bursty", "heterogeneous-fleet", "overload")
T_FLEET_CPU, T_REGISTRY, REGISTRY_PER_KIND = 4, 200, 16
VSWEEP = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2)
# JAX's own numbers on the paper's Fig. 2 setup (RandomCarbonSource(N=5),
# UniformArrivals(M=5), PRNGKey(0), T=2000): emission reduction of
# CarbonIntensity(V) vs QueueLength in %, from jax 0.9.0 on the CPU
# (`tests/test_torch_fleet.py::test_fig2_reductions_pinned` pins them);
# the card's run differs only by its float32 sums' order (emissions
# within rtol 1e-6), so within FIG2_TOL points
FIG2_JAX = {0.01: 38.01082353974602, 0.05: 58.72058679671891}
FIG2_TOL = 1e-3
# ExactDPPPolicy (phases 3f and 4i): its DP's grid (the JAX policy's
# default), 3f's random grids and edge cases ([scores, weights, caps,
# (budget, 0, 0)] of 3 items, the CPU tests' edges) and the crafted cases
# of the reference's rounding points with jax 0.9.0's counts (jit): the
# weight's cell count is one FMA (3 copies fit, unfused 2), the candidate
# a multiply and then an add (fused: [1, 6, 0])
KP_GRID = 512
KP_GRIDS = (16, 17, 100, 257, 512, 600, 1023, 1024)
NAN, INF = float("nan"), float("inf")
KP_EDGES = [
    [[3.0, 1.0, 0.5], [1.0, 2.0, 3.0], [5, 5, 5], [8.0, 0, 0]],
    [[-1.0, -2.0, 0.0], [0.5, 1.0, 1.0], [5000, 40, 9], [8.0, 0, 0]],
    [[-5.0, -1.0, -2.0], [20.0, 9.0, 1.0], [3, 3, 3], [8.0, 0, 0]],
    [[-1.0, -1.0, -1.0], [2.0, 2.0, 2.0], [2, 2, 2], [8.0, 0, 0]],
    [[-1.0, -2.0, -3.0], [1.0, 2.0, 3.0], [9, 9, 9], [8.0, 0, 0]],
    [[-1.0, -1.0, -2.0], [0.0, 1e-12, 1.0], [1e10, 3e9, 2.0], [8.0, 0, 0]],
    [[NAN, -1.0, -2.0], [1.0, 1.0, 1.0], [3, NAN, 2], [8.0, 0, 0]],
    [[-1.0, -2.0, -3.0], [1.0, 1.0, 1.0], [3, 3, 3], [0.0, 0, 0]],
    [[-1.0, -2.0, -3.0], [1.0, 1.0, 1.0], [3, 3, 3], [-3.0, 0, 0]],
    [[-1.0, -2.0, -3.0], [1.0, 1.0, 1.0], [3, 3, 3], [NAN, 0, 0]],
    [[-1.0, -2.0, -3.0], [1.0, 1.0, 1.0], [3, 3, 3], [INF, 0, 0]],
]
KP_CRAFTED = {
    "fma cell count": (([[-1.0]], [[61.662136]], [[10.0]], [186.91333]), 194, [[3.0]]),
    "unfused candidate": (([[-0.2, -0.7, -0.9]], [[2.0, 1.0, 3.0]], [[4.0, 6.0, 7.0]], [8.0]), 8,
                          [[0.0, 5.0, 1.0]]),
}
# jax 0.9.0's emission reduction of ExactDPPPolicy(V=0.05, grid 512) vs
# QueueLength on the Fig. 2 setup (RandomCarbonSource(N=5),
# UniformArrivals(M=5), PRNGKey(0), T=2000, jit(simulate) on the CPU;
# pinned by tests/test_torch_knapsack.py), held as FIG2_JAX is
EXACT_JAX, EXACT_TOL = 82.52899978416805, 1e-3
T_EXACT_CPU, T_EXACT_TURNS, T_EXACT_PLAIN = 64, 256, 16
T_EXACT_MAIN = 16  # ExactDPP at the main width (4i)
# 3f's launches past the staged 64 types and past grid 4096, up to the
# kernel's limit: (K, M, grids)
KP_WIDE = (3, 70, (4097, 8192, 23455))
# 3f's search for the inputs that pick each knapsack_dp instance (cells a
# thread, a warp or not): grids and K tried in this order
KP_PLAN_GRIDS = (2000, 1049, 1000, 512, 400, 200, 100, 48, 16)  # wide first: fewer steps
KP_PLAN_KS = (1, 6, 257, 500, 1000, 1500, 2000, 3072)
# the earlier knapsack_dp design (one block a knapsack) at phase 7's
# shapes, ms cold (warm), H100 80GB HBM3 at 700 W (PERF.md's kernel
# table): printed beside this run's times
KP_BLOCK_KERNEL = {"fleet A F512 x 6 x M5": (0.15995, 0.16059), "paper 6 x M5": (0.02118, 0.02362),
           "main 257 x M4096": (29.87773, 29.88221)}
T_THRESH, T_THRESH_CPU, THRESHOLD = 64, 16, 200.0
T_ADAPTIVE, ADAPTIVE_TARGET = 250, 30000.0
# the registry fleet's mean reduction in JAX (fleet/F96xT200, the fleet an
# argument of the jitted run); the port's multi-region-uk tables are
# JAX's bitwise (the twin's normal over XLA's log1p), so the card's value
# is held within 1e-3 points, as the other anchors are
REGISTRY_JAX, REGISTRY_TOL = 18.13128662109375, 1e-3
# known answers of jax 0.9.0 (jax_threefry_partitionable, x64 off), as
# printed by jax on the CPU: for (seed, t), k = fold_in(PRNGKey(seed), t):
# bits(k, (3,)), uniform(k, (3,)) as uint32, randint(k, (3,), 0, 401),
# then RandomCarbonSource(N=5)(t, PRNGKey(seed)): Ce and the 5 Cc
THREEFRY_KNOWN = {
    (0, 0): (
        3617712097, 783310428, 975722988, 1062707686, 1044038008, 1047044448, 273, 287, 41, 45,
        416, 438, 498, 324, 447),
    (0, 1): (
        31327077, 89727312, 2497208264, 1005519104, 1017848832, 1058330718, 384, 265, 57, 245,
        399, 563, 234, 231, 655),
    (0, 191): (
        543545720, 2481940912, 234799875, 1040291680, 1058271080, 1029696544, 50, 74, 11, 390,
        130, 99, 121, 216, 611),
    (0, 1999): (
        687750587, 2087171489, 1730193244, 1042544880, 1056493416, 1053704524, 351, 210, 190,
        170, 275, 46, 492, 629, 401),
    (0, 2147483647): (
        3910006613, 2989248242, 2519893887, 1063849462, 1060252750, 1058419334, 14, 347, 394,
        646, 568, 379, 148, 77, 12),
    (-1, 0): (
        3917993853, 594088678, 2364685701, 1063880662, 1041081416, 1057813052, 202, 0, 189, 164,
        308, 640, 124, 22, 684),
    (-1, 1): (
        944004320, 1565343559, 399852139, 1046548848, 1052416636, 1035905552, 110, 243, 345, 21,
        316, 556, 621, 11, 674),
    (-1, 191): (
        2541464656, 220356828, 1190150728, 1058503596, 1028793856, 1049485444, 341, 182, 154,
        617, 260, 335, 29, 115, 211),
    (-1, 1999): (
        1385597949, 1886305101, 2259345895, 1051012372, 1054924148, 1057401568, 292, 344, 141,
        513, 408, 663, 513, 36, 151),
    (-1, 2147483647): (
        3508836959, 1581205559, 3103252440, 1062282394, 1052540560, 1060698078, 56, 283, 214,
        357, 640, 449, 383, 579, 295),
    (2147483647, 0): (
        3845134602, 3672592896, 3272731171, 1063596056, 1062922066, 1061360106, 332, 301, 155,
        198, 339, 121, 487, 581, 624),
    (2147483647, 1): (
        3316644445, 3230149795, 2441697680, 1061531642, 1061193772, 1058113880, 18, 325, 71, 58,
        410, 311, 673, 63, 462),
    (2147483647, 191): (
        3812138357, 583099379, 499073091, 1063467164, 1040909704, 1039006208, 210, 163, 309,
        474, 274, 292, 666, 124, 649),
    (2147483647, 1999): (
        1776856719, 820901870, 105760095, 1054069084, 1044625368, 1019852928, 373, 285, 181, 0,
        629, 309, 586, 682, 257),
    (2147483647, 2147483647): (
        2111541414, 1345954618, 3675835155, 1056683808, 1050702660, 1062934730, 368, 391, 58,
        381, 311, 72, 131, 641, 90),
}
# known answers of jax 0.9.0 for the key walk of its samplers' loops, k =
# fold_in(PRNGKey(seed), t): three rounds of `rng, sub = split(rng)`,
# uniform(sub, (2,)), then two of `rng, a, b = split(rng, 3)`, uniform(a,
# (2,)) and uniform(b, (2,)), each float32 as uint32 (threefry_draw's chain)
CHAIN_KNOWN = {
    (0, 0): (1037407792, 1051729700, 1034497072, 1061675434, 1009690496, 1057317694,
             1037407792, 1051729700, 1047132152, 1060959150, 1034497072, 1061675434,
             1037557648, 1050940200),
    (0, 1999): (1014840832, 1048662988, 1063447974, 1048756640, 1056493952, 1061388498,
                1014840832, 1048662988, 1057074894, 1049115160, 1063447974, 1048756640,
                1060306694, 1051888020),
    (-1, 0): (1060731916, 1061075730, 1055573404, 1059494742, 1064461466, 1060296742,
              1060731916, 1061075730, 1063188844, 1053281672, 1055573404, 1059494742,
              1063761466, 1063820022),
    (2147483647, 1999): (1056634264, 1032084000, 1065221360, 1056633116, 1047776536,
                         1063174034, 1056634264, 1032084000, 1058299756, 1058355086,
                         1065221360, 1056633116, 1063210856, 1051125312),
}
# known answers of jax 0.9.0 for the draw's normal finish: normal(k, (4,))
# as uint32, k = fold_in(PRNGKey(seed), t)
NORMAL_KNOWN = {
    (0, 0): (1065386890, 3211265463, 3208611895, 3214274394),
    (0, 1999): (3212734967, 3171955973, 3195791067, 1044741942),
    (-1, 191): (1047368018, 3218141168, 3205982829, 1051005619),
    (2147483647, 2**32 - 1): (3199031301, 1016559813, 3215777685, 3223082057),
}
# PoissonArrivals at the main path's width (phase 7): rates across both of
# poisson's samplers (Knuth below 10, rejection from 10 up)
POISSON_RATE_LO, POISSON_RATE_HI, POISSON_SLOTS = 0.5, 400.0, 16
T_WAN_CPU, T_WAN_HEADLINE, WAN_INSTANCES, V_WAN = 8, 192, 8, 0.1
# the WAN fleet (phase 4d). W1 is the JAX bench's bench_network_routing
# rows: build_network_fleet([kind], per_kind=64, Tc=96, seed=0), M5xN5
# (L 10), V=0.1, T=192, record=T//8, PRNGKey(0); phase 5b's instances
# are its first WAN_INSTANCES congested-uplink lanes. W2: 16 lanes of
# congested-uplink at the main path's width (L 512), T=64
T_W1, W1_PER_KIND, W1_KINDS = T_WAN_HEADLINE, 64, ("congested-uplink", "multi-region-uk-wan")
W2_PER_KIND, T_W2, T_W2_CPU = 16, 64, 4
# jax 0.9.0's mean reduction NetworkAwareDPP vs StaticRoute(CarbonIntensity)
# on W1, on the CPU, with the fleet an argument of the jitted run, as the
# simulator carries it (pinned by tests/test_torch_wan_fleet.py); the
# bench's own jit closes over the fleet, where XLA folds the graph's
# constants (ROADMAP hazard 20) and gets 28.133020% on congested-uplink.
# multi-region-uk-wan's tables are JAX's bitwise (XLA's log1p under the
# twin's normal), so both are held within 1e-3 points
WAN_JAX = {"congested-uplink": 28.23200798034668, "multi-region-uk-wan": 2.1636054515838623}
WAN_TOL = {"congested-uplink": 1e-3, "multi-region-uk-wan": 1e-3}
# the forecasts (phase 4e): the rows of bench_forecast_lookahead,
# build_fleet([kind], per_kind=16, Tc=96, seed=0), V=0.2, T=192,
# PRNGKey(0); jax 0.9.0's mean reduction of each row against
# CarbonIntensity(V=0.2), the fleet an argument of the jitted run (pinned
# by tests/test_torch_forecast.py; closed over, XLA folds the tables and
# six rows move by 0.02-0.12 points). Every row, the noisy ones (the
# twin's normal, JAX's bitwise) too, is held within 1e-3 points
T_FC_ANCHOR, V_FC, FC_PER_KIND, FC_KINDS = 192, 0.2, 16, ("diurnal", "diurnal-slack")
FORECAST_JAX = {
    "diurnal": {"la_H1_perfect": 0.0, "la_H4_perfect": 16.87108612060547,
                "la_H8_perfect": 24.25740623474121, "la_H16_perfect": 30.99785804748535,
                "la_H8_noisy20": 40.113067626953125, "la_H8_persistence": 0.0,
                "la_H8_seasonal": 14.198285102844238},
    "diurnal-slack": {"la_H1_perfect": 0.0, "la_H4_perfect": 16.840587615966797,
                      "la_H8_perfect": 21.818805694580078, "la_H16_perfect": 25.784387588500977,
                      "la_H8_noisy20": 35.63770294189453, "la_H8_persistence": 0.0,
                      "la_H8_seasonal": 15.90768051147461},
}
FC_TOL = 1e-3
T_FC_WIDTH, FC_H = 64, 8  # LookaheadDPP(H=8) on fleet B
# the fault layer (phase 4f): the rows of bench_fault_robustness,
# build_fleet(["diurnal-slack"]) and build_network_fleet(["congested-uplink"]),
# per_kind=16, Tc=96, seed=0, with_faults(..., seed=0), V=0.05, T=192,
# record="summary", PRNGKey(0); jax 0.9.0's (recovery slots, emission
# reduction vs qlen %, completed %) of each row, the fleet an argument of
# the jitted run (pinned by tests/test_torch_fault_fleet.py). Recovery and
# completed are held exactly, the reductions within FAULT_TOL points
T_FAULT, V_FAULT, FAULT_PER_KIND, FAULT_TOL = 192, 0.05, 16, 1e-3
FAULT_JAX = {
    "regional-blackout": {"qlen": (143.375, 0.0, 91.64795684814453),
                          "carbon": (104.0625, 33.454568943621474, 76.99911499023438),
                          "guard": (92.125, 33.94740367384068, 76.8633804321289)},
    "telemetry-brownout": {"qlen": (155.6875, 0.0, 91.63323211669922),
                           "carbon": (87.625, 32.670801765359236, 75.8416748046875),
                           "guard": (0.0, 22.371901129831485, 82.11490631103516)},
    "flappy-uplink": {"qlen": (94.75, 0.0, 95.37596893310547),
                      "carbon": (54.4375, 46.814294237866086, 76.64797973632812),
                      "guard": (29.125, 45.677208726292584, 77.12126159667969)},
}
T_FAULT_WIDTH, T_FAULT_CPU = 64, 4  # fleet B's and W2's shapes under faults
# the deadline layer (phase 4g): the rows of bench_deadline_pareto,
# build_fleet(["diurnal-slack"]) and build_fleet(["overload"]), per_kind=16,
# Tc=96, seed=0, with_deadlines / with_faults(..., seed=0), V=0.2, H=16
# (ClairvoyantTableForecaster), T=192, record="summary", PRNGKey(0); jax
# 0.9.0's numbers of each row, the fleet an argument of the jitted run
# (pinned by tests/test_torch_deadline_fleet.py): the missed, shed and
# admitted counts (and the blackout rows' mean final backlog) are held
# exactly, the reductions and waiting within DL_TOL points. On jax 0.9.0
# the shed lane misses 488 tasks (the bench's own `miss_s == 0` fails in
# JAX itself, closed over or not; jax 0.4.37's streams gave 0), so the
# phase holds the shed lane to JAX's count and to far fewer misses than
# the unshedded lane's
T_DL, V_DL, DL_PER_KIND, DL_H, DL_TOL = 192, 0.2, 16, 16, 1e-3
DEADLINE_JAX = {
    "lookahead_H16": {"reduction": 17.691747665405273},
    "slack_thresh": {"reduction": 17.691747665405273, "waiting": 107.88565826416016,
                     "missed": 0.0, "shed": 0.0, "admitted": 1841142.0},
    "waitawhile": {"reduction": 49.834007263183594, "waiting": 136.53237915039062,
                   "missed": 275.0, "shed": 0.0, "admitted": 1841142.0},
    "edd": {"reduction": -381.8828125, "waiting": 5.115818023681641, "missed": 0.0, "shed": 0.0,
            "admitted": 1841142.0},
    "overload/unshedded": {"missed": 1861052.0, "shed": 0.0, "admitted": 5517671.0},
    "overload/shed": {"missed": 488.0, "shed": 3295943.0, "admitted": 2221728.0},
    "overload+blackout/unshedded": {"missed": 1861711.0, "shed": 0.0, "admitted": 5517671.0,
                                    "backlog": 54882.9375},
    "overload+blackout/shed": {"missed": 488.0, "shed": 3325701.0, "admitted": 2191970.0,
                               "backlog": 4025.6875},
}
T_DL_WIDTH, T_DL_CPU = 64, 4  # fleet B's shape under tight-uniform deadlines
# the telemetry layer (phase 4h): manifest(frame) as the JAX benches stamp
# it, (peak backlog, total emissions, total wasted, total failed, (tripped
# lanes, firing slots, first firing slot) a monitor in MONITORS' order),
# from jax 0.9.0 on the CPU with the fleet an argument of the jitted run
# (pinned by tests/test_torch_telemetry.py). TELEMETRY_JAX is
# bench_telemetry_overhead's taps-on run: build_fleet(["diurnal-slack"],
# per_kind=32, Tc=96, seed=0), CarbonIntensity(V=0.05), T=192, summary,
# PRNGKey(0); FAULT_MANIFEST_JAX the taps-on reruns of the nine
# bench_fault_robustness rows (phase 4f's fleets) and W1's congested-uplink
# fleet under NetworkAwareDPP (record=T//8); the alert records and the peak
# are held exactly, the totals within TEL_RTOL (the card's float32 sums
# of emissions and waste run in its own order). STREAM_JAX is
# bench_stream_overhead's instance (M2048 x N64, pe~U(1,8), pc~U(2,100),
# Pe 1e4, Pc~U(1e3,1e5) from default_rng(0), UK-regional source,
# UniformArrivals(amax=300), T=192, summary): its backlog passes 2**24
# near slot 56, where the float32 sums' order decides the residual and
# JAX's own conservation_drift fires; the probe sums in XLA:CPU's order
# (ROADMAP hazard 34), so the card's manifest is held to it as the others
TEL_PER_KIND, T_TEL, TEL_RTOL = 32, 192, 1e-6
M_STREAM, N_STREAM, T_STREAM, A_STREAM, STREAM_FLUSH = 2048, 64, 192, 300, 16
TEL_BUDGET_PCT, STREAM_BUDGET_PCT = 5.0, 10.0  # the JAX benches' overhead budgets
TELEMETRY_JAX = (27459.0, 27085393920.0, 0.0, 0.0,
                 ((32, 614, 7), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1)))
FAULT_MANIFEST_JAX = {
    "regional-blackout/qlen": (16803.0, 21464461312.0, 599003328.0, 52145.0,
        ((11, 26, 7), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1))),
    "regional-blackout/carbon": (29814.0, 14283618304.0, 385509888.0, 43845.0,
        ((16, 350, 7), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1))),
    "regional-blackout/guard": (29587.0, 14177833984.0, 381357888.0, 43722.0,
        ((16, 339, 7), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1))),
    "telemetry-brownout/qlen": (16517.0, 20865163264.0, 0.0, 0.0,
        ((8, 30, 7), (16, 1551, 5), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1))),
    "telemetry-brownout/carbon": (32176.0, 14048347136.0, 0.0, 0.0,
        ((16, 387, 7), (16, 1551, 5), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1))),
    "telemetry-brownout/guard": (25896.0, 16197228544.0, 0.0, 0.0,
        ((16, 192, 7), (16, 1551, 5), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1))),
    "flappy-uplink/qlen": (10059.0, 19949658112.0, 164096032.0, 17721.0,
        ((8, 18, 7), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1))),
    "flappy-uplink/carbon": (31002.0, 10610366464.0, 88322176.0, 14228.0,
        ((16, 343, 7), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1))),
    "flappy-uplink/guard": (29845.0, 10837211136.0, 91296488.0, 14355.0,
        ((16, 289, 7), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1))),
    "W1 congested-uplink aware": (46117.0, 26463662080.0, 0.0, 0.0,
        ((64, 2112, 7), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1), (0, 0, -1))),
}
STREAM_JAX = (57652656.0, 8460317184.0, 0.0, 0.0,
              ((1, 185, 7), (0, 0, -1), (0, 0, -1), (1, 98, 56), (0, 0, -1), (0, 0, -1)))


def manifest_row(m) -> tuple:
    """A `telemetry.manifest` dict as the anchors above hold it."""
    return (m["peak_backlog"], m["total_emissions"], m["total_wasted"], m["total_failed"],
            tuple(tuple(a.values()) for a in m["alerts"].values()))


def stream_instance_arrays():
    """bench_stream_overhead's spec (pe, pc, Pe, Pc), float32 numpy."""
    rng = np.random.default_rng(SEED)
    M, N = M_STREAM, N_STREAM
    return (rng.uniform(1, 8, M).astype(np.float32), rng.uniform(2, 100, (M, N)).astype(np.float32),
            np.float32(1e4), rng.uniform(1e3, 1e5, N).astype(np.float32))


LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "glm4_9b", 8, 4096, 64
SSM_ARCH = "mamba2_1_3b"  # phase 9 serves it at phase 8's batch, prompt and length
# phase 10 serves Qwen1.5-MoE-A2.7B at full size and Arctic at full width,
# one layer deep (its 35 layers hold 477 B parameters), at phase 8's
# batch, prompt and length
MOE_ARCH, MOE_WIDE_ARCH = "qwen2_moe_a2_7b", "arctic_480b"
# phase 11 serves PaliGemma-3B at full size at phase 8's batch, length
# and generated tokens: 256 patch embeddings (the SigLIP frontend's stub)
# and 3,840 text tokens make the same 4,096 positions
VLM_ARCH = "paligemma_3b"
# phase 12 serves SeamlessM4T-medium at full size at phase 8's batch,
# generated tokens and self cache: source_len 4,096 frame embeddings (the
# speech frontend's stub) in
ENCDEC_ARCH = "seamless_m4t_medium"
LM_CACHE = LM_PROMPT + LM_GEN + 1
# phase 13 trains Qwen1.5-0.5B at full size on the train_4k micro-bundle
# `paper_workloads.lm_workloads` costs a task by (8 x 4096 tokens a step),
# and runs the GreenOrchestrator with two such jobs at 8 x 1024
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen1_5_0_5b", 8, 4096, 4
# phase 13s trains mamba2-1.3B (SSM_ARCH) at full size on the same bundle,
# its kernels-vs-plain gradients (a) on the first COMPARE_LAYERS layers:
# at full depth too every float32 leaf held a third of the gate (PERF.md),
# but those four passes cost 28 s more of a run near its 1,200 s limit
ORCH_SEQ, ORCH_SLOTS = 1024, 4
# teacher-forced logits, kernels vs plain attention: with float32
# activations (the same bf16 weights) both kernels agree with their plain
# versions to float32 summation order, so the relative L2 gap stays far
# below LOGIT_F32_TOL, which a wrong kernel exceeds; in bf16, where 40
# random layers amplify one bf16 rounding step to about 2%, each path is
# held against the float32 plain path and the kernels' relative L2 error
# may be at most LOGIT_ERR_RATIO times the plain path's
LM_TEACHER_STEPS, LOGIT_F32_TOL, LOGIT_ERR_RATIO = 4, 1e-4, 1.5
# the depth of the kernels-vs-plain comparisons of the phases that cost
# the most (`serve_lm`'s compare_layers; the timed greedy runs stay at
# full depth, the comparisons keep the full widths and kernel shapes):
# GLM-4-9B 10 of 40 layers, mamba2-1.3B 12 of 48, PaliGemma 4 of 18. Not
# Qwen1.5-MoE: at 6 of its 24 layers the bf16 routing flips between the
# two paths dominate a decode step's error (ratio 1.86 in one run), so its
# comparisons stay at full depth, where both paths' errors saturate alike
COMPARE_LAYERS = {"glm4-9b": 10, "mamba2-1.3b": 12, "paligemma-3b": 4}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# the data sheet gives no int32 rate: Hopper's SM issues 64 int32
# operations a clock against 128 float32 FMAs (2 operations each), so a
# quarter of the float32 rate
INT32_OPS_PER_S = 67e12 / 4
# integer operations of one threefry2x32 hash as csrc/threefry.cu issues
# it: 20 rounds of add, funnel-shift rotate and xor, 5 key injections of
# three adds, the key schedule's two xors and the first two adds, and the
# xor of its two words into 32 bits
THREEFRY_OPS = 20 * 3 + 5 * 3 + 4 + 1
FP32_OPS_PER_S = 67e12     # H100 SXM data sheet, non-tensor float32
BF16_OPS_PER_S = 989e12    # H100 SXM data sheet, dense bf16 tensor cores
TF32_OPS_PER_S = 495e12    # H100 SXM data sheet, dense tf32 tensor cores
# kernels vs plain attention, |err| <= abs + rel * |plain|: both sides
# compute in float32 and round once to the output type. In float32 they
# differ by summation order (tests/test_kernels.py's 2e-5); in bf16 that
# rounding can fall either side, one bf16 step, at most 2**-7 * |plain|,
# plus an absolute floor for outputs near 0
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0**-7)}
# the attention backward vs its plain version. float32: |err| <= ATTN_BWD_F32
# x (sum|terms| + |plain|), sum|terms| each gradient's last sum taken over
# absolute values (`bwd_term_sums`: dq and dk over P (|dP| + |D|), where
# dS = P (dP - D) cancels), 2e-5 = 336 x 2**-24: the summation orders
# differ over sums of up to 16 x 4096 terms. bf16: each gradient's max abs
# error from the float32 plain gradient at most ATTN_BWD_RATIO x the plain
# bf16 path's (both round once at the end; the kernel takes D as the plain
# path does, tests/test_torch_attention_grad.py)
ATTN_BWD_F32, ATTN_BWD_RATIO = 2e-5, 1.5
# ssd_chunk_intra vs its plain version, |err| <= SSD_TOL * max(1, sum|terms|)
# + SSD_TOL * |plain| (tests/test_kernels.py's f32, with the absolute part
# scaled by the plain version's sum of |terms|): y sums up to 256 terms
# of mixed sign, each a sum of N = 128 products, and two summation orders
# of a float32 sum differ by up to about (terms) x 2**-24 x sum|terms|, far
# more than 2e-5 where y is near 0
SSD_TOL = 2e-5


def forecast_rows(mods, V):
    """The rows of the JAX bench's bench_forecast_lookahead, {row:
    (policy, forecaster)}, from either package's modules ({"core": ...,
    "forecast": ...}; the tests build JAX's with it)."""
    core, fc = mods["core"], mods["forecast"]
    rows = {f"la_H{H}_perfect": (core.LookaheadDPPPolicy(V=V, H=H, discount=1.0, defer_weight=3.0),
                                 fc.ClairvoyantTableForecaster(H=H)) for H in (1, 4, 8, 16)}
    la8 = core.LookaheadDPPPolicy(V=V, H=8, discount=0.98, defer_weight=2.0)
    rows["la_H8_noisy20"] = (la8, fc.ClairvoyantTableForecaster(
        H=8, error=fc.ForecastErrorModel(noise=0.2, seed=7)))
    rows["la_H8_persistence"] = (la8, fc.PersistenceForecaster(H=8))
    rows["la_H8_seasonal"] = (la8, fc.SeasonalNaiveForecaster(H=8, period=48))
    return rows


def fault_row_stats(r, r0):
    """bench_fault_robustness's numbers of one faulted fleet run `r`
    against the same policy's zero-fault run `r0` (numpy, as the bench
    computes them): recovery (slots a lane's excess backlog exceeds two
    mean slots of arrivals, mean over lanes), the mean final cumulative
    emissions, and the % of arrived tasks completed (processed - failed).
    Either package's results."""
    def host(x):
        return np.asarray(x.cpu()) if hasattr(x, "cpu") else np.asarray(x)

    excess = host(r.backlog) - host(r0.backlog)
    theta = 2.0 * host(r.arrived).mean()
    recovery = float((excess > theta).sum(axis=-1).mean())
    em = float(host(r.cum_emissions)[:, -1].mean())
    done = host(r.processed).sum() - host(r.failed).sum()
    completed = float(100.0 * done / max(host(r.arrived).sum(), 1.0))
    return recovery, em, completed


def deadline_rows(m, base, over, run, V=V_DL, H=DL_H, seed=SEED):
    """The numbers of the JAX bench's bench_deadline_pareto rows from
    either package: `m` its modules ({"core", "deadlines", "faults",
    "forecast", "fleet_scenarios"}), `base` and `over` the diurnal-slack
    and overload fleets, `run(policy, fleet, forecaster)` one fleet run
    (record="summary"). Returns ({row: {name: value}}, {row: result}):
    the reduction against CarbonIntensity(V) and the waiting (final
    backlog against CarbonIntensity's, %) of the generous-slack rows, and
    every deadline row's missed, shed and admitted totals; the blackout
    rows add their mean final backlog (the post-step Qe + Qc + retry)."""
    core, dl, flt, fcs, fs = (m[k] for k in ("core", "deadlines", "faults", "forecast",
                                             "fleet_scenarios"))

    def host(x):
        return np.asarray(x.cpu()) if hasattr(x, "cpu") else np.asarray(x)

    def backlog(r):
        return host(r.Qe)[:, -1].sum(-1) + host(r.Qc)[:, -1].sum((-2, -1))

    def counts(r):
        return {k: float(host(getattr(r.deadlines, k)).sum()) for k in ("missed", "shed",
                                                                           "admitted")}
    clair = fcs.ClairvoyantTableForecaster(H=H)
    r_base = run(core.CarbonIntensityPolicy(V=V), base, None)
    em_base = host(r_base.cum_emissions)[:, -1]
    bl_base = backlog(r_base).mean()

    def red(r):
        return float(100.0 * (1.0 - host(r.cum_emissions)[:, -1] / em_base).mean())
    results = {f"lookahead_H{H}": run(core.LookaheadDPPPolicy(V=V, H=H), base, clair)}
    rows = {f"lookahead_H{H}": {"reduction": red(results[f"lookahead_H{H}"])}}
    slack = fs.with_deadlines(base, "generous-slack", seed=seed)
    for name, pol, fc in (("slack_thresh", dl.SlackThresholdPolicy(V=V, H=H), clair),
                          ("waitawhile", dl.WaitAwhilePolicy(V=V, H=H, J=2), clair),
                          ("edd", dl.EDDPolicy(), None)):
        r = results[name] = run(pol, slack, fc)
        rows[name] = dict(reduction=red(r),
                          waiting=float(100.0 * backlog(r).mean() / max(bl_base, 1.0)), **counts(r))
    pol = dl.SlackThresholdPolicy(V=V)
    guard = flt.StalenessGuardPolicy(inner=dl.SlackThresholdPolicy(V=V))
    blk = fs.with_faults(over, "regional-blackout", seed=seed)
    for name, p, fleet, kind in (
            ("overload/unshedded", pol, over, "tight-uniform"),
            ("overload/shed", pol, over, "shed-overload"),
            ("overload+blackout/unshedded", guard, blk, "tight-uniform"),
            ("overload+blackout/shed", guard, blk, "shed-overload")):
        r = results[name] = run(p, fs.with_deadlines(fleet, kind, seed=seed), None)
        rows[name] = counts(r)
        if "blackout" in name:
            rows[name]["backlog"] = float(host(r.backlog)[:, -1].mean())
    return rows, results


def draw_ops(lanes, n, lane_hashes, value_hashes, value_ops):
    """Integer operations of a draw of n values a lane, as the function
    needs them: `lane_hashes` hashes a lane (its fold_in and splits),
    `value_hashes` hashes and `value_ops` more operations a value."""
    return lanes * (lane_hashes * THREEFRY_OPS + n * (value_hashes * THREEFRY_OPS + value_ops))


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


class PhaseClock:
    """Each phase's wall seconds, printed on a line of its own when the
    next phase starts (`start`) or the run ends (`stop`), with the memory
    still allocated on the card then (what a phase did not free)."""

    def __init__(self):
        self.tag, self.t0, self.secs = None, None, {}

    def start(self, tag) -> None:
        now = time.perf_counter()
        if self.tag is not None:
            self.secs[self.tag] = now - self.t0
            say(f"[{self.tag} wall] phase {self.tag}: {self.secs[self.tag]:.1f} s; "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
        self.tag, self.t0 = tag, now

    def stop(self) -> None:
        self.start(None)
        say("[wall] phases in run order, s: " + ", ".join(
            f"{k} {v:.1f}" for k, v in self.secs.items())
            + f"; total {time.perf_counter() - T_START:.1f} s since the script started")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, inner: int) -> float:
    """Median over `reps` of the mean time of `inner` back-to-back eager
    calls, from CUDA events (warm caches). Includes the host's launch
    cost wherever that is longer than the device work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _replay_ms(body, reps: int, inner: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            body()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, reps: int, inner: int) -> tuple:
    """Device time of one call, (warm, cold): `inner` calls captured into
    one CUDA graph and replayed `reps` times between CUDA events, the
    median per call; the replay launches from the device, so no host
    launch cost is timed. Warm: back to back, inputs left in the 50 MB L2
    by the call before. Cold: each call after a 128 MB read that evicts
    L2, minus the time of that read alone."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    sink = torch.empty((), dtype=torch.float32, device="cuda")

    def evict():
        torch.sum(flush, dim=0, out=sink)

    def cold():
        evict()
        fn()

    warm_ms = _replay_ms(fn, reps, inner)
    cold_ms = _replay_ms(cold, reps, inner) - _replay_ms(evict, reps, inner)
    return warm_ms, cold_ms


def draw_turns(block, per_slot, reps: int = 10, inner: int = 20, inner_slots: int = 2) -> dict:
    """A block draw against the per-slot draws it replaces, in turns
    (block, slots, slots, block), each from CUDA-graph replay (`graph_ms`:
    warm, cold; `inner` block draws, or `inner_slots` rounds of the
    per-slot draws, a graph, so that the replay's own cost does not
    count): {"block": [turn 1, turn 4], "slots": [turn 2, turn 3]}."""
    out = {"block": [], "slots": []}
    for name in ("block", "slots", "slots", "block"):
        fn, k = (block, inner) if name == "block" else (per_slot, inner_slots)
        out[name].append(graph_ms(fn, reps=reps, inner=k))
    return out


def turns_text(turns) -> str:
    """`draw_turns`' times as 'cold (warm)' in turn order."""
    return "; ".join(f"{name} " + " / ".join(f"{c:.5f} ({w:.5f})" for w, c in turns[name])
                     for name in ("block", "slots"))


def profile_slots(run, slots: int):
    """Time per slot from torch.profiler over `run()` (covering `slots`
    slots): ({'total': ms, kernel name: ms} on the device, or None when
    the profiler recorded no device time; {op name: (self host ms, calls)}
    on the host, profiler overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    per, host = {}, {}
    total = 0.0
    for evt in prof.key_averages():
        # kernels, memsets and copies; the `repro.<phase>` labels also show
        # on the device timeline, as spans over the kernels inside them
        if evt.key.startswith("repro."):
            continue
        if evt.device_type == DeviceType.CUDA:
            per[evt.key] = evt.self_device_time_total / 1e3 / slots
            total += per[evt.key]
        elif evt.device_type == DeviceType.CPU:
            host[evt.key] = (evt.self_cpu_time_total / 1e3 / slots, evt.count / slots)
    if total <= 0.0:
        return None, host
    per["total"] = total
    return per, host


def ptxas_lines(log: str, entry: str) -> list:
    """The register and spill lines of ptxas's -v report for the entry
    functions whose names contain `entry`, each tagged with the entry's
    integer template arguments (`<128>`)."""
    out, keep, tag = [], False, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            keep = entry in ln
            tag = "<" + ",".join(re.findall(r"ILi(\d+)E", ln)) + ">"
        elif keep and ("registers" in ln or "spill" in ln):
            out.append(f"{entry}{tag} " + ln.split(":", 1)[-1].strip())
    return out


def bwd_term_sums(q, k, v, g, mode, prefix_len):
    """Per element of (dq, dk, dv), the sum of the absolute values of the
    terms of its last sum, float32: dq_i: scale sum_j P_ij (|dP_ij| + |D_i|)
    |k_j|; dk_j: sum_i P_ij (|dP_ij| + |D_i|) |qs_i|; dv_j: sum_i P_ij
    |dO_i| (over the G query heads of a kv head), in query chunks as the
    plain version runs."""
    from repro_torch.kernels.flash_attention import NEG_INF, QUERY_CHUNK

    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G, scale = H // K, 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(Skv, device=q.device)
    tq = torch.empty((B, H, Sq, hd), device=q.device)
    tk, tv = torch.zeros((B, K, Skv, hd), device=q.device), torch.zeros((B, K, Skv, hd), device=q.device)
    for s0 in range(0, Sq, QUERY_CHUNK):
        c = min(QUERY_CHUNK, Sq - s0)
        qg = (q[:, :, s0:s0 + c].float() * scale).reshape(B, K, G, c, hd)
        gg = g[:, :, s0:s0 + c].float().reshape(B, K, G, c, hd)
        s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf)
        if mode != "full":
            q_pos = torch.arange(s0, s0 + c, device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            if mode == "prefix":
                mask = mask | (k_pos[None, :] < prefix_len)
            s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        dp = torch.einsum("bkgqd,bksd->bkgqs", gg, vf)
        w = p * (dp.abs() + (p * dp).sum(-1, keepdim=True).abs())
        tq[:, :, s0:s0 + c] = (torch.einsum("bkgqs,bksd->bkgqd", w, kf.abs()) * scale).reshape(
            B, H, c, hd)
        tk += torch.einsum("bkgqs,bkgqd->bksd", w, qg.abs())
        tv += torch.einsum("bkgqs,bkgqd->bksd", p, gg.abs())
    return tq, tk, tv


def same_bits(a, b) -> bool:
    """Bitwise equal float32 tensors, any NaN equal to any NaN (the card's
    arithmetic returns its own NaN)."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32), torch.where(nan, 0.0, b).view(torch.int32))


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


class TableArrivals:
    """Plays back a numpy [T, M] arrival table on any device (staged
    once by `to`), so the card and the CPU see the same arrivals."""

    def __init__(self, table: np.ndarray):
        self.table = table
        self._on = {}

    def to(self, device):
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = torch.as_tensor(self.table, device=device)
        return self

    def __call__(self, t, seed, device):
        return self.to(device)._on[torch.device(device)][t % self.table.shape[0]]


def main_instance(convert, carbon, UniformArrivals, dev):
    """The M4096xN256 main-path configuration (see the module docstring)."""
    rng = np.random.default_rng(SEED)
    M, N = M_MAIN, N_MAIN
    pe = rng.uniform(1, 8, M).astype(np.float32)
    pc = rng.uniform(2, 100, (M, N)).astype(np.float32)
    mean_arrivals = M * A_MAX / 2
    Pe = np.float32(pe.mean() * mean_arrivals / 0.86)
    Pc = np.full(N, pc.mean() * mean_arrivals / N / 0.33, np.float32)
    Qe0 = rng.integers(0, 1000, M).astype(np.float32)
    Qc0 = rng.integers(0, 1000, (M, N)).astype(np.float32)
    T_tab = max(T_MAIN, T_SERVE)
    table = carbon.diurnal_table(T_tab, N, rng)
    return dict(
        spec=lambda d: convert.spec_from_numpy(pe, pc, Pe, Pc, d),
        state0=lambda d: convert.state_from_numpy(Qe0, Qc0, d),
        carbon=carbon.TableCarbonSource(table=table).to(dev).to("cpu"),
        arrivals=UniformArrivals(M=M, amax=A_MAX),
    )


def drive_path(tag, size, policies, sim, expected, ops, dev):
    """Runs `sim(pol, T_MAIN, "summary", dev)` for each policy under sync
    debug mode "error", with the launch counters set to 0 just before
    and read just after each run. Returns ({policy: ms/slot from CUDA
    events}, {policy: result}, the counters summed over the path)."""
    ms, results, total = {}, {}, {}
    for pname, pol in policies.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        host0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            res = sim(pol, T_MAIN, "summary", dev)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - host0
        launches = ops.launch_counts()
        want = dict.fromkeys(launches, 0)  # kernels the path does not name: none
        want.update(expected[pname])
        if launches != want:
            fail(f"{pname}: kernel launches {launches}, expected {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if not (torch.isfinite(res.emissions).all() and torch.isfinite(res.Qc).all()):
            fail(f"{pname}: non-finite emissions or queues")
        if res.Qc.shape != (1, M_MAIN, N_MAIN) or res.emissions.shape != (T_MAIN,):
            fail(f"{pname}: unexpected result shapes {tuple(res.Qc.shape)}")
        ms[pname] = start.elapsed_time(end) / T_MAIN
        results[pname] = res
        say(f"[{tag}] {pname} {size} T={T_MAIN} record=summary under sync debug mode 'error': "
            f"launches {launches}; {ms[pname]:.4f} ms/slot (CUDA events), host "
            f"{1e3 * host_s / T_MAIN:.4f} ms/slot; cum emissions "
            f"{float(res.cum_emissions[-1]):.6e}, final backlog {float(res.final_backlog):.6e}, "
            f"processed {float(res.processed.sum()):.6e}")
    return ms, results, total


def profile_path(tag, policies, sim, ms, dev):
    """Where a slot's time goes: device time per slot (torch.profiler
    over 8 slots) against the unprofiled ms/slot; the rest is the device
    idle, waiting for the host to launch."""
    for pname, pol in policies.items():
        prof, host = profile_slots(lambda pol=pol: sim(pol, 8, "summary", dev), slots=8)
        top_host = sorted(((v[0], v[1], k) for k, v in host.items()), reverse=True)
        ops_per_slot = sum(v[1] for k, v in host.items() if k.startswith("aten::"))
        say(f"[{tag}] {pname}: host under the profiler {sum(v[0] for v in host.values()):.4f} "
            f"ms/slot of self time, {ops_per_slot:.1f} aten op calls/slot (nested calls "
            "counted); top host ops per slot "
            + ", ".join(f"{k[:40]} {v:.4f} ms ({c:.1f} calls)" for v, c, k in top_host[:6]))
        if prof is None:
            say(f"[{tag}] {pname}: device time per slot not measured (the profiler recorded "
                "no device time)")
            continue
        busy = prof.pop("total")
        top = sorted(((v, k) for k, v in prof.items()), reverse=True)
        say(f"[{tag}] {pname}: device busy {busy:.4f} ms/slot of {ms[pname]:.4f} ms/slot "
            f"(idle share {1.0 - busy / ms[pname]:.3f}); top kernels per slot "
            + ", ".join(f"{k[:48]} {v:.4f} ms" for v, k in top[:5]))


def in_turns(tag, policies, sim, dev):
    """ms/slot of each policy over T_MAIN slots, run in turns A, B, B, A
    (CUDA events, no sync debug mode), so that a cost of running first
    shows apart from a cost of the policy."""
    names = list(policies)
    runs = {p: [] for p in names}
    for pname in names + names[::-1]:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sim(policies[pname], T_MAIN, "summary", dev)
        end.record()
        end.synchronize()
        runs[pname].append(start.elapsed_time(end) / T_MAIN)
    say(f"[{tag}] in turns {' '.join(names + names[::-1])}: "
        + "; ".join(f"{p} " + " / ".join(f"{x:.4f}" for x in v) + " ms/slot"
                    for p, v in runs.items()))


def card_vs_cpu(tag, policies, sim, T, queues, dev):
    """T slots on the card and through the CPU plain versions: the
    recorded `queues` bitwise, emissions within rtol 1e-6."""
    for pname, pol in policies.items():
        t0 = time.perf_counter()
        gpu = sim(pol, T, "full", dev)
        cpu = sim(pol, T, "full", "cpu")
        for q in queues:
            if not torch.equal(getattr(gpu, q).cpu(), getattr(cpu, q)):
                fail(f"{pname}: card and CPU {q} differ over T={T}")
        em_g, em_c = gpu.emissions.cpu().double(), cpu.emissions.double()
        rel = float(((em_g - em_c).abs() / em_c.abs().clamp_min(1e-30)).max())
        if rel > 1e-6:
            fail(f"{pname}: emissions differ by rtol {rel:.3e} > 1e-6")
        say(f"[{tag}] {pname} T={T} card vs CPU plain path: {', '.join(queues)} bitwise equal "
            f"over {T} slots, emissions max rel diff {rel:.3e} (limit 1e-6); "
            f"{time.perf_counter() - t0:.1f} s")


def same_result(a, b, names=("Qe", "Qc", "emissions", "cum_emissions", "dispatched",
                                 "processed", "energy_edge", "energy_cloud")) -> list:
    """The fields of two SimResults whose bits differ."""
    return [n for n in names if not same_bits(getattr(a, n).cpu(), getattr(b, n).cpu())]


def emission_rtol(a, b) -> float:
    """The largest relative difference of two emission series."""
    ea, eb = a.emissions.cpu().double(), b.emissions.cpu().double()
    return float(((ea - eb).abs() / eb.abs().clamp_min(1e-30)).max())


COUNTED = ("Qe", "Qc", "dispatched", "processed")


class Each(NamedTuple):
    """A kernel's expected launches in a run of T slots: `slot` a slot
    and `run` a run (the sources' block draws: one a run while a run's
    slots fit in one block)."""

    slot: int = 0
    run: int = 0


# the sources' block draw; a faulted run's fault stream (one paths draw a
# slot) and its backlog series (one tap_probe a slot, taps on or off)
BLOCK_DRAW = Each(run=1)
FAULT_RUN = {"threefry_draw": Each(slot=1, run=1), "threefry_draw paths": 1, "tap_probe": 1}


def drive_fleets(tag, runs, ops, dev):
    """Each fleet run once under sync debug mode "error", the launch
    counters set to 0 just before and read just after it, the draw's
    `paths=` launches under their own key, "threefry_draw paths" (each
    also one of threefry_draw's). `runs`: {name: (fn(T, record), T, F,
    expected launches per slot, an int or an `Each`)}. Returns ({name:
    ms/slot from CUDA events}, {name: result}, {name: launches})."""
    ms, results, counts = {}, {}, {}
    for name, (fn, T, nl, per_slot) in runs.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            res = fn(T, "summary")
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        launches = dict(ops.launch_counts(), **{"threefry_draw paths": ops.path_launches()})
        want = dict.fromkeys(launches, 0)
        want.update({k: v.slot * T + v.run if isinstance(v, Each) else v * T
                     for k, v in per_slot.items()})
        if launches != want:
            fail(f"{tag} {name}: kernel launches {launches}, expected {want}")
        if not (torch.isfinite(res.emissions).all() and torch.isfinite(res.Qc).all()):
            fail(f"{tag} {name}: non-finite emissions or queues")
        if res.Qc.shape[:2] != (nl, 1) or res.emissions.shape != (nl, T):
            fail(f"{tag} {name}: unexpected result shapes {tuple(res.Qc.shape)}")
        ms[name], results[name], counts[name] = start.elapsed_time(end) / T, res, launches
        say(f"[{tag}] {name} F={nl} T={T} record=summary under sync debug mode 'error': "
            f"launches per slot " + ", ".join(f"{k} {v / T:g}" for k, v in launches.items() if v)
            + f"; {ms[name]:.4f} ms/slot, {1e3 * ms[name] / nl:.4f} us per lane-slot (CUDA "
            f"events); cum emissions summed over lanes {float(res.cum_emissions[:, -1].sum()):.6e}")
    return ms, results, counts


def fleet_turns(tag, runs):
    """ms/slot of each run in turns (A, B, ..., ..., B, A; CUDA events, no
    sync debug mode), with us per lane-slot."""
    names = list(runs)
    times = {n: [] for n in names}
    for name in names + names[::-1]:
        fn, T, _, _ = runs[name]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(T, "summary")
        end.record()
        end.synchronize()
        times[name].append(start.elapsed_time(end) / T)
    say(f"[{tag}] in turns {' / '.join(names + names[::-1])}: " + "; ".join(
        f"{n} " + " / ".join(f"{x:.4f}" for x in v) + " ms/slot ("
        + " / ".join(f"{1e3 * x / runs[n][2]:.4f}" for x in v) + " us per lane-slot)"
        for n, v in times.items()))
    return times


def profile_fleets(tag, runs, ms):
    """Device busy and idle share per slot of each fleet run
    (torch.profiler over 8 slots) against its unprofiled ms/slot, with
    the aten calls a slot and the top kernels. Returns ({run: aten calls
    a slot}, {run: device busy ms a slot or None})."""
    calls, busy_ms = {}, {}
    for run, (fn, _, _, _) in runs.items():
        prof, host = profile_slots(lambda fn=fn: fn(8, "summary"), slots=8)
        n_aten = sum(v[1] for k, v in host.items() if k.startswith("aten::"))
        calls[run], busy_ms[run] = n_aten, None if prof is None else prof["total"]
        if prof is None:
            say(f"[{tag}] {run}: device time per slot not measured (the profiler "
                f"recorded no device time); {n_aten:.1f} aten op calls/slot")
            continue
        busy = prof.pop("total")
        top = sorted(((v, k) for k, v in prof.items()), reverse=True)
        say(f"[{tag}] {run}: device busy {busy:.4f} ms/slot of {ms[run]:.4f} "
            f"(idle share {1.0 - busy / ms[run]:.3f}), {n_aten:.1f} aten op calls/slot; "
            "top kernels per slot " + ", ".join(f"{k[:48]} {v:.4f} ms" for v, k in top[:5]))
    return calls, busy_ms


def lane_of(res, f):
    """Lane f of a fleet result (its layers that are off stay None)."""
    return res._replace(**{n: getattr(res, n)[f] for n in res._fields
                           if getattr(res, n) is not None})


WAN_COUNTED = ("Qe", "Qc", "Qt", "dispatched", "delivered", "processed")


def wan_instance(convert, fleet_scenarios, M, N, T_tab, dev, j=0):
    """The congested-uplink instance of lane j (see the module
    docstring), with its arrival table and a starting backlog."""
    spec, table, amax, graph = fleet_scenarios.congested_uplink(
        M, N, 96, np.random.default_rng((SEED, 1, j)))
    rng = np.random.default_rng((SEED, 2, j))
    Qe0 = rng.integers(0, 1000, M).astype(np.float32)
    Qc0 = rng.integers(0, 1000, (M, N)).astype(np.float32)
    arrivals = rng.integers(0, amax.astype(np.int64) + 1, (T_tab, M)).astype(np.float32)
    return dict(
        spec=lambda d: convert.spec_from_numpy(spec.pe, spec.pc, spec.Pe, spec.Pc, d),
        state0=lambda d: convert.state_from_numpy(Qe0, Qc0, d),
        graph=graph,
        table=table,
        arrivals=TableArrivals(arrivals).to(dev).to("cpu"),
    )


def rel_l2(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@contextlib.contextmanager
def swapped(ops, plain):
    """The `ops` dispatchers named in `plain` replaced by the given plain
    versions, on the card, for a comparison only."""
    saved = {name: getattr(ops, name) for name in plain}
    for name, fn in plain.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def batch_generate(model, params, batch, gen_len: int, cache_len: int) -> torch.Tensor:
    """Greedy decoding of a prefill batch (a vlm's patches and tokens, an
    enc-dec model's frames) through the Model API, `Model.prefill` then
    `Model.decode_step` and argmax on the device, as the port's
    `greedy_generate` does for token prompts (the serve CLI takes
    decoder-only LMs, as JAX's does) -> [B, gen_len] int32 tokens on the
    device."""
    logits, cache = model.prefill(params, batch, cache_len=cache_len)
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    out = []
    for _ in range(gen_len):
        out.append(tok)
        logits, cache = model.decode_step(params, tok, cache)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    return torch.cat(out, dim=1)


def cut_depth(cfg, params, n: int):
    """(cfg, params) of the first n decoder layers: the config with
    n_layers = n, the stacked "layers" leaves (and an enc-dec model's
    "cross" leaves) as views of their first n rows."""
    def first(tree):
        return {k: first(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[:n]

    cut = dict(params, **{k: first(params[k]) for k in ("layers", "cross") if k in params})
    return dataclasses.replace(cfg, n_layers=n), cut


def lm_outputs(m, params, batch, toks):
    """The outputs held kernels vs plain in a serving phase, [(label,
    tensor)]: the prefill's logits and LM_TEACHER_STEPS decode steps'
    logits, each step fed the kernel run's greedy tokens `toks`."""
    logits, cache = m.prefill(params, batch, cache_len=LM_CACHE)
    out = [("prefill logits", logits)]
    for t in range(LM_TEACHER_STEPS):
        logits, cache = m.decode_step(params, toks[:, t:t + 1], cache)
        out.append((f"decode step {t + 1} logits", logits))
    return out


def serve_lm(tag, cfg, expected, plain, what, dev, ops, build_model, greedy_generate,
             before_checks=None, outputs=lm_outputs, compare_layers=None):
    """One LM serving phase (8 dense, 9 ssm, 10 moe, 11 vlm, 12 enc-dec)
    at `cfg`'s full size with the port's seeded init: batch LM_BATCH,
    prompts of LM_PROMPT positions from SEED (for a vlm, prefix_len patch
    embeddings drawn with numpy's normal in the compute dtype, the
    frontend stub's output, then LM_PROMPT - prefix_len tokens; for an
    enc-dec model, source_len frame embeddings drawn so and no tokens;
    both generated by `batch_generate`), LM_GEN greedy tokens.
    `greedy_generate` once under sync debug mode "error" with the launch
    counters set to 0 just before and checked against `expected` just
    after (every other kernel 0); timed with CUDA events (prefill ms,
    decode ms/step, tokens/s, peak memory); one prefill and one decode
    step profiled; then against the plain versions `plain` ({ops name:
    function}, swapped in for this comparison only), `outputs(model,
    params, batch, toks)` (default: prefill logits and
    LM_TEACHER_STEPS teacher-forced decode steps' logits): with float32
    activations over the same bf16 weights, kernels vs plain within a
    relative L2 of LOGIT_F32_TOL; in bf16, each path against the float32
    plain one, the kernels' relative L2 error at most LOGIT_ERR_RATIO x
    the plain path's; and the greedy tokens' agreement. With
    `compare_layers`, those comparisons run on the model cut to its first
    compare_layers decoder layers (`cut_depth`: the same widths, weights
    and kernel shapes), its greedy tokens generated through the kernels
    too. With a KV cache, the two timed runs' prefills must give bitwise
    equal logits and caches at the prompt's positions (which no decode
    step writes; an enc-dec model's cross caches whole, its BOS logits
    exactly 0; an SSM's states advance in place). `before_checks`, if
    given, is called as before_checks(model, params, batch) after the
    profiles and before the comparisons. Returns (the launch counts of
    the greedy run, model, params, prompts)."""
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    P = cfg.prefix_len  # image patches before the text (vlm), else 0
    encdec = cfg.is_encoder_decoder
    say(f"[{tag}] {cfg.name}: {n_params:,} parameters ({cfg.param_dtype}) made on the card in "
        f"{time.perf_counter() - t0:.1f} s; batch {LM_BATCH}, "
        + (f"sources of {cfg.source_len} frame embeddings" if encdec else
           f"prompts of {LM_PROMPT} " + (f"positions ({P} patches, {LM_PROMPT - P} tokens)"
                                        if P else "tokens"))
        + f", {LM_GEN} generated, cache {LM_CACHE}")
    rng = np.random.default_rng(SEED)
    cd = getattr(torch, cfg.compute_dtype)
    if encdec:
        prompts = None
        batch = {"frames": torch.as_tensor(rng.standard_normal(
            (LM_BATCH, cfg.source_len, cfg.d_model), dtype=np.float32), device=dev).to(cd)}
    else:
        prompts = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (LM_BATCH, LM_PROMPT - P)).astype(np.int32), device=dev)
        batch = {"tokens": prompts}
    if cfg.family == "vlm":
        batch["patches"] = torch.as_tensor(rng.standard_normal(
            (LM_BATCH, P, cfg.d_model), dtype=np.float32), device=dev).to(cd)

    def generate(m=model, p=params):
        if cfg.family == "vlm" or encdec:
            return batch_generate(m, p, batch, LM_GEN, LM_CACHE)
        return greedy_generate(m, p, prompts, LM_GEN, LM_CACHE)

    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2**30  # weights and what earlier phases hold
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = generate()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = ops.launch_counts()
    toks_h = toks.cpu()
    host_s = time.perf_counter() - t0
    want = {k: 0 for k in launches}
    want.update(expected)
    if launches != want:
        fail(f"{tag}: kernel launches {launches}, expected {want}")
    if (toks_h.shape != (LM_BATCH, LM_GEN) or toks_h.dtype != torch.int32
            or int(toks_h.min()) < 0 or int(toks_h.max()) >= cfg.vocab_size):
        fail(f"{tag}: tokens {tuple(toks_h.shape)} {toks_h.dtype} out of shape or range")
    say(f"[{tag}] greedy_generate under sync debug mode 'error': launches {launches}; "
        f"{host_s:.2f} s host; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"first tokens {toks_h[0, :8].tolist()}")

    def timed_generate():
        """(prefill ms, decode ms per step incl. argmax, cache, last
        token, the prefill's logits) from CUDA events, greedy_generate's
        own steps without the debug mode."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        logits, cache = model.prefill(params, batch, cache_len=LM_CACHE)
        ev[1].record()
        first = logits
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        for _ in range(LM_GEN):
            logits, cache = model.decode_step(params, tok, cache)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        ev[2].record()
        ev[2].synchronize()
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]) / LM_GEN, cache, tok, first

    torch.cuda.reset_peak_memory_stats()
    runs = [timed_generate() for _ in range(2)]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    prefill_ms, decode_ms, cache, tok, _ = runs[-1]
    if encdec:
        (_, _, c1, _, l1), (_, _, c2, _, l2) = runs
        if bool(l1.any()) or bool(l2.any()):
            fail(f"{tag}: the prefill's BOS logits are not all 0")
        if not all(torch.equal(c1[n].view(torch.int16), c2[n].view(torch.int16))
                   for n in ("ck", "cv")):
            fail(f"{tag}: the two timed runs' cross caches differ")
        say(f"[{tag}] the two timed runs' prefills: BOS logits exactly 0 (a zero hidden state); "
            f"the cross caches ck, cv {tuple(c1['ck'].shape)} bitwise equal")
        del c1, c2, l1, l2
    elif "k" in cache:
        (_, _, c1, _, l1), (_, _, c2, _, l2) = runs
        if not (same_bits(l1, l2) and all(
                torch.equal(c1[n][:, :, :LM_PROMPT].view(torch.int16),
                            c2[n][:, :, :LM_PROMPT].view(torch.int16)) for n in ("k", "v"))):
            fail(f"{tag}: the two timed runs' prefills differ (logits or caches)")
        say(f"[{tag}] the two timed runs' prefills: logits and the KV caches' {LM_PROMPT} prompt "
            "positions bitwise equal")
        del c1, c2, l1, l2
    n_in = cfg.source_len if encdec else LM_PROMPT
    say(f"[{tag}] timed (CUDA events, 2 runs): prefill "
        + " / ".join(f"{r[0]:.1f}" for r in runs) + " ms for "
        f"{LM_BATCH}x{n_in} {'frames' if encdec else 'tokens'}; decode "
        + " / ".join(f"{r[1]:.3f}" for r in runs)
        + f" ms/step ({LM_BATCH * 1e3 / decode_ms:,.1f} tokens/s at batch {LM_BATCH}); "
        f"whole request {prefill_ms + LM_GEN * decode_ms:.1f} ms "
        f"({LM_BATCH * LM_GEN * 1e3 / (prefill_ms + LM_GEN * decode_ms):,.1f} generated tokens/s); "
        f"peak memory {peak_gib:.2f} GiB ({held_gib:.2f} GiB allocated before the phase's "
        "first run, weights included)")
    prof, _ = profile_slots(lambda: model.prefill(params, batch, cache_len=LM_CACHE), slots=1)
    if prof is not None:
        busy = prof.pop("total")
        top = sorted(((v, k) for k, v in prof.items()), reverse=True)
        say(f"[{tag}] one prefill under the profiler: device busy {busy:.1f} ms of {prefill_ms:.1f} "
            "ms; top kernels " + ", ".join(f"{k[:56]} {v:.1f} ms" for v, k in top[:8]))
        # ssd_chunk_intra launches two kernels; name both
        ssd = [f"{re.search(r'ssd_[a-z]+_kernel', k).group()} {v:.1f} ms" for v, k in top
               if re.search(r"ssd_[a-z]+_kernel", k)]
        if ssd:
            say(f"[{tag}] ssd_chunk_intra's two kernels in that prefill: " + ", ".join(ssd))
    # one more step (for a KV cache, at its last slot), under the profiler
    prof, host = profile_slots(lambda: model.decode_step(params, tok, cache), slots=1)
    if prof is None:
        say(f"[{tag}] decode step device time not measured (the profiler recorded no device time)")
    else:
        busy = prof.pop("total")
        top = sorted(((v, k) for k, v in prof.items()), reverse=True)
        say(f"[{tag}] one decode step under the profiler: device busy {busy:.3f} ms of "
            f"{decode_ms:.3f} ms/step (idle share {1.0 - busy / decode_ms:.3f}); "
            f"{sum(v[1] for k, v in host.items() if k.startswith('aten::')):.0f} aten op calls; "
            "top kernels " + ", ".join(f"{k[:56]} {v:.3f} ms" for v, k in top[:8]))
    del cache, runs
    if before_checks is not None:
        before_checks(model, params, batch)

    ccfg, cparams, depth = cfg, params, ""
    if compare_layers is not None:
        ccfg, cparams = cut_depth(cfg, params, compare_layers)
        depth = f" (the first {compare_layers} of {cfg.n_layers} layers)"

    def plain_ctx():
        return swapped(ops, plain)

    def teacher_forced(m, ctx):
        """`outputs` of model m under ctx; through the plain versions,
        none of the swapped kernels may launch."""
        ops.reset_launch_counts()
        with ctx():
            out = outputs(m, cparams, batch, toks)
        counts = ops.launch_counts()
        if ctx is plain_ctx and any(counts[name] for name in plain):
            fail(f"{tag}: the plain path launched kernels {counts}")
        return out

    cmodel = build_model(ccfg, dev)
    steps = {"kernels": teacher_forced(cmodel, contextlib.nullcontext),
             "plain": teacher_forced(cmodel, plain_ctx)}
    # float32 activations over the same bf16 weights (cast per use)
    ref_model = build_model(dataclasses.replace(ccfg, compute_dtype="float32"), dev)
    t0 = time.perf_counter()
    steps["f32"] = teacher_forced(ref_model, plain_ctx)
    steps["f32 kernels"] = teacher_forced(ref_model, contextlib.nullcontext)
    say(f"[{tag}] float32 activations (bf16 weights cast per use), {what} and kernels{depth}: "
        f"{time.perf_counter() - t0:.1f} s")
    def agree(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    for (step, a), (_, r) in zip(steps["f32 kernels"], steps["f32"]):
        gap = rel_l2(a, r)
        say(f"[{tag}] {step} in float32{depth}: kernels vs {what} relative L2 {gap:.3e} "
            f"(limit {LOGIT_F32_TOL:g}), max abs {float((a - r).abs().max()):.3e} (max |value| "
            f"{float(r.abs().max()):.3f})"
            + (f"; argmax agreement {agree(a, r):.3f}" if "logits" in step else ""))
        if not (torch.isfinite(a).all() and gap <= LOGIT_F32_TOL):
            fail(f"{tag} {step}: float32 values through the kernels are {gap:.3e} from the "
                 f"{what} path's, beyond {LOGIT_F32_TOL:g}")
    for (step, a), (_, b), (_, r) in zip(steps["kernels"], steps["plain"], steps["f32"]):
        err_k, err_p = rel_l2(a, r), rel_l2(b, r)
        say(f"[{tag}] {step}{depth}: relative L2 error vs the float32 reference, kernels "
            f"{err_k:.3e}, {what} {err_p:.3e} (ratio {err_k / err_p:.3f}, limit "
            f"{LOGIT_ERR_RATIO:g}); kernels vs plain {rel_l2(a, b):.3e}, max abs "
            f"{float((a.float() - b.float()).abs().max()):.3e} (max |value| "
            f"{float(b.abs().max()):.3f})"
            + (f"; argmax agreement kernels/plain {agree(a, b):.3f}, kernels/f32 {agree(a, r):.3f}"
               if "logits" in step else ""))
        if not (torch.isfinite(a).all() and err_k <= LOGIT_ERR_RATIO * err_p):
            fail(f"{tag} {step}: the kernels' values are {err_k:.3e} from the float32 reference, "
                 f"beyond {LOGIT_ERR_RATIO:g} x the {what} path's {err_p:.3e}")
    del steps, ref_model
    toks_k = toks_h if compare_layers is None else generate(cmodel, cparams).cpu()
    with plain_ctx():
        toks_plain = generate(cmodel, cparams).cpu()
    same = toks_plain == toks_k
    first = [int(row.logical_not().nonzero()[0]) if not bool(row.all()) else LM_GEN for row in same]
    say(f"[{tag}] greedy tokens{depth}, kernels vs {what}: {float(same.float().mean()):.4f} equal; "
        f"first divergence per sequence {first} (of {LM_GEN})")
    del cmodel, cparams
    return launches, model, params, prompts

@contextlib.contextmanager
def recording_plans(moe):
    """Every MoE layer's routing while the block runs: `moe.dispatch_plan`
    wrapped to keep (idx [T, k], keep [T*k]) of each call, in layer
    order."""
    plans, inner = [], moe.dispatch_plan

    def record(*args, **kwargs):
        plan = inner(*args, **kwargs)
        plans.append((plan.idx, plan.keep))
        return plan

    moe.dispatch_plan = record
    try:
        yield plans
    finally:
        moe.dispatch_plan = inner


def moe_bounds(cfg, E: int, C: int) -> tuple:
    """(prefill operations, decode-step bytes) of a MoE config at phase
    10's shape, from the shapes: the prefill's products (attention
    projections, the causal q.k and p.v pairs, the router, every expert's
    C-row buffer, the shared and dense residual MLPs; the logits of the
    last position), 2 operations a multiply-add; a decode step's bytes
    (every weight once but the embedding, of which one row a token; every
    expert runs on its buffer, so every expert's weights are read; the
    valid KV cache once)."""
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    T, ff, Lr = LM_BATCH * LM_PROMPT, cfg.moe_d_ff or cfg.d_ff, cfg.n_layers
    shared = (cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts
    dense_ff = cfg.d_ff if cfg.moe_dense_residual else 0
    proj = 2 * T * D * (H + 2 * K) * hd + 2 * T * H * hd * D
    attn = 4 * LM_BATCH * H * hd * LM_PROMPT * (LM_PROMPT + 1) // 2
    ffn = 6 * E * C * D * ff + 6 * T * D * (shared + dense_ff) + 2 * T * D * E
    nops = Lr * (proj + attn + ffn) + 2 * LM_BATCH * D * cfg.vocab_size
    layer_w = D * (H + 2 * K) * hd + H * hd * D + 3 * D * (E * ff + shared + dense_ff) + 2 * D
    cache = 2 * Lr * LM_BATCH * LM_CACHE * K * hd * 2
    nbytes = 2 * Lr * layer_w + 4 * Lr * D * E + cache + 2 * D * cfg.vocab_size + 2 * LM_BATCH * D
    return nops, nbytes


def prefix_pairs(S: int, P: int) -> int:
    """(query, key) pairs of one head that the prefix mask admits over S
    positions: key j <= query i, or j < P."""
    return P * P + S * (S + 1) // 2 - P * (P + 1) // 2


def vlm_bounds(cfg) -> dict:
    """Phase 11's bounds from the shapes of a vlm config (a dense stack
    with a gated MLP and tied embeddings): the prefill's operations (the
    attention projections, q.k and p.v over the pairs the prefix mask
    admits, the MLP's three products; the logits of the last position),
    2 a multiply-add; a decode step's bytes (every layer weight once, the
    tied embedding once as the unembedding, the valid KV cache once; one
    embedding row a token); the weights' and the cache's bytes."""
    D, H, K, hd, ff, Lr = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                           cfg.d_ff, cfg.n_layers)
    T = LM_BATCH * LM_PROMPT
    layers_ops = Lr * (2 * T * D * (H + 2 * K) * hd + 2 * T * H * hd * D + 6 * T * D * ff)
    attn_ops = Lr * 4 * LM_BATCH * H * hd * prefix_pairs(LM_PROMPT, cfg.prefix_len)
    logits_ops = 2 * LM_BATCH * D * cfg.vocab_size
    layer_w = 2 * Lr * (D * (H + 2 * K) * hd + H * hd * D + 3 * D * ff + 2 * D)
    unembed = 2 * D * cfg.vocab_size
    cache = 2 * Lr * LM_BATCH * LM_CACHE * K * hd * 2
    return dict(prefill_ops=layers_ops + attn_ops + logits_ops, layers_ops=layers_ops,
                attn_ops=attn_ops, logits_ops=logits_ops,
                step_bytes=layer_w + unembed + cache + 2 * LM_BATCH * D, layer_bytes=layer_w,
                unembed_bytes=unembed, cache_bytes=cache, weight_bytes=layer_w + unembed + 2 * D)


def encdec_outputs(m, params, batch, toks):
    """Phase 12's outputs held kernels vs plain, [(label, tensor)]: the
    encoder's output, the prefill's cross caches ck and cv of every layer,
    LM_TEACHER_STEPS teacher-forced decode steps' logits (fed the kernel
    run's greedy tokens `toks`), and `decoder_forward_encdec`'s
    final-normed hidden state over all LM_GEN of them (the prefill's BOS
    logits are 0 by construction and say nothing)."""
    from repro_torch.models import transformer

    enc = transformer.encoder_forward(params, batch["frames"], m.cfg)
    logits, cache = m.prefill(params, batch, cache_len=LM_CACHE)
    out = [("encoder output", enc), ("cross keys ck", cache["ck"]),
           ("cross values cv", cache["cv"])]
    for t in range(LM_TEACHER_STEPS):
        logits, cache = m.decode_step(params, toks[:, t:t + 1], cache)
        out.append((f"decode step {t + 1} logits", logits))
    del cache
    out.append((f"decoder_forward_encdec output over {toks.shape[1]} tokens",
                transformer.decoder_forward_encdec(params, toks, enc, m.cfg)))
    return out


def encdec_bounds(cfg) -> dict:
    """Phase 12's bounds from the shapes of an enc-dec config (MHA, an
    ungated MLP, untied embeddings): the prefill's operations (the
    encoder's projections and MLP, q.k and p.v over every (query, key)
    pair of the full mask, every decoder layer's cross wk and wv over
    the encoder's output, the zero BOS state's logits), 2 a multiply-add;
    a decode step's bytes at its last step (every decoder layer's weights
    but the cross wk and wv, the unembedding, the cross caches, the self
    caches' LM_GEN valid positions, one embedding row a token)."""
    D, H, K, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff
    Le, Ld, S = cfg.n_encoder_layers, cfg.n_layers, cfg.source_len
    T = LM_BATCH * S
    enc_ops = Le * (2 * T * D * (H + 2 * K) * hd + 2 * T * H * hd * D + 4 * T * D * ff)
    attn_ops = Le * 4 * LM_BATCH * H * hd * S * S
    cross_ops = Ld * 4 * T * D * K * hd
    logits_ops = 2 * LM_BATCH * D * cfg.vocab_size
    layer_w = 2 * Ld * (D * (H + 2 * K) * hd + H * hd * D  # self-attention
                        + 2 * D * H * hd                     # cross wq, wo
                        + 2 * D * ff + 6 * D)                # MLP, three norms
    unembed = 2 * D * cfg.vocab_size
    cross = 2 * Ld * LM_BATCH * S * K * hd * 2
    self_kv = 2 * Ld * LM_BATCH * LM_GEN * K * hd * 2
    return dict(prefill_ops=enc_ops + attn_ops + cross_ops + logits_ops, enc_ops=enc_ops,
                attn_ops=attn_ops, cross_ops=cross_ops, logits_ops=logits_ops,
                step_bytes=layer_w + unembed + cross + self_kv + 2 * LM_BATCH * D,
                layer_bytes=layer_w, unembed_bytes=unembed, cross_bytes=cross,
                self_bytes=self_kv)


def encdec_serve(tag, cfg, dev, ops, build_model, greedy_generate, plain, randn, gelu_tanh):
    """Phase 12: `serve_lm` for an enc-dec config at full size (frame
    embeddings in, LM_GEN greedy tokens out through Model.prefill and
    Model.decode_step; flash_attention once a layer of the encoder and
    once a decoder layer a step for the one-query cross-attention,
    flash_decode once a decoder layer a step), its outputs those of
    `encdec_outputs`, with the GELU's cost on one encoder layer and the
    bounds of `encdec_bounds` printed before the comparisons. Returns the
    greedy run's launch counts."""
    eb = encdec_bounds(cfg)
    bf16 = torch.bfloat16

    def checks(model, params, batch):
        h = randn((LM_BATCH, cfg.source_len, cfg.d_ff), bf16)
        gelu_ms = cuda_ms(lambda: gelu_tanh(h), reps=2, inner=1)
        del h
        say(f"[{tag}] gelu_tanh on one encoder layer's hidden [{LM_BATCH}, {cfg.source_len}, "
            f"{cfg.d_ff}] bf16 (tanh_xla's nine FMAs, each emulated in float64): {gelu_ms:.1f} ms "
            f"(CUDA events, eager), x {cfg.n_encoder_layers} layers = "
            f"{gelu_ms * cfg.n_encoder_layers:.0f} ms of the prefill")
        say(f"[{tag}] bounds from the shapes: prefill {eb['prefill_ops'] / 1e12:.2f} TFLOP "
            f"({eb['enc_ops'] / 1e12:.2f} in the encoder's products, "
            f"{eb['attn_ops'] / 1e12:.2f} in its attention over {cfg.source_len ** 2:,} pairs a "
            f"head, {eb['cross_ops'] / 1e12:.2f} in the cross K/V projections, "
            f"{eb['logits_ops'] / 1e9:.2f} G in the BOS logits), "
            f"{eb['prefill_ops'] / BF16_OPS_PER_S * 1e3:.1f} ms at {BF16_OPS_PER_S / 1e12:.0f} "
            f"TFLOP/s bf16; a decode step {eb['step_bytes'] / 1e9:.2f} GB "
            f"({eb['layer_bytes'] / 1e9:.2f} of decoder weights, {eb['unembed_bytes'] / 1e9:.2f} "
            f"of unembedding, {eb['cross_bytes'] / 1e9:.2f} of cross caches, "
            f"{eb['self_bytes'] / 1e9:.3f} of self caches), "
            f"{eb['step_bytes'] / HBM_BYTES_PER_S * 1e3:.2f} ms at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    launches, *_ = serve_lm(
        tag, cfg, dict(flash_attention=cfg.n_encoder_layers + cfg.n_layers * LM_GEN,
                       flash_decode=cfg.n_layers * LM_GEN),
        plain, "plain attention", dev, ops, build_model, greedy_generate, before_checks=checks,
        outputs=encdec_outputs)
    torch.cuda.empty_cache()  # the model's weights go before the next phase's
    return launches


def attn_shape_entry(kname, shape, launches, phase, run, plain, lib, nbytes, nops, reps, inner,
                     smi):
    """An entry of an attention row at a serving phase's shape (phase 7):
    the kernel's ms from CUDA-graph replay (cold and warm) and per eager
    call, its plain version's and the library call's (per eager call, and
    replayed as the kernel is), its bound (bf16 tensor cores), and its
    `launches` on that phase's path."""
    times, call_ms = graph_ms(run, reps=reps, inner=inner), cuda_ms(run, reps=reps, inner=inner)
    plain_ms = cuda_ms(plain, reps=2, inner=1)
    lib_ms, lib_times = cuda_ms(lib, reps=reps, inner=inner), graph_ms(lib, reps=reps, inner=inner)
    bound_b, bound_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / BF16_OPS_PER_S * 1e3
    out = {"shape": shape, "launches": launches, "ms": times[1], "warm_ms": times[0],
           "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": max(bound_b, bound_o),
           "bound_by": "bytes" if bound_b >= bound_o else "operations",
           "library_ms": lib_ms, "library_replay_ms": lib_times[1],
           "library_replay_warm_ms": lib_times[0]}
    say(f"[7 time] {kname} at {shape}: {times[1]:.5f} ms from a cold L2, {times[0]:.5f} ms "
        f"warm (CUDA graph replay) vs bound {out['bound_ms']:.5f} ms ({nbytes / 1e6:.2f} MB, "
        f"{nops / 1e9:.3f} G ops, {out['bound_by']}); {call_ms:.5f} ms per eager call; plain "
        f"version {plain_ms:.3f} ms; SDPA {lib_ms:.5f} ms per eager call, "
        f"{lib_times[1]:.5f} ms cold, {lib_times[0]:.5f} ms warm (CUDA graph replay); "
        f"{launches} launches on phase {phase}'s path ({smi})")
    return out


def encdec_attention_times(cfg, launches, dev, fa, fd, held, randn, smi):
    """Phase 7's entries at an enc-dec config's shapes (bf16, MHA):
    flash_attention at the encoder's (S source_len, full mask) and at the
    decode step's cross-attention (one query row a (sequence, head)
    against the source positions), beside the cross step flash_decode
    over the same cross cache at pos Ssrc - 1 (the same function, held to
    the plain attention by `held`); flash_decode at the decode step's
    self-attention (LM_CACHE positions, the last step's pos LM_GEN - 1);
    SDPA at each shape (timed only). `launches` are phase 12's. Returns
    (flash_attention's entries, flash_decode's)."""
    bf16 = torch.bfloat16
    H, K, hd, S = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.source_len
    q = randn((LM_BATCH, S, H, hd), bf16).transpose(1, 2)
    k, v = (randn((LM_BATCH, S, K, hd), bf16).transpose(1, 2) for _ in range(2))
    enc = attn_shape_entry(
        "flash_attention", f"{cfg.name} encoder B{LM_BATCH} H{H} K{K} S{S} hd{hd} full",
        cfg.n_encoder_layers, "12", lambda: fa.flash_attention_cuda(q, k, v, mask_mode="full"),
        lambda: fa.flash_attention_plain(q, k, v, mask_mode="full"),
        lambda: F.scaled_dot_product_attention(q, k, v), reps=3, inner=2, smi=smi,
        nbytes=2 * (2 * LM_BATCH * H * S * hd + 2 * LM_BATCH * K * S * hd),
        nops=4 * LM_BATCH * H * hd * S * S)
    issued = 4 * LM_BATCH * H * hd * S * S * 3 // 2  # q.k, p_hi.v, p_lo.v: the split of P
    enc.update(issued_ops=issued, issued_bound_ms=issued / BF16_OPS_PER_S * 1e3)
    say(f"[7 time] flash_attention at {cfg.name}'s encoder: the bf16 kernel issues "
        f"{issued / 1e12:.3f} TFLOP (the split of P), {enc['issued_bound_ms']:.3f} ms at the peak; "
        f"x {cfg.n_encoder_layers} layers = {enc['ms'] * cfg.n_encoder_layers:.1f} ms of the "
        "prefill")
    del q, k, v
    ck, cv = (randn((LM_BATCH, S, K, hd), bf16) for _ in range(2))
    qx = randn((LM_BATCH, 1, H, hd), bf16)
    qt, kt, vt = qx.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2)
    cross = attn_shape_entry(
        "flash_attention", f"{cfg.name} cross-attention step B{LM_BATCH} H{H} K{K} Sq1 Skv{S} "
        f"hd{hd} full", launches["flash_attention"] - cfg.n_encoder_layers, "12",
        lambda: fa.flash_attention_cuda(qt, kt, vt, mask_mode="full"),
        lambda: fa.flash_attention_plain(qt, kt, vt, mask_mode="full"),
        lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=20, inner=50, smi=smi,
        nbytes=2 * (2 * LM_BATCH * H * hd + 2 * LM_BATCH * K * S * hd),
        nops=4 * LM_BATCH * H * hd * S)
    qd = qx[:, 0]
    pos_src = torch.full((1,), S - 1, dtype=torch.int32, device=dev)
    held("flash_decode", fd.flash_decode_cuda(qd, ck, cv, pos_src),
         fa.flash_attention_plain(qt, kt, vt, mask_mode="full")[:, :, 0],
         f"over {cfg.name}'s cross cache at pos {S - 1}: the cross step's function")
    dwarm, dcold = graph_ms(lambda: fd.flash_decode_cuda(qd, ck, cv, pos_src), reps=20, inner=50)
    cross.update(decode_ms=dcold, decode_warm_ms=dwarm)
    say(f"[7 time] the same cross step through flash_decode (over ck/cv at pos {S - 1}): "
        f"{dcold:.5f} ms cold, {dwarm:.5f} ms warm (CUDA graph replay) against flash_attention's "
        f"{cross['ms']:.5f} / {cross['warm_ms']:.5f} and SDPA's {cross['library_replay_ms']:.5f} / "
        f"{cross['library_replay_warm_ms']:.5f}")
    del ck, cv, qx, qt, kt, vt, qd
    qd = randn((LM_BATCH, H, hd), bf16)
    kd, vd = (randn((LM_BATCH, LM_CACHE, K, hd), bf16) for _ in range(2))
    pos_d = torch.full((1,), LM_GEN - 1, dtype=torch.int32, device=dev)
    kv_t, vv_t = kd[:, :LM_GEN].transpose(1, 2), vd[:, :LM_GEN].transpose(1, 2)
    dec = attn_shape_entry(
        "flash_decode", f"{cfg.name} decode B{LM_BATCH} H{H} K{K} S{LM_CACHE} hd{hd} "
        f"pos {LM_GEN - 1}", launches["flash_decode"], "12",
        lambda: fd.flash_decode_cuda(qd, kd, vd, pos_d),
        lambda: fd.flash_decode_plain(qd, kd, vd, pos_d),
        lambda: F.scaled_dot_product_attention(qd[:, :, None], kv_t, vv_t), reps=20, inner=50,
        smi=smi, nbytes=2 * (2 * LM_BATCH * H * hd + 2 * LM_BATCH * LM_GEN * K * hd),
        nops=4 * LM_BATCH * H * LM_GEN * hd)
    return [enc, cross], [dec]


def moe_attention_routes(cfgs, dev, fa, fd, held, randn):
    """flash_attention and flash_decode at each MoE config's serving shapes
    (bf16; G 1 for Qwen1.5-MoE, 7 for Arctic), held to their plain
    versions by `held` (phase 3c's tolerance); the profiler's kernel
    names must show the tensor-core routes, attention_tc and decode_tc."""
    bf16 = torch.bfloat16
    for c in cfgs:
        H, K, hd = c.n_heads, c.n_kv_heads, c.resolved_head_dim
        q, k, v = (randn((LM_BATCH, LM_PROMPT, n, hd), bf16).transpose(1, 2) for n in (H, K, K))
        held("flash_attention", fa.flash_attention_cuda(q, k, v), fa.flash_attention_plain(q, k, v),
             f"{c.name} prefill B{LM_BATCH} H{H} K{K} S{LM_PROMPT} hd{hd} bf16 causal (G {H // K}, "
             "strided [B,S,H,hd] views)")
        qd, kd, vd = (randn((LM_BATCH, H, hd), bf16), randn((LM_BATCH, LM_CACHE, K, hd), bf16),
                      randn((LM_BATCH, LM_CACHE, K, hd), bf16))
        pd = torch.full((1,), LM_CACHE - 1, dtype=torch.int32, device=dev)
        held("flash_decode", fd.flash_decode_cuda(qd, kd, vd, pd),
             fd.flash_decode_plain(qd, kd, vd, pd),
             f"{c.name} decode B{LM_BATCH} H{H} K{K} S{LM_CACHE} hd{hd} bf16 pos {LM_CACHE - 1} "
             f"(G {H // K})")
        prof, _ = profile_slots(lambda: (fa.flash_attention_cuda(q, k, v),
                                         fd.flash_decode_cuda(qd, kd, vd, pd)), slots=1)
        names = sorted(n for n in (prof or {}) if "attention" in n or "decode" in n)
        if prof is not None and not (any("attention_tc" in n for n in names)
                                     and any("decode_tc" in n for n in names)):
            fail(f"10 moe: at G {H // K} the attention kernels ran {names}, not the tensor-core "
                 "routes attention_tc and decode_tc")
        say(f"[10 moe] G {H // K} (H {H}, K {K}, hd {hd}): the profiler's kernels "
            + (", ".join(n[:48] for n in names) if prof is not None else "not measured"))


def moe_serve(tag, cfg, dev, ops, moe, build_model, greedy_generate, plain):
    """Phase 10 for one MoE config: `serve_lm` (phase 8's run and bounds)
    with the MoE checks before its comparisons: for one prefill each
    layer's (token, slot) routing choices that differ between the kernel
    path and the plain path, in bf16 and with float32 activations; the
    pairs dropped per layer at the prefill and a decode step; the bounds
    of `moe_bounds`. `serve_lm` holds the two timed runs' prefills bitwise
    equal (the combine gathers and adds in a fixed order). Returns the
    greedy run's launch counts."""
    E = moe.padded_expert_count(cfg.n_experts, cfg.ep_axis)
    k = cfg.n_experts_active
    T = LM_BATCH * LM_PROMPT
    C = moe.capacity(T, k, E, cfg.moe_capacity_factor)
    C_dec = moe.capacity(LM_BATCH, k, E, cfg.moe_capacity_factor)

    def checks(model, params, batch):
        diffs = {}
        for dt, m in (("bf16", model),
                      ("float32", build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                                              dev))):
            with recording_plans(moe) as kern:
                logits, cache = m.prefill(params, batch, cache_len=LM_CACHE)
            with swapped(ops, plain), recording_plans(moe) as pl:
                m.prefill(params, batch, cache_len=LM_CACHE)
            if len(kern) != cfg.n_layers or len(pl) != cfg.n_layers:
                fail(f"{tag}: {len(kern)} and {len(pl)} routed layers in a prefill, expected "
                     f"{cfg.n_layers}")
            diffs[dt] = [int((a[0] != b[0]).sum()) for a, b in zip(kern, pl)]
            if dt == "bf16":
                drops = [int((~keep).sum()) for _, keep in kern]
                tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
                with recording_plans(moe) as dec:
                    model.decode_step(params, tok, cache)
                dec_drops = [int((~keep).sum()) for _, keep in dec]
            del logits, cache
        say(f"[{tag}] routing, kernels vs plain attention, (token, slot) choices that differ per "
            f"layer of one prefill ({T * k:,} pairs a layer): bf16 {diffs['bf16']}, float32 "
            f"activations {diffs['float32']}")
        say(f"[{tag}] dropped pairs per layer (E {E} experts, k {k}, capacity factor "
            f"{cfg.moe_capacity_factor:g}): prefill C {C}, of {T * k:,}: {drops}; a decode step "
            f"C {C_dec}, of {LM_BATCH * k}: {dec_drops}")
        nops, nbytes = moe_bounds(cfg, E, C)
        say(f"[{tag}] bounds from the shapes: prefill {nops / 1e12:.2f} TFLOP, "
            f"{nops / BF16_OPS_PER_S * 1e3:.1f} ms at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16; "
            f"a decode step {nbytes / 1e9:.2f} GB, {nbytes / HBM_BYTES_PER_S * 1e3:.2f} ms at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    launches, *_ = serve_lm(
        tag, cfg, dict(flash_attention=cfg.n_layers, flash_decode=cfg.n_layers * LM_GEN), plain,
        "plain attention", dev, ops, build_model, greedy_generate, before_checks=checks)
    torch.cuda.empty_cache()  # the model's weights go before the next phase's
    return launches


def attention_bwd_cases(fa, randn, max_err):
    """Phase 3c's backward cases: flash_attention_bwd_cuda vs its plain
    version on the card (the shapes below; tolerances ATTN_BWD_F32 and
    ATTN_BWD_RATIO), each case run twice and the two bitwise equal;
    max_err["flash_attention_bwd"] collects the largest error against the
    float32 plain gradient. The bf16 route reads the forward kernel's
    statistics (`stats=True`); the forward's output with them is held
    bitwise to its output without."""
    # the backward kernel (csrc/flash_attention_bwd.cu) vs its plain
    # version: float32 within ATTN_BWD_F32 of each gradient's sum of
    # |terms| (`bwd_term_sums`); bf16 (the tensor cores, fed by the
    # forward's lse and O32) each gradient's max abs error from the
    # float32 plain gradient at most ATTN_BWD_RATIO x the plain bf16
    # path's; every case run twice and the two bitwise equal (no atomics)
    bf16, f32 = torch.bfloat16, torch.float32
    max_err["flash_attention_bwd"] = 0.0
    bwd_cases = [  # B, H, K, Sq, Skv, hd, mask, prefix_len, dtypes
        (LM_BATCH, 16, 16, 4096, 4096, 64, "causal", 0, (bf16, f32)),  # Qwen1.5-0.5B's training
        (LM_BATCH, 32, 2, 1024, 1024, 128, "causal", 0, (bf16, f32)),  # GLM-4-9B's heads
        (2, 8, 2, 333, 333, 16, "causal", 0, (bf16, f32)),
        (2, 8, 4, 300, 500, 32, "full", 0, (bf16, f32)),
        (1, 4, 4, 63, 1000, 64, "full", 0, (bf16, f32)),
        (1, 4, 4, 65, 4095, 64, "causal", 0, (bf16, f32)),
        (1, 4, 4, 65, 1000, 64, "causal", 0, (bf16,)),
        (1, 4, 2, 63, 4095, 128, "prefix", 1000, (bf16,)),
        (1, 16, 16, 1000, 1000, 64, "causal", 0, (bf16,)),
    ] + [(2, 8, 2, 512, 512, 64, "prefix", pl, (bf16, f32)) for pl in (1, 255, 256, 257)]
    for B, H, K, Sq, Skv, hd, mode, pl, dts in bwd_cases:
        for dt in dts:
            q, k, v, g = (randn((B, n, S, hd), dt) for n, S in ((H, Sq), (K, Skv), (K, Skv), (H, Sq)))
            label = (f"B{B} H{H} K{K} Sq{Sq} Skv{Skv} hd{hd} {str(dt)[6:]} {mode}"
                     + (f" prefix_len {pl}" if mode == "prefix" else ""))
            stats = {}
            if dt == bf16:
                out, lse, o32 = fa.flash_attention_cuda(q, k, v, mask_mode=mode, prefix_len=pl,
                                                        stats=True)
                if not torch.equal(out, fa.flash_attention_cuda(q, k, v, mask_mode=mode,
                                                                prefix_len=pl)):
                    fail(f"flash_attention {label}: the output with stats differs from the "
                         "output without")
                stats = dict(lse=lse, o32=o32)
                del out
            got = fa.flash_attention_bwd_cuda(q, k, v, g, mask_mode=mode, prefix_len=pl, **stats)
            again = fa.flash_attention_bwd_cuda(q, k, v, g, mask_mode=mode, prefix_len=pl, **stats)
            torch.cuda.synchronize()
            if not all(same_bits(a.float(), b.float()) for a, b in zip(got, again)):
                fail(f"flash_attention_bwd {label}: two runs differ")
            exact = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), g.float(),
                                                 mask_mode=mode, prefix_len=pl)
            errs = [float((a.float() - b).abs().max()) for a, b in zip(got, exact)]
            if dt == f32:
                terms = bwd_term_sums(q, k, v, g, mode, pl)
                ratio = max(float(((a - b).abs() / (ATTN_BWD_F32 * t + ATTN_BWD_F32 * b.abs()
                                                    + 1e-30)).max())
                            for a, b, t in zip(got, exact, terms))
                if not ratio <= 1.0:
                    fail(f"flash_attention_bwd {label}: error {errs} beyond {ATTN_BWD_F32:g} x "
                         f"sum|terms| + {ATTN_BWD_F32:g} x |plain| (ratio {ratio:.3f})")
                detail = f"{ratio:.3f} of the tolerance {ATTN_BWD_F32:g} x (sum|terms| + |plain|)"
                del terms
            else:
                plain_b = fa.flash_attention_bwd_plain(q, k, v, g, mask_mode=mode, prefix_len=pl)
                errs_p = [float((a.float() - b).abs().max()) for a, b in zip(plain_b, exact)]
                ratios = [e / max(p_, 1e-30) for e, p_ in zip(errs, errs_p)]
                if not max(ratios) <= ATTN_BWD_RATIO:
                    fail(f"flash_attention_bwd {label}: errors {errs} vs the plain bf16 path's "
                         f"{errs_p} (ratios {ratios}, limit {ATTN_BWD_RATIO:g})")
                detail = (f"the plain bf16 path's {', '.join(f'{e:.3e}' for e in errs_p)}, ratios "
                          f"{', '.join(f'{r:.3f}' for r in ratios)} (limit {ATTN_BWD_RATIO:g})")
                del plain_b
            max_err["flash_attention_bwd"] = max(max_err["flash_attention_bwd"], *errs)
            say(f"[3c kernels] flash_attention_bwd {label}: dq, dk, dv max abs err "
                f"{', '.join(f'{e:.3e}' for e in errs)} vs the float32 plain gradient; {detail}; "
                "two runs bitwise equal"
                + ("; the forward's output with stats bitwise its output without" if stats else ""))
            del q, k, v, g, got, again, exact, stats
    # the training path's layout: the model's [B,S,H,hd] projections and
    # the output's gradient, passed transposed (strided views): the same
    # bits as the kernel on contiguous copies, gradients in q, k, v's layouts
    for dt in (bf16, f32):
        q, g = randn((2, 300, 16, 64), dt), randn((2, 300, 16, 64), dt)
        k, v = randn((2, 300, 4, 64), dt), randn((2, 300, 4, 64), dt)
        views = [x.transpose(1, 2) for x in (q, k, v, g)]
        stats = (dict(zip(("lse", "o32"), fa.flash_attention_cuda(*views[:3], stats=True)[1:]))
                 if dt == bf16 else {})
        got = fa.flash_attention_bwd_cuda(*views, **stats)
        want = fa.flash_attention_bwd_cuda(*(x.contiguous() for x in views), **stats)
        torch.cuda.synchronize()
        if not (all(same_bits(a.float(), b.float()) for a, b in zip(got, want))
                and all(a.stride() == x.stride() for a, x in zip(got, views[:3]))):
            fail(f"flash_attention_bwd strided {str(dt)[6:]}: the gradients differ from the "
                 "contiguous inputs', or are not in q, k, v's layouts")
        say(f"[3c kernels] flash_attention_bwd B2 H16 K4 S300 hd64 {str(dt)[6:]} causal, strided "
            "[B,S,H,hd] views: bitwise the kernel on contiguous copies; dq, dk, dv in q, k, v's "
            "layouts")
        del q, k, v, g, views, got, want, stats
    torch.cuda.empty_cache()


def ssd_bwd_cases(sdc, inputs, randn, max_err):
    """Phase 3d's backward cases: ssd_chunk_intra_bwd_cuda vs its plain
    version on the card, every output within SSD_TOL x max(1, sum|terms|)
    + SSD_TOL x |plain| (`ssd_chunk_intra_bwd_terms`: the terms of each
    output's sums, the reverse prefix sum of da included), every case run
    twice and the two bitwise equal (no atomics); max_err collects the
    largest error. `inputs(B, nc, l, H, P, N, decays)` gives a, x, Bm, Cm;
    the cotangents are seeded normals (zero where the case says)."""
    f32 = torch.float32
    max_err["ssd_chunk_intra_bwd"] = 0.0
    cases = [  # B, nc, l, H, P, N, decays, cotangent
        (TRAIN_BATCH, TRAIN_SEQ // 256, 256, 64, 64, 128, "init", ""),  # mamba2-1.3B's training
        (TRAIN_BATCH, TRAIN_SEQ // 256, 256, 64, 64, 128, "strong", ""),
        (TRAIN_BATCH, TRAIN_SEQ // 256, 256, 64, 64, 128, "weak", ""),
        (2, 3, 1, 5, 16, 16, "init", ""),       # l 1
        (2, 3, 16, 5, 16, 16, "strong", ""),    # l 16, P 16, N 16
        (2, 3, 17, 5, 16, 16, "weak", ""),      # l 17: a ragged 64-row tile and scan block
        (1, 2, 255, 12, 64, 128, "init", ""),   # l 255: the last tile ragged
        (1, 2, 250, 60, 64, 128, "init", ""),   # l 250: a tile ending off the k8 steps; H 60:
                                                # the last group of 8 heads holds 4
        (1, 1, 256, 64, 64, 128, "weak", ""),   # B = nc = 1
        (1, 1, 100, 7, 33, 40, "strong", ""),   # ragged everything
        (1, 2, 256, 40, 64, 256, "init", ""),   # N 256: four 64-state tiles
        (2, 2, 65, 8, 64, 128, "init", "dS"),   # a zero dS (and dtot)
        (2, 2, 65, 8, 64, 128, "weak", "dy"),   # a zero dy
    ]
    for B, nc, l, H, P, N, decays, zero in cases:
        a, x, Bm, Cm = inputs(B, nc, l, H, P, N, decays)
        dy = randn((B, nc, l, H, P), f32) * (zero != "dy")
        dS, dtot = (randn(shape, f32) * (zero != "dS") for shape in ((B, nc, H, N, P), (B, nc, H)))
        args = (a, x, Bm, Cm, dy, dS, dtot)
        label = f"B{B} nc{nc} l{l} H{H} P{P} N{N} {decays} decays" + (f", zero {zero}" if zero else "")
        got = sdc.ssd_chunk_intra_bwd_cuda(*args)
        again = sdc.ssd_chunk_intra_bwd_cuda(*args)
        want = sdc.ssd_chunk_intra_bwd_plain(*args)
        terms = sdc.ssd_chunk_intra_bwd_terms(*args)
        torch.cuda.synchronize()
        if not all(same_bits(u, v) for u, v in zip(got, again)):
            fail(f"ssd_chunk_intra_bwd {label}: two runs differ")
        parts = []
        for part, gv, wv, tv in zip(("da", "dx", "dB", "dC"), got, want, terms):
            diff = (gv - wv).abs()
            err = float(diff.max())
            over = float((diff / (SSD_TOL * tv.clamp_min(1.0) + SSD_TOL * wv.abs())).max())
            if not (torch.isfinite(gv).all() and over <= 1.0):
                fail(f"ssd_chunk_intra_bwd {label}: {part} max abs err {err:.3e} beyond "
                     f"{SSD_TOL:g} * max(1, sum|terms|) + {SSD_TOL:g}*|plain| ({over:.3f})")
            max_err["ssd_chunk_intra_bwd"] = max(max_err["ssd_chunk_intra_bwd"], err)
            parts.append(f"{part} {err:.3e} ({over:.3f} of the limit; {int((gv != wv).sum())} of "
                         f"{gv.numel()} entries differ)")
        say(f"[3d kernels] ssd_chunk_intra_bwd {label}: max abs err vs plain " + ", ".join(parts)
            + "; two runs bitwise equal")
        del args, got, again, want, terms, a, x, Bm, Cm, dy, dS, dtot
    torch.cuda.empty_cache()


def ssd_work(B, nc, l, H, P, N) -> tuple:
    """(operations, bytes) of ssd_chunk_intra's function: y over the
    causal (i, j) pairs, S_c over every (j, n) pair, the scores C.B once
    per (batch, chunk) over the causal pairs, the decay weights and the
    decayed x; a, x, B, C read and y, S_c, total written once, float32.
    Also the products alone (the work a 3xTF32 route would triple)."""
    pairs = l * (l + 1) // 2
    products = B * nc * (H * pairs * 2 * P + H * l * P * 2 * N + pairs * 2 * N)
    nops = products + B * nc * (H * pairs + H * l * P)
    nbytes = 4 * (2 * B * nc * l * H * P + B * nc * l * H + 2 * B * nc * l * N
                  + B * nc * H * N * P + B * nc * H)
    return nops, nbytes, products


def train_bounds(cfg, batch: int, seq: int) -> dict:
    """The least time one training step could take on the card, from the
    shapes: the bf16 products (the forward, remat's recompute of it and
    the backward's two products a weight; a dense layer's attention, q.k
    and p.v over the causal pairs in the forward and the recompute, and
    its backward's five: S, dP, dv, dq, dk) at BF16_OPS_PER_S, plus the
    float32 unembed (its forward, the backward's recompute and its two
    gradient products) as chunked_ce_loss computes it and an ssm layer's
    SSD step (`ssd_work` twice, the forward and its recompute, and
    `ssd_chunk.bwd_work`) at FP32_OPS_PER_S."""
    from repro_torch.kernels.ssd_chunk import bwd_work

    tokens = batch * seq
    d, L = cfg.d_model, cfg.n_layers
    attn = ssd = 0
    if cfg.family == "ssm":
        di, ds, nh, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
        layer_w = d * (2 * di + 2 * ds + nh) + di * d  # in_proj, out_proj
        l = min(cfg.ssm_chunk, seq)
        nc = -(-seq // l)
        ssd = L * (2 * ssd_work(batch, nc, l, nh, P, ds)[0] + bwd_work(batch, nc, l, nh, P, ds)[0])
    else:
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        layer_w = d * (H + 2 * K) * hd + H * hd * d + 3 * d * cfg.d_ff  # projections + SwiGLU
        attn = 2 * hd * (batch * H * seq * (seq + 1) // 2) * L * (2 + 2 + 5)
    matmul = 2 * layer_w * tokens * L * (1 + 1 + 2)
    unembed = 2 * d * cfg.vocab_size * tokens * 4
    bf16_s, f32_s = (matmul + attn) / BF16_OPS_PER_S, (unembed + ssd) / FP32_OPS_PER_S
    return dict(matmul=matmul, attn=attn, ssd=ssd, unembed=unembed, bf16_s=bf16_s, f32_s=f32_s,
                total_s=bf16_s + f32_s)


def train_steps(tag, cfg, dev, ops, plain, per_layer, smi, compare_layers=None) -> dict:
    """(a)-(c) of a training phase for `cfg` at full size, batch
    TRAIN_BATCH x TRAIN_SEQ tokens from the synthetic stream
    (`data.make_batch_fn`), the port's seeded bf16 init:
    (a) one step's loss and every leaf's gradient through the kernels and
        with the plain versions `plain` swapped in ({ops name: function},
        `swapped`), float32 (params and activations) within LOGIT_F32_TOL
        relative L2 a leaf, bf16 each leaf's error from the float32 plain
        gradient at most LOGIT_ERR_RATIO x the plain path's; every leaf's
        gradient nonzero through the kernels (the autograd path reaches
        every leaf); with `compare_layers`, on the model's first
        compare_layers layers (`cut_depth`: the same widths and shapes);
    (b) TRAIN_STEPS steps of `launch.train.train_loop` (AdamW, cosine
        schedule) after one warm step, launches held to `per_layer` x the
        layers a step, each step timed with CUDA events; tokens/s, peak
        memory, MFU, one step profiled (idle share, top kernels) beside
        `train_bounds`;
    (c) two steps from the same state bitwise equal.
    Returns {"per_step", "launches" (the timed run's), "step_ms" (the
    median), "mfu", "tokens"}; the model is freed."""
    from repro_torch.data import make_batch_fn
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule, make_train_step
    from repro_torch.pytree import flatten_with_path, tree_leaves, tree_map, tree_unflatten

    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    batch_fn = make_batch_fn(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=SEED, device=dev)
    say(f"[{tag}] {cfg.name}: {n_params:,} parameters ({cfg.param_dtype}) made on the card in "
        f"{time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens ({tokens:,} a "
        f"step), remat {cfg.remat}, logit_chunk {cfg.logit_chunk}")
    per_step = {k: v * cfg.n_layers for k, v in per_layer.items()}

    def expect(counts, want, what):
        full = {k: 0 for k in counts}
        full.update(want)
        if counts != full:
            fail(f"{tag} {what}: kernel launches {counts}, expected {full}")

    # ---- (a) kernels vs plain versions: loss and every leaf's gradient
    def loss_grads(m, p, batch):
        lv = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
        loss, _ = m.loss(tree_unflatten(p, lv), batch)
        return loss.detach(), torch.autograd.grad(loss, lv)

    batch = batch_fn(0)
    ccfg, cparams = cut_depth(cfg, params, compare_layers) if compare_layers else (cfg, params)
    names = [n for n, _ in flatten_with_path(cparams)]
    cmodel = build_model(ccfg, dev)
    f32_model = build_model(dataclasses.replace(ccfg, param_dtype="float32",
                                                compute_dtype="float32"), dev)
    p32 = tree_map(lambda x: x.float(), cparams)
    cut = f" (the first {ccfg.n_layers} of {cfg.n_layers} layers)" if compare_layers else ""
    res = {}
    for key, m, p in (("bf16 kernels", cmodel, cparams), ("bf16 plain", cmodel, cparams),
                      ("f32 kernels", f32_model, p32), ("f32 plain", f32_model, p32)):
        ctx = (lambda: swapped(ops, plain)) if "plain" in key else contextlib.nullcontext
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with ctx():
            res[key] = loss_grads(m, p, batch)
        torch.cuda.synchronize()
        expect(ops.launch_counts(), {} if "plain" in key else
               {k: v * ccfg.n_layers for k, v in per_layer.items()}, key)
        say(f"[{tag}] (a) {key}{cut}: loss {float(res[key][0]):.6f}, one step's loss and gradients "
            f"{time.perf_counter() - t0:.2f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
    for key in ("bf16 kernels", "f32 kernels"):
        zero = [n for n, g, r in zip(names, res[key][1], res["f32 plain"][1])
                if not bool(g.any()) and bool(r.any())]
        if zero:
            fail(f"{tag} (a) {key}: no gradient reached {zero}")
    ref = res["f32 plain"][1]
    loss_gap = abs(float(res["f32 kernels"][0]) - float(res["f32 plain"][0])) / abs(
        float(res["f32 plain"][0]))
    if loss_gap > LOGIT_F32_TOL:
        fail(f"{tag} (a): float32 loss kernels vs plain {loss_gap:.3e} beyond {LOGIT_F32_TOL:g}")
    lines = []
    for i, n in enumerate(names):
        gap = rel_l2(res["f32 kernels"][1][i], ref[i])
        err_k, err_p = rel_l2(res["bf16 kernels"][1][i], ref[i]), rel_l2(res["bf16 plain"][1][i],
                                                                           ref[i])
        lines.append(f"{n} f32 {gap:.2e} bf16 {err_k:.3e}/{err_p:.3e} ({err_k / err_p:.3f})")
        if not gap <= LOGIT_F32_TOL:
            fail(f"{tag} (a) {n}: float32 gradient kernels vs plain {gap:.3e} beyond "
                 f"{LOGIT_F32_TOL:g}")
        if not err_k <= LOGIT_ERR_RATIO * err_p:
            fail(f"{tag} (a) {n}: bf16 gradient error {err_k:.3e} beyond {LOGIT_ERR_RATIO:g} x "
                 f"the plain path's {err_p:.3e}")
    say(f"[{tag}] (a){cut} every leaf's gradient nonzero through the kernels; float32 loss kernels vs "
        f"plain {loss_gap:.3e}; per leaf: float32 kernels vs plain relative L2 (limit "
        f"{LOGIT_F32_TOL:g}), bf16 kernels / plain relative L2 error vs the float32 plain "
        f"gradient (ratio, limit {LOGIT_ERR_RATIO:g}): " + "; ".join(lines))
    say(f"[{tag}] (a) bf16 loss kernels {float(res['bf16 kernels'][0]):.6f}, plain "
        f"{float(res['bf16 plain'][0]):.6f}, float32 plain {float(res['f32 plain'][0]):.6f}")
    del res, ref, p32, f32_model, cmodel, cparams
    torch.cuda.empty_cache()

    # ---- (b) TRAIN_STEPS timed steps of launch.train's loop
    opt = AdamW(lr=cosine_schedule(3e-4, 2, TRAIN_STEPS + 1))
    state = opt.init(params)
    train_step = make_train_step(model, opt)
    params, state, _ = train_step(params, state, batch_fn(0))  # warm: allocator, library init
    torch.cuda.synchronize()
    events, metrics_seen = [], []

    def timed_step(p, st, b):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = train_step(p, st, b)
        ev[1].record()
        events.append(ev)
        metrics_seen.append(out[2])
        return out

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, state, metrics = train_loop(timed_step, batch_fn, params, state, 1, 1 + TRAIN_STEPS,
                                        log=None)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    expect(launches, {k: v * TRAIN_STEPS for k, v in per_step.items()}, "(b) timed steps")
    step_ms = [a.elapsed_time(b) for a, b in events]
    med = statistics.median(step_ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m_["loss"]) for m_ in metrics_seen]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{tag} (b): non-finite losses {losses}")
    mfu = 6.0 * cfg.active_params() * tokens / (med / 1e3) / BF16_OPS_PER_S
    tb = train_bounds(cfg, TRAIN_BATCH, TRAIN_SEQ)
    say(f"[{tag}] (b) {TRAIN_STEPS} steps of launch.train.train_loop (AdamW, cosine schedule): "
        f"launches {launches} ({per_step} a step); step ms (CUDA events) "
        + ", ".join(f"{x:.1f}" for x in step_ms) + f", median {med:.1f} ms; host "
        f"{host_s / TRAIN_STEPS * 1e3:.1f} ms a step; {tokens / (med / 1e3):,.0f} tokens/s; "
        f"peak memory {peak:.2f} GiB; losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f", grad_norm {float(metrics['grad_norm']):.3f}, lr {float(metrics['lr']):.3e}; "
        f"MFU {mfu:.4f} (6 x {cfg.active_params():,} x {tokens:,} FLOP a step at "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s); {smi}")
    say(f"[{tag}] (b) the step's bound: bf16 products {(tb['matmul'] + tb['attn']) / 1e12:.2f} TFLOP "
        f"(matmuls {tb['matmul'] / 1e12:.2f}, attention {tb['attn'] / 1e12:.2f}) at "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s = {tb['bf16_s'] * 1e3:.1f} ms, plus the float32 "
        f"unembed {tb['unembed'] / 1e12:.2f} TFLOP and SSD steps {tb['ssd'] / 1e12:.2f} TFLOP at "
        f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s = {tb['f32_s'] * 1e3:.1f} ms; "
        f"{tb['total_s'] * 1e3:.1f} ms in all, {tb['total_s'] * 1e3 / med:.3f} of the measured step")
    prof, host = profile_slots(lambda: train_step(params, state, batch_fn(1 + TRAIN_STEPS)), slots=1)
    if prof is None:
        say(f"[{tag}] (b) one step's device time not measured (the profiler recorded no device "
            "time)")
    else:
        busy = prof.pop("total")
        top = sorted(((v, k) for k, v in prof.items()), reverse=True)
        say(f"[{tag}] (b) one step under the profiler: device busy {busy:.1f} ms of {med:.1f} ms "
            f"(idle share {1.0 - busy / med:.3f}); "
            f"{sum(v[1] for k, v in host.items() if k.startswith('aten::')):.0f} aten op calls; "
            "top kernels " + ", ".join(f"{k[:60]} {v:.1f} ms" for v, k in top[:10]))
    torch.cuda.empty_cache()

    # ---- (c) two steps from the same state: bitwise equal
    b6 = batch_fn(2 + TRAIN_STEPS)
    pa, sa, ma = train_step(params, state, b6)
    pb, sb, mb = train_step(params, state, b6)
    same = [n for (n, x), y in zip(flatten_with_path((pa, sa)), tree_leaves((pb, sb)))
            if not torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                               y.view(torch.int16) if y.dtype == torch.bfloat16 else y)]
    if same or float(ma["loss"]) != float(mb["loss"]):
        fail(f"{tag} (c): two steps from one state differ in {same[:5]} (losses "
             f"{float(ma['loss'])}, {float(mb['loss'])})")
    say(f"[{tag}] (c) two steps from the same parameters and AdamW state: every parameter and "
        f"moment bitwise equal, loss {float(ma['loss']):.6f} both")
    del pa, sa, pb, sb, model, params, state, train_step
    torch.cuda.empty_cache()
    return {"per_step": per_step, "launches": launches, "step_ms": med, "mfu": mfu,
            "tokens": tokens}


def train_phase(dev, ops, fa, smi):
    """Phase 13: the training path for TRAIN_ARCH (Qwen1.5-0.5B) at full
    size: (a)-(c) `train_steps`, the plain attention swapped in for (a),
    launches held to 48 forward (24 + 24 remat recomputes) and 24 backward
    a step;
    (d) the GreenOrchestrator on the card: restart bit-exact on the SMOKE
        setup of tests/test_orchestrator.py, then ORCH_SLOTS slots with two
        full-size jobs (seeds 0 and 1, ORCH_SEQ x TRAIN_BATCH, one step a
        task, one task a cloud a slot);
    (e) the card's kWh a task from the measured step time and power limit,
        beside `lm_task_energy_kwh` given the card's peak and that MFU.
    Returns `train_steps`' dict."""
    from repro_torch.configs import registry
    from repro_torch.configs.paper_workloads import lm_task_energy_kwh
    from repro_torch.core.carbon import ConstantCarbonSource, UKRegionalTraceSource
    from repro_torch.core.policies import CarbonIntensityPolicy
    from repro_torch.core.queueing import NetworkSpec
    from repro_torch.data import make_batch_fn
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, make_train_step
    from repro_torch.orchestrator import Cloud, GreenOrchestrator, TrainJob
    from repro_torch.pytree import flatten_with_path, tree_leaves

    tag = "13 train"
    cfg = registry.get_config(TRAIN_ARCH)
    info = train_steps(tag, cfg, dev, ops, {"flash_attention": fa.flash_attention_plain},
                       {"flash_attention": 2, "flash_attention_bwd": 1}, smi)
    per_step, med, mfu, tokens = info["per_step"], info["step_ms"], info["mfu"], info["tokens"]

    def expect(counts, want, what):
        full = {k: 0 for k in counts}
        full.update(want)
        if counts != full:
            fail(f"{tag} {what}: kernel launches {counts}, expected {full}")

    # ---- (d) the GreenOrchestrator on the card
    spec = NetworkSpec(pe=np.full(2, 1.0, np.float32), pc=np.full((2, 2), 5.0, np.float32),
                       Pe=8.0, Pc=np.full(2, 20.0, np.float32))

    def arrivals(t):  # tests/test_orchestrator.py's
        return np.random.default_rng((7, t)).integers(0, 3, 2).astype(np.float32)

    def jobs(arch_seeds, seq, batch, smoke):
        out = []
        for aid, seed in arch_seeds:
            c = registry.get_smoke_config(aid) if smoke else registry.get_config(aid)
            m = build_model(c, dev)
            o = AdamW(lr=1e-3)
            p = m.init(torch.Generator(device=dev).manual_seed(seed))
            out.append(TrainJob(name=f"{aid}-{seed}", model=m, train_step=make_train_step(m, o),
                                batch_fn=make_batch_fn(c, seq, batch, seed=seed, device=dev),
                                params=p, opt_state=o.init(p), steps_per_task=1))
        return out

    smoke_jobs = (("qwen1_5_0_5b", 0), ("internlm2_20b", 1))
    with tempfile.TemporaryDirectory() as ck:
        def fresh(d):
            return GreenOrchestrator(jobs(smoke_jobs, 32, 2, True), [Cloud("c0"), Cloud("c1")], spec,
                                     ConstantCarbonSource(N=2, Ce=10.0, Cc=10.0), arrivals,
                                     policy=CarbonIntensityPolicy(V=0.01), ckpt_dir=f"{ck}/{d}",
                                     ckpt_every=2, max_tasks_per_slot=3, device=dev)
        a = fresh("a")
        a.run(6)
        b1 = fresh("b")
        b1.run(4)
        b1.ckpt.wait()
        b2 = fresh("b")
        if not (b2.resume() and b2.t == 4):
            fail(f"{tag} (d): the SMOKE orchestrator did not resume at slot 4")
        b2.run(2)
        bad = [n for (n, x), y in zip(
            flatten_with_path([(j.params, j.opt_state) for j in a.jobs] + [a.state]),
            tree_leaves([(j.params, j.opt_state) for j in b2.jobs] + [b2.state]))
            if not torch.equal(x, y)]
        if bad or a.executed_tasks != b2.executed_tasks or a.cum_emissions != b2.cum_emissions:
            fail(f"{tag} (d): the resumed SMOKE run differs in {bad[:5]}, executed "
                 f"{a.executed_tasks} vs {b2.executed_tasks}, emissions {a.cum_emissions} vs "
                 f"{b2.cum_emissions}")
        say(f"[{tag}] (d) SMOKE orchestrator on the card (tests/test_orchestrator.py's setup): 6 "
            f"slots straight vs 4, a checkpoint, a new orchestrator resumed and 2 more: queues, "
            f"every parameter and AdamW moment bitwise equal; executed {a.executed_tasks}, "
            f"emissions {a.cum_emissions:.1f} both")
        del a, b1, b2
    actions = []
    pol = CarbonIntensityPolicy(V=0.01)

    def recording(*args):
        act = pol(*args)
        actions.append((act.d.cpu().numpy(), act.w.cpu().numpy()))
        return act

    orch = GreenOrchestrator(jobs(((TRAIN_ARCH, 0), (TRAIN_ARCH, 1)), ORCH_SEQ, TRAIN_BATCH, False),
                             [Cloud("c0"), Cloud("c1")], spec, UKRegionalTraceSource(N=2), arrivals,
                             policy=recording, max_tasks_per_slot=1, device=dev)
    orch.jobs[0].run_task()  # warm the allocator and libraries at this shape (not a slot)
    orch.jobs[0].losses.clear()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    slot_s = []
    for _ in range(ORCH_SLOTS):
        t0 = time.perf_counter()
        orch.run_slot()
        slot_s.append(time.perf_counter() - t0)
    launches_d = ops.launch_counts()
    n_exec = orch.executed_tasks
    # the UK source draws its noise for 256 slots in one threefry_draw
    expect(launches_d, {"carbon_scores": ORCH_SLOTS, "greedy_fill": ORCH_SLOTS, "threefry_draw": 1,
                        "flash_attention": per_step["flash_attention"] * n_exec,
                        "flash_attention_bwd": per_step["flash_attention_bwd"] * n_exec}, "(d)")
    if n_exec == 0:
        fail(f"{tag} (d): the orchestrator executed no task in {ORCH_SLOTS} slots")
    say(f"[{tag}] (d) GreenOrchestrator, two full-size {cfg.name} jobs (seeds 0, 1; {TRAIN_BATCH} x "
        f"{ORCH_SEQ} tokens, one step a task, one task a cloud a slot), UK regional carbon, "
        f"{ORCH_SLOTS} slots: d " + " ".join(str(d.astype(int).tolist()) for d, _ in actions)
        + "; w " + " ".join(str(w.astype(int).tolist()) for _, w in actions)
        + f"; executed {n_exec}; emissions {orch.cum_emissions:.3f} (trace "
        + ", ".join(f"{x:.3f}" for x in orch.cum_emissions_trace) + "); losses "
        + "; ".join(f"{j.name} " + ", ".join(f"{x:.4f}" for x in j.losses) for j in orch.jobs)
        + "; seconds a slot " + ", ".join(f"{x:.2f}" for x in slot_s)
        + f"; launches {launches_d}")
    del orch, actions
    torch.cuda.empty_cache()

    # ---- (e) the card's kWh a task
    watts = float(re.search(r"([\d.]+)\s*W", smi).group(1))
    kwh = med / 1e3 * watts / 3.6e6
    model_kwh = lm_task_energy_kwh(cfg.active_params(), tokens, 1, peak_flops=BF16_OPS_PER_S,
                                   chip_kw=watts / 1e3, mfu=mfu)
    say(f"[{tag}] (e) kWh a task (one step of {tokens:,} tokens): measured {med:.1f} ms x "
        f"{watts:.0f} W (the power limit) = {kwh:.4e} kWh; lm_task_energy_kwh(peak "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s, {watts / 1e3:.3f} kW, MFU {mfu:.4f}) = "
        f"{model_kwh:.4e} kWh (equal by construction: the MFU is this step's)")
    return info


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.core as core
    from repro_torch.core import extensions as ext
    from repro_torch import convert
    import repro_torch.forecast as fcst
    import repro_torch.network as net
    import repro_torch.faults as flt
    import repro_torch.deadlines as dlm
    import repro_torch.telemetry as tlm
    from repro_torch.configs import fleet_scenarios
    from repro_torch.configs.paper_workloads import V_PAPER, paper_spec
    from repro_torch.core import carbon
    from repro_torch.core.policies import discount_powers
    from repro_torch.kernels import build, ops
    from repro_torch.configs import registry
    from repro_torch.kernels import carbon_score as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import greedy_fill as gf
    from repro_torch.kernels import knapsack as kpk
    from repro_torch.kernels import route_score as rs
    from repro_torch.kernels import ssd_chunk as sdc
    from repro_torch.kernels import taps as tpk
    from repro_torch.kernels import threefry as tfk
    from repro_torch import random as jr
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import build_model
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import moe as moe_lib
    from repro_torch.serve import serve_loop

    dev = torch.device("cuda", 0)
    # full float32 products, and bf16 products accumulated in float32 (as
    # the JAX einsums are), so kernel-vs-plain gaps are the kernels' own
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # ---- 1. device -------------------------------------------------
    clock = PhaseClock()
    clock.start("1")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = smi_line()
    say(f"[1 device] {name} capability {cap[0]}.{cap[1]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} count {torch.cuda.device_count()}")
    say(f"[1 device] nvidia-smi: {smi}")
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")

    # ---- 2. build --------------------------------------------------
    clock.start("2")
    t0 = time.perf_counter()
    built = build.build_all()
    say(f"[2 build] {len(built)} kernels in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for kname, (secs, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        say(f"[2 build] {kname}: {secs:.2f} s; " + " | ".join(regs))

    # ---- 3. kernels vs plain versions on the card -------------------
    clock.start("3")
    max_err = {"carbon_scores": 0.0, "route_scores": 0.0, "greedy_fill": 0.0,
               "threefry_draw": 0.0, "tap_scan": 0.0, "tap_probe": 0.0}
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def check_scores(Qc, pc, Qe, pe, vcc, vce, label):
        got = cs.carbon_scores_cuda(Qc, pc, Qe, pe, vcc, vce)
        want = cs.carbon_scores_plain(Qc, pc, Qe, pe, vcc, vce)
        torch.cuda.synchronize()
        for part, a, b in zip(("c", "n1", "b"), got, want):
            if not torch.equal(a, b):
                fail(f"carbon_scores {label}: {part} differs from the plain version")
        err = max(float((got[0] - want[0]).abs().max()), float((got[2] - want[2]).abs().max()))
        max_err["carbon_scores"] = max(max_err["carbon_scores"], err)
        say(f"[3 kernels] carbon_scores {label}: c, n1, b bitwise equal to plain")

    def rand(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=g, device=dev).float()

    for M, N in ((M_MAIN, N_MAIN), (257, 129), (100, 37), (5, 5)):
        check_scores(ints((M, N), 5000), rand((M, N), 1, 100), ints((M,), 5000),
                     rand((M,), 1, 10), rand((N,), 0, 35), rand((), 0, 35), f"{M}x{N}")
    check_scores(ints((M_MAIN, N_MAIN), 4), rand((M_MAIN, N_MAIN), 1, 100), ints((M_MAIN,), 5),
                 rand((M_MAIN,), 1, 10), rand((N_MAIN,), 0, 35), rand((), 0, 35),
                 f"{M_MAIN}x{N_MAIN} tie-heavy Qc")
    # the lane axis (the fleet's and the V sweep's form): F16 at the main
    # width with one V*Ce a lane, the bench fleet's F512 x M5 x N5, a
    # ragged one; and F = 1 against the [M, N] call
    for nl, M, N in ((16, M_MAIN, N_MAIN), (FLEET_A_LANES, 5, 5), (3, 257, 129)):
        check_scores(ints((nl, M, N), 5000), rand((nl, M, N), 1, 100), ints((nl, M), 5000),
                     rand((nl, M), 1, 10), rand((nl, N), 0, 35), rand((nl,), 0, 35),
                     f"lanes F{nl}xM{M}xN{N} (per-lane V)")
    one_args = (ints((M_MAIN, N_MAIN), 5000), rand((M_MAIN, N_MAIN), 1, 100),
                ints((M_MAIN,), 5000), rand((M_MAIN,), 1, 10), rand((N_MAIN,), 0, 35),
                rand((), 0, 35))
    one = cs.carbon_scores_cuda(*one_args)
    lane = cs.carbon_scores_cuda(*(x[None] for x in one_args))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b[0]) for a, b in zip(one, lane)):
        fail("carbon_scores: F = 1 differs from the [M, N] call")
    say(f"[3 kernels] carbon_scores F=1 x M{M_MAIN} x N{N_MAIN}: c, n1, b bitwise equal to the "
        "[M, N] call")

    def check_routes(Qt, pt, Qcr, extra, Qe, pe, vct, vce, label):
        for mode, ex in (("with extra", extra), ("without extra", None)):
            got = rs.route_scores_cuda(Qt, pt, Qcr, ex, Qe, pe, vct, vce)
            want = rs.route_scores_plain(Qt, pt, Qcr, ex, Qe, pe, vct, vce)
            torch.cuda.synchronize()
            for part, a, b in zip(("rc", "l1", "b"), got, want):
                if not torch.equal(a, b):
                    fail(f"route_scores {label} {mode}: {part} differs from the plain version")
            err = max(float((got[0] - want[0]).abs().max()), float((got[2] - want[2]).abs().max()))
            max_err["route_scores"] = max(max_err["route_scores"], err)
        say(f"[3 kernels] route_scores {label}: rc, l1, b bitwise equal to plain, with and "
            "without extra")

    L_MAIN = 2 * N_MAIN
    for M, L in ((M_MAIN, L_MAIN), (257, 129), (100, 37), (5, 5), (300, 1), (1, 1)):
        check_routes(ints((M, L), 500), rand((M, L), 0, 5), ints((M, L), 900),
                     rand((M, L), 0, 50), ints((M,), 900), rand((M,), 1, 8), rand((L,), 0, 40),
                     rand((), 0, 40), f"{M}x{L}")
    zeros = torch.zeros((M_MAIN, L_MAIN), device=dev)
    check_routes(ints((M_MAIN, L_MAIN), 3), zeros, ints((M_MAIN, L_MAIN), 2), zeros,
                 ints((M_MAIN,), 900), rand((M_MAIN,), 1, 8), rand((L_MAIN,), 0, 40),
                 rand((), 0, 40), f"{M_MAIN}x{L_MAIN} tie-heavy rc")
    # the lane axis (the WAN fleet's form): W2's F16 x M4096 x L512, W1's
    # F64 x M5 x L10 with one V a lane, a ragged one; F = 1 against the
    # [M, L] call, in both modes
    for nl, M, L in ((W2_PER_KIND, M_MAIN, L_MAIN), (W1_PER_KIND, 5, 10), (3, 257, 129)):
        check_routes(ints((nl, M, L), 500), rand((nl, M, L), 0, 5), ints((nl, M, L), 900),
                     rand((nl, M, L), 0, 50), ints((nl, M), 900), rand((nl, M), 1, 8),
                     rand((nl, L), 0, 40), rand((nl,), 0, 40), f"lanes F{nl}xM{M}xL{L} (per-lane V)")
    one_args = (ints((M_MAIN, L_MAIN), 500), rand((M_MAIN, L_MAIN), 0, 5),
                ints((M_MAIN, L_MAIN), 900), rand((M_MAIN, L_MAIN), 0, 50), ints((M_MAIN,), 900),
                rand((M_MAIN,), 1, 8), rand((L_MAIN,), 0, 40), rand((), 0, 40))
    for mode, ex in (("with extra", one_args[3]), ("without extra", None)):
        one = rs.route_scores_cuda(*one_args[:3], ex, *one_args[4:])
        lane = rs.route_scores_cuda(*(x[None] for x in one_args[:3]),
                                    None if ex is None else ex[None],
                                    *(x[None] for x in one_args[4:]))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b[0]) for a, b in zip(one, lane)):
            fail(f"route_scores {mode}: F = 1 differs from the [M, L] call")
    say(f"[3 kernels] route_scores F=1 x M{M_MAIN} x L{L_MAIN}: rc, l1, b bitwise equal to the "
        "[M, L] call, with and without extra")
    del one_args, one, lane

    variants = {
        "stop": dict(stop_at_first_unfit=True),
        "nostop": dict(stop_at_first_unfit=False),
        "literal": dict(literal_edge_budget=True),
        "sort_key": dict(stop_at_first_unfit=False, sort_key=True),
    }

    def variant_inputs(S, C, kw):
        """The variant's scores and keyword arguments (sort_key: the
        QueueLength ordering, longest queue first)."""
        kw = dict(kw)
        if kw.pop("sort_key", False):
            S = torch.where(C > 0, -C, 1.0)
            kw["sort_key"] = S
        return S, kw

    def check_fill_variant(S_v, E, C, P, kw, label):
        got = gf.greedy_fill_cuda(S_v, E, C, P, **kw)
        want = gf.greedy_fill_plain(S_v, E, C, P, **kw)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            fail(f"greedy_fill {label}: counts differ from the plain version")
        max_err["greedy_fill"] = max(max_err["greedy_fill"],
                                     float((got - want).abs().nan_to_num().max()))

    def check_fill(S, E, C, P, label):
        for vname, kw in variants.items():
            S_v, kw = variant_inputs(S, C, kw)
            check_fill_variant(S_v, E, C, P, kw, f"{label} {vname}")
        say(f"[3 kernels] greedy_fill {label}: counts bitwise equal to plain in "
            f"{', '.join(variants)}")

    B, M = N_MAIN + 1, M_MAIN
    check_fill(rand((B, M), -100, 50), rand((B, M), 0.5, 10), ints((B, M), 50),
               rand((B,), 1, 40000), f"[{B},{M}]")
    for (B, M) in ((9, 120), (3, 33), (1, 7), (4, 1), (1, 1)):
        S, E, C = rand((B, M), -200, 50), rand((B, M), 0.5, 20), ints((B, M), 100)
        P = rand((B,), 0, 500)
        check_fill(S, E, C, P, f"[{B},{M}]")
        check_fill(S, E, C, torch.zeros_like(P), f"[{B},{M}] zero budget")
        check_fill(S.abs(), E, C, P, f"[{B},{M}] non-negative scores")
        check_fill(S, E, torch.zeros_like(C), P, f"[{B},{M}] zero caps")

    # the classified walk (csrc/greedy_fill.cu): every class boundary, the
    # certificate at its edge, the largest lanes, inputs off the integers
    def walk_order(S_v, E, C, kw):
        key = kw["sort_key"] if "sort_key" in kw else S_v / E
        key = torch.where((S_v < 0) & torch.isfinite(key), key, torch.inf)
        order = torch.sort(key, dim=-1, stable=True).indices
        return E.gather(1, order), C.gather(1, order), torch.isfinite(key.gather(1, order))

    def ulp(x, d):
        return torch.nextafter(x, torch.full_like(x, d * torch.inf))

    B, M = 4096, 2
    S, E, C = rand((B, M), -100, -1), rand((B, M), 0.5, 10), ints((B, M), 50) + 2
    for vname, kw in variants.items():
        S_v, kw = variant_inputs(S, C, kw)
        e_w, c_w, _ = walk_order(S_v, E, C, kw)
        T, U = gf.fill_thresholds(e_w[:, 0], c_w[:, 0])  # the first item's, on the card
        if bool(T.isnan().any()) or not bool((T > U).all()):
            fail(f"greedy_fill boundary lanes {vname}: a first item without finite T > U")
        edges = torch.stack([T, ulp(T, -1), ulp(T, 1), U, ulp(U, -1), ulp(U, 1)])
        P = edges.gather(0, (torch.arange(B, device=dev) % 6)[None])[0]
        check_fill_variant(S_v, E, C, P, kw, f"boundary lanes [{B},{M}] {vname}")
    say(f"[3 kernels] greedy_fill boundary lanes [{B},{M}] (P0 on, one ulp below and above the "
        f"first item's T and U from fill_thresholds on the card): counts bitwise equal to plain "
        f"in {', '.join(variants)}")

    def tight_budgets(S_v, E, C, kw):
        """Each lane's least float32 budget that fill_certified passes
        (bisection on the bits), on the CPU."""
        e_w, c_w, live = (x.cpu() for x in walk_order(S_v, E, C, kw))
        T = gf.fill_thresholds(e_w, c_w)[0]

        def passes(bits):
            P0 = torch.tensor(bits, dtype=torch.int32).view(torch.float32)
            return gf.fill_certified(e_w, c_w, T, live, P0).tolist()

        lo, hi = [0] * len(e_w), [int(torch.tensor(3e38).view(torch.int32))] * len(e_w)
        while max(h - l_ for l_, h in zip(lo, hi)) > 1:
            mid = [(l_ + h) // 2 for l_, h in zip(lo, hi)]
            ok = passes(mid)
            lo = [l_ if o else m for l_, m, o in zip(lo, mid, ok)]
            hi = [m if o else h for h, m, o in zip(hi, mid, ok)]
        if not all(passes(hi)) or any(passes([h - 1 for h in hi])):
            fail("greedy_fill certificate lanes: no tight budget found")
        return torch.tensor(hi, dtype=torch.int32).view(torch.float32).to(dev)

    B, M = 2, M_MAIN
    S, E, C = rand((B, M), -100, -1), rand((B, M), 0.5, 10), ints((B, M), 50) + 1
    tight = {}
    for vname, kw in variants.items():
        S_v, kw = variant_inputs(S, C, kw)
        order = "sort_key" if "sort_key" in kw else "score/e"  # literal: the stop order
        if order not in tight:
            tight[order] = tight_budgets(S_v, E, C, kw)
        P = torch.stack([tight[order][0], ulp(tight[order][1], -1)])
        check_fill_variant(S_v, E, C, P, kw, f"certificate lanes [{B},{M}] {vname}")
    say(f"[3 kernels] greedy_fill [{B},{M}] every item negative, lane 0 at the least budget the "
        f"certificate passes (fill_certified), lane 1 one ulp short of its own (walks all {M} "
        f"items): counts bitwise equal to plain in {', '.join(variants)}")

    for M in (gf.MAX_ITEMS, gf.MAX_ITEMS - 1):
        S, E, C = rand((4, M), -100, 50), rand((4, M), 0.5, 10), ints((4, M), 50)
        cover = (C * E * (S < 0)).sum(-1)
        P = torch.stack([rand((), 1, 500), cover[1] * 1.01, cover[2] * 0.5, cover[3] * 0.99])
        check_fill(S, E, C, P, f"[4,{M}] (budgets: small, covering, half, just short)")
    try:
        gf.greedy_fill_cuda(*(torch.zeros((1, gf.MAX_ITEMS + 1), device=dev) for _ in range(3)),
                            torch.zeros(1, device=dev))
    except ValueError:
        say(f"[3 kernels] greedy_fill M={gf.MAX_ITEMS + 1}: refused (ValueError), as it must be")
    else:
        fail(f"greedy_fill M={gf.MAX_ITEMS + 1} was not refused")

    B, M = 33, 300
    S, E, C = rand((B, M), -200, 50), rand((B, M), 0.5, 20), ints((B, M), 100)
    P = rand((B,), 0, 2000)
    check_fill(S, E, rand((B, M), 0, 50), P, f"[{B},{M}] non-integer caps")
    check_fill(S, E, -C, P, f"[{B},{M}] negative caps")
    check_fill(S, E, torch.where(C > 80, torch.nan, C), P, f"[{B},{M}] NaN caps")
    check_fill(S, E, C, torch.full_like(P, torch.inf), f"[{B},{M}] inf budget")
    check_fill(S, E, C, torch.full_like(P, torch.nan), f"[{B},{M}] NaN budget")

    # the LM layers' float emulations of XLA:CPU (rope's glibc sinf/cosf
    # and FMAs, tanh, GELU): one chain of elementwise torch calls each,
    # so the card must give the CPU's bits
    for arch in registry.DENSE_ARCHS:
        cfg = registry.get_config(arch)
        rot = int(cfg.resolved_head_dim * cfg.rope_fraction)
        positions = torch.arange(32768, device=dev)
        got = lm_layers.rope_angles(positions, rot, cfg.rope_theta)
        want = lm_layers.rope_angles(positions.cpu(), rot, cfg.rope_theta)
        for part, a, b in zip(("cos", "sin"), got, want):
            if not torch.equal(a.cpu(), b):
                fail(f"rope_angles {arch} {part}: the card differs from the CPU")
        say(f"[3 numerics] rope_angles {arch} (rot {rot}, theta {cfg.rope_theta:g}) at positions "
            "0-32767: cos, sin bitwise equal on the card and the CPU")
    gc = torch.Generator().manual_seed(SEED)
    xg = torch.cat([torch.linspace(-12, 12, 200001), torch.randn(100000, generator=gc) * 300])
    xr = torch.randn((2, 64, 4, 128), generator=gc)
    cos, sin = lm_layers.rope_angles(torch.arange(64), 128, 1e6)
    for dt in (torch.float32, torch.bfloat16):
        x = xg.to(dt)
        if not torch.equal(lm_layers.gelu_tanh(x.to(dev)).cpu(), lm_layers.gelu_tanh(x)):
            fail(f"gelu_tanh {dt}: the card differs from the CPU")
        x = xr.to(dt)
        got = lm_layers.apply_rope(x.to(dev), cos.to(dev), sin.to(dev), 1.0)
        if not torch.equal(got.cpu(), lm_layers.apply_rope(x, cos, sin, 1.0)):
            fail(f"apply_rope {dt}: the card differs from the CPU")
    say("[3 numerics] gelu_tanh (XLA's tanh) and apply_rope (FMAs) in float32 and bfloat16: "
        "bitwise equal on the card and the CPU")

    # ---- 3e. threefry_draw vs its plain version, and JAX's answers --------
    clock.start("3e")
    t0 = time.perf_counter()
    draw_keys = {
        "PRNGKey(0)": jr.PRNGKey(0, device=dev),
        "PRNGKey(-1)": jr.PRNGKey(-1, device=dev),
        "PRNGKey(2**31-1)": jr.PRNGKey(2**31 - 1, device=dev),
        "split(PRNGKey(0), 512)": jr.split(jr.PRNGKey(0, device=dev), FLEET_A_LANES),
        "split(PRNGKey(7), 16)": jr.split(jr.PRNGKey(7, device=dev), 16),
    }
    finishes = [("bits", {})] + [
        ("uniform", dict(minval=lo, maxval=hi))
        for lo, hi in ((0.0, 1.0), (jr.NORMAL_LO, 1.0), (-3.5, 7.25))] + [
        ("randint", dict(minval=0, maxval=span)) for span in (1, 2, 401, 701, 2**31 - 1)] + [
        ("randint_f32", dict(minval=0, maxval=401)),
        ("randint_f32", dict(minval=0, maxval=701, seg=1)),   # RandomCarbonSource's split
        ("uniform", dict(seg="half")),                        # RandomPolicy's split
        ("uniform", dict(minval=jr.NORMAL_LO, maxval=1.0, fold_each=True)),  # the UK noise
        ("floor", dict(scale="amax")),                        # the fleet's arrivals
        ("uniform", dict(chain=(64, 1))),                     # poisson's Knuth walk
        ("uniform", dict(chain=(24, 2))),                     # its rejection walk
        ("bits", dict(chain=(3, 2))),
    ]
    n_draws = 0
    for kname, keys in draw_keys.items():
        shapes = (1, 5, M_MAIN) if keys.dim() == 1 else ((5,) if keys.shape[0] > 16 else (M_MAIN,))
        for n in shapes:
            amax = rand(tuple(keys.shape[:-1]) + (n,), 0, 4000).floor()
            for t in (None, 0, 1, 191, 1999, 2**31 - 1):
                for finish, kw in finishes:
                    if "chain" in kw and t not in (None, 191, 2**31 - 1):
                        continue  # the long walks at three slots: the plain walk is slow
                    kw = dict(kw)
                    if kw.get("seg") == "half":
                        kw["seg"] = n // 2
                    if kw.get("scale") == "amax":
                        kw["scale"] = amax + 1.0
                    got = tfk.threefry_draw_cuda(keys, t, n, finish=finish, **kw)
                    want = tfk.threefry_draw_plain(keys, t, n, finish=finish, **kw)
                    torch.cuda.synchronize()
                    ok = (same_bits(got, want) if got.dtype == torch.float32
                          else torch.equal(got, want))
                    if not ok:
                        fail(f"threefry_draw {kname} t={t} n={n} {finish} {kw}: differs from "
                             "the plain version")
                    n_draws += 1
    for (seed, t), want in THREEFRY_KNOWN.items():
        k = jr.PRNGKey(seed, device=dev)
        bits = tfk.threefry_draw_cuda(k, t, 3, finish="bits").tolist()
        u = tfk.threefry_draw_cuda(k, t, 3, finish="uniform").view(torch.int32).cpu().numpy()
        r = tfk.threefry_draw_cuda(k, t, 3, finish="randint", minval=0, maxval=401).tolist()
        Ce, Cc = core.RandomCarbonSource(N=5)(t, k, dev)
        got = tuple(bits + [int(x) for x in u.view(np.uint32)] + r
                    + [int(Ce)] + [int(x) for x in Cc.tolist()])
        if got != want:
            fail(f"threefry_draw PRNGKey({seed}) t={t}: {got} is not jax 0.9.0's {want}")
    for (seed, t), want in CHAIN_KNOWN.items():
        k = jr.PRNGKey(seed, device=dev)
        walks = (tfk.threefry_draw_cuda(k, t, 2, chain=(3, 1)),
                 tfk.threefry_draw_cuda(k, t, 2, chain=(2, 2)))
        got = tuple(int(x) for w in walks
                    for x in w.reshape(-1).view(torch.int32).cpu().numpy().view(np.uint32))
        if got != want:
            fail(f"threefry_draw chain PRNGKey({seed}) t={t}: {got} is not jax 0.9.0's {want}")
    # the redesign's surface: every walk x finish over slot ranges (the
    # block draws of the slot loops), each kernel row also equal to the
    # kernel's own single-slot draw; jax 0.9.0's normal answers
    walk_kw = {"table": {}, "seg": dict(seg="half"), "paths": dict(paths="three"),
               "fold_each": dict(fold_each=True), "chain": dict(chain=(3, 2))}
    fin_kw = {"bits": {}, "uniform": dict(minval=-3.5, maxval=7.25), "floor": dict(scale="amax"),
              "randint": dict(minval=0, maxval=701), "randint_f32": dict(minval=0, maxval=401),
              "normal": {}}
    range_cases = (("PRNGKey(-1)", 1030), ("PRNGKey(0)", 257), ("split(PRNGKey(7), 16)", M_MAIN),
                   ("split(PRNGKey(0), 512)", 5))

    def same_draw(a, b):
        return same_bits(a, b) if a.dtype == torch.float32 else torch.equal(a, b)

    n_range = 0
    for kname, n in range_cases:
        keys = draw_keys[kname]
        amax = rand(tuple(keys.shape[:-1]) + (n,), 0, 4000).floor()
        for (t, count), (wname, wkw), (finish, fkw) in itertools.product(
                ((None, None), (0, 1), (191, T_MAIN), (2**32 - 3, 5)), walk_kw.items(),
                fin_kw.items()):
            kw = dict(wkw, **fkw)
            if kw.get("seg") == "half":
                kw["seg"] = n // 2
            if kw.get("paths") == "three":
                kw["paths"] = (((2, 0, 7), n // 3), ((1,), 1), ((), n - n // 3 - 1))
            if kw.get("scale") == "amax":
                kw["scale"] = amax + 1.0
            got = tfk.threefry_draw_cuda(keys, t, n, finish=finish, count=count, **kw)
            want = tfk.threefry_draw_plain(keys, t, n, finish=finish, count=count, **kw)
            if not same_draw(got, want):
                fail(f"threefry_draw {kname} n={n} t={t} count={count} {wname} {finish}: "
                     "differs from the plain version")
            if count == T_MAIN:
                for i in (0, count - 1):
                    one = tfk.threefry_draw_cuda(keys, t + i, n, finish=finish, **kw)
                    if not same_draw(got[i], one):
                        fail(f"threefry_draw {kname} n={n} slots {t}..: row {i} is not the "
                             f"draw at slot {t + i} ({wname} {finish})")
            n_range += 1
            del got, want
    for (seed, t), want in NORMAL_KNOWN.items():
        got = tfk.threefry_draw_cuda(jr.PRNGKey(seed, device=dev), t, len(want), finish="normal")
        if tuple(int(x) for x in got.view(torch.int32).cpu().numpy().view(np.uint32)) != want:
            fail(f"threefry_draw normal PRNGKey({seed}) t={t}: not jax 0.9.0's {want}")
    say(f"[3e kernels] threefry_draw over slot ranges: {n_range} draws bitwise equal to the "
        f"plain version (every walk: table, seg, paths, fold_each, chain 3 x 2; every finish: "
        f"bits, uniform, floor, randint, randint_f32, normal; slots none, 0 x 1, 191 x "
        f"{T_MAIN} (rows 0 and {T_MAIN - 1} equal to single-slot draws), 2**32-3 x 5 (wraps); "
        + "; ".join(f"{k} n {n}" for k, n in range_cases)
        + f"); {len(NORMAL_KNOWN)} normal answers of jax 0.9.0 equal")
    say(f"[3e kernels] threefry_draw: {n_draws} draws bitwise equal to the plain version (keys "
        f"{', '.join(draw_keys)}; n 1, 5, {M_MAIN} a key; t none, 0, 1, 191, 1999, 2**31-1; "
        "bits, uniform [0,1) / [nextafter(-1,0),1) / [-3.5,7.25), randint spans 1, 2, 401, 701, "
        "2**31-1, RandomCarbonSource's and RandomPolicy's splits, fold_each, the fleet's floor, "
        "poisson's key walks (chain 64 x 1, 24 x 2; 3 x 2 bits) at t none, 191, 2**31-1); "
        f"{len(THREEFRY_KNOWN)} known answers and {len(CHAIN_KNOWN)} key walks of jax 0.9.0 "
        "equal; "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 3f. knapsack_dp vs its plain version on the card --------------
    clock.start("3f")
    # ExactDPPPolicy's DP (src/repro/core/knapsack.py:75, a jnp scan):
    # random instances at grids 16 to 1024 (scores rounded to integers in
    # every third: ties in the best row), the edges and the crafted cases
    # of the CPU tests, a fleet-A-shaped launch (512 lanes x (1 + N)
    # knapsacks of M5, grid 512, from the policy's own score pass on
    # random queues) and one slot at the main width (M4096 x N256, grid
    # 512, from the main instance's backlog), whose plain check covers the
    # edge knapsack and the first cloud's (the plain version's count table
    # over M4096 is the slow part); counts bitwise
    t0 = time.perf_counter()
    max_err["knapsack_dp"] = 0.0
    n_kp = [0, 0]  # knapsacks checked, launches

    def check_knapsacks(args, grid, label, rows=None):
        got = kpk.knapsack_dp_cuda(*args, grid)
        sub = args if rows is None else tuple(x[rows] for x in args)
        want = kpk.knapsack_dp_plain(*sub, grid)
        torch.cuda.synchronize()
        if not torch.equal(got if rows is None else got[rows], want):
            bad = (got if rows is None else got[rows]) != want
            k = int(bad.any(-1).nonzero()[0])
            fail(f"knapsack_dp {label} grid {grid}: knapsack {k} differs from the plain version")
        n_kp[0] += want.shape[0]
        n_kp[1] += 1
        return got

    for i, grid in enumerate(itertools.islice(itertools.cycle(KP_GRIDS), 3 * len(KP_GRIDS))):
        K, M = int(torch.randint(1, 41, (), generator=g, device=dev)), 1 + i % 16
        scores = torch.randn((K, M), generator=g, device=dev) * (100.0 if i % 2 else 1.0)
        if i % 3 == 0:
            scores = scores.round()
        check_knapsacks((scores, rand((K, M), 0.05, 30), ints((K, M), 3000), rand((K,), 1, 500)),
                        grid, f"random K{K} M{M}")
    edges = torch.tensor(KP_EDGES, dtype=torch.float32, device=dev)  # [cases, 4, 3]
    edge_args = (edges[:, 0], edges[:, 1], edges[:, 2], edges[:, 3, 0].contiguous())
    for grid in (16, 1024):
        check_knapsacks(tuple(x.contiguous() for x in edge_args), grid, "edges")
    for label, (args, grid, want) in KP_CRAFTED.items():
        got = check_knapsacks(tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                                    for x in args), grid, label)
        if got.tolist() != want:
            fail(f"knapsack_dp {label}: {got.tolist()} is not JAX's {want}")
    # fleet A's shape: the policy's stacked rows on random queues
    fa_spec = fleet_scenarios.build_fleet(["diurnal"], per_kind=FLEET_A_LANES, Tc=96, seed=SEED,
                                          device=dev).to(dev)
    fa_pe, fa_pc, fa_Pe, fa_Pc = fa_spec.spec
    fa_Qe, fa_Qc = ints(tuple(fa_pe.shape), 1000), ints(tuple(fa_pc.shape), 1000)
    fa_V = torch.full((), V_PAPER, device=dev)
    fc_, fn1, fb = cs.carbon_scores_cuda(fa_Qc, fa_pc, fa_Qe, fa_pe, fa_V * fa_spec.carbon[:, 0, 1:],
                                         fa_V * fa_spec.carbon[:, 0, 0])

    def stacked(first, rest):
        return torch.cat([first[..., None, :], rest], dim=-2).reshape(-1, first.shape[-1])

    kp_fleet_args = (stacked(fb, fc_.transpose(-1, -2)), stacked(fa_pe, fa_pc.transpose(-1, -2)),
                     stacked(fa_Qe, fa_Qc.transpose(-1, -2)),
                     torch.cat([fa_Pe[:, None], fa_Pc], dim=-1).reshape(-1).contiguous())
    check_knapsacks(kp_fleet_args, KP_GRID, f"fleet A F{FLEET_A_LANES} x (1 + N5) x M5")
    # the main width: the main instance's backlog and spec, the table's
    # first row (the same inputs phase 7 times)
    kp_inst = main_instance(convert, carbon, core.UniformArrivals, dev)
    kp_state, kp_spec = kp_inst["state0"](dev), kp_inst["spec"](dev)
    k_pe, k_pc, k_Pe, k_Pc = kp_spec.as_arrays(dev)
    kCe, kCc = kp_inst["carbon"](0, 0, dev)
    kc, _, kb = cs.carbon_scores_cuda(kp_state.Qc, k_pc, kp_state.Qe, k_pe, fa_V * kCc, fa_V * kCe)
    kp_main_args = (stacked(kb, kc.T), stacked(k_pe, k_pc.T), stacked(kp_state.Qe, kp_state.Qc.T),
                    torch.cat([k_Pe.reshape(1), k_Pc]).contiguous())
    # the main width: the plain version holds the edge's knapsack and the
    # first cloud's (its count table over M4096 is the slow part) in every
    # launch that has them: the slot's 257, and the launches of 1, 6 and
    # 3,072 of its rows, which pick other group sizes (the 3,072 repeat the
    # 257); their other knapsacks are held to the slot's launch
    t1 = time.perf_counter()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    instances = kpk.kernel_instances()
    K_main = kp_main_args[0].shape[0]
    kp_main_out = check_knapsacks(kp_main_args, KP_GRID, f"main M{M_MAIN} x (1 + N{N_MAIN})",
                                  rows=slice(0, 2))
    n_same = [0, 0]  # knapsacks held to the slot's launch, launches
    plans = {}
    for K in (1, 6, 3 * 1024):
        plans[K] = kpk.group_plan(K, KP_GRID, sms, instances)
        check_knapsacks(tuple(x[:K].contiguous() for x in kp_fleet_args), KP_GRID,
                        f"fleet A rows K{K} {plans[K]}")
        idx = torch.arange(K, device=dev) % K_main
        got = kpk.knapsack_dp_cuda(*(x[idx].contiguous() for x in kp_main_args), KP_GRID)
        torch.cuda.synchronize()
        n = min(K, 2)
        if not torch.equal(got[:n], kp_main_out[:n]):
            fail(f"knapsack_dp main rows K{K} {plans[K]}: the first {n} differ from the plain "
                 "version")
        n_kp[0] += n
        n_kp[1] += 1
        if K > 2:
            if not torch.equal(got[2:], kp_main_out[idx[2:]]):
                k = 2 + int((got[2:] != kp_main_out[idx[2:]]).any(-1).nonzero()[0])
                fail(f"knapsack_dp main rows K{K} {plans[K]}: knapsack {k} differs from the "
                     "slot's launch")
            n_same[0] += K - 2
            n_same[1] += 1
    plans[K_main] = kpk.group_plan(K_main, KP_GRID, sms, instances)
    say(f"[3f kernels] knapsack_dp at the main width: the edge's and first cloud's knapsacks "
        f"in the slot's {K_main} and in launches of its rows at K 1, 6 and 3,072 bitwise equal "
        f"to the plain version; the other {n_same[0]} knapsacks of the 6 and the 3,072 equal "
        f"to the slot's launch; "
        f"(group, cells a thread) at grid {KP_GRID} ({sms} SMs): "
        + ", ".join(f"K{k} {p}" for k, p in sorted(plans.items()))
        + f" (fleet A's first K rows each held to the plain version too); "
        f"{time.perf_counter() - t1:.1f} s")
    # every kernel instance (cells a thread, a warp or a group with its own
    # barrier, records in shared memory or streamed) through the inputs
    # that pick it: the first (grid, K) of KP_PLAN_GRIDS x KP_PLAN_KS whose
    # plan it is, at M5 and at the M whose records take 4 x 4096 words
    # if every step is active (streamed: past 48 KB a group; past the
    # ring's 3 chunks of about 4096 words, so through the global scratch);
    # rows from a generator of their own (g's later draws stay as they
    # were), held to the plain version on every row where the count table
    # is small, else on 6 rows across the launch's blocks
    t1 = time.perf_counter()
    gi = torch.Generator(device=dev)
    gi.manual_seed(SEED + 2)
    picks = {}
    for grid, K in itertools.product(KP_PLAN_GRIDS, KP_PLAN_KS):
        group, cpt = kpk.group_plan(K, grid, sms, instances)
        picks.setdefault((cpt, group == 32), (grid, K))
    missing = [(c, w) for c, _ in instances for w in (False, True) if (c, w) not in picks]
    if missing:
        fail(f"knapsack_dp: no input of KP_PLAN_GRIDS x KP_PLAN_KS picks the instances "
             f"(cells a thread, a warp) {missing}")
    reached = []
    for (cpt, warp), (grid, K) in sorted(picks.items()):
        ns, W = kpk.n_splits(grid), (grid + 32) // 32
        for M in (5, -(-4 * 4096 // (ns * W))):
            budget = torch.rand((K,), generator=gi, device=dev) * 499 + 1
            scores = -(torch.rand((K, M), generator=gi, device=dev) * 9.9 + 0.1)
            if len(reached) % 3 == 0:
                scores = scores.round()  # ties in the best row
            weights = (budget / grid)[:, None] * (torch.rand((K, M), generator=gi, device=dev)
                                                  * 2.7 + 0.3)
            caps = torch.randint(0, 2 * grid, (K, M), generator=gi, device=dev).float()
            group, _, words, _ = kpk.kernel_plan(K, M, grid, dev)
            if bool(words) != (M > 5):
                fail(f"knapsack_dp grid {grid} K{K} M{M}: records streamed={bool(words)}")
            rows = (None if K * (grid + 1) * M <= 2 ** 24 else
                    sorted({0, 1, K // 3, K // 2, K - 2, K - 1}))
            check_knapsacks((scores, weights, caps, budget), grid,
                            f"instance ({cpt} cells, group {group}) K{K} M{M}",
                            rows=None if rows is None else torch.tensor(rows, device=dev))
            reached.append(f"({cpt}, {group}{', streamed' if words else ''}) grid {grid} K{K} "
                           f"M{M}{'' if rows is None else f' ({len(rows)} rows)'}")
    say(f"[3f kernels] knapsack_dp: each of the {2 * len(picks)} instances (cells a thread, "
        f"group; records in shared memory or streamed) launched by the inputs that pick it and "
        f"held to the plain version: {'; '.join(reached)}; {time.perf_counter() - t1:.1f} s")
    # past the staged types and past grid 4096 (the grid limit L4 before),
    # drawn from a generator of their own (g's later draws stay as they were)
    t1 = time.perf_counter()
    K, M, wide = KP_WIDE
    gw = torch.Generator(device=dev)
    gw.manual_seed(SEED + 1)

    def wide_rand(shape, lo, hi):
        return torch.rand(shape, generator=gw, device=dev) * (hi - lo) + lo

    for grid in wide:
        wargs = (-wide_rand((K, M), 0.1, 10), wide_rand((K, M), 0.05, 30),
                 torch.randint(0, 3000, (K, M), generator=gw, device=dev).float(),
                 wide_rand((K,), 1, 500))
        check_knapsacks(wargs, grid, f"wide K{K} M{M}")
    say(f"[3f kernels] knapsack_dp K{K} x M{M} (past the 64 staged types) at grids "
        f"{', '.join(map(str, wide))} (the kernel's limit {kpk.MAX_GRID}; records streamed) "
        f"bitwise the plain version; {time.perf_counter() - t1:.1f} s")
    say(f"[3f kernels] knapsack_dp: {n_kp[0]} knapsacks in {n_kp[1]} launches bitwise equal to "
        f"the plain version (grids {', '.join(map(str, KP_GRIDS))}: random K 1-40 x M 1-16, "
        f"integral scores (ties) in every third; {len(KP_EDGES)} edge cases at grids 16 and "
        f"1024: positives, caps past 2**n_splits - 1, items wider than the grid, equal items "
        f"and values, weights 0 and 1e-12 with caps past int32, NaN scores and caps, budgets "
        f"0, -3, NaN, inf; the crafted cases {', '.join(KP_CRAFTED)} equal to jax 0.9.0's "
        f"counts; fleet A's F{FLEET_A_LANES} x 6 x M5 launch and its first 1, 6 and 3,072 "
        f"rows; the main width's edge and first cloud in 4 launches; every kernel instance; "
        f"KP_WIDE); "
        f"{n_same[0]} more knapsacks in {n_same[1]} launches equal to the main slot's launch; "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 3c. attention kernels vs plain versions on the card ---------
    clock.start("3c")
    max_err["flash_attention"] = max_err["flash_decode"] = 0.0

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    def attn_held(kname, got, want, label):
        torch.cuda.synchronize()
        atol, rtol = ATTN_TOL[want.dtype]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if not bool((diff <= atol + rtol * want.float().abs()).all()):
            fail(f"{kname} {label}: max abs err {err:.3e} beyond {atol:g} + {rtol:g}*|plain|")
        max_err[kname] = max(max_err[kname], err)
        say(f"[3c kernels] {kname} {label}: max abs err {err:.3e} vs plain (tolerance {atol:g} + "
            f"{rtol:g}*|plain|)")

    bf16, f32 = torch.bfloat16, torch.float32
    attn_cases = [  # B, H, K, Sq, Skv, hd, dtype, mask, prefix_len
        (LM_BATCH, 32, 2, LM_PROMPT, LM_PROMPT, 128, bf16, "causal", 0),
        (LM_BATCH, 32, 2, LM_PROMPT, LM_PROMPT, 128, bf16, "prefix", 1000),
        (LM_BATCH, 32, 2, LM_PROMPT, LM_PROMPT, 128, bf16, "full", 0),
        (2, 8, 8, 1024, 1024, 128, bf16, "causal", 0),    # MHA
        (2, 16, 1, 1024, 1024, 64, bf16, "causal", 0),    # MQA
        (1, 4, 2, 1000, 777, 128, bf16, "causal", 0),     # ragged, Sq > Skv
        (2, 8, 2, 333, 1025, 32, bf16, "full", 0),        # ragged
        (1, 4, 2, 100, 37, 16, bf16, "prefix", 20),       # ragged, hd 16
        (2, 32, 2, 1024, 1024, 128, f32, "causal", 0),
        (1, 8, 2, 513, 513, 64, f32, "prefix", 100),
        # the tensor-core route's edges: every hd with Sq, Skv off the
        # 128-row tiles, prefix off a tile edge and past Sq, Sq > Skv, one block
        (1, 4, 2, 200, 300, 16, bf16, "causal", 0),
        (1, 4, 2, 333, 250, 32, bf16, "full", 0),
        (2, 8, 2, 777, 555, 64, bf16, "causal", 0),
        (1, 8, 2, 900, 1100, 128, bf16, "full", 0),
        (1, 8, 2, 1000, 1000, 128, bf16, "prefix", 333),
        (1, 8, 2, 300, 300, 64, bf16, "prefix", 500),
        (1, 4, 2, 600, 200, 128, bf16, "causal", 0),
        (1, 1, 1, 64, 64, 128, bf16, "causal", 0),
    ]
    attn_main = None
    for B, H, K, Sq, Skv, hd, dt, mode, pl in attn_cases:
        q, k, v = randn((B, H, Sq, hd), dt), randn((B, K, Skv, hd), dt), randn((B, K, Skv, hd), dt)
        attn_held("flash_attention", fa.flash_attention_cuda(q, k, v, mask_mode=mode, prefix_len=pl),
             fa.flash_attention_plain(q, k, v, mask_mode=mode, prefix_len=pl),
             f"B{B} H{H} K{K} Sq{Sq} Skv{Skv} hd{hd} {str(dt)[6:]} {mode}"
             + (f" prefix_len {pl}" if mode == "prefix" else ""))
        if attn_main is None:
            attn_main = (q, k, v)
    # the model's [B,S,H,hd] projections, passed transposed (strided)
    q, k, v = randn((2, 300, 32, 128), bf16), randn((2, 300, 2, 128), bf16), randn((2, 300, 2, 128), bf16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    attn_held("flash_attention", fa.flash_attention_cuda(qt, kt, vt), fa.flash_attention_plain(qt, kt, vt),
         "B2 H32 K2 S300 hd128 bf16 causal, strided [B,S,H,hd] views")
    q, k, v = randn((2, 437, 16, 64), bf16), randn((2, 437, 4, 64), bf16), randn((2, 437, 4, 64), bf16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    attn_held("flash_attention", fa.flash_attention_cuda(qt, kt, vt), fa.flash_attention_plain(qt, kt, vt),
         "B2 H16 K4 S437 hd64 bf16 causal, strided [B,S,H,hd] views")
    # SeamlessM4T's heads (phase 12), hd 64 MHA (H 16 on K 16), in bf16
    # and f32: the encoder (S 4096, full mask), the decode step's
    # cross-attention (ONE query row against the 4,096 source positions:
    # 127 of the tensor-core block's 128 rows out of bounds), one-block
    # cases of 1, 2, 63 and 65 query rows against 1,000 and 4,095 keys,
    # the teacher-forced decoder's cross-attention (64 queries) and its
    # causal self-attention, causal at G 1 off the 128-row tiles, and the
    # model's strided [B,S,H,hd] layouts of the encoder and the cross step
    Ec = registry.get_config(ENCDEC_ARCH)
    He, Ke, hde, Se = Ec.n_heads, Ec.n_kv_heads, Ec.resolved_head_dim, Ec.source_len
    encdec_cases = [(B, He, Ke, Sq, Skv, hde, dt, mode, 0) for dt in (bf16, f32)
                    for B, Sq, Skv, mode in (
                        (LM_BATCH, Se, Se, "full"), (LM_BATCH, 1, Se, "full"),
                        (2, 1, 1000, "full"), (2, 2, 1000, "full"), (2, 63, 1000, "full"),
                        (2, 65, 1000, "full"), (2, 1, Se - 1, "full"), (2, 2, Se - 1, "full"),
                        (2, 63, Se - 1, "full"), (2, 65, Se - 1, "full"),
                        (LM_BATCH, LM_GEN, Se, "full"), (LM_BATCH, LM_GEN, LM_GEN, "causal"),
                        (2, 1000, 1000, "causal"), (2, 1, 1, "causal"))]
    for B, H, K, Sq, Skv, hd, dt, mode, pl in encdec_cases:
        q, k, v = randn((B, H, Sq, hd), dt), randn((B, K, Skv, hd), dt), randn((B, K, Skv, hd), dt)
        attn_held("flash_attention", fa.flash_attention_cuda(q, k, v, mask_mode=mode),
                  fa.flash_attention_plain(q, k, v, mask_mode=mode),
                  f"B{B} H{H} K{K} Sq{Sq} Skv{Skv} hd{hd} {str(dt)[6:]} {mode} (SeamlessM4T)")
    for Sq in (Se, 1):
        for dt in (bf16, f32):
            q = randn((LM_BATCH, Sq, He, hde), dt).transpose(1, 2)
            k, v = (randn((LM_BATCH, Se, Ke, hde), dt).transpose(1, 2) for _ in range(2))
            attn_held("flash_attention", fa.flash_attention_cuda(q, k, v, mask_mode="full"),
                      fa.flash_attention_plain(q, k, v, mask_mode="full"),
                      f"B{LM_BATCH} H{He} K{Ke} Sq{Sq} Skv{Se} hd{hde} {str(dt)[6:]} full, strided "
                      "[B,S,H,hd] views (SeamlessM4T)")
    # PaliGemma's heads, hd 256 (attention_tc<256>: two consumer
    # warpgroups over 128-row blocks and 80-key tiles; attention_f32<256>),
    # MQA H 8 on K 1: every mask, the prefix edge far past a tile, Sq
    # against a longer Skv, causal Sq > Skv, and the tensor-core
    # instance's edges: Sq either side of a 128-row block (and the lower
    # warpgroup's rows alone in the last block), the prefix edge either
    # side of an 80-key tile and of a block, in both dtypes
    hd256_cases = [(2, 8, 1, Sq, Skv, 256, dt, mode, pl) for dt in (bf16, f32)
                   for Sq, Skv, mode, pl in (
                       (256, 256, "causal", 0), (1000, 1000, "causal", 0),
                       (LM_PROMPT, LM_PROMPT, "causal", 0),
                       (1000, 1000, "prefix", 1), (1000, 1000, "prefix", 255),
                       (1000, 1000, "prefix", 256), (1000, 1000, "prefix", 257),
                       (1000, 1000, "prefix", 1000), (LM_PROMPT, LM_PROMPT, "prefix", 256),
                       (LM_PROMPT, LM_PROMPT, "prefix", 1000), (1000, 1000, "full", 0),
                       (LM_PROMPT, LM_PROMPT, "full", 0), (128, 1000, "full", 0),
                       (600, 200, "causal", 0),
                       (127, 127, "causal", 0), (128, 128, "causal", 0), (129, 129, "causal", 0),
                       (255, 255, "causal", 0), (257, 257, "causal", 0),
                       (500, 500, "prefix", 79), (500, 500, "prefix", 80),
                       (500, 500, "prefix", 81), (500, 500, "prefix", 159),
                       (500, 500, "prefix", 160), (500, 500, "prefix", 161),
                       (500, 500, "prefix", 127), (500, 500, "prefix", 129),
                       (129, 400, "prefix", 300))]
    for B, H, K, Sq, Skv, hd, dt, mode, pl in hd256_cases:
        q, k, v = randn((B, H, Sq, hd), dt), randn((B, K, Skv, hd), dt), randn((B, K, Skv, hd), dt)
        attn_held("flash_attention", fa.flash_attention_cuda(q, k, v, mask_mode=mode, prefix_len=pl),
                  fa.flash_attention_plain(q, k, v, mask_mode=mode, prefix_len=pl),
                  f"B{B} H{H} K{K} Sq{Sq} Skv{Skv} hd{hd} {str(dt)[6:]} {mode}"
                  + (f" prefix_len {pl}" if mode == "prefix" else ""))
    q, k, v = randn((2, 300, 8, 256), bf16), randn((2, 300, 1, 256), bf16), randn((2, 300, 1, 256), bf16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    attn_held("flash_attention",
              fa.flash_attention_cuda(qt, kt, vt, mask_mode="prefix", prefix_len=256),
              fa.flash_attention_plain(qt, kt, vt, mask_mode="prefix", prefix_len=256),
              "B2 H8 K1 S300 hd256 bf16 prefix_len 256, strided [B,S,H,hd] views")
    del q, k, v, qt, kt, vt

    decode_cases = [(LM_BATCH, 32, 2, LM_CACHE, 128, bf16, pos)
                    for pos in (0, 511, 512, 4095, LM_CACHE - 1)]
    decode_cases += [(LM_BATCH, 32, 32, LM_CACHE, 128, bf16, LM_CACHE - 1),  # G = 1
                     (LM_BATCH, 32, 2, LM_CACHE, 128, f32, LM_CACHE - 1),
                     (2, 8, 2, 1000, 64, f32, 255)]
    # the tensor-core route's edges: G 8 and 32 (two row tiles), hd 16,
    # 32, 64, S off the 128-key tile, pos at a tile edge and at the edge of
    # the first split (528 positions at GLM-4-9B's B*K), B = 1 (many splits)
    decode_cases += [(LM_BATCH, 32, 4, LM_CACHE, 128, bf16, LM_CACHE - 1),
                     (2, 64, 2, 1000, 128, bf16, 999),
                     (2, 8, 2, 777, 16, bf16, 700), (2, 8, 2, 777, 32, bf16, 776),
                     (2, 16, 2, 1500, 64, bf16, 1499),
                     (LM_BATCH, 32, 2, LM_CACHE, 128, bf16, 127),
                     (LM_BATCH, 32, 2, LM_CACHE, 128, bf16, 128),
                     (LM_BATCH, 32, 2, LM_CACHE, 128, bf16, 527),
                     (LM_BATCH, 32, 2, LM_CACHE, 128, bf16, 528),
                     (1, 32, 2, LM_CACHE, 128, bf16, LM_CACHE - 1),
                     (1, 32, 2, LM_CACHE, 128, bf16, 300)]
    # PaliGemma's decode, hd 256 (decode_tc<256>: 8 warps, 64-key tiles,
    # 272-position splits at B 8; decode_f32<256>): G 8 on K 1 at pos on
    # either side of a tile and of a split and at the serving cache's
    # end, G 1 and 32, B 1
    decode_cases += [(LM_BATCH, 8, 1, LM_CACHE, 256, bf16, pos)
                     for pos in (0, 63, 64, 127, 128, 271, 272, 4095, LM_CACHE - 1)]
    decode_cases += [(LM_BATCH, 8, 8, LM_CACHE, 256, bf16, LM_CACHE - 1),   # G 1
                     (LM_BATCH, 32, 1, LM_CACHE, 256, bf16, LM_CACHE - 1),  # G 32
                     (1, 8, 1, LM_CACHE, 256, bf16, LM_CACHE - 1), (1, 8, 1, LM_CACHE, 256, bf16, 300),
                     (LM_BATCH, 8, 1, LM_CACHE, 256, f32, LM_CACHE - 1),
                     (LM_BATCH, 8, 1, LM_CACHE, 256, f32, 63), (2, 32, 1, 1000, 256, f32, 999)]
    # SeamlessM4T's decode step (phase 12): hd 64, G 1 (H 16 on K 16) over
    # the self cache of LM_CACHE positions at its first steps' pos
    decode_cases += [(LM_BATCH, He, Ke, LM_CACHE, hde, dt, pos) for dt in (bf16, f32)
                     for pos in (0, 1, LM_GEN - 1)]
    for B, H, K, S, hd, dt, pos in decode_cases:
        q, k, v = randn((B, H, hd), dt), randn((B, S, K, hd), dt), randn((B, S, K, hd), dt)
        p = torch.full((1,), pos, dtype=torch.int32, device=dev)
        attn_held("flash_decode", fd.flash_decode_cuda(q, k, v, p), fd.flash_decode_plain(q, k, v, p),
             f"B{B} H{H} K{K} S{S} hd{hd} {str(dt)[6:]} pos {pos}")
    del q, k, v
    # the profiler names the hd 256 tensor-core instances on bf16 inputs
    q, k, v = (randn((2, 8, 1000, 256), bf16), randn((2, 1, 1000, 256), bf16),
               randn((2, 1, 1000, 256), bf16))
    qd, kd, vd = randn((2, 8, 256), bf16), randn((2, 1000, 1, 256), bf16), randn((2, 1000, 1, 256), bf16)
    pd = torch.full((1,), 999, dtype=torch.int32, device=dev)
    prof, _ = profile_slots(lambda: (fa.flash_attention_cuda(q, k, v, mask_mode="prefix",
                                                             prefix_len=256),
                                     fd.flash_decode_cuda(qd, kd, vd, pd)), slots=1)
    names = sorted(n for n in (prof or {}) if "attention" in n or "decode" in n)
    if prof is not None and not (any("attention_tc<256>" in n for n in names)
                                 and any("decode_tc<256>" in n for n in names)):
        fail(f"3c: at hd 256 the attention kernels ran {names}, not attention_tc<256> and "
             "decode_tc<256>")
    say("[3c kernels] hd 256 bf16: the profiler's kernels "
        + (", ".join(n[:60] for n in names) if prof is not None else "not measured"))
    del q, k, v, qd, kd, vd

    attention_bwd_cases(fa, randn, max_err)

    # ---- 3d. ssd_chunk_intra vs its plain version on the card -----------
    clock.start("3d")
    max_err["ssd_chunk_intra"] = 0.0

    def ssd_inputs(B, nc, l, H, P, N, decays):
        """Seeded inputs: decays "strong" a = -softplus(N(0,1))
        (tests/test_kernels.py's), "weak" 0.01 x that (the whole triangle
        and S_c from position 0 carry weight), "init" a = dt * A with the
        repo's init (A = -U(1,16), dt = softplus(N(0,1)))."""
        sp = F.softplus(torch.randn((B, nc, l, H), generator=g, device=dev))
        if decays == "strong":
            a = -sp
        elif decays == "weak":
            a = -0.01 * sp
        else:
            a = sp * -(torch.rand((H,), generator=g, device=dev) * 15.0 + 1.0)
        return (a.contiguous(), torch.randn((B, nc, l, H, P), generator=g, device=dev),
                torch.randn((B, nc, l, N), generator=g, device=dev),
                torch.randn((B, nc, l, N), generator=g, device=dev))

    ssd_cases = [  # B, nc, l, H, P, N, decays
        (LM_BATCH, 16, 256, 64, 64, 128, "strong"),  # mamba2-1.3B's prefill shape
        (LM_BATCH, 16, 256, 64, 64, 128, "weak"),
        (LM_BATCH, 16, 256, 64, 64, 128, "init"),
        (LM_BATCH, 1, 100, 64, 64, 128, "weak"),     # chunk = min(256, S) at S = 100
        (LM_BATCH, 1, 100, 64, 64, 128, "init"),
        (2, 3, 256, 12, 64, 128, "weak"),            # H not a multiple of the 8-head group
        (1, 1, 256, 64, 64, 128, "weak"),            # B = 1, nc = 1
        (2, 3, 32, 16, 8, 16, "strong"),             # tests/test_kernels.py's sweep shape
        (1, 2, 17, 5, 33, 40, "weak"),               # ragged everything
        (1, 1, 1, 3, 16, 8, "init"),                 # l = 1
        # the tile edges of the kernel: 64-row y tiles (l 64, 65, 128), a
        # ragged last 16- and 32-position step (l 255), 128-state S_c
        # passes (N 8, 136), 16-column x blocks (P 8, 48), heads past the
        # y block's 8 warps and the S_c block's 2 heads (H 1, 3), a second
        # 32-head y block with two S_c passes (H 40, N 256)
        (2, 2, 64, 8, 64, 128, "init"),
        (2, 2, 65, 8, 64, 128, "strong"),
        (1, 3, 128, 8, 64, 128, "weak"),
        (1, 2, 255, 8, 64, 128, "init"),
        (1, 2, 256, 8, 64, 8, "weak"),
        (1, 2, 256, 8, 64, 136, "strong"),
        (1, 2, 256, 8, 8, 128, "init"),
        (1, 2, 256, 8, 48, 128, "weak"),
        (1, 2, 256, 1, 64, 128, "strong"),
        (1, 2, 256, 3, 64, 128, "init"),
        (1, 2, 256, 40, 64, 256, "init"),
        # every other head of a 26-head tensor: H 13, not a multiple of the
        # group, as a strided view (refused) and then its contiguous copy
        (1, 2, 256, 13, 64, 128, "strided"),
        # x, B and C contiguous but 4 bytes past a 16-byte boundary: the
        # kernel moves their rows 4 bytes at a time
        (1, 2, 256, 8, 64, 128, "shifted"),
    ]
    ssd_main = None
    for B, nc, l, H, P, N, decays in ssd_cases:
        if decays == "strided":
            a2, x2, Bm, Cm = ssd_inputs(B, nc, l, 2 * H, P, N, "init")
            a, x = a2[..., ::2], x2[..., ::2, :]
            try:
                sdc.ssd_chunk_intra_cuda(a, x, Bm, Cm)
                fail("ssd_chunk_intra took a strided view; the kernel reads contiguous rows")
            except ValueError:
                pass
            args = (a.contiguous(), x.contiguous(), Bm, Cm)
            del a2, x2
        elif decays == "shifted":
            a, x, Bm, Cm = ssd_inputs(B, nc, l, H, P, N, "init")
            args = (a, *(torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
                         for t in (x, Bm, Cm)))
            if not all(t.is_contiguous() and t.data_ptr() % 16 == 4 for t in args[1:]):
                fail("ssd_chunk_intra: the shifted case's inputs are not 4 bytes off 16")
        else:
            args = ssd_inputs(B, nc, l, H, P, N, decays)
        got = sdc.ssd_chunk_intra_cuda(*args)
        want = sdc.ssd_chunk_intra_plain(*args)
        a, x, Bm, Cm = args
        sum_abs = sdc.ssd_chunk_intra_plain(a, x.abs(), Bm.abs(), Cm.abs())
        torch.cuda.synchronize()
        parts = []
        for part, gv, wv, av in zip(("y_diag", "S_c", "total"), got, want, sum_abs):
            diff = (gv - wv).abs()
            err = float(diff.max())
            over_f32 = float((diff / (SSD_TOL + SSD_TOL * wv.abs())).max())
            over = float((diff / (SSD_TOL * av.clamp_min(1.0) + SSD_TOL * wv.abs())).max())
            if not (torch.isfinite(gv).all() and over <= 1.0):
                fail(f"ssd_chunk_intra B{B} nc{nc} l{l} H{H} P{P} N{N} {decays}: {part} max abs "
                     f"err {err:.3e} beyond {SSD_TOL:g} * max(1, sum|terms|) + {SSD_TOL:g}*|plain|")
            # total = exp(ci_last) has no dot product: the same prefix-sum
            # order (hazard 11) and expf give the same bits
            if part == "total" and not torch.equal(gv, wv):
                fail(f"ssd_chunk_intra B{B} nc{nc} l{l} H{H} P{P} N{N} {decays}: total differs "
                     f"from the plain version's ({err:.3e}): the prefix sums' order differs")
            max_err["ssd_chunk_intra"] = max(max_err["ssd_chunk_intra"], err)
            parts.append(f"{part} {err:.3e} ({over:.3f} of the limit; {over_f32:.3f} of "
                         f"{SSD_TOL:g} + {SSD_TOL:g}*|plain|; {int((gv != wv).sum())} of "
                         f"{gv.numel()} entries differ)")
        say(f"[3d kernels] ssd_chunk_intra B{B} nc{nc} l{l} H{H} P{P} N{N} {decays} decays: max abs "
            "err vs plain " + ", ".join(parts))
        if ssd_main is None:
            ssd_main = args
        # at the prefill shape the kernel sums in the plain version's order
        # (cuBLAS's), and phase 9's float32 gate needs those bits: 48
        # float32 layers move the logits about 3e-4 for any other (PR 17)
        if (B, nc, l, H, P, N) == (LM_BATCH, 16, 256, 64, 64, 128):
            for part, gv, wv in zip(("y_diag", "S_c"), got, want):
                if not torch.equal(gv, wv):
                    fail(f"ssd_chunk_intra B{B} nc{nc} l{l} H{H} P{P} N{N} {decays}: {part} "
                         f"differs from the plain version's in {int((gv != wv).sum())} entries")
        del args, got, want, sum_abs, a, x, Bm, Cm

    ssd_bwd_cases(sdc, ssd_inputs, randn, max_err)

    # ---- 4. main path at M4096xN256 --------------------------------
    clock.start("4")
    inst = main_instance(convert, carbon, core.UniformArrivals, dev)
    spec_d, state0_d = inst["spec"](dev), inst["state0"](dev)
    spec_h, state0_h = inst["spec"]("cpu"), inst["state0"]("cpu")
    policies = {
        "CarbonIntensity": core.CarbonIntensityPolicy(V=V_PAPER),
        "QueueLength": core.QueueLengthPolicy(),
    }

    def sim(pol, T, record, d):
        spec, state0 = (spec_d, state0_d) if d == dev else (spec_h, state0_h)
        return core.simulate(pol, spec, inst["carbon"], inst["arrivals"], T, SEED,
                             state0=state0, record=record, device=d)

    # the arrivals are the twin's UniformArrivals: one threefry_draw a run,
    # its T_MAIN slots one block
    expected = {
        "CarbonIntensity": {"carbon_scores": T_MAIN, "route_scores": 0, "greedy_fill": T_MAIN,
                            "threefry_draw": 1},
        "QueueLength": {"carbon_scores": 0, "route_scores": 0, "greedy_fill": T_MAIN,
                        "threefry_draw": 1},
    }
    main_ms, results, main_launches = drive_path("4 main", f"M{M_MAIN}xN{N_MAIN}", policies, sim,
                                                 expected, ops, dev)
    finals = {p: core.NetworkState(Qe=r.Qe[0], Qc=r.Qc[0]) for p, r in results.items()}
    profile_path("4 profile", policies, sim, main_ms, dev)
    in_turns("4 main", policies, sim, dev)
    card_vs_cpu("4 main", policies, sim, T_CPU, ("Qe", "Qc"), dev)

    # ---- 4b. WAN path at M4096xN256xL512 ----------------------------
    clock.start("4b")
    wan = wan_instance(convert, fleet_scenarios, M_MAIN, N_MAIN, T_MAIN, dev)
    wspec_d, wstate0_d = wan["spec"](dev), wan["state0"](dev)
    wspec_h, wstate0_h = wan["spec"]("cpu"), wan["state0"]("cpu")
    wgraph_d, wgraph_h = wan["graph"].to(dev), wan["graph"].to("cpu")
    wcarbon = core.TableCarbonSource(table=wan["table"]).to(dev).to("cpu")
    wan_policies = {
        "NetworkAwareDPP": net.NetworkAwareDPPPolicy(V=V_WAN),
        "StaticRoute(CarbonIntensity)": net.StaticRoutePolicy(core.CarbonIntensityPolicy(V=V_WAN)),
    }

    def wan_sim(pol, T, record, d):
        spec, state0, graph = ((wspec_d, wstate0_d, wgraph_d) if d == dev
                               else (wspec_h, wstate0_h, wgraph_h))
        return core.simulate(pol, spec, wcarbon, wan["arrivals"], T, SEED, state0=state0,
                             record=record, device=d, graph=graph)

    wan_expected = {
        "NetworkAwareDPP": {"carbon_scores": T_MAIN, "route_scores": T_MAIN,
                            "greedy_fill": T_MAIN},
        "StaticRoute(CarbonIntensity)": {"carbon_scores": T_MAIN, "route_scores": 0,
                                         "greedy_fill": T_MAIN},
    }
    wan_ms, wan_results, wan_launches = drive_path(
        "4b wan", f"M{M_MAIN}xN{N_MAIN}xL{wgraph_d.L}", wan_policies, wan_sim, wan_expected,
        ops, dev)
    wan_final = wan_results["NetworkAwareDPP"]
    profile_path("4b profile", wan_policies, wan_sim, wan_ms, dev)
    in_turns("4b wan", wan_policies, wan_sim, dev)
    card_vs_cpu("4b wan", wan_policies, wan_sim, T_WAN_CPU, ("Qe", "Qc", "Qt"), dev)

    # ---- 4c. the scenario fleet -------------------------------------
    clock.start("4c")
    t0 = time.perf_counter()
    fleet_a = fleet_scenarios.build_fleet(["diurnal"], per_kind=FLEET_A_LANES, Tc=96,
                                          seed=SEED, device=dev).to(dev)
    fleet_b_h = fleet_scenarios.build_fleet(FLEET_B_KINDS, per_kind=FLEET_B_PER_KIND, M=M_MAIN,
                                            N=N_MAIN, Tc=96, seed=SEED, device=dev)
    fleet_b = fleet_b_h.to(dev)
    F_B = fleet_b.F
    lane_bytes = sum(x[0].numel() * 4 for x in (fleet_b.spec.pc, fleet_b.carbon)) + 4 * (
        3 * M_MAIN * N_MAIN)  # pc, table, and Qc, c, the fill's rows
    say(f"[4c fleet] built fleet A (F={fleet_a.F}, M5xN5) and fleet B (F={F_B}, "
        f"M{M_MAIN}xN{N_MAIN}, {F_B * lane_bytes / 2**30:.2f} GiB of lane state) in "
        f"{time.perf_counter() - t0:.1f} s")
    ci, ql = policies["CarbonIntensity"], policies["QueueLength"]

    def fleet_run(pol, fleet):
        return lambda T, record, d=dev: core.simulate_fleet(pol, fleet, T, SEED, record=record,
                                                            device=d)

    fleet_runs = {
        "A CarbonIntensity": (fleet_run(ci, fleet_a), T_FLEET_A, fleet_a.F,
                              {"carbon_scores": 1, "greedy_fill": 1, "threefry_draw": BLOCK_DRAW}),
        "B CarbonIntensity": (fleet_run(ci, fleet_b), T_FLEET_B, F_B,
                              {"carbon_scores": 1, "greedy_fill": 1, "threefry_draw": BLOCK_DRAW}),
        "B QueueLength": (fleet_run(ql, fleet_b), T_FLEET_B, F_B,
                          {"greedy_fill": 1, "threefry_draw": BLOCK_DRAW}),
    }
    fleet_ms, fleet_results, fleet_launches = drive_fleets("4c fleet", fleet_runs, ops, dev)
    fleet_turns("4c fleet", fleet_runs)
    profile_fleets("4c profile", fleet_runs, fleet_ms)
    # fleet A: the summary scalars equal the full record's
    full_a = fleet_runs["A CarbonIntensity"][0](T_FLEET_A, "full")
    bad = same_result(full_a, fleet_results["A CarbonIntensity"],
                      ("emissions", "cum_emissions", "dispatched", "processed", "energy_edge",
                       "energy_cloud"))
    if bad or not torch.equal(full_a.Qc[:, -1], fleet_results["A CarbonIntensity"].Qc[:, 0]):
        fail(f"fleet A: summary differs from full in {bad or ['the final state']}")
    say(f"[4c fleet] A: summary scalars and final state bitwise equal to record='full'")
    del full_a
    # fleet B: lanes 0 and F-1 alone through the card's simulate
    keys_b = jr.split(jr.PRNGKey(SEED, device=dev), F_B)
    for pname, pol in (("CarbonIntensity", ci), ("QueueLength", ql)):
        res = fleet_results[f"B {pname}"]
        for f in (0, F_B - 1):
            spec_f = core.NetworkSpec(*(x[f] for x in fleet_b.spec))
            one = core.simulate(pol, spec_f, core.TableCarbonSource(table=fleet_b.carbon[f]),
                                core.FleetArrivals(amax=fleet_b.arrival_amax[f]), T_FLEET_B,
                                keys_b[f], record="summary", device=dev)
            lane = lane_of(res, f)
            bad, rel = same_result(one, lane, COUNTED), emission_rtol(one, lane)
            if bad or rel > 1e-6:
                fail(f"fleet B {pname}: lane {f} differs from its instance alone in {bad}, "
                     f"emissions rtol {rel:.3e}")
            say(f"[4c fleet] B {pname}: lane {f} bitwise equal to its instance run alone through "
                f"simulate on the card (Qe, Qc, dispatched, processed; T={T_FLEET_B}); "
                f"emissions max rel diff {rel:.3e}, identical bits: "
                f"{not same_result(one, lane, ('emissions',))}")
    # fleet B's first two lanes, card vs the CPU plain path
    t0 = time.perf_counter()
    two_h = fleet_b_h._replace(spec=core.FleetSpec(*(x[:2] for x in fleet_b_h.spec)),
                               carbon=fleet_b_h.carbon[:2], arrival_amax=fleet_b_h.arrival_amax[:2])
    for pname, pol in (("CarbonIntensity", ci), ("QueueLength", ql)):
        gpu = core.simulate_fleet(pol, two_h.to(dev), T_FLEET_CPU, SEED, device=dev)
        cpu = core.simulate_fleet(pol, two_h, T_FLEET_CPU, SEED, device="cpu")
        bad = [n for n in ("Qe", "Qc", "dispatched", "processed")
               if not torch.equal(getattr(gpu, n).cpu(), getattr(cpu, n))]
        em_g, em_c = gpu.emissions.cpu().double(), cpu.emissions.double()
        rel = float(((em_g - em_c).abs() / em_c.abs().clamp_min(1e-30)).max())
        if bad or rel > 1e-6:
            fail(f"fleet B F2 {pname}: card and CPU differ in {bad}, emissions rtol {rel:.3e}")
        say(f"[4c fleet] B F2xM{M_MAIN}xN{N_MAIN} {pname} T={T_FLEET_CPU} card vs CPU plain "
            f"path: Qe, Qc, dispatched, processed bitwise equal, emissions max rel diff "
            f"{rel:.3e} (limit 1e-6)")
    say(f"[4c fleet] card vs CPU: {time.perf_counter() - t0:.1f} s")
    del two_h
    # the kernels at the fleets' shapes, on each fleet's last-slot inputs
    # (timed here, reported in phase 7 beside the main path's times)
    fleet_times = {}
    for fname, fleet, T in (("A", fleet_a, T_FLEET_A), ("B", fleet_b, T_FLEET_B)):
        st_f = fleet_results[f"{fname} CarbonIntensity"]
        Qe_f, Qc_f = st_f.Qe[:, 0], st_f.Qc[:, 0]
        nl, M, N = Qc_f.shape
        pe_f, pc_f, Pe_f, Pc_f = fleet.spec
        row_t = fleet.carbon[:, (T - 1) % fleet.carbon.shape[1]]
        sargs = (Qc_f, pc_f, Qe_f, pe_f, V_PAPER * row_t[:, 1:], V_PAPER * row_t[:, 0])
        c_f, _, b_f = cs.carbon_scores_cuda(*sargs)
        fargs = (torch.cat([b_f[:, None], c_f.transpose(1, 2)], 1).reshape(-1, M),
                 torch.cat([pe_f[:, None], pc_f.transpose(1, 2)], 1).reshape(-1, M),
                 torch.cat([Qe_f[:, None], Qc_f.transpose(1, 2)], 1).reshape(-1, M),
                 torch.cat([Pe_f[:, None], Pc_f], 1).reshape(-1))
        keys_f = jr.split(jr.split(jr.PRNGKey(SEED, device=dev), nl), 3)[:, 1]
        scale_f = fleet.arrival_amax + 1.0
        n_neg_f = int((fargs[0] < 0).sum())
        fleet_times[fname] = dict(
            shape=f"F{nl}xM{M}xN{N}",
            scores=graph_ms(lambda: cs.carbon_scores_cuda(*sargs), reps=10, inner=20),
            scores_bytes=4 * (3 * nl * M * N + 4 * nl * M + nl * N + nl),
            fill=graph_ms(lambda: gf.greedy_fill_cuda(*fargs), reps=5, inner=5),
            fill_rows=fargs[0].shape[0], fill_neg=n_neg_f,
            fill_bytes=4 * (3 * fargs[0].numel() + n_neg_f + fargs[0].shape[0]),
            draw=draw_turns(
                lambda: tfk.threefry_draw_cuda(keys_f, 0, M, finish="floor", scale=scale_f,
                                               count=T),
                lambda: [tfk.threefry_draw_cuda(keys_f, t, M, finish="floor", scale=scale_f)
                         for t in range(T)]),
            draw_T=T, draw_n=T * nl * M, draw_ops=draw_ops(T * nl, M, 1, 1, 2),
            launches={k: v for k, v in fleet_launches[f"{fname} CarbonIntensity"].items() if v})
        ft = fleet_times[fname]
        say(f"[4c time] fleet {fname} {ft['shape']}: carbon_scores {ft['scores'][1]:.5f} ms cold "
            f"({ft['scores'][0]:.5f} warm) vs byte bound "
            f"{ft['scores_bytes'] / HBM_BYTES_PER_S * 1e3:.5f} ms; greedy_fill over "
            f"{ft['fill_rows']} rows of {M} {ft['fill'][1]:.5f} ms cold "
            f"({ft['fill'][0]:.5f} warm), "
            f"{n_neg_f} negative-score items (CUDA graph replay, CUDA events, median); "
            f"threefry_draw, the fleet's arrivals of a run ({T} slots x {nl} x {M}) in one block "
            f"draw against {T} per-slot draws, in turns, ms cold (warm): "
            f"{turns_text(ft['draw'])}; operation bound "
            f"{ft['draw_ops'] / INT32_OPS_PER_S * 1e3:.6f} ms ({smi})")
        del sargs, fargs, c_f, b_f

    # the registry fleet (the JAX bench's fleet/F96xT200): mean reduction
    t0 = time.perf_counter()
    reg = fleet_scenarios.build_fleet(per_kind=REGISTRY_PER_KIND, Tc=96, seed=SEED,
                                      device=dev).to(dev)
    finals_reg = {p: core.simulate_fleet(pol, reg, T_REGISTRY, SEED, record="summary",
                                         device=dev).cum_emissions[:, -1].double()
                  for p, pol in (("CarbonIntensity", ci), ("QueueLength", ql))}
    ratio = finals_reg["CarbonIntensity"] / finals_reg["QueueLength"]
    reg_red = 100.0 * float(1.0 - ratio.mean())
    say(f"[4c fleet] registry fleet F={reg.F}xT{T_REGISTRY} (6 kinds x {REGISTRY_PER_KIND}): "
        f"mean emission reduction CarbonIntensity(V={V_PAPER}) vs QueueLength {reg_red:.6f}% "
        f"(JAX {REGISTRY_JAX:.6f}%); {time.perf_counter() - t0:.1f} s")
    if not abs(reg_red - REGISTRY_JAX) <= REGISTRY_TOL:
        fail(f"registry fleet reduction {reg_red:.4f}% is not within {REGISTRY_TOL} of JAX's")
    del reg

    # ---- 4d. the WAN fleet ------------------------------------------
    clock.start("4d")
    aware = wan_policies["NetworkAwareDPP"]
    blind = wan_policies["StaticRoute(CarbonIntensity)"]
    per_aware = {"carbon_scores": 1, "route_scores": 1, "greedy_fill": 1,
                 "threefry_draw": BLOCK_DRAW}
    per_blind = {"carbon_scores": 1, "greedy_fill": 1, "threefry_draw": BLOCK_DRAW}
    t0 = time.perf_counter()
    w1 = {kind: fleet_scenarios.build_network_fleet([kind], per_kind=W1_PER_KIND, Tc=96,
                                                    seed=SEED, device=dev).to(dev)
          for kind in W1_KINDS}
    say(f"[4d wan fleet] built W1 ({', '.join(w1)}: F={W1_PER_KIND} each, M5xN5, "
        f"L{w1[W1_KINDS[0]].graph.L}) in {time.perf_counter() - t0:.1f} s")
    w1_runs = {}
    for kind, fl in w1.items():
        w1_runs[f"W1 {kind} aware"] = (fleet_run(aware, fl), T_W1, fl.F, per_aware)
        w1_runs[f"W1 {kind} blind"] = (fleet_run(blind, fl), T_W1, fl.F, per_blind)
    w1_ms, w1_results, w1_launches = drive_fleets("4d wan fleet", w1_runs, ops, dev)
    fleet_turns("4d wan fleet", {k: v for k, v in w1_runs.items() if "congested" in k})
    profile_fleets("4d profile", {k: v for k, v in w1_runs.items() if "congested" in k}, w1_ms)
    # the anchor: the bench's record=T//8 runs, their reduction beside JAX's
    for kind, fl in w1.items():
        cum = {}
        for pname, pol in (("aware", aware), ("blind", blind)):
            r = core.simulate_fleet(pol, fl, T_W1, SEED, record=T_W1 // 8, device=dev)
            summ = w1_results[f"W1 {kind} {pname}"]
            if not (same_bits(r.cum_emissions, summ.cum_emissions)
                    and all(torch.equal(getattr(r, q)[:, -1], getattr(summ, q)[:, 0])
                            for q in ("Qe", "Qc", "Qt"))):
                fail(f"W1 {kind} {pname}: record={T_W1 // 8} differs from record='summary'")
            cum[pname] = r.cum_emissions[:, -1].double()
        red = 100.0 * float((1.0 - cum["aware"] / cum["blind"]).mean())
        say(f"[4d wan fleet] W1 {kind} F{fl.F} T={T_W1} record={T_W1 // 8}: mean emission "
            f"reduction NetworkAwareDPP(V={V_WAN}) vs StaticRoute(CarbonIntensity) {red:.6f}% "
            f"(JAX {WAN_JAX[kind]:.6f}%, limit {WAN_TOL[kind]:g} points); stride rows and "
            "cum emissions bitwise equal to record='summary'")
        if not abs(red - WAN_JAX[kind]) <= WAN_TOL[kind]:
            fail(f"W1 {kind}: reduction {red:.6f}% is not within {WAN_TOL[kind]} of JAX's")

    # W2: congested-uplink at the main path's width
    t0 = time.perf_counter()
    w2_h = fleet_scenarios.build_network_fleet(["congested-uplink"], per_kind=W2_PER_KIND,
                                               M=M_MAIN, N=N_MAIN, Tc=96, seed=SEED, device=dev)
    w2 = w2_h.to(dev)
    say(f"[4d wan fleet] built W2 (F={w2.F}, M{M_MAIN}xN{N_MAIN}xL{w2.graph.L}) in "
        f"{time.perf_counter() - t0:.1f} s")
    w2_runs = {"W2 aware": (fleet_run(aware, w2), T_W2, w2.F, per_aware),
               "W2 blind": (fleet_run(blind, w2), T_W2, w2.F, per_blind)}
    w2_ms, w2_results, w2_launches = drive_fleets("4d wan fleet", w2_runs, ops, dev)
    fleet_turns("4d wan fleet", w2_runs)
    profile_fleets("4d profile", w2_runs, w2_ms)
    keys_w2 = jr.split(jr.PRNGKey(SEED, device=dev), w2.F)
    for pname, pol in (("aware", aware), ("blind", blind)):
        res = w2_results[f"W2 {pname}"]
        for f in (0, w2.F - 1):
            one = core.simulate(pol, core.NetworkSpec(*(x[f] for x in w2.spec)),
                                core.TableCarbonSource(table=w2.carbon[f]),
                                core.FleetArrivals(amax=w2.arrival_amax[f]), T_W2, keys_w2[f],
                                record="summary", device=dev,
                                graph=net.LinkGraph(*(x[f] for x in w2.graph)))
            lane = lane_of(res, f)
            bad, rel = same_result(one, lane, WAN_COUNTED), emission_rtol(one, lane)
            if bad or rel > 1e-6:
                fail(f"W2 {pname}: lane {f} differs from its instance alone in {bad}, "
                     f"emissions rtol {rel:.3e}")
            say(f"[4d wan fleet] W2 {pname}: lane {f} bitwise equal to its instance run alone "
                f"through simulate(graph=) on the card ({', '.join(WAN_COUNTED)}; T={T_W2}); "
                f"emissions max rel diff {rel:.3e}, identical bits: "
                f"{not same_result(one, lane, ('emissions',))}")
    t0 = time.perf_counter()
    two_w = w2_h._replace(spec=core.FleetSpec(*(x[:2] for x in w2_h.spec)),
                          carbon=w2_h.carbon[:2], arrival_amax=w2_h.arrival_amax[:2],
                          graph=net.LinkGraph(*(x[:2] for x in w2_h.graph)))
    for pname, pol in (("aware", aware), ("blind", blind)):
        gpu = core.simulate_fleet(pol, two_w.to(dev), T_W2_CPU, SEED, device=dev)
        cpu = core.simulate_fleet(pol, two_w, T_W2_CPU, SEED, device="cpu")
        bad = [n for n in WAN_COUNTED if not torch.equal(getattr(gpu, n).cpu(), getattr(cpu, n))]
        rel = emission_rtol(gpu, cpu)
        if bad or rel > 1e-6:
            fail(f"W2 F2 {pname}: card and CPU differ in {bad}, emissions rtol {rel:.3e}")
        say(f"[4d wan fleet] W2 F2xM{M_MAIN}xN{N_MAIN}xL{w2.graph.L} {pname} T={T_W2_CPU} card vs "
            f"CPU plain path: {', '.join(WAN_COUNTED)} bitwise equal, emissions max rel diff "
            f"{rel:.3e} (limit 1e-6)")
    say(f"[4d wan fleet] card vs CPU: {time.perf_counter() - t0:.1f} s")
    del two_w
    # route_scores at the fleets' shapes, on each fleet's last-slot inputs
    # (reported in phase 7), in the mode without extra the policy runs
    route_fleet_times = []
    for fname, fl, res, T, n_launch in (
            ("W1", w1["congested-uplink"], w1_results["W1 congested-uplink aware"], T_W1,
             w1_launches["W1 congested-uplink aware"]["route_scores"]),
            ("W2", w2, w2_results["W2 aware"], T_W2, w2_launches["W2 aware"]["route_scores"])):
        g_f = fl.graph
        nl, M, L = g_f.pt.shape
        row_t = fl.carbon[:, (T - 1) % fl.carbon.shape[1]]
        Qc_f = res.Qc[:, 0]
        rargs = (res.Qt[:, 0], g_f.pt, Qc_f.gather(-1, g_f.dest[:, None, :].expand(nl, M, L)), None,
                 res.Qe[:, 0], fl.spec.pe, V_WAN * row_t.gather(-1, g_f.region),
                 V_WAN * row_t[:, 0])
        got = rs.route_scores_cuda(*rargs)
        want = rs.route_scores_plain(*rargs)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"route_scores {fname} fleet inputs: the kernel differs from the plain version")
        nbytes = 4 * (4 * nl * M * L + 4 * nl * M + nl * L + nl)
        times = graph_ms(lambda: rs.route_scores_cuda(*rargs), reps=10, inner=20)
        route_fleet_times.append({
            "shape": f"F{nl}xM{M}xL{L}", "launches": n_launch, "ms": times[1], "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"})
        say(f"[4d time] route_scores {fname} F{nl}xM{M}xL{L}: {times[1]:.5f} ms cold "
            f"({times[0]:.5f} warm) vs byte bound {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms "
            f"({nbytes / 1e6:.2f} MB; CUDA graph replay, CUDA events, median); bitwise equal to "
            "the plain version on these inputs")
        del rargs, got, want

    # ---- 4e. forecasts ----------------------------------------------
    clock.start("4e")
    mods = {"core": core, "forecast": fcst}
    for d in (0.98, 1.0):
        for H in (1, 4, 8, 16):
            if not torch.equal(discount_powers(d, H, dev).cpu(), discount_powers(d, H, "cpu")):
                fail(f"discount ** arange(H) at discount {d}, H {H}: the card differs from the CPU")
    say("[4e forecast] discount ** arange(H) (LookaheadDPPPolicy's) at discounts 0.98 and 1.0, "
        "H 1, 4, 8, 16: the card's values bitwise equal to the CPU's")
    per_fc = {"carbon_scores": 1, "greedy_fill": 1, "threefry_draw": BLOCK_DRAW}
    for kind in FC_KINDS:
        fl = fleet_scenarios.build_fleet([kind], per_kind=FC_PER_KIND, Tc=96, seed=SEED,
                                         device=dev).to(dev)
        runs = {"CarbonIntensity": (fleet_run(core.CarbonIntensityPolicy(V=V_FC), fl),
                                    T_FC_ANCHOR, fl.F, per_fc)}
        for row, (pol, fc) in forecast_rows(mods, V_FC).items():
            noisy = not getattr(getattr(fc, "error", None), "exact", True)
            runs[row] = ((lambda T, record, pol=pol, fc=fc: core.simulate_fleet(
                pol, fl, T, SEED, record=record, device=dev, forecaster=fc)),
                T_FC_ANCHOR, fl.F,
                dict(per_fc, threefry_draw=Each(slot=1, run=1)) if noisy else per_fc)
        fc_ms, fc_results, _ = drive_fleets(f"4e forecast {kind}", runs, ops, dev)
        base = fc_results["CarbonIntensity"].cum_emissions[:, -1]
        for row, want in FORECAST_JAX[kind].items():
            cum = fc_results[row].cum_emissions[:, -1]
            red = 100.0 * float((1.0 - cum.double() / base.double()).mean())
            tol = FC_TOL
            h1 = row.startswith("la_H1_")
            if h1 and same_result(fc_results[row], fc_results["CarbonIntensity"]):
                fail(f"forecast {kind} {row}: H=1 differs from CarbonIntensity")
            say(f"[4e forecast] {kind} F{fl.F} T={T_FC_ANCHOR} {row}: mean reduction vs "
                f"CarbonIntensity(V={V_FC}) {red:.6f}% (JAX {want:.6f}%, limit {tol:g} points)"
                + ("; every field bitwise equal to CarbonIntensity's run" if h1 else ""))
            if not abs(red - want) <= tol:
                fail(f"forecast {kind} {row}: {red:.6f}% is not within {tol} of JAX's {want:.6f}%")
        del fl, fc_results
    # width: LookaheadDPP(H=8) on fleet B, fed perfect forecasts and RidgeAR
    la = core.LookaheadDPPPolicy(V=V_PAPER, H=FC_H)
    clair, ridge = fcst.ClairvoyantTableForecaster(H=FC_H), fcst.RidgeARForecaster(H=FC_H)

    def la_run(fc, fleet=fleet_b):
        return lambda T, record, d=dev: core.simulate_fleet(la, fleet, T, SEED, record=record,
                                                            device=d, forecaster=fc)

    fcw_runs = {"B CarbonIntensity": fleet_runs["B CarbonIntensity"],
                "B Lookahead(H=8) clairvoyant": (la_run(clair), T_FC_WIDTH, F_B,
                                                 {"carbon_scores": 1, "greedy_fill": 1,
                                                  "threefry_draw": BLOCK_DRAW}),
                "B Lookahead(H=8) RidgeAR": (la_run(ridge), T_FC_WIDTH, F_B,
                                             {"carbon_scores": 1, "greedy_fill": 1,
                                              "threefry_draw": BLOCK_DRAW})}
    fcw_ms, fcw_results, _ = drive_fleets("4e forecast width", fcw_runs, ops, dev)
    fleet_turns("4e forecast width", fcw_runs)
    profile_fleets("4e profile", {k: v for k, v in fcw_runs.items() if "Lookahead" in k}, fcw_ms)
    res = fcw_results["B Lookahead(H=8) clairvoyant"]
    for f in (0, F_B - 1):
        one = core.simulate(la, core.NetworkSpec(*(x[f] for x in fleet_b.spec)),
                            core.TableCarbonSource(table=fleet_b.carbon[f]),
                            core.FleetArrivals(amax=fleet_b.arrival_amax[f]), T_FC_WIDTH,
                            keys_b[f], record="summary", device=dev, forecaster=clair)
        lane = lane_of(res, f)
        bad, rel = same_result(one, lane, COUNTED), emission_rtol(one, lane)
        if bad or rel > 1e-6:
            fail(f"forecast width: lane {f} differs from its instance alone in {bad}, emissions "
                 f"rtol {rel:.3e}")
        say(f"[4e forecast] B Lookahead(H=8) clairvoyant: lane {f} bitwise equal to its instance "
            f"run alone through simulate(forecaster=) on the card ({', '.join(COUNTED)}; "
            f"T={T_FC_WIDTH}); emissions max rel diff {rel:.3e}")
    two_h = fleet_b_h._replace(spec=core.FleetSpec(*(x[:2] for x in fleet_b_h.spec)),
                               carbon=fleet_b_h.carbon[:2], arrival_amax=fleet_b_h.arrival_amax[:2])
    gpu = core.simulate_fleet(la, two_h.to(dev), T_FLEET_CPU, SEED, device=dev, forecaster=clair)
    cpu = core.simulate_fleet(la, two_h, T_FLEET_CPU, SEED, device="cpu", forecaster=clair)
    bad = [n for n in COUNTED if not torch.equal(getattr(gpu, n).cpu(), getattr(cpu, n))]
    rel = emission_rtol(gpu, cpu)
    if bad or rel > 1e-6:
        fail(f"forecast width F2: card and CPU differ in {bad}, emissions rtol {rel:.3e}")
    say(f"[4e forecast] B F2xM{M_MAIN}xN{N_MAIN} Lookahead(H=8) clairvoyant T={T_FLEET_CPU} card "
        f"vs CPU plain path: {', '.join(COUNTED)} bitwise equal, emissions max rel diff {rel:.3e}")
    del two_h, gpu, cpu
    # RidgeAR's refit and rollout alone, with a full window (T=64 reaches
    # it at the last slot only): one predict over F16 x 257 regions
    rcarry = ridge.init(N_MAIN, device=dev)
    for t in range(ridge.window):
        rcarry = ridge.update(rcarry, fleet_b.carbon[:, t % fleet_b.carbon.shape[1]])
    fit_ms = cuda_ms(lambda: ridge.predict(rcarry, ridge.window - 1), reps=10, inner=3)
    if not bool(torch.isfinite(ridge.predict(rcarry, ridge.window - 1)).all()):
        fail("RidgeAR: a non-finite forecast from a full window")
    say(f"[4e forecast] RidgeAR(H=8, lags 8, window 64) one predict with a full window, F{F_B} x "
        f"{N_MAIN + 1} regions (fixed-order 9x9 eliminations, 7 rollout steps): {fit_ms:.4f} ms (CUDA "
        "events, eager, median)")
    del rcarry
    # RidgeAR past its window: the forecast rows' fleet (diurnal, F16 x M5
    # x N5) at T=64 (one refit, at the last slot) and T=192 (a refit every
    # slot from there); the warm slots' ms is the runs' difference over
    # the 128 slots between them
    fl_r = fleet_scenarios.build_fleet(["diurnal"], per_kind=FC_PER_KIND, Tc=96, seed=SEED,
                                       device=dev).to(dev)
    la_r = core.LookaheadDPPPolicy(V=V_FC, H=FC_H, discount=0.98, defer_weight=2.0)

    def ridge_run(T, record):
        return core.simulate_fleet(la_r, fl_r, T, SEED, record=record, device=dev,
                                   forecaster=ridge)

    r_T = (ridge.window, T_FC_ANCHOR)
    r_ms, _, _ = drive_fleets("4e forecast RidgeAR", {
        f"diurnal Lookahead(H=8) RidgeAR T={T}": (ridge_run, T, fl_r.F, per_fc) for T in r_T}, ops,
        dev)
    r_short, r_long = (r_ms[f"diurnal Lookahead(H=8) RidgeAR T={T}"] for T in r_T)
    say(f"[4e forecast] RidgeAR past its window, diurnal F{fl_r.F} x M5 x N5: "
        f"{(r_long * r_T[1] - r_short * r_T[0]) / (r_T[1] - r_T[0]):.4f} ms a warm slot (a refit "
        f"and a 7-step rollout a slot; T={r_T[1]} less T={r_T[0]}, CUDA events under sync debug "
        f"mode; {smi})")
    del fl_r

    # ---- 4f. the fault layer ------------------------------------------
    clock.start("4f")
    # threefry_draw(paths=...) vs its plain version, bitwise: the fault
    # slot's layout at the bench rows' shape (with and without links) and
    # at W2's, for lanes of keys and one key, and a path deeper than two, a
    # segment of length 1, an empty one and the folded key itself
    t0 = time.perf_counter()
    path_cases = (
        (f"F{FAULT_PER_KIND}xM5xN5xL10", FAULT_PER_KIND, flt.fault_paths(5, 5, 10)),
        (f"F{FAULT_PER_KIND}xM5xN5 (no links)", FAULT_PER_KIND, flt.fault_paths(5, 5)),
        (f"F{W2_PER_KIND}xM{M_MAIN}xN{N_MAIN}xL{2 * N_MAIN}", W2_PER_KIND,
         flt.fault_paths(M_MAIN, N_MAIN, 2 * N_MAIN)),
        ("F3 paths (2,0,7) (1,) (0,4) () (5,5,5,5), lengths 9 1 0 6 3", 3,
         (((2, 0, 7), 9), ((1,), 1), ((0, 4), 0), ((), 6), ((5, 5, 5, 5), 3))),
    )
    n_path_draws = 0
    for cname, nl, paths in path_cases:
        n = sum(length for _, length in paths)
        kf = jr.fold_in(jr.split(jr.PRNGKey(SEED, device=dev), nl), flt.FAULT_STREAM_SALT)
        for kk in (kf, kf[0]):
            for t in (0, 1, 191, 2**31 - 1):
                got = tfk.threefry_draw_cuda(kk, t, n, paths=paths)
                want = tfk.threefry_draw_plain(kk, t, n, paths=paths)
                if not same_bits(got, want):
                    fail(f"threefry_draw paths {cname} keys {tuple(kk.shape)} t={t}: differs "
                         "from the plain version")
                n_path_draws += 1
        del got, want
    say(f"[4f faults] threefry_draw(paths=...): {n_path_draws} draws bitwise equal to the plain "
        f"version ({'; '.join(c for c, _, _ in path_cases)}; lanes of keys and one key; t 0, 1, "
        f"191, 2**31-1); {time.perf_counter() - t0:.1f} s")

    # the rows of bench_fault_robustness, held to jax 0.9.0's (FAULT_JAX)
    t0 = time.perf_counter()
    fault_bases = {
        False: fleet_scenarios.build_fleet(["diurnal-slack"], per_kind=FAULT_PER_KIND, Tc=96,
                                           seed=SEED, device=dev),
        True: fleet_scenarios.build_network_fleet(["congested-uplink"], per_kind=FAULT_PER_KIND,
                                                  Tc=96, seed=SEED, device=dev)}

    def zero_faulted(fl):
        N, L = fl.spec.Pc.shape[1], None if fl.graph is None else fl.graph.bw.shape[-1]
        return fl._replace(faults=flt.stack_faults([flt.no_faults(N, L, device="cpu")] * fl.F))

    ci_f, aware_f = core.CarbonIntensityPolicy(V=V_FAULT), net.NetworkAwareDPPPolicy(V=V_FAULT)
    fault_pols = {
        False: {"qlen": core.QueueLengthPolicy(), "carbon": ci_f,
                "guard": flt.StalenessGuardPolicy(inner=ci_f)},
        True: {"qlen": net.StaticRoutePolicy(core.QueueLengthPolicy()), "carbon": aware_f,
               "guard": flt.StalenessGuardPolicy(inner=aware_f)}}
    # launches: the fault stream is one threefry_draw (paths=) a slot, the
    # arrivals one a run, the backlog one tap_probe a slot
    fault_draw = FAULT_RUN
    per_fault = {
        False: {"qlen": {"greedy_fill": 1, **fault_draw},
                "carbon": {"carbon_scores": 1, "greedy_fill": 1, **fault_draw}},
        True: {"qlen": {"greedy_fill": 1, **fault_draw},
               "carbon": {"carbon_scores": 1, "route_scores": 1, "greedy_fill": 1,
                          **fault_draw}}}
    # the fault stream's paths launches, measured: {shape: [launches a run]}
    path_counts = {}
    fault_row_ms = {}
    for wan_f, fl_h in fault_bases.items():
        zero = zero_faulted(fl_h).to(dev)
        zero_runs = {p: core.simulate_fleet(pol, zero, T_FAULT, SEED, record="summary", device=dev)
                     for p, pol in fault_pols[wan_f].items()}
        # the zero-fault anchors: a no_faults fleet is the plain fleet (both
        # score routes) and the guard under no faults is its inner policy
        plain_run = core.simulate_fleet(fault_pols[wan_f]["carbon"], fl_h.to(dev), T_FAULT, SEED,
                                        record="summary", device=dev)
        shared = [n for n in type(plain_run)._fields if getattr(plain_run, n) is not None
                  and not same_bits(getattr(plain_run, n), getattr(zero_runs["carbon"], n))]
        guard_diff = [n for n in type(zero_runs["guard"])._fields
                      if getattr(zero_runs["guard"], n) is not None
                      and not same_bits(getattr(zero_runs["guard"], n),
                                        getattr(zero_runs["carbon"], n))]
        if shared or guard_diff:
            fail(f"zero-fault anchors ({'WAN' if wan_f else 'plain'}): no_faults differs from "
                 f"the plain fleet in {shared}, the guard from its inner policy in {guard_diff}")
        say(f"[4f faults] {'WAN' if wan_f else 'plain'} fleet F{fl_h.F} T={T_FAULT}: no_faults "
            f"bitwise equal to the fault-free fleet in every shared field "
            f"({'route_scores' if wan_f else 'carbon_scores'} route); the guard under no faults "
            "bitwise equal to its inner policy in every field")
        for scen in [k for k in FAULT_JAX if (k == "flappy-uplink") == wan_f]:
            faulted = fleet_scenarios.with_faults(fl_h, scen, seed=SEED).to(dev)
            runs = {f"{scen} {p}": (fleet_run(pol, faulted), T_FAULT, faulted.F,
                                    per_fault[wan_f]["carbon" if p == "guard" else p])
                    for p, pol in fault_pols[wan_f].items()}
            f_ms, f_res, f_launches = drive_fleets("4f faults", runs, ops, dev)
            fault_row_ms.update(f_ms)
            path_counts.setdefault(wan_f, []).extend(
                f_launches[k]["threefry_draw paths"] for k in runs)
            stats = {p: fault_row_stats(f_res[f"{scen} {p}"], zero_runs[p])
                     for p in fault_pols[wan_f]}
            for p, (rec, em, comp) in stats.items():
                r = f_res[f"{scen} {p}"]
                red = 100.0 * (1.0 - em / stats["qlen"][1])
                want = FAULT_JAX[scen][p]
                flow = torch.cumsum((r.arrived - r.processed + r.failed).double(), dim=-1)
                if not torch.equal(r.backlog.double(), flow):
                    fail(f"fault {scen} {p}: backlog != cum(arrived) - cum(processed) + "
                         "cum(failed) on some lane")
                say(f"[4f faults] {scen} {p} F{faulted.F} T={T_FAULT}: recovery {rec} slots "
                    f"(JAX {want[0]}), emission reduction vs qlen {red:.6f}% (JAX {want[1]:.6f}%, "
                    f"limit {FAULT_TOL:g} points), completed {comp:.6f}% (JAX {want[2]:.6f}%); "
                    "conservation exact on every lane and slot")
                if rec != want[0] or comp != want[2] or not abs(red - want[1]) <= FAULT_TOL:
                    fail(f"fault {scen} {p}: ({rec}, {red}, {comp}) is not jax 0.9.0's {want}")
            if not wan_f and not (stats["guard"][0] < stats["carbon"][0]
                                  and stats["guard"][1] < stats["qlen"][1]):
                fail(f"fault {scen}: the guard does not recover faster than carbon and emit less "
                     "than qlen")
            del faulted, f_res
        del zero, zero_runs, plain_run
    say(f"[4f faults] the bench's rows: {time.perf_counter() - t0:.1f} s")

    # full width: fleet B's and W2's shapes under faults, against the same
    # fleets without faults
    fault_b = {scen: fleet_scenarios.with_faults(fleet_b_h, scen, seed=SEED).to(dev)
               for scen in ("regional-blackout", "telemetry-brownout")}
    guard_b = flt.StalenessGuardPolicy(inner=ci)
    per_ci = {"carbon_scores": 1, "greedy_fill": 1, **fault_draw}
    fw_runs = {"B no faults CarbonIntensity": fleet_runs["B CarbonIntensity"]}
    for scen, fl in fault_b.items():
        fw_runs[f"B {scen} CarbonIntensity"] = (fleet_run(ci, fl), T_FAULT_WIDTH, F_B, per_ci)
        fw_runs[f"B {scen} guard"] = (fleet_run(guard_b, fl), T_FAULT_WIDTH, F_B, per_ci)
    w2_flappy_h = fleet_scenarios.with_faults(w2_h, "flappy-uplink", seed=SEED)
    w2_flappy = w2_flappy_h.to(dev)
    guard_w = flt.StalenessGuardPolicy(inner=aware)
    fw2_runs = {"W2 no faults aware": w2_runs["W2 aware"],
                "W2 flappy-uplink aware": (fleet_run(aware, w2_flappy), T_FAULT_WIDTH, w2.F,
                                           dict(per_aware, **fault_draw)),
                "W2 flappy-uplink guard": (fleet_run(guard_w, w2_flappy), T_FAULT_WIDTH, w2.F,
                                           dict(per_aware, **fault_draw))}
    fault_width_ms = {}
    for tag, runs_w in (("4f fault width B", fw_runs), ("4f fault width W2", fw2_runs)):
        w_ms, w_res, w_launches = drive_fleets(tag, runs_w, ops, dev)
        fault_width_ms.update(w_ms)
        path_counts[tag] = [w_launches[k]["threefry_draw paths"] for k in runs_w
                            if "no faults" not in k]
        say(f"[{tag}] fault-stream draws a slot: " + ", ".join(
            f"{k} {w_launches[k]['threefry_draw paths'] / runs_w[k][1]:g}" for k in runs_w
            if "no faults" not in k) + " (threefry_draw's paths= launches, counted at the "
            "launch)")
        fleet_turns(tag, runs_w)
        profile_fleets(tag.replace("width", "profile"),
                       {k: v for k, v in runs_w.items() if "no faults" not in k}, w_ms)
        # lanes 0 and F-1 of the guard run, each instance alone on the card
        gname = [k for k in runs_w if k.endswith("guard")][-1]
        fl_g = fault_b["telemetry-brownout"] if tag.endswith("B") else w2_flappy
        pol_g = guard_b if tag.endswith("B") else guard_w
        keys_g = jr.split(jr.PRNGKey(SEED, device=dev), fl_g.F)
        for f in (0, fl_g.F - 1):
            kw = {} if fl_g.graph is None else {"graph": net.LinkGraph(*(x[f] for x in fl_g.graph))}
            one = core.simulate(pol_g, core.NetworkSpec(*(x[f] for x in fl_g.spec)),
                                core.TableCarbonSource(table=fl_g.carbon[f]),
                                core.FleetArrivals(amax=fl_g.arrival_amax[f]), T_FAULT_WIDTH,
                                keys_g[f], record="summary", device=dev,
                                faults=flt.FaultParams(*(None if x is None else x[f]
                                                         for x in fl_g.faults)), **kw)
            lane = lane_of(w_res[gname], f)
            counted = [n for n in type(one)._fields
                       if getattr(one, n) is not None and n not in (
                           "emissions", "cum_emissions", "energy_edge", "energy_cloud",
                           "energy_transfer", "wasted")]
            bad, rel = same_result(one, lane, counted), emission_rtol(one, lane)
            if bad or rel > 1e-6:
                fail(f"{gname}: lane {f} differs from its instance alone in {bad}, emissions "
                     f"rtol {rel:.3e}")
            say(f"[{tag}] {gname}: lane {f} bitwise equal to its instance run alone through "
                f"simulate(faults=) on the card ({', '.join(counted)}; T={T_FAULT_WIDTH}); "
                f"emissions max rel diff {rel:.3e}")
        del w_res
    # card vs CPU at F2, T=4
    t0 = time.perf_counter()
    two_cases = [(f"B F2xM{M_MAIN}xN{N_MAIN} {scen}", fleet_scenarios.with_faults(
        fleet_b_h._replace(spec=core.FleetSpec(*(x[:2] for x in fleet_b_h.spec)),
                           carbon=fleet_b_h.carbon[:2], arrival_amax=fleet_b_h.arrival_amax[:2]),
        scen, seed=SEED), guard_b) for scen in ("regional-blackout", "telemetry-brownout")]
    two_cases.append((f"W2 F2xM{M_MAIN}xN{N_MAIN}xL{w2.graph.L} flappy-uplink",
                      w2_flappy_h._replace(
                          spec=core.FleetSpec(*(x[:2] for x in w2_flappy_h.spec)),
                          carbon=w2_flappy_h.carbon[:2],
                          arrival_amax=w2_flappy_h.arrival_amax[:2],
                          graph=net.LinkGraph(*(x[:2] for x in w2_flappy_h.graph)),
                          faults=flt.FaultParams(*(None if x is None else x[:2]
                                                   for x in w2_flappy_h.faults))), guard_w))
    for cname, two, pol in two_cases:
        gpu = core.simulate_fleet(pol, two.to(dev), T_FAULT_CPU, SEED, device=dev)
        cpu = core.simulate_fleet(pol, two, T_FAULT_CPU, SEED, device="cpu")
        counted = [n for n in type(cpu)._fields if getattr(cpu, n) is not None and n not in (
            "emissions", "cum_emissions", "energy_edge", "energy_cloud", "energy_transfer",
            "wasted")]
        bad = [n for n in counted if not torch.equal(getattr(gpu, n).cpu(), getattr(cpu, n))]
        rel = emission_rtol(gpu, cpu)
        if bad or rel > 1e-6:
            fail(f"{cname} guard: card and CPU differ in {bad}, emissions rtol {rel:.3e}")
        say(f"[4f faults] {cname} guard T={T_FAULT_CPU} card vs CPU plain path: "
            f"{', '.join(counted)} bitwise equal, emissions max rel diff {rel:.3e} (limit 1e-6)")
        del gpu, cpu
    say(f"[4f faults] card vs CPU: {time.perf_counter() - t0:.1f} s")
    # the fault slot's draw at both widths: one paths launch against the
    # six per-segment draws it replaces (keys derived beforehand), the plain
    # version, and its bound: one hash a value plus the fold and the path's
    # keys a lane, the values' 4-byte stores; launches are the paths=
    # launches counted in the runs at that shape above, a list a run
    fault_draw_times = []
    for dname, nl, M, N, L, n_launch in (
            (f"F{FAULT_PER_KIND}xM5xN5xL10 (the bench's flappy-uplink slot)", FAULT_PER_KIND,
             5, 5, 10, path_counts[True]),
            (f"F{F_B}xM{M_MAIN}xN{N_MAIN} (fleet B's fault slot)", F_B, M_MAIN, N_MAIN, None,
             path_counts["4f fault width B"]),
            (f"F{w2.F}xM{M_MAIN}xN{N_MAIN}xL{w2.graph.L} (W2's fault slot)", w2.F, M_MAIN,
             N_MAIN, w2.graph.L, path_counts["4f fault width W2"])):
        paths = flt.fault_paths(M, N, L)
        n = sum(length for _, length in paths)
        kf = jr.fold_in(jr.split(jr.PRNGKey(SEED, device=dev), nl), flt.FAULT_STREAM_SALT)
        t_last = T_FAULT_WIDTH - 1
        seg_keys = []
        for path, length in paths:
            kk = jr.fold_in(kf, t_last)
            for i in path:
                kk = jr.fold_in(kk, i)
            seg_keys.append((kk.contiguous(), length))
        # in turns: the paths draw, the six draws, the six draws, the paths draw
        turns = draw_turns(lambda: tfk.threefry_draw_cuda(kf, t_last, n, paths=paths),
                           lambda: [tfk.threefry_draw_cuda(kk, None, length)
                                    for kk, length in seg_keys], inner=5, inner_slots=5)
        times, per_call = turns["block"][0], turns["slots"][0]
        plain = cuda_ms(lambda: tfk.threefry_draw_plain(kf, t_last, n, paths=paths), reps=3,
                        inner=1)
        nops = draw_ops(nl, n, 2 + len(paths), 1, 4)
        nbytes = 4 * nl * n + 16 * nl
        bound_o, bound_b = nops / INT32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        fault_draw_times.append({
            "shape": f"{dname}, {nl * n} values", "launches": sum(n_launch),
            "launches_per_run": n_launch, "ms": times[1], "warm_ms": times[0],
            "ms_turn4": turns["block"][1][1], "warm_ms_turn4": turns["block"][1][0],
            "per_call_ms": per_call[1], "plain_ms": plain, "bound_ms": max(bound_o, bound_b),
            "bound_by": "operations" if bound_o >= bound_b else "bytes"})
        say(f"[4f time] threefry_draw(paths=...) {dname}: {nl * n} values ({nbytes / 1e6:.2f} "
            f"MB) vs bound {max(bound_o, bound_b):.5f} ms ({nops / 1e9:.3f} G int ops: "
            f"{bound_o:.5f} ms; bytes {bound_b:.5f} ms); in turns, the paths draw (block) "
            f"against the six per-segment draws (slots), ms cold (warm): {turns_text(turns)}; "
            f"plain version {plain:.3f} ms (CUDA graph replay, CUDA events, median; {smi})")
    say("[4f time] faulted fleets ms/slot under sync debug mode (CUDA events): " + "; ".join(
        f"{k} {v:.4f}" for k, v in {**fault_row_ms, **fault_width_ms}.items()) + f" ({smi})")
    del fault_b, w2_flappy, w2_flappy_h

    # ---- 4g. the deadline layer ---------------------------------------
    clock.start("4g")
    # the rows of bench_deadline_pareto, held to jax 0.9.0's (DEADLINE_JAX):
    # each run under sync debug mode "error", its launches counted (the
    # score pass, the fill and the arrivals' draw a slot; EDD runs no score
    # pass; the blackout rows add the fault stream's paths draw)
    t0 = time.perf_counter()
    dl_base = fleet_scenarios.build_fleet(["diurnal-slack"], per_kind=DL_PER_KIND, Tc=96,
                                          seed=SEED, device=dev).to(dev)
    dl_over = fleet_scenarios.build_fleet(["overload"], per_kind=DL_PER_KIND, Tc=96, seed=SEED,
                                          device=dev).to(dev)
    dl_names = iter(("CarbonIntensity", "lookahead_H16", "slack_thresh", "waitawhile", "edd",
                     "overload/unshedded", "overload/shed", "overload+blackout/unshedded",
                     "overload+blackout/shed"))
    dl_counts = {}  # kernel -> launches over phase 4g's driven runs

    def dl_run(pol, fleet, fc, T=T_DL, tag="4g deadlines"):
        name = next(dl_names) if tag == "4g deadlines" else tag
        fleet = fleet.to(dev)  # the scenario's CPU lanes, staged before the timed run
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            res = core.simulate_fleet(pol, fleet, T, SEED, record="summary", device=dev,
                                      forecaster=fc)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        launches = dict(ops.launch_counts(), **{"threefry_draw paths": ops.path_launches()})
        faulted = fleet.faults is not None
        want = dict.fromkeys(launches, 0)
        want.update({"greedy_fill": T, "threefry_draw": 1 + (T if faulted else 0),
                     "threefry_draw paths": T if faulted else 0, "tap_probe": T if faulted else 0})
        if not isinstance(pol, dlm.EDDPolicy):
            want["carbon_scores"] = T
        if launches != want:
            fail(f"{tag} {name}: kernel launches {launches}, expected {want}")
        for k, v in launches.items():
            dl_counts[k] = dl_counts.get(k, 0) + v
        if not (torch.isfinite(res.emissions).all() and torch.isfinite(res.Qc).all()):
            fail(f"{tag} {name}: non-finite emissions or queues")
        say(f"[{tag}] {name} F{fleet.F} T={T} record=summary under sync debug mode 'error': "
            "launches per slot " + ", ".join(f"{k} {v / T:g}" for k, v in launches.items() if v)
            + f"; {start.elapsed_time(end) / T:.4f} ms/slot (CUDA events)")
        return res

    dl_mods = dict(core=core, deadlines=dlm, faults=flt, forecast=fcst,
                   fleet_scenarios=fleet_scenarios)
    dl_rows, dl_res = deadline_rows(dl_mods, dl_base, dl_over, dl_run)
    for row, want in DEADLINE_JAX.items():
        got = dl_rows[row]
        say(f"[4g deadlines] {row}: " + ", ".join(
            f"{k} {got[k]:.6f} (JAX {v:.6f})" if k in ("reduction", "waiting")
            else f"{k} {got[k]:g} (JAX {v:g})" for k, v in want.items()))
        bad = [k for k, v in want.items()
               if not (abs(got[k] - v) <= DL_TOL if k in ("reduction", "waiting") else got[k] == v)]
        if bad or set(got) != set(want):
            fail(f"deadline row {row}: {bad} are not jax 0.9.0's ({got} vs {want})")
    # conservation on every lane: the rings re-sum to Qe; the faulted rows'
    # backlog is cum(arrived - processed + failed - missed - shed)
    for row, r in dl_res.items():
        if r.deadlines is None:
            continue
        if not torch.equal(r.deadlines.Qd[:, -1].sum(-1), r.Qe[:, -1]):
            fail(f"deadline row {row}: the rings do not re-sum to Qe")
        if hasattr(r, "backlog"):
            led = r.deadlines
            flow = torch.cumsum((r.arrived - r.processed + r.failed - led.missed
                                 - led.shed).double(), dim=-1)
            if not torch.equal(r.backlog.double(), flow):
                fail(f"deadline row {row}: backlog != cum(arrived - processed + failed - missed "
                     "- shed) on some lane")
    # the bench's acceptance (see DEADLINE_JAX for the shed lane's misses)
    red_la = dl_rows[f"lookahead_H{DL_H}"]["reduction"]
    best = max((v["reduction"] for k, v in dl_rows.items()
                if k in ("slack_thresh", "waitawhile", "edd") and v["missed"] == 0.0),
               default=-np.inf)
    unshed, shed_r = dl_rows["overload/unshedded"], dl_rows["overload/shed"]
    blk_u, blk_s = dl_rows["overload+blackout/unshedded"], dl_rows["overload+blackout/shed"]
    say(f"[4g deadlines] acceptance: best zero-miss deadline policy {best:.6f}% vs lookahead "
        f"{red_la:.6f}% ({best / red_la:.4f} of it, needs >= 0.9); overload misses unshedded "
        f"{unshed['missed']:g}, shed {shed_r['missed']:g} of {shed_r['admitted']:g} admitted "
        f"({100 * shed_r['missed'] / shed_r['admitted']:.4f}%; the bench's 0 fails in jax 0.9.0 "
        f"too); blackout shed lane sheds {blk_s['shed']:g}, final backlog {blk_s['backlog']:g} vs "
        f"unshedded {blk_u['backlog']:g}; {time.perf_counter() - t0:.1f} s")
    if not (best >= 0.9 * red_la and unshed["missed"] > 0.0
            and shed_r["missed"] <= 1e-3 * shed_r["admitted"] and blk_s["shed"] > 0.0
            and blk_s["backlog"] < blk_u["backlog"]):
        fail("bench_deadline_pareto's acceptance does not hold on the card")
    # the infinite-deadline anchor through the kernels: SlackThreshold on a
    # no_deadlines fleet is LookaheadDPP bitwise in every shared field
    nd = dl_base._replace(deadlines=dlm.stack_deadlines(
        [dlm.no_deadlines(dl_base.spec.pe.shape[1], device="cpu")] * dl_base.F))
    anch = dl_run(dlm.SlackThresholdPolicy(V=V_DL, H=DL_H), nd,
                  fcst.ClairvoyantTableForecaster(H=DL_H), tag="4g anchor")
    la = dl_res[f"lookahead_H{DL_H}"]
    diff = [n for n in type(la)._fields if getattr(la, n) is not None
            and not same_bits(getattr(la, n), getattr(anch, n))]
    if diff or float(anch.deadlines.missed.sum()) != 0.0:
        fail(f"infinite-deadline anchor: SlackThreshold on no_deadlines differs from LookaheadDPP "
             f"in {diff}")
    say("[4g deadlines] infinite-deadline anchor: SlackThreshold on a no_deadlines fleet bitwise "
        "equal to LookaheadDPP in every field (carbon_scores, greedy_fill, threefry_draw)")
    del dl_res, anch, la, nd

    # card vs CPU at fleet B's width, F2, T=4: queues, rings and counts
    # bitwise, emissions within rtol 1e-6, conservation exact on every lane
    t0 = time.perf_counter()
    two_b = fleet_b_h._replace(spec=core.FleetSpec(*(x[:2] for x in fleet_b_h.spec)),
                               carbon=fleet_b_h.carbon[:2], arrival_amax=fleet_b_h.arrival_amax[:2])
    for kind, pol in (("tight-uniform", dlm.SlackThresholdPolicy(V=V_PAPER)),
                      ("shed-overload", dlm.SlackThresholdPolicy(V=V_PAPER)),
                      ("tight-uniform", dlm.EDDPolicy())):
        two = fleet_scenarios.with_deadlines(two_b, kind, seed=SEED)
        gpu = core.simulate_fleet(pol, two.to(dev), T_DL_CPU, SEED, device=dev)
        cpu = core.simulate_fleet(pol, two, T_DL_CPU, SEED, device="cpu")
        bad = [n for n in COUNTED if not torch.equal(getattr(gpu, n).cpu(), getattr(cpu, n))]
        bad += [n for n in ("Qd", "missed", "shed", "admitted")
                if not torch.equal(getattr(gpu.deadlines, n).cpu(), getattr(cpu.deadlines, n))]
        rel = emission_rtol(gpu, cpu)
        led = cpu.deadlines
        # every slot of every lane: Qe + Qc = cum(admitted - processed - missed)
        flow = torch.cumsum((led.admitted - cpu.processed - led.missed).double(), dim=-1)
        held = cpu.Qe.double().sum(-1) + cpu.Qc.double().sum((-2, -1))
        if bad or rel > 1e-6 or not torch.equal(flow, held):
            fail(f"deadline {kind} {type(pol).__name__} F2: card and CPU differ in {bad}, "
                 f"emissions rtol {rel:.3e}, or conservation fails")
        say(f"[4g deadlines] B F2xM{M_MAIN}xN{N_MAIN} {kind} {type(pol).__name__} T={T_DL_CPU} "
            f"card vs CPU plain path: {', '.join(COUNTED)}, Qd, missed, shed, admitted bitwise equal, "
            f"emissions max rel diff {rel:.3e} (limit 1e-6); conservation exact on both lanes "
            f"(missed {float(led.missed.sum()):g}, shed {float(led.shed.sum()):g})")
        del gpu, cpu
    say(f"[4g deadlines] card vs CPU: {time.perf_counter() - t0:.1f} s")
    # timing at width: fleet B under tight-uniform deadlines, in turns
    # against the same fleet without deadlines; CarbonIntensity ignores
    # the view, so its deadline run adds the deadline step alone, and
    # SlackThreshold's adds its score updates on top
    fleet_b_dl = fleet_scenarios.with_deadlines(fleet_b_h, "tight-uniform", seed=SEED).to(dev)
    slack_b = dlm.SlackThresholdPolicy(V=V_PAPER)
    per_b = {"carbon_scores": 1, "greedy_fill": 1, "threefry_draw": BLOCK_DRAW}
    dw_runs = {"B no deadlines CarbonIntensity": fleet_runs["B CarbonIntensity"],
               "B tight-uniform CarbonIntensity": (fleet_run(ci, fleet_b_dl), T_DL_WIDTH, F_B,
                                                   per_b),
               "B tight-uniform SlackThreshold": (fleet_run(slack_b, fleet_b_dl), T_DL_WIDTH, F_B,
                                                  per_b)}
    dw_ms, dw_res, dw_launches = drive_fleets("4g deadline width B", dw_runs, ops, dev)
    for run in ("B tight-uniform CarbonIntensity", "B tight-uniform SlackThreshold"):
        for k, v in dw_launches[run].items():
            dl_counts[k] = dl_counts.get(k, 0) + v
        led = dw_res[run].deadlines
        say(f"[4g deadline width B] {run} F{F_B} T={T_DL_WIDTH}: missed "
            f"{float(led.missed.sum()):g}, shed {float(led.shed.sum()):g}, admitted "
            f"{float(led.admitted.sum()):g}")
    fleet_turns("4g deadline width B", dw_runs)
    dw_calls, dw_busy = profile_fleets("4g deadline profile B", dw_runs, dw_ms)
    base_run, step_run, slack_run = dw_runs
    if None not in dw_busy.values():
        say(f"[4g deadline profile B] a slot of fleet B: the deadline step adds "
            f"{dw_calls[step_run] - dw_calls[base_run]:.1f} aten calls and "
            f"{dw_busy[step_run] - dw_busy[base_run]:.4f} ms of device time; SlackThreshold's "
            f"score updates {dw_calls[slack_run] - dw_calls[step_run]:.1f} calls and "
            f"{dw_busy[slack_run] - dw_busy[step_run]:.4f} ms more (profiler, 8 slots)")
    say("[4g deadlines] launches over the phase's driven runs: " + ", ".join(
        f"{k} {v}" for k, v in dl_counts.items() if v) + f" ({smi})")
    del dw_res, fleet_b_dl, dl_base, dl_over, two_b

    # ---- 4h. the telemetry layer --------------------------------------
    clock.start("4h")
    # the taps ride every loop: each slot writes the probe's raw fields,
    # and one tap_scan launch a run (one a flush chunk when streaming)
    # builds the frame; every run below is held to its taps-off twin
    t0 = time.perf_counter()
    tcfg = tlm.TelemetryConfig()
    tap_counts = {}  # kernel -> launches over phase 4h's driven runs
    TAP_RUN = {"tap_scan": Each(run=1), "tap_probe": 1}

    def taps_of(runs):
        for name, launches in runs.items():
            for k, v in launches.items():
                tap_counts[k] = tap_counts.get(k, 0) + v

    def taps_off_equal(tag, off, on):
        bad = [n for n in type(off)._fields if n != "telemetry" and getattr(off, n) is not None
               and (not torch.is_tensor(getattr(off, n))
                    or not same_bits(getattr(off, n), getattr(on, n)))]
        if bad or off.telemetry is not None or on.telemetry is None:
            fail(f"{tag}: taps on changed {bad}")

    def held_manifest(tag, got, want):
        """alert records and the peak exactly, the totals within TEL_RTOL"""
        ok = got[4] == want[4] and got[0] == want[0] and all(
            abs(g - w) <= TEL_RTOL * abs(w) for g, w in zip(got[1:4], want[1:4]))
        say(f"[4h telemetry] {tag}: manifest {got}; JAX {want}")
        if not ok:
            fail(f"{tag}: manifest {got} is not jax 0.9.0's {want} (alerts and peak exact, "
                 f"totals within rtol {TEL_RTOL:g})")

    def tap_turns(tag, fns, T, lanes, pairs=3):
        """ms a run of each fn in `fns` (taps off / on, or taps / stream),
        paired and interleaved (A, B, B, A, ...), CUDA events; the overhead
        is the median of the pairs' ratios, as bench_stream_overhead takes
        it (the host's drift hits both runs of a pair)"""
        names = list(fns)
        got = {n: [] for n in names}
        for i in range(pairs):
            for n in (names if i % 2 == 0 else names[::-1]):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fns[n]()
                end.record()
                end.synchronize()
                got[n].append(start.elapsed_time(end))
        ratio = statistics.median(b / a for a, b in zip(got[names[0]], got[names[1]]))
        per = {n: statistics.median(v) * 1e3 / (T * lanes) for n, v in got.items()}
        say(f"[4h telemetry] {tag} in turns {' / '.join(names + names[::-1])} x {pairs}: "
            + "; ".join(f"{n} " + " / ".join(f"{x:.3f}" for x in v) + " ms a run"
                        for n, v in got.items())
            + "; median us per lane-slot " + ", ".join(f"{n} {v:.4f}" for n, v in per.items())
            + f"; overhead {100.0 * (ratio - 1.0):.2f}% (median of the pairs' ratios)")
        return 100.0 * (ratio - 1.0), per

    # (a) bench_telemetry_overhead's fleet: F32 x M5 x N5, T=192, summary
    tel_fleet = fleet_scenarios.build_fleet(["diurnal-slack"], per_kind=TEL_PER_KIND, Tc=96,
                                            seed=SEED, device=dev).to(dev)
    ci_t = core.CarbonIntensityPolicy(V=V_FAULT)
    per_a = {"carbon_scores": 1, "greedy_fill": 1, "threefry_draw": BLOCK_DRAW}
    a_runs = {"A off": (lambda T, record: core.simulate_fleet(ci_t, tel_fleet, T, SEED,
                                                              record=record, device=dev),
                        T_TEL, tel_fleet.F, per_a),
              "A on": (lambda T, record: core.simulate_fleet(ci_t, tel_fleet, T, SEED,
                                                             record=record, device=dev,
                                                             telemetry=tcfg),
                       T_TEL, tel_fleet.F, dict(per_a, **TAP_RUN))}
    _, a_res, a_launches = drive_fleets("4h telemetry", a_runs, ops, dev)
    taps_of({"A on": a_launches["A on"]})
    taps_off_equal("bench_telemetry_overhead fleet", a_res["A off"], a_res["A on"])
    held_manifest(f"bench_telemetry_overhead F{tel_fleet.F} T={T_TEL}",
                  manifest_row(tlm.manifest(a_res["A on"].telemetry)), TELEMETRY_JAX)
    a_over, a_per = tap_turns(f"bench_telemetry_overhead F{tel_fleet.F} T={T_TEL}",
                              {"off": lambda: a_runs["A off"][0](T_TEL, "summary"),
                               "on": lambda: a_runs["A on"][0](T_TEL, "summary")},
                              T_TEL, tel_fleet.F, pairs=7)
    say(f"[4h telemetry] bench_telemetry_overhead: taps on cost {a_over:.2f}% per lane-slot "
        f"({a_per['off']:.4f} -> {a_per['on']:.4f} us), the JAX bench's budget "
        f"{TEL_BUDGET_PCT:g}% (printed, not enforced; {smi})")
    tap_cases = {f"F{tel_fleet.F} x T{T_TEL} (bench_telemetry_overhead)": a_res["A on"].telemetry}

    # (b) bench_stream_overhead's instance: M2048 x N64, UK source, T=192,
    # taps only against StreamConfig(flush_every=16)
    pe_s, pc_s, Pe_s, Pc_s = stream_instance_arrays()
    spec_s = convert.spec_from_numpy(pe_s, pc_s, Pe_s, Pc_s, dev)
    uk_s = core.UKRegionalTraceSource(N=N_STREAM)
    arr_s = core.UniformArrivals(M=M_STREAM, amax=A_STREAM)
    scfg = tlm.StreamConfig(taps=tcfg, flush_every=STREAM_FLUSH, channel="chip")

    def stream_run(telemetry):
        return core.simulate(ci_t, spec_s, uk_s, arr_s, T_STREAM, SEED, record="summary",
                             device=dev, telemetry=telemetry)

    ops.reset_launch_counts()
    s_off = stream_run(None)
    s_taps = stream_run(tcfg)
    n_taps, n_probe = ops.launch_counts()["tap_scan"], ops.launch_counts()["tap_probe"]
    tlm.reset_channel("chip")
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as live_dir:
        with tlm.follow_run(channel="chip", outdir=live_dir) as live:
            s_stream = stream_run(scfg)
        n_stream = ops.launch_counts()["tap_scan"]
        n_events = tlm.validate_jsonl(Path(live.paths["jsonl"]).read_text())
        n_prom = tlm.validate_prometheus(Path(live.paths["prometheus"]).read_text())
    taps_of({"stream taps": {"tap_scan": n_taps}, "stream": {"tap_scan": n_stream}})
    taps_off_equal("bench_stream_overhead instance", s_off, s_taps)
    if n_taps != 1 or n_stream != T_STREAM // STREAM_FLUSH or n_probe != T_STREAM:
        fail(f"tap_scan launches: {n_taps} a batch run, {n_stream} a streamed run "
             f"(1 and {T_STREAM // STREAM_FLUSH} expected); tap_probe {n_probe} ({T_STREAM})")
    bad = [n for n, a, b in zip(tlm.Telemetry._fields, s_taps.telemetry, s_stream.telemetry)
           if a.dtype != b.dtype or not same_bits(a, b)]
    bad += [n for n in type(s_taps)._fields if n != "telemetry"
            and getattr(s_taps, n) is not None and not same_bits(getattr(s_taps, n),
                                                                 getattr(s_stream, n))]
    chan = tlm.channel("chip").series(0)
    bad += [f"channel {n}" for n in tlm.TapSeries._fields
            if not np.array_equal(getattr(chan, n), getattr(s_taps.telemetry, n).cpu().numpy())]
    if bad or live.slots != T_STREAM or n_events != T_STREAM + 1:
        fail(f"streamed run differs from the taps-only run in {bad}, or the live JSONL has "
             f"{n_events} events for {live.slots} slots")
    say(f"[4h telemetry] bench_stream_overhead M{M_STREAM}xN{N_STREAM} T={T_STREAM}: taps-off "
        "fields bitwise equal with taps on; StreamConfig(flush_every="
        f"{STREAM_FLUSH}) bitwise equal to the taps-only run in every result and frame field; "
        f"tap_scan launches {n_taps} a batch run, {n_stream} a streamed run; the channel's "
        f"reassembly bitwise the batch series; FollowedRun's JSONL {n_events} events "
        f"(validate_jsonl), Prometheus {n_prom} samples")
    tlm.reset_channel("chip")
    s_over, s_per = tap_turns(f"bench_stream_overhead M{M_STREAM}xN{N_STREAM} T={T_STREAM}",
                              {"taps": lambda: stream_run(tcfg),
                               "stream": lambda: stream_run(scfg)},
                              T_STREAM, 1, pairs=9)
    o_over, o_per = tap_turns(f"bench_stream_overhead M{M_STREAM}xN{N_STREAM} T={T_STREAM}",
                              {"off": lambda: stream_run(None), "taps": lambda: stream_run(tcfg)},
                              T_STREAM, 1, pairs=5)
    tlm.reset_channel("chip")
    # where the taps' host time goes on this host-paced instance: the
    # profiler's host ops over 16 slots, taps on against taps off
    hosts = {}
    for name, tel_x in (("off", None), ("taps", tcfg)):
        _, hosts[name] = profile_slots(lambda tel_x=tel_x: core.simulate(
            ci_t, spec_s, uk_s, arr_s, 16, SEED, record="summary", device=dev,
            telemetry=tel_x), slots=16)
    grown = sorted(((hosts["taps"][k][0] - hosts["off"].get(k, (0.0, 0.0))[0],
                     hosts["taps"][k][1] - hosts["off"].get(k, (0.0, 0.0))[1], k)
                    for k in hosts["taps"]), reverse=True)
    say("[4h telemetry] bench_stream_overhead, 16 slots under the profiler: the host ops taps "
        "grow most, self ms a slot (calls a slot) added: " + ", ".join(
            f"{k[:40]} {d:.4f} ({c:+.2f})" for d, c, k in grown[:8]))
    say(f"[4h telemetry] bench_stream_overhead: streaming costs {s_over:.2f}% against taps only, "
        f"the JAX bench's budget {STREAM_BUDGET_PCT:g}% (printed, not enforced); taps on cost "
        f"{o_over:.2f}% against taps off ({smi})")
    tel_s = s_taps.telemetry
    k_drift = tlm.MONITORS.index("conservation_drift")
    # past 2**24 the probe's sums in XLA:CPU's order give JAX's backlog,
    # residual and alerts (hazard 34): the manifest is held
    held_manifest(f"bench_stream_overhead M{M_STREAM}xN{N_STREAM} T={T_STREAM}",
                  manifest_row(tlm.manifest(tel_s)), STREAM_JAX)
    say(f"[4h telemetry] bench_stream_overhead on the card: |residual| max "
        f"{float(tel_s.conservation_residual.abs().max()):g}, first nonzero at slot "
        f"{int((tel_s.conservation_residual != 0).int().argmax())}, conservation_drift first "
        f"fires at {int(tel_s.alert_first_slot[k_drift])} (JAX 56), peak backlog "
        f"{float(tel_s.peak_backlog):.9g} (JAX {STREAM_JAX[0]:.9g}); tap_probe {n_probe} "
        "launches a run")
    tap_cases[f"F1 x T{T_STREAM} (bench_stream_overhead, M{M_STREAM}xN{N_STREAM})"] = tel_s
    del s_off, s_stream

    # (c) the nine fault rows rerun with taps (bench_fault_robustness's
    # manifests) and W1's congested-uplink fleet (summary records here: the
    # frame is the same in every record mode, and the anchor's is T//8)
    c_runs = {}
    for scen in (k for k in FAULT_JAX):
        wan_f = scen == "flappy-uplink"
        faulted = fleet_scenarios.with_faults(fault_bases[wan_f], scen, seed=SEED).to(dev)
        for p, pol in fault_pols[wan_f].items():
            c_runs[f"{scen}/{p}"] = (
                lambda T, record, pol=pol, fl=faulted: core.simulate_fleet(
                    pol, fl, T, SEED, record=record, device=dev, telemetry=tcfg),
                T_FAULT, faulted.F,
                dict(per_fault[wan_f]["carbon" if p == "guard" else p], **TAP_RUN))
    w1c_t = w1["congested-uplink"]
    c_runs["W1 congested-uplink aware"] = (
        lambda T, record: core.simulate_fleet(aware, w1c_t, T, SEED, record=record, device=dev,
                                              telemetry=tcfg),
        T_W1, w1c_t.F, dict(per_aware, **TAP_RUN))
    for name in c_runs:  # one at a time: a fault fleet's state is let go before the next
        _, c_res, c_launches = drive_fleets("4h telemetry", {name: c_runs[name]}, ops, dev)
        taps_of(c_launches)
        held_manifest(name, manifest_row(tlm.manifest(c_res[name].telemetry)),
                      FAULT_MANIFEST_JAX[name])
        del c_res
    del c_runs

    # (d) the main path and fleet B at full width, T=64, taps on: taps-off
    # fields bitwise, launches, aten calls a slot with and without taps
    def main_taps(T, record, telemetry=tcfg, pol=policies["CarbonIntensity"]):
        return core.simulate(pol, spec_d, inst["carbon"], inst["arrivals"], T, SEED,
                             state0=state0_d, record=record, device=dev, telemetry=telemetry)

    per_main = {"carbon_scores": 1, "greedy_fill": 1, "threefry_draw": BLOCK_DRAW}
    d_runs = {"main off": (lambda T, record: main_taps(T, record, None), T_MAIN, 1, per_main),
              "main on": (main_taps, T_MAIN, 1, dict(per_main, **TAP_RUN)),
              "B off": (lambda T, record: core.simulate_fleet(ci, fleet_b, T, SEED, record=record,
                                                              device=dev),
                        T_FLEET_B, F_B, per_main),
              "B on": (lambda T, record: core.simulate_fleet(ci, fleet_b, T, SEED, record=record,
                                                             device=dev, telemetry=tcfg),
                       T_FLEET_B, F_B, dict(per_main, **TAP_RUN))}
    # drive_fleets wants a lane axis: the main run is driven here alone
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        main_on = main_taps(T_MAIN, "summary")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    main_tap_launches = ops.launch_counts()  # the main path with taps, alone
    want = dict.fromkeys(main_tap_launches, 0)
    want.update(carbon_scores=T_MAIN, greedy_fill=T_MAIN, threefry_draw=1, tap_scan=1,
                tap_probe=T_MAIN)
    if main_tap_launches != want:
        fail(f"4h main with taps: launches {main_tap_launches}, expected {want}")
    taps_of({"main on": main_tap_launches})
    taps_off_equal(f"main M{M_MAIN}xN{N_MAIN}", results["CarbonIntensity"], main_on)
    _, b_res, b_launches = drive_fleets(
        "4h telemetry", {k: d_runs[k] for k in ("B off", "B on")}, ops, dev)
    taps_of({"B on": b_launches["B on"]})
    taps_off_equal(f"fleet B F{F_B}", b_res["B off"], b_res["B on"])
    # the main path starts from a backlog Qe0, Qc0, which no tap has seen
    # arrive (the ledger starts empty, as JAX's does), so its residual is
    # about minus that backlog; fleet B starts empty, and its residual
    # leaves 0 only where the float32 sums pass 2**24 (hazard 34)
    for tag, tel_d in ((f"main M{M_MAIN}xN{N_MAIN} T={T_MAIN} (from a backlog of "
                        f"{float(state0_d.Qe.sum() + state0_d.Qc.sum()):.9g})", main_on.telemetry),
                       (f"fleet B F{F_B} T={T_FLEET_B} (from empty queues)",
                        b_res["B on"].telemetry)):
        say(f"[4h telemetry] {tag}: taps-off fields bitwise equal with taps on, sync-free; "
            f"peak backlog {tel_d.peak_backlog.max().item():.9g}, |residual| max "
            f"{float(tel_d.conservation_residual.abs().max()):g}, alerts firing slots "
            + ", ".join(f"{m} {int(c)}" for m, c in zip(tlm.MONITORS,
                                                       tel_d.alert_count.reshape(-1, 6).sum(0))))
    tap_cases[f"F1 x T{T_MAIN} (main M{M_MAIN}xN{N_MAIN})"] = main_on.telemetry
    tap_cases[f"F{F_B} x T{T_FLEET_B} (fleet B)"] = b_res["B on"].telemetry
    d_over, _ = tap_turns(f"main M{M_MAIN}xN{N_MAIN} T={T_MAIN}",
                          {"off": lambda: main_taps(T_MAIN, "summary", None),
                           "on": lambda: main_taps(T_MAIN, "summary")}, T_MAIN, 1)
    b_over, _ = tap_turns(f"fleet B F{F_B} T={T_FLEET_B}",
                          {"off": lambda: d_runs["B off"][0](T_FLEET_B, "summary"),
                           "on": lambda: d_runs["B on"][0](T_FLEET_B, "summary")}, T_FLEET_B, F_B)

    def aten_calls(fn, T):
        _, host = profile_slots(lambda: fn(T), slots=1)
        return sum(v[1] for k, v in host.items() if k.startswith("aten::"))

    calls = {(n, T): aten_calls(lambda T, n=n: d_runs[n][0](T, "summary"), T)
             for n in ("main off", "main on") for T in (8, 16)}
    added = ((calls["main on", 16] - calls["main off", 16])
             - (calls["main on", 8] - calls["main off", 8])) / 8
    say(f"[4h telemetry] aten calls (profiler, nested calls counted): main off "
        f"{calls['main off', 16] / 16:.1f} a slot, on {calls['main on', 16] / 16:.1f} a slot over "
        f"16 slots; taps add {added:.1f} a slot (16 against 8 slots, so a run's once-only calls "
        f"cancel); overheads main {d_over:.2f}%, fleet B {b_over:.2f}% ({smi})")

    def device_events(fn):
        """(kernels, memsets, tap_probe kernels) the card ran during fn()
        and the cooperative launches the host made, from torch.profiler"""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = [0, 0, 0, 0]
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and not evt.key.startswith("repro."):
                n["memset" in evt.key.lower()] += evt.count
                n[2] += evt.count if "tap_probe_kernel" in evt.key else 0
            elif evt.key == "cudaLaunchCooperativeKernel":
                n[3] += evt.count
        return n

    ev = {(n, T): device_events(lambda T=T, n=n: d_runs[n][0](T, "summary"))
          for n in ("main off", "main on") for T in (8, 16)}
    ev_added = [((ev["main on", 16][i] - ev["main off", 16][i])
                 - (ev["main on", 8][i] - ev["main off", 8][i])) / 8 for i in (0, 1)]
    say(f"[4h telemetry] the card's events (profiler) taps add a slot on main: kernels "
        f"{ev_added[0]:g}, memsets {ev_added[1]:g} (16 against 8 slots)")
    if ev_added[1] != 0:
        fail(f"4h main with taps: {ev_added[1]:g} memsets a slot (the probe must add none)")
    # the probe: one kernel a slot, an ordinary launch (no cooperative one)
    probe_a_slot = (ev["main on", 16][2] - ev["main on", 8][2]) / 8
    coop = sum(v[3] for v in ev.values())
    say(f"[4h telemetry] tap_probe on main with taps (profiler): {probe_a_slot:g} kernel a slot "
        f"(16 against 8 slots), {coop} cooperative launches; "
        f"{tpk._probe_lib().tap_probe_occupancy()} blocks an SM")
    if probe_a_slot != 1 or coop:
        fail(f"4h main with taps: tap_probe {probe_a_slot:g} kernels a slot, {coop} cooperative "
             "launches (one ordinary launch a slot expected)")
    del main_on, b_res

    # tap_scan against its plain version on the card: on every run's probe
    # series above, whole and in chunks from the carried state, and on a
    # synthetic series past 2**24 that puts each monitor one float below,
    # at and above its threshold
    def probe_of(tel_x):
        return tlm.TelemetryProbe(
            emissions=tel_x.emission_rate, arrived=tel_x.arrived,
            dispatched=tel_x.dispatched_cloud, processed=tel_x.processed, failed=tel_x.failed,
            wasted=tel_x.wasted, backlog=tel_x.backlog, stale=tel_x.staleness,
            clouds_down=tel_x.clouds_down, retry_depth=tel_x.retry_depth,
            transfer_occupancy=tel_x.transfer_occupancy, missed=tel_x.missed, shed=tel_x.shed)

    def tap_check(label, cfg_x, probe, chunks=()):
        lanes_x, T_x = tuple(probe.backlog.shape[:-1]), probe.backlog.shape[-1]
        outs = []
        for fn in (tpk.tap_scan_cuda, tpk.tap_scan_plain):
            out_x = tpk.TapOut.empty(lanes_x, T_x, dev)
            st_x = torch.zeros(lanes_x + (7,), device=dev)
            bounds = [0, *chunks, T_x]
            for a0, a1 in zip(bounds, bounds[1:]):
                fn(cfg_x, probe, out_x, st_x, a0, a1)
            outs.append((out_x, st_x))
        torch.cuda.synchronize()
        for a, b in zip((*outs[0][0], outs[0][1]), (*outs[1][0], outs[1][1])):
            if a.dtype == torch.float32:
                err = float(torch.nan_to_num((a - b).abs(), nan=0.0).max())
                max_err["tap_scan"] = max(max_err["tap_scan"], err)
        bad = [n for n, a, b in zip(tpk.TapOut._fields + ("state",), (*outs[0][0], outs[0][1]),
                                    (*outs[1][0], outs[1][1])) if not same_bits(a, b)]
        if bad:
            fail(f"tap_scan {label}: {bad} differ from the plain version")
        return outs[0]

    n_checked = 0
    for label, tel_x in tap_cases.items():
        probe = probe_of(tel_x)
        out_x, _ = tap_check(label, tcfg, probe)
        frame_bad = [n for n in ("backlog_growth", "conservation_residual", "alert_active")
                     if not same_bits(getattr(out_x, n), getattr(tel_x, n))]
        if frame_bad:
            fail(f"tap_scan {label}: the run's frame differs in {frame_bad}")
        T_x = probe.backlog.shape[-1]
        tap_check(label + " in chunks", tcfg, probe, chunks=(1, T_x // 3, T_x // 2 + 1))
        n_checked += 2
    rng_t = np.random.default_rng(SEED)
    lanes_t, T_t = 96, 300
    near = lambda v: [float(np.nextafter(np.float32(v), np.float32(d)))  # noqa: E731
                      for d in (-np.inf, np.float32(v), np.inf)]
    shape = (lanes_t, T_t)
    arrived = rng_t.integers(0, 2**26, shape).astype(np.float32)
    processed = np.minimum(rng_t.integers(0, 2**26, shape).astype(np.float32), arrived)
    backlog = np.cumsum(arrived - processed, axis=-1, dtype=np.float64).astype(np.float32)
    syn = dict(emissions=(rng_t.uniform(0, 1, shape) * 10.0 ** rng_t.integers(-3, 9, shape)),
               arrived=arrived, processed=processed,
               failed=np.minimum(rng_t.integers(0, 2**23, shape).astype(np.float32), processed),
               wasted=rng_t.uniform(0, 3e4, shape), backlog=backlog,
               stale=rng_t.integers(0, 9, shape), clouds_down=rng_t.integers(0, 6, shape),
               retry_depth=np.zeros(shape), transfer_occupancy=np.zeros(shape),
               missed=np.zeros(shape), shed=np.zeros(shape))
    cfg_t = tlm.TelemetryConfig(growth_thresh=0.1, growth_sustain=1, stale_budget=3,
                                drift_tol=0.3, miss_tol=0.7, shed_frac=0.1)
    # lanes 0-2: one float below, at and above growth_thresh, miss_tol and
    # shed_frac x 10 arrivals (processed as they come), stale 2-4 against
    # a budget of 3, 4-6 of 5 clouds down; lanes 3-5 a residual below, at
    # and above drift_tol; each monitor's firing slots are then exact
    for i in range(6):
        for k in syn:
            syn[k][i] = 0
    for i in range(3):
        syn["backlog"][i, 1::2] = near(0.1)[i]
        syn["arrived"][i] = syn["processed"][i] = 10.0
        syn["missed"][i] = near(0.7)[i]
        syn["shed"][i] = near(1.0)[i]
        syn["stale"][i] = 2 + i
        syn["clouds_down"][i] = 4 + i
        syn["arrived"][3 + i, 0] = near(0.3)[i]
    fired_want = np.zeros((6, 6), np.int64)
    fired_want[1, 2] = fired_want[2, 1:3] = fired_want[2, 4:6] = fired_want[5, 3] = T_t
    fired_want[2, 0] = T_t // 2
    fired_want[:3, 3] = T_t  # lanes 0-2's misses and sheds leave the residual at -1.7 a slot
    probe_t = tlm.TelemetryProbe(
        dispatched=torch.zeros(shape + (5,), device=dev),
        **{k: torch.as_tensor(np.ascontiguousarray(v), device=dev,
                              dtype=torch.int32 if k == "stale" else torch.float32)
           for k, v in syn.items()})
    out_t, _ = tap_check("synthetic", cfg_t, probe_t)
    tap_check("synthetic in chunks", cfg_t, probe_t, chunks=(1, 2, 31, 32, 33, 200))
    fired = out_t.alert_active[:6].sum(dim=1).cpu().numpy()
    if not np.array_equal(fired, fired_want):
        fail(f"tap_scan synthetic: the lanes near the thresholds fire {fired.tolist()}, "
             f"not {fired_want.tolist()}")
    say(f"[4h telemetry] tap_scan bitwise equal to its plain version on the card: {n_checked} "
        f"runs' probe series ({', '.join(tap_cases)}; each whole and in chunks from the carried "
        f"state) and a synthetic F{lanes_t} x T{T_t} past 2**24 (cum arrived up to "
        f"{float(out_t.gauges[:, 2].max()):.3e}) with lanes one float below, at and above each "
        f"threshold (firing slots, lane by monitor, as expected: {fired.tolist()}), whole and "
        "in 7 chunks")
    # the kernel's 256-slot tiles: F1, F32 and F512 at T 64, 192, 2000 and
    # 4100, past 2**24, whole and in chunks that end mid-tile and on tile
    # edges (a streamed run's launches), the backlog with +0/-0 ties
    tile_cases = ((1, 64), (1, 192), (32, 192), (512, 192), (1, 2000), (1, 4100))
    for F_x, T_x in tile_cases:
        rng_x = np.random.default_rng(F_x * 7919 + T_x)
        shape_x = (F_x, T_x)
        arr_x = rng_x.integers(0, 2**26, shape_x).astype(np.float32)
        proc_x = np.minimum(rng_x.integers(0, 2**26, shape_x).astype(np.float32), arr_x)
        back_x = np.cumsum(arr_x - proc_x, axis=-1, dtype=np.float64).astype(np.float32)
        back_x += rng_x.integers(0, 3, shape_x)
        back_x[0] = -back_x[0]  # lane 0 at most 0: its peak is the +0 among -0s
        back_x[0, :3] = (-0.0, 0.0, -0.0)
        syn_x = dict(emissions=rng_x.uniform(0, 1, shape_x) * 10.0 ** rng_x.integers(-3, 9, shape_x),
                     arrived=arr_x, processed=proc_x,
                     failed=np.minimum(rng_x.integers(0, 2**23, shape_x), proc_x),
                     wasted=rng_x.uniform(0, 3e4, shape_x), backlog=back_x,
                     stale=rng_x.integers(0, 9, shape_x), clouds_down=rng_x.integers(0, 6, shape_x),
                     retry_depth=np.zeros(shape_x), transfer_occupancy=np.zeros(shape_x),
                     missed=rng_x.integers(0, 3, shape_x) * (rng_x.uniform(size=shape_x) < 0.3),
                     shed=rng_x.integers(0, 2**20, shape_x) * (rng_x.uniform(size=shape_x) < 0.3))
        probe_x = tlm.TelemetryProbe(
            dispatched=torch.zeros(shape_x + (5,), device=dev),
            **{k: torch.as_tensor(np.ascontiguousarray(v), device=dev,
                                  dtype=torch.int32 if k == "stale" else torch.float32)
               for k, v in syn_x.items()})
        edges = tuple(sorted({c for c in (1, 255, 256, 257, T_x // 2 + 1, T_x - 1) if 0 < c < T_x}))
        tap_check(f"F{F_x} x T{T_x}", cfg_t, probe_x)
        tap_check(f"F{F_x} x T{T_x} in chunks", cfg_t, probe_x, chunks=edges)
    say("[4h telemetry] tap_scan bitwise equal to its plain version across its tiles, past 2**24 "
        "(lane 0's peak the +0 among -0s): " + ", ".join(
            f"F{f} x T{t}" for f, t in tile_cases) + ", each whole and in chunks at slots 1, "
        "255, 256, 257, T/2 + 1 and T - 1 (those inside the run)")

    # tap_scan's time at each case's shape, cold and warm, with its byte
    # bound; the row of phase 7 is bench_telemetry_overhead's fleet
    tap_times = []
    for label, tel_x in tap_cases.items():
        probe = probe_of(tel_x)
        lanes_x, T_x = tuple(probe.backlog.shape[:-1]), probe.backlog.shape[-1]
        out_x = tpk.TapOut.empty(lanes_x, T_x, dev)
        st_x = torch.zeros(lanes_x + (7,), device=dev)
        nl = math.prod(lanes_x)
        call = lambda probe=probe, out_x=out_x, st_x=st_x, T_x=T_x: tpk.tap_scan_cuda(  # noqa: E731
            tcfg, probe, out_x, st_x, 0, T_x)
        times = graph_ms(call, reps=20, inner=20)
        nbytes = nl * (T_x * (10 * 4 + 8 * 4) + 2 * 7 * 4 + 8 * 4 + 18 * 4)
        nops = nl * T_x * 16
        tap_times.append({
            "shape": label, "times": times, "call_ms": cuda_ms(call, reps=10, inner=10),
            "plain_ms": cuda_ms(lambda probe=probe, out_x=out_x, st_x=st_x, T_x=T_x:
                                tpk.tap_scan_plain(tcfg, probe, out_x, st_x, 0, T_x),
                                reps=3, inner=1),
            "nbytes": nbytes, "nops": nops,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3})
        say(f"[4h time] tap_scan {label}: {times[1]:.5f} ms cold, {times[0]:.5f} ms warm (CUDA "
            f"graph replay, CUDA events, median) vs byte bound {tap_times[-1]['bound_ms']:.6f} ms "
            f"({nbytes / 1e6:.3f} MB); {tap_times[-1]['call_ms']:.5f} ms per eager call; plain "
            f"version {tap_times[-1]['plain_ms']:.3f} ms ({smi})")

    # tap_probe against its plain version on the card, on inputs whose sums
    # depend on their order (non-integral, mixed signs, 1e-3..1e9): every
    # sum a loop hands it (the landings by cloud, arrivals, the backlog's
    # Qe and Qc, the WAN loop's Qt and the faulted loops' retry pool, both
    # named sums and backlog parts) at the loops' shapes and off the
    # 32-grid; then the probe of each loop alone, timed against the
    # torch.sum calls it replaced (one a sum, with their kernels and memsets)
    g_p = torch.Generator(device=dev)
    g_p.manual_seed(SEED + 25)

    def order_data(shape):
        x = torch.rand(shape, generator=g_p, device=dev) * 10.0 ** torch.randint(
            -3, 9, shape, generator=g_p, device=dev).float()
        return torch.where(torch.rand(shape, generator=g_p, device=dev) < 0.3, -x, x)

    def probe_inputs(lanes_x, M_x, N_x, L_x=None, faulted=False, full=False):
        """a loop's probe inputs and backlog parts; `full`: every sum the
        kernel takes at once (six jobs, four backlog parts)"""
        inputs = {"dispatched": order_data(lanes_x + (M_x, N_x))}
        if full or not faulted:
            inputs["arrived"] = order_data(lanes_x + (M_x,))
        inputs["part0"], inputs["part1"] = order_data(lanes_x + (M_x,)), \
            order_data(lanes_x + (M_x, N_x))
        parts = ["part0", "part1"]
        if L_x:
            inputs["transfer_occupancy"] = order_data(lanes_x + (M_x, L_x))
            parts.append("transfer_occupancy")
        if faulted or full:
            inputs["retry_depth"] = order_data(lanes_x + (M_x, N_x))
            parts.append("retry_depth")
        return inputs, parts

    def probe_plan(lanes_x, inputs, parts, T_x=4):
        series = {n: torch.zeros(lanes_x + (T_x,), device=dev)
                  for n in ("arrived", "transfer_occupancy", "retry_depth", "backlog")}
        series["dispatched"] = torch.zeros(lanes_x + (T_x, inputs["dispatched"].shape[-1]),
                                           device=dev)
        plan = tpk.ProbePlan(lanes_x, T_x, inputs, {n: series[n] for n in inputs if n in series},
                             parts, series["backlog"], by_column=("dispatched",))
        return series, plan

    probe_shapes = {  # label: (lanes, M, N, L)
        f"main F1 x M{M_MAIN} x N{N_MAIN}": ((), M_MAIN, N_MAIN, None),
        f"fleet B F{F_B} x M{M_MAIN} x N{N_MAIN}": ((F_B,), M_MAIN, N_MAIN, None),
        f"W2 F{F_B} x M{M_MAIN} x N{N_MAIN} x L{2 * N_MAIN}": ((F_B,), M_MAIN, N_MAIN, 2 * N_MAIN),
        f"bench fleet F{tel_fleet.F} x M5 x N5": ((tel_fleet.F,), 5, 5, None),
        "fleet A F512 x M5 x N5": ((512,), 5, 5, None),
        "W1 F64 x M5 x N5 x L10": ((64,), 5, 5, 10),
        f"stream M{M_STREAM} x N{N_STREAM}": ((), M_STREAM, N_STREAM, None),
        "F3 x M33 x N5": ((3,), 33, 5, None), "F2 x M127 x N63": ((2,), 127, 63, None),
        "M63 x N5 x L40": ((), 63, 5, 40),
    }
    for label, (lanes_x, M_x, N_x, L_x) in probe_shapes.items():
        inputs, parts = probe_inputs(lanes_x, M_x, N_x, L_x, full=True)
        outs = []
        for fn in (tpk.tap_probe_cuda, tpk.tap_probe_plain):
            series, plan = probe_plan(lanes_x, inputs, parts)
            for t in (0, 3):
                fn(plan, t, inputs)
            outs.append(series)
        torch.cuda.synchronize()
        bad = [n for n in outs[0] if not same_bits(outs[0][n], outs[1][n])]
        if bad:
            fail(f"tap_probe {label}: {bad} differ from the plain version")
        for n in outs[0]:
            err = float((outs[0][n] - outs[1][n]).abs().max())
            max_err["tap_probe"] = max(max_err["tap_probe"], err)
        del inputs, outs
    say(f"[4h telemetry] tap_probe bitwise equal to its plain version on the card at "
        f"{', '.join(probe_shapes)}: landings by cloud, arrivals, Qe, Qc, Qt (where L) and the "
        "retry pool, named sums and four backlog parts in one launch, slots 0 and 3")

    # the counters each group and lane keeps reset themselves: at main and
    # fleet B, two plans (the loop's probe on two sets of inputs) launched
    # in turns on one stream, 64 slots each, captured in one CUDA graph and
    # replayed; every slot of both bitwise the plain version
    T_GR = 64
    for label in (f"main F1 x M{M_MAIN} x N{N_MAIN}", f"fleet B F{F_B} x M{M_MAIN} x N{N_MAIN}"):
        lanes_x, M_x, N_x, _ = probe_shapes[label]
        pairs = [probe_inputs(lanes_x, M_x, N_x) for _ in range(2)]
        kern = [probe_plan(lanes_x, x_, parts_, T_GR) for x_, parts_ in pairs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # the argument blocks and counters, made before capture
            for (_, plan_), (x_, _) in zip(kern, pairs):
                tpk.tap_probe_cuda(plan_, 0, x_)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        for series_, _ in kern:
            for v_ in series_.values():
                v_.zero_()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for t_ in range(T_GR):
                for (_, plan_), (x_, _) in zip(kern, pairs):
                    tpk.tap_probe_cuda(plan_, t_, x_)
        graph.replay()
        torch.cuda.synchronize()
        for (series_, _), (x_, parts_) in zip(kern, pairs):
            want_, plan_w = probe_plan(lanes_x, x_, parts_, T_GR)
            for t_ in range(T_GR):
                tpk.tap_probe_plain(plan_w, t_, x_)
            bad = [n for n in series_ if not same_bits(series_[n], want_[n])]
            if bad:
                fail(f"tap_probe {label}: {bad} differ from the plain version over {T_GR} "
                     "graph-replayed slots of two plans in turns")
        del pairs, kern, graph
    say(f"[4h telemetry] tap_probe: two plans in turns on one stream, {T_GR} slots each in one "
        f"CUDA graph, at main and fleet B: every slot bitwise the plain version")


    probe_loops = {  # the loops' own probes: (lanes, M, N, L, faulted)
        f"main F1 x M{M_MAIN} x N{N_MAIN}": ((), M_MAIN, N_MAIN, None, False),
        f"fleet B F{F_B} x M{M_MAIN} x N{N_MAIN}": ((F_B,), M_MAIN, N_MAIN, None, False),
        f"W2 F{F_B} x M{M_MAIN} x N{N_MAIN} x L{2 * N_MAIN}": ((F_B,), M_MAIN, N_MAIN, 2 * N_MAIN,
                                                               False),
        f"bench fleet F{tel_fleet.F} x M5 x N5": ((tel_fleet.F,), 5, 5, None, False),
        f"stream M{M_STREAM} x N{N_STREAM}": ((), M_STREAM, N_STREAM, None, False),
        f"fleet B faulted F{F_B} x M{M_MAIN} x N{N_MAIN}": ((F_B,), M_MAIN, N_MAIN, None, True),
    }
    probe_times = []
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.split()[0])
    for label, (lanes_x, M_x, N_x, L_x, faulted) in probe_loops.items():
        inputs, parts = probe_inputs(lanes_x, M_x, N_x, L_x, faulted=faulted)
        series, plan = probe_plan(lanes_x, inputs, parts)
        call = lambda plan=plan, inputs=inputs: tpk.tap_probe_cuda(plan, 1, inputs)  # noqa: E731
        nl = lanes_x[0] if lanes_x else 1
        e1 = tuple(range(len(lanes_x), len(lanes_x) + 1))
        e2 = tuple(range(len(lanes_x), len(lanes_x) + 2))

        def torch_sums(inputs=inputs, series=series, e1=e1, e2=e2):
            """the probe as one torch call a sum and the add"""
            torch.sum(inputs["dispatched"], dim=-2, out=series["dispatched"][..., 1, :])
            if "arrived" in inputs:
                torch.sum(inputs["arrived"], dim=e1, out=series["arrived"][..., 1])
            totals = [torch.sum(inputs["part0"], dim=e1), torch.sum(inputs["part1"], dim=e2)]
            for n in ("transfer_occupancy", "retry_depth"):
                if n in inputs:
                    totals.append(torch.sum(inputs[n], dim=e2, out=series[n][..., 1]))
            acc = totals[0]
            for x in totals[1:-1]:
                acc = acc + x
            torch.add(acc, totals[-1], out=series["backlog"][..., 1])

        times = graph_ms(call, reps=20, inner=20)
        lib = graph_ms(torch_sums, reps=20, inner=20)
        nbytes = 4 * (sum(x.numel() for x in inputs.values()) + nl * (N_x + len(inputs)))
        probe_times.append({
            "shape": label, "times": times, "call_ms": cuda_ms(call, reps=10, inner=10),
            "plain_ms": cuda_ms(lambda plan=plan, inputs=inputs: tpk.tap_probe_plain(
                plan, 1, inputs), reps=3, inner=1),
            "library_ms": lib[1], "library_warm_ms": lib[0], "nbytes": nbytes,
            "nops": sum(x.numel() for x in inputs.values()),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "serial_adds": plan.longest_chain(),
            "serial_floor_ms": plan.longest_chain() * 4 / clk / 1e3})
        say(f"[4h time] tap_probe {label}: {times[1]:.5f} ms cold, {times[0]:.5f} ms warm (CUDA "
            f"graph replay, CUDA events, median) vs byte bound {probe_times[-1]['bound_ms']:.6f} ms "
            f"({nbytes / 1e6:.3f} MB) and serial floor {probe_times[-1]['serial_floor_ms']:.5f} ms "
            f"({plan.longest_chain()} dependent adds of 4 cycles at {clk:.0f} MHz); the torch.sum "
            f"calls it replaced {lib[1]:.5f} ms cold, {lib[0]:.5f} warm; "
            f"{probe_times[-1]['call_ms']:.5f} ms per eager call; plain version "
            f"{probe_times[-1]['plain_ms']:.3f} ms ({smi})")
    say("[4h telemetry] launches over the phase's driven runs: " + ", ".join(
        f"{k} {v}" for k, v in tap_counts.items() if v) + f"; {time.perf_counter() - t0:.1f} s")
    del tap_cases, a_res, tel_fleet

    # ---- 4i. the scheduler's extensions --------------------------------
    clock.start("4i")
    # ExactDPPPolicy (one score pass and one knapsack_dp launch a slot) on
    # the Fig. 2 setup, held to JAX's reduction (EXACT_JAX) and card vs
    # CPU; on fleet A's shape, lanes vs alone and card vs CPU; with the
    # plain DP swapped in, what the kernel replaces; ThresholdPolicy at the
    # main width; the AdaptiveVController loop card vs CPU; the oracles'
    # bounds under every policy's emissions; conservation on every lane
    p5 = paper_spec().to(dev)
    rand5, arrive5 = core.RandomCarbonSource(N=5), core.UniformArrivals(M=5, amax=A_MAX)
    exact = core.ExactDPPPolicy(V=V_PAPER, grid=KP_GRID)
    threshold = ext.ThresholdPolicy(THRESHOLD)
    ext_counts = {}

    def counted(tag, fn, want):
        """fn() under sync debug mode "error", the launch counters set to
        0 just before and read just after; `want` {kernel: launches}."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = ops.launch_counts()
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad:
            fail(f"{tag}: launches (got, expected) {bad}")
        ext_counts[tag] = {k: v for k, v in got.items() if v}
        say(f"[4i extensions] {tag} under sync debug mode 'error': launches "
            f"{ext_counts[tag]}; {secs:.2f} s")
        return res

    def paper_run(pol, T, d, record="summary"):
        return core.simulate(pol, p5 if d == dev else paper_spec(), rand5, arrive5, T, SEED,
                             record=record, device=d)

    def conserved(res, a, q0=0.0) -> bool:
        """Every lane and slot: Qe + sum Qc = q0 + cum(arrivals - processed)
        (res recorded in full; a [T, ..., M] arrivals)."""
        a_t = a.double().sum(-1).movedim(0, -1)
        flow = q0 + torch.cumsum(a_t - res.processed.double(), dim=-1)
        held = res.Qe.double().sum(-1) + res.Qc.double().sum((-2, -1))
        return torch.equal(held, flow)

    def arrivals_of(source, T, F=None):
        """The arrivals a run from SEED draws, [T, (F,) M]."""
        keys = jr.PRNGKey(SEED, device=dev) if F is None else jr.split(
            jr.PRNGKey(SEED, device=dev), F)
        return source.block(0, T, jr.split(keys, 3)[..., 1, :].contiguous(), dev)

    # (a) the Fig. 2 setup: EXACT_JAX, launches, card vs CPU, conservation
    ex_runs = {
        "ExactDPP": counted(f"ExactDPP Fig. 2 M5xN5 grid {KP_GRID} T={T_PAPER}",
                            lambda: paper_run(exact, T_PAPER, dev),
                            {"knapsack_dp": T_PAPER, "carbon_scores": T_PAPER, "greedy_fill": 0}),
        "QueueLength": counted(f"QueueLength Fig. 2 T={T_PAPER}",
                               lambda: paper_run(policies["QueueLength"], T_PAPER, dev),
                               {"knapsack_dp": 0}),
        "CarbonIntensity": counted(f"CarbonIntensity Fig. 2 T={T_PAPER}",
                                   lambda: paper_run(policies["CarbonIntensity"], T_PAPER, dev),
                                   {"knapsack_dp": 0}),
        "Threshold": counted(f"Threshold({THRESHOLD:g}) Fig. 2 T={T_PAPER}",
                             lambda: paper_run(threshold, T_PAPER, dev),
                             {"knapsack_dp": 0, "carbon_scores": 0, "greedy_fill": T_PAPER}),
    }
    exact_launches = ext_counts[f"ExactDPP Fig. 2 M5xN5 grid {KP_GRID} T={T_PAPER}"]
    cum_ex = {k: float(r.cum_emissions[-1]) for k, r in ex_runs.items()}
    red_exact = 100.0 * (1.0 - cum_ex["ExactDPP"] / cum_ex["QueueLength"])
    if not abs(red_exact - EXACT_JAX) <= EXACT_TOL:
        fail(f"ExactDPP reduction {red_exact:.6f}% is not JAX's {EXACT_JAX:.6f}%")
    say(f"[4i extensions] Fig. 2 T={T_PAPER}: reduction vs QueueLength ExactDPP(V={V_PAPER}, "
        f"grid {KP_GRID}) {red_exact:.6f}% (JAX {EXACT_JAX:.6f}%, limit {EXACT_TOL:g} points), "
        f"CarbonIntensity {100.0 * (1.0 - cum_ex['CarbonIntensity'] / cum_ex['QueueLength']):.6f}%, "
        f"Threshold({THRESHOLD:g}) "
        f"{100.0 * (1.0 - cum_ex['Threshold'] / cum_ex['QueueLength']):.6f}%")
    a5 = arrivals_of(arrive5, T_EXACT_CPU)
    for pname, pol in (("ExactDPP", exact), ("Threshold", threshold)):
        gpu, cpu = paper_run(pol, T_EXACT_CPU, dev, "full"), paper_run(pol, T_EXACT_CPU, "cpu",
                                                                           "full")
        bad, rel = same_result(gpu, cpu, COUNTED), emission_rtol(gpu, cpu)
        if bad or rel > 1e-6 or not conserved(gpu, a5):
            fail(f"{pname} Fig. 2 T={T_EXACT_CPU}: card and CPU differ in {bad}, emissions rtol "
                 f"{rel:.3e}, or conservation fails")
        say(f"[4i extensions] {pname} Fig. 2 T={T_EXACT_CPU} card vs CPU plain path: "
            f"{', '.join(COUNTED)} bitwise equal, emissions max rel diff {rel:.3e} (limit 1e-6); "
            "conservation exact on every slot")
    # (b) the oracles: every bound at most each policy's emissions
    k_c = jr.split(jr.PRNGKey(SEED, device=dev), 3)[0]
    table5 = core.materialize(rand5, T_PAPER, k_c, device=dev)
    bounds = {}
    for pname, r in ex_runs.items():
        ee, ec = r.energy_edge.cpu().numpy(), r.energy_cloud.cpu().numpy()
        lb = ext.oracle_emissions_for_work(p5, table5, float(ee.sum()), ec.sum())
        hb = {h: ext.oracle_emissions_horizon(table5, ee, ec, horizon=h) for h in (8, None)}
        if not (lb <= cum_ex[pname] * 1.001 and all(b <= cum_ex[pname] * (1 + 1e-6)
                                                   for b in hb.values())):
            fail(f"oracle bound above {pname}'s emissions: {lb}, {hb}, {cum_ex[pname]}")
        bounds[pname] = (lb / cum_ex[pname], hb[8] / cum_ex[pname], hb[None] / cum_ex[pname])
    say("[4i extensions] oracles / emissions (for_work, horizon 8, full trace), each <= 1: "
        + ", ".join(f"{p} " + " / ".join(f"{x:.4f}" for x in v) for p, v in bounds.items()))
    # (c) what a slot costs: ExactDPP against CarbonIntensity in turns, its
    # device time (profiler), and the plain DP swapped in
    turns = {"ExactDPP": [], "CarbonIntensity": []}
    for pname in ("ExactDPP", "CarbonIntensity", "CarbonIntensity", "ExactDPP"):
        pol = exact if pname == "ExactDPP" else policies["CarbonIntensity"]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        paper_run(pol, T_EXACT_TURNS, dev)
        end.record()
        end.synchronize()
        turns[pname].append(start.elapsed_time(end) / T_EXACT_TURNS)
    prof, host = profile_slots(lambda: paper_run(exact, 8, dev), slots=8)
    n_aten = sum(v[1] for k, v in host.items() if k.startswith("aten::"))
    busy = "not measured" if prof is None else f"{prof['total']:.4f} ms"
    with swapped(ops, dict(knapsack_dp=kpk.knapsack_dp_plain)):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain_run = paper_run(exact, T_EXACT_PLAIN, dev)
        end.record()
        end.synchronize()
        plain_slot_ms = start.elapsed_time(end) / T_EXACT_PLAIN
        _, host_p = profile_slots(lambda: paper_run(exact, 2, dev), slots=2)
    n_aten_p = sum(v[1] for k, v in host_p.items() if k.startswith("aten::"))
    if same_result(plain_run, paper_run(exact, T_EXACT_PLAIN, dev), COUNTED):
        fail("ExactDPP with the plain DP on the card differs from the kernel's run")
    say(f"[4i extensions] ExactDPP Fig. 2 slot: in turns ExactDPP / CarbonIntensity / "
        f"CarbonIntensity / ExactDPP over T={T_EXACT_TURNS}: ExactDPP "
        + " / ".join(f"{x:.4f}" for x in turns["ExactDPP"]) + ", CarbonIntensity "
        + " / ".join(f"{x:.4f}" for x in turns["CarbonIntensity"])
        + f" ms/slot; {n_aten:.1f} aten op calls a slot, device busy {busy} a slot (profiler, 8 "
        f"slots); with the plain DP on the card {plain_slot_ms:.4f} ms/slot and {n_aten_p:.0f} "
        f"aten op calls a slot (T={T_EXACT_PLAIN}, the same queues and counts)")
    exact_slot = {"turns": turns, "aten": n_aten, "plain_ms": plain_slot_ms,
                  "plain_aten": n_aten_p}
    # (d) fleet A's shape: F512 x M5 x N5, T=192
    fa_res = counted(f"ExactDPP fleet A F{fleet_a.F} T={T_FLEET_A}",
                     lambda: core.simulate_fleet(exact, fleet_a, T_FLEET_A, SEED, record="full",
                                                 device=dev),
                     {"knapsack_dp": T_FLEET_A, "carbon_scores": T_FLEET_A, "greedy_fill": 0})
    fleet_exact_launches = ext_counts[f"ExactDPP fleet A F{fleet_a.F} T={T_FLEET_A}"]
    if not conserved(fa_res, arrivals_of(core.FleetArrivals(amax=fleet_a.arrival_amax),
                                         T_FLEET_A, fleet_a.F)):
        fail("ExactDPP fleet A: conservation fails on some lane")
    keys_a = jr.split(jr.PRNGKey(SEED, device=dev), fleet_a.F)
    for f in (0, fleet_a.F - 1):
        spec_f = core.NetworkSpec(*(x[f] for x in fleet_a.spec))
        one = core.simulate(exact, spec_f, core.TableCarbonSource(table=fleet_a.carbon[f]),
                            core.FleetArrivals(amax=fleet_a.arrival_amax[f]), T_FLEET_A,
                            keys_a[f], record="full", device=dev)
        lane = lane_of(fa_res, f)
        bad, rel = same_result(one, lane, COUNTED), emission_rtol(one, lane)
        if bad or rel > 1e-6:
            fail(f"ExactDPP fleet A: lane {f} differs from its instance alone in {bad}, "
                 f"emissions rtol {rel:.3e}")
    two_a = fleet_a._replace(spec=core.FleetSpec(*(x[:2] for x in fleet_a.spec)),
                             carbon=fleet_a.carbon[:2], arrival_amax=fleet_a.arrival_amax[:2])
    gpu = core.simulate_fleet(exact, two_a, T_FLEET_A, SEED, record="full", device=dev)
    cpu = core.simulate_fleet(exact, two_a.to("cpu"), T_FLEET_A, SEED, record="full",
                              device="cpu")
    bad, rel = same_result(gpu, cpu, COUNTED), emission_rtol(gpu, cpu)
    if bad or rel > 1e-6:
        fail(f"ExactDPP fleet A F2: card and CPU differ in {bad}, emissions rtol {rel:.3e}")
    say(f"[4i extensions] ExactDPP fleet A F{fleet_a.F} x M5 x N5 T={T_FLEET_A}: conservation "
        f"exact on every lane and slot; lanes 0 and {fleet_a.F - 1} bitwise equal to each "
        f"instance alone; F2 card vs CPU plain path {', '.join(COUNTED)} bitwise equal, "
        f"emissions max rel diff {rel:.3e} (limit 1e-6)")
    del fa_res, gpu, cpu
    # (e) ThresholdPolicy at the main width (phase 4's instance and sim)
    th_res = counted(f"Threshold({THRESHOLD:g}) M{M_MAIN}xN{N_MAIN} T={T_THRESH}",
                     lambda: sim(threshold, T_THRESH, "full", dev),
                     {"knapsack_dp": 0, "carbon_scores": 0, "greedy_fill": T_THRESH})
    q0 = float(state0_d.Qe.double().sum() + state0_d.Qc.double().sum())
    if not conserved(th_res, arrivals_of(inst["arrivals"], T_THRESH), q0):
        fail("Threshold main width: conservation fails")
    gated = int((inst["carbon"].table[:T_THRESH, 1:] >= THRESHOLD).sum())
    say(f"[4i extensions] Threshold({THRESHOLD:g}) main width: conservation exact on every slot "
        f"from the backlog; {gated} (slot, cloud) cells gated off; processed "
        f"{float(th_res.processed.sum()):.6e}")
    del th_res
    card_vs_cpu("4i threshold", {f"Threshold({THRESHOLD:g})": threshold}, sim, T_THRESH_CPU,
                ("Qe", "Qc", "processed", "dispatched"), dev)
    # (e2) ExactDPP at the main width (phase 4's instance and sim): one
    # knapsack_dp of 257 knapsacks of M4096 a slot; conservation from the
    # backlog; slot 0's edge and first-cloud counts against the plain DP on
    # the inputs the policy gave the kernel (the plain count table over all
    # 257 is the slow part); in turns with CarbonIntensity (ms/slot) and the
    # device's busy time a slot from the profiler (idle share)
    ex_tag = f"ExactDPP M{M_MAIN}xN{N_MAIN} grid {KP_GRID} T={T_EXACT_MAIN}"
    ex_res = counted(ex_tag, lambda: sim(exact, T_EXACT_MAIN, "full", dev),
                     {"knapsack_dp": T_EXACT_MAIN, "carbon_scores": T_EXACT_MAIN,
                      "greedy_fill": 0})
    if not conserved(ex_res, arrivals_of(inst["arrivals"], T_EXACT_MAIN), q0):
        fail("ExactDPP main width: conservation fails")
    del ex_res
    seen = {}

    def kernel_seen(*args):
        seen["args"], seen["out"] = args, kpk.knapsack_dp_cuda(*args)
        return seen["out"]

    Ce0, Cc0 = inst["carbon"](0, 0, dev)
    with swapped(ops, dict(knapsack_dp=kernel_seen)):
        exact(state0_d, spec_d, Ce0, Cc0)
    want0 = kpk.knapsack_dp_plain(*(x[:2] for x in seen["args"][:4]), KP_GRID)
    torch.cuda.synchronize()
    if not torch.equal(seen["out"][:2], want0):
        fail("ExactDPP main width: slot 0's edge or first-cloud counts differ from the plain DP")
    ex_turns = {"ExactDPP": [], "CarbonIntensity": []}
    for pname in ("ExactDPP", "CarbonIntensity", "CarbonIntensity", "ExactDPP"):
        pol = exact if pname == "ExactDPP" else policies["CarbonIntensity"]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        sim(pol, T_EXACT_MAIN, "summary", dev)
        end.record()
        end.synchronize()
        ex_turns[pname].append(start.elapsed_time(end) / T_EXACT_MAIN)
    prof_main, _ = profile_slots(lambda: sim(exact, 4, "summary", dev), slots=4)
    ex_slot = statistics.mean(ex_turns["ExactDPP"])
    busy_main = None if prof_main is None else prof_main["total"]
    exact_main = {"turns": ex_turns, "busy_ms": busy_main,
                  "idle": None if busy_main is None else 1.0 - busy_main / ex_slot,
                  "knapsack_ms": None if prof_main is None else sum(
                      v for k, v in prof_main.items() if "knapsack" in k)}
    say(f"[4i extensions] {ex_tag}: conservation exact on every slot from the backlog; slot 0's "
        f"edge and first-cloud counts ({seen['out'].shape[0]} knapsacks) bitwise the plain DP's; "
        f"in turns ExactDPP / CarbonIntensity / CarbonIntensity / ExactDPP: ExactDPP "
        + " / ".join(f"{x:.4f}" for x in ex_turns["ExactDPP"]) + ", CarbonIntensity "
        + " / ".join(f"{x:.4f}" for x in ex_turns["CarbonIntensity"]) + " ms/slot; device busy "
        + ("not measured" if busy_main is None else
           f"{busy_main:.4f} ms a slot, knapsack_dp {exact_main['knapsack_ms']:.4f}, idle share "
           f"{exact_main['idle']:.4f}") + " (profiler, 4 slots)")
    del seen
    # (f) the AdaptiveVController loop (tests/test_extensions.py's): the
    # card and the CPU read the same backlogs and walk V alike
    def adaptive(d):
        ctrl = ext.AdaptiveVController(target_backlog=ADAPTIVE_TARGET, V=0.001)
        spec = p5 if d == dev else paper_spec()
        kc, ka = jr.split(jr.PRNGKey(1, device=d), 2)
        st = core.init_state(5, 5, device=d)
        Vs, backlogs = [], []
        for t in range(T_ADAPTIVE):
            Ce, Cc = rand5(t, kc, d)
            a = arrive5(t, ka, d)
            act = ctrl.policy()(st, spec, Ce, Cc, a, None)
            st = core.step(st, act, a)
            backlogs.append(float(st.Qe.sum() + st.Qc.sum()))  # the controller's host read
            Vs.append(ctrl.update(backlogs[-1]))
        return Vs, backlogs, st

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    Vg, bg, sg = adaptive(dev)
    ad_counts = ops.launch_counts()
    Vc, bc, sc = adaptive("cpu")
    tail = statistics.fmean(bg[-80:])
    if (Vg != Vc or bg != bc or not torch.equal(sg.Qc.cpu(), sc.Qc)
            or ad_counts["carbon_scores"] != T_ADAPTIVE or ad_counts["greedy_fill"] != T_ADAPTIVE
            or not ADAPTIVE_TARGET / 5 < tail < 3 * ADAPTIVE_TARGET):
        fail(f"AdaptiveVController: card and CPU differ, launches {ad_counts}, or the tail "
             f"backlog {tail:.1f} is off its target")
    say(f"[4i extensions] AdaptiveVController T={T_ADAPTIVE} target {ADAPTIVE_TARGET:g}: V and "
        f"the backlog bitwise equal card vs CPU every slot, final queues equal; tail backlog "
        f"{tail:.1f}, final V {Vg[-1]:.6g}; launches {dict((k, v) for k, v in ad_counts.items() if v)}")

    # ---- 5. paper headline -----------------------------------------
    clock.start("5")
    pspec = paper_spec().to(dev)
    uk = core.UKRegionalTraceSource(N=5).to(dev)
    arrive = core.UniformArrivals(M=5, amax=400)
    cum = {}
    for pname, pol in policies.items():
        t0 = time.perf_counter()
        # the random sources draw on the card from per-slot generators:
        # the loop stays free of host syncs with them too
        torch.cuda.set_sync_debug_mode("error")
        try:
            r = core.simulate(pol, pspec, uk, arrive, T_PAPER, SEED, record="summary", device=dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        cum[pname] = float(r.cum_emissions[-1])
        say(f"[5 paper] {pname}: cumulative emissions {cum[pname]:.6e} over T={T_PAPER} under "
            f"sync debug mode 'error' ({1e3 * (time.perf_counter() - t0) / T_PAPER:.4f} ms/slot host)")
    reduction = 100.0 * (1.0 - cum["CarbonIntensity"] / cum["QueueLength"])
    if not 0.0 < reduction < 100.0:
        fail(f"paper headline reduction {reduction:.2f}% is not a reduction")
    say(f"[5 paper] emission reduction CarbonIntensity(V={V_PAPER}) vs QueueLength on the "
        f"UK-regional source: {reduction:.2f}% (paper: 54%)")

    # Fig. 2 on JAX's streams: RandomCarbonSource, UniformArrivals, PRNGKey(0)
    rand_src = core.RandomCarbonSource(N=5)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        base = core.simulate(policies["QueueLength"], pspec, rand_src, arrive, T_PAPER, SEED,
                             record="summary", device=dev)
        single = {V: core.simulate(core.CarbonIntensityPolicy(V=V), pspec, rand_src, arrive,
                                   T_PAPER, SEED, record="summary", device=dev) for V in VSWEEP}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fig2 = {V: 100.0 * (1.0 - float(single[V].cum_emissions[-1]) / float(base.cum_emissions[-1]))
            for V in VSWEEP}
    for V, want in FIG2_JAX.items():
        if not abs(fig2[V] - want) <= FIG2_TOL:
            fail(f"Fig. 2 reduction at V={V}: {fig2[V]:.6f}% is not JAX's {want:.6f}%")
    say(f"[5 paper] Fig. 2 on JAX's streams (RandomCarbonSource, UniformArrivals, PRNGKey({SEED}), "
        f"T={T_PAPER}, under sync debug mode 'error'): reduction CarbonIntensity vs QueueLength "
        + ", ".join(f"V={V} {fig2[V]:.6f}% (JAX {FIG2_JAX[V]:.6f}%)" for V in FIG2_JAX)
        + f"; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sweep = core.simulate_vsweep(lambda V: core.CarbonIntensityPolicy(V=V), VSWEEP, pspec,
                                 rand_src, arrive, T_PAPER, SEED, device=dev)
    sweep_h = core.simulate_vsweep(lambda V: core.CarbonIntensityPolicy(V=V), VSWEEP,
                                   paper_spec(), rand_src, arrive, T_PAPER, SEED, device="cpu")
    if same_result(sweep, sweep_h, ("Qe", "Qc", "dispatched", "processed")):
        fail("simulate_vsweep: card and CPU queues differ")
    for i, V in enumerate(VSWEEP):
        lane = lane_of(sweep, i)
        bad = same_result(single[V], lane, ("dispatched", "processed"))
        rel = emission_rtol(single[V], lane)
        if bad or rel > 1e-6 or not torch.equal(lane.Qc[-1], single[V].Qc[0]):
            fail(f"simulate_vsweep lane V={V} differs from simulate in {bad or ['Qc']}, "
                 f"emissions rtol {rel:.3e}")
    say(f"[5 paper] simulate_vsweep V {VSWEEP}, T={T_PAPER}: card vs CPU queues bitwise equal; "
        "each lane's queues and counts bitwise equal to its single-V simulate, emissions within "
        "rtol 1e-6; reductions "
        + ", ".join(f"{V} {fig2[V]:.4f}%" for V in VSWEEP) + f"; {time.perf_counter() - t0:.1f} s")
    del sweep, sweep_h, single

    # ---- 5b. WAN headline -------------------------------------------
    clock.start("5b")
    # the JAX bench's network/congested-uplink rows (phase 4d's W1 fleet):
    # its first WAN_INSTANCES lanes, each run alone through simulate(graph=)
    # with the lane's key, table and arrivals, from empty queues and links;
    # each equal to its fleet lane
    t0 = time.perf_counter()
    w1c = w1["congested-uplink"]
    keys_w1 = jr.split(jr.PRNGKey(SEED, device=dev), w1c.F)
    reductions = []
    for j in range(WAN_INSTANCES):
        spec_j = core.NetworkSpec(*(x[j] for x in w1c.spec))
        graph_j = net.LinkGraph(*(x[j] for x in w1c.graph))
        cum = {}
        for pname, pol in (("aware", aware), ("blind", blind)):
            r = core.simulate(pol, spec_j, core.TableCarbonSource(table=w1c.carbon[j]),
                              core.FleetArrivals(amax=w1c.arrival_amax[j]), T_WAN_HEADLINE,
                              keys_w1[j], record="summary", device=dev, graph=graph_j)
            lane = lane_of(w1_results[f"W1 congested-uplink {pname}"], j)
            bad, rel = same_result(r, lane, WAN_COUNTED), emission_rtol(r, lane)
            if bad or rel > 1e-6:
                fail(f"WAN headline instance {j} {pname}: differs from W1's lane {j} in {bad}, "
                     f"emissions rtol {rel:.3e}")
            cum[pname] = float(r.cum_emissions[-1])
        reductions.append(100.0 * (1.0 - cum["aware"] / cum["blind"]))
    wan_reduction = statistics.fmean(reductions)
    say(f"[5b wan] emission reduction NetworkAwareDPP(V={V_WAN}) vs StaticRoute(CarbonIntensity) "
        f"on congested-uplink M5xN5, T={T_WAN_HEADLINE}, mean of {WAN_INSTANCES} instances: "
        f"{wan_reduction:.2f}% (per instance " + ", ".join(f"{x:.2f}" for x in reductions)
        + f"); each instance's {', '.join(WAN_COUNTED)} bitwise equal to W1's lane, emissions "
        f"within rtol 1e-6; {time.perf_counter() - t0:.1f} s")
    if not wan_reduction > 5.0:
        fail(f"WAN headline reduction {wan_reduction:.2f}% is not above 5%")

    # ---- 6. serve_loop ---------------------------------------------
    clock.start("6")
    pol = policies["CarbonIntensity"]
    rep = serve_loop(pol, spec_d, inst["carbon"], inst["arrivals"], T_SERVE, SEED, device=dev)
    ref = core.simulate(pol, spec_d, inst["carbon"], inst["arrivals"], T_SERVE, SEED,
                        record="full", device=dev)
    ref_backlog = torch.stack([torch.sum(ref.Qe[t]) + torch.sum(ref.Qc[t])
                               for t in range(T_SERVE)]).cpu().numpy()
    if not (np.array_equal(rep.emissions, ref.emissions.cpu().numpy())
            and np.array_equal(rep.backlog, ref_backlog.astype(np.float64))
            and torch.equal(rep.state.Qe, ref.Qe[-1]) and torch.equal(rep.state.Qc, ref.Qc[-1])):
        fail("serve_loop trajectory differs from simulate on the card")
    say(f"[6 serve] M{M_MAIN}xN{N_MAIN} {T_SERVE} slots (warmup {rep.warmup}): decision latency "
        f"p50 {rep.p50_us:.1f} us, p95 {rep.p95_us:.1f} us, p99 {rep.p99_us:.1f} us; "
        f"{rep.tasks_per_sec:,.0f} tasks/sec; trajectory bitwise equal to simulate")
    # deadline-aware serving: deadline 4, admission control on
    serve_dl = dlm.make_deadlines(M_MAIN, device=dev, deadline=4.0, shed_on=1.0)
    pol_dl = dlm.SlackThresholdPolicy(V=V_PAPER)
    rep = serve_loop(pol_dl, spec_d, inst["carbon"], inst["arrivals"], T_SERVE, SEED, device=dev,
                     deadlines=serve_dl)
    ref = core.simulate(pol_dl, spec_d, inst["carbon"], inst["arrivals"], T_SERVE, SEED,
                        record="full", device=dev, deadlines=serve_dl)
    ref_backlog = torch.stack([torch.sum(ref.Qe[t]) + torch.sum(ref.Qc[t])
                               for t in range(T_SERVE)]).cpu().numpy()
    if not (np.array_equal(rep.emissions, ref.emissions.cpu().numpy())
            and np.array_equal(rep.backlog, ref_backlog.astype(np.float64))
            and torch.equal(rep.state.Qe, ref.Qe[-1]) and torch.equal(rep.state.Qc, ref.Qc[-1])
            and torch.equal(rep.dstate.Qd, ref.deadlines.Qd[-1])
            and rep.missed_total == float(ref.deadlines.missed.double().sum())
            and rep.shed_total == float(ref.deadlines.shed.double().sum())):
        fail("deadline-aware serve_loop trajectory differs from simulate on the card")
    say(f"[6 serve] deadline-aware (deadline 4, shed on, SlackThreshold) M{M_MAIN}xN{N_MAIN} "
        f"{T_SERVE} slots: decision latency p50 {rep.p50_us:.1f} us, p95 {rep.p95_us:.1f} us, "
        f"p99 {rep.p99_us:.1f} us; {rep.tasks_per_sec:,.0f} tasks/sec; missed "
        f"{rep.missed_total:g}, shed {rep.shed_total:g}; queue age p50/p95/p99 {rep.age_p50:g}/"
        f"{rep.age_p95:g}/{rep.age_p99:g}, over the deadline {rep.age_over_deadline_frac:.3f}; "
        "trajectory (queues, rings, counts) bitwise equal to simulate(deadlines=)")

    # ---- 10. MoE serving: Qwen1.5-MoE-A2.7B, Arctic at one layer ------
    clock.start("10")
    # (before phase 8, whose model phase 7 keeps: no two models are held)
    moe_cfgs = [registry.get_config(MOE_ARCH),
                dataclasses.replace(registry.get_config(MOE_WIDE_ARCH), n_layers=1)]
    moe_attention_routes(moe_cfgs, dev, fa, fd, attn_held, randn)
    attn_plain = dict(flash_attention=fa.flash_attention_plain,
                      flash_decode=fd.flash_decode_plain)
    moe_launches = {}
    for mcfg, mtag in zip(moe_cfgs, ("10 moe", "10 moe arctic")):
        name_m = mcfg.name + ("" if mcfg is moe_cfgs[0] else f" ({mcfg.n_layers} layer)")
        moe_launches[name_m] = moe_serve(mtag, mcfg, dev, ops, moe_lib, build_model,
                                         greedy_generate, attn_plain)

    # ---- 11. VLM serving: PaliGemma-3B at full size ------------------
    clock.start("11")
    # (after phase 10; its model is freed before phase 8 builds GLM-4-9B)
    vlm_cfg = registry.get_config(VLM_ARCH)
    vb = vlm_bounds(vlm_cfg)

    def vlm_checks(model, params, batch):
        """What GeGLU's GELU costs the prefill (XLA:CPU's rounding, its
        tanh's FMAs emulated in float64), and the bounds from the shapes."""
        gate = randn((LM_BATCH, LM_PROMPT, vlm_cfg.d_ff), bf16)
        gelu_ms = cuda_ms(lambda: lm_layers.gelu_tanh(gate), reps=2, inner=1)
        del gate
        say(f"[11 vlm] gelu_tanh on one layer's gate [{LM_BATCH}, {LM_PROMPT}, {vlm_cfg.d_ff}] bf16 "
            f"(tanh_xla's nine FMAs, each emulated in float64): {gelu_ms:.1f} ms (CUDA events, "
            f"eager), x {vlm_cfg.n_layers} layers = {gelu_ms * vlm_cfg.n_layers:.0f} ms of the prefill")
        from repro_torch.models.serving import _logits

        x_last = randn((LM_BATCH, vlm_cfg.d_model), bf16)
        logit_ms = cuda_ms(lambda: _logits(params, x_last, vlm_cfg), reps=5, inner=3)
        emb = vlm_cfg.vocab_size * vlm_cfg.d_model
        say(f"[11 vlm] the tied unembedding (`_logits`: embed.T cast to float32, "
            f"{4 * emb / 1e9:.2f} GB written a call, then the float32 product): {logit_ms:.3f} ms "
            f"a call (CUDA events, eager), one a prefill and one a decode step; the bytes it moves "
            f"(bf16 read, float32 written and read) {10 * emb / HBM_BYTES_PER_S * 1e3:.3f} ms at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, the function's own (the bf16 table once) "
            f"{2 * emb / HBM_BYTES_PER_S * 1e3:.3f} ms")
        del x_last
        say(f"[11 vlm] bounds from the shapes: prefill {vb['prefill_ops'] / 1e12:.2f} TFLOP "
            f"({vb['layers_ops'] / 1e12:.2f} in the layers' products, "
            f"{vb['attn_ops'] / 1e12:.3f} in attention over "
            f"{prefix_pairs(LM_PROMPT, vlm_cfg.prefix_len):,} prefix-mask pairs a head, "
            f"{vb['logits_ops'] / 1e9:.2f} G in the last position's logits), "
            f"{vb['prefill_ops'] / BF16_OPS_PER_S * 1e3:.1f} ms at "
            f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16; a decode step "
            f"{vb['step_bytes'] / 1e9:.2f} GB ({vb['layer_bytes'] / 1e9:.2f} of layer weights, "
            f"{vb['unembed_bytes'] / 1e9:.2f} of tied unembedding, {vb['cache_bytes'] / 1e9:.3f} "
            f"of KV cache), {vb['step_bytes'] / HBM_BYTES_PER_S * 1e3:.2f} ms at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; weights {vb['weight_bytes'] / 1e9:.2f} GB, "
            f"cache {vb['cache_bytes'] / 1e6:.1f} MB")

    vlm_launches = serve_lm(
        "11 vlm", vlm_cfg, dict(flash_attention=vlm_cfg.n_layers,
                                flash_decode=vlm_cfg.n_layers * LM_GEN),
        attn_plain, "plain attention", dev, ops, build_model, greedy_generate,
        before_checks=vlm_checks, compare_layers=COMPARE_LAYERS[vlm_cfg.name])[0]
    torch.cuda.empty_cache()  # the model's weights go before phase 12's

    # ---- 12. enc-dec serving: SeamlessM4T-medium at full size --------
    # (after phase 11; its model is freed before phase 8 builds GLM-4-9B)
    clock.start("12")
    encdec_cfg = registry.get_config(ENCDEC_ARCH)
    encdec_launches = encdec_serve("12 encdec", encdec_cfg, dev, ops, build_model, greedy_generate,
                                   attn_plain, randn, lm_layers.gelu_tanh)

    # ---- 13. training: Qwen1.5-0.5B at full size, the orchestrator --------
    # (after phase 12; its models are freed before phase 8 builds GLM-4-9B)
    clock.start("13")
    train_info = train_phase(dev, ops, fa, smi)
    torch.cuda.empty_cache()

    # ---- 13s. training: mamba2-1.3B at full size -------------------------
    # (after phase 13; its model is freed before phase 8 builds GLM-4-9B)
    clock.start("13s")
    ssm_train_info = train_steps(
        "13s train ssm", registry.get_config(SSM_ARCH), dev, ops,
        {"ssd_chunk_intra": ops.ssd_chunk_intra_with(sdc.ssd_chunk_intra_plain,
                                                     sdc.ssd_chunk_intra_bwd_plain)},
        {"ssd_chunk_intra": 2, "ssd_chunk_intra_bwd": 1}, smi,
        compare_layers=COMPARE_LAYERS[registry.get_config(SSM_ARCH).name])
    torch.cuda.empty_cache()

    # ---- 8. LM serving: GLM-4-9B, prefill + KV-cache decode ----------
    clock.start("8")
    lm_cfg = registry.get_config(LM_ARCH)
    lm_launches, model, params, prompts = serve_lm(
        "8 lm", lm_cfg, dict(flash_attention=lm_cfg.n_layers, flash_decode=lm_cfg.n_layers * LM_GEN),
        dict(flash_attention=fa.flash_attention_plain, flash_decode=fd.flash_decode_plain),
        "plain attention", dev, ops, build_model, greedy_generate,
        compare_layers=COMPARE_LAYERS[lm_cfg.name])

    # ---- 9. SSM serving: mamba2-1.3B, prefill + state decode --------
    clock.start("9")
    ssm_cfg = registry.get_config(SSM_ARCH)
    ssm_launches, *_ = serve_lm(
        "9 ssm", ssm_cfg, dict(ssd_chunk_intra=ssm_cfg.n_layers),
        dict(ssd_chunk_intra=sdc.ssd_chunk_intra_plain), "plain SSD", dev, ops, build_model,
        greedy_generate, compare_layers=COMPARE_LAYERS[ssm_cfg.name])

    # ---- 7. kernel times at the main path's shapes -------------------
    clock.start("7")
    # inputs as the main path's last slot hands them to each kernel
    st, st_ql = finals["CarbonIntensity"], finals["QueueLength"]
    pe, pc, Pe, Pc = spec_d.as_arrays(dev)
    V = torch.full((), V_PAPER, device=dev)
    Ce, Cc = inst["carbon"](T_MAIN - 1, 0, dev)
    vcc, vce = V * Cc, V * Ce
    score_args = (st.Qc, pc, st.Qe, pe, vcc, vce)
    c, n1, b = cs.carbon_scores_cuda(*score_args)
    fill_args = (torch.cat([b[None], c.T]), torch.cat([pe[None], pc.T]),
                 torch.cat([st.Qe[None], st.Qc.T]), torch.cat([Pe.reshape(1), Pc]))
    ql_scores = torch.cat([torch.where(st_ql.Qe > 0, -st_ql.Qe, 1.0)[None],
                           torch.where(st_ql.Qc > 0, -st_ql.Qc, 1.0).T])
    ql_args = (ql_scores, fill_args[1], torch.cat([st_ql.Qe[None], st_ql.Qc.T]), fill_args[3])
    M, N, B = M_MAIN, N_MAIN, N_MAIN + 1
    rows = []

    def row(kname, source, replaces, launches, times, call_ms, plain_ms, nbytes, nops,
            ops_per_s=FP32_OPS_PER_S, library_ms=None, ops_ms=None):
        """ops_ms, where given, is the operations' bound in place of
        nops / ops_per_s (operations of more than one type)."""
        warm_ms, ms = times
        bound_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_o = nops / ops_per_s * 1e3 if ops_ms is None else ops_ms
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err[kname], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bound_b, bound_o),
            "bound_by": "bytes" if bound_b >= bound_o else "operations", "library_ms": library_ms,
        })
        say(f"[7 time] {kname}: {ms:.5f} ms device time from a cold L2, {warm_ms:.5f} ms warm "
            f"(CUDA graph replay, CUDA events, median) vs bound {max(bound_b, bound_o):.5f} ms "
            f"({nbytes / 1e6:.2f} MB, {nops / 1e6:.1f} M ops); {call_ms:.5f} ms per eager call; "
            f"plain version {plain_ms:.3f} ms"
            + (f"; library call {library_ms:.5f} ms" if library_ms is not None else ""))

    ms = graph_ms(lambda: cs.carbon_scores_cuda(*score_args), reps=20, inner=50)
    call_ms = cuda_ms(lambda: cs.carbon_scores_cuda(*score_args), reps=20, inner=50)
    plain_ms = cuda_ms(lambda: cs.carbon_scores_plain(*score_args), reps=5, inner=3)
    row("carbon_scores", "src/repro_torch/kernels/csrc/carbon_score.cu",
        "src/repro/kernels/carbon_score.py:69", main_launches["carbon_scores"], ms, call_ms,
        plain_ms,
        nbytes=4 * (3 * M * N + 4 * M + N + 1), nops=3 * M * N + 2 * M)

    # greedy_fill: scores and energies are read and counts written for
    # every item; caps are read, and the walk steps, only for the
    # negative-score items of this run's inputs
    n_neg = int((fill_args[0] < 0).sum())
    ms = graph_ms(lambda: gf.greedy_fill_cuda(*fill_args), reps=10, inner=10)
    call_ms = cuda_ms(lambda: gf.greedy_fill_cuda(*fill_args), reps=10, inner=10)
    ms_ql = graph_ms(lambda: gf.greedy_fill_cuda(*ql_args, stop_at_first_unfit=False,
                                                 sort_key=ql_scores), reps=10, inner=10)[1]
    plain_ms = cuda_ms(lambda: gf.greedy_fill_plain(*fill_args), reps=3, inner=1)
    L = max(1, (M - 1).bit_length())  # bitonic sort over 2^L slots: 2^(L-1) * L(L+1)/2 compares
    row("greedy_fill", "src/repro_torch/kernels/csrc/greedy_fill.cu",
        "src/repro/core/policies.py:53", main_launches["greedy_fill"], ms, call_ms, plain_ms,
        nbytes=4 * (3 * B * M + n_neg + B),
        nops=B * (2 * M + (1 << (L - 1)) * L * (L + 1) // 2) + 4 * n_neg)
    for ft in fleet_times.values():
        rows[0].setdefault("fleet", []).append({
            "shape": ft["shape"], "launches": ft["launches"].get("carbon_scores", 0),
            "ms": ft["scores"][1], "bound_ms": ft["scores_bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"})
        rows[1].setdefault("fleet", []).append({
            "shape": f"{ft['fill_rows']}x{ft['shape'].split('xN')[0].split('M')[1]}",
            "launches": ft["launches"].get("greedy_fill", 0), "ms": ft["fill"][1],
            "bound_ms": ft["fill_bytes"] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"})
    n_neg_ql = int((ql_scores < 0).sum())
    say(f"[7 time] greedy_fill with QueueLength inputs (sort_key, no stop): {ms_ql:.5f} ms device "
        f"time (cold L2), {n_neg_ql} negative-score items; the row above had CarbonIntensity inputs, "
        f"{n_neg} negative-score items over {B} lanes")
    # where the time goes, same inputs: with every budget 0 no lane
    # certifies or walks past its first item (keys, sort, thresholds);
    # with every score non-negative no item is live (keys only)
    parts = {}
    for label, args, kw in (("CarbonIntensity", fill_args, {}),
                            ("QueueLength", ql_args,
                             dict(stop_at_first_unfit=False, sort_key=ql_scores))):
        zero_P = torch.zeros_like(args[3])
        no_live = (args[0].abs(), *args[1:])
        no_live_kw = dict(kw, sort_key=no_live[0]) if "sort_key" in kw else kw
        parts[label] = (
            graph_ms(lambda: gf.greedy_fill_cuda(*args[:3], zero_P, **kw), reps=10, inner=10)[1],
            graph_ms(lambda: gf.greedy_fill_cuda(*no_live, **no_live_kw), reps=10, inner=10)[1])
    say("[7 time] greedy_fill's parts, cold: " + "; ".join(
        f"{label} inputs with every budget 0 (keys, sort, thresholds; no walk) {a:.5f} ms, "
        f"with every score non-negative (keys only) {k:.5f} ms" for label, (a, k) in parts.items())
        + f"; the full fills above {ms[1]:.5f} and {ms_ql:.5f} ms")
    # what the classified walk leaves on the chain, from the design in
    # plain PyTorch on the same inputs (its counts checked against the kernel)
    clk_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    for label, args, kw in (("CarbonIntensity (stop)", fill_args, {}),
                            ("CarbonIntensity (no stop)", fill_args,
                             dict(stop_at_first_unfit=False)),
                            ("CarbonIntensity (literal)", fill_args,
                             dict(literal_edge_budget=True)),
                            ("QueueLength (sort_key, no stop)", ql_args,
                             dict(stop_at_first_unfit=False, sort_key=ql_scores))):
        counts, certified, steps, exact = gf.fill_walk_profile(*args, **kw)
        if not same_bits(counts, gf.greedy_fill_cuda(*args, **kw)):
            fail(f"greedy_fill {label}: fill_walk_profile's counts differ from the kernel's")
        walked = torch.where(certified, -1, steps)
        lane = int(walked.argmax())
        n_steps, n_exact = max(0, int(walked[lane])), int(exact[lane])
        say(f"[7 time] greedy_fill walk, {label} inputs (fill_walk_profile): "
            f"{int(certified.sum())} of {B} lanes certified (edge lane "
            f"{'certified' if bool(certified[0]) else 'walks'}); longest uncertified walk "
            f"{n_steps} steps (lane {lane}), {n_exact} of them exact; its chain {n_steps} x 4 "
            f"cycles at {clk_mhz:.0f} MHz (clocks.max.sm) = {n_steps * 4 / clk_mhz:.4f} us")
    # a class A step's cost: one lane of M items, every score negative,
    # whose budget covers all but half the last item (it walks every item;
    # the last binds), against the same lane certified (it walks none)
    S1, E1, C1 = rand((1, M), -100, -1), rand((1, M), 0.5, 10), ints((1, M), 49) + 1
    cover = float((C1.double() * E1.double()).sum())
    last = float((C1 * E1)[0, torch.sort(S1 / E1, stable=True).indices[0, -1]])
    lane_ms = {}
    for label, P0 in (("walks", cover - last / 2), ("certified", cover * 1.01)):
        P1 = torch.full((1,), P0, device=dev)
        got, (_, certified, steps, _) = (gf.greedy_fill_cuda(S1, E1, C1, P1),
                                         gf.fill_walk_profile(S1, E1, C1, P1))
        if not same_bits(got, gf.greedy_fill_plain(S1, E1, C1, P1)):
            fail(f"greedy_fill step lane ({label}): counts differ from the plain version")
        lane_ms[label] = (graph_ms(lambda: gf.greedy_fill_cuda(S1, E1, C1, P1), reps=10,
                                   inner=5)[1], int(steps[0]), bool(certified[0]))
    (walk_ms, walk_steps, _), (cert_ms, _, cert_ok) = lane_ms["walks"], lane_ms["certified"]
    step_ns = (walk_ms - cert_ms) * 1e6 / max(1, walk_steps)
    say(f"[7 time] greedy_fill class A step: one lane of {M} items walking all {walk_steps} "
        f"(the last binds) {walk_ms:.5f} ms cold, the same lane certified ({cert_ok}) "
        f"{cert_ms:.5f} ms: {step_ns:.2f} ns = {step_ns * clk_mhz / 1e3:.1f} cycles a step at "
        f"{clk_mhz:.0f} MHz")
    say("[7 time] greedy_fill_kernel: "
        + " | ".join(ptxas_lines(built["greedy_fill"][1], "greedy_fill_kernel")))

    # route_scores: inputs as the WAN path's last NetworkAwareDPP slot
    # hands them, in the mode without extra that the path runs; the
    # mode with extra (route_compute_weight != 0) on the same inputs
    Qt_f, Qc_f, Qe_f = wan_final.Qt[0], wan_final.Qc[0], wan_final.Qe[0]
    wpe = wspec_d.as_arrays(dev)[0]
    Vw = torch.full((), V_WAN, device=dev)
    wCe, wCc = wcarbon(T_MAIN - 1, 0, dev)
    VCt = Vw * torch.cat([wCe.reshape(1), wCc]).index_select(0, wgraph_d.region)
    route_args = (Qt_f, wgraph_d.pt, Qc_f.index_select(1, wgraph_d.dest), None, Qe_f, wpe, VCt,
                  Vw * wCe)
    extra = rand(tuple(Qt_f.shape), 0, 50)
    extra_args = route_args[:3] + (extra,) + route_args[4:]
    Lw = wgraph_d.L
    ms = graph_ms(lambda: rs.route_scores_cuda(*route_args), reps=20, inner=50)
    call_ms = cuda_ms(lambda: rs.route_scores_cuda(*route_args), reps=20, inner=50)
    plain_ms = cuda_ms(lambda: rs.route_scores_plain(*route_args), reps=5, inner=3)
    row("route_scores", "src/repro_torch/kernels/csrc/route_score.cu",
        "src/repro/kernels/route_score.py:82", wan_launches["route_scores"], ms, call_ms,
        plain_ms, nbytes=4 * (4 * M * Lw + 4 * M + Lw + 1), nops=3 * M * Lw + 2 * M)
    rows[-1]["fleet"] = route_fleet_times
    warm_x, cold_x = graph_ms(lambda: rs.route_scores_cuda(*extra_args), reps=20, inner=50)
    say(f"[7 time] route_scores with extra (route_compute_weight != 0): {cold_x:.5f} ms from a "
        f"cold L2, {warm_x:.5f} ms warm vs bound "
        f"{4 * (5 * M * Lw + 4 * M + Lw + 1) / HBM_BYTES_PER_S * 1e3:.5f} ms (bytes)")

    # flash_attention: the prefill shape (phase 3c's first case); the
    # library yardstick is PyTorch's fused attention on the same inputs
    q, k, v = attn_main
    B, H, S, hd = q.shape
    Ka = k.shape[1]
    ms = graph_ms(lambda: fa.flash_attention_cuda(q, k, v), reps=3, inner=2)
    call_ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v), reps=3, inner=2)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), reps=2, inner=1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                            enable_gqa=True), reps=3, inner=5)
    nops = 4 * B * H * hd * S * (S + 1) // 2  # q.k and p.v over the causal pairs
    row("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:87", lm_launches["flash_attention"], ms, call_ms,
        plain_ms, nbytes=2 * (2 * B * H * S * hd + 2 * B * Ka * S * hd), nops=nops,
        ops_per_s=BF16_OPS_PER_S, library_ms=lib_ms)
    rows[-1]["moe_launches"] = {n: c["flash_attention"] for n, c in moe_launches.items()}
    issued = nops * 3 // 2  # q.k, p_hi.v and p_lo.v on the tensor cores
    say(f"[7 time] flash_attention: bf16 runs on the tensor cores (wgmma, TMA), float32 on the "
        f"CUDA cores; the bf16 kernel issues {issued / 1e12:.3f} TFLOP of tensor-core work "
        f"(1.5x the function's, the split of P), {issued / BF16_OPS_PER_S * 1e3:.3f} ms at the "
        f"peak; {' | '.join(ptxas_lines(built['flash_attention'][1], 'attention_tc'))}; "
        f"x {lm_cfg.n_layers} layers = {ms[1] * lm_cfg.n_layers:.1f} ms of the prefill")
    del q, k, v, attn_main

    rows[-1]["train_launches_per_step"] = train_info["per_step"]["flash_attention"]

    def hd256_entry(entry, shape, launches, run, plain, lib, nbytes, nops, reps, inner):
        """A hd 256 entry of the attention rows (PaliGemma's shapes):
        `attn_shape_entry`'s times and bound beside the hd 256 instance's
        ptxas registers and spills (a spill store fails the run)."""
        kname = "flash_attention" if entry == "attention_tc" else "flash_decode"
        out = attn_shape_entry(kname, shape, launches, "11", run, plain, lib, nbytes, nops, reps,
                               inner, smi)
        out["ptxas"] = [ln for ln in ptxas_lines(built[kname][1], entry) if "<256>" in ln]
        spills = [int(n) for ln in out["ptxas"]
                  for n in re.findall(r"(\d+) bytes spill stores", ln)]
        if not spills or any(spills):
            fail(f"7: {entry}<256> spills (ptxas: {' | '.join(out['ptxas'])})")
        say(f"[7 time] {entry}<256>: " + " | ".join(out["ptxas"]))
        return out

    # flash_attention at PaliGemma's prefill (hd 256, MQA H 8 on K 1,
    # prefix 256): attention_tc<256>; its yardstick SDPA causal at the
    # same shape (timed only)
    Hv, Kv, hdv, Pv = (vlm_cfg.n_heads, vlm_cfg.n_kv_heads, vlm_cfg.resolved_head_dim,
                       vlm_cfg.prefix_len)
    q = randn((LM_BATCH, Hv, LM_PROMPT, hdv), bf16)
    k, v = (randn((LM_BATCH, Kv, LM_PROMPT, hdv), bf16) for _ in range(2))
    run = lambda: fa.flash_attention_cuda(q, k, v, mask_mode="prefix", prefix_len=Pv)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
    rows[-1]["hd256"] = hd256_entry(
        "attention_tc",
        f"PaliGemma-3B prefill B{LM_BATCH} H{Hv} K{Kv} S{LM_PROMPT} hd{hdv} prefix {Pv}",
        vlm_launches["flash_attention"], run,
        lambda: fa.flash_attention_plain(q, k, v, mask_mode="prefix", prefix_len=Pv), lib,
        nbytes=2 * (2 * LM_BATCH * Hv * LM_PROMPT * hdv + 2 * LM_BATCH * Kv * LM_PROMPT * hdv),
        nops=4 * LM_BATCH * Hv * hdv * prefix_pairs(LM_PROMPT, Pv), reps=3, inner=2)
    rows[-1]["hd256"]["f32_ptxas"] = [ln for ln in ptxas_lines(built["flash_attention"][1],
                                                               "attention_f32") if "<256>" in ln]
    say("[7 time] attention_f32<256> (float32 inputs): " + " | ".join(rows[-1]["hd256"]["f32_ptxas"]))
    del q, k, v, run, lib

    # SeamlessM4T's shapes (phase 12): encoder, cross step (beside it
    # flash_decode over the same cross cache), decode step
    fa_encdec, fd_encdec = encdec_attention_times(encdec_cfg, encdec_launches, dev, fa, fd,
                                                  attn_held, randn, smi)
    rows[-1].update(encdec_launches=encdec_launches["flash_attention"], other_shapes=fa_encdec)

    # flash_attention_bwd: phase 13's training shape (Qwen1.5-0.5B, B 8, H 16
    # on K 16, S 4096, hd 64, causal, bf16) from the forward kernel's
    # statistics; the library yardstick is the backward of PyTorch's fused
    # attention on the same inputs (timed only)
    tq, tk, tv, tg = (randn((TRAIN_BATCH, 16, TRAIN_SEQ, 64), bf16) for _ in range(4))
    _, lse, o32 = fa.flash_attention_cuda(tq, tk, tv, stats=True)
    bwd = lambda: fa.flash_attention_bwd_cuda(tq, tk, tv, tg, lse=lse, o32=o32)  # noqa: E731
    ms = graph_ms(bwd, reps=3, inner=1)
    call_ms = cuda_ms(bwd, reps=3, inner=1)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(tq, tk, tv, tg), reps=2, inner=1)
    lq, lk, lv = (x.detach().requires_grad_(True) for x in (tq, tk, tv))
    lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(lout, (lq, lk, lv), tg, retain_graph=True),
                     reps=3, inner=2)
    B, H, S, hd = tq.shape
    pairs = B * H * S * (S + 1) // 2
    # the function's work: S = q.k again, dP, dv, dq and dk, 2 hd FLOP a
    # causal pair each; q, k, v, dO read and dq, dk, dv written once, bf16
    row("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/layers.py:132",  # attention_scores_chunked: its XLA autodiff
        train_info["launches"]["flash_attention_bwd"], ms, call_ms, plain_ms,
        nbytes=2 * 7 * B * H * S * hd, nops=5 * 2 * hd * pairs, ops_per_s=BF16_OPS_PER_S,
        library_ms=lib_ms)
    rows[-1]["launches_per_step"] = train_info["per_step"]["flash_attention_bwd"]
    bwd_log = built["flash_attention_bwd"][1]
    rows[-1]["ptxas"] = [ln for e in ("bwd_delta", "bwd_dkdv_tc", "bwd_dq_tc")
                         for ln in ptxas_lines(bwd_log, e)]
    issued = 10 * 2 * hd * pairs  # key pass S, dP, dv x2, dk x2; query pass S, dP, dq x2
    say(f"[7 time] flash_attention_bwd: bf16 on the tensor cores (wgmma, TMA) from the "
        f"forward's lse and O32: D = rowsum(dO O32), a key pass (dk, dv), a query pass (dq); "
        f"ten products of 2 hd FLOP a pair issued (P^T, dS^T and dS split into bf16 hi + lo): "
        f"{issued / 1e12:.3f} TFLOP, {issued / BF16_OPS_PER_S * 1e3:.3f} ms at "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16; x {rows[-1]['launches_per_step']} layers = "
        f"{ms[1] * rows[-1]['launches_per_step']:.0f} ms of a {train_info['step_ms']:.0f} ms "
        f"step; SDPA's backward {lib_ms:.3f} ms per eager call ({ms[1] / lib_ms:.2f}x); "
        + " | ".join(rows[-1]["ptxas"]))
    spills = [int(n) for ln in rows[-1]["ptxas"]
              for n in re.findall(r"(\d+) bytes spill stores", ln)]
    if not spills or any(spills):
        fail(f"7: flash_attention_bwd's tensor-core entries spill ({' | '.join(rows[-1]['ptxas'])})")
    del tq, tk, tv, tg, lq, lk, lv, lout, lse, o32, bwd

    # flash_decode: layer 0's cache after the serving prefill (4096
    # positions written, the rest zero), read up to pos 4160 as the last
    # decode step reads it; the library call attends over the same slice
    _, dcache = model.prefill(params, {"tokens": prompts}, cache_len=LM_CACHE)
    kd, vd = dcache["k"][0], dcache["v"][0]
    posd = torch.full((1,), LM_CACHE - 1, dtype=torch.int32, device=dev)
    qd = randn((LM_BATCH, lm_cfg.n_heads, lm_cfg.resolved_head_dim), bf16)
    ms = graph_ms(lambda: fd.flash_decode_cuda(qd, kd, vd, posd), reps=20, inner=50)
    call_ms = cuda_ms(lambda: fd.flash_decode_cuda(qd, kd, vd, posd), reps=20, inner=50)
    plain_ms = cuda_ms(lambda: fd.flash_decode_plain(qd, kd, vd, posd), reps=5, inner=3)
    kv_t, vv_t = kd[:, :LM_CACHE].transpose(1, 2), vd[:, :LM_CACHE].transpose(1, 2)
    def sdpa():
        return F.scaled_dot_product_attention(qd[:, :, None], kv_t, vv_t, enable_gqa=True)

    lib_ms = cuda_ms(sdpa, reps=20, inner=50)
    # device times in turns (kernel, SDPA, SDPA, kernel), both replayed
    # from CUDA graphs, so the yardstick is read under the same conditions
    turns = []
    for fn in ("kernel", "sdpa", "sdpa", "kernel"):
        turns.append(graph_ms(sdpa if fn == "sdpa" else
                              (lambda: fd.flash_decode_cuda(qd, kd, vd, posd)), reps=20, inner=50))
    say("[7 time] flash_decode vs SDPA in turns (kernel, SDPA, SDPA, kernel; CUDA graph replay, "
        "ms cold / warm): " + ", ".join(f"{c:.5f} / {w:.5f}" for w, c in turns)
        + f"; SDPA eager {lib_ms:.5f} ms per call; "
        + " | ".join(ptxas_lines(built["flash_decode"][1], "decode_tc")))
    B, H, hd = qd.shape
    Kd, n_valid = kd.shape[2], LM_CACHE
    row("flash_decode", "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:76", lm_launches["flash_decode"], ms, call_ms,
        plain_ms, nbytes=2 * (2 * B * H * hd + 2 * B * n_valid * Kd * hd),
        nops=4 * B * H * n_valid * hd, ops_per_s=BF16_OPS_PER_S, library_ms=lib_ms)
    rows[-1]["moe_launches"] = {n: c["flash_decode"] for n, c in moe_launches.items()}
    del dcache, kd, vd

    # flash_decode at PaliGemma's decode (hd 256, G 8 on K 1, its last
    # step's pos 4160 of a random cache): decode_tc<256>; SDPA over the
    # same slice (timed only)
    qd = randn((LM_BATCH, Hv, hdv), bf16)
    kd, vd = (randn((LM_BATCH, LM_CACHE, Kv, hdv), bf16) for _ in range(2))
    kv_t, vv_t = kd.transpose(1, 2), vd.transpose(1, 2)
    run = lambda: fd.flash_decode_cuda(qd, kd, vd, posd)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(qd[:, :, None], kv_t, vv_t,  # noqa: E731
                                                 enable_gqa=True)
    rows[-1]["hd256"] = hd256_entry(
        "decode_tc",
        f"PaliGemma-3B decode B{LM_BATCH} H{Hv} K{Kv} S{LM_CACHE} hd{hdv} pos {LM_CACHE - 1}",
        vlm_launches["flash_decode"], run, lambda: fd.flash_decode_plain(qd, kd, vd, posd), lib,
        nbytes=2 * (2 * LM_BATCH * Hv * hdv + 2 * LM_BATCH * LM_CACHE * Kv * hdv),
        nops=4 * LM_BATCH * Hv * LM_CACHE * hdv, reps=20, inner=50)
    del qd, kd, vd, kv_t, vv_t, run, lib

    rows[-1].update(encdec_launches=encdec_launches["flash_decode"], other_shapes=fd_encdec)

    # ssd_chunk_intra: the prefill shape of phase 9 (phase 3d's first
    # case); y counts the causal (i, j) pairs, S_c every (j, n) pair, the
    # scores C.B once per (batch, chunk) over the causal pairs; no single
    # PyTorch call computes (y_diag, S_c, total)
    a, x, Bm, Cm = ssd_main
    B, nc, l, H = a.shape
    P, N = x.shape[-1], Bm.shape[-1]
    ms = graph_ms(lambda: sdc.ssd_chunk_intra_cuda(*ssd_main), reps=3, inner=2)
    call_ms = cuda_ms(lambda: sdc.ssd_chunk_intra_cuda(*ssd_main), reps=3, inner=2)
    plain_ms = cuda_ms(lambda: sdc.ssd_chunk_intra_plain(*ssd_main), reps=2, inner=1)
    # bound: the float32 operations on the CUDA cores (the kernel must sum
    # in the plain version's order); beside it the bytes' bound and the
    # same work as 3xTF32 on the tensor cores (three tf32 products each)
    nops, nbytes, products = ssd_work(B, nc, l, H, P, N)
    tc_ms = (3 * products / TF32_OPS_PER_S + (nops - products) / FP32_OPS_PER_S) * 1e3
    row("ssd_chunk_intra", "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "src/repro/kernels/ssd_chunk.py:62", ssm_launches["ssd_chunk_intra"], ms, call_ms,
        plain_ms, nbytes=nbytes, nops=nops)
    sass = subprocess.run([str(Path(build.nvcc()).parent / "cuobjdump"), "-sass",
                           str(build.library_path("ssd_chunk"))],
                          capture_output=True, text=True, timeout=120).stdout.splitlines()
    n_ffma = sum("FFMA" in ln for ln in sass)
    n_tf32 = sum(("HGMMA" in ln or "HMMA" in ln) and "TF32" in ln for ln in sass)
    say(f"[7 time] ssd_chunk_intra bounds: float32 CUDA cores {nops / FP32_OPS_PER_S * 1e3:.5f} "
        f"ms ({nops / 1e9:.2f} GFLOP at 67 TFLOP/s), bytes {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms "
        f"({nbytes / 1e6:.2f} MB at 3.35 TB/s), the same work as 3xTF32 on the tensor cores "
        f"{tc_ms:.5f} ms (3 x {products / 1e9:.2f} GFLOP at 495 TFLOP/s + "
        f"{(nops - products) / 1e9:.2f} at 67); SASS: {n_ffma} FFMA, {n_tf32} tf32 tensor-core "
        "instructions; "
        + " | ".join(ptxas_lines(built["ssd_chunk"][1], "ssd_y_kernel")
                     + ptxas_lines(built["ssd_chunk"][1], "ssd_state_kernel")))
    say(f"[7 time] ssd_chunk_intra: x {ssm_cfg.n_layers} layers = {ms[1] * ssm_cfg.n_layers:.1f} "
        "ms of the prefill")
    del ssd_main, a, x, Bm, Cm

    # ssd_chunk_intra_bwd: phase 13s's training shape (mamba2-1.3B, B 8, nc
    # 16, l 256, H 64, P 64, N 128; the init's decays, seeded cotangents);
    # no single PyTorch call computes (da, dx, dB, dC)
    gb = torch.Generator(device=dev).manual_seed(SEED)
    shape = (TRAIN_BATCH, TRAIN_SEQ // ssm_cfg.ssm_chunk, ssm_cfg.ssm_chunk, ssm_cfg.ssm_heads)
    B, nc, l, H = shape
    P, N = ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state
    bargs = (F.softplus(torch.randn(shape, generator=gb, device=dev))
             * -(torch.rand((H,), generator=gb, device=dev) * 15.0 + 1.0),
             *(torch.randn(sh, generator=gb, device=dev) for sh in (
                 (B, nc, l, H, P), (B, nc, l, N), (B, nc, l, N), (B, nc, l, H, P),
                 (B, nc, H, N, P), (B, nc, H))))
    ms = graph_ms(lambda: sdc.ssd_chunk_intra_bwd_cuda(*bargs), reps=3, inner=1)
    call_ms = cuda_ms(lambda: sdc.ssd_chunk_intra_bwd_cuda(*bargs), reps=3, inner=1)
    plain_ms = cuda_ms(lambda: sdc.ssd_chunk_intra_bwd_plain(*bargs), reps=2, inner=1)
    # bound: the work the kernel issues (its products 3xTF32 on the tensor
    # cores, the rest on the CUDA cores) or its bytes; the float32 bound
    # (every operation on the CUDA cores) beside it
    nops, nbytes, products = sdc.bwd_work(B, nc, l, H, P, N)
    bounds = sdc.bwd_bounds_ms((B, nc, l, H, P, N), FP32_OPS_PER_S, TF32_OPS_PER_S,
                               HBM_BYTES_PER_S)
    tc_ms = bounds["tf32x3"]
    row("ssd_chunk_intra_bwd", "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        "src/repro/models/mamba2.py:66",  # ssd_chunked: its XLA autodiff
        ssm_train_info["launches"]["ssd_chunk_intra_bwd"], ms, call_ms, plain_ms, nbytes=nbytes,
        nops=nops, ops_ms=tc_ms)
    rows[-1]["launches_per_step"] = ssm_train_info["per_step"]["ssd_chunk_intra_bwd"]
    rows[-1]["f32_bound_ms"] = bounds["f32"]
    rows[-1]["ptxas"] = [ln for e in ("bwd_scores_tc", "bwd_head_tc", "bwd_dgsum", "bwd_bc_tc")
                         for ln in ptxas_lines(built["ssd_chunk_bwd"][1], e)]
    if any(int(n) for ln in rows[-1]["ptxas"] for n in re.findall(r"(\d+) bytes spill stores", ln)):
        say("[7 time] ssd_chunk_intra_bwd: ptxas reports spill stores (its lines below)")
    say(f"[7 time] ssd_chunk_intra_bwd bounds: the work the kernel issues, 3xTF32 on the tensor "
        f"cores, {tc_ms:.5f} ms (3 x {products / 1e9:.2f} GFLOP at 495 TFLOP/s + "
        f"{(nops - products) / 1e9:.2f} at 67; the row's bound, {ms[1] / tc_ms:.2f}x), bytes "
        f"{bounds['bytes']:.5f} ms ({nbytes / 1e6:.2f} MB at 3.35 TB/s), float32 CUDA cores "
        f"{bounds['f32']:.5f} ms ({nops / 1e9:.2f} GFLOP at 67 TFLOP/s, "
        f"{ms[1] / bounds['f32']:.2f}x); x {rows[-1]['launches_per_step']} layers = "
        f"{ms[1] * rows[-1]['launches_per_step']:.0f} ms of a {ssm_train_info['step_ms']:.0f} ms "
        "step; " + " | ".join(rows[-1]["ptxas"]))
    del bargs

    # threefry_draw: the main path's arrivals (UniformArrivals at M4096),
    # the run's T_MAIN slots in one block draw, as phase 4 launches it,
    # in turns against the T_MAIN per-slot draws it replaces; the bound
    # counts the function's own integer operations: a slot's fold_in and
    # randint's split (three hashes), two hashes and the span's
    # remainders a value; and the bytes of its keys and output; no
    # PyTorch call draws JAX's stream
    k_arr = jr.split(jr.PRNGKey(SEED, device=dev), 3)[1]
    draw_kw = dict(finish="randint_f32", minval=0, maxval=A_MAX + 1)

    def main_block():
        return tfk.threefry_draw_cuda(k_arr, 0, M_MAIN, count=T_MAIN, **draw_kw)

    main_turns = draw_turns(main_block, lambda: [tfk.threefry_draw_cuda(k_arr, t, M_MAIN,
                                                                        **draw_kw)
                                                 for t in range(T_MAIN)])
    call_ms = cuda_ms(main_block, reps=20, inner=20)
    plain_ms = cuda_ms(lambda: tfk.threefry_draw_plain(k_arr, 0, M_MAIN, count=T_MAIN,
                                                       **draw_kw), reps=5, inner=3)
    row("threefry_draw", "src/repro_torch/kernels/csrc/threefry.cu",
        "src/repro/core/simulator.py:45", main_launches["threefry_draw"], main_turns["block"][0],
        call_ms, plain_ms, nbytes=4 * T_MAIN * M_MAIN + 16,
        nops=draw_ops(T_MAIN, M_MAIN, 3, 2, 12), ops_per_s=INT32_OPS_PER_S)
    one_ms = graph_ms(lambda: tfk.threefry_draw_cuda(k_arr, T_MAIN - 1, M_MAIN, **draw_kw),
                      reps=20, inner=50)
    rows[-1]["block"] = {
        "shape": f"{T_MAIN} slots x {M_MAIN} randints", "turns": main_turns,
        "one_slot_ms": one_ms[1], "one_slot_warm_ms": one_ms[0],
        "one_slot_bound_ms": draw_ops(1, M_MAIN, 3, 2, 12) / INT32_OPS_PER_S * 1e3}
    say(f"[7 time] threefry_draw, the main path's {T_MAIN} slots x {M_MAIN} arrivals: in turns, "
        f"one block draw against {T_MAIN} per-slot draws, ms cold (warm): "
        f"{turns_text(main_turns)}; one slot alone {one_ms[1]:.5f} ({one_ms[0]:.5f}) against "
        f"its bound {rows[-1]['block']['one_slot_bound_ms']:.7f} ({smi})")
    rows[-1]["fleet"] = [{
        "shape": f"{ft['shape']} arrivals, {ft['draw_T']} slots ({ft['draw_n']} values)",
        "launches": ft["launches"].get("threefry_draw", 0), "ms": ft["draw"]["block"][0][1],
        "warm_ms": ft["draw"]["block"][0][0], "turns": ft["draw"],
        "bound_ms": max(ft["draw_ops"] / INT32_OPS_PER_S,
                        8 * ft["draw_n"] / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations"} for ft in fleet_times.values()]
    rows[-1]["paths"] = fault_draw_times  # the fault stream's draw (phase 4f)
    # the deadline layer's runs (phase 4g: the bench's rows and fleet B's
    # width run) launch three of the kernels; the blackout rows' fault
    # stream is threefry_draw's paths launches
    for r in rows:
        if r["name"] in ("carbon_scores", "greedy_fill", "threefry_draw"):
            r["deadlines"] = {"launches": dl_counts.get(r["name"], 0)}
    rows[-1]["deadlines"]["paths_launches"] = dl_counts.get("threefry_draw paths", 0)

    # PoissonArrivals at M4096 (no main path runs it): a slot's arrivals
    # are two chain draws (poisson's Knuth and rejection walks, the fold
    # inside them) and the samplers' eager elementwise passes; beside it
    # the same slot with the plain walk (the eager twin: split and uniform
    # a round); the draws' mean held to the rates' within 6 standard errors
    rates = np.linspace(POISSON_RATE_LO, POISSON_RATE_HI, M_MAIN)
    pois = core.PoissonArrivals(rates=tuple(rates.tolist()))
    k_pois = jr.split(jr.PRNGKey(SEED, device=dev), 3)[1]
    pois(0, k_pois, dev)  # stages the rates on the card
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    draws = torch.stack([pois(t, k_pois, dev) for t in range(POISSON_SLOTS)]).double()
    pois_draws = ops.launch_counts()["threefry_draw"] / POISSON_SLOTS
    se = float(np.sqrt(rates.mean() / draws.numel()))
    gap = abs(float(draws.mean()) - float(rates.mean()))
    if not (gap < 6 * se and bool((draws >= 0).all()) and bool((draws == draws.floor()).all())
            and pois_draws == 2):
        fail(f"PoissonArrivals: mean {float(draws.mean()):.3f} vs rates' {rates.mean():.3f} "
             f"(6 se {6 * se:.3f}), {pois_draws} draws a slot (2 expected)")
    pois_ms = cuda_ms(lambda: pois(T_MAIN - 1, k_pois, dev), reps=10, inner=5)
    prof, host = profile_slots(lambda: [pois(t, k_pois, dev) for t in range(POISSON_SLOTS)],
                               slots=POISSON_SLOTS)
    n_aten = sum(v[1] for k, v in host.items() if k.startswith("aten::"))
    busy = "not measured" if prof is None else f"{prof['total']:.4f} ms"
    with swapped(ops, dict(threefry_draw=tfk.threefry_draw_plain)):
        pois_plain_ms = cuda_ms(lambda: pois(T_MAIN - 1, k_pois, dev), reps=3, inner=1)
        _, host_plain = profile_slots(lambda: pois(T_MAIN - 1, k_pois, dev), slots=1)
    n_aten_plain = sum(v[1] for k, v in host_plain.items() if k.startswith("aten::"))
    say(f"[7 time] PoissonArrivals M{M_MAIN} (rates {POISSON_RATE_LO}-{POISSON_RATE_HI}): "
        f"{pois_ms:.5f} ms a slot (CUDA events, eager, median), {pois_draws:g} threefry_draw "
        f"launches and {n_aten:.1f} aten op calls a slot, device busy {busy} a slot; with the "
        f"plain walk {pois_plain_ms:.5f} ms, {n_aten_plain:.0f} aten op calls; mean of "
        f"{draws.numel()} draws {float(draws.mean()):.4f} vs rates' {rates.mean():.4f} "
        f"(6 se {6 * se:.4f})")

    # tap_scan (phase 4h): its time at bench_telemetry_overhead's fleet
    # (F32 x T192) for the row, every other case's beside it; launches from
    # the main path's run with taps on (set to 0 just before it), and apart
    # from them the phase's total and a streamed run's (one a flush chunk);
    # no PyTorch call computes the recurrence (a prefix sum adds in another
    # order), so no library time
    tt = tap_times[0]
    row("tap_scan", "src/repro_torch/kernels/csrc/tap_scan.cu", "src/repro/telemetry/taps.py:162",
        main_tap_launches["tap_scan"], tt["times"], tt["call_ms"], tt["plain_ms"],
        nbytes=tt["nbytes"], nops=tt["nops"])
    # beside the byte bound, the serial floor: T dependent float32 adds of
    # each running sum at 4 cycles an add, at clocks.max.sm
    T_tt = int(tt["shape"].split(" x T")[1].split()[0])
    rows[-1].update(phase_launches=tap_counts.get("tap_scan", 0),
                    stream_launches_per_run=n_stream, shape=tt["shape"],
                    serial_floor_ms=T_tt * 4 / clk_mhz / 1e3)
    rows[-1]["other_shapes"] = [
        {"shape": x["shape"], "ms": x["times"][1], "warm_ms": x["times"][0],
         "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"], "bound_by": "bytes",
         "serial_floor_ms": int(x["shape"].split(" x T")[1].split()[0]) * 4 / clk_mhz / 1e3}
        for x in tap_times[1:]]
    say(f"[7 time] tap_scan's serial floor at {clk_mhz:.0f} MHz (T adds of 4 cycles): "
        + ", ".join(f"{x['shape']} {x.get('serial_floor_ms', rows[-1]['serial_floor_ms']):.5f} ms"
                    for x in [rows[-1]] + rows[-1]["other_shapes"]))

    # tap_probe (phase 4h): the main path's probe (the landings by cloud,
    # the arrivals, Qe and Qc) for the row, the other loops' beside it; its
    # launches those of the main path's run with taps on, one a slot; the
    # library time is one slot of the torch.sum calls it replaced, which no call of
    # the port makes now
    pt = probe_times[0]
    row("tap_probe", "src/repro_torch/kernels/csrc/tap_probe.cu",
        "src/repro/core/simulator.py:412", main_tap_launches["tap_probe"], pt["times"],
        pt["call_ms"], pt["plain_ms"], nbytes=pt["nbytes"], nops=pt["nops"],
        library_ms=pt["library_ms"])
    rows[-1].update(shape=pt["shape"], library_warm_ms=pt["library_warm_ms"],
                    serial_adds=pt["serial_adds"], serial_floor_ms=pt["serial_floor_ms"])
    rows[-1]["other_shapes"] = [
        {"shape": x["shape"], "ms": x["times"][1], "warm_ms": x["times"][0],
         "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"], "bound_by": "bytes",
         "serial_adds": x["serial_adds"], "serial_floor_ms": x["serial_floor_ms"],
         "library_ms": x["library_ms"], "library_warm_ms": x["library_warm_ms"]}
        for x in probe_times[1:]]

    # knapsack_dp (phase 3f's inputs): the row at fleet A's shape (512
    # lanes x 6 knapsacks of M5, grid 512: the widest ExactDPP launch a
    # path of 4i makes), the paper setup's one lane and the main width's
    # slot beside it. Bytes: each input read once, the counts written once;
    # operations: about 6 a cell (a subtract, a compare, an add, a
    # compare, two selects) for each step this data takes (k > 0); beside
    # them the serial floor, the longest knapsack's steps as dependent
    # 4-cycle adds at clocks.max.sm. No PyTorch call computes the DP.
    def kp_work(args):
        K, M = args[0].shape
        _, cap = kpk.knapsack_items(*args, KP_GRID)
        steps = torch.where(cap > 0, torch.floor(torch.log2(cap.clamp_min(1).double())) + 1, 0)
        steps = steps.clamp_max(kpk.n_splits(KP_GRID)).sum(-1)
        return (4 * (4 * K * M + K), 6 * (KP_GRID + 1) * float(steps.sum()),
                float(steps.max()) * 4 / clk_mhz / 1e3)

    kp_shapes = {"fleet A F512 x 6 x M5": (kp_fleet_args, 20, 5),
                 "paper 6 x M5": (tuple(x[:6] for x in kp_fleet_args), 20, 5),
                 f"main 257 x M{M_MAIN}": (kp_main_args, 3, 1)}
    kp_rows = []
    for label, (args, reps, inner) in kp_shapes.items():
        times = graph_ms(lambda args=args: kpk.knapsack_dp_cuda(*args, KP_GRID), reps=reps,
                         inner=inner)
        call_ms = cuda_ms(lambda args=args: kpk.knapsack_dp_cuda(*args, KP_GRID), reps=reps,
                          inner=inner)
        plain_ms = None if label.startswith("main") else cuda_ms(
            lambda args=args: kpk.knapsack_dp_plain(*args, KP_GRID), reps=3, inner=1)
        nbytes, nops, floor_ms = kp_work(args)
        kp_rows.append(dict(shape=label, times=times, call_ms=call_ms, plain_ms=plain_ms,
                            nbytes=nbytes, nops=nops, floor_ms=floor_ms))
        bound = max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3
        say(f"[7 time] knapsack_dp {label} grid {KP_GRID}: {times[1]:.5f} ms cold, "
            f"{times[0]:.5f} ms warm (CUDA graph replay), {call_ms:.5f} ms per eager call; bound "
            f"{bound:.6f} ms ({nbytes / 1e6:.3f} MB, {nops / 1e6:.1f} M ops), serial floor "
            f"{floor_ms:.5f} ms; the one-block-a-knapsack kernel "
            f"{KP_BLOCK_KERNEL[label][0]:.5f} ms cold ({KP_BLOCK_KERNEL[label][1]:.5f} warm); "
            f"plain version "
            + ("not timed (its count table)" if plain_ms is None else f"{plain_ms:.3f} ms"))
    kr = kp_rows[0]
    row("knapsack_dp", "src/repro_torch/kernels/csrc/knapsack.cu",
        "src/repro/core/knapsack.py:75", exact_launches["knapsack_dp"], kr["times"],
        kr["call_ms"], kr["plain_ms"], nbytes=kr["nbytes"], nops=kr["nops"])
    rows[-1].update(shape=kr["shape"], serial_floor_ms=kr["floor_ms"],
                    fleet_a_launches=fleet_exact_launches["knapsack_dp"],
                    exact_slot=exact_slot, exact_main_slot=exact_main)
    rows[-1]["other_shapes"] = [
        {"shape": x["shape"], "ms": x["times"][1], "warm_ms": x["times"][0],
         "plain_ms": x["plain_ms"], "serial_floor_ms": x["floor_ms"],
         "bound_ms": max(x["nbytes"] / HBM_BYTES_PER_S, x["nops"] / FP32_OPS_PER_S) * 1e3,
         "bound_by": "bytes" if x["nbytes"] / HBM_BYTES_PER_S >= x["nops"] / FP32_OPS_PER_S
         else "operations"}
        for x in kp_rows[1:]]

    clock.stop()
    say(json.dumps({"kernels": rows}))
    say(smi)  # the nvidia-smi name, power limit line as it prints it
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
