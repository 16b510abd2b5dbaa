#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--verbose] [--profile]

Drives the port's main paths — ``ServeEngine`` -> prefill -> decode for
gemma2-2b (with the model-dtype and the int8 KV cache), recurrentgemma-2b,
mamba2-130m and the mixture-of-experts deepseek-moe-16b and dbrx-132b,
``Model.prefill`` -> ``decode_step`` for paligemma-3b (a vision
prefix) and seamless-m4t-large-v2 (encoder-decoder), and the DS3 scenario path
``Scenario`` -> ``run`` / ``simulate_batch`` / ``sweep`` -> the epoch scan —
through the entry points a user would call, and holds every CUDA kernel of
those paths against its plain PyTorch version; then trains mamba2-130m and
gemma2-2b at published widths (``repro_torch.launch.train``), a path with no
kernel, and drives the layouts and launch tools (the GPipe schedule at
granite-3-8b's published width, the ``meta`` dry-run against the card, the
autotune example on K1), the linter, the dry-run's collectives (steps run
as DTensors over a fake process group), and ``sweep(shard=)`` over virtual
shards of the card (blocks of lanes on streams of their own).  Needs one
CUDA device;
without one it exits non-zero at once.  Imports ``repro_torch`` only (from ``src/`` beside this file), never
``jax`` or ``repro``.  Phases:

1. card    the ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build   the kernels, from the sources in this checkout (seconds printed);
3. kernels each wrapper vs its plain version on the card, at the shapes the
           main paths give it and at small shapes: K2 flash attention and K3
           flash decode (gemma2-2b's and recurrentgemma-2b's geometries, the
           tile edges S = 1, 63, 64, 65, 4097 at every head dim, both key
           tiles of head_dim 256, 1-16 query heads per KV head, an empty slot,
           q scaled by 8 so that the scores reach the softcap) bf16 2e-2 / f32
           2e-5, K4 ssd_scan (mamba2-130m's, and for its bf16 tensor-core
           path the chunk edges c = 1, 15, 16, 17, 63, 64, 65, 255, 256 in one
           and three chunks at (P, N) = (16, 16), (32, 64), (64, 128)) bf16
           2e-2 / f32 2e-3, K5 rg_lru (recurrentgemma-2b's at B = 1, 2, 4,
           and the edges of a warp's rows, a block's chunk and the first
           anchor, S = 1, 15, 16, 17, 127, 128, 129, 257, 1024, 1025 at
           W = 33, 100; f32 only, its gates are f32) 1e-5, its output
           bit-identical over two eager calls and three calls in a replayed
           CUDA graph, K6 thermal_grid (f32) at a static sweep's launch
           (1,024 lanes on 15 PEs) and a DSE call's (1,080 designs of 1-19
           PEs padded to 19 x 4 lanes), lanes of 1,000 jobs x 8 tasks that
           fill the bins in part, and at tests/thermal_schedules.py's bin
           cases (bins filled in part; a period that heats and cools, each
           shown to be so by the plain version first) 2e-5 relative, no
           local memory, its plain version's time that of one eager call;
           device times from CUDA-graph replays timed by CUDA events (and the
           time of one eager call from Python beside them); for K2/K3 one
           library call (``scaled_dot_product_attention``, softcap off, a
           window as a boolean band mask; used nowhere in the port) timed
           beside each as a yardstick.  K4, K5 and K6 have none: no
           single PyTorch call computes any of them.  Then K2 and K3 at phase
           10's shapes, timed the same way: paligemma-3b (8 heads on 1 KV
           head, head_dim 256: K2 at S = 320, B = 1 and 4; K3 on a 336-slot
           cache) and seamless-m4t-large-v2's decoder (16 on 16, head_dim 64,
           a group of one: K2 at S = 64 and 32; K3 on 48 slots); no softcap,
           so the library call computes the same function there and is held
           against the plain version too.  The same for the MoE serves'
           shapes: deepseek-moe-16b (16 heads on 16, head_dim 128) and
           dbrx-132b (48 on 8, head_dim 128), K2 at B=1 S=2,048, K3 at B=4
           on an 8,192-slot cache (no softcap either);
4. reduced the reduced gemma2-2b, mamba2-130m, recurrentgemma-2b and
           deepseek-moe-16b (capacity factor num_experts / top_k, which
           drops nothing: the oracle's forward and the engine route
           different groups) in f32,
           with the embedding scaled by 0.1 so the greedy token is not the
           input echoed (asserted: under half of the positions): engine output
           equals teacher-forced greedy decoding; the logits of every prefill
           and decode step equal ``forward_logits`` at that position (1e-3);
           logits of the kernel path and the einsum path agree within 3e-2;
           then the four reduced models in bf16 (the tensor-core paths of K2
           and K4; mamba2's prompt of 512 tokens is two chunks): kernel-path
           logits vs the einsum path within 2e-2 (absolute part of the
           logits' scale where it exceeds 1: deepseek's untied head), and no
           farther from an f32 forward than twice the einsum path;
5. full    each of the four at full width (gemma2-2b 26 layers, recurrentgemma-
           2b 26, mamba2-130m 24, deepseek-moe-16b 28: 16.88 G parameters, its
           prompts inside the MoE group rule, 4,096 two groups of 2,048), bf16,
           seeded random weights: 8 requests with Poisson arrivals, 16 new
           tokens each, through a 4-slot engine with an 8192-token cache.
           Every kernel's launch count is set to 0 just before each serve and
           read just after, and must equal what the model's layers imply
           (e.g. recurrentgemma-2b: K5 18 and K2 8 per request, K3 8 per
           tick; deepseek-moe-16b: K2 28 per request, K3 28 per tick);
6. scenario the DS3 simulator with K1, the epoch scan: wifi_tx x {etf, met,
           table} at 80 jobs and 2, 20, 60 jobs/ms through
           ``run(backend="torch")``, and the comm-free etf case, equal to K1's
           plain version bit for bit (every output), to ``backend="ref"``
           within 1e-4 (latency, makespan) / 1e-3 (energy), the comm-free
           schedule equal to the event-heap oracle; K1's SASS holds no FFMA;
           K1's block shapes (1, 2 and 4 lanes a block) in all four
           instantiations equal to the plain scan bit for bit: three designs
           of 8/13/19 PEs with S = 3 lanes each (blocks straddle designs, L
           = 9 not a multiple of the lanes a block) of 100 jobs (not a
           multiple of 32), and a two-task app at 1,100 jobs (more groups of
           32 jobs than a warp has lanes), with each instantiation's lanes a
           block, lanes an SM, registers and spill printed; then
           the paper's five-app mix on ``DesignPoint(num_vit=1)`` (15
           PEs), 1,024 lanes (32 rates from 1 to 80 jobs/ms x 32 seeds) of
           1,000 Poisson jobs, one K1 launch per scheduler, every 16th lane
           equal to the plain scan bit for bit; K1's time (CUDA events, median
           of 5), the plain loop's, scheduled tasks per second, the memory a
           launch holds and ``backend="ref"``'s time for one lane.  Then
           closed-loop DTPM through K1's DTPM variant: (a) ondemand and
           throttle (27 C cap, 0.05 s RC step) x {etf, met, table} at 2, 20,
           60 jobs/ms, 80 jobs, through ``run(backend="torch")``: equal to
           the plain scan bit for bit on the schedule, ``onopp`` and
           ``opp_idx``, within 1e-5 on peak temperature and energy, within
           1e-4 / 1e-3 of ``backend="ref"``; (b) one launch of 9 lanes with
           different up thresholds and windows, each lane equal to its own
           plain scan; (c) the comm-free integer trace (window 50 us, etf and
           met) equal to the event-heap oracle on finish, PE and latched
           frequency; (d) the full grid under ondemand and throttle per
           scheduler, K1 timed as above, windows a lane printed, two lanes
           (seed 0 of the middle and the highest rate: the plain loop pays
           each checked lane's windows) equal to the plain scan.  The
           host oracle runs at 20 and 60 jobs/ms only.  Then fail-stop
           faults through K1's two faulted instantiations: (a) wifi_tx x
           {etf, met} at 2, 20, 60 jobs/ms, 80 jobs, through
           ``run(backend="torch")``, with one fault mid-trace, one at t = 0,
           two faults, two simultaneous ones, every accelerator lost, and an
           FFT accelerator lost between two arrivals:
           equal to the plain scan bit for bit (every output, steps and
           commits included), within 1e-4 / 1e-3 of ``backend="ref"``, and on
           the comm-free ``deterministic_trace(25, 48)`` equal to the
           event-heap oracle on finish, start and PE, with at least one
           skipped step (a stale pick); (b) the five-app mix on
           ``DesignPoint(num_vit=1)``, 1,024 lanes = 16 fault sets (none, and
           each of the 15 PEs lost at the lane's arrival of job 500) x 8
           rates x 8 seeds of 1,000 jobs, one faulted launch per scheduler
           (etf, met), timed as above, with re-commits, steps against the
           cap and memory printed; its fault-free lanes equal a fault-free
           launch of the same 64 traces, and two lanes (80 jobs/ms seed 0:
           the lost PE with the most re-commits, and fault-free) equal the
           plain scan; (c) the cases of (a) under ondemand and throttle
           through K1's DTPM-with-faults instantiation, then the grid of (b)
           under ondemand per scheduler, two lanes checked (schedule,
           ``onopp``, ``opp_idx``, steps and commits bit for bit, peak and
           energy within 1e-5).  K1's SASS, all four instantiations, holds
           no FFMA.  Launch counts are set to 0 before each part and must be
           exact, by instantiation (10, 3, 18, 1, 2, 6, 36, 12, 2 + 2, 72, 2);
7. sweep   ``repro_torch.scenario.sweep`` as a user calls it, one K1 launch
           per scheduler over design-major lanes (the designs are K1's D
           axis): (a) small sweeps of 80 jobs — {3 designs of 8, 13 and 19
           PEs} x {2, 20, 60 jobs/ms} (wifi_tx+wifi_rx), {etf, met, table} x
           rate (wifi_tx), 9 ondemand and 9 throttle parameterisations x the
           3 designs, 4 fault sets x the 3 designs x {20, 60 jobs/ms} x {etf,
           met}, static and ondemand — every lane equal to ``run(backend=
           "torch")`` of its point (makespan, latency, energy and per-PE
           busy time bit for bit, throughput and utilization within 1e-6
           relative, peak 1e-5) and to the same sweep on ``backend="ref"``
           within 1e-4 /
           1e-3, and K1's lanes equal to the plain scan on the same stacked
           tables bit for bit (every output); (b) every valid design of
           ``DesignSpace().grid()`` (1,080, padded to 19 PEs) x 4 seeds of
           1,000 jobs of the five-app mix at 20 jobs/ms, static, etf and
           met (D = 1,080, 4,320 lanes a launch); (c) 64 LHS designs x 16
           ondemand policies, etf and met (D = 64, 1,024 lanes); (d) 8
           fault sets (none; PE 0-6 lost at 500 us) x 16 designs of more
           than 7 PEs x 8 seeds, etf.  For (b)-(d): the sweep's wall time,
           split from inside the sweep into the host table builds (cold),
           the K1 launches (CUDA events) and the epilogue plus thermal; K1
           again on the same inputs (median of 5); design points a second;
           device memory held; four lanes of each of the sweep's launches,
           spread over the designs, equal to ONE plain call over those
           lanes, and the sweep's makespans of them equal to their
           schedules'.  Launch counts exact,
           by instantiation, and equal to the scans the sweeps started (4,
           2, 2, 2 small; 2; 2; 1), and K6's, one a static scan (6 small; 2;
           0; 1);
8. dse     the DSE mode (``repro_torch.dse``) and the chunked lane executor
           (``sweep(chunk=)``), as a user calls them, on phase 7's grids at
           etf: the unchunked sweep of grid (b) (1,080 designs x 4 seeds),
           then (a) ``evaluate`` on the same designs and traces: its
           latencies equal the sweep's bit for bit (energy and peak
           temperature bit for bit where they are, else within 1e-6 / 1e-5
           relative, said in the line), ``front_mask()`` equals
           ``pareto_mask`` of its objectives; front size, design points a
           second and the time split (host tables, K1, epilogue, thermal,
           the rest); (b) ``pareto_search`` (4 rounds of 64 designs, seed
           0) twice: the two archives identical, each round's designs,
           archive, front and wall time; (c) grid (b) at ``chunk=135`` (8
           chunks, no pad) and ``chunk=256`` (5 chunks, 200 pad designs):
           the schedule and energy bit for bit with the unchunked sweep,
           peak as in (a), the chunk and pad counters exact, device memory
           held (``max_memory_allocated``, reset first) below the
           unchunked sweep's at 135; (d) grid (c) (64 designs x 16
           ondemand policies) at ``chunk=16`` (streams designs: 4 chunks)
           and 4 of its designs x the 16 policies at ``chunk=5`` (streams
           policies: 4 chunks, 4 pad policies), each against its unchunked
           sweep as in (c); (e) grid (d) (faults) at ``chunk=1``, as
           ``benchmarks/bench_faults.py`` runs it (16 chunks), against the
           unchunked sweep; (f) ``python -m repro_torch.dse.reports
           --designs 64 --traces 4``, and with ``--rounds 3``, in-process
           (``main([...])``), printing their fronts.  K1's launches are
           counted per call as in phase 7 (1 + 1 + 2 x 4 + 8 + 5 + 1 + 3
           static in (a)-(c) and (f), 1 + 4 + 1 + 4 under DTPM, 1 + 16 with
           faults);
9. obs     ``repro_torch.obs`` on phase 6's configuration (the five-app mix
           on ``DesignPoint(num_vit=1)``, 1,000 jobs at 20 jobs/ms): (a)
           ``run(telemetry=True)`` under performance, ondemand and throttle
           (27 C cap) x {etf, met, table}, and performance etf with a fault:
           K1 launched once with telemetry and once without, its outputs and
           the metrics the same bits, ``num_windows_for`` windows, the
           replayed peak equal to K1's ``peak_temp_c`` bit for bit (DTPM),
           the card's replay equal to the same replay on the host over K1's
           outputs copied there, bit for bit, the manifest naming the card;
           the replay's wall time (the ``obs.telemetry.replay`` timer),
           windows a second and the run's memory on the card; (b)
           ``sweep(telemetry=True)`` on 16 LHS designs x 4 ondemand policies
           x 2 seeds and on 64 designs x 2 seeds static: one K1 launch each,
           the outputs as without telemetry; ``chunk=5`` (4 and 13 launches)
           the same bits with telemetry as without, its telemetry equal to
           the unchunked sweep's bit for bit, makespans and the epilogue's
           sums (latency, busy time, energy) bit for bit, peak temperature
           bit for bit or within 1e-5 (the line says which);
           four lanes of each equal to their ``run(telemetry=True)`` bit for
           bit; the replay's time, window steps and lane-windows; (c) the
           comm-free ondemand trace: the card's replay against the event-heap
           recorder (``freq_idx`` equal, the rest within 1e-4); (d) ``python
           -m repro_torch.obs.report --trace`` in-process (a host tool: the
           event-heap kernel), its trace validated.  K1's launches are
           counted per call (6 + 32 static in (a)-(b), 12 + 14 + 1 under
           DTPM in (a)-(c), 2 with faults);
10. encdec the two families the engine does not serve, through ``Model``
           as ``tests/test_arch_smoke.py`` drives them, and the attention
           options of this slice: (a) reduced paligemma-3b and
           seamless-m4t-large-v2 in f32, embedding scaled by 0.1 (echo
           share under half): prefill of 34 tokens (after 8 patch
           embeddings; 24 frames) and 6 decode steps, the kernel path
           against the einsum path at every step and against
           ``forward_logits`` (1e-3), K2/K3 launches exact; (b) both at full
           width in bf16, batch 4 (paligemma-3b: 256 patch embeddings + 64
           tokens; seamless-m4t-large-v2: 1,024 frames + 32 tokens), prefill
           and 16 greedy decode steps: parameters, init time, prefill ms,
           median tick ms, tok/s, peak memory; K2 once a decoder layer at
           prefill and K3 once a decoder layer a tick (18 + 18, 24 + 24; the
           encoder's non-causal attention launches none); logits finite,
           the einsum path teacher-forced on the same tokens within bf16's
           2e-2 absolute plus relative at every step, and the kernel path's
           prefill logits no farther from an f32 einsum prefill than twice
           the einsum path's; (c) the int8 codes, scales and dequantised
           values of a K/V tensor on the card equal the CPU's bit for bit,
           then gemma2-2b with ``kv_cache_dtype="int8"`` through the engine
           as in phase 5 (launches as phase 5's), tok/s and peak memory
           beside phase 5's; (d) reduced gemma2-2b f32 with ``attn_impl``
           "blocked" and "blocked_unroll" over 1,100 positions (3 query
           chunks at global layers, 2 at windowed ones) against "einsum",
           forward and prefill + 4 decode steps at 1e-4, K2/K3 not launched;
11. moe    the mixture-of-experts layer (``models/moe.py``, no kernel of its
           own: einsums, a stable sort, gathers): (a) the reduced
           deepseek-moe-16b and dbrx-132b layers in f32 on the card against
           the same weights on the CPU, at the configs' capacity factor and
           at 0.25 (pairs drop): top-k indices and kept (token, choice)
           pairs equal, ``apply_moe`` in both forms within 1e-5, onehot vs
           sort on the card within 1e-5; (b) dbrx-132b at full width with 4
           of its 40 layers (131.6 G parameters, 263 GB of bf16 weights
           whole, against the card's 80 GB) through the engine as phase 5
           serves (deepseek's prompts), K2 4 per request and K3 4 per tick,
           exact; (c) one deepseek-moe-16b layer at full width in bf16, both
           forms, at a prefill group of 2,048 tokens (C = 240) and a 4-slot
           decode tick (C = 8; both forms read every expert's weights, the
           bound only those of the experts the tokens reach): device ms,
           the eager call, the byte/FLOP bound (the onehot form's dispatch
           and combine einsums counted), onehot vs sort within 2e-2 of the
           outputs' scale plus relative;
12. train  the training path (``repro_torch.launch.train``, ``steps``,
           ``optim``, ``data``, ``checkpoint``), which runs
           ``attn_impl="blocked"`` and no kernel: (a) K2-K5 at small shapes,
           one input requiring grad: each wrapper raises under grad (no
           kernel has a backward) and launches once under ``no_grad``; (b)
           reduced mamba2-130m and gemma2-2b in f32, one
           ``init_params(device="cpu")`` tree on the card and on the CPU,
           B=8 S=256: the loss within 1e-5 (relative), every gradient leaf
           within 1e-4 of its largest entry and none zero, one AdamW update
           from the same gradients within 1e-6; (c) mamba2-130m at
           published width and depth through ``train(preset="full")`` (bf16,
           ``remat="full"``, B=8 S=256 lr 3e-3, the reference trainer's
           defaults): 30 steps, losses finite and the mean of the last 5
           below the first 5's, median step ms, tokens/s, peak memory and
           straggler events; then 10 steps unbroken against
           ``train_with_retries(fail_at=7, ckpt_every=5)`` (checkpoint under
           ``build/train/``): every leaf equal bit for bit (every step under
           ``torch.use_deterministic_algorithms(True)``, so
           ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` is set before anything runs);
           (d) gemma2-2b at published width and depth (2.6 G parameters,
           bf16, ``remat="full"``, f32 master and moments) through
           ``make_train_step``, B=4 S=256, 5 steps: losses and gradient
           norms finite, median step ms, tokens/s, peak memory; (e)
           reduced mamba2-130m through ``train`` with ``accum=4`` and with
           ``compress_grads=True``, 10 steps each: finite, and the loss
           falls under compression.  The kernels' counts are set to 0
           before (c) and must still be 0 after (e);
13. layouts the layouts and launch tools (``repro_torch.sharding``,
           ``launch/mesh``, ``specs``, ``dryrun``, ``roofline``,
           ``hillclimb``, ``models/pipeline.py``, the autotune example):
           (a) the GPipe schedule: reduced granite-3-8b in f32 (the
           reference test's case: 2 repeats on 2 stages, 2 microbatches,
           B=4 S=32, a (2,2,2) mesh's ``train_pp`` rules) pipelined on the
           card against the plain stack on the card and the same call on
           the CPU (loss 1e-5 relative, every gradient leaf 1e-4 of its
           largest entry); granite-3-8b at published width (40 layers,
           8.17 G parameters, bf16, ``blocked``, ``remat="full"``), 4
           stages x 4 microbatches, B=4 S=256, against the plain stack
           (loss 2e-2 relative, every leaf 2e-2 of its largest, none zero):
           the loss+grad step's median ms of 3 (synchronised) both ways and
           the peak memory; (b) the dry-run held to the card: gemma2-2b
           train at B=2 S=1024 and mamba2-130m long_500k decode on the host
           mesh, the ``meta`` matmul FLOPs equal to ``FlopCounterMode``'s
           count of the same step on the card (exact), the accounted
           argument bytes against what materialising parameters, optimizer
           state, batch and cache allocates (1%); then the three hillclimb
           cells on pod16x16 with their roofline terms (the collective one
           from phase 15's count); (c) a 8192^3 bf16
           ``torch.matmul`` and a 4 GiB device copy (CUDA events, median of
           5) beside the data sheet's rates, failing above 105% of them;
           (d) reduced granite-3-8b: 5 steps on the card, saved, restored
           on the CPU under a (2,4) mesh's rules, 5 more, within 5e-3 of 10
           unbroken CPU steps; (e) the autotune example's simulation on the
           card, K1 once a layout (3, exact), each layout's step equal to
           the event-heap simulator on the CPU within 1e-6.  (a)-(d) launch
           no kernel;
14. lint   the port's static linter and its counter gate
           (``repro_torch.analysis``): (a) ``python -m repro_torch.analysis
           --strict`` on this checkout in a process of its own, exit 0, with
           the files it scanned, its findings by rule (active and waived)
           and its wall time, and the analysis alone timed in this process;
           (b) phase 7's smallest sweep (3 designs x 3
           rates) as a user calls it, K1 once (exact), its
           ``obs.bench.rows_payload(device=the card)`` written to a
           temporary ``BENCH_*.json`` and gated: against a contract equal
           to the counts it carries, no finding; against the same contract
           one lower on any one counter, exactly one CC001 finding, naming
           that counter;
15. collectives the dry-run's partitioned count (``launch/dryrun.py``:
           each step run as DTensors over a fake process group whose mesh
           is the cell's, ``sharding.shard`` restoring the reference's
           activation constraints): (a) gemma2-2b prefill_32k, dbrx-132b
           decode_32k and mamba2-130m train_4k at full width and depth on
           pod16x16 (a fake world of 256 on this machine's host), each
           cell's collective result and wire bytes and counts by kind, the
           count's seconds and the roofline's three terms (NVLink's 450 GB/s
           each way for the collective one); (b) the CPU test's reduced
           granite-3-8b prefill on a (2, 4) fake world, its 34 collectives
           equal to the list derived by hand in tests/hand_layouts.py
           (exact: this torch's DTensor chooses what the CPU's does); (c)
           the same step on CUDA tensors as DTensors over a (1, 1) cuda
           mesh (a fake world of one): no collective, logits and cache equal
           to the plain step bit for bit.  Launches no kernel;
16. lanes  lane sharding (``sharding.virtual_lane_devices``,
           ``scenario/shardexec.py``: each chunk of lanes split into one
           contiguous block a shard, a CUDA stream each, all blocks issued
           before the outputs come back in lane order): ``sweep`` as a user
           calls it, held bit for bit to phase 7's unsharded outputs of
           grids (b)-(d) (every schedule output, energy, peak temperature),
           K1's launches (a block a scheduler value and chunk) and the
           shard, pad and chunk counters exact: (a) grid (b) over 4 shards,
           3 runs; (b) over 7 (5 pad designs); (c) with chunk=135 over 4
           (width 136, 8 chunks, 8 pad designs); (d) grid (c) over 4
           (designs stream) and its first 4 designs x 16 policies over 8
           (policies stream, at grid (c)'s PE width); (e) grid (d) over 4;
           (f) ``sweep(telemetry=True)`` static and ondemand over 4, every
           lane's telemetry = the unsharded sweep's; (g) the same over the
           machine's cards where it has more than one (logged as not run
           on one card); (h) grid (b) and grid (c) at etf unsharded, as
           one block through the streamer and over 2, 4 and 8 shards: the
           wall, K1's time a launch (CUDA events on the block's stream),
           the launches' sum against their span (the streams' overlap),
           the peak device memory.

``--profile`` adds the device time of each of K4's three launches at S=4096
bf16 (``torch.profiler``), and a second, instrumented pass of each phase-5
serve after the measured one: prefill and tick times by a host clock with a
synchronise after each, and ``torch.profiler``'s device time by kernel
(asserting one decode kernel launch per ``decode_attention`` call and no merge
kernel).

A failure in any phase raises: the run exits non-zero and prints no result
line.  The last line of standard output is the result object; the line before
it describes the kernels; the card's name and power limit stand on their own
line before both.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import os

# phase 12 trains under torch.use_deterministic_algorithms(True), which needs
# cuBLAS's workspace fixed before the process's first cuBLAS call
# lint: waive TX003 -- a program, not a module (ROADMAP, "Bit-exact resume")
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
             "False); this script runs on the GPU only")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch.nn.functional as F  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.core import simkernel_ref, simkernel_torch  # noqa: E402
from repro_torch.core.applications import _chain, wifi_tx  # noqa: E402
from repro_torch.core.dvfs import (GovernorPolicy, OndemandGovernor,  # noqa: E402
                                   policy_lanes, stack_policies)
from repro_torch.core.jobgen import deterministic_trace, poisson_trace  # noqa: E402
from repro_torch.core.resources import CommModel, make_soc_table2  # noqa: E402
from repro_torch.core.schedulers import get_scheduler  # noqa: E402
from repro_torch.data import SyntheticLMPipeline  # noqa: E402
from repro_torch.dse import (DesignPoint, DesignSpace, evaluate,  # noqa: E402
                             pareto_mask, pareto_search, stack_tables,
                             stack_traces)
from repro_torch.dse import batch as dse_batch  # noqa: E402
from repro_torch.dse import thermal_torch as tthermal  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as k3  # noqa: E402
from repro_torch.kernels import epoch_scan as k1  # noqa: E402
from repro_torch.kernels import flash_attention as k2  # noqa: E402
from repro_torch.kernels import rg_lru as k5  # noqa: E402
from repro_torch.kernels import ssd_scan as k4  # noqa: E402
from repro_torch.launch import dryrun, hillclimb, roofline  # noqa: E402
from repro_torch.launch.mesh import (LINK_BW, make_host_mesh,  # noqa: E402
                                    rules_for)
from repro_torch.launch.steps import (batch_to, init_opt_state,  # noqa: E402
                                      make_train_step)
from repro_torch.launch.train import (deterministic, train,  # noqa: E402
                                      train_config, train_with_retries)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.analysis import (compile_gate, load_config,  # noqa: E402
                                  run_analysis)
from repro_torch.obs import bench as obs_bench  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.obs import report as obs_report  # noqa: E402
from repro_torch.obs import telemetry as obs_tel  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.models.params import (ParamStore, tree_leaves,  # noqa: E402
                                       tree_map)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.models.transformer import stack_layout  # noqa: E402
from repro_torch.scenario import (FaultSpec, Scenario, TraceSpec,  # noqa: E402
                                  pe_loss_faults, run, sweep, tables_for)
from repro_torch.scenario.faults import (fault_scan_steps,  # noqa: E402
                                         normalize_failures, stack_fault_plans)
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.scenario import shardexec  # noqa: E402
from repro_torch.sharding import (Mesh, lane_devices, use_mesh,  # noqa: E402
                                  virtual_lane_devices)

# the modules (the package's `sweep` and `run` attributes are the functions)
sweep_mod = importlib.import_module("repro_torch.scenario.sweep")
run_mod = importlib.import_module("repro_torch.scenario.run")
dse_reports = importlib.import_module("repro_torch.dse.reports")

DEV = torch.device("cuda", 0)
# NVIDIA H100 SXM data sheet (dense rates): the peaks every bound is stated against
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
LRU_TOL = 1e-5
KERNELS = {"flash_attention": k2, "decode_attention": k3, "ssd_scan": k4,
           "rg_lru": k5, "epoch_scan": k1}
# the serves of phase 5: prompt lengths (mamba2's inside the reference's
# chunk rule, a multiple of min(256, length); recurrentgemma's 5000 wraps
# its 2048-slot ring; deepseek's inside the MoE group rule, a multiple of
# min(2048, length): 4096 is two groups)
PROMPT_LENS = {
    "gemma2-2b": [37, 128, 512, 1000, 2048, 5000, 64, 300],
    "recurrentgemma-2b": [37, 128, 512, 1000, 2048, 5000, 64, 300],
    "mamba2-130m": [37, 64, 128, 256, 512, 1024, 2048, 4096],
    "deepseek-moe-16b": [37, 128, 512, 1000, 2048, 4096, 64, 300],
}
NEW_TOKENS = 16


def log(msg: str):
    print(msg, flush=True)


def eager_ms(fn, iters: int = 10, warm: int = 2) -> float:
    """Median milliseconds of one ``fn()`` called from Python, by CUDA events.
    Where the device finishes before the host has issued the next call, this
    is the host's time per call, not the device's."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fns, rounds: int = 3, reps: int = 5) -> float:
    """Median device milliseconds of one call: ``rounds`` passes over the
    closures ``fns`` are captured into one CUDA graph and replayed, so no host
    time lies between the launches.  Several closures on different buffers
    keep a call from finding its inputs in the 50 MB L2 left by the last.
    The warm-up runs on the stream that captures, so what a wrapper makes once
    per stream (K3's counters) is made there, not inside the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(rounds):
            for fn in fns:
                fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / (rounds * len(fns)))
    del graph
    return statistics.median(times)


def compare(got: torch.Tensor, want: torch.Tensor, tol: float, what: str) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol·|want| everywhere."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: shape {tuple(g.shape)} vs "
                             f"{tuple(w.shape)} or non-finite output")
    err = (g - w).abs()
    if bool((err > tol + tol * w.abs()).any()):
        raise AssertionError(f"{what}: max abs err {float(err.max()):.3e} "
                             f"exceeds tolerance {tol}")
    return float(err.max())


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV,
                       dtype=torch.float32).to(dtype)


# ------------------------------------------------------------------ phase 1-2

def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0 of {torch.cuda.device_count()}: "
        f"{torch.cuda.get_device_name(0)}")
    log(smi)
    return smi


def phase_build(verbose: bool):
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"[build] {nvcc[-2].strip()} ({nvcc[-1].strip()}), "
        f"flags {' '.join(_build.NVCC_FLAGS)}")
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=verbose)
    for name in libs:
        _build.load(name)  # lint: waive TX003 -- opens each built library once
    log(f"[build] {len(libs)} CUDA sources ({', '.join(sorted(libs))}) built "
        f"and loaded in {time.perf_counter() - t0:.1f} s into "
        f"{_build.build_dir()}")


# ------------------------------------------------------------------ phase 3

def keys_attended(S: int, window) -> int:
    r = np.arange(1, S + 1, dtype=np.int64)
    return int((np.minimum(r, window) if window else r).sum())


def flash_bound_ms(B, H, KV, S, Dh, window, dtype):
    """(ms, 'bytes'|'operations'): the larger of Q,K,V read + O written once
    over the memory rate and 4·B·H·Dh·Σ_rows(keys attended) FLOP over the peak
    rate of the input type (bf16: tensor cores; f32: CUDA cores)."""
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * S * H * Dh + 2 * B * S * KV * Dh) * item
    flops = 4 * B * H * Dh * keys_attended(S, window)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_b, t_o = nbytes / PEAK_BYTES_S, flops / peak
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def decode_bound_ms(B, H, KV, L, Dh, valid, dtype):
    """As above for one decode call.  Only valid slots need reading, so the
    bytes are this run's: 2·(valid keys)·KV·Dh K/V elements, q, the output and
    the (B,L) mask."""
    item = torch.finfo(dtype).bits // 8
    nvalid = int(valid.sum())
    nbytes = 2 * nvalid * KV * Dh * item + 2 * B * H * Dh * item + B * L
    flops = 4 * H * Dh * nvalid
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_b, t_o = nbytes / PEAK_BYTES_S, flops / peak
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def sdpa_causal(q, k, v, scale):
    """The library yardstick for K2: (B,S,H,Dh) in and out, GQA, causal; no
    softcap (the library call has none)."""
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, scale=scale, enable_gqa=True)
    return o.transpose(1, 2)


def band_mask(S, window):
    """(S,S) bool: causal and inside the sliding window."""
    r = torch.arange(S, device=DEV)[:, None]
    c = torch.arange(S, device=DEV)[None, :]
    return (c <= r) & (c > r - window)


def sdpa_band(q, k, v, mask, scale):
    """The library yardstick for K2 with a window: a boolean band mask."""
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, scale=scale, enable_gqa=True)
    return o.transpose(1, 2)


def sdpa_decode(q, k, v, valid, scale):
    """The library yardstick for K3: boolean mask, GQA; no softcap."""
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=valid[:, None, None, :], scale=scale, enable_gqa=True)
    return o.transpose(1, 2)


def phase_flash(gen):
    """K2 vs plain.  Returns the `kernels` entry, timed at the paths' heaviest
    prefill (gemma2-2b, S=5000, bf16, global layer)."""
    Dh = 256
    # gemma2-2b: 8 heads on 4 KV heads, softcap 50, global or window 4096
    cases = [(1, S, 8, 4, Dh, w, 50.0) for S in (37, 1000, 5000)
             for w in (None, 4096)]
    # recurrentgemma-2b's local layers: 10 heads on 1 KV head, window 2048
    cases += [(1, S, 10, 1, Dh, 2048, None) for S in (37, 1000, 5000)]
    cases.append((2, 100, 4, 2, 16, 32, 50.0))      # the reduced config's shape
    cases.append((2, 100, 4, 2, 16, None, None))
    # the other head dims and head groupings the supported configs use
    cases.append((1, 200, 8, 2, 128, None, None))   # 4 query heads per KV head
    cases.append((1, 150, 9, 1, 64, 64, 30.0))      # 9 per KV head (MQA-like)
    cases.append((2, 70, 2, 2, 32, None, None))     # MHA
    timed = len(cases)
    # the edges of the tiles at every head dim (64 query rows a block, 64 keys
    # a tile; 32 at Dh=256 on a large grid): one row, a tile less one, a tile,
    # a tile plus one, many tiles plus one; a window that is no multiple of a
    # tile; a softcap with a window
    for dh in k2.HEAD_DIMS:
        cases += [(1, S, 4, 2, dh, None, None) for S in (1, 63, 64, 65, 4097)]
        cases += [(1, 1000, 4, 2, dh, 100, None), (1, 777, 4, 2, dh, 300, 50.0)]
    cases = [c + (1.0,) for c in cases]
    # q scaled by 8: scores of std 8, up to ~40, where tanh bends (both tiles
    # of head_dim 256)
    cases += [(1, 1000, 8, 4, 256, None, 50.0, 8.0),
              (1, 4097, 8, 4, 256, 4096, 50.0, 8.0),
              (1, 777, 4, 2, 64, None, 30.0, 8.0)]
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    tiles = set()      # key tiles the bf16 cases at head_dim 256 ran
    entry = {}
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (b, S, h, kv, dh, window, softcap, qmul) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            q = (randn(gen, (b, S, h, dh), torch.float32) * qmul).to(dtype)
            k = randn(gen, (b, S, kv, dh), dtype)
            v = randn(gen, (b, S, kv, dh), dtype)
            kw = dict(causal=True, window=window, softcap=softcap,
                      scale=dh ** -0.5)
            out = k2.flash_attention(q, k, v, **kw)
            want = k2.flash_attention_plain(q, k, v, **kw)
            what = (f"flash_attention B={b} S={S} H={h} KV={kv} Dh={dh} "
                    f"window={window} softcap={softcap} q x{qmul:g} "
                    f"{str(dtype).split('.')[-1]}")
            if dtype == torch.bfloat16:
                tile = k2.key_tile(S, dh, b, h, sms)
                what += f" (key tile {tile})"
                if dh == 256:
                    tiles.add(tile)
            err = compare(out, want, TOL[dtype], what)
            errs[dtype] = max(errs[dtype], err)
            del want
            line = f"[kernels] {what}: max_abs_err {err:.3e}"
            if dh == Dh and i < timed:
                ms = device_ms([lambda: k2.flash_attention(q, k, v, **kw)])
                eager = eager_ms(lambda: k2.flash_attention(q, k, v, **kw))
                plain = device_ms(
                    [lambda: k2.flash_attention_plain(q, k, v, **kw)], rounds=2)
                bound, by = flash_bound_ms(b, h, kv, S, dh, window, dtype)
                if window is None:
                    lib = device_ms([lambda: sdpa_causal(q, k, v, dh ** -0.5)])
                else:
                    mask = band_mask(S, window)
                    lib = device_ms(
                        [lambda: sdpa_band(q, k, v, mask, dh ** -0.5)])
                line += (f", kernel {ms:.4f} ms (eager call {eager:.4f} ms), "
                         f"plain {plain:.4f} ms, bound {bound:.5f} ms ({by}), "
                         f"library {lib:.4f} ms")
                if (S, h, window, dtype) == (5000, 8, None, torch.bfloat16):
                    entry = {"shape": f"B={b} S={S} H={h} KV={kv} Dh={dh} bf16 "
                                      "causal softcap=50 window=None",
                             "max_abs_err": err, "ms": ms, "eager_call_ms": eager,
                             "plain_ms": plain, "bound_ms": bound,
                             "bound_by": by, "library_ms": lib}
            log(line)
    if tiles != {32, 64}:
        raise AssertionError(f"flash_attention: head_dim 256 ran key tiles "
                             f"{sorted(tiles)}, not both 32 and 64")
    entry["max_abs_err_f32_all_cases"] = errs[torch.float32]
    entry["max_abs_err_bf16_all_cases"] = errs[torch.bfloat16]
    return entry


def full_valid(L, pos):
    idx = torch.arange(L, device=DEV)[None, :]
    return idx <= torch.tensor(pos, device=DEV)[:, None]


def ring_valid(L, window, pos):
    """The ring-buffer mask of models/attention.py for per-slot positions."""
    posb = torch.tensor(pos, device=DEV)[:, None]
    idx = torch.arange(L, device=DEV)[None, :]
    slot_pos = posb - torch.remainder(torch.remainder(posb, L) - idx, L)
    return (slot_pos >= 0) & (slot_pos > posb - window)


def phase_decode(gen):
    """K3 vs plain.  Returns the `kernels` entry, timed at a global layer's
    decode tick (B=4, L=8192, bf16, four different positions)."""
    B, Dh = 4, 256
    pos = [5015, 2063, 1015, 315]
    cases = [
        ("full L=8192", B, 8192, 8, 4, Dh, full_valid(8192, pos), 50.0),
        ("full L=8192 at the brim", B, 8192, 8, 4, Dh, full_valid(8192, [8190, 8191, 0, 4096]), 50.0),
        ("ring L=4096", B, 4096, 8, 4, Dh, ring_valid(4096, 4096, [5015, 9000, 4096, 315]), 50.0),
        # recurrentgemma-2b's local layers: ring of 2048, 10 heads on 1 KV head
        ("recurrentgemma ring L=2048", B, 2048, 10, 1, Dh, ring_valid(2048, 2048, pos), None),
        ("small full", 2, 64, 4, 2, 16, full_valid(64, [10, 63]), 50.0),
        ("small ring, one slot empty", 2, 32, 4, 2, 16,
         ring_valid(32, 32, [40, 7]) & torch.tensor([[True], [False]], device=DEV), None),
        # the other head dims and head groupings the supported configs use
        ("4 heads per KV head", 2, 300, 8, 2, 128, full_valid(300, [299, 130]), None),
        ("9 heads per KV head", 1, 200, 9, 1, 64, full_valid(200, [150]), 30.0),
        ("MHA", 2, 129, 2, 2, 32, full_valid(129, [128, 5]), None),
    ]
    timed = 4
    # every query-group size a block serves in one pass (up to 16 heads on
    # one KV head), and a group of 16 with a fully masked slot
    cases += [(f"{g} heads per KV head", 2, 700, 2 * g, 2, dh,
               full_valid(700, [699, 250]), 50.0 if g % 2 else None)
              for g, dh in ((1, 256), (2, 64), (4, 128), (9, 256), (10, 256),
                            (16, 256))]
    cases.append(("16 heads per KV head, one slot empty", 2, 300, 16, 1, 256,
                  full_valid(300, [299, 5]) & torch.tensor([[True], [False]],
                                                            device=DEV), None))
    cases = [c + (1.0,) for c in cases]
    # q scaled by 8: the scores reach the softcap
    cases += [("softcap reached", 2, 700, 8, 4, 256,
               full_valid(700, [699, 250]), 50.0, 8.0),
              ("softcap reached, 9 heads per KV head", 1, 300, 9, 1, 64,
               full_valid(300, [299]), 30.0, 8.0)]
    entry = {}
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (name, b, L, h, kv, dh, valid, softcap, qmul) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            q = (randn(gen, (b, 1, h, dh), torch.float32) * qmul).to(dtype)
            k = randn(gen, (b, L, kv, dh), dtype)
            v = randn(gen, (b, L, kv, dh), dtype)
            kw = dict(softcap=softcap, scale=dh ** -0.5)
            out = k3.decode_attention(q, k, v, valid, **kw)
            want = k3.decode_attention_plain(q, k, v, valid, **kw)
            what = (f"decode_attention {name} B={b} L={L} H={h} KV={kv} "
                    f"Dh={dh} valid={int(valid.sum())} "
                    f"{str(dtype).split('.')[-1]}")
            err = compare(out, want, TOL[dtype], what)
            errs[dtype] = max(errs[dtype], err)
            if name.endswith("slot empty") and float(out[1].abs().max()) != 0.0:
                raise AssertionError(f"{what}: the empty slot's output is not 0")
            line = f"[kernels] {what}: max_abs_err {err:.3e}"
            if i < timed:
                # the caller finds the cache cold (26 layers of caches and
                # weights pass between two ticks of one layer): time over
                # several copies of K/V, more than the L2 holds
                sets = [(k, v)] + [(k.clone(), v.clone()) for _ in range(5)]

                def calls(fn):
                    return [lambda kk=kk, vv=vv: fn(q, kk, vv, valid, **kw)
                            for kk, vv in sets]
                ms = device_ms(calls(k3.decode_attention))
                eager = eager_ms(lambda: k3.decode_attention(q, k, v, valid, **kw))
                plain = device_ms(calls(k3.decode_attention_plain), rounds=1)
                bound, by = decode_bound_ms(b, h, kv, L, dh, valid, dtype)
                lib = device_ms(calls(
                    lambda q, kk, vv, valid, **kw:
                    sdpa_decode(q, kk, vv, valid, dh ** -0.5)))
                line += (f", kernel {ms:.4f} ms (eager call {eager:.4f} ms), "
                         f"plain {plain:.4f} ms, bound {bound:.5f} ms ({by}), "
                         f"library {lib:.4f} ms")
                if name == "full L=8192" and dtype == torch.bfloat16:
                    entry = {"shape": f"B={b} L={L} H={h} KV={kv} Dh={dh} bf16 "
                                      f"softcap=50 valid keys={int(valid.sum())}",
                             "max_abs_err": err, "ms": ms, "eager_call_ms": eager,
                             "plain_ms": plain, "bound_ms": bound,
                             "bound_by": by, "library_ms": lib}
                del sets
            log(line)
    entry["max_abs_err_f32_all_cases"] = errs[torch.float32]
    entry["max_abs_err_bf16_all_cases"] = errs[torch.bfloat16]
    return entry


# the K2/K3 shapes of the models with no softcap, where
# scaled_dot_product_attention computes the same function: phase 10's
# paligemma-3b (8 heads on one KV head, head_dim 256) and
# seamless-m4t-large-v2's decoder (16 heads on 16, head_dim 64: a group of
# one), K2 at B=1 and at phase 10's batch of 4 (a prefill of 256 patches + 64
# tokens; 32 tokens), K3 at phase 10's caches (256 + 64 + 16 = 336 slots,
# 32 + 16 = 48); and the MoE serves of phases 5 and 11, deepseek-moe-16b (16
# heads on 16, head_dim 128) and dbrx-132b (48 on 8: a group of 6), K2 at a
# prefill of 2,048 tokens, K3 at their 4-slot 8,192-token caches.  K3's four
# slots stand at different positions
NOCAP_FLASH = {"paligemma-3b": [(1, 320, 8, 1, 256), (4, 320, 8, 1, 256)],
               "seamless-m4t-large-v2": [(1, 64, 16, 16, 64), (4, 32, 16, 16, 64)],
               "deepseek-moe-16b": [(1, 2048, 16, 16, 128)],
               "dbrx-132b": [(1, 2048, 48, 8, 128)]}
NOCAP_DECODE = {"paligemma-3b": (4, 336, 8, 1, 256, [327, 320, 335, 330]),
                "seamless-m4t-large-v2": (4, 48, 16, 16, 64, [40, 32, 47, 35]),
                "deepseek-moe-16b": (4, 8192, 16, 16, 128, [4111, 2063, 1015, 315]),
                "dbrx-132b": (4, 8192, 48, 8, 128, [4111, 2063, 1015, 315])}


def phase_nocap_kernels(gen):
    """K2 and K3 against their plain versions at the no-softcap models'
    shapes (bf16 and f32), and ``scaled_dot_product_attention`` against the
    plain version too (it computes the same function here); in bf16 the
    kernel, its eager call, the plain version, the bound and the library
    call timed.  Returns {kernel: {"<arch> ...": entry}}."""
    out = {"flash_attention": {}, "decode_attention": {}}
    for arch, shapes in NOCAP_FLASH.items():
        for b, S, h, kv, dh in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                q = randn(gen, (b, S, h, dh), dtype)
                k = randn(gen, (b, S, kv, dh), dtype)
                v = randn(gen, (b, S, kv, dh), dtype)
                kw = dict(causal=True, window=None, softcap=None, scale=dh ** -0.5)
                want = k2.flash_attention_plain(q, k, v, **kw)
                name = f"{arch} prefill B={b} S={S} H={h} KV={kv} Dh={dh}"
                what = f"flash_attention {name} {str(dtype).split('.')[-1]}"
                err = compare(k2.flash_attention(q, k, v, **kw), want,
                              TOL[dtype], what)
                lib_err = compare(sdpa_causal(q, k, v, dh ** -0.5), want,
                                  TOL[dtype], f"{what} (library call)")
                line = (f"[kernels] {what}: max_abs_err {err:.3e} (library call "
                        f"{lib_err:.3e})")
                if dtype == torch.bfloat16:
                    ms = device_ms([lambda: k2.flash_attention(q, k, v, **kw)])
                    eager = eager_ms(lambda: k2.flash_attention(q, k, v, **kw))
                    plain = device_ms(
                        [lambda: k2.flash_attention_plain(q, k, v, **kw)], rounds=2)
                    bound, by = flash_bound_ms(b, h, kv, S, dh, None, dtype)
                    lib = device_ms([lambda: sdpa_causal(q, k, v, dh ** -0.5)])
                    out["flash_attention"][name] = {
                        "max_abs_err": err, "ms": ms, "eager_call_ms": eager,
                        "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                        "library_ms": lib}
                    line += (f", kernel {ms:.4f} ms (eager call {eager:.4f} ms), "
                             f"plain {plain:.4f} ms, bound {bound:.5f} ms ({by}), "
                             f"library {lib:.4f} ms")
                log(line)
    for arch, (b, L, h, kv, dh, pos) in NOCAP_DECODE.items():
        valid = full_valid(L, pos)
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(gen, (b, 1, h, dh), dtype)
            k = randn(gen, (b, L, kv, dh), dtype)
            v = randn(gen, (b, L, kv, dh), dtype)
            kw = dict(softcap=None, scale=dh ** -0.5)
            want = k3.decode_attention_plain(q, k, v, valid, **kw)
            name = (f"{arch} decode B={b} L={L} H={h} KV={kv} Dh={dh} "
                    f"valid={int(valid.sum())}")
            what = f"decode_attention {name} {str(dtype).split('.')[-1]}"
            err = compare(k3.decode_attention(q, k, v, valid, **kw), want,
                          TOL[dtype], what)
            lib_err = compare(sdpa_decode(q, k, v, valid, dh ** -0.5), want,
                              TOL[dtype], f"{what} (library call)")
            line = (f"[kernels] {what}: max_abs_err {err:.3e} (library call "
                    f"{lib_err:.3e})")
            if dtype == torch.bfloat16:
                # cold caches, as phase_decode times them
                sets = [(k, v)] + [(k.clone(), v.clone()) for _ in range(5)]

                def calls(fn):
                    return [lambda kk=kk, vv=vv: fn(q, kk, vv, valid, **kw)
                            for kk, vv in sets]
                ms = device_ms(calls(k3.decode_attention))
                eager = eager_ms(lambda: k3.decode_attention(q, k, v, valid, **kw))
                plain = device_ms(calls(k3.decode_attention_plain), rounds=1)
                bound, by = decode_bound_ms(b, h, kv, L, dh, valid, dtype)
                lib = device_ms(calls(lambda q, kk, vv, valid, **kw:
                                      sdpa_decode(q, kk, vv, valid, dh ** -0.5)))
                out["decode_attention"][name] = {
                    "max_abs_err": err, "ms": ms, "eager_call_ms": eager,
                    "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                    "library_ms": lib}
                line += (f", kernel {ms:.4f} ms (eager call {eager:.4f} ms), "
                         f"plain {plain:.4f} ms, bound {bound:.5f} ms ({by}), "
                         f"library {lib:.4f} ms")
            log(line)
    return out


def ssd_bound_ms(B, S, H, P, N, c, dtype):
    """(ms, 'bytes'|'operations') for one ssd_scan call.  Bytes: x, B, C read
    once in their type, dt and cs in f32, y written in x's type, the final
    state in f32.  Operations, the least this run needs: C·Bᵀ over the lower
    triangle of each chunk ONCE per (batch, chunk) (it is the same for every
    head), and per (batch, head, chunk) the lower-triangle product with x,
    the chunk state, and the inter-chunk term for every chunk but the first
    (whose entering state is zero); 2 FLOP per multiply-add, over the peak
    of the input type (bf16: tensor cores; f32: CUDA cores)."""
    item = torch.finfo(dtype).bits // 8
    nc = S // c
    tri = c * (c + 1) // 2
    nbytes = (B * S * (H * P + 2 * N) + B * S * H * P) * item \
        + 2 * B * S * H * 4 + B * H * P * N * 4
    macs = B * nc * tri * N + B * H * nc * (tri * P + c * P * N) \
        + B * H * (nc - 1) * c * N * P
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_b, t_o = nbytes / PEAK_BYTES_S, 2 * macs / peak
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def ssd_case(gen, B, S, H, P, N, c, dtype):
    """Inputs laid out as apply_mamba hands them over: x, B and C are views
    of one (B,S,H·P+2N) projection; dt = softplus(·), A < 0, cs the cumsum of
    A·dt inside each chunk."""
    nc = S // c
    xbc = (randn(gen, (B, S, H * P + 2 * N), torch.float32) * 0.5).to(dtype)
    x = xbc[..., :H * P].reshape(B, nc, c, H, P)
    bm = xbc[..., H * P:H * P + N].reshape(B, nc, c, N)
    cm = xbc[..., H * P + N:].reshape(B, nc, c, N)
    dt = F.softplus(randn(gen, (B, S, H), torch.float32)).reshape(B, nc, c, H)
    A = -torch.exp(randn(gen, (H,), torch.float32) * 0.3)
    return x, dt, torch.cumsum(dt * A, dim=2), bm, cm


def ssd_profile(args):
    """Device time of each of K4's launches in one call, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    k4.ssd_scan(*args)
    torch.cuda.synchronize()
    reps = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            k4.ssd_scan(*args)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and "ssd_" in e.key:
            log(f"[profile]   {us / 1e3 / reps:.4f} ms a call  x{e.count // reps} "
                f"{e.key[:90]}")


def phase_ssd(gen, with_profile: bool = False):
    """K4 vs plain.  Returns the `kernels` entry, timed at mamba2-130m's
    heaviest prefill on the path (S=4096, bf16)."""
    cases = [(1, S, 24, 64, 128, 256) for S in (256, 1024, 4096)]
    cases += [(2, 64, 4, 16, 16, 32),       # the reduced config's geometry
              (1, 37, 3, 16, 16, 37),       # a chunk no multiple of the tile
              (1, 128, 2, 32, 64, 64)]
    cases = [c + ((torch.bfloat16, torch.float32),) for c in cases]
    # the bf16 (tensor-core) path at the edges of its 64-row tiles, in one
    # chunk and in three (the inter-chunk term), at each width it takes; one
    # batch of 2
    cases += [(1, nc * c, h, P, N, c, (torch.bfloat16,))
              for P, N, h in ((16, 16, 3), (32, 64, 3), (64, 128, 24))
              for c in (1, 15, 16, 17, 63, 64, 65, 255, 256) for nc in (1, 3)]
    cases.append((2, 3 * 65, 3, 64, 128, 65, (torch.bfloat16,)))
    entry = {}
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (b, S, h, P, N, c, dtypes) in enumerate(cases):
        for dtype in dtypes:
            args = ssd_case(gen, b, S, h, P, N, c, dtype)
            y, hl = k4.ssd_scan(*args)
            wy, wh = k4.ssd_scan_plain(*args)
            what = (f"ssd_scan B={b} S={S} H={h} P={P} N={N} chunk={c} "
                    f"{str(dtype).split('.')[-1]}")
            err = max(compare(y, wy, SSD_TOL[dtype], what + " y"),
                      compare(hl, wh, SSD_TOL[dtype], what + " state"))
            errs[dtype] = max(errs[dtype], err)
            line = f"[kernels] {what}: max_abs_err {err:.3e}"
            if i < 3:      # mamba2-130m's S = 256, 1024, 4096
                ms = device_ms([lambda: k4.ssd_scan(*args)])
                eager = eager_ms(lambda: k4.ssd_scan(*args))
                plain = device_ms([lambda: k4.ssd_scan_plain(*args)], rounds=1)
                bound, by = ssd_bound_ms(b, S, h, P, N, c, dtype)
                line += (f", kernel {ms:.4f} ms (eager call {eager:.4f} ms), "
                         f"plain {plain:.4f} ms, bound {bound:.5f} ms ({by}), "
                         "library n/a")
                if S == 4096 and dtype == torch.bfloat16:
                    entry = {"shape": f"B={b} S={S} H={h} P={P} N={N} "
                                      f"chunk={c} bf16",
                             "max_abs_err": err, "ms": ms, "eager_call_ms": eager,
                             "plain_ms": plain, "bound_ms": bound,
                             "bound_by": by, "library_ms": None,
                             "library_note": "no single PyTorch call computes "
                                             "the chunked SSD scan"}
            log(line)
            if with_profile and (S, dtype) == (4096, torch.bfloat16):
                ssd_profile(args)
    entry["max_abs_err_f32_all_cases"] = errs[torch.float32]
    entry["max_abs_err_bf16_all_cases"] = errs[torch.bfloat16]
    return entry


def rglru_bound_ms(B, S, W):
    """(ms, 'bytes'|'operations'): a and x read, h written once, f32; one
    multiply and one add per element over the f32 CUDA-core rate."""
    nbytes = 3 * B * S * W * 4
    t_b, t_o = nbytes / PEAK_BYTES_S, 2 * B * S * W / PEAK_F32_FLOPS
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def rglru_inputs(gen, b, S, W, kind):
    r = randn(gen, (b, S, W), torch.float32)
    x = randn(gen, (b, S, W), torch.float32)
    if kind == "sigmoid":
        return torch.sigmoid(r), x * 0.5
    # a in (0.99, 1); x scaled by sqrt(1 - a²) as the RG-LRU does
    a = 1.0 - 0.01 * torch.sigmoid(r)
    return a, x * torch.sqrt(1.0 - a * a)


def rglru_deterministic(a, x):
    """Two eager calls and three calls captured into one CUDA graph and
    replayed return the same bits (the carry is folded in one fixed order)."""
    first = k5.rg_lru(a, x)
    second = k5.rg_lru(a, x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k5.rg_lru(a, x)      # the capturing stream's scratch, made outside the graph
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [k5.rg_lru(a, x) for _ in range(3)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same = [torch.equal(first, o) for o in [second] + outs]
        if not all(same):
            raise AssertionError(f"rg_lru is not deterministic: bit-equal to "
                                 f"the first call {same}")
    del graph


def phase_rglru(gen):
    """K5 vs plain (f32: the only input type, the gates are f32).  Returns the
    `kernels` entry, timed at recurrentgemma-2b's heaviest prefill on the path
    (B=1, S=5000, W=2560)."""
    cases = [(1, S, 2560, "sigmoid") for S in (37, 1000, 5000)]
    cases += [(1, 5000, 2560, "near 1"),    # long memory, gated as the model
              (2, 5000, 2560, "sigmoid"), (4, 5000, 2560, "near 1"),
              (2, 77, 100, "sigmoid"),      # ragged W and S
              (3, 1, 33, "sigmoid")]
    # the edges of a warp's rows and of a block's chunk, in one and three
    # chunks, and the first anchor beyond chunk 0, with a ragged channel tile
    R, L, K = k5.ROWS, k5.CHUNK, k5.ANCHOR
    cases += [(2, S, W, "near 1" if S % 2 else "sigmoid")
              for S in (1, R - 1, R, R + 1, L - 1, L, L + 1, 2 * L + 1,
                        K * L, K * L + 1)
              for W in (33, 100)]
    info = k5.kernel_info(DEV)
    tiles, chunks, blocks = k5.geometry(1, 5000, 2560)
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    log(f"[kernels] rg_lru: blocks of {info['chunk_rows']} rows of S x "
        f"{info['channels']} channels, {info['threads']} threads, "
        f"{info['blocks_per_sm']} blocks per SM "
        f"({info['blocks_per_sm'] * sms} resident on {sms} SMs), an anchor "
        f"every {info['anchor']} chunks; B=1 S=5000 W=2560: grid {tiles} "
        f"tiles x {chunks} chunks = {blocks} blocks")
    entry = {}
    worst = 0.0
    for (b, S, W, kind) in cases:
        a, x = rglru_inputs(gen, b, S, W, kind)
        what = f"rg_lru B={b} S={S} W={W} a {kind} f32"
        err = compare(k5.rg_lru(a, x), k5.rg_lru_plain(a, x), LRU_TOL, what)
        worst = max(worst, err)
        line = f"[kernels] {what}: max_abs_err {err:.3e}"
        if W == 2560:
            ms = device_ms([lambda: k5.rg_lru(a, x)])
            eager = eager_ms(lambda: k5.rg_lru(a, x))
            plain = device_ms([lambda: k5.rg_lru_plain(a, x)], rounds=1, reps=2)
            bound, by = rglru_bound_ms(b, S, W)
            line += (f", kernel {ms:.4f} ms (eager call {eager:.4f} ms), "
                     f"plain {plain:.4f} ms, bound {bound:.5f} ms ({by}, "
                     f"{100 * bound / ms:.0f}% of it), library n/a")
            if S == 5000 and b == 1 and kind == "sigmoid":
                entry = {"shape": f"B={b} S={S} W={W} f32",
                         "max_abs_err": err, "ms": ms, "eager_call_ms": eager,
                         "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                         "library_ms": None,
                         "library_note": "no single PyTorch call computes a "
                                         "linear recurrence"}
            if S == 5000 and b == 1 and kind == "near 1":
                rglru_deterministic(a, x)
                line += ("; bit-identical over 2 eager calls and 3 calls in "
                         "a CUDA graph, replayed twice")
        log(line)
    entry["max_abs_err_f32_all_cases"] = worst
    return entry


# K6, the thermal grid, at the main paths' shapes: a static sweep's launch
# (1,024 lanes on 15 PEs) and a DSE call (1,080 designs of 1-19 PEs padded to
# 19 x 4 lanes), lanes of 1,000 jobs x 8 tasks of 1-61 us over a 50 ms
# makespan (tests/thermal_schedules.py: bins the PEs fill in part), 32 bins x
# 3 repeats; then that module's bin cases at DS3's size
THERMAL_SHAPES = {"static_launch": ((1, 1024), [15]),
                  "dse_call": ((1080, 4), [1 + d % 19 for d in range(1080)])}
THERMAL_JOBS, THERMAL_TASKS, THERMAL_TOL = 1000, 8, 2e-5


def thermal_bound_ms(L, JT):
    """K6's byte bound: every cell's start, finish, PE and flag read once
    (13 B), a lane's makespan and peak (8 B), at the data sheet's rate."""
    return (13 * JT + 8) * L / PEAK_BYTES_S * 1e3


def thermal_rel_err(got, want, what: str) -> float:
    """Largest relative gap of K6's peaks from the plain version's; raises
    past THERMAL_TOL."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    rel = float(((got - want).abs() / want.abs()).max())
    if rel > THERMAL_TOL:
        raise AssertionError(f"{what}: relative gap {rel:.3e} exceeds "
                             f"{THERMAL_TOL}")
    return rel


def phase_thermal():
    """K6 vs plain (f32, the schedules' type).  Returns the `kernels`
    entry, timed at a static sweep's launch, with the DSE call's shape and
    the bin cases' gaps beside it.  The plain version's time is one eager
    call's (CUDA events): ~725 small launches a chunk of lanes, host-bound."""
    sys.path.insert(0, str(ROOT / "tests"))
    try:      # the generator tests/test_torch_thermal_*.py use too
        cases = importlib.import_module("thermal_schedules")
    finally:
        sys.path.pop(0)
    grid, plain = tthermal.peak_temperature_grid, tthermal.peak_temperature_grid_plain
    JT = THERMAL_JOBS * THERMAL_TASKS
    entry = {}
    for name, (lead, pes) in THERMAL_SHAPES.items():
        gen = torch.Generator(device=DEV).manual_seed(len(pes))
        out, *tables = cases.schedules(gen, lead, THERMAL_JOBS, THERMAL_TASKS,
                                       pes, makespan_us=50_000.0)
        L, P = out["makespan_us"].numel(), max(pes)
        what = f"thermal_grid {name} L={L} P={P} bins=32 repeats=3 f32"
        got = grid(out, *tables)
        rel = thermal_rel_err(got, plain(out, *tables), what)
        ms = device_ms([lambda: grid(out, *tables)])
        eager = eager_ms(lambda: grid(out, *tables))
        plain_ms = eager_ms(lambda: plain(out, *tables), iters=3, warm=1)
        bound = thermal_bound_ms(L, JT)
        info = tthermal.kernel_info(P, 32, DEV)
        if info["local_bytes"]:
            raise AssertionError(f"{what}: {info['local_bytes']} local bytes "
                                 "a thread")
        log(f"[kernels] {what}: max_rel_err {rel:.3e}, kernel {ms:.4f} ms "
            f"(eager call {eager:.4f} ms), plain {plain_ms:.2f} ms (one eager "
            f"call), bound {bound:.5f} ms (bytes, {100 * bound / ms:.0f}% of "
            f"it), library n/a; {info['threads']} threads, "
            f"{info['shared_bytes']} B shared, {info['blocks_per_sm']} blocks "
            f"an SM, {info['registers']} registers, 0 local bytes")
        part = {"shape": f"L={L} P={P} J={THERMAL_JOBS} T={THERMAL_TASKS} "
                         "bins=32 repeats=3 f32",
                "max_rel_err": rel, "ms": ms, "eager_call_ms": eager,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                "geometry": info}
        if not entry:
            entry = dict(part, library_ms=None,
                         library_note="no single PyTorch call bins a schedule")
        else:
            entry[name] = part
        del out, tables, got
    entry["bin_cases_max_rel_err"] = {}
    for case, (_, kw) in cases.BIN_CASES.items():
        gen = torch.Generator(device=DEV).manual_seed(17)
        out, *tables = cases.schedules(gen, (2, len(cases.BIN_PES), 16),
                                       pes=cases.BIN_PES, **kw)
        want = plain(out, *tables)
        cases.assert_bins_matter(out, tables, 32, want, case, THERMAL_TOL)
        rel = thermal_rel_err(grid(out, *tables), want, f"thermal_grid {case}")
        entry["bin_cases_max_rel_err"][case] = rel
        log(f"[kernels] thermal_grid {case} (96 lanes of {kw['J']} jobs x "
            f"{kw['T']} tasks on {cases.BIN_PES} PEs, makespan "
            f"{kw['makespan_us'] / 1e3:.0f} ms): max_rel_err {rel:.3e}")
    torch.cuda.empty_cache()
    return entry


# ------------------------------------------------------------------ phase 4

def greedy_reference(model, params, prompt, n_new):
    """Teacher-forced greedy continuation via full forwards (the oracle)."""
    toks = list(int(t) for t in prompt)
    for _ in range(n_new):
        logits = model.forward_logits(
            params, {"tokens": torch.tensor([toks], device=DEV)})
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def record_logits(eng):
    """rid -> the logits row of every token ``eng`` emits (the prefill's last
    row, then the request's slot row of each decode tick), recorded by
    wrapping the engine's model calls on the instance."""
    rows, admitting = {}, []
    model, admit = eng.model, eng._admit
    prefill, decode = model.prefill, model.decode_step

    def _admit(req, slot):
        admitting[:] = [req.rid]
        return admit(req, slot)

    def _prefill(*args, **kw):
        out = prefill(*args, **kw)
        rows.setdefault(admitting[0], []).append(out[0][0, -1].float())
        return out

    def _decode(*args, **kw):
        active = [(i, r.rid) for i, r in enumerate(eng.active) if r is not None]
        out = decode(*args, **kw)
        for i, rid in active:
            rows[rid].append(out[0][i, -1].float())
        return out

    eng._admit, model.prefill, model.decode_step = _admit, _prefill, _decode
    return rows


@torch.no_grad()
def phase_reduced(arch):
    cfg = reduced(get_config(arch)).replace(window_size=32)
    assert cfg.attn_impl == "cuda" and cfg.dtype == "float32"
    if cfg.num_experts:
        # a capacity that drops nothing: the oracle's forward routes the
        # whole sequence as one group, the engine the prompt and then each
        # tick's slot tokens, so a capacity that drops pairs would drop
        # different ones (the reference's semantics)
        cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
    model = build_model(cfg, device=DEV)
    params = model.init_params(torch.Generator(device=DEV).manual_seed(0))
    # the tied, sqrt(d_model)-scaled embedding of random weights makes the
    # greedy token the input token; scaled down, it no longer does
    params["embed"]["tok"].mul_(0.1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 40)]       # 40 > window 32 wraps the rings
    before = {n: KERNELS[n].launches
              for n, k in expected_launches(cfg, 1, 1).items() if k}
    eng = ServeEngine(build_model(cfg, device=DEV), params, num_slots=2,
                      max_len=64, device=DEV)
    rows = record_logits(eng)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    idle = [n for n in before if KERNELS[n].launches == before[n]]
    if idle:
        raise AssertionError(f"reduced {arch}: engine did not launch {idle}")
    V, err = cfg.vocab_size, 0.0
    for r in reqs:
        want = greedy_reference(model, params, r.prompt, 6)
        if r.output != want:
            raise AssertionError(f"reduced {arch} req {r.rid}: {r.output} != "
                                 f"teacher-forced greedy {want}")
        toks = torch.tensor([list(r.prompt) + r.output[:-1]], device=DEV)
        full = model.forward_logits(params, {"tokens": toks})[0]
        got = torch.stack(rows[r.rid])
        # f32; prefill/decode and the forward take different algorithms
        # (chunked vs recurrent scans, flash vs decode kernel) and the card
        # sums in its own order: 10x the CPU tests' 1e-4
        err = max(err, compare(got[:, :V], full[len(r.prompt) - 1:, :V], 1e-3,
                               f"reduced {arch} req {r.rid} engine logits vs "
                               "forward_logits"))
    def echo(prompt):
        """Teacher-forced share of positions whose greedy token is the input."""
        t = torch.from_numpy(prompt.astype(np.int64)).to(DEV)
        logits = model.forward_logits(params, {"tokens": t[None]})[0, :, :V]
        return float((logits.argmax(-1) == t).float().mean())
    share = float(np.mean([echo(p) for p in prompts]))
    if not share < 0.5:
        raise AssertionError(f"reduced {arch}: greedy token echoes the input "
                             f"at {share:.0%} of positions")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48))).to(DEV)
    a = model.forward_logits(params, {"tokens": tokens})
    b = build_model(cfg.replace(attn_impl="einsum"), device=DEV) \
        .forward_logits(params, {"tokens": tokens})
    kerr = compare(a, b, 3e-2, f"reduced {arch} forward_logits cuda vs einsum")
    log(f"[reduced] {arch}: engine == teacher-forced greedy for {len(reqs)} "
        f"requests ({eng.ticks} ticks); logits of every step vs forward_logits "
        f"max_abs_err {err:.3e}; echo share {share:.3f}; logits cuda vs einsum "
        f"max_abs_err {kerr:.3e}")


@torch.no_grad()
def phase_reduced_bf16(arch):
    """The kernels' bf16 (tensor-core) paths end to end: the reduced model in
    bf16, ``forward_logits`` on the kernel path against the einsum path, and
    both against an f32 einsum forward of the same weights."""
    cfg = reduced(get_config(arch)).replace(window_size=32, dtype="bfloat16")
    model = build_model(cfg, device=DEV)
    params = model.init_params(torch.Generator(device=DEV).manual_seed(0))
    params["embed"]["tok"].mul_(0.1)
    # 80 > window 32; mamba2: two chunks of 256 (a length must be a multiple
    # of min(256, length))
    length = 512 if arch == "mamba2-130m" else 80
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, length))).to(DEV)
    V = cfg.vocab_size
    before = {n: KERNELS[n].launches
              for n, k in expected_launches(cfg, 1, 0).items() if k}
    kern = model.forward_logits(params, {"tokens": tokens})[..., :V].float()
    idle = [n for n in before if KERNELS[n].launches == before[n]]
    if idle:
        raise AssertionError(f"reduced {arch} bf16: {idle} not launched")
    ein = build_model(cfg.replace(attn_impl="einsum"), device=DEV) \
        .forward_logits(params, {"tokens": tokens})[..., :V].float()
    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, params)
    ref = build_model(cfg.replace(attn_impl="einsum", dtype="float32"),
                      device=DEV).forward_logits(p32, {"tokens": tokens})[..., :V]
    # Both bf16 paths round every layer's activations to bf16 (2^-8 relative);
    # the einsum path also rounds the scores and the probabilities (attention)
    # or seg, the decay weights and the carried state (mamba2), the kernels
    # round only P before P·V or seg·x.  So they are held to the bf16
    # tolerance of the kernel tests, 2e-2 absolute plus relative (the logits
    # of the tied embeddings are below 1 here; a CPU rehearsal differs by
    # 5e-3); and the kernel path must be no farther from f32 than twice the
    # einsum path's distance.  The absolute part is taken of the logits'
    # scale where that exceeds 1: deepseek-moe-16b's untied head gives
    # logits up to ~4, each path ~4e-2 from f32 where a logit is near 0 (a
    # CPU rehearsal), so both are divided by max(1, max |f32 logit|) first
    # (1 for the other families).
    scale = max(1.0, float(ref.abs().max()))
    err = scale * compare(kern / scale, ein / scale, 2e-2,
                          f"reduced {arch} bf16 forward_logits cuda vs einsum "
                          f"(over logit scale {scale:.2f})")
    e_kern = float((kern - ref).abs().max())
    e_ein = float((ein - ref).abs().max())
    if not e_kern <= 2 * e_ein + 1e-3:
        raise AssertionError(f"reduced {arch} bf16: kernel path {e_kern:.3e} "
                             f"from f32, einsum path {e_ein:.3e}")
    log(f"[reduced] {arch} bf16: logits cuda vs einsum max_abs_err {err:.3e}; "
        f"vs f32 einsum: cuda {e_kern:.3e}, einsum {e_ein:.3e} (logits up to "
        f"{float(ref.abs().max()):.2f})")


# ------------------------------------------------------------------ phase 5

def make_requests(cfg, prompt_lens):
    trace = poisson_trace(rate_jobs_per_ms=0.5, num_jobs=len(prompt_lens),
                          app_names=["chat"], seed=0)
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, size=n,
                                        dtype=np.int64).astype(np.int32),
                    max_new_tokens=NEW_TOKENS, arrival_s=float(t) * 1e-6)
            for i, (n, t) in enumerate(zip(prompt_lens, trace.arrival_us))]


def expected_launches(cfg, requests: int, ticks: int):
    """Launches of each kernel a serve must make: one per request for each
    prefill kernel of each layer, one per tick for decode attention."""
    pat, reps, tail = stack_layout(cfg)
    kinds = list(pat) * reps + list(tail)
    attn_layers = sum(k in ("global", "local", "xdec") for k in kinds)
    return {"flash_attention": attn_layers * requests,
            "decode_attention": attn_layers * ticks,
            "ssd_scan": kinds.count("mamba2") * requests,
            "rg_lru": kinds.count("rglru") * requests,
            "epoch_scan": 0}


def profile_serve(model, params, cfg, prompt_lens, smi: str):
    """The serve of phase 5 twice more, instrumented (not the measured run):
    once with a host clock and a synchronise around every prefill and tick,
    once under ``torch.profiler`` for the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServeEngine(model, params, num_slots=4, max_len=8192, device=DEV)
    spans = {"prefill": [], "tick": []}

    def timed(kind, fn, label):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spans[kind].append((label(*args), time.perf_counter() - t0))
            return out
        return run
    eng._admit = timed("prefill", eng._admit, lambda req, slot: len(req.prompt))
    eng.step = timed("tick", eng.step, lambda: None)
    t0 = time.perf_counter()
    eng.run(make_requests(cfg, prompt_lens))
    wall = time.perf_counter() - t0
    pre = ", ".join(f"{n}: {1e3 * t:.1f}" for n, t in sorted(spans["prefill"]))
    ticks = [t for _, t in spans["tick"]]
    log(f"[profile] {cfg.name}: synchronised serve {wall:.3f} s; prefill ms by "
        f"prompt length {{{pre}}} (sum "
        f"{1e3 * sum(t for _, t in spans['prefill']):.1f}); {len(ticks)} ticks, "
        f"median {1e3 * statistics.median(ticks):.2f} ms, sum "
        f"{1e3 * sum(ticks):.1f} ms  [{smi}]")

    eng = ServeEngine(model, params, num_slots=4, max_len=8192, device=DEV)
    calls = k3.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run(make_requests(cfg, prompt_lens))
        torch.cuda.synchronize()
    calls = k3.launches - calls

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows)
    log(f"[profile] {cfg.name}: device time by kernel under torch.profiler, "
        f"total {busy / 1e3:.1f} ms")
    # the top 14, and the port's kernels below them
    ours = ("flash_", "decode_", "ssd_", "rg_lru")
    for e in rows[:14] + [e for e in rows[14:] if any(k in e.key for k in ours)]:
        if dev_us(e) > 0:
            log(f"[profile]   {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")
    # one CUDA launch per decode_attention call, and no merge kernel
    dec = sum(e.count for e in rows if dev_us(e) > 0 and
              ("decode_mma_kernel" in e.key or "decode_f32_kernel" in e.key))
    merge = [e.key for e in rows if dev_us(e) > 0 and "merge" in e.key]
    if dec != calls or merge:
        raise AssertionError(f"{cfg.name}: {calls} decode_attention calls, "
                             f"{dec} decode kernel launches, merge kernels "
                             f"{merge}")
    log(f"[profile] {cfg.name}: {calls} decode_attention calls = {dec} kernel "
        "launches; no merge kernel")


# tok/s and peak GiB of each phase-5 serve, by (arch, kv_cache_dtype)
SERVED = {}


@torch.no_grad()
def phase_full(arch: str, smi: str, with_profile: bool = False,
               kv_cache_dtype: str = "model", num_layers=None,
               prompt_lens=None):
    """The full-width serve of ``arch`` (``num_layers`` cuts the depth only;
    ``prompt_lens`` default: the arch's ``PROMPT_LENS``)."""
    cfg = get_config(arch).replace(kv_cache_dtype=kv_cache_dtype)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    assert cfg.dtype == "bfloat16" and cfg.attn_impl == "cuda"
    prompt_lens = prompt_lens or PROMPT_LENS[arch]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=DEV)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[full] {arch}: {model.param_count() / 1e9:.3f} G parameters, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, bf16, init "
        f"{time.perf_counter() - t0:.1f} s")
    eng = ServeEngine(model, params, num_slots=4, max_len=8192, device=DEV)

    # warm-up outside the measured run: library handles, allocator pools
    warm = torch.zeros((1, 64), dtype=torch.int64, device=DEV)
    _, wcache = model.prefill(params, {"tokens": warm}, 128)
    model.decode_step(params, wcache, warm[:, :1], 64)
    del wcache
    torch.cuda.synchronize()

    reqs = make_requests(cfg, prompt_lens)

    for mod in KERNELS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in KERNELS.items()}

    for r in reqs:
        if r.finish_s is None or len(r.output) != NEW_TOKENS or \
                not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"full-width {arch} req {r.rid}: output "
                                 f"{r.output}")
    want = expected_launches(cfg, len(reqs), eng.ticks)
    if launches != want:
        raise AssertionError(f"{arch}: kernel launches {launches}, expected "
                             f"{want}")

    # logits of the path are finite (after the counts are read)
    toks = torch.from_numpy(reqs[0].prompt.astype(np.int64))[None].to(DEV)
    logits, cache = model.prefill(params, {"tokens": toks}, 8192)
    step, _ = model.decode_step(params, cache, toks[:, :1], toks.shape[1])
    if logits.shape != (1, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all() & torch.isfinite(step).all()):
        raise AssertionError(f"full-width {arch} logits: wrong shape or not "
                             "finite")

    toks_out = sum(len(r.output) for r in reqs)
    lats = [r.latency_s for r in reqs]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    SERVED[arch, kv_cache_dtype] = (toks_out / wall, peak)
    kv = "" if kv_cache_dtype == "model" else f" ({kv_cache_dtype} KV cache)"
    log(f"[full] {arch}{kv}: {len(reqs)} requests (prompts {prompt_lens}), "
        f"{toks_out} new tokens in {wall:.3f} s = {toks_out / wall:.2f} tok/s, "
        f"{eng.ticks} decode ticks, latency p50 {np.percentile(lats, 50):.3f} s "
        f"p95 {np.percentile(lats, 95):.3f} s, peak memory {peak:.2f} GiB, "
        f"launches {launches}  [{smi}]")
    if with_profile:
        profile_serve(model, params, cfg, prompt_lens, smi)
    return launches


# ------------------------------------------------------------------ phase 6

APPS5 = ("wifi_tx", "wifi_rx", "single_carrier", "range_detection",
         "pulse_doppler")
SCAN_OUT = ("scheduled", "start", "finish", "onpe")
# the full-size run: rates x seeds lanes of jobs each; every CHECK_EVERY-th
# lane also goes through the plain scan
SCAN_RATES, SCAN_SEEDS, SCAN_JOBS, CHECK_EVERY = 32, 32, 1000, 16
# DTPM: the governors (throttle with bench_dtpm.py's 27 C cap and 0.05 s RC
# step, so the cap binds) and the outputs held bit for bit
DTPM_GOVERNORS = {"ondemand": (),
                  "throttle": (("thermal_cap_c", 27.0), ("thermal_dt_s", 0.05))}
DTPM_EXACT = SCAN_OUT + ("onopp", "opp_idx", "job_finish", "makespan_us")
# faults: the full grid's traces (rates x seeds), each under 16 fault sets
FAULT_RATES, FAULT_SEEDS = 8, 8


# K1's four instantiations, (DTPM, FAULTS) -> the name of its `kernels` entry
K1_VARIANTS = k1.VARIANT_NAMES


def counts_zero():
    for mod in KERNELS.values():
        mod.launches = 0
    for key in k1.variant_launches:
        k1.variant_launches[key] = 0
    metrics.counter("thermal_launches").reset()


def counts():
    return {name: mod.launches for name, mod in KERNELS.items()}


def k1_counts():
    """K1's launches by instantiation since the last counts_zero()."""
    return {K1_VARIANTS[key]: n for key, n in k1.variant_launches.items()}


def scan_plain_outputs(tables, policy, arrival, app_idx, gov=None, faults=None):
    """K1's plain version and the shared epilogue on the same lanes; ``gov``
    (one policy or one per lane) runs the DTPM program, ``faults`` ((L, P)
    fail times) the fail-stop one."""
    arrival = torch.as_tensor(arrival, device=DEV)
    app_idx = torch.as_tensor(app_idx, device=DEV, dtype=torch.int32)
    if arrival.ndim == 1:
        arrival, app_idx = arrival[None], app_idx[None]
    if faults is not None:
        faults = torch.as_tensor(faults, device=DEV)
    lanes = None if gov is None else policy_lanes(gov, arrival.shape[0])
    scan = k1.epoch_scan_plain(tables, policy, arrival, app_idx, lanes, faults)
    out = simkernel_torch._epilogue(tables, arrival, app_idx, *scan[:4],
                                    *scan[4:5] if gov is not None else ())
    if gov is not None:
        out.update(zip(("onopp", "opp_idx", "peak_temp_c"), scan[4:7]))
    if faults is not None:
        out.update(steps=scan[-1][:, 0], commits=scan[-1][:, 1])
    return out


def lane_outputs(tables, arrival, app_idx, scan_out: dict, k: int) -> dict:
    """Lane k of a batched plain scan's outputs, its epilogue taken on that
    lane alone (so its sums run in the order of a one-lane call's)."""
    one = {key: v[k:k + 1] for key, v in scan_out.items()}
    arr = torch.as_tensor(arrival[k:k + 1], device=DEV)
    app = torch.as_tensor(app_idx[k:k + 1], device=DEV, dtype=torch.int32)
    one.update(simkernel_torch._epilogue(tables, arr, app, one["scheduled"],
                                         one["start"], one["finish"], one["onpe"],
                                         one.get("onopp")))
    return one


def assert_bits_equal(got: dict, want: dict, keys, what: str):
    torch.cuda.synchronize()
    for key in keys:
        g, w = got[key], want[key]
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            bad = int((g != w).sum()) if g.shape == w.shape else -1
            raise AssertionError(f"{what}: K1 and its plain version differ "
                                 f"in {key} ({bad} entries)")


def no_fma_in_k1():
    """ptxas may contract a*b+c into FFMA; the scan's contractible spots are
    written with __fmul_rn/__fadd_rn and the DTPM kernel's divisions refine
    in f64 (``div_rn``), so no instantiation's SASS holds an FFMA.  Returns
    per instantiation (named as in the `kernels` line) its counts of
    FMUL+FADD, of DFMA and of all instructions."""
    tool = Path(shutil.which(_build.nvcc())).parent / "cuobjdump"
    libs = _build.build_all()
    sass = "".join(subprocess.run([str(tool), "-sass", str(libs[name])],
                                  capture_output=True, text=True, check=True).stdout
                   for name in ("epoch_scan", "epoch_scan_faults"))
    mangled = {f"epoch_scan_kernelILb{int(d)}ELb{int(f)}E": name
               for (d, f), name in K1_VARIANTS.items()}
    found = {}
    for part in sass.split("Function : ")[1:]:
        name, *lines = part.splitlines()
        kind = next((v for m, v in mangled.items() if m in name), None)
        if kind is None:
            continue
        n = sum("FFMA" in ln for ln in lines)
        if n:
            raise AssertionError(f"epoch_scan_kernel ({kind})'s SASS holds {n} FFMA")
        found[kind] = {"fmul_fadd": sum("FMUL" in ln or "FADD" in ln for ln in lines),
                       "dfma": sum("DFMA" in ln for ln in lines),
                       "instructions": sum(ln.strip().startswith("/*") and "*/" in ln
                                           and ";" in ln for ln in lines)}
    if set(found) != set(K1_VARIANTS.values()):
        raise AssertionError(f"epoch_scan's SASS: kernels {sorted(found)}, "
                             f"expected {sorted(K1_VARIANTS.values())}")
    return found


def scan_bound_ms(tables, L, J, dtpm=False, faults=False):
    """Bytes only: the tables and the (L, J) lanes read once, the (L, J, T)
    schedule written once (bool, f32, f32, i32), at the memory rate; under
    DTPM also the OPP tables, the per-lane policies (window, up, cap, the RC
    matrices, two exponents) and the latched OPPs (L, J, T), final OPPs and
    peaks; with faults also the (L, P) plans read once, the (L, J, T) floor
    written once and the (L, 2) counts.  The scan itself is a chain of
    dependent steps, and under DTPM of windows, that no rate bounds.  Over
    the tables of D stacked designs every table counts D times."""
    *lead, A, T, P = tables.exec_us.shape
    D = lead[0] if lead else 1
    table_bytes = 4 * D * (A * T * P + 2 * A * T + A * T * T + A + P * P + 2)
    nbytes = table_bytes + 8 * L * J + 13 * L * J * T
    if dtpm:
        C, K = tables.opp_freq.shape[-2:]
        nbytes += 4 * (D * (A * T * P * (K - 1) + P * K + C * K + 3 * C + 4 * P)
                       + 37 * L + L * J * T + L * C + L)
    if faults:
        nbytes += 4 * (L * P + L * J * T + 2 * L)
    return 1e3 * nbytes / PEAK_BYTES_S


def k1_geometry(info: dict) -> str:
    """K1's launch shape from ``kernel_info``, as the log lines print it."""
    return (f"{info['lanes_per_block']} lanes ({info['threads']} threads) a "
            f"block, {info['lanes_per_sm']} lanes an SM, {info['registers']} "
            f"registers and {info['local_bytes']} local (spill) bytes a thread, "
            f"{info['shared_bytes']} bytes of shared memory a block")


@torch.no_grad()
def phase_k1_geometry(smi: str):
    """K1 against the plain scan, bit for bit on every output, in all four
    instantiations: (a) three designs of 8, 13 and 19 PEs padded to 19 with
    S = 3 lanes each (odd, so neighbouring blocks read different designs) of
    100 jobs (not a multiple of 32); (b) one two-task app at 1,100 jobs, L = 3
    (35 groups of 32 jobs: more than a warp's lanes).  Then each
    instantiation's shape at phase 6's sizes."""
    t0 = time.perf_counter()
    counts_zero()
    programs = {"epoch_scan": (None, False), "epoch_scan_dtpm": ("ondemand", False),
                "epoch_scan_faults": (None, True),
                "epoch_scan_dtpm_faults": ("ondemand", True)}
    tiny = _chain("tiny", ["scrambler_encoder", "crc"])
    checked = 0
    for name, (gov, faulted) in programs.items():
        policy = "met" if gov or faulted else "etf"
        # (a) the stacked designs
        scns = [Scenario(design=p, apps=("wifi_tx", "wifi_rx"), scheduler=policy,
                         governor=gov or "performance") for p in SWEEP_DESIGNS]
        stack = stack_tables([tables_for(s, pad_pes=19) for s in scns])
        traces = [poisson_trace(r, 100, ("wifi_tx", "wifi_rx"), seed=k)
                  for k, r in enumerate((10.0, 40.0, 80.0))]
        arr, app = stack_traces(traces)
        arr, app = arr.repeat(3, 1), app.repeat(3, 1)
        plans = None
        if faulted:
            plans = torch.full((9, 19), float("inf"), device=DEV)
            plans[:, 1], plans[:, 0] = 150.0, 400.0
        cases = [("3 designs x S=3, J=100", stack, arr, app, plans,
                  scns[0].make_policy() if gov else None)]
        # (b) the two-task app
        governor = OndemandGovernor() if gov else None
        tb = simkernel_torch.build_tables(make_soc_table2(), [tiny], governor=governor)
        traces = [poisson_trace(r, 1100, ["tiny"], seed=k)
                  for k, r in enumerate((20.0, 60.0, 100.0))]
        arr, app = stack_traces(traces)
        plans = None
        if faulted:
            plans = torch.full((3, tb.num_pes), float("inf"), device=DEV)
            plans[:, 0], plans[:, 1] = 5000.0, 9000.0
        cases.append(("one design, J=1100", tb, arr, app, plans,
                      governor.policy() if gov else None))
        for what, tb, arr, app, plans, pol in cases:
            lanes = None if pol is None else policy_lanes(pol, arr.shape[0])
            want = k1.epoch_scan_plain(tb, policy, arr, app, lanes, plans)
            got = k1.epoch_scan(tb, policy, arr, app, gov=lanes, faults=plans)
            torch.cuda.synchronize()
            for k, (g, w) in enumerate(zip(got, want)):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(f"K1 geometry {name} {what}: output {k} "
                                         "differs from the plain scan")
            checked += 1
    geometry_counts = k1_counts()
    if geometry_counts != dict.fromkeys(programs, len(cases)):
        raise AssertionError(f"K1 geometry: launches {geometry_counts}, expected "
                             f"{len(cases)} per instantiation")
    log(f"[scenario] K1 geometry: {checked} launches (4 instantiations x 2 cases: "
        f"3 designs of 8/13/19 PEs x S=3 lanes of 100 jobs; a two-task app at "
        f"1,100 jobs x 3 lanes) = the plain scan bit for bit on every output; "
        f"launches by instantiation {geometry_counts} "
        f"({time.perf_counter() - t0:.1f} s)")
    # each instantiation's shape at phase 6's sizes (five apps, T=8, P=15)
    tb = tables_for(Scenario(design=DesignPoint(num_vit=1), apps=APPS5,
                             governor="ondemand"))
    A, T, P = tb.exec_us.shape
    C, K = tb.opp_freq.shape
    for name, (gov, faulted) in programs.items():
        CK = (C, K) if gov else (0, 0)
        info = k1.kernel_info(SCAN_JOBS, A, T, P, DEV, *CK, faults=faulted)
        log(f"[scenario] K1 {name} at J={SCAN_JOBS}: {k1_geometry(info)}  [{smi}]")


# the DTPM cell over seconds of workload: 16 ondemand policies x 64 traces of
# 40,000 jobs at 20 jobs/ms (2 s a lane) on the Table-2 SoC, policy-major
SECONDS_JOBS, SECONDS_TRACES, SECONDS_CHECKED = 40_000, 64, (0, 1023)
SECONDS_POLICIES = [(("sample_window_us", w), ("up_threshold", u))
                    for u in (0.6, 0.7, 0.8, 0.9) for w in (25.0, 50.0, 100.0, 200.0)]


@torch.no_grad()
def phase_k1_seconds(smi: str) -> dict:
    """K1 at the ``dtpm-seconds-sweep`` cell's shape: 1,024 lanes of 40,000
    jobs (DTPM ondemand, etf), one launch, timed by CUDA events (median of
    2 after a warm launch); its geometry (the same shared bytes and lanes an
    SM as at 1,000 jobs, where another instantiation runs), the most jobs a lane held live and the lanes that spilled (a
    launch under the profiler, read in the manifest), peak memory; lanes
    ``SECONDS_CHECKED`` (the 25 us and the 200 us window) through the plain
    scan on the card, bit for bit K1's on every output (``plain_ms``), and
    launched alone, bit for bit the grid's.  Returns the ``kernels``
    entry."""
    t0 = time.perf_counter()
    base = Scenario(design=DesignPoint(num_vit=1), apps=APPS5, governor="ondemand")
    tb = tables_for(base)
    A, T, P = tb.exec_us.shape
    C, K = tb.opp_freq.shape
    pols = [base.replace(governor_params=g).make_policy() for g in SECONDS_POLICIES]
    L = len(pols) * SECONDS_TRACES
    lanes = policy_lanes([pol for pol in pols for _ in range(SECONDS_TRACES)], L)
    traces = [poisson_trace(20.0, SECONDS_JOBS, APPS5, seed=k)
              for k in range(SECONDS_TRACES)]
    arr, app = stack_traces(traces)
    arr, app = arr.repeat(len(pols), 1), app.repeat(len(pols), 1)
    info = k1.kernel_info(SECONDS_JOBS, A, T, P, DEV, C, K)
    short = k1.kernel_info(SCAN_JOBS, A, T, P, DEV, C, K)
    if (info["shared_bytes"], info["lanes_per_sm"]) != (short["shared_bytes"],
                                                        short["lanes_per_sm"]):
        raise AssertionError(f"K1's geometry at {SECONDS_JOBS} jobs {info} differs "
                             f"from that at {SCAN_JOBS} {short}")
    torch.cuda.reset_peak_memory_stats()
    out = k1.epoch_scan(tb, "etf", arr, app, gov=lanes)
    torch.cuda.synchronize()
    times = []
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        k1.epoch_scan(tb, "etf", arr, app, gov=lanes)
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    peak_mem = torch.cuda.max_memory_allocated()
    metrics.run_manifest()                    # nothing left pending
    metrics.counter(metrics.K1_LIVE_PEAK).reset()
    spilled = metrics.counter(metrics.K1_OVERFLOW).value
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        k1.epoch_scan(tb, "etf", arr, app, gov=lanes)
    man = metrics.run_manifest(device=DEV)
    held = man[metrics.K1_LIVE_PEAK]
    spilled = man[metrics.K1_OVERFLOW] - spilled
    tasks = int(tb.valid[app.long()].sum())
    ms = statistics.median(times)
    log(f"[seconds] K1 timed: {ms:.1f} ms a launch ({times}); lanes "
        f"{SECONDS_CHECKED} through the plain scan next  [{smi}]")
    pick = torch.tensor(SECONDS_CHECKED)      # the policies' lanes are on the host
    t1 = time.perf_counter()
    plain = k1.epoch_scan_plain(tb, "etf", arr[pick.to(DEV)], app[pick.to(DEV)],
                                lanes.take(pick))
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t1)
    for n, (g, w) in enumerate(zip(plain, out)):
        if not torch.equal(g, w[pick.to(w.device)]):
            raise AssertionError(f"K1 seconds grid: lanes {SECONDS_CHECKED} "
                                 f"differ from the plain scan in output {n}")
    for l in SECONDS_CHECKED:
        alone = k1.epoch_scan(tb, "etf", arr[l:l + 1], app[l:l + 1],
                              gov=lanes.take(torch.tensor([l])))
        for n, (g, w) in enumerate(zip(alone, out)):
            if not torch.equal(g[0], w[l]):
                raise AssertionError(f"K1 seconds grid: lane {l} alone differs "
                                     f"in output {n}")
    entry = {"shape": f"L={L} lanes ({len(pols)} ondemand policies x "
                      f"{SECONDS_TRACES} traces) x J={SECONDS_JOBS} jobs at 20 "
                      "jobs/ms, DTPM etf, Table-2 SoC (T=8, P=15)",
             "ms": ms, "ms_each": times, "ns_per_task": 1e6 * ms / tasks,
             "tasks": tasks, "bound_ms": scan_bound_ms(tb, L, SECONDS_JOBS, dtpm=True),
             "live_jobs_peak": held, "overflow_lanes": spilled,
             "peak_memory_bytes": peak_mem, "plain_ms": plain_ms,
             "geometry": info}
    log(f"[seconds] K1 at the seconds cell's shape: {entry['shape']}: {ms:.1f} ms "
        f"a launch ({times}), {entry['ns_per_task']:.2f} ns a task over {tasks:,} "
        f"tasks, bound {entry['bound_ms']:.3f} ms; at most {held} jobs live in a "
        f"lane, {spilled} lanes spilled; peak memory {peak_mem:,} bytes; lanes "
        f"{SECONDS_CHECKED} = the plain scan bit for bit (plain {plain_ms:.0f} "
        f"ms), and alone = the grid's; {k1_geometry(info)} "
        f"({time.perf_counter() - t0:.1f} s)  [{smi}]")
    return entry


@torch.no_grad()
def phase_scenario(smi: str):
    """K1 through the DS3 scenario path: small cases against the plain scan
    and the event-heap oracle, then 1,024 lanes of the five-app mix at 1,000
    jobs per scheduler.  Returns (the `kernels` entry, K1 launches)."""
    # -- small: the cases of tests/test_sim_equivalence.py through run()
    small = [(p, r) for p in ("etf", "met", "table") for r in (2.0, 20.0, 60.0)]
    counts_zero()
    runs = []
    for policy, rate in small:
        scn = Scenario(apps=("wifi_tx",), scheduler=policy,
                       trace=TraceSpec(rate_jobs_per_ms=rate, num_jobs=80,
                                       seed=int(rate)))
        runs.append((scn, run(scn, backend="torch")))
    db = make_soc_table2()
    db.comm = CommModel(startup_us=0.0, bw_bytes_per_us=1e30)
    free_trace = deterministic_trace(25.0, 64, ["wifi_tx"])
    free_tables = simkernel_torch.build_tables(db, [wifi_tx()])
    free = simkernel_torch.simulate_torch(free_tables, "etf",
                                          free_trace.arrival_us,
                                          free_trace.app_index)
    torch.cuda.synchronize()
    small_counts = counts()
    want = dict.fromkeys(KERNELS, 0)
    want["epoch_scan"] = len(small) + 1
    if small_counts != want:
        raise AssertionError(f"scenario path (small): launches {small_counts}, "
                             f"expected {want}")
    for (scn, res) in runs:
        trace = scn.job_trace()
        plain = scan_plain_outputs(tables_for(scn), scn.scheduler,
                                   trace.arrival_us, trace.app_index)
        assert_bits_equal({k: v[None] for k, v in res.raw.items()}, plain,
                          res.raw.keys(), scn.label())
        ref = run(scn, backend="ref")
        np.testing.assert_allclose(res.avg_latency_us, ref.avg_latency_us, rtol=1e-4)
        np.testing.assert_allclose(res.makespan_us, ref.makespan_us, rtol=1e-4)
        np.testing.assert_allclose(res.energy_j, ref.energy_j, rtol=1e-3)
    plain = scan_plain_outputs(free_tables, "etf", free_trace.arrival_us,
                               free_trace.app_index)
    assert_bits_equal({k: v[None] for k, v in free.items()}, plain, free.keys(),
                      "comm-free")
    ref = simkernel_ref.simulate(db, [wifi_tx()], free_trace,
                                 get_scheduler("etf"))
    fin, onpe = free["finish"].cpu().numpy(), free["onpe"].cpu().numpy()
    for r in ref.records:
        if fin[r.job_id, r.task_id] != np.float32(r.finish_us) or \
                onpe[r.job_id, r.task_id] != r.pe_id:
            raise AssertionError(f"comm-free: job {r.job_id} task {r.task_id} "
                                 "differs from the event-heap oracle")
    sass = no_fma_in_k1()
    log(f"[scenario] small: wifi_tx x {{etf, met, table}} x rates {{2, 20, 60}} "
        f"(80 jobs) through run(backend='torch') and the comm-free etf case: "
        f"K1 = plain bit for bit (every output), vs backend='ref' within "
        f"1e-4 / 1e-3, comm-free schedule = the event-heap oracle; launches "
        f"{small_counts['epoch_scan']}; SASS: 0 FFMA in all four kernels; "
        + "; ".join(f"{name} {c['fmul_fadd']} FMUL/FADD, {c['dfma']} DFMA, "
                    f"{c['instructions']} instructions" for name, c in sass.items())
        + " (DFMA: the DTPM divisions' f64 refinement)")
    phase_k1_geometry(smi)

    # -- full size: the paper's five-app mix, 1,024 lanes of 1,000 jobs
    rates = np.linspace(1.0, 80.0, SCAN_RATES)
    traces = [poisson_trace(float(r), SCAN_JOBS, APPS5, seed=s)
              for r in rates for s in range(SCAN_SEEDS)]
    arrival = torch.from_numpy(np.stack([t.arrival_us for t in traces])).to(DEV)
    app_idx = torch.from_numpy(np.stack([t.app_index for t in traces])).to(DEV)
    L, J = arrival.shape
    base = Scenario(design=DesignPoint(num_vit=1), apps=APPS5)
    tables = {p: tables_for(base.replace(scheduler=p))
              for p in ("etf", "met", "table")}
    T, P = tables["etf"].t_max, tables["etf"].num_pes
    info = k1.kernel_info(J, len(APPS5), T, P, DEV)
    info_f = k1.kernel_info(J, len(APPS5), T, P, DEV, faults=True)
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    counts_zero()
    outs = {}
    for policy, tb in tables.items():
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        outs[policy] = simkernel_torch.simulate_batch(tb, policy, arrival, app_idx)
        torch.cuda.synchronize()
        outs[policy]["held_bytes"] = torch.cuda.max_memory_allocated() - held
    full_counts = counts()
    want = dict.fromkeys(KERNELS, 0)
    want["epoch_scan"] = 3
    if full_counts != want:
        raise AssertionError(f"scenario path (full): launches {full_counts}, "
                             f"expected {want}")
    checked = torch.arange(0, L, CHECK_EVERY, device=DEV)
    valid_tasks = int(tables["etf"].valid[app_idx.long()].sum())
    entry = {"shape": f"L={L} lanes x J={J} jobs, T={T}, P={P} (five apps, "
                      "DesignPoint(num_vit=1))"}
    for policy, tb in tables.items():
        out = outs[policy]
        if not bool(out["scheduled"].all()) or \
                not bool(torch.isfinite(out["finish"]).all()) or \
                not bool((out["makespan_us"] > 0).all()) or \
                out["finish"].shape != (L, J, T):
            raise AssertionError(f"full {policy}: unscheduled, non-finite or "
                                 "misshapen output")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan = k1.epoch_scan_plain(tb, policy, arrival[checked], app_idx[checked])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = 0.0
        for key, got in zip(SCAN_OUT, scan):
            want_k = out[key][checked]
            if not torch.equal(got, want_k):
                raise AssertionError(f"full {policy}: K1 and its plain version "
                                     f"differ in {key} on the checked lanes")
            if got.dtype == torch.float32:
                err = max(err, float((got - want_k).abs().max()))
        ms = eager_ms(lambda: k1.epoch_scan(tb, policy, arrival, app_idx),
                      iters=5, warm=1)
        t0 = time.perf_counter()
        ref = run(base.replace(scheduler=policy), backend="ref",
                  trace_override=traces[0])
        ref_s = time.perf_counter() - t0
        lat0 = float(out["avg_job_latency_us"][0])
        bound = scan_bound_ms(tb, L, J)
        log(f"[scenario] full {policy}: K1 {ms:.3f} ms a launch (median of 5, "
            f"CUDA events), {valid_tasks / (ms * 1e-3):.4g} scheduled tasks/s "
            f"({valid_tasks} valid tasks), holds "
            f"{out['held_bytes'] / 2 ** 20:.1f} MiB; plain {plain_s:.3f} s for "
            f"its {len(checked)} lanes (= K1 bit for bit on scheduled, start, "
            f"finish, onpe); backend='ref' {ref_s:.3f} s for lane 0 on the "
            f"host (avg latency {ref.avg_latency_us:.3f} us, K1 {lat0:.3f}); "
            f"byte bound {bound:.5f} ms  [{smi}]")
        entry[f"ms_{policy}"] = ms
        entry[f"plain_s_{len(checked)}_lanes_{policy}"] = plain_s
        entry[f"tasks_per_s_{policy}"] = valid_tasks / (ms * 1e-3)
        entry[f"ref_s_one_lane_{policy}"] = ref_s
        entry[f"held_bytes_{policy}"] = out["held_bytes"]
        entry.setdefault("max_abs_err", err)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    for name, inf in (("K1", info), ("K1 faults", info_f)):
        log(f"[scenario] {name}: {k1_geometry(inf)} ({inf['lanes_per_sm'] * sms} "
            f"lanes resident on {sms} SMs) for {L} lanes")
    entry.update(ms=entry["ms_etf"], plain_ms=1e3 * entry[f"plain_s_{len(checked)}_lanes_etf"],
                 plain_note=f"etf, the plain loop over {len(checked)} of the {L} lanes",
                 bound_ms=scan_bound_ms(tables["etf"], L, J), bound_by="bytes",
                 library_ms=None,
                 library_note="no PyTorch call computes the scan")
    entries = {"epoch_scan": entry}
    entries["epoch_scan_dtpm"], dtpm_launches = phase_scenario_dtpm(
        smi, entry, traces, arrival, app_idx)
    launches = {"epoch_scan": small_counts["epoch_scan"] + full_counts["epoch_scan"],
                "epoch_scan_dtpm": dtpm_launches}
    faulted = phase_scenario_faults(smi)
    for name, (ent, n) in faulted.items():
        if name in entries:          # fault-free launches of the fault phase
            launches[name] += n
        else:
            entries[name], launches[name] = ent, n
    return entries, launches


def assert_dtpm_equal(got: dict, want: dict, what: str) -> float:
    """K1's DTPM outputs against the plain scan's: the schedule, latched and
    final OPPs bit for bit, peak temperature and energy within 1e-5
    relative.  Returns the largest absolute difference of the two."""
    assert_bits_equal(got, want, DTPM_EXACT, what)
    err = 0.0
    for key in ("peak_temp_c", "energy_j"):
        err = max(err, compare(got[key], want[key], 1e-5, f"{what}: {key}"))
    return err


@torch.no_grad()
def phase_scenario_dtpm(smi: str, entry: dict, traces, arrival, app_idx):
    """Closed-loop DTPM through K1's DTPM variant: (a) small cases through
    run(), (b) one launch of lanes with different policies, (c) the comm-free
    integer trace against the event-heap oracle, (d) the full grid under
    ondemand and throttle.  Returns the DTPM instantiation's `kernels` entry
    and its launches."""
    t_phase = time.perf_counter()
    dent = {}
    # (a) ondemand and throttle x etf/met/table x 2, 20, 60 jobs/ms, 80 jobs
    small = [(g, p, r) for g in DTPM_GOVERNORS for p in ("etf", "met", "table")
             for r in (2.0, 20.0, 60.0)]
    counts_zero()
    runs = []
    for gov, policy, rate in small:
        scn = Scenario(apps=("wifi_tx",), scheduler=policy, governor=gov,
                       governor_params=DTPM_GOVERNORS[gov],
                       trace=TraceSpec(rate_jobs_per_ms=rate, num_jobs=80,
                                       seed=int(rate)))
        runs.append((scn, run(scn, backend="torch")))
    torch.cuda.synchronize()
    want = dict.fromkeys(KERNELS, 0)
    want["epoch_scan"] = len(small)
    if counts() != want:
        raise AssertionError(f"DTPM (small): launches {counts()}, expected {want}")
    n_launches = len(small)
    err = 0.0
    for scn, res in runs:
        trace = scn.job_trace()
        plain = scan_plain_outputs(tables_for(scn), scn.scheduler,
                                   trace.arrival_us, trace.app_index,
                                   scn.make_policy())
        err = max(err, assert_dtpm_equal({k: v[None] for k, v in res.raw.items()},
                                         plain, scn.label()))
        if scn.trace.rate_jobs_per_ms >= 20.0:   # the host oracle's windows are slow
            ref = run(scn, backend="ref")
            np.testing.assert_allclose(res.avg_latency_us, ref.avg_latency_us, rtol=1e-4)
            np.testing.assert_allclose(res.makespan_us, ref.makespan_us, rtol=1e-4)
            np.testing.assert_allclose(res.energy_j, ref.energy_j, rtol=1e-3)
    log(f"[scenario] DTPM small: {{ondemand, throttle}} x {{etf, met, table}} x "
        f"rates {{2, 20, 60}} (80 jobs) through run(backend='torch'): K1 = "
        f"plain bit for bit on {', '.join(DTPM_EXACT)}, peak and energy within "
        f"1e-5 (max abs err {err:.3e}); at 20 and 60 jobs/ms within 1e-4 / 1e-3 "
        f"of backend='ref'; launches {len(small)}")

    # (b) one launch, a different policy on every lane
    pols = [GovernorPolicy(dynamic=True, up_threshold=u, sample_window_us=w,
                           thermal_dt_s=w * 1e-6)
            for u in (0.6, 0.8, 0.95) for w in (25.0, 50.0, 100.0)]
    base_b = Scenario(apps=("wifi_tx",), governor="ondemand")
    lane_traces = [base_b.replace(trace=TraceSpec(rate_jobs_per_ms=r, num_jobs=80,
                                                  seed=k)).job_trace()
                   for k, r in enumerate((5.0, 20.0, 40.0) * 3)]
    tb = tables_for(base_b)
    counts_zero()
    mixed = simkernel_torch.simulate_batch_dtpm(
        tb, "etf", np.stack([t.arrival_us for t in lane_traces]),
        np.stack([t.app_index for t in lane_traces]), pols)
    torch.cuda.synchronize()
    if counts()["epoch_scan"] != 1:
        raise AssertionError(f"DTPM (policy lanes): launches {counts()}, expected 1")
    n_launches += 1
    plain = scan_plain_outputs(tb, "etf", np.stack([t.arrival_us for t in lane_traces]),
                               np.stack([t.app_index for t in lane_traces]), pols)
    for k in range(len(pols)):
        err = max(err, assert_dtpm_equal({key: v[k:k + 1] for key, v in mixed.items()},
                                         {key: v[k:k + 1] for key, v in plain.items()},
                                         f"policy lane {k}"))
    log(f"[scenario] DTPM policy lanes: one launch of 9 lanes (up_threshold "
        f"0.6/0.8/0.95 x window 25/50/100 us), each lane = the plain scan's "
        f"bit for bit")

    # (c) the comm-free integer trace against the event-heap oracle
    db = make_soc_table2()
    db.comm = CommModel(startup_us=0.0, bw_bytes_per_us=1e30)
    free_trace = deterministic_trace(25.0, 64, ["wifi_tx"])
    counts_zero()
    for policy in ("etf", "met"):
        governor = OndemandGovernor(sample_window_us=50.0)
        free_tables = simkernel_torch.build_tables(db, [wifi_tx()], governor=governor)
        got = simkernel_torch.simulate_torch_dtpm(
            free_tables, policy, free_trace.arrival_us, free_trace.app_index,
            governor.policy())
        ref = simkernel_ref.simulate(db, [wifi_tx()], free_trace,
                                     get_scheduler(policy), governor)
        fin, onpe, onopp = (got[k].cpu().numpy() for k in ("finish", "onpe", "onopp"))
        opp_freq = free_tables.opp_freq.cpu().numpy()
        pe_domain = free_tables.pe_domain.cpu().numpy()
        for r in ref.records:
            f = opp_freq[pe_domain[r.pe_id], onopp[r.job_id, r.task_id]]
            if fin[r.job_id, r.task_id] != np.float32(r.finish_us) or \
                    onpe[r.job_id, r.task_id] != r.pe_id or \
                    (db.pes[r.pe_id].is_cpu and f != np.float32(r.freq_ghz)):
                raise AssertionError(f"DTPM comm-free {policy}: job {r.job_id} "
                                     f"task {r.task_id} differs from the "
                                     "event-heap oracle")
    if counts()["epoch_scan"] != 2:
        raise AssertionError(f"DTPM (comm-free): launches {counts()}, expected 2")
    n_launches += 2
    log("[scenario] DTPM comm-free: deterministic_trace(25, 64, wifi_tx), "
        "window 50 us, etf and met: finish, PE and latched frequency = the "
        "event-heap oracle bit for bit")

    # (d) the full grid under ondemand and throttle
    L, J = arrival.shape
    base = Scenario(design=DesignPoint(num_vit=1), apps=APPS5)
    valid = None
    counts_zero()
    outs = {}
    for gov, params in DTPM_GOVERNORS.items():
        for policy in ("etf", "met", "table"):
            scn = base.replace(scheduler=policy, governor=gov, governor_params=params)
            tb = tables_for(scn)
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            out = simkernel_torch.simulate_batch_dtpm(tb, policy, arrival,
                                                      app_idx, scn.make_policy())
            torch.cuda.synchronize()
            out["held_bytes"] = torch.cuda.max_memory_allocated() - held
            outs[gov, policy] = (scn, tb, out)
    if counts()["epoch_scan"] != 2 * 3 or k1_counts()["epoch_scan_dtpm"] != 6:
        raise AssertionError(f"DTPM (full): launches {k1_counts()}, expected 6")
    n_launches += 6
    # the plain loop runs its longest lane's steps (~6,800 here, ~1 ms each)
    # and one masked window step for each window of each of its lanes (they
    # seldom close together; ~20,000 / rate a lane, ~1 ms each): so two lanes,
    # seed 0 of the middle and of the highest rate, where most jobs are in
    # flight and each PE's commit list is longest
    check_idx = (SCAN_RATES // 2, SCAN_RATES - 1)
    checked = torch.tensor([r * SCAN_SEEDS for r in check_idx], device=DEV)
    check_rates = " and ".join(f"{np.linspace(1.0, 80.0, SCAN_RATES)[r]:.2f}"
                               for r in check_idx)
    for (gov, policy), (scn, tb, out) in outs.items():
        A, T, P = tb.exec_us.shape
        C, K = tb.opp_freq.shape
        if valid is None:
            valid = int(tb.valid[app_idx.long()].sum())
            info = k1.kernel_info(J, A, T, P, DEV, C, K)
        if not bool(out["scheduled"].all()) or \
                not bool(torch.isfinite(out["finish"]).all()) or \
                not bool(torch.isfinite(out["peak_temp_c"]).all()) or \
                not bool((out["peak_temp_c"] >= 25.0).all()) or \
                out["onopp"].shape != (L, J, T):
            raise AssertionError(f"DTPM full {gov} {policy}: unscheduled, "
                                 "non-finite or misshapen output")
        pol = scn.make_policy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = scan_plain_outputs(tb, policy, arrival[checked], app_idx[checked], pol)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = max(err, assert_dtpm_equal({k: v[checked] for k, v in out.items()
                                          if k != "held_bytes"},
                                         plain, f"DTPM full {gov} {policy}"))
        lanes = policy_lanes(pol, L)
        ms = eager_ms(lambda: k1.epoch_scan(tb, policy, arrival, app_idx, gov=lanes),
                      iters=5, warm=1)
        windows = (out["makespan_us"].double() / pol.sample_window_us).floor() + 1
        bound = scan_bound_ms(tb, L, J, dtpm=True)
        log(f"[scenario] DTPM full {gov} {policy}: K1 {ms:.3f} ms a launch "
            f"(median of 5, CUDA events), {valid / (ms * 1e-3):.4g} scheduled "
            f"tasks/s, {float(windows.mean()):.0f} windows a lane on average "
            f"({int(windows.max())} at most, {int(windows.min())} at least), "
            f"peak {float(out['peak_temp_c'].min()):.3f}-"
            f"{float(out['peak_temp_c'].max()):.3f} C, holds "
            f"{out['held_bytes'] / 2 ** 20:.1f} MiB; plain {plain_s:.3f} s for "
            f"lanes {checked.tolist()} (seed 0 at {check_rates} jobs/ms; = K1 "
            f"bit for bit); byte bound {bound:.5f} ms  [{smi}]")
        dent[f"ms_{gov}_{policy}"] = ms
        dent[f"plain_s_{len(checked)}_lanes_{gov}_{policy}"] = plain_s
        dent[f"tasks_per_s_{gov}_{policy}"] = valid / (ms * 1e-3)
        dent[f"windows_mean_{gov}_{policy}"] = float(windows.mean())
        dent[f"bound_ms_{gov}_{policy}"] = bound
    log(f"[scenario] K1 DTPM: {k1_geometry(info)} for {L} lanes; the DTPM part "
        f"took {time.perf_counter() - t_phase:.1f} s")
    dent.update(shape=entry["shape"] + ", ondemand", ms=dent["ms_ondemand_etf"],
                plain_ms=1e3 * dent[f"plain_s_{len(checked)}_lanes_ondemand_etf"],
                plain_note=f"ondemand etf, the plain loop over {len(checked)} of "
                           f"the {L} lanes",
                bound_ms=dent["bound_ms_ondemand_etf"], bound_by="bytes",
                library_ms=None, library_note="no PyTorch call computes the scan",
                max_abs_err=err)
    return dent, n_launches


def small_fault_sets(trace, db) -> dict:
    """The small cases' fault sets, as (pe_id, fail time) at the trace's own
    arrivals (f32): one fault mid-trace, one at t = 0, two faults, two
    simultaneous ones, every accelerator lost mid-trace, and an FFT
    accelerator lost between two arrivals (on the comm-free trace the first
    epoch past that fail time picks a task whose pred the rollback takes: a
    skipped step)."""
    a = trace.arrival_us
    J = len(a)

    def at(k):
        return float(np.float32(a[k]))
    accel = [j for j, pe in enumerate(db.pes) if not pe.is_cpu]
    return {"mid": ((0, at(J // 2)),),
            "t0": ((1, 0.0),),
            "two": ((0, at(J // 3)), (4, at(2 * J // 3))),
            "simultaneous": ((0, at(J // 2)), (2, at(J // 2))),
            "accelerators": tuple((p, at(J // 2)) for p in accel),
            "between": ((10, float(np.float32((a[J // 2] + a[J // 2 + 1]) / 2))),)}


def fault_plans(sets, num_pes) -> np.ndarray:
    """(L, P) f32 fail-time plans of (pe_id, time) sets (inf: never)."""
    plans = np.full((len(sets), num_pes), np.inf, np.float32)
    for k, fs in enumerate(sets):
        for pe, t in fs:
            plans[k, pe] = np.float32(t)
    return plans


def assert_counts(want: dict, what: str):
    got = {name: n for name, n in k1_counts().items() if n}
    if counts() != dict.fromkeys(KERNELS, 0) | {"epoch_scan": sum(want.values())} \
            or got != want:
        raise AssertionError(f"{what}: launches {counts()}, by instantiation "
                             f"{got}, expected {want}")


@torch.no_grad()
def phase_scenario_faults(smi: str) -> dict:
    """Fail-stop faults through K1's faulted instantiations: (a) small cases
    through run() and the comm-free trace against the event-heap oracle,
    (b) the full grid of 16 fault sets x 64 traces per scheduler, (c) DTPM
    with faults, small and on the full grid.  Returns per instantiation it
    launched its `kernels` entry (None for the fault-free one) and its
    launches."""
    t_phase = time.perf_counter()
    out = {}
    # -- (a) wifi_tx x {etf, met} x 2, 20, 60 jobs/ms x the six fault sets
    small = []
    for policy in ("etf", "met"):
        for rate in (2.0, 20.0, 60.0):
            scn = Scenario(apps=("wifi_tx",), scheduler=policy,
                           trace=TraceSpec(rate_jobs_per_ms=rate, num_jobs=80,
                                           seed=int(rate)))
            for name, fs in small_fault_sets(scn.job_trace(), scn.soc()).items():
                small.append((scn.replace(failures=tuple(FaultSpec(*f) for f in fs)),
                              name, fs))
    counts_zero()
    runs = [run(scn, backend="torch") for scn, _, _ in small]
    torch.cuda.synchronize()
    assert_counts({"epoch_scan_faults": len(small)}, "faults (small)")
    recommits = skips = 0
    for policy in ("etf", "met"):
        idx = [k for k, (scn, _, _) in enumerate(small) if scn.scheduler == policy]
        traces = [small[k][0].job_trace() for k in idx]
        arrival = np.stack([t.arrival_us for t in traces])
        app_idx = np.stack([t.app_index for t in traces])
        tb = tables_for(small[idx[0]][0])
        plain = scan_plain_outputs(tb, policy, arrival, app_idx,
                                   faults=fault_plans([small[k][2] for k in idx],
                                                      tb.num_pes))
        for lane, k in enumerate(idx):
            scn, res = small[k][0], runs[k]
            want = lane_outputs(tb, arrival, app_idx, plain, lane)
            assert_bits_equal({key: v[None] for key, v in res.raw.items()}, want,
                              res.raw.keys(), f"faults {scn.label()} {small[k][1]}")
            ref = run(scn, backend="ref")
            np.testing.assert_allclose(res.avg_latency_us, ref.avg_latency_us, rtol=1e-4)
            np.testing.assert_allclose(res.makespan_us, ref.makespan_us, rtol=1e-4)
            np.testing.assert_allclose(res.energy_j, ref.energy_j, rtol=1e-3)
            recommits += int(res.raw["commits"]) - int(res.raw["scheduled"].sum())
            skips += int(res.raw["steps"]) - int(res.raw["commits"])
    # the comm-free integer trace against the event-heap oracle
    db = make_soc_table2()
    db.comm = CommModel(startup_us=0.0, bw_bytes_per_us=1e30)
    free_trace = deterministic_trace(25.0, 48, ["wifi_tx"])
    free_tables = simkernel_torch.build_tables(db, [wifi_tx()])
    free_sets = small_fault_sets(free_trace, db)
    free_skips = 0
    counts_zero()
    for policy in ("etf", "met"):
        for name, fs in free_sets.items():
            got = simkernel_torch.simulate_torch(
                free_tables, policy, free_trace.arrival_us, free_trace.app_index,
                faults=fault_plans([fs], db.num_pes)[0])
            ref = simkernel_ref.simulate(db, [wifi_tx()], free_trace,
                                         get_scheduler(policy),
                                         failures=[FaultSpec(*f) for f in fs])
            fin, start, onpe = (got[k].cpu().numpy() for k in ("finish", "start", "onpe"))
            free_skips += int(got["steps"] - got["commits"])
            if int(got["scheduled"].sum()) != len(ref.records):
                raise AssertionError(f"faults comm-free {policy} {name}: "
                                     f"{len(ref.records)} records in the oracle")
            for r in ref.records:
                if fin[r.job_id, r.task_id] != np.float32(r.finish_us) or \
                        start[r.job_id, r.task_id] != np.float32(r.start_us) or \
                        onpe[r.job_id, r.task_id] != r.pe_id:
                    raise AssertionError(f"faults comm-free {policy} {name}: job "
                                         f"{r.job_id} task {r.task_id} differs "
                                         "from the event-heap oracle")
    assert_counts({"epoch_scan_faults": 2 * len(free_sets)}, "faults (comm-free)")
    if not free_skips:
        raise AssertionError("faults comm-free: no step skipped a stale pick")
    n_faults = len(small) + 2 * len(free_sets)
    log(f"[scenario] faults small: wifi_tx x {{etf, met}} x rates {{2, 20, 60}} "
        f"(80 jobs) x {{{', '.join(free_sets)}}} through "
        f"run(backend='torch') ({len(small)} launches): K1 = plain bit for bit "
        f"(every output), within 1e-4 / 1e-3 of backend='ref'; {recommits} "
        f"re-commits, {skips} skipped steps in all; comm-free "
        f"deterministic_trace(25, 48) x the same sets x {{etf, met}} "
        f"({2 * len(free_sets)} launches, {free_skips} skipped steps): finish, "
        f"start, PE = the event-heap oracle")

    # -- (b) the full grid: 16 fault sets x 8 rates x 8 seeds of 1,000 jobs
    rates = np.linspace(1.0, 80.0, FAULT_RATES)
    traces = [poisson_trace(float(r), SCAN_JOBS, APPS5, seed=s)
              for r in rates for s in range(FAULT_SEEDS)]
    base = Scenario(design=DesignPoint(num_vit=1), apps=APPS5)
    P = base.design.num_pes
    N = len(traces)
    plans = np.full((P + 1, N, P), np.inf, np.float32)      # (set, trace, PE)
    for f, fs in enumerate(pe_loss_faults(range(P), k=1)):
        (spec,) = fs
        for n, t in enumerate(traces):
            plans[f + 1, n, spec.pe_id] = np.float32(t.arrival_us[SCAN_JOBS // 2])
    plans = torch.from_numpy(plans.reshape(-1, P)).to(DEV)
    arrival1 = torch.from_numpy(np.stack([t.arrival_us for t in traces])).to(DEV)
    app1 = torch.from_numpy(np.stack([t.app_index for t in traces])).to(DEV)
    arrival = arrival1.repeat(P + 1, 1)
    app_idx = app1.repeat(P + 1, 1)
    L, J = arrival.shape
    tables = {p: tables_for(base.replace(scheduler=p)) for p in ("etf", "met")}
    T = tables["etf"].t_max
    cap = fault_scan_steps(J, T, 1)
    valid = int(tables["etf"].valid[app_idx.long()].sum())
    fent = {"shape": f"L={L} lanes (16 fault sets: none and each of the {P} "
                     f"PEs lost at the lane's arrival of job {SCAN_JOBS // 2}, x "
                     f"{FAULT_RATES} rates x {FAULT_SEEDS} seeds) x J={J} jobs, "
                     f"T={T}, P={P} (five apps, DesignPoint(num_vit=1))"}
    err = 0.0
    counts_zero()
    outs, free = {}, {}
    for policy, tb in tables.items():
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        outs[policy] = simkernel_torch.simulate_batch(tb, policy, arrival, app_idx,
                                                      faults=plans)
        torch.cuda.synchronize()
        outs[policy]["held_bytes"] = torch.cuda.max_memory_allocated() - held
        free[policy] = simkernel_torch.simulate_batch(tb, policy, arrival1, app1)
    torch.cuda.synchronize()
    assert_counts({"epoch_scan_faults": 2, "epoch_scan": 2}, "faults (full)")
    for policy, tb in tables.items():
        o = outs[policy]
        if not bool(o["scheduled"].all()) or not bool(torch.isfinite(o["finish"]).all()) \
                or o["finish"].shape != (L, J, T):
            raise AssertionError(f"faults full {policy}: unscheduled, non-finite "
                                 "or misshapen output")
        # the fault-free lanes equal the fault-free launch of the same traces
        assert_bits_equal({k: o[k][:N] for k in SCAN_OUT}, free[policy], SCAN_OUT,
                          f"faults full {policy}: the fault-free lanes")
        # two lanes against the plain scan: the highest rate's seed 0, lost PE
        # with the most re-commits, and the same trace fault-free
        n0 = (FAULT_RATES - 1) * FAULT_SEEDS
        lost = o["commits"][n0 + N::N] - o["commits"][n0]
        lane = n0 + N * (1 + int(torch.argmax(lost)))
        checked = torch.tensor([lane, n0], device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = scan_plain_outputs(tb, policy, arrival[checked], app_idx[checked],
                                   faults=plans[checked])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        got = {k: o[k][checked] for k in SCAN_OUT + ("steps", "commits")}
        assert_bits_equal(got, plain, SCAN_OUT + ("steps", "commits"),
                          f"faults full {policy}: lanes {checked.tolist()}")
        ms = eager_ms(lambda: k1.epoch_scan(tb, policy, arrival, app_idx,
                                            faults=plans), iters=5, warm=1)
        commits, steps = int(o["commits"].sum()), int(o["steps"].sum())
        bound = scan_bound_ms(tb, L, J, faults=True)
        log(f"[scenario] faults full {policy}: K1 {ms:.3f} ms a launch (median "
            f"of 5, CUDA events), {valid / (ms * 1e-3):.4g} scheduled tasks/s "
            f"({valid} valid tasks; {commits - valid} re-commits and "
            f"{steps - commits} skipped steps besides, {commits / (ms * 1e-3):.4g} "
            f"commits/s); the most steps of a lane {int(o['steps'].max())} of its "
            f"cap {cap}; holds {o['held_bytes'] / 2 ** 20:.1f} MiB; the 64 "
            f"fault-free lanes = the fault-free launch bit for bit; plain "
            f"{plain_s:.3f} s for lanes {checked.tolist()} (seed 0 at 80 jobs/ms, "
            f"PE {int(torch.argmax(lost))} lost at job {SCAN_JOBS // 2} with "
            f"{int(lost.max())} re-commits, and fault-free; = K1 bit for bit); "
            f"byte bound {bound:.5f} ms  [{smi}]")
        fent[f"ms_{policy}"] = ms
        fent[f"plain_s_2_lanes_{policy}"] = plain_s
        fent[f"tasks_per_s_{policy}"] = valid / (ms * 1e-3)
        fent[f"recommits_{policy}"] = commits - valid
        fent[f"max_steps_{policy}"] = int(o["steps"].max())
        fent[f"held_bytes_{policy}"] = o["held_bytes"]
    fent.update(cap=cap, ms=fent["ms_etf"], plain_ms=1e3 * fent["plain_s_2_lanes_etf"],
                plain_note="etf, the plain loop over 2 of the lanes",
                bound_ms=scan_bound_ms(tables["etf"], L, J, faults=True),
                bound_by="bytes", library_ms=None,
                library_note="no PyTorch call computes the scan", max_abs_err=err)
    out["epoch_scan_faults"] = (fent, n_faults + 2)
    out["epoch_scan"] = (None, 2)

    # -- (c) DTPM with faults: the small cases, then the full grid (ondemand)
    dent = {}
    counts_zero()
    cases = []
    for gov, params in DTPM_GOVERNORS.items():
        for scn, name, fs in small:
            cases.append((scn.replace(governor=gov, governor_params=params), name, fs))
    runs = [run(scn, backend="torch") for scn, _, _ in cases]
    torch.cuda.synchronize()
    assert_counts({"epoch_scan_dtpm_faults": len(cases)}, "DTPM faults (small)")
    for gov in DTPM_GOVERNORS:
        for policy in ("etf", "met"):
            idx = [k for k, (scn, _, _) in enumerate(cases)
                   if scn.scheduler == policy and scn.governor == gov]
            traces_c = [cases[k][0].job_trace() for k in idx]
            arr_c = np.stack([t.arrival_us for t in traces_c])
            app_c = np.stack([t.app_index for t in traces_c])
            scn0 = cases[idx[0]][0]
            tb = tables_for(scn0)
            plain = scan_plain_outputs(tb, policy, arr_c, app_c, scn0.make_policy(),
                                       faults=fault_plans([cases[k][2] for k in idx],
                                                          tb.num_pes))
            for lane, k in enumerate(idx):
                res = runs[k]
                want = lane_outputs(tb, arr_c, app_c, plain, lane)
                err = max(err, assert_dtpm_equal(
                    {key: v[None] for key, v in res.raw.items()}, want,
                    f"DTPM faults {cases[k][0].label()} {cases[k][1]}"))
                assert_bits_equal({key: res.raw[key][None] for key in ("steps", "commits")},
                                  want, ("steps", "commits"),
                                  f"DTPM faults {cases[k][0].label()} {cases[k][1]}")
    log(f"[scenario] DTPM faults small: {{ondemand, throttle}} x the {len(small)} "
        f"static fault cases through run(backend='torch') ({len(cases)} "
        f"launches): K1 = plain bit for bit on {', '.join(DTPM_EXACT)}, steps and "
        f"commits; peak and energy within 1e-5 (max abs err {err:.3e})")
    counts_zero()
    gov = "ondemand"
    dlaunch = {}
    for policy in ("etf", "met"):
        scn = base.replace(scheduler=policy, governor=gov)
        tb = tables_for(scn)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        o = simkernel_torch.simulate_batch_dtpm(tb, policy, arrival, app_idx,
                                                scn.make_policy(), faults=plans)
        torch.cuda.synchronize()
        o["held_bytes"] = torch.cuda.max_memory_allocated() - held
        dlaunch[policy] = (scn, tb, o)
    assert_counts({"epoch_scan_dtpm_faults": 2}, "DTPM faults (full)")
    for policy, (scn, tb, o) in dlaunch.items():
        A, T, P_ = tb.exec_us.shape
        C, K = tb.opp_freq.shape
        if not bool(o["scheduled"].all()) or \
                not bool(torch.isfinite(o["peak_temp_c"]).all()) or \
                not bool((o["peak_temp_c"] >= 25.0).all()):
            raise AssertionError(f"DTPM faults full {policy}: unscheduled or "
                                 "non-finite output")
        n0 = (FAULT_RATES - 1) * FAULT_SEEDS
        lost = o["commits"][n0 + N::N] - o["commits"][n0]
        lane = n0 + N * (1 + int(torch.argmax(lost)))
        checked = torch.tensor([lane, n0], device=DEV)
        pol = scn.make_policy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = scan_plain_outputs(tb, policy, arrival[checked], app_idx[checked],
                                   pol, faults=plans[checked])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = max(err, assert_dtpm_equal({k: v[checked] for k, v in o.items()
                                          if k != "held_bytes"}, plain,
                                         f"DTPM faults full {policy}"))
        assert_bits_equal({k: o[k][checked] for k in ("steps", "commits")}, plain,
                          ("steps", "commits"), f"DTPM faults full {policy}")
        lanes = policy_lanes(pol, L)
        ms = eager_ms(lambda: k1.epoch_scan(tb, policy, arrival, app_idx, gov=lanes,
                                            faults=plans), iters=5, warm=1)
        info = k1.kernel_info(J, A, T, P_, DEV, C, K, faults=True)
        commits, steps = int(o["commits"].sum()), int(o["steps"].sum())
        bound = scan_bound_ms(tb, L, J, dtpm=True, faults=True)
        log(f"[scenario] DTPM faults full {gov} {policy}: K1 {ms:.3f} ms a launch "
            f"(median of 5, CUDA events), {valid / (ms * 1e-3):.4g} scheduled "
            f"tasks/s ({commits - valid} re-commits, {steps - commits} skipped "
            f"steps), the most steps of a lane {int(o['steps'].max())} of {cap}, "
            f"peak {float(o['peak_temp_c'].min()):.3f}-"
            f"{float(o['peak_temp_c'].max()):.3f} C, holds "
            f"{o['held_bytes'] / 2 ** 20:.1f} MiB; plain {plain_s:.3f} s for lanes "
            f"{checked.tolist()} (= K1 bit for bit); byte bound {bound:.5f} ms; "
            f"{k1_geometry(info)}  [{smi}]")
        dent[f"ms_{gov}_{policy}"] = ms
        dent[f"plain_s_2_lanes_{gov}_{policy}"] = plain_s
        dent[f"tasks_per_s_{gov}_{policy}"] = valid / (ms * 1e-3)
        dent[f"recommits_{gov}_{policy}"] = commits - valid
        dent[f"held_bytes_{gov}_{policy}"] = o["held_bytes"]
    dent.update(shape=fent["shape"] + ", ondemand", cap=cap,
                ms=dent["ms_ondemand_etf"],
                plain_ms=1e3 * dent["plain_s_2_lanes_ondemand_etf"],
                plain_note="ondemand etf, the plain loop over 2 of the lanes",
                bound_ms=scan_bound_ms(dlaunch["etf"][1], L, J, dtpm=True, faults=True),
                bound_by="bytes", library_ms=None,
                library_note="no PyTorch call computes the scan", max_abs_err=err)
    out["epoch_scan_dtpm_faults"] = (dent, len(cases) + 2)
    log(f"[scenario] the faults part took {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------------------------------------------ phase 7

# (a) small sweeps of 80 jobs at phase 6's rates, over three designs of 8,
# 13 and 19 PEs (the first without a big core: a lower peak power)
SWEEP_JOBS, SWEEP_RATES = 80, (2.0, 20.0, 60.0)
SWEEP_DESIGNS = (DesignPoint(0, 4, 1, 2, 1), DesignPoint(2, 4, 2, 4, 1),
                 DesignPoint(4, 8, 2, 4, 1))
# 9 ondemand / throttle parameterisations: 3 up thresholds x 3 windows
SWEEP_PARAMS = tuple((("up_threshold", u), ("sample_window_us", w))
                     for u in (0.6, 0.8, 0.95) for w in (25.0, 50.0, 100.0))
# four fault sets: none, one PE mid-trace, two at once, one at t = 0; at the
# two higher rates (at 2 jobs/ms the plain loop's windows cost the most)
SWEEP_FAULTS = ((), (FaultSpec(0, 300.0),),
                (FaultSpec(1, 500.0), FaultSpec(2, 500.0)), (FaultSpec(3, 0.0),))
SWEEP_FAULT_RATES = SWEEP_RATES[1:]
# (b)-(d): the five-app mix, 1,000 Poisson jobs at 20 jobs/ms; (b) every valid
# design of DesignSpace().grid() x 4 seeds, (c) 64 LHS designs x 16 ondemand
# policies (4 up thresholds x 4 windows), (d) 8 fault sets x 16 designs of
# more than 7 PEs x 8 seeds
GRID_JOBS, GRID_RATE, GRID_SEEDS = 1000, 20.0, 4
GRID_DTPM_DESIGNS = 64
GRID_DTPM_PARAMS = tuple((("up_threshold", u), ("sample_window_us", w))
                         for u in (0.6, 0.7, 0.8, 0.9)
                         for w in (25.0, 50.0, 100.0, 200.0))
GRID_FAULT_DESIGNS, GRID_FAULT_SEEDS = 16, 8


def take_designs(tables, idx):
    """The designs ``idx`` of a stack, as a stack of their own."""
    idx = torch.as_tensor(idx, device=tables.device)
    return dataclasses.replace(tables, **{
        name: getattr(tables, name)[idx] for name in simkernel_torch.ARRAY_FIELDS
        if getattr(tables, name) is not None})


def sweep_scans() -> int:
    return sum(sweep_mod.scan_calls.values())


def assert_sweep_is_runs(sr, base, axes: dict, what: str):
    """Every lane of a sweep against run(backend="torch") of its point
    (makespan and the epilogue's sums, latency, energy and per-PE busy
    time, bit for bit; throughput and utilization within 1e-6 relative, peak
    within 1e-5) and against the same sweep on backend="ref" (phase 6's 1e-4
    on latency and makespan, 1e-3 on energy)."""
    names = list(axes)
    for idx in np.ndindex(*sr.shape):
        scn = sweep_mod._apply_axes(base, names, [axes[n][i] for n, i in zip(names, idx)])
        res = run(scn, backend="torch")
        if sr.makespan_us[idx] != res.makespan_us:
            raise AssertionError(f"{what} {idx}: makespan {sr.makespan_us[idx]} "
                                 f"vs run {res.makespan_us}")
        P = res.utilization.shape[0]
        for name, got, want in (
                ("avg_latency_us", sr.avg_latency_us[idx], res.avg_latency_us),
                ("energy_j", sr.energy_j[idx], res.energy_j),
                ("busy_per_pe_us", sr.busy_per_pe_us[idx][:P],
                 res.raw["busy_per_pe_us"].cpu().numpy()[:P])):
            if not np.array_equal(got, want):
                raise AssertionError(f"{what} {idx}: {name} {got} vs run {want}")
        for name, got, want, tol in (
                ("throughput", sr.throughput_jobs_per_ms[idx],
                 res.throughput_jobs_per_ms, 1e-6),
                ("peak_temp_c", sr.peak_temp_c[idx], res.peak_temp_c, 1e-5)):
            if abs(got - want) > tol * abs(want):
                raise AssertionError(f"{what} {idx}: {name} {got} vs run {want}")
        np.testing.assert_allclose(sr.utilization[idx][:P], res.utilization,
                                   rtol=1e-6, atol=1e-12, err_msg=f"{what} {idx}")
        if np.any(sr.busy_per_pe_us[idx][P:] != 0):
            raise AssertionError(f"{what} {idx}: a padded PE is busy")
    ref = sweep(base, axes, backend="ref")
    np.testing.assert_allclose(sr.avg_latency_us, ref.avg_latency_us, rtol=1e-4,
                               err_msg=f"{what} vs ref")
    np.testing.assert_allclose(sr.makespan_us, ref.makespan_us, rtol=1e-4,
                               err_msg=f"{what} vs ref")
    np.testing.assert_allclose(sr.energy_j, ref.energy_j, rtol=1e-3,
                               err_msg=f"{what} vs ref")


def grid_vs_plain(tables, policy, arrival, app_idx, gov=None, fplans=None,
                  what=""):
    """One K1 launch of a grid's design-major lanes (a comparison launch,
    after the main path's counts were read) and K1's plain version on the
    same stacked tables and lanes: every output bit for bit."""
    la, lp, pols, plans, _ = dse_batch.grid_lanes(tables, arrival, app_idx, gov,
                                                  fplans)
    got = k1.epoch_scan(tables, policy, la, lp, pols, plans)
    want = k1.epoch_scan_plain(tables, policy, la, lp, pols, plans)
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what}: K1 and its plain version differ in "
                                 f"output {k} on the stacked tables")
    return la.shape[0]


def lanes_vs_plain(tables, scan, policy, arrival, app_idx, picks, lanes_per_design,
                   gov=None, plans=None, what=""):
    """Lanes of one K1 launch against ONE plain call over just those lanes:
    ``picks`` (design, lane within its design) pairs; the plain scan runs on
    a stack of the picked designs, one lane each (so its cost is the plain
    loop's steps, not its lanes).  Returns the plain call's seconds."""
    lanes = [d * lanes_per_design + k for d, k in picks]
    sub = take_designs(tables, [d for d, _ in picks])
    pols = None if gov is None else gov.take(torch.tensor(lanes))
    fp = None if plans is None else plans[lanes]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = k1.epoch_scan_plain(sub, policy, arrival[lanes], app_idx[lanes], pols, fp)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for k, (g, w) in enumerate(zip(scan, want)):
        if not torch.equal(g[lanes], w):
            raise AssertionError(f"{what}: K1 and its plain version differ in "
                                 f"output {k} on lanes {lanes}")
    return plain_s


@torch.no_grad()
def phase_sweep(smi: str) -> dict:
    """``repro_torch.scenario.sweep`` on the card: (a) small sweeps of every
    axis kind against run(), backend="ref" and the plain scan, (b) the full
    static design grid, (c) a dynamic design x policy grid, (d) a fault x
    design grid, each one K1 launch per scheduler.  Returns K1's launches by
    instantiation name and K6's (``thermal_grid``: one a static scan), the
    measured numbers for the `kernels` line, and the outputs of grids
    (b)-(d) with their sweeps' arguments (phase 16 holds the sharded sweeps
    to them)."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(list(K1_VARIANTS.values()) + ["thermal_grid"], 0)
    measured, kept = {}, {}

    def main_path(base, axes, want: dict, what: str):
        """The sweep as a user calls it, with the launch counts set to 0 just
        before and read just after."""
        counts_zero()
        n0 = sweep_scans()
        sr = sweep(base, axes)
        torch.cuda.synchronize()
        assert_counts(want, what)
        if sweep_scans() - n0 != sum(want.values()):
            raise AssertionError(f"{what}: {sweep_scans() - n0} scans started, "
                                 f"{sum(want.values())} launches")
        # K6 once a static scan; DTPM lanes take their peak from K1
        thermal = sum(n for name, n in want.items() if "dtpm" not in name)
        if metrics.counter("thermal_launches").value != thermal:
            raise AssertionError(f"{what}: K6 launched "
                                 f"{metrics.counter('thermal_launches').value} "
                                 f"times, expected {thermal}")
        for name, n in want.items():
            launches[name] += n
        launches["thermal_grid"] += thermal
        return sr

    # -- (a) small sweeps: every lane = run(), = ref within phase 6's
    # tolerances; K1 = the plain scan on the stacked tables
    mix = Scenario(apps=("wifi_tx", "wifi_rx"),
                   trace=TraceSpec(rate_jobs_per_ms=20.0, num_jobs=SWEEP_JOBS, seed=1))
    one = Scenario(apps=("wifi_tx",),
                   trace=TraceSpec(rate_jobs_per_ms=20.0, num_jobs=SWEEP_JOBS, seed=2))
    designs = [(p,) for p in SWEEP_DESIGNS]
    rate_arr, rate_app = stack_traces([mix.at_rate(r).job_trace() for r in SWEEP_RATES], DEV)
    small_lanes, plain_lanes = 0, 0
    # design x rate
    axes = {"design": SWEEP_DESIGNS, "rate": SWEEP_RATES}
    sr = main_path(mix, axes, {"epoch_scan": 1}, "sweep design x rate")
    assert_sweep_is_runs(sr, mix, axes, "sweep design x rate")
    tables = sweep_mod._design_lanes(mix, ["design"], designs, None, DEV)
    if tuple(tables.exec_us.shape[:1]) + (tables.num_pes,) != (3, 19):
        raise AssertionError(f"sweep design x rate: stacked tables "
                             f"{tuple(tables.exec_us.shape)}, expected D = 3, P = 19")
    plain_lanes += grid_vs_plain(tables, "etf", rate_arr, rate_app,
                                 what="sweep design x rate")
    small_lanes += sr.num_points
    # scheduler x rate
    axes = {"scheduler": ("etf", "met", "table"), "rate": SWEEP_RATES}
    sr = main_path(one, axes, {"epoch_scan": 3}, "sweep scheduler x rate")
    assert_sweep_is_runs(sr, one, axes, "sweep scheduler x rate")
    arr1, app1 = stack_traces([one.at_rate(r).job_trace() for r in SWEEP_RATES], DEV)
    for policy in axes["scheduler"]:
        tb = sweep_mod._design_lanes(one.replace(scheduler=policy), [], [()], None, DEV)
        plain_lanes += grid_vs_plain(tb, policy, arr1, app1,
                                     what=f"sweep scheduler x rate ({policy})")
    small_lanes += sr.num_points
    # governor_params x design, ondemand and throttle
    for gov, extra in DTPM_GOVERNORS.items():
        params = tuple(extra + p for p in SWEEP_PARAMS)
        base = mix.replace(governor=gov)
        axes = {"governor_params": params, "design": SWEEP_DESIGNS}
        sr = main_path(base, axes, {"epoch_scan_dtpm": 1}, f"sweep {gov} params x design")
        assert_sweep_is_runs(sr, base, axes, f"sweep {gov} params x design")
        tables = sweep_mod._design_lanes(base.replace(governor_params=params[0]),
                                         ["design"], designs, None, DEV)
        pols = stack_policies([base.replace(governor_params=q).make_policy()
                               for q in params])
        arr0, app0 = stack_traces([mix.job_trace()], DEV)
        plain_lanes += grid_vs_plain(tables, "etf", arr0, app0, gov=pols,
                                     what=f"sweep {gov} params x design")
        small_lanes += sr.num_points
    # faults x design x rate x {etf, met}, static and ondemand
    fault_sets = [normalize_failures(fs) for fs in SWEEP_FAULTS]
    fault_arr, fault_app = stack_traces([mix.at_rate(r).job_trace()
                                         for r in SWEEP_FAULT_RATES], DEV)
    for gov in ("performance", "ondemand"):
        base = mix.replace(governor=gov)
        axes = {"faults": SWEEP_FAULTS, "design": SWEEP_DESIGNS,
                "rate": SWEEP_FAULT_RATES, "scheduler": ("etf", "met")}
        name = "epoch_scan_dtpm_faults" if gov == "ondemand" else "epoch_scan_faults"
        sr = main_path(base, axes, {name: 2}, f"sweep {gov} faults x design x rate")
        assert_sweep_is_runs(sr, base, axes, f"sweep {gov} faults x design x rate")
        tables = sweep_mod._design_lanes(base, ["design"], designs, None, DEV)
        plans, _ = stack_fault_plans(fault_sets, 8, width=tables.num_pes)
        pols = stack_policies([base.make_policy()]) if gov == "ondemand" else None
        for policy in ("etf", "met"):
            plain_lanes += grid_vs_plain(tables, policy, fault_arr, fault_app, gov=pols,
                                         fplans=torch.from_numpy(plans),
                                         what=f"sweep {gov} faults ({policy})")
        small_lanes += sr.num_points
    log(f"[sweep] (a) small: {small_lanes} points in 8 sweeps (design x rate; "
        f"etf/met/table x rate; 9 ondemand and 9 throttle parameterisations x "
        f"3 designs of 8, 13, 19 PEs padded to 19; 4 fault sets x 3 designs x 2 "
        f"rates x etf/met, static and ondemand): every lane = run(backend='torch') "
        f"(makespan, latency, energy and busy time bit for bit, throughput 1e-6, "
        f"peak 1e-5) and = backend='ref' within "
        f"1e-4 / 1e-3; K1 = the plain scan bit for bit on the stacked tables "
        f"({plain_lanes} lanes); launches {dict(launches)}")

    # -- (b)-(d): the full grids, timed from inside the sweep
    apps_base = Scenario(apps=APPS5, governor="design",
                         trace=TraceSpec(rate_jobs_per_ms=GRID_RATE,
                                         num_jobs=GRID_JOBS, seed=0))
    space = DesignSpace()

    def timed_sweep(base, axes, want, what):
        """The sweep as a user calls it, with its parts timed from inside:
        the host table builds (``_design_lanes``, cold: the table cache
        emptied first), each K1 launch (CUDA events; its tables, lanes and
        outputs kept for the checks), the grid program (K1 + epilogue) and
        the thermal grid, each with a synchronise after it."""
        rec = {"tables_s": 0.0, "grid_s": 0.0, "thermal_s": 0.0, "launches": []}
        orig = {"design_lanes": sweep_mod._design_lanes, "scan": k1.epoch_scan,
                "grid": shardexec.simulate_grid,
                "thermal": shardexec.peak_temperature_grid}

        def timed(key, fn):
            def call(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                rec[key] += time.perf_counter() - t0
                return out
            return call

        def scan(tables, policy, arrival, app_idx, gov=None, faults=None):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = orig["scan"](tables, policy, arrival, app_idx, gov, faults)
            ev[1].record()
            rec["launches"].append(dict(tables=tables, policy=policy, events=ev,
                                        lanes=(arrival, app_idx, gov, faults), scan=out))
            return out

        importlib.import_module("repro_torch.scenario.run")._cached_tables.cache_clear()
        sweep_mod._design_lanes = timed("tables_s", orig["design_lanes"])
        shardexec.simulate_grid = timed("grid_s", orig["grid"])
        shardexec.peak_temperature_grid = timed("thermal_s", orig["thermal"])
        k1.epoch_scan = scan
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            sr = main_path(base, axes, want, what)
            wall = time.perf_counter() - t0
            held = torch.cuda.max_memory_allocated() - held
        finally:
            sweep_mod._design_lanes = orig["design_lanes"]
            shardexec.simulate_grid = orig["grid"]
            shardexec.peak_temperature_grid = orig["thermal"]
            k1.epoch_scan = orig["scan"]
        for launch in rec["launches"]:
            launch["in_sweep_ms"] = launch["events"][0].elapsed_time(launch["events"][1])
        return sr, wall, held, rec

    def check_and_time(rec, picks, lanes_per_design, sr_makespan, what):
        """Per K1 launch of the sweep: four of its lanes against ONE plain
        call over just those lanes (``picks``: (design, lane within it)), the
        sweep's makespans of those lanes against the checked schedules, and
        K1 timed again on the same inputs (CUDA events, median of 5; these
        launches are not the main path's)."""
        parts = []
        for i, launch in enumerate(rec["launches"]):
            tables, policy, scan = launch["tables"], launch["policy"], launch["scan"]
            arrival, app_idx, gov, faults = launch["lanes"]
            plain_s = lanes_vs_plain(tables, scan, policy, arrival, app_idx, picks,
                                     lanes_per_design, gov=gov, plans=faults,
                                     what=f"{what} {policy}")
            for d, k in picks:
                lane = d * lanes_per_design + k
                want_mk = float(scan[2][lane].amax())
                if sr_makespan(i, d, k) != want_mk:
                    raise AssertionError(f"{what} {policy}: the sweep's makespan of "
                                         f"lane {lane} is not its schedule's")
            ms = eager_ms(lambda: k1.epoch_scan(tables, policy, arrival, app_idx,
                                                gov, faults), iters=5, warm=0)
            parts.append(dict(policy=policy, k1_ms=ms, in_sweep_ms=launch["in_sweep_ms"],
                              plain_s=plain_s))
        return parts

    def report(tag, what, sr, wall, held, rec, parts, L, J, bound):
        k1_s = sum(p["in_sweep_ms"] for p in parts) / 1e3
        epi_s = rec["grid_s"] - k1_s + rec["thermal_s"]
        rest = wall - rec["tables_s"] - rec["grid_s"] - rec["thermal_s"]
        log(f"[sweep] {what}: {sr.num_points} points in {wall:.3f} s end to end "
            f"({sr.num_points / wall:.1f} design points/s), device memory held "
            f"{held / 2 ** 20:.1f} MiB; in the sweep: host tables {rec['tables_s']:.3f} s, "
            f"K1 {k1_s:.3f} s ({len(parts)} launches), epilogue + thermal "
            f"{epi_s:.3f} s (thermal {rec['thermal_s']:.3f}), the rest (traces, "
            f"assembly) {rest:.3f} s; "
            + "; ".join(f"{p['policy']}: K1 {p['k1_ms']:.3f} ms a launch of {L} lanes "
                        f"(median of 5, CUDA events; {p['in_sweep_ms']:.3f} in the "
                        f"sweep), 4 lanes = plain bit for bit ({p['plain_s']:.3f} s)"
                        for p in parts)
            + f"; byte bound {bound:.5f} ms  [{smi}]")
        measured[tag] = dict(points=sr.num_points, wall_s=wall,
                             points_per_s=sr.num_points / wall, held_bytes=held,
                             tables_s=rec["tables_s"], k1_in_sweep_s=k1_s,
                             epilogue_thermal_s=epi_s, thermal_s=rec["thermal_s"],
                             lanes=L, jobs=J, bound_ms=bound,
                             **{f"{k}_{p['policy']}": p[k] for p in parts
                                for k in ("k1_ms", "in_sweep_ms", "plain_s")})

    # (b) every valid design x 4 seeds, static, etf and met
    points = space.grid()
    seeds = list(range(GRID_SEEDS))
    axes = {"scheduler": ("etf", "met"), "design": points, "seed": seeds}
    sr, wall, held, rec = timed_sweep(apps_base, axes, {"epoch_scan": 2},
                                      "sweep (b) static grid")
    D, S = len(points), len(seeds)
    tables = rec["launches"][0]["tables"]
    if tables.exec_us.shape[0] != D or tables.num_pes != max(p.num_pes for p in points):
        raise AssertionError(f"sweep (b): the stack is not {D} designs padded to the "
                             "widest")
    parts = check_and_time(rec, [(0, 0), (D // 3, 1), (2 * D // 3, 2), (D - 1, 3)], S,
                           lambda i, d, k: sr.makespan_us[i, d, k], "sweep (b)")
    report("static_grid", f"(b) static grid, {D} designs (P <= 19) x {S} seeds x "
           f"{GRID_JOBS} jobs, D = {D}, makespan {sr.makespan_us.min() / 1e3:.1f}-"
           f"{sr.makespan_us.max() / 1e3:.1f} ms", sr, wall, held, rec, parts, D * S,
           GRID_JOBS, scan_bound_ms(tables, D * S, GRID_JOBS))
    kept["static_grid"] = dict(base=apps_base, axes=axes, out=sweep_fields(sr))
    del rec, tables, sr
    torch.cuda.empty_cache()

    # (c) 64 LHS designs x 16 ondemand policies x 1 seed, etf and met
    points = space.sample_lhs(GRID_DTPM_DESIGNS, seed=0)
    base = apps_base.replace(governor="ondemand")
    axes = {"scheduler": ("etf", "met"), "design": points,
            "governor_params": GRID_DTPM_PARAMS}
    sr, wall, held, rec = timed_sweep(base, axes, {"epoch_scan_dtpm": 2},
                                      "sweep (c) ondemand design x policy grid")
    D, G = len(points), len(GRID_DTPM_PARAMS)
    tables = rec["launches"][0]["tables"]
    # four designs under the policy of the longest window (200 us: the fewest
    # window steps for the plain loop)
    g = G - 1
    parts = check_and_time(rec, [(0, g), (D // 3, g), (2 * D // 3, g), (D - 1, g)], G,
                           lambda i, d, k: sr.makespan_us[i, d, k], "sweep (c)")
    # windows a lane: the makespan over the lane's window, as the scan runs them
    window = np.array([dict(q)["sample_window_us"] for q in GRID_DTPM_PARAMS])
    windows = np.floor(sr.makespan_us / window) + 1
    pes = [p.num_pes for p in points]
    report("dtpm_grid", f"(c) ondemand grid, {D} LHS designs (P {min(pes)}-{max(pes)}) "
           f"x {G} policies x {GRID_JOBS} jobs, D = {D}, windows a lane "
           f"{windows.mean():.0f} on average, {int(windows.max())} at most, "
           f"makespan {sr.makespan_us.min() / 1e3:.1f}-{sr.makespan_us.max() / 1e3:.1f} ms",
           sr, wall, held, rec, parts, D * G, GRID_JOBS,
           scan_bound_ms(tables, D * G, GRID_JOBS, dtpm=True))
    kept["dtpm_grid"] = dict(base=base, axes=axes, out=sweep_fields(sr),
                             pad_pes=int(tables.num_pes))
    del rec, tables, sr
    torch.cuda.empty_cache()

    # (d) 8 fault sets (none; PE 0-6 lost at 500 us) x 16 designs of more than
    # 7 PEs x 8 seeds, etf
    wide = [p for p in space.grid() if p.num_pes > 7]
    points = wide[::len(wide) // GRID_FAULT_DESIGNS][:GRID_FAULT_DESIGNS]
    fsets = ((),) + tuple((FaultSpec(pe, 500.0),) for pe in range(7))
    seeds = list(range(GRID_FAULT_SEEDS))
    axes = {"faults": fsets, "design": points, "seed": seeds}
    sr, wall, held, rec = timed_sweep(apps_base, axes, {"epoch_scan_faults": 1},
                                      "sweep (d) fault x design grid")
    D, nf, S = len(points), len(fsets), len(seeds)
    launch = rec["launches"][0]
    tables, (la, lp, _, _), scan = launch["tables"], launch["lanes"], launch["scan"]
    # four designs, each with a PE lost (sets 1, 3, 5, 7), seeds 0-3
    parts = check_and_time(rec, [(0, 1 * S + 0), (D // 3, 3 * S + 1),
                                 (2 * D // 3, 5 * S + 2), (D - 1, 7 * S + 3)], nf * S,
                           lambda i, d, k: sr.makespan_us[k // S, d, k % S], "sweep (d)")
    recommits = int(scan[4][:, 1].sum() - tables.valid[
        k1.lane_designs(tables, la.shape[0], DEV)[:, None], lp.long()].sum())
    report("fault_grid", f"(d) fault grid, {nf} fault sets x {D} designs (P "
           f"{min(p.num_pes for p in points)}-{max(p.num_pes for p in points)}) x "
           f"{S} seeds x {GRID_JOBS} jobs, D = {D}, {recommits} re-commits",
           sr, wall, held, rec, parts, D * nf * S, GRID_JOBS,
           scan_bound_ms(tables, D * nf * S, GRID_JOBS, faults=True))
    kept["fault_grid"] = dict(base=apps_base, axes=axes, out=sweep_fields(sr))
    del rec, tables, scan, launch, sr
    torch.cuda.empty_cache()
    log(f"[sweep] phase 7 took {time.perf_counter() - t_phase:.1f} s; K1 launches "
        f"by instantiation and K6's (thermal_grid) {launches}")
    return launches, measured, kept


def sweep_fields(sr) -> dict:
    """A sweep's outputs on the host: the schedule, energy and peak
    temperature arrays, copied."""
    return {name: np.array(getattr(sr, name))
            for name in SWEEP_SCHEDULE + ("energy_j", "peak_temp_c")}


# ------------------------------------------------------------------ phase 8

# (a)-(c) grid (b) of phase 7: every valid design of DesignSpace().grid() x
# GRID_SEEDS seeds of the five-app mix, etf; (b) the refinement loop at 64
# designs a round; (c) two chunk widths of grid (b): 135 divides its 1,080
# designs (8 chunks, no pad), 256 does not (5 chunks, 200 pad designs)
DSE_ROUNDS, DSE_BATCH = 4, 64
DSE_CHUNKS = {135: (8, 0), 256: (5, 200)}
# (d) DTPM chunks: grid (c) of phase 7 (64 designs x 16 policies, etf) at 16
# designs a chunk (streams designs: 4 chunks), and 4 of its designs x the 16
# policies at 5 policies a chunk (streams policies: 4 chunks, 4 pad policies)
DSE_DTPM_CHUNK, DSE_POLICY_DESIGNS, DSE_POLICY_CHUNK = 16, 4, 5
# schedule outputs of a sweep, held bit for bit between chunked and unchunked
SWEEP_SCHEDULE = ("avg_latency_us", "makespan_us", "throughput_jobs_per_ms",
                  "busy_per_pe_us")


def timed_dse(fn):
    """``fn()`` (an entry point as a user calls it) under ``torch.profiler``
    (CPU and CUDA), its parts read from the program's own spans
    (``repro_torch.obs.metrics``), which are live only while the profiler
    records: the host time of the table builds, K1's wrapper, the epilogue,
    the thermal grid and the wait on the card (the registry's timers of the
    spans), and K1's device time (``epoch_scan_kernel`` in the profiler's
    ``key_averages()``).  Nothing is patched and nothing synchronised inside
    ``fn``.  Returns its result and the times in seconds."""
    from torch.profiler import ProfilerActivity, profile
    names = {"tables_s": metrics.TABLES, "k1_host_s": metrics.K1,
             "epilogue_s": metrics.EPILOGUE, "thermal_s": metrics.THERMAL,
             "wait_s": metrics.WAIT}
    before = {k: metrics.timer(n).total_s for k, n in names.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec = {"wall_s": time.perf_counter() - t0}
    rec.update({k: metrics.timer(n).total_s - before[k] for k, n in names.items()})
    rec["k1_s"] = sum(getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
                      for e in prof.key_averages()
                      if "epoch_scan_kernel" in e.key) / 1e6
    rec["rest_s"] = rec["wall_s"] - sum(rec[k] for k in names)
    return out, rec


def parts(rec) -> str:
    return (f"{rec['wall_s']:.3f} s: host tables {rec['tables_s']:.3f}, K1 "
            f"{rec['k1_s']:.3f} (its wrapper {rec['k1_host_s']:.3f} on the host), "
            f"epilogue {rec['epilogue_s']:.3f}, thermal {rec['thermal_s']:.3f}, "
            f"the wait on the card {rec['wait_s']:.3f}, the rest (traces, copies, "
            f"assembly, search) {rec['rest_s']:.3f}; host times of the "
            f"program's spans, K1's on the card, under torch.profiler")


def held_bytes(fn):
    """``fn()`` and the device memory it held at its peak, above what was
    allocated before it (``max_memory_allocated``, reset first)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def sums_note(pairs, what: str) -> str:
    """Energy and peak temperature of two runs of one grid: bit for bit where
    they are, else within test_torch_sweep.py's 1e-6 / 1e-5 relative (the
    return says which, and how many lanes moved)."""
    notes = []
    for name, got, want, tol in pairs:
        if np.array_equal(got, want):
            notes.append(f"{name} bit for bit")
            continue
        np.testing.assert_allclose(got, want, rtol=tol, atol=0, err_msg=what)
        moved = got != want
        notes.append(f"{name} within {tol:g} ({np.count_nonzero(moved)} of "
                     f"{got.size} differ, at most "
                     f"{np.max(np.abs(got - want)[moved] / np.abs(want[moved])):.2e} "
                     "relative)")
    return ", ".join(notes)


def assert_chunked_equal(got, want, what: str) -> str:
    """A chunked sweep against the unchunked one: the schedule outputs and
    energy bit for bit, peak temperature as ``sums_note`` says."""
    for name in SWEEP_SCHEDULE + ("energy_j",):
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"{what}: {name} differs from the unchunked sweep")
    return "schedule and energy bit for bit, " + sums_note(
        [("peak_temp_c", got.peak_temp_c, want.peak_temp_c, 1e-5)], what)


@torch.no_grad()
def phase_dse(smi: str) -> dict:
    """The DSE mode on the card: (a) ``evaluate`` on every valid design of
    ``DesignSpace().grid()``, (b) ``pareto_search`` twice, (c)-(e)
    ``sweep(chunk=)`` static, DTPM in both streaming directions and with
    faults against the unchunked sweep, (f) ``python -m
    repro_torch.dse.reports`` in-process.  Returns K1's launches by
    instantiation."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(K1_VARIANTS.values(), 0)
    chunks, pads = (metrics.counter("scenario.sweep.chunks"),
                    metrics.counter("scenario.shard.pad_lanes"))

    def main_path(fn, what, want=None):
        """An entry point as a user calls it, K1's counts set to 0 just before
        and read just after: launches by instantiation (``want``, where the
        call fixes them) and equal to the scans the sweeps started."""
        counts_zero()
        n0 = sweep_scans()
        out = fn()
        torch.cuda.synchronize()
        got = {name: n for name, n in k1_counts().items() if n}
        if want is not None:
            assert_counts(want, what)
        if not got or sweep_scans() - n0 != sum(got.values()):
            raise AssertionError(f"{what}: {sweep_scans() - n0} scans started, "
                                 f"launches {got}")
        for name, n in got.items():
            launches[name] += n
        return out, got

    base = Scenario(apps=APPS5, governor="design", scheduler="etf",
                    trace=TraceSpec(rate_jobs_per_ms=GRID_RATE, num_jobs=GRID_JOBS,
                                    seed=0))
    space = DesignSpace()
    points = space.grid()
    seeds = list(range(GRID_SEEDS))
    D, S = len(points), len(seeds)
    apps, traces = base.applications(), [base.with_seed(s).job_trace() for s in seeds]
    grid_axes = {"design": points, "seed": seeds}

    # the unchunked sweep of grid (b), etf: the reference of (a) and (c)
    (plain, plain_rec), plain_held = held_bytes(lambda: main_path(
        lambda: timed_dse(lambda: sweep(base, grid_axes)), "dse unchunked grid (b)",
        {"epoch_scan": 1})[0])

    # -- (a) evaluate on the whole grid
    (ev, rec), _ = main_path(lambda: timed_dse(lambda: evaluate(
        points, apps, traces, policy="etf")), "dse (a) evaluate", {"epoch_scan": 1})
    if not np.array_equal(ev.latency_per_trace_us, plain.avg_latency_us):
        raise AssertionError("dse (a): evaluate's latencies differ from the sweep's")
    same = "latency bit for bit, " + sums_note(
        [("energy_j", ev.energy_per_trace_j, plain.energy_j, 1e-6),
         ("peak_temp_c", ev.temp_per_trace_c, plain.peak_temp_c, 1e-5)],
        "dse (a) evaluate vs sweep")
    front = ev.front_mask()
    if not np.array_equal(front, pareto_mask(ev.objectives())):
        raise AssertionError("dse (a): front_mask() is not pareto_mask(objectives())")
    if not np.all(np.isfinite(ev.objectives())) or not front.any():
        raise AssertionError("dse (a): objectives not finite, or an empty front")
    log(f"[dse] (a) evaluate: {D} designs x {S} seeds x {GRID_JOBS} jobs (the "
        f"five-app mix at {GRID_RATE:g} jobs/ms, etf), front {int(front.sum())} of "
        f"{D}, {D / rec['wall_s']:.1f} design points/s ({D * S / rec['wall_s']:.1f} "
        f"simulations/s), K1 launches 1; in {parts(rec)}; = the sweep of the same grid "
        f"({same}; the sweep {parts(plain_rec)})  [{smi}]")

    # -- (b) the refinement loop, twice
    runs = []
    for k in range(2):
        (sr, rec), got = main_path(lambda: timed_dse(lambda: pareto_search(
            space, apps, traces, policy="etf", rounds=DSE_ROUNDS,
            batch_size=DSE_BATCH, seed=0)), f"dse (b) pareto_search run {k}")
        if got != {"epoch_scan": len(sr.rounds)}:
            raise AssertionError(f"dse (b): launches {got} for {len(sr.rounds)} rounds")
        runs.append(sr)
        log(f"[dse] (b) pareto_search run {k}: "
            + "; ".join(f"round {r['round']}: evaluated {r['evaluated']}, archive "
                        f"{r['archive']}, front {r['front']}, {r['wall_s']:.3f} s"
                        for r in sr.rounds)
            + f"; in {parts(rec)}")
    a, b = runs
    if a.archive.points != b.archive.points or not np.array_equal(
            a.archive.objectives(), b.archive.objectives()) \
            or not np.array_equal(a.front, b.front):
        raise AssertionError("dse (b): two runs of pareto_search differ")
    log(f"[dse] (b) the two archives are identical: {a.archive.num_designs} designs, "
        f"front {int(a.front.sum())}, K1 launches {2 * len(a.rounds)}")

    # -- (c) chunk= on grid (b), static
    for width, (n_chunks, n_pad) in DSE_CHUNKS.items():
        c0, p0 = chunks.value, pads.value
        ((sr, rec), _), held = held_bytes(lambda: main_path(
            lambda: timed_dse(lambda: sweep(base, grid_axes, chunk=width)),
            f"dse (c) chunk={width}", {"epoch_scan": n_chunks}))
        if (chunks.value - c0, pads.value - p0) != (n_chunks, n_pad):
            raise AssertionError(f"dse (c) chunk={width}: {chunks.value - c0} chunks, "
                                 f"{pads.value - p0} pad designs")
        same = assert_chunked_equal(sr, plain, f"dse (c) chunk={width}")
        if n_pad == 0 and not held < plain_held:
            raise AssertionError(f"dse (c): chunk={width} held {held} bytes, "
                                 f"unchunked {plain_held}")
        log(f"[dse] (c) grid (b) at chunk={width}: {n_chunks} chunks, {n_pad} pad "
            f"designs, {same}; device memory held {held / 2 ** 20:.1f} MiB "
            f"(unchunked {plain_held / 2 ** 20:.1f}); in {parts(rec)}  [{smi}]")

    # -- (d) chunk= under DTPM, streaming designs, then policies
    dtpm = base.replace(governor="ondemand")
    dpoints = space.sample_lhs(GRID_DTPM_DESIGNS, seed=0)
    cases = (("designs", dpoints, DSE_DTPM_CHUNK),
             ("policies", dpoints[:DSE_POLICY_DESIGNS], DSE_POLICY_CHUNK))
    for streams, pts, width in cases:
        axes = {"design": pts, "governor_params": GRID_DTPM_PARAMS}
        lanes = max(len(pts), len(GRID_DTPM_PARAMS))
        n_chunks = -(-lanes // width)
        want, _ = main_path(lambda: sweep(dtpm, axes), f"dse (d) {streams} unchunked",
                            {"epoch_scan_dtpm": 1})
        c0, p0 = chunks.value, pads.value
        (sr, rec), _ = main_path(lambda: timed_dse(lambda: sweep(dtpm, axes, chunk=width)),
                                 f"dse (d) {streams} chunk={width}",
                                 {"epoch_scan_dtpm": n_chunks})
        if (chunks.value - c0, pads.value - p0) != (n_chunks, n_chunks * width - lanes):
            raise AssertionError(f"dse (d) {streams}: {chunks.value - c0} chunks, "
                                 f"{pads.value - p0} pad lanes")
        log(f"[dse] (d) ondemand, {len(pts)} designs x {len(GRID_DTPM_PARAMS)} "
            f"policies at chunk={width} (streams {streams}): {n_chunks} chunks, "
            f"{n_chunks * width - lanes} pad, "
            f"{assert_chunked_equal(sr, want, f'dse (d) {streams}')}; in {parts(rec)}")

    # -- (e) grid (d) of phase 7 (faults) at chunk=1, as bench_faults.py runs it
    wide = [p for p in points if p.num_pes > 7]
    fpoints = wide[::len(wide) // GRID_FAULT_DESIGNS][:GRID_FAULT_DESIGNS]
    fsets = ((),) + tuple((FaultSpec(pe, 500.0),) for pe in range(7))
    axes = {"faults": fsets, "design": fpoints, "seed": list(range(GRID_FAULT_SEEDS))}
    want, _ = main_path(lambda: sweep(base, axes), "dse (e) faults unchunked",
                        {"epoch_scan_faults": 1})
    c0 = chunks.value
    (sr, rec), _ = main_path(lambda: timed_dse(lambda: sweep(base, axes, chunk=1)),
                             "dse (e) faults chunk=1",
                             {"epoch_scan_faults": len(fpoints)})
    if chunks.value - c0 != len(fpoints):
        raise AssertionError(f"dse (e): {chunks.value - c0} chunks")
    log(f"[dse] (e) {len(fsets)} fault sets x {len(fpoints)} designs x "
        f"{GRID_FAULT_SEEDS} seeds at chunk=1: {len(fpoints)} chunks, "
        f"{assert_chunked_equal(sr, want, 'dse (e)')}; in {parts(rec)}")

    # -- (f) python -m repro_torch.dse.reports, in-process
    for argv in (["--designs", "64", "--traces", "4"],
                 ["--designs", "64", "--traces", "4", "--rounds", "3"]):
        log(f"[dse] (f) python -m repro_torch.dse.reports {' '.join(argv)}:")
        res, got = main_path(lambda: dse_reports.main(argv), f"dse (f) {argv}")
        if not res.front_mask().any():
            raise AssertionError(f"dse (f) {argv}: an empty front")
    log(f"[dse] phase 8 took {time.perf_counter() - t_phase:.1f} s; K1 launches by "
        f"instantiation {launches}")
    return launches


# ------------------------------------------------------------------ phase 9

# phase 6's configuration: the five-app mix on DesignPoint(num_vit=1), 1,000
# Poisson jobs at 20 jobs/ms
OBS_JOBS, OBS_RATE = 1000, 20.0
OBS_GOVERNORS = {"performance": (), "ondemand": (),
                 "throttle": DTPM_GOVERNORS["throttle"]}
OBS_FAULTS = (FaultSpec(3, 500.0),)
# the sweeps: 16 LHS designs x 4 ondemand policies x 2 seeds, 64 designs x 2
# seeds static; each chunked at 5; OBS_CHECKED lanes of each against run()
OBS_DTPM_DESIGNS, OBS_STATIC_DESIGNS, OBS_SEEDS, OBS_CHUNK = 16, 64, 2, 5
OBS_PARAMS = tuple((("up_threshold", u), ("sample_window_us", 50.0))
                   for u in (0.6, 0.7, 0.8, 0.9))
OBS_CHECKED = 4


def host_replay(scn, out):
    """The telemetry ``run`` replays for ``scn`` (``replay_telemetry``, the
    same code), on the host over the one-lane scan outputs ``out`` copied
    there (the CPU's tables), and its wall seconds."""
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    tel = run_mod.replay_telemetry(scn, tables_for(scn, device=cpu),
                                   {k: v.cpu() for k, v in out.items()},
                                   scn.job_trace().app_index)
    return tel, time.perf_counter() - t0


def replayed(fn):
    """``fn()`` and what the telemetry replays inside it did: seconds (to
    their last copy to the host), window steps, lane-windows (the
    ``obs.telemetry`` timer and counters)."""
    t0, s0, l0 = (obs_tel.replay_timer.total_s, obs_tel.window_steps.value,
                  obs_tel.lane_windows.value)
    out = fn()
    return out, (obs_tel.replay_timer.total_s - t0,
                 obs_tel.window_steps.value - s0, obs_tel.lane_windows.value - l0)


def assert_telemetry_equal(got, want, what: str):
    if not got.equals(want):
        raise AssertionError(f"{what}: telemetry differs")


def assert_sweeps_equal(got, want, what: str):
    """Two sweeps of one grid, every output and every lane's telemetry bit
    for bit."""
    for name in SWEEP_SCHEDULE + ("energy_j", "peak_temp_c"):
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"{what}: {name} differs")
    for a, b in zip(got.telemetry.flat, want.telemetry.flat):
        assert_telemetry_equal(a, b, what)


def check_manifest(man: dict, backend: str, what: str):
    want = ("gpu", torch.cuda.get_device_name(DEV), torch.cuda.device_count())
    if (man["device_platform"], man["device_kind"], man["device_count"]) != want \
            or man["backend"] != backend or man["cuda_version"] != torch.version.cuda:
        raise AssertionError(f"{what}: manifest {man} does not name the card")


@torch.no_grad()
def phase_obs(smi: str) -> dict:
    """``repro_torch.obs`` on the card: (a) ``run(telemetry=True)`` under
    every governor kind and scheduler and with faults: K1 launched as often
    as without telemetry, its outputs the same bits, the replayed peak K1's,
    the card's replay equal to the same replay on the host, the manifest
    naming the card; (b) ``sweep(telemetry=True)`` under ondemand and
    static, chunked too; (c) the comm-free trace against the event-heap
    recorder; (d) ``python -m repro_torch.obs.report --trace``.  Returns
    K1's launches by instantiation."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(K1_VARIANTS.values(), 0)

    def main_path(fn, what, want):
        """An entry point as a user calls it, K1's counts set to 0 just
        before and read just after; ``want`` by instantiation."""
        counts_zero()
        out = fn()
        torch.cuda.synchronize()
        assert_counts(want, what)
        for name, n in want.items():
            launches[name] += n
        return out

    base = Scenario(design=DesignPoint(num_vit=1), apps=APPS5,
                    trace=TraceSpec(rate_jobs_per_ms=OBS_RATE, num_jobs=OBS_JOBS,
                                    seed=0))
    # -- (a) run(telemetry=True), one lane of phase 6's configuration
    cases = [(g, p, ()) for g in OBS_GOVERNORS for p in ("etf", "met", "table")]
    cases.append(("performance", "etf", OBS_FAULTS))
    for gov, policy, failures in cases:
        scn = base.replace(governor=gov, governor_params=OBS_GOVERNORS[gov],
                           scheduler=policy, failures=failures)
        dynamic = scn.make_policy().dynamic
        variant = K1_VARIANTS[dynamic, bool(failures)]
        what = f"{gov} {policy}" + (" faults" if failures else "")
        plain_res = main_path(lambda: run(scn), f"obs (a) {what} telemetry off",
                              {variant: 1})
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res, (card_s, W, _) = replayed(lambda: main_path(
            lambda: run(scn, telemetry=True), f"obs (a) {what}", {variant: 1}))
        run_s = time.perf_counter() - t0
        held = torch.cuda.max_memory_allocated() - held
        for key, v in plain_res.raw.items():
            if not torch.equal(v, res.raw[key]):
                raise AssertionError(f"obs (a) {what}: telemetry=True changed {key}")
        if (plain_res.avg_latency_us, plain_res.energy_j, plain_res.peak_temp_c) \
                != (res.avg_latency_us, res.energy_j, res.peak_temp_c):
            raise AssertionError(f"obs (a) {what}: telemetry=True changed the metrics")
        tel = res.telemetry
        window = scn.make_policy().sample_window_us if dynamic \
            else obs_tel.static_window(scn.make_governor())
        if tel.num_windows != W or W != obs_tel.num_windows_for(res.makespan_us, window) \
                or W == 0 or not np.all(np.isfinite(tel.temps_c)):
            raise AssertionError(f"obs (a) {what}: {tel.num_windows} windows")
        if dynamic and tel.peak_temp_c != res.peak_temp_c:
            raise AssertionError(f"obs (a) {what}: replayed peak {tel.peak_temp_c!r}, "
                                 f"K1's {res.peak_temp_c!r}")
        check_manifest(res.manifest, "torch", f"obs (a) {what}")
        host, host_s = host_replay(scn, res.raw)
        assert_telemetry_equal(host, tel, f"obs (a) {what} (card vs host replay)")
        moves = int(np.count_nonzero(np.diff(tel.freq_idx, axis=0)))
        log(f"[obs] (a) run(telemetry=True) {what}: {W} windows of {window:g} us, "
            f"K1 launches 1 ({variant}) with and without; replay on the card "
            f"{card_s:.3f} s ({W / card_s:,.0f} windows/s) of the run's {run_s:.3f} s, "
            f"which held {held / 2 ** 20:.1f} MiB; the same replay on the host "
            f"{host_s:.3f} s, equal bit for bit; "
            + (f"peak {tel.peak_temp_c:.4f} C = K1's bit for bit, {moves} OPP "
               f"moves" if dynamic else f"replayed peak {tel.peak_temp_c:.4f} C "
               f"(binned RC {res.peak_temp_c:.4f} C)")
            + f"; manifest {res.manifest['device_kind']}  [{smi}]")

    # -- (b) sweep(telemetry=True), unchunked and at chunk=5, lanes vs run
    space = DesignSpace()
    seeds = list(range(OBS_SEEDS))
    dtpm = base.replace(governor="ondemand")
    static = base.replace(governor="design")
    grids = (("ondemand", dtpm, {"design": space.sample_lhs(OBS_DTPM_DESIGNS, seed=0),
                                 "governor_params": OBS_PARAMS, "seed": seeds},
              "epoch_scan_dtpm"),
             ("static", static, {"design": space.sample_lhs(OBS_STATIC_DESIGNS, seed=1),
                                 "seed": seeds}, "epoch_scan"))
    for name, scn, axes, variant in grids:
        shape = tuple(len(v) for v in axes.values())
        lanes = int(np.prod(shape))
        n_chunks = -(-(max(shape[:-1])) // OBS_CHUNK)
        t0 = time.perf_counter()
        off = main_path(lambda: sweep(scn, axes), f"obs (b) {name}", {variant: 1})
        off_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sr, (rep_s, steps, lane_w) = replayed(lambda: main_path(
            lambda: sweep(scn, axes, telemetry=True), f"obs (b) {name}", {variant: 1}))
        on_s = time.perf_counter() - t0
        for field in SWEEP_SCHEDULE + ("energy_j", "peak_temp_c"):
            if not np.array_equal(getattr(off, field), getattr(sr, field)):
                raise AssertionError(f"obs (b) {name}: telemetry=True changed {field}")
        chunked_off = main_path(lambda: sweep(scn, axes, chunk=OBS_CHUNK),
                                f"obs (b) {name} chunk={OBS_CHUNK} telemetry off",
                                {variant: n_chunks})
        chunked, (chunk_s, _, _) = replayed(lambda: main_path(
            lambda: sweep(scn, axes, telemetry=True, chunk=OBS_CHUNK),
            f"obs (b) {name} chunk={OBS_CHUNK}", {variant: n_chunks}))
        for field in SWEEP_SCHEDULE + ("energy_j", "peak_temp_c"):
            if not np.array_equal(getattr(chunked_off, field), getattr(chunked, field)):
                raise AssertionError(f"obs (b) {name} chunk: telemetry=True changed "
                                     f"{field}")
        for a, b in zip(sr.telemetry.flat, chunked.telemetry.flat):
            assert_telemetry_equal(b, a, f"obs (b) {name} chunk={OBS_CHUNK}")
        # the chunked sweep's outputs against the unchunked one's: a max and
        # the epilogue's sums (a fixed order a lane) bit for bit; peak
        # temperature as sums_note says
        for field in ("makespan_us", "throughput_jobs_per_ms", "avg_latency_us",
                      "busy_per_pe_us", "energy_j"):
            if not np.array_equal(getattr(chunked, field), getattr(sr, field)):
                raise AssertionError(f"obs (b) {name} chunk: {field} differs")
        sums = "latency, busy time and energy bit for bit, " + sums_note(
            [("peak_temp_c", chunked.peak_temp_c, sr.peak_temp_c, 1e-5)],
            f"obs (b) {name} chunk")
        checked = [np.unravel_index(i, shape)
                   for i in np.linspace(0, lanes - 1, OBS_CHECKED).astype(int)]
        names = list(axes)
        for idx in checked:
            lane = sweep_mod._apply_axes(scn, names, [axes[n][i] for n, i in
                                                      zip(names, idx)])
            single = main_path(lambda: run(lane, telemetry=True),
                               f"obs (b) {name} {idx}", {variant: 1})
            assert_telemetry_equal(sr.telemetry[idx], single.telemetry,
                                   f"obs (b) {name} lane {idx} vs run")
            if variant == "epoch_scan_dtpm" and \
                    sr.telemetry[idx].peak_temp_c != sr.peak_temp_c[idx]:
                raise AssertionError(f"obs (b) {name} lane {idx}: peak")
        log(f"[obs] (b) sweep(telemetry=True) {name}, {' x '.join(map(str, shape))} "
            f"= {lanes} lanes ({OBS_JOBS:,} jobs, {OBS_RATE:g} jobs/ms): {on_s:.3f} s "
            f"against {off_s:.3f} s without; its replay {rep_s:.3f} s over {steps:,} "
            f"windows (the longest lane's; {steps / rep_s:,.0f} window steps/s), "
            f"{lane_w:,} lane-windows ({lane_w / rep_s:,.0f}/s); chunk={OBS_CHUNK}: "
            f"{n_chunks} launches, replays {chunk_s:.3f} s, telemetry bit for bit, "
            f"outputs = chunk={OBS_CHUNK} without telemetry bit for bit, against the "
            f"unchunked sweep makespan bit for bit, {sums}; lanes "
            f"{[tuple(int(i) for i in x) for x in checked]} = their "
            f"run(telemetry=True) bit for bit  [{smi}]")

    # -- (c) the comm-free trace: the card's replay vs the event-heap recorder
    db = make_soc_table2()
    db.comm = CommModel(startup_us=0.0, bw_bytes_per_us=1e30)
    gov = OndemandGovernor(sample_window_us=50.0)
    trace = deterministic_trace(25.0, 64, ["wifi_tx"])
    tables = simkernel_torch.build_tables(db, [wifi_tx()], governor=gov)
    out = main_path(lambda: simkernel_torch.simulate_torch_dtpm(
        tables, "etf", trace.arrival_us, trace.app_index, gov.policy()),
        "obs (c)", {"epoch_scan_dtpm": 1})
    got = obs_tel.torch_dtpm_telemetry(
        tables, gov.policy(), {k: v[None] for k, v in out.items()},
        trace.app_index[None])[0]
    rec = obs_tel.TelemetryRecorder(gov.sample_window_us)
    simkernel_ref.simulate(db, [wifi_tx()], trace, get_scheduler("etf"),
                           OndemandGovernor(sample_window_us=50.0), telemetry=rec)
    want = rec.build(obs_tel.domain_count(db))
    if got.num_windows != want.num_windows or \
            not np.array_equal(got.freq_idx, want.freq_idx):
        raise AssertionError("obs (c): windows or OPPs differ from the recorder")
    err = 0.0
    for field in ("util", "power_w", "temps_c"):
        g, w = getattr(got, field), getattr(want, field)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=f"obs (c) {field}")
        err = max(err, float(np.max(np.abs(g - w))))
    log(f"[obs] (c) comm-free ondemand trace (wifi_tx, 64 jobs, window 50 us): the "
        f"card's replay = the event-heap recorder on {got.num_windows} windows "
        f"(freq_idx bit for bit, util/power/temps within 1e-4, max abs diff "
        f"{err:.2e})")

    # -- (d) python -m repro_torch.obs.report --trace, in-process (host tool)
    out_dir = ROOT / "build" / "obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    trace_p, tel_p = out_dir / "TRACE.json", out_dir / "TELEMETRY.json"
    if obs_report.main(["--governor", "ondemand", "--trace", str(trace_p),
                        "--telemetry", str(tel_p)]) != 0 \
            or obs_report.main(["--validate", str(trace_p)]) != 0 \
            or obs_trace.validate_chrome_trace(json.loads(trace_p.read_text())):
        raise AssertionError("obs (d): the report's trace does not validate")
    log(f"[obs] (d) python -m repro_torch.obs.report --trace: valid, "
        f"{trace_p.stat().st_size:,} bytes")
    log(f"[obs] phase 9 took {time.perf_counter() - t_phase:.1f} s; K1 launches by "
        f"instantiation {launches}  [{smi}]")
    return launches


# ------------------------------------------------------------------ phase 10

# (a) the reduced models in f32: 40 tokens (seamless: 24 frames), prefill of
# 34, then 6 decode steps
ENCDEC_REDUCED = (40, 34, 24)
# (b) full width, bf16, a batch of 4: paligemma-3b 256 patch embeddings + a
# 64-token prompt, seamless-m4t-large-v2 1,024 frames + a 32-token prompt;
# 16 decode steps
ENCDEC_BATCH, ENCDEC_STEPS, ENCDEC_FRAMES = 4, 16, 1024
ENCDEC_PROMPT = {"paligemma-3b": 64, "seamless-m4t-large-v2": 32}
# the bf16 tolerance of phase 4 (absolute plus relative) on the logits of
# the kernel path against the einsum path
ENCDEC_TOL = 2e-2
# (d) 1,100 positions: 3 query chunks of 512 at the global layers, 2 of
# 1,024 at the windowed ones
BLOCKED_S = 1100


def encdec_batch(cfg, gen, batch: int, n_tokens: int, n_frames: int, rng):
    """Tokens, and the front end's precomputed embeddings (f32, on the card)."""
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, n_tokens))).to(DEV)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = randn(gen, (batch, cfg.num_prefix_tokens,
                                          cfg.d_model), torch.float32)
    elif cfg.frontend == "audio":
        out["frames"] = randn(gen, (batch, n_frames, cfg.d_model), torch.float32)
    return out


def prefix_of(cfg) -> int:
    """Positions a vision prefix takes before the text (decode offsets)."""
    return cfg.num_prefix_tokens if cfg.frontend == "vision" else 0


def greedy_serve(model, params, batch, max_len: int, steps: int, off: int):
    """``Model.prefill`` then ``steps`` greedy ``decode_step`` calls, a
    synchronise after each: tokens (B, 1 + steps), the logits rows they came
    from (B, 1 + steps, V), prefill seconds and the seconds of each tick."""
    P = batch["tokens"].shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_len)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    toks, rows, ticks = [tok], [logits[:, -1]], []
    for i in range(steps):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tok, off + P + i)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t0)
        toks.append(tok)
        rows.append(logits[:, -1])
    return torch.cat(toks, 1), torch.stack(rows, 1), pre_s, ticks


def teacher_forced_rows(model, params, batch, toks, max_len: int, off: int):
    """The logits rows of prefill and of decode steps fed ``toks``."""
    P = batch["tokens"].shape[1]
    logits, cache = model.prefill(params, batch, max_len)
    rows = [logits[:, -1]]
    for i in range(toks.shape[1] - 1):
        logits, cache = model.decode_step(params, cache, toks[:, i:i + 1],
                                          off + P + i)
        rows.append(logits[:, -1])
    return torch.stack(rows, 1)


@torch.no_grad()
def phase_encdec_reduced(arch: str):
    """(a) The reduced model in f32 on the card, embedding scaled by 0.1:
    prefill + decode on the kernel path against the einsum path at every
    step and against ``forward_logits`` (phase 4's 1e-3), K2 and K3 launched
    once a causal layer a call, the echo share under half."""
    S, n_pre, n_frames = ENCDEC_REDUCED
    cfg = reduced(get_config(arch))
    assert cfg.attn_impl == "cuda" and cfg.dtype == "float32"
    model = build_model(cfg, device=DEV)
    ein = build_model(cfg.replace(attn_impl="einsum"), device=DEV)
    params = model.init_params(torch.Generator(device=DEV).manual_seed(0))
    params["embed"]["tok"].mul_(0.1)
    batch = encdec_batch(cfg, torch.Generator(device=DEV).manual_seed(1), 2, S,
                         n_frames, np.random.default_rng(0))
    off, V, B = prefix_of(cfg), cfg.vocab_size, 2
    tokens = batch["tokens"]
    pre = dict(batch, tokens=tokens[:, :n_pre])
    steps = {}
    for name, m in (("cuda", model), ("einsum", ein)):
        before = (k2.launches, k3.launches)
        full = m.forward_logits(params, batch)[..., :V]
        logits, cache = m.prefill(params, pre, off + S + 8)
        rows = [logits[:, 0]]
        for i in range(n_pre, S):
            logits, cache = m.decode_step(params, cache, tokens[:, i:i + 1],
                                          torch.full((B,), i + off, device=DEV))
            rows.append(logits[:, 0])
        steps[name] = (full, torch.stack(rows, 1)[..., :V])
        got = (k2.launches - before[0], k3.launches - before[1])
        n = expected_launches(cfg, 2, S - n_pre)
        want = (n["flash_attention"], n["decode_attention"]) \
            if name == "cuda" else (0, 0)
        if got != want:
            raise AssertionError(f"reduced {arch} {name}: K2/K3 launches {got}, "
                                 f"expected {want}")
    (full, rows), (full_e, rows_e) = steps["cuda"], steps["einsum"]
    e_fwd = compare(full, full_e, 1e-3, f"reduced {arch} forward cuda vs einsum")
    e_step = compare(rows, rows_e, 1e-3, f"reduced {arch} prefill+decode cuda "
                                         "vs einsum at every step")
    e_tf = compare(rows, full[:, n_pre - 1:], 1e-3,
                   f"reduced {arch} prefill+decode vs forward_logits")
    share = float((full.argmax(-1) == tokens).float().mean())
    if not share < 0.5:
        raise AssertionError(f"reduced {arch}: greedy token echoes the input at "
                             f"{share:.0%} of positions")
    log(f"[encdec] (a) reduced {arch} f32: prefill {n_pre} + {S - n_pre} decode "
        f"steps (positions offset by {off}); logits cuda vs einsum: forward "
        f"{e_fwd:.3e}, every step {e_step:.3e}; prefill+decode vs forward_logits "
        f"{e_tf:.3e}; echo share {share:.3f}")


@torch.no_grad()
def phase_encdec_full(arch: str, smi: str):
    """(b) Full width, bf16, kernel path, a batch of 4 through ``Model.prefill``
    and ``decode_step``: launches exact (K2 once a decoder layer at prefill, K3
    once a decoder layer a tick, none from the encoder), tokens valid, logits
    finite; then the einsum path teacher-forced on the same tokens and an f32
    einsum prefill.  Returns the launches and the logits' distances."""
    cfg = get_config(arch)
    assert cfg.dtype == "bfloat16" and cfg.attn_impl == "cuda"
    B, P, off = ENCDEC_BATCH, ENCDEC_PROMPT[arch], prefix_of(cfg)
    max_len = off + P + ENCDEC_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=DEV)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = encdec_batch(cfg, torch.Generator(device=DEV).manual_seed(1), B, P,
                         ENCDEC_FRAMES, np.random.default_rng(0))
    greedy_serve(model, params, batch, max_len, 2, off)    # warm-up

    for mod in KERNELS.values():
        mod.launches = 0
    toks, rows, pre_s, ticks = greedy_serve(model, params, batch, max_len,
                                            ENCDEC_STEPS, off)
    launches = {name: mod.launches for name, mod in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = expected_launches(cfg, 1, ENCDEC_STEPS)
    if launches != n:
        raise AssertionError(f"{arch}: kernel launches {launches}, expected {n}")
    V = cfg.vocab_size
    if toks.shape != (B, 1 + ENCDEC_STEPS) or \
            not bool(((toks >= 0) & (toks < V)).all()) or \
            not bool(torch.isfinite(rows[..., :V]).all()):
        raise AssertionError(f"full-width {arch}: tokens out of range or logits "
                             "not finite")
    wall = pre_s + sum(ticks)
    log(f"[encdec] (b) {arch}: {model.param_count() / 1e9:.3f} G parameters, "
        f"bf16, init {init_s:.1f} s; batch {B}, "
        + (f"{cfg.num_prefix_tokens} patch embeddings + " if off else
           f"{ENCDEC_FRAMES} frames + ")
        + f"{P}-token prompt: prefill {1e3 * pre_s:.2f} ms, {ENCDEC_STEPS} ticks "
        f"median {1e3 * statistics.median(ticks):.3f} ms, {toks.numel()} tokens "
        f"in {wall:.3f} s = {toks.numel() / wall:.2f} tok/s, peak memory "
        f"{peak:.2f} GiB, launches {launches}  [{smi}]")

    # the einsum path on the same tokens, and an f32 einsum prefill
    ein = build_model(cfg.replace(attn_impl="einsum"), device=DEV)
    rows_e = teacher_forced_rows(ein, params, batch, toks, max_len, off)
    a, b = rows[..., :V].float(), rows_e[..., :V].float()
    err = float((a - b).abs().max())
    excess = float(((a - b).abs() - ENCDEC_TOL * b.abs()).max())
    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, params)
    del params, model, ein
    torch.cuda.empty_cache()
    ref = build_model(cfg.replace(attn_impl="einsum", dtype="float32"), device=DEV)
    r32 = ref.prefill(p32, batch, max_len)[0][:, -1, :V]
    e_kern = float((a[:, 0] - r32).abs().max())
    e_ein = float((b[:, 0] - r32).abs().max())
    del p32, ref
    torch.cuda.empty_cache()
    log(f"[encdec] (b) {arch}: logits cuda vs einsum over every step max_abs_err "
        f"{err:.3e} (|d| - {ENCDEC_TOL:g}|einsum| at most {excess:.3e}); prefill "
        f"logits vs an f32 einsum prefill: cuda {e_kern:.3e}, einsum {e_ein:.3e} "
        f"(logits up to {float(r32.abs().max()):.2f})")
    return launches, {"arch": arch, "excess": excess, "e_kern": e_kern,
                      "e_ein": e_ein}


@torch.no_grad()
def phase_int8_bits(gen):
    """(c) The int8 codes and scales the card computes for K/V equal the
    CPU's bit for bit: gemma2-2b's K/V shape in bf16, with rows whose codes
    fall on exact .5 ties and an all-zero row."""
    from repro_torch.models.attention import dequantize_kv, quantize_kv
    x = randn(gen, (4, 2048, 4, 256), torch.bfloat16) * 3
    tie = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5] * 32,
                       device=DEV)
    x[0, 0, 0], x[0, 0, 1], x[0, 0, 2] = tie, tie * 2, 0.0
    q, sc = quantize_kv(x)
    qc, scc = quantize_kv(x.cpu())
    if not (torch.equal(q.cpu(), qc) and torch.equal(sc.cpu().view(torch.int16),
                                                     scc.view(torch.int16))):
        raise AssertionError("int8 K/V: the card's codes or scales differ from "
                             "the CPU's")
    d = dequantize_kv(q, sc, torch.bfloat16)
    if not torch.equal(d.cpu().view(torch.int16),
                       dequantize_kv(qc, scc, torch.bfloat16).view(torch.int16)):
        raise AssertionError("int8 K/V: the card's dequantised values differ")
    log(f"[encdec] (c) int8 K/V of {tuple(x.shape)} bf16 (ties and a zero row "
        "included): codes, scales and dequantised values = the CPU's bit for bit")


@torch.no_grad()
def phase_blocked():
    """(d) Reduced gemma2-2b (f32, window 32) with ``attn_impl`` "blocked" and
    "blocked_unroll" on the card against "einsum": ``forward_logits`` over
    1,100 positions, and prefill + 4 decode steps (decode is the einsum path
    under both names), 1e-4; K2 and K3 never launched."""
    cfg = reduced(get_config("gemma2-2b")).replace(window_size=32)
    params = build_model(cfg, device=DEV).init_params(
        torch.Generator(device=DEV).manual_seed(0))
    params["embed"]["tok"].mul_(0.1)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, BLOCKED_S))).to(DEV)
    n_pre, V = BLOCKED_S - 4, cfg.vocab_size

    def logits_of(impl):
        m = build_model(cfg.replace(attn_impl=impl), device=DEV)
        full = m.forward_logits(params, {"tokens": tokens})[..., :V]
        logits, cache = m.prefill(params, {"tokens": tokens[:, :n_pre]},
                                  BLOCKED_S + 4)
        rows = [logits[:, 0]]
        for i in range(n_pre, BLOCKED_S):
            logits, cache = m.decode_step(params, cache, tokens[:, i:i + 1], i)
            rows.append(logits[:, 0])
        return full, torch.stack(rows, 1)[..., :V]

    full_e, rows_e = logits_of("einsum")
    errs = []
    for impl in ("blocked", "blocked_unroll"):
        before = (k2.launches, k3.launches)
        full, rows = logits_of(impl)
        if (k2.launches, k3.launches) != before:
            raise AssertionError(f"blocked {impl}: K2/K3 launched")
        errs.append(compare(full, full_e, 1e-4, f"reduced gemma2-2b {impl} "
                            "forward vs einsum"))
        errs.append(compare(rows, rows_e, 1e-4, f"reduced gemma2-2b {impl} "
                            "prefill+decode vs einsum"))
    log(f"[encdec] (d) reduced gemma2-2b f32 attn_impl blocked / blocked_unroll, "
        f"{BLOCKED_S} positions: forward and prefill + 4 decode steps vs einsum "
        f"max_abs_err {max(errs):.3e}; K2/K3 not launched")


def phase_encdec(smi: str, gen) -> dict:
    """Phase 10: (a) the reduced models, (b) full width, (c) gemma2-2b serving
    with the int8 KV cache beside phase 5's, (d) the blocked forms.  Returns
    the main paths' launches ((b) and (c))."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    for arch in ENCDEC_PROMPT:
        phase_encdec_reduced(arch)
    launches = {name: 0 for name in KERNELS}
    dists = []
    for arch in ENCDEC_PROMPT:
        got, dist = phase_encdec_full(arch, smi)
        dists.append(dist)
        for name, n in got.items():
            launches[name] += n
    for d in dists:
        if not d["excess"] <= ENCDEC_TOL:
            raise AssertionError(f"full-width {d['arch']}: logits cuda vs einsum "
                                 f"beyond {ENCDEC_TOL:g} absolute plus relative")
        if not d["e_kern"] <= 2 * d["e_ein"] + 1e-3:
            raise AssertionError(f"full-width {d['arch']}: kernel path "
                                 f"{d['e_kern']:.3e} from f32, einsum path "
                                 f"{d['e_ein']:.3e}")
    phase_int8_bits(gen)
    for name, n in phase_full("gemma2-2b", smi, kv_cache_dtype="int8").items():
        launches[name] += n
    (tps, peak), (tps8, peak8) = (SERVED["gemma2-2b", "model"],
                                  SERVED["gemma2-2b", "int8"])
    log(f"[encdec] (c) gemma2-2b int8 KV cache: {tps8:.2f} tok/s, peak memory "
        f"{peak8:.2f} GiB, beside the model-dtype cache's {tps:.2f} tok/s, "
        f"{peak:.2f} GiB (phase 5)  [{smi}]")
    phase_blocked()
    log(f"[encdec] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------------ phase 11

MOE_ARCHS = ("deepseek-moe-16b", "dbrx-132b")
# (a) the reduced layers: a batch of 4 x 64 tokens in groups of 128 (two
# groups), at the configs' capacity factor and at 0.25, where pairs drop
MOE_REDUCED_X, MOE_REDUCED_GROUP, MOE_DROP_CF = (4, 64), 128, 0.25
# (b) dbrx-132b's depth: 4 of its 40 layers (263 GB of bf16 weights whole,
# against the card's 80 GB)
DBRX_LAYERS = 4
# (c) one deepseek-moe-16b layer at full width: a prefill group and a 4-slot
# decode tick
MOE_LAYER_TOKENS = {"prefill group": (1, 2048), "decode tick": (4, 1)}


def moe_layer_params(cfg, seed: int, device):
    """One MoE layer's parameters as ``init_moe`` draws them."""
    ps = ParamStore(torch.Generator(device=device).manual_seed(seed),
                    torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
                    device)
    moe.init_moe(ps, "moe", cfg, None)
    return ps.params["moe"]


def kept_pairs(topi: torch.Tensor, G: int, E: int, C: int) -> torch.Tensor:
    """(G, S·k) bool: which (token, choice) pairs, in (token, choice) order,
    rank below the capacity among their expert's pairs (the reference's
    rule, from the top-k indices alone)."""
    oh = F.one_hot(topi.reshape(G, -1), E)
    return ((oh.cumsum(1) - oh) * oh).sum(-1) < C


@torch.no_grad()
def phase_moe_reduced():
    """(a) The reduced layers in f32, on the card against the same weights
    on the CPU: the top-k indices equal, the kept pairs equal, ``apply_moe``
    in both forms within 1e-5; on the card onehot against sort within 1e-5.
    At capacity factor 0.25 pairs must drop."""
    B, S = MOE_REDUCED_X
    gen = torch.Generator(device=DEV).manual_seed(11)
    lines = []
    for arch in MOE_ARCHS:
        base = reduced(get_config(arch))
        assert base.dtype == "float32"
        for cf in (base.capacity_factor, MOE_DROP_CF):
            cfg = base.replace(capacity_factor=cf)
            p = moe_layer_params(cfg, 0, DEV)
            pc = tree_map(lambda t: t.cpu(), p)
            x = randn(gen, (B, S, cfg.d_model), torch.float32)
            G, gs = B * S // MOE_REDUCED_GROUP, MOE_REDUCED_GROUP
            C = moe._capacity(gs, cfg)
            _, topi, _ = moe._router_probs(p, cfg, x.reshape(B * S, -1))
            _, topi_c, _ = moe._router_probs(pc, cfg, x.reshape(B * S, -1).cpu())
            kept = kept_pairs(topi, G, cfg.num_experts, C)
            if not (torch.equal(topi.cpu(), topi_c) and torch.equal(
                    kept.cpu(), kept_pairs(topi_c, G, cfg.num_experts, C))):
                raise AssertionError(f"reduced {arch} MoE cf {cf}: top-k or "
                                     "kept pairs differ card vs CPU")
            n_kept, n_pairs = int(kept.sum()), kept.numel()
            if cf == MOE_DROP_CF and n_kept == n_pairs:
                raise AssertionError(f"reduced {arch} MoE cf {cf}: no pair "
                                     "dropped")
            outs, errs = {}, []
            for impl in moe.MOE_IMPL:
                outs[impl] = moe.apply_moe(p, cfg, x, impl=impl,
                                           group_size=gs)
                want = moe.apply_moe(pc, cfg, x.cpu(), impl=impl,
                                     group_size=gs).to(DEV)
                errs.append(compare(outs[impl], want, 1e-5,
                                    f"reduced {arch} MoE {impl} cf {cf} card "
                                    "vs CPU"))
            e_forms = compare(outs["onehot"], outs["sort"], 1e-5,
                              f"reduced {arch} MoE cf {cf} onehot vs sort")
            lines.append(f"{arch} cf {cf:g}: C={C}, {n_kept} of {n_pairs} "
                         f"pairs kept (= CPU), card vs CPU onehot "
                         f"{errs[0]:.2e} sort {errs[1]:.2e}, onehot vs sort "
                         f"{e_forms:.2e}")
    log("[moe] (a) reduced layers f32, top-k and kept pairs equal card vs "
        "CPU: " + "; ".join(lines))


def moe_layer_bound_ms(cfg, T: int, G: int, C: int, kept: int, used: int,
                       onehot: bool):
    """(ms, 'bytes'|'operations') of one MoE layer on T bf16 tokens: the
    larger of the bytes (the router (f32), the weights of the ``used``
    routed experts that this run's tokens reach and of the shared experts
    read once, x read and y written once) over the memory rate, and this
    run's FLOPs over the bf16 peak: the router, the ``kept`` pairs' expert
    products (3 of 2·D·F each), the shared experts' (3 of 2·D·F·n_shared a
    token), and for the onehot form its dispatch and combine einsums,
    2·S·E·C·D each a group."""
    D, Fe, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    ns = cfg.num_shared_experts
    nbytes = 4 * D * E + 2 * 3 * used * D * Fe + 2 * 3 * D * Fe * ns + 2 * 2 * T * D
    flops = 2 * T * D * E + 6 * D * Fe * kept + 6 * D * Fe * ns * T
    if onehot:
        flops += 2 * (2 * (T // G) * E * C * D) * G
    t_b, t_o = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


@torch.no_grad()
def phase_moe_layer(smi: str):
    """(c) One deepseek-moe-16b MoE layer at full width in bf16, both forms,
    at a prefill group of 2,048 tokens and a 4-token decode tick: device ms
    (CUDA-graph replays timed by CUDA events, median of 5), the eager call,
    the bound, and onehot against sort within bf16's 2e-2 (of the outputs'
    scale) absolute plus relative."""
    cfg = get_config("deepseek-moe-16b")
    assert cfg.dtype == "bfloat16"
    torch.cuda.empty_cache()
    p = moe_layer_params(cfg, 0, DEV)
    gen = torch.Generator(device=DEV).manual_seed(12)
    for case, (B, S) in MOE_LAYER_TOKENS.items():
        T = B * S
        gs = min(cfg.moe_group_size, T)
        G, C = T // gs, moe._capacity(gs, cfg)
        xs = [randn(gen, (B, S, cfg.d_model), torch.bfloat16) for _ in range(3)]
        _, topi, _ = moe._router_probs(p, cfg, xs[0].reshape(T, -1))
        keep = kept_pairs(topi, G, cfg.num_experts, C)
        kept = int(keep.sum())
        used = int(topi.reshape(G, -1)[keep].unique().numel())
        ys = {}
        for impl in moe.MOE_IMPL:
            def call(x, impl=impl):
                return moe.apply_moe(p, cfg, x, impl=impl,
                                     group_size=cfg.moe_group_size)
            ys[impl] = call(xs[0])
            ms = device_ms([lambda x=x: call(x) for x in xs])
            eager = eager_ms(lambda: call(xs[0]), iters=5)
            bound, by = moe_layer_bound_ms(cfg, T, G, C, kept, used,
                                           impl == "onehot")
            log(f"[moe] (c) deepseek-moe-16b layer, {case} B={B} S={S} (G={G}, "
                f"C={C}, {kept} of {T * cfg.top_k} pairs kept, {used} of "
                f"{cfg.num_experts} experts reached), {impl}: "
                f"{ms:.4f} ms (eager call {eager:.4f} ms), bound "
                f"{bound:.5f} ms ({by})  [{smi}]")
        # the init's expert weights (fan-in over E·D, as the reference's)
        # make small outputs, far below bf16's 2e-2 absolute: the forms are
        # held to 2e-2 of the outputs' largest magnitude plus relative
        scale = float(ys["sort"].float().abs().max())
        err = scale * compare(ys["onehot"].float() / scale,
                              ys["sort"].float() / scale, 2e-2,
                              f"deepseek-moe-16b layer {case} onehot vs sort "
                              "(over the outputs' scale)")
        log(f"[moe] (c) {case}: onehot vs sort max_abs_err {err:.3e} (outputs "
            f"up to {scale:.3e})")
    del p
    torch.cuda.empty_cache()


def phase_moe(smi: str):
    """Phase 11: (a) the reduced layers card vs CPU, (b) dbrx-132b at full
    width and 4 of 40 layers through the engine, (c) one deepseek-moe-16b
    layer timed.  Returns the main path's launches ((b))."""
    t_phase = time.perf_counter()
    phase_moe_reduced()
    full = get_config("dbrx-132b")
    n = build_model(full, device=DEV).param_count()     # shapes only
    log(f"[moe] (b) dbrx-132b at full width with {DBRX_LAYERS} of its "
        f"{full.num_layers} layers: {full.num_layers - DBRX_LAYERS} cut, since "
        f"its {n / 1e9:.1f} G parameters are {2 * n / 1e9:.0f} GB of bf16 "
        "weights against the card's 80 GB")
    launches = phase_full("dbrx-132b", smi, num_layers=DBRX_LAYERS,
                          prompt_lens=PROMPT_LENS["deepseek-moe-16b"])
    phase_moe_layer(smi)
    log(f"[moe] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------------ phase 12

TRAIN_ARCHS = ("mamba2-130m", "gemma2-2b")
TRAIN_LOSS_TOL = 1e-5       # (b) card vs CPU, relative
TRAIN_LEAF_TOL = 1e-4       # (b) a gradient leaf, of its largest entry
ADAMW_TOL = 1e-6            # (b) one update from the same gradients
# the reference trainer's defaults (launch/train.py), and its resume test's
# shape (tests/test_train_and_serve.py) at them
TRAIN_B, TRAIN_S, TRAIN_LR = 8, 256, 3e-3
TRAIN_STEPS, RESUME_STEPS, RESUME_FAIL_AT, RESUME_EVERY = 30, 10, 7, 5
GEMMA_B, GEMMA_STEPS = 4, 5
SIDE_STEPS = 10             # (e) accumulation, compression
DET_PAIRS = 3               # (c), (d): steps with and without the mode
TRAIN_DIR = ROOT / "build" / "train"


def phase_train_repair(gen):
    """(a) K2-K5 at small shapes: with an input that requires grad the
    wrapper raises while autograd records; under ``no_grad`` it launches
    once (these launches compare, they are not a main path's)."""
    def r(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    cs = -torch.rand((1, 1, 16, 2), generator=gen, device=DEV).cumsum(2)
    kv = (r(1, 8, 1, 64), r(1, 8, 1, 64))
    cases = {"flash_attention": (k2.flash_attention, (r(1, 8, 2, 64), *kv)),
             "decode_attention": (k3.decode_attention, (
                 r(1, 1, 2, 64), *kv,
                 torch.ones(8, dtype=torch.bool, device=DEV))),
             "ssd_scan": (k4.ssd_scan, (r(1, 1, 16, 2, 16),
                                        r(1, 1, 16, 2).abs(), cs,
                                        r(1, 1, 16, 16), r(1, 1, 16, 16))),
             "rg_lru": (k5.rg_lru, (torch.rand((1, 8, 4), generator=gen,
                                               device=DEV), r(1, 8, 4)))}
    for name, (fn, args) in cases.items():
        args[0].requires_grad_(True)
        try:
            fn(*args)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"[train] (a) {name} launched under grad")
        before = KERNELS[name].launches
        with torch.no_grad():
            out = fn(*args)
        torch.cuda.synchronize()
        out = out[0] if isinstance(out, tuple) else out
        if KERNELS[name].launches != before + 1 or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"[train] (a) {name} under no_grad: "
                                 f"{KERNELS[name].launches - before} launches")
    log("[train] (a) K2-K5 each raise under grad with an input that "
        "requires grad, and launch once each under no_grad")


def loss_and_grads(model, params, batch):
    """The loss and every leaf's gradient (``tree_leaves`` order)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = model.loss_fn(live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
    return loss.detach(), grads


def leaf_err(got, want) -> float:
    """max |got - want| over the largest |want| (got moved to want's device)."""
    g, w = got.detach().float().to(want.device), want.detach().float()
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


def phase_train_card_vs_cpu():
    """(b) reduced mamba2-130m and gemma2-2b, f32, ``blocked``: the same
    ``init_params(device="cpu")`` tree on the card and on the CPU, one batch:
    the loss, every gradient leaf, and one AdamW update from the CPU's
    gradients on both sides."""
    for arch in TRAIN_ARCHS:
        cfg = reduced(get_config(arch)).replace(attn_impl="blocked")
        cpu = torch.device("cpu")
        host = build_model(cfg, device=cpu).init_params(
            torch.Generator().manual_seed(0))
        dev = tree_map(lambda t: t.to(DEV), host)
        b = SyntheticLMPipeline(cfg.vocab_size, TRAIN_B, TRAIN_S).batch_at(0)
        l_h, g_h = loss_and_grads(build_model(cfg, device=cpu), host,
                                  batch_to(b, cpu))
        l_d, g_d = loss_and_grads(build_model(cfg, device=DEV), dev,
                                  batch_to(b, DEV))
        loss_err = abs(float(l_d) - float(l_h)) / abs(float(l_h))
        if not loss_err <= TRAIN_LOSS_TOL:
            raise AssertionError(f"[train] (b) {arch}: loss {float(l_d)} on "
                                 f"the card, {float(l_h)} on the CPU")
        if any(g is None or not bool(g.any()) for g in g_d):
            raise AssertionError(f"[train] (b) {arch}: a gradient leaf is "
                                 "None or all zero")
        worst = max(leaf_err(a, b) for a, b in zip(g_d, g_h))
        if not worst <= TRAIN_LEAF_TOL:
            raise AssertionError(f"[train] (b) {arch}: a gradient leaf "
                                 f"{worst:.2e} of its largest entry away")
        it = iter(g_h)
        grads_h = tree_map(lambda _: next(it), host)
        out = {}
        for side, params, grads in (("cpu", host, grads_h),
                                    ("card", dev, tree_map(
                                        lambda t: t.to(DEV), grads_h))):
            new, opt, gn = adamw_update(AdamWConfig(lr=TRAIN_LR), grads,
                                        adamw_init(params), params=params)
            out[side] = tree_leaves(new) + tree_leaves(opt) + [gn]
        upd = max(leaf_err(a, b) for a, b in zip(out["card"], out["cpu"]))
        if not upd <= ADAMW_TOL:
            raise AssertionError(f"[train] (b) {arch}: AdamW on the card "
                                 f"{upd:.2e} from the CPU's")
        log(f"[train] (b) {arch} reduced f32 blocked, B={TRAIN_B} "
            f"S={TRAIN_S}, card vs CPU: loss {float(l_d):.6f} (rel err "
            f"{loss_err:.2e}, tol {TRAIN_LOSS_TOL}), {len(g_d)} gradient "
            f"leaves, none zero, worst {worst:.2e} of the leaf's largest "
            f"entry (tol {TRAIN_LEAF_TOL}); one AdamW update from the same "
            f"gradients: params, master, moments, step and norm within "
            f"{upd:.2e} (tol {ADAMW_TOL})")


def timed_steps(step, params, opt, pipe, start: int, n: int, det: bool):
    """``n`` steps from ``pipe``'s step ``start`` (under the trainer's
    deterministic mode if ``det``): (params, opt, losses, gradient norms,
    seconds a step, each synchronised)."""
    losses, norms, times = [], [], []
    with deterministic() if det else contextlib.nullcontext():
        for s in range(start, start + n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, pipe.batch_at(s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            times.append(time.perf_counter() - t0)
    return params, opt, losses, norms, times


def deterministic_cost(step, params, opt, pipe, start: int, n: int) -> str:
    """Median step ms with and without the deterministic mode, ``n`` steps
    each in alternating pairs, continuing from ``params`` (they are consumed)."""
    ms = {True: [], False: []}
    for i in range(n):
        for det in (False, True):
            params, opt, _, _, t = timed_steps(step, params, opt, pipe,
                                               start + 2 * i + det, 1, det)
            ms[det] += t
    on, off = (float(np.median(ms[d])) * 1e3 for d in (True, False))
    return (f"median step {on:.2f} ms under the deterministic mode, "
            f"{off:.2f} ms without ({(on / off - 1) * 100:+.1f}%)")


def phase_train_mamba(smi: str):
    """(c) mamba2-130m at published width and depth through ``train`` (the
    reference trainer's default arch, preset full: bf16, ``remat="full"``,
    B=8, S=256): the loss falls over 30 steps; a run preempted at step 7 and
    resumed from the step-5 checkpoint ends bit for bit where an unbroken run
    of 10 steps does."""
    kw = dict(arch="mamba2-130m", preset="full", batch=TRAIN_B, seq=TRAIN_S,
              lr=TRAIN_LR, device=DEV)
    cfg = train_config("mamba2-130m", "full")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, losses, wd = train(steps=TRAIN_STEPS, log_every=TRAIN_STEPS, **kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"[train] (c) mamba2-130m losses {losses}")
    ms = float(np.median(wd.times)) * 1e3
    log(f"[train] (c) mamba2-130m full width ({cfg.num_layers} layers, "
        f"{cfg.dtype}, remat {cfg.remat}, {cfg.attn_impl}), B={TRAIN_B} "
        f"S={TRAIN_S} lr "
        f"{TRAIN_LR}: {TRAIN_STEPS} steps in {wall:.1f} s, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 5 "
        f"{first:.4f}, last 5 {last:.4f}), median step {ms:.2f} ms = "
        f"{TRAIN_B * TRAIN_S / ms * 1e3:.0f} tokens/s, peak memory "
        f"{peak:.2f} GiB, straggler events {len(wd.events)}  [{smi}]")

    ckpt = TRAIN_DIR / "resume"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    straight, _, _ = train(steps=RESUME_STEPS, log_every=RESUME_STEPS, **kw)
    resumed, _, _ = train_with_retries(
        steps=RESUME_STEPS, ckpt_dir=str(ckpt), ckpt_every=RESUME_EVERY,
        fail_at=RESUME_FAIL_AT, log_every=RESUME_STEPS, **kw)
    pairs = list(zip(tree_leaves(straight), tree_leaves(resumed)))
    differ = [i for i, (a, b) in enumerate(pairs)
              if a.dtype != b.dtype or not torch.equal(a, b)]
    shutil.rmtree(ckpt, ignore_errors=True)
    if differ or not pairs:
        raise AssertionError(f"[train] (c) resumed run: {len(differ)} of "
                             f"{len(pairs)} leaves differ from the unbroken "
                             "run")
    log(f"[train] (c) preempted at step {RESUME_FAIL_AT}, resumed from the "
        f"step-{RESUME_EVERY} checkpoint: all {len(pairs)} leaves equal the "
        f"unbroken {RESUME_STEPS}-step run bit for bit "
        f"({time.perf_counter() - t0:.1f} s for both runs)")
    step = make_train_step(build_model(cfg, device=DEV),
                           AdamWConfig(lr=TRAIN_LR))
    cost = deterministic_cost(step, straight, init_opt_state(straight),
                              SyntheticLMPipeline(cfg.vocab_size, TRAIN_B,
                                                  TRAIN_S), 0, DET_PAIRS)
    log(f"[train] (c) mamba2-130m: {cost}  [{smi}]")


def phase_train_gemma(smi: str):
    """(d) gemma2-2b at published width and depth (bf16, ``remat="full"``)
    through ``make_train_step``, as ``train`` drives it: B=4, S=256, 5
    steps, the loss and the gradient norm finite."""
    cfg = train_config("gemma2-2b", "full")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=DEV)
    n = model.param_count()
    params = model.init_params(torch.Generator(DEV).manual_seed(0))
    opt = init_opt_state(params)
    step = make_train_step(model, AdamWConfig(lr=TRAIN_LR))
    pipe = SyntheticLMPipeline(cfg.vocab_size, GEMMA_B, TRAIN_S)
    params, opt, losses, norms, times = timed_steps(step, params, opt, pipe,
                                                    0, GEMMA_STEPS, True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"[train] (d) gemma2-2b losses {losses}, "
                             f"gradient norms {norms}")
    ms = float(np.median(times)) * 1e3
    log(f"[train] (d) gemma2-2b full width ({n / 1e9:.3f} G parameters, "
        f"{cfg.num_layers} layers, {cfg.dtype}, remat {cfg.remat}, "
        f"{cfg.attn_impl}, f32 master and moments), B={GEMMA_B} S={TRAIN_S}: "
        f"losses "
        f"{[round(x, 4) for x in losses]}, gradient norms "
        f"{[round(x, 3) for x in norms]}, median step {ms:.2f} ms = "
        f"{GEMMA_B * TRAIN_S / ms * 1e3:.0f} tokens/s, peak memory "
        f"{peak:.2f} GiB  [{smi}]")
    cost = deterministic_cost(step, params, opt, pipe, GEMMA_STEPS, DET_PAIRS)
    log(f"[train] (d) gemma2-2b: {cost}  [{smi}]")
    del params, opt, step, model
    torch.cuda.empty_cache()


def phase_train_side():
    """(e) reduced mamba2-130m through ``train`` on the card: accumulation
    over 4 microbatches and int8 error-feedback compression, 10 steps each."""
    kw = dict(arch="mamba2-130m", preset="tiny", steps=SIDE_STEPS,
              batch=TRAIN_B, seq=TRAIN_S, lr=TRAIN_LR, device=DEV,
              log_every=SIDE_STEPS)
    _, acc, _ = train(accum=4, **kw)
    _, comp, _ = train(compress_grads=True, **kw)
    if not (np.isfinite(acc).all() and np.isfinite(comp).all()) or \
            not np.mean(comp[-5:]) < np.mean(comp[:5]):
        raise AssertionError(f"[train] (e) accum {acc}, compressed {comp}")
    log(f"[train] (e) reduced mamba2-130m, {SIDE_STEPS} steps: accum 4 loss "
        f"{acc[0]:.4f} -> {acc[-1]:.4f}; int8 compression {comp[0]:.4f} -> "
        f"{comp[-1]:.4f} (mean of the first 5 {np.mean(comp[:5]):.4f}, last "
        f"5 {np.mean(comp[-5:]):.4f})")


def phase_train(smi: str, gen):
    """Phase 12: (a) the kernels refuse grad; (b) card vs CPU; (c)-(e) the
    training runs, in which no kernel may launch (training runs
    ``blocked``)."""
    t_phase = time.perf_counter()
    phase_train_repair(gen)
    phase_train_card_vs_cpu()
    counts_zero()
    phase_train_mamba(smi)
    phase_train_gemma(smi)
    phase_train_side()
    if any(counts().values()):
        raise AssertionError(f"[train] kernels launched while training: "
                             f"{counts()}")
    log(f"[train] (c)-(e) launched no kernel; phase 12 took "
        f"{time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------ phase 13

PP_REDUCED = dict(stages=2, micro=2, B=4, S=32)      # tests/test_pipeline.py
PP_FULL = dict(stages=4, micro=4, B=4, S=256)        # granite-3-8b as published
PP_LOSS_TOL = 1e-5          # (a) reduced f32: relative
PP_LEAF_TOL = 1e-4          # (a) reduced f32: of the leaf's largest entry
PP_BF16_TOL = 2e-2          # (a) full width bf16: loss relative, and a leaf
PP_REPS = 3                 # (a) timed loss+grad steps each way
DRY_CELLS = (("gemma2-2b", ShapeConfig("train_s1024_b2", 1024, 2, "train")),
             ("mamba2-130m", "long_500k"))
DRY_MEM_TOL = 0.01          # (b) accounted vs allocated argument bytes
HILLCLIMB_KEYS = ("moe", "decode", "long")
RATE_N = 8192               # (c) an N^3 bf16 matmul
RATE_COPY_BYTES = 4 * 2 ** 30
RATE_CAP = 1.05             # (c) no rate above 105% of the data sheet's
ELASTIC_STEPS, ELASTIC_B, ELASTIC_S, ELASTIC_LR = 5, 8, 32, 1e-3
ELASTIC_TOL = 5e-3          # (d) tests/test_elastic_resume.py's bound
ELASTIC_DIR = ROOT / "build" / "elastic"
EXAMPLE_ARCH, EXAMPLE_SHAPE = "granite-3-8b", "train_4k"


def pp_loss_and_grads(cfg, params, batch, stages: int, micro: int):
    """Loss and every gradient leaf of the plain stack (``stages`` 0) or
    the GPipe schedule under a (stages, 2, 2) mesh's ``train_pp`` rules."""
    B = batch["tokens"].shape[0]
    mesh = Mesh((max(stages, 1), 2, 2), ("pod", "data", "model"))
    if stages:
        cfg = cfg.replace(pipeline_stages=stages, pipeline_microbatches=micro)
    with use_mesh(mesh, rules_for(mesh, batch_size=B, kind="train_pp")):
        return loss_and_grads(build_model(cfg, device=tree_leaves(
            params)[0].device), params, batch)


def token_batch(vocab: int, B: int, S: int, device, seed: int):
    t = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (B, S))).to(device)
    return {"tokens": t, "labels": torch.roll(t, -1, 1)}


def sliced_leaf_err(got, want) -> float:
    """:func:`leaf_err` taken a leading slice at a time (a stacked leaf of
    a published-width model in f32 would take gigabytes at once)."""
    if got.ndim < 2:
        return leaf_err(got, want)
    diff = max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))
    return diff / max(max(float(w.float().abs().max()) for w in want), 1e-30)


def phase_layouts_gpipe(smi: str):
    """(a) The GPipe schedule: reduced granite-3-8b in f32 (the reference
    test's case) pipelined on the card against the plain stack on the card
    and the same call on the CPU; then granite-3-8b at published width in
    bf16 (``blocked``, ``remat="full"``), 4 stages x 4 microbatches."""
    cpu = torch.device("cpu")
    r = PP_REDUCED
    cfg = reduced(get_config("granite-3-8b")).replace(attn_impl="blocked")
    host = build_model(cfg, device=cpu).init_params(
        torch.Generator().manual_seed(0))
    dev = tree_map(lambda t: t.to(DEV), host)
    hb = token_batch(cfg.vocab_size, r["B"], r["S"], cpu, 1)
    db = {k: v.to(DEV) for k, v in hb.items()}
    l_pp, g_pp = pp_loss_and_grads(cfg, dev, db, r["stages"], r["micro"])
    l_pl, g_pl = pp_loss_and_grads(cfg, dev, db, 0, 0)
    l_cpu, g_cpu = pp_loss_and_grads(cfg, host, hb, r["stages"], r["micro"])
    errs = {}
    for what, (l_w, g_w) in {"plain stack on the card": (l_pl, g_pl),
                             "same call on the CPU": (l_cpu, g_cpu)}.items():
        le = abs(float(l_pp) - float(l_w)) / abs(float(l_w))
        ge = max(leaf_err(a, b) for a, b in zip(g_pp, g_w))
        if not (le <= PP_LOSS_TOL and ge <= PP_LEAF_TOL):
            raise AssertionError(f"[layouts] (a) reduced pipeline vs {what}: "
                                 f"loss {le:.2e}, worst leaf {ge:.2e}")
        errs[what] = (le, ge)
    if any(not bool(g.any()) for g in g_pp):
        raise AssertionError("[layouts] (a) a pipelined gradient leaf is zero")
    log(f"[layouts] (a) GPipe, reduced granite-3-8b f32 blocked, "
        f"{r['stages']} stages x {r['micro']} microbatches, B={r['B']} "
        f"S={r['S']}, (2,2,2) mesh train_pp rules: loss {float(l_pp):.6f}; "
        + "; ".join(f"vs the {w}: loss {le:.2e} rel (tol {PP_LOSS_TOL}), "
                    f"{len(g_pp)} leaves, worst {ge:.2e} of the leaf's "
                    f"largest (tol {PP_LEAF_TOL})"
                    for w, (le, ge) in errs.items()))

    f = PP_FULL
    cfg = get_config("granite-3-8b").replace(attn_impl="blocked",
                                             remat="full")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=DEV)
    n = model.param_count()
    params = model.init_params(torch.Generator(DEV).manual_seed(0))
    batch = token_batch(cfg.vocab_size, f["B"], f["S"], DEV, 2)
    ms = {}
    for stages in (f["stages"], 0):
        times = []
        for _ in range(PP_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pp_loss_and_grads(cfg, params, batch, stages, f["micro"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del out
        ms[stages] = float(np.median(times)) * 1e3
    l_pp, g_pp = pp_loss_and_grads(cfg, params, batch, f["stages"], f["micro"])
    l_pl, g_pl = pp_loss_and_grads(cfg, params, batch, 0, 0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    le = abs(float(l_pp) - float(l_pl)) / abs(float(l_pl))
    ge = max(sliced_leaf_err(a, b) for a, b in zip(g_pp, g_pl))
    zero = sum(not bool(g.any()) for g in g_pp)
    if not (np.isfinite(float(l_pp)) and le <= PP_BF16_TOL
            and ge <= PP_BF16_TOL and zero == 0):
        raise AssertionError(f"[layouts] (a) granite-3-8b pipeline vs plain: "
                             f"loss {le:.2e}, worst leaf {ge:.2e}, {zero} "
                             "zero leaves")
    log(f"[layouts] (a) GPipe, granite-3-8b full width ({n / 1e9:.3f} G "
        f"parameters, {cfg.num_layers} layers, {cfg.dtype}, remat "
        f"{cfg.remat}, {cfg.attn_impl}), {f['stages']} stages x "
        f"{f['micro']} microbatches, B={f['B']} S={f['S']}: loss "
        f"{float(l_pp):.4f} vs plain {float(l_pl):.4f} ({le:.2e} rel, tol "
        f"{PP_BF16_TOL}), {len(g_pp)} gradient leaves, none zero, worst "
        f"{ge:.2e} of the leaf's largest (tol {PP_BF16_TOL}); loss+grad step "
        f"median of {PP_REPS} (synchronised) {ms[f['stages']]:.2f} ms "
        f"pipelined, {ms[0]:.2f} ms plain; peak memory {peak:.2f} GiB  "
        f"[{smi}]")
    del params, g_pp, g_pl, model
    torch.cuda.empty_cache()


def phase_layouts_dryrun(smi: str):
    """(b) The dry-run held to the card: for each of ``DRY_CELLS`` on the
    host mesh, the ``meta`` count of the step against ``FlopCounterMode``'s
    count of the same step run on the card, and the accounted argument
    bytes against what materialising them allocates; then the hillclimb
    cells on pod16x16 with their roofline terms."""
    for arch, shape in DRY_CELLS:
        cell = dryrun.build_cell(arch, shape, False, mesh_shape=(1, 1))
        t0 = time.perf_counter()
        outs, f_meta, b_meta = dryrun.count_step(cell.step, cell.args)
        t_meta = time.perf_counter() - t0
        acct = dryrun.memory_analysis(cell, outs)["argument_size_in_bytes"]
        del outs
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        args = dryrun.real_args(cell, DEV, seed=0)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
        if not abs(grown - acct) <= DRY_MEM_TOL * acct:
            raise AssertionError(f"[layouts] (b) {arch} {cell.shape.name}: "
                                 f"{acct} bytes accounted, {grown} allocated")
        t0 = time.perf_counter()
        _, f_card, b_card = dryrun.count_step(cell.step, args)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        if f_card != f_meta or f_meta <= 0:
            raise AssertionError(f"[layouts] (b) {arch} {cell.shape.name}: "
                                 f"{f_meta} FLOPs on meta, {f_card} on the "
                                 "card")
        log(f"[layouts] (b) {arch} {cell.shape.name} (B="
            f"{cell.shape.global_batch} S={cell.shape.seq_len}, "
            f"{cell.shape.kind}, host mesh, {cell.accum} microbatch(es)): "
            f"matmul FLOPs {f_meta} on meta = {f_card} on the card (exact); "
            f"bytes {b_meta} on meta, {b_card} on the card "
            f"({b_card / b_meta - 1:+.2e}); argument bytes {acct} accounted, "
            f"{grown} allocated ({grown / acct - 1:+.2e}, tol {DRY_MEM_TOL}); "
            f"counted in {t_meta:.1f} s on meta, the card's step "
            f"{t_card:.2f} s under the counters  [{smi}]")
        del args
        torch.cuda.empty_cache()
    for key in HILLCLIMB_KEYS:
        arch, shape, _ = hillclimb.CELLS[key]
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, False, save=False, device=DEV)
        t = roofline.cell_terms(rec)
        log(f"[layouts] (b) hillclimb cell {key}: {arch} x {shape} x "
            f"pod16x16 ({rec['num_devices']} devices, perfectly "
            f"partitioned): {rec['flops']:.4e} matmul FLOPs and "
            f"{rec['bytes_accessed']:.4e} bytes a device, compute "
            f"{t['t_compute']:.4e} s, memory {t['t_memory']:.4e} s, "
            f"collective {t['t_collective']:.4e} s at "
            f"{LINK_BW / 1e9:.0f} GB/s, dominant "
            f"{t['dominant']}, MODEL/counted "
            f"{t['model_flops_frac']:.3f}, arguments "
            f"{rec['memory_analysis']['argument_size_in_bytes'] / 1e9:.2f} GB"
            f" a device (fits {rec['fits']}); counted in "
            f"{time.perf_counter() - t0:.1f} s (H100 SXM data-sheet peaks)")


def phase_layouts_rates(smi: str):
    """(c) The card's own matmul and copy rates beside the data sheet's
    (CUDA events, median of 5); a rate above 105% of the data sheet's means
    the timing is broken."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    a = torch.randn((RATE_N, RATE_N), generator=gen, device=DEV,
                    dtype=torch.bfloat16)
    b = torch.randn((RATE_N, RATE_N), generator=gen, device=DEV,
                    dtype=torch.bfloat16)
    c = torch.empty_like(a)
    mm = eager_ms(lambda: torch.matmul(a, b, out=c), iters=5)
    del a, b, c
    src = torch.empty(RATE_COPY_BYTES, dtype=torch.uint8, device=DEV)
    dst = torch.empty_like(src)
    cp = eager_ms(lambda: dst.copy_(src), iters=5)
    del src, dst
    torch.cuda.empty_cache()
    flops = 2 * RATE_N ** 3 / (mm * 1e-3)
    bps = 2 * RATE_COPY_BYTES / (cp * 1e-3)
    if flops > RATE_CAP * PEAK_BF16_FLOPS or bps > RATE_CAP * PEAK_BYTES_S:
        raise AssertionError(f"[layouts] (c) {flops:.3e} FLOP/s, {bps:.3e} "
                             "B/s: above the data sheet")
    log(f"[layouts] (c) the card's rates (CUDA events, median of 5): "
        f"{RATE_N}^3 bf16 torch.matmul {mm:.4f} ms = {flops / 1e12:.1f} "
        f"TFLOP/s ({flops / PEAK_BF16_FLOPS:.1%} of the data sheet's "
        f"{PEAK_BF16_FLOPS / 1e12:.0f}); a {RATE_COPY_BYTES / 2 ** 30:.0f} "
        f"GiB device copy {cp:.4f} ms = {bps / 1e12:.3f} TB/s read+write "
        f"({bps / PEAK_BYTES_S:.1%} of {PEAK_BYTES_S / 1e12:.2f})  [{smi}]")


def elastic_steps(cfg, params, opt, device, start: int, stop: int, mesh):
    """Steps ``start``..``stop`` of the reduced granite run under ``mesh``'s
    rules on ``device`` (the data pipeline addressed by step)."""
    with use_mesh(mesh, rules_for(mesh, batch_size=ELASTIC_B)):
        step = make_train_step(build_model(cfg, device=device),
                               AdamWConfig(lr=ELASTIC_LR))
        pipe = SyntheticLMPipeline(cfg.vocab_size, ELASTIC_B, ELASTIC_S)
        for t in range(start, stop):
            params, opt, m = step(params, opt, pipe.batch_at(t))
            if not np.isfinite(float(m["loss"])):
                raise AssertionError(f"[layouts] (d) loss at step {t}")
        pipe.state.step = stop
    return params, opt, pipe


def phase_layouts_elastic():
    """(d) Across meshes on one card: reduced granite-3-8b takes 5 steps on
    the card under the host mesh's rules, saves, restores on the CPU under
    a (2,4) mesh's rules and takes 5 more; its final parameters against 10
    unbroken CPU steps."""
    cpu = torch.device("cpu")
    cfg = reduced(get_config("granite-3-8b")).replace(attn_impl="blocked")
    init = build_model(cfg, device=cpu).init_params(
        torch.Generator().manual_seed(0))
    dev = tree_map(lambda t: t.to(DEV), init)
    dev, opt, pipe = elastic_steps(cfg, dev, init_opt_state(dev), DEV, 0,
                                   ELASTIC_STEPS, make_host_mesh())
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    mgr = CheckpointManager(str(ELASTIC_DIR))
    mgr.save(ELASTIC_STEPS, {"params": dev, "opt": opt},
             meta={"data": pipe.state_dict()})
    state, meta = mgr.restore(device=cpu)
    resumed, _, _ = elastic_steps(cfg, state["params"], state["opt"], cpu,
                                  meta["data"]["step"], 2 * ELASTIC_STEPS,
                                  Mesh((2, 4), ("data", "model")))
    straight, _, _ = elastic_steps(cfg, init, init_opt_state(init), cpu, 0,
                                   2 * ELASTIC_STEPS, make_host_mesh())
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    err = max(float((a - b).abs().max()) for a, b in
              zip(tree_leaves(resumed), tree_leaves(straight)))
    if not err < ELASTIC_TOL:
        raise AssertionError(f"[layouts] (d) resumed across meshes {err:.2e} "
                             "from the unbroken CPU run")
    log(f"[layouts] (d) reduced granite-3-8b f32: {ELASTIC_STEPS} steps on "
        f"the card (host mesh), saved, restored on the CPU under a (2,4) "
        f"mesh's rules, {ELASTIC_STEPS} more: final parameters within "
        f"{err:.2e} of {2 * ELASTIC_STEPS} unbroken CPU steps (tol "
        f"{ELASTIC_TOL})")


def phase_layouts_example(smi: str) -> int:
    """(e) ``examples/autotune_sharding_torch.py`` on the card: one K1
    launch a layout; each simulated step against the event-heap simulator
    on the CPU."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        ex = importlib.import_module("autotune_sharding_torch")
    finally:
        sys.path.pop(0)
    counts_zero()
    rows = ex.simulate_layouts(EXAMPLE_ARCH, EXAMPLE_SHAPE, DEV)
    got = k1_counts()
    want = {name: 0 for name in got}
    want["epoch_scan"] = len(ex.CANDIDATES)
    if got != want or counts()["epoch_scan"] != len(ex.CANDIDATES):
        raise AssertionError(f"[layouts] (e) K1 launches {got}, expected "
                             f"{want}")
    for (name, _, _, step_ms), (_, _, _, db, app, trace) in zip(
            rows, ex.layouts(EXAMPLE_ARCH, EXAMPLE_SHAPE)):
        ref = simkernel_ref.simulate(db, [app], trace, get_scheduler(
            "etf")).makespan_us / 1e3
        if not abs(step_ms - ref) <= 1e-6 * abs(ref):
            raise AssertionError(f"[layouts] (e) {name}: {step_ms} ms on the "
                                 f"card, {ref} ms by the event heap")
    best = min(rows, key=lambda r: r[3])
    log(f"[layouts] (e) autotune example, {EXAMPLE_ARCH} x {EXAMPLE_SHAPE}: "
        + ", ".join(f"{r[0]} {r[3]:.4f} ms" for r in rows)
        + f" simulated (each = the event-heap simulator on the CPU within "
          f"1e-6); selected {best[0]}; K1 launches {got}  [{smi}]")
    return len(ex.CANDIDATES)


def phase_layouts(smi: str) -> dict:
    """Phase 13: layouts and launch tools.  (a)-(d) launch no kernel; (e)
    launches K1 once a layout (its count is returned)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    counts_zero()
    phase_layouts_gpipe(smi)
    phase_layouts_dryrun(smi)
    phase_layouts_rates(smi)
    phase_layouts_elastic()
    if any(counts().values()):
        raise AssertionError(f"[layouts] (a)-(d) launched kernels: "
                             f"{counts()}")
    k1_example = phase_layouts_example(smi)
    log(f"[layouts] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return {"epoch_scan": k1_example}


# ------------------------------------------------------------------ lint

def phase_lint(smi: str) -> dict:
    """Phase 14: (a) the port's linter on this checkout, as a user runs it;
    (b) its counter gate on the card's own counters: the manifest of a sweep
    on the card, gated against contracts at and one below its counts.
    Returns (b)'s K1 launches."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) the linter, in a process of its own
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--strict",
             "--report", str(tmp / "lint.json")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        lint_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[lint] python -m repro_torch.analysis "
                                 f"--strict exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        rep = json.loads((tmp / "lint.json").read_text())
        by_rule = {}
        for f in rep["findings"]:
            active, waived = by_rule.get(f["code"], (0, 0))
            by_rule[f["code"]] = (active + (not f["waived"]),
                                  waived + f["waived"])
        if rep["summary"]["active"]:
            raise AssertionError(f"[lint] active findings: {rep['summary']}")
        # the analysis alone, in this process (the subprocess's wall also
        # holds the interpreter's start and torch's import)
        t0 = time.perf_counter()
        again = run_analysis(load_config(ROOT), strict=True)
        analysis_s = time.perf_counter() - t0
        if not again.ok or len(again.findings) != len(rep["findings"]):
            raise AssertionError(f"[lint] in-process analysis: "
                                 f"{len(again.active)} active, "
                                 f"{len(again.findings)} findings")
        log(f"[lint] (a) python -m repro_torch.analysis --strict: exit 0, "
            f"{len(rep['files'])} files, rules {','.join(rep['rules'])}, "
            f"findings by rule (active, waived) "
            + ", ".join(f"{c} {a}/{w}" for c, (a, w) in sorted(by_rule.items()))
            + f"; {lint_s:.2f} s wall in all, the analysis alone "
              f"{analysis_s:.2f} s in process (Python "
              f"{sys.version.split()[0]})  [{smi}]")

        # (b) the gate on the card's counters: phase 7's smallest sweep
        mix = Scenario(apps=("wifi_tx", "wifi_rx"),
                       trace=TraceSpec(rate_jobs_per_ms=20.0,
                                       num_jobs=SWEEP_JOBS, seed=1))
        axes = {"design": SWEEP_DESIGNS, "rate": SWEEP_RATES}
        counts_zero()
        for key in sweep_mod.scan_calls:
            sweep_mod.scan_calls[key] = 0
        t0 = time.perf_counter()
        sr = sweep(mix, axes)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        assert_counts({"epoch_scan": 1}, "[lint] sweep design x rate")
        if not np.isfinite(sr.avg_latency_us).all() or sr.num_points != 9:
            raise AssertionError(f"[lint] sweep: {sr.num_points} points, "
                                 f"latency {sr.avg_latency_us}")
        payload = obs_bench.rows_payload(
            [("points", sr.num_points, "design x rate"),
             ("avg_latency_us", float(np.mean(sr.avg_latency_us)), "mean")],
            "lint_sweep", wall_s, device=DEV)
        if payload["manifest"]["device_platform"] != "gpu":
            raise AssertionError(f"[lint] manifest {payload['manifest']}")
        got = compile_gate.bench_counters(payload)
        want = {f"k1_launches.{n}": int(n == "epoch_scan")
                for n in K1_VARIANTS.values()}
        want.update({f"scan_calls.{n}": int(n == "epoch_scan")
                     for n in K1_VARIANTS.values()})
        if got != want:
            raise AssertionError(f"[lint] the manifest's counters {got}, "
                                 f"expected {want}")
        bench = tmp / "BENCH_lint_sweep.json"
        bench.write_text(json.dumps(payload))

        def gate(contract: dict) -> list:
            path = tmp / "contracts.json"
            path.write_text(json.dumps({
                "schema": compile_gate.CONTRACTS_SCHEMA,
                "contracts": {"lint_sweep": contract}}))
            return compile_gate.check_compile_gate(path, [bench])

        found = gate(dict(got))
        if found:
            raise AssertionError(f"[lint] the gate at the printed counts: "
                                 f"{[f.render() for f in found]}")
        for name, n in sorted(got.items()):
            found = gate(dict(got, **{name: n - 1}))
            if len(found) != 1 or found[0].code != "CC001" \
                    or f"`{name}`" not in found[0].message \
                    or "+1 over budget" not in found[0].message:
                raise AssertionError(f"[lint] the gate with `{name}` one "
                                     f"below: {[f.render() for f in found]}")
    log(f"[lint] (b) sweep of {sr.num_points} points on the card: counters "
        + ", ".join(f"{k} {v}" for k, v in sorted(got.items()) if v)
        + f" (the other {sum(not v for v in got.values())} 0); gated at "
          f"those counts: no finding; each of the {len(got)} counters one "
          f"lower: exactly one CC001 finding naming it")
    log(f"[lint] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return {"epoch_scan": 1}


# ------------------------------------------------------------------ phase 15

COLL_CELLS = (("gemma2-2b", "prefill_32k"), ("dbrx-132b", "decode_32k"),
              ("mamba2-130m", "train_4k"))
COLL_REDUCED = ("granite-3-8b", ShapeConfig("prefill_s64", 64, 4, "prefill"))


def reduced_cell(arch: str, shape, mesh_shape) -> "dryrun.Cell":
    cfg = get_config(arch)
    r = reduced(cfg)
    ov = {f.name: getattr(r, f.name) for f in dataclasses.fields(cfg)
          if getattr(r, f.name) != getattr(cfg, f.name)}
    return dryrun.build_cell(arch, shape, False, overrides=ov,
                             mesh_shape=mesh_shape)


def local_tree(tree):
    """A step's outputs with every ``DTensor`` as its local tensor."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(local_tree(v) for v in tree)
    return tree.to_local() if hasattr(tree, "to_local") else tree


def phase_collectives(smi: str):
    """Phase 15: the dry-run's partitioned count on this machine.  (a) three
    cells at full width on pod16x16 (a fake world of 256 on the host); (b)
    the CPU test's reduced cell, its collectives equal to the list derived
    by hand; (c) a (1, 1) mesh over a fake world of one on the card: the
    reduced granite-3-8b prefill step on CUDA tensors equals the plain
    step bit for bit and issues no collective.  Launches no kernel."""
    t_phase = time.perf_counter()
    counts_zero()
    for arch, shape in COLL_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, False, save=False, device=DEV)
        t = roofline.cell_terms(rec)
        counts_ = rec["collective_counts"]
        if tuple(counts_) != dryrun.COLLECTIVES or not counts_["all-gather"]:
            raise AssertionError(f"[collectives] (a) {arch} {shape}: {rec}")
        log(f"[collectives] (a) {arch} x {shape} x pod16x16 (fake world of "
            f"{rec['num_devices']}, full depth, {rec['microbatches']} "
            f"microbatch(es)): counts {counts_}; result bytes a device "
            f"{rec['collective_bytes']}; wire bytes a device "
            f"{rec['collective_wire_bytes']} (sum "
            f"{sum(rec['collective_wire_bytes'].values()):.4e}); counted in "
            f"{rec['collective_count_s']} s ({rec['count_s']} s for FLOPs "
            f"and bytes; {time.perf_counter() - t0:.1f} s in this phase: a "
            f"cell phase 13 counted is not counted again); roofline "
            f"compute {t['t_compute']:.4e} s, memory {t['t_memory']:.4e} s, "
            f"collective {t['t_collective']:.4e} s at "
            f"{LINK_BW / 1e9:.0f} GB/s NVLink, dominant "
            f"{t['dominant']} (H100 SXM data-sheet figures)  [{smi}]")

    arch, shape = COLL_REDUCED
    cell = reduced_cell(arch, shape, (2, 4))
    t0 = time.perf_counter()
    events, _ = dryrun.count_collectives(cell.step, cell.args, cell.mesh,
                                         cell.rules, cell.arg_specs)
    got = [tuple(e) for e in events]
    sys.path.insert(0, str(ROOT / "tests"))
    try:      # the one list tests/test_torch_collectives.py holds too
        want = importlib.import_module("hand_layouts").granite_prefill_by_hand()
    finally:
        sys.path.pop(0)
    if got != want:
        raise AssertionError(f"[collectives] (b) {arch} prefill on (2, 4) "
                             f"under torch {torch.__version__}:\n counted "
                             f"{got}\n by hand  {want}")
    res, wire, cnt = dryrun.collective_bytes(events)
    log(f"[collectives] (b) reduced {arch} prefill B=4 S=64 on a (2, 4) "
        f"fake world: {len(got)} collectives equal to the list derived by "
        f"hand (exact, torch {torch.__version__}): counts {cnt}, result "
        f"bytes {res}, wire bytes {wire}; {time.perf_counter() - t0:.2f} s")

    cell = reduced_cell(arch, shape, (1, 1))
    args = dryrun.real_args(cell, DEV, seed=0)
    with torch.no_grad():
        want_out = cell.step(*args)
    events, got_out = dryrun.count_collectives(
        cell.step, args, cell.mesh, cell.rules, cell.arg_specs,
        device_type="cuda")
    got_leaves = tree_flatten(local_tree(got_out))[0]
    want_leaves = tree_flatten(want_out)[0]
    if events or len(got_leaves) != len(want_leaves) or not all(
            g.device.type == "cuda" and torch.equal(g, w)
            for g, w in zip(got_leaves, want_leaves)):
        raise AssertionError(f"[collectives] (c) (1, 1) mesh on the card: "
                             f"{events} collectives; outputs equal: "
                             f"{[torch.equal(g, w) for g, w in zip(got_leaves, want_leaves)]}")
    if any(counts().values()):
        raise AssertionError(f"[collectives] launched kernels: {counts()}")
    log(f"[collectives] (c) reduced {arch} prefill on CUDA tensors as "
        f"DTensors over a (1, 1) cuda mesh (a fake world of one): no "
        f"collective, {len(got_leaves)} outputs (logits, cache) equal to "
        f"the plain step bit for bit; no kernel launched")
    log(f"[collectives] phase 15 took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------ main

# ------------------------------------------------------------------ phase 16

# sweep(shard=) over virtual shards of the card (sharding.virtual_lane_devices:
# one block of lanes a shard, a stream each): grid (b) of phase 7 over 4
# shards (270 designs a shard), 3 times, and over 7 (155 a shard, 5 pad
# designs); with chunk=135 over 4 (136 a chunk: 34 a shard, 8 pad designs);
# grid (c) over 4 (designs stream, 16 a shard) and its first 4 designs x 16
# policies over 8 (policies stream, 2 a shard); grid (d) over 4 (4 designs a
# shard); telemetry on small grids of LANES_TEL_JOBS jobs a lane
LANES_SHARDS, LANES_UNEVEN, LANES_POLICY_SHARDS, LANES_REPEATS = 4, 7, 8, 3
LANES_CHUNK, LANES_POLICY_DESIGNS = 135, 4
LANES_TEL_DESIGNS, LANES_TEL_JOBS = 8, 100
# the walls of grid (b) and grid (c) at etf: unsharded, as one block through
# the streamer (chunk = the lane count), and over these shard counts
LANES_WALL_SHARDS = (2, 4, 8)


def lanes_timed(fn):
    """``fn()`` with each K1 launch timed by CUDA events recorded on the
    stream it runs on, its wall, and the device memory it held at its peak.
    The launches' span (first start to last end) beside the sum of their
    times says what the streams overlapped."""
    events, orig = [], k1.epoch_scan

    def scan(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = orig(*args, **kw)
        ev[1].record()
        events.append(ev)
        return out

    k1.epoch_scan = scan
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        held = torch.cuda.max_memory_allocated() - held
    finally:
        k1.epoch_scan = orig
    ref = events[0][0]
    starts = [ref.elapsed_time(a) for a, _ in events]
    ends = [ref.elapsed_time(b) for _, b in events]
    k1_ms = [a.elapsed_time(b) for a, b in events]
    return out, dict(wall_s=wall, held_bytes=held, launches=len(events),
                     k1_ms_mean=sum(k1_ms) / len(k1_ms), k1_ms_sum=sum(k1_ms),
                     k1_span_ms=max(ends) - min(starts))


@torch.no_grad()
def phase_lanes(smi: str, grids: dict):
    """Phase 16: lane sharding.  ``sweep`` as a user calls it under
    ``virtual_lane_devices(n)`` (n shards of the card, each a contiguous
    block of lanes on a stream of its own), held bit for bit to phase 7's
    unsharded outputs of grids (b)-(d) (``grids``): every schedule output,
    energy and peak temperature; K1's launches (a block a scheduler value
    and chunk) and the shard, pad and chunk counters exact.  Then the walls,
    K1's time a launch, its overlap across the streams and the peak memory
    over 1, 2, 4 and 8 shards; the same over several cards where the
    machine has them.  Returns K1's launches by instantiation and the
    measured walls."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(K1_VARIANTS.values(), 0)
    devs, pads, chunks = (metrics.counter("scenario.shard.devices"),
                          metrics.counter("scenario.shard.pad_lanes"),
                          metrics.counter("scenario.sweep.chunks"))
    # phase 14's gate read a sweep with no virtual devices: on one card it
    # resolved to the unsharded path, so its counts are a launch a scheduler
    if torch.cuda.device_count() == 1 and \
            shardexec.resolve_mesh(None, lane_devices(DEV)) is not None:
        raise AssertionError("[lanes] one card without virtual devices shards")

    def main_path(n, base, axes, want: dict, what: str, pad: int, **kw):
        """The sweep as a user calls it over ``n`` virtual shards (``n`` =
        None: the process's own lane devices), K1's counts set to 0 just
        before and read just after; the shard and pad counters checked."""
        p0, c0 = pads.value, chunks.value
        counts_zero()
        n0 = sweep_scans()
        with virtual_lane_devices(n) if n else contextlib.nullcontext():
            sr = sweep(base, axes, **kw)
        torch.cuda.synchronize()
        assert_counts(want, what)
        if sweep_scans() - n0 != sum(want.values()):
            raise AssertionError(f"{what}: {sweep_scans() - n0} scans started, "
                                 f"{sum(want.values())} launches")
        shards = n or len(lane_devices(DEV))
        if (kw.get("shard") is not False and devs.value != shards) \
                or pads.value - p0 != pad:
            raise AssertionError(f"{what}: {devs.value} shards, "
                                 f"{pads.value - p0} pad lanes; expected "
                                 f"{shards}, {pad}")
        for name, k in want.items():
            launches[name] += k
        return sr, chunks.value - c0

    def equal(sr, want: dict, what: str, index=()):
        for name, arr in want.items():
            got, arr = getattr(sr, name), arr[index]
            if got.shape != arr.shape or not np.array_equal(got, arr):
                raise AssertionError(
                    f"{what}: {name} differs from the unsharded sweep "
                    f"({np.count_nonzero(got != arr)} of {arr.size} lanes)")

    def pad_of(lanes, n, chunk=None):
        width = shardexec.padded_width(lanes, chunk, n)
        return -(-lanes // width) * width - lanes

    # -- (a) grid (b) over 4 shards, 3 times; (b) over 7; (c) with chunk=
    g = grids["static_grid"]
    base, axes, out = g["base"], g["axes"], g["out"]
    D, n_sched = len(axes["design"]), len(axes["scheduler"])
    walls = []
    for k in range(LANES_REPEATS):
        t0 = time.perf_counter()
        sr, _ = main_path(LANES_SHARDS, base, axes,
                          {"epoch_scan": LANES_SHARDS * n_sched},
                          f"[lanes] (a) grid (b) run {k}", 0)
        walls.append(time.perf_counter() - t0)
        equal(sr, out, f"[lanes] (a) grid (b) over {LANES_SHARDS} shards, run {k}")
    log(f"[lanes] (a) grid (b) ({D} designs x {len(axes['seed'])} seeds, etf and met) "
        f"over {LANES_SHARDS} virtual shards of the card ({D // LANES_SHARDS} designs "
        f"a shard, a stream each), {LANES_REPEATS} runs: each = phase 7's unsharded "
        f"outputs bit for bit (schedule, energy, peak temperature), K1 "
        f"{LANES_SHARDS * n_sched} launches a run; walls "
        + ", ".join(f"{w:.3f}" for w in walls) + f" s  [{smi}]")
    pad = pad_of(D, LANES_UNEVEN) * n_sched
    t0 = time.perf_counter()
    sr, _ = main_path(LANES_UNEVEN, base, axes, {"epoch_scan": LANES_UNEVEN * n_sched},
                      "[lanes] (b) grid (b) uneven", pad)
    wall = time.perf_counter() - t0
    equal(sr, out, f"[lanes] (b) grid (b) over {LANES_UNEVEN} shards")
    log(f"[lanes] (b) grid (b) over {LANES_UNEVEN} shards "
        f"({shardexec.padded_width(D, None, LANES_UNEVEN) // LANES_UNEVEN} designs a "
        f"shard, {pad // n_sched} pad designs a scheduler): bit for bit, K1 "
        f"{LANES_UNEVEN * n_sched} launches, {wall:.3f} s")
    width = shardexec.padded_width(D, LANES_CHUNK, LANES_SHARDS)
    n_chunks = -(-D // width)
    pad = pad_of(D, LANES_SHARDS, LANES_CHUNK) * n_sched
    t0 = time.perf_counter()
    sr, got_chunks = main_path(LANES_SHARDS, base, axes,
                               {"epoch_scan": n_chunks * LANES_SHARDS * n_sched},
                               "[lanes] (c) grid (b) chunked", pad, chunk=LANES_CHUNK)
    wall = time.perf_counter() - t0
    if got_chunks != n_chunks * n_sched:
        raise AssertionError(f"[lanes] (c): {got_chunks} chunks, not "
                             f"{n_chunks * n_sched}")
    equal(sr, out, f"[lanes] (c) grid (b) chunk={LANES_CHUNK} over {LANES_SHARDS}")
    log(f"[lanes] (c) grid (b) at chunk={LANES_CHUNK} over {LANES_SHARDS} shards: "
        f"width {width}, {n_chunks} chunks and {pad // n_sched} pad designs a "
        f"scheduler, {n_chunks * LANES_SHARDS} K1 launches a scheduler, bit for bit, "
        f"{wall:.3f} s")

    # -- (d) grid (c) over 4 shards (designs stream); its first 4 designs x
    # 16 policies over 8 (policies stream), at grid (c)'s PE width
    g = grids["dtpm_grid"]
    dbase, daxes, dout = g["base"], g["axes"], g["out"]
    DD, G = len(daxes["design"]), len(daxes["governor_params"])
    t0 = time.perf_counter()
    sr, _ = main_path(LANES_SHARDS, dbase, daxes,
                      {"epoch_scan_dtpm": LANES_SHARDS * n_sched},
                      "[lanes] (d) grid (c)", 0)
    wall = time.perf_counter() - t0
    equal(sr, dout, f"[lanes] (d) grid (c) over {LANES_SHARDS}")
    paxes = dict(daxes, design=daxes["design"][:LANES_POLICY_DESIGNS])
    t0 = time.perf_counter()
    sr, _ = main_path(LANES_POLICY_SHARDS, dbase, paxes,
                      {"epoch_scan_dtpm": LANES_POLICY_SHARDS * n_sched},
                      "[lanes] (d) policies", pad_of(G, LANES_POLICY_SHARDS) * n_sched,
                      pad_pes=g["pad_pes"])
    pwall = time.perf_counter() - t0
    equal(sr, dout, f"[lanes] (d) {LANES_POLICY_DESIGNS} designs x {G} policies "
          f"over {LANES_POLICY_SHARDS}", (slice(None), slice(0, LANES_POLICY_DESIGNS)))
    log(f"[lanes] (d) grid (c) ({DD} designs x {G} ondemand policies, etf and met) "
        f"over {LANES_SHARDS} shards (designs stream, {DD // LANES_SHARDS} a shard): "
        f"bit for bit, {wall:.3f} s; its first {LANES_POLICY_DESIGNS} designs x {G} "
        f"policies over {LANES_POLICY_SHARDS} shards (policies stream, "
        f"{G // LANES_POLICY_SHARDS} a shard, padded to grid (c)'s {g['pad_pes']} PEs): "
        f"= those lanes of phase 7's grid bit for bit, {pwall:.3f} s")

    # -- (e) grid (d) over 4 shards (fault lanes: the design axis streams)
    g = grids["fault_grid"]
    fbase, faxes, fout = g["base"], g["axes"], g["out"]
    FD = len(faxes["design"])
    t0 = time.perf_counter()
    sr, _ = main_path(LANES_SHARDS, fbase, faxes,
                      {"epoch_scan_faults": LANES_SHARDS},
                      "[lanes] (e) grid (d)", pad_of(FD, LANES_SHARDS))
    wall = time.perf_counter() - t0
    equal(sr, fout, f"[lanes] (e) grid (d) over {LANES_SHARDS}")
    log(f"[lanes] (e) grid (d) ({len(faxes['faults'])} fault sets x {FD} designs x "
        f"{len(faxes['seed'])} seeds) over {LANES_SHARDS} shards "
        f"({FD // LANES_SHARDS} designs a shard): bit for bit, {wall:.3f} s")

    # -- (f) telemetry, replayed block by block on the block's stream
    tel_base = base.replace(trace=dataclasses.replace(base.trace,
                                                      num_jobs=LANES_TEL_JOBS))
    tel_cases = (
        ("static", tel_base, {"design": list(axes["design"][:LANES_TEL_DESIGNS]),
                              "seed": [0, 1]}, "epoch_scan"),
        ("ondemand", tel_base.replace(governor="ondemand"),
         {"design": list(daxes["design"][:LANES_SHARDS]),
          "governor_params": OBS_PARAMS}, "epoch_scan_dtpm"))
    notes = []
    for what, tbase, taxes, name in tel_cases:
        lanes = len(taxes["design"])
        plain, _ = main_path(None, tbase, taxes, {name: 1}, f"[lanes] (f) {what} plain",
                             0, telemetry=True, shard=False)
        t0 = time.perf_counter()
        sr, _ = main_path(LANES_SHARDS, tbase, taxes, {name: LANES_SHARDS},
                          f"[lanes] (f) {what}", pad_of(lanes, LANES_SHARDS),
                          telemetry=True)
        wall = time.perf_counter() - t0
        equal(sr, sweep_fields(plain), f"[lanes] (f) {what}")
        for a, b in zip(sr.telemetry.flat, plain.telemetry.flat):
            assert_telemetry_equal(a, b, f"[lanes] (f) {what}")
        notes.append(f"{what} {sr.num_points} lanes in {wall:.3f} s")
    log(f"[lanes] (f) sweep(telemetry=True) over {LANES_SHARDS} shards "
        f"({LANES_TEL_JOBS} jobs a lane): outputs and every lane's telemetry = the "
        f"unsharded sweep's bit for bit; " + ", ".join(notes))

    # -- (g) several cards, where the machine has them
    cards = torch.cuda.device_count()
    if cards > 1:
        t0 = time.perf_counter()
        sr, _ = main_path(None, base, axes, {"epoch_scan": cards * n_sched},
                          "[lanes] (g) cards", pad_of(D, cards) * n_sched)
        equal(sr, out, f"[lanes] (g) grid (b) over {cards} cards")
        log(f"[lanes] (g) grid (b) over the {cards} cards (a block and a stream "
            f"a card): bit for bit, {time.perf_counter() - t0:.3f} s")
    else:
        log("[lanes] (g) one card: lane sharding over several cards (a block a "
            "card, the shared inputs copied to each) was not run")

    # -- (h) the walls over 1, 2, 4 and 8 shards, grids (b) and (c) at etf
    measured = {}
    for tag, gbase, gaxes, gout, name in (
            ("static_grid", base, axes, out, "epoch_scan"),
            ("dtpm_grid", dbase, daxes, dout, "epoch_scan_dtpm")):
        eaxes = {k: v for k, v in gaxes.items() if k != "scheduler"}
        ebase = gbase.replace(scheduler=gaxes["scheduler"][0])
        lanes = len(eaxes["design"])
        rows = {}
        modes = [("unsharded", None, 1, dict(shard=False)),
                 ("1 block", None, 1, dict(shard=False, chunk=lanes))] + [
            (f"{n} shards", n, n, {}) for n in LANES_WALL_SHARDS]
        for label, n, launched, kw in modes:
            (sr, _), rec = lanes_timed(lambda: main_path(
                n, ebase, eaxes, {name: launched}, f"[lanes] (h) {tag} {label}",
                pad_of(lanes, n) if n else 0, **kw))
            equal(sr, gout, f"[lanes] (h) {tag} {label}", (0,))
            rows[label] = rec
        measured[tag] = rows
        log(f"[lanes] (h) {tag} at etf ({lanes} designs, {sr.num_points} points; "
            "= phase 7's etf lanes bit for bit each): "
            + "; ".join(f"{label}: {r['wall_s']:.3f} s, K1 {r['launches']} x "
                        f"{r['k1_ms_mean']:.3f} ms (sum {r['k1_ms_sum']:.3f}, span "
                        f"{r['k1_span_ms']:.3f} ms), peak {r['held_bytes'] / 2 ** 20:.1f} MiB"
                        for label, r in rows.items())
            + f"  [{smi}]")
    log(f"[lanes] phase 16 took {time.perf_counter() - t_phase:.1f} s; K1 launches by "
        f"instantiation {launches}")
    return launches, measured


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--verbose", action="store_true",
                    help="print the compiler's per-kernel resource usage")
    ap.add_argument("--profile", action="store_true",
                    help="add an instrumented second pass of each full serve")
    args = ap.parse_args()
    t_start = time.perf_counter()
    torch.cuda.set_device(DEV)
    # full-precision f32 products everywhere (the tolerances assume them)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_card()
    phase_build(args.verbose)
    gen = torch.Generator(device=DEV).manual_seed(0)
    measured = {"flash_attention": phase_flash(gen),
                "decode_attention": phase_decode(gen),
                "ssd_scan": phase_ssd(gen, args.profile),
                "rg_lru": phase_rglru(gen),
                "thermal_grid": phase_thermal()}
    for name, entries in phase_nocap_kernels(gen).items():
        measured[name]["no_softcap_shapes"] = entries
    torch.cuda.empty_cache()
    for arch in PROMPT_LENS:
        phase_reduced(arch)
    for arch in PROMPT_LENS:
        phase_reduced_bf16(arch)
    launches = {name: 0 for name in KERNELS} | {"thermal_grid": 0}
    for arch in PROMPT_LENS:
        for name, n in phase_full(arch, smi, args.profile).items():
            launches[name] += n
    t_scn = time.perf_counter()
    k1_measured, k1_launches = phase_scenario(smi)
    measured.update(k1_measured)
    launches.update(k1_launches)
    log(f"[scenario] phase 6 took {time.perf_counter() - t_scn:.1f} s")
    measured["epoch_scan_dtpm"]["seconds_grid"] = phase_k1_seconds(smi)
    sweep_launches, sweep_measured, sweep_outputs = phase_sweep(smi)
    for name, n in sweep_launches.items():
        launches[name] += n
    for name, n in phase_dse(smi).items():
        launches[name] += n
    for name, n in phase_obs(smi).items():
        launches[name] += n
    for name, n in phase_encdec(smi, gen).items():
        launches[name] += n
    for name, n in phase_moe(smi).items():
        launches[name] += n
    phase_train(smi, gen)
    for name, n in phase_layouts(smi).items():
        launches[name] += n
    for name, n in phase_lint(smi).items():
        launches[name] += n
    phase_collectives(smi)
    lanes_launches, lanes_measured = phase_lanes(smi, sweep_outputs)
    for name, n in lanes_launches.items():
        launches[name] += n
    measured["epoch_scan"]["lanes_static_grid"] = lanes_measured["static_grid"]
    measured["epoch_scan_dtpm"]["lanes_dtpm_grid"] = lanes_measured["dtpm_grid"]
    # the design-lane launches of phase 7 beside K1's phase-6 numbers
    measured["epoch_scan"]["sweep_static_grid"] = sweep_measured["static_grid"]
    measured["epoch_scan_dtpm"]["sweep_dtpm_grid"] = sweep_measured["dtpm_grid"]
    measured["epoch_scan_faults"]["sweep_fault_grid"] = sweep_measured["fault_grid"]

    sources = {"flash_attention": "src/repro/kernels/flash_attention.py:82",
               "decode_attention": "src/repro/kernels/decode_attention.py:62",
               "ssd_scan": "src/repro/kernels/ssd_scan.py:66",
               "rg_lru": "src/repro/kernels/rg_lru.py:42",
               # no Pallas kernel: jnp under vmap
               "thermal_grid": "src/repro/dse/thermal_jax.py:145"}
    # K1's four instantiations, one source
    sources.update(dict.fromkeys(K1_VARIANTS.values(),
                                 "src/repro/core/simkernel_jax.py:321"))
    # K1's fault-free kernels come from epoch_scan.cu, the fail-stop ones from
    # epoch_scan_faults.cu (both include epoch_scan.cuh)
    files = {"epoch_scan_dtpm": "epoch_scan", "epoch_scan_dtpm_faults": "epoch_scan_faults"}
    kernels = [{"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{files.get(name, name)}.cu",
                "replaces": sources[name], "launches": launches[name],
                **measured[name]} for name in sources]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
