#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero without the
result line:

1. environment: a CUDA card is required; prints its name and power
   limit; TF32 is switched off so the plain versions run in full float32;
2. build: every kernel source under ``src/repro_torch/kernels/csrc`` (K1,
   K2, K3, K4, K5 and K6, K7, K8, K9, and K1w / K4w) is compiled with
   ``nvcc`` (one process per source, in parallel), with ptxas's registers
   and spills printed; then a line per kernel library counting, with
   ``cuobjdump --dump-sass``, the tensor-core ``HMMA`` instructions of
   each kernel function in it: the bf16 K8 (``k8_flash_mma_kernel`` and
   ``k8_flash_mla_kernel``) and K7's GEMM (``k7_gemm_kernel``) must have
   some, the float32 K8
   (``k8_flash_kernel``) none; for K1, K2 and K4 the ``FFMA`` and ``LDS``
   instructions of each kernel function and of its densest phase between
   two barriers, with their ratios; for K9 the ``MUFU`` (expf), ``FFMA``
   and ``LDS`` per step of a chunk's unrolled steps and the ``LDGSTS``
   (cp.async) of each function, which must have both; K4's read-noise
   instantiations must have ``LDGSTS``;
3. K1 vs its plain version on the card, at the serving path's shapes,
   in two drive modes, and at a width whose weights need more than 48 KB
   of shared memory; error relative to each trajectory's peak <= 1e-4;
   each trajectory bitwise identical at one twin per block and at four;
4. the serving path: a seeded He-init Lorenz96 twin is saved with the
   port's ``save_twin`` and served by ``serve_fleet`` on the ``fused_cuda``
   backend, 2 request batches of 1024 twins x 200 RK4 steps; launch
   counts are zeroed just before and read just after; the result is held
   against the same requests served on the digital backend (<= 1e-4);
5. K1 timing with CUDA events at the fleet request: kernel, plain
   version, the card's bound, microseconds per RK4 step and the launch
   geometry;
6. K2 vs its plain version on the card at the Lorenz96 training shapes
   (paper and CI windows), the HP training shape (per-twin drive), the
   fleet shape and the 128-wide case; each gradient within 1e-4 of its
   peak, and two calls bitwise identical; dy0 bitwise identical at one
   twin per block and at four, the gradients there within 1e-4 too;
7. the training paths, each with the K1 and K2 counts zeroed just before
   and read just after: ``train_hp_twin(200, 250, "fused_cuda")`` to the
   HP gates of ``tests/test_twins.py``; 40 HP steps on fused_cuda vs the
   digital adjoint (loss histories <= 1e-3 rel; exactly 40 K1 and K2
   launches on fused_cuda, none on digital); ``train_l96_twin`` at
   the CI budget to the Lorenz96 gates; gradient steps per second of
   each trajectory phase;
8. K1 and K2 timing with CUDA events at every shape a main path launches
   them at: the fleet request (1024 x 200), HP training (9 x 50, one drive
   per twin), Lorenz96 training (14 x 60, 29 x 60) and P4's 8 x 200:
   kernel, plain version (for K2 autograd through
   ``fused_node_rollout_ref``), the card's bound, microseconds per RK4
   step and the launch geometry;
9. K3 (the counter noise stream) on the card against its plain version
   on a 513 x 512 block at two salts, one above 2^31: hash bits, uniforms
   and stuck masks bitwise, normals within 1e-6; K3's batched stuck masks
   (one launch) bitwise their plain version and the per-array fill at P2's
   programming arrays and at a ragged (100, 70) + (513, 512) pair; K3's
   hardware-aware write path against ``ref.hw_write_path_ref`` at HP
   (2->14->14->1, 2 draws), Lorenz96 (6->64->64->6, 4 draws) and scorecard
   (6->512->512->6, 2 draws) widths, the calibrated spec, 1% stuck cells
   resampled per (step, draw), the calibrated drift over 1000 reads, at
   step 0 and at a step whose salts wrap past 2^32, as w_hw and as the
   straight-through value: noisy within 1e-6 of each layer's peak,
   noise-free bitwise (levels, stuck cells, drift), one launch a call,
   repeats bitwise, a single layer's launch bitwise the batched one;
10. K4 (fused analogue rollout) against its plain version: the Lorenz96
   fleet shape (1024 x 200, 6->64->64->6) with float storage and clean
   reads, the same with uint8 storage, read noise 0.02, 1% stuck cells
   and drift, the HP shape with per-twin drives and read noise, and the
   HP shape at P1's settings (shared drive, programming and read noise)
   for one twin and for 100, P1's quantisation-only rollout, and at
   run-time widths the noisy faulty uint8 case at 6->128->128->6 and
   6->64->64->64->6 and a clean float case with drift at 6->96->96->6
   (<= 1e-4 of the peak); two calls bitwise equal; each trajectory bitwise
   identical at one twin per block and at four; float64 conductances
   bitwise the float32 ones; the noisy rollout split at step 120 and
   resumed with ``step_offset=120`` bitwise equal to the unsplit one, and
   so is the same rollout run in time chunks of 64 steps; the read-noise
   pre-pass bitwise equal to its plain version
   (``ref.fused_analogue_noisy_pairs_ref``) at the fleet's uint8 stuck
   arrays from step 0 and from a step whose salts pass 2^31, and at P1's
   float arrays;
11. K7 (crossbar VMM) against its plain version at M=1024, K=513, N=512
   and at the ragged (100, 70, 50): float and uint8 storage, clean reads,
   read noise, stuck cells (<= 1e-4 of the peak), each case repeated
   bitwise with one read pass per call, and the read pass
   (``crossbar_vmm.effective_g``) bitwise equal to
   ``ref.crossbar_effective_g``; float64 conductances bitwise the float32
   ones;
12. the analogue paths, each with the K1, K3, K4 (rollout and read-noise
   pre-pass) and K7 counts zeroed just before and read just after: P1,
   both analogue gates of ``tests/test_twins.py`` for the HP twin of
   phase 7 on ``analogue_fused_cuda`` (one K4 launch per rollout, one
   pre-pass for the noisy one) and on ``analogue``; P2, the Lorenz96
   fleet served by ``serve_fleet`` on ``analogue_fused_cuda``, 2 batches
   of 1024 x 200 (exactly 2 K4 launches and no pre-pass; the clean
   unquantised spec within 1e-4 of ``fused_cuda``; with the noisy faulty
   spec two serves bitwise equal, one pre-pass per batch, one K3 batched
   mask launch per programming and no K3 fill); P3,
   ``AnalogueBackend`` with uint8 storage at the scorecard width
   6->512->512->6 rolling out 1024 twins x 50 steps (exactly 200 K7
   GEMM and 200 read-pass launches, within 1e-4 of the same path on K7's
   plain version); P6, hardware-aware training of the HP twin,
   ``train_hp_twin(seed=42, 200, 250, "fused_cuda", hw_aware=
   HwAwareConfig(spec=spec_from_calibration(...), k_draws=2))`` (exactly one
   K3 write-path launch and two K1 and K2 launches a step, no K3 fill or
   mask launch; a finite loss history that falls), 40 steps from the same
   weights twice (bitwise) and with the plain write path swapped in
   (<= 1e-3 rel), clean beside them (the hardware-aware / clean step
   ratio), 10 steps on ``analogue_fused_cuda`` (step-keyed, not the clean
   loss), a ``FusedAnalogueCudaBackend(trainable=True)`` rollout's
   gradients (finite, non-zero; ``trainable=False`` detached), the write
   path's host cost within a step with the kernel and with the plain
   version, and the clean and hardware-aware weights deployed on
   ``analogue_fused_cuda`` (sine MREs printed, not a gate);
13. K3, K4 and K7 timing with CUDA events: kernel, plain version, the
   card's bound, and for K7 one ``torch.matmul`` on the pre-combined pair;
   K3's fill, its batched masks at P2's programming and its write path at
   the HP and Lorenz96 step shapes, each with its wrapper's host time per
   call (and the write path's share of P6's step);
   K4 at the fleet request clean and noisy faulty and at P1's HP shapes
   (one twin clean and noisy, 100 twins noisy), a noisy rollout's
   pre-pass also alone;
14. K5 (soft-DTW forward with R, and hard DTW) and K6 (the E-matrix
   backward) on row-major costs, through ``softdtw_rowmajor(_bwd)`` and
   through the diagonal-layout adapters ``softdtw_wavefront(_bwd)``,
   bitwise equal to their plain versions (answer, R, hard answer, E) at
   seven (B, n, m) shapes, the two Lorenz96 training shapes (29, 61, 61)
   and (8, 201, 201) among them, at the row limit (2, 4096, 33) and with
   planted in-matrix costs at or above BIG_CUT, gamma 0.1 and 0.7;
   repeats bitwise; ``ops.soft_dtw``'s value and gradient against
   autograd through the reference DP ``losses.soft_dtw_batch`` at (2, 40,
   60, d=2), gamma 0.5 (<= 1e-4 of the peak);
15. the soft-DTW training path P4: from phase 7's Lorenz96 weights on the
   paper's 1800-point training window, ``train_twin(loss=CONFIG.loss,
   gamma=0.1, backend="fused_cuda")`` for 40 steps at segment length 60
   (29 segments) and 40 at 200 (8), the K1, K2, K5 and K6 counts zeroed
   before and checked after each (exactly one of each per step); the
   loss history's ends, interpolation and short extrapolation L1; the
   same 10 steps at length 60 on fused_cuda and on digital (loss
   histories <= 1e-3 rel, no K5/K6 on digital); ``l96_lyapunov_info()``
   with its wall time;
16. K5 and K6 timing with CUDA events at the two training shapes:
   kernel, plain version, the bytes bound and the chain bound (n+m-1
   steps of each kernel's dependent step, timed on one warp by a probe
   built from ``csrc/softdtw.cu``'s own cell, with its SASS opcodes a
   step; the same library first holds the kernels' ``sdtw_log`` against
   logf at every float of [1, 3] and fails on any difference), the
   kernels' share of a P4 step, the whole soft-DTW term (forward and
   backward) per call on the host clock and its device kernels per call
   in a profiler trace beside an estimate of the count with the
   diagonal layout and the gather of E that the first port ran around
   the same kernels, and a ``torch.profiler`` trace of 5 P4 steps (device busy share, the
   kernels by device time);
17. K8 (causal GQA flash attention) and K9 (the selective-SSM scan)
   against their plain versions: K8 at the JAX package's three test
   shapes, the Jamba prefill's (B, H, Hkv, S, d) = (2, 32, 8, 4096,
   128) and a ragged (1, 32, 8, 4097, 128), in float32 (<= 2e-5 of the peak) and bf16 (<= 2e-2, and per
   element within 2^-8 |want| + 2e-5 of the peak of the plain version's
   float32 output before its cast), on the model's (B, S, H, d) layout; K9 at JAX's three test shapes and
   (B, S, DI, N) = (2, 4096, 8192, 16) (<= 1e-5 for y and the final
   state); repeats bitwise; whether the final state is bitwise the plain
   version's (printed, not a gate);
18. P5, Jamba v0.1 served at full width with its depth cut from 32
   layers to 8 (one period: 7 Mamba mixers, 1 GQA, 4 MoE): in float32
   at batch 1, ``make_prefill_step`` on (1, 4097) tokens through the
   kernels (exactly 1 K8 and 7 K9 launches) and again with
   ``ops.flash_attention``/``ops.ssm_scan`` swapped to their plain
   versions here (last logits <= 1e-3 of the peak, ssm states <= 1e-4;
   MoE top-2 choices that differ, printed); then in bf16 ``unembed``'s
   float32-output product against the widened one (<= 1e-4), two prefill
   batches of (2, 4097) (1 K8 and 7 K9 each, finite f32 logits, caches
   of ``init_cache``'s shapes) and ``greedy_generate`` of 16 tokens from
   a 16-token prompt (no K8 or K9 launch, finite logits);
19. K8 and K9 timing at P5's shapes with CUDA events (kernel, plain
   version, the card's bound, for K8 ``scaled_dot_product_attention``
   and the achieved TFLOP/s, for K9 the three bounds: bytes, FP32 operations and expf at the special-function
   rate), P5's prefill tokens/s and decode
   ms per token, and a ``torch.profiler`` trace of one bf16 prefill (K8
   and K9's share of device time, the top five kernels, idle share);
20. P7, streaming serving: the Lorenz96 fleet of phase 4 (6->64->64->6,
   the same seeded weights) through ``StreamingFleetServer`` (hot slab
   2048 rows, batches of 1024, windows of up to 200 steps in multiples
   of 8) with ``REPRO_STORE_AUDIT=1`` (the store's invariants after
   every pump): (a) on ``fused_cuda``, a Poisson trace (16384 requests
   over 4096 twins, 8-64 steps) then a ragged one (8192 requests, up to
   400 steps, split across windows): every request served, conservation,
   exactly one K1 launch per pump, K1 within 1e-4 of its plain version
   on one recorded pump's inputs at every window length, and every
   twin's stitched trajectory bitwise one uninterrupted K1 rollout from
   its y0; (b) on
   ``analogue_fused_cuda`` with P2's noisy faulty spec under
   ``ServingSLO(max_rel_error=0.5)``: the Poisson trace served by the
   primary tier, one probe per 8 pumps, one K4 rollout and pre-pass per
   pump and probe, K4 (read noise, offset 0) within 1e-4 of its plain
   version on each served window length's recorded inputs, two K3 mask
   launches when the tiers are programmed and none while serving; the
   fleet request split at step 120 through a
   ``TwinStateStore`` and resumed at offset 120 bitwise the unsplit K4
   rollout; the clean unquantised spec streamed within 1e-4 of (a);
   (c) an array with 30% stuck cells demoted to digital at the first
   probe with every request served and none quarantined, and two
   injected transient faults absorbed by two retries; (d) printed, not
   gated: pumps/s and twin-steps/s per trace, page-ins and evictions,
   the host ms of each pump stage (``_assemble``, ``store.fetch``, the
   solve, ``_commit_batch``, the audit), K1's CUDA-event ms per pump at
   the pumps' shapes, ``FleetServer`` on the same 1024 x 200 request,
   and a ``torch.profiler`` trace of 10 pumps (device idle share).
21. P8, crash recovery: phase 20's Poisson stream (4096 twins, hot slab
   2048, batches of 1024, windows up to 200 steps) with the write-ahead
   journal (every acknowledged append fsync'd) and a snapshot every 4
   pumps, in a temporary directory on the machine's disk, on
   ``fused_cuda`` (K1) and on P2's noisy faulty ``analogue_fused_cuda``
   (K4 + K3, no SLO).  The crash-free durable run is bitwise phase 20's
   run without durability (states, steps, completions, order); then one
   crash at each of the five kill points, its hit half the kill point's
   executions in the crash-free run (printed), ``recover(...,
   device=cuda)`` and the rest of the trace fed again: every twin's state
   and step, every delivered completion's trajectory and the completion
   set bitwise the crash-free durable run; K1 (or K4 and its pre-pass)
   launched during ``recover`` exactly once per replayed commit record
   (counted from the journal), K3 masks once for the programming of the
   analogue tier, and the replayed windows within 1e-4 of the kernel's
   plain version.  Printed, not gated: journal records and bytes, host
   ms per pump of the journal (records plus the group commit's fsync)
   with ``fsync=True`` and with ``fsync=False``, acknowledged appends'
   ms, snapshot ms and bytes, recover ms split into journal read, build
   and programming, snapshot load and replay (ms per replayed commit),
   and pumps/s with durability on beside the same stream without it.
22. P9, the training engines: five training paths from the same params
   and seed, HP on fused_cuda (9 x 50, K1 + K2), Lorenz96 on fused_cuda
   (14 x 60), P4's ``l1+softdtw`` at 29 x 60 and 8 x 200 (K1, K2, K5,
   K6), P6's hardware-aware HP step (the K3 write path + K1/K2 per draw)
   and HP on the digital adjoint (no kernel of the port), each 45 steps
   three ways: the eager loop ``trainer.fit_eager`` (the oracle), the
   per-step CUDA graph (``fit_per_step``) and the chunk graphs
   (``fit(scan_chunk=37)``: graphs of 8 and 5 steps); loss histories and
   final params bitwise the oracle's, launches equal to the per-step
   counts times 45 on all three runs, the graphs captured and replayed;
   printed, not gated: ms a step of each (host clock to a device sync,
   and CUDA events), steady state for the two graphs, and a
   ``torch.profiler`` trace of one replayed 8-step chunk (kernels and
   copies a step, device busy ms, the card's idle share of the traced
   wall and of the device span, and 1 - busy / the untraced chunk's
   time: tracing slows a replay, so the traced shares overstate it).
23. P10, the paper's energy scorecard on the card: K1w and K4w (the wide
   cluster kernels of ``csrc/fused_wide.cu``, 8-CTA clusters) at the
   scorecard's Lorenz96 twin 6->512->512->6, at (1, 1800) and at P3's
   (1024, 50): K1w within 1e-4 of its plain version and bitwise on
   repeat; K1w forced at 6->64->64->6 within 1e-5 of the resident K1 (one
   and four twins per cluster); K4w clean float, noisy faulty (uint8, read
   noise 0.02, 1% stuck, drift) and clean uint8 within 1e-4 of its plain
   version and bitwise on repeat; clean uint8 K4w at P3's deployment
   within 1e-4 of P3's ``AnalogueBackend`` run on K7; then
   ``scorecard.scorecard()`` on the four backends (the main path): every
   anchor within ``ANCHOR_TOL``, each row's counted MACs equal to the
   same rollout's count on the host CPU (a process of its own, run beside
   the card's work), the digital row's equal to ``model_macs``, exactly
   one K1, K1w, K4 and K4w launch (Lorenz96 on K1w / K4w, HP on the
   resident kernels), no K7.  Printed, not gated: the rows, the clusters
   the card holds at once, CUDA-event ms of K1w and K4w (clean, noisy) at
   both shapes beside their plain versions' ms, their bounds (operations
   or bytes) and chain bounds (4 T evaluations x what the exchange of the
   last layer's partials and the cluster and block barriers of one
   evaluation cost, from a probe kernel's cycles; the resident K1 and K1w
   forced at 6->64->64->6 over 1800 steps beside them), and the
   1800-step rollout's wall ms on ``fused_cuda``, ``analogue_fused_cuda``,
   ``analogue`` and ``digital``.
24. P11, the paper's comparisons and the adaptive solver on the card:
   (a) phase 7's HP twin rebuilt with ``method="dopri5"`` on ``digital``
   and on the noise-free crossbar simulator over the first 100
   intervals of its sine grid (JAX's gate: atol 5e-4, rtol 1e-4), the
   digital result within 1e-3 of the peak of RK4 at 8 sub-steps, and
   ``fused_cuda`` refusing dopri5 for a rollout and for ``train_twin``,
   naming RK4; (b) P3's deployment (uint8 ``AnalogueBackend``,
   6->512->512->6, 1024 twins over 50 intervals) under dopri5 with the
   K7 counts zeroed just before: K7's GEMM and read pass each launched
   exactly 7 times per iteration of the adaptive loop (its iterations
   and the accepted and rejected steps per twin printed), the result
   within 1e-4 of the peak of the same run on K7's plain version (both
   runs' iterations printed); a noisy HP fleet of 8 twins under dopri5
   over 15 intervals, each row within 1e-6 of the peak of its own
   single-twin noisy rollout; (c) Fig. 3j:
   ``train_hp_resnet(train_steps=250)`` through the training engines
   (graphs captured and replayed, ms a step), ``eval_hp_resnet`` on the
   four drives beside phase 7's ``eval_hp_twin``: the NODE's mean MRE
   under half the ResNet's; (d) Fig. 4g: ``eval_l96_baseline`` for the
   LSTM, GRU and RNN at ``P11_L96_STEPS`` steps on phase 7's Lorenz96
   data, a finite falling loss history each, interpolation and
   extrapolation L1 printed beside phase 7's ``eval_l96_twin`` (not
   gated), ms a step; the phase's wall time.
25. P12, the bf16 precision policies ("bf16_f32acc" and "bf16"): K1
   against its plain version on the card at the fleet request (1024 x
   200, 6->64->64->6), Lorenz96 training (14 x 60) and HP training (9 x
   50, one drive per twin) at the planner's rounding chunk and at 7 steps;
   K2's gradients against the plain VJP at (29, 60) and (9, 50), each at
   the backward planner's chunk and at 7 steps, the replayed states in
   shared memory bitwise the same in the device-memory scratch; K5 / K6 on
   bf16 costs at
   (29, 61, 61) and (8, 201, 201), bitwise the plain DP on the same
   rounded costs, planted padding cells still invalid; K1 within
   ``P12_K1_TOL`` of the peak with at least ``P12_K1_SHARE`` of its
   elements bitwise, K2 within ``P12_K2_TOL``, each limit shown to catch
   its controls (plain versions that skip a rounding the policy asks for,
   or K2's chunk replay) on the same inputs; a resume from a chunk start
   and the forward inside autograd bitwise; then the main paths with the
   counts zeroed just before and read just after: one ``serve_fleet``
   batch per policy (one K1 launch of that policy, bf16 out, within K1's
   limits of the same serve on the plain versions, which the f32 serve
   misses), ``train_hp_twin(200, 250)`` on
   ``FusedCudaBackend(precision="bf16_f32acc")`` through the engines
   (250 K1 and K2 launches of that policy; loss and sine MRE beside
   phase 7's, the HP gates asserted as ``P12_HP_GATES`` says), 40 HP steps
   on the kernels against the eager loop on the plain versions (loss
   histories within ``P12_HIST_TOL`` rel a step, which the f32 history
   and one without K2's chunk replay miss), and ``P12_P4_STEPS`` steps of the Lorenz96
   ``l1+softdtw`` fit per policy (K1, K2, K5 and K6 on bf16 costs once a
   step); CUDA-event means of K1, K2, K5 and K6 under each policy beside
   float32 at the same shapes, the plain versions and the bounds (bytes
   at the bf16 itemsizes, K1's and K2's products at the bf16 tensor-core
   peak).
26. P13, the twin mesh (``launch/mesh.py``, ``shard_rollout_batch``): the
   Lorenz96 fleet of phase 4 (6->64->64->6, 1024 x 200) served from a
   ``save_twin`` checkpoint, each path with the K1, K3 and K4 counts
   zeroed just before and read just after: (a) ``serve_fleet(mesh=
   make_twin_mesh())`` (one shard per card) bitwise ``serve_fleet``
   without a mesh, one K1 launch per request and card; (b) a mesh of 4
   shards on the one card (a ``Mesh`` naming it 4 times) serving 1021
   twins (padded to
   1024, 256 rows a shard): 4 K1 launches per request, within 1e-4 of
   the peak of (a) (bitwise printed) and each shard's launch within 1e-4
   of K1's plain version on its recorded inputs; (c) the same mesh through
   ``rollout_batch(mesh=, precision="bf16_f32acc")``: 4 K1 launches of
   that policy, within phase 25's K1 limits of the unsharded bf16 request
   and of the plain version over the shards; (d) ``FleetServer(mesh=,
   slo=ServingSLO(0.5))`` on P2's noisy faulty ``analogue_fused_cuda``,
   its weights from ``load_twin(shardings=fleet_param_shardings(...))``:
   2 K3 mask launches when it is built, as many as the unsharded server's
   and none while serving (programmed once, copied to the shards); the
   masks K3 drew while both servers were built bitwise its plain version
   on the same arguments, and every tier's program as each shard holds
   it bitwise the unsharded server's, tensor for tensor; one K4
   and pre-pass per shard beside the probe's, within 1e-4 of the
   unsharded server's request (bitwise printed) and a shard within 1e-4
   of K4's plain version; (e) ``StreamingFleetServer`` on
   ``FusedCudaBackend(precision="bf16_f32acc")``, a Poisson trace of 1024
   requests over 256 twins in batches of 256: every completion finite
   float32, one K1 launch of that policy per pump, and the same stream on
   the plain K1 within phase 25's K1 limits.  Printed: the batch wall
   times of (a)-(d) and the stream's, K1 per shard and on the whole 1024
   (CUDA events), K4 per shard, their plain versions and bounds.
27. P14, DeepSeek-V2-Lite served at full width (d_model 2048, 16 MLA
   heads of head_dim 128 + rope 64 over a 512-wide latent, 64 routed + 2
   shared experts top-6, vocab 102400): (a) in float32 at batch 1 with
   its depth cut from 27 layers to 4 (1 dense + 3 MoE),
   ``make_prefill_step`` on (1, 4097) tokens through the kernels (one
   K8 launch a layer, at (d, dv) = (576, 512)) and again with
   ``ops.flash_attention`` swapped to its plain version (last logits <=
   1e-3 of the peak, the ckv / k_rope caches <= 1e-4; MoE top-6 choices
   that differ, printed); (b) in bf16 at its full 27 layers, two prefill
   batches of (2, 4097) (27 K8 launches each, finite float32 logits,
   caches of ``init_cache``'s shapes) and ``greedy_generate`` of 16
   tokens from a 16-token prompt (no K8 launch, finite logits); (c) K8
   alone at (B, H, Hkv, S, d, dv) = (2, 16, 1, 4096, 576, 512) in bf16
   and float32, and at the smoke configs' (48, 32) at S = 97 and 4096,
   against its plain version at phase 17's limits (bf16 per element
   within the rounding bound too), timed with CUDA events beside its
   bound, the plain version and ``scaled_dot_product_attention`` (the
   backend PyTorch's dispatcher picks, printed).
28. P15, continuous depth, xLSTM and the torch examples, on Llama-3-8B
   at full width (d_model 4096, 32 heads, 8 kv heads of head_dim 128,
   d_ff 14336, vocab 128256) with ``ode_depth = 4``: one weight-tied layer
   integrated over depth 32 in 4 RK4 steps (16 block evaluations, each
   one K8 launch at phase 17's (2, 32, 8, 4096, 128)).  First, on a quiet
   card: (b) two bf16 prefills of (2, 4097), ms and tokens/s, (c) exactly
   16 K8 launches each, finite float32 logits and no stack cache; (d) a
   profiler trace of one prefill (idle share, K8's share of device time);
   (e) ``decode_step`` raising ``NotImplementedError("ODE-depth mode is
   train/prefill only")`` as the JAX package's does; xlstm-125m at full
   width (12 layers, d_model 768, 4 heads, an sLSTM every 6th layer; no
   kernel on its path): two bf16 prefills of (2, 4097) with the sLSTM
   layers' share by host clock around ``slstm_prefill`` and a greedy
   decode of 16 tokens from a 16-token prompt (31 steps).  Then the six
   ``examples/torch`` drivers start together as processes on the card
   (``hp_memristor_twin.py --fast``, ``lorenz96_twin.py --fast
   --no-baselines``, ``fleet_serving_sharded.py --smoke``, the other three
   at their own budgets), and beside them run (a) a float32 Llama prefill
   of (2, 4097) tokens through the kernels (16 K8 launches) and again with
   ``ops.flash_attention`` swapped to its plain version (none), last
   logits <= 1e-3 of the peak, and xlstm-125m's prefill of (1, 1025) on
   the card against the same call on the CPU (float64 compute within
   1e-4 of the peak; float32 on each beside the float64 answer, the
   card's within 2x the CPU's distance).  Each example exits 0 within
   300 s; the quickstart's analogue MRE < 0.3, the backend matrix's
   ``digital`` and ``fused_cuda`` MREs within 1e-4 of each other, the
   sharded example's own parity assert and "OK"; each one's wall time
   printed.  Their kernel launches are their own processes' and are not
   counted here.

Training (phases 7, 12, 15, 16, 22, 24 and 25) runs through the training engines
by default, as the JAX package's does through its scan engine: on the
card every step is a replay of a CUDA graph, and the engines add what a
graph launches to the kernels' launch counters at every replay (its
capture and the warm-up step before it, on copies that are thrown away,
count nothing), so each check of a count per step keeps its meaning.

The second-to-last line is the ``{"kernels": [...]}`` JSON record, the
last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, get_smoke, param_count  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.configs.lorenz96_twin import CONFIG as L96_CONFIG  # noqa: E402
from repro_torch.core.analogue import (AnalogueSpec,  # noqa: E402
                                       drift_from_calibration,
                                       spec_from_calibration)
from repro_torch.core import faults as core_faults  # noqa: E402
from repro_torch.core import ode, scorecard  # noqa: E402
from repro_torch.core.backends import (AnalogueBackend, DigitalBackend,  # noqa: E402
                                       FusedAnalogueCudaBackend,
                                       FusedCudaBackend, resolve_backend,
                                       uniform_dt)
from repro_torch.core.faults import (FAULT_SALT_BASE, FaultModel,  # noqa: E402
                                     StuckCells, fault_salt,
                                     make_fault_model)
from repro_torch.core.losses import _pairwise_dist, mre, soft_dtw_batch  # noqa: E402
from repro_torch.core.node import mlp_init  # noqa: E402
from repro_torch.core.twin import (TwinFleet, make_autonomous_twin,  # noqa: E402
                                   make_driven_twin)
from repro_torch.data import hp_memristor as hp  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.kernels import (_build, crossbar_vmm,  # noqa: E402
                                 flash_attention, fused_analogue,
                                 fused_ode_mlp, fused_ode_mlp_bwd, noise, ops,
                                 ref, softdtw, ssm_scan)
from repro_torch.launch import chaos, traffic  # noqa: E402
from repro_torch.launch import journal as journal_lib  # noqa: E402
from repro_torch.launch.fleet_serving import (FleetServer,  # noqa: E402
                                              ServingSLO,
                                              StreamingFleetServer,
                                              serve_fleet)
from repro_torch.launch.mesh import (TWIN_AXIS, Mesh,  # noqa: E402
                                     make_twin_mesh, twin_shard_count)
from repro_torch.launch.mesh_check import (max_abs_diff,  # noqa: E402
                                           programs_diff)
from repro_torch.launch.sharding import fleet_param_shardings  # noqa: E402
from repro_torch.launch.state_store import TwinStateStore  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import xlstm as lm_xlstm  # noqa: E402
from repro_torch.train import (checkpoint, hw_aware, lm_trainer,  # noqa: E402
                               recipes, trainer)
from repro_torch.train.hw_aware import HwAwareConfig  # noqa: E402
from repro_torch.train.optimizer import adam  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = 1e-4          # kernel vs plain, fused vs digital: of the peak |y|
HIST_TOL = 1e-3     # fused vs digital-adjoint loss history, rel per step
#: K7 shapes of phase 11 as (M, K, N): P3's middle array (timed in phase
#: 13), then a ragged one.
K7_SHAPES = [(1024, 513, 512), (100, 70, 50)]
SEED = 0

# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): FP32 without
# tensor cores, and device-memory bandwidth.  The bound uses them whatever
# the power limit printed beside it.  The FP32 peak is its 132 SMs x 128
# FP32 lanes x 2 operations at the 1.98 GHz boost clock.
SM_COUNT = 132
SM_CLOCK = 1.98e9
FP32_PEAK = 67.0e12
HBM_BW = 3.35e12
#: Its dense BF16 tensor-core peak (same data sheet): the bound of K8's
#: bf16 products and of K1's and K2's under the bf16 policies.
BF16_PEAK = 989.0e12
#: Its dense TF32 tensor-core peak (same data sheet): the bound of K7's
#: 3xTF32 products.
TF32_PEAK = 495.0e12
#: Scalar operations of one counter normal (two splitmix32 hashes, two
#: exponent bitcasts, log, sqrt, cos and three products, each counted as
#: one operation at the FP32 rate): the bounds count the noise with it.
OPS_PER_NORMAL = 31
#: One noisy pair element: two normals, then g+ (1 + s e+) - g- (1 + s e-).
OPS_PER_NOISY_PAIR = 2 * OPS_PER_NORMAL + 7
NORMAL_ATOL = 1e-6  # K3 normals, kernel vs plain (precise logf/cosf)
#: Spin of ``torch.cuda._sleep`` ahead of a short kernel's timed calls
#: (~10 ms at the H100's 1.98 GHz boost clock; longer than the host
#: takes to enqueue 50 wrapper calls).
QUEUE_AHEAD_CYCLES = 20_000_000
#: Idle seconds at each end of a profiler session that counts device
#: events: the profiler keeps only the device events whose converted
#: timestamps fall inside its session, and a kernel that ends just before
#: the session stops can land outside it (one run lost the last of 65
#: events of phase 16's term and most of its glue's).
PROFILER_GUARD_S = 0.02


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(a: torch.Tensor, b: torch.Tensor):
    """(max |a - b|, that over max |b|)."""
    abs_err = float((a - b).abs().max())
    return abs_err, abs_err / float(b.abs().max())


def make_case(gen, sizes, B, T, du_mode, device):
    """Seeded He-init weights with random biases, y0 and a drive."""
    params = mlp_init(gen, sizes, device=device)
    for p in params:
        p["b"] = (0.1 * torch.randn(p["b"].shape, generator=gen)).to(device)
    D = sizes[-1]
    y0 = (0.5 * torch.randn((B, D), generator=gen)).to(device)
    th = torch.arange(2 * T + 1, dtype=torch.float64) / (2 * T)
    if du_mode == "none":
        u = torch.zeros((2 * T + 1, 0))
    elif du_mode == "shared":
        u = torch.sin(2 * torch.pi * 2.0 * th)[:, None]
    else:
        amp = 0.5 + torch.rand((B, 1), generator=gen, dtype=torch.float64)
        freq = 1.0 + 3.0 * torch.rand((B, 1), generator=gen,
                                      dtype=torch.float64)
        u = (amp * torch.sin(2 * torch.pi * freq * th[None, :]))[..., None]
    return params, y0, u.to(torch.float32).to(device)


def k1_bound(sizes, B, T, u):
    """(bound_ms, bound_by, GFLOP, MB) of one K1 call: the MLP's products
    for every twin and RK4 stage; y0, the drive and the weights read once,
    the trajectory written once."""
    flops, nbytes = fused_ode_mlp.rollout_work(sizes, B, T, u.numel())
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_BW * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops / 1e9, nbytes / 1e6)


def geometry_str(g) -> str:
    return (f"{g.blocks} blocks x {g.threads} threads, "
            f"{g.twins_per_block} twin(s) per block, {g.smem_bytes} B smem")


#: The other tile of :func:`fused_ode_mlp.launch_geometry`'s two.
def other_tile(g) -> int:
    return 1 if g.twins_per_block != 1 else fused_ode_mlp.FLEET_TWINS_PER_BLOCK


def k2_bound(sizes, B, T, u):
    """(bound_ms, bound_by, GFLOP, MB) of one K2 call: per twin-step the
    four stages' forward recompute, weight-gradient and input-cotangent
    products (the last only for the y columns of layer 0); the bytes of
    the trajectory, drive, cotangent and weights read once, and of dy0
    and the gradients written once."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    macs = sum(a * b for a, b in pairs)
    P = sum(a * b + b for a, b in pairs)
    D, du = sizes[-1], u.shape[-1]
    flops = 4 * 2 * (3 * macs - du * sizes[1]) * B * T
    nbytes = 4 * (2 * (T + 1) * B * D + u.numel() + 2 * P + B * D)
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_BW * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops / 1e9, nbytes / 1e6)


def grads_rel_err(got, want):
    """Max abs error and error over the peak, per gradient of
    (dy0, dweights, dbiases), and their worst."""
    pairs = list(zip([got[0], *got[1], *got[2]],
                     [want[0], *want[1], *want[2]]))
    abs_errs = [float((a - b).abs().max()) for a, b in pairs]
    rels = [e / float(b.abs().max()) for e, (_, b) in zip(abs_errs, pairs)]
    return max(abs_errs), max(rels), rels


def bound(flops: float, nbytes: float, peak: float = FP32_PEAK):
    """(bound_ms, bound_by): the larger of the operations at ``peak`` (the
    FP32 peak unless the operands' type has a faster one) and the bytes at
    the HBM rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BW * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def tensor_bytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def k4_work(staged, y0, u, T, noisy: bool):
    """(FLOP, bytes) of one K4 call: the MLP's products for every twin and
    evaluation, plus, with read noise, the noisy pairs generated once per
    evaluation (however many blocks redo them); each input read once, the
    trajectory written once."""
    pairs = [tuple(g.shape) for g in staged["gps"]]
    macs = sum((k - 1) * n for k, n in pairs)
    B, D = y0.shape
    flops = 2 * macs * 4 * T * B
    if noisy:
        flops += 4 * T * sum(k * n for k, n in pairs) * OPS_PER_NOISY_PAIR
    moved = tensor_bytes(y0, u, staged["scales"], *staged["gps"],
                         *staged["gms"])
    return flops, moved + 4 * (T + 1) * B * D


def fault_args(staged) -> dict:
    return dict(fused_analogue.FAULT_DEFAULTS, **(staged.get("fault") or {}))


def k4_plain(staged, y0, u, dt, read_noise, noise_seed, step_offset=0):
    """K4's plain version on the staged arrays (any device)."""
    return ref.fused_analogue_rollout_ref(
        staged["gps"], staged["gms"], staged["scales"], y0, u, dt,
        fault=fault_args(staged), g_step=staged["g_step"],
        g_min=staged["g_min"], g_max=staged["g_max"],
        v_clamp=staged["v_clamp"], read_noise=read_noise,
        noise_seed=noise_seed, step_offset=step_offset)


def k4_at(geom, staged, y0, u, dt, read_noise, noise_seed):
    """K4 at a forced launch geometry on the staged arrays."""
    return fused_analogue.fused_analogue_rollout_at(
        geom, staged["gps"], staged["gms"], staged["scales"], y0, u, dt,
        g_step=staged["g_step"], g_min=staged["g_min"], g_max=staged["g_max"],
        v_clamp=staged["v_clamp"], read_noise=read_noise,
        noise_seed=noise_seed, fault=staged.get("fault"))


def noise_pass_work(staged, T):
    """(FLOP, bytes) of K4's read-noise pre-pass over T steps: a noisy pair
    element per array cell and evaluation, the arrays read once and the
    pairs written once in the kernels' padded layout."""
    cells = sum(g.numel() for g in staged["gps"])
    sizes = [staged["gps"][0].shape[0] - 1] + [g.shape[1]
                                               for g in staged["gps"]]
    written = 4 * 4 * T * fused_analogue.noise_eval_floats(sizes)
    return (4 * T * cells * OPS_PER_NOISY_PAIR,
            tensor_bytes(*staged["gps"], *staged["gms"]) + written)


def noise_pass_kwargs(staged, read_noise):
    return dict(read_noise=read_noise, noise_seed=SEED,
                g_step=staged["g_step"], g_min=staged["g_min"],
                g_max=staged["g_max"], fault=fault_args(staged))


# -- K3's batched masks and write path (phases 9, 12 P6, 13) -------------------

CALIBRATION = ROOT / "calibration" / "paper_device.json"
#: Phase 9's write-path widths as (name, sizes, k_draws): HP and Lorenz96
#: at their training widths, the scorecard width of P3.
K3_WRITE_CASES = [("hp", (2, 14, 14, 1), 2), ("l96", (6, 64, 64, 6), 4),
                  ("scorecard", (6, 512, 512, 6), 2)]
#: A training step whose salts wrap past 2^32 at every case above:
#: (step k + draw) L 4 >= 4.8e9.
K3_WRAP_STEP = 200_000_000
WRITE_TOL = 1e-6    # w_hw, kernel vs plain, of each layer's peak (normals)
#: Scalar operations of one counter uniform (one splitmix32 hash of about
#: ten integer operations, the exponent bitcast and the subtraction).
OPS_PER_UNIFORM = 12
#: Scalar operations of one write-path element and draw besides its
#: normals and uniforms: the pair, the level, clips, drift, the read back.
OPS_PER_WRITE = 20
#: P6's hardware-aware policy: the calibrated device, two draws.
P6_DRAWS = 2


def p2_mask_arrays():
    """The (salt, shape) arrays of one programming of P2's fleet twin: each
    layer's folded (in + 1, out) array, G+ and G-."""
    cfg = recipes.FLEET
    sizes = [cfg.state_dim] + [cfg.hidden] * cfg.n_hidden_layers + [
        cfg.state_dim]
    return [(fault_salt(li, pair), (a + 1, b))
            for li, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))
            for pair in (0, 1)]


def k3_write_config(k: int, noisy: bool = True) -> HwAwareConfig:
    """Phase 9's write path: the calibrated spec (programming and read
    noise, or neither), 1% stuck cells resampled per (step, draw), the
    calibrated drift spread over 1000 reads."""
    spec = spec_from_calibration(CALIBRATION)
    if not noisy:
        spec = dataclasses.replace(spec, prog_noise=0.0, read_noise=0.0)
    fm = FaultModel(stuck=StuckCells(rate=0.01),
                    drift=drift_from_calibration(CALIBRATION), seed=SEED)
    return HwAwareConfig(spec=spec, k_draws=k, noise_seed=SEED + 3,
                         faults=fm, fault_ensemble=True, drift_reads=1000)


def k3_masks_check(dev) -> None:
    """Phase 9 (a): the batched mask fill at P2's programming arrays and at
    a ragged pair, bitwise its plain version and the per-array fill."""
    cases = {"P2 programming": (p2_mask_arrays(), 0.01, 0.5),
             "ragged (100, 70) + (513, 512)": (
                 [(FAULT_SALT_BASE + 5, (100, 70)),
                  (2 ** 31 + 12345, (513, 512))], 0.2, 0.4)}
    for name, (arrays, rate, on_frac) in cases.items():
        before = noise.MASK_LAUNCHES
        got = noise.stuck_cell_masks_many(SEED, arrays, rate, on_frac,
                                          device=dev)
        launches = noise.MASK_LAUNCHES - before
        want = ref.stuck_cell_masks_many_ref(SEED, arrays, rate, on_frac,
                                             device=dev)
        single = [noise.stuck_cell_masks(SEED, salt, shape, rate, on_frac,
                                         device=dev) for salt, shape in arrays]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for g, w in zip(got, want)
                   for a, b in zip(g, w))
        same1 = all(torch.equal(a, b) for g, w in zip(got, single)
                    for a, b in zip(g, w))
        stuck = sum(int(g[0].sum()) for g in got)
        print(f"K3 batched masks vs plain [{name}, {len(arrays)} arrays, "
              f"rate {rate}]: {launches} launch, {stuck} stuck cells; "
              f"bitwise the plain version: {same}; bitwise the per-array "
              f"fill: {same1}")
        check(launches == 1, f"K3 batched masks {name}: {launches} launches")
        check(same and same1, f"K3 batched masks {name} differ")


def folded_of(per_draw):
    """The write path's (w_hw, b_hw) pairs as folded (K + 1, N) arrays."""
    return [[torch.cat([w, b[None, :]]) for w, b in pairs]
            for pairs in per_draw]


def layer_errs(got, want):
    """Per (draw, layer): max |got - want| and that over the layer's peak."""
    return [(float((a - b).abs().max()),
             float((a - b).abs().max()) / float(b.abs().max()))
            for ga, wa in zip(got, want) for a, b in zip(ga, wa)]


def k3_write_inputs(gen, sizes, dev):
    params = mlp_init(gen, sizes, device=dev)
    for p in params:
        p["b"] = (0.1 * torch.randn(p["b"].shape, generator=gen)).to(dev)
    return [p["w"] for p in params], [p["b"] for p in params]


def k3_write_check(gen, dev) -> float:
    """Phase 9 (b): the write path against ``ref.hw_write_path_ref`` at each
    case of K3_WRITE_CASES, noisy (within WRITE_TOL of each layer's peak)
    and noise-free (bitwise: the levels, stuck cells and drift are the
    plain version's bits), at step 0, K3_WRAP_STEP and 2^32 - 1, the
    straight-through value too; two calls bitwise; the step as an int32
    device counter bitwise the int step; one layer's own launch bitwise
    the batched one.  Returns the worst (max abs err, error of the
    peak)."""
    worst = (0.0, 0.0)
    for name, sizes, k in K3_WRITE_CASES:
        ws, bs = k3_write_inputs(gen, sizes, dev)
        L = len(ws)
        for noisy in (True, False):
            cfg = k3_write_config(k, noisy)
            wp = hw_aware._write_path(cfg, L, k)
            for step in (0, K3_WRAP_STEP, (1 << 32) - 1):
                salt = ref.hw_salt(k, L, step, k - 1, L - 1, 1, 1)
                for ste in (False, True):
                    before = noise.WRITE_LAUNCHES
                    got = folded_of(noise.hw_write_path(
                        ws, bs, wp, step, range(k), ste=ste))
                    launches = noise.WRITE_LAUNCHES - before
                    again = folded_of(noise.hw_write_path(
                        ws, bs, wp, step, range(k), ste=ste))
                    want = folded_of(ref.hw_write_path_ref(
                        ws, bs, wp, step, range(k), ste=ste))
                    torch.cuda.synchronize()
                    pairs = [(a, b) for ga, wa in zip(got, want)
                             for a, b in zip(ga, wa)]
                    bitwise = all(torch.equal(a, b) for a, b in pairs)
                    repeat = all(torch.equal(a, b) for ga, aa in
                                 zip(got, again) for a, b in zip(ga, aa))
                    finite = all(bool(torch.isfinite(a).all())
                                 for a, _ in pairs)
                    # the step as the training engines' int32 device
                    # counter (read by the kernel, as uint32): bitwise the
                    # int step, kernel and plain version alike
                    counter = torch.tensor(
                        step - (1 << 32 if step >= 1 << 31 else 0),
                        dtype=torch.int32, device=dev)
                    by_counter = folded_of(noise.hw_write_path(
                        ws, bs, wp, counter, range(k), ste=ste))
                    plain_counter = folded_of(ref.hw_write_path_ref(
                        ws, bs, wp, counter, range(k), ste=ste))
                    same_counter = all(
                        torch.equal(a, b) for ga, ca in zip(got, by_counter)
                        for a, b in zip(ga, ca)) and all(
                        torch.equal(a, b) for wa, ca in zip(want,
                                                            plain_counter)
                        for a, b in zip(wa, ca))
                    errs = layer_errs(got, want)
                    rel = max(r for _, r in errs)
                    worst = (max(worst[0], max(a for a, _ in errs)),
                             max(worst[1], rel))
                    print(f"K3 write path vs plain [{name} {sizes} k={k}, "
                          f"{'noisy' if noisy else 'noise-free'}, step "
                          f"{step} (last salt {salt:#x}), "
                          f"{'STE value' if ste else 'w_hw'}]: {launches} "
                          f"launch; max abs err "
                          f"{max(a for a, _ in errs):.3e}, worst of a "
                          f"layer's peak {rel:.3e} (limit {WRITE_TOL:g}); "
                          f"bitwise {bitwise}; repeat bitwise {repeat}; the "
                          f"step as an int32 device counter bitwise the int "
                          f"(kernel and plain): {same_counter}")
                    check(launches == 1 and finite and repeat,
                          f"K3 write path {name}: launches {launches}, "
                          f"finite {finite}, repeat bitwise {repeat}")
                    check(same_counter, f"K3 write path {name}: the step "
                                        f"as a device counter differs from "
                                        f"the int step")
                    if noisy:
                        check(rel <= WRITE_TOL,
                              f"K3 write path {name}: kernel disagrees with "
                              f"its plain version")
                    else:
                        check(bitwise, f"K3 write path {name}: noise-free "
                                       f"output not bitwise the plain "
                                       f"version's")
            # a layer alone (its own launch, salts of its global index)
            folded = torch.cat([ws[1], bs[1][None, :]])
            alone = hw_aware.write_path_tensor(folded, cfg, 11, k - 1, 1, L)
            batched = folded_of(noise.hw_write_path(ws, bs, wp, 11,
                                                    range(k)))[k - 1][1]
            same = torch.equal(alone, batched)
            print(f"  K3 write path [{name}, {'noisy' if noisy else 'noise-free'}] "
                  f"write_path_tensor of layer 1, draw {k - 1} bitwise the "
                  f"batched launch's: {same}")
            check(same, f"K3 write path {name}: one layer's launch differs")
    return worst


def k3_mask_work(arrays):
    """(operations, bytes) of the batched mask fill: two uniforms a cell,
    two bool masks written."""
    cells = sum(r * c for _, (r, c) in arrays)
    return 2 * cells * OPS_PER_UNIFORM, 2 * cells


def k3_write_work(ws, bs, cfg, k):
    """(operations, bytes) of one write-path call of k draws: per element
    and draw 4 normals (with noise), 4 uniforms (with stuck cells) and the
    chain; the folded weights read once and each draw written once."""
    cells = sum(w.numel() + b.numel() for w, b in zip(ws, bs))
    normals = 2 * (cfg.spec.prog_noise > 0) + 2 * (
        cfg.effective_read_sigma > 0)
    uniforms = 4 * (cfg.faults is not None and cfg.faults.stuck_rate > 0)
    ops = k * cells * (normals * OPS_PER_NORMAL + uniforms * OPS_PER_UNIFORM
                       + OPS_PER_WRITE)
    return ops, 4 * cells * (1 + k)


def host_ms(fn, reps: int = 100) -> float:
    """Host-clock ms per call of ``reps`` calls enqueued behind a spin
    kernel (the wrapper's own cost: the card never holds the host back)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sec = time.perf_counter() - t0
    torch.cuda.synchronize()
    return sec / reps * 1e3


def p6_hw_aware(dev, smi, clean_twin, clean_params, zero_counts,
                read_counts) -> dict:
    """P6: hardware-aware training of the HP twin on the card, the
    calibrated device at P6_DRAWS draws a step.  ``train_hp_twin`` at the
    CI budget (one K3 write-path launch and P6_DRAWS K1 and K2 launches a
    step, no K3 fill); 40 steps twice (bitwise), with the plain write path
    swapped in (1e-3 rel), and clean beside them (order clean, hw, hw,
    clean: the step-time ratio); training on ``analogue_fused_cuda``
    (step-keyed, not the clean loss); a trainable fused analogue rollout's
    gradients; the write path's host cost within a step; then the clean
    (phase 7) and hardware-aware weights deployed on
    ``analogue_fused_cuda`` (printed, not a gate).  Returns the counts by
    path, the HP steps' times and the write path's share."""
    spec = spec_from_calibration(CALIBRATION)
    cfg = HwAwareConfig(spec=spec, k_draws=P6_DRAWS)
    steps = 250
    hists = []
    train_twin = trainer.train_twin

    def keep_history(*args, **kw):
        out = train_twin(*args, **kw)
        hists.append(out[1])
        return out

    trainer.train_twin = keep_history
    try:
        torch.cuda.synchronize()
        t_p = time.perf_counter()
        hw_twin, hw_params, loss = recipes.train_hp_twin(
            seed=42, pretrain_steps=200, train_steps=steps,
            backend="fused_cuda", hw_aware=cfg, device=dev)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t_p
    finally:
        trainer.train_twin = train_twin
    path = f"P6 train_hp_twin(hw_aware, k_draws={P6_DRAWS})"
    counts = {path: read_counts(path, {
        "K3_write": steps, "K3": 0, "K3_masks": 0, "K1": P6_DRAWS * steps,
        "K2": P6_DRAWS * steps, "K4": 0})}
    hist = hists[0]
    h0, h1 = float(hist[0]), float(hist[-1])
    print(f"[{smi}] {path}: loss {h0:.6f} -> {h1:.6f} (final {loss:.6f}) "
          f"in {sec:.3f} s, warm start included")
    check(bool(torch.isfinite(hist).all()) and h1 < h0,
          "P6: the hardware-aware loss history is not finite or did not fall")

    ts, xs, _, _ = hp.generate("sine", num_points=500, dt=1e-3,
                               amp=recipes.HP_AMP, freq=recipes.HP_FREQ,
                               device=dev)
    tw = make_driven_twin(1, hp.WAVEFORMS["sine"](
        amp=recipes.HP_AMP, freq=recipes.HP_FREQ), hidden=14)
    p0 = tw.init(torch.Generator().manual_seed(42), device=dev)

    def run(hw, backend="fused_cuda", n=40):
        torch.cuda.synchronize()
        t_r = time.perf_counter()
        _, h = trainer.train_twin(
            tw, p0, ts, xs[:, None], optimizer=adam(1e-3), num_steps=n,
            segment_len=50, loss="l1", noise_std=0.002,
            generator=torch.Generator().manual_seed(1), backend=backend,
            hw_aware=hw)
        torch.cuda.synchronize()
        return h, (time.perf_counter() - t_r) / n * 1e3

    clean_a, clean_a_ms = run(None)
    hw_a, hw_a_ms = run(cfg)
    hw_b, hw_b_ms = run(cfg)
    clean_b, clean_b_ms = run(None)
    same = torch.equal(hw_a, hw_b)
    real_write = noise.hw_write_path
    noise.hw_write_path = (
        lambda *a, **kw: ref.hw_write_path_ref(*a, **kw))
    try:
        plain, plain_step_ms = run(cfg)
    finally:
        noise.hw_write_path = real_write
    plain_rel = float(((plain - hw_a).abs() / hw_a.abs()).max())
    ratio = (hw_a_ms + hw_b_ms) / (clean_a_ms + clean_b_ms)
    print(f"[{smi}] P6 40 HP steps from the same weights (clean; hw; hw; "
          f"clean): {clean_a_ms:.3f}; {hw_a_ms:.3f}; {hw_b_ms:.3f}; "
          f"{clean_b_ms:.3f} ms a step (hardware-aware / clean "
          f"{ratio:.3f}); hw loss {float(hw_a[0]):.6f} -> "
          f"{float(hw_a[-1]):.6f}, two runs bitwise equal: {same}; with the "
          f"plain write path ({plain_step_ms:.3f} ms a step) max rel diff "
          f"{plain_rel:.3e} (limit {HIST_TOL:g})")
    check(same, "P6: two hardware-aware runs differ")
    check(plain_rel <= HIST_TOL,
          "P6: the plain write path's history differs from the kernel's")

    # training on the analogue substrate is hardware-aware and step-keyed
    be = FusedAnalogueCudaBackend(spec=spec)
    ts_seg, ys_seg = trainer.make_segments(ts, xs[:, None], 50)
    keyed = trainer.segment_loss_fn(tw, ts_seg, ys_seg,
                                    backend=be).wants_step
    analogue, _ = run(None, backend=be, n=10)
    differs = not torch.equal(analogue, clean_a[:10])
    print(f"P6 10 steps on analogue_fused_cuda: step-keyed {keyed}, loss "
          f"{float(analogue[0]):.6f} -> {float(analogue[-1]):.6f} against "
          f"fused_cuda's {float(clean_a[0]):.6f} -> {float(clean_a[9]):.6f};"
          f" differs: {differs}")
    check(keyed and differs,
          "P6: training on analogue_fused_cuda is not hardware-aware")

    # the trainable fused analogue backend differentiates its rollout
    leaves = [{k: v.detach().clone().requires_grad_() for k, v in p.items()}
              for p in p0]
    trainable = FusedAnalogueCudaBackend(spec=spec, trainable=True)
    out = trainable.rollout(trainable.program(tw.node.field, leaves),
                            xs[:1], ts)
    grads = torch.autograd.grad(out.sum(), [x for p in leaves
                                            for x in p.values()])
    ok = all(bool(torch.isfinite(g).all()) for g in grads) and all(
        float(g.abs().sum()) > 0 for g in grads)
    frozen = FusedAnalogueCudaBackend(spec=spec)
    detached = frozen.rollout(frozen.program(tw.node.field, leaves), xs[:1],
                              ts).grad_fn is None
    print(f"P6 FusedAnalogueCudaBackend(trainable=True) rollout: gradients "
          f"finite and non-zero: {ok} (|grad| sums "
          f"{', '.join(f'{float(g.abs().sum()):.3e}' for g in grads)}); "
          f"trainable=False detached: {detached}")
    check(ok and detached, "P6: trainable rollout gradients")

    # the write path's host cost within a step, kernel and plain version
    def draws_ms(reps):
        torch.cuda.synchronize()
        t_w = time.perf_counter()
        for i in range(reps):
            hw_aware._step_draws(leaves, cfg, i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t_w) / reps * 1e3

    draws_ms(3)
    write_ms = draws_ms(50)
    noise.hw_write_path = (
        lambda *a, **kw: ref.hw_write_path_ref(*a, **kw))
    try:
        draws_ms(2)
        plain_write_ms = draws_ms(10)
    finally:
        noise.hw_write_path = real_write
    step_ms = (hw_a_ms + hw_b_ms) / 2
    print(f"[{smi}] P6 write path per step (host clock, the STE's forward, "
          f"{P6_DRAWS} draws): {write_ms:.4f} ms with the kernel "
          f"({100 * write_ms / step_ms:.2f}% of a {step_ms:.3f} ms step), "
          f"{plain_write_ms:.4f} ms with the plain version on the card "
          f"({100 * plain_write_ms / step_ms:.2f}%)")

    # deployment: the clean and the hardware-aware weights on the card's
    # analogue substrate (JAX's x2 gate is red in the reference: not a gate)
    mres = {}
    for name, prm in (("clean", clean_params), ("hw_aware", hw_params)):
        mres[name] = [recipes.eval_hp_twin(
            clean_twin, prm, "sine", device=dev,
            backend=FusedAnalogueCudaBackend(spec=spec, prog_seed=100,
                                             read_seed=rs))["mre"]
            for rs in (0, 1)]
    mean = {k: sum(v) / len(v) for k, v in mres.items()}
    print(f"P6 deployed on analogue_fused_cuda (calibrated spec, prog_seed "
          f"100, read seeds 0 and 1): sine MRE clean {mres['clean']}, "
          f"hardware-aware {mres['hw_aware']}; clean / hardware-aware "
          f"{mean['clean'] / mean['hw_aware']:.3f}")
    return dict(counts=counts, step_ms=step_ms, clean_step_ms=(
        clean_a_ms + clean_b_ms) / 2, write_ms=write_ms,
        plain_write_ms=plain_write_ms, ratio=ratio)


def k3_times(dev, smi, step_ms) -> dict:
    """Phase 13's K3 rows: the batched masks at P2's programming, the write
    path at the HP and Lorenz96 step shapes (P6's policy): kernel ms
    (CUDA events behind a spin kernel), the wrapper's host ms per call,
    plain ms and the bound; for the write path also the STE helper's host
    ms and its share of P6's step."""
    rows = {}
    arrays = p2_mask_arrays()
    call = functools.partial(noise.stuck_cell_masks_many, SEED, arrays, 0.01,
                             0.5, device=dev)
    ops, nbytes = k3_mask_work(arrays)
    b_ms, b_by = bound(ops, nbytes)
    rows["masks"] = dict(
        ms=cuda_ms(call, reps=50, queue_ahead=True), host_ms=host_ms(call),
        plain_ms=cuda_ms(lambda: ref.stuck_cell_masks_many_ref(
            SEED, arrays, 0.01, 0.5, device=dev), reps=10, queue_ahead=True),
        bound_ms=b_ms, bound_by=b_by)
    r = rows["masks"]
    print(f"[{smi}] K3 stuck_cell_masks_many [P2 programming, 6 arrays]: "
          f"kernel_ms {r['ms']:.4f}, the wrapper's host time per call "
          f"{r['host_ms']:.4f}, plain_ms {r['plain_ms']:.4f}, bound_ms "
          f"{b_ms:.6f} ({b_by}: {ops / 1e6:.3f} M operations, "
          f"{nbytes / 1e3:.1f} KB), launches per programming 1")
    spec = spec_from_calibration(CALIBRATION)
    gen = torch.Generator().manual_seed(SEED + 13)
    for name, sizes, k in K3_WRITE_CASES[:2]:
        ws, bs = k3_write_inputs(gen, sizes, dev)
        cfg = HwAwareConfig(spec=spec, k_draws=k)
        wp = hw_aware._write_path(cfg, len(ws), k)
        call = functools.partial(noise.hw_write_path, ws, bs, wp, 7, range(k),
                                 ste=True)
        leaves = [{"w": w.clone().requires_grad_(),
                   "b": b.clone().requires_grad_()} for w, b in zip(ws, bs)]
        ops, nbytes = k3_write_work(ws, bs, cfg, k)
        t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_BW * 1e3
        row = dict(
            k_draws=k, ms=cuda_ms(call, reps=50, queue_ahead=True),
            host_ms=host_ms(call),
            ste_host_ms=host_ms(lambda: hw_aware._step_draws(leaves, cfg, 7)),
            plain_ms=cuda_ms(lambda: ref.hw_write_path_ref(
                ws, bs, wp, 7, range(k), ste=True), reps=10,
                queue_ahead=True),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            ops_bound_ms=t_ops, bytes_bound_ms=t_bytes)
        rows[f"write_{name}"] = row
        share = (f", {100 * row['ste_host_ms'] / step_ms:.2f}% of P6's "
                 f"{step_ms:.3f} ms step" if name == "hp" else "")
        print(f"[{smi}] K3 hw_write_path [{name} step {sizes}, k_draws "
              f"{k}]: kernel_ms {row['ms']:.4f}, the wrapper's host time per "
              f"call {row['host_ms']:.4f} (with the STE, all draws of a "
              f"step {row['ste_host_ms']:.4f}{share}), plain_ms "
              f"{row['plain_ms']:.4f}, bound_ms {row['bound_ms']:.7f} "
              f"({row['bound_by']}; operations {t_ops:.7f}, bytes "
              f"{t_bytes:.7f}), launches per step 1")
    return rows


#: Scalar operations of one soft-DTW cell, expf and logf counted as one
#: operation each at the FP32 rate: K5, two minima, three differences,
#: three scalings, three expf, two sums, logf, a product and two
#: differences; K6, per child two differences, a scaling, expf and a
#: product, and two sums.
K5_OPS_PER_CELL = 17
K6_OPS_PER_CELL = 17
#: Soft-DTW shapes of phase 14: (B, n, m); the last two are the Lorenz96
#: training shapes (29 segments of 60 steps, 8 of 200: L+1 points each).
SDTW_SHAPES = [(2, 1, 1), (2, 5, 5), (2, 50, 70), (2, 300, 200),
               (2, 257, 513), (29, 61, 61), (8, 201, 201)]


def sdtw_work(B, n, m, bwd: bool):
    """(FLOP, bytes) of one K5 (with R) or K6 call over the n*m real
    cells of each pair: K5 reads the costs and writes R (and the answer),
    K6 reads the costs and R and writes E, each once, float32."""
    cells = B * n * m
    if bwd:
        return cells * K6_OPS_PER_CELL, 12 * cells
    return cells * K5_OPS_PER_CELL, 8 * cells + 4 * B


#: Phase 14's two more cases as (B, n, m, planted): the row limit MAX_ROWS
#: against a short second series (four bands of 1024 rows), and costs with
#: in-matrix cells at or above BIG_CUT (invalid cells).
SDTW_EXTRA = [(2, softdtw.MAX_ROWS, 33, False), (2, 50, 70, True)]
#: The probe of one wavefront step's dependent chain: each kernel's own cell
#: (``csrc/softdtw.cu`` is included) in a loop of SDTW_CHAIN_STEPS dependent
#: steps on one warp, timed with CUDA events.  K5: the shuffle that brings
#: the row above's R, then the soft minimum and the sum with the cost.  K6:
#: the shuffle that brings the row above's E, then the three children's
#: products and the two sums; the child weights do not depend on E and are
#: hoisted (in the kernel they are computed a step ahead, beside the chain).
SDTW_CHAIN_STEPS = 1 << 20
#: Floats of [1, 3] (bit patterns 0x3f800000 to 0x40400000), each of which
#: the probe library's ``sdtw_log_check`` holds ``sdtw_log`` against logf.
SDTW_LOG_FLOATS = 0x40400000 - 0x3f800000 + 1
SDTW_CHAIN_SRC = r"""
#include "SOFTDTW_CU"
__global__ void sdtw_chain_k5(const float* in, float* out, int steps) {
  // lane-dependent start values, so that the shuffle is not folded away
  float myr = in[0] + 1e-3f * threadIdx.x, nb_prev = myr;
  const float d = in[1], gamma = in[2], inv_g = in[3];
  for (int s = 0; s < steps; ++s) {
    const float nb = __shfl_up_sync(SDTW_FULL, myr, 1);
    float r = __fadd_rn(d, sdtw_softmin(myr, nb, nb_prev, gamma, inv_g));
    if (d >= SDTW_BIG_CUT) r = SDTW_BIG;
    nb_prev = nb;
    myr = r;
  }
  out[threadIdx.x] = myr;
}
__global__ void sdtw_chain_k6(const float* in, float* out, int steps) {
  float mye = in[0] + 1e-3f * threadIdx.x, ae_prev = mye;
  const float inv_g = in[1], r = in[2], cd = in[3];
  const float w_dn = expf(__fmul_rn((in[4] - r) - in[5], inv_g));
  const float w_rt = expf(__fmul_rn((in[6] - r) - in[7], inv_g));
  const float w_dg = expf(__fmul_rn((in[8] - r) - in[9], inv_g));
  const bool ok_dn = in[5] < SDTW_BIG_CUT, ok_rt = in[7] < SDTW_BIG_CUT,
             ok_dg = in[9] < SDTW_BIG_CUT;
  for (int s = 0; s < steps; ++s) {
    const float ae = __shfl_up_sync(SDTW_FULL, mye, 1);
    float e = __fadd_rn(__fadd_rn(ok_dn ? __fmul_rn(ae, w_dn) : 0.f,
                                  ok_rt ? __fmul_rn(mye, w_rt) : 0.f),
                        ok_dg ? __fmul_rn(ae_prev, w_dg) : 0.f);
    if (!(cd < SDTW_BIG_CUT)) e = 0.f;
    ae_prev = ae;
    mye = e;
  }
  out[threadIdx.x] = mye;
}
// sdtw_log against logf at every float of [1, 3], the range of the soft
// minimum's sum: K5 keeps the plain version's bits only where they agree.
__global__ void sdtw_log_check(unsigned* bad) {
  for (unsigned b = 0x3f800000u + blockIdx.x * blockDim.x + threadIdx.x;
       b <= 0x40400000u; b += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(b);
    if (__float_as_uint(sdtw_log(x)) != __float_as_uint(logf(x)))
      atomicAdd(bad, 1u);
  }
}
extern "C" int sdtw_log_check_run(unsigned* bad, void* stream) {
  sdtw_log_check<<<1056, 256, 0, static_cast<cudaStream_t>(stream)>>>(bad);
  return (int)cudaGetLastError();
}
extern "C" int sdtw_chain_run(int k6, const float* in, float* out, int steps,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k6)
    sdtw_chain_k6<<<1, 32, 0, s>>>(in, out, steps);
  else
    sdtw_chain_k5<<<1, 32, 0, s>>>(in, out, steps);
  return (int)cudaGetLastError();
}
"""


def sdtw_chain_build():
    """Start nvcc on the chain probe (beside the kernels' build); returns
    (library path, process)."""
    out = ROOT / "build" / "sdtw_chain"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "sdtw_chain.cu"
    src.write_text(SDTW_CHAIN_SRC.replace(
        "SOFTDTW_CU", str(_build.CSRC / "softdtw.cu")))
    lib = out / "libsdtw_chain.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return lib, subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def sdtw_chain(lib: Path, proc, dev) -> dict:
    """Time of one dependent step of K5 and K6 on one warp (CUDA events over
    SDTW_CHAIN_STEPS steps; in SM cycles at SM_CLOCK), and the SASS
    opcodes of one step of each probe: its loop body (from a backward
    branch's target to the branch) over the shuffles in it, one a step.
    First, fails unless ``sdtw_log`` is logf's bits at every float of
    [1, 3] (``log_mismatches``)."""
    log, _ = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"chain probe build failed:\n{log}")
    so = ctypes.CDLL(str(lib))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    err = so.sdtw_log_check_run(
        ctypes.c_void_p(bad.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    check(err == 0, f"sdtw_log check: cudaError_t {err}")
    out = {"log_mismatches": int(bad.item())}
    print(f"sdtw_log vs logf at all {SDTW_LOG_FLOATS} floats of [1, 3]: "
          f"{out['log_mismatches']} differ")
    check(out["log_mismatches"] == 0,
          "sdtw_log differs from logf: K5 is no longer its plain version")
    for kind, args in (("K5", [1.0, 0.5, 0.1, 10.0]),
                       ("K6", [1.0, 1.0, 2.3, 0.5, 2.0, 0.5, 2.1, 0.4, 1.9,
                               0.6])):
        x = torch.tensor(args, dtype=torch.float32, device=dev)
        y = torch.zeros(32, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def run(steps):
            err = so.sdtw_chain_run(int(kind == "K6"),
                                    ctypes.c_void_p(x.data_ptr()),
                                    ctypes.c_void_p(y.data_ptr()), steps,
                                    stream)
            check(err == 0, f"chain probe {kind}: cudaError_t {err}")
        run(1024)
        t = cuda_ms(lambda: run(SDTW_CHAIN_STEPS), reps=3, warmup=1)
        step_s = t / 1e3 / SDTW_CHAIN_STEPS
        # the probe's loop: the longest backward branch of its function
        fn_sass = sass.split(f"sdtw_chain_{kind.lower()}", 1)[1]
        fn_sass = fn_sass.split("Function :", 1)[0]
        code = []
        for line in fn_sass.splitlines():
            mo = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                           r"([A-Z0-9_.]+)([^;]*)", line)
            if mo:
                code.append((int(mo.group(1), 16), mo.group(3),
                             mo.group(4)))
        loop = (0, 0)
        for addr, op, rest in code:
            tgt = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and tgt and int(tgt.group(1), 16) < addr:
                lo = int(tgt.group(1), 16)
                if addr - lo > loop[1] - loop[0]:
                    loop = (lo, addr)
        body = {}
        for addr, op, _ in code:
            if loop[0] <= addr <= loop[1]:
                body[op] = body.get(op, 0) + 1
        per = max(body.get("SHFL.UP", 1), 1)
        out[kind] = {"cycles_per_step": step_s * SM_CLOCK,
                     "ms_per_step": step_s * 1e3,
                     "sass_per_step": {op: k / per for op, k in body.items()}}
    return out


def real_cells(r):
    """R with its BIG sentinel cells zeroed, for an error of the peak."""
    return torch.where(r < ref.BIG_CUT, r, torch.zeros_like(r))


def sdtw_costs(gen, B, n, m, dev, planted=False):
    """Seeded series pair -> the (B, n, m) row-major pairwise costs on
    ``dev``; ``planted`` sets one in-matrix cost above BIG_CUT and one at
    it (both invalid cells)."""
    x = torch.randn((B, n, 2), generator=gen).to(dev)
    y = torch.randn((B, m, 2), generator=gen).to(dev)
    D = _pairwise_dist(x, y).contiguous()
    if planted:
        D[0, n // 2, m // 3] = 2 * ref.BIG
        D[B - 1, n - 1, m // 2] = ref.BIG_CUT
    return D


def sdtw_check(gen, dev) -> dict:
    """Phase 14: K5 (answer, R, hard answer) and K6 (E) through the
    row-major entry points and through the diagonal-layout adapters against
    their plain versions, bitwise, at every ``SDTW_SHAPES`` and
    ``SDTW_EXTRA`` case and gamma 0.1 and 0.7; repeats bitwise.  Returns
    ({(B, n, m, gamma): {name: (max abs err, err of the peak)}},
    {(B, n, m, gamma): {name: bitwise equal to the plain version}})."""
    errs, equal = {}, {}
    for B, n, m, planted in ([(*sh, False) for sh in SDTW_SHAPES]
                             + SDTW_EXTRA):
        for gamma in (0.1, 0.7):
            D = sdtw_costs(gen, B, n, m, dev, planted)
            dd = ref.diag_layout(D).contiguous()
            ans, R = softdtw.softdtw_rowmajor(D, gamma=gamma, return_r=True)
            E = softdtw.softdtw_rowmajor_bwd(D, R, gamma=gamma)
            ans2, R2 = softdtw.softdtw_rowmajor(D, gamma=gamma, return_r=True)
            E2 = softdtw.softdtw_rowmajor_bwd(D, R, gamma=gamma)
            d_ans, d_r = softdtw.softdtw_wavefront(dd, n, m, gamma=gamma,
                                                   return_r=True)
            got = {"K5": ans, "K5 R": R,
                   "K5 hard": softdtw.softdtw_rowmajor(D, hard=True),
                   "K6": E, "diag K5": d_ans, "diag K5 R": d_r,
                   "diag K5 hard": softdtw.softdtw_wavefront(dd, n, m,
                                                             hard=True),
                   "diag K6": softdtw.softdtw_wavefront_bwd(dd, d_r, n, m,
                                                            gamma=gamma)}
            p_ans, p_r = ref.softdtw_rowmajor_ref(D, gamma=gamma,
                                                  return_r=True)
            pd_ans, pd_r = ref.softdtw_wavefront_ref(dd, n, m, gamma=gamma,
                                                     return_r=True)
            want = {"K5": p_ans, "K5 R": p_r,
                    "K5 hard": ref.softdtw_rowmajor_ref(D, hard=True),
                    "K6": ref.softdtw_rowmajor_bwd_ref(D, p_r, gamma=gamma),
                    "diag K5": pd_ans, "diag K5 R": pd_r,
                    "diag K5 hard": ref.softdtw_wavefront_ref(dd, n, m,
                                                              hard=True),
                    "diag K6": ref.softdtw_wavefront_bwd_ref(dd, pd_r, n, m,
                                                             gamma=gamma)}
            torch.cuda.synchronize()
            case = f"({B}, {n}, {m}){' planted' if planted else ''}"
            errs[B, n, m, gamma] = {}
            for k, x in got.items():
                real = real_cells(x) if k.endswith(" R") else x
                check(bool(torch.isfinite(real).all()),
                      f"{k} {case} gamma {gamma}: non-finite")
                errs[B, n, m, gamma][k] = rel_err(
                    real, real_cells(want[k]) if k.endswith(" R") else want[k])
            same = equal[B, n, m, gamma] = {
                k: torch.equal(got[k], want[k]) for k in got}
            repeats = (torch.equal(ans, ans2) and torch.equal(R, R2)
                       and torch.equal(E, E2))
            print(f"K5/K6 vs plain {case} gamma {gamma}: " + ", ".join(
                f"{k} {e[1]:.3e}" for k, e in errs[B, n, m, gamma].items())
                + f" of the peak; bitwise equal to the plain versions: "
                f"{all(same.values())}; repeats bitwise: {repeats}")
            check(all(same.values()), f"K5/K6 {case} gamma {gamma}: not "
                  f"bitwise the plain version in {[k for k, v in same.items() if not v]}")
            check(repeats, f"K5/K6 {case} gamma {gamma}: two calls differ")
    return errs, equal


def sdtw_times(gen, dev, smi, chain) -> dict:
    """Phase 16's kernel timing at the two Lorenz96 training shapes: K5
    (with R) and K6 on the row-major costs, CUDA-event means queued ahead
    (kernel) and back to back with the wrapper (per call), the plain
    versions, the bytes bound and the chain bound.  Returns {(B, n, m):
    {"K5": row, "K6": row}}."""
    times = {}
    for B, n, m in ((29, 61, 61), (8, 201, 201)):
        D = sdtw_costs(gen, B, n, m, dev)
        _, R = softdtw.softdtw_rowmajor(D, gamma=0.1, return_r=True)
        rows = {}
        for kname, bwd in (("K5", False), ("K6", True)):
            def call():
                if bwd:
                    return softdtw.softdtw_rowmajor_bwd(D, R, gamma=0.1)
                return softdtw.softdtw_rowmajor(D, gamma=0.1, return_r=True)

            def plain():
                if bwd:
                    return ref.softdtw_rowmajor_bwd_ref(D, R, gamma=0.1)
                return ref.softdtw_rowmajor_ref(D, gamma=0.1, return_r=True)
            k_ms = cuda_ms(call, reps=50, queue_ahead=True)
            call_ms = cuda_ms(call, reps=50)
            p_ms = cuda_ms(plain, reps=3, warmup=1)
            flops, moved = sdtw_work(B, n, m, bwd)
            b_ms, b_by = bound(flops, moved)
            chain_ms = (n + m - 1) * chain[kname]["ms_per_step"]
            rows[kname] = {"ms": k_ms, "call_ms": call_ms, "plain_ms": p_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "chain_bound_ms": chain_ms}
            wrapper = ("softdtw_rowmajor_bwd" if bwd
                       else "softdtw_rowmajor (with R)")
            print(f"[{smi}] {kname} {wrapper} (B, n, m) = ({B}, {n}, {m}), "
                  f"{softdtw.band_warps(n)} warps: kernel_ms {k_ms:.4f} (per call with the "
                  f"wrapper {call_ms:.4f}), plain_ms {p_ms:.4f}, bound_ms "
                  f"{b_ms:.6f} ({b_by}: {flops / 1e6:.3f} MFLOP, "
                  f"{moved / 1e6:.3f} MB), chain_bound_ms {chain_ms:.4f} "
                  f"(n+m-1 = {n + m - 1} steps x "
                  f"{chain[kname]['cycles_per_step']:.1f} cycles at "
                  f"{SM_CLOCK / 1e9:g} GHz); library_ms n/a (no single "
                  f"PyTorch call computes soft-DTW)")
        times[B, n, m] = rows
    return times


#: SASS opcodes counted per kernel function by :func:`sass_counts`.
SASS_OPCODES = ("HMMA", "FFMA", "LDS", "MUFU", "LDGSTS")
#: Opcodes counted in a function's densest barrier-to-barrier phase.
DENSE_OPCODES = ("FFMA", "LDS", "MUFU")


def sass_counts(lib: Path) -> dict:
    """{kernel function (mangled name): {opcode: instructions}} for the
    opcodes of ``SASS_OPCODES`` (tensor-core products, float32 FMAs,
    shared-memory loads of any width, special-function instructions,
    cp.async copies) in the SASS of one built kernel library, read with
    ``cuobjdump --dump-sass``; ``"dense"`` holds the ``DENSE_OPCODES`` of
    the stretch between two block barriers with the most FFMAs (in K1 and
    K4 the hidden layer's product, in K2 the gradient-tile phase, in K9 a
    chunk's 32 steps)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn, seg = {}, None, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPCODES, 0)
            counts[fn]["dense"] = seg = dict.fromkeys(DENSE_OPCODES, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                      line)
        if fn is None or not m:
            continue
        op = m.group(1)
        if op in SASS_OPCODES:
            counts[fn][op] += 1
        if op == "BAR":
            if seg["FFMA"] > counts[fn]["dense"]["FFMA"]:
                counts[fn]["dense"] = seg
            seg = dict.fromkeys(DENSE_OPCODES, 0)
        elif op in seg:
            seg[op] += 1
    return counts


def cuda_ms(fn, reps: int, warmup: int = 2, queue_ahead: bool = False
            ) -> float:
    """Mean ms per call between CUDA events around ``reps`` calls.  With
    ``queue_ahead`` the card first runs a ~10 ms spin kernel, so the host
    has enqueued the calls before the start event fires: the events then
    time the launches back to back, without the Python wrapper's cost
    (which bounds a kernel of tens of microseconds otherwise)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phases 17-19: the LM serving slice (K8, K9, P5) ---------------------------

#: K8 at the Jamba prefill, (B, H, Hkv, S, d): timed in phase 19.
K8_P5 = (2, 32, 8, 4096, 128)
#: K8 shapes of phase 17 as (B, H, Hkv, S, d): the JAX package's three test
#: shapes, the Jamba prefill's, and a ragged S (not a multiple of 64).
K8_SHAPES = [(1, 2, 2, 32, 16), (2, 4, 2, 64, 32), (1, 8, 2, 128, 64),
             K8_P5, (1, 32, 8, 4097, 128)]
#: K9 shapes of phase 17 as (B, S, DI, N): JAX's three, then Jamba's.
K9_SHAPES = [(1, 8, 16, 4), (2, 32, 64, 16), (1, 64, 128, 16),
             (2, 4096, 8192, 16)]
#: K8 vs plain, of the peak |out|: the tolerances of the JAX package's
#: test_flash_pallas_matches_ref (bf16 output rounding).
K8_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: bf16 K8, per element, against the plain version's float32 output before its
#: cast: |got - want| <= 2^-8 |want| (round to nearest in bf16's 8-bit
#: significand) + K8_TOL[float32] of the peak (the kernel's own float32 sums).
#: Far tighter than 2e-2 of the peak where rows attend over many keys.
BF16_ROUND = 2.0 ** -8
K9_TOL = 1e-5
P5_SEQ = 4096        # P5 prompt length: the Jamba prefill shape of K8, K9
P5_LOGIT_TOL = 1e-3   # P5 f32 last logits, kernels vs plain, of the peak
P5_SSM_TOL = 1e-4     # P5 f32 ssm cache states, kernels vs plain, of the peak
#: P5 bf16 logits (unembed's float32-output bf16 product on the card) vs the
#: product of the widened operands, of the peak; a bf16-rounded output would
#: be ~2^-9 of the peak off.
UNEMBED_TOL = 1e-4
#: Float32 operations of one causal (q, kv) pair's softmax besides the
#: products: scale, mask, max, subtract, exp, sum.
K8_SOFTMAX_OPS = 6
#: Float32 operations of one (step, channel, state) of the scan besides its
#: exp: dt*A, (dt x)*B, the decay product, the sum, h*C and its sum.
K9_OPS_PER_STATE = 6
#: The H100 SXM's special-function rate (16 results a clock per SM, at the
#: clock of FP32_PEAK): the bound of the scan's expf, one each.
SFU_RATE = 16 * SM_COUNT * SM_CLOCK
#: Steps of one K9 chunk (K9_TC in ``csrc/ssm_scan.cu``): its densest SASS
#: phase holds this many unrolled steps.
K9_CHUNK = 32


def k8_inputs(gen, b, h, hkv, s, d, dtype, dev):
    """q, k, v as the model hands them to K8: (B, S, heads, d) activations
    seen as (B, heads, S, d) without a copy."""
    return [torch.randn((b, s, n, d), generator=gen, device=dev).to(
        dtype).transpose(1, 2) for n in (h, hkv, hkv)]


def k9_inputs(gen, bsz, s, di, n, dev):
    """Drawn as the JAX package's test draws them."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(rn(bsz, s, di)) * 0.1
    return dt, rn(bsz, s, n), rn(bsz, s, n), rn(bsz, s, di), \
        -torch.exp(rn(di, n) * 0.3)


def k8_work(b, h, hkv, s, d, elem_bytes, dv=None):
    """(bound_ms, bound_by, GFLOP of products, MB) of one causal K8 call:
    the products (2 d for Q K^T and 2 dv for P V a pair) of the s(s+1)/2
    visible pairs of each (batch, head) at the bf16 tensor-core peak (or
    FP32 for float32 inputs), their softmax at the FP32 peak, and Q, K, V
    read and O written once.  ``dv`` defaults to d."""
    dv = d if dv is None else dv
    pairs = b * h * s * (s + 1) // 2
    products = 2 * (d + dv) * pairs
    peak = BF16_PEAK if elem_bytes == 2 else FP32_PEAK
    moved = flash_attention.hbm_traffic_bytes(b, h, hkv, s, d, dv,
                                              elem_bytes)["total"]
    times = {"operations": max(products / peak,
                               K8_SOFTMAX_OPS * pairs / FP32_PEAK) * 1e3,
             "bytes": moved / HBM_BW * 1e3}
    by = max(times, key=times.get)
    return times[by], by, products / 1e9, moved / 1e6


def k7_work(M, K, N, noisy, moved):
    """(bound_ms, bound_by, GFLOP of products) of one K7 call: its three
    TF32 products per multiply-add (3xTF32) at the TF32 tensor-core peak,
    a noisy read's noise at the FP32 peak, and ``moved`` bytes."""
    products = 3 * 2 * M * K * N
    noise_ops = K * N * OPS_PER_NOISY_PAIR if noisy else 0
    times = {"operations": max(products / TF32_PEAK,
                               noise_ops / FP32_PEAK) * 1e3,
             "bytes": moved / HBM_BW * 1e3}
    by = max(times, key=times.get)
    return times[by], by, products / 1e9


def k9_work(bsz, s, di, n):
    """(bound_ms, bound_by, GFLOP, MB, times) of one K9 call: dt, x, B, C
    and A read and y and the final state written once, float32; the FP32
    operations at the FP32 peak; each state's expf at the SFU rate.
    ``times`` holds the three (bytes, FP32, SFU) in ms; bound_by is
    "bytes", or "operations" for either of the other two."""
    flops = bsz * s * di * (K9_OPS_PER_STATE * n + 1)
    moved = 4 * (3 * bsz * s * di + 2 * bsz * s * n + di * n + bsz * di * n)
    times = {"bytes": moved / HBM_BW * 1e3, "fp32": flops / FP32_PEAK * 1e3,
             "sfu": bsz * s * di * n / SFU_RATE * 1e3}
    by = max(times, key=times.get)
    return (times[by], "bytes" if by == "bytes" else "operations",
            flops / 1e9, moved / 1e6, times)


def k8_vs_plain(name, q, k, v, scale) -> tuple:
    """K8 against its plain version on the same inputs (phases 17 and 27):
    of the peak within K8_TOL, repeats bitwise, bf16 per element
    within the rounding bound.  Returns (max abs err, of peak, bf16
    rounding ratio or None)."""
    got = flash_attention.flash_attention(q, k, v, scale=scale)
    again = flash_attention.flash_attention(q, k, v, scale=scale)
    want = ref.flash_attention_ref(q, k, v, scale=scale)
    torch.cuda.synchronize()
    check(got.shape == want.shape == (*q.shape[:3], v.shape[-1])
          and got.dtype == q.dtype, f"K8 {name}: {got.shape} {got.dtype}")
    a, r = rel_err(got.float(), want.float())
    tol = K8_TOL[q.dtype]
    ratio = None
    if q.dtype == torch.bfloat16:
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                         scale=scale)
        limit = BF16_ROUND * want32.abs() + K8_TOL[torch.float32] * \
            float(want32.abs().max())
        ratio = float(((got.float() - want32).abs() / limit).max())
        del want32, limit
    print(f"K8 vs plain {name} {q.dtype}: max abs err {a:.3e}, of peak "
          f"{r:.3e} (limit {tol:g}); repeat bitwise "
          f"{torch.equal(got, again)}" + (
              "" if ratio is None else f"; per element vs the float32 "
              f"plain output: max |err| / (2^-8 |want| + "
              f"{K8_TOL[torch.float32]:g} of the peak) = {ratio:.4f} "
              f"(limit 1)"))
    check(r <= tol, f"K8 {name} {q.dtype} disagrees with its plain version")
    check(torch.equal(got, again), f"K8 {name} {q.dtype}: repeats differ")
    check(ratio is None or ratio <= 1.0,
          f"K8 {name} bf16 beyond the rounding bound of its plain version")
    return a, r, ratio


def prefill_trace(label, prefill, params, batch, kernels) -> None:
    """A ``torch.profiler`` trace of one prefill: wall and device-busy ms,
    the idle share, the device ms and share of each named kernel family
    (``kernels``: name -> substring of its kernel functions) and the top
    five kernels by device time, printed."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t_p = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t_p) * 1e3
    kernels_us = {ev.key: ev.self_device_time_total
                  for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and ev.self_device_time_total > 0}
    busy_ms = sum(kernels_us.values()) / 1e3
    if busy_ms <= 0:
        print(f"{label} trace: the profiler recorded no device time (device "
              f"idle share not measured)")
        return
    shares = []
    for name, sub in kernels.items():
        dev_ms = sum(t for key, t in kernels_us.items() if sub in key) / 1e3
        shares.append(f"{name} {dev_ms:.3f} ms "
                      f"({100 * dev_ms / busy_ms:.1f}% of device time)")
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:5]
    b, s1 = batch["tokens"].shape
    print(f"{label} trace, one bf16 prefill ({b}, {s1 - 1}): wall "
          f"{traced_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle {100 * (1 - busy_ms / traced_ms):.1f}%); "
          + ", ".join(shares) + "; top five by device time: " + "; ".join(
              f"{key[:60]} {t / 1e3:.3f} ms" for key, t in top))


def lm_slice(dev, smi, hmma, sass9):
    """Phases 17-19; returns the K8 and K9 entries of the kernel record
    (``hmma``: K8's SASS HMMA counts by kernel function, ``sass9`` K9's
    SASS counts, phase 2)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # -- 17. K8 and K9 vs their plain versions -----------------------------------
    k8_errs, k9_errs = {}, {}
    for b, h, hkv, s, d in K8_SHAPES:
        for dtype in K8_TOL:
            q, k, v = k8_inputs(gen, b, h, hkv, s, d, dtype, dev)
            a, r, ratio = k8_vs_plain(f"(B, H, Hkv, S, d) = "
                                      f"{(b, h, hkv, s, d)}", q, k, v,
                                      d ** -0.5)
            k8_errs[b, h, hkv, s, d, dtype] = (a, r)
            if ratio is not None:
                k8_errs["bf16_rounding", b, h, hkv, s, d] = ratio
            del q, k, v
    for bsz, s, di, n in K9_SHAPES:
        args = k9_inputs(gen, bsz, s, di, n, dev)
        y, hf = ssm_scan.ssm_scan(*args)
        y2, h2 = ssm_scan.ssm_scan(*args)
        yr, hr = ref.ssm_scan_ref(*args)
        torch.cuda.synchronize()
        ya, yrel = rel_err(y, yr)
        ha, hrel = rel_err(hf, hr)
        k9_errs[bsz, s, di, n] = (max(ya, ha), max(yrel, hrel))
        same = torch.equal(y, y2) and torch.equal(hf, h2)
        # an observation, not a gate: each state is the plain version's
        # arithmetic, so the final state matches it bit for bit where the
        # card's exp is expf
        k9_errs["h_bitwise", bsz, s, di, n] = torch.equal(hf, hr)
        print(f"K9 vs plain (B, S, DI, N) = {(bsz, s, di, n)}: y max abs err "
              f"{ya:.3e}, of peak {yrel:.3e}; h_final {ha:.3e}, of peak "
              f"{hrel:.3e} (limit {K9_TOL:g}); repeat bitwise {same}; "
              f"h_final bitwise the plain version's "
              f"{k9_errs['h_bitwise', bsz, s, di, n]}")
        check(max(yrel, hrel) <= K9_TOL, f"K9 {(bsz, s, di, n)} disagrees "
                                         f"with its plain version")
        check(same, f"K9 {(bsz, s, di, n)}: repeats differ")
        del args, y, hf, y2, h2, yr, hr
    torch.cuda.empty_cache()

    # -- 18. P5: Jamba prefill and decode at full width --------------------------------
    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=8)
    print(f"P5 config {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads} "
          f"(kv {cfg.n_kv}, hd {cfg.hd}), d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"Mamba d_inner {cfg.mamba.d_inner} N {cfg.mamba.d_state}, MoE "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}; reduced: "
          f"n_layers {full.n_layers} -> {cfg.n_layers} (one whole period, "
          f"{param_count(cfg) / 1e9:.2f} B params of "
          f"{param_count(full) / 1e9:.2f} B)")
    s_len = P5_SEQ
    n_mamba = sum(sp.mixer == "mamba" for sp in lm_model.block_program(cfg)[1])

    def zero_lm():
        flash_attention.LAUNCHES = 0
        ssm_scan.LAUNCHES = 0

    def read_lm(path, want):
        torch.cuda.synchronize()
        got = {"K8": flash_attention.LAUNCHES, "K9": ssm_scan.LAUNCHES}
        print(f"{path}: launches {got}")
        for key, n_ in want.items():
            check(got[key] == n_, f"{path}: expected {n_} {key} launches, "
                                  f"got {got[key]}")
        return got

    choices = []
    route_moe = lm_moe.moe_apply

    def recording_moe(params, mcfg, x):
        choices[-1].append(torch.sort(lm_moe.route(params, mcfg, x)[2],
                                      dim=-1).values)
        return route_moe(params, mcfg, x)

    lm_counts = {}
    # parity in float32, batch of 1: kernels, then the plain versions
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t_i = time.perf_counter()
    params = lm_model.init_params(cfg32, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"P5 float32 params on {dev}: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, drawn in "
          f"{time.perf_counter() - t_i:.2f} s")
    batch = {"tokens": TokenPipeline(cfg.vocab, s_len, 1, seed=SEED)
             .batch_at(0)["tokens"].to(dev)}
    prefill32 = lm_trainer.make_prefill_step(cfg32)
    runs = {}
    lm_moe.moe_apply = recording_moe
    plain_ops = {"flash_attention": lambda q, k, v, scale=None:
                 ref.flash_attention_ref(q, k, v, scale=scale),
                 "ssm_scan": ref.ssm_scan_ref}
    kernel_ops = {name: getattr(ops, name) for name in plain_ops}
    try:
        for mode in ("kernels", "plain"):
            choices.append([])
            if mode == "plain":
                for name, fn in plain_ops.items():
                    setattr(ops, name, fn)
            zero_lm()
            t_p = time.perf_counter()
            logits, cache = prefill32(params, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t_p
            got = read_lm(f"P5 float32 prefill (1, {s_len}) on {mode}",
                          {"K8": 1, "K9": n_mamba} if mode == "kernels"
                          else {"K8": 0, "K9": 0})
            if mode == "kernels":
                lm_counts["P5_f32_prefill"] = got
            runs[mode] = (logits, [cache["stack"][f"b{i}"]["ssm"]
                                   for i, sp in enumerate(
                                       lm_model.block_program(cfg)[1])
                                   if sp.mixer == "mamba"])
            print(f"P5 float32 prefill on {mode}: {secs:.3f} s")
            del cache
    finally:
        lm_moe.moe_apply = route_moe
        for name, fn in kernel_ops.items():
            setattr(ops, name, fn)
    la, lr = rel_err(runs["kernels"][0], runs["plain"][0])
    sr = max(rel_err(a, b)[1] for a, b in zip(runs["kernels"][1],
                                              runs["plain"][1]))
    flips = sum(int((a != b).sum()) for a, b in zip(*choices))
    n_choices = sum(int(a.numel()) for a in choices[0])
    print(f"P5 float32 kernels vs plain: last logits max abs err {la:.3e}, "
          f"of peak {lr:.3e} (limit {P5_LOGIT_TOL:g}); ssm states of peak "
          f"{sr:.3e} (limit {P5_SSM_TOL:g}); MoE top-{cfg.moe.top_k} choices "
          f"that differ: {flips} of {n_choices}")
    check(bool(torch.isfinite(runs["kernels"][0]).all()),
          "P5 float32 logits not finite")
    check(lr <= P5_LOGIT_TOL, "P5 float32 logits: kernels vs plain differ")
    check(sr <= P5_SSM_TOL, "P5 float32 ssm states: kernels vs plain differ")
    del params, runs, logits, choices
    torch.cuda.empty_cache()

    # serving in the config's own bf16: two prefill batches, then decode
    t_i = time.perf_counter()
    params = lm_model.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"P5 bf16 params on {dev}: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, drawn in "
          f"{time.perf_counter() - t_i:.2f} s")
    # unembed's card branch (bf16 operands, float32 output) at the prefill's
    # shape, against the product of the widened operands
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    x = torch.randn((2, s_len, cfg.d_model), generator=gen, device=dev).to(
        table.dtype)
    ua, ur = rel_err(lm_layers.unembed(x, table), x.float() @ table.float().t())
    print(f"P5 unembed (2, {s_len}, {cfg.d_model}) x {tuple(table.shape)} "
          f"{table.dtype}, float32 out: max abs err {ua:.3e}, of peak "
          f"{ur:.3e} vs the widened product (limit {UNEMBED_TOL:g})")
    check(ur <= UNEMBED_TOL, "P5 unembed disagrees with the widened product")
    del x, table
    torch.cuda.empty_cache()
    prefill = lm_trainer.make_prefill_step(cfg)
    want_cache = lm_model.init_cache(cfg, 2, s_len, device=dev)
    want_leaves = [(tuple(x.shape), x.dtype) for x in tree_leaves(want_cache)]
    del want_cache
    pipe = TokenPipeline(cfg.vocab, s_len, 2, seed=SEED)
    prefill_secs = []
    for i in range(2):
        batch = {"tokens": pipe.batch_at(1 + i)["tokens"].to(dev)}
        torch.cuda.synchronize()
        zero_lm()
        t_p = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t_p
        lm_counts[f"P5_bf16_prefill_{i}"] = read_lm(
            f"P5 bf16 prefill {i} (2, {s_len})", {"K8": 1, "K9": n_mamba})
        check(tuple(logits.shape) == (2, cfg.vocab)
              and logits.dtype == torch.float32, f"P5 logits {logits.shape}")
        check(bool(torch.isfinite(logits).all()), "P5 bf16 logits not finite")
        got_leaves = [(tuple(x.shape), x.dtype) for x in tree_leaves(cache)]
        check(got_leaves == want_leaves, f"P5 cache leaves {got_leaves} vs "
                                         f"init_cache's {want_leaves}")
        prefill_secs.append(secs)
        print(f"[{smi}] P5 bf16 prefill {i}: (2, {s_len}) in "
              f"{secs * 1e3:.3f} ms, {2 * s_len / secs:,.0f} tokens/s")
        del logits, cache

    finite = []
    decode_step = lm_trainer.decode_step

    def checking_decode(*args):
        out = decode_step(*args)
        finite.append(torch.isfinite(out[0]).all())
        return out

    prompt = pipe.batch_at(3)["tokens"][:, :16].to(dev)
    zero_lm()
    lm_trainer.decode_step = checking_decode
    try:
        torch.cuda.synchronize()
        t_g = time.perf_counter()
        toks = lm_trainer.greedy_generate(params, cfg, prompt, 16, 32)
        torch.cuda.synchronize()
        gen_secs = time.perf_counter() - t_g
    finally:
        lm_trainer.decode_step = decode_step
    lm_counts["P5_greedy_generate"] = read_lm(
        "P5 greedy_generate (16 + 16 tokens)", {"K8": 0, "K9": 0})
    steps = prompt.shape[1] + 16 - 1
    check(tuple(toks.shape) == (2, 16), f"generated {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token range")
    check(len(finite) == steps and bool(torch.stack(finite).all()),
          "P5 decode logits not finite")
    decode_ms = gen_secs / steps * 1e3
    print(f"[{smi}] P5 greedy_generate: {steps} decode steps of batch 2 in "
          f"{gen_secs:.3f} s, {decode_ms:.3f} ms per token step; first "
          f"tokens {toks[0, :6].tolist()}")

    # -- 19. K8 and K9 timing, and where P5's time goes ---------------------------
    b, h, hkv, s, d = K8_P5
    q, k, v = k8_inputs(gen, b, h, hkv, s, d, torch.bfloat16, dev)
    k8_ms = cuda_ms(lambda: flash_attention.flash_attention(q, k, v), reps=5)
    k8_plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v), reps=2,
                       warmup=1)
    k8_lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=d ** -0.5, enable_gqa=True), reps=5)
    k8_bound, k8_by, k8_gf, k8_mb = k8_work(b, h, hkv, s, d, 2)
    k8_tflops = k8_gf / k8_ms        # GFLOP / ms = TFLOP/s
    print(f"[{smi}] K8 flash_attention (B, H, Hkv, S, d) = {(b, h, hkv, s, d)} "
          f"bf16: kernel_ms {k8_ms:.4f}, plain_ms {k8_plain:.4f}, bound_ms "
          f"{k8_bound:.4f} ({k8_by}: {k8_gf:.1f} GFLOP of products, "
          f"{k8_mb:.1f} MB), library_ms {k8_lib:.4f} (scaled_dot_product_"
          f"attention, causal, enable_gqa); achieved {k8_tflops:.1f} TFLOP/s "
          f"of the causal products ({1.5 * k8_tflops:.1f} counting the "
          f"kernel's two P.V products)")
    del q, k, v
    bsz, s, di, n = K9_SHAPES[-1]
    args = k9_inputs(gen, bsz, s, di, n, dev)
    k9_ms = cuda_ms(lambda: ssm_scan.ssm_scan(*args), reps=5)
    k9_plain = cuda_ms(lambda: ref.ssm_scan_ref(*args), reps=1, warmup=1)
    k9_bound, k9_by, k9_gf, k9_mb, k9_t = k9_work(bsz, s, di, n)
    print(f"[{smi}] K9 ssm_scan (B, S, DI, N) = {(bsz, s, di, n)}: kernel_ms "
          f"{k9_ms:.4f}, plain_ms {k9_plain:.4f}, bound_ms {k9_bound:.4f} "
          f"({k9_by}: bytes {k9_t['bytes']:.4f}, FP32 {k9_t['fp32']:.4f}, expf at the "
          f"SFU rate {k9_t['sfu']:.4f}; {k9_gf:.2f} GFLOP, {k9_mb:.1f} MB), "
          f"library_ms n/a (no single PyTorch call computes the scan)")
    del args

    prefill_trace(f"[{smi}] P5", prefill, params,
                  {"tokens": pipe.batch_at(1)["tokens"].to(dev)},
                  {"K8": "k8_flash", "K9": "k9_ssm_scan"})
    del params
    torch.cuda.empty_cache()

    def paths(key):
        return {p: c[key] for p, c in lm_counts.items() if c[key]}

    k8_err = k8_errs[(*K8_P5, torch.bfloat16)]
    k9_err = k9_errs[K9_SHAPES[-1]]
    return [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/legacy/flash_attention.py:65",
        "launches": sum(paths("K8").values()),
        "launches_by_path": paths("K8"),
        "shape": "B=2 H=32 Hkv=8 S=4096 d=128 bf16 (Jamba prefill)",
        "max_abs_err": k8_err[0],
        "max_rel_err_of_peak": k8_err[1],
        "f32_max_rel_err_of_peak": k8_errs[(*K8_P5, torch.float32)][1],
        "bf16_err_of_rounding_bound": k8_errs[("bf16_rounding", *K8_P5)],
        "ragged_bf16_err_of_rounding_bound": k8_errs[("bf16_rounding",
                                                      *K8_SHAPES[-1])],
        "tflops": k8_tflops,
        "sass_hmma": sum(n for fn, n in hmma.items()
                         if "k8_flash_mma_kernel" in fn),
        "ms": k8_ms,
        "plain_ms": k8_plain,
        "bound_ms": k8_bound,
        "bound_by": k8_by,
        "library_ms": k8_lib,
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/legacy/ssm_scan.py:51",
        "launches": sum(paths("K9").values()),
        "launches_by_path": paths("K9"),
        "shape": "B=2 S=4096 DI=8192 N=16 (Jamba prefill)",
        "max_abs_err": k9_err[0],
        "max_rel_err_of_peak": k9_err[1],
        "h_final_bitwise_plain": k9_errs[("h_bitwise", *K9_SHAPES[-1])],
        "ms": k9_ms,
        "plain_ms": k9_plain,
        "bound_ms": k9_bound,
        "bound_by": k9_by,
        "bound_ms_by": k9_t,
        "library_ms": None,
        "sass": {fn: {k: c[k] for k in ("MUFU", "FFMA", "LDGSTS", "dense")}
                 for fn, c in sass9.items()},
    }]


# -- phase 20: P7, streaming serving (K1, K4, K3) -------------------------------

#: The streaming server of phase 20 and its traffic: a population twice the
#: hot slab (so the store pages), Poisson windows of 8-64 steps, then
#: ragged windows of up to 400 steps (split across 200-step windows).
P7_SERVER = dict(hot_capacity=2048, max_batch=1024, max_window=200,
                 horizon_quantum=8)
P7_POPULATION = 4096
P7_POISSON = dict(seed=0, n_requests=16384, min_horizon=8, max_horizon=64)
P7_RAGGED = dict(seed=1, n_requests=8192, max_horizon=400)
#: Requests of the degradation and fault-injection runs.
P7_SMALL = 4096
P7_TRACED_PUMPS = 10
P7_SPLIT = 120


def conservation(server, path: str) -> None:
    s = server.stats().stream
    total = (s.served + s.failed + s.shed + s.expired + s.quarantined
             + server.pending)
    check(s.enqueued == total,
          f"{path}: conservation broken, enqueued {s.enqueued} != {total} "
          f"({s.as_dict()}, pending {server.pending})")


def timed_pumps(server) -> dict:
    """Wrap the server's pump stages with host clocks; returns the lists
    of seconds per call, and the window length H of every solve."""
    host = {"_assemble": [], "store.fetch": [], "solve": [],
            "_commit_batch": [], "audit": [], "H": []}

    def wrap(obj, name, key):
        fn = getattr(obj, name)

        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            host[key].append(time.perf_counter() - t0)
            return out
        setattr(obj, name, run)

    wrap(server, "_assemble", "_assemble")
    wrap(server.store, "fetch", "store.fetch")
    wrap(server, "_solve_batch", "solve")
    wrap(server, "_commit_batch", "_commit_batch")
    wrap(server.store, "check_invariants", "audit")
    run_tier = server._run_tier

    def run_recorded(tier_idx, ys, starts, thetas, H):
        host["H"].append(H)
        return run_tier(tier_idx, ys, starts, thetas, H)
    server._run_tier = run_recorded
    return host


def record_windows(name: str, rows: int, into: dict):
    """Wrap the kernel entry point ``ops.<name>`` so that the first call at
    each window length H on ``rows`` twins (a served window, not a probe)
    keeps its arguments in ``into[H]``; returns the undo."""
    fn = getattr(ops, name)

    def run(*a, **k):
        y0, u = a[1], a[2]
        H = (u.shape[-2] - 1) // 2
        if y0.shape[0] == rows and H not in into:
            into[H] = ((a[0], y0.clone(), u.clone(), a[3]), dict(k))
        return fn(*a, **k)
    setattr(ops, name, run)
    return lambda: setattr(ops, name, fn)


def hold_windows(smi, what: str, into: dict, kernel, plain,
                 phase: str = "P7") -> None:
    """Hold the kernel against its plain version on every recorded
    window's inputs, within TOL of the peak."""
    errs = {}
    for H, (a, k) in sorted(into.items()):
        errs[H] = rel_err(kernel(*a, **k), plain(*a, **k))[1]
    print(f"[{smi}] {phase} {what} vs plain on a pump's recorded inputs, max "
          f"error of the peak by H: " + ", ".join(
              f"{H}: {e:.3e}" for H, e in errs.items()) + f" (limit {TOL:g})")
    check(bool(errs), f"{phase} {what}: no window recorded")
    check(max(errs.values()) <= TOL,
          f"{phase} {what}: disagrees with its plain version at H "
          f"{max(errs, key=errs.get)}")


def k1_window_plain(params, y0, u, dt, **_):
    return ref.fused_node_rollout_ref(y0, u, [p["w"] for p in params],
                                      [p["b"] for p in params], dt)


def k4_window_plain(staged, y0, u, dt, *, read_noise, noise_seed,
                    step_offset, **_):
    return k4_plain(staged, y0, u, dt, read_noise, noise_seed, step_offset)


def stitched_by_twin(done) -> dict:
    parts = {}
    for c in sorted(done, key=lambda c: c.seq):
        parts.setdefault(c.twin_id, []).append(c.trajectory)
    return {tid: np.concatenate([p[0]] + [q[1:] for q in p[1:]])
            for tid, p in parts.items()}


def p7_streaming(dev, smi, noisy_faulty, zero_counts, read_counts):
    """Phase 20: the Lorenz96 fleet (6->64->64->6, phase 4's seeded
    weights) streamed by ``StreamingFleetServer`` on the card.  Returns
    the launch counts of its paths, and per tier the Poisson trace's
    completions and the store's ``export_state`` after it (phase 21's
    reference)."""
    cfg = recipes.FLEET
    fleet = recipes.make_l96_fleet(
        backend=FusedCudaBackend(batch_tile=cfg.batch_tile))
    params = fleet.twin.init(torch.Generator().manual_seed(SEED),
                             device="cpu")
    y0_table = (cfg.y0_spread * torch.randn(
        (P7_POPULATION, cfg.state_dim),
        generator=torch.Generator().manual_seed(SEED + 20))).numpy()

    def y0_of(tid):
        return y0_table[tid]

    poisson = traffic.poisson_trace(population=P7_POPULATION, **P7_POISSON)
    ragged = traffic.ragged_trace(population=P7_POPULATION, **P7_RAGGED)
    counts, refs = {}, {}

    def make(backend, **kw):
        return StreamingFleetServer(fleet.with_backend(backend), params,
                                    dt=cfg.dt, device=dev, **P7_SERVER, **kw)

    def fused():
        return FusedCudaBackend(batch_tile=cfg.batch_tile)

    # (a) fused_cuda, no SLO: both traces, the store audited every pump
    os.environ["REPRO_STORE_AUDIT"] = "1"
    srv = make(fused())
    check(srv._audit, "P7: REPRO_STORE_AUDIT=1 did not arm the audit")
    host = timed_pumps(srv)
    k1_windows = {}
    undo = record_windows("fused_node_rollout", P7_SERVER["max_batch"],
                          k1_windows)
    zero_counts()
    done_a, runs = [], {}
    for name, trace in (("poisson", poisson), ("ragged", ragged)):
        b0 = srv.stream_stats.batches
        s0 = srv.stream_stats.twin_steps
        p0 = srv.store.stats.page_ins
        e0 = srv.store.stats.evictions
        torch.cuda.synchronize()
        t_r = time.perf_counter()
        done = srv.serve_trace(trace, y0_of=y0_of)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t_r
        pumps = srv.stream_stats.batches - b0
        steps = srv.stream_stats.twin_steps - s0
        runs[name] = done
        if name == "poisson":
            refs["fused_cuda"] = (done, srv.store.export_state())
        done_a += done
        check(len(done) == len(trace), f"P7 {name}: {len(done)} of "
                                       f"{len(trace)} requests served")
        print(f"[{smi}] P7 fused_cuda {name} trace: {len(trace)} requests, "
              f"{pumps} pumps in {sec:.3f} s ({pumps / sec:.2f} pumps/s, "
              f"{steps / sec:,.0f} twin-steps/s, store audited every pump); "
              f"page-ins {srv.store.stats.page_ins - p0}, evictions "
              f"{srv.store.stats.evictions - e0}; splits "
              f"{srv.stream_stats.splits}")
    undo()
    conservation(srv, "P7 fused_cuda")
    batches = srv.stream_stats.batches
    counts["P7_stream_fused_cuda"] = read_counts(
        "P7 stream fused_cuda (poisson then ragged)",
        {"K1": batches, "K4": 0, "K4_noise": 0, "K3_masks": 0, "K7": 0})
    check(len(host["audit"]) == batches,
          f"P7: {len(host['audit'])} store audits for {batches} pumps")
    print(f"P7 fused_cuda: {batches} pumps, {counts['P7_stream_fused_cuda']['K1']}"
          f" K1 launches (one per pump), store audits {len(host['audit'])}")
    for key in ("_assemble", "store.fetch", "solve", "_commit_batch",
                "audit"):
        v = np.asarray(host[key]) * 1e3
        print(f"[{smi}] P7 pump host ms {key}: mean {v.mean():.3f}, median "
              f"{np.median(v):.3f}, max {v.max():.3f} over {v.size} calls")
    # the kernel's own time per pump: K1 at each pump's (1024, H), CUDA events
    ws = [p["w"].to(dev) for p in params]
    bs = [p["b"].to(dev) for p in params]
    y0_dev = torch.from_numpy(y0_table[: P7_SERVER["max_batch"]]).to(dev)
    k1_ms = {}
    for H in sorted(set(host["H"])):
        uh = torch.zeros((2 * H + 1, 0), device=dev)
        k1_ms[H] = cuda_ms(lambda: fused_ode_mlp.fused_node_rollout(
            y0_dev, uh, ws, bs, cfg.dt, batch_tile=cfg.batch_tile),
            reps=5, warmup=1)
    kernel_per_pump = float(np.mean([k1_ms[H] for H in host["H"]]))
    solve_per_pump = float(np.mean(host["solve"])) * 1e3
    print(f"[{smi}] P7 fused_cuda: K1 CUDA-event ms per pump {kernel_per_pump:.4f}"
          f" (mean over the pumps' (1024, H); H in {sorted(k1_ms)}), solve "
          f"host ms per pump {solve_per_pump:.4f}; K1 ms by H " + ", ".join(
              f"{H}: {ms:.4f}" for H, ms in sorted(k1_ms.items())))

    # K1 against its plain version at every window shape the pumps gave it
    hold_windows(smi, "K1 (fused_cuda windows)", k1_windows,
                 ops.fused_node_rollout, k1_window_plain)

    # every twin's stitched trajectory is one uninterrupted rollout, bitwise
    stitched = stitched_by_twin(done_a)
    ids = sorted(stitched)
    longest = max(s.shape[0] for s in stitched.values()) - 1
    backend, state = srv._programs[0]
    with torch.no_grad():
        full = backend.rollout_batch_resumed(
            state, torch.from_numpy(y0_table[ids]).to(dev), dt=cfg.dt,
            num_steps=longest, gradient="stopgrad").cpu().numpy()
    bad = [tid for i, tid in enumerate(ids)
           if not np.array_equal(stitched[tid],
                                 full[i, : stitched[tid].shape[0]])]
    print(f"P7 fused_cuda: {len(ids)} twins' stitched trajectories (up to "
          f"{longest} steps) vs one uninterrupted K1 rollout each: "
          f"{len(ids) - len(bad)} bitwise identical")
    check(not bad, f"P7: {len(bad)} twins differ from their uninterrupted "
                   f"rollout (first {bad[:5]})")

    # (b) analogue_fused_cuda, P2's noisy faulty spec, under an SLO
    zero_counts()
    nb = make(FusedAnalogueCudaBackend(batch_tile=cfg.batch_tile,
                                       prog_seed=SEED, read_seed=SEED,
                                       **noisy_faulty),
              slo=ServingSLO(max_rel_error=0.5))
    tiers = [n for n, _ in nb._tiers]
    check(tiers == ["analogue_fused_cuda", "analogue_fused_cuda_clean",
                    "digital"], f"P7: tiers {tiers}")
    counts["P7_program_tiers"] = read_counts(
        "P7 analogue tiers programmed (primary and quiet tier)",
        {"K3_masks": 2, "K3": 0, "K4": 0, "K1": 0})
    k4_windows = {}
    undo = record_windows("fused_analogue_rollout", P7_SERVER["max_batch"],
                          k4_windows)
    zero_counts()
    torch.cuda.synchronize()
    t_r = time.perf_counter()
    done_b = nb.serve_trace(poisson, y0_of=y0_of)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t_r
    undo()
    refs["analogue_fused_cuda"] = (done_b, nb.store.export_state())
    st = nb.stats()
    nbatch, probes = st.stream.batches, st.serving.probes
    check(probes == -(-nbatch // nb.slo.probe_every),
          f"P7 noisy: {probes} probes for {nbatch} batches")
    check(st.serving.served_by == {"analogue_fused_cuda": nbatch},
          f"P7 noisy: served_by {st.serving.served_by}")
    counts["P7_stream_analogue_noisy_faulty"] = read_counts(
        "P7 stream analogue_fused_cuda (uint8, read noise 0.02, 1% stuck, "
        "drift; SLO 0.5)", {"K3_masks": 0, "K3": 0, "K4": nbatch + probes,
                            "K4_noise": nbatch + probes, "K1": 0, "K7": 0})
    conservation(nb, "P7 noisy")
    check(len(done_b) == len(poisson), "P7 noisy: requests not all served")
    check(all(np.isfinite(c.trajectory).all() for c in done_b),
          "P7 noisy: non-finite trajectories")
    print(f"[{smi}] P7 analogue_fused_cuda noisy faulty poisson trace: "
          f"{nbatch} pumps in {sec:.3f} s ({nbatch / sec:.2f} pumps/s, "
          f"{st.stream.twin_steps / sec:,.0f} twin-steps/s); {probes} probes,"
          f" probe errors {st.serving.probe_errors}; served_by "
          f"{st.serving.served_by}")
    # K4 (read noise, offset 0) against its plain version at every window
    # shape the primary tier served
    check(all(k["step_offset"] == 0 and k["read_noise"] > 0
              for _, k in k4_windows.values()),
          "P7 noisy: a served window was not a noisy one at offset 0")
    hold_windows(smi, "K4 (noisy analogue_fused_cuda windows)", k4_windows,
                 ops.fused_analogue_rollout, k4_window_plain)
    # a whole-fleet split at step 120, through a state store, resumed with
    # the shared offset: bitwise the unsplit rollout (pre-pass + K4 each)
    backend, state = nb._programs[0]
    ys = torch.from_numpy(y0_table[: cfg.fleet_size]).to(dev)
    T = cfg.horizon
    with torch.no_grad():
        whole = backend.rollout_batch_resumed(state, ys, dt=cfg.dt,
                                              num_steps=T)
        head = backend.rollout_batch_resumed(state, ys, dt=cfg.dt,
                                             num_steps=P7_SPLIT)
        ids = list(range(ys.shape[0]))
        store = TwinStateStore(cfg.state_dim, len(ids), device=dev)
        for i in ids:
            store.register(i, y0_table[i])
        store.fetch(ids)
        store.commit(ids, head[:, P7_SPLIT], np.full(len(ids), P7_SPLIT))
        mid, steps, _ = store.fetch(ids)
        tail = backend.rollout_batch_resumed(state, mid, dt=cfg.dt,
                                             num_steps=T - P7_SPLIT,
                                             start_steps=steps)
    same = (torch.equal(head, whole[:, : P7_SPLIT + 1])
            and torch.equal(tail, whole[:, P7_SPLIT:]))
    print(f"P7 analogue noisy faulty: {len(ids)} x {T} split at step {P7_SPLIT} "
          f"through TwinStateStore and resumed at offset {P7_SPLIT}: bitwise "
          f"the unsplit rollout: {same}")
    check(same, "P7: the resumed K4 rollout is not the unsplit one")
    # the clean unquantised spec streamed: within TOL of (a)'s trajectories
    cb = make(FusedAnalogueCudaBackend(
        spec=AnalogueSpec(prog_noise=0.0, quantize=False),
        batch_tile=cfg.batch_tile))
    done_c = cb.serve_trace(poisson, y0_of=y0_of)
    check([c.seq for c in done_c] == [c.seq for c in runs["poisson"]],
          "P7 clean analogue: another completion order than fused_cuda")
    err = max(float(np.max(np.abs(c.trajectory - a.trajectory))
                    / np.max(np.abs(a.trajectory)))
              for c, a in zip(done_c, runs["poisson"]))
    print(f"P7 clean unquantised analogue stream vs fused_cuda stream: max "
          f"error of the peak {err:.3e} (limit {TOL:g})")
    check(err <= TOL, "P7: the clean analogue stream disagrees with K1's")

    # (c) degradation: unrepairable stuck cells demote to digital at the
    # first probe; a transient fault is absorbed by two retries
    small = traffic.poisson_trace(seed=2, n_requests=P7_SMALL,
                                  population=P7_POPULATION, min_horizon=8,
                                  max_horizon=64)
    db = make(FusedAnalogueCudaBackend(
        spec=AnalogueSpec(prog_noise=0.0), batch_tile=cfg.batch_tile,
        faults=make_fault_model(("stuck", dict(rate=0.3)), seed=5)),
        slo=ServingSLO(max_rel_error=0.05))
    done_d = db.serve_trace(small, y0_of=y0_of)
    sd = db.stats()
    print(f"P7 unrepairable array (30% stuck): active tier {db.active_tier},"
          f" demotions {sd.serving.probe_demotions}, probe errors "
          f"{sd.serving.probe_errors}, served_by {sd.serving.served_by}, "
          f"served {sd.stream.served} of {len(small)}, quarantined "
          f"{sd.stream.quarantined}")
    check(db.active_tier == "digital" and sd.serving.probe_demotions == 1
          and sd.serving.served_by == {"digital": sd.stream.batches}
          and len(done_d) == len(small) and sd.stream.quarantined == 0,
          "P7: the unrepairable array did not demote to digital cleanly")
    conservation(db, "P7 degraded")
    fb = make(fused(), transient_retries=2, backoff_base_s=0.0)
    with chaos.flaky("pump:run_tier", times=2):
        done_f = fb.serve_trace(small[:64], y0_of=y0_of)
    sf = fb.stats()
    print(f"P7 transient faults: 2 injected at pump:run_tier, "
          f"{sf.serving.transient_retries} retries, served {len(done_f)} of "
          f"64, served_by {sf.serving.served_by}")
    check(sf.serving.transient_retries == 2 and len(done_f) == 64
          and sf.stream.quarantined == 0,
          "P7: the transient faults were not absorbed by the retries")
    os.environ.pop("REPRO_STORE_AUDIT")

    # (d) the same 1024 x 200 request through FleetServer, then a profiler
    # trace of 10 pumps of (a)'s poisson trace (no audit)
    server = FleetServer(fleet, params, recipes.l96_fleet_ts(), device=dev)
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t_r = time.perf_counter()
        server.serve(ys)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t_r)
    h200 = [s for s, H in zip(host["solve"], host["H"]) if H == 200]
    print(f"[{smi}] P7 FleetServer 1024 x 200 request: "
          f"{secs[1] * 1e3:.3f}; {secs[2] * 1e3:.3f} ms (after one warm-up); "
          f"streaming solve of a 1024 x 200 window "
          f"{np.mean(h200) * 1e3 if h200 else float('nan'):.3f} ms "
          f"({len(h200)} pumps)")
    ps = make(fused())
    check(not ps._audit, "P7: the traced server audits")
    pumps = 0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_r = time.perf_counter()
        for a in poisson:
            if a.twin_id not in ps.store:
                ps.register_twin(a.twin_id, y0_of(a.twin_id))
            ps.submit(a.twin_id, a.horizon, t_arrival=a.time)
            if ps.pending >= ps.max_batch:
                ps.pump(now=a.time)
                pumps += 1
                if pumps == P7_TRACED_PUMPS:
                    break
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t_r) * 1e3
    kernels_us = {ev.key: ev.self_device_time_total
                  for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and ev.self_device_time_total > 0}
    busy_ms = sum(kernels_us.values()) / 1e3
    if busy_ms > 0:
        top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:5]
        print(f"[{smi}] P7 trace, {pumps} pumps of the poisson trace: wall "
              f"{traced_ms:.3f} ms ({traced_ms / pumps:.3f} ms a pump, "
              f"ingest included), device busy {busy_ms:.3f} ms (idle "
              f"{100 * (1 - busy_ms / traced_ms):.1f}%); by device time: "
              + "; ".join(f"{k[:48]} {v / 1e3:.4f} ms" for k, v in top))
    else:
        print("P7 trace: the profiler recorded no device time (device idle "
              "share not measured)")
    return counts, refs


# -- phase 21: P8, crash recovery (K1, K4, K3) ---------------------------------

#: Phase 21's durable server: phase 20's, every acknowledged journal append
#: fsync'd and a snapshot every 4 pumps.
P8_DURABLE = dict(fsync=True, snapshot_every=4)


def journal_timers(server) -> dict:
    """Wrap the server's journal with host clocks.  Inside a pump: the
    seconds and bytes of its records (commit, complete, expire) and of the
    group commit's one sync, summed per pump.  Outside: the seconds of
    each acknowledged append (register, submit), each with its own
    fsync when the journal has ``fsync=True``."""
    acc = {"pump_s": [], "pump_bytes": [], "ack_s": []}
    j, pump = server._journal, server._pump
    cur = []                    # [seconds, bytes] of the pump under way

    def timed(fn, ack: bool):
        def run(*a, **k):
            b0, t0 = j.nbytes, time.perf_counter()
            out = fn(*a, **k)
            dt = time.perf_counter() - t0
            if cur:
                cur[0] += dt
                cur[1] += j.nbytes - b0
            elif ack:
                acc["ack_s"].append(dt)
            return out
        return run

    j.append, j.sync = timed(j.append, True), timed(j.sync, False)

    def run_pump(now):
        cur[:] = [0.0, 0]
        try:
            return pump(now)
        finally:
            acc["pump_s"].append(cur[0])
            acc["pump_bytes"].append(cur[1])
            cur.clear()
    server._pump = run_pump
    return acc


def snapshot_timer(server) -> list:
    """Wrap ``server.snapshot``; returns the list of (seconds, bytes on
    disk) per snapshot."""
    out, fn = [], server.snapshot

    def run():
        t0 = time.perf_counter()
        path = fn()
        sec = time.perf_counter() - t0
        out.append((sec, sum(f.stat().st_size for f in Path(path).iterdir())))
        return path
    server.snapshot = run
    return out


def count_kill_points():
    """Count each kill point's executions; returns (counts, undo)."""
    seen, fn = {}, chaos.kill_point

    def run(name, partial=None):
        seen[name] = seen.get(name, 0) + 1
        return fn(name, partial)
    chaos.kill_point = run
    return seen, lambda: setattr(chaos, "kill_point", fn)


def same_run(got_done, got_states, want_done, want_states) -> tuple:
    """(states and steps bitwise, completion set equal, trajectories
    bitwise) of a run against a reference; ``*_states`` are
    ``export_state`` tuples, ``got_done`` may repeat a completion
    (at-least-once delivery after a recovery)."""
    ref = {c.seq: c.trajectory for c in want_done}
    traj = all(c.seq in ref and np.array_equal(c.trajectory, ref[c.seq])
               for c in got_done)
    seqs = {c.seq for c in got_done} == set(ref)
    ids, ys, steps, _ = want_states
    gids, gys, gsteps, _ = got_states
    row = {tid: i for i, tid in enumerate(gids)}
    states = (sorted(gids) == sorted(ids) and all(
        gsteps[row[t]] == steps[i] and np.array_equal(gys[row[t]], ys[i])
        for i, t in enumerate(ids)))
    return states, seqs, traj


def p8_recovery(dev, smi, noisy_faulty, zero_counts, read_counts,
                p7_refs) -> dict:
    """Phase 21: phase 20's Poisson stream with the journal and snapshots
    on, crashed at each kill point on ``fused_cuda`` (K1) and on P2's
    noisy faulty ``analogue_fused_cuda`` (K4 + K3), recovered on the card
    and resumed.  Returns the launch counts of its paths."""
    t_phase = time.perf_counter()
    cfg = recipes.FLEET
    fleet = recipes.make_l96_fleet(
        backend=FusedCudaBackend(batch_tile=cfg.batch_tile))
    params = fleet.twin.init(torch.Generator().manual_seed(SEED),
                             device="cpu")
    y0_table = (cfg.y0_spread * torch.randn(
        (P7_POPULATION, cfg.state_dim),
        generator=torch.Generator().manual_seed(SEED + 20))).numpy()

    def y0_of(tid):
        return y0_table[tid]

    poisson = traffic.poisson_trace(population=P7_POPULATION, **P7_POISSON)
    none = {"K1": 0, "K4": 0, "K4_noise": 0, "K3_masks": 0, "K3": 0,
            "K7": 0}
    tiers = {
        "fused_cuda": (FusedCudaBackend(batch_tile=cfg.batch_tile),
                       "fused_node_rollout", k1_window_plain,
                       lambda n: {**none, "K1": n}),
        "analogue_fused_cuda": (
            FusedAnalogueCudaBackend(batch_tile=cfg.batch_tile,
                                     prog_seed=SEED, read_seed=SEED,
                                     **noisy_faulty),
            "fused_analogue_rollout", k4_window_plain,
            lambda n: {**none, "K4": n, "K4_noise": n}),
    }
    counts = {}
    root = tempfile.mkdtemp(prefix="p8_serve_")
    try:
        for name, (backend, entry, plain, want) in tiers.items():
            tier_fleet = fleet.with_backend(backend)
            masks = int(name != "fused_cuda")   # one programming, stuck cells

            def make(**kw):
                return StreamingFleetServer(tier_fleet, params, dt=cfg.dt,
                                            device=dev, **P7_SERVER, **kw)

            def timed_serve(srv, **kw):
                torch.cuda.synchronize()
                t_r = time.perf_counter()
                done = srv.serve_trace(poisson, y0_of=y0_of, **kw)
                torch.cuda.synchronize()
                return done, time.perf_counter() - t_r

            if name == "fused_cuda":
                # the same stream without durability, for the rate beside
                off = make()
                _, sec_off = timed_serve(off)
                pumps_off = off.stream_stats.batches / sec_off
            # the crash-free durable run: bitwise phase 20's, and the
            # counts that place each kill point's crash mid-trace
            zero_counts()
            srv = make(durability_dir=os.path.join(root, f"{name}_clean"),
                       **P8_DURABLE)
            jt, snaps = journal_timers(srv), snapshot_timer(srv)
            seen, undo = count_kill_points()
            try:
                done, sec = timed_serve(srv)
            finally:
                undo()
            jbytes, nrec = srv._journal.nbytes, srv._journal.lsn
            srv.close()
            pumps = srv.stream_stats.batches
            counts[f"P8_durable_{name}"] = read_counts(
                f"P8 {name}: durable crash-free stream",
                {**want(pumps), "K3_masks": masks})
            ref_states = srv.store.export_state()
            ok = same_run(done, ref_states, *p7_refs[name])
            order = [c.seq for c in done] == [c.seq for c in
                                              p7_refs[name][0]]
            print(f"P8 {name}: durable crash-free run vs phase 20's run "
                  f"without durability: states bitwise {ok[0]}, completion "
                  f"set {ok[1]}, trajectories bitwise {ok[2]}, order "
                  f"{order}")
            check(all(ok) and order, f"P8 {name}: the durable run is not "
                                     f"bitwise phase 20's")
            conservation(srv, f"P8 {name} durable")
            pj, ack = np.asarray(jt["pump_s"]) * 1e3, np.asarray(
                jt["ack_s"]) * 1e3
            snap_ms = [1e3 * a for a, _ in snaps]
            print(f"[{smi}] P8 {name} journal, fsync=True: {nrec} records, "
                  f"{jbytes} bytes ({jbytes / nrec:.1f} a record), "
                  f"{np.mean(jt['pump_bytes']):.0f} bytes a pump; host ms "
                  f"per pump (records + one group fsync) mean {pj.mean():.4f}"
                  f", median {np.median(pj):.4f}, max {pj.max():.4f} over "
                  f"{pj.size} pumps; acknowledged appends (register, submit,"
                  f" fsync each) ms mean {ack.mean():.4f}, median "
                  f"{np.median(ack):.4f}, max {ack.max():.4f} over "
                  f"{ack.size}")
            print(f"[{smi}] P8 {name} snapshots: {len(snaps)} of "
                  f"{P7_POPULATION} twins, ms each " + ", ".join(
                      f"{m:.3f}" for m in snap_ms) + f"; bytes "
                  f"{[b for _, b in snaps]}")
            line = (f"[{smi}] P8 {name} durable stream: {pumps} pumps in "
                    f"{sec:.3f} s ({pumps / sec:.2f} pumps/s, fsync=True, "
                    f"snapshot every 4)")
            if name == "fused_cuda":
                # once more with fsync=False: the durability's price
                nf = make(durability_dir=os.path.join(root, "nofsync"),
                          fsync=False, snapshot_every=4)
                jf = journal_timers(nf)
                done_nf, sec_nf = timed_serve(nf)
                nf.close()
                check(all(same_run(done_nf, nf.store.export_state(), done,
                                   ref_states)),
                      "P8: the fsync=False run differs")
                pf = np.asarray(jf["pump_s"]) * 1e3
                af = np.asarray(jf["ack_s"]) * 1e3
                print(f"[{smi}] P8 {name} journal, fsync=False: host ms per "
                      f"pump mean {pf.mean():.4f}, median "
                      f"{np.median(pf):.4f}; appends ms mean "
                      f"{af.mean():.4f}")
                line += (f"; fsync=False {nf.stream_stats.batches / sec_nf:.2f}"
                         f" pumps/s; without durability {pumps_off:.2f} "
                         f"pumps/s")
            print(line)
            hits = {k: max(1, seen.get(k, 0) // 2) for k in chaos.KILL_POINTS}
            print(f"P8 {name}: kill points' executions in the crash-free run "
                  f"{seen}; crash hits (mid-trace) {hits}")

            for kill in chaos.KILL_POINTS:
                tag = f"P8 {name} {kill}"
                d = os.path.join(root, f"{name}_{kill.replace(':', '_')}")
                live = make(durability_dir=d, **P8_DURABLE)
                delivered, fired = [], False
                try:
                    with chaos.crash_at(kill, hit=hits[kill]):
                        live.serve_trace(poisson, y0_of=y0_of,
                                         sink=delivered)
                except chaos.SimulatedCrash:
                    fired = True
                live.close()
                check(fired, f"{tag}: hit {hits[kill]} never fired")
                # the commits recovery must replay, read independently
                records, _, _ = journal_lib.read_journal(
                    journal_lib.journal_path(d))
                snap = journal_lib.load_latest_snapshot(d)
                start = 1 if snap is None else snap[0]
                replayed = sum(r["t"] == "commit" for r in records[start:])
                windows = {}
                zero_counts()
                undo = record_windows(entry, P7_SERVER["max_batch"], windows)
                try:
                    t_r = time.perf_counter()
                    rec, redelivered = StreamingFleetServer.recover(
                        d, tier_fleet, params, device=dev)
                    torch.cuda.synchronize()
                    rec_ms = (time.perf_counter() - t_r) * 1e3
                finally:
                    undo()
                counts[f"P8_recover_{name}_{kill}"] = read_counts(
                    f"{tag}: recover", {**want(replayed), "K3_masks": masks})
                r = rec.recovery
                check(r.commits == replayed,
                      f"{tag}: recover replayed {r.commits} commits of "
                      f"{replayed}")
                if windows:
                    hold_windows(smi, f"{name} {kill}: replayed windows",
                                 windows,
                                 getattr(ops, entry), plain, phase="P8")
                zero_counts()
                b0 = rec.stream_stats.batches
                resumed = rec.serve_trace(poisson, y0_of=y0_of,
                                          start=rec.stream_stats.enqueued)
                rec.close()
                counts[f"P8_resume_{name}_{kill}"] = read_counts(
                    f"{tag}: resume", want(rec.stream_stats.batches - b0))
                got = delivered + list(redelivered) + list(resumed)
                ok = same_run(got, rec.store.export_state(), done, ref_states)
                print(f"[{smi}] {tag}: crashed at hit {hits[kill]} after "
                      f"{len(delivered)} deliveries; recover {rec_ms:.3f} ms "
                      f"(journal read {1e3 * r.journal_read_s:.3f}, build and "
                      f"program {1e3 * r.build_s:.3f}, snapshot load "
                      f"{1e3 * r.snapshot_load_s:.3f}, replay "
                      f"{1e3 * r.replay_s:.3f} of {r.records} records, "
                      f"{r.commits} commits: "
                      f"{1e3 * r.replay_s / max(r.commits, 1):.3f} ms a "
                      f"commit); {len(redelivered)} redelivered, "
                      f"{len(resumed)} served after the resume")
                print(f"{tag}: states bitwise {ok[0]}, completion set "
                      f"{ok[1]}, trajectories bitwise {ok[2]}")
                check(all(ok), f"{tag}: recovery is not the crash-free run")
                conservation(rec, tag)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[{smi}] phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return counts



# -- phase 22: P9, the training engines (CUDA graphs of the step) --------------

#: Steps of each P9 run, and the chunk of the chunked fit: 37 is not a
#: multiple of the engine's unroll (8), so a remainder graph runs (blocks
#: of 8 and 5 for the first chunk, one of 8 for the second).
P9_STEPS = 45
P9_CHUNK = 37
P9_UNROLL = 8
#: Replays timed after the bitwise runs: the step graph, and the 8-step
#: graph of the chunk engine.
P9_TIMED_STEPS = 16
P9_TIMED_CHUNKS = 3
#: P9's launch counters (phase 22 holds each to its per-step count times
#: the steps).
P9_COUNTERS = {"K1": (fused_ode_mlp, "LAUNCHES"),
               "K2": (fused_ode_mlp_bwd, "LAUNCHES"),
               "K3_write": (noise, "WRITE_LAUNCHES"),
               "K5": (softdtw, "LAUNCHES"),
               "K6": (softdtw, "BWD_LAUNCHES")}


def p9_paths(dev, l96_twin, l96_params, l96_data, data96) -> list:
    """Phase 22's training paths: (name, shape, loss_fn, params, optimizer,
    generator seed, kernel launches per step)."""
    ts, xs, _, _ = hp.generate("sine", num_points=500, dt=1e-3,
                               amp=recipes.HP_AMP, freq=recipes.HP_FREQ,
                               device=dev)
    tw = make_driven_twin(1, hp.WAVEFORMS["sine"](
        amp=recipes.HP_AMP, freq=recipes.HP_FREQ), hidden=14)
    p0 = tw.init(torch.Generator().manual_seed(42), device=dev)
    hp_seg = trainer.make_segments(ts, xs[:, None], 50)
    cfg = HwAwareConfig(spec=spec_from_calibration(CALIBRATION),
                        k_draws=P6_DRAWS)
    l96_ts, l96_ys, l96_split = l96_data
    l96_seg = trainer.make_segments(l96_ts[:l96_split], l96_ys[:l96_split], 60)
    ts96, ys96, split96 = data96
    fused = {"K1": 1, "K2": 1}
    paths = [
        ("hp_fused", "9 x 50", trainer.segment_loss_fn(
            tw, *hp_seg, "l1", noise_std=0.002, backend="fused_cuda"),
         p0, adam(1e-3), 1, fused),
        ("l96_fused", "14 x 60", trainer.segment_loss_fn(
            l96_twin, *l96_seg, "l1", noise_std=0.02, backend="fused_cuda"),
         l96_params, adam(1e-3, weight_decay=1e-4), SEED + 22, fused)]
    for seg in (60, 200):
        segs = trainer.make_segments(ts96[:split96], ys96[:split96], seg)
        paths.append((
            f"p4_{seg}", f"{segs[0].shape[0]} x {seg}",
            trainer.segment_loss_fn(
                l96_twin, *segs, L96_CONFIG.loss, 0.1,
                noise_std=L96_CONFIG.noise_regulariser, backend="fused_cuda"),
            l96_params, adam(4e-4), SEED + seg,
            {"K1": 1, "K2": 1, "K5": 1, "K6": 1}))
    paths += [
        ("p6_hw_aware", f"9 x 50, k_draws {P6_DRAWS}",
         trainer.segment_loss_fn(tw, *hp_seg, "l1", noise_std=0.002,
                                 backend="fused_cuda", hw_aware=cfg),
         p0, adam(1e-3), 1, {"K3_write": 1, "K1": P6_DRAWS,
                             "K2": P6_DRAWS}),
        ("hp_digital_adjoint", "9 x 50", trainer.segment_loss_fn(
            tw, *hp_seg, "l1", noise_std=0.002), p0, adam(1e-3), 1, {})]
    return paths


def p9_blocks() -> tuple:
    """The graph lengths ``fit(scan_chunk=P9_CHUNK)`` captures over
    P9_STEPS steps at the engine's unroll, and its replays."""
    lengths, replays, done = set(), 0, 0
    while done < P9_STEPS:
        n = min(P9_CHUNK, P9_STEPS - done)
        u = min(P9_UNROLL, n)
        lengths.add(u)
        replays += n // u
        if n % u:
            lengths.add(n % u)
            replays += 1
        done += n
    return sorted(lengths), replays


def p9_trace(fn, steps: int) -> dict:
    """``fn`` (``steps`` training steps) under ``torch.profiler``: the host
    wall ms to a device sync, the device busy ms (kernels and copies, the
    union of their intervals), the span from the first device event's
    start to the last one's end, the kernels and copies per step, and the
    idle shares of the wall and of the span (the wall carries the trace's
    own host cost; the span only the gaps between device events)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_GUARD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILER_GUARD_S)
    dev_events = [ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(ev.name.startswith(("Memcpy", "Memset"))
                 for ev in dev_events)
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in dev_events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                     # the union of the intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e3
    span = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
    return dict(wall_ms=wall, busy_ms=busy, span_ms=span,
                kernels_per_step=(len(dev_events) - copies) / steps,
                copies_per_step=copies / steps,
                idle=(1 - busy / wall) if busy > 0 else None,
                idle_span=(1 - busy / span) if busy > 0 else None)


def p9_engines(dev, smi, l96_twin, l96_params, l96_data, data96) -> dict:
    """Phase 22 (P9): each training path 45 steps three ways from the same
    params and seed: the eager loop (``fit_eager``, the oracle), the
    per-step graph (``fit_per_step``) and the chunk graphs (``fit`` at
    ``scan_chunk=37``); histories and final params bitwise, launches equal
    to the per-step counts times the steps on both replayed runs; then ms
    per step of each (host clock to a sync, and CUDA events), the graphs
    captured and replayed, and a profiler trace of one replayed 8-step
    chunk (kernels per step, busy ms, idle shares).
    Returns the replayed runs' launch counts and the numbers by path."""
    t_phase = time.perf_counter()
    engines = {"step": [], "chunk": []}
    real = {"step": trainer.make_step_fn, "chunk": trainer.make_scan_engine}

    def spy(kind):
        def make(*a, **kw):
            fn = real[kind](*a, **kw)
            engines[kind].append(fn.engine)
            return fn
        return make

    def zero():
        for mod, name in P9_COUNTERS.values():
            setattr(mod, name, 0)

    def counts():
        torch.cuda.synchronize()
        return {k: getattr(mod, name) for k, (mod, name) in
                P9_COUNTERS.items()}

    def timed(fn, steps):
        """fn() over ``steps`` steps: (host ms, CUDA-event ms) a step."""
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        out = fn()
        ev1.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / steps
        return out, host, ev0.elapsed_time(ev1) / steps

    out, launch_counts = {}, {}
    trainer.make_step_fn = spy("step")
    trainer.make_scan_engine = spy("chunk")
    try:
        for name, shape, loss, p0, opt, seed, per_step in p9_paths(
                dev, l96_twin, l96_params, l96_data, data96):
            def gen():
                return torch.Generator().manual_seed(seed)
            want = {k: P9_STEPS * per_step.get(k, 0) for k in P9_COUNTERS}
            zero()
            (pe, he), eager_host, eager_ev = timed(
                lambda: trainer.fit_eager(loss, p0, opt, P9_STEPS, gen()),
                P9_STEPS)
            eager_counts = counts()
            runs = {}
            for kind, run in (
                    ("step", lambda: trainer.fit_per_step(
                        loss, p0, opt, P9_STEPS, gen())),
                    ("chunk", lambda: trainer.fit(
                        loss, p0, opt, P9_STEPS, gen(),
                        scan_chunk=P9_CHUNK))):
                zero()
                (pr, hr), host, ev = timed(run, P9_STEPS)
                c = counts()
                eng = engines[kind][-1]
                same_h = torch.equal(hr, he)
                same_p = all(torch.equal(a, b) for a, b in
                             zip(tree_leaves(pr), tree_leaves(pe)))
                runs[kind] = dict(counts=c, first_host_ms=host,
                                  first_event_ms=ev, engine=eng,
                                  bitwise=same_h and same_p)
                launch_counts[f"P9_{name}_{kind}_graph"] = c
                print(f"P9 {name} ({shape}) {kind} graph: loss history "
                      f"bitwise the eager loop's: {same_h}; final params "
                      f"bitwise: {same_p}; launches {c} (want {want}; eager "
                      f"loop {eager_counts}); graphs captured "
                      f"{eng.captures} (lengths {sorted(eng.blocks)}), "
                      f"replayed {eng.replays}")
                check(same_h and same_p, f"P9 {name}: the {kind} graph's "
                                         f"run differs from the eager loop")
                check(c == want and eager_counts == want,
                      f"P9 {name}: {kind} graph launches {c}, eager "
                      f"{eager_counts}, want {want}")
            eng_s, eng_c = runs["step"]["engine"], runs["chunk"]["engine"]
            check(eng_s.captures == 1 and eng_s.replays == P9_STEPS,
                  f"P9 {name}: step graph captured {eng_s.captures} times, "
                  f"replayed {eng_s.replays}")
            lengths, replays = p9_blocks()
            check(sorted(eng_c.blocks) == lengths
                  and eng_c.captures == len(lengths)
                  and eng_c.replays == replays,
                  f"P9 {name}: chunk graphs of lengths "
                  f"{sorted(eng_c.blocks)}, {eng_c.captures} captures, "
                  f"{eng_c.replays} replays; want {lengths}, {replays}")
            # steady state: replays of the captured graphs alone
            _, step_host, step_ev = timed(
                lambda: [eng_s.run(1) for _ in range(P9_TIMED_STEPS)],
                P9_TIMED_STEPS)
            _, chunk_host, chunk_ev = timed(
                lambda: [eng_c.run(P9_UNROLL) for _ in range(P9_TIMED_CHUNKS)],
                P9_TIMED_CHUNKS * P9_UNROLL)
            tr_chunk = p9_trace(lambda: eng_c.run(P9_UNROLL), P9_UNROLL)
            idle = ("not measured (no device time in the trace)"
                    if tr_chunk["idle"] is None
                    else f"{100 * tr_chunk['idle']:.1f}% of the wall, "
                         f"{100 * tr_chunk['idle_span']:.1f}% of the device "
                         f"span ({tr_chunk['span_ms']:.3f} ms)")
            print(f"[{smi}] P9 {name} ({shape}), ms a step: eager "
                  f"{eager_host:.4f} host / {eager_ev:.4f} events; step graph "
                  f"{step_host:.4f} / {step_ev:.4f}; chunk graph "
                  f"{chunk_host:.4f} / {chunk_ev:.4f} (eager / chunk "
                  f"{eager_host / chunk_host:.2f}x on the host clock); "
                  f"whole 45-step runs with warm-up and capture: step "
                  f"{runs['step']['first_host_ms']:.4f}, chunk "
                  f"{runs['chunk']['first_host_ms']:.4f}")
            busy_step = tr_chunk["busy_ms"] / P9_UNROLL
            print(f"[{smi}] P9 {name} trace of one replayed {P9_UNROLL}-step "
                  f"chunk: wall {tr_chunk['wall_ms']:.3f} ms, device busy "
                  f"{tr_chunk['busy_ms']:.3f} ms ({busy_step:.4f} a step "
                  f"against {chunk_ev:.4f} untraced: idle "
                  f"{100 * (1 - busy_step / chunk_ev):.1f}% untraced), "
                  f"traced idle {idle}; "
                  f"{tr_chunk['kernels_per_step']:.1f} kernels and "
                  f"{tr_chunk['copies_per_step']:.2f} copies a step")
            out[name] = dict(
                shape=shape, eager_ms=eager_host, eager_event_ms=eager_ev,
                step_graph_ms=step_host, step_graph_event_ms=step_ev,
                chunk_graph_ms=chunk_host, chunk_graph_event_ms=chunk_ev,
                chunk_idle=tr_chunk["idle"],
                chunk_idle_of_span=tr_chunk["idle_span"],
                chunk_busy_ms_per_step=busy_step,
                chunk_idle_untraced=1 - busy_step / chunk_ev,
                chunk_kernels_per_step=tr_chunk["kernels_per_step"],
                chunk_copies_per_step=tr_chunk["copies_per_step"],
                captures={k: runs[k]["engine"].captures for k in runs},
                replays={k: runs[k]["engine"].replays for k in runs})
            del runs, eng_s, eng_c
            engines["step"].clear()
            engines["chunk"].clear()
    finally:
        trainer.make_step_fn = real["step"]
        trainer.make_scan_engine = real["chunk"]
    print(f"[{smi}] phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return dict(counts=launch_counts, paths=out)

# -- phase 23: P10, the paper's energy scorecard on the card (K1w, K4w) -------

#: The scorecard twin's rollout shapes of phase 23 as (B, T): the
#: scorecard's single Lorenz96 twin over its 1800 steps, and P3's fleet.
P10_SHAPES = ((1, 1800), (1024, 50))
#: K1w forced at the twins' 6->64->64->6 against the resident K1: of the
#: peak (the two differ in the last layer's summation order only).
P10_FORCED_TOL = 1e-5
#: Iterations of each barrier in the cluster-barrier probe.
P10_PROBE_ITERS = 10_000
#: The scorecard's counts on the host CPU, in a process of its own that
#: runs beside the card's work: (workload, backend, counted MACs) rows.
P10_CPU_COUNTS = r"""
import json, sys
import torch
torch.set_num_threads(2)
sys.path.insert(0, sys.argv[1])
from repro_torch.core import scorecard
rows = scorecard.backend_rows(device="cpu")
print(json.dumps([[r["workload"], r["backend"], r["counted"]["macs"]]
                  for r in rows]))
"""


def timed_once(fn):
    """(``fn()``, the CUDA-event ms of that one call): a plain version that
    runs for seconds is timed on its checked run."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def kw_sync_cycles(cluster: int, threads: int) -> dict:
    """SM cycles, on a cluster of ``cluster`` CTAs of ``threads`` threads,
    of one cluster barrier, one block barrier, and one exchange of the
    last layer's partials as K1w/K4w make it (a cluster barrier, every
    rank's partial loaded and summed in rank order, a block barrier;
    ``exchange_push``: the partials stored into every rank first): the
    probe ``kw_sync_probe`` of ``csrc/fused_wide.cu``."""
    fn = _build.load("fused_wide").kw_sync_probe
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    out = torch.zeros(4, dtype=torch.int64, device="cuda")
    err = fn(cluster, threads, P10_PROBE_ITERS, out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"P10: the barrier probe failed to launch ({err})")
    torch.cuda.synchronize()
    c = [x / P10_PROBE_ITERS for x in out.cpu().tolist()]
    return dict(zip(("cluster", "block", "exchange", "exchange_push"), c))


def kw_barriers(sizes, noisy: bool) -> tuple:
    """(cluster barriers, block barriers) of one K1w / K4w evaluation: a
    block barrier after each layer but the last and after the RK4 update,
    a cluster barrier before the rank sum and before each gather of a
    hidden vector (MLPs deeper than three layers), a block barrier after
    each gather; under read noise a block barrier before each layer (its
    slice of the noisy pairs has landed)."""
    L = len(sizes) - 1
    gathers = max(0, L - 3)
    return 1 + gathers, L + gathers + (L if noisy else 0)


def kw_chain_cycles(sizes, noisy: bool, cyc: dict) -> float:
    """SM cycles one K1w / K4w evaluation cannot go below whatever its
    products cost: the exchange of the partials (one cluster barrier and
    one block barrier in it), the other cluster and block barriers."""
    nc, nb = kw_barriers(sizes, noisy)
    return (cyc["exchange"] + (nc - 1) * cyc["cluster"]
            + (nb - 1) * cyc["block"])


def p10_scorecard(dev, smi, wide_params, y0_wide, ts_wide, p3,
                  zero_counts, read_counts) -> dict:
    """Phase 23: the paper's energy scorecard on the card.  K1w and K4w
    (the wide cluster kernels) at the scorecard twin's 6->512->512->6
    against their plain versions, then ``scorecard()`` on the four
    backends with the counts held against the host CPU's.  P3's fleet
    (``wide_params``, ``y0_wide`` over ``ts_wide``) and its trajectory on
    K7 (``p3``) give the fleet shape.  Returns the main path's launch
    counts, the kernels' JSON entries and the rows."""
    t_phase = time.perf_counter()
    cpu = subprocess.Popen([sys.executable, "-c", P10_CPU_COUNTS,
                            str(ROOT / "src")], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        out = _p10(dev, smi, wide_params, y0_wide, ts_wide, p3, zero_counts,
                   read_counts, cpu)
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
    print(f"[{smi}] phase 23 took {time.perf_counter() - t_phase:.1f} s")
    return out


def _p10(dev, smi, wide_params, y0_wide, ts_wide, p3, zero_counts,
         read_counts, cpu) -> dict:
    sizes = (6, 512, 512, 6)
    gen = torch.Generator().manual_seed(SEED + 23)
    ws = [p["w"] for p in wide_params]
    bs = [p["b"] for p in wide_params]
    dt_sc = 1.0 / 1800
    dt_wide = uniform_dt(ts_wide, "P3")
    inputs = {}
    for B, T in P10_SHAPES:
        y0 = (0.5 * torch.randn((B, 6), generator=gen)).to(dev) if B == 1 \
            else y0_wide
        inputs[B, T] = (y0, torch.zeros((2 * T + 1, 0), device=dev),
                        dt_sc if B == 1 else dt_wide)
    for (B, T) in P10_SHAPES:
        g = fused_ode_mlp.launch_geometry(B, sizes)
        check(g.cluster == fused_ode_mlp.WIDE_CLUSTER,
              f"P10: {sizes} at B={B} is not on the cluster launch ({g})")
        n_active = ctypes.c_int(0)
        fn = _build.load("fused_wide").kw_max_active_clusters
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong,
                                            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(0, g.cluster, g.twins_per_block, g.threads, g.smem_bytes,
                 ctypes.byref(n_active))
        check(err == 0 and n_active.value >= 1,
              f"P10: no cluster of {g} fits the card ({err})")
        print(f"P10 K1w at B={B}: {geometry_str(g)}, clusters of "
              f"{g.cluster} CTAs, {n_active.value} clusters resident at once")
    entries, times = {}, {}

    # K1w against its plain version, twice bitwise; forced at 6->64->64->6
    # against the resident K1
    errs, plain_ms = {}, {}
    for (B, T), (y0, u, dt) in inputs.items():
        got = fused_ode_mlp.fused_node_rollout(y0, u, ws, bs, dt,
                                               batch_tile=B)
        again = fused_ode_mlp.fused_node_rollout(y0, u, ws, bs, dt,
                                                 batch_tile=B)
        want, plain_ms[B, T] = timed_once(
            lambda: ref.fused_node_rollout_ref(y0, u, ws, bs, dt))
        errs[B, T] = rel_err(got, want)
        same = torch.equal(got, again)
        print(f"[{smi}] P10 K1w ({B}, {T}) vs plain: max abs err "
              f"{errs[B, T][0]:.3e}, of peak {errs[B, T][1]:.3e} (limit "
              f"{TOL:g}); repeat bitwise: {same}")
        check(bool(torch.isfinite(got).all()) and errs[B, T][1] <= TOL,
              f"P10: K1w disagrees with its plain version at ({B}, {T})")
        check(same, f"P10: two K1w runs differ at ({B}, {T})")
    small = (6, 64, 64, 6)
    params, y0s, us = make_case(gen, small, 1024, 200, "none", dev)
    sw = [p["w"] for p in params]
    sb = [p["b"] for p in params]
    resident = fused_ode_mlp.fused_node_rollout(y0s, us, sw, sb, 0.0025,
                                                batch_tile=1024)
    for rt in (4, 1):
        g = fused_ode_mlp.wide_geometry(1024, small, twins_per_block=rt)
        forced = fused_ode_mlp.fused_node_rollout_at(g, y0s, us, sw, sb,
                                                     0.0025)
        torch.cuda.synchronize()
        e = rel_err(forced, resident)
        print(f"[{smi}] P10 K1w forced at {small} (1024, 200), {rt} twin(s) "
              f"per cluster, vs the resident K1: max abs err {e[0]:.3e}, of "
              f"peak {e[1]:.3e} (limit {P10_FORCED_TOL:g})")
        check(e[1] <= P10_FORCED_TOL,
              f"P10: forced K1w disagrees with the resident K1 ({rt})")

    # K4w against its plain version: clean float, noisy faulty uint8,
    # clean uint8, each repeat bitwise
    k4_cases = {
        "float_clean": (dict(spec=AnalogueSpec()), 0.0),
        "uint8_noise_stuck_drift": (dict(
            spec=AnalogueSpec(prog_noise=0.0, read_noise=0.02),
            storage="uint8", faults=make_fault_model(
                ("stuck", dict(rate=0.01)), "drift", seed=SEED)), 0.02),
        "uint8_clean": (dict(spec=AnalogueSpec(prog_noise=0.0),
                             storage="uint8"), 0.0),
    }
    wide_twin = make_autonomous_twin(6, hidden=512)
    staged = {}
    k4_errs = {}
    for name, (kw, noise) in k4_cases.items():
        be = FusedAnalogueCudaBackend(prog_seed=SEED, read_seed=SEED, **kw)
        staged[name] = be.program(wide_twin.node.field, wide_params).extra
        st = staged[name]
        for (B, T), (y0, u, dt) in inputs.items():
            run = functools.partial(
                ops.fused_analogue_rollout, st, y0, u, dt, batch_tile=B,
                read_noise=noise, noise_seed=SEED)
            got, again = run(), run()
            want, plain_ms[name, B, T] = timed_once(
                lambda: k4_plain(st, y0, u, dt, noise, SEED))
            e = k4_errs[name, B, T] = rel_err(got, want)
            same = torch.equal(got, again)
            print(f"[{smi}] P10 K4w {name} ({B}, {T}) vs plain: max abs err "
                  f"{e[0]:.3e}, of peak {e[1]:.3e} (limit {TOL:g}); repeat "
                  f"bitwise: {same}")
            check(bool(torch.isfinite(got).all()) and e[1] <= TOL,
                  f"P10: K4w {name} disagrees with its plain version at "
                  f"({B}, {T})")
            check(same, f"P10: two K4w {name} runs differ at ({B}, {T})")
    # clean uint8 K4w at P3's deployment against AnalogueBackend on K7
    fleet_k4 = TwinFleet(wide_twin.with_backend(FusedAnalogueCudaBackend(
        spec=AnalogueSpec(prog_noise=0.0), storage="uint8", prog_seed=SEED)))
    with torch.no_grad():
        got = fleet_k4.rollout_batch(wide_params, y0_wide, ts_wide)
    torch.cuda.synchronize()
    e = rel_err(got, p3)
    print(f"[{smi}] P10 K4w uint8 clean at P3's deployment (1024 x 50) vs "
          f"AnalogueBackend on K7 (P3): max abs err {e[0]:.3e}, of peak "
          f"{e[1]:.3e} (limit {TOL:g})")
    check(e[1] <= TOL, "P10: K4w disagrees with the simulator on K7")

    # times, bounds and the chain of barriers
    g1 = fused_ode_mlp.launch_geometry(1, sizes)
    cyc = kw_sync_cycles(g1.cluster, g1.threads)
    print(f"[{smi}] P10 on a cluster of {g1.cluster} x {g1.threads} "
          f"threads, SM cycles: cluster barrier {cyc['cluster']:.1f}, block "
          f"barrier {cyc['block']:.1f}, exchange of the partials "
          f"{cyc['exchange']:.1f} (pushed instead: "
          f"{cyc['exchange_push']:.1f})")

    def chain_ms(T, noisy):
        return 4 * T * kw_chain_cycles(sizes, noisy, cyc) / SM_CLOCK * 1e3

    for (B, T), (y0, u, dt) in inputs.items():
        reps = 5 if B == 1 else 10
        ms = cuda_ms(lambda: fused_ode_mlp.fused_node_rollout(
            y0, u, ws, bs, dt, batch_tile=B), reps)
        plain = plain_ms[B, T]
        bnd, by, gf, mb = k1_bound(sizes, B, T, u)
        row = {"ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
               "chain_bound_ms": chain_ms(T, False),
               "max_abs_err": errs[B, T][0],
               "max_rel_err_of_peak": errs[B, T][1]}
        times["K1w", B, T] = row
        print(f"[{smi}] P10 K1w ({B}, {T}): {ms:.4f} ms (CUDA events, "
              f"{reps} runs), plain {plain:.4f} ms (its checked run); "
              f"bound {bnd:.4f} ms "
              f"({by}: {gf:.3f} GFLOP, {mb:.3f} MB), chain bound "
              f"{row['chain_bound_ms']:.4f} ms ({4 * T} evaluations x "
              f"{kw_chain_cycles(sizes, False, cyc):.1f} cycles: the "
              f"exchange and {kw_barriers(sizes, False)} cluster/block "
              f"barriers in all)")
        for name, (_, noise) in k4_cases.items():
            if name == "uint8_clean":
                continue
            st = staged[name]
            ms = cuda_ms(lambda: ops.fused_analogue_rollout(
                st, y0, u, dt, batch_tile=B, read_noise=noise,
                noise_seed=SEED), 3 if noise else reps)
            plain = plain_ms[name, B, T]
            bnd, by = bound(*k4_work(st, y0, u, T, noise > 0))
            row = {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                   "bound_by": by, "chain_bound_ms": chain_ms(T, noise > 0),
                   "max_abs_err": k4_errs[name, B, T][0],
                   "max_rel_err_of_peak": k4_errs[name, B, T][1]}
            times["K4w", name, B, T] = row
            print(f"[{smi}] P10 K4w {name} ({B}, {T}): {ms:.4f} ms (CUDA "
                  f"events, pre-pass and chunks included), plain "
                  f"{plain:.4f} ms; bound {bnd:.4f} ms ({by}), chain bound "
                  f"{row['chain_bound_ms']:.4f} ms")

    # what an evaluation costs besides the 512-wide product: K1w forced at
    # the twins' 6->64->64->6 over the scorecard's 1800 steps, beside the
    # resident K1 there
    p_s, y_s, u_s = make_case(gen, small, 1, 1800, "none", dev)
    w_s = [p["w"] for p in p_s]
    b_s = [p["b"] for p in p_s]
    g_s = fused_ode_mlp.wide_geometry(1, small)
    f_ms = cuda_ms(lambda: fused_ode_mlp.fused_node_rollout_at(
        g_s, y_s, u_s, w_s, b_s, dt_sc), 5)
    r_ms = cuda_ms(lambda: fused_ode_mlp.fused_node_rollout(
        y_s, u_s, w_s, b_s, dt_sc, batch_tile=1), 5)
    times["K1w_forced_64"] = {"ms": f_ms, "resident_k1_ms": r_ms}
    print(f"[{smi}] P10 K1w forced at {small} (1, 1800): {f_ms:.4f} ms "
          f"({f_ms / 7200 * 1e3:.3f} us an evaluation); the resident K1 "
          f"there {r_ms:.4f} ms")

    # the 1800-step rollout's wall time on each substrate (host clock to a
    # device sync, deployment excluded; the fused ones warmed up by a first
    # run, the unfused ones' seconds of small launches run once)
    wall = {}
    for name in scorecard.BACKEND_SUBSTRATE:
        be = resolve_backend(name)
        twin, params, ts, y0 = scorecard._build_twin(scorecard.LORENZ96,
                                                     device=dev)
        state = be.program(twin.node.field, params)
        fused = isinstance(be, FusedCudaBackend)
        grad = "stopgrad" if fused else "direct"
        secs = []
        for _ in range(2 if fused else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                be.rollout(state, y0, ts, gradient=grad)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        wall[name] = secs[-1] * 1e3
        print(f"[{smi}] P10 Lorenz96 1800-step rollout on {name}: "
              f"{secs[-1] * 1e3:.3f} ms ({len(secs)} run(s), the first "
              f"{secs[0] * 1e3:.3f} ms)")

    # the main path: scorecard() on the card, counts against the CPU's
    zero_counts()
    sc = scorecard.scorecard(device=dev)
    counts = read_counts("P10 scorecard() on the card", {
        "K1": 1, "K1w": 1, "K4": 1, "K4w": 1, "K4_noise": 0, "K2": 0,
        "K7": 0})
    scorecard.assert_anchors(sc["anchors"])
    for r in sc["anchors"]:
        print(f"P10 anchor {r['workload']}/{r['name']}: model "
              f"{r['model']:.3f} vs paper {r['paper']:.3f} (rel err "
              f"{r['rel_err']:.4f}, limit {r['tol']:g})")
    stdout, stderr = cpu.communicate(timeout=900)
    check(cpu.returncode == 0,
          f"P10: the CPU count process failed ({cpu.returncode}): {stderr}")
    cpu_macs = {(w, b): m for w, b, m in json.loads(stdout.splitlines()[-1])}
    want_kernels = {("hp", "fused_cuda"): {"K1": 1},
                    ("lorenz96", "fused_cuda"): {"K1w": 1},
                    ("hp", "analogue_fused_cuda"): {"K4": 1},
                    ("lorenz96", "analogue_fused_cuda"): {"K4w": 1}}
    for r in sc["backends"]:
        key = (r["workload"], r["backend"])
        c = r["counted"]
        print(f"P10 row {key}: counted {c['macs']:.6e} MACs (CPU "
              f"{cpu_macs[key]:.6e}, model {r['model_macs']:.6e}), "
              f"traffic {c['traffic_bytes']}, kernels {c['kernels']}; "
              f"projected {r['projected']['time_us']:.3f} us, "
              f"{r['projected']['energy_uj']:.3f} uJ")
        check(c["macs"] == cpu_macs[key],
              f"P10: {key} counts {c['macs']} MACs on the card, "
              f"{cpu_macs[key]} on the CPU")
        if r["backend"] == "digital":
            check(c["macs"] == r["model_macs"],
                  f"P10: {key} counted MACs differ from the model's")
        check(c["kernels"] == want_kernels.get(key, {}),
              f"P10: {key} reported kernels {c['kernels']}")

    one, fleet = P10_SHAPES
    k1w, k4c = times["K1w", *one], times["K4w", "float_clean", *one]
    k4n = times["K4w", "uint8_noise_stuck_drift", *one]
    entries = [{
        "name": "fused_node_rollout_wide",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_wide.cu",
        "replaces": "src/repro/kernels/fused_ode_mlp.py:390",
        "launches": counts["K1w"],
        "launches_by_path": {"P10_scorecard": counts["K1w"]},
        "shape": f"scorecard Lorenz96 B={one[0]} T={one[1]} 6-512-512-6",
        **{k: k1w[k] for k in ("max_abs_err", "max_rel_err_of_peak", "ms",
                               "plain_ms", "bound_ms", "bound_by",
                               "chain_bound_ms")},
        "library_ms": None,
        "fleet_shape": {"B": fleet[0], "T": fleet[1],
                        **times["K1w", *fleet]},
        "forced_6_64_64_6": times["K1w_forced_64"],
    }, {
        "name": "fused_analogue_rollout_wide",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_wide.cu",
        "replaces": "src/repro/kernels/fused_analogue.py:208",
        "launches": counts["K4w"],
        "launches_by_path": {"P10_scorecard": counts["K4w"]},
        "shape": f"scorecard Lorenz96 B={one[0]} T={one[1]} 6-512-512-6, "
                 f"float clean",
        **{k: k4c[k] for k in ("max_abs_err", "max_rel_err_of_peak", "ms",
                               "plain_ms", "bound_ms", "bound_by",
                               "chain_bound_ms")},
        "library_ms": None,
        "noisy_shape": {"case": "uint8_noise_stuck_drift", **k4n},
        "fleet_shape": {"B": fleet[0], "T": fleet[1],
                        **times["K4w", "float_clean", *fleet]},
        "fleet_noisy_shape": times["K4w", "uint8_noise_stuck_drift",
                                   *fleet],
    }]
    return {"counts": {"P10_scorecard": counts}, "kernels": entries,
            "rows": sc["backends"], "wall_ms": wall,
            "barrier_cycles": cyc}


# -- phase 24: P11, the paper's comparisons and dopri5 on the card (K7) ------

#: JAX's analogue dopri5 gate (``tests/test_backends.py:242``).
P11_ATOL, P11_RTOL = 5e-4, 1e-4
#: digital dopri5 against RK4 at 8 sub-steps, of the peak.
P11_RK4_TOL = 1e-3
#: the HP twin's dopri5 runs: the first intervals of its evaluation grid
#: (one host sync per adaptive step, ~3 ms of host each on the card).
P11_HP_INTERVALS = 100
#: the noisy HP fleet: twins, and the intervals of the HP grid it runs.
P11_NOISY_TWINS = 8
P11_NOISY_INTERVALS = 15
#: a row of the noisy fleet against its single-twin rollout, of the peak.
P11_SELF_TOL = 1e-6
#: Fig. 3j: the JAX test's budget.
P11_RESNET_STEPS = 250
#: Fig. 4g: each cell's steps here (the recipe's default is 2500): a
#: multiple of the engines' unroll of 8, so one graph is captured.
P11_L96_STEPS = 64
P11_WAVEFORMS = ("sine", "triangular", "rectangular", "modulated_sine")


def p11_paths(dev, smi, twin, params, l96_twin, l96_params, l96_data,
              wide_params, y0_wide, ts_wide, p3, zero_counts,
              read_counts) -> dict:
    """Phase 24 (P11): dopri5 on the twins (phase 7's HP twin on digital
    and on the noise-free simulator, JAX's gate; fused_cuda refusing it),
    dopri5 through K7 at P3's deployment (K7 exactly 7 launches per loop
    iteration, against K7's plain version), a noisy HP fleet under dopri5
    against its single twins; then the paper's baselines trained on the
    card through the training engines: the recurrent ResNet against the
    HP twin (Fig. 3j's gate) and the LSTM / GRU / RNN forecasters beside
    the Lorenz96 twin (Fig. 4g).  Returns the main paths' launch counts
    and the numbers printed."""
    t_phase = time.perf_counter()
    out, counts = {}, {}
    real_dopri5 = ode.odeint_dopri5
    runs = []

    def counted_dopri5(*a, **kw):
        stats = {}
        res = real_dopri5(*a, **kw, stats=stats)
        runs.append(stats)
        return res

    def solve(fn):
        """fn() with dopri5's loop statistics recorded; returns its result,
        the last solve's statistics and the host seconds to a sync."""
        runs.clear()
        ode.odeint_dopri5 = counted_dopri5
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                res = fn()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        finally:
            ode.odeint_dopri5 = real_dopri5
        check(len(runs) == 1, f"P11: expected one dopri5 solve, got "
                              f"{len(runs)}")
        return res, runs[-1], sec

    def steps_str(st):
        acc = st["accepted"].reshape(-1).double().cpu()
        rej = st["rejected"].reshape(-1).double().cpu()
        return (f"{st['iterations']} loop iterations; accepted steps per "
                f"twin min/median/max {acc.min():g}/{acc.median():g}/"
                f"{acc.max():g}, rejected {rej.min():g}/{rej.median():g}/"
                f"{rej.max():g}")

    # (a) dopri5 on the twins: phase 7's HP twin on digital and on the
    # noise-free crossbar simulator
    m = recipes.eval_hp_twin(twin, params, "sine", device=dev)
    ts_hp, y0_hp = m["ts"][:P11_HP_INTERVALS + 1], m["true"][:1]
    drive = hp.WAVEFORMS["sine"](amp=recipes.HP_AMP, freq=recipes.HP_FREQ)
    twin5 = make_driven_twin(1, drive, hidden=14, method="dopri5")
    zero_counts()
    dig5, st_d, sec_d = solve(lambda: twin5.simulate(params, y0_hp, ts_hp))
    noise_free = AnalogueSpec(prog_noise=0.0, read_noise=0.0, quantize=False)
    ana5, st_a, sec_a = solve(lambda: twin5.with_backend(AnalogueBackend(
        spec=noise_free, prog_seed=SEED)).simulate(params, y0_hp, ts_hp))
    counts["P11_hp_dopri5"] = read_counts(
        "P11 HP twin dopri5 on digital and the noise-free simulator",
        {"K1": 0, "K4": 0, "K7": 0})
    with torch.no_grad():
        rk8 = make_driven_twin(1, drive, hidden=14,
                               steps_per_interval=8).simulate(params, y0_hp,
                                                              ts_hp)
    torch.cuda.synchronize()
    gap = float(((ana5 - dig5).abs()
                 - (P11_ATOL + P11_RTOL * dig5.abs())).max())
    rk_err = rel_err(dig5, rk8)
    for name, st, sec in (("digital", st_d, sec_d), ("analogue", st_a, sec_a)):
        print(f"[{smi}] P11 HP twin dopri5 on {name}: {tuple(dig5.shape)} in "
              f"{sec:.3f} s, {steps_str(st)}")
    print(f"P11 HP dopri5: noise-free analogue vs digital max abs err "
          f"{float((ana5 - dig5).abs().max()):.3e} (gate atol {P11_ATOL:g}, "
          f"rtol {P11_RTOL:g}: worst margin {gap:.3e}); digital dopri5 vs "
          f"RK4 at 8 sub-steps of peak {rk_err[1]:.3e} (limit "
          f"{P11_RK4_TOL:g})")
    check(bool(torch.isfinite(dig5).all()) and gap <= 0.0,
          "P11: dopri5 on the noise-free simulator misses JAX's gate")
    check(rk_err[1] <= P11_RK4_TOL, "P11: dopri5 disagrees with RK4")
    for what, call in (
            ("rollout", lambda: twin5.with_backend("fused_cuda").simulate(
                params, y0_hp, ts_hp)),
            ("train_twin", lambda: trainer.train_twin(
                twin5, params, ts_hp,
                m["true"][:P11_HP_INTERVALS + 1, None],
                optimizer=adam(1e-3), num_steps=1, segment_len=50,
                backend="fused_cuda"))):
        try:
            call()
        except ValueError as e:
            print(f"P11 fused_cuda {what} of a dopri5 twin refused: {e}")
            check("RK4" in str(e), f"P11: fused_cuda {what} refusal does "
                                   f"not name RK4")
        else:
            check(False, f"P11: fused_cuda {what} took a dopri5 twin")
    out["hp"] = dict(iterations=st_d["iterations"], seconds=sec_d,
                     analogue_seconds=sec_a, vs_rk4_of_peak=rk_err[1])

    # (b) dopri5 through K7: P3's deployment, 1024 twins over 50 intervals
    wide5 = make_autonomous_twin(6, hidden=512, method="dopri5")
    fleet5 = TwinFleet(wide5.with_backend(AnalogueBackend(
        spec=AnalogueSpec(prog_noise=0.0), storage="uint8", prog_seed=SEED)))
    zero_counts()
    k7run, st_k, sec_k = solve(lambda: fleet5.rollout_batch(
        wide_params, y0_wide, ts_wide))
    it = st_k["iterations"]
    counts["P11_dopri5_scorecard_width"] = read_counts(
        f"P11 dopri5 AnalogueBackend(uint8) 6->512->512->6, 1024 twins x 50 "
        f"intervals, {it} loop iterations",
        {"K7": 7 * it, "K7_read": 7 * it, "K4": 0, "K1": 0})
    real_k7 = crossbar_vmm.crossbar_matmul
    crossbar_vmm.crossbar_matmul = (
        lambda x, gp, gm, **kw: ref.crossbar_matmul_ref(x, gp, gm, **kw))
    try:
        plain, st_p, sec_p = solve(lambda: fleet5.rollout_batch(
            wide_params, y0_wide, ts_wide))
    finally:
        crossbar_vmm.crossbar_matmul = real_k7
    check(bool(torch.isfinite(k7run).all())
          and tuple(k7run.shape) == (1024, 51, 6),
          f"P11: dopri5 on K7 {tuple(k7run.shape)} non-finite or misshapen")
    k7_err = rel_err(k7run, plain)
    rk4_gap = rel_err(k7run, p3)
    print(f"[{smi}] P11 dopri5 through K7: {tuple(k7run.shape)} in "
          f"{sec_k:.3f} s ({1e3 * sec_k / it:.3f} ms a loop iteration of 7 "
          f"evaluations), {steps_str(st_k)}; with K7's plain version "
          f"{sec_p:.3f} s, {st_p['iterations']} iterations; vs the plain "
          f"run max abs err {k7_err[0]:.3e}, of peak {k7_err[1]:.3e} (limit "
          f"{TOL:g}); vs P3's RK4 run of peak {rk4_gap[1]:.3e} (printed, not "
          f"gated)")
    check(k7_err[1] <= TOL, "P11: dopri5 on K7 disagrees with its plain path")
    out["k7"] = dict(iterations=it, plain_iterations=st_p["iterations"],
                     seconds=sec_k, plain_seconds=sec_p,
                     max_rel_err_of_peak=k7_err[1],
                     accepted=[int(st_k["accepted"].min()),
                               int(st_k["accepted"].max())],
                     rejected=[int(st_k["rejected"].min()),
                               int(st_k["rejected"].max())])

    # a noisy HP fleet under dopri5: rows at different ticks in one
    # evaluation, each row against its own single-twin noisy rollout
    noisy = twin5.with_backend(AnalogueBackend(
        spec=AnalogueSpec(prog_noise=0.0436, read_noise=0.02),
        prog_seed=SEED, read_seed=1))
    ts_n = ts_hp[:P11_NOISY_INTERVALS + 1]
    y0s = torch.linspace(0.05, 0.8, P11_NOISY_TWINS, device=dev)[:, None]
    zero_counts()
    fleet_n, st_n, sec_n = solve(lambda: noisy.simulate_batch(params, y0s,
                                                              ts_n))
    worst, t_one = 0.0, time.perf_counter()
    for i in range(P11_NOISY_TWINS):
        with torch.no_grad():
            one = noisy.simulate(params, y0s[i], ts_n)
        worst = max(worst, rel_err(fleet_n[i], one)[1])
    t_one = time.perf_counter() - t_one
    counts["P11_noisy_hp_fleet"] = read_counts(
        "P11 noisy HP fleet dopri5 on the simulator", {"K7": 0, "K4": 0})
    print(f"[{smi}] P11 noisy HP fleet dopri5 ({P11_NOISY_TWINS} twins x "
          f"{P11_NOISY_INTERVALS} intervals): {sec_n:.3f} s, "
          f"{steps_str(st_n)}; the {P11_NOISY_TWINS} single-twin rollouts "
          f"{t_one:.3f} s; worst row vs its single twin of peak {worst:.3e} "
          f"(limit {P11_SELF_TOL:g})")
    check(bool(torch.isfinite(fleet_n).all()) and worst <= P11_SELF_TOL,
          "P11: a noisy dopri5 fleet row differs from its single twin")
    out["noisy_fleet"] = dict(iterations=st_n["iterations"], seconds=sec_n,
                              worst_of_peak=worst)

    # the baselines train through the engines: their graphs, captured and
    # replayed, and their loss histories
    engines, hists = [], []
    real_engine = trainer.make_scan_engine
    real_fit = trainer.fit

    def spy_engine(*a, **kw):
        fn = real_engine(*a, **kw)
        engines.append(fn.engine)
        return fn

    def spy_fit(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_fit(*a, **kw)
        torch.cuda.synchronize()
        hists.append((res[1], time.perf_counter() - t0))
        return res

    def train(fn, steps):
        """fn() (a recipe) with its one fit spied on: the result, the
        engine, the loss history and ms a step of the fit (warm-up and
        capture included)."""
        engines.clear()
        hists.clear()
        trainer.make_scan_engine, trainer.fit = spy_engine, spy_fit
        try:
            res = fn()
        finally:
            trainer.make_scan_engine, trainer.fit = real_engine, real_fit
        check(len(engines) == 1 and len(hists) == 1,
              f"P11: expected one engine, got {len(engines)}")
        eng, (hist, sec) = engines[0], hists[0]
        hist = hist.cpu()
        check(eng.captures >= 1 and eng.replays >= 1,
              f"P11: {eng.captures} graphs captured, {eng.replays} replayed")
        check(bool(torch.isfinite(hist).all()) and hist[-1] < hist[0],
              f"P11: loss history {float(hist[0])} -> {float(hist[-1])} is "
              f"not finite and falling")
        return res, eng, hist, 1e3 * sec / steps

    def replay_ms(eng):
        """ms a step of replays of the engine's longest graph alone (they
        train on: call it once the trained params are used)."""
        u = max(eng.blocks)
        return cuda_ms(lambda: eng.run(u), reps=2, warmup=1) / u

    # (c) Fig. 3j: the recurrent ResNet against the HP twin of phase 7
    (resnet, rparams, rloss), eng, hist, ms = train(
        lambda: recipes.train_hp_resnet(train_steps=P11_RESNET_STEPS,
                                        device=dev), P11_RESNET_STEPS)
    rparams = [{k: v.clone() for k, v in layer.items()} for layer in rparams]
    node_mre, res_mre = [], []
    for wf in P11_WAVEFORMS:
        node_mre.append(recipes.eval_hp_twin(twin, params, wf,
                                             device=dev)["mre"])
        r = recipes.eval_hp_resnet(resnet, rparams, wf, device=dev)
        res_mre.append(r["mre"])
        print(f"  Fig. 3j {wf:15s} NODE MRE {node_mre[-1]:.4f}, recurrent "
              f"ResNet MRE {r['mre']:.4f} (DTW/pt {r['dtw']:.6f})")
    node_mean, res_mean = sum(node_mre) / 4, sum(res_mre) / 4
    steady = replay_ms(eng)
    print(f"[{smi}] P11 train_hp_resnet({P11_RESNET_STEPS}) on {dev}: loss "
          f"{float(hist[0]):.6f} -> {rloss:.6f}; graphs captured "
          f"{eng.captures} (lengths {sorted(eng.blocks)}), replayed "
          f"{eng.replays}; {ms:.4f} ms a step with warm-up and capture, "
          f"{steady:.4f} a step replayed; mean MRE NODE {node_mean:.4f}, "
          f"ResNet {res_mean:.4f} (gate: NODE < 0.5 x ResNet, ratio "
          f"{node_mean / res_mean:.3f})")
    check(node_mean < 0.5 * res_mean, "P11: Fig. 3j gate: the NODE's mean "
                                      "MRE is not under half the ResNet's")
    out["fig3j"] = dict(node_mre=node_mre, resnet_mre=res_mre,
                        ms_per_step=ms, replay_ms_per_step=steady,
                        captures=eng.captures, replays=eng.replays)

    # (d) Fig. 4g: the recurrent forecasters beside the Lorenz96 twin
    twin_l1 = recipes.eval_l96_twin(l96_twin, l96_params, data=l96_data)
    print(f"  Fig. 4g NODE (phase 7's Lorenz96 twin): interpolation L1 "
          f"{twin_l1['interp_l1']:.4f}, extrapolation L1 "
          f"{twin_l1['extrap_l1']:.4f}")
    out["fig4g"] = {"node": {k: twin_l1[k] for k in ("interp_l1",
                                                     "extrap_l1")}}
    for cell in ("lstm", "gru", "rnn"):
        res, eng, hist, ms = train(
            lambda: recipes.eval_l96_baseline(
                cell, train_steps=P11_L96_STEPS, data=l96_data, device=dev),
            P11_L96_STEPS)
        steady = replay_ms(eng)
        print(f"[{smi}] P11 eval_l96_baseline({cell!r}, {P11_L96_STEPS} "
              f"steps) on {dev}: loss {float(hist[0]):.6f} -> "
              f"{float(hist[-1]):.6f}; interpolation L1 "
              f"{res['interp_l1']:.4f}, extrapolation L1 "
              f"{res['extrap_l1']:.4f} (printed, not gated); graphs "
              f"captured {eng.captures}, replayed {eng.replays}; {ms:.4f} ms "
              f"a step with warm-up and capture, {steady:.4f} a step "
              f"replayed")
        out["fig4g"][cell] = dict(res, ms_per_step=ms,
                                  replay_ms_per_step=steady,
                                  loss_first=float(hist[0]),
                                  loss_last=float(hist[-1]))
    sec = time.perf_counter() - t_phase
    print(f"[{smi}] phase 24 took {sec:.1f} s")
    out["seconds"] = sec
    return {"counts": counts, "numbers": out}


# -- phase 25: P12, the bf16 precision policies (K1, K2, K5, K6) -------------

P12_POLICIES = ("bf16_f32acc", "bf16")
#: K1 under a bf16 policy vs its plain version: the most error over the
#: peak, and the least share of bitwise-equal elements.  Both sum bf16 x
#: bf16 products (exact in float32) in float32, the kernel in
#: fused_mlp_eval.cuh's fixed order, the plain version in torch's; an order
#: that rounds a sum differently can flip the bf16 rounding of a layer
#: input, which moves a few values by about one bf16 ulp of an activation
#: carried through dt.  Each limit sits between the sound kernel's readings
#: and its controls' (``p12_k1_controls``), which PERF.md section 6 lists.
P12_K1_TOL = 2e-3
P12_K1_SHARE = 0.999
#: K2 under a bf16 policy vs the plain VJP, of each gradient's peak: its
#: float32 sums run in another order, so few elements are bitwise (no share
#: is gated); the limit sits between the sound kernel's readings and its
#: controls' (``p12_k2_controls``), PERF.md section 6.
P12_K2_TOL = 1e-4
#: K1 cases as (sizes, B, T, drive, dt, time_chunk): the fleet request
#: (autonomous), Lorenz96 training (CI window) and HP training at the
#: planner's chunk (None) and at 7 steps.
P12_K1_CASES = {
    "fleet_l96": ((6, 64, 64, 6), 1024, 200, "none", 0.0025, None),
    "l96_train_ci": ((6, 64, 64, 6), 14, 60, "none", 0.0025, None),
    "hp_train": ((2, 14, 14, 1), 9, 50, "per_twin", 1e-3, None),
    "hp_train_chunk7": ((2, 14, 14, 1), 9, 50, "per_twin", 1e-3, 7),
}
#: K2 cases: the Lorenz96 paper window and HP training, each at the
#: backward planner's chunk (one chunk replayed) and at 7 steps (several).
P12_K2_CASES = {
    "l96_train": ((6, 64, 64, 6), 29, 60, "none", 0.0025, None),
    "l96_train_chunk7": ((6, 64, 64, 6), 29, 60, "none", 0.0025, 7),
    "hp_train": ((2, 14, 14, 1), 9, 50, "per_twin", 1e-3, None),
    "hp_train_chunk7": ((2, 14, 14, 1), 9, 50, "per_twin", 1e-3, 7),
}
#: K5 / K6 on bf16 costs: the two Lorenz96 training shapes (B, n, m).
P12_SDTW_SHAPES = ((29, 61, 61), (8, 201, 201))


def bitwise_share(got, want) -> float:
    """The fraction of elements of ``got`` bitwise equal to ``want``'s."""
    return float((got.float() == want.float()).float().mean())


def p12_chunk(sizes, B, T, du, per_twin, prec, time_chunk, backward):
    """The rounding chunk a call plans (forward or shared backward)."""
    if time_chunk is not None:
        return time_chunk
    if backward:
        return fused_ode_mlp_bwd.plan_bwd_time_chunk(
            T, min(64, B), sizes[-1], du, per_twin, sizes,
            precision=prec).time_chunk
    return fused_ode_mlp.plan_time_chunk(T, min(64, B), sizes[-1], du,
                                         per_twin, sizes,
                                         precision=prec).time_chunk


def p12_k1_pass(r: float, share: float) -> bool:
    """Whether a bf16 K1 reading (error of the peak, bitwise share) is
    within ``P12_K1_TOL`` and ``P12_K1_SHARE``."""
    return r <= P12_K1_TOL and share >= P12_K1_SHARE


def p12_k1_controls(y0, u, ws, bs, dt, prec, C, want) -> dict:
    """{control: (error of the peak, bitwise share)} against K1's plain
    version ``want``, of plain rollouts that a wrong kernel would match:
    one that keeps the policy's bf16 storage (operands rounded, trajectory
    stored as bf16) but rounds nothing else (float32 arithmetic), and under
    "bf16" one with "bf16_f32acc"'s arithmetic.  K1's limits must reject
    each."""
    def r16(x):
        return x.to(torch.bfloat16).float()

    ctl = {"f32 arithmetic": ref.fused_node_rollout_ref(
        r16(y0), r16(u), [r16(w) for w in ws], [r16(b) for b in bs],
        float(dt)).to(torch.bfloat16)}
    if prec == "bf16":
        ctl["bf16_f32acc arithmetic"] = ref.fused_node_rollout_bf16_ref(
            y0, u, ws, bs, dt, "bf16_f32acc", C)
    return {k: (rel_err(v.float(), want.float())[1], bitwise_share(v, want))
            for k, v in ctl.items()}


def p12_k2_controls(traj, u, ws, bs, g, dt, prec, C, want) -> dict:
    """{control: worst error of a gradient's peak} against the plain VJP
    ``want``, of a plain VJP that a wrong kernel would match: under
    "bf16_f32acc" one without the chunk replay (every row taken as a
    state: chunk 1), under "bf16" (whose rows are the states) one with
    "bf16_f32acc"'s arithmetic.  K2's limit must reject each."""
    if prec == "bf16_f32acc":
        name, ctl = "no chunk replay", ref.fused_node_rollout_bf16_bwd_ref(
            traj, u, ws, bs, g, dt, prec, 1)
    else:
        name, ctl = ("bf16_f32acc arithmetic",
                     ref.fused_node_rollout_bf16_bwd_ref(
                         traj, u, ws, bs, g, dt, "bf16_f32acc", C))
    return {name: grads_rel_err(ctl, want)[1]}


def p12_kernels(dev) -> dict:
    """Phase 25's checks of K1, K2, K5 and K6 under the bf16 policies
    against their plain versions on the card, each limit against its
    controls, and the two bitwise checks (a resume from a chunk start, the
    forward inside autograd).  Returns the errors, the controls' readings
    and the inputs the timing reuses."""
    out = {"k1": {}, "k2": {}, "sdtw": {}, "inputs": {}, "controls": {}}
    gen = torch.Generator().manual_seed(SEED + 25)
    for case, (sizes, B, T, mode, dt, tc) in P12_K1_CASES.items():
        params, y0, u = make_case(gen, sizes, B, T, mode, dev)
        ws = [p["w"] for p in params]
        bs = [p["b"] for p in params]
        y0p, up, bt, _ = fused_ode_mlp.pad_fleet_to_tile(y0, u, 64)
        for prec in P12_POLICIES:
            C = p12_chunk(sizes, y0p.shape[0], T, u.shape[-1], u.ndim == 3,
                          prec, tc, False)
            got = fused_ode_mlp.fused_node_rollout(
                y0p, up, ws, bs, dt, batch_tile=bt, time_chunk=tc,
                precision=prec)
            want = ref.fused_node_rollout_bf16_ref(y0p, up, ws, bs, dt, prec,
                                                   C)
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16 and got.shape == want.shape,
                  f"K1 {prec} {case}: {got.dtype} {tuple(got.shape)}")
            check(bool(torch.isfinite(got.float()).all()),
                  f"K1 {prec} {case}: non-finite")
            a, r = rel_err(got.float(), want.float())
            share = bitwise_share(got, want)
            ctl = p12_k1_controls(y0p, up, ws, bs, dt, prec, C, want)
            out["k1"][prec, case] = (a, r, share)
            out["controls"]["K1", prec, case] = ctl
            out["inputs"][prec, case] = (y0p, up, ws, bs, dt, bt, C, sizes)
            print(f"K1 {prec} vs plain [{case}] B={B} T={T} sizes={sizes} "
                  f"chunk {C}: max abs err {a:.3e}, of peak {r:.3e} (limit "
                  f"{P12_K1_TOL:g}); bitwise-equal share {share:.6f} (least "
                  f"{P12_K1_SHARE:g}); controls (of peak / share): "
                  + "; ".join(f"{k} {c[0]:.3e} / {c[1]:.6f}"
                              for k, c in ctl.items()))
            check(p12_k1_pass(r, share), f"K1 {prec} {case}: kernel "
                                         f"disagrees with its plain version")
            check(not any(p12_k1_pass(*c) for c in ctl.values()),
                  f"K1 {prec} {case}: a control passes K1's limits")
    # a resume from row k C reproduces the rest bitwise; the forward inside
    # autograd is bitwise a plain call with the same chunk
    y0p, up, ws, bs, dt, bt, _, sizes = out["inputs"]["bf16", "hp_train"]
    for prec in P12_POLICIES:
        C, k = 7, 3
        full = fused_ode_mlp.fused_node_rollout(y0p, up, ws, bs, dt,
                                                batch_tile=bt, time_chunk=C,
                                                precision=prec)
        T = full.shape[0] - 1
        rest = fused_ode_mlp.fused_node_rollout(
            full[k * C], fused_ode_mlp.drive_window(up, k * C, T - k * C), ws,
            bs, dt, batch_tile=bt, time_chunk=C, precision=prec)
        resumed = torch.equal(rest, full[k * C:])
        params = [{"w": w.clone().requires_grad_(),
                   "b": b.clone().requires_grad_()} for w, b in zip(ws, bs)]
        fwd = ops.fused_node_rollout(params, y0p, up, dt, batch_tile=bt,
                                     time_chunk=C, precision=prec)
        plain_call = ops.fused_node_rollout(params, y0p, up, dt,
                                            batch_tile=bt, time_chunk=C,
                                            precision=prec,
                                            gradient="stopgrad")
        same = torch.equal(fwd.detach(), plain_call)
        print(f"K1 {prec} bitwise: resume from row {k * C} (chunk {C}) "
              f"reproduces rows {k * C}..{T}: {resumed}; the forward inside "
              f"autograd equals a plain call: {same}")
        check(resumed, f"K1 {prec}: a resume from a chunk start differs")
        check(same, f"K1 {prec}: the forward inside autograd differs")
    for case, (sizes, B, T, mode, dt, tc) in P12_K2_CASES.items():
        params, y0, u = make_case(gen, sizes, B, T, mode, dev)
        ws = [p["w"] for p in params]
        bs = [p["b"] for p in params]
        for prec in P12_POLICIES:
            C = p12_chunk(sizes, B, T, u.shape[-1], u.ndim == 3, prec, tc,
                          True)
            traj = fused_ode_mlp.fused_node_rollout(
                y0, u, ws, bs, dt, batch_tile=B, time_chunk=C,
                precision=prec)
            g = torch.randn(traj.shape, generator=gen).to(dev)
            got = fused_ode_mlp_bwd.fused_node_rollout_bwd(
                traj, u, ws, bs, g, dt, precision=prec, time_chunk=C)
            again = fused_ode_mlp_bwd.fused_node_rollout_bwd(
                traj, u, ws, bs, g, dt, precision=prec, time_chunk=C)
            want = ref.fused_node_rollout_bf16_bwd_ref(traj, u, ws, bs, g, dt,
                                                       prec, C)
            torch.cuda.synchronize()
            flat = [got[0], *got[1], *got[2]]
            check(all(x.dtype == torch.float32 and bool(torch.isfinite(x).all())
                      for x in flat), f"K2 {prec} {case}: not finite float32")
            a, r, rels = grads_rel_err(got, want)
            share = bitwise_share(torch.cat([x.reshape(-1) for x in flat]),
                                  torch.cat([x.reshape(-1) for x in
                                             [want[0], *want[1], *want[2]]]))
            repeat = all(torch.equal(x, y) for x, y in zip(
                flat, [again[0], *again[1], *again[2]]))
            ctl = p12_k2_controls(traj, u, ws, bs, g, dt, prec, C, want)
            out["k2"][prec, case] = (a, r, share)
            out["controls"]["K2", prec, case] = ctl
            out["inputs"]["k2", prec, case] = (traj, u, ws, bs, g, dt, C,
                                               sizes)
            print(f"K2 {prec} vs plain [{case}] B={B} T={T} sizes={sizes} "
                  f"chunk {C}: max abs err {a:.3e}, worst of peak {r:.3e} "
                  f"(limit {P12_K2_TOL:g}; per gradient "
                  f"{', '.join(f'{x:.1e}' for x in rels)}); bitwise-equal "
                  f"share {share:.6f}; repeat bitwise: {repeat}; controls "
                  f"(worst of peak): "
                  + "; ".join(f"{k} {c:.3e}" for k, c in ctl.items()))
            check(r <= P12_K2_TOL, f"K2 {prec} {case}: kernel disagrees with "
                                   f"its plain version")
            check(all(c > P12_K2_TOL for c in ctl.values()),
                  f"K2 {prec} {case}: a control passes K2's limit")
            check(repeat, f"K2 {prec} {case}: two calls differ")
            # the replayed states in device memory instead of shared memory
            scratch = fused_ode_mlp_bwd.fused_node_rollout_bwd(
                traj, u, ws, bs, g, dt, precision=prec, time_chunk=C,
                _force_scratch=True)
            same = all(torch.equal(x, y) for x, y in zip(
                flat, [scratch[0], *scratch[1], *scratch[2]]))
            print(f"  K2 {prec} [{case}]: replayed states in shared memory "
                  f"and in the device-memory scratch bitwise identical: "
                  f"{same}")
            check(same, f"K2 {prec} {case}: the two homes of the replayed "
                        f"states differ")
    for B, n, m in P12_SDTW_SHAPES:
        D = sdtw_costs(gen, B, n, m, dev)
        D[0, n // 2, m // 3] = ref.BIG          # the layout's padding value
        D[B - 1, n - 1, m // 2] = 2 * ref.BIG
        Db = D.to(torch.bfloat16)
        ans, R = softdtw.softdtw_rowmajor(Db, gamma=0.1, return_r=True)
        E = softdtw.softdtw_rowmajor_bwd(Db, R, gamma=0.1)
        p_ans, p_r = ref.softdtw_rowmajor_ref(Db.float(), gamma=0.1,
                                              return_r=True)
        p_e = ref.softdtw_rowmajor_bwd_ref(Db.float(), p_r, gamma=0.1)
        torch.cuda.synchronize()
        # the planted cells: BIG rounds to 9.9992e9 in bf16, 2 BIG to 2.00e10,
        # both at or above BIG_CUT, so they stay invalid (R = BIG, E = 0)
        invalid = Db.float() >= ref.BIG_CUT
        sentinels = (bool((R[invalid] == ref.BIG).all())
                     and bool((E[invalid] == 0).all())
                     and int(invalid.sum()) == 2)
        same = {"K5": torch.equal(ans, p_ans), "K5 R": torch.equal(R, p_r),
                "K6": torch.equal(E, p_e)}
        out["sdtw"][B, n, m] = {
            "K5": rel_err(ans, p_ans), "K6": rel_err(E, p_e),
            "bitwise": all(same.values())}
        out["inputs"]["sdtw", B, n, m] = (Db, R)
        print(f"K5/K6 on bf16 costs vs plain ({B}, {n}, {m}) gamma 0.1: "
              f"bitwise equal {same}; planted padded cells invalid (R = BIG, "
              f"E = 0): {sentinels}")
        check(all(same.values()), f"K5/K6 bf16 ({B}, {n}, {m}): not bitwise "
                                  f"the plain version")
        check(sentinels, f"K5/K6 bf16 ({B}, {n}, {m}): a padded cell reads "
                         f"as valid")
    return out


#: Phase 25's launch counters: K1 and K2 per policy (f32 in ``LAUNCHES``),
#: K5 and K6 on float32 and on bfloat16 costs.
P12_COUNTERS = {
    "K1": (fused_ode_mlp, "LAUNCHES"),
    "K1 bf16_f32acc": (fused_ode_mlp, "LAUNCHES_BF16_F32ACC"),
    "K1 bf16": (fused_ode_mlp, "LAUNCHES_BF16"),
    "K2": (fused_ode_mlp_bwd, "LAUNCHES"),
    "K2 bf16_f32acc": (fused_ode_mlp_bwd, "LAUNCHES_BF16_F32ACC"),
    "K2 bf16": (fused_ode_mlp_bwd, "LAUNCHES_BF16"),
    "K5": (softdtw, "LAUNCHES"), "K5 bf16": (softdtw, "LAUNCHES_BF16"),
    "K6": (softdtw, "BWD_LAUNCHES"), "K6 bf16": (softdtw, "BWD_LAUNCHES_BF16"),
}
#: The 40-step HP loss history on the bf16_f32acc kernels against the same
#: steps on their plain versions, rel a step: between the sound kernels'
#: reading and the controls' (the f32 history, and one whose K2 skips the
#: chunk replay), PERF.md section 6.
P12_HIST_TOL = 1e-4
#: Steps of the Lorenz96 ``l1+softdtw`` fit at segment length 60 under each
#: bf16 policy (K1, K2, K5 and K6 on the reduced substrate).
P12_P4_STEPS = 10
#: Whether phase 25 asserts the HP gates (loss < 0.01, sine MRE < 0.1) for
#: the twin trained at bf16_f32acc: the CPU rehearsal at phase 7's budget
#: (``train_hp_twin(200, 250)``, plain versions) passed them.
P12_HP_GATES = True


def p12_zero():
    for mod, name in P12_COUNTERS.values():
        setattr(mod, name, 0)


def p12_read(path: str, want: dict) -> dict:
    """Phase 25's counts after ``path``; every counter not in ``want`` must
    be 0."""
    torch.cuda.synchronize()
    got = {k: getattr(mod, name) for k, (mod, name) in P12_COUNTERS.items()}
    print(f"{path}: launches " + ", ".join(
        f"{k} {v}" for k, v in got.items() if v or k in want))
    for k, v in got.items():
        check(v == want.get(k, 0), f"{path}: expected {want.get(k, 0)} {k} "
                                   f"launches, got {v}")
    return got


@contextlib.contextmanager
def p12_plain_kernels(k1: bool = True, k2_chunk=None):
    """K1's (with ``k1``) and K2's bf16 launches swapped for their plain
    versions on the same CUDA tensors (for the kernels-vs-plain loss
    history); ``k2_chunk`` replaces K2's rounding chunk (1: the control
    without the chunk replay)."""
    saved = (fused_ode_mlp._launch, fused_ode_mlp_bwd._launch_bf16)

    def k1_plain(y0, u, ws, bs, dt, per_twin, T, du, sizes, geom,
                 prec="f32", C=None):
        if prec == "f32":
            return saved[0](y0, u, ws, bs, dt, per_twin, T, du, sizes, geom)
        return ref.fused_node_rollout_bf16_ref(y0, u, ws, bs, float(dt),
                                               prec, C)

    def k2_plain(traj, u, gs, g0, ws, bs, dt, per_twin, T, du, sizes, geom,
                 prec, C, _force_scratch=False):
        g = torch.cat([g0[None], gs[1:].to(torch.float32)])
        return ref.fused_node_rollout_bf16_bwd_ref(
            traj, u, ws, bs, g, float(dt), prec, k2_chunk or C)

    if k1:
        fused_ode_mlp._launch = k1_plain
    fused_ode_mlp_bwd._launch_bf16 = k2_plain
    try:
        yield
    finally:
        fused_ode_mlp._launch, fused_ode_mlp_bwd._launch_bf16 = saved


def p12_paths(dev, smi, hp_f32, l96_twin, l96_params, ts_tr, ys_tr) -> dict:
    """Phase 25's main paths on the reduced substrate, each with the counts
    zeroed just before and read just after: one ``serve_fleet`` batch per
    policy (K1), the HP twin trained at bf16_f32acc through the engines at
    phase 7's budget (K1, K2) with its 40-step history held to the plain
    versions', and the Lorenz96 ``l1+softdtw`` fit per policy (K1, K2, K5
    and K6 on bf16 costs).  Returns {path: counts} and the numbers printed."""
    counts, numbers = {}, {}
    cfg = recipes.FLEET
    ts = recipes.l96_fleet_ts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p12_") as ckpt:
        fleet = recipes.make_l96_fleet(
            backend=FusedCudaBackend(batch_tile=cfg.batch_tile))
        checkpoint.save_twin(ckpt, fleet.twin.init(
            torch.Generator().manual_seed(SEED), device="cpu"))
        reqs = list(recipes.l96_fleet_requests(num_batches=1, seed=SEED,
                                               device=dev))
        f32 = next(serve_fleet(ckpt, fleet, ts, reqs, device=dev))
        for prec in P12_POLICIES:
            be = FusedCudaBackend(batch_tile=cfg.batch_tile, precision=prec)
            fleet_p = recipes.make_l96_fleet(backend=be)
            p12_zero()
            t_b = time.perf_counter()
            out = next(serve_fleet(ckpt, fleet_p, ts, reqs, device=dev))
            torch.cuda.synchronize()
            sec = time.perf_counter() - t_b
            path = f"P12_serve_fleet_{prec}"
            counts[path] = p12_read(f"P12 serve_fleet at {prec}",
                                    {f"K1 {prec}": 1})
            with p12_plain_kernels():
                plain = next(serve_fleet(ckpt, fleet_p, ts, reqs, device=dev))
            torch.cuda.synchronize()
            check(out.dtype == torch.bfloat16 and tuple(out.shape) == (
                cfg.fleet_size, cfg.horizon + 1, cfg.state_dim),
                f"{path}: {out.dtype} {tuple(out.shape)}")
            check(bool(torch.isfinite(out.float()).all()), f"{path}: non-finite")
            a, r = rel_err(out.float(), plain.float())
            share = bitwise_share(out, plain)
            _, r32 = rel_err(out.float(), f32)
            # the control: the f32 serve stored as bf16, against the plain
            f32b = f32.to(torch.bfloat16)
            ctl = (rel_err(f32b.float(), plain.float())[1],
                   bitwise_share(f32b, plain))
            numbers[path] = dict(ms=sec * 1e3, err_of_peak=r,
                                 bitwise_share=share, from_f32_of_peak=r32,
                                 control_f32=ctl)
            print(f"[{smi}] {path}: {tuple(out.shape)} bf16 in "
                  f"{sec * 1e3:.3f} ms; vs the plain version {r:.3e} of the "
                  f"peak (limit {P12_K1_TOL:g}), bitwise-equal share "
                  f"{share:.6f} (least {P12_K1_SHARE:g}); from the f32 serve "
                  f"{r32:.3e} of the peak; control (the f32 serve as bf16 vs "
                  f"the plain version) {ctl[0]:.3e} / {ctl[1]:.6f}")
            check(p12_k1_pass(r, share),
                  f"{path}: K1 disagrees with its plain version")
            check(not p12_k1_pass(*ctl), f"{path}: the f32 control passes "
                                         f"K1's limits")

    # the HP twin trained at bf16_f32acc through the engines (phase 7's
    # budget), beside phase 7's f32 twin
    be = FusedCudaBackend(precision="bf16_f32acc")
    p12_zero()
    t_p = time.perf_counter()
    twin, params, loss = recipes.train_hp_twin(
        pretrain_steps=200, train_steps=250, backend=be, device=dev)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t_p
    counts["P12_train_hp_twin_bf16_f32acc"] = p12_read(
        "P12 train_hp_twin(200, 250) on bf16_f32acc",
        {"K1 bf16_f32acc": 250, "K2 bf16_f32acc": 250})
    sine = recipes.eval_hp_twin(twin, params, "sine", device=dev)["mre"]
    served = recipes.eval_hp_twin(twin, params, "sine", device=dev,
                                  backend=FusedCudaBackend(
                                      batch_tile=1,
                                      precision="bf16_f32acc"))["mre"]
    numbers["hp_bf16_f32acc"] = dict(loss=loss, sine_mre=sine,
                                     sine_mre_served_bf16=served, s=sec,
                                     f32_loss=hp_f32[0], f32_sine_mre=hp_f32[1])
    print(f"[{smi}] P12 train_hp_twin at bf16_f32acc: final loss "
          f"{loss:.6f}, sine MRE {sine:.4f} (served on bf16_f32acc "
          f"{served:.4f}) in {sec:.2f} s; phase 7's f32 twin: loss "
          f"{hp_f32[0]:.6f}, sine MRE {hp_f32[1]:.4f}; HP gates "
          f"(loss < 0.01, sine MRE < 0.1) "
          f"{'asserted' if P12_HP_GATES else 'printed only'}")
    if P12_HP_GATES:
        check(loss < 0.01, "P12 HP twin at bf16_f32acc: loss over 0.01")
        check(sine < 0.1, "P12 HP twin at bf16_f32acc: sine MRE over 0.1")

    # 40 HP steps from phase 7's weights on the kernels and on the plain
    # versions (the eager loop: the engines are its bits)
    ts_h, xs_h, _, _ = hp.generate("sine", num_points=500, dt=1e-3,
                                   amp=recipes.HP_AMP, freq=recipes.HP_FREQ,
                                   device=dev)
    twin40 = make_driven_twin(1, hp.WAVEFORMS["sine"](
        amp=recipes.HP_AMP, freq=recipes.HP_FREQ), hidden=14)
    p0 = twin40.init(torch.Generator().manual_seed(42), device=dev)
    hists = {}
    for run in ("kernels", "plain", "f32", "no replay"):
        p12_zero()
        if run in ("kernels", "f32"):
            _, hists[run] = trainer.train_twin(
                twin40, p0, ts_h, xs_h[:, None], optimizer=adam(1e-3),
                num_steps=40, segment_len=50, loss="l1", noise_std=0.002,
                generator=torch.Generator().manual_seed(1),
                backend=be if run == "kernels" else FusedCudaBackend())
            if run == "kernels":
                counts["P12_hp_40_steps_bf16_f32acc"] = p12_read(
                    "P12 HP 40 steps on bf16_f32acc",
                    {"K1 bf16_f32acc": 40, "K2 bf16_f32acc": 40})
            else:
                p12_read("P12 HP 40 steps on f32 (control)",
                         {"K1": 40, "K2": 40})
        else:
            ts_seg, ys_seg = trainer.make_segments(ts_h, xs_h[:, None], 50)
            loss_fn = trainer.segment_loss_fn(twin40, ts_seg, ys_seg,
                                              loss="l1", noise_std=0.002,
                                              backend=be)
            plain = run == "plain"
            with p12_plain_kernels(k1=plain, k2_chunk=None if plain else 1):
                _, hists[run] = trainer.fit_eager(
                    loss_fn, p0, adam(1e-3), 40,
                    torch.Generator().manual_seed(1))
            p12_read(f"P12 HP 40 steps on the plain versions"
                     if plain else "P12 HP 40 steps, K2 without the chunk "
                     "replay (control)",
                     {} if plain else {"K1 bf16_f32acc": 40})

    def h_rel(run):
        return float(((hists[run] - hists["plain"]).abs()
                      / hists["plain"].abs()).max())

    numbers["hp40_hist_rel"] = h_rel("kernels")
    numbers["hp40_hist_controls"] = {k: h_rel(k) for k in ("f32",
                                                           "no replay")}
    print(f"P12 HP 40 steps at bf16_f32acc, kernels vs plain: loss "
          f"{float(hists['kernels'][0]):.6f} -> "
          f"{float(hists['kernels'][-1]):.6f}, max rel diff "
          f"{numbers['hp40_hist_rel']:.3e} (limit {P12_HIST_TOL:g}); "
          f"bitwise equal: {torch.equal(hists['kernels'], hists['plain'])}; "
          f"controls: " + "; ".join(
              f"{k} {v:.3e}" for k, v in numbers["hp40_hist_controls"].items()))
    check(numbers["hp40_hist_rel"] <= P12_HIST_TOL,
          "P12 HP history: kernels vs plain differ")
    check(all(v > P12_HIST_TOL
              for v in numbers["hp40_hist_controls"].values()),
          "P12 HP history: a control passes the limit")

    # the Lorenz96 l1+softdtw fit under each policy (K5 / K6 on bf16 costs)
    for prec in P12_POLICIES:
        p12_zero()
        t_p = time.perf_counter()
        _, hist = trainer.train_twin(
            l96_twin, l96_params, ts_tr, ys_tr, optimizer=adam(4e-4),
            num_steps=P12_P4_STEPS, segment_len=60, loss=L96_CONFIG.loss,
            gamma=0.1, noise_std=L96_CONFIG.noise_regulariser,
            generator=torch.Generator().manual_seed(SEED + 4),
            backend=FusedCudaBackend(precision=prec))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t_p
        path = f"P12_P4_segment_60_{prec}"
        n = P12_P4_STEPS
        counts[path] = p12_read(
            f"P12 L96 {L96_CONFIG.loss} at {prec}, segments of 60",
            {f"K1 {prec}": n, f"K2 {prec}": n, "K5 bf16": n, "K6 bf16": n})
        check(bool(torch.isfinite(hist).all()), f"{path}: non-finite")
        numbers[path] = dict(first=float(hist[0]), last=float(hist[-1]),
                             s=sec)
        print(f"[{smi}] {path}: {n} steps in {sec:.3f} s, loss "
              f"{float(hist[0]):.6f} -> {float(hist[-1]):.6f}")
    return counts, numbers


def k2_bf16_bound(sizes, B, T, u):
    """(bound_ms, bound_by, GFLOP, MB) of one bf16 K2 call: k2_bound's
    products plus the replay's forward pass, at the bf16 tensor-core peak
    (the least the card could take: under "bf16_f32acc" some products take
    a float32 adjoint); the trajectory, drive, cotangent rows 1..T and
    weights read once at 2 bytes, g0 at 4, and dy0 and the float32
    gradients written once."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    macs = sum(a * b for a, b in pairs)
    P = sum(a * b + b for a, b in pairs)
    D = sizes[-1]
    du = u.shape[-1]
    flops = 4 * 2 * (4 * macs - du * sizes[1]) * B * T
    nbytes = (2 * ((T + 1) * B * D + T * B * D + u.numel() + P)
              + 4 * (B * D + P + B * D))
    b_ms, b_by = bound(flops, nbytes, BF16_PEAK)
    return b_ms, b_by, flops / 1e9, nbytes / 1e6


def p12_times(dev, smi, kern) -> dict:
    """Phase 25's CUDA-event means of K1, K2, K5 and K6 under the bf16
    policies beside float32 at the same shapes and inputs, each with its
    plain version and its bound (bytes at the bf16 itemsizes; K1's and
    K2's products, bf16 x bf16 summed in float32, at the bf16 tensor-core
    peak, as K8's bf16 products)."""
    rows = {}

    def row(key, label, k_ms, f32_ms, p_ms, b, extra=""):
        rows[key] = dict(ms=k_ms, f32_ms=f32_ms, plain_ms=p_ms,
                         bound_ms=b[0], bound_by=b[1])
        print(f"[{smi}] {label}: kernel_ms {k_ms:.4f} (f32 {f32_ms:.4f}, "
              f"x{k_ms / f32_ms:.3f}), plain_ms {p_ms:.4f}, bound_ms "
              f"{b[0]:.6f} ({b[1]}: {b[2]:.4f} GFLOP, {b[3]:.4f} MB)"
              f"{extra}, library_ms n/a (no single PyTorch call)")

    for case in ("fleet_l96", "hp_train"):
        for prec in P12_POLICIES:
            y0, u, ws, bs, dt, bt, C, sizes = kern["inputs"][prec, case]
            B, T = y0.shape[0], (u.shape[1 if u.ndim == 3 else 0] - 1) // 2
            reps = 10 if B * T > 100_000 else 20
            k_ms = cuda_ms(lambda: fused_ode_mlp.fused_node_rollout(
                y0, u, ws, bs, dt, batch_tile=bt, time_chunk=C,
                precision=prec), reps=reps, warmup=3)
            f_ms = cuda_ms(lambda: fused_ode_mlp.fused_node_rollout(
                y0, u, ws, bs, dt, batch_tile=bt), reps=reps, warmup=3)
            p_ms = cuda_ms(lambda: ref.fused_node_rollout_bf16_ref(
                y0, u, ws, bs, dt, prec, C), reps=3, warmup=1)
            flops, nbytes = fused_ode_mlp.rollout_work(sizes, B, T,
                                                       u.numel(), 2)
            b = (*bound(flops, nbytes, BF16_PEAK), flops / 1e9, nbytes / 1e6)
            row(("K1", prec, case), f"K1 {prec} [{case}] B={B} T={T} "
                f"sizes={sizes} chunk {C}", k_ms, f_ms, p_ms, b)
    for case in ("l96_train", "hp_train"):
        for prec in P12_POLICIES:
            traj, u, ws, bs, g, dt, C, sizes = kern["inputs"]["k2", prec,
                                                             case]
            B, T = traj.shape[1], traj.shape[0] - 1
            traj32 = traj.float()
            k_ms = cuda_ms(lambda: fused_ode_mlp_bwd.fused_node_rollout_bwd(
                traj, u, ws, bs, g, dt, precision=prec, time_chunk=C),
                reps=20, warmup=3)
            f_ms = cuda_ms(lambda: fused_ode_mlp_bwd.fused_node_rollout_bwd(
                traj32, u, ws, bs, g, dt), reps=20, warmup=3)
            p_ms = cuda_ms(lambda: ref.fused_node_rollout_bf16_bwd_ref(
                traj, u, ws, bs, g, dt, prec, C), reps=3, warmup=1)
            row(("K2", prec, case), f"K2 {prec} [{case}] B={B} T={T} "
                f"sizes={sizes} chunk {C}", k_ms, f_ms, p_ms,
                k2_bf16_bound(sizes, B, T, u),
                ", launches per call 2 (sweep + reduction)")
    for B, n, m in P12_SDTW_SHAPES:
        Db, R = kern["inputs"]["sdtw", B, n, m]
        D32 = Db.float()
        for kname, bwd in (("K5", False), ("K6", True)):
            def call(D):
                if bwd:
                    return softdtw.softdtw_rowmajor_bwd(D, R, gamma=0.1)
                return softdtw.softdtw_rowmajor(D, gamma=0.1, return_r=True)

            def plain():
                if bwd:
                    return ref.softdtw_rowmajor_bwd_ref(D32, R, gamma=0.1)
                return ref.softdtw_rowmajor_ref(D32, gamma=0.1, return_r=True)
            k_ms = cuda_ms(lambda: call(Db), reps=50, queue_ahead=True)
            f_ms = cuda_ms(lambda: call(D32), reps=50, queue_ahead=True)
            p_ms = cuda_ms(plain, reps=3, warmup=1)
            flops, moved = sdtw_work(B, n, m, bwd)
            moved -= 2 * B * n * m            # the costs at 2 bytes, not 4
            b = (*bound(flops, moved), flops / 1e9, moved / 1e6)
            row((kname, "bf16", (B, n, m)), f"{kname} on bf16 costs (B, n, "
                f"m) = ({B}, {n}, {m})", k_ms, f_ms, p_ms, b)
    return rows


def p12_bf16(dev, smi, hp_f32, l96_twin, l96_params, ts_tr, ys_tr) -> dict:
    """Phase 25 (P12): the kernels' checks, the main paths and the timing
    under the bf16 policies.  Returns what the kernels line needs."""
    t0 = time.perf_counter()
    kern = p12_kernels(dev)
    counts, numbers = p12_paths(dev, smi, hp_f32, l96_twin, l96_params,
                                ts_tr, ys_tr)
    times = p12_times(dev, smi, kern)
    sec = time.perf_counter() - t0
    print(f"[{smi}] phase 25 (P12) in {sec:.1f} s")
    return {"kern": kern, "counts": counts, "numbers": numbers,
            "times": times, "s": sec}


def p12_entries(p12) -> list:
    """The kernels line's entries of the bf16 variants."""
    def launches(key):
        by = {p: c[key] for p, c in p12["counts"].items() if c[key]}
        return sum(by.values()), by

    out = []
    for kname, name, src, replaces, case in (
            ("K1", "fused_node_rollout", "fused_ode_mlp.cu",
             "src/repro/kernels/fused_ode_mlp.py:390", "fleet_l96"),
            ("K2", "fused_node_rollout_bwd", "fused_ode_mlp_bwd.cu",
             "src/repro/kernels/fused_ode_mlp_bwd.py:210", "l96_train")):
        for prec in P12_POLICIES:
            n, by = launches(f"{kname} {prec}")
            err = p12["kern"][kname.lower()][prec, case]
            t = p12["times"][kname, prec, case]
            out.append({
                "name": f"{name}_{prec}", "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": replaces, "precision": prec,
                "launches": n, "launches_by_path": by,
                "shape": case, "max_abs_err": err[0],
                "max_rel_err_of_peak": err[1], "bitwise_share": err[2],
                "limit_of_peak": P12_K1_TOL if kname == "K1" else P12_K2_TOL,
                "controls": p12["kern"]["controls"][kname, prec, case],
                "ms": t["ms"], "f32_ms": t["f32_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "other_shape": {k[2]: v for k, v in p12["times"].items()
                                if k[:2] == (kname, prec) and k[2] != case}})
    for kname, name, replaces in (
            ("K5", "softdtw_rowmajor_bf16", "src/repro/kernels/softdtw.py:110"),
            ("K6", "softdtw_rowmajor_bwd_bf16",
             "src/repro/kernels/softdtw.py:215")):
        n, by = launches(f"{kname} bf16")
        t = p12["times"][kname, "bf16", (29, 61, 61)]
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/softdtw.cu",
            "replaces": replaces, "precision": "bf16 costs (both policies)",
            "launches": n, "launches_by_path": by,
            "shape": "B=29 n=61 m=61 gamma=0.1",
            "max_abs_err": max(e[kname][0] for e in p12["kern"]["sdtw"].values()),
            "bitwise_equal_to_plain": all(
                e["bitwise"] for e in p12["kern"]["sdtw"].values()),
            "ms": t["ms"], "f32_ms": t["f32_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "segment_200_shape": p12["times"][kname, "bf16", (8, 201, 201)]})
    return out


# -- phase 26: P13, the twin mesh (K1, K3 and K4 per shard) --------------------
#: Shards of the split mesh: a ``Mesh`` naming the one card this often.
P13_SHARDS = 4
#: The uneven fleet of (b)-(d): 1021 twins pad to 1024, 256 rows a shard.
P13_UNEVEN = 1021
#: (e): the bf16 stream at 256 twins (P7's server cut to one slab of 256).
P13_POPULATION = 256
P13_STREAM = dict(hot_capacity=256, max_batch=256, max_window=200,
                  horizon_quantum=8)
P13_TRACE = dict(seed=26, n_requests=1024, min_horizon=8, max_horizon=64)
P13_COUNTERS = {
    "K1": (fused_ode_mlp, "LAUNCHES"),
    "K1 bf16_f32acc": (fused_ode_mlp, "LAUNCHES_BF16_F32ACC"),
    "K1 bf16": (fused_ode_mlp, "LAUNCHES_BF16"),
    "K3": (noise, "LAUNCHES"),
    "K3_masks": (noise, "MASK_LAUNCHES"),
    "K4": (fused_analogue, "LAUNCHES"),
    "K4_noise": (fused_analogue, "NOISE_LAUNCHES"),
}


def p13_zero():
    for mod, name in P13_COUNTERS.values():
        setattr(mod, name, 0)


def p13_read(path: str, want: dict) -> dict:
    """Phase 26's counts after ``path``; every counter not in ``want`` must
    be 0."""
    torch.cuda.synchronize()
    got = {k: getattr(mod, name) for k, (mod, name) in P13_COUNTERS.items()}
    print(f"{path}: launches " + ", ".join(
        f"{k} {v}" for k, v in got.items() if v or k in want))
    for k, v in got.items():
        check(v == want.get(k, 0), f"{path}: expected {want.get(k, 0)} {k} "
                                   f"launches, got {v}")
    return got


def record_calls(name: str, rows: int, into: list):
    """Wrap the kernel entry point ``ops.<name>`` so that every call on
    ``rows`` twins (a shard, not a probe) keeps its inputs and output in
    ``into``; returns the undo."""
    fn = getattr(ops, name)

    def run(*a, **k):
        out = fn(*a, **k)
        if a[1].shape[0] == rows:
            into.append(((a[0], a[1].clone(), a[2].clone(), a[3]), dict(k),
                         out.clone()))
        return out
    setattr(ops, name, run)
    return lambda: setattr(ops, name, fn)


def p13_serve(ckpt, fleet, ts, reqs, mesh):
    """``serve_fleet`` over ``mesh``: the outputs and each batch's wall ms
    (host clock to a device sync)."""
    outs, ms = [], []
    stream = serve_fleet(ckpt, fleet, ts, reqs, mesh=mesh)
    while True:
        t_b = time.perf_counter()
        out = next(stream, None)
        torch.cuda.synchronize()
        if out is None:
            return outs, ms
        ms.append((time.perf_counter() - t_b) * 1e3)
        outs.append(out)


def p13_mesh(card, smi, noisy_faulty) -> dict:
    """Phase 26 (P13): the Lorenz96 fleet (6->64->64->6, 1024 x 200) served
    over twin meshes from a ``save_twin`` checkpoint: (a) ``serve_fleet(
    mesh=make_twin_mesh())`` bitwise the unsharded serve, one K1 launch a
    request per card; (b) 4 shards on one card, 1021 twins (256 rows a
    shard): 4 K1 launches a request, against (a) and each shard against
    K1's plain version; (c) the same mesh at a per-call
    ``precision="bf16_f32acc"`` against the unsharded bf16 request and the
    plain version; (d) ``FleetServer(mesh=, slo=)`` on the noisy faulty
    analogue substrate: K3 masks at construction only, as many as the
    unsharded server's, K4 per shard against the unsharded request and a
    shard against K4's plain version; (e) ``StreamingFleetServer`` on
    ``bf16_f32acc`` (float32 completions) against the same stream on the
    plain K1.  Returns the counts and numbers."""
    t_phase = time.perf_counter()
    cfg = recipes.FLEET
    ts = recipes.l96_fleet_ts()
    T = cfg.horizon
    one = make_twin_mesh(device=card.type)
    four = Mesh((TWIN_AXIS,), (P13_SHARDS,), (card,) * P13_SHARDS)
    n_one = twin_shard_count(one)
    check(n_one == torch.cuda.device_count(),
          f"P13: make_twin_mesh() has {n_one} shard(s) for "
          f"{torch.cuda.device_count()} card(s)")
    rows = -(-P13_UNEVEN // P13_SHARDS)
    counts, numbers = {}, {}
    fleet = recipes.make_l96_fleet(
        backend=FusedCudaBackend(batch_tile=cfg.batch_tile))
    sizes = tuple(fleet.twin.field.sizes)
    template = fleet.twin.init(torch.Generator().manual_seed(SEED),
                               device="cpu")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p13_") as ckpt:
        checkpoint.save_twin(ckpt, template)
        params = checkpoint.load_twin(ckpt, template, device=card)
        reqs = list(recipes.l96_fleet_requests(num_batches=2, seed=SEED + 13,
                                               device=card))
        ref1 = list(serve_fleet(ckpt, fleet, ts, reqs, device=card))

        # (a) the default mesh: every card, one shard here
        p13_zero()
        outs_a, ms_a = p13_serve(ckpt, fleet, ts, reqs, one)
        counts["P13_serve_fleet_make_twin_mesh"] = p13_read(
            f"P13 (a) serve_fleet over make_twin_mesh() ({n_one} shard(s))",
            {"K1": 2 * n_one})
        same_a = all(torch.equal(o, r) for o, r in zip(outs_a, ref1))
        print(f"[{smi}] P13 (a) {len(outs_a)} batches of "
              f"{tuple(outs_a[0].shape)}: wall ms {ms_a[0]:.3f}; "
              f"{ms_a[1]:.3f}; bitwise serve_fleet without a mesh: {same_a}")
        check(same_a, "P13 (a): the mesh serve is not bitwise the unmeshed "
                      "one")

        # (b) four shards on the card, an uneven fleet
        uneven = [r[:P13_UNEVEN] for r in reqs]
        shard_k1 = []
        undo = record_calls("fused_node_rollout", rows, shard_k1)
        try:
            p13_zero()
            outs_b, ms_b = p13_serve(ckpt, fleet, ts, uneven, four)
            counts["P13_serve_fleet_4_shards_1021"] = p13_read(
                f"P13 (b) serve_fleet over {P13_SHARDS} shards on one card, "
                f"{P13_UNEVEN} twins", {"K1": 2 * P13_SHARDS})
        finally:
            undo()
        check(len(shard_k1) == 2 * P13_SHARDS,
              f"P13 (b): {len(shard_k1)} shard launches of {rows} rows")
        errs_b, same_b = [], True
        for o, a in zip(outs_b, outs_a):
            check(tuple(o.shape) == (P13_UNEVEN, T + 1, cfg.state_dim),
                  f"P13 (b): shape {tuple(o.shape)}")
            errs_b.append(rel_err(o, a[:P13_UNEVEN]))
            same_b &= torch.equal(o, a[:P13_UNEVEN])
        plain_b = [rel_err(out, k1_window_plain(*a, **k))
                   for a, k, out in shard_k1]
        print(f"[{smi}] P13 (b) wall ms {ms_b[0]:.3f}; {ms_b[1]:.3f} "
              f"({P13_SHARDS} K1 launches of {rows} rows a request); vs (a) "
              f"max err of the peak {max(e[1] for e in errs_b):.3e}, bitwise "
              f"{same_b}; each shard vs K1's plain version: " + ", ".join(
                  f"{e[1]:.3e}" for e in plain_b) + f" (limit {TOL:g})")
        check(max(e[1] for e in errs_b) <= TOL,
              "P13 (b): the sharded serve disagrees with (a)")
        check(max(e[1] for e in plain_b) <= TOL,
              "P13 (b): a shard's K1 disagrees with its plain version")

        # K1 per shard beside the whole request, CUDA events
        (p_s, y_s, u_s, dt_s), _, _ = shard_k1[0]
        ws = [p["w"] for p in p_s]
        bs = [p["b"] for p in p_s]
        y_all = torch.cat([a[1] for a, _, _ in shard_k1[:P13_SHARDS]])
        shard_ms = cuda_ms(lambda: fused_ode_mlp.fused_node_rollout(
            y_s, u_s, ws, bs, dt_s, batch_tile=cfg.batch_tile), reps=20,
            warmup=3)
        whole_ms = cuda_ms(lambda: fused_ode_mlp.fused_node_rollout(
            y_all, u_s, ws, bs, dt_s, batch_tile=cfg.batch_tile), reps=20,
            warmup=3)
        shard_plain_ms = cuda_ms(lambda: ref.fused_node_rollout_ref(
            y_s, u_s, ws, bs, dt_s), reps=3, warmup=1)
        b_ms, b_by, gflop, mb = k1_bound(sizes, rows, T, u_s)
        g_s = fused_ode_mlp.launch_geometry(rows, sizes)
        g_w = fused_ode_mlp.launch_geometry(y_all.shape[0], sizes)
        print(f"[{smi}] P13 K1 per shard B={rows} T={T} at "
              f"{geometry_str(g_s)}: kernel_ms {shard_ms:.4f} (x"
              f"{P13_SHARDS} = {P13_SHARDS * shard_ms:.4f}), the whole "
              f"{y_all.shape[0]} at {geometry_str(g_w)} {whole_ms:.4f}; "
              f"plain_ms {shard_plain_ms:.4f}; bound_ms {b_ms:.4f} ({b_by}: "
              f"{gflop:.4f} GFLOP, {mb:.4f} MB)")
        numbers["k1"] = dict(
            ms=shard_ms, whole_ms=whole_ms, plain_ms=shard_plain_ms,
            bound_ms=b_ms, bound_by=b_by,
            max_abs_err=max(e[0] for e in plain_b),
            max_rel_err_of_peak=max(e[1] for e in plain_b),
            vs_unsharded_of_peak=max(e[1] for e in errs_b),
            bitwise_unsharded=same_b, wall_ms_a=ms_a, wall_ms_b=ms_b)

        # (c) bf16_f32acc passed per call, over the same four shards
        be = fleet.backend
        state = be.program(fleet.twin.node.field, params)
        kw16 = dict(method="rk4", gradient="stopgrad",
                    precision="bf16_f32acc")
        y_c = uneven[0]
        shard16 = []
        with torch.no_grad():
            unsh16 = be.rollout_batch(state, y_c, ts, **kw16)
            undo = record_calls("fused_node_rollout", rows, shard16)
            try:
                p13_zero()
                t_b = time.perf_counter()
                sh16 = be.rollout_batch(state, y_c, ts, mesh=four, **kw16)
                torch.cuda.synchronize()
                ms_c = (time.perf_counter() - t_b) * 1e3
                counts["P13_rollout_batch_4_shards_bf16_f32acc"] = p13_read(
                    f"P13 (c) rollout_batch over {P13_SHARDS} shards, "
                    f"precision='bf16_f32acc' per call",
                    {"K1 bf16_f32acc": P13_SHARDS})
            finally:
                undo()
            with p12_plain_kernels():
                plain16 = be.rollout_batch(state, y_c, ts, mesh=four, **kw16)
        check(sh16.dtype == torch.bfloat16, f"P13 (c): {sh16.dtype}")
        r_c = rel_err(sh16.float(), unsh16.float())
        share_c = bitwise_share(sh16, unsh16)
        r_cp = rel_err(sh16.float(), plain16.float())
        share_cp = bitwise_share(sh16, plain16)
        print(f"[{smi}] P13 (c) wall ms {ms_c:.3f}; vs the unsharded bf16 "
              f"request {r_c[1]:.3e} of the peak, bitwise share "
              f"{share_c:.6f}; vs the plain version over the shards "
              f"{r_cp[1]:.3e} / {share_cp:.6f} (limits {P12_K1_TOL:g}, "
              f"{P12_K1_SHARE:g})")
        check(p12_k1_pass(r_c[1], share_c),
              "P13 (c): the sharded bf16 rollout disagrees with the unsharded")
        check(p12_k1_pass(r_cp[1], share_cp),
              "P13 (c): the sharded bf16 rollout disagrees with the plain")
        (p16, y16, u16, dt16), k16, _ = shard16[0]
        ms16 = cuda_ms(lambda: ops.fused_node_rollout(p16, y16, u16, dt16,
                                                      **k16),
                       reps=20, warmup=3)
        with p12_plain_kernels():
            plain16_ms = cuda_ms(lambda: ops.fused_node_rollout(
                p16, y16, u16, dt16, **k16), reps=3, warmup=1)
        flops, nbytes = fused_ode_mlp.rollout_work(sizes, rows, T,
                                                   u16.numel(), 2)
        b16 = bound(flops, nbytes, BF16_PEAK)
        print(f"[{smi}] P13 K1 bf16_f32acc per shard B={rows} T={T}: "
              f"kernel_ms {ms16:.4f}, plain_ms {plain16_ms:.4f}, bound_ms "
              f"{b16[0]:.6f} ({b16[1]})")
        numbers["k1_bf16"] = dict(
            ms=ms16, plain_ms=plain16_ms, bound_ms=b16[0], bound_by=b16[1],
            max_abs_err=r_cp[0], max_rel_err_of_peak=r_cp[1],
            bitwise_share_plain=share_cp, vs_unsharded_of_peak=r_c[1],
            bitwise_share_unsharded=share_c, wall_ms_c=ms_c)

        # (d) FleetServer(mesh=, slo=) on the noisy faulty analogue substrate
        afleet = recipes.make_l96_fleet(backend=FusedAnalogueCudaBackend(
            batch_tile=cfg.batch_tile, prog_seed=SEED, read_seed=SEED,
            **noisy_faulty))
        slo = ServingSLO(max_rel_error=0.5)
        # the sharded server takes its weights as load_twin places them
        placed = checkpoint.load_twin(
            ckpt, template, shardings=fleet_param_shardings(four, template))
        check(len(placed) == P13_SHARDS and all(
            p[0]["w"] is placed[0][0]["w"] for p in placed),
            "P13 (d): load_twin(shardings=) did not place one copy a card")
        built, mask_calls = {}, []
        real_masks = core_faults.stuck_cell_masks_many

        def record_masks(*a, **k):
            out = real_masks(*a, **k)
            mask_calls.append((a, k, out))
            return out
        for name, kw in (("unsharded", dict(device=card, params=params)),
                         ("4_shards", dict(mesh=four, params=placed))):
            p13_zero()
            core_faults.stuck_cell_masks_many = record_masks
            try:
                srv = FleetServer(afleet, ts=ts, slo=slo, **kw)
            finally:
                core_faults.stuck_cell_masks_many = real_masks
            built[name] = (srv, p13_read(
                f"P13 (d) FleetServer({name}, slo) built", {"K3_masks": 2}))
        u_srv, s_srv = built["unsharded"][0], built["4_shards"][0]
        # what K3 drew while the servers were built, against its plain
        # version on the same arguments; and the programs each shard holds
        # against the unsharded server's, tensor for tensor
        check(len(mask_calls) == 4, f"P13 (d): {len(mask_calls)} mask calls")
        mask_err, mask_same = 0.0, True
        for a, k, out in mask_calls:
            want = ref.stuck_cell_masks_many_ref(*a, **k)
            for g_pair, w_pair in zip(out, want):
                for g, w in zip(g_pair, w_pair):
                    mask_same &= torch.equal(g, w)
                    mask_err = max(mask_err, max_abs_diff(g, w))
        prog_err, prog_n, prog_same = programs_diff(u_srv, s_srv, four)
        print(f"[{smi}] P13 (d) K3 masks drawn at construction vs the plain "
              f"version: {len(mask_calls)} calls, max abs {mask_err:g}, "
              f"bitwise {mask_same}; the {P13_SHARDS} shards' placed "
              f"programs vs the unsharded server's: {prog_n} tensors, max "
              f"abs {prog_err:g}, bitwise {prog_same}")
        check(mask_same and mask_err == 0.0,
              "P13 (d): K3's masks differ from the plain version's")
        check(prog_same and prog_err == 0.0,
              "P13 (d): a shard's program differs from the unsharded one")
        # the first request probes the primary (one K4 and pre-pass), which
        # meets the SLO and serves: one more per shard
        p13_zero()
        out_u = u_srv.serve(uneven[0])
        p13_read("P13 (d) unsharded FleetServer(slo) serve",
                 {"K4": 2, "K4_noise": 2})
        shard_k4 = []
        undo = record_calls("fused_analogue_rollout", rows, shard_k4)
        try:
            p13_zero()
            t_b = time.perf_counter()
            out_s = s_srv.serve(uneven[0])
            torch.cuda.synchronize()
            ms_d = (time.perf_counter() - t_b) * 1e3
            got_d = p13_read(
                f"P13 (d) FleetServer(mesh={P13_SHARDS} shards, slo) serve",
                {"K4": 1 + P13_SHARDS, "K4_noise": 1 + P13_SHARDS})
        finally:
            undo()
        counts["P13_fleet_server_4_shards_slo_analogue"] = {
            **got_d, "K3_masks": built["4_shards"][1]["K3_masks"]}
        check(s_srv.active_tier == u_srv.active_tier == afleet.backend.name
              and s_srv.stats.served_by == u_srv.stats.served_by,
              f"P13 (d): tiers {s_srv.stats.served_by} vs "
              f"{u_srv.stats.served_by}")
        r_d = rel_err(out_s, out_u)
        same_d = torch.equal(out_s, out_u)
        check(len(shard_k4) == P13_SHARDS, f"P13 (d): {len(shard_k4)} shards")
        (st4, y4, u4, dt4), k4kw, out4 = shard_k4[0]
        plain4, plain4_ms = timed_once(lambda: k4_window_plain(
            st4, y4, u4, dt4, **k4kw))
        r_dp = rel_err(out4, plain4)
        ms4 = cuda_ms(lambda: ops.fused_analogue_rollout(st4, y4, u4, dt4,
                                                         **k4kw),
                      reps=10, warmup=2)
        flops4, bytes4 = k4_work(st4, y4, u4, T, noisy=True)
        b4 = bound(flops4, bytes4)
        print(f"[{smi}] P13 (d) wall ms {ms_d:.3f} ({len(shard_k4)} K4 "
              f"shard launches of {rows} rows); vs the unsharded request "
              f"{r_d[1]:.3e} of the peak, bitwise {same_d} (limit {TOL:g}); "
              f"shard 0 vs K4's plain version {r_dp[1]:.3e}; K4 per shard "
              f"kernel_ms {ms4:.4f} (pre-pass included), plain_ms "
              f"{plain4_ms:.4f}, bound_ms {b4[0]:.4f} ({b4[1]}); K3 mask "
              f"launches at construction: unsharded "
              f"{built['unsharded'][1]['K3_masks']}, {P13_SHARDS} shards "
              f"{built['4_shards'][1]['K3_masks']}, while serving 0")
        check(same_d or r_d[1] <= TOL, "P13 (d): sharded K4 disagrees")
        check(r_dp[1] <= TOL, "P13 (d): K4 disagrees with its plain version")
        numbers["k3"] = dict(max_abs_err=mask_err, bitwise=mask_same,
                             programs_max_abs_vs_unsharded=prog_err,
                             programs_tensors_compared=prog_n,
                             programs_bitwise=prog_same)
        numbers["k4"] = dict(ms=ms4, plain_ms=plain4_ms, bound_ms=b4[0],
                             bound_by=b4[1], max_abs_err=r_dp[0],
                             max_rel_err_of_peak=r_dp[1],
                             vs_unsharded_of_peak=r_d[1],
                             bitwise_unsharded=same_d, wall_ms_d=ms_d)

    # (e) the bf16 stream: float32 completions, vs the plain K1's stream
    sfleet = recipes.make_l96_fleet(backend=FusedCudaBackend(
        batch_tile=cfg.batch_tile, precision="bf16_f32acc"))
    y0_table = (cfg.y0_spread * torch.randn(
        (P13_POPULATION, cfg.state_dim),
        generator=torch.Generator().manual_seed(SEED + 26))).numpy()
    trace = traffic.poisson_trace(population=P13_POPULATION, **P13_TRACE)

    def stream():
        srv = StreamingFleetServer(sfleet, template, dt=cfg.dt, device=card,
                                   **P13_STREAM)
        return srv, srv.serve_trace(trace, y0_of=lambda i: y0_table[i])

    p13_zero()
    t_b = time.perf_counter()
    srv, done = stream()
    torch.cuda.synchronize()
    ms_e = (time.perf_counter() - t_b) * 1e3
    counts["P13_stream_bf16_f32acc"] = p13_read(
        "P13 (e) StreamingFleetServer on bf16_f32acc",
        {"K1 bf16_f32acc": srv.stream_stats.batches})
    check(len(done) == len(trace), f"P13 (e): {len(done)} of {len(trace)}")
    check(all(c.trajectory.dtype == np.float32
              and np.isfinite(c.trajectory).all() for c in done),
          "P13 (e): a completion is not finite float32")
    with p12_plain_kernels():
        _, plain_done = stream()
    got = torch.from_numpy(np.concatenate(
        [c.trajectory for c in sorted(done, key=lambda c: c.seq)]))
    want = torch.from_numpy(np.concatenate(
        [c.trajectory for c in sorted(plain_done, key=lambda c: c.seq)]))
    r_e, share_e = rel_err(got, want), bitwise_share(got, want)
    print(f"[{smi}] P13 (e) {len(done)} float32 completions in "
          f"{srv.stream_stats.batches} pumps, {ms_e:.3f} ms; vs the stream "
          f"on K1's plain version {r_e[1]:.3e} of the peak, bitwise share "
          f"{share_e:.6f} (limits {P12_K1_TOL:g}, {P12_K1_SHARE:g})")
    check(p12_k1_pass(r_e[1], share_e),
          "P13 (e): the bf16 stream disagrees with the plain stream")
    numbers["stream"] = dict(ms=ms_e, pumps=srv.stream_stats.batches,
                             err_of_peak=r_e[1], bitwise_share=share_e)
    sec = time.perf_counter() - t_phase
    print(f"[{smi}] phase 26 (P13) in {sec:.1f} s")
    return {"counts": counts, "numbers": numbers, "s": sec, "rows": rows}


def p13_entries(p13, k3_masks_row) -> list:
    """The kernels line's entries of the sharded paths (P13)."""
    c, n = p13["counts"], p13["numbers"]

    def by(key):
        return {p: v[key] for p, v in c.items() if v.get(key)}

    shape = (f"{P13_SHARDS} shards x {p13['rows']} rows of {P13_UNEVEN} "
             f"twins, T={recipes.FLEET.horizon}, 6-64-64-6")
    k1, k16, k4 = n["k1"], n["k1_bf16"], n["k4"]
    return [{
        "name": "fused_node_rollout_sharded", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_ode_mlp.cu",
        "replaces": "src/repro/kernels/fused_ode_mlp.py:390", "shape": shape,
        "launches": sum(by("K1").values()), "launches_by_path": by("K1"),
        "max_abs_err": k1["max_abs_err"],
        "max_rel_err_of_peak": k1["max_rel_err_of_peak"],
        "vs_unsharded_of_peak": k1["vs_unsharded_of_peak"],
        "bitwise_unsharded": k1["bitwise_unsharded"],
        "ms": k1["ms"], "whole_request_ms": k1["whole_ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
        "wall_ms_make_twin_mesh": k1["wall_ms_a"],
        "wall_ms_4_shards": k1["wall_ms_b"],
    }, {
        "name": "fused_node_rollout_bf16_f32acc_sharded", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_ode_mlp.cu",
        "replaces": "src/repro/kernels/fused_ode_mlp.py:390", "shape": shape,
        "precision": "bf16_f32acc",
        "launches": sum(by("K1 bf16_f32acc").values()),
        "launches_by_path": by("K1 bf16_f32acc"),
        "max_abs_err": k16["max_abs_err"],
        "max_rel_err_of_peak": k16["max_rel_err_of_peak"],
        "bitwise_share": k16["bitwise_share_plain"],
        "vs_unsharded_of_peak": k16["vs_unsharded_of_peak"],
        "bitwise_share_unsharded": k16["bitwise_share_unsharded"],
        "ms": k16["ms"], "plain_ms": k16["plain_ms"],
        "bound_ms": k16["bound_ms"], "bound_by": k16["bound_by"],
        "library_ms": None, "wall_ms": k16["wall_ms_c"],
        "stream": n["stream"],
    }, {
        "name": "counter_noise_stuck_masks_sharded_serving", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/counter_noise.cu",
        "replaces": "src/repro/kernels/noise.py:80",
        "shape": "P2's programming, once per tier when FleetServer(mesh=, "
                 "slo=) is built, whatever the shard count",
        "launches": sum(by("K3_masks").values()),
        "launches_by_path": by("K3_masks"),
        "max_abs_err": n["k3"]["max_abs_err"],
        "bitwise_plain": n["k3"]["bitwise"],
        "programs_max_abs_vs_unsharded":
            n["k3"]["programs_max_abs_vs_unsharded"],
        "programs_tensors_compared": n["k3"]["programs_tensors_compared"],
        **k3_masks_row, "library_ms": None,
    }, {
        "name": "fused_analogue_rollout_sharded", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_analogue.cu",
        "replaces": "src/repro/kernels/fused_analogue.py:208",
        "shape": shape + ", uint8, read noise 0.02, 1% stuck, drift",
        "launches": sum(by("K4").values()), "launches_by_path": by("K4"),
        "noise_launches": sum(by("K4_noise").values()),
        "max_abs_err": k4["max_abs_err"],
        "max_rel_err_of_peak": k4["max_rel_err_of_peak"],
        "vs_unsharded_of_peak": k4["vs_unsharded_of_peak"],
        "bitwise_unsharded": k4["bitwise_unsharded"],
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": None, "wall_ms": k4["wall_ms_d"],
    }]


# -- phase 27: P14, DeepSeek-V2-Lite at full width (MLA through K8) ----------

#: K8 at DeepSeek-V2-Lite's absorbed MLA prefill, (B, H, Hkv, S, d, dv):
#: kv_lora 512 + rope 64 scored against one latent kv head, the kv_lora
#: columns read as the values.  Held against plain and timed in phase 27.
K8_P14 = (2, 16, 1, 4096, 576, 512)
#: The smoke configs' MLA pair (48, 32) at a ragged and a long S.
K8_P14_SMOKE = [(1, 4, 1, 97, 48, 32), (2, 4, 1, 4096, 48, 32)]
P14_SEQ = 4096        # P14 prompt length: K8_P14's S
#: Depth of P14's float32 parity prefill: the dense prelude block and 3 MoE
#: blocks of the config's 27.
P14_F32_LAYERS = 4
#: Depth of P14's bf16 serving run: the config's own 27 (cut here, and the
#: cut printed, if the phase outgrows its share of the script's budget).
P14_BF16_LAYERS = 27
#: P14 f32 latent caches (ckv, k_rope), kernels vs plain, of the peak.
P14_CACHE_TOL = 1e-4


def mla_k8_inputs(gen, b, h, s, d, dv, dtype, dev):
    """q, k, v as MLA's absorbed flash branch hands them to K8: q the
    (B, S, H, d) concatenation [q_lat, q_rope], k the one-head (B, S, 1,
    d) concatenation [ckv, k_rope], v the latent ckv (B, S, 1, dv), each
    seen as (B, heads, S, .) without a copy."""
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    ckv = torch.randn((b, s, dv), generator=gen, device=dev).to(dtype)
    k_rope = torch.randn((b, s, d - dv), generator=gen, device=dev).to(dtype)
    k = torch.cat([ckv, k_rope], dim=-1)[:, :, None, :]
    return (q.transpose(1, 2), k.transpose(1, 2),
            ckv[:, :, None, :].transpose(1, 2))


def sdpa_backend(q, k, v, scale) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these
    inputs (causal, GQA), as PyTorch's dispatcher reports it."""
    from torch.nn.attention import SDPBackend
    try:
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, None, 0.0, True, scale=scale, enable_gqa=True)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"not reported ({type(e).__name__})"


def p14_deepseek(dev, smi) -> dict:
    """Phase 27 (P14): DeepSeek-V2-Lite served at full width through
    ``make_prefill_step`` / ``greedy_generate``: (a) float32 parity at 4
    layers, kernels against plain; (b) bf16 at its full depth, two
    prefills of (2, 4096) with one K8 launch a layer, then a greedy
    decode (no K8); (c) K8 alone at the MLA prefill's (576, 512) and the
    smoke configs' (48, 32) against plain, timed beside its bound and
    SDPA.  Returns K8's launch counts by path and the new pairs' numbers
    for the kernels line."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    full = get_config("deepseek-v2-lite-16b")
    scale = (full.hd + full.mla_rope_dim) ** -0.5
    counts = {}

    def zero():
        flash_attention.LAUNCHES = 0

    def read(path, want):
        torch.cuda.synchronize()
        got = flash_attention.LAUNCHES
        print(f"{path}: launches {{'K8': {got}}}")
        check(got == want, f"{path}: expected {want} K8 launches, got {got}")
        counts[path] = got

    print(f"P14 config {full.name}: d_model {full.d_model}, heads "
          f"{full.n_heads} (head_dim {full.hd}, rope {full.mla_rope_dim}, "
          f"kv_lora {full.mla_kv_lora}, q_lora {full.mla_q_lora}), MoE "
          f"{full.moe.n_experts} routed + {full.moe.n_shared} shared top-"
          f"{full.moe.top_k} (d_ff {full.moe.d_ff}), first_k_dense "
          f"{full.first_k_dense} (d_ff_dense {full.d_ff_dense}), vocab "
          f"{full.vocab}, {full.n_layers} layers, "
          f"{param_count(full) / 1e9:.2f} B params; K8 at (d, dv) = "
          f"({full.mla_kv_lora + full.mla_rope_dim}, {full.mla_kv_lora}), "
          f"scale {scale:.6f}")

    # -- (a) float32 parity: kernels, then the plain K8 ------------------------
    cfg32 = dataclasses.replace(full, n_layers=P14_F32_LAYERS,
                                dtype="float32")
    prelude, period, n_per = lm_model.block_program(cfg32)
    print(f"P14 reduced (float32 parity): n_layers {full.n_layers} -> "
          f"{cfg32.n_layers} ({len(prelude)} dense + {n_per * len(period)} "
          f"MoE, {param_count(cfg32) / 1e9:.2f} B params of "
          f"{param_count(full) / 1e9:.2f} B), batch 1")
    params = lm_model.init_params(cfg32, seed=SEED, device=dev)
    batch = {"tokens": TokenPipeline(full.vocab, P14_SEQ, 1, seed=SEED)
             .batch_at(0)["tokens"].to(dev)}
    prefill32 = lm_trainer.make_prefill_step(cfg32)
    choices, runs = [], {}
    route_moe = lm_moe.moe_apply
    kernel_flash = ops.flash_attention

    def recording_moe(p, mcfg, x):
        choices[-1].append(torch.sort(lm_moe.route(p, mcfg, x)[2],
                                      dim=-1).values)
        return route_moe(p, mcfg, x)

    lm_moe.moe_apply = recording_moe
    try:
        for mode in ("kernels", "plain"):
            choices.append([])
            if mode == "plain":
                ops.flash_attention = lambda q, k, v, scale=None: \
                    ref.flash_attention_ref(q, k, v, scale=scale)
            zero()
            t_p = time.perf_counter()
            logits, cache = prefill32(params, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t_p
            read(f"P14 float32 prefill (1, {P14_SEQ}) on {mode}",
                 cfg32.n_layers if mode == "kernels" else 0)
            runs[mode] = (logits, tree_leaves(cache))
            print(f"P14 float32 prefill on {mode}: {secs:.3f} s")
            del cache
    finally:
        lm_moe.moe_apply = route_moe
        ops.flash_attention = kernel_flash
    la, lr = rel_err(runs["kernels"][0], runs["plain"][0])
    cr = max(rel_err(a, b)[1] for a, b in zip(runs["kernels"][1],
                                              runs["plain"][1]))
    flips = sum(int((a != b).sum()) for a, b in zip(*choices))
    n_choices = sum(int(a.numel()) for a in choices[0])
    print(f"P14 float32 kernels vs plain: last logits max abs err {la:.3e}, "
          f"of peak {lr:.3e} (limit {P5_LOGIT_TOL:g}); ckv / k_rope caches "
          f"({len(runs['plain'][1])} leaves) of peak {cr:.3e} (limit "
          f"{P14_CACHE_TOL:g}); MoE top-{full.moe.top_k} choices that "
          f"differ: {flips} of {n_choices}")
    check(bool(torch.isfinite(runs["kernels"][0]).all()),
          "P14 float32 logits not finite")
    check(lr <= P5_LOGIT_TOL, "P14 float32 logits: kernels vs plain differ")
    check(cr <= P14_CACHE_TOL, "P14 float32 caches: kernels vs plain differ")
    del params, runs, logits, choices
    torch.cuda.empty_cache()

    # -- (b) bf16 serving at full depth: two prefills, then decode -------------
    cfg = dataclasses.replace(full, n_layers=P14_BF16_LAYERS)
    if cfg.n_layers != full.n_layers:
        print(f"P14 reduced (bf16): n_layers {full.n_layers} -> "
              f"{cfg.n_layers} ({param_count(cfg) / 1e9:.2f} B params)")
    t_i = time.perf_counter()
    params = lm_model.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"P14 bf16 params ({cfg.n_layers} layers, "
          f"{param_count(cfg) / 1e9:.2f} B) on {dev}: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, drawn in "
          f"{time.perf_counter() - t_i:.2f} s")
    prefill = lm_trainer.make_prefill_step(cfg)
    want_cache = lm_model.init_cache(cfg, 2, P14_SEQ, device=dev)
    want_leaves = [(tuple(x.shape), x.dtype) for x in tree_leaves(want_cache)]
    del want_cache
    pipe = TokenPipeline(cfg.vocab, P14_SEQ, 2, seed=SEED)
    prefill_ms = []
    for i in range(2):
        batch = {"tokens": pipe.batch_at(1 + i)["tokens"].to(dev)}
        torch.cuda.synchronize()
        zero()
        t_p = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t_p
        read(f"P14 bf16 prefill {i} (2, {P14_SEQ})", cfg.n_layers)
        check(tuple(logits.shape) == (2, cfg.vocab)
              and logits.dtype == torch.float32, f"P14 logits {logits.shape}")
        check(bool(torch.isfinite(logits).all()), "P14 bf16 logits not finite")
        got_leaves = [(tuple(x.shape), x.dtype) for x in tree_leaves(cache)]
        check(got_leaves == want_leaves, f"P14 cache leaves {got_leaves} vs "
                                         f"init_cache's {want_leaves}")
        prefill_ms.append(secs * 1e3)
        print(f"[{smi}] P14 bf16 prefill {i}: (2, {P14_SEQ}) in "
              f"{secs * 1e3:.3f} ms, {2 * P14_SEQ / secs:,.0f} tokens/s")
        del logits, cache
    finite = []
    decode_step = lm_trainer.decode_step

    def checking_decode(*args):
        out = decode_step(*args)
        finite.append(torch.isfinite(out[0]).all())
        return out

    prompt = pipe.batch_at(3)["tokens"][:, :16].to(dev)
    zero()
    lm_trainer.decode_step = checking_decode
    try:
        torch.cuda.synchronize()
        t_g = time.perf_counter()
        toks = lm_trainer.greedy_generate(params, cfg, prompt, 16, 32)
        torch.cuda.synchronize()
        gen_secs = time.perf_counter() - t_g
    finally:
        lm_trainer.decode_step = decode_step
    read("P14 greedy_generate (16 + 16 tokens)", 0)
    steps = prompt.shape[1] + 16 - 1
    check(tuple(toks.shape) == (2, 16), f"generated {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token range")
    check(len(finite) == steps and bool(torch.stack(finite).all()),
          "P14 decode logits not finite")
    decode_ms = gen_secs / steps * 1e3
    print(f"[{smi}] P14 greedy_generate: {steps} decode steps of batch 2 in "
          f"{gen_secs:.3f} s, {decode_ms:.3f} ms per token step; first "
          f"tokens {toks[0, :6].tolist()}")
    prefill_trace(f"[{smi}] P14", prefill, params,
                  {"tokens": pipe.batch_at(1)["tokens"].to(dev)},
                  {"K8": "k8_flash"})
    del params
    torch.cuda.empty_cache()

    # -- (c) K8 alone at the new pairs, against plain, timed --------------------
    b, h, hkv, s, d, dv = K8_P14
    pairs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = mla_k8_inputs(gen, b, h, s, d, dv, dtype, dev)
        a, r, ratio = k8_vs_plain(str(K8_P14), q, k, v, scale)
        bound, by, gf, mb = k8_work(b, h, hkv, s, d, q.element_size(), dv)
        ms = cuda_ms(lambda: flash_attention.flash_attention(
            q, k, v, scale=scale), reps=5 if dtype == torch.bfloat16 else 2,
            warmup=1)
        row = {"shape": list(K8_P14), "max_abs_err": a,
               "max_rel_err_of_peak": r, "ms": ms, "bound_ms": bound,
               "bound_by": by, "tflops": gf / ms}
        if ratio is not None:
            row["bf16_err_of_rounding_bound"] = ratio
        if dtype == torch.bfloat16:
            row["plain_ms"] = cuda_ms(lambda: ref.flash_attention_ref(
                q, k, v, scale=scale), reps=2, warmup=1)
            backend = sdpa_backend(q, k, v, scale)
            try:
                row["library_ms"] = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=True, scale=scale,
                        enable_gqa=True), reps=3, warmup=1)
            except RuntimeError as e:      # the yardstick only
                row["library_ms"] = None
                print(f"  scaled_dot_product_attention at {K8_P14}: "
                      f"{type(e).__name__}: {str(e)[:200]}")
            row["library_backend"] = backend
            print(f"[{smi}] K8 flash_attention (B, H, Hkv, S, d, dv) = "
                  f"{K8_P14} bf16: kernel_ms {ms:.4f}, plain_ms "
                  f"{row['plain_ms']:.4f}, bound_ms {bound:.4f} ({by}: "
                  f"{gf:.1f} GFLOP of products, {mb:.1f} MB), library_ms "
                  + ("n/a" if row["library_ms"] is None
                     else f"{row['library_ms']:.4f}") +
                  f" (scaled_dot_product_attention, causal, enable_gqa; "
                  f"backend {backend}); achieved {gf / ms:.1f} TFLOP/s of "
                  f"the causal products")
            pairs["576x512"] = row
        else:
            print(f"[{smi}] K8 flash_attention {K8_P14} float32 (CUDA "
                  f"cores): kernel_ms {ms:.4f}, bound_ms {bound:.4f} ({by}, "
                  f"FP32 peak); achieved {gf / ms:.2f} TFLOP/s")
            pairs["576x512"]["f32"] = row
        del q, k, v
        torch.cuda.empty_cache()
    small = get_smoke("deepseek-v2-lite-16b")
    for shape in K8_P14_SMOKE:
        b, h, hkv, s, d, dv = shape
        sc = (small.hd + small.mla_rope_dim) ** -0.5
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = mla_k8_inputs(gen, b, h, s, d, dv, dtype, dev)
            a, r, ratio = k8_vs_plain(str(shape), q, k, v, sc)
            if shape == K8_P14_SMOKE[-1] and dtype == torch.bfloat16:
                bound, by, gf, mb = k8_work(b, h, hkv, s, d, 2, dv)
                ms = cuda_ms(lambda: flash_attention.flash_attention(
                    q, k, v, scale=sc), reps=20, queue_ahead=True)
                pairs["48x32"] = {
                    "shape": list(shape), "max_abs_err": a,
                    "max_rel_err_of_peak": r,
                    "bf16_err_of_rounding_bound": ratio, "ms": ms,
                    "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(
                        q, k, v, scale=sc), reps=2, warmup=1),
                    "bound_ms": bound, "bound_by": by}
                print(f"[{smi}] K8 flash_attention {shape} bf16: kernel_ms "
                      f"{ms:.4f}, bound_ms {bound:.4f} ({by})")
            del q, k, v
    sec = time.perf_counter() - t_phase
    print(f"[{smi}] phase 27 (P14) in {sec:.1f} s")
    return {"counts": counts, "pairs": pairs, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "seconds": sec}


# -- phase 28: P15, continuous depth, xLSTM and the torch examples ----------

#: P15's Llama-3-8B in ``ode_depth`` mode: one weight-tied layer integrated
#: over depth 32 in 4 RK4 steps, 16 block evaluations a prefill, each one
#: K8 launch at (2, 32, 8, 4096, 128) (phase 17's ``K8_P5``, held against
#: plain there).
P15_ODE_DEPTH = 4
P15_SEQ = 4096        # P15 prompt length: K8_P5's S
#: P15 xlstm-125m: a prefill of (1, P15_XLSTM_CPU_SEQ) on the card vs the
#: same call on the CPU, in float64 compute, of the peak.  (In float32 the
#: model itself lands ~1e-4 of the peak from its float64 answer at this
#: width on either device, as phase 28 prints, so float32 card vs CPU is
#: printed and the card's float32 is held to the float64 answer within
#: P15_XLSTM_F32_RATIO x the CPU's own distance to it.)
P15_XLSTM_CPU_SEQ = 1024
P15_XLSTM_TOL = 1e-4
P15_XLSTM_F32_RATIO = 2.0
#: The torch examples, each run as a subprocess on the card: (file, flags,
#: the gate read from its output).
P15_EXAMPLES = (
    ("quickstart.py", ()),
    ("hp_memristor_twin.py", ("--fast",)),
    ("lorenz96_twin.py", ("--fast", "--no-baselines")),
    ("analogue_inference.py", ()),
    ("twin_fleet_serving.py", ()),
    ("fleet_serving_sharded.py", ("--smoke",)),
)
P15_QUICKSTART_MRE = 0.3   # the quickstart's analogue MRE must be below
P15_MATRIX_TOL = 1e-4      # backend matrix: |digital - fused_cuda| MRE
P15_EXAMPLE_TIMEOUT = 300


@contextlib.contextmanager
def float64_compute(on: bool):
    """Run the LM modules in float64 where they compute in float32 (their
    ``F32`` upcasts, the norms, the gates and states of the xLSTM) and a
    ``float32`` config's activations in float64: the float64 answer of a
    float32 call.  Off: nothing changes."""
    if not on:
        yield
        return
    mods = (lm_layers, lm_xlstm, lm_model)
    saved = [m.F32 for m in mods]
    prop = ArchConfig.torch_dtype
    try:
        for m in mods:
            m.F32 = torch.float64
        ArchConfig.torch_dtype = property(lambda self: torch.float64)
        yield
    finally:
        for m, f in zip(mods, saved):
            m.F32 = f
        ArchConfig.torch_dtype = prop


def p15_llama_config():
    """P15's Llama-3-8B at ``ode_depth = 4`` and its K8 launches a prefill
    (one a block evaluation: 4 RK4 stages x ``ode_depth`` steps)."""
    full = dataclasses.replace(get_config("llama3-8b"),
                               ode_depth=P15_ODE_DEPTH)
    return full, 4 * full.ode_depth


def p15_k8_zero():
    flash_attention.LAUNCHES = 0


def p15_k8_read(path, want, counts):
    torch.cuda.synchronize()
    got = flash_attention.LAUNCHES
    print(f"{path}: launches {{'K8': {got}}}")
    check(got == want, f"{path}: expected {want} K8 launches, got {got}")
    counts[path] = got


def p15_llama_serving(dev, smi, counts) -> dict:
    """(b)-(e) of phase 28: two bf16 prefills of (2, 4096), each with 16
    K8 launches; a profiler trace of one; ``decode_step`` raising."""
    full, evals = p15_llama_config()
    _, _, n_per = lm_model.block_program(full)
    print(f"P15 config {full.name} with ode_depth {full.ode_depth}: d_model "
          f"{full.d_model}, {full.n_heads} heads ({full.n_kv} kv, head_dim "
          f"{full.hd}), d_ff {full.d_ff}, vocab {full.vocab}; one weight-"
          f"tied layer integrated over depth {n_per} in {full.ode_depth} "
          f"RK4 steps ({evals} block evaluations, one K8 launch each)")
    pipe = TokenPipeline(full.vocab, P15_SEQ, 2, seed=SEED)
    # -- (b), (c) bf16: two prefills, 16 K8 launches each ---------------------
    t_i = time.perf_counter()
    params = lm_model.init_params(full, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"P15 bf16 params on {dev}: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, drawn in "
          f"{time.perf_counter() - t_i:.2f} s")
    prefill = lm_trainer.make_prefill_step(full)
    prefill_ms = []
    for i in range(2):
        batch = {"tokens": pipe.batch_at(1 + i)["tokens"].to(dev)}
        torch.cuda.synchronize()
        p15_k8_zero()
        t_p = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t_p
        p15_k8_read(f"P15 bf16 ode_depth prefill {i} (2, {P15_SEQ})",
                    evals, counts)
        check(tuple(logits.shape) == (2, full.vocab)
              and logits.dtype == torch.float32, f"P15 logits {logits.shape}")
        check(bool(torch.isfinite(logits).all()), "P15 bf16 logits not finite")
        prefill_ms.append(secs * 1e3)
        print(f"[{smi}] P15 bf16 ode_depth prefill {i}: (2, {P15_SEQ}) in "
              f"{secs * 1e3:.3f} ms, {2 * P15_SEQ / secs:,.0f} tokens/s")
        del logits, cache
    # -- (d) a profiler trace of one prefill ----------------------------------
    prefill_trace(f"[{smi}] P15", prefill, params,
                  {"tokens": pipe.batch_at(1)["tokens"].to(dev)},
                  {"K8": "k8_flash"})
    # -- (e) decode raises, as JAX's does -------------------------------------
    cache = lm_model.init_cache(full, 2, 16, device=dev)
    try:
        lm_model.decode_step(params, full, batch["tokens"][:, :1], 0, cache)
        raised = None
    except NotImplementedError as e:
        raised = str(e)
    print(f"P15 decode_step with ode_depth raises NotImplementedError: "
          f"{raised!r}")
    check(raised == "ODE-depth mode is train/prefill only",
          "P15 decode_step did not raise as the JAX package's does")
    del params, cache
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms}


def p15_llama_parity(dev, counts):
    """(a) of phase 28: a float32 prefill of (2, 4096) through the kernels
    (16 K8 launches), then with K8's plain version (none); last logits
    within P5_LOGIT_TOL of the peak."""
    full, evals = p15_llama_config()
    pipe = TokenPipeline(full.vocab, P15_SEQ, 2, seed=SEED)
    # -- (a) float32: kernels, then the plain K8 ------------------------------
    cfg32 = dataclasses.replace(full, dtype="float32")
    t_i = time.perf_counter()
    params = lm_model.init_params(cfg32, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"P15 float32 params ({n_params / 1e9:.3f} B, one period; the "
          f"discrete stack has {param_count(full) / 1e9:.2f} B) on {dev}: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, drawn in "
          f"{time.perf_counter() - t_i:.2f} s")
    batch = {"tokens": pipe.batch_at(0)["tokens"].to(dev)}
    prefill32 = lm_trainer.make_prefill_step(cfg32)
    runs = {}
    kernel_flash = ops.flash_attention
    try:
        for mode in ("kernels", "plain"):
            if mode == "plain":
                ops.flash_attention = lambda q, k, v, scale=None: \
                    ref.flash_attention_ref(q, k, v, scale=scale)
            p15_k8_zero()
            t_p = time.perf_counter()
            logits, cache = prefill32(params, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t_p
            p15_k8_read(f"P15 float32 ode_depth prefill (2, {P15_SEQ}) on "
                        f"{mode}", evals if mode == "kernels" else 0, counts)
            check(cache["stack"] is None, "P15: the ode_depth cache stack "
                                          "is not None")
            runs[mode] = logits.clone()
            print(f"P15 float32 prefill on {mode}: {secs:.3f} s")
            del logits, cache
    finally:
        ops.flash_attention = kernel_flash
    la, lr = rel_err(runs["kernels"], runs["plain"])
    print(f"P15 float32 kernels vs plain: last logits max abs err {la:.3e}, "
          f"of peak {lr:.3e} (limit {P5_LOGIT_TOL:g}); peak |logit| "
          f"{float(runs['plain'].abs().max()):.3f}")
    check(bool(torch.isfinite(runs["kernels"]).all()),
          "P15 float32 logits not finite")
    check(lr <= P5_LOGIT_TOL, "P15 float32 logits: kernels vs plain differ")
    del params, runs
    torch.cuda.empty_cache()
    return lr


def p15_xlstm_serving(dev, smi) -> dict:
    """xlstm-125m at full width on phase 28: two bf16 prefills of (2, 4096)
    with the sLSTM layers' share by host clock and a greedy decode of 31
    steps."""
    full = get_config("xlstm-125m")
    xc = full.xlstm_cfg()
    _, period, n_per = lm_model.block_program(full)
    print(f"P15 config {full.name}: {full.n_layers} layers (periods of "
          f"{len(period)}: {', '.join(s.mixer for s in period)}), d_model "
          f"{full.d_model}, {full.n_heads} heads (mLSTM d_inner {xc.d_inner},"
          f" head_dim {xc.head_dim}, chunk {xc.chunk}), vocab {full.vocab}, "
          f"{param_count(full) / 1e6:.1f} M params (analytic)")
    params = lm_model.init_params(full, seed=SEED, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    prefill = lm_trainer.make_prefill_step(full)
    pipe = TokenPipeline(full.vocab, P15_SEQ, 2, seed=SEED)
    slstm_prefill = lm_xlstm.slstm_prefill
    slstm_s = []

    def timed_slstm(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = slstm_prefill(*args)
        torch.cuda.synchronize()
        slstm_s.append(time.perf_counter() - t)
        return out

    prefill_ms, shares = [], []
    lm_xlstm.slstm_prefill = timed_slstm
    try:
        for i in range(2):
            batch = {"tokens": pipe.batch_at(i)["tokens"].to(dev)}
            slstm_s.clear()
            torch.cuda.synchronize()
            t_p = time.perf_counter()
            logits, cache = prefill(params, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t_p
            check(tuple(logits.shape) == (2, full.vocab) and bool(
                torch.isfinite(logits).all()), "P15 xLSTM bf16 logits")
            check(len(slstm_s) == n_per, f"P15: {len(slstm_s)} sLSTM calls")
            prefill_ms.append(secs * 1e3)
            shares.append(sum(slstm_s) / secs)
            print(f"[{smi}] P15 xLSTM bf16 prefill {i}: (2, {P15_SEQ}) in "
                  f"{secs * 1e3:.3f} ms, {2 * P15_SEQ / secs:,.0f} tokens/s; "
                  f"sLSTM layers {sum(slstm_s) * 1e3:.3f} ms "
                  f"({100 * shares[-1]:.1f}% of the prefill, host clock, "
                  f"{n_per} layers x {P15_SEQ} steps)")
            del logits, cache
    finally:
        lm_xlstm.slstm_prefill = slstm_prefill
    prompt = pipe.batch_at(2)["tokens"][:, :16].to(dev)
    torch.cuda.synchronize()
    t_g = time.perf_counter()
    toks = lm_trainer.greedy_generate(params, full, prompt, 16, 32)
    torch.cuda.synchronize()
    gen_secs = time.perf_counter() - t_g
    steps = prompt.shape[1] + 16 - 1
    check(tuple(toks.shape) == (2, 16) and bool(
        ((toks >= 0) & (toks < full.vocab)).all()), "P15 xLSTM tokens")
    decode_ms = gen_secs / steps * 1e3
    print(f"[{smi}] P15 xLSTM greedy_generate: {steps} decode steps of batch "
          f"2 in {gen_secs:.3f} s, {decode_ms:.3f} ms per token step; first "
          f"tokens {toks[0, :6].tolist()}")
    del params
    torch.cuda.empty_cache()
    return {"params": n_params, "prefill_ms": prefill_ms,
            "slstm_share": shares, "decode_ms": decode_ms}


def p15_xlstm_card_vs_cpu(dev) -> dict:
    """xlstm-125m's prefill of (1, P15_XLSTM_CPU_SEQ) on the card against
    the same call on the CPU (no kernel runs): float64 compute card vs
    CPU within P15_XLSTM_TOL of the peak; float32 on each, beside the
    float64 answer, the card's within P15_XLSTM_F32_RATIO x the CPU's
    distance to it."""
    full = get_config("xlstm-125m")
    cfg32 = dataclasses.replace(full, dtype="float32")
    p_dev = lm_model.init_params(cfg32, seed=SEED, device=dev)
    batch = TokenPipeline(full.vocab, P15_XLSTM_CPU_SEQ, 1, seed=SEED
                          ).batch_at(0)["tokens"]
    f32 = lm_trainer.make_prefill_step(cfg32)
    last, secs = {}, {}
    for prec in ("float32", "float64"):
        with float64_compute(prec == "float64"):
            for where, d in (("card", dev), ("CPU", torch.device("cpu"))):
                wide = torch.float64 if prec == "float64" else torch.float32
                p = tree_map(lambda x: x.to(d, wide), p_dev)
                t_c = time.perf_counter()
                logits, _ = f32(p, {"tokens": batch.to(d)})
                torch.cuda.synchronize()
                secs[where, prec] = time.perf_counter() - t_c
                check(bool(torch.isfinite(logits).all()),
                      f"P15 xLSTM {prec} on the {where}: not finite")
                last[where, prec] = logits.double().cpu()
                del p, logits
    exact = last["CPU", "float64"]
    errs = {"card_vs_cpu_float64": rel_err(last["card", "float64"], exact),
            "card_vs_cpu_float32": rel_err(last["card", "float32"],
                                           last["CPU", "float32"]),
            "card_float32_vs_float64": rel_err(last["card", "float32"],
                                               exact),
            "cpu_float32_vs_float64": rel_err(last["CPU", "float32"],
                                              exact)}
    print(f"P15 xLSTM prefill (1, {P15_XLSTM_CPU_SEQ}), last logits of the "
          f"peak: float64 card vs CPU "
          f"{errs['card_vs_cpu_float64'][1]:.3e} (limit {P15_XLSTM_TOL:g}); "
          f"float32 card vs CPU {errs['card_vs_cpu_float32'][1]:.3e}, card "
          f"vs the float64 answer {errs['card_float32_vs_float64'][1]:.3e}, "
          f"CPU vs it {errs['cpu_float32_vs_float64'][1]:.3e} (the card's "
          f"float32 within {P15_XLSTM_F32_RATIO:g}x the CPU's); seconds "
          + ", ".join(f"{w} {p} {s:.3f}" for (w, p), s in secs.items()))
    check(errs["card_vs_cpu_float64"][1] <= P15_XLSTM_TOL,
          "P15 xLSTM float64: card vs CPU differ")
    check(errs["card_float32_vs_float64"][1] <= P15_XLSTM_F32_RATIO
          * errs["cpu_float32_vs_float64"][1],
          "P15 xLSTM float32: the card is further from the float64 answer "
          "than the CPU allows")
    del p_dev, last
    torch.cuda.empty_cache()
    return {k: v[1] for k, v in errs.items()}


def p15_example_gates(name: str, out: str) -> dict:
    """The gate values an example prints, checked."""
    if name == "quickstart.py":
        m = re.search(r"analogue twin MRE vs ground truth: ([0-9.]+)", out)
        check(m is not None, "quickstart printed no analogue MRE")
        v = float(m.group(1))
        check(v < P15_QUICKSTART_MRE, f"quickstart analogue MRE {v} >= "
                                      f"{P15_QUICKSTART_MRE}")
        return {"analogue_mre": v}
    if name == "analogue_inference.py":
        got = {k: float(v) for k, v in re.findall(
            r"^  (digital|fused_cuda|analogue) +MRE vs truth ([0-9.]+)$",
            out, re.M)}
        check(set(got) == {"digital", "fused_cuda", "analogue"},
              f"backend matrix lines: {got}")
        gap = abs(got["digital"] - got["fused_cuda"])
        check(gap <= P15_MATRIX_TOL, f"backend matrix: digital vs "
                                     f"fused_cuda MRE differ by {gap}")
        return {"backend_matrix": got, "digital_vs_fused_cuda": gap}
    if name == "fleet_serving_sharded.py":
        check(out.rstrip().endswith("OK"), "fleet_serving_sharded: no OK")
    return {}


def p15_start_examples() -> list:
    """Every ``examples/torch`` driver started as its own process on the
    card, all together, each logging to an anonymous temporary file."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    # the host's cores shared among the processes, not each taking all
    env.setdefault("OMP_NUM_THREADS", str(max(
        1, (os.cpu_count() or 1) // len(P15_EXAMPLES))))
    procs = []
    for name, flags in P15_EXAMPLES:
        log = tempfile.TemporaryFile(mode="w+")
        procs.append((name, flags, log, subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / "torch" / name),
             *flags], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT)))
    return procs


def p15_stop_examples(procs):
    for *_, log, proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()


def p15_wait_examples(procs, t0, smi) -> dict:
    """Wait for the examples started at ``t0``: each must exit 0 within
    P15_EXAMPLE_TIMEOUT and its gates hold; each one's wall time from the
    common start."""
    ended, rows = {}, {}
    while len(ended) < len(procs):
        for name, _, _, proc in procs:
            if name not in ended and proc.poll() is not None:
                ended[name] = time.perf_counter() - t0
        if time.perf_counter() - t0 > P15_EXAMPLE_TIMEOUT:
            raise RuntimeError(
                f"chip_smoke: examples still running after "
                f"{P15_EXAMPLE_TIMEOUT} s: "
                f"{sorted(set(n for n, *_ in procs) - set(ended))}")
        time.sleep(0.2)
    for name, flags, log, proc in procs:
        log.seek(0)
        out = log.read()
        if proc.returncode != 0:
            print(out[-4000:])
        check(proc.returncode == 0, f"example {name} {' '.join(flags)} "
                                    f"exited {proc.returncode}")
        gates = p15_example_gates(name, out)
        rows[name] = {"flags": list(flags), "seconds": ended[name], **gates}
        print(f"[{smi}] P15 example {name} {' '.join(flags)}: exit 0 in "
              f"{ended[name]:.1f} s (all {len(procs)} started together on "
              f"one card, beside P15's float32 checks); gates {gates}")
    return rows


def p15_continuous_depth(dev, smi) -> dict:
    """Phase 28 (P15): Llama-3-8B's weight-tied layer in ``ode_depth`` mode
    through K8, xlstm-125m, and the torch examples.  The timed serving
    runs go first, on a quiet card; then the examples start, and the
    float32 checks (Llama's kernels vs plain, xLSTM's card vs CPU) run
    beside them.  Returns K8's launch counts by path and the phase's
    numbers."""
    t_phase = time.perf_counter()
    counts = {}
    llama = p15_llama_serving(dev, smi, counts)
    t_x = time.perf_counter()
    xlstm = p15_xlstm_serving(dev, smi)
    t_e = time.perf_counter()
    procs = p15_start_examples()
    try:
        llama["f32_logits_of_peak"] = p15_llama_parity(dev, counts)
        xlstm["card_vs_cpu_of_peak"] = p15_xlstm_card_vs_cpu(dev)
        t_c = time.perf_counter()
        examples = p15_wait_examples(procs, t_e, smi)
    finally:
        p15_stop_examples(procs)
    t_end = time.perf_counter()
    sec = t_end - t_phase
    print(f"[{smi}] phase 28 (P15) in {sec:.1f} s: Llama bf16 serving "
          f"{t_x - t_phase:.1f} s, xLSTM serving {t_e - t_x:.1f} s, then "
          f"the examples {t_end - t_e:.1f} s with the float32 checks "
          f"({t_c - t_e:.1f} s) beside them")
    return {"counts": counts, "llama": llama, "xlstm": xlstm,
            "examples": examples, "seconds": sec}


def main() -> int:
    # -- 1. environment ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print("TF32 off: matmul.allow_tf32=False, cudnn.allow_tf32=False, "
          "float32_matmul_precision='highest'")
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}; "
          f"bounds against H100 SXM peaks: {FP32_PEAK / 1e12:g} TFLOP/s "
          f"fp32, {TF32_PEAK / 1e12:g} tf32 and {BF16_PEAK / 1e12:g} bf16 "
          f"tensor cores, {HBM_BW / 1e12:g} TB/s")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    chain_lib, chain_proc = sdtw_chain_build()   # beside the kernels
    libs = _build.build()
    print(f"build: {len(libs)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s")
    for src, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {src}: {line.strip()}")
    sass = {src: sass_counts(path) for src, path in libs.items()}
    hmma = {src: {fn: c["HMMA"] for fn, c in counts.items()}
            for src, counts in sass.items()}
    for src, counts in hmma.items():
        print(f"SASS HMMA {src}: " + "; ".join(
            f"{fn} {n}" for fn, n in counts.items()))
    # K1, K2 and K4: float32 FMAs per shared-memory load, in the whole
    # function and in its densest barrier-to-barrier phase
    for src in ("fused_ode_mlp", "fused_ode_mlp_bwd", "fused_analogue",
                "fused_wide"):
        print(f"SASS FFMA/LDS {src}: " + "; ".join(
            f"{fn} FFMA {c['FFMA']} LDS {c['LDS']} ratio "
            f"{c['FFMA'] / max(c['LDS'], 1):.2f}, densest phase FFMA "
            f"{c['dense']['FFMA']} LDS {c['dense']['LDS']} ratio "
            f"{c['dense']['FFMA'] / max(c['dense']['LDS'], 1):.2f}"
            for fn, c in sass[src].items()))
    # K9: per step of a chunk's 32 unrolled steps (its densest phase), the
    # special-function (expf), FFMA and shared-memory loads of one lane; the
    # cp.async copies of the staging (LDGSTS) in the whole function
    for fn, c in sass["ssm_scan"].items():
        d = c["dense"]
        print(f"SASS ssm_scan {fn}: per step MUFU {d['MUFU'] / K9_CHUNK:.2f}, "
              f"FFMA {d['FFMA'] / K9_CHUNK:.2f}, LDS {d['LDS'] / K9_CHUNK:.2f}; "
              f"whole function MUFU {c['MUFU']} FFMA {c['FFMA']} LDGSTS "
              f"{c['LDGSTS']}")
        check(d["MUFU"] > 0 and c["LDGSTS"] > 0,
              f"SASS: {fn} has no expf in its steps or no cp.async staging")
    # K4's read-noise instantiations stream the noisy pairs by cp.async
    k4_copies = [c["LDGSTS"] for fn, c in sass["fused_analogue"].items()
                 if "k4_rollout_kernel" in fn]
    check(sum(n > 0 for n in k4_copies) * 2 == len(k4_copies),
          f"SASS: K4 rollout LDGSTS counts {k4_copies}; want half of them "
          f"(the read-noise instantiations) > 0")
    for src, kernel, tensor_cores in (
            ("flash_attention", "k8_flash_mma_kernel", True),
            ("flash_attention", "k8_flash_mla_kernel", True),
            ("flash_attention", "k8_flash_kernel", False),
            ("crossbar_vmm", "k7_gemm_kernel", True)):
        found = {fn: n for fn, n in hmma[src].items() if kernel in fn}
        check(bool(found), f"SASS: no {kernel} in {src}")
        check(all((n > 0) == tensor_cores for n in found.values()),
              f"SASS: {kernel} has HMMA counts {list(found.values())}; want "
              f"{'> 0' if tensor_cores else '0'} in every instantiation")

    # -- 3. kernel vs plain version -------------------------------------------
    gen = torch.Generator().manual_seed(SEED)
    cases = {
        "l96_autonomous": ((6, 64, 64, 6), 1024, 200, "none", 0.0025),
        "hp_shared_drive": ((2, 14, 14, 1), 64, 500, "shared", 1e-3),
        "hp_per_twin_drive_B100": ((2, 14, 14, 1), 100, 200, "per_twin",
                                   1e-3),
        # 73 KB of weights: past the 48 KB static limit, so the launch
        # raises the block's dynamic shared-memory allowance first
        "wide_h128_over_48KB": ((6, 128, 128, 6), 256, 50, "none", 0.0025),
    }
    errs, inputs = {}, {}
    for case, (sizes, B, T, mode, dt) in cases.items():
        params, y0, u = make_case(gen, sizes, B, T, mode, dev)
        ws = [p["w"] for p in params]
        bs = [p["b"] for p in params]
        y0p, up, bt, _ = fused_ode_mlp.pad_fleet_to_tile(y0, u, 64)
        got = fused_ode_mlp.fused_node_rollout(y0p, up, ws, bs, dt,
                                               batch_tile=bt)[:, :B]
        want = ref.fused_node_rollout_ref(y0, u, ws, bs, dt)
        torch.cuda.synchronize()
        check(got.shape == (T + 1, B, sizes[-1]), f"{case}: shape {got.shape}")
        check(bool(torch.isfinite(got).all()), f"{case}: non-finite output")
        a, r = rel_err(got, want)
        errs[case] = (a, r)
        inputs[case] = (y0p, up, ws, bs, dt, bt, sizes, B, T)
        print(f"kernel vs plain [{case}] B={B} T={T} sizes={sizes}: "
              f"max abs err {a:.3e}, of peak {r:.3e} (limit {TOL:g})")
        check(r <= TOL, f"{case}: kernel disagrees with its plain version")
        # the same twins at one twin per block and at the other tile: a
        # twin's trajectory does not depend on the launch geometry
        chosen = fused_ode_mlp.launch_geometry(y0p.shape[0], sizes)
        for rt in sorted({1, other_tile(chosen)}):
            forced = fused_ode_mlp.launch_geometry(y0p.shape[0], sizes,
                                                   twins_per_block=rt)
            alt = fused_ode_mlp.fused_node_rollout_at(forced, y0p, up, ws, bs,
                                                      dt)[:, :B]
            same = torch.equal(alt, got)
            print(f"  K1 [{case}] at {geometry_str(chosen)} vs "
                  f"{geometry_str(forced)}: bitwise identical: {same}")
            check(same, f"{case}: K1's trajectory depends on the geometry")

    # -- 4. the main path ------------------------------------------------------
    cfg = recipes.FLEET
    fleet = recipes.make_l96_fleet(
        backend=FusedCudaBackend(batch_tile=cfg.batch_tile))
    ts = recipes.l96_fleet_ts()
    n_batches = 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        params = fleet.twin.init(torch.Generator().manual_seed(SEED),
                                 device="cpu")
        checkpoint.save_twin(ckpt, params)

        fused_ode_mlp.LAUNCHES = 0
        outs, times = [], []
        stream = serve_fleet(ckpt, fleet, ts, recipes.l96_fleet_requests(
            num_batches=n_batches, seed=SEED, device=dev), device=dev)
        while True:
            t_b = time.perf_counter()
            out = next(stream, None)
            torch.cuda.synchronize()
            if out is None:
                break
            times.append(time.perf_counter() - t_b)
            outs.append(out)
        launches = fused_ode_mlp.LAUNCHES

        want_shape = (cfg.fleet_size, cfg.horizon + 1, cfg.state_dim)
        check(len(outs) == n_batches, f"served {len(outs)} batches")
        for i, (o, s) in enumerate(zip(outs, times)):
            check(tuple(o.shape) == want_shape, f"batch {i}: shape {o.shape}")
            check(bool(torch.isfinite(o).all()), f"batch {i}: non-finite")
            print(f"main path batch {i}: {tuple(o.shape)} in {s * 1e3:.3f} ms "
                  f"({cfg.fleet_size * cfg.horizon / s:,.0f} twin-steps/s)")
        print(f"main path: fused_node_rollout launches = {launches} "
              f"for {n_batches} request batches")
        check(launches == n_batches,
              f"expected {n_batches} kernel launches, counted {launches}")

        digital = list(serve_fleet(
            ckpt, fleet.with_backend(DigitalBackend()), ts,
            recipes.l96_fleet_requests(num_batches=n_batches, seed=SEED,
                                       device=dev), device=dev))
        torch.cuda.synchronize()
        for i, (o, d) in enumerate(zip(outs, digital)):
            a, r = rel_err(o, d)
            print(f"main path batch {i}: fused vs digital max abs err "
                  f"{a:.3e}, of peak {r:.3e} (limit {TOL:g})")
            check(r <= TOL, f"batch {i}: fused_cuda disagrees with digital")

    # -- 5. timing ---------------------------------------------------------------
    y0p, up, ws, bs, dt, bt, sizes, B, T = inputs["l96_autonomous"]
    kernel_ms = cuda_ms(lambda: fused_ode_mlp.fused_node_rollout(
        y0p, up, ws, bs, dt, batch_tile=bt), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: ref.fused_node_rollout_ref(
        y0p, up, ws, bs, dt), reps=5, warmup=1)
    bound_ms, bound_by, gflop, mb = k1_bound(sizes, B, T, up)
    print(f"[{smi}] K1 fused_node_rollout B={B} T={T} sizes={sizes} at "
          f"{geometry_str(fused_ode_mlp.launch_geometry(B, sizes))}: "
          f"kernel_ms {kernel_ms:.4f} ({1e3 * kernel_ms / T:.3f} us per RK4 "
          f"step), plain_ms {plain_ms:.4f}, "
          f"bound_ms {bound_ms:.4f} ({bound_by}: {gflop:.3f} GFLOP, "
          f"{mb:.3f} MB), launches per request 1, "
          f"library_ms n/a (no single PyTorch call computes an RK4 rollout)")

    # -- 6. K2 vs plain version -------------------------------------------------
    k2_cases = {
        # the Lorenz96 training shape (paper window: 29 segments of 60)
        "l96_train_autonomous": ((6, 64, 64, 6), 29, 60, "none", 0.0025),
        # the shape phase 7's Lorenz96 training launches (CI window: 14
        # segments of 60)
        "l96_train_ci_autonomous": ((6, 64, 64, 6), 14, 60, "none", 0.0025),
        # the HP training shape: 9 segments of 50, one drive per segment
        "hp_train_per_twin_drive": ((2, 14, 14, 1), 9, 50, "per_twin",
                                    1e-3),
        "fleet_l96": ((6, 64, 64, 6), 1024, 200, "none", 0.0025),
        "wide_h128": ((6, 128, 128, 6), 64, 50, "none", 0.0025),
    }
    k2_errs, k2_inputs = {}, {}
    for case, (sizes, B, T, mode, dt) in k2_cases.items():
        params, y0, u = make_case(gen, sizes, B, T, mode, dev)
        ws = [p["w"] for p in params]
        bs = [p["b"] for p in params]
        try:
            need = fused_ode_mlp.launch_geometry(B, sizes,
                                                 backward=True).smem_bytes
        except ValueError as e:
            print(f"K2 [{case}] sizes={sizes}: refused: {e}")
            continue
        traj = fused_ode_mlp.fused_node_rollout(y0, u, ws, bs, dt,
                                                batch_tile=B)
        g = torch.randn(traj.shape, generator=gen).to(dev)
        got = fused_ode_mlp_bwd.fused_node_rollout_bwd(traj, u, ws, bs, g, dt)
        again = fused_ode_mlp_bwd.fused_node_rollout_bwd(traj, u, ws, bs, g,
                                                         dt)
        want = ref.fused_node_rollout_bwd_ref(traj, u, ws, bs, g, dt)
        torch.cuda.synchronize()
        for x in [got[0], *got[1], *got[2]]:
            check(bool(torch.isfinite(x).all()), f"K2 {case}: non-finite")
        a, r, rels = grads_rel_err(got, want)
        bitwise = all(torch.equal(x, y) for x, y in zip(
            [got[0], *got[1], *got[2]], [again[0], *again[1], *again[2]]))
        k2_errs[case] = (a, r)
        k2_inputs[case] = (traj, u, ws, bs, g, dt, sizes, B, T)
        print(f"K2 vs plain [{case}] B={B} T={T} sizes={sizes} "
              f"smem={need} B: max abs err {a:.3e}, worst of peak {r:.3e} "
              f"(limit {TOL:g}; per gradient "
              f"{', '.join(f'{x:.1e}' for x in rels)}); repeat bitwise "
              f"identical: {bitwise}")
        check(r <= TOL, f"K2 {case}: kernel disagrees with its plain version")
        check(bitwise, f"K2 {case}: two calls differ")
        # one twin per block and the other tile: dy0 bitwise, the weight
        # gradients (summed in another order) within the same tolerance
        chosen = fused_ode_mlp.launch_geometry(B, sizes, backward=True)
        for rt in sorted({1, other_tile(chosen)}):
            try:
                forced = fused_ode_mlp.launch_geometry(
                    B, sizes, backward=True, twins_per_block=rt)
            except ValueError as e:
                print(f"  K2 [{case}] at {rt} twins per block: refused: {e}")
                continue
            alt = fused_ode_mlp_bwd.fused_node_rollout_bwd_at(
                forced, traj, u, ws, bs, g, dt)
            same = torch.equal(alt[0], got[0])
            _, r_alt, _ = grads_rel_err(alt, want)
            print(f"  K2 [{case}] at {geometry_str(chosen)} vs "
                  f"{geometry_str(forced)}: dy0 bitwise identical: {same}; "
                  f"gradients vs plain {r_alt:.3e} of peak (limit {TOL:g})")
            check(same, f"K2 {case}: dy0 depends on the geometry")
            check(r_alt <= TOL, f"K2 {case}: gradients at {rt} twins per "
                                f"block disagree with the plain version")

    # -- 7. the training paths ---------------------------------------------------
    phases = []             # (path, steps, seconds) per trajectory phase
    path = [""]
    train_twin = trainer.train_twin

    def timed_train_twin(*args, **kw):
        torch.cuda.synchronize()
        t_p = time.perf_counter()
        out = train_twin(*args, **kw)
        torch.cuda.synchronize()
        phases.append((path[0], kw["num_steps"], time.perf_counter() - t_p))
        return out

    def reset_counts(phase):
        path[0] = phase
        fused_ode_mlp.LAUNCHES = 0
        fused_ode_mlp_bwd.LAUNCHES = 0

    def read_counts(phase, steps):
        counts = (fused_ode_mlp.LAUNCHES, fused_ode_mlp_bwd.LAUNCHES)
        print(f"{phase}: K1 launches {counts[0]}, K2 launches {counts[1]} "
              f"for {steps} fused gradient steps")
        check(counts == (steps, steps),
              f"{phase}: expected {steps} K1 and K2 launches, got {counts}")
        return counts

    trainer.train_twin = timed_train_twin
    try:
        reset_counts("train_hp_twin")
        twin, params, loss = recipes.train_hp_twin(
            pretrain_steps=200, train_steps=250, backend="fused_cuda",
            device=dev)
        torch.cuda.synchronize()
        hp_counts = read_counts("train_hp_twin", 250)
        print(f"train_hp_twin: final loss {loss:.6f} (gate < 0.01)")
        check(loss < 0.01, "HP twin: final loss over the 0.01 gate")
        for wf in ("sine", "triangular", "rectangular", "modulated_sine"):
            m = recipes.eval_hp_twin(twin, params, wf, device=dev)
            gate = 0.1 if wf == "sine" else 0.25
            print(f"  HP {wf:15s} MRE {m['mre']:.4f} (gate < {gate}), "
                  f"DTW/pt {m['dtw']:.6f}")
            check(m["mre"] < gate, f"HP twin: {wf} MRE over its gate")
            if wf == "sine":
                hp_f32 = (loss, m["mre"])     # beside phase 25's bf16 twin
        m = recipes.eval_hp_twin(twin, params, "sine", device=dev,
                                 backend=FusedCudaBackend(batch_tile=1))
        print(f"  HP sine served on fused_cuda: MRE {m['mre']:.4f}")

        # the same 40 steps on the two substrates, from the same weights
        ts, xs, _, _ = hp.generate("sine", num_points=500, dt=1e-3,
                                   amp=recipes.HP_AMP, freq=recipes.HP_FREQ,
                                   device=dev)
        twin40 = make_driven_twin(1, hp.WAVEFORMS["sine"](
            amp=recipes.HP_AMP, freq=recipes.HP_FREQ), hidden=14)
        p0 = twin40.init(torch.Generator().manual_seed(42), device=dev)
        hists, hp40_counts = {}, {}
        for substrate, be in (("fused_cuda", "fused_cuda"),
                              ("digital", None)):
            reset_counts(f"hp_40_steps_{substrate}")
            _, hists[substrate] = trainer.train_twin(
                twin40, p0, ts, xs[:, None], optimizer=adam(1e-3),
                num_steps=40, segment_len=50, loss="l1", noise_std=0.002,
                generator=torch.Generator().manual_seed(1), backend=be)
            torch.cuda.synchronize()
            hp40_counts[substrate] = read_counts(
                f"hp_40_steps_{substrate}", 40 if be else 0)
        hist_rel = float(((hists["fused_cuda"] - hists["digital"]).abs()
                          / hists["digital"].abs()).max())
        print(f"HP 40 steps, fused_cuda vs digital adjoint: loss "
              f"{float(hists['fused_cuda'][0]):.6f} -> "
              f"{float(hists['fused_cuda'][-1]):.6f}, max rel diff "
              f"{hist_rel:.3e} (limit {HIST_TOL:g})")
        check(hist_rel <= HIST_TOL, "fused vs digital loss histories differ")

        data = recipes.l96_data(num_points=1200, device=dev)
        reset_counts("train_l96_twin")
        l96_twin, l96_params = recipes.train_l96_twin(
            pretrain_steps=1500, train_steps=((60, 300, 1e-3),), data=data,
            backend="fused_cuda", device=dev)
        torch.cuda.synchronize()
        l96_counts = read_counts("train_l96_twin", 300)
    finally:
        trainer.train_twin = train_twin
    m = recipes.eval_l96_twin(l96_twin, l96_params, data=data)
    l96_ts, l96_ys, split = data
    with torch.no_grad():
        pred = l96_twin.simulate(l96_params, l96_ys[split - 1],
                                 l96_ts[split - 1:split + 199])
    short = float((pred[1:] - l96_ys[split:split + 199]).abs().mean())
    print(f"train_l96_twin: interpolation L1 {m['interp_l1']:.4f} "
          f"(gate < 0.3), extrapolation L1 over 199 steps {short:.4f} "
          f"(gate < 0.5), over the whole test window {m['extrap_l1']:.4f}")
    check(m["interp_l1"] < 0.3, "L96 twin: interpolation over its gate")
    check(short < 0.5, "L96 twin: short-horizon extrapolation over its gate")
    for phase, steps, sec in phases:
        print(f"[{smi}] trajectory phase {phase}: {steps} gradient steps in "
              f"{sec:.3f} s = {steps / sec:.2f} steps/s")

    # -- 8. K1 and K2 timing at every main-path shape ------------------------------
    # (B, T) of each launch on the main paths: the fleet request (K1 on
    # phase 4; K2 at the same shape for comparison), HP training (9
    # segments of 50), Lorenz96 training at the CI and paper windows (14 and
    # 29 of 60) and P4's 8 segments of 200 (inputs from their own generator,
    # so the earlier phases' data stay as they were)
    gen8 = torch.Generator().manual_seed(SEED + 8)
    params8, y08, u8 = make_case(gen8, (6, 64, 64, 6), 8, 200, "none", dev)
    ws8 = [p["w"] for p in params8]
    bs8 = [p["b"] for p in params8]
    traj8 = fused_ode_mlp.fused_node_rollout(y08, u8, ws8, bs8, 0.0025,
                                             batch_tile=8)
    g8 = torch.randn(traj8.shape, generator=gen8).to(dev)
    k2_inputs["p4_segment_200"] = (traj8, u8, ws8, bs8, g8, 0.0025,
                                   (6, 64, 64, 6), 8, 200)
    timed_shapes = ("fleet_l96", "hp_train_per_twin_drive",
                    "l96_train_ci_autonomous", "l96_train_autonomous",
                    "p4_segment_200")
    k1_times, k2_times = {}, {}
    for case in timed_shapes:
        traj, u, ws, bs, g, dt, sizes, B, T = k2_inputs[case]
        y0 = traj[0].contiguous()
        reps = 20 if B * T < 100_000 else 10
        for kname, times, call, plain, bound_of, backward in (
                ("K1 fused_node_rollout", k1_times,
                 lambda: fused_ode_mlp.fused_node_rollout(
                     y0, u, ws, bs, dt, batch_tile=B),
                 lambda: ref.fused_node_rollout_ref(y0, u, ws, bs, dt),
                 k1_bound, False),
                ("K2 fused_node_rollout_bwd", k2_times,
                 lambda: fused_ode_mlp_bwd.fused_node_rollout_bwd(
                     traj, u, ws, bs, g, dt),
                 None, k2_bound, True)):
            k_ms = cuda_ms(call, reps=reps, warmup=3)
            if plain is None:           # autograd through the plain rollout
                y0r = traj[0].clone().requires_grad_()
                wr = [w.clone().requires_grad_() for w in ws]
                br = [b.clone().requires_grad_() for b in bs]
                out = ref.fused_node_rollout_ref(y0r, u, wr, br, dt)
                p_ms = cuda_ms(lambda: torch.autograd.grad(
                    out, [y0r, *wr, *br], g, retain_graph=True), reps=3,
                    warmup=1)
                del out
            else:
                p_ms = cuda_ms(plain, reps=3, warmup=1)
            b_ms, b_by, gflop, mb = bound_of(sizes, B, T, u)
            geom = fused_ode_mlp.launch_geometry(B, sizes, backward=backward)
            times[case] = dict(B=B, T=T, sizes=list(sizes), ms=k_ms,
                               plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                               us_per_step=1e3 * k_ms / T,
                               blocks=geom.blocks,
                               twins_per_block=geom.twins_per_block,
                               threads=geom.threads)
            print(f"[{smi}] {kname} [{case}] B={B} T={T} sizes={sizes} at "
                  f"{geometry_str(geom)}: kernel_ms {k_ms:.4f} "
                  f"({1e3 * k_ms / T:.3f} us per RK4 step), plain_ms "
                  f"{p_ms:.4f}{' (autograd through fused_node_rollout_ref)' if backward else ''}, "
                  f"bound_ms {b_ms:.4f} ({b_by}: {gflop:.3f} GFLOP, "
                  f"{mb:.3f} MB), library_ms n/a (no single PyTorch call "
                  f"computes {'this VJP' if backward else 'an RK4 rollout'})"
                  + (", launches per call 2 (sweep + reduction)"
                     if backward else ""))

    # -- 9. K3 on the card ---------------------------------------------------------
    shape = (513, 512)
    xbits = torch.randint(0, 2 ** 32, shape, dtype=torch.int64,
                          generator=torch.Generator().manual_seed(SEED)).to(dev)
    check(torch.equal(noise.splitmix32(xbits), ref.splitmix32_ref(xbits)),
          "K3 splitmix32: kernel bits differ from the plain version")
    k3_err = 0.0
    for salt in (FAULT_SALT_BASE + 5, 2 ** 31 + 12345):
        idx = ref.global_cell_index(shape, 7, 3, 1000, device=dev)
        u_k = noise.counter_uniform_at(SEED, salt, idx)
        check(torch.equal(u_k, ref.counter_uniform_at_ref(SEED, salt, idx)),
              f"K3 uniforms at salt {salt:#x} differ from the plain version")
        masks = noise.stuck_cell_masks(SEED, salt, shape, 0.01, 0.5, row0=7,
                                       col0=3, ncols=1000, device=dev)
        want = ref.stuck_cell_masks_ref(SEED, salt, shape, 0.01, 0.5, row0=7,
                                        col0=3, ncols=1000, device=dev)
        check(all(torch.equal(a, b) for a, b in zip(masks, want)),
              f"K3 stuck masks at salt {salt:#x} differ")
        z = noise.counter_normal(SEED, salt, shape, device=dev)
        z_ref = ref.counter_normal_ref(SEED, salt, shape, dev)
        torch.cuda.synchronize()
        err = float((z - z_ref).abs().max())
        k3_err = max(k3_err, err)
        print(f"K3 vs plain [513x512, salt {salt:#x}]: hash bits, uniforms, "
              f"stuck masks ({int(masks[0].sum())} stuck) bitwise equal; "
              f"normals max abs err {err:.3e} (limit {NORMAL_ATOL:g}), "
              f"bitwise equal: {torch.equal(z, z_ref)}")
        check(err <= NORMAL_ATOL, "K3 normals disagree with the plain version")
    # K3's batched masks and write path (their own generator, so the later
    # phases' data stay as they were)
    k3_masks_check(dev)
    k3_write_err = k3_write_check(torch.Generator().manual_seed(SEED + 9), dev)

    # -- 10. K4 vs plain version --------------------------------------------------
    fleet_twin = make_autonomous_twin(6, hidden=64)
    fleet_params = fleet_twin.init(torch.Generator().manual_seed(SEED),
                                   device=dev)
    hp_twin = make_driven_twin(1, None, hidden=14)
    hp_params = hp_twin.init(torch.Generator().manual_seed(SEED), device=dev)
    for p in hp_params:
        p["b"] = (0.1 * torch.randn(p["b"].shape, generator=gen)).to(dev)
    wide4 = make_autonomous_twin(6, hidden=128)
    wide4_params = wide4.init(torch.Generator().manual_seed(SEED), device=dev)
    deep4 = make_autonomous_twin(6, hidden=64, n_hidden_layers=3)
    deep4_params = deep4.init(torch.Generator().manual_seed(SEED), device=dev)
    wide96 = make_autonomous_twin(6, hidden=96)
    wide96_params = wide96.init(torch.Generator().manual_seed(SEED),
                                device=dev)
    p1_noisy = AnalogueSpec(prog_noise=0.0436, read_noise=0.02)
    noisy_faulty = dict(
        spec=AnalogueSpec(prog_noise=0.0, read_noise=0.02), storage="uint8",
        faults=make_fault_model(("stuck", dict(rate=0.01)), "drift",
                                seed=SEED))
    k4_cases = {
        # name: (twin, params, backend kwargs, B, T, drive, dt)
        "fleet_float_clean": (fleet_twin, fleet_params,
                              dict(spec=AnalogueSpec()), 1024, 200, "none",
                              0.0025),
        "fleet_uint8_noise_stuck_drift": (fleet_twin, fleet_params,
                                          noisy_faulty, 1024, 200, "none",
                                          0.0025),
        "hp_per_twin_noise": (hp_twin, hp_params, dict(spec=AnalogueSpec(
            read_noise=0.02)), 64, 500, "per_twin", 1e-3),
        # P1's settings: one twin, the shared drive (Du = 1, twin stride
        # 0), float storage, programming and read noise; the same twin
        # quantised without noise (P1's first rollout); then a fleet that
        # is not a multiple of 4
        "hp_p1_B1_shared_noise": (hp_twin, hp_params, dict(spec=p1_noisy),
                                  1, 500, "shared", 1e-3),
        "hp_p1_B1_shared_clean": (hp_twin, hp_params, dict(
            spec=AnalogueSpec(prog_noise=0.0)), 1, 500, "shared", 1e-3),
        "hp_p1_B100_shared_noise": (hp_twin, hp_params, dict(spec=p1_noisy),
                                    100, 500, "shared", 1e-3),
        # run-time widths (the 6->128 layer split by twin, 128->128 not) at
        # one twin per block and, forced below, at four
        "wide_h128_uint8_noise_stuck_drift": (wide4, wide4_params,
                                              noisy_faulty, 256, 50, "none",
                                              0.0025),
        # run-time widths with hidden-to-hidden layers, clean and noisy, at
        # one and four twins per block: the configuration in which a
        # change to the layout of K1's last-layer epilogue once put K1 off
        # (ROADMAP queue 3); K4's epilogues sit on the same header
        "deep_h64x3_uint8_noise_stuck_drift": (deep4, deep4_params,
                                               noisy_faulty, 256, 50, "none",
                                               0.0025),
        "wide_h96_float_drift": (wide96, wide96_params, dict(
            spec=AnalogueSpec(), faults=make_fault_model("drift", seed=SEED)),
            256, 50, "none", 0.0025),
    }
    k4_errs, k4_inputs = {}, {}
    for case, (tw, prm, kw, B, T, mode, dt) in k4_cases.items():
        staged = FusedAnalogueCudaBackend(prog_seed=SEED, **kw).program(
            tw.node.field, prm).extra
        sigma = kw["spec"].read_noise
        _, y0, u = make_case(gen, tw.field.sizes, B, T, mode, dev)
        got = ops.fused_analogue_rollout(staged, y0, u, dt, batch_tile=B,
                                         read_noise=sigma, noise_seed=SEED)
        again = ops.fused_analogue_rollout(staged, y0, u, dt, batch_tile=B,
                                           read_noise=sigma, noise_seed=SEED)
        want = k4_plain(staged, y0, u, dt, sigma, SEED)
        torch.cuda.synchronize()
        check(got.shape == (T + 1, B, tw.field.sizes[-1]),
              f"K4 {case}: shape {got.shape}")
        check(bool(torch.isfinite(got).all()), f"K4 {case}: non-finite")
        a, r = rel_err(got, want)
        k4_errs[case] = (a, r)
        k4_inputs[case] = (staged, y0, u, dt, sigma, T)
        chosen = fused_analogue.launch_geometry(B, tw.field.sizes, sigma > 0)
        print(f"K4 vs plain [{case}] B={B} T={T} sizes={tw.field.sizes} at "
              f"{geometry_str(chosen)}: max abs err {a:.3e}, of peak {r:.3e} "
              f"(limit {TOL:g}); repeat bitwise identical: "
              f"{torch.equal(got, again)}")
        check(r <= TOL, f"K4 {case}: kernel disagrees with its plain version")
        check(torch.equal(got, again), f"K4 {case}: two calls differ")
        # the same twins at the other tile: a twin's trajectory does not
        # depend on the launch geometry
        forced = fused_analogue.launch_geometry(
            B, tw.field.sizes, sigma > 0, twins_per_block=other_tile(chosen))
        same = torch.equal(k4_at(forced, staged, y0, u, dt, sigma, SEED), got)
        print(f"  K4 [{case}] at {geometry_str(forced)}: bitwise identical: "
              f"{same}")
        check(same, f"K4 {case}: the trajectory depends on the geometry")
    # float64 conductances are handed to the kernel as float32
    staged, y0, u, dt, sigma, T = k4_inputs["hp_p1_B1_shared_noise"]
    f64 = dict(staged, gps=[g.double() for g in staged["gps"]],
               gms=[g.double() for g in staged["gms"]])
    same = torch.equal(
        ops.fused_analogue_rollout(f64, y0, u, dt, read_noise=sigma,
                                   noise_seed=SEED),
        ops.fused_analogue_rollout(staged, y0, u, dt, read_noise=sigma,
                                   noise_seed=SEED))
    print(f"K4 float64 conductances bitwise equal to float32: {same}")
    check(same, "K4: float64 conductances read differently from float32")
    staged, y0, u, dt, sigma, T = k4_inputs["fleet_uint8_noise_stuck_drift"]
    full = ops.fused_analogue_rollout(staged, y0, u, dt, read_noise=sigma,
                                      noise_seed=SEED)
    k = 120
    head = ops.fused_analogue_rollout(staged, y0, u[:2 * k + 1], dt,
                                      read_noise=sigma, noise_seed=SEED)
    tail = ops.fused_analogue_rollout(staged, head[-1], u[2 * k:], dt,
                                      read_noise=sigma, noise_seed=SEED,
                                      step_offset=k)
    resumed = torch.cat([head, tail[1:]])
    torch.cuda.synchronize()
    print(f"K4 split at step {k} and resumed with step_offset={k}: bitwise "
          f"equal to the unsplit rollout: {torch.equal(resumed, full)}")
    check(torch.equal(resumed, full), "K4 split-and-resume differs")
    # the same rollout in time chunks of 64 steps (pre-pass + rollout each)
    sizes4 = [staged["gps"][0].shape[0] - 1] + [g.shape[1]
                                                for g in staged["gps"]]
    chunk_bytes = fused_analogue.NOISE_CHUNK_BYTES
    fused_analogue.NOISE_CHUNK_BYTES = \
        16 * fused_analogue.noise_eval_floats(sizes4) * 64
    try:
        before = (fused_analogue.LAUNCHES, fused_analogue.NOISE_LAUNCHES)
        chunked = ops.fused_analogue_rollout(staged, y0, u, dt,
                                             read_noise=sigma, noise_seed=SEED)
        chunk_launches = (fused_analogue.LAUNCHES - before[0],
                          fused_analogue.NOISE_LAUNCHES - before[1])
    finally:
        fused_analogue.NOISE_CHUNK_BYTES = chunk_bytes
    torch.cuda.synchronize()
    print(f"K4 in time chunks of 64 steps ({chunk_launches[0]} rollout and "
          f"{chunk_launches[1]} pre-pass launches): bitwise equal to one "
          f"chunk: {torch.equal(chunked, full)}")
    check(torch.equal(chunked, full) and chunk_launches == (4, 4),
          "K4 chunked rollout differs")
    # the read-noise pre-pass against its plain version, bitwise: the fleet's
    # uint8 stuck-cell arrays over the whole request, from step 0 and from a
    # step whose salts pass 2^31; P1's float arrays over 20 steps
    pre_cases = [("fleet_uint8_noise_stuck_drift", 0, None),
                 ("fleet_uint8_noise_stuck_drift", 90_000_000, None),
                 ("hp_p1_B100_shared_noise", 7, 20)]
    np_err = 0.0
    for case, offset, steps in pre_cases:
        staged, y0, u, dt, sigma, T = k4_inputs[case]
        steps = steps or T
        kw = noise_pass_kwargs(staged, sigma)
        got = fused_analogue.noisy_pairs(staged["gps"], staged["gms"], steps,
                                         step_offset=offset, **kw)
        want = ref.fused_analogue_noisy_pairs_ref(
            staged["gps"], staged["gms"], steps, step_offset=offset, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a_, b_) for a_, b_ in zip(got, want))
        np_err = max(np_err, *(float((a_ - b_).abs().max())
                               for a_, b_ in zip(got, want)))
        print(f"K4 read-noise pre-pass vs plain [{case}] {steps} steps from "
              f"step {offset}: bitwise equal {same}")
        check(same, f"K4 pre-pass {case} at step {offset} differs from its "
                    f"plain version")

    # -- 11. K7 vs plain version ---------------------------------------------------
    spec = AnalogueSpec()
    stuck7 = dict(stuck_rate=0.01, g_max=spec.g_max, g_min=spec.g_min,
                  fault_seed=SEED, fault_salts=(FAULT_SALT_BASE + 2,
                                                FAULT_SALT_BASE + 3))
    noisy7 = dict(read_noise=0.02, noise_seed=SEED, g_min=spec.g_min)
    k7_cases = {
        "uint8_clean": ("uint8", {}),
        "float_clean": ("float", {}),
        "float_read_noise": ("float", noisy7),
        "uint8_read_noise": ("uint8", noisy7),
        "uint8_stuck_drift": ("uint8", dict(stuck7, drift=0.99)),
        "float_noise_stuck": ("float", dict(noisy7, **stuck7)),
    }

    def k7_arrays(seed, M, K, N):
        g7 = torch.Generator().manual_seed(seed)
        x = torch.randn((M, K), generator=g7).to(dev)
        ip = torch.randint(0, 64, (K, N), generator=g7,
                           dtype=torch.uint8).to(dev)
        im = torch.randint(0, 64, (K, N), generator=g7,
                           dtype=torch.uint8).to(dev)
        fp = (spec.g_min + ip.float() * spec.g_step) * (
            1 + 0.0436 * torch.randn((K, N), generator=g7).to(dev))
        fm = spec.g_min + im.float() * spec.g_step
        return x, ip, im, fp, fm

    k7_errs = {}
    for i, (M, K, N) in enumerate(K7_SHAPES):
        x_, ip_, im_, fp_, fm_ = k7_arrays(SEED + 7 + i, M, K, N)
        if i == 0:
            x7, ip, im, fp, fm = x_, ip_, im_, fp_, fm_
        for case, (storage, kw) in k7_cases.items():
            a_, b_ = (ip_, im_) if storage == "uint8" else (fp_, fm_)
            g_step = spec.g_step if storage == "uint8" else None
            reads0 = crossbar_vmm.READ_LAUNCHES
            got = crossbar_vmm.crossbar_matmul(x_, a_, b_, inv_scale=1.0,
                                               g_step=g_step, **kw)
            again = crossbar_vmm.crossbar_matmul(x_, a_, b_, inv_scale=1.0,
                                                 g_step=g_step, **kw)
            want = ref.crossbar_matmul_ref(x_, a_, b_, inv_scale=1.0,
                                           g_step=g_step, **kw)
            reads = crossbar_vmm.READ_LAUNCHES - reads0
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"K7 {case}: non-finite")
            err = rel_err(got, want)
            if i == 0:
                k7_errs[case] = err
            same = torch.equal(got, again)
            line = (f"K7 vs plain [{case}] M={M} K={K} N={N}: max abs err "
                    f"{err[0]:.3e}, of peak {err[1]:.3e} (limit {TOL:g}); "
                    f"repeat bitwise {same}; read-pass launches {reads}")
            check(err[1] <= TOL,
                  f"K7 {case} {(M, K, N)}: kernel disagrees with its plain "
                  f"version")
            check(same, f"K7 {case} {(M, K, N)}: repeats differ")
            check(reads == 2,
                  f"K7 {case}: {reads} read-pass launches in two calls")
            g_read = crossbar_vmm.effective_g(a_, b_, g_step=g_step, **kw)
            g_want = ref.crossbar_effective_g(a_, b_, g_step=g_step, **kw)
            g_same = torch.equal(g_read, g_want)
            line += f"; read pass bitwise ref.crossbar_effective_g {g_same}"
            check(g_same, f"K7 {case} {(M, K, N)}: the read pass differs "
                          f"from ref.crossbar_effective_g")
            print(line)
    same = torch.equal(
        crossbar_vmm.crossbar_matmul(x7, fp.double(), fm.double(),
                                     inv_scale=1.0, **noisy7),
        crossbar_vmm.crossbar_matmul(x7, fp, fm, inv_scale=1.0, **noisy7))
    print(f"K7 float64 conductances bitwise equal to float32: {same}")
    check(same, "K7: float64 conductances read differently from float32")

    # -- 12. the analogue paths ----------------------------------------------------
    counters = {"K1": (fused_ode_mlp, "LAUNCHES"), "K2": (fused_ode_mlp_bwd,
                                                           "LAUNCHES"),
                "K3": (noise, "LAUNCHES"),
                "K3_masks": (noise, "MASK_LAUNCHES"),
                "K3_write": (noise, "WRITE_LAUNCHES"),
                "K4": (fused_analogue, "LAUNCHES"),
                "K4_noise": (fused_analogue, "NOISE_LAUNCHES"),
                "K1w": (fused_ode_mlp, "WIDE_LAUNCHES"),
                "K4w": (fused_analogue, "WIDE_LAUNCHES"),
                "K7": (crossbar_vmm, "LAUNCHES"),
                "K7_read": (crossbar_vmm, "READ_LAUNCHES")}

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts(path, want):
        torch.cuda.synchronize()
        got = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        print(f"{path}: launches {got}")
        for k, n in want.items():
            check(got[k] == n, f"{path}: expected {n} {k} launches, got "
                               f"{got[k]}")
        return got

    # P1: the HP twin of phase 7, both analogue gates on both backends
    path_counts = {}
    m = recipes.eval_hp_twin(twin, params, "sine", device=dev)
    y0_hp = m["true"][:1]
    clean_spec = AnalogueSpec(prog_noise=0.0)
    noisy_spec = AnalogueSpec(prog_noise=0.0436, read_noise=0.02)
    for substrate in ("analogue_fused_cuda", "analogue"):
        if substrate == "analogue":
            backends = (AnalogueBackend(spec=clean_spec),
                        AnalogueBackend(spec=noisy_spec, prog_seed=0,
                                        read_seed=1))
        else:
            backends = (FusedAnalogueCudaBackend(spec=clean_spec),
                        FusedAnalogueCudaBackend(spec=noisy_spec, prog_seed=0,
                                                 read_seed=1))
        zero_counts()
        secs = []
        with torch.no_grad():
            for be in backends:
                t_p = time.perf_counter()
                out = twin.with_backend(be).simulate(params, y0_hp, m["ts"])
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t_p)
                if be is backends[0]:
                    quant = out[:, 0]
                else:
                    noisy = out[:, 0]
        fused = substrate == "analogue_fused_cuda"
        counts = read_counts(f"P1 {substrate}", {
            "K4": 2 if fused else 0, "K4_noise": 1 if fused else 0, "K1": 0,
            "K7": 0})
        path_counts[f"P1_{substrate}"] = counts
        q_mre = float(mre(quant, m["pred"]))
        n_mre = float(mre(noisy, m["true"]))
        print(f"P1 {substrate}: quantisation-only MRE vs digital "
              f"{q_mre:.4f} (gate < 0.08); prog 0.0436 + read 0.02 MRE vs "
              f"truth {n_mre:.4f} (gate < 0.3); rollouts of "
              f"{m['ts'].shape[0] - 1} steps in {secs[0]:.3f} s "
              f"(quantisation only) and {secs[1]:.3f} s (programming and "
              f"read noise), deployment included in each")
        check(q_mre < 0.08, f"P1 {substrate}: quantisation gate")
        check(n_mre < 0.3, f"P1 {substrate}: noise gate")

    # P2: the Lorenz96 fleet served on K4
    cfg = recipes.FLEET
    ts = recipes.l96_fleet_ts()

    def serve(backend, ckpt):
        fleet_b = recipes.make_l96_fleet(backend=backend)
        reqs = recipes.l96_fleet_requests(num_batches=n_batches, seed=SEED,
                                          device=dev)
        outs, secs = [], []
        stream = serve_fleet(ckpt, fleet_b, ts, reqs, device=dev)
        while True:
            t_b = time.perf_counter()
            out = next(stream, None)
            torch.cuda.synchronize()
            if out is None:
                return outs, secs
            secs.append(time.perf_counter() - t_b)
            outs.append(out)

    p2 = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        fleet0 = recipes.make_l96_fleet()
        checkpoint.save_twin(ckpt, fleet0.twin.init(
            torch.Generator().manual_seed(SEED), device="cpu"))
        clean_be = FusedAnalogueCudaBackend(
            spec=AnalogueSpec(prog_noise=0.0, quantize=False),
            batch_tile=cfg.batch_tile)
        faulty_be = FusedAnalogueCudaBackend(batch_tile=cfg.batch_tile,
                                             prog_seed=SEED, read_seed=SEED,
                                             **noisy_faulty)
        zero_counts()
        outs, secs = serve(clean_be, ckpt)
        path_counts["P2_serve_clean"] = read_counts(
            "P2 serve_fleet analogue_fused_cuda (clean)",
            {"K4": n_batches, "K4_noise": 0, "K1": 0, "K7": 0})
        digital, _ = serve(FusedCudaBackend(batch_tile=cfg.batch_tile), ckpt)
        for i, (o, d, sec) in enumerate(zip(outs, digital, secs)):
            check(tuple(o.shape) == (cfg.fleet_size, cfg.horizon + 1,
                                     cfg.state_dim), f"P2 batch {i} shape")
            a, r = rel_err(o, d)
            print(f"[{smi}] P2 clean batch {i}: {tuple(o.shape)} in "
                  f"{sec * 1e3:.3f} ms ({cfg.fleet_size * cfg.horizon / sec:,.0f}"
                  f" twin-steps/s); vs fused_cuda (K1) max abs err {a:.3e}, "
                  f"of peak {r:.3e} (limit {TOL:g})")
            check(r <= TOL, f"P2 batch {i}: analogue_fused_cuda (clean, "
                            f"unquantised) disagrees with fused_cuda")
        p2["clean"] = secs
        zero_counts()
        serves = [serve(faulty_be, ckpt) for _ in range(2)]
        path_counts["P2_serve_noisy_faulty_x2"] = read_counts(
            "P2 serve_fleet analogue_fused_cuda (uint8, read noise 0.02, 1% "
            "stuck, drift), served twice", {"K4": 2 * n_batches,
                                            "K4_noise": 2 * n_batches,
                                            "K1": 0, "K7": 0})
        p2_k3 = path_counts["P2_serve_noisy_faulty_x2"]
        check(p2_k3["K3_masks"] == 2 * n_batches and p2_k3["K3"] == 0,
              "P2: expected one K3 launch (the batched stuck masks) per "
              "programming")
        for i, (a_, b_) in enumerate(zip(serves[0][0], serves[1][0])):
            check(bool(torch.isfinite(a_).all()), f"P2 noisy batch {i}")
            same = torch.equal(a_, b_)
            sec = serves[0][1][i]
            print(f"[{smi}] P2 noisy faulty batch {i}: {sec * 1e3:.3f} ms "
                  f"({cfg.fleet_size * cfg.horizon / sec:,.0f} twin-steps/s, "
                  f"programming included); two serves bitwise equal: {same}")
            check(same, f"P2 noisy batch {i}: two serves differ")
        p2["noisy"] = serves[0][1] + serves[1][1]

    # P3: the scorecard width on the unfused simulator, K7 per evaluation
    wide = make_autonomous_twin(6, hidden=512)
    wide_params = wide.init(torch.Generator().manual_seed(SEED), device=dev)
    wide_fleet = TwinFleet(wide.with_backend(AnalogueBackend(
        spec=AnalogueSpec(prog_noise=0.0), storage="uint8", prog_seed=SEED)))
    y0_wide = (0.5 * torch.randn((1024, 6), generator=gen)).to(dev)
    ts_wide = torch.linspace(0.0, 50 * cfg.dt, 51)
    zero_counts()
    t_p = time.perf_counter()
    with torch.no_grad():
        p3 = wide_fleet.rollout_batch(wide_params, y0_wide, ts_wide)
    path_counts["P3_analogue_scorecard_width"] = read_counts(
        "P3 AnalogueBackend(uint8) 6->512->512->6, 1024 twins x 50 steps",
        {"K7": 200, "K7_read": 200, "K4": 0, "K4_noise": 0, "K1": 0})
    p3_sec = time.perf_counter() - t_p
    real_k7 = crossbar_vmm.crossbar_matmul
    crossbar_vmm.crossbar_matmul = (
        lambda x, gp, gm, **kw: ref.crossbar_matmul_ref(x, gp, gm, **kw))
    try:
        with torch.no_grad():
            p3_plain = wide_fleet.rollout_batch(wide_params, y0_wide, ts_wide)
        torch.cuda.synchronize()
    finally:
        crossbar_vmm.crossbar_matmul = real_k7
    check(bool(torch.isfinite(p3).all()) and tuple(p3.shape) == (1024, 51, 6),
          f"P3: {tuple(p3.shape)} non-finite or misshapen")
    p3_err = rel_err(p3, p3_plain)
    print(f"[{smi}] P3: {tuple(p3.shape)} in {p3_sec:.3f} s; vs the same path "
          f"on K7's plain version max abs err {p3_err[0]:.3e}, of peak "
          f"{p3_err[1]:.3e} (limit {TOL:g})")
    check(p3_err[1] <= TOL, "P3 disagrees with its plain path")

    # P6: hardware-aware training of the HP twin (K3's write path, K1, K2)
    zero_counts()
    p6 = p6_hw_aware(dev, smi, twin, params, zero_counts, read_counts)
    path_counts.update(p6["counts"])

    # -- 13. K3, K4 and K7 timing -----------------------------------------------------
    # K4 at the fleet request (P2) and at P1's HP shapes; a noisy rollout is
    # a pre-pass and a rollout launch, both inside kernel_ms, the pre-pass
    # also alone
    k4_times = {}
    for case in ("fleet_float_clean", "fleet_uint8_noise_stuck_drift",
                 "hp_p1_B1_shared_clean", "hp_p1_B1_shared_noise",
                 "hp_p1_B100_shared_noise"):
        staged, y0, u, dt, sigma, T = k4_inputs[case]
        B = y0.shape[0]
        k_ms = cuda_ms(lambda: ops.fused_analogue_rollout(
            staged, y0, u, dt, batch_tile=B, read_noise=sigma,
            noise_seed=SEED), reps=10)
        p_ms = cuda_ms(lambda: k4_plain(staged, y0, u, dt, sigma, SEED),
                       reps=2, warmup=1)
        flops, moved = k4_work(staged, y0, u, T, sigma > 0)
        b_ms, b_by = bound(flops, moved)
        row = dict(B=B, T=T, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                   bound_by=b_by)
        sizes4 = [staged["gps"][0].shape[0] - 1] + [g.shape[1]
                                                    for g in staged["gps"]]
        geom = fused_analogue.launch_geometry(B, sizes4, sigma > 0)
        extra = ""
        if sigma > 0:
            kw = noise_pass_kwargs(staged, sigma)
            row["noise_pass_ms"] = cuda_ms(lambda: fused_analogue.noisy_pairs(
                staged["gps"], staged["gms"], T, **kw), reps=10,
                queue_ahead=True)
            extra = f" (the pre-pass alone {row['noise_pass_ms']:.4f})"
        k4_times[case] = row
        print(f"[{smi}] K4 fused_analogue_rollout [{case}] B={B} T={T} "
              f"sizes={tuple(sizes4)} at {geometry_str(geom)}: kernel_ms "
              f"{k_ms:.4f}{extra}, plain_ms {p_ms:.4f}, bound_ms {b_ms:.6f} "
              f"({b_by}: {flops / 1e9:.3f} GFLOP, {moved / 1e6:.3f} MB), "
              f"launches per rollout "
              f"{'2 (pre-pass + rollout)' if sigma > 0 else '1'}, "
              f"library_ms n/a (no single PyTorch call computes the "
              f"rollout)")
    # the pre-pass alone at the fleet request, against its plain version
    staged, y0, u, dt, sigma, T = k4_inputs["fleet_uint8_noise_stuck_drift"]
    kw = noise_pass_kwargs(staged, sigma)
    np_flops, np_moved = noise_pass_work(staged, T)
    np_bound, np_by = bound(np_flops, np_moved)
    np_plain = cuda_ms(lambda: ref.fused_analogue_noisy_pairs_ref(
        staged["gps"], staged["gms"], T, **kw), reps=1, warmup=1)
    np_row = dict(ms=k4_times["fleet_uint8_noise_stuck_drift"]["noise_pass_ms"],
                  plain_ms=np_plain, bound_ms=np_bound, bound_by=np_by)
    print(f"[{smi}] K4 read-noise pre-pass [fleet_uint8_noise_stuck_drift] "
          f"T={T}: kernel_ms {np_row['ms']:.4f}, plain_ms {np_plain:.4f}, "
          f"bound_ms {np_bound:.5f} ({np_by}: {np_flops / 1e9:.3f} GFLOP, "
          f"{np_moved / 1e6:.3f} MB), library_ms n/a")
    M, K, N = K7_SHAPES[0]
    k7_args = dict(inv_scale=1.0, g_step=spec.g_step)
    k7_call = functools.partial(crossbar_vmm.crossbar_matmul, x7, ip, im,
                                **k7_args)
    k7_ms = cuda_ms(k7_call, reps=50, queue_ahead=True)
    k7_wall_ms = cuda_ms(k7_call, reps=50)
    k7_plain_ms = cuda_ms(lambda: ref.crossbar_matmul_ref(x7, ip, im,
                                                          **k7_args),
                          reps=20, queue_ahead=True)
    w7 = (ip.float() - im.float()) * spec.g_step
    k7_lib_ms = cuda_ms(lambda: torch.matmul(x7, w7), reps=50,
                        queue_ahead=True)
    k7_moved = tensor_bytes(x7, ip, im) + 4 * M * N
    k7_bound, k7_by, k7_gflop = k7_work(M, K, N, False, k7_moved)
    k7rc_ms = cuda_ms(lambda: crossbar_vmm.effective_g(
        ip, im, g_step=spec.g_step), reps=50, queue_ahead=True)
    print(f"[{smi}] K7 crossbar_matmul [uint8_clean] M={M} K={K} N={N}: "
          f"kernel_ms {k7_ms:.4f} (read pass + GEMM; the read pass alone "
          f"{k7rc_ms:.4f}; per call with the wrapper {k7_wall_ms:.4f}), "
          f"plain_ms {k7_plain_ms:.4f}, bound_ms {k7_bound:.4f} ({k7_by}: "
          f"{k7_gflop:.3f} GFLOP of 3xTF32 products), library_ms "
          f"{k7_lib_ms:.4f} (torch.matmul on the pre-combined f32 pair, "
          f"TF32 off), launches per evaluation 1 GEMM + 1 read pass (P3)")
    k7n_args = dict(k7_args, **noisy7)
    k7n_ms = cuda_ms(lambda: crossbar_vmm.crossbar_matmul(x7, ip, im,
                                                          **k7n_args),
                     reps=50, queue_ahead=True)
    k7n_bound, k7n_by, _ = k7_work(M, K, N, True, k7_moved)
    k7r_ms = cuda_ms(lambda: crossbar_vmm.effective_g(
        ip, im, g_step=spec.g_step, **noisy7), reps=50, queue_ahead=True)
    print(f"[{smi}] K7 crossbar_matmul [uint8_read_noise] M={M} K={K} N={N}: "
          f"kernel_ms {k7n_ms:.4f} (read pass + GEMM; the read pass alone "
          f"{k7r_ms:.4f}), bound_ms {k7n_bound:.4f} ({k7n_by})")
    n3 = shape[0] * shape[1]
    k3_call = functools.partial(noise.counter_normal, SEED, 5, shape,
                                device=dev)
    k3_ms = cuda_ms(k3_call, reps=50, queue_ahead=True)
    k3_wall_ms = cuda_ms(k3_call, reps=50)
    k3_plain_ms = cuda_ms(lambda: ref.counter_normal_ref(SEED, 5, shape, dev),
                          reps=10, queue_ahead=True)
    k3_bound, k3_by = bound(n3 * OPS_PER_NORMAL, 4 * n3)
    k3_host_ms = host_ms(k3_call)
    print(f"[{smi}] K3 counter_normal fill 513x512: kernel_ms {k3_ms:.4f} "
          f"(per call with the wrapper {k3_wall_ms:.4f}; the wrapper's host "
          f"time per call {k3_host_ms:.4f}), plain_ms "
          f"{k3_plain_ms:.4f}, bound_ms {k3_bound:.5f} ({k3_by}), "
          f"library_ms n/a")
    k3_rows = k3_times(dev, smi, p6["step_ms"])

    # -- 14. K5 and K6 vs plain versions ---------------------------------------
    sdtw_errs, sdtw_equal = sdtw_check(gen, dev)
    # the autograd Function (K5 forward, K6 backward) against autograd
    # through the reference DP
    gx = torch.Generator().manual_seed(SEED + 14)
    xs = torch.randn((2, 40, 2), generator=gx).to(dev)
    ys = torch.randn((2, 60, 2), generator=gx).to(dev)
    grads = []
    for loss_of in (lambda a, b: ops.soft_dtw(a, b, 0.5),
                    lambda a, b: soft_dtw_batch(a, b, 0.5)):
        a, b = xs.clone().requires_grad_(), ys.clone().requires_grad_()
        val = loss_of(a, b)
        val.sum().backward()
        grads.append((val.detach(), a.grad, b.grad))
    torch.cuda.synchronize()
    # two algorithms (the closed-form E-matrix, autodiff through the
    # logsumexp DP): float32 rounding apart, each of the peak
    g_errs = [rel_err(u, v) for u, v in zip(grads[0], grads[1])]
    print(f"ops.soft_dtw (K5 + K6) vs autograd through losses.soft_dtw_batch "
          f"(2, 40, 60, d=2) gamma 0.5: value {g_errs[0][1]:.3e}, dx "
          f"{g_errs[1][1]:.3e}, dy {g_errs[2][1]:.3e} of the peak (limit "
          f"{TOL:g})")
    check(all(r <= TOL for _, r in g_errs),
          "ops.soft_dtw disagrees with autograd through the reference DP")

    # -- 15. the soft-DTW training path P4 ----------------------------------------
    sdtw_mods = {"K1": fused_ode_mlp, "K2": fused_ode_mlp_bwd, "K5": softdtw}

    def zero_p4():
        for mod in sdtw_mods.values():
            mod.LAUNCHES = 0
        softdtw.BWD_LAUNCHES = 0

    def read_p4(path, want):
        torch.cuda.synchronize()
        got = {k: mod.LAUNCHES for k, mod in sdtw_mods.items()}
        got["K6"] = softdtw.BWD_LAUNCHES
        print(f"{path}: launches {got}")
        for k, n_ in want.items():
            check(got[k] == n_, f"{path}: expected {n_} {k} launches, got "
                                f"{got[k]}")
        return got

    data96 = recipes.l96_data(num_points=L96_CONFIG.num_points, device=dev)
    ts96, ys96, split96 = data96
    ts_tr, ys_tr = ts96[:split96], ys96[:split96]
    p4_steps = 40
    p4, p4_params = {}, l96_params
    for seg in (60, 200):
        zero_p4()
        torch.cuda.synchronize()
        t_p = time.perf_counter()
        p4_params, hist = trainer.train_twin(
            l96_twin, p4_params, ts_tr, ys_tr, optimizer=adam(4e-4),
            num_steps=p4_steps, segment_len=seg, loss=L96_CONFIG.loss,
            gamma=0.1, noise_std=L96_CONFIG.noise_regulariser,
            generator=torch.Generator().manual_seed(SEED + seg),
            backend="fused_cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t_p
        segs = (split96 - 1) // seg
        counts = read_p4(f"P4 train_twin(loss={L96_CONFIG.loss!r}, gamma=0.1,"
                         f" fused_cuda) {segs} segments of {seg}",
                         {k: p4_steps for k in ("K1", "K2", "K5", "K6")})
        check(bool(torch.isfinite(hist).all()), f"P4 seg {seg}: non-finite")
        p4[seg] = (counts, sec, hist)
        print(f"[{smi}] P4 segment length {seg} (S={segs}): {p4_steps} steps "
              f"in {sec:.3f} s = {p4_steps / sec:.2f} steps/s "
              f"({sec / p4_steps * 1e3:.3f} ms/step); loss "
              f"{float(hist[0]):.6f} -> {float(hist[-1]):.6f}")
    m4 = recipes.eval_l96_twin(l96_twin, p4_params, data=data96)
    with torch.no_grad():
        pred = l96_twin.simulate(p4_params, ys96[split96 - 1],
                                 ts96[split96 - 1:split96 + 199])
    short4 = float((pred[1:] - ys96[split96:split96 + 199]).abs().mean())
    print(f"P4 after both phases: interpolation L1 {m4['interp_l1']:.4f}, "
          f"extrapolation L1 over 199 steps {short4:.4f}, over the whole "
          f"test window {m4['extrap_l1']:.4f} (printed, not gated)")
    hist4, cmp_steps = {}, 10
    for substrate, be in (("fused_cuda", "fused_cuda"), ("digital", None)):
        zero_p4()
        _, hist4[substrate] = trainer.train_twin(
            l96_twin, l96_params, ts_tr, ys_tr, optimizer=adam(4e-4),
            num_steps=cmp_steps, segment_len=60, loss=L96_CONFIG.loss,
            gamma=0.1,
            noise_std=L96_CONFIG.noise_regulariser,
            generator=torch.Generator().manual_seed(SEED + 4), backend=be)
        want = ({k: cmp_steps for k in ("K1", "K2", "K5", "K6")}
                if substrate == "fused_cuda" else {"K5": 0, "K6": 0})
        got4 = read_p4(f"P4 {cmp_steps} steps on {substrate}", want)
        if substrate == "fused_cuda":
            p4_cmp = got4
    hist4_rel = float(((hist4["fused_cuda"] - hist4["digital"]).abs()
                       / hist4["digital"].abs()).max())
    print(f"P4 {cmp_steps} steps, fused_cuda vs digital: loss "
          f"{float(hist4['fused_cuda'][0]):.6f} -> "
          f"{float(hist4['fused_cuda'][-1]):.6f}, max rel diff "
          f"{hist4_rel:.3e} (limit {HIST_TOL:g})")
    check(hist4_rel <= HIST_TOL, "P4 fused vs digital loss histories differ")
    t_l = time.perf_counter()
    lyap = recipes.l96_lyapunov_info()
    print(f"l96_lyapunov_info() on {dev}: MLE {lyap['mle']:.6f}, Lyapunov "
          f"time {lyap['lyapunov_time']:.6f} in "
          f"{time.perf_counter() - t_l:.3f} s")
    check(lyap["mle"] > 0, "L96 maximal Lyapunov exponent not positive")

    # -- 16. K5 and K6 timing --------------------------------------------------------
    chain = sdtw_chain(chain_lib, chain_proc, dev)
    for kname in ("K5", "K6"):
        c = chain[kname]
        print(f"[{smi}] {kname} chain: {c['ms_per_step'] * 1e6:.2f} ns = "
              f"{c['cycles_per_step']:.1f} SM cycles at {SM_CLOCK / 1e9:g} "
              f"GHz a dependent step on one warp (chain probe, "
              f"{SDTW_CHAIN_STEPS} "
              f"steps, CUDA events); SASS a step of the probe's loop: "
              + ", ".join(f"{op} {k:g}"
                          for op, k in sorted(c["sass_per_step"].items())))
    sdtw_timed = sdtw_times(gen, dev, smi, chain)
    for (B, n, m), seg in (((29, 61, 61), 60), ((8, 201, 201), 200)):
        rows = sdtw_timed[B, n, m]
        # the whole soft-DTW term of a step, forward and backward, on
        # predictions and targets of the P4 shape: host clock around 20
        # calls ended by a device sync, and the device kernels of one call
        # in a profiler trace of 5 (the pairwise cost and its backward, K5,
        # K6, the scaling); beside them an estimate of the first port's
        # count: this term's plus the kernels of the layout glue it ran
        # around the same kernels (the diagonal layout of D and the gather
        # of E, traced alone), which this port no longer runs.  The first
        # port's term itself is measured by launch/kernel_timing.py on its
        # tree.
        preds = torch.randn((B, n, 6), generator=gen).to(dev)
        targets = torch.randn((B, n, 6), generator=gen).to(dev)
        leaf = preds.clone().requires_grad_()

        def sdtw_term():
            torch.mean(ops.soft_dtw(leaf, targets, 0.1)).backward()

        def glue():
            D = _pairwise_dist(preds, targets)
            ref.undiag_layout(ref.diag_layout(D).contiguous(), n, m)

        sdtw_term()
        glue()
        torch.cuda.synchronize()
        t_t = time.perf_counter()
        for _ in range(20):
            sdtw_term()
        torch.cuda.synchronize()
        term_ms = (time.perf_counter() - t_t) / 20 * 1e3
        counts = {}
        for name, fn in (("term", sdtw_term), ("glue", glue)):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof_t:
                time.sleep(PROFILER_GUARD_S)
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                time.sleep(PROFILER_GUARD_S)
            counts[name] = sum(
                1 for ev in prof_t.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA) / 5
        # the glue's pairwise cost is not part of the parent's extra work
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof_c:
            time.sleep(PROFILER_GUARD_S)
            for _ in range(5):
                _pairwise_dist(preds, targets)
            torch.cuda.synchronize()
            time.sleep(PROFILER_GUARD_S)
        cost_kernels = sum(
            1 for ev in prof_c.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA) / 5
        glue_estimate = counts["term"] + counts["glue"] - cost_kernels
        step_ms = p4[seg][1] / p4_steps * 1e3
        k56 = rows["K5"]["ms"] + rows["K6"]["ms"]
        print(f"[{smi}] P4 segment length {seg}: K5 + K6 {k56:.4f} ms of a "
              f"{step_ms:.3f} ms step ({100 * k56 / step_ms:.2f}%); the "
              f"soft-DTW term (cost, K5, K6, backward to the predictions) "
              f"{term_ms:.4f} ms per call, host clock, {counts['term']:g} "
              f"device kernels per call (profiler); estimate with the "
              f"first port's layout and gather around the same kernels: "
              f"{glue_estimate:g}")
        check(counts["term"] < glue_estimate,
              "the soft-DTW term launches no fewer kernels than with the "
              "layout glue")
        rows["K5"]["term_ms"] = term_ms
        rows["K5"]["term_kernels"] = counts["term"]
        rows["K5"]["term_kernels_glue_estimate"] = glue_estimate

    # where a P4 step's time goes: a torch.profiler trace of 5 steps at
    # segment length 60 (the trace's own host cost slows the steps)
    trace_steps = 5
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_p = time.perf_counter()
        trainer.train_twin(
            l96_twin, l96_params, ts_tr, ys_tr, optimizer=adam(4e-4),
            num_steps=trace_steps, segment_len=60, loss=L96_CONFIG.loss,
            gamma=0.1, noise_std=L96_CONFIG.noise_regulariser,
            generator=torch.Generator().manual_seed(SEED), backend="fused_cuda")
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t_p) * 1e3
    # device-side events only: an operator's own entry repeats the time
    # of the kernels it launched
    kernels_us = {ev.key: ev.self_device_time_total
                  for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and ev.self_device_time_total > 0}
    busy_ms = sum(kernels_us.values()) / 1e3
    if busy_ms > 0:
        top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:6]
        print(f"[{smi}] P4 trace, {trace_steps} steps at segment length 60: "
              f"wall {traced_ms:.3f} ms, device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / traced_ms:.1f}%; idle "
              f"{100 * (1 - busy_ms / traced_ms):.1f}%); per step by "
              f"device time: " + "; ".join(
                  f"{k[:48]} {v / 1e3 / trace_steps:.4f} ms" for k, v in top))
    else:
        print("P4 trace: the profiler recorded no device time (device idle "
              "share not measured)")

    # -- 17-19. the LM serving slice: K8, K9 and P5 (Jamba at full width) ------
    lm_entries = lm_slice(dev, smi, hmma["flash_attention"], sass["ssm_scan"])

    # -- 20. P7: streaming serving (K1, K4, K3) ---------------------------------
    p7, p7_refs = p7_streaming(dev, smi, noisy_faulty, zero_counts,
                               read_counts)
    path_counts.update(p7)

    # -- 21. P8: crash recovery (K1, K4, K3) ------------------------------------
    p8 = p8_recovery(dev, smi, noisy_faulty, zero_counts, read_counts,
                     p7_refs)
    path_counts.update(p8)

    # -- 22. P9: the training engines (K1, K2, K3 write path, K5, K6) --------
    p9 = p9_engines(dev, smi, l96_twin, l96_params, data, data96)

    def p9_paths_of(key):
        return {p: c[key] for p, c in p9["counts"].items() if c[key]}

    # -- 23. P10: the paper's energy scorecard (K1w, K4w, K1, K4) -------------
    p10 = p10_scorecard(dev, smi, wide_params, y0_wide, ts_wide, p3,
                        zero_counts, read_counts)
    path_counts.update(p10["counts"])

    # -- 24. P11: dopri5 (K7) and the paper's baselines (the engines) ---------
    p11 = p11_paths(dev, smi, twin, params, l96_twin, l96_params, data,
                    wide_params, y0_wide, ts_wide, p3, zero_counts,
                    read_counts)
    path_counts.update(p11["counts"])

    # -- 25. P12: the bf16 policies (K1, K2, K5, K6 on the reduced substrate) --
    p12 = p12_bf16(dev, smi, hp_f32, l96_twin, l96_params, ts_tr, ys_tr)

    # -- 26. P13: the twin mesh (K1, K3 and K4 per shard) ---------------------
    p13 = p13_mesh(torch.device("cuda", torch.cuda.current_device()), smi,
                   noisy_faulty)
    path_counts.update({p: {k: c.get(k, 0) for k in counters}
                        for p, c in p13["counts"].items()})

    # -- 27. P14: DeepSeek-V2-Lite at full width (MLA through K8) -----------
    p14 = p14_deepseek(dev, smi)
    k8_row = lm_entries[0]
    k8_row["launches"] += sum(p14["counts"].values())
    k8_row["launches_by_path"].update(
        {p: c for p, c in p14["counts"].items() if c})
    k8_row["pairs"] = "(16,16) (32,32) (64,64) (128,128) (48,32) (576,512)"
    k8_row["mla"] = p14["pairs"]

    # -- 28. P15: continuous depth (K8), xLSTM and the torch examples --------
    p15 = p15_continuous_depth(dev, smi)
    k8_row["launches"] += sum(p15["counts"].values())
    k8_row["launches_by_path"].update(
        {p: c for p, c in p15["counts"].items() if c})
    k8_row["ode_depth_P15"] = {k: p15[k] for k in ("llama", "seconds")}

    k1_paths = {"serve_fleet": launches, "train_hp_twin": hp_counts[0],
                "hp_40_steps_fused_cuda": hp40_counts["fused_cuda"][0],
                "train_l96_twin": l96_counts[0],
                **{f"P4_segment_{seg}": c[0]["K1"] for seg, c in p4.items()},
                "P4_10_steps_fused_cuda": p4_cmp["K1"],
                **{p: c["K1"] for p, c in p6["counts"].items()},
                **{p: c["K1"] for p, c in p7.items() if c["K1"]},
                **{p: c["K1"] for p, c in p8.items() if c["K1"]},
                **p9_paths_of("K1"),
                "P10_scorecard": p10["counts"]["P10_scorecard"]["K1"],
                **{p: c["K1"] for p, c in p13["counts"].items() if c["K1"]}}
    k2_paths = {"train_hp_twin": hp_counts[1],
                **{p: c["K2"] for p, c in p6["counts"].items()},
                "hp_40_steps_fused_cuda": hp40_counts["fused_cuda"][1],
                "train_l96_twin": l96_counts[1],
                **{f"P4_segment_{seg}": c[0]["K2"] for seg, c in p4.items()},
                "P4_10_steps_fused_cuda": p4_cmp["K2"],
                **p9_paths_of("K2")}

    def ffma_lds(src):
        return {fn: {k: c[k] for k in ("FFMA", "LDS", "dense")}
                for fn, c in sass[src].items()}

    def by_path(key):
        return {p: c[key] for p, c in path_counts.items() if c[key]}

    k2_row = k2_times["l96_train_autonomous"]
    k2_fleet = k2_times["fleet_l96"]
    c4 = k4_times["fleet_float_clean"]
    n4 = k4_times["fleet_uint8_noise_stuck_drift"]
    record = {"kernels": [{
        "name": "fused_node_rollout",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_ode_mlp.cu",
        "replaces": "src/repro/kernels/fused_ode_mlp.py:390",
        "launches": sum(k1_paths.values()),
        "launches_by_path": k1_paths,
        "max_abs_err": errs["l96_autonomous"][0],
        "max_rel_err_of_peak": errs["l96_autonomous"][1],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shapes": k1_times,
        "sass": ffma_lds("fused_ode_mlp"),
        "training_engines": p9["paths"],
    }, {
        "name": "fused_node_rollout_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_ode_mlp_bwd.cu",
        "replaces": "src/repro/kernels/fused_ode_mlp_bwd.py:210",
        "launches": sum(k2_paths.values()),
        "launches_by_path": k2_paths,
        "shape": "l96_train_autonomous B=29 T=60 6-64-64-6",
        "max_abs_err": k2_errs["l96_train_autonomous"][0],
        "max_rel_err_of_peak": k2_errs["l96_train_autonomous"][1],
        "ms": k2_row["ms"],
        "plain_ms": k2_row["plain_ms"],
        "bound_ms": k2_row["bound_ms"],
        "bound_by": k2_row["bound_by"],
        "library_ms": None,
        "fleet_shape": {"B": 1024, "T": 200, "ms": k2_fleet["ms"],
                        "plain_ms": k2_fleet["plain_ms"],
                        "bound_ms": k2_fleet["bound_ms"],
                        "bound_by": k2_fleet["bound_by"],
                        "max_rel_err_of_peak": k2_errs["fleet_l96"][1]},
        "shapes": k2_times,
        "sass": ffma_lds("fused_ode_mlp_bwd"),
    }, {
        "name": "counter_noise",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/counter_noise.cu",
        "replaces": "src/repro/kernels/noise.py:46",
        "launches": sum(by_path("K3").values()),
        "launches_by_path": by_path("K3"),
        "in_kernel_of": ["fused_analogue_rollout", "crossbar_matmul"],
        "shape": "counter_normal fill 513x512",
        "max_abs_err": k3_err,
        "ms": k3_ms,
        "call_ms": k3_wall_ms,
        "host_ms": k3_host_ms,
        "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound,
        "bound_by": k3_by,
        "library_ms": None,
    }, {
        "name": "counter_noise_stuck_masks",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/counter_noise.cu",
        "replaces": "src/repro/kernels/noise.py:80",
        "launches": sum(by_path("K3_masks").values()),
        "launches_by_path": by_path("K3_masks"),
        "shape": "P2's programming: 6 arrays (7x64, 65x64, 65x6, G+ and G-)",
        "max_abs_err": 0.0,
        **k3_rows["masks"],
        "library_ms": None,
    }, {
        "name": "counter_noise_hw_write_path",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/counter_noise.cu",
        "replaces": "src/repro/kernels/noise.py:100",
        "launches": sum(by_path("K3_write").values())
        + sum(p9_paths_of("K3_write").values()),
        "launches_by_path": {**by_path("K3_write"),
                             **p9_paths_of("K3_write")},
        "step": "an int, or the training engines' int32 counter read from "
                "device memory (step_ptr), so a replayed CUDA graph of the "
                "step draws at each replay's step",
        "shape": "HP step: 2-14-14-1, k_draws 2",
        "max_abs_err": k3_write_err[0],
        "max_rel_err_of_peak": k3_write_err[1],
        **k3_rows["write_hp"],
        "l96_step_shape": k3_rows["write_l96"],
        "library_ms": None,
    }, {
        "name": "fused_analogue_rollout",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_analogue.cu",
        "replaces": "src/repro/kernels/fused_analogue.py:208",
        "launches": sum(by_path("K4").values()),
        "launches_by_path": by_path("K4"),
        "shape": "fleet_float_clean B=1024 T=200 6-64-64-6",
        "max_abs_err": k4_errs["fleet_float_clean"][0],
        "max_rel_err_of_peak": k4_errs["fleet_float_clean"][1],
        "ms": c4["ms"],
        "plain_ms": c4["plain_ms"],
        "bound_ms": c4["bound_ms"],
        "bound_by": c4["bound_by"],
        "library_ms": None,
        "noise_launches": sum(by_path("K4_noise").values()),
        "noisy_shape": {"case": "fleet_uint8_noise_stuck_drift",
                        "ms": n4["ms"], "plain_ms": n4["plain_ms"],
                        "bound_ms": n4["bound_ms"],
                        "bound_by": n4["bound_by"],
                        "max_rel_err_of_peak":
                            k4_errs["fleet_uint8_noise_stuck_drift"][1]},
        "shapes": k4_times,
        "sass": ffma_lds("fused_analogue"),
    }, {
        "name": "fused_analogue_noise_pass",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_analogue.cu",
        "replaces": "src/repro/kernels/fused_analogue.py:208",
        "launches": sum(by_path("K4_noise").values()),
        "launches_by_path": by_path("K4_noise"),
        "shape": "fleet_uint8_noise_stuck_drift T=200 6-64-64-6",
        "max_abs_err": np_err,
        "ms": np_row["ms"],
        "plain_ms": np_row["plain_ms"],
        "bound_ms": np_row["bound_ms"],
        "bound_by": np_row["bound_by"],
        "library_ms": None,
    }, {
        "name": "crossbar_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/crossbar_vmm.cu",
        "replaces": "src/repro/kernels/crossbar_vmm.py:147",
        "launches": sum(by_path("K7").values()),
        "launches_by_path": by_path("K7"),
        "shape": "uint8_clean M=1024 K=513 N=512",
        "max_abs_err": k7_errs["uint8_clean"][0],
        "max_rel_err_of_peak": k7_errs["uint8_clean"][1],
        "ms": k7_ms,
        "call_ms": k7_wall_ms,
        "plain_ms": k7_plain_ms,
        "bound_ms": k7_bound,
        "bound_by": k7_by,
        "library_ms": k7_lib_ms,
        "read_pass_ms": k7rc_ms,
        "noisy_ms": k7n_ms,
        "noisy_read_pass_ms": k7r_ms,
        "noisy_bound_ms": k7n_bound,
        "read_launches": sum(by_path("K7_read").values()),
        "dopri5_P11": p11["numbers"]["k7"],
        "sass_hmma": sum(n for fn, n in hmma["crossbar_vmm"].items()
                         if "k7_gemm_kernel" in fn),
    }, *[{
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/softdtw.cu",
        "replaces": replaces,
        "launches": sum(c[0][key] for c in p4.values())
        + sum(p9_paths_of(key).values()),
        "launches_by_path": {**{f"P4_segment_{seg}": c[0][key]
                                for seg, c in p4.items()},
                             **p9_paths_of(key)},
        "shape": "B=29 n=61 m=61 gamma=0.1 (L96 training, segments of 60)",
        "max_abs_err": max(v[0] for e in sdtw_errs.values()
                           for k, v in e.items() if k.startswith(key)),
        "max_rel_err_of_peak": max(v[1] for e in sdtw_errs.values()
                                   for k, v in e.items()
                                   if k.startswith(key)),
        "bitwise_equal_to_plain": all(
            v for e in sdtw_equal.values() for k, v in e.items()
            if k.startswith(key) or k.startswith(f"diag {key}")),
        **{k: sdtw_timed[29, 61, 61][key][k]
           for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                     "chain_bound_ms")},
        "library_ms": None,
        "chain_cycles_per_step": chain[key]["cycles_per_step"],
        **({"sdtw_log_mismatches_in_1_to_3": chain["log_mismatches"]}
           if key == "K5" else {}),
        "segment_200_shape": {
            k: sdtw_timed[8, 201, 201][key][k]
            for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                      "chain_bound_ms")},
        **({"term_ms_by_segment": {
                seg: sdtw_timed[shape]["K5"]["term_ms"]
                for shape, seg in (((29, 61, 61), 60), ((8, 201, 201), 200))},
            "term_device_kernels_by_segment": {
                seg: {"measured": sdtw_timed[shape]["K5"]["term_kernels"],
                      "with_layout_glue_estimate":
                          sdtw_timed[shape]["K5"]["term_kernels_glue_estimate"]}
                for shape, seg in (((29, 61, 61), 60), ((8, 201, 201), 200))}}
           if key == "K5" else {}),
    } for name, key, replaces in (
        ("softdtw_rowmajor", "K5", "src/repro/kernels/softdtw.py:110"),
        ("softdtw_rowmajor_bwd", "K6",
         "src/repro/kernels/softdtw.py:215"))], *lm_entries,
        *p10["kernels"], *p12_entries(p12),
        *p13_entries(p13, k3_rows["masks"])]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
