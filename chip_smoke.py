#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's paths — the paper's Fig-9 speech-enhancement
SigProgram (learned FIR -> STFT -> mask CNN -> iSTFT, plus a mel tap) at
its own width (length 4096, frame 256, hop 128, 9 FIR taps, 24 mels, mask
CNN channels (2, 12, 12, 1)), offline, served, trained and streamed,
its SigQuant form Fig-9q (the mask a block-circulant layer, calibrated,
served and streamed int-routed), the FFT, phased-FIR and
flash-attention entry points, a dense LM (starcoder2-3b) served and
co-served with Fig 9, the other model families (MoE, RG-LRU hybrid,
xLSTM, Whisper) served, starcoder2-3b and each other family trained
at full width,
Fig 9 served and streamed over a 4-shard mesh (SigMesh) with its
fault-tolerance paths, the multi-device models (a pipelined
forward, a sharded train step, the compressed all-reduce and an elastic
checkpoint) on 4 gloo ranks sharing the card, the launchers (the
serve CLI at full width, the dry-run on fake CUDA tensors), and the
paper's own signal workloads at their published sizes (FFT 128-1024, FIR
256 x {20, 40, 80} and 8-phase, the 2-D DCT of 32, the DWT, a 1024-point
audio front end) offline, trained, served and streamed, with random
weights and inputs drawn from ``--seed`` (by numpy; the LM's weights by a ``torch.Generator`` on the
card) — phase by phase:

  0. environment: torch, the card, ``nvidia-smi`` name and power limit;
  1. build: compiles every ``src/repro_torch/kernels/csrc/*.cu`` with one
     ``nvcc`` each, all at once, links them into one library, prints
     registers, spills and ptxas's wgmma notes (C75xx) per kernel, and
     probes the library
     (``compiled_supported``, one launch of the copy probe), then times
     the probe against ``Tensor.copy_`` in turns (copy, probe, probe,
     copy);
  2. kernels: records the 4 shuffle-GEMM calls one Fig-9 forward makes
     (2 ``shuffle_gemm_blocks``: the FIR taps and the mel filterbank; 2
     ``shuffle_gemm_chain``: the STFT's and the iSTFT's 8 butterflies,
     each chain in one launch) and holds each against its plain PyTorch
     version on the same card tensors (rtol = atol = 1e-5 in float32,
     2e-2 in bfloat16), each chain also bit for bit against its 8
     sub-steps launched one at a time on ``shuffle_gemm_grouped_blocks``
     (each of those against its plain version too; their times summed
     beside the chain's), and the STFT chain in bfloat16; device times
     from CUDA-graph replays.  The ``shuffle_gemm_grouped`` entry point
     then runs the 16 sub-steps one launch each (the grouped kernel's
     ``launches``), equal to the chains' outputs;
  3. offline: one batch-4 forward on the ``hopper`` backend against the
     port's ``reference`` backend (rtol 1e-4, atol 1e-5), launching the
     kernels exactly ``FORWARD_LAUNCHES`` times; ``torch.profiler`` over
     5 forwards gives the device time by kernel and the busy share;
  4. serve: ``SignalService`` answers 8 mixed-length requests in one
     length bucket (the masked path), then the same 8 sent 4 times over
     (32 requests, 8 waves) in the window that is timed and counted;
     every result equals an offline compile at the request's true length
     (``out`` atol 1e-5, ``mel_tap`` rtol = atol = 1e-4).  The launch
     counts of this window are the ``launches`` of the kernel line.
  5. precision (Fig-9q at length 4096, batch 4): ``auto_policy`` on 6
     seeded batches at a 1e-2 budget; the bound program int-routes every
     policy step, each one launch of the fused quantize -> integer GEMM ->
     dequantize kernel (``bitserial_quant_matmul_hopper``); one forward's
     wall time, device launches and ``torch.profiler`` breakdown; on each
     int-routed call of one forward, the fused kernel and the planes
     kernel (``bitserial_matmul_planes``, on the call's quantized digit
     planes) are held bit-exact against their plain versions on the same
     card tensors and timed beside their bounds and the float64
     ``torch.matmul`` yardstick on the quantized integers (bit-exact too),
     and ``torch._int_mm`` where both widths are at most 8; the
     ``bitserial_matmul`` entry point then runs on the same quantized
     operands (the planes kernel's ``launches``); the held-out relative L2
     error of ``out`` and ``mel_tap`` is within the budget;
     ``SignalService(precision=)`` answers 8 + 32 mixed-length requests,
     each equal to the int-routed offline compile at its true length (atol
     1e-5).  The launch counts of the timed serve window are the fused
     kernel's ``launches``.
  6. entry points: ``fft_hopper`` on the 124 Fig-9 STFT frames, all 8
     stages and the final scatter in one launch (against its plain
     version at 1e-4 and ``torch.fft.fft`` at 2e-3), then each of the 8
     stages alone through ``fft_stage_hopper`` (against the plain stage
     at 1e-4, timed beside its per-stage bound), and ``fir_conv`` on
     the (4, 4096) input with 9 taps and 8 phases (against the plain
     version and a causal ``F.conv1d`` at 1e-4; timed in turns with the
     copy probe, its launch floor); their launch counts are those of one
     call.
  7. train: one Fig-9 ``value_and_grad`` step (wrt the front taps and
     the mask CNN, the example's edge-cut MSE against the clean target of
     ``SignalStream(4096, 4, seed)``) on ``hopper`` against the port's
     ``reference`` backend on the same card tensors (loss and every
     gradient leaf at rtol 1e-4, atol 1e-5), launching the kernels
     exactly ``TRAIN_LAUNCHES`` times (forward 2 + 2, backward 1 + 2);
     its wall time and ``torch.profiler`` breakdown; each backward
     kernel call held against its plain version (rtol = atol = 1e-5),
     each backward chain also bit for bit against its sub-steps launched
     one at a time, and timed; 6 AdamW steps through ``train``
     lower the held-out loss; Fig-9q's straight-through gradient equals
     that of ``y_float + (y_int - y_float).detach()`` on its mel step,
     and the full policy's gradients are finite and nonzero.  The
     backward launch counts are the shuffle-GEMM rows' ``backward``.
  8. attention: ``flash_attention`` on a gemma2-2b local layer (S 8192,
     8 heads over 4 kv heads, hd 256, window 4096, softcap 50) and a
     starcoder2-3b layer (S 4096, 24 heads over 2, hd 128), each in
     float32 (split-TF32 body: a pre-pass launch, then three TF32
     ``wgmma`` products for each float32 one) and bfloat16 (bf16
     ``wgmma`` body), batch 1, causal — each held against the plain
     version (rtol = atol = 1e-4 and a max abs error of 1e-5 in float32;
     bfloat16 rtol 1e-2, atol 5e-3; relative L2 error under 1e-2) and
     timed beside its bound (float32: the split-TF32 bound, 3 x the
     flops at 495 TFLOP/s, and the FMA bound at 67 TFLOP/s, each with the
     kernel's share of it); each float32 call's pre-pass
     (``flash_split_kv_hopper``) bit for bit its plain version, timed;
     the starcoder2 calls also against ``F.scaled_dot_product_attention``,
     held to the same limits.  The four calls' launches are the flash
     kernels' ``launches``; ``launches_per_call`` holds each call's own,
     read with the counts set to 0 just before it and read just after,
     and each is held to the wrapper's ``LAUNCHES_PER_CALL`` for its
     type; the row's ``per_call`` splits the times by call, and
     ``library_kernel_ms`` is the kernel's time on the calls
     ``library_ms`` covers.
  9. stream: Fig 9 streamed on ``hopper`` in blocks of at most 8 new
     frames.  A ``StreamingRunner`` takes a batch of 4 in chunks of 256,
     100, 700, 37 and the rest, against the offline compile (``out`` atol
     1e-5, ``mel_tap`` rtol 1e-5, atol 1e-4).  4 lock-stepped
     ``SignalService`` sessions fed 256 samples a tick make at most one
     core call a tick, each exactly ``STREAM_TICK_LAUNCHES`` (the mel
     GEMM, the STFT and iSTFT chains); every session equals the offline
     compile and its private runner at those limits, and one session
     alone equals its private runner bit for bit.  The first compile of
     each block size is timed; a steady tick's calls are held against
     their plain versions (each chain bit for bit its sub-steps) and
     timed, and the first blocks' calls (fewer frames) are held too; the
     tick's p50 wall time, samples/s and ``torch.profiler`` breakdown.
     Gradients of phase 7's loss through the runner (front taps, mask
     CNN) equal the offline ``value_and_grad`` (rtol 1e-4, atol 1e-5),
     the backward launching the shuffle-GEMM kernels.  Fig-9q streams
     under the phase-5 policy: one ``bitserial_quant_matmul_hopper``
     launch per int-routed core step, ``out`` within the 1e-2 budget of
     the float32 reference.  ``save_checkpoint`` mid-stream,
     ``restore_from_disk`` in a fresh service and the same feeds give
     tails equal bit for bit, nothing delivered twice.  An ``iir_biquad
     -> fir`` chain of 2048 samples streams equal to offline (atol
     1e-5).  The session window's launches are the shuffle-GEMM rows'
     ``stream``.
 10. sched: SigSched, the service's default dispatch, on Fig 9 at full
     width: (a) phase 4's window through ``scheduler=False`` gives the
     same ``batches``, ``bucketed``, ``exact`` and ``compiles``, the same
     launches and the same results bit for bit; (b) two registrations
     ``a``, ``b`` of Fig 9 with equal params, 8 requests alternating,
     ``batch_size=8``: one cross-graph wave of exactly
     ``FORWARD_LAUNCHES``, where ``scheduler=False`` takes 2; (c) the
     same with ``b``'s FIR taps and mask CNN from seed 1: still one wave
     of ``FORWARD_LAUNCHES``, ``param_splits`` 0, the FIR call one
     ``shuffle_gemm_blocks`` launch on per-row operands ``w (8, 9, 1)``,
     each row against its own graph's offline compile with its own
     params (``out`` atol 1e-5, ``mel_tap`` rtol = atol = 1e-4); (d)
     ``row_budget=2`` splits the 8-row wave into 4 chunks equal bit for
     bit to the unsplit wave; (e) a deadline-1 newcomer runs before an
     older bulk group, a slack-rich request defers one tick and runs in
     a fuller wave, and at ``batch_size=1`` a deadline-less request runs
     within ``6 x starvation_ticks`` ticks of finite-deadline load; (f)
     sessions of ``a``, ``b``, ``a``, ``b`` fed 256 samples a tick make one
     cross-graph core call a tick of ``STREAM_TICK_LAUNCHES``, equal to
     the offline compile at phase 9's limits; (g) smoke readings: p50
     ``step()`` and requests/s on 16 requests ``a`` / ``b`` with SigSched
     and with ``scheduler=False``, and the per-row FIR call's device time
     beside the shared-``w`` call, its bound and its plain version (each
     row bit for bit the shared call on its operand; the plain version at
     1e-5).  The per-row call is the kernel JSON's ``per_row`` entry of
     ``shuffle_gemm_blocks``.
 11. models: starcoder2-3b at its config's full width (30 layers, d 3072,
     24 heads over 2, hd 128, d_ff 12288, vocab 49152, bfloat16; random
     weights drawn on the card from ``--seed``) served by
     ``ServingEngine``: (a) 16 requests, prompts cut from ``TokenStream``
     to 256-2048 tokens, ``max_new=32`` at batch 8 — the main path, whose
     flash launches are the kernel JSON's ``launches`` — every request
     exactly 32 tokens, exactly 30 ``flash_attention_hopper`` launches a
     prefill (one a full-length attention layer) and none in a decode
     step; (b) every ``flash_attention`` call of an 8 x 2048 prefill, as
     ``models/layers.py`` makes it, against the plain version (relative
     L2 under 1e-2), one call timed beside its bound and
     ``F.scaled_dot_product_attention``; (c) ``DecodeWave`` stepped to the
     end gives ``generate``'s tokens bit for bit; (d) teacher forcing: a
     prefill of S - 1 tokens and one ``decode_step`` against
     ``forward_train``'s last two positions (relative L2 under 2e-2);
     (e) the engine co-served with phase 4's Fig-9 service through
     ``CoScheduler`` under ``round_robin``, ``latency_aware`` and
     ``cost_balanced``: 8 LLM requests (prompts 64-512, ``max_new`` 16)
     and 16 Fig-9 requests all complete, both occupancy counters
     positive, every tick's launches exactly ``FORWARD_LAUNCHES`` a DSP
     wave and 30 flash a prefill, DSP results equal the offline compile
     at phase 4's tolerances, ``round_robin``'s tokens ``engine.serve``'s
     bit for bit, and ``latency_aware`` serves an EDF deadline script in
     deadline order; (f) a newcomer admitted mid-flight into a batch-2
     wave against its solo run, equal wherever the solo run's top-2
     logit margin is above 1e-2 (a flip on a smaller margin is a tie
     between batch-2 and batch-1 products; the comparison stops there);
     (g) smoke readings: prefill time of an 8 x 2048 wave and its flash
     share, p50 decode step and tokens/s at batch 8, a decode step's
     launches, ticks/s and ``dsp_share`` by policy, peak memory.
 12. families: each other model family served at its config's full
     width, bf16, random weights drawn on the card from ``--seed``, one
     model at a time (``FAMILIES``): qwen2-moe-a2.7b (24 layers, 60
     experts top-4 + a shared expert), grok-1-314b (cut to 2 of its 64
     layers: 8 experts of d_ff 32768, softcap 30), recurrentgemma-2b (26
     RG-LRU and local-attention layers, window 2048, MQA at hd 256, a
     prompt past the window), xlstm-350m (24 mLSTM/sLSTM blocks, no
     attention) and whisper-small (12 encoder layers over the engine's
     1500 zero frames, 12 decoder layers).  For each: (a) the requests
     through ``ServingEngine.serve``, every request exactly ``max_new``
     tokens, exactly one ``flash_attention_hopper`` launch a full-length
     attention layer a prefill (24 / 2 / 8 / 0 / 12 + 12), none of
     ``flash_split_kv_hopper``, and (MoE) the routed slots the prefills
     dropped at the shipped capacity factor; (c) ``DecodeWave`` == the
     served tokens bit for bit, 0 flash launches a decode step; (b)
     every flash call of a prefill of the longest prompts against the
     plain version (relative L2 under 1e-2), the first one timed beside
     its bound and ``F.scaled_dot_product_attention`` (with a window
     mask where the window bites; none for a softcap); (e) smoke
     readings: parameter bytes, the prefill's wall time, launches and
     flash share, p50 decode step, a step's launches and busy share,
     peak memory; (d) last, teacher forcing (a prefill of S - 1 tokens
     and one decode step against ``forward_train``; MoE at capacity
     factor E / k, so no slot drops) held at relative L2 1e-3 on the
     weights upcast to float32 in place, the bf16 reading (and MoE's
     routing flips at the last token) printed beside it.
 13. LM train: (a) starcoder2-3b at full width and depth (30 layers, d
     3072, bf16, random weights from ``--seed``, the config's microbatch
     4 and remat) trained 20 steps through ``make_batch_iterator``
     (``TokenStream(vocab, 2048, 8, seed)``) -> ``make_train_step``
     (``cosine_schedule(3e-4, 5, 20)``, in-place AdamW) -> ``TrainLoop``:
     every loss and gradient norm finite, no kernel launched in any step
     (attention under autograd takes the JAX package's direct route below
     4096 positions), the mean of the last 5 losses under the first 5's
     minus 0.3 (``examples/train_e2e.py``'s check); readings: p50 step
     time, one step's device busy share and launches (``torch.profiler``),
     peak memory.  (b) The held-out loss at the final params under
     ``torch.no_grad()`` (the flash kernel, exactly one launch a layer)
     within relative 1e-2 of the same loss with autograd recording (the
     direct route, no launch).  (c) ``examples/train_e2e.py``'s recipe on
     the port (d 768, 8 layers, vocab 8192, float32, seq 256, batch 8,
     microbatch 2, remat, 200 steps, checkpoints every 50, keep 2): the
     loss falls by more than 0.3, and a run failing hard at step 120 (3
     failures against ``max_retries`` 2) restores step 100 and ends on
     the whole run's last 5 losses at rtol 1e-6 (whether they are bit
     equal is printed);
 14. mesh: SigMesh on Fig 9 at phase 4's width and window (batch 4,
     ``fuse=2``; the 4 shards wrap onto the one card, as the JAX
     package's mesh spans one jax device): (a) phase 4's 32 requests
     through ``SignalService(mesh=4)`` and an unmeshed service, every
     result ``np.array_equal``, every meshed wave exactly
     ``FORWARD_LAUNCHES`` (one call on the padded rows), the router
     charging each shard ``device_step_costs`` a wave and ``wall_cycles``
     its largest share; (b) ``sharded_jit`` over ``make_data_mesh()`` on
     a batch of 8, ``torch.equal`` to the plain call, ``FORWARD_LAUNCHES``;
     (c) 4 sessions on ``mesh=4`` (one a shard, never stacked) against 4
     unmeshed ones, 256 samples a tick: a meshed tick exactly 4 core
     calls of ``STREAM_TICK_LAUNCHES``, every output ``np.array_equal``;
     then ``StreamSupervisor`` over fresh meshed services under each of
     ``MESH_FAULTS`` (a transient failure, retry exhaustion, a lost
     shard), each run ``np.array_equal`` to the unfailed supervised run
     with the listed ``stats``, the dropped shard holding no session and
     the re-homed state on the card; (d) ``CoScheduler`` over a meshed
     service and starcoder2-3b cut to 2 layers at full width: all work
     done, ``occupancy()["per_device"]`` charging every shard, the DSP
     results equal to (a)'s; (e) smoke readings in turns (unmeshed,
     meshed, meshed, unmeshed; 4 windows each): p50 ``step()`` and p50
     tick meshed against unmeshed, launches a tick, the phase's seconds.
     Its launches are the shuffle-GEMM rows' ``mesh`` entry.
 15. mesh models (``mesh_models_phase``, callable alone after
     ``kernels.build()``): 4 gloo ranks started with ``spawn``, all on
     ``cuda:0`` (one H100 takes one NCCL rank), their collectives through
     the port's staged group (pinned host buffers, counted): every time
     here is that one-card transport's, not an inter-card link's.  (a)
     ``all_reduce``, ``broadcast``, ``all_gather_into_tensor``,
     ``reduce_scatter_tensor``, ``send``/``recv`` and
     ``all_to_all_single`` on CUDA tensors, by plain gloo (one 2-rank
     group an op) and by the staged group: a table of what ran; (b)
     ``spmd_pipeline`` over 4 stages, each one starcoder2-3b block at
     full width (bf16), 8 microbatches of 1 x 2048 under ``no_grad``:
     bit for bit the same blocks run one after another in the parent,
     exactly 8 ``flash_attention_hopper`` launches a rank; (c)
     starcoder2-3b at full width cut to 2 layers, float32, TF32 off, its
     microbatch 4 and remat, on a (2, 2) mesh, 3 steps at batch 8 x 512
     from ``make_batch_iterator(sharding=)``: loss and gradient norm at
     rtol 1e-5, every moment and param at rtol 1e-4 / atol 1e-6 (params
     whose gradient came within 100x of AdamW's eps at 2 x steps x lr)
     against the unsharded ``make_train_step`` in the parent, and each
     moment's largest error over its largest value; p50 step, collectives
     and staged bytes a step, peak memory by rank; (d)
     ``allreduce_compressed`` of a 3072 x 12288 gradient within 0.1 of
     the mean, its int8 and float32 payload bytes, and a tree saved from
     (2, 2) and restored under (4, 1) bit for bit; (e) run first, in a
     spawn of 4 ranks of its own (``mesh_families``), qwen2-moe-a2.7b cut
     to 1 layer and
     xlstm-350m to 8 (one pattern of 7 mLSTM + 1 sLSTM), full width,
     float32, TF32 off, on the (2, 2) mesh, params drawn on the CPU and
     each rank's blocks moved to the card, moments zero-1: a sharded
     prefill of 8 x 256 and one greedy decode step against the parent's
     unsharded ones (logits rtol 1e-4, atol 1e-5 — xlstm's by relative L2
     1e-3, phase 12's float32 limit —, both tokens bit for bit), qwen2-moe's
     prefill exactly one float32 ``flash_attention_hopper`` call and its
     ``flash_split_kv_hopper`` pre-pass a layer a rank (8 of 16 heads),
     none in a decode step or in xlstm; then one sharded train step
     against the unsharded one at (c)'s limits
     (params near eps in either run exempt; xlstm: its loss there, its
     gradient norm and the whole first and
     second moments by relative L2 at 1e-2, each leaf's error printed);
     step p50 sharded against unsharded, staged bytes a step.  A failed
     rank fails the phase.
 16. launchers (``launchers_phase``, callable alone after
     ``kernels.build()``): (a) ``python -m repro_torch.launch.serve
     --arch gemma2-2b --no-reduced`` (``serve.main`` in this process) at
     full width, in bf16 and with ``--quant-bits 8``: 6 requests at batch
     4, ``max_new`` 16, each exactly 16 tokens, exactly 2 waves x 26
     ``flash_attention_hopper`` launches a run and no other kernel, the
     tokens equal to ``ServingEngine.serve`` on the same weights, tok/s
     printed; (b) the dry-run (``launch/dryrun.py`` ``lower_cell``) of
     ``DRYRUN_CELLS`` on fake CUDA tensors over a fake 256 / 512-rank
     process group, one ``spawn``ed process a cell, all started after
     (a) at a lower priority and read after phase 17, which runs
     meanwhile: no launch, no card memory but FakeTensorMode's own probe,
     ``argument_bytes`` equal to the sharding specs' count, the
     prefills' flash op 30 (starcoder2-3b) and 24 (qwen2-moe-a2.7b) calls
     at the flop formula; the same step traced on one fake device with
     no mesh (``dryrun.unsharded_flops``; a train cell's in a process of
     its own), and each cell's share (FLOPs
     less ``replicated.flops``) times the ranks equal to its FLOPs at
     relative 1e-9; per cell the counted loops (``while_loops``: a
     loop's body traced until two trips count alike, the rest added),
     the trace seconds, FLOPs, HBM bytes, collectives and memory per
     device.  The 15 cells (``DRYRUN_CELLS``): starcoder2-3b train_4k
     (also on (2, 16, 16)), prefill_32k and decode_32k, gemma2-2b
     decode_32k, qwen2-moe-a2.7b prefill_32k and decode_32k,
     grok-1-314b decode_32k and train_4k (also on (2, 16, 16); its
     FLOPs and replicated FLOPs a device also held to the CPU sweep's,
     ``DRYRUN_SWEEP_FLOPS``), xlstm-350m decode_32k, long_500k,
     prefill_32k and train_4k (also on (2, 16, 16)); starcoder2-3b
     prefill_32k and train_4k and xlstm-350m long_500k are also traced
     with every loop run whole and held to their loop-aware records
     (FLOPs, replicated FLOPs, HBM and collective bytes at relative
     1e-9, temp bytes at 5%).
 17. family train (``family_train_phase``, callable alone after
     ``kernels.build()``): phase 13 (a)-(b) for each other family at
     full width, bf16, random weights drawn on the card from ``--seed``,
     the config's microbatch and remat, one model at a time
     (``FAMILY_TRAIN``): qwen2-moe-a2.7b (cut to 4 of its 24 layers, 8 x
     2048), recurrentgemma-2b (uncut, 4 x 2048: the local layers' window
     full, the rows halved beside 16b's processes' card contexts),
     xlstm-350m (cut to 8 of its 24 layers, 8 x 128: its sLSTM is a
     Python loop over time) and whisper-small (uncut, 8 x 448 decoder
     tokens over 1500 seeded encoder frames).  For each: (a) 10 steps
     (xlstm-350m 24) through
     ``make_batch_iterator`` -> ``make_train_step``
     (``cosine_schedule(3e-4, 3, steps)``) -> ``TrainLoop``, every loss
     and gradient norm finite, no kernel launched in any step, the mean
     of the last 3 losses under the first 3's minus 0.3, (MoE) the
     routed slots each step dropped at the shipped capacity factor; (b)
     the held-out loss at the final params on one microbatch's rows
     under ``torch.no_grad()`` (exactly one ``flash_attention_hopper``
     launch a full-length attention layer: 4 / 8 / 0 / 24) within
     relative 1e-2 of the same loss with autograd recording (the direct
     route, no launch); (c) smoke readings: init seconds, parameter
     bytes, p50 step and tokens/s, one step's busy share, launches and
     time by kind of kernel (``torch.profiler``), peak memory.  Then (d)
     ``python -m repro_torch.launch.train --arch xlstm-350m --steps 50
     --seq 128 --batch 8`` (``train.main``) on the card: its ``loss a
     -> b`` line with b below a, no launch, its two checkpoints written
     under ``build/`` and removed; the phase's seconds printed beside
     its 300 s budget.
 18. kernels: the kernel JSON of all ten kernels (phase 20's per-row
     calls under ``per_row``); the flash row's numbers
     are the serving path's call (phase 11), phase 8's under
     ``entry_point``, phase 12's under ``families``, phase 13's under
     ``train``, phase 17's under ``family_train``, phase 15's pipelined
     forward under ``mesh_models`` and phase 16a's serve CLI under
     ``launchers`` (those two's launches added to the row's); the three
     shuffle-GEMM rows, ``fft_stages_hopper`` and ``fir_conv_hopper``
     carry phase 19's under ``paper_suite`` (its launches added to the
     rows').  Phase 19 runs after phase 16, before this list.
 19. paper suite (``paper_suite_phase``, callable alone after
     ``kernels.build()``): the workloads of ``configs/sigdla_paper.py``
     as ``paper_suite`` builds them — fft128 / 256 / 512 / 1024,
     fft_ifft1024, fir256_20 / 40 / 80 and fir256_80_phased (taps from
     ``--seed``), dct2_32 (rows of 32; the 2-D transform of a block two
     calls with a transpose between), dwt_haar / dwt_db2 at 1024, at
     4096 rows (dct2_32 4096 blocks, 131072 rows), and front1024 (a
     learnable FIR of 80 taps -> STFT 1024 / 512 -> one-sided magnitude
     -> 64 mels at 16 kHz over 16384 samples, 64 rows): (a) each at fuse
     0, 1 and 2 on ``hopper`` against ``reference`` on the same card
     tensors (rtol 1e-4, atol 1e-4 x max|want|); each chain bit for bit
     its sub-steps launched one at a time, fft1024's and front1024's in
     bfloat16 too (against the plain version at 2e-2, the same form);
     (b) exactly ``SUITE_LAUNCHES`` a forward (fuse 0: a grouped launch a
     butterfly; fuse 1, 2: one chain a stage) and each chain's shared
     memory ``SUITE_SHARED_BYTES`` (80,368 to 205,552 bytes a block);
     (c) front1024's ``value_and_grad`` wrt the FIR taps and the mel
     weights (the mel's squared error against a seeded target over the
     target's power) on ``hopper`` against ``reference`` (rtol 1e-4,
     atol 1e-5), launching ``SUITE_TRAIN_LAUNCHES``, then 6 AdamW steps
     lower the held-out loss; (d) one ``SignalService`` holding the suite
     answers 64 requests spread over its graphs (the FIRs and front1024
     at uneven lengths), each equal to the offline compile at its true
     length at (a)'s limits, the window's launches printed; (e)
     ``StreamingRunner`` takes fir256_80 in chunks of 100, 37 and 119
     against the offline compile (atol 1e-5) and refuses front1024 (an
     STFT with no iSTFT), as the JAX package's does; (f) smoke readings:
     each kernel call of a fuse-2 forward timed (CUDA-graph replays)
     beside its bound, its plain version, one PyTorch call computing the
     same function where there is one (``torch.fft.fft``, a causal
     ``F.conv1d``, and ``torch.matmul`` on ``x.view(B, rows, t)`` where a
     call's rows gather ``x`` in order without overlap: dct2_32,
     dwt_haar, front1024's mel; each held to the kernel's result; db2's
     windows overlap and wrap, so it has none) and, for a call of t >=
     32, the sequential body on the same operands; ``fft_hopper`` at
     128-1024 points and ``fir_conv`` at 256 x {20, 40, 80} taps in 8
     phases on 4096 rows through phase 6's readings
     (``fft_entry_reading``, ``fir_entry_reading``); (g) the
     phase's seconds against its 180 s budget.
 20. per-row (``per_row_phase``; runs after phase 10): two tenants of one
     graph with different params as one wave, each kernel launching once
     with one operand a batch row: (a) Fig-9q at ``LENGTH`` under phase
     5's policy, tenants from ``--seed`` and ``--seed`` + 1 (FIR taps and
     circulant-mask weights), 8 requests alternating at ``batch_size=8``:
     one wave, ``param_splits`` 0, one Fig-9q forward's launches with
     every quantized GEMM on ``w (8, K, N)``, each row against its
     tenant's offline compile (atol 1e-5), and the wave's wall time
     against the same requests as two waves of one tenant, in turns;
     (b) ``iir_biquad -> stft(256, 128, learnable window) -> istft`` at
     ``LENGTH`` with two tenants' coefficients and windows: one wave, one
     forward's launches, rows at atol 1e-5; (c) Fig 9's 16 butterflies at
     batch 8 with one operand a batch row: each per-row chain and
     grouped call bit for bit the shared call on each row's operands
     and within 1e-5 of its plain version; the planes kernel at (3, 5)
     and (8, 8) planes equal to its plain version; (d) each per-row
     call's device time beside the shared call on the same shapes, its
     bound, its plain version and a library call (the quantized GEMM:
     float64 ``torch.bmm`` on the quantized integers; the planes kernel:
     float64 ``torch.matmul`` on the composed digits at (3, 5), none exact
     at (8, 8)), each held bit for bit, and the body each quantized call
     ran (``quant_rows_body``: row, tiles or chunked); the wave's device
     time by ``torch.profiler`` beside its wall time (the kernel JSON's
     ``per_row`` entries; the waves' launches added to the rows').

Any failed phase raises and the script exits non-zero.  The last two
lines are the kernel JSON and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import itertools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

LENGTH, BATCH, CH = 4096, 4, (2, 12, 12, 1)
SERVE_LENGTHS = [LENGTH - 500 - 200 * i for i in range(8)]
SERVE_ROUNDS = 4                   # the 8 lengths, sent 4 times
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12            # H100 SXM float32 outside tensor cores
INT8_OPS_PER_S = 1979e12           # H100 SXM int8 tensor cores, dense
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
Q_BUDGET, Q_BATCHES = 1e-2, 6      # SigQuant error budget, calibration data
TPU_KERNELS = {
    "shuffle_gemm_blocks": "src/repro/kernels/shuffle_gemm/kernel.py:64",
    "shuffle_gemm_grouped_blocks":
        "src/repro/kernels/shuffle_gemm/kernel.py:125",
    "shuffle_gemm_chain_hopper":
        "src/repro/kernels/shuffle_gemm/kernel.py:125",
    "bitserial_matmul_planes": "src/repro/kernels/bitserial_mm/kernel.py:46",
    "bitserial_quant_matmul_hopper":
        "src/repro/kernels/bitserial_mm/kernel.py:46",
    "fft_stages_hopper": "src/repro/kernels/fft_stage/kernel.py:39",
    "fir_conv_hopper": "src/repro/kernels/fir_conv/kernel.py:33",
    "flash_attention_hopper": "src/repro/kernels/flash_attention/kernel.py:81",
    "flash_split_kv_hopper":
        "src/repro/kernels/flash_attention/kernel.py:81",
    "compiled_supported": "src/repro/kernels/__init__.py:66",
}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"shuffle_gemm_blocks": CSRC + "shuffle_gemm.cu",
           "shuffle_gemm_grouped_blocks": CSRC + "shuffle_gemm.cu",
           "shuffle_gemm_chain_hopper": CSRC + "shuffle_gemm.cu",
           "bitserial_matmul_planes": CSRC + "bitserial_mm.cu",
           "bitserial_quant_matmul_hopper": CSRC + "bitserial_mm.cu",
           "fft_stages_hopper": CSRC + "fft_stage.cu",
           "fir_conv_hopper": CSRC + "fir_conv.cu",
           "flash_attention_hopper": CSRC + "flash_attention.cu",
           "flash_split_kv_hopper": CSRC + "flash_attention.cu",
           "compiled_supported": CSRC + "shuffle_gemm.cu"}
BF16_FLOP_PER_S = 989e12           # H100 SXM bf16 tensor cores, dense
TF32_FLOP_PER_S = 495e12           # H100 SXM TF32 tensor cores, dense
# Launches of one Fig-9 forward on hopper: the FIR taps and the mel
# filterbank on shuffle_gemm_blocks; the STFT's 8 butterflies and the
# iSTFT's 8 are two runs of consecutive grouped steps, each one chain
# launch (kernels/shuffle_gemm/chain.py finds one segment of 31 tiles of
# 512 floats a batch row in each).  A value_and_grad step (wrt the front
# taps and the mask CNN) adds the backward: each of the 16 butterflies
# needs d_x (its input depends on the front taps), one transposed GEMM
# and one adjoint reduction; a reduction of width 1 (a butterfly's
# permutation) folds into the next transposed GEMM's gather, so each
# stage's backward is one chain launch (the iSTFT's 9 sub-steps, the
# STFT's 8), and the STFT framing's adjoint (width 2: frames overlap by
# the hop, so it reads across tiles) runs alone on shuffle_gemm_blocks.  The front taps' GEMM needs only d_w (its
# input is the signal: an einsum, no kernel) and the mel tap is not in
# the loss.
FORWARD_LAUNCHES = {"shuffle_gemm_blocks": 2,
                    "shuffle_gemm_grouped_blocks": 0,
                    "shuffle_gemm_chain": 2}
BACKWARD_LAUNCHES = {"shuffle_gemm_blocks": 1,
                     "shuffle_gemm_grouped_blocks": 0,
                     "shuffle_gemm_chain": 2}
TRAIN_LAUNCHES = {n: FORWARD_LAUNCHES[n] + BACKWARD_LAUNCHES[n]
                  for n in FORWARD_LAUNCHES}
TRAIN_STEPS = 6
# Streaming (phase 9): Fig 9 in blocks of at most 8 new frames, 4
# lock-stepped sessions fed 256 samples a tick.  A tick's one core call
# (the sessions' blocks stacked) runs the framewise core only — the FIR
# front-end streams as a plain einsum outside it, as in the JAX package —
# so it launches the mel filterbank on shuffle_gemm_blocks and the STFT's
# and the iSTFT's butterflies one chain each.
STREAM_BLOCK_FRAMES, STREAM_SESSIONS, STREAM_CHUNK = 8, 4, 256
STREAM_SPLITS = [256, 356, 1056, 1093]    # chunks 256, 100, 700, 37, rest
STREAM_TICK_LAUNCHES = {"shuffle_gemm_blocks": 1,
                        "shuffle_gemm_grouped_blocks": 0,
                        "shuffle_gemm_chain": 2}
STREAM_STEADY_TICKS = 20
IIR_LENGTH = 2048
# Attention layers at the widths of configs the repo ships, batch 1:
# (label, source, S, H, KV, hd, window, softcap, dtype name, (rtol, atol));
# all causal.  float32 runs the split-TF32 body, bfloat16 the bf16 one.
# softcap has no library call; the starcoder2 calls are also timed
# against F.scaled_dot_product_attention.  At S 4096 a causal
# output row over n unit-normal keys has a spread of about sqrt(e / n),
# so typical values are 0.03-0.04: the bfloat16 limits are set from the
# measured error (1.95e-3, one bf16 step at 0.25-0.5) with room on both
# sides, not from the small shapes of the unit tests (3e-2), where they
# would be as large as the values.  ATTN_REL_L2 also holds the relative
# L2 error of each whole output.
ATTENTION = [
    ("gemma2-2b local layer", "src/repro/configs/gemma2_2b.py", 8192, 8, 4,
     256, 4096, 50.0, "float32", (1e-4, 1e-4)),
    ("starcoder2-3b layer", "src/repro/configs/starcoder2_3b.py", 4096, 24,
     2, 128, 0, 0.0, "float32", (1e-4, 1e-4)),
    ("starcoder2-3b layer", "src/repro/configs/starcoder2_3b.py", 4096, 24,
     2, 128, 0, 0.0, "bfloat16", (1e-2, 5e-3)),
    ("gemma2-2b local layer", "src/repro/configs/gemma2_2b.py", 8192, 8, 4,
     256, 4096, 50.0, "bfloat16", (1e-2, 5e-3)),
]
ATTN_REL_L2 = 1e-2
F32_MAX_ABS = 1e-5                 # float32 calls: max abs error vs plain


def phase(title: str) -> None:
    print(f"== {title}", flush=True)


def device_ms(torch, fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured into a CUDA
    graph, replayed ``iters`` times between two CUDA events, so host
    launch overhead is not in the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def wall_ms(torch, fn, iters: int = 20) -> float:
    """Time of one ``fn()`` from the host's side: CUDA events around a
    loop of calls, launch overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_cost(args: dict) -> tuple:
    """(bytes, flops) one kernel call must move and do, from this call's
    data: each element of ``x`` that some row gathers, read once per batch
    row; ``pad`` only at the PAD entries (idx < 0), the only ones read;
    ``idx``, ``scale`` and ``w`` in full; the output written once.  2 flops
    per multiply-add."""
    x, idx, w, scale = args["x"], args["idx"], args["w"], args.get("scale")
    es = x.element_size()
    b, rows, t, n_out = x.shape[0], idx.shape[0], idx.shape[1], w.shape[-1]
    gathered = int(idx[idx >= 0].unique().numel())
    nbytes = (b * gathered * es + idx.numel() * 4 + int((idx < 0).sum()) * es
              + (0 if scale is None else scale.numel() * es)
              + w.numel() * es + b * rows * n_out * es)
    return nbytes, 2 * b * rows * t * n_out


def chain_cost(args: dict) -> tuple:
    """(bytes, flops) one chain launch must move and do, from this call's
    data: the input gathered once (each element of ``x`` the first
    sub-step reads, once per batch row, and its PAD values at the PAD
    entries), sub-step 0's tables, every later sub-step's tables as the
    kernel reads them (the two packed buffers: indices, PAD values where a
    sub-step has PAD entries, scales; one tile's copy where the tiles'
    tables agree), every operand, the output written once.  2 flops per
    multiply-add."""
    x, seg, ws = args["x"], args["segment"], args["ws"]
    es, b = x.element_size(), x.shape[0]
    kern, _ = seg.device_tables(x.device, x.dtype)
    idx0, _, scale0 = kern["first"]
    nbytes = (b * int(idx0[idx0 >= 0].unique().numel()) * es
              + int((idx0 < 0).sum()) * es + idx0.numel() * 4
              + (0 if scale0 is None else scale0.numel() * es)
              + kern["shared"].numel() + kern["own"].numel()
              + sum(w.numel() * es for w in ws)
              + b * seg.steps[-1].n_elems * es)
    flops = 2 * b * sum(s.rows * s.t * s.n_out for s in seg.steps)
    return nbytes, flops


def describe(name: str, args: dict) -> dict:
    if name == "shuffle_gemm_chain":
        seg = args["segment"]
        return {"kernel": name, "steps": len(seg.steps),
                "tiles": seg.tiles * args["x"].shape[0],
                "tile_floats": seg.steps[-1].n_elems // seg.tiles,
                "sub_steps": [(s.name, s.rows, s.t, s.n_out, s.groups)
                              for s in seg.steps]}
    idx, w = args["idx"], args["w"]
    return {"kernel": name, "rows": idx.shape[0], "t": idx.shape[1],
            "n_out": w.shape[-1], "groups": args.get("groups", 1),
            "nb": args.get("nb", idx.shape[0]),
            "pad": int((idx < 0).sum()), "scale": args.get("scale")
            is not None}


SHUFFLE_MODULES = ("repro_torch.kernels.shuffle_gemm.vjp",
                   "repro_torch.kernels.shuffle_gemm.ops")
SHUFFLE_NAMES = ("shuffle_gemm_blocks", "shuffle_gemm_grouped_blocks",
                 "shuffle_gemm_chain")


def plain_blocks(ref):
    """``ref`` (``ref_shuffle_gemm_blocks``) on a recorded
    ``shuffle_gemm_blocks`` call's arguments: the plan's row-tile spans,
    which only the kernel reads, set aside."""
    def plain(x, idx, pad_vals, w, scale=None, spans=None):
        return ref(x, idx, pad_vals, w, scale)
    return plain


def record_calls(torch, forward, module=SHUFFLE_MODULES,
                 names=SHUFFLE_NAMES, grad: bool = False):
    """Run ``forward()`` once (under ``torch.no_grad()`` unless ``grad``)
    with the kernel wrappers ``names``, as ``module`` (a module name or a
    tuple of them) calls them, wrapped by a recorder: returns ``[(kernel
    name, bound arguments)]`` in call order, with every tensor argument
    (and every tensor of a list argument) cloned and detached."""
    mods = [importlib.import_module(m) for m in
            ((module,) if isinstance(module, str) else module)]
    patched = [(m, n, getattr(m, n)) for m in mods for n in names
               if hasattr(m, n)]
    calls = []

    def keep(v):
        if isinstance(v, torch.Tensor):
            return v.detach().clone()
        if isinstance(v, list):
            return [keep(u) for u in v]
        return v

    def recorder(name, fn):
        sig = inspect.signature(fn)

        def rec(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            calls.append((name, {k: keep(v)
                                 for k, v in bound.arguments.items()}))
            return fn(*a, **kw)
        return rec

    for m, n, fn in patched:
        setattr(m, n, recorder(n, fn))
    try:
        with torch.set_grad_enabled(grad):
            forward()
        torch.cuda.synchronize()
    finally:
        for m, n, fn in patched:
            setattr(m, n, fn)
    return calls


def check_fig9_calls(calls) -> None:
    """The 4 calls match the Fig-9 lowering: two row-uniform GEMMs (FIR
    taps, mel) and two chains of 8 butterflies (t 4, n_out 4, groups
    1..128), 124 tiles of 512 floats each at batch 4."""
    d = [describe(n, a) for n, a in calls]
    blocks = sorted((c["rows"], c["t"], c["n_out"]) for c in d
                    if c["kernel"] == "shuffle_gemm_blocks")
    chains = [c for c in d if c["kernel"] == "shuffle_gemm_chain"]
    if blocks != [(31, 129, 24), (4096, 9, 1)] or len(d) != 4:
        raise AssertionError(f"shuffle_gemm_blocks shapes {blocks}, "
                             f"{len(d)} calls")
    for c in chains:
        shapes = [(rows, t, n_out) for _, rows, t, n_out, _ in
                  c["sub_steps"]]
        if c["steps"] != 8 or shapes != [(3968, 4, 4)] * 8 \
                or [g for *_, g in c["sub_steps"]] \
                != [1 << k for k in range(8)] \
                or (c["tiles"], c["tile_floats"]) != (124, 512):
            raise AssertionError(f"shuffle_gemm_chain call {c}")
    if len(chains) != 2:
        raise AssertionError(f"{len(chains)} chain calls")


def profile_forward(torch, forward, wall_ms_per_call: float,
                    calls: int = 5, label: str = "hopper forward",
                    grad: bool = False, breakdown: list = None):
    """Where one forward's device time goes: ``torch.profiler`` over
    ``calls`` forwards (under ``torch.no_grad()`` unless ``grad``), device
    time summed by kernel name, and the busy share against the
    unprofiled wall time of one forward.  Returns the device launches
    (kernels and copies) of one forward, or None when the profiler saw
    no device time; ``breakdown``, when given, is extended with the
    ``(us per forward, calls per forward, kernel name)`` entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.set_grad_enabled(grad):
        forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                forward()
            torch.cuda.synchronize()
    # device-side events only: an operator's entry repeats the time of
    # the kernels it launched
    by_name = [(e.self_device_time_total / calls, e.count / calls, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not by_name:
        print("profile: the profiler recorded no device time; device busy "
              "share not measured")
        return None
    by_name.sort(reverse=True)
    if breakdown is not None:
        breakdown.extend(by_name)
    busy_us = sum(t for t, _, _ in by_name)
    print(f"profile of one {label}: device busy {busy_us:.1f} us of "
          f"{wall_ms_per_call * 1e3:.1f} us wall "
          f"({100 * busy_us / (wall_ms_per_call * 1e3):.1f}% busy), "
          f"{sum(c for _, c, _ in by_name):.0f} kernels and copies")
    for t, c, key in by_name[:10]:
        print(f"  {t:8.2f} us  {c:5.1f} calls  {key[:90]}")
    return round(sum(c for _, c, _ in by_name))


def fig9q_mask_activation(v):
    """Fig-9q's mask activation, ``sigmoid(v - 1)``: a module-level
    function closing over nothing, so the program keeps a structural
    fingerprint and two registrations of the graph can share a wave."""
    import torch
    return torch.sigmoid(v - 1.0)


def fig9q_graph(length: int):
    """Fig-9q: the SigQuant form of Fig 9 (``tests/test_precision_
    calibration.py`` ``_fig9q(length, fir=True, mel=True)``) at Fig 9's
    own widths: 9 Hann taps, frame 256, hop 128, a block-circulant mask
    (block 4) in place of the CNN, and a 24-mel tap."""
    import numpy as np
    from repro_torch.signal import SignalGraph
    g = SignalGraph("fig9q")
    g.fir("front", "input", taps=np.hanning(9) / np.hanning(9).sum())
    g.stft("spec", "front", frame=256, hop=128)
    g.magnitude("mag", "spec", onesided=False)
    g.dnn_circulant("mask", "mag", 256, block=4,
                    activation=fig9q_mask_activation)
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=128, length=length)
    g.magnitude("m2", "enh", onesided=True)
    g.mel_filterbank("mel_tap", "m2", sr=16_000, n_mels=24)
    g.outputs("out", "mel_tap")
    return g


def bound(nbytes: int, ops: int, ops_per_s: float) -> tuple:
    """(bound ms, bytes-bound ms, operations-bound ms)."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return max(b, o), b, o


def new_row(calls: int, per: str) -> dict:
    return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_bytes_ms": 0.0, "bound_ops_ms": 0.0, "library_ms": None,
            "calls": calls, "per": per}


def add_call(row: dict, err: float, k_ms: float, p_ms: float,
             b: tuple) -> None:
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["ms"] += k_ms
    row["plain_ms"] += p_ms
    row["bound_ms"] += b[0]
    row["bound_bytes_ms"] += b[1]
    row["bound_ops_ms"] += b[2]


def int_mm_operands(torch, xq, wq, aw, ww):
    """The int8 operands ``torch._int_mm`` takes for the same product:
    the quantized integers (both widths at most 8 bits), zero-padded to
    its shape rules (M > 16, K and N multiples of 8); None when an
    operand has 16 bits."""
    if aw > 8 or ww > 8:
        return None
    (m, k), n = xq.shape, wq.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    ap = torch.zeros((mp, kp), dtype=torch.int8, device=xq.device)
    wp = torch.zeros((kp, np_), dtype=torch.int8, device=xq.device)
    ap[:m, :k], wp[:k, :n] = xq, wq
    return ap, wp


F64_LIBRARY = (
    "torch.matmul in float64 on the quantized integer operands (cast "
    "outside the timed region), exact while every partial sum stays "
    "below 2^53 (the bind-time guard keeps them below 2^31), wrapped to "
    "int32 and held equal to the kernel's output; summed over the calls")


def f64_yardstick(torch, xq, wq, want) -> tuple:
    """The one PyTorch call that computes a bitserial call's integer
    product at every width: ``torch.matmul`` in float64 on the quantized
    integers.  Checks its result, wrapped to int32, equals ``want`` bit
    for bit; returns (device ms, text)."""
    from repro_torch.kernels.bitserial_mm.ref import wrap32

    a64, w64 = xq.to(torch.float64), wq.to(torch.float64)
    peak = float(a64.abs().amax()) * float(w64.abs().amax()) * a64.shape[1]
    if peak >= 2 ** 53:
        raise AssertionError(f"float64 yardstick not exact: peak {peak}")
    got = wrap32(torch.matmul(a64, w64).to(torch.int64))
    if not torch.equal(got, want):
        raise AssertionError("the float64 torch.matmul yardstick disagrees "
                             "with the bitserial kernel")
    f_ms = device_ms(torch, lambda: torch.matmul(a64, w64))
    return f_ms, f"torch.matmul float64 {f_ms * 1e3:8.2f} us (bit-exact)"


# Phase 11: a dense LM served at full width, and co-served with Fig 9.
# starcoder2-3b at its config's widths (src/repro/configs/starcoder2_3b.py:
# 30 layers, d 3072, 24 heads over 2 kv heads, hd 128, d_ff 12288, GELU,
# vocab 49152, bfloat16), random weights drawn on the card from --seed.
# Every prefill's 30 attention layers are full-length calls, each one
# launch of the bf16 flash kernel; decode steps attend over the cache in
# plain torch and launch none.
LM_ARCH, LM_SRC = "starcoder2-3b", "src/repro/configs/starcoder2_3b.py"
LM_SIZES = {
    "batch": 8, "requests": 16, "max_new": 32, "prompt_lo": 256,
    "prompt_hi": 2048,                     # the served traffic
    "co_llm": 8, "co_lo": 64, "co_hi": 512, "co_max_new": 16,
    "co_dsp": 16,                          # the co-served traffic
    "tf_seq": 512,                         # the teacher-forcing check
    "admit_prompt": 64, "admit_long": 12, "admit_new": 8,
}
LM_TF_REL_L2 = 2e-2        # teacher forcing, bf16: see PERF.md §2
ADMIT_MARGIN = 1e-2        # solo top-2 logit margin under which a flip
                           # between batch-2 and batch-1 products is a tie
POLICIES = ("round_robin", "latency_aware", "cost_balanced")
EDF_DEADLINES = (5.0, 1.0, 3.0, 2.0)


def rel_l2(torch, got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def models_phase(torch, np, seed: int, smi: str, sig: dict) -> dict:
    """Phase 11.  ``sig`` carries phase 4's Fig-9 pieces: ``service()``
    (a fresh hopper ``SignalService`` with Fig 9 registered, warmed on
    one request), ``signals`` (the served lengths' inputs), ``offline``
    (their offline outputs at the true lengths, numpy), ``tol``,
    ``counts`` / ``reset`` (the shuffle-GEMM launch counters) and
    ``per_wave`` (``FORWARD_LAUNCHES``).  Returns the flash kernel's
    serving row for the kernel JSON."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ref_attention
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models import get_model
    from repro_torch.serving import (CoScheduler, DecodeWave, Request,
                                     ServingEngine, SignalRequest)
    from repro_torch.tree import tree_leaves
    sz = LM_SIZES
    cfg = get_config(LM_ARCH)
    n_attn = sum(lt in ("global", "local") for lt in cfg.layer_types)
    fa = flash_kernel.flash_attention_hopper
    per_prefill = {"flash_attention_hopper": n_attn,
                   "flash_split_kv_hopper": 0}
    none = {"flash_attention_hopper": 0, "flash_split_kv_hopper": 0}
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(seed),
                         device="cuda")
    batch, max_new = sz["batch"], sz["max_new"]
    engine = ServingEngine(bundle, batch_size=batch, temperature=0.0)
    engine.load(params, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    p_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    kv_token = 2 * n_attn * cfg.kv_dim * torch.finfo(
        params["embed"].dtype).bits // 8
    print(f"{LM_ARCH} ({LM_SRC}): {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads}, hd {cfg.head_dim}, "
          f"d_ff {cfg.d_ff} {cfg.mlp_kind}, vocab {cfg.vocab} "
          f"(padded {cfg.padded_vocab}), {cfg.dtype}; {n_params} params, "
          f"{p_bytes} B, KV cache {kv_token} B a token; init and load "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    toks = TokenStream(vocab=cfg.vocab, seq_len=sz["prompt_hi"],
                       global_batch=max(sz["requests"], batch + 4),
                       seed=seed).batch_at(0)
    rng = np.random.default_rng(seed + 20)
    lens = rng.permutation(np.linspace(sz["prompt_lo"], sz["prompt_hi"],
                                       sz["requests"]).round().astype(int))

    def requests(base):
        return [Request(rid=base + i, prompt=toks[i, :lens[i]].tolist(),
                        max_new=max_new) for i in range(sz["requests"])]

    # (a) the main path: the engine serves the requests, counted
    flash_kernel.reset_launch_counts()
    sig["reset"]()
    t1 = time.perf_counter()
    served = engine.serve(requests(0))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    serve_counts = flash_kernel.launch_counts()
    waves = -(-sz["requests"] // batch)
    if serve_counts != {k: v * waves for k, v in per_prefill.items()} \
            or any(sig["counts"]().values()):
        raise AssertionError(f"serving {sz['requests']} requests in {waves} "
                             f"waves launched {serve_counts} and "
                             f"{sig['counts']()}, not {n_attn} flash "
                             f"launches a prefill")
    if sorted(served) != list(range(sz["requests"])) or any(
            len(v) != max_new for v in served.values()):
        raise AssertionError("a served request did not return exactly "
                             f"{max_new} tokens")
    print(f"(a) served {sz['requests']} requests (prompts {lens.min()}-"
          f"{lens.max()} tokens, max_new {max_new}) at batch {batch} in "
          f"{waves} waves, {serve_s:.3f} s; launches {serve_counts} "
          f"({n_attn} a prefill); every request {max_new} tokens",
          flush=True)

    # (c) DecodeWave stepped to the end == generate's tokens; launches a
    # prefill and a decode step
    wave_reqs = requests(0)[:batch]
    flash_kernel.reset_launch_counts()
    wave = DecodeWave(engine, wave_reqs)
    torch.cuda.synchronize()
    if flash_kernel.launch_counts() != per_prefill:
        raise AssertionError(f"a DecodeWave prefill launched "
                             f"{flash_kernel.launch_counts()}")
    step_ms = []
    while not wave.done:
        flash_kernel.reset_launch_counts()
        t1 = time.perf_counter()
        wave.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if flash_kernel.launch_counts() != none:
            raise AssertionError(f"a decode step launched "
                                 f"{flash_kernel.launch_counts()}")
    if wave.results() != {r.rid: served[r.rid] for r in wave_reqs}:
        raise AssertionError("DecodeWave's tokens are not generate's")
    decode_ms = step_ms[:-1]              # the last step decodes nothing
    p50 = float(np.median(decode_ms))
    print(f"(c) DecodeWave of the first {batch} requests stepped to the end "
          f"== engine.serve's tokens bit for bit; {n_attn} flash launches "
          f"its prefill, 0 in each of its {len(decode_ms)} decode steps",
          flush=True)

    # (b) every flash call of an 8 x 2048 prefill against its plain version
    long_prompts = [toks[i, :sz["prompt_hi"]].tolist() for i in range(batch)]
    calls = record_calls(
        torch, lambda: engine.prefill_prompts(long_prompts, max_new),
        module="repro_torch.models.layers", names=("flash_attention",))
    if len(calls) != n_attn:
        raise AssertionError(f"{len(calls)} flash_attention calls in a "
                             f"prefill, not {n_attn}")
    worst_err = worst_rel = 0.0
    with torch.no_grad():
        for _, a in calls:
            q, k, v = a["q"], a["k"], a["v"]
            kw = dict(causal=a["causal"], window=a["window"],
                      softcap=a["softcap"])
            got, want = fa(q, k, v, **kw), ref_attention(q, k, v, **kw)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError("non-finite flash output")
            worst_rel = max(worst_rel, rel_l2(torch, got, want))
            worst_err = max(worst_err,
                            float((got.float() - want.float()).abs().max()))
            del got, want
    if not worst_rel < ATTN_REL_L2:
        raise AssertionError(f"a prefill's flash call is {worst_rel:.3e} "
                             f"relative L2 from its plain version")
    _, a = calls[0]
    q, k, v = a["q"], a["k"], a["v"]
    kw = dict(causal=a["causal"], window=a["window"], softcap=a["softcap"])
    b_, s_, h_, hd_ = q.shape
    with torch.no_grad():
        k_ms = device_ms(torch, lambda: fa(q, k, v, **kw), reps=3, iters=3)
        p_ms = device_ms(torch, lambda: ref_attention(q, k, v, **kw),
                         reps=1, iters=2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        l_rel = rel_l2(torch, sdpa().transpose(1, 2), fa(q, k, v, **kw))
        l_ms = device_ms(torch, sdpa, reps=3, iters=3)
    pairs = s_ * (s_ + 1) // 2
    flops = 4 * b_ * h_ * hd_ * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b = bound(nbytes, flops, BF16_FLOP_PER_S)
    print(f"(b) the {n_attn} flash_attention calls of a {batch} x "
          f"{s_} prefill (q {tuple(q.shape)}, k/v {tuple(k.shape)}, "
          f"{q.dtype}) vs the plain version: max abs err {worst_err:.3e}, "
          f"max relative L2 {worst_rel:.3e} (limit {ATTN_REL_L2}); one call "
          f"on {smi}: kernel {k_ms * 1e3:.1f} us ({flops / k_ms / 1e9:.1f} "
          f"TFLOP/s), plain {p_ms * 1e3:.1f} us, bound {b[0] * 1e3:.1f} us "
          f"({100 * b[0] / k_ms:.1f}% of it), F.scaled_dot_product_"
          f"attention {l_ms * 1e3:.1f} us (rel L2 {l_rel:.3e} to the "
          f"kernel)", flush=True)
    if not l_rel < ATTN_REL_L2:
        raise AssertionError(f"SDPA and the kernel differ: {l_rel:.3e}")
    del calls, q, k, v, qt, kt, vt
    row = new_row(1, f"one bf16 call of a {LM_ARCH} prefill at {batch} x "
                     f"{s_} (the serving path's shape); max_abs_err over "
                     f"the {n_attn} calls of that prefill")
    add_call(row, worst_err, k_ms, p_ms, b)
    row.update(library_ms=l_ms, library="F.scaled_dot_product_attention"
               "(is_causal=True, enable_gqa=True) on the same call",
               launches=serve_counts["flash_attention_hopper"],
               launches_per_prefill=n_attn, max_rel_l2=worst_rel)

    # (d) teacher forcing at full width
    tf = torch.as_tensor(toks[:2, :sz["tf_seq"]], device="cuda")
    with torch.no_grad():
        full, _ = bundle.forward(engine.params, {"tokens": tf})
        lp, cache = bundle.prefill(engine.params, {"tokens": tf[:, :-1]},
                                   max_len=sz["tf_seq"] + 2)
        ld, _ = bundle.decode_step(engine.params, cache,
                                   {"tokens": tf[:, -1:]})
    tf_rel = (rel_l2(torch, lp[:, -1], full[:, -2]),
              rel_l2(torch, ld[:, -1], full[:, -1]))
    print(f"(d) teacher forcing, 2 x {sz['tf_seq']} tokens: prefill of "
          f"{sz['tf_seq'] - 1} vs forward_train at position -2 relative L2 "
          f"{tf_rel[0]:.3e}, one decode_step vs position -1 {tf_rel[1]:.3e} "
          f"(limit {LM_TF_REL_L2})", flush=True)
    if not max(tf_rel) < LM_TF_REL_L2:
        raise AssertionError(f"teacher forcing: relative L2 {tf_rel}")
    del full, lp, ld, cache

    # (f) mid-flight admission against solo runs
    eng2 = ServingEngine(bundle, batch_size=2, temperature=0.0)
    eng2.load(engine.params, device="cuda")
    ap = sz["admit_prompt"]
    short = Request(rid=0, prompt=toks[batch, :ap].tolist(), max_new=2)
    long = Request(rid=1, prompt=toks[batch + 1, :ap].tolist(),
                   max_new=sz["admit_long"])
    newcomer = Request(rid=2, prompt=toks[batch + 2, :ap + 2].tolist(),
                       max_new=sz["admit_new"])
    w2 = DecodeWave(eng2, [short, long])
    w2.step()
    w2.step()
    if w2.free_slots() != 1 or list(w2.admit([newcomer])) != [0]:
        raise AssertionError("admission did not free the short request")
    while not w2.done:
        w2.step()
    got2 = w2.results()

    def solo(r):
        """A solo run's tokens and each step's top-2 logit margin (the
        computation of ``generate`` at batch 1)."""
        logits, cache, _ = eng2.prefill_prompts([r.prompt], r.max_new)
        out, margins = [], []
        for _ in range(r.max_new):
            top = torch.topk(logits[0, -1].float(), 2).values
            margins.append(float(top[0] - top[1]))
            cur = eng2._sample(logits[:, -1], None)
            out.append(int(cur[0]))
            logits, cache = eng2._step(cache, cur)
        return out, margins

    report = []
    for r in (long, newcomer):
        want, margins = solo(r)
        if want != eng2.serve([Request(rid=r.rid, prompt=r.prompt,
                                       max_new=r.max_new)])[r.rid]:
            raise AssertionError("the solo reading is not generate's")
        got = got2[r.rid]
        if len(got) != r.max_new:
            raise AssertionError(f"request {r.rid}: {len(got)} tokens")
        ties = sum(m <= ADMIT_MARGIN for m in margins)
        flip = next((j for j, (g, w) in enumerate(zip(got, want))
                     if g != w), None)
        if flip is not None and margins[flip] > ADMIT_MARGIN:
            raise AssertionError(f"request {r.rid} differs from its solo run "
                                 f"at step {flip}, margin {margins[flip]}")
        how = "equal" if flip is None else (
            f"equal up to step {flip}, a near-tie (margin "
            f"{margins[flip]:.2e}) after which the contexts differ")
        report.append(f"request {r.rid}: {how}; {ties} of {len(margins)} "
                      f"solo steps under margin {ADMIT_MARGIN}, min margin "
                      f"{min(margins):.2e}")
    print(f"(f) admission into a batch-2 wave after 2 steps (newcomer prompt "
          f"{ap + 2} = active prefix): " + "; ".join(report), flush=True)
    del eng2, w2

    # (e) co-serving with Fig 9 under each policy
    co_lens = rng.permutation(np.linspace(sz["co_lo"], sz["co_hi"],
                                          sz["co_llm"]).round().astype(int))
    co_spec = [(1000 + i, toks[i, :co_lens[i]].tolist())
               for i in range(sz["co_llm"])]
    n_sig = len(sig["signals"])
    prefills = [0]
    prefill_prompts = engine.prefill_prompts

    def counted_prefill(*a, **kw):
        prefills[0] += 1
        return prefill_prompts(*a, **kw)
    engine.prefill_prompts = counted_prefill
    co_read, worst = {}, {k: 0.0 for k, _ in sig["tol"]}
    try:
        for policy in POLICIES:
            svc = sig["service"]()
            sched = CoScheduler(engine, svc, policy=policy)
            for rid, p in co_spec:
                sched.submit_llm(Request(rid=rid, prompt=p,
                                         max_new=sz["co_max_new"]))
            for j in range(sz["co_dsp"]):
                sched.submit_signal(SignalRequest(
                    rid=2000 + j, graph="speech_enhancement",
                    samples=sig["signals"][j % n_sig]))
            tick_counts = []
            t1 = time.perf_counter()
            while not sched.idle:
                flash_kernel.reset_launch_counts()
                sig["reset"]()
                b0, p0 = svc.stats["batches"], prefills[0]
                sched.tick()
                torch.cuda.synchronize()
                dsp_w, pre = svc.stats["batches"] - b0, prefills[0] - p0
                made = {**sig["counts"](), **flash_kernel.launch_counts()}
                want = {**{n: c * dsp_w for n, c in sig["per_wave"].items()},
                        **{n: c * pre for n, c in per_prefill.items()}}
                if made != want:
                    raise AssertionError(f"{policy} tick {sched.ticks}: "
                                         f"launches {made}, not {want}")
                tick_counts.append((dsp_w, pre))
            co_s = time.perf_counter() - t1
            llm, dsp = sched.llm_results, sched.dsp_results
            occ = sched.occupancy()
            if sorted(llm) != [r for r, _ in co_spec] or any(
                    len(v) != sz["co_max_new"] for v in llm.values()) \
                    or sorted(dsp) != [2000 + j
                                       for j in range(sz["co_dsp"])]:
                raise AssertionError(f"{policy}: work left undone")
            if not (occ["llm_cycles"] > 0 and occ["dsp_cycles"] > 0):
                raise AssertionError(f"{policy}: occupancy {occ}")
            for j in range(sz["co_dsp"]):
                want_j = sig["offline"][j % n_sig]
                for key, (rtol, atol) in sig["tol"]:
                    np.testing.assert_allclose(
                        dsp[2000 + j][key], want_j[key], rtol=rtol,
                        atol=atol, err_msg=f"{policy} request {j} {key}")
                    worst[key] = max(worst[key], float(np.abs(
                        dsp[2000 + j][key] - want_j[key]).max()))
            if policy == "round_robin":
                ref = engine.serve([Request(rid=r, prompt=p,
                                            max_new=sz["co_max_new"])
                                    for r, p in co_spec])
                if llm != ref:
                    raise AssertionError("round_robin's tokens are not "
                                         "engine.serve's")
            co_read[policy] = (sched.ticks, sched.ticks / co_s,
                               occ["dsp_share"], sum(p for _, p in
                                                     tick_counts),
                               sum(w for w, _ in tick_counts))
            print(f"(e) {policy}: {sz['co_llm']} LLM requests (prompts "
                  f"{co_lens.min()}-{co_lens.max()}, max_new "
                  f"{sz['co_max_new']}) and {sz['co_dsp']} Fig-9 requests "
                  f"done in {sched.ticks} ticks, {co_read[policy][3]} "
                  f"prefills, {co_read[policy][4]} DSP waves; every tick's "
                  f"launches = {sig['per_wave']} a DSP wave + {n_attn} flash "
                  f"a prefill; occupancy {occ}"
                  + ("; LLM tokens == engine.serve bit for bit"
                     if policy == "round_robin" else ""), flush=True)
        # latency_aware: an EDF script, one DSP request a wave
        svc = sig["service"](batch_size=1)
        sched = CoScheduler(engine, svc, policy="latency_aware")
        for rid, p in co_spec[:2]:
            sched.submit_llm(Request(rid=rid, prompt=p, max_new=4))
        for j, dl in enumerate(EDF_DEADLINES):
            sched.submit_signal(SignalRequest(
                rid=3000 + j, graph="speech_enhancement", deadline=dl,
                samples=sig["signals"][j % n_sig]))
        order = []
        while not sched.idle:
            sched.tick()
            order += [r for r in sched.dsp_results if r not in order]
        want_order = [3000 + j for j in np.argsort(EDF_DEADLINES)]
        if order != want_order or sorted(sched.llm_results) != [
                r for r, _ in co_spec[:2]]:
            raise AssertionError(f"latency_aware EDF order {order}, not "
                                 f"{want_order}")
        print(f"(e) latency_aware EDF script: deadlines {EDF_DEADLINES} "
              f"served in order {order}; DSP vs offline compile max abs err "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()),
              flush=True)
    finally:
        engine.prefill_prompts = prefill_prompts

    # (g) smoke readings
    with torch.no_grad():
        pre_ms = wall_ms(torch, lambda: engine.prefill_prompts(
            long_prompts, max_new), iters=3)
        by_name = []
        profile_forward(torch, lambda: engine.prefill_prompts(
            long_prompts, max_new), pre_ms, calls=1,
            label=f"{batch} x {sz['prompt_hi']} prefill", breakdown=by_name)
        busy = sum(t for t, _, _ in by_name)
        flash_us = sum(t for t, _, key in by_name if "flash" in key)
        logits, cache, _ = engine.prefill_prompts(long_prompts, max_new)
        cur = engine._sample(logits[:, -1], None)
        state = {"cache": cache}      # a step consumes the cache it is given

        def step():
            state["cache"] = engine._step(state["cache"], cur)[1]
        step_launches = profile_forward(
            torch, step, p50, calls=3, label=f"decode step (batch {batch})")
        del logits, cache, state
    print(f"(g) smoke readings, not metrics, on {smi}: prefill of {batch} x "
          f"{sz['prompt_hi']} tokens {pre_ms:.3f} ms wall, flash "
          + (f"{flash_us:.1f} of {busy:.1f} us device busy "
             f"({100 * flash_us / busy:.1f}%)" if busy else "not measured")
          + f"; p50 decode step at batch {batch} {p50:.3f} ms "
          f"({batch / p50 * 1e3:.1f} tokens/s; steps "
          f"{', '.join(f'{s:.2f}' for s in decode_ms)} ms), "
          f"{step_launches} device launches a step; co-serving ticks/s and "
          f"dsp_share: " + "; ".join(
              f"{p} {c[1]:.1f} ticks/s ({c[0]} ticks), dsp_share {c[2]:.4f}"
              for p, c in co_read.items())
          + f"; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B", flush=True)
    del engine, params
    torch.cuda.empty_cache()
    return row


# Phase 12: the other model families served at full width, one at a time,
# bf16, random weights drawn on the card from --seed.  Each row: config,
# its source, depth (None: uncut), requests, prompt lengths (lo, hi),
# max_new, batch.  grok-1 keeps 2 of its 64 layers: one layer's 8 experts
# are ~9.7 GB in bf16, so the whole model does not fit one card.
# recurrentgemma's longest prompt passes its 2048 window; xlstm's prompts
# stay short because its sLSTM layers run a Python loop over time.
FAMILIES = [
    ("qwen2-moe-a2.7b", "src/repro/configs/qwen2_moe_a2_7b.py", None, 16,
     256, 2048, 32, 8),
    ("grok-1-314b", "src/repro/configs/grok1_314b.py", 2, 8, 256, 2048, 16,
     8),
    ("recurrentgemma-2b", "src/repro/configs/recurrentgemma_2b.py", None, 8,
     256, 3072, 16, 4),
    ("xlstm-350m", "src/repro/configs/xlstm_350m.py", None, 8, 64, 512, 16,
     8),
    ("whisper-small", "src/repro/configs/whisper_small.py", None, 8, 16, 128,
     16, 8),
]
FAMILY_TF_SEQ = 512        # teacher-forcing tokens (at most the prompts')
FAMILY_TF_F32_REL_L2 = 1e-3  # teacher forcing on float32 weights; the
                             # five read <= 1.7e-5 on an H100 (PERF.md §2)


def _dicts(tree):
    """Every dict of a nested dict tree, outermost first."""
    yield tree
    for v in tree.values():
        if isinstance(v, dict):
            yield from _dicts(v)


def full_length_attention_calls(cfg) -> int:
    """The full-length attention calls (flash launches on the card) of one
    prefill: every attention layer of a decoder, and the encoder's and
    the decoder's self-attention layers of an encoder-decoder."""
    if cfg.input_kind == "encdec":
        return cfg.enc_layers + cfg.n_layers
    return sum(lt in ("global", "local") for lt in cfg.layer_types)


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs a call's mask lets through."""
    import numpy as np
    qi = np.arange(sq)
    hi = np.minimum(qi + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(qi - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.clip(hi - lo, 0, None).sum())


def serve_family(torch, np, spec, seed: int, smi: str) -> dict:
    """Phase 12 for one config of ``FAMILIES``: (a) the engine serves the
    requests, counted; (c) ``DecodeWave`` == ``generate``; (b) every
    flash call of one prefill against the plain version, one timed; (e)
    readings; (d) teacher forcing, last: it upcasts the weights in place.
    Returns the config's ``families``
    entry of the flash row."""
    import dataclasses
    import gc
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ref_attention
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models import get_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving import DecodeWave, Request, ServingEngine
    from repro_torch.tree import tree_leaves
    arch, src, depth, n_req, lo, hi, max_new, batch = spec
    t_start = time.perf_counter()
    cfg = get_config(arch)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    n_flash = full_length_attention_calls(cfg)
    per_prefill = {"flash_attention_hopper": n_flash,
                   "flash_split_kv_hopper": 0}
    none = {"flash_attention_hopper": 0, "flash_split_kv_hopper": 0}
    torch.cuda.reset_peak_memory_stats()
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(seed),
                         device="cuda")
    engine = ServingEngine(bundle, batch_size=batch, temperature=0.0)
    engine.load(params, device="cuda")
    torch.cuda.synchronize()
    p_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"{arch} ({src}): {cfg.n_layers} layers"
          + (f" (cut from {get_config(arch).n_layers})" if depth else "")
          + f" {sorted(set(cfg.layer_types))}"
          + (f" + encoder {cfg.enc_layers}" if cfg.enc_layers else "")
          + f", d {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads}, hd {cfg.head_dim}, d_ff {cfg.d_ff} "
          f"{cfg.mlp_kind}"
          + (f", {cfg.n_experts} experts top-{cfg.top_k} (+"
             f"{cfg.n_shared_experts} shared), capacity factor "
             f"{cfg.capacity_factor}" if cfg.n_experts else "")
          + f", vocab {cfg.vocab}, {cfg.dtype}; {p_bytes} B of params; "
          f"init and load {time.perf_counter() - t_start:.2f} s", flush=True)

    toks = TokenStream(vocab=cfg.vocab, seq_len=hi, global_batch=n_req,
                       seed=seed).batch_at(0)
    rng = np.random.default_rng(seed + 21)
    lens = rng.permutation(np.linspace(lo, hi, n_req).round().astype(int))
    reqs = [Request(rid=i, prompt=toks[i, :lens[i]].tolist(),
                    max_new=max_new) for i in range(n_req)]

    # (a) the main path, counted; MoE: the slots its prefills drop
    drops, plan = [], moe_mod.dispatch_plan

    def counted_plan(*a, **kw):
        pos, keep = plan(*a, **kw)
        drops.append(((~keep).sum(), keep.numel()))
        return pos, keep
    moe_mod.dispatch_plan = counted_plan
    try:
        flash_kernel.reset_launch_counts()
        t1 = time.perf_counter()
        served = engine.serve(reqs)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t1
        counts = flash_kernel.launch_counts()
    finally:
        moe_mod.dispatch_plan = plan
    waves = -(-n_req // batch)
    if counts != {k: v * waves for k, v in per_prefill.items()}:
        raise AssertionError(f"{arch}: serving {n_req} requests in {waves} "
                             f"waves launched {counts}, not {n_flash} flash "
                             f"launches a prefill")
    if sorted(served) != list(range(n_req)) or any(
            len(v) != max_new for v in served.values()):
        raise AssertionError(f"{arch}: a served request did not return "
                             f"exactly {max_new} tokens")
    dropped = (int(sum(int(d) for d, _ in drops)), sum(n for _, n in drops))
    print(f"(a) served {n_req} requests (prompts {lens.min()}-{lens.max()} "
          f"tokens, max_new {max_new}) at batch {batch} in {waves} waves, "
          f"{serve_s:.3f} s; launches {counts} ({n_flash} a prefill); every "
          f"request {max_new} tokens"
          + (f"; the prefills dropped {dropped[0]} of {dropped[1]} routed "
             f"slots" if cfg.n_experts else ""), flush=True)

    # (c) DecodeWave stepped to the end == generate's tokens
    flash_kernel.reset_launch_counts()
    wave = DecodeWave(engine, reqs[:batch])
    torch.cuda.synchronize()
    if flash_kernel.launch_counts() != per_prefill:
        raise AssertionError(f"{arch}: a DecodeWave prefill launched "
                             f"{flash_kernel.launch_counts()}")
    step_ms = []
    while not wave.done:
        flash_kernel.reset_launch_counts()
        t1 = time.perf_counter()
        wave.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if flash_kernel.launch_counts() != none:
            raise AssertionError(f"{arch}: a decode step launched "
                                 f"{flash_kernel.launch_counts()}")
    if wave.results() != {r.rid: served[r.rid] for r in reqs[:batch]}:
        raise AssertionError(f"{arch}: DecodeWave's tokens are not "
                             f"generate's")
    decode_ms = step_ms[:-1]              # the last step decodes nothing
    p50 = float(np.median(decode_ms))
    del wave
    print(f"(c) DecodeWave of the first {batch} requests == engine.serve's "
          f"tokens bit for bit; {n_flash} flash launches its prefill, 0 in "
          f"each of its {len(decode_ms)} decode steps", flush=True)

    # (b) every flash call of one prefill of the longest prompts
    long_prompts = [toks[i, :hi].tolist() for i in range(batch)]
    calls = record_calls(
        torch, lambda: engine.prefill_prompts(long_prompts, max_new),
        module="repro_torch.models.layers", names=("flash_attention",))
    if len(calls) != n_flash:
        raise AssertionError(f"{arch}: {len(calls)} flash_attention calls in "
                             f"a prefill, not {n_flash}")
    entry = {"config": arch, "source": src, "depth": cfg.n_layers,
             "depth_cut_from": get_config(arch).n_layers if depth else None,
             "launches": counts["flash_attention_hopper"],
             "launches_per_prefill": n_flash, "max_rel_l2": None,
             "max_abs_err": None, "shape": None, "ms": None,
             "bound_ms": None, "bound_by": None, "plain_ms": None,
             "sdpa_ms": None}
    if calls:
        worst_rel = worst_err = 0.0
        with torch.no_grad():
            for _, a in calls:
                kw = dict(causal=a["causal"], window=a["window"],
                          softcap=a["softcap"])
                got = flash_kernel.flash_attention_hopper(a["q"], a["k"],
                                                          a["v"], **kw)
                want = ref_attention(a["q"], a["k"], a["v"], **kw)
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{arch}: non-finite flash output")
                worst_rel = max(worst_rel, rel_l2(torch, got, want))
                worst_err = max(worst_err, float(
                    (got.float() - want.float()).abs().max()))
                del got, want
        if not worst_rel < ATTN_REL_L2:
            raise AssertionError(f"{arch}: a prefill's flash call is "
                                 f"{worst_rel:.3e} relative L2 from its "
                                 f"plain version")
        _, a = calls[0]
        q, k, v = a["q"], a["k"], a["v"]
        kw = dict(causal=a["causal"], window=a["window"],
                  softcap=a["softcap"])
        (b_, sq, h_, hd_), skv, kvh = q.shape, k.shape[1], k.shape[2]
        fa = flash_kernel.flash_attention_hopper
        with torch.no_grad():
            k_ms = device_ms(torch, lambda: fa(q, k, v, **kw), reps=3,
                             iters=3)
            p_ms = device_ms(torch, lambda: ref_attention(q, k, v, **kw),
                             reps=1, iters=2)
            l_ms = l_rel = None
            if not kw["softcap"]:
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                mask = None
                if kw["window"] and kw["window"] < skv:
                    qi = torch.arange(sq, device="cuda")[:, None]
                    ki = torch.arange(skv, device="cuda")[None, :]
                    mask = (ki > qi - kw["window"]) & (
                        (ki <= qi) if kw["causal"] else True)

                def sdpa():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask,
                        is_causal=kw["causal"] and mask is None,
                        enable_gqa=kvh < h_)
                l_rel = rel_l2(torch, sdpa().transpose(1, 2),
                               fa(q, k, v, **kw))
                if not l_rel < ATTN_REL_L2:
                    raise AssertionError(f"{arch}: SDPA and the kernel "
                                         f"differ: {l_rel:.3e}")
                l_ms = device_ms(torch, sdpa, reps=3, iters=3)
        flops = 4 * b_ * h_ * hd_ * visible_pairs(sq, skv, kw["causal"],
                                                  kw["window"])
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bnd = bound(nbytes, flops, BF16_FLOP_PER_S)
        shape = (f"q {tuple(q.shape)} k/v {tuple(k.shape)} causal "
                 f"{kw['causal']} window {kw['window']} softcap "
                 f"{kw['softcap']}")
        entry.update(max_rel_l2=worst_rel, max_abs_err=worst_err,
                     shape=shape, ms=k_ms, bound_ms=bnd[0],
                     bound_by="bytes" if bnd[1] >= bnd[2] else "operations",
                     plain_ms=p_ms, sdpa_ms=l_ms)
        print(f"(b) the {n_flash} flash_attention calls of a {batch} x {hi} "
              f"prefill vs the plain version: max abs err {worst_err:.3e}, "
              f"max relative L2 {worst_rel:.3e} (limit {ATTN_REL_L2}); the "
              f"first call ({shape}) on {smi}: kernel {k_ms * 1e3:.1f} us "
              f"({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms * 1e3:.1f} "
              f"us, bound {bnd[0] * 1e3:.1f} us ({entry['bound_by']}; "
              f"{100 * bnd[0] / k_ms:.1f}% of it), "
              + (f"F.scaled_dot_product_attention {l_ms * 1e3:.1f} us (rel "
                 f"L2 {l_rel:.3e} to the kernel)" if l_ms is not None else
                 "no SDPA call computes a softcap"), flush=True)
        del q, k, v
    else:
        print("(b) no full-length attention in this model: no flash call",
              flush=True)
    del calls

    # (e) smoke readings
    def prefill():
        return engine.prefill_prompts(long_prompts, max_new)
    with torch.no_grad():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(2):
            prefill()
        end.record()
        torch.cuda.synchronize()
        pre_ms = start.elapsed_time(end) / 2
        by_name = []
        pre_launches = profile_forward(
            torch, prefill, pre_ms, calls=1,
            label=f"{batch} x {hi} prefill", breakdown=by_name)
        busy = sum(t for t, _, _ in by_name)
        flash_us = sum(t for t, _, key in by_name if "flash" in key)
        logits, cache, _ = engine.prefill_prompts(long_prompts, max_new)
        cur = engine._sample(logits[:, -1], None)
        state = {"cache": cache}      # a step consumes the cache it is given

        def step():
            state["cache"] = engine._step(state["cache"], cur)[1]
        step_launches = profile_forward(
            torch, step, p50, calls=3, label=f"decode step (batch {batch})")
        del logits, cache, state
    peak = torch.cuda.max_memory_allocated()
    print(f"(e) smoke readings, not metrics, on {smi}: {p_bytes} B of "
          f"params; prefill of {batch} x {hi} tokens {pre_ms:.3f} ms wall, "
          f"{pre_launches} device launches"
          + (f" ({pre_launches / hi:.1f} a prompt position)"
             if pre_launches else "")
          + ", flash "
          + (f"{flash_us:.1f} of {busy:.1f} us device busy "
             f"({100 * flash_us / busy:.1f}%)" if busy else "not measured")
          + f"; p50 decode step at batch {batch} {p50:.3f} ms "
          f"({batch / p50 * 1e3:.1f} tokens/s), {step_launches} device "
          f"launches a step; max_memory_allocated {peak} B", flush=True)

    # (d) teacher forcing: a prefill of S - 1 tokens and one decode step
    # against forward_train (MoE at a capacity no slot overflows, where
    # the capacity path and the decode step's dense path compute one
    # function).  Held on the weights upcast to float32: in bf16 the
    # decode step rounds other GEMM shapes and forms (the recurrent
    # families' one-rounding conv einsum and bf16-rounded carried state,
    # MoE's dense combine) than the forward, as the JAX package's does,
    # and a near-tie in MoE routing then picks other experts; the bf16
    # reading and its routing flips are printed beside it (PERF.md §2).
    tf_cfg = cfg
    if cfg.n_experts:
        tf_cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                     / cfg.top_k)
    n_tf = min(FAMILY_TF_SEQ, hi)
    tf = torch.as_tensor(toks[:2, :n_tf], device="cuda")
    extra = {}
    if cfg.input_kind == "encdec":
        extra["embeds"] = torch.zeros((2, cfg.enc_seq, cfg.d_model),
                                      device="cuda")

    def teacher_forcing(run_cfg, run_params):
        """(relative L2 at position -2, at -1, MoE layers whose top-k
        set for the last token differs between the forward and the
        decode step)."""
        b_, route, picks = get_model(run_cfg), moe_mod.route, []

        def recorded(*a, **kw):
            out = route(*a, **kw)
            picks.append(out[2][:, -1].sort(-1).values)
            return out
        moe_mod.route = recorded
        try:
            with torch.no_grad():
                full, _ = b_.forward(run_params, {"tokens": tf, **extra})
                n_fwd = len(picks)
                lp, cache = b_.prefill(run_params,
                                       {"tokens": tf[:, :-1], **extra},
                                       max_len=n_tf + 2)
                del picks[n_fwd:]
                ld, _ = b_.decode_step(run_params, cache,
                                       {"tokens": tf[:, -1:]})
        finally:
            moe_mod.route = route
        flips = sum(not torch.equal(f, d) for f, d in
                    zip(picks[:n_fwd], picks[n_fwd:]))
        return (rel_l2(torch, lp[:, -1], full[:, -2]),
                rel_l2(torch, ld[:, -1], full[:, -1]), flips)
    tf_read = {"bfloat16": teacher_forcing(tf_cfg, params)}
    del engine
    for leaves in _dicts(params):         # upcast in place, leaf by leaf
        for k in list(leaves):
            if isinstance(leaves[k], torch.Tensor):
                leaves[k] = leaves[k].float()
    gc.collect()
    torch.cuda.empty_cache()
    tf_read["float32"] = teacher_forcing(
        dataclasses.replace(tf_cfg, dtype="float32"), params)
    tf_rel = tf_read["float32"][:2]
    print(f"(d) teacher forcing, 2 x {n_tf} tokens"
          + (f" (capacity factor {tf_cfg.capacity_factor})"
             if cfg.n_experts else "")
          + ": prefill of S - 1 vs forward_train at position -2, one "
          "decode_step vs position -1, relative L2: "
          + "; ".join(f"{dt} {r[0]:.3e}, {r[1]:.3e}"
                      + (f", {r[2]} of {cfg.n_layers} MoE layers route the "
                         f"last token to other experts" if cfg.n_experts
                         else "")
                      + (f" (held, limit {FAMILY_TF_F32_REL_L2})"
                         if dt == "float32" else " (not held)")
                      for dt, r in tf_read.items())
          + f"; phase wall {time.perf_counter() - t_start:.1f} s",
          flush=True)
    if not max(tf_rel) < FAMILY_TF_F32_REL_L2:
        raise AssertionError(f"{arch}: teacher forcing (float32): relative "
                             f"L2 {tf_rel}")
    entry.update(param_bytes=p_bytes, prefill_ms=pre_ms,
                 prefill_launches=pre_launches,
                 prefill_flash_share=flash_us / busy if busy else None,
                 decode_p50_ms=p50, decode_launches=step_launches,
                 teacher_forcing_rel_l2={k: list(v[:2])
                                         for k, v in tf_read.items()},
                 moe_routing_flips_bf16=tf_read["bfloat16"][2]
                 if cfg.n_experts else None, peak_bytes=peak,
                 dropped_slots=list(dropped) if cfg.n_experts else None)
    del params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return entry


# The LM training phase (13): starcoder2-3b at full width and depth through
# the port's training stack, then examples/train_e2e.py's recipe.
TRAIN_ARCH, TRAIN_SRC = LM_ARCH, LM_SRC
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS_LM = 2048, 8, 20
TRAIN_LR = (3e-4, 5, 20)          # cosine_schedule(base, warmup, total)
TRAIN_DROP = 0.3                  # examples/train_e2e.py: last < first - 0.3
TRAIN_PROFILE_STEP = 12           # the step traced by torch.profiler
ROUTE_REL = 1e-2                  # held-out loss, flash vs direct: phase 8's
#                                   bf16 limit
# examples/train_e2e.py's recipe: starcoder2-3b reduced to d 768, 8 layers,
# 12 heads, d_ff 3072, vocab 8192 (float32, as reduced() makes it), seq 256,
# batch 8, microbatch 2, remat, 200 steps, cosine_schedule(3e-4, 20, 200),
# Checkpointer(keep=2) every 50 steps; a second run fails hard at step 120
# (3 failures against max_retries 2) and must restore step 100
E2E = {"n_layers": 8, "d_model": 768, "n_heads": 12, "d_ff": 3072,
       "vocab": 8192, "seq": 256, "batch": 8, "microbatch": 2,
       "steps": 200, "ckpt_every": 50, "crash_at": 120, "keep": 2}
E2E_TRAJ_RTOL = 1e-6              # the JAX package's crash-restart limit


def all_launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    from repro_torch import kernels as K
    from repro_torch.kernels import bitserial_mm as bsm
    from repro_torch.kernels.fft_stage import kernel as fft_kernel
    from repro_torch.kernels.fir_conv import kernel as fir_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.shuffle_gemm import launch_counts
    return {**launch_counts(), **bsm.launch_counts(),
            **fft_kernel.launch_counts(), **fir_kernel.launch_counts(),
            **flash_kernel.launch_counts(),
            "compiled_supported": K.compiled_supported.launches}


def kernel_kinds(by_name) -> dict:
    """Device ms by kind of kernel, from ``(us, calls, name)`` entries:
    float32 GEMMs outside tensor cores (cuBLAS ``f32f32`` FFMA kernels:
    the direct attention's einsums), other GEMMs, softmax, and the rest
    (elementwise kernels, reductions, copies)."""
    kinds = {"float32 FFMA GEMMs": 0.0, "other GEMMs": 0.0, "softmax": 0.0,
             "elementwise, reductions, copies": 0.0}
    for us, _, name in by_name:
        low = name.lower()
        kind = ("float32 FFMA GEMMs" if "f32f32" in low and "gemm" in low
                else "other GEMMs" if "gemm" in low or "nvjet" in low
                else "softmax" if "softmax" in low
                else "elementwise, reductions, copies")
        kinds[kind] += us / 1e3
    return kinds


def launched() -> dict:
    """The kernels launched since the counts were last reset."""
    return {k: v for k, v in all_launch_counts().items() if v}


def reset_all_launch_counts() -> None:
    from repro_torch import kernels as K
    from repro_torch.kernels import bitserial_mm as bsm
    from repro_torch.kernels.fft_stage import kernel as fft_kernel
    from repro_torch.kernels.fir_conv import kernel as fir_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.shuffle_gemm import reset_launch_counts
    for reset in (reset_launch_counts, bsm.reset_launch_counts,
                  fft_kernel.reset_launch_counts,
                  fir_kernel.reset_launch_counts,
                  flash_kernel.reset_launch_counts):
        reset()
    K.compiled_supported.launches = 0


def lm_train_phase(torch, np, seed: int, smi: str) -> dict:
    """Phase 13.  (a) starcoder2-3b at full width and depth (bf16, its
    ``microbatch`` 4 and ``remat``) trained 20 steps through
    ``make_batch_iterator`` -> ``make_train_step`` -> ``TrainLoop``:
    every loss and gradient norm finite, no kernel launched in any step,
    the mean of the last 5 losses under the first 5's minus 0.3; the p50
    step time, one step's device busy share and launches
    (``torch.profiler``) and the peak memory.  (b) The held-out loss at
    the final params on the flash kernel (``torch.no_grad()``: exactly one
    launch a layer) against the same loss with autograd recording (the
    direct route, no launch), relative 1e-2.  (c) ``examples/train_e2e.py``'s
    recipe on the port, run whole and again with a hard failure at step
    120, whose last 5 losses must equal the whole run's at rtol 1e-6.
    Returns the flash row's training entry for the kernel JSON."""
    import signal
    # TrainLoop installs a SIGTERM handler (preemption); the script keeps
    # its own for the other phases
    sigterm = signal.getsignal(signal.SIGTERM)
    try:
        return _lm_train(torch, np, seed, smi)
    finally:
        signal.signal(signal.SIGTERM, sigterm)


def _lm_train(torch, np, seed: int, smi: str) -> dict:
    import dataclasses
    import gc
    import shutil
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_batch_iterator
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.runtime import TrainLoop
    from repro_torch.tree import tree_leaves, tree_map

    # (a) full width and depth, the config's own microbatch and remat
    cfg = get_config(TRAIN_ARCH)
    n_attn = sum(lt in ("global", "local") for lt in cfg.layer_types)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = get_model(cfg)
    params, opt = init_train_state(
        bundle, torch.Generator(device="cuda").manual_seed(seed),
        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"(a) {TRAIN_ARCH} ({TRAIN_SRC}): {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, hd "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype};"
          f" {n_params} params; microbatch {cfg.microbatch}, remat "
          f"{cfg.remat}; batch {TRAIN_BATCH} x {TRAIN_SEQ} from TokenStream"
          f"(seed {seed}); cosine_schedule{TRAIN_LR}; init "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated()} B allocated", flush=True)
    stream = TokenStream(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, seed=seed)
    step = make_train_step(bundle, cosine_schedule(*TRAIN_LR))
    step_s, step_counts, gnorms, lrs = [], [], [], []
    prof_box = {}

    def counted_step(p, o, b):
        """The train step, timed, its launches read, one step traced."""
        reset_all_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if len(step_s) == TRAIN_PROFILE_STEP:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = step(p, o, b)
                torch.cuda.synchronize()
            prof_box["prof"] = prof
        else:
            out = step(p, o, b)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        step_counts.append(launched())
        gnorms.append(float(out[2]["grad_norm"]))
        lrs.append(out[2]["lr"])
        return out

    ck_dir = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(ck_dir, ignore_errors=True)
    loop = TrainLoop(counted_step,
                     lambda s: make_batch_iterator(stream, start_step=s,
                                                   device="cuda"),
                     Checkpointer(os.path.join(ck_dir, "full")),
                     ckpt_every=10 ** 9)
    t1 = time.perf_counter()
    out = loop.run(params, opt, n_steps=TRAIN_STEPS_LM)
    train_s = time.perf_counter() - t1
    hist = out["history"]
    params, opt = out["params"], out["opt_state"]
    peak = torch.cuda.max_memory_allocated()
    print("losses " + " ".join(f"{x:.4f}" for x in hist))
    print("grad norms " + " ".join(f"{x:.4f}" for x in gnorms))
    if len(hist) != TRAIN_STEPS_LM or opt.step != TRAIN_STEPS_LM:
        raise AssertionError(f"{len(hist)} losses, optimizer step "
                             f"{opt.step}; want {TRAIN_STEPS_LM}")
    if not all(np.isfinite(hist)) or not all(np.isfinite(gnorms)):
        raise AssertionError("a loss or gradient norm is not finite")
    if any(step_counts):
        raise AssertionError(f"a training step launched kernels: "
                             f"{step_counts}")
    first, last = float(np.mean(hist[:5])), float(np.mean(hist[-5:]))
    if not last < first - TRAIN_DROP:
        raise AssertionError(f"loss first-5 {first:.4f} -> last-5 "
                             f"{last:.4f}: did not fall by {TRAIN_DROP}")
    steady = sorted(step_s[1:])
    p50 = steady[len(steady) // 2] * 1e3
    prof = prof_box["prof"]
    by_name = [(e.self_device_time_total, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(t for t, _, _ in by_name)
    launches = sum(c for _, c, _ in by_name)
    prof_ms = step_s[TRAIN_PROFILE_STEP] * 1e3
    by_name.sort(reverse=True)
    print(f"(a) {TRAIN_STEPS_LM} steps in {train_s:.1f} s: first step "
          f"{step_s[0] * 1e3:.1f} ms, p50 of the rest {p50:.1f} ms "
          f"({TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:.0f} tokens/s); no kernel "
          f"launch (flash_attention_hopper 0) in any of the "
          f"{TRAIN_STEPS_LM} steps; loss first-5 {first:.4f} "
          f"-> last-5 {last:.4f} (falls {first - last:.4f} > "
          f"{TRAIN_DROP}); peak memory {peak} B; {smi}", flush=True)
    if busy_us:
        print(f"profile of step {TRAIN_PROFILE_STEP}: device busy "
              f"{busy_us / 1e3:.1f} ms of {prof_ms:.1f} ms wall (traced; "
              f"{100 * busy_us / 1e3 / prof_ms:.1f}% busy; "
              f"{100 * busy_us / 1e3 / p50:.1f}% of the p50 step), "
              f"{launches} kernels and copies")
        for t, c, key in by_name[:12]:
            print(f"  {t / 1e3:9.2f} ms  {c:6d} calls  {key[:90]}")
        print("  by kind: " + "; ".join(
            f"{kind} {ms:.1f} ms ({100 * ms * 1e3 / busy_us:.1f}%)"
            for kind, ms in kernel_kinds(by_name).items()))
    else:
        print("profile: the profiler recorded no device time; busy share "
              "not measured")
    del loop, out, step
    gc.collect()

    # (b) held-out loss at the final params: flash route vs direct route
    held = {"tokens": torch.as_tensor(stream.batch_at(10 ** 6),
                                      device="cuda")}
    reset_all_launch_counts()
    with torch.no_grad():
        flash_loss = float(bundle.loss_fn(params, held)[0])
    torch.cuda.synchronize()
    flash_counts = launched()
    want = {"flash_attention_hopper": n_attn}
    if flash_counts != want:
        raise AssertionError(f"held-out loss under no_grad launched "
                             f"{flash_counts}, not {want}")
    reset_all_launch_counts()
    live = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(live)
    direct_loss = float(bundle.loss_fn(tree_map(lambda _: next(it), params),
                                       held)[0].detach())
    torch.cuda.synchronize()
    direct_counts = launched()
    del live
    rel = abs(flash_loss - direct_loss) / abs(direct_loss)
    print(f"(b) held-out loss (TokenStream step 10**6, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}) at the final params: flash route (no_grad) "
          f"{flash_loss:.6f}, launches {flash_counts}; direct route (grad "
          f"recorded) {direct_loss:.6f}, launches {direct_counts or 0}; "
          f"relative difference {rel:.3e} (limit {ROUTE_REL})", flush=True)
    if direct_counts or not rel < ROUTE_REL:
        raise AssertionError("the two attention routes disagree")
    del params, opt, bundle, held
    gc.collect()
    torch.cuda.empty_cache()

    # (c) examples/train_e2e.py's recipe, whole and with a crash at 120
    e2e_cfg = dataclasses.replace(get_config(TRAIN_ARCH).reduced(
        n_layers=E2E["n_layers"], d_model=E2E["d_model"],
        n_heads=E2E["n_heads"], d_ff=E2E["d_ff"], vocab=E2E["vocab"]),
        microbatch=E2E["microbatch"], remat=True)
    e2e_bundle = get_model(e2e_cfg)
    e2e_stream = TokenStream(vocab=e2e_cfg.vocab, seq_len=E2E["seq"],
                             global_batch=E2E["batch"], seed=seed)

    def e2e_run(name, crash_at):
        params_, opt_ = init_train_state(
            e2e_bundle, torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")
        fails = {"n": 0}

        def injector(s, attempt):
            if s == crash_at and fails["n"] < 3:
                fails["n"] += 1
                raise RuntimeError("injected failure")
        loop_ = TrainLoop(
            make_train_step(e2e_bundle,
                            cosine_schedule(3e-4, 20, E2E["steps"])),
            lambda s: make_batch_iterator(e2e_stream, start_step=s,
                                          device="cuda"),
            Checkpointer(os.path.join(ck_dir, name), keep=E2E["keep"]),
            ckpt_every=E2E["ckpt_every"])
        reset_all_launch_counts()
        t_ = time.perf_counter()
        res = loop_.run(params_, opt_, n_steps=E2E["steps"],
                        fail_injector=injector if crash_at >= 0 else None)
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t_
        res["launches"] = launched()
        res["fails"] = fails["n"]
        return res

    whole = e2e_run("whole", -1)
    n_e2e = sum(t.numel() for t in tree_leaves(whole["params"]))
    e2e_hist = whole["history"]
    k = max(5, len(e2e_hist) // 20)
    e2e_first, e2e_last = (float(np.mean(e2e_hist[:k])),
                           float(np.mean(e2e_hist[-k:])))
    print(f"(c) train_e2e recipe: {e2e_cfg.n_layers} layers, d "
          f"{e2e_cfg.d_model}, {e2e_cfg.n_heads} heads, d_ff {e2e_cfg.d_ff},"
          f" vocab {e2e_cfg.vocab}, {e2e_cfg.dtype}, {n_e2e} params; "
          f"{E2E['steps']} steps in {whole['seconds']:.1f} s "
          f"({whole['seconds'] / E2E['steps'] * 1e3:.1f} ms a step with "
          f"checkpoints); launches {whole['launches'] or 0}; loss first-{k} "
          f"{e2e_first:.4f} -> last-{k} {e2e_last:.4f}; stragglers "
          f"{len(whole['stragglers'])}", flush=True)
    if whole["launches"] or not e2e_last < e2e_first - TRAIN_DROP:
        raise AssertionError("train_e2e recipe: the loss did not fall by "
                             f"{TRAIN_DROP} or a kernel launched")
    crashed = e2e_run("crash", E2E["crash_at"])
    a, b = np.array(crashed["history"][-5:]), np.array(e2e_hist[-5:])
    bit_equal = bool(np.array_equal(a, b)) and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(crashed["params"]),
                                          tree_leaves(whole["params"])))
    print(f"(c) crash at step {E2E['crash_at']}: {crashed['fails']} "
          f"failures (max_retries 2), {len(crashed['history'])} steps run "
          f"(restored step {E2E['crash_at'] // E2E['ckpt_every'] * E2E['ckpt_every']}), "
          f"{crashed['seconds']:.1f} s; last 5 losses "
          + " ".join(f"{x:.6f}" for x in a) + " vs whole "
          + " ".join(f"{x:.6f}" for x in b)
          + f"; max relative difference "
          f"{float(np.max(np.abs(a - b) / np.abs(b))):.3e} (limit "
          f"{E2E_TRAJ_RTOL}); bit-equal losses and params: {bit_equal}",
          flush=True)
    want_steps = E2E["steps"] + E2E["crash_at"] % E2E["ckpt_every"]
    if crashed["fails"] != 3 or len(crashed["history"]) != want_steps:
        raise AssertionError(f"the crash run made {crashed['fails']} "
                             f"failures and {len(crashed['history'])} steps,"
                             f" not 3 and {want_steps}")
    np.testing.assert_allclose(a, b, rtol=E2E_TRAJ_RTOL)
    shutil.rmtree(ck_dir, ignore_errors=True)
    del whole, crashed
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches_per_step": 0, "steps": TRAIN_STEPS_LM,
            "held_out_launches": flash_counts["flash_attention_hopper"],
            "held_out_rel_diff": rel, "step_p50_ms": p50,
            "busy_share": busy_us / 1e3 / p50 if busy_us else None,
            "device_launches_per_step": launches if busy_us else None,
            "peak_bytes": peak, "loss_first5": first, "loss_last5": last,
            "e2e_bit_equal": bit_equal,
            "per": "starcoder2-3b trained at full width: the training step "
                   "runs no kernel; the held-out loss under no_grad runs "
                   "one flash call a layer"}


# Phase 17: every other model family trained at full width on the card,
# phase 13 (a)-(b) for each, one model at a time, then the train CLI.
# (arch, source, layers kept (None: uncut), batch, seq, steps).  State is
# 16 B a param (bf16 param and gradient, float32 accumulator and two
# moments): qwen2-moe-a2.7b uncut is 14.3e9 params, ~229 GB, so it keeps
# 4 of its 24 layers (2.91e9, ~46.5 GB); recurrentgemma-2b uncut is
# 3.55e9, ~56.8 GB, at the local layers' full 2048 window: 8 rows peak
# at 66.2-67.3 GB on an H100, which would leave under 4 GB of the card
# beside the 13.8 GB of 16b's processes' contexts (they trace
# meanwhile), so it takes 4 rows.
# xlstm-350m's sLSTM is a Python loop over time (~25 ops a step, 3
# layers, forward, remat and backward, 4 microbatches): on an H100 a step
# of 8 x 128 took 6.9 s in ~0.2M kernels, and its loss fell by 0.3 only
# once the schedule's summed learning rate passed ~3e-3 (8 x 512 fell
# 0.11 in 10 steps, 8 x 64 0.20 in 24, noisier), ~24 steps, ~166 s at 24
# layers; so it keeps one pattern group, 8 layers (7 mLSTM, 1 sLSTM; 2.35
# s a step).  whisper-small's decoder takes its own 448-token context
# over 1500 encoder frames.  grok-1-314b is not trained here: one layer
# alone is 4.92e9 params; the dry-run's two train_4k cells hold its step
# (16b).
FAMILY_TRAIN = [
    ("qwen2-moe-a2.7b", "src/repro/configs/qwen2_moe_a2_7b.py", 4, 8, 2048,
     10),
    ("recurrentgemma-2b", "src/repro/configs/recurrentgemma_2b.py", None, 4,
     2048, 10),
    ("xlstm-350m", "src/repro/configs/xlstm_350m.py", 8, 8, 128, 24),
    ("whisper-small", "src/repro/configs/whisper_small.py", None, 8, 448,
     10),
]
FAMILY_TRAIN_LR = (3e-4, 3)        # cosine_schedule(base, warmup, steps)
FAMILY_TRAIN_EDGE = 3              # last-3 mean under first-3 minus the drop
FAMILY_TRAIN_PROFILE_STEP = 6      # the step traced by torch.profiler
FAMILY_TRAIN_BUDGET_S = 300        # the phase's own seconds, CLI included,
#                                    printed beside them (the script's
#                                    1200 s is the limit)
# the train CLI's docstring arguments (a reduced config, as the JAX
# package's CLI trains)
TRAIN_CLI = ["--arch", "xlstm-350m", "--steps", "50", "--seq", "128",
             "--batch", "8"]


class EncDecStream:
    """A Whisper batch a step: ``TokenStream`` 's decoder tokens and seeded
    unit-normal encoder frames, ``{"tokens": (B, S), "embeds": (B,
    enc_seq, d_model)}`` (float32; the encoder casts them to the weight
    dtype), each a pure function of ``(seed, step)``."""

    def __init__(self, tokens, enc_seq: int, d_model: int, seed: int):
        self.tokens, self.enc_seq, self.d_model = tokens, enc_seq, d_model
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        import numpy as np
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 11]))
        tokens = self.tokens.batch_at(step)
        return {"tokens": tokens, "embeds": rng.standard_normal(
            (tokens.shape[0], self.enc_seq, self.d_model)).astype(
                np.float32)}


def family_stream(cfg, batch: int, seq: int, seed: int):
    """The batches a family trains on: token ids from ``TokenStream``,
    with encoder frames beside them for an encoder-decoder."""
    from repro_torch.data import TokenStream
    tokens = TokenStream(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                         seed=seed)
    if cfg.input_kind == "encdec":
        return EncDecStream(tokens, cfg.enc_seq, cfg.d_model, seed)
    return tokens


def family_train_run(torch, np, cfg, batch: int, seq: int, steps: int,
                     seed: int, device: str, ck_dir: str,
                     profile_step=None) -> dict:
    """Phase 17's per-model body, on ``device`` (the CPU tests run it at
    ``reduced()`` width): params drawn from ``seed`` on the device,
    ``make_batch_iterator(family_stream(...))`` -> ``make_train_step(
    cosine_schedule(FAMILY_TRAIN_LR..., steps))`` -> ``TrainLoop`` for
    ``steps`` steps.  Returns the final params and moments, the losses,
    gradient norms and learning rates, each step's seconds and launches,
    the first batch's keys and shapes, the MoE slots each step dropped
    (``(dropped, routed)``, forward passes only: remat's recompute
    routes the same slots again), the init seconds and, with
    ``profile_step``, a ``torch.profiler`` trace of that step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models import get_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.runtime import TrainLoop
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params, opt = init_train_state(bundle, gen, device=device)
    sync()
    init_s = time.perf_counter() - t0
    stream = family_stream(cfg, batch, seq, seed)
    step = make_train_step(bundle, cosine_schedule(*FAMILY_TRAIN_LR, steps))
    out = {"step_s": [], "launches": [], "grad_norms": [], "lrs": [],
           "drops": [], "init_s": init_s, "prof": None}
    drops, plan = [], moe_mod.dispatch_plan

    def counted_plan(*a, **kw):
        pos, keep = plan(*a, **kw)
        if torch._C._current_autograd_node() is None:
            drops.append(((~keep).sum(), keep.numel()))
        return pos, keep

    def counted_step(p, o, b):
        """The train step, timed, its launches and MoE drops read, one
        step traced."""
        if "batch_keys" not in out:
            out["batch_keys"] = {k: tuple(v.shape) for k, v in b.items()}
        reset_all_launch_counts()
        drops.clear()
        sync()
        t1 = time.perf_counter()
        if len(out["step_s"]) == profile_step:
            # the device's activity only: the host ops' events of an
            # xlstm-350m step (~0.2M kernels) take minutes to tabulate
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                res = step(p, o, b)
                sync()
            out["prof"] = prof
        else:
            res = step(p, o, b)
        sync()
        out["step_s"].append(time.perf_counter() - t1)
        out["launches"].append(launched())
        out["grad_norms"].append(float(res[2]["grad_norm"]))
        out["lrs"].append(res[2]["lr"])
        out["drops"].append((int(sum(int(d) for d, _ in drops)),
                             sum(n for _, n in drops)))
        return res

    loop = TrainLoop(counted_step,
                     lambda s: make_batch_iterator(stream, start_step=s,
                                                   device=device),
                     Checkpointer(ck_dir), ckpt_every=10 ** 9)
    moe_mod.dispatch_plan = counted_plan
    try:
        res = loop.run(params, opt, n_steps=steps)
    finally:
        moe_mod.dispatch_plan = plan
    out.update(bundle=bundle, stream=stream, params=res["params"],
               opt=res["opt_state"], history=res["history"])
    return out


def train_family(torch, np, spec, seed: int, smi: str) -> dict:
    """Phase 17 for one config of ``FAMILY_TRAIN``: (a) its steps, read,
    then checked; (c) smoke readings; (b) the held-out loss on the flash
    kernel against the direct route.  Returns its ``family_train`` entry
    of the flash row."""
    import dataclasses
    import gc
    import shutil
    from torch.autograd import DeviceType
    from repro_torch.configs import get_config
    from repro_torch.tree import tree_leaves, tree_map
    arch, src, depth, batch, seq, steps = spec
    cfg = get_config(arch)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    n_flash = full_length_attention_calls(cfg)
    ck_dir = os.path.join(ROOT, "build", "chip_smoke_family_train", arch)
    shutil.rmtree(ck_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    run = family_train_run(torch, np, cfg, batch, seq, steps, seed, "cuda",
                           ck_dir, FAMILY_TRAIN_PROFILE_STEP)
    train_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated()
    params, opt, bundle = run["params"], run["opt"], run["bundle"]
    hist, gnorms = run["history"], run["grad_norms"]
    n_params = sum(t.numel() for t in tree_leaves(params))
    p_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    e = FAMILY_TRAIN_EDGE
    first, last = float(np.mean(hist[:e])), float(np.mean(hist[-e:]))
    steady = sorted(run["step_s"][1:])
    p50 = steady[len(steady) // 2] * 1e3
    tok_s = batch * seq / p50 * 1e3
    print(f"(a) {arch} ({src}): {cfg.n_layers} layers"
          + (f" (cut from {get_config(arch).n_layers})" if depth else "")
          + (f" + encoder {cfg.enc_layers}" if cfg.enc_layers else "")
          + f", d {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}; {n_params}"
          f" params, {p_bytes} B; microbatch {cfg.microbatch}, remat "
          f"{cfg.remat}; batch {batch} x {seq} {run['batch_keys']}; "
          f"cosine_schedule{FAMILY_TRAIN_LR + (steps,)}; init "
          f"{run['init_s']:.2f} s", flush=True)
    print("    losses " + " ".join(f"{x:.4f}" for x in hist))
    print("    grad norms " + " ".join(f"{x:.4f}" for x in gnorms))
    print(f"(a) {steps} steps in {train_s:.1f} s with the init: first "
          f"step {run['step_s'][0] * 1e3:.1f} ms, p50 of the rest "
          f"{p50:.1f} ms ({tok_s:.0f} tokens/s); launches a step "
          f"{[c or 0 for c in run['launches']]}; loss first-{e} "
          f"{first:.4f} -> last-{e} {last:.4f} (falls {first - last:.4f},"
          f" limit {TRAIN_DROP})"
          + (f"; routed slots dropped a step at capacity factor "
             f"{cfg.capacity_factor}: "
             + ", ".join(f"{d}/{n}" for d, n in run["drops"])
             if cfg.n_experts else "")
          + f"; peak memory {peak} B; {smi}", flush=True)
    if len(hist) != steps or opt.step != steps:
        raise AssertionError(f"{arch}: {len(hist)} losses, optimizer step "
                             f"{opt.step}; want {steps}")
    if not all(np.isfinite(hist)) or not all(np.isfinite(gnorms)):
        raise AssertionError(f"{arch}: a loss or gradient norm is not "
                             f"finite")
    if any(run["launches"]):
        raise AssertionError(f"{arch}: a training step launched kernels")
    if cfg.input_kind == "encdec" and "embeds" not in run["batch_keys"]:
        raise AssertionError(f"{arch}: its batches hold no embeds")
    if not last < first - TRAIN_DROP:
        raise AssertionError(f"{arch}: the loss did not fall by "
                             f"{TRAIN_DROP}")
    prof = run.pop("prof")
    by_name = [(ev.self_device_time_total, ev.count, ev.key)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
    busy_us = sum(t for t, _, _ in by_name)
    launches = sum(c for _, c, _ in by_name)
    prof_ms = run["step_s"][FAMILY_TRAIN_PROFILE_STEP] * 1e3
    kinds = kernel_kinds(by_name)
    del prof
    if busy_us:
        print(f"(c) smoke readings, not metrics: profile of step "
              f"{FAMILY_TRAIN_PROFILE_STEP}: device busy "
              f"{busy_us / 1e3:.1f} ms of {prof_ms:.1f} ms wall (traced; "
              f"{100 * busy_us / 1e3 / prof_ms:.1f}% busy; "
              f"{100 * busy_us / 1e3 / p50:.1f}% of the p50 step), "
              f"{launches} kernels and copies; by kind: " + "; ".join(
                  f"{kind} {ms:.1f} ms" for kind, ms in kinds.items()),
              flush=True)
    else:
        print("(c) profile: the profiler recorded no device time; busy "
              "share not measured", flush=True)

    # (b) held-out loss at the final params, one microbatch's rows (the
    # direct route's activations for the whole batch would not fit beside
    # recurrentgemma-2b's 256000-row logits): flash route vs direct route
    del opt, run["opt"]
    gc.collect()
    torch.cuda.empty_cache()
    rows = batch // cfg.microbatch
    raw = family_stream(cfg, batch, seq, seed).batch_at(10 ** 6)
    if isinstance(raw, np.ndarray):
        raw = {"tokens": raw}
    held = {k: torch.as_tensor(v[:rows], device="cuda")
            for k, v in raw.items()}
    reset_all_launch_counts()
    with torch.no_grad():
        flash_loss = float(bundle.loss_fn(params, held)[0])
    torch.cuda.synchronize()
    flash_counts = launched()
    reset_all_launch_counts()
    live = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(live)
    direct_loss = float(bundle.loss_fn(tree_map(lambda _: next(it), params),
                                       held)[0].detach())
    torch.cuda.synchronize()
    direct_counts = launched()
    del live
    rel = abs(flash_loss - direct_loss) / abs(direct_loss)
    print(f"(b) held-out loss (step 10**6, {rows} x {seq}) at the final "
          f"params: flash route (no_grad) {flash_loss:.6f}, launches "
          f"{flash_counts or 0} ({n_flash} full-length attention layers); "
          f"direct route (grad recorded) {direct_loss:.6f}, launches "
          f"{direct_counts or 0}; relative difference {rel:.3e} (limit "
          f"{ROUTE_REL}); {time.perf_counter() - t_start:.1f} s for the "
          f"model", flush=True)
    want = {"flash_attention_hopper": n_flash} if n_flash else {}
    if flash_counts != want:
        raise AssertionError(f"{arch}: held-out loss under no_grad launched "
                             f"{flash_counts}, not {want}")
    if direct_counts or not rel < ROUTE_REL:
        raise AssertionError(f"{arch}: the two attention routes disagree")
    shutil.rmtree(ck_dir, ignore_errors=True)
    return {"config": arch, "source": src, "depth": cfg.n_layers,
            "depth_cut_from": get_config(arch).n_layers if depth else None,
            "batch": batch, "seq": seq, "steps": steps,
            "n_params": n_params, "param_bytes": p_bytes,
            "init_s": run["init_s"], "launches_per_step": 0,
            "held_out_launches": flash_counts.get("flash_attention_hopper",
                                                  0),
            "held_out_rel_diff": rel, "step_p50_ms": p50,
            "tokens_per_s": tok_s,
            "busy_share": busy_us / 1e3 / p50 if busy_us else None,
            "device_launches_per_step": launches if busy_us else None,
            "kernel_kinds_ms": kinds if busy_us else None,
            "peak_bytes": peak, "loss_first3": first, "loss_last3": last,
            "dropped_slots": run["drops"] if cfg.n_experts else None,
            "seconds": time.perf_counter() - t_start}


def train_cli_on_card(torch) -> dict:
    """(d) ``python -m repro_torch.launch.train`` at its docstring's
    arguments (``TRAIN_CLI``) on the card, ``train.main`` in this
    process: its ``loss a -> b`` line with b below a, no kernel launch,
    its checkpoints of steps 25 and 50 written under ``build/`` and
    removed."""
    import contextlib
    import io
    import re
    import shutil
    from repro_torch.launch import train as train_cli
    ck_dir = os.path.join(ROOT, "build", "chip_smoke_train_cli")
    shutil.rmtree(ck_dir, ignore_errors=True)
    argv = TRAIN_CLI + ["--device", "cuda", "--ckpt-dir", ck_dir]
    reset_all_launch_counts()
    buf = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train_cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t1
    counts = launched()
    text = buf.getvalue().strip()
    saved = sorted(os.listdir(ck_dir))
    print(f"(d) python -m repro_torch.launch.train {' '.join(argv)}: "
          f"{cli_s:.1f} s, launches {counts or 0}, checkpoints {saved}; "
          f"its output: {text}", flush=True)
    m = re.fullmatch(r"loss (\S+) -> (\S+) over (\d+) steps",
                     text.splitlines()[-1])
    if m is None or not float(m.group(2)) < float(m.group(1)):
        raise AssertionError(f"the train CLI's loss did not fall: {text!r}")
    if counts:
        raise AssertionError(f"the train CLI launched {counts}")
    if saved != ["step_000025", "step_000050"]:
        raise AssertionError(f"the train CLI wrote {saved} under {ck_dir}")
    shutil.rmtree(ck_dir)
    return {"argv": argv, "seconds": cli_s, "output": text}


def family_train_phase(torch, np, seed: int, smi: str) -> dict:
    """Phase 17: ``FAMILY_TRAIN`` trained one model at a time
    (``train_family``), then (d) the train CLI on the card
    (``train_cli_on_card``); the phase's seconds printed beside its
    budget.  Returns the flash row's ``family_train`` entry."""
    import gc
    import shutil
    import signal
    # TrainLoop installs a SIGTERM handler (preemption); the script keeps
    # its own for the other phases
    sigterm = signal.getsignal(signal.SIGTERM)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"card memory at the phase's start: {free} of {total} B free, "
          f"{torch.cuda.memory_allocated()} B allocated by this process "
          f"(16b's processes hold their contexts)", flush=True)
    try:
        models = []
        for spec in FAMILY_TRAIN:
            models.append(train_family(torch, np, spec, seed, smi))
            gc.collect()
            torch.cuda.empty_cache()
        cli = train_cli_on_card(torch)
    finally:
        signal.signal(signal.SIGTERM, sigterm)
    shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke_family_train"),
                  ignore_errors=True)
    phase_s = time.perf_counter() - t0
    print(f"phase 17: {phase_s:.1f} s (its budget "
          f"{FAMILY_TRAIN_BUDGET_S} s): "
          + ", ".join(f"{r['config']} {r['seconds']:.1f} s" for r in models)
          + f", the CLI {cli['seconds']:.1f} s", flush=True)
    return {"launches": sum(r["held_out_launches"] for r in models),
            "models": models, "phase_s": phase_s, "cli": cli,
            "per": "the held-out losses under no_grad, one flash call a "
                   "full-length attention layer; the training steps and "
                   "the train CLI launch no kernel"}


# Phase 14: SigMesh — Fig 9 served and streamed over a 4-shard mesh.  On
# one card the 4 logical shards wrap onto the one device (SignalMesh spans
# it, as the JAX package's mesh spans one jax device): a meshed wave is
# ONE call on the padded rows, FORWARD_LAUNCHES as an unmeshed wave, while
# the router charges each shard ceil(rows / 4) rows; 4 sessions homed on 4
# shards never stack (the shard is part of the stacking key), so a tick is
# 4 core calls of STREAM_TICK_LAUNCHES where an unmeshed tick is 1.  The
# co-serving engine is starcoder2-3b cut to MESH_CO["layers"] of its 30
# layers at full width (bf16, random weights from --seed).
MESH_SHARDS, MESH_ROUNDS, MESH_TURNS = 4, 4, 4
MESH_SHARDED_BATCH = 8
MESH_FAULTS = (                    # (label, supervisor options, stats)
    ("transient failure at tick 2", {},
     {"retries": 1, "checkpoint_restores": 0, "device_losses": 0}),
    ("retry exhaustion at tick 3", {"ckpt_every": 2, "max_retries": 2},
     {"retries": 3, "checkpoint_restores": 1, "device_losses": 0}),
    ("DeviceLoss(1) at tick 6", {"ckpt_every": 2},
     {"retries": 0, "checkpoint_restores": 1, "device_losses": 1}),
)
MESH_CO = {"layers": 2, "llm": 4, "prompt": 128, "max_new": 8}


def mesh_phase(torch, np, seed: int, smi: str, fig: dict) -> dict:
    """Phase 14.  ``fig`` carries the Fig-9 pieces of phase 4: ``graph``,
    ``cnn`` (the mask CNN's weights on the card), ``signals`` (the 8
    served lengths' inputs), ``compiled`` (phase 3's hopper compile at
    length 4096) and ``params``.  (a) phase 4's window through ``SignalService(mesh=4)``
    and an unmeshed service: every result ``np.array_equal``, every wave
    exactly ``FORWARD_LAUNCHES``, the router charging each shard
    ``device_step_costs`` a wave and ``wall_cycles`` the largest share;
    (b) ``sharded_jit`` over ``make_data_mesh()`` on a batch of 8,
    ``torch.equal`` to the plain call; (c) 4 sessions on ``mesh=4``
    against 4 unmeshed ones, 256 samples a tick: exactly 4 core calls of
    ``STREAM_TICK_LAUNCHES`` a meshed tick, outputs ``np.array_equal``;
    then ``StreamSupervisor`` over fresh meshed services with each of
    ``MESH_FAULTS`` injected, each run's outputs ``np.array_equal`` to the
    unfailed supervised run's and its ``stats`` as listed, the dropped
    shard left with no session and the re-homed state on the card; (d)
    ``CoScheduler`` over a meshed service and the cut engine: all work
    done, ``occupancy()["per_device"]`` charging every shard, DSP results
    equal to (a)'s; (e) smoke readings in turns.  Returns the launch
    counts of the shuffle-GEMM rows' ``mesh`` entry."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.perf_model import device_step_costs
    from repro_torch.kernels.shuffle_gemm import (launch_counts,
                                                  reset_launch_counts)
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models import get_model
    from repro_torch.runtime import DeviceLoss, StreamSupervisor
    from repro_torch.serving import (CoScheduler, Request, ServingEngine,
                                     SignalRequest, SignalService)
    t_phase = time.perf_counter()
    graph, cnn, sigs = fig["graph"], fig["cnn"], fig["signals"]
    totals = {"serve": {}, "sharded_jit": {}, "stream": {}, "coserve": {}}
    failures = []

    def add(where, counts):
        for n, c in counts.items():
            totals[where][n] = totals[where].get(n, 0) + c

    def service(mesh=None):
        s_ = SignalService(batch_size=BATCH, backend="hopper",
                           device="cuda", mesh=mesh,
                           block_frames=STREAM_BLOCK_FRAMES)
        s_.register("se", graph, params={"mask": cnn})
        return s_

    def requests(base):
        return [SignalRequest(rid=base + i, graph="se", samples=s)
                for i, s in enumerate(sigs)]

    def serve_window(svc, base, rounds):
        for k in range(rounds):
            for r in requests(base + 100 * k):
                svc.submit(r)
        results, ms, made = {}, [], []
        while svc.pending():
            reset_launch_counts()
            t1 = time.perf_counter()
            results.update(svc.step())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            made.append(launch_counts())
        return results, ms, made

    def unequal(ref, got):
        """The (rid, output, max abs difference) of results that are not
        equal bit for bit."""
        out = []
        for rid, want in ref.items():
            for k, v in want.items():
                if not np.array_equal(v, got[rid][k]):
                    out.append((rid, k, float(np.abs(v - got[rid][k]).max())
                                if v.shape == got[rid][k].shape else None))
        return out

    # (a) meshed serving: phase 4's window, meshed and unmeshed
    unm, msh = service(), service(MESH_SHARDS)
    n_slots = len(msh.mesh.devices)
    for s_ in (unm, msh):
        s_.serve(requests(-1000))            # compiles the 4096 bucket
    torch.cuda.synchronize()
    cyc0, wall0 = list(msh.router.device_cycles), msh.wall_cycles
    ref, _, _ = serve_window(unm, 1000, MESH_ROUNDS)
    got, m_ms, made = serve_window(msh, 1000, MESH_ROUNDS)
    for m in made:
        add("serve", m)
    per_item = msh.group_cost(unm.group_key(requests(0)[0]))
    share = device_step_costs(per_item, BATCH, MESH_SHARDS)
    charged = [a - b for a, b in zip(msh.router.device_cycles, cyc0)]
    diff = unequal(ref, got)
    print(f"(a) SignalService(mesh={MESH_SHARDS}) over {n_slots} device(s) "
          f"{[str(d) for d in msh.mesh.devices]}: {len(got)} requests in "
          f"{len(made)} waves, launches a wave {made[0]} (unmeshed "
          f"{FORWARD_LAUNCHES}); results != unmeshed: {len(diff)} "
          f"{diff[:4]}; shards charged {charged} (device_step_costs "
          f"{share} a wave x {len(made)}), wall_cycles +"
          f"{msh.wall_cycles - wall0}, est per wave {per_item * BATCH}",
          flush=True)
    if sorted(got) != sorted(ref) or diff:
        failures.append(f"(a) meshed results differ from unmeshed: {diff[:4]}")
    if any(m != FORWARD_LAUNCHES for m in made):
        failures.append(f"(a) meshed waves launched {made}")
    if charged != [c * len(made) for c in share] \
            or msh.wall_cycles - wall0 != max(share) * len(made):
        failures.append(f"(a) router charged {charged}, wall "
                        f"{msh.wall_cycles - wall0}")

    # (b) sharded_jit over make_data_mesh() on a batch of 8
    dmesh = make_data_mesh(device="cuda")
    rng = np.random.default_rng(seed + 14)
    x8 = torch.as_tensor(rng.standard_normal(
        (MESH_SHARDED_BATCH, LENGTH)).astype(np.float32), device="cuda")
    compiled = fig["compiled"]
    sharded = compiled.sharded_jit(dmesh)
    with torch.no_grad():
        want = compiled(x8, fig["params"])
        reset_launch_counts()
        out8 = sharded(x8, fig["params"])
        torch.cuda.synchronize()
        sj_counts = launch_counts()
    add("sharded_jit", sj_counts)
    sj_equal = all(torch.equal(out8[k], want[k]) for k in want)
    print(f"(b) sharded_jit over {dmesh} on a batch of "
          f"{MESH_SHARDED_BATCH}: torch.equal to the plain call {sj_equal}; "
          f"launches {sj_counts}", flush=True)
    if not sj_equal or sj_counts != FORWARD_LAUNCHES:
        failures.append(f"(b) sharded_jit equal {sj_equal}, launches "
                        f"{sj_counts}")

    # (c) meshed streaming and supervision
    rng = np.random.default_rng(seed + 15)
    waves_s = [rng.standard_normal(LENGTH).astype(np.float32)
               for _ in range(MESH_SHARDS)]

    def stream(svc, sup=None, injector=None, length=LENGTH, at_end=None):
        sessions = [svc.open_stream("se") for _ in waves_s]
        accs = [{} for _ in sessions]
        ticks = []
        for lo in range(0, length, STREAM_CHUNK):
            for sess, w in zip(sessions, waves_s):
                chunk = w[lo:lo + STREAM_CHUNK]
                if sup is None:
                    sess.feed(chunk)
                else:
                    sup.feed(sess, chunk)
            reset_launch_counts()
            c0 = svc.stats["core_calls"]
            t1 = time.perf_counter()
            if sup is None:
                svc.stream_step()
            else:
                sup.tick(injector)
            torch.cuda.synchronize()
            ticks.append((svc.stats["core_calls"] - c0, launch_counts(),
                          (time.perf_counter() - t1) * 1e3))
            for acc, sess in zip(accs, sessions):
                for k, v in sess.read().items():
                    acc.setdefault(k, []).append(v)
        if at_end is not None:
            at_end(svc, sessions)
        for acc, sess in zip(accs, sessions):
            for k, v in sess.close().items():
                acc.setdefault(k, []).append(v)
        return ([{k: np.concatenate(v, axis=-1 if k == "out" else 0)
                  for k, v in acc.items()} for acc in accs], ticks)

    def streams_unequal(a, b):
        return [(i, k, float(np.abs(x[k] - y[k]).max())
                 if x[k].shape == y[k].shape else None)
                for i, (x, y) in enumerate(zip(a, b)) for k in x
                if not np.array_equal(x[k], y[k])]

    s_unm, u_ticks = stream(service())
    s_msh, m_ticks = stream(service(MESH_SHARDS))
    for _, m, _ in m_ticks:
        add("stream", m)
    bad_ticks = [(c, m) for c, m, _ in m_ticks
                 if c not in (0, MESH_SHARDS)
                 or m != {n: v * c for n, v in STREAM_TICK_LAUNCHES.items()}]
    bad_ticks += [(c, m) for c, m, _ in u_ticks
                  if c not in (0, 1) or m != {n: v * c for n, v in
                                              STREAM_TICK_LAUNCHES.items()}]
    # the launches of the first tick that ran a core call, as measured
    m_tick = next(m for c, m, _ in m_ticks if c)
    u_tick = next(m for c, m, _ in u_ticks if c)
    s_diff = streams_unequal(s_unm, s_msh)
    print(f"(c) {MESH_SHARDS} sessions, chunks of {STREAM_CHUNK}: meshed "
          f"core calls a tick {[c for c, _, _ in m_ticks]} (unmeshed "
          f"{[c for c, _, _ in u_ticks]}), launches of a meshed tick "
          f"{m_tick} (unmeshed {u_tick}); outputs != unmeshed: "
          f"{len(s_diff)} {s_diff[:4]}", flush=True)
    if bad_ticks:
        failures.append(f"(c) ticks {bad_ticks[:3]}")
    if s_diff:
        failures.append(f"(c) meshed streams differ from unmeshed: "
                        f"{s_diff[:4]}")
    svc_b = service(MESH_SHARDS)
    base, _ = stream(svc_b, sup=StreamSupervisor(svc_b))
    for (label, kw, stats), fail_tick in zip(MESH_FAULTS, (2, 3, 6)):
        svc_f = service(MESH_SHARDS)
        sup = StreamSupervisor(svc_f, **kw)
        fired, seen = [], {}

        def injector(tick, attempt, fail_tick=fail_tick, label=label):
            if tick != fail_tick:
                return
            if label.startswith("DeviceLoss"):
                if not fired:
                    fired.append(attempt)
                    raise DeviceLoss(1)
            elif label.startswith("transient"):
                if attempt == 0:
                    fired.append(attempt)
                    raise RuntimeError("transient device error")
            elif len(fired) <= sup.max_retries:
                fired.append(attempt)
                raise RuntimeError("persistent device error")

        def at_end(svc, sessions):
            seen["alive"] = list(svc.router.alive)
            seen["sessions"] = list(svc.router.device_sessions)
            seen["homes"] = [s.device_index for s in sessions]
            seen["state_devices"] = sorted({str(s.state.buf.device)
                                            for s in sessions})
        out_f, _ = stream(svc_f, sup=sup, injector=injector, at_end=at_end)
        f_diff = streams_unequal(base, out_f)
        print(f"    supervised, {label}: fired at attempts {fired}, stats "
              f"{sup.stats}; outputs != unfailed run: {len(f_diff)} "
              f"{f_diff[:4]}; shards alive {seen['alive']}, sessions "
              f"{seen['sessions']}, homes {seen['homes']}, state on "
              f"{seen['state_devices']}", flush=True)
        if f_diff or sup.stats != stats or not fired:
            failures.append(f"(c) {label}: stats {sup.stats}, "
                            f"{len(f_diff)} outputs differ")
        if label.startswith("DeviceLoss") and (
                seen["alive"][1] or seen["sessions"][1] or 1 in seen["homes"]
                or not all(d.startswith("cuda")
                           for d in seen["state_devices"])):
            failures.append(f"(c) after DeviceLoss(1): {seen}")

    # (d) co-serving on a meshed service, with the cut engine
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=MESH_CO["layers"])
    bundle = get_model(cfg)
    lm_params = bundle.init(torch.Generator(device="cuda").manual_seed(seed),
                            device="cuda")
    engine = ServingEngine(bundle, batch_size=MESH_CO["llm"],
                           temperature=0.0)
    engine.load(lm_params, device="cuda")
    svc_c = service(MESH_SHARDS)
    svc_c.serve(requests(-1000))
    sched = CoScheduler(engine, svc_c, policy="round_robin")
    toks = np.random.default_rng(seed + 16).integers(
        0, cfg.vocab, (MESH_CO["llm"], MESH_CO["prompt"]))
    for i in range(MESH_CO["llm"]):
        sched.submit_llm(Request(rid=i, prompt=toks[i].tolist(),
                                 max_new=MESH_CO["max_new"]))
    for r in requests(3000):
        sched.submit_signal(r)
    reset_launch_counts()
    llm, dsp = sched.run()
    torch.cuda.synchronize()
    add("coserve", launch_counts())
    occ = sched.occupancy()
    per = occ.get("per_device", {})
    co_diff = unequal({3000 + i: ref[1000 + i] for i in range(len(sigs))},
                      dsp)
    print(f"(d) CoScheduler over SignalService(mesh={MESH_SHARDS}) and "
          f"{LM_ARCH} cut to {cfg.n_layers} layers: {len(llm)} LLM, "
          f"{len(dsp)} DSP requests in {sched.ticks} ticks; per_device "
          f"{per}; DSP != (a)'s unmeshed: {len(co_diff)}; launches "
          f"{totals['coserve']}", flush=True)
    if sorted(llm) != list(range(MESH_CO["llm"])) or any(
            len(v) != MESH_CO["max_new"] for v in llm.values()) or co_diff \
            or len(per.get("device_cycles", [])) != MESH_SHARDS \
            or not all(per["device_cycles"]):
        failures.append(f"(d) co-serving: per_device {per}, "
                        f"{len(co_diff)} DSP results differ")
    del engine, lm_params, bundle, sched
    torch.cuda.empty_cache()

    # (e) smoke readings, in turns: unmeshed, meshed, meshed, unmeshed, ...
    steps = {"unmeshed": [], "meshed": []}
    ticks = {"unmeshed": [], "meshed": []}
    order = ["unmeshed", "meshed", "meshed", "unmeshed"] * (MESH_TURNS // 2)
    for i, which in enumerate(order):
        svc_t = unm if which == "unmeshed" else msh
        steps[which] += serve_window(svc_t, 5000 + 1000 * i, 1)[1]
        _, tk = stream(service(MESH_SHARDS if which == "meshed" else None),
                       length=LENGTH // 2)
        ticks[which] += [ms for c, _, ms in tk if c]
    p50 = {k: float(np.median(v)) for k, v in steps.items()}
    t50 = {k: float(np.median(v)) for k, v in ticks.items()}
    launches_tick = {"meshed": sum(m_tick.values()),
                     "unmeshed": sum(u_tick.values())}
    secs = time.perf_counter() - t_phase
    print(smi)
    print(f"(e) smoke readings (not a benchmark), {MESH_TURNS} windows each "
          f"in turns: p50 step() meshed {p50['meshed']:.3f} ms, unmeshed "
          f"{p50['unmeshed']:.3f} ms (ratio "
          f"{p50['meshed'] / p50['unmeshed']:.3f}); p50 tick meshed "
          f"{t50['meshed']:.3f} ms ({MESH_SHARDS} core calls), unmeshed "
          f"{t50['unmeshed']:.3f} ms (1 call) (ratio "
          f"{t50['meshed'] / t50['unmeshed']:.3f}); shuffle-GEMM launches "
          f"a tick {launches_tick}; phase 14 {secs:.1f} s", flush=True)
    if failures:
        raise AssertionError("phase 14: " + "; ".join(failures))
    return {name: {"launches": sum(totals[w].get(name, 0) for w in totals),
                   **{w: totals[w].get(name, 0) for w in totals},
                   "per_wave": made[0].get(name, 0),
                   "per_meshed_tick": m_tick.get(name, 0),
                   "per_unmeshed_tick": u_tick.get(name, 0),
                   "step_p50_ms": p50, "tick_p50_ms": t50,
                   "launches_per_tick": launches_tick, "phase_s": secs,
                   "per": f"phase 14: phase 4's window served on "
                          f"mesh={MESH_SHARDS}, one sharded_jit call, "
                          f"{MESH_SHARDS} meshed sessions' ticks, a "
                          f"meshed co-serve"}
            for name in ("shuffle_gemm_blocks", "shuffle_gemm_chain")}


# -- phase 15: multi-device models on gloo ranks that share the card ------
# One H100 takes one NCCL rank, so the ranks are gloo processes on cuda:0
# whose collectives the port's staged group (launch/staged_gloo.py) runs
# through pinned host memory: every time of this phase is that one-card
# transport's, not an inter-card link's.
MM_WORLD = 4
MM_PROBE_WORLD = 2                 # ranks of each plain-gloo probe group
MM_ARCH = "starcoder2-3b"
MM_PROBE_OPS = ("all_reduce", "broadcast", "all_gather_into_tensor",
                "reduce_scatter_tensor", "send_recv", "all_to_all_single")
MM_PIPE = {"stages": 4, "microbatches": 8, "seq": 2048}   # one block a stage
# full width, depth cut to 2 layers, float32 (TF32 off) so the sharded
# step can be held at the CPU test's tolerances; the config's microbatch 4
# and remat
MM_TRAIN = {"mesh": (2, 2), "n_layers": 2, "batch": 8, "seq": 512,
            "steps": 3, "lr": 1e-3}
MM_LOSS_RTOL, MM_RTOL, MM_ATOL = 1e-5, 1e-4, 1e-6
MM_NEAR_EPS = 1e-6     # a gradient element this small makes AdamW's ratio
                       # ill-conditioned: held to 2 x steps x lr instead (a
                       # flipped sign moves a step's update by 2 lr)
MM_COMPRESS = (3072, 12288)                # starcoder2-3b's w_up
MM_COMPRESS_REL = 0.1                      # the JAX package's test limit
MM_TIMEOUT = 600
# 15e: the MoE and xLSTM families on the (2, 2) mesh, full width, float32
# (TF32 off), cut in depth as 15c is (qwen2-moe-a2.7b to 1 of its 24
# layers: at 2, four ranks' steps beside the references overflow the
# 80 GB card; xlstm-350m to 8: one pattern of 7 mLSTM and 1 sLSTM), with
# their configs' microbatch 4 and remat; MM_TRAIN's batch of 8, 256
# positions and one step (its gradient is then the first moment over
# 0.1: no rank keeps a copy of its moments to find it).  Params are drawn on the CPU, so the parent and
# every rank draw the same values, and each rank moves only its own
# blocks to the card and keeps its moments in the zero-1 layout; the
# ranks are a second spawn, after 15b-d's references are freed:
# qwen2-moe's float32 references (params and moments, 21 GB) would not
# fit the card beside 15c's and four ranks' steps.
MM_FAMILIES = {"qwen2-moe-a2.7b": 1, "xlstm-350m": 8}     # layers kept
MM_FAMILY_RUN = {"mesh": (2, 2), "batch": 8, "seq": 256, "steps": 1,
                 "lr": 1e-3}
MM_LOGITS_RTOL, MM_LOGITS_ATOL = 1e-4, 1e-5
# xlstm-350m: its logits by relative L2 at phase 12's float32 limit for
# the recurrent families (FAMILY_TF_F32_REL_L2): its exponentially gated
# blocks amplify one block's float32 rounding about threefold a block
# (tests/test_torch_recurrent.py holds the reduced model at atol 3e-4;
# at full width the card read 3.4e-4 for the largest element); one train
# step, its
# loss at MM_LOSS_RTOL, its gradient norm and the whole first and second
# moments (every leaf together) by relative L2 at MM_XLSTM_GRAD_REL.  Its
# gradient is ill-conditioned: the stabilizers' gradient paths cancel
# analytically and leave float32 rounding amplified by the exponentials,
# so a sharded step's GEMMs over fewer rows move it draw by draw (a CPU
# rehearsal at d 64, 8 layers: the gradient norm 7.6e-6 from the
# unsharded one's at one seed, 1.2e-3 at another, where one
# zero-initialized norm weight's update flips sign); each leaf's error
# is printed, not held
MM_XLSTM_GRAD_REL = 1e-2


def _mm_probe_op(torch, dist, name: str, rank: int, world: int) -> bool:
    """Collective ``name`` on CUDA tensors of ``cuda:0``; True when every
    element of its result is right."""
    dev = torch.device("cuda", 0)
    if name == "all_reduce":
        x = torch.full((1 << 20,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        return bool((x == world * (world + 1) / 2).all())
    if name == "broadcast":
        x = torch.full((1 << 20,), float(rank), device=dev)
        dist.broadcast(x, src=world - 1)
        return bool((x == world - 1).all())
    if name == "all_gather_into_tensor":
        x = torch.full((1 << 18,), float(rank), device=dev)
        out = torch.empty(world << 18, device=dev)
        dist.all_gather_into_tensor(out, x)
        return bool(torch.equal(out.view(world, -1)[:, 0].cpu(),
                                torch.arange(world, dtype=torch.float32)))
    if name == "reduce_scatter_tensor":
        x = torch.arange(world << 18, device=dev, dtype=torch.float32)
        out = torch.empty(1 << 18, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return bool(torch.equal(out, world * x.view(world, -1)[rank]))
    if name == "send_recv":
        x = torch.full((1 << 18,), float(rank), device=dev)
        if rank % 2 == 0:
            dist.send(x, rank + 1)
            return True
        dist.recv(x, rank - 1)
        return bool((x == rank - 1).all())
    if name == "all_to_all_single":
        x = (torch.arange(world, device=dev, dtype=torch.float32)
             .repeat_interleave(1 << 16) + 10 * rank)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        want = (torch.arange(world, device=dev, dtype=torch.float32) * 10
                + rank).repeat_interleave(1 << 16)
        return bool(torch.equal(out, want))
    raise ValueError(name)


def _mm_plain_probe(op: str, rank: int, world: int, init: str,
                    out_dir: str) -> None:
    """One rank of 15a's plain-gloo probe of ``op`` (its own 4-rank
    group); a crash or an exception is the probe's finding, read by the
    parent from the exit code."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    ok = _mm_probe_op(torch, dist, op, rank, world)
    torch.cuda.synchronize()
    with open(os.path.join(out_dir, f"plain_{op}_{rank}.json"), "w") as f:
        json.dump({"ok": ok}, f)
    dist.destroy_process_group()


def _mm_flat(tree, prefix: str = "") -> dict:
    """``{"a/b": leaf}`` of a dict tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_mm_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _mm_stage_block(torch, cfg, seed: int, stage: int):
    from repro_torch.models import transformer as T
    return T.init_block(torch.Generator(device="cuda").manual_seed(
        seed * 1000 + 100 + stage), "global", cfg)


def _mm_pipe_inputs(torch, cfg, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed * 1000 + 99)
    return torch.randn((MM_PIPE["microbatches"], 1, MM_PIPE["seq"],
                        cfg.d_model), generator=gen, device="cuda").to(
                            torch.bfloat16)


def _mm_block_fn(torch, cfg):
    """One stage's compute: a starcoder2-3b block (the flash kernel on
    its full-length attention under ``no_grad``)."""
    from repro_torch.models import transformer as T
    positions = torch.arange(MM_PIPE["seq"], device="cuda")

    def fn(p, x):
        return T.block_apply("global", p, x, cfg, "train", positions, 0,
                             None)[0]
    return fn


def _mm_train_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MM_ARCH),
                               n_layers=MM_TRAIN["n_layers"],
                               dtype="float32")


def _mm_references(torch, seed: int) -> tuple:
    """The parent's single-process references, on the card: the four
    stages run one after another on every microbatch (15b), and
    ``MM_TRAIN["steps"]`` steps of the unsharded ``make_train_step`` on
    the same weights and batches (15c).  Returns the readings and the
    tensors the ranks compare against, left on the card: the ranks get
    them through CUDA IPC (``torch.multiprocessing``), nothing copied."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_batch_iterator
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import adamw_init
    out, t_start = {}, time.perf_counter()
    cfg = get_config(MM_ARCH)
    fn = _mm_block_fn(torch, cfg)
    blocks = [_mm_stage_block(torch, cfg, seed, s)
              for s in range(MM_PIPE["stages"])]
    x = _mm_pipe_inputs(torch, cfg, seed)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq = torch.stack([_mm_sequential(fn, blocks, x[i])
                           for i in range(MM_PIPE["microbatches"])])
        torch.cuda.synchronize()
    out["sequential_ms"] = (time.perf_counter() - t0) * 1e3
    del blocks, x
    out["pipe_s"] = time.perf_counter() - t_start

    tcfg = _mm_train_cfg()
    bundle = get_model(tcfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(seed),
                         device="cuda")
    opt = adamw_init(params)
    step = make_train_step(bundle, lambda s: MM_TRAIN["lr"])
    it = make_batch_iterator(TokenStream(
        tcfg.vocab, MM_TRAIN["seq"], MM_TRAIN["batch"], seed), device="cuda")
    m_prev = {k: v.clone() for k, v in _mm_flat(opt.m).items()}
    near = {k: torch.zeros_like(v, dtype=torch.bool)
            for k, v in m_prev.items()}
    losses, norms, times = [], [], []
    for _ in range(MM_TRAIN["steps"]):
        _, batch = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        for k, v in _mm_flat(opt.m).items():
            # this step's clipped gradient, from the first moment's update
            g = (v - 0.9 * m_prev[k]).abs() / 0.1
            near[k] |= (g > 0) & (g < MM_NEAR_EPS)
            m_prev[k].copy_(v)
    del m_prev
    torch.cuda.empty_cache()
    out["single_step_s"] = times
    out["single_p50_s"] = float(np.median(times))
    out["loss"], out["grad_norm"] = losses, norms
    out["near_eps"] = int(sum(int(v.sum()) for v in near.values()))
    out["seconds"] = time.perf_counter() - t_start
    shared = {"pipe": seq, "loss": losses, "grad_norm": norms,
              "params": _mm_flat(params), "m": _mm_flat(opt.m),
              "v": _mm_flat(opt.v), "near_eps": near}
    return out, shared


def _mm_sequential(fn, blocks, x):
    """``x`` through every block in order, in this process."""
    for p in blocks:
        x = fn(p, x)
    return x


def _mm_rank_pipeline(torch, dist, seed: int, ref) -> dict:
    """15b in one rank: ``spmd_pipeline`` over the 4 stages, this rank's
    block a ``Shard(0)`` row of the stacked stage params."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime.pipeline import spmd_pipeline
    from repro_torch.tree import tree_map
    cfg = get_config(MM_ARCH)
    mesh = make_test_mesh((MM_PIPE["stages"],), ("stage",), device="cuda")
    stage = mesh.get_local_rank("stage")
    block = _mm_stage_block(torch, cfg, seed, stage)
    stacked = tree_map(lambda t: DTensor.from_local(
        t[None], mesh, [Shard(0)], run_check=False), block)
    x = _mm_pipe_inputs(torch, cfg, seed)
    fn = _mm_block_fn(torch, cfg)
    FK.reset_launch_counts()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = spmd_pipeline(fn, stacked, x, mesh=mesh, axis_name="stage",
                            n_microbatches=MM_PIPE["microbatches"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = FK.launch_counts()
    diff = (out.float() - ref.float())
    return {"stage": stage, "launches": counts, "ms": wall * 1e3,
            "equal": bool(torch.equal(out, ref)),
            "max_abs_diff": float(diff.abs().max()),
            "rel_l2": float(diff.norm() / ref.float().norm())}


def _mm_rank_train(torch, dist, seed: int, ref: dict) -> dict:
    """15c in one rank: ``MM_TRAIN["steps"]`` sharded steps on a (2, 2)
    mesh, then this rank's shards held against the parent's unsharded
    run."""
    import numpy as np
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.data import TokenStream, make_batch_iterator
    from repro_torch.launch import staged_gloo
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import get_model
    from repro_torch.models import sharding as SH
    from repro_torch.optim.adamw import adamw_init
    cfg = _mm_train_cfg()
    bundle = get_model(cfg)
    mesh = make_test_mesh(MM_TRAIN["mesh"], device="cuda")
    params = bundle.init(torch.Generator(device="cuda").manual_seed(seed),
                         device="cuda")
    params = SH.distribute_tree(params, SH.param_specs(
        params, SH.mesh_axes_of(mesh), cfg.fsdp), mesh)
    torch.cuda.empty_cache()
    opt = adamw_init(params)
    step = make_train_step(bundle, lambda s: MM_TRAIN["lr"])
    it = make_batch_iterator(TokenStream(
        cfg.vocab, MM_TRAIN["seq"], MM_TRAIN["batch"], seed),
        sharding=SH.row_sharding(mesh, (MM_TRAIN["batch"], MM_TRAIN["seq"])))
    losses, norms, times, per_step = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(MM_TRAIN["steps"]):
        _, batch = next(it)
        before = staged_gloo.staged_totals()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = staged_gloo.staged_totals()
        per_step.append({k: after.get(k, 0) - before.get(k, 0)
                         for k in after if after.get(k, 0) != before.get(k, 0)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    worst, bad, n_near, bad_moments, m_scaled = {}, 0, 0, 0, 0.0

    def local(t, placements):
        return distribute_tensor(t, mesh, placements,
                                 src_data_rank=None).to_local()
    for name, leaf in _mm_flat(params).items():
        want = local(ref["params"][name], leaf.placements)
        sens = local(ref["near_eps"][name], leaf.placements)
        err = (leaf.to_local() - want).abs()
        tol = torch.where(sens, 2 * MM_TRAIN["steps"] * MM_TRAIN["lr"],
                          MM_ATOL + MM_RTOL * want.abs())
        bad += int((err > tol).sum())
        n_near += int(sens.sum())
        worst[name] = float(err[~sens].max()) if (~sens).any() else 0.0
    # the moments, linear and quadratic in the gradients, have no such
    # ill-conditioned elements: all of them at the CPU test's tolerances
    for key, tree in (("m", opt.m), ("v", opt.v)):
        for name, leaf in _mm_flat(tree).items():
            want = local(ref[key][name], leaf.placements)
            err = (leaf.to_local() - want).abs()
            bad_moments += int((err > MM_ATOL + MM_RTOL * want.abs()).sum())
            if want.numel() and float(want.abs().max()) > 0:
                m_scaled = max(m_scaled, float(err.max() / want.abs().max()))
    return {"loss": losses, "grad_norm": norms,
            "ref_loss": ref["loss"], "ref_grad_norm": ref["grad_norm"],
            "step_s": times, "p50_s": float(np.median(times)),
            "collectives_per_step": per_step, "peak_bytes": peak,
            "violations": bad, "moment_violations": bad_moments,
            "moment_err_over_max": m_scaled,
            "near_eps_local": n_near,
            "max_abs_err": max(worst.values()),
            "worst_leaf": max(worst, key=worst.get)}


def _mm_rank_compress(torch, dist, seed: int, rank: int, world: int) -> dict:
    """15d (1): ``allreduce_compressed`` of a full-width ``w_up``
    gradient, each rank its own, against the mean of all four."""
    from repro_torch.launch import staged_gloo
    from repro_torch.optim.compression import (allreduce_compressed,
                                               compress_int8)

    def grad(r):
        gen = torch.Generator(device="cuda").manual_seed(seed * 1000 + 200
                                                         + r)
        return torch.randn(MM_COMPRESS, generator=gen, device="cuda") * 1e-3
    mean = grad(0)
    for r in range(1, world):
        mean += grad(r)
    mean /= world
    q, s = compress_int8(grad(rank))
    before = staged_gloo.staged_totals()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = allreduce_compressed(q, s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = staged_gloo.staged_totals()
    n = q.numel()
    return {"rel": float((out - mean).abs().max() / mean.abs().max()),
            "ms": wall * 1e3, "int8_payload_bytes": n,
            "float32_payload_bytes": 4 * n, "int32_sum_bytes": 4 * n,
            "staged": {k: after.get(k, 0) - before.get(k, 0) for k in after
                       if after.get(k, 0) != before.get(k, 0)}}


def _mm_rank_checkpoint(torch, dist, seed: int, work: str) -> dict:
    """15d (2): a tree placed by its fsdp specs on (2, 2), saved, and
    restored under (4, 1): each rank's blocks bit for bit."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import sharding as SH
    gen = torch.Generator(device="cuda").manual_seed(seed * 1000 + 300)
    tree = {"w_up": torch.randn(MM_COMPRESS, generator=gen, device="cuda"),
            "wq": torch.randn((3072, 3072), generator=gen, device="cuda"),
            "norm_in": torch.randn((3072,), generator=gen, device="cuda")}
    m1 = make_test_mesh((2, 2), device="cuda")
    t1 = SH.distribute_tree(tree, SH.param_specs(
        tree, SH.mesh_axes_of(m1), True), m1)
    ck = Checkpointer(os.path.join(work, "ckpt"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(1, t1, blocking=True)
    save_s = time.perf_counter() - t0
    m2 = make_test_mesh((4, 1), device="cuda")
    specs2 = SH.param_specs(tree, SH.mesh_axes_of(m2), True)
    shardings = {k: SH.NamedSharding(m2, s) for k, s in specs2.items()}
    t0 = time.perf_counter()
    step, back = ck.restore(like=tree, shardings=shardings)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    equal = {}
    for k in tree:
        want = distribute_tensor(tree[k], m2, SH.to_placements(specs2[k], m2),
                                 src_data_rank=None)
        equal[k] = bool(torch.equal(back[k].to_local(), want.to_local())
                        and back[k].placements == want.placements)
    return {"step": step, "equal": equal, "save_s": save_s,
            "restore_s": restore_s,
            "placements": {k: str(back[k].placements) for k in tree}}


def _release_shared(torch, tree: dict) -> None:
    """Drop a rank's references to the parent's tensors (received through
    CUDA IPC) while CUDA still runs: freed at interpreter exit, they are
    never reported back, and the parent holds them (its IPC limbo) to
    its own end."""
    tree.clear()
    import gc
    gc.collect()
    torch.cuda.synchronize()


def _mm_rank(rank: int, world: int, init: str, work: str, seed: int,
             ref: dict) -> None:
    """One of the 4 ranks of phase 15 (b-d and 15a's staged probe);
    ``ref`` holds the parent's references on the card (CUDA IPC); the
    readings go to ``work/rank<r>.json``, a traceback to
    ``work/rank<r>.err``."""
    try:
        import torch
        import torch.distributed as dist
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch import kernels as K
        from repro_torch.launch import staged_gloo
        from repro_torch.launch.mesh import init_distributed
        init_distributed(rank, world, init, device="cuda", timeout_s=300)
        res = {"backend": dist.get_backend()}
        # the kernel library's first use in this rank: the probe
        K.compiled_supported.launches = 0
        if not K.compiled_supported():
            raise AssertionError("compiled_supported() is False")
        res["probe_launches"] = K.compiled_supported.launches
        staged = {}
        for op in MM_PROBE_OPS:
            before = staged_gloo.staged_totals()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = _mm_probe_op(torch, dist, op, rank, world)
            torch.cuda.synchronize()
            after = staged_gloo.staged_totals()
            staged[op] = {"ok": ok, "ms": (time.perf_counter() - t0) * 1e3,
                          "staged_bytes": sum(
                              after.get(k, 0) - before.get(k, 0)
                              for k in ("bytes_to_host",
                                        "bytes_to_device"))}
            dist.barrier()
        res["staged"] = staged
        t0 = time.perf_counter()
        res["pipeline"] = _mm_rank_pipeline(torch, dist, seed, ref["pipe"])
        res["pipeline_s"] = time.perf_counter() - t0
        dist.barrier()
        t0 = time.perf_counter()
        res["train"] = _mm_rank_train(torch, dist, seed, ref)
        res["train_s"] = time.perf_counter() - t0
        dist.barrier()
        torch.cuda.empty_cache()
        res["compress"] = _mm_rank_compress(torch, dist, seed, rank, world)
        res["checkpoint"] = _mm_rank_checkpoint(torch, dist, seed, work)
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        res["staged_totals"] = staged_gloo.staged_totals()
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        _release_shared(torch, ref)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        import traceback
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def _mm_family_cfg(arch: str):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=MM_FAMILIES[arch],
                               dtype="float32")


def _mm_family_seed(seed: int, arch: str) -> int:
    return seed * 1000 + 400 + 10 * sorted(MM_FAMILIES).index(arch)


def _mm_family_init(torch, arch: str, seed: int):
    """15e's params of ``arch``, drawn on the CPU: the parent and every
    rank draw the same values."""
    from repro_torch.models import get_model
    return get_model(_mm_family_cfg(arch)).init(
        torch.Generator().manual_seed(_mm_family_seed(seed, arch)),
        device="cpu")


def _mm_family_stream(arch: str, seed: int):
    """15e's token stream: its first batch the prompt, the next ones the
    train steps'."""
    from repro_torch.data import TokenStream
    r = MM_FAMILY_RUN
    return TokenStream(_mm_family_cfg(arch).vocab, r["seq"], r["batch"],
                       _mm_family_seed(seed, arch) + 1)


def _mm_block(t, mesh, placements):
    """This rank's block of ``t`` under ``placements`` (each dim split
    evenly, by one mesh dim at most, as the specs split them)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for j, p in enumerate(placements):
        if isinstance(p, Shard):
            t = t.chunk(mesh.size(j), dim=p.dim)[coord[j]]
    return t.contiguous()


def _mm_place(torch, tree, specs, mesh):
    """``tree`` (CPU tensors) placed on ``mesh`` by ``specs``: each rank
    moves only its own block of each leaf to the card."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import sharding as SH
    from repro_torch.tree import tree_map

    def place(leaf, spec):
        pl = SH.to_placements(spec, mesh)
        return DTensor.from_local(_mm_block(leaf, mesh, pl).to("cuda"), mesh,
                                  pl, run_check=False, shape=leaf.shape,
                                  stride=leaf.stride())
    return tree_map(place, tree, specs)


def _mm_family_references(torch, seed: int) -> tuple:
    """15e's references in the parent, one family at a time: the
    unsharded prefill of the stream's first batch and one greedy decode
    step, then ``MM_FAMILY_RUN["steps"]`` unsharded train steps on the
    next batches.  Returns the readings and the tensors the ranks
    compare against, left on the card (CUDA IPC)."""
    import numpy as np
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.tree import tree_map
    r, out, shared = MM_FAMILY_RUN, {}, {}
    for arch in MM_FAMILIES:
        t0 = time.perf_counter()
        bundle = get_model(_mm_family_cfg(arch))
        params = tree_map(lambda t: t.to("cuda"),
                          _mm_family_init(torch, arch, seed))
        it = make_batch_iterator(_mm_family_stream(arch, seed),
                                 device="cuda")
        prompt = next(it)[1]
        with torch.no_grad():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lg, cache = bundle.prefill(params, prompt, max_len=r["seq"] + 1)
            nxt = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            lg2, _ = bundle.decode_step(params, cache, {"tokens": nxt})
            torch.cuda.synchronize()
        serve_s = time.perf_counter() - t1
        del cache
        ref = {"prefill": lg, "decode": lg2,
               "tokens": [nxt[:, 0].tolist(),
                          lg2[:, -1].argmax(-1).tolist()]}
        opt = adamw_init(params)
        step = make_train_step(bundle, lambda s: r["lr"])
        m_prev = {k: v.clone() for k, v in _mm_flat(opt.m).items()}
        near = {k: torch.zeros_like(v, dtype=torch.bool)
                for k, v in m_prev.items()}
        losses, norms, times = [], [], []
        for _ in range(MM_FAMILY_RUN["steps"]):
            _, batch = next(it)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            for k, v in _mm_flat(opt.m).items():
                g = (v - 0.9 * m_prev[k]).abs() / 0.1
                near[k] |= (g > 0) & (g < MM_NEAR_EPS)
                m_prev[k].copy_(v)
        del m_prev
        ref.update(loss=losses, grad_norm=norms, params=_mm_flat(params),
                   m=_mm_flat(opt.m), v=_mm_flat(opt.v), near_eps=near)
        shared[arch] = ref
        out[arch] = {"step_s": times, "p50_s": float(np.median(times)),
                     "prefill_decode_s": serve_s,
                     "seconds": time.perf_counter() - t0}
        del params, opt
        torch.cuda.empty_cache()
    return out, shared


def _mm_rank_family(torch, dist, seed: int, arch: str, ref: dict) -> dict:
    """15e in one rank for ``arch``: this rank's blocks of the CPU-drawn
    params placed by the specs on the (2, 2) mesh; a sharded prefill of
    the prompt and one greedy decode step (no_grad; the kernel launches
    of each), then ``MM_FAMILY_RUN["steps"]`` sharded train steps with
    zero-1 moments; every block held against the parent's unsharded
    results."""
    import numpy as np
    from torch.distributed.tensor import zeros as dtensor_zeros
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.data import make_batch_iterator
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch import staged_gloo
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import get_model
    from repro_torch.models import sharding as SH
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.tree import tree_map
    r, res = MM_FAMILY_RUN, {}
    bundle = get_model(_mm_family_cfg(arch))
    mesh = make_test_mesh(r["mesh"], device="cuda")
    axes = SH.mesh_axes_of(mesh)
    t0 = time.perf_counter()
    cpu = _mm_family_init(torch, arch, seed)
    pspecs = SH.param_specs(cpu, axes, bundle.cfg.fsdp)
    params = _mm_place(torch, cpu, pspecs, mesh)
    del cpu
    res["place_s"] = time.perf_counter() - t0
    it = make_batch_iterator(_mm_family_stream(arch, seed),
                             sharding=SH.row_sharding(
                                 mesh, (r["batch"], r["seq"])))
    prompt = next(it)[1]

    def logits(got, want):
        err = (got - want).abs()
        rel = float((got - want).norm() / want.norm())
        within = (rel <= FAMILY_TF_F32_REL_L2 if arch == "xlstm-350m" else
                  bool((err <= MM_LOGITS_ATOL
                        + MM_LOGITS_RTOL * want.abs()).all()))
        return {"max_abs_err": float(err.max()), "rel_l2": rel,
                "within": within}
    with torch.no_grad(), implicit_replication():
        FK.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = bundle.prefill(params, prompt, max_len=r["seq"] + 1)
        first = lg.full_tensor()
        res["prefill_launches"] = FK.launch_counts()
        nxt = first[:, -1].argmax(-1).to(torch.int32)[:, None]
        FK.reset_launch_counts()
        lg2, _ = bundle.decode_step(params, cache, {
            "tokens": SH.distribute_tree(nxt, SH.batch_spec(
                tuple(nxt.shape), axes), mesh)})
        second = lg2.full_tensor()
        torch.cuda.synchronize()
        res["decode_launches"] = FK.launch_counts()
        res["prefill_decode_s"] = time.perf_counter() - t0
    del cache
    res["prefill"] = logits(first, ref["prefill"])
    res["decode"] = logits(second, ref["decode"])
    res["tokens"] = [nxt[:, 0].tolist(), second[:, -1].argmax(-1).tolist()]
    # the train steps, moments in the zero-1 layout
    mspecs = tree_map(lambda p, sp: SH.zero1_spec(sp, tuple(p.shape), axes),
                      params, pspecs)
    opt = AdamWState(0, *(tree_map(lambda p, sp: dtensor_zeros(
        tuple(p.shape), dtype=torch.float32, device_mesh=mesh,
        placements=SH.to_placements(sp, mesh)), params, mspecs)
        for _ in range(2)))
    step = make_train_step(bundle, lambda s: r["lr"])
    losses, norms, times, per_step = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(MM_FAMILY_RUN["steps"]):
        _, batch = next(it)
        before = staged_gloo.staged_totals()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = staged_gloo.staged_totals()
        per_step.append({k: after.get(k, 0) - before.get(k, 0)
                         for k in after if after.get(k, 0)
                         != before.get(k, 0)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    # this run's own near-eps elements, as the parent marks its own (one
    # step: its gradient is m / 0.1): an element whose gradient is under
    # MM_NEAR_EPS in either run has an ill-conditioned AdamW ratio
    near = {k: (v.abs() > 0) & (v.abs() < 0.1 * MM_NEAR_EPS)
            for k, v in _mm_flat(opt.m).items()}
    peak = torch.cuda.max_memory_allocated()
    bad, bad_m, n_near, sq = 0, 0, 0, {}
    for key, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
        for name, leaf in _mm_flat(tree).items():
            got = leaf.to_local()
            want = _mm_block(ref[key][name], mesh, leaf.placements)
            err = (got - want).abs()
            tol = MM_ATOL + MM_RTOL * want.abs()
            if key == "params":
                # near eps in the parent's run or in this one (its mask
                # in the zero-1 moments' layout, moved to the param's)
                own = near[name].to(torch.uint8).redistribute(
                    mesh, leaf.placements).to_local().bool()
                sens = _mm_block(ref["near_eps"][name], mesh,
                                 leaf.placements) | own
                tol = torch.where(sens, 2 * r["steps"] * r["lr"], tol)
                n_near += int(sens.sum())
                bad += int((err > tol).sum())
            else:
                bad_m += int((err > tol).sum())
            # squared error and squared reference of the block: summed
            # over the ranks, a leaf's relative L2 error
            sq[f"{key}/{name}"] = [float(err.double().pow(2).sum()),
                                   float(want.double().pow(2).sum())]
    res.update(loss=losses, grad_norm=norms, step_s=times,
               p50_s=float(np.median(times)), collectives_per_step=per_step,
               peak_bytes=peak, violations=bad, moment_violations=bad_m,
               near_eps_local=n_near, sq=sq)
    return res


def _mm_family_rank(rank: int, world: int, init: str, work: str, seed: int,
                    refs: dict) -> None:
    """One of the 4 ranks of 15e (a second spawn); readings to
    ``work/family<r>.json``, a traceback to ``work/family<r>.err``."""
    try:
        import torch
        import torch.distributed as dist
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.launch.mesh import init_distributed
        init_distributed(rank, world, init, device="cuda", timeout_s=300)
        res = {}
        for arch in MM_FAMILIES:
            t0 = time.perf_counter()
            res[arch] = _mm_rank_family(torch, dist, seed, arch, refs[arch])
            res[arch]["seconds"] = time.perf_counter() - t0
            dist.barrier()
            torch.cuda.empty_cache()
        with open(os.path.join(work, f"family{rank}.json"), "w") as f:
            json.dump(res, f)
        _release_shared(torch, refs)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        import traceback
        with open(os.path.join(work, f"family{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def _mm_join(procs, deadline: float, grace: float = 15.0) -> list:
    """Wait for ``procs`` until they end, ``deadline`` (monotonic) passes,
    or ``grace`` seconds after the first failure; kill what is left and
    return the exit codes."""
    failed_at = None
    while any(p.is_alive() for p in procs):
        now = time.monotonic()
        if failed_at is None and any(p.exitcode not in (None, 0)
                                     for p in procs):
            failed_at = now
        if now > deadline or (failed_at is not None
                              and now > failed_at + grace):
            break
        time.sleep(0.1)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    return [p.exitcode for p in procs]


def mesh_families(torch, seed: int, work: str, ctx) -> tuple:
    """15e: ``MM_FAMILIES`` on the (2, 2) mesh of 4 gloo ranks on the card
    (``_mm_family_rank``, a spawn of its own in ``ctx`` after the parent's
    references, ``_mm_family_references``), each held against the
    parent's unsharded run.  Returns (the failures, the flash and pre-pass
    launches summed over the ranks, per-family readings, the seconds of
    the references and of the ranks)."""
    from repro_torch.configs import get_config
    failures = []
    torch.cuda.empty_cache()
    print(f"15e: the parent holds {torch.cuda.memory_allocated()} B on the "
          f"card before its references", flush=True)
    frefs, fshared = _mm_family_references(torch, seed)
    print(f"15e: {torch.cuda.memory_allocated()} B with them", flush=True)
    init = "file://" + os.path.join(work, "rdv_families")
    procs = [ctx.Process(target=_mm_family_rank,
                         args=(r, MM_WORLD, init, work, seed, fshared))
             for r in range(MM_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    codes = _mm_join(procs, time.monotonic() + MM_TIMEOUT)
    family_ranks_s = time.perf_counter() - t0
    # the unsharded steps' metrics and tokens; the tensors are freed
    fmetrics = {arch: {k: fshared[arch][k] for k in
                       ("loss", "grad_norm", "tokens")}
                for arch in MM_FAMILIES}
    del fshared
    # tensors sent to the ranks stay in CUDA IPC's limbo until collected
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    if any(c != 0 for c in codes):
        errs = []
        for r in range(MM_WORLD):
            path = os.path.join(work, f"family{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f"--- rank {r} ---\n{f.read()}")
        raise AssertionError(f"phase 15e ranks exited {codes}:\n"
                             + ("\n".join(errs) or "no traceback written"))
    fam = []
    for r in range(MM_WORLD):
        with open(os.path.join(work, f"family{r}.json")) as f:
            fam.append(json.load(f))
    run = MM_FAMILY_RUN
    family_flash = family_split = 0
    family_rows = {}
    for arch, layers in MM_FAMILIES.items():
        got = [x[arch] for x in fam]
        g0, ref = got[0], fmetrics[arch]
        cfg_f = _mm_family_cfg(arch)
        # qwen2-moe: one float32 flash call a layer on each rank's 8 of
        # the 16 heads, each with its pre-pass; xLSTM has no attention
        calls = full_length_attention_calls(cfg_f)
        want_pre = {"flash_attention_hopper": calls,
                    "flash_split_kv_hopper": calls}
        want_dec = {"flash_attention_hopper": 0, "flash_split_kv_hopper": 0}
        for x in got:
            if x["prefill_launches"] != want_pre or \
                    x["decode_launches"] != want_dec:
                failures.append(f"15e {arch}: launches a rank: prefill "
                                f"{x['prefill_launches']}, decode "
                                f"{x['decode_launches']}; want {want_pre}, "
                                f"{want_dec}")
        family_flash += sum(x["prefill_launches"]["flash_attention_hopper"]
                            for x in got)
        family_split += sum(x["prefill_launches"]["flash_split_kv_hopper"]
                            for x in got)
        xl = arch == "xlstm-350m"
        limit = (f"relative L2 {FAMILY_TF_F32_REL_L2}" if xl else
                 f"rtol {MM_LOGITS_RTOL}, atol {MM_LOGITS_ATOL}")
        for key in ("prefill", "decode"):
            if not all(x[key]["within"] for x in got):
                failures.append(f"15e {arch}: {key} logits off by "
                                f"{max(x[key]['max_abs_err'] for x in got)}"
                                f" (relative L2 "
                                f"{max(x[key]['rel_l2'] for x in got)}; "
                                f"limit {limit})")
        if any(x["tokens"] != got[0]["tokens"] for x in got):
            failures.append(f"15e {arch}: ranks' tokens differ")
        # relative L2 errors over the ranks' blocks (a replicated block
        # counts once a rank on both sides): each leaf's, and the whole
        # first and second moments'
        sums = {}
        for name in g0["sq"]:
            sums[name] = [sum(x["sq"][name][i] for x in got) for i in (0, 1)]
        rel = {n: (a ** 0.5) / max(b ** 0.5, 1e-30)
               for n, (a, b) in sums.items()}
        whole = {}
        for key in ("m", "v"):
            a = sum(v[0] for n, v in sums.items() if n.startswith(key + "/"))
            b = sum(v[1] for n, v in sums.items() if n.startswith(key + "/"))
            whole[key] = (a ** 0.5) / max(b ** 0.5, 1e-30)
        worst = max(rel, key=rel.get)
        norm_tol = MM_XLSTM_GRAD_REL if xl else MM_LOSS_RTOL
        for i in range(MM_FAMILY_RUN["steps"]):
            for key, tol in (("loss", MM_LOSS_RTOL), ("grad_norm", norm_tol)):
                a, b = g0[key][i], ref[key][i]
                if abs(a - b) > tol * abs(b):
                    failures.append(f"15e {arch}: step {i} {key} {a} vs {b}")
        bad = sum(x["violations"] for x in got)
        bad_m = sum(x["moment_violations"] for x in got)
        if xl:
            if max(whole.values()) > MM_XLSTM_GRAD_REL:
                failures.append(f"15e {arch}: moments' relative L2 {whole} "
                                f"> {MM_XLSTM_GRAD_REL}")
        elif bad or bad_m:
            failures.append(f"15e {arch}: {bad} param and {bad_m} moment "
                            f"elements outside tolerance")
        held = (f"held by the moments' relative L2 {whole['m']:.3e} / "
                f"{whole['v']:.3e} (limit {MM_XLSTM_GRAD_REL}), the "
                f"elementwise counts a reading" if xl else "held")
        coll = g0["collectives_per_step"][-1]
        print(f"15e {arch} full width, {layers} layers (cut from "
              f"{get_config(arch).n_layers}), float32, microbatch "
              f"{cfg_f.microbatch}, remat, (2, 2) mesh: prefill of "
              f"{run['batch']} x {run['seq']} and one decode step: logits "
              f"max abs err {max(x['prefill']['max_abs_err'] for x in got):.3e}"
              f" / {max(x['decode']['max_abs_err'] for x in got):.3e}, "
              f"relative L2 {max(x['prefill']['rel_l2'] for x in got):.3e} / "
              f"{max(x['decode']['rel_l2'] for x in got):.3e} vs unsharded "
              f"(held: {limit}); "
              f"tokens {g0['tokens'] == ref['tokens']} bit for bit "
              f"({g0['tokens'][1][:4]}...); launches a rank prefill "
              f"{g0['prefill_launches']}, decode {g0['decode_launches']}; "
              f"{MM_FAMILY_RUN["steps"]} train step(s) of {run['batch']} x "
              f"{run['seq']}: "
              f"loss {g0['loss']} vs unsharded {ref['loss']}; grad_norm "
              f"{g0['grad_norm']} vs {ref['grad_norm']}; elements outside "
              f"rtol {MM_RTOL} / atol {MM_ATOL}: params {bad} (near eps, at "
              f"2 x steps x lr: {sum(x['near_eps_local'] for x in got)}), "
              f"moments {bad_m} ({held}); largest leaf relative L2 "
              f"{rel[worst]:.3e} ({worst}); step p50 {g0['p50_s']:.3f} s sharded vs "
              f"{frefs[arch]['p50_s']:.3f} s unsharded; rank 0's collectives "
              f"and staged bytes of the last step {coll}; peak memory by "
              f"rank {[round(x['peak_bytes'] / 1e9, 2) for x in got]} GB; "
              f"{g0['seconds']:.1f} s in the ranks", flush=True)
        if g0["tokens"] != ref["tokens"]:
            failures.append(f"15e {arch}: tokens {g0['tokens']} vs "
                            f"unsharded {ref['tokens']}")
        family_rows[arch] = {"train_p50_s": g0["p50_s"],
                             "unsharded_p50_s": frefs[arch]["p50_s"],
                             "staged_last_step": coll,
                             "prefill_launches_per_rank":
                             g0["prefill_launches"]}
    timing = {"references_s": sum(x["seconds"] for x in frefs.values()),
              "ranks_s": family_ranks_s}
    return failures, family_flash, family_split, family_rows, timing


def mesh_models_phase(torch, np, seed: int, smi: str) -> dict:
    """Phase 15, callable alone after ``kernels.build()`` (the ranks load
    the library the parent built: N ranks building into one directory at
    once would race).  (a) each collective the slice uses, on CUDA
    tensors, by plain gloo (one 2-rank group an op, all at once) and by
    the port's staged group; (b) ``spmd_pipeline`` over 4 stages of one
    starcoder2-3b block each (bf16, 8 microbatches of 1 x 2048, no_grad)
    against the same blocks run one after another in this process; (c)
    ``MM_TRAIN`` sharded steps on a (2, 2) mesh against the unsharded
    step here; (d) ``allreduce_compressed`` of a w_up gradient and the
    (2, 2) -> (4, 1) checkpoint; (e) ``mesh_families``, the MoE and
    xLSTM families' sharded prefill, decode step and train step, run
    first, in a spawn of its own.  Returns the readings and the launch
    counts of the kernel JSON."""
    import shutil
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"phase 15: the parent holds {torch.cuda.memory_allocated()} B "
          f"on the card at its start", flush=True)
    work = os.path.join(ROOT, "build", "chip_smoke_mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ctx = mp.get_context("spawn")
    # -- 15e first, a spawn of its own, while the parent holds least on
    # the card: tensors a rank reads through CUDA IPC stay allocated in
    # the parent until the rank releases them, and a rank that exits
    # holding them never does (15c's references stayed, 7.6 GB, and
    # 15e's ranks then overflowed the card) --
    t_e = time.perf_counter()
    efails, family_flash, family_split, family_rows, ftime = mesh_families(
        torch, seed, work, ctx)
    family_s = time.perf_counter() - t_e
    t_ad = time.perf_counter()
    # 15a: plain gloo, one 2-rank group an op, started first so their
    # start-up overlaps the references below
    probes = {}
    for op in MM_PROBE_OPS:
        init = "file://" + os.path.join(work, f"rdv_plain_{op}")
        probes[op] = [ctx.Process(target=_mm_plain_probe,
                                  args=(op, r, MM_PROBE_WORLD, init, work))
                      for r in range(MM_PROBE_WORLD)]
        for p in probes[op]:
            p.start()
    refs, shared = _mm_references(torch, seed)
    print(f"references: 4 blocks one after another on 8 microbatches "
          f"{refs['sequential_ms']:.1f} ms ({refs['pipe_s']:.1f} s with "
          f"the set-up); unsharded step {refs['single_step_s']} s, p50 "
          f"{refs['single_p50_s']:.3f} s (losses {refs['loss']}); "
          f"{refs['seconds']:.1f} s", flush=True)
    deadline = time.monotonic() + 120
    plain = {op: _mm_join(ps, deadline) for op, ps in probes.items()}
    plain_s = time.perf_counter() - t_ad

    init = "file://" + os.path.join(work, "rdv_mesh")
    procs = [ctx.Process(target=_mm_rank,
                         args=(r, MM_WORLD, init, work, seed, shared))
             for r in range(MM_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    codes = _mm_join(procs, time.monotonic() + MM_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    del shared                        # the ranks are gone: free the card
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    if any(c != 0 for c in codes):
        errs = []
        for r in range(MM_WORLD):
            path = os.path.join(work, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f"--- rank {r} ---\n{f.read()}")
        raise AssertionError(f"phase 15 ranks exited {codes}:\n"
                             + ("\n".join(errs) or "no traceback written"))
    res = []
    for r in range(MM_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            res.append(json.load(f))
    failures = []

    # -- 15a --
    print(f"15a collectives on CUDA tensors of cuda:0 ({smi}): plain gloo "
          f"in a {MM_PROBE_WORLD}-rank group an op, the staged group in the "
          f"phase's {MM_WORLD} ranks:")
    print(f"  {'op':24s} {'plain gloo':34s} staged gloo "
          f"(ms, bytes staged by rank 0)")
    table = {}
    for op in MM_PROBE_OPS:
        oks = []
        for r in range(MM_PROBE_WORLD):
            path = os.path.join(work, f"plain_{op}_{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    oks.append(json.load(f)["ok"])
        if all(c == 0 for c in plain[op]) and len(oks) == MM_PROBE_WORLD:
            verdict = "ran, right" if all(oks) else "ran, WRONG result"
        else:
            verdict = f"failed: exit codes {plain[op]}"
        st = [x["staged"][op] for x in res]
        table[op] = {"plain": verdict, "plain_exit": plain[op],
                     "staged_ok": all(s_["ok"] for s_ in st),
                     "staged_ms": st[0]["ms"],
                     "staged_bytes": st[0]["staged_bytes"]}
        print(f"  {op:24s} {verdict:34s} "
              f"{'ran, right' if table[op]['staged_ok'] else 'WRONG'} "
              f"({st[0]['ms']:.2f} ms, {st[0]['staged_bytes']} B)")
        if not table[op]["staged_ok"]:
            failures.append(f"15a: staged {op} gave a wrong result")
    print(f"  backend of the ranks: {res[0]['backend']}; probe launches a "
          f"rank {[x['probe_launches'] for x in res]}", flush=True)

    # -- 15b --
    pipe = [x["pipeline"] for x in res]
    flash = [x["launches"]["flash_attention_hopper"] for x in pipe]
    split = [x["launches"]["flash_split_kv_hopper"] for x in pipe]
    print(f"15b spmd_pipeline: {MM_PIPE['stages']} stages x 1 block of "
          f"{MM_ARCH} (d 3072, 24/2 heads, hd 128, d_ff 12288, bf16), "
          f"{MM_PIPE['microbatches']} microbatches of 1 x {MM_PIPE['seq']}: "
          f"wall {[round(x['ms'], 1) for x in pipe]} ms by rank, "
          f"sequential {refs['sequential_ms']:.1f} ms; bit for bit the "
          f"sequential run on every rank: {[x['equal'] for x in pipe]} "
          f"(max abs diff {[x['max_abs_diff'] for x in pipe]}); flash "
          f"launches by rank {flash}", flush=True)
    if flash != [MM_PIPE["microbatches"]] * MM_WORLD or any(split):
        failures.append(f"15b: flash launches {flash}, split_kv {split}")
    for x in pipe:
        if not x["equal"] and x["rel_l2"] > ATTN_REL_L2:
            failures.append(f"15b: stage {x['stage']} rel L2 {x['rel_l2']}")

    # -- 15c --
    tr = [x["train"] for x in res]
    t0r = tr[0]
    for i in range(MM_TRAIN["steps"]):
        for key in ("loss", "grad_norm"):
            got, want = t0r[key][i], t0r["ref_" + key][i]
            if abs(got - want) > MM_LOSS_RTOL * abs(want):
                failures.append(f"15c: step {i} {key} {got} vs {want}")
    bad = sum(x["violations"] for x in tr)
    bad_m = sum(x["moment_violations"] for x in tr)
    if bad or bad_m:
        failures.append(f"15c: {bad} param and {bad_m} moment elements "
                        f"outside tolerance")
    coll = t0r["collectives_per_step"][-1]
    print(f"15c {MM_ARCH} full width, {MM_TRAIN['n_layers']} layers "
          f"(cut from 30), float32, microbatch "
          f"{_mm_train_cfg().microbatch}, remat, batch {MM_TRAIN['batch']} "
          f"x {MM_TRAIN['seq']}, (2, 2) mesh, {MM_TRAIN['steps']} steps: "
          f"loss {t0r['loss']} vs unsharded {t0r['ref_loss']}; grad_norm "
          f"{t0r['grad_norm']} vs {t0r['ref_grad_norm']}; moments (m, v) "
          f"outside rtol {MM_RTOL} / atol {MM_ATOL}: {bad_m} (largest error "
          f"over a leaf's largest value "
          f"{max(x['moment_err_over_max'] for x in tr):.3e}); params: {bad} "
          f"(elements near eps, "
          f"held to 2 x steps x lr: {sum(x['near_eps_local'] for x in tr)} "
          f"shard elements; max abs err elsewhere "
          f"{max(x['max_abs_err'] for x in tr):.3e}); step p50 "
          f"{t0r['p50_s']:.3f} s sharded vs {refs['single_p50_s']:.3f} s "
          f"unsharded; rank 0's collectives and staged bytes of the last "
          f"step {coll}; peak memory by rank "
          f"{[round(x['peak_bytes'] / 1e9, 2) for x in tr]} GB", flush=True)

    # -- 15d --
    cp = [x["compress"] for x in res]
    ck = [x["checkpoint"] for x in res]
    print(f"15d allreduce_compressed of a {MM_COMPRESS} gradient over "
          f"{MM_WORLD} ranks: max rel err vs the mean "
          f"{max(x['rel'] for x in cp):.4f} (limit {MM_COMPRESS_REL}); "
          f"payload {cp[0]['int8_payload_bytes']} B int8 against "
          f"{cp[0]['float32_payload_bytes']} B float32 (the sum runs on "
          f"{cp[0]['int32_sum_bytes']} B of int32); {cp[0]['ms']:.1f} ms, "
          f"staged {cp[0]['staged']}", flush=True)
    if max(x["rel"] for x in cp) >= MM_COMPRESS_REL:
        failures.append("15d: compressed all-reduce off the mean")
    print(f"15d checkpoint (2, 2) -> (4, 1): equal {[x['equal'] for x in ck]}"
          f", placements {ck[0]['placements']}, save {ck[0]['save_s']:.2f} s"
          f", restore {ck[0]['restore_s']:.2f} s", flush=True)
    if not all(all(x["equal"].values()) and x["step"] == 1 for x in ck):
        failures.append("15d: the elastic restore differs")

    failures += efails
    shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    print(f"phase 15: {phase_s:.1f} s (references {refs['seconds']:.1f} s"
          f", with the plain probe {plain_s:.1f} s; ranks {ranks_s:.1f} s: "
          f"pipeline "
          f"{res[0]['pipeline_s']:.1f} s, train {res[0]['train_s']:.1f} s; "
          f"15e {family_s:.1f} s: references "
          f"{ftime['references_s']:.1f} s, ranks {ftime['ranks_s']:.1f} s)",
          flush=True)
    if failures:
        raise AssertionError("phase 15: " + "; ".join(failures))
    return {"flash_launches": sum(flash), "flash_per_rank": flash,
            "probe_launches": sum(x["probe_launches"] for x in res),
            "pipeline_ms": [x["ms"] for x in pipe],
            "collectives": table, "seconds": phase_s,
            "train_p50_s": t0r["p50_s"],
            "family_flash_launches": family_flash,
            "family_split_launches": family_split,
            "families": family_rows, "family_seconds": family_s}


# -- phase 16: the launchers: the serve CLI and the dry-run ----------------

# 16a: repro_torch.launch.serve at full width, in this process, twice
LAUNCH_SERVE = {"arch": "gemma2-2b", "requests": 6, "batch": 4,
                "max_new": 16, "quant_bits": (0, 8)}
# 16b: dry-run cells (arch, shape, multi_pod), each in a process of its
# own, all at once; traced on fake CUDA tensors over a fake process group
DRYRUN_CELLS = [("starcoder2-3b", "train_4k", False),
                ("starcoder2-3b", "prefill_32k", False),
                ("starcoder2-3b", "decode_32k", False),
                ("gemma2-2b", "decode_32k", False),
                ("starcoder2-3b", "train_4k", True),
                ("qwen2-moe-a2.7b", "prefill_32k", False),
                ("qwen2-moe-a2.7b", "decode_32k", False),
                ("grok-1-314b", "decode_32k", False),
                ("grok-1-314b", "train_4k", False),
                ("grok-1-314b", "train_4k", True),
                ("xlstm-350m", "decode_32k", False),
                ("xlstm-350m", "long_500k", False),
                ("xlstm-350m", "prefill_32k", False),
                ("xlstm-350m", "train_4k", False),
                ("xlstm-350m", "train_4k", True)]
# cells also traced with every loop run whole (dryrun.lower_cell(
# whole_loops=True)), in processes of their own, each held to its
# loop-aware record: FLOPs, replicated FLOPs, HBM bytes and collective
# bytes by kind at DRYRUN_LOOP_REL, temp bytes (a peak) at
# DRYRUN_LOOP_TEMP_REL, as tests/test_torch_launch.py holds them
DRYRUN_WHOLE = [("starcoder2-3b", "prefill_32k", False),
                ("xlstm-350m", "long_500k", False),
                ("starcoder2-3b", "train_4k", False)]
DRYRUN_LOOP_REL = 1e-9
DRYRUN_LOOP_TEMP_REL = 0.05
DRYRUN_TIMEOUT = 600
# a cell's share of the work times its ranks against the same step
# traced on one fake device with no mesh
DRYRUN_SHARE_REL = 1e-9
# (FLOPs, replicated FLOPs) a device of the CPU sweep (tools/dryrun_sweep.py
# on torch 2.13) that the card's trace must give at DRYRUN_SHARE_REL:
# grok-1-314b's train step, whose expert FFN torch 2.11's DTensor plans
# only expert-major
DRYRUN_SWEEP_FLOPS = {
    ("grok-1-314b", "train_4k", False): (4648666442760192.0,
                                         1198295875584000.0),
    ("grok-1-314b", "train_4k", True): (4648666442760192.0,
                                        2923481159172096.0),
}


def _dryrun_tag(arch: str, shape: str, multi_pod: bool,
                mode: str = "record") -> str:
    return (f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"
            + ("" if mode == "record" else f"__{mode}"))


def _unsharded_apart(shape: str) -> bool:
    """A train cell's unsharded trace runs in a process of its own (the
    longest cells' two traces in parallel); a prefill's or a decode's
    follows its record in the record's process."""
    return shape == "train_4k"


def _dryrun_cell(arch: str, shape: str, multi_pod: bool, work: str,
                 mode: str = "record") -> None:
    """One 16b trace in a process of its own, on fake CUDA tensors, with
    this process's kernel launches and ``torch.cuda.memory_allocated()``
    around it; the readings go to ``work/<tag>.json``, a traceback to
    ``<tag>.err``.  ``mode``: ``"record"`` — ``dryrun.lower_cell``, then
    (unless a multi-pod twin or ``_unsharded_apart``) the same step on
    one fake device with no mesh; ``"whole"`` — ``lower_cell`` with
    every loop run whole, no unsharded trace; ``"unsharded"`` — that
    unsharded trace alone."""
    tag = _dryrun_tag(arch, shape, multi_pod, mode)
    # the host's cores go first to the parent, which runs phase 17 on the
    # card meanwhile
    os.nice(19)
    try:
        import torch
        torch.set_num_threads(1)
        sys.path.insert(0, os.path.join(ROOT, "src"))
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.launch import dryrun as DR
        torch.cuda.init()
        # this process's card context now, while the card has room: the
        # parent starts phase 17 once every cell is ready
        torch.empty(1, device="cuda")
        open(os.path.join(work, tag + ".ready"), "w").close()
        reset_all_launch_counts()
        # where any card memory is allocated, with its Python stack
        torch.cuda.memory._record_memory_history(max_entries=1000)
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        rec = None if mode == "unsharded" else DR.lower_cell(
            arch, shape, multi_pod, device="cuda",
            whole_loops=mode == "whole")
        wall = time.perf_counter() - t0
        # the same step on one fake device with no mesh (a multi-pod
        # cell reads its (16, 16) twin's: no mesh, the same trace)
        t0 = time.perf_counter()
        twin = multi_pod and (arch, shape, False) in DRYRUN_CELLS
        skip = mode == "whole" or (mode == "record" and (
            twin or _unsharded_apart(shape)))
        one = None if skip else DR.unsharded_flops(
            get_config(arch), SHAPES[shape], device="cuda")
        res = {"record": rec, "wall_s": wall, "unsharded": one,
               "unsharded_s": time.perf_counter() - t0,
               "launches": launched(), "allocated_before": before,
               "allocated_after": torch.cuda.memory_allocated(),
               "max_allocated": torch.cuda.max_memory_allocated(),
               "allocations": [
                   {"bytes": e["size"], "frames": [
                       f"{f['filename']}:{f['line']} {f['name']}"
                       for f in e.get("frames", [])
                       if f["filename"].endswith(".py")][:12]}
                   for trace in torch.cuda.memory._snapshot()[
                       "device_traces"] for e in trace
                   if e["action"] == "alloc"][:8]}
        torch.cuda.memory._record_memory_history(enabled=None)
        with open(os.path.join(work, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1)
    except BaseException:
        import traceback
        with open(os.path.join(work, tag + ".err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def _spec_bytes(torch, tree, specs, axes: dict) -> int:
    """Local bytes of ``tree`` 's tensors under the matching ``specs``:
    each leaf's elements over the product of the mesh axes its spec
    names, times its item size (the count the 16b cells' own
    ``argument_bytes`` must equal)."""
    if isinstance(tree, dict):
        return sum(_spec_bytes(torch, tree[k], specs[k], axes)
                   for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(_spec_bytes(torch, t, sp, axes)
                   for t, sp in zip(tree, specs))
    if not isinstance(tree, torch.Tensor):
        return 0                      # AdamWState.step, the cache's pos
    ways = 1
    for entry in specs:
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            ways *= axes[ax]
    if tree.numel() % ways:
        raise AssertionError(f"a spec {specs} that does not divide "
                             f"{tuple(tree.shape)}")
    return tree.numel() // ways * tree.element_size()


def _expected_arguments(torch, arch: str, shape_name: str,
                        multi_pod: bool) -> int:
    """Rank 0's argument bytes of a cell from the config's shapes and the
    sharding rules alone: params by ``param_specs``, moments (float32)
    by ``zero1_spec``, the batch by ``batch_spec``, a decode cell's cache
    by ``cache_specs``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import get_model
    from repro_torch.models import sharding as SH
    from repro_torch.models.zoo import cache_specs_for, input_specs
    cfg, shape = get_config(arch), SHAPES[shape_name]
    axes = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    with FakeTensorMode():
        params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                     device="cpu")
    pspecs = SH.param_specs(params, axes, cfg.fsdp)
    total = _spec_bytes(torch, params, pspecs, axes)
    batch = input_specs(cfg, shape)
    total += _spec_bytes(torch, batch, {k: SH.batch_spec(tuple(v.shape),
                                                         axes)
                                        for k, v in batch.items()}, axes)
    if shape.kind == "train":
        def moment_bytes(p, sp):
            if isinstance(p, dict):
                return sum(moment_bytes(p[k], sp[k]) for k in p)
            zsp = SH.zero1_spec(sp, tuple(p.shape), axes)
            return 4 * _spec_bytes(torch, p, zsp, axes) // p.element_size()
        total += 2 * moment_bytes(params, pspecs)
    elif shape.kind == "decode":
        cache = cache_specs_for(cfg, shape)
        total += _spec_bytes(torch, cache, SH.cache_specs(
            cache, axes, shape.global_batch), axes)
    return total


def _dense_step_flops(cfg, shape) -> int:
    """Global FLOPs of one prefill or decode step of a dense decoder, from
    its config alone (the count a 16b cell's share must equal, over its
    ranks): the projections' and the MLP's dots on every position, the
    LM head on the returned positions (the last of a prefill), and 4 a
    head dim a (query, key) pair — the pairs the flash kernel's mask
    lets through in a prefill, the whole cache buffer (a local layer's
    ring of ``window`` slots) in a decode."""
    d, b, s = cfg.d_model, shape.global_batch, shape.seq_len
    nmat = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    layer = 2 * d * (2 * cfg.q_dim + 2 * cfg.kv_dim) \
        + 2 * nmat * d * cfg.d_ff
    tokens = b * s if shape.kind == "prefill" else b
    total = tokens * cfg.n_layers * layer + b * 2 * d * cfg.padded_vocab
    for lt in cfg.layer_types:
        window = cfg.window if lt == "local" else 0
        pairs = (visible_pairs(s, s, True, window) if shape.kind == "prefill"
                 else min(window, s) if window else s)
        total += 4 * b * cfg.n_heads * cfg.head_dim * pairs
    return total


def launchers_phase(torch, np, seed: int, smi: str, during=None) -> dict:
    """Phase 16.  (a) ``python -m repro_torch.launch.serve --arch
    gemma2-2b --no-reduced`` (``serve.main``) in this process, once in
    bf16 and once with ``--quant-bits 8``: 6 requests at batch 4,
    ``max_new`` 16, every request exactly 16 tokens, exactly ``waves x
    26`` flash launches (one a full-length attention layer a prefill,
    none a decode step) and no other kernel, the tokens equal to
    ``ServingEngine.serve`` called directly on the same weights; tok/s
    printed as a smoke reading (96 tokens a run: no throughput).  (b)
    then ``DRYRUN_CELLS`` through ``dryrun.lower_cell`` on fake CUDA
    tensors over a fake 256 / 512-rank group, each in a process of its
    own, all at once: no kernel launched,
    ``memory_allocated`` 0 before and after, and no allocation on the
    card but PyTorch's own (FakeTensorMode's one-element context probe,
    its Python stack read from the allocator's history),
    ``argument_bytes`` equal to ``_expected_arguments``, the prefill
    cell's flash op called once a
    layer with ``4 B H hd`` FLOPs a visible pair on the rank's batch rows
    and heads, all but a model rank's share of them repeated where the
    heads do not split; a prefill or decode cell's share of the work
    (``loop_aware.flops`` less ``replicated.flops``) times its ranks the
    FLOPs of the same step traced on one fake device with no mesh
    (``dryrun.unsharded_flops``; a train cell's in a process of its own,
    ``_unsharded_apart``) at ``DRYRUN_SHARE_REL`` in every cell,
    train cells included, and for a dense decoder's prefill or decode
    also the step's analytic count (``_dense_step_flops``) over its
    ranks, and the ``DRYRUN_SWEEP_FLOPS`` cells' FLOPs and replicated
    FLOPs the CPU sweep's; each cell's counted loops and trace seconds
    printed; the
    ``DRYRUN_WHOLE`` cells also traced with every loop run whole, in
    processes of their own started first, and held to their loop-aware
    records at ``DRYRUN_LOOP_REL`` (temp bytes at
    ``DRYRUN_LOOP_TEMP_REL``); each record written under
    ``build/chip_smoke_dryrun``.  The cells' processes run at a lower
    priority (``os.nice``) while ``during()``, if given, runs in this
    process (the script's phase 17: its training is the card's, theirs
    the host's); their records are read after it.
    Returns the readings, the serve CLI's flash launches for the kernel
    JSON and ``during()`` 's result."""
    import contextlib
    import io
    import re
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import get_model
    from repro_torch.serving import ServingEngine
    t_phase = time.perf_counter()

    # -- 16a: alone, before 16b's processes load the host --
    ls = LAUNCH_SERVE
    cfg = get_config(ls["arch"])
    waves = -(-ls["requests"] // ls["batch"])
    want = {"flash_attention_hopper":
            waves * full_length_attention_calls(cfg)}
    serve_rows, flash_launches = [], 0
    for quant in ls["quant_bits"]:
        argv = ["--arch", ls["arch"], "--no-reduced", "--requests",
                str(ls["requests"]), "--batch-size", str(ls["batch"]),
                "--max-new", str(ls["max_new"]), "--quant-bits", str(quant)]
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_all_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            got = serve_mod.main(argv)
        wall = time.perf_counter() - t0
        counts = launched()
        text = buf.getvalue().strip()
        print(f"16a python -m repro_torch.launch.serve {' '.join(argv)} "
              f"({wall:.1f} s with the weights' init):")
        for line in text.splitlines():
            print(f"  {line}")
        if counts != want:
            raise AssertionError(f"serve CLI (quant {quant}) launched "
                                 f"{counts}, want {want}")
        if sorted(got) != list(range(ls["requests"])) or any(
                len(v) != ls["max_new"] for v in got.values()):
            raise AssertionError(f"serve CLI (quant {quant}): "
                                 f"{ {k: len(v) for k, v in got.items()} }")
        rate = float(re.search(r"\(([0-9.]+) tok/s", text).group(1))
        flash_launches += counts["flash_attention_hopper"]
        bundle = get_model(cfg)
        params = bundle.init(torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
        eng = ServingEngine(bundle, batch_size=ls["batch"],
                            quant_bits=quant)
        eng.load(params, device="cuda")
        del params
        direct = eng.serve(serve_mod.requests_for(ls["requests"], cfg.vocab,
                                                  ls["max_new"]))
        del eng
        torch.cuda.empty_cache()
        if direct != got:
            raise AssertionError(f"serve CLI (quant {quant}) tokens differ "
                                 f"from ServingEngine.serve's")
        print(f"  launches {counts} ({waves} waves x "
              f"{full_length_attention_calls(cfg)} attention layers, 0 a "
              f"decode step); tokens == ServingEngine.serve's on the same "
              f"weights; {rate} tok/s (a smoke reading of "
              f"{ls['requests'] * ls['max_new']} tokens, not a throughput; "
              f"{smi})", flush=True)
        serve_rows.append({"quant_bits": quant, "launches": counts,
                           "smoke_tok_per_s": rate, "wall_s": wall})

    # -- 16b --
    work = os.path.join(ROOT, "build", "chip_smoke_dryrun")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ctx = mp.get_context("spawn")
    # the whole traces first: the longest
    runs = [cell + ("whole",) for cell in DRYRUN_WHOLE] + [
        cell + ("record",) for cell in DRYRUN_CELLS] + [
        cell + ("unsharded",) for cell in DRYRUN_CELLS
        if not cell[2] and _unsharded_apart(cell[1])]
    procs = {run: ctx.Process(target=_dryrun_cell,
                              args=(*run[:3], work, run[3]))
             for run in runs}
    for p in procs.values():
        p.start()
    deadline = time.monotonic() + DRYRUN_TIMEOUT
    t_ready = time.perf_counter()
    while time.monotonic() < deadline and not all(
            os.path.exists(os.path.join(work, _dryrun_tag(*run) + ".ready"))
            or p.exitcode is not None for run, p in procs.items()):
        time.sleep(0.2)
    free, total = torch.cuda.mem_get_info()
    print(f"16b: {len(procs)} processes hold their card contexts after "
          f"{time.perf_counter() - t_ready:.1f} s; the card has {free} of "
          f"{total} B free", flush=True)
    during_out = during() if during is not None else None
    codes = _mm_join(list(procs.values()), deadline)
    errs = []
    for cell, code in zip(procs, codes):
        path = os.path.join(work, _dryrun_tag(*cell) + ".err")
        if code != 0:
            errs.append(f"--- {cell} exit {code} ---\n" + (
                open(path).read() if os.path.exists(path) else
                "no traceback written"))
    if errs:
        raise AssertionError("16b dry-run cells failed:\n" + "\n".join(errs))
    cells = {}
    print(f"16b dry-run on fake CUDA tensors, rank 0 of a fake group "
          f"({smi}; the records are per device of the (2 x) 16 x 16 mesh, "
          f"counted, not timed):")
    failures = []
    for arch, shape_name, multi_pod in DRYRUN_CELLS:
        tag = _dryrun_tag(arch, shape_name, multi_pod)
        with open(os.path.join(work, tag + ".json")) as f:
            res = json.load(f)
        rec = res["record"]
        with open(os.path.join(work, tag + ".record.json"), "w") as f:
            json.dump(rec, f, indent=2)
        # the one allocation allowed is PyTorch's own: FakeTensorMode
        # makes one real 1-element tensor on a device the first time it
        # fakes a tensor there (fake_tensor.py, init_gpu_context)
        ours = [a for a in res["allocations"] if a["bytes"] > 4 or not any(
            "init_gpu_context" in f for f in a["frames"])]
        if res["launches"] or res["allocated_before"] \
                or res["allocated_after"] or ours:
            failures.append(f"{tag}: launches {res['launches']}, allocated "
                            f"{res['allocated_before']} -> "
                            f"{res['allocated_after']} (max "
                            f"{res['max_allocated']}) at "
                            f"{json.dumps(ours, indent=1)}")
        want_args = _expected_arguments(torch, arch, shape_name, multi_pod)
        if rec["memory"]["argument_bytes"] != want_args:
            failures.append(f"{tag}: argument_bytes "
                            f"{rec['memory']['argument_bytes']} != "
                            f"{want_args} from the specs")
        cfg_c, shape = get_config(arch), SHAPES[shape_name]
        fl = rec["flash_attention"]
        la, mem, rep = rec["loop_aware"], rec["memory"], rec["replicated"]
        share = la["flops"] - rep["flops"]
        if shape.kind == "prefill":
            model = 16
            data = 32 if multi_pod else 16
            b_local = shape.global_batch // data
            # split_dim gathers heads that do not split over the model
            # axis; on_local_heads then attends over all of them on
            # every model rank
            split = (cfg_c.n_heads % model == 0
                     and cfg_c.n_kv_heads % model == 0)
            h_local = cfg_c.n_heads // model if split else cfg_c.n_heads
            calls = full_length_attention_calls(cfg_c)
            per = 4 * b_local * h_local * cfg_c.head_dim * visible_pairs(
                shape.seq_len, shape.seq_len, True, 0)
            want_fl = {"calls": calls, "flops": float(calls * per)}
            # its FLOPs repeated on the other model ranks
            want_rep = 0.0 if split else float(calls * per * (model - 1)
                                               // model)
            got_rep = rep["by_op"].get("repro_torch.flash_attention", 0.0)
            if fl != want_fl or got_rep != want_rep:
                failures.append(f"{tag}: flash op {fl}, {got_rep} of its "
                                f"FLOPs repeated; want {want_fl}, "
                                f"{want_rep}")
        elif fl["calls"]:
            failures.append(f"{tag}: flash op called {fl}")
        # the share times the ranks over the unsharded trace's FLOPs: 1
        # where no work was lost and none counted twice, the loops
        # counted alike in both
        if res["unsharded"] is None:
            apart = _unsharded_apart(shape_name)
            with open(os.path.join(work, _dryrun_tag(
                    arch, shape_name, False,
                    "unsharded" if apart else "record") + ".json")) as f:
                one = json.load(f)
            if one["launches"] or one["allocated_after"]:
                failures.append(f"{tag} unsharded: launches "
                                f"{one['launches']}, allocated "
                                f"{one['allocated_after']}")
            res["unsharded"] = one["unsharded"]
            res["unsharded_s"] = None if multi_pod else one["unsharded_s"]
        ratio = share * rec["n_devices"] / res["unsharded"]["flops"]
        if abs(ratio - 1.0) > DRYRUN_SHARE_REL:
            failures.append(f"{tag}: share x {rec['n_devices']} ranks "
                            f"over the unsharded step's FLOPs {ratio!r}")
        sweep = DRYRUN_SWEEP_FLOPS.get((arch, shape_name, multi_pod))
        if sweep and any(abs(g - w) > DRYRUN_SHARE_REL * w for g, w in zip(
                (la["flops"], rep["flops"]), sweep)):
            failures.append(f"{tag}: FLOPs {la['flops']!r}, replicated "
                            f"{rep['flops']!r}; the CPU sweep's {sweep}")
        dense_held = cfg_c.family == "dense" and shape.kind != "train"
        if dense_held:
            want_share = _dense_step_flops(cfg_c, shape) / rec["n_devices"]
            if share != want_share:
                failures.append(f"{tag}: FLOPs less replicated {share}, "
                                f"the step's analytic count a device "
                                f"{want_share}")
        coll = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in
                         la["collective_bytes"].items() if v)
        held = (f"; x {rec['n_devices']} ranks over the unsharded step's "
                f"{res['unsharded']['flops']:.4e}: {ratio!r}, held at "
                f"{DRYRUN_SHARE_REL}"
                + (", and the analytic count" if dense_held else "")
                + (", and the CPU sweep's FLOPs and replicated FLOPs"
                   if sweep else ""))
        loops = ", ".join(f"{n} x {t}" for n, t in la["while_loops"])
        print(f"  {tag}: loops [{loops}] (trip-blind "
              f"{rec['cost']['flops_per_device_naive']:.4e} FLOPs); "
              f"traced in {rec['lower_s']} s ({res['wall_s']:.1f} "
              f"s in its process; unsharded "
              + ("the 16 x 16 cell's" if res["unsharded_s"] is None
                 else f"{res['unsharded_s']:.1f} s"
                 + (" in a process of its own"
                    if _unsharded_apart(shape_name) else "")) + "); "
              f"{la['flops']:.4e} FLOPs ("
              f"{rep['flops']:.4e} repeated by other ranks, the rank's "
              f"share {share:.4e}{held}), "
              f"{la['hbm_bytes']:.4e} HBM bytes, collectives "
              f"{la['collective_count']:.0f} ({coll} GB); arguments "
              f"{mem['argument_bytes']} B (the specs' count {want_args}), "
              f"outputs {mem['output_bytes']}, temp {mem['temp_bytes']}; "
              f"flash op {fl['calls']} calls, {fl['flops']:.6e} FLOPs; "
              f"launches {res['launches']}, card bytes allocated "
              f"{res['allocated_before']} -> {res['allocated_after']} (max "
              f"{res['max_allocated']}: {len(res['allocations'])} "
              f"allocation(s), "
              f"{sum(a['bytes'] for a in res['allocations'])} B, all "
              f"FakeTensorMode's context probe)", flush=True)
        cells[tag] = {"seconds": rec["lower_s"], "wall_s": res["wall_s"],
                      "unsharded_flops": res["unsharded"]["flops"],
                      "unsharded_s": res["unsharded_s"],
                      "share_ratio": ratio,
                      "while_loops": la["while_loops"],
                      "flops": la["flops"], "replicated_flops": rep["flops"],
                      "hbm_bytes": la["hbm_bytes"],
                      "collective_bytes": la["collective_bytes"],
                      "memory": mem, "flash_attention": fl}
    # the loop-aware records against the same cells traced whole
    for cell in DRYRUN_WHOLE:
        tag = _dryrun_tag(*cell)
        with open(os.path.join(work, _dryrun_tag(*cell, "whole")
                               + ".json")) as f:
            res = json.load(f)
        rec, got = res["record"], cells[tag]
        with open(os.path.join(work, _dryrun_tag(*cell, "whole")
                               + ".record.json"), "w") as f:
            json.dump(rec, f, indent=2)
        la = rec["loop_aware"]
        if res["launches"] or res["allocated_after"]:
            failures.append(f"{tag} whole: launches {res['launches']}, "
                            f"allocated {res['allocated_after']}")
        pairs = [("flops", got["flops"], la["flops"]),
                 ("replicated", got["replicated_flops"],
                  rec["replicated"]["flops"]),
                 ("hbm_bytes", got["hbm_bytes"], la["hbm_bytes"])] + [
            (k, got["collective_bytes"][k], la["collective_bytes"][k])
            for k in la["collective_bytes"]]
        off = [(k, a, w) for k, a, w in pairs
               if abs(a - w) > DRYRUN_LOOP_REL * abs(w)]
        temp_a, temp_w = got["memory"]["temp_bytes"], \
            rec["memory"]["temp_bytes"]
        if abs(temp_a - temp_w) > DRYRUN_LOOP_TEMP_REL * temp_w:
            off.append(("temp_bytes", temp_a, temp_w))
        if la["while_loops"] or off:
            failures.append(f"{tag}: loop-aware against whole {off}, "
                            f"whole loops {la['while_loops']}")
        print(f"  {tag} traced whole (every loop every trip): "
              f"{rec['lower_s']} s against {got['seconds']} s loop-aware; "
              f"FLOPs {la['flops']:.6e}, replicated "
              f"{rec['replicated']['flops']:.6e}, HBM bytes "
              f"{la['hbm_bytes']:.6e}, collectives equal at "
              f"{DRYRUN_LOOP_REL}; temp {temp_w} against {temp_a} "
              f"({temp_a / temp_w - 1:+.2e}, held at "
              f"{DRYRUN_LOOP_TEMP_REL})", flush=True)
        got["whole"] = {"seconds": rec["lower_s"], "flops": la["flops"],
                        "hbm_bytes": la["hbm_bytes"],
                        "temp_bytes": temp_w}
    if failures:
        raise AssertionError("16b:\n" + "\n".join(failures))
    seconds = time.perf_counter() - t_phase
    print(f"phase 16: {seconds:.1f} s"
          + (" (phase 17 ran within it)" if during is not None else ""),
          flush=True)
    return {"flash_launches": flash_launches, "serve": serve_rows,
            "dryrun": cells, "seconds": seconds, "during": during_out}


# -- phase 19: the paper's own signal workloads on the card ----------------
# The workloads of src/repro/configs/sigdla_paper.py (Table I, Fig 7, Fig 8,
# Fig 10) at the paper's sizes, as SignalGraphs compiled on the hopper
# backend: the FFT at 128-1024 points (one chain of log2 n butterflies, one
# tile a row; above 48 KB of shared memory the chain launch needs the
# opt-in), FFT -> iFFT at 1024, the FIR of 256 samples with 20, 40 and 80
# taps (80 taps also in 8 phases), the DCT-II of 32 (t 32, the first t of
# eight partial sums; the 2-D transform of a 32 x 32 block is two calls
# with a transpose between them), the Haar and db2
# DWT of 1024, and front1024: the 1024-point audio front end (a learnable
# FIR of 80 taps, STFT frame 1024 hop 512, one-sided magnitude, 64 mels at
# 16 kHz) over 1.02 s of samples.  Batches: 4096 rows (4096 DCT blocks,
# 131072 rows of 32), front1024 64.
SUITE_FFT_N = (128, 256, 512, 1024)
SUITE_FIR_TAPS = (20, 40, 80)
SUITE_BATCH, SUITE_FRONT_BATCH = 4096, 64
SUITE_REL = 1e-4            # rtol, and atol as this times max|want|: an
#                             n-point FFT's outputs grow as sqrt(n)
SUITE_BF16 = ("fft1024", "front1024")       # chains also run in bfloat16
SUITE_BF16_REL = 2e-2
SUITE_GRAD_TOL = (1e-4, 1e-5)               # Fig 9's (phase 7)
SUITE_TRAIN_STEPS, SUITE_TRAIN_LR = 6, 1e-2
SUITE_REQUESTS, SUITE_SERVE_BATCH = 64, 8
SUITE_STREAM_ROWS = 8
SUITE_STREAM = {"fir256_80": (100, 37), "front1024": (5000, 1234)}
SUITE_STREAM_REFUSED = {"front1024": "stft and istft must appear together"}
SUITE_STREAM_ATOL = 1e-5                    # Fig 9's streamed ``out``
SUITE_BUDGET_S = 180
# Dynamic shared memory of a block of each chain launch at its segment's
# slots (kernels/shuffle_gemm/chain.py shared_bytes): one tile a batch row
# (front1024: 31), a block holding up to 2048 rows of tiles at once —
# fft128 32 slots, fft256 16, fft512 8, fft1024 and front1024 4 — beside
# the tables and operands it stages once (fft1024: 140,016 B).
SUITE_SHARED_BYTES = {"fft128": 80368, "fft256": 96832, "fft512": 131744,
                      "fft1024": 205552, "fft_ifft1024": 205552,
                      "front1024": 205552}


def _suite_launches(blocks: int = 0, grouped: int = 0, chain: int = 0):
    return {"shuffle_gemm_blocks": blocks,
            "shuffle_gemm_grouped_blocks": grouped,
            "shuffle_gemm_chain": chain}


# Launches of one forward of each suite workload on hopper, at fuse 0, 1
# and 2: at fuse 0 the butterflies' standalone gathers split every run, so
# each butterfly is one grouped launch; at fuse 1 and 2 a stage's
# butterflies are one chain segment (one launch).  Each fused_gemm route is
# one shuffle_gemm_blocks launch (dct2_32: two calls, rows then columns).
SUITE_LAUNCHES = {
    **{f"fft{n}": (_suite_launches(grouped=n.bit_length() - 1),
                   _suite_launches(chain=1), _suite_launches(chain=1))
       for n in SUITE_FFT_N},
    "fft_ifft1024": (_suite_launches(grouped=20), _suite_launches(chain=2),
                     _suite_launches(chain=2)),
    **{f"fir256_{t}": (_suite_launches(blocks=1),) * 3
       for t in SUITE_FIR_TAPS},
    "fir256_80_phased": (_suite_launches(blocks=1),) * 3,
    "dct2_32": (_suite_launches(blocks=2),) * 3,
    "dwt_haar": (_suite_launches(blocks=1),) * 3,
    "dwt_db2": (_suite_launches(blocks=1),) * 3,
    "front1024": (_suite_launches(blocks=2, grouped=10),
                  _suite_launches(blocks=2, chain=1),
                  _suite_launches(blocks=2, chain=1)),
}
# front1024's value_and_grad (wrt the FIR taps and the mel weights) at fuse
# 2: the forward's 2 + 1, then the backward's 3 + 1: the mel GEMM's
# transposed GEMM (rows 31, t 64, n_out 513: its input depends on the taps)
# and its width-1 adjoint reduction (no chain to fold it into), the STFT
# chain's backward list (10 transposed butterflies, the width-1 adjoints
# folded) as one chain, and the framing adjoint (frames overlap by the hop:
# width 2); the FIR's and the mel's d_w are einsums (no kernel).
SUITE_TRAIN_LAUNCHES = _suite_launches(blocks=5, chain=2)


def paper_suite(SignalGraph, seed: int = 0) -> dict:
    """The paper's signal workloads as graphs of ``SignalGraph`` (either
    package's class): ``{name: (graph, length, batch on the card)}``, the
    names the workload keys of ``configs/sigdla_paper.py``.  FIR taps come
    from ``seed`` (numpy); each graph's output is ``y``, front1024's
    ``mel``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    suite = {}

    def graph(name, build, length, batch=SUITE_BATCH, out="y"):
        g = SignalGraph(name)
        build(g)
        g.outputs(out)
        suite[name] = (g, length, batch)

    for n in SUITE_FFT_N:
        graph(f"fft{n}", lambda g: g.fft("y", "input"), n)
    graph("fft_ifft1024", lambda g: (g.fft("f", "input"), g.ifft("y", "f")),
          1024)
    for t in SUITE_FIR_TAPS:
        taps = rng.standard_normal(t) / np.sqrt(t)
        graph(f"fir256_{t}", lambda g: g.fir("y", "input", taps=taps), 256)
    taps = rng.standard_normal(80) / np.sqrt(80)
    graph("fir256_80_phased",
          lambda g: g.fir("y", "input", taps=taps, phases=8), 256)
    graph("dct2_32", lambda g: g.dct("y", "input"), 32)
    for w in ("haar", "db2"):
        graph(f"dwt_{w}", lambda g: g.dwt("y", "input", wavelet=w), 1024)
    front = rng.standard_normal(80) / np.sqrt(80)

    def front1024(g):
        g.fir("front", "input", taps=front)
        g.stft("spec", "front", frame=1024, hop=512)
        g.magnitude("mag", "spec", onesided=True)
        g.mel_filterbank("mel", "mag", sr=16_000, n_mels=64)
    graph("front1024", front1024, 16384, SUITE_FRONT_BATCH, out="mel")
    return suite


def suite_input(np, rng, name: str, length: int, batch: int):
    """A float32 standard-normal input of a suite workload: ``(batch,
    length)``, dct2_32's ``(batch, 32, 32)`` blocks."""
    shape = (batch, length, length) if name == "dct2_32" else (batch, length)
    return rng.standard_normal(shape).astype(np.float32)


def suite_forward(name: str, compiled, x, params=None) -> dict:
    """One forward of a suite workload through ``compiled`` (either
    package's): the graph's outputs; dct2_32 takes ``(blocks, 32, 32)``
    and returns the 2-D DCT-II of each block, the graph over rows, then
    over the columns."""
    if name != "dct2_32":
        return compiled(x, params)
    b, n, _ = x.shape
    y = compiled(x.reshape(b * n, n), params)["y"].reshape(b, n, n)
    y = compiled(y.swapaxes(1, 2).reshape(b * n, n), params)["y"]
    return {"y": y.reshape(b, n, n).swapaxes(1, 2)}


def suite_close(torch, label: str, got, want, rel: float) -> float:
    """Max abs error of ``got`` against ``want`` (same shape, finite),
    held at rtol ``rel`` and atol ``rel * max|want|``."""
    got, want = got.detach(), want.detach()
    if got.is_floating_point():
        got, want = got.float(), want.float()
    if tuple(got.shape) != tuple(want.shape) \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: shape {tuple(got.shape)} (want "
                             f"{tuple(want.shape)}) or non-finite values")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rel, atol=rel * scale):
        raise AssertionError(f"{label}: max abs err {err:.3e} beyond rtol "
                             f"{rel}, atol {rel} x {scale:.3e}")
    return err


def _fir_conv1d(torch, x, taps):
    """The causal FIR ``y[n] = sum_k taps[k] x[n - k]`` as one
    ``F.conv1d`` (flipped taps, the left pad outside)."""
    import torch.nn.functional as F
    xin = F.pad(x[:, None], (taps.numel() - 1, 0))
    w = taps.flip(0)[None, None]
    return lambda: F.conv1d(xin, w)[:, 0]


def fft_entry_reading(torch, z) -> tuple:
    """One ``fft_hopper`` call on the complex64 rows ``z`` (phases 6 and
    19): its one launch checked and its result held against
    ``torch.fft.fft`` (rtol = atol = 2e-3), then its ``fft_stages_hopper``
    call held against the plain version (1e-4) and timed beside its bound
    and ``torch.fft.fft`` on ``z``.  Returns (the call's arguments, the
    bound as ``bound`` gives it, the reading)."""
    from repro_torch.kernels.fft_stage import (fft_hopper, fft_stages_hopper,
                                               ref_fft_stages_hopper)
    from repro_torch.kernels.fft_stage import kernel as fft_kernel
    with torch.no_grad():
        fft_kernel.reset_launch_counts()
        y = fft_hopper(z)
        torch.cuda.synchronize()
        counts = fft_kernel.launch_counts()
        lib_y = torch.fft.fft(z)
    if counts != {"fft_stages_hopper": 1}:
        raise AssertionError(f"fft_hopper over {z.shape[-1]} points "
                             f"launched {counts}")
    torch.testing.assert_close(y, lib_y, rtol=2e-3, atol=2e-3)
    (_, a), = record_calls(torch, lambda: fft_hopper(z),
                           "repro_torch.kernels.fft_stage.ops",
                           ("fft_stages_hopper",))
    with torch.no_grad():
        got, want = fft_stages_hopper(**a), ref_fft_stages_hopper(**a)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        k_ms = device_ms(torch, lambda: fft_stages_hopper(**a))
        p_ms = device_ms(torch, lambda: ref_fft_stages_hopper(**a))
        l_ms = device_ms(torch, lambda: torch.fft.fft(z))
    b_, n2 = a["x"].shape
    n_st = len(a["nb"])
    # one read and one write of the frames, the indices, the scatter and
    # the twiddles; 8 flops an element a stage
    b = bound(2 * 4 * b_ * n2 + 4 * (a["idx"].numel() + a["scatter"].numel()
                                     + a["tw"].numel()),
              8 * b_ * n2 * n_st, FP32_FLOP_PER_S)
    return a, b, {
        "n": z.shape[-1], "rows": b_, "stages": n_st, "launches": counts,
        "max_abs_err": err, "library_err": float((y - lib_y).abs().max()),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b[0],
        "bound_by": "bytes" if b[1] >= b[2] else "operations",
        "library_ms": l_ms, "library": "torch.fft.fft"}


def fir_entry_reading(torch, x, h, phases: int = 8) -> tuple:
    """One ``fir_conv`` call on the float32 rows ``x`` with taps ``h`` in
    ``phases`` phases (phases 6 and 19): its one launch checked and its
    result held against the causal ``F.conv1d`` (rtol = atol = 1e-4), then
    its ``fir_conv_hopper`` call held against the plain version (1e-4) and
    timed beside its bound and that ``F.conv1d``.  Returns (the call's
    arguments, the bound as ``bound`` gives it, the reading)."""
    from repro_torch.kernels.fir_conv import (fir_conv, fir_conv_hopper,
                                              ref_fir_conv_hopper)
    from repro_torch.kernels.fir_conv import kernel as fir_kernel
    conv = _fir_conv1d(torch, x, h)
    with torch.no_grad():
        fir_kernel.reset_launch_counts()
        y = fir_conv(x, h, phases=phases)
        torch.cuda.synchronize()
        counts = fir_kernel.launch_counts()
        lib_y = conv()
    if counts != {"fir_conv_hopper": 1}:
        raise AssertionError(f"fir_conv {h.numel()} taps launched {counts}")
    torch.testing.assert_close(y, lib_y, rtol=1e-4, atol=1e-4)
    (_, a), = record_calls(torch, lambda: fir_conv(x, h, phases=phases),
                           "repro_torch.kernels.fir_conv.ops",
                           ("fir_conv_hopper",))
    with torch.no_grad():
        got, want = fir_conv_hopper(**a), ref_fir_conv_hopper(**a)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        k_ms = device_ms(torch, lambda: fir_conv_hopper(**a))
        p_ms = device_ms(torch, lambda: ref_fir_conv_hopper(**a))
        l_ms = device_ms(torch, conv)
    (b_, n), (m, win), p_ = a["x"].shape, a["idx"].shape, \
        a["wbank"].shape[1]
    # the input, the window table, the tap bank and the output once each;
    # 2 flops a multiply-add
    b = bound(4 * (b_ * n + m * win + win * p_ + b_ * m * p_),
              2 * b_ * m * win * p_, FP32_FLOP_PER_S)
    return a, b, {
        "taps": h.numel(), "phases": p_, "rows": b_, "windows": m,
        "window": win, "launches": counts, "max_abs_err": err,
        "library_err": float((y - lib_y).abs().max()), "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b[0],
        "bound_by": "bytes" if b[1] >= b[2] else "operations",
        "library_ms": l_ms, "library": "causal F.conv1d"}


def matmul_form(torch, a: dict):
    """The one ``torch.matmul`` a ``shuffle_gemm_blocks`` call ``a`` is
    where its rows gather ``x`` in order, without overlap, PAD or scale
    (dct2_32, dwt_haar, a mel bank): ``x.view(B, rows, t) @ w``, as a
    function of no arguments; else None."""
    x, idx, w = a["x"], a["idx"], a["w"]
    rows, t = idx.shape
    if a.get("scale") is not None or w.ndim != 2 or x.shape[1] != rows * t \
            or not torch.equal(idx.flatten(), torch.arange(
                rows * t, dtype=idx.dtype, device=idx.device)):
        return None
    xr = x.view(x.shape[0], rows, t)
    return lambda: torch.matmul(xr, w)


def paper_suite_phase(torch, np, seed: int, smi: str) -> dict:
    """Phase 19: the paper suite (``paper_suite``) on the card through
    the graph's entry points, each result held against the ``reference``
    backend on the same card tensors; callable alone after
    ``kernels.build()``.  Returns the kernel JSON's ``paper_suite``
    entries and launch counts."""
    from repro_torch.kernels.shuffle_gemm import (
        launch_counts, ref_shuffle_gemm_blocks,
        ref_shuffle_gemm_grouped_blocks, reset_launch_counts,
        shuffle_gemm_blocks, shuffle_gemm_chain, shuffle_gemm_grouped_blocks,
        shuffle_gemm_steps)
    from repro_torch.kernels.shuffle_gemm.kernel import ref_chain
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.serving import SignalRequest, SignalService
    from repro_torch.signal import SignalGraph, StreamingRunner

    t_phase = time.perf_counter()
    suite = paper_suite(SignalGraph, seed)
    rng = np.random.default_rng(seed + 19)
    xs = {name: torch.as_tensor(suite_input(np, rng, name, length, batch),
                                device="cuda")
          for name, (_, length, batch) in suite.items()}
    kern = {"shuffle_gemm_blocks": (shuffle_gemm_blocks,
                                    plain_blocks(ref_shuffle_gemm_blocks)),
            "shuffle_gemm_grouped_blocks": (shuffle_gemm_grouped_blocks,
                                            ref_shuffle_gemm_grouped_blocks),
            "shuffle_gemm_chain": (shuffle_gemm_chain, ref_chain)}
    made = _suite_launches()             # the phase's main-path launches

    def add(counts):
        for k, v in counts.items():
            made[k] += v

    # -- a/b. offline at fuse 0, 1, 2 against reference; launches; chains
    compiled, calls_of = {}, {}
    for name, (g, length, batch) in suite.items():
        x, errs = xs[name], []
        for fuse in (0, 1, 2):
            h = g.compile(length, fuse=fuse, backend="hopper", device="cuda")
            r = g.compile(length, fuse=fuse, backend="reference",
                          device="cuda")
            with torch.no_grad():
                reset_launch_counts()
                got = suite_forward(name, h, x)
                torch.cuda.synchronize()
                counts = launch_counts()
                want = suite_forward(name, r, x)
            if counts != SUITE_LAUNCHES[name][fuse]:
                raise AssertionError(f"{name} fuse {fuse} launched {counts}, "
                                     f"not {SUITE_LAUNCHES[name][fuse]}")
            add(counts)
            errs += [suite_close(torch, f"{name} fuse {fuse} {k}", got[k],
                                 want[k], SUITE_REL) for k in want]
        compiled[name] = (h, r)
        calls = calls_of[name] = record_calls(
            torch, lambda: suite_forward(name, h, x))
        chains = []
        for kname, a in calls:
            if kname != "shuffle_gemm_chain":
                continue
            rep = a["segment"].report()
            if rep["shared_bytes"] != SUITE_SHARED_BYTES[name]:
                raise AssertionError(f"{name} chain {rep}: shared bytes not "
                                     f"{SUITE_SHARED_BYTES[name]}")
            with torch.no_grad():
                got = shuffle_gemm_chain(**a)
                if not torch.equal(got, shuffle_gemm_steps(**a)):
                    raise AssertionError(f"{name} chain is not its "
                                         f"sub-steps launched one at a time")
                text = (f"chain of {len(rep['steps'])} ({rep['tiles']} tiles "
                        f"of {rep['tile_floats']} floats a row, "
                        f"{rep['shared_bytes']} B shared) bit for bit its "
                        f"sub-steps")
                if name in SUITE_BF16:
                    a16 = dict(a, x=a["x"].to(torch.bfloat16),
                               ws=[w.to(torch.bfloat16) for w in a["ws"]])
                    got = shuffle_gemm_chain(**a16)
                    if not torch.equal(got, shuffle_gemm_steps(**a16)):
                        raise AssertionError(f"{name} bfloat16 chain is not "
                                             f"its sub-steps")
                    err = suite_close(torch, f"{name} bfloat16 chain", got,
                                      ref_chain(**a16), SUITE_BF16_REL)
                    text += (f", bfloat16 too (max abs err {err:.3e} against "
                             f"the plain version, rel {SUITE_BF16_REL})")
            chains.append(text)
        print(f"{name}: length {length}, input {tuple(x.shape)}; hopper vs "
              f"reference at fuse 0/1/2 max abs err {max(errs):.3e}; "
              f"launches {[SUITE_LAUNCHES[name][f] for f in (0, 1, 2)]}"
              + "".join(f"; {c}" for c in chains), flush=True)

    # -- f. readings: each kernel call of a fuse-2 forward, timed beside
    # its bound, its plain version and (FFT, FIR, DCT, Haar DWT, mel) one
    # PyTorch call
    print(f"readings (smoke, not metrics; CUDA-graph replays) on {smi}:",
          flush=True)
    readings = {n: [] for n in kern}
    for name, calls in calls_of.items():
        x = xs[name]
        for kname, a in calls:
            k_fn, p_fn = kern[kname]
            with torch.no_grad():
                err = suite_close(torch, f"{name} {kname}", k_fn(**a),
                                  p_fn(**a), SUITE_REL)
                k_ms = device_ms(torch, lambda: k_fn(**a))
                p_ms = device_ms(torch, lambda: p_fn(**a))
            nbytes, flops = (chain_cost if kname == "shuffle_gemm_chain"
                             else call_cost)(a)
            b = bound(nbytes, flops, FP32_FLOP_PER_S)
            d = describe(kname, a)
            # the one PyTorch call computing the same function, held
            # against the kernel's result
            lib, lib_name, lib_want = None, None, None
            mm = (matmul_form(torch, a) if kname == "shuffle_gemm_blocks"
                  else None)
            if name in ("fft128", "fft256", "fft512", "fft1024"):
                lib, lib_name = (lambda: torch.fft.fft(x)), "torch.fft.fft"
                lib_want = compiled[name][0](x)["y"]
            elif kname == "shuffle_gemm_blocks" and (
                    name.startswith("fir256") or d["n_out"] == 1
                    and name == "front1024"):
                stage = "front" if name == "front1024" else "y"
                taps = torch.as_tensor(suite[name][0].stages[stage].params[
                    "taps"].astype(np.float32), device="cuda")
                lib, lib_name = _fir_conv1d(torch, x, taps), "causal F.conv1d"
                with torch.no_grad():
                    lib_want = k_fn(**a).reshape(x.shape)
            elif mm is not None:
                # dct2_32 (the DCT matrix), dwt_haar (the Haar pair),
                # front1024's mel bank: rows in order, no overlap
                lib = mm
                lib_name = "torch.matmul (x.view(B, rows, t) @ w)"
                with torch.no_grad():
                    lib_want = k_fn(**a)
            if lib is not None:
                with torch.no_grad():
                    suite_close(torch, f"{name} {lib_name}", lib(), lib_want,
                                SUITE_REL)
            lib_ms = None if lib is None else device_ms(torch, lib)
            # a call of t >= 32 also on the sequential body: the grouped
            # kernel with one group computes the same function
            seq_ms = None
            if kname == "shuffle_gemm_blocks" and d["t"] >= 32:
                ga = dict(x=a["x"], idx=a["idx"], pad_vals=a["pad_vals"],
                          w=a["w"][None], reps=1, groups=1, nb=d["rows"],
                          scale=a["scale"])
                with torch.no_grad():
                    suite_close(torch, f"{name} sequential body",
                                shuffle_gemm_grouped_blocks(**ga),
                                k_fn(**a).reshape(a["x"].shape[0], -1),
                                SUITE_REL)
                    seq_ms = device_ms(
                        torch, lambda: shuffle_gemm_grouped_blocks(**ga))
            entry = {"workload": name, "max_abs_err": err, "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b[0],
                     "bound_by": "bytes" if b[1] >= b[2] else "operations",
                     "bytes": nbytes, "flops": flops, "library_ms": lib_ms,
                     "library": lib_name, "sequential_ms": seq_ms,
                     "shape": {k: v for k, v in d.items()
                               if k != "sub_steps"}}
            readings[kname].append(entry)
            shape = (f"{d['steps']} sub-steps, {d['tiles']} tiles of "
                     f"{d['tile_floats']}" if kname == "shuffle_gemm_chain"
                     else f"B {a['x'].shape[0]} rows {d['rows']} t {d['t']} "
                          f"n_out {d['n_out']}")
            print(f"  {name:16s} {kname:27s} {shape} | err {err:.2e} | "
                  f"kernel {k_ms * 1e3:9.2f} us  plain {p_ms * 1e3:9.2f} us  "
                  f"bound {b[0] * 1e3:8.3f} us ({nbytes} B, {flops} flop)"
                  + ("" if lib_ms is None else
                     f"  {lib_name} {lib_ms * 1e3:9.2f} us")
                  + ("" if seq_ms is None else
                     f"  sequential body {seq_ms * 1e3:9.2f} us"), flush=True)

    # -- f. the entry points of phase 6 at the paper's sizes
    entry = {"fft_stages_hopper": [], "fir_conv_hopper": []}
    for n in SUITE_FFT_N:
        z = torch.as_tensor(
            (rng.standard_normal((SUITE_BATCH, n))
             + 1j * rng.standard_normal((SUITE_BATCH, n))).astype(
                np.complex64), device="cuda")
        _, _, rd = fft_entry_reading(torch, z)
        entry["fft_stages_hopper"].append(rd)
        print(f"  fft_hopper n {n:4d} x {rd['rows']} rows, one launch of "
              f"{rd['stages']} stages | err {rd['max_abs_err']:.2e} vs "
              f"plain, {rd['library_err']:.2e} vs torch.fft.fft | kernel "
              f"{rd['ms'] * 1e3:8.2f} us  plain {rd['plain_ms'] * 1e3:8.2f} "
              f"us  bound {rd['bound_ms'] * 1e3:7.3f} us  torch.fft.fft "
              f"{rd['library_ms'] * 1e3:8.2f} us", flush=True)
    xf = xs["fir256_20"]
    for t in SUITE_FIR_TAPS:
        h = torch.as_tensor(suite[f"fir256_{t}"][0].stages["y"].params[
            "taps"].astype(np.float32), device="cuda")
        _, _, rd = fir_entry_reading(torch, xf, h)
        entry["fir_conv_hopper"].append(rd)
        print(f"  fir_conv 256 x {t} taps, {rd['phases']} phases, "
              f"{rd['rows']} rows (M {rd['windows']} L {rd['window']}) | err "
              f"{rd['max_abs_err']:.2e} vs plain, {rd['library_err']:.2e} vs "
              f"F.conv1d | kernel {rd['ms'] * 1e3:8.2f} us  plain "
              f"{rd['plain_ms'] * 1e3:8.2f} us  bound "
              f"{rd['bound_ms'] * 1e3:7.3f} us  F.conv1d "
              f"{rd['library_ms'] * 1e3:8.2f} us", flush=True)
    entry_counts = {k: len(v) for k, v in entry.items()}

    # -- c. training: front1024's FIR taps and mel weights toward a seeded
    # target (the same graph with other taps), gradients on hopper against
    # reference, then AdamW
    g, length, batch = suite["front1024"]
    h, r = compiled["front1024"]
    params = {k: {f: torch.as_tensor(np.asarray(v, np.float32),
                                     device="cuda") for f, v in d.items()}
              for k, d in h.init_params().items()}
    teacher = {**params, "front": {"taps": torch.as_tensor(
        (rng.standard_normal(80) / np.sqrt(80)).astype(np.float32),
        device="cuda")}}
    batches = [torch.as_tensor(suite_input(np, rng, "front1024", length,
                                           batch), device="cuda")
               for _ in range(SUITE_TRAIN_STEPS + 1)]
    with torch.no_grad():
        targets = [r(xb, teacher)["mel"] for xb in batches]

    def loss_fn(outs, target):
        return torch.mean((outs["mel"] - target) ** 2) \
            / torch.mean(target ** 2)

    wrt = ("front", "mel")
    vag_h = h.value_and_grad(loss_fn, wrt=wrt)
    vag_r = r.value_and_grad(loss_fn, wrt=wrt)
    reset_launch_counts()
    loss_h, grads_h = vag_h(params, batches[0], targets[0])
    torch.cuda.synchronize()
    train_counts = launch_counts()
    add(train_counts)
    backward = {k: v - SUITE_LAUNCHES["front1024"][2][k]
                for k, v in train_counts.items()}
    loss_r, grads_r = vag_r(params, batches[0], targets[0])
    leaves = [("loss", loss_h, loss_r),
              ("front.taps", grads_h["front"]["taps"],
               grads_r["front"]["taps"]),
              ("mel.weights", grads_h["mel"]["weights"],
               grads_r["mel"]["weights"])]
    for label, a_, b_ in leaves:
        if not bool(torch.isfinite(a_).all()) or (
                label != "loss" and not float(a_.abs().max()) > 0):
            raise AssertionError(f"front1024 {label}: non-finite or zero")
        torch.testing.assert_close(a_, b_, rtol=SUITE_GRAD_TOL[0],
                                   atol=SUITE_GRAD_TOL[1])
    print(f"front1024 value_and_grad (batch {batch}): loss "
          f"{float(loss_h):.6f}; "
          + ", ".join(f"{lb} {tuple(a_.shape)} max abs err "
                      f"{float((a_ - b_).abs().max()):.3e}"
                      for lb, a_, b_ in leaves)
          + f" (rtol {SUITE_GRAD_TOL[0]}, atol {SUITE_GRAD_TOL[1]}); "
          f"launches {train_counts}, the backward's {backward}", flush=True)
    if train_counts != SUITE_TRAIN_LAUNCHES:
        raise AssertionError(f"front1024 value_and_grad launched "
                             f"{train_counts}, not {SUITE_TRAIN_LAUNCHES}")
    trained = {k: params[k] for k in wrt}
    opt = adamw_init(trained)
    held_out = (batches[-1], targets[-1])
    eval_before = float(vag_h(params, *held_out)[0])
    losses = []
    reset_launch_counts()
    for i in range(SUITE_TRAIN_STEPS):
        loss, grads = vag_h({**params, **trained}, batches[i], targets[i])
        trained, opt, _ = adamw_update(grads, opt, trained,
                                       lr=SUITE_TRAIN_LR, weight_decay=0.0)
        losses.append(float(loss))
    add(launch_counts())
    eval_after = float(vag_h({**params, **trained}, *held_out)[0])
    print(f"front1024 {SUITE_TRAIN_STEPS} AdamW steps (lr "
          f"{SUITE_TRAIN_LR}): losses {[round(v, 6) for v in losses]}; "
          f"held-out loss {eval_before:.6f} -> {eval_after:.6f}", flush=True)
    if not all(np.isfinite(losses)) or not eval_after < eval_before:
        raise AssertionError("front1024 training did not lower the "
                             "held-out loss")

    # -- d. serving: the suite in one SignalService, 64 requests over its
    # graphs; the FIR graphs and front1024 at uneven lengths (bucketed and
    # masked), the others at their own length (fft, dct and dwt are not
    # local in time: exact-length groups)
    svc = SignalService(batch_size=SUITE_SERVE_BATCH, backend="hopper",
                        device="cuda")
    for name, (g, _, _) in suite.items():
        svc.register(name, g)
    names = list(suite)
    requests = []
    for i in range(SUITE_REQUESTS):
        name = names[i % len(names)]
        length = suite[name][1]
        if name == "front1024":
            length = int(rng.integers(1024, length + 1))
        elif name in ("fir256_20", "fir256_40", "fir256_80"):
            length = int(rng.integers(1, length + 1))
        elif name == "fir256_80_phased":
            length = 8 * int(rng.integers(1, length // 8 + 1))
        requests.append(SignalRequest(
            rid=i, graph=name,
            samples=rng.standard_normal(length).astype(np.float32)))
    for req in requests:
        svc.submit(req)
    reset_launch_counts()
    t_serve, served, waves = time.perf_counter(), {}, 0
    while svc.pending():
        served.update(svc.step())
        waves += 1
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    serve_counts = launch_counts()
    add(serve_counts)
    worst = 0.0
    with torch.no_grad():
        for req in requests:
            name, length = req.graph, req.samples.shape[0]
            off = suite[name][0].compile(length, fuse=2, backend="hopper",
                                         device="cuda")(
                torch.as_tensor(req.samples[None], device="cuda"))
            for k, want in off.items():
                got = torch.as_tensor(served[req.rid][k])
                worst = max(worst, suite_close(
                    torch, f"served {name} rid {req.rid} ({length}) {k}",
                    got, want[0].cpu(), SUITE_REL))
    if sorted(served) != list(range(SUITE_REQUESTS)):
        raise AssertionError(f"served {sorted(served)}")
    print(f"served {SUITE_REQUESTS} requests over {len(names)} graphs in "
          f"{waves} steps, {serve_s:.3f} s (smoke reading); stats "
          f"{svc.stats}; launches {serve_counts}; every result == the "
          f"offline compile at its true length, max abs err {worst:.3e}",
          flush=True)

    # -- e. streaming: 3 uneven chunks against the offline compile
    streamed = {}
    for name, (first, second) in SUITE_STREAM.items():
        g, length, _ = suite[name]
        x = xs[name][:SUITE_STREAM_ROWS]
        try:
            runner = StreamingRunner(g, backend="hopper", device="cuda")
        except ValueError as e:
            if SUITE_STREAM_REFUSED.get(name) != str(e):
                raise
            streamed[name] = f"refused: {e}"
            print(f"{name}: StreamingRunner refuses it, as the JAX "
                  f"package's does: {e}", flush=True)
            continue
        if name in SUITE_STREAM_REFUSED:
            raise AssertionError(f"{name} streamed; expected the refusal "
                                 f"{SUITE_STREAM_REFUSED[name]!r}")
        cuts = (0, first, first + second, length)
        reset_launch_counts()
        with torch.no_grad():
            outs = [runner.process(x[:, a:b_])
                    for a, b_ in zip(cuts, cuts[1:])] + [runner.flush()]
            got = torch.cat([o.get("y", x[:, :0]) if isinstance(o, dict)
                             else o for o in outs], dim=-1)
            want = compiled[name][0](x)["y"]
        torch.cuda.synchronize()
        counts = launch_counts()
        add(counts)
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=0.0,
                                   atol=SUITE_STREAM_ATOL)
        streamed[name] = {"chunks": [b_ - a for a, b_ in
                                     zip(cuts, cuts[1:])],
                          "max_abs_err": err, "launches": counts}
        print(f"{name}: streamed in chunks {streamed[name]['chunks']} == "
              f"offline, max abs err {err:.3e} (atol {SUITE_STREAM_ATOL}); "
              f"launches {counts}", flush=True)

    seconds = time.perf_counter() - t_phase
    print(f"phase 19: {seconds:.1f} s (its budget {SUITE_BUDGET_S} s); "
          f"main-path launches {made}, entry points {entry_counts}; "
          f"{smi}", flush=True)
    return {"launches": made, "entry_launches": entry_counts,
            "readings": readings, "entry": entry, "seconds": seconds,
            "train": {"losses": losses, "eval_before": eval_before,
                      "eval_after": eval_after, "launches": train_counts,
                      "backward": backward},
            "serve": {"launches": serve_counts, "max_abs_err": worst,
                      "seconds": serve_s},
            "stream": streamed}


# -- phase 20: cross-graph waves with one operand a batch row ---------------
# Two tenants of one graph that registered different params are one wave:
# every stage takes its rows' params, each kernel launching once for the
# wave with one operand a batch row (the JAX package's vmap over stacked
# params, src/repro/serving/signal_service.py _run_per_row_params).  (a)
# Fig-9q (fig9q_graph) at LENGTH under phase 5's policy, tenants from seeds
# seed and seed + 1 (FIR taps and circulant-mask weights about the
# layer's own init, the scale the policy was calibrated at): every
# int-routed step one launch of the per-row quantized GEMM, w (8, K, N);
# (b) Fig 9's front end at its widths, iir_biquad -> stft(256, 128,
# learnable window) -> istft, tenants with their own biquad coefficients
# and windows; (c) the per-row grouped kernel and the per-row chain at
# Fig 9's 16 butterflies (its STFT and iSTFT chains at batch 8, one
# operand set a row), each row bit for bit the shared call on its row's
# operands, and the planes kernel at plane counts no width gives; (d)
# readings of each per-row call beside the shared call on the same shapes.
PER_ROW_BATCH = 8
PER_ROW_PLANES = ((3, 5), (8, 8))
PER_ROW_F64_LIBRARY = (
    "torch.bmm in float64 on the quantized integers (batch row b against "
    "w[b]'s; cast outside the timed region, the quantize not counted), "
    "exact below 2^53, wrapped to int32, dequantized and held equal to the "
    "kernel's output; summed over the calls")
PLANES_F64_LIBRARY = (
    "torch.matmul in float64 on the composed digit integers sum_i a_i 16^i, "
    "taken mod 2^32 and held equal to the kernel's output, where every "
    "product stays below 2^53: (3, 5) only; at (8, 8) a composed product "
    "reaches ~1.3e21 (3.4e23 summed over K 256), so no float64 call is "
    "exact (none exact)")


def per_row_phase(torch, np, seed: int, smi: str, ctx: dict) -> dict:
    """Phase 20 (see above).  ``ctx``: phase 5's ``policy``, the Fig-9
    ``graph`` and its ``params``.  Returns the kernel JSON's ``per_row``
    entries by kernel and the main-path ``launches`` of waves (a) and
    (b)."""
    from repro_torch.core import bitwidth as bw
    from repro_torch.kernels import launch
    from repro_torch.kernels import bitserial_mm as bsm
    from repro_torch.kernels.bitserial_mm.ref import wrap32
    from repro_torch.kernels.shuffle_gemm import (
        launch_counts, ref_shuffle_gemm_grouped_blocks, reset_launch_counts,
        shuffle_gemm_chain, shuffle_gemm_grouped_blocks)
    from repro_torch.kernels.shuffle_gemm.kernel import chain_steps, ref_chain
    from repro_torch.serving import SignalRequest, SignalService
    from repro_torch.signal import HopperBackend, SignalGraph

    t_phase = time.perf_counter()
    B = PER_ROW_BATCH
    policy, graph, params = ctx["policy"], ctx["graph"], ctx["params"]
    qback = HopperBackend(precision=policy)
    rng = np.random.default_rng(seed + 20)
    made = {n: 0 for n in ("shuffle_gemm_blocks",
                           "shuffle_gemm_grouped_blocks",
                           "shuffle_gemm_chain",
                           "bitserial_quant_matmul_hopper",
                           "bitserial_matmul_planes")}
    out = {}

    def counts():
        return {**launch_counts(), **bsm.launch_counts()}

    def reset():
        reset_launch_counts()
        bsm.reset_launch_counts()

    def wave(svc, reqs):
        """Serve ``reqs`` as the main path: counts set to 0 just before,
        read just after; (results, launches, batches, cross-graph
        waves)."""
        b0 = svc.stats["batches"]
        c0 = svc.scheduler.stats["cross_graph_batches"]
        reset()
        got = svc.serve(reqs)
        torch.cuda.synchronize()
        n = counts()
        return (got, n, svc.stats["batches"] - b0,
                svc.scheduler.stats["cross_graph_batches"] - c0)

    def hold_rows(what, got, offline, atol):
        worst = 0.0
        for i, want in offline.items():
            for k, v in want.items():
                g = got[i][k]
                if g.shape != v.shape or not np.all(np.isfinite(g)):
                    raise AssertionError(f"{what} row {i} {k}: shape "
                                         f"{g.shape} vs {v.shape}")
                d = float(np.abs(g - v).max())
                if d > atol:
                    raise AssertionError(f"{what} row {i} {k}: max abs err "
                                         f"{d} beyond {atol}")
                worst = max(worst, d)
        return worst

    # -- (a) Fig-9q, two tenants, one wave of the per-row int route
    gq = fig9q_graph(LENGTH)
    cq = gq.compile(LENGTH, fuse=2, backend=qback, device="cuda")
    base = cq.init_params()
    n_int = len(policy.widths)

    def tenant(r):
        p = {k: {kk: torch.as_tensor(np.asarray(vv, np.float32),
                                     device="cuda") for kk, vv in v.items()}
             for k, v in base.items()}
        bw_ = np.asarray(base["mask"]["weights"], np.float32)
        taps = (0.3 * r.standard_normal(9)).astype(np.float32)
        taps[0] += 1.0
        p["front"]["taps"] = torch.as_tensor(taps, device="cuda")
        p["mask"]["weights"] = torch.as_tensor(
            (bw_ + 0.5 * bw_.std() * r.standard_normal(bw_.shape))
            .astype(np.float32), device="cuda")
        return p
    pq = [tenant(np.random.default_rng(seed + k)) for k in (0, 1)]
    xq = [rng.standard_normal(LENGTH).astype(np.float32) for _ in range(B)]
    svc_q = SignalService(batch_size=B, backend="hopper", precision=policy,
                          device="cuda")
    for name, p in zip("ab", pq):
        svc_q.register(name, gq, params=p)

    def reqs_q(base_rid, which="ab"):
        return [SignalRequest(rid=base_rid + i, graph="ab"[i % 2],
                              samples=xq[i]) for i in range(B)
                if "ab"[i % 2] in which]
    svc_q.serve(reqs_q(0))                   # compiles the bucket
    torch.cuda.synchronize()
    with torch.no_grad():
        reset()
        cq(torch.as_tensor(np.stack(xq), device="cuda"), pq[0])
        torch.cuda.synchronize()
        one_forward = counts()
    calls_q = []
    orig_q = bsm.ops.bitserial_quant_matmul_hopper

    def rec_q(h, w, aw, ww):
        calls_q.append({"h": h.detach().clone(), "w": w.detach().clone(),
                        "aw": aw, "ww": ww})
        return orig_q(h, w, aw, ww)
    bsm.ops.bitserial_quant_matmul_hopper = rec_q
    try:
        res_a, made_a, waves_a, cross_a = wave(svc_q, reqs_q(100))
    finally:
        bsm.ops.bitserial_quant_matmul_hopper = orig_q
    if waves_a != 1 or cross_a != 1 or svc_q.stats["param_splits"] \
            or made_a != one_forward \
            or made_a["bitserial_quant_matmul_hopper"] != n_int \
            or len(calls_q) != n_int \
            or any(c["w"].ndim != 3 or c["w"].shape[0] != B
                   for c in calls_q):
        raise AssertionError(
            f"(a) {waves_a} waves, {cross_a} cross-graph, param_splits "
            f"{svc_q.stats['param_splits']}, launches {made_a} vs one "
            f"forward's {one_forward}, quantized-GEMM operands "
            f"{[tuple(c['w'].shape) for c in calls_q]}")
    for k, v in made_a.items():
        made[k] += v
    with torch.no_grad():
        off_a = {}
        for i in range(B):
            o = cq(torch.as_tensor(xq[i][None], device="cuda"), pq[i % 2])
            off_a[100 + i] = {k: v[0].cpu().numpy() for k, v in o.items()}
    err_a = hold_rows("(a) Fig-9q", res_a, off_a, 1e-5)
    # the same wave split per tenant: two waves of 4, the parent's path
    split_counts = None
    for tag in ("a", "b"):
        _, n, _, _ = wave(svc_q, reqs_q(200, tag))
        split_counts = n if split_counts is None else {
            k: split_counts[k] + n[k] for k in n}

    def one_wave():
        svc_q.serve(reqs_q(300))

    def split_wave():
        svc_q.serve(reqs_q(400, "a"))
        svc_q.serve(reqs_q(500, "b"))
    turns = [wall_ms(torch, f, iters=5)
             for f in (one_wave, split_wave, split_wave, one_wave)]
    wave_ms, split_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    wave_kernels = []
    profile_forward(torch, one_wave, wave_ms, label="two-tenant Fig-9q wave",
                    breakdown=wave_kernels)
    wave_device_ms = (sum(t for t, _, _ in wave_kernels) / 1e3
                      if wave_kernels else None)
    print(f"(a) on {smi}: Fig-9q, {B} requests of {LENGTH} alternating two "
          f"tenants: {waves_a} wave ({cross_a} cross-graph), param_splits "
          f"{svc_q.stats['param_splits']}, launches {made_a} (one forward's: "
          f"{one_forward}); quantized-GEMM operands "
          f"{[tuple(c['w'].shape) for c in calls_q]}; rows vs each tenant's "
          f"offline compile max abs err {err_a:.2e} (atol 1e-5); wall time "
          f"(host clock with CUDA events, 5 waves, in turns one/split/split/"
          f"one: {', '.join(f'{t:.3f}' for t in turns)} ms) one per-row "
          f"wave {wave_ms:.3f} ms, split per tenant {split_ms:.3f} ms "
          f"(launches {split_counts})", flush=True)
    wave_row = {"per_row_ms": wave_ms, "split_ms": split_ms,
                "device_ms": wave_device_ms,
                "launches": made_a, "split_launches": split_counts,
                "per": f"Fig-9q, {B} requests of {LENGTH} from two "
                       f"tenants: one per-row wave against the same "
                       f"requests as two waves of one tenant, host wall "
                       f"time a wave; device_ms: its device activity by "
                       f"torch.profiler (None where it saw none)"}

    # -- (b) Fig 9's front end: per-row biquad and learnable window
    def front_graph():
        g = SignalGraph("front_rows")
        g.iir_biquad("iir", "input", b=[0.2, 0.3, 0.2], a=[1.0, -0.5, 0.25])
        g.stft("spec", "iir", frame=256, hop=128, window="learnable")
        g.istft("out", "spec", hop=128, length=LENGTH)
        g.outputs("out")
        return g
    gf = front_graph()
    cf = gf.compile(LENGTH, fuse=2, backend="hopper", device="cuda")
    hann = np.asarray(cf.init_params()["spec"]["window"], np.float32)
    pf = [{"iir": {"b": torch.tensor([0.2, 0.3, 0.2], device="cuda"),
                   "a": torch.tensor([1.0, -0.5, 0.25], device="cuda")},
           "spec": {"window": torch.as_tensor(hann, device="cuda")}},
          {"iir": {"b": torch.tensor([0.1, 0.25, 0.1], device="cuda"),
                   "a": torch.tensor([1.0, -0.4, 0.2], device="cuda")},
           "spec": {"window": torch.as_tensor(
               (hann * (1.0 + 0.2 * rng.standard_normal(hann.shape)))
               .astype(np.float32), device="cuda")}}]
    svc_f = SignalService(batch_size=B, backend="hopper", device="cuda")
    for name, p in zip("ab", pf):
        svc_f.register(name, gf, params=p)
    reqs_f = [SignalRequest(rid=600 + i, graph="ab"[i % 2], samples=xq[i])
              for i in range(B)]
    with torch.no_grad():
        reset()
        cf(torch.as_tensor(np.stack(xq), device="cuda"), pf[0])
        torch.cuda.synchronize()
        front_forward = counts()
    res_b, made_b, waves_b, cross_b = wave(svc_f, reqs_f)
    if waves_b != 1 or cross_b != 1 or svc_f.stats["param_splits"] \
            or made_b != front_forward:
        raise AssertionError(f"(b) {waves_b} waves, {cross_b} cross-graph, "
                             f"param_splits {svc_f.stats['param_splits']}, "
                             f"launches {made_b} vs {front_forward}")
    for k, v in made_b.items():
        made[k] += v
    with torch.no_grad():
        off_b = {600 + i: {"out": cf(torch.as_tensor(
            xq[i][None], device="cuda"), pf[i % 2])["out"][0].cpu().numpy()}
            for i in range(B)}
    err_b = hold_rows("(b) front end", res_b, off_b, 1e-5)
    print(f"(b) on {smi}: iir_biquad -> stft(256, 128, learnable) -> istft "
          f"at {LENGTH}, two tenants: {waves_b} wave, param_splits "
          f"{svc_f.stats['param_splits']}, launches {made_b} (one "
          f"forward's); rows vs each tenant's offline compile max abs err "
          f"{err_b:.2e} (atol 1e-5)", flush=True)

    # -- (c)/(d) the per-row kernels at Fig 9's butterflies, batch 8
    x8 = torch.as_tensor(rng.standard_normal((B, LENGTH)).astype(np.float32),
                         device="cuda")
    hopper = graph.compile(LENGTH, fuse=2, backend="hopper", device="cuda")
    chains = [a for n, a in record_calls(torch, lambda: hopper(x8, params))
              if n == "shuffle_gemm_chain"]
    if len(chains) != 2:
        raise AssertionError(f"{len(chains)} chain calls at batch {B}")

    def rows_of(w):
        """``w`` (G, t, n_out) as one operand a batch row, each its own."""
        noise = torch.as_tensor(rng.standard_normal((B, *w.shape)),
                                dtype=w.dtype, device=w.device)
        return (w[None] * (1.0 + 0.05 * noise)).contiguous()

    def same_rows(label, per, shared_of):
        for b in range(B):
            if not torch.equal(per[b], shared_of(b)[b]):
                bad = (per[b] != shared_of(b)[b]).nonzero()[0].tolist()
                raise AssertionError(f"{label}: row {b} is not the shared "
                                     f"call on its operands at {bad}")

    def reading(label, k_fn, s_fn, p_fn, nbytes, ops, ops_per_s):
        k_ms = device_ms(torch, k_fn)
        s_ms = device_ms(torch, s_fn)
        p_ms = device_ms(torch, p_fn)
        b = bound(nbytes, ops, ops_per_s)
        print(f"  {label}: per-row {k_ms * 1e3:8.2f} us  shared "
              f"{s_ms * 1e3:8.2f} us  plain {p_ms * 1e3:8.2f} us  bound "
              f"{b[0] * 1e3:6.3f} us ({nbytes} B, {ops} ops)", flush=True)
        return k_ms, s_ms, p_ms, b

    def new_per_row(per):
        return {**new_row(0, per), "shared_ms": 0.0}

    print(f"(c, d) per-row kernels on {smi}:", flush=True)
    g_row = new_per_row(f"sum over Fig 9's 16 butterflies (its STFT and "
                        f"iSTFT chains' sub-steps) at batch {B}, one "
                        f"launch each, one (G, 4, 4) operand a batch row; "
                        f"shared_ms: the same calls on one shared operand")
    c_row = new_per_row(f"sum over Fig 9's two chains at batch {B}, one "
                        f"operand set a batch row; shared_ms: the same "
                        f"chains on one shared operand set")
    for a in chains:
        seg = a["segment"]
        ws_rows = [rows_of(w) for w in a["ws"]]
        args = dict(x=a["x"], segment=seg, ws=ws_rows)
        with torch.no_grad():
            per = shuffle_gemm_chain(**args)
            want = ref_chain(**args)
            same_rows("per-row chain", per, lambda b: shuffle_gemm_chain(
                a["x"], seg, [w[b].contiguous() for w in ws_rows]))
            err = float((per - want).abs().max())
            if not torch.allclose(per, want, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"per-row chain vs plain: {err}")
        nbytes, flops = chain_cost(args)
        k_ms, s_ms, p_ms, b = reading(
            f"chain of {len(seg.steps)}", lambda: shuffle_gemm_chain(**args),
            lambda: shuffle_gemm_chain(**a), lambda: ref_chain(**args),
            nbytes, flops, FP32_FLOP_PER_S)
        add_call(c_row, err, k_ms, p_ms, b)
        c_row["shared_ms"] += s_ms
        c_row["calls"] += 1
        xi = a["x"]
        for (idx, pads, w, reps, groups, nb, scale), wr in zip(
                chain_steps(seg, a["ws"], xi.device, xi.dtype), ws_rows):
            ga = dict(x=xi, idx=idx, pad_vals=pads, w=wr, reps=reps,
                      groups=groups, nb=nb, scale=scale)
            gs = dict(ga, w=w)
            with torch.no_grad():
                per = shuffle_gemm_grouped_blocks(**ga)
                want = ref_shuffle_gemm_grouped_blocks(**ga)
                same_rows("per-row grouped", per,
                          lambda b: shuffle_gemm_grouped_blocks(
                              **dict(ga, w=wr[b].contiguous())))
                err = float((per - want).abs().max())
                if not torch.allclose(per, want, rtol=1e-5, atol=1e-5):
                    raise AssertionError(f"per-row grouped vs plain: {err}")
            nbytes, flops = call_cost(ga)
            k_ms = device_ms(torch, lambda: shuffle_gemm_grouped_blocks(**ga))
            s_ms = device_ms(torch, lambda: shuffle_gemm_grouped_blocks(**gs))
            p_ms = device_ms(torch,
                             lambda: ref_shuffle_gemm_grouped_blocks(**ga))
            add_call(g_row, err, k_ms, p_ms,
                     bound(nbytes, flops, FP32_FLOP_PER_S))
            g_row["shared_ms"] += s_ms
            g_row["calls"] += 1
            with torch.no_grad():
                xi = shuffle_gemm_grouped_blocks(**gs)
    print(f"  16 per-row grouped launches: per-row {g_row['ms'] * 1e3:.2f} "
          f"us, shared {g_row['shared_ms'] * 1e3:.2f} us, plain "
          f"{g_row['plain_ms'] * 1e3:.2f} us, bound "
          f"{g_row['bound_ms'] * 1e3:.3f} us; every row bit for bit the "
          f"shared call on its operands", flush=True)
    out["shuffle_gemm_grouped_blocks"] = g_row
    out["shuffle_gemm_chain_hopper"] = c_row

    q_row = new_per_row(f"sum over wave (a)'s {n_int} int-routed calls, "
                        f"one w a batch row; shared_ms: the same h, "
                        f"flattened, on one shared w")
    q_row.update(library_ms=0.0, library=PER_ROW_F64_LIBRARY, bodies=[])
    for c in calls_q:
        h, w, aw, ww = c["h"], c["w"], c["aw"], c["ww"]
        (_, r, k), n = h.shape, w.shape[-1]
        hs = h.reshape(-1, k)
        with torch.no_grad():
            per = bsm.bitserial_quant_matmul_hopper(h, w, aw, ww)
            if not torch.equal(per, bsm.ref_bitserial_quant_matmul(
                    h, w, aw, ww)):
                raise AssertionError(f"per-row quantized GEMM ({B}, {r}, "
                                     f"{k}, {n}) is not its plain version")
            for b in range(B):
                if not torch.equal(per[b], bsm.bitserial_quant_matmul_hopper(
                        h[b], w[b], aw, ww)):
                    raise AssertionError("per-row quantized GEMM row is not "
                                         "the shared-w call on w[b]")
            # the body the launch reports (a comparison launch, not counted)
            again, args = bsm.quant_rows_launch_args(h, w, aw, ww)
            launch("repro_bitserial_quant_matmul_rows", h.device, *args)
            body = bsm.QUANT_ROWS_BODIES[args[9][0]]
            if body != bsm.quant_rows_body(k, n) or not torch.equal(again,
                                                                    per):
                raise AssertionError(f"per-row quantized GEMM ran the {body} "
                                     f"body, the rule names "
                                     f"{bsm.quant_rows_body(k, n)}")
            # the library yardstick: float64 torch.bmm on the quantized
            # integers (cast outside the timed region), exact below 2^53
            xq, xs = bw.quantize(h, aw, axis=-1)
            wq, wsc = bw.quantize(w, ww, axis=-2)
            if (2 ** (aw - 1) - 1) * (2 ** (ww - 1) - 1) * k >= 2 ** 53:
                raise AssertionError("float64 torch.bmm not exact here")
            a64, w64 = xq.to(torch.float64), wq.to(torch.float64)
            lib_y = wrap32(torch.bmm(a64, w64).to(torch.int64)).to(
                torch.float32) * xs * wsc
            if not torch.equal(lib_y, per):
                raise AssertionError("the float64 torch.bmm yardstick, "
                                     "dequantized, is not the kernel's output")
        pa, pw = aw // 4, ww // 4
        ops = 2 * B * r * k * n * pa * pw
        k_ms, s_ms, p_ms, b_ = reading(
            f"quantized GEMM ({B}, {r}, {k}, {n}) {aw, ww}, {body} body",
            lambda: bsm.bitserial_quant_matmul_hopper(h, w, aw, ww),
            lambda: bsm.bitserial_quant_matmul_hopper(hs, w[0], aw, ww),
            lambda: bsm.ref_bitserial_quant_matmul(h, w, aw, ww),
            4 * (h.numel() + w.numel() + B * r * n), ops, INT8_OPS_PER_S)
        l_ms = device_ms(torch, lambda: torch.bmm(a64, w64))
        print(f"    body {body} (grid {args[9][1]} x {args[9][2]}, "
              f"{args[9][3]} {'rows' if body == 'row' else 'M tiles'} a "
              f"CTA); library torch.bmm float64 {l_ms * 1e3:8.2f} us "
              f"(bit-exact)", flush=True)
        add_call(q_row, 0.0, k_ms, p_ms, b_)
        q_row["shared_ms"] += s_ms
        q_row["library_ms"] += l_ms
        q_row["bodies"].append(body)
        q_row["calls"] += 1
    q_row["wave"] = wave_row
    out["bitserial_quant_matmul_hopper"] = q_row

    p_row = new_per_row(f"the planes kernel's body of any count at (pa, "
                        f"pw) in {PER_ROW_PLANES} on Fig-9q's mask call "
                        f"shape at batch {B} (any int8 digits); shared_ms: "
                        f"the (4, 4) body on the same shape")
    m, k, n = B * 124, 256, 64
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)

    def digits(shape):
        return torch.randint(-128, 128, shape, dtype=torch.int8,
                             device="cuda", generator=gen)
    a4, w4 = digits((4, m, k)), digits((4, k, n))
    p_row.update(library_ms=None, library=PLANES_F64_LIBRARY)
    for pa, pw in PER_ROW_PLANES:
        a8, w8 = digits((pa, m, k)), digits((pw, k, n))
        with torch.no_grad():
            got = bsm.bitserial_matmul_planes(a8, w8)
            if not torch.equal(got, bsm.ref_bitserial_matmul_planes(a8, w8)):
                raise AssertionError(f"planes kernel at ({pa}, {pw}) is not "
                                     f"its plain version")
        pairs = sum(1 for i in range(pa) for j in range(pw) if i + j < 8)
        k_ms, s_ms, p_ms, b_ = reading(
            f"planes ({pa}, {pw}) {m} x {k} x {n}",
            lambda: bsm.bitserial_matmul_planes(a8, w8),
            lambda: bsm.bitserial_matmul_planes(a4, w4),
            lambda: bsm.ref_bitserial_matmul_planes(a8, w8),
            min(pa, 8) * m * k + min(pw, 8) * k * n + 4 * m * n,
            2 * m * k * n * pairs, INT8_OPS_PER_S)
        add_call(p_row, 0.0, k_ms, p_ms, b_)
        p_row["shared_ms"] += s_ms
        p_row["calls"] += 1
        # the library yardstick where float64 is exact: the composed
        # integers sum_i a_i 16^i (|a_i| <= 128) multiplied in float64
        peak = 128 * sum(16 ** i for i in range(pa)) * 128 * sum(
            16 ** j for j in range(pw)) * k
        if peak < 2 ** 53:
            ac = sum(a8[i].to(torch.float64) * 16.0 ** i for i in range(pa))
            wc = sum(w8[j].to(torch.float64) * 16.0 ** j for j in range(pw))
            if not torch.equal(wrap32(torch.matmul(ac, wc).to(torch.int64)),
                               got):
                raise AssertionError(f"the float64 yardstick disagrees with "
                                     f"the planes kernel at ({pa}, {pw})")
            l_ms = device_ms(torch, lambda: torch.matmul(ac, wc))
            p_row["library_ms"] = (p_row["library_ms"] or 0.0) + l_ms
            print(f"    ({pa}, {pw}) library torch.matmul float64 on the "
                  f"composed integers {l_ms * 1e3:8.2f} us (bit-exact)",
                  flush=True)
        else:
            print(f"    ({pa}, {pw}) library: none exact (composed "
                  f"products up to {float(peak):.3g}, past 2^53)", flush=True)
    out["bitserial_matmul_planes"] = p_row
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s; main-path "
          f"launches {made}", flush=True)
    return {"per_row": out, "launches": made}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_main = time.perf_counter()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))

    # -- 0. environment -----------------------------------------------------
    phase("0 environment")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"device {kind}; count {torch.cuda.device_count()}")
    print(smi, flush=True)

    # -- 1. build -----------------------------------------------------------
    phase("1 build")
    from repro_torch import kernels as K
    from repro_torch.kernels.shuffle_gemm import (
        launch_counts, ref_shuffle_gemm_blocks,
        ref_shuffle_gemm_grouped_blocks, reset_launch_counts,
        shuffle_gemm_blocks, shuffle_gemm_chain, shuffle_gemm_grouped_blocks,
        shuffle_gemm_steps)
    from repro_torch.kernels.shuffle_gemm.kernel import chain_steps, ref_chain
    t0 = time.perf_counter()
    lib = K.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s under "
          f"{lib.parent}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if ("registers" in line or "spill" in line or "C75" in line
                or "entry function" in line or line.startswith("== ")):
            print(f"  {line.strip()}")
    K.compiled_supported.launches = 0
    if not K.compiled_supported():
        raise AssertionError("compiled_supported() is False on the card")
    probe_counts = {"compiled_supported": K.compiled_supported.launches}
    if probe_counts != {"compiled_supported": 1}:
        raise AssertionError(f"the probe launched {probe_counts}")
    print(f"compiled_supported() True; launches {probe_counts}", flush=True)
    probe_x = torch.arange(8 * 128, dtype=torch.float32, device="cuda")
    probe_y = torch.empty_like(probe_x)

    def probe():
        err = K.library().repro_copy_f32(
            probe_x.data_ptr(), probe_y.data_ptr(), probe_x.numel(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"repro_copy_f32 launch failed: {err}")
    # in turns (copy, probe, probe, copy), so drift between the readings
    # falls on both alike
    turns = [device_ms(torch, f) for f in (
        lambda: probe_y.copy_(probe_x), probe, probe,
        lambda: probe_y.copy_(probe_x))]
    copy_ms, probe_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    probe_bound = bound(2 * probe_x.nbytes, 0, FP32_FLOP_PER_S)
    print(f"probe repro_copy_f32 (8x128 float32) vs Tensor.copy_ (the plain "
          f"version and the library call), in turns copy/probe/probe/copy: "
          + ", ".join(f"{t * 1e3:.3f}" for t in turns)
          + f" us; kernel {probe_ms * 1e3:.3f} us, Tensor.copy_ "
          f"{copy_ms * 1e3:.3f} us, bound {probe_bound[0] * 1e3:.4f} us",
          flush=True)
    rows = {"compiled_supported": new_row(1, "one 8x128 float32 copy")}
    add_call(rows["compiled_supported"], 0.0, probe_ms, copy_ms, probe_bound)
    rows["compiled_supported"].update(
        library_ms=copy_ms, library="Tensor.copy_ of the same tensor")

    # -- model and inputs (numpy, from the seed) ----------------------------
    from repro_torch.convert import params_from_jax
    from repro_torch.pipelines.speech_enhancement import build_graph
    from repro_torch.serving import SignalRequest, SignalService
    rng = np.random.default_rng(args.seed)
    cnn_hwio = [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
                .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])]
    cnn = params_from_jax(cnn_hwio, device="cuda")
    x_np = rng.standard_normal((BATCH, LENGTH)).astype(np.float32)
    xs_serve = [rng.standard_normal(t).astype(np.float32)
                for t in SERVE_LENGTHS]
    graph = build_graph(LENGTH, ch=CH)
    hopper = graph.compile(LENGTH, fuse=2, backend="hopper", device="cuda")
    params = dict(hopper.init_params())
    params["mask"] = cnn
    x = torch.as_tensor(x_np, device="cuda")
    print(f"Fig-9 graph: length {LENGTH}, batch {BATCH}, cnn {CH}; "
          f"lowering {hopper.lowering_report()}", flush=True)

    # -- 2. kernels against their plain versions ----------------------------
    phase("2 kernels")
    wrappers = {"shuffle_gemm_blocks": (shuffle_gemm_blocks, plain_blocks(
                    ref_shuffle_gemm_blocks)),
                "shuffle_gemm_grouped_blocks": (
                    shuffle_gemm_grouped_blocks,
                    ref_shuffle_gemm_grouped_blocks),
                "shuffle_gemm_chain": (shuffle_gemm_chain, ref_chain)}
    calls = record_calls(torch, lambda: hopper(x, params))
    check_fig9_calls(calls)
    per = f"sum over the calls of one batch-{BATCH} Fig-9 forward"
    per_kernel = {n: new_row(0, per) for n in wrappers}
    per_kernel["shuffle_gemm_grouped_blocks"]["per"] = (
        f"sum over the 16 sub-steps of the two chains of one batch-{BATCH} "
        f"Fig-9 forward, one launch each")

    def check_close(name, a, got, want, dt):
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), rtol=TOL[dt],
                              atol=TOL[dt]):
            raise AssertionError(f"{name} {describe(name, a)} {dt}: max "
                                 f"abs err {err} beyond {TOL[dt]}")
        return err

    def time_call(name, a, row=None, label=""):
        """Kernel, plain and wrapper times and the bound of one call,
        printed and added to ``row``; returns the kernel's time."""
        kern, plain = wrappers[name]
        with torch.no_grad():
            got, want = kern(**a), plain(**a)
            torch.cuda.synchronize()
            err = check_close(name, a, got, want, "float32")
            k_ms = device_ms(torch, lambda: kern(**a))
            p_ms = device_ms(torch, lambda: plain(**a))
            w_ms = wall_ms(torch, lambda: kern(**a))
        nbytes, flops = (chain_cost if name == "shuffle_gemm_chain"
                         else call_cost)(a)
        b = bound(nbytes, flops, FP32_FLOP_PER_S)
        if row is not None:
            add_call(row, err, k_ms, p_ms, b)
            row["calls"] += 1
        d = describe(name, a)
        shape = (f"{d['steps']} sub-steps, {d['tiles']} tiles of "
                 f"{d['tile_floats']}" if name == "shuffle_gemm_chain" else
                 f"rows {d['rows']:5d} t {d['t']:3d} n_out {d['n_out']:2d} "
                 f"G {d['groups']:3d} pad {d['pad']:5d} scale "
                 f"{int(d['scale'])}")
        print(f"{label}{name:28s} {shape} | max_abs_err {err:.3e} | kernel "
              f"{k_ms * 1e3:8.2f} us  plain {p_ms * 1e3:8.2f} us  wrapper "
              f"{w_ms * 1e3:8.2f} us  bound {b[0] * 1e3:6.3f} us "
              f"({nbytes} B, {flops} flop)", flush=True)
        return k_ms

    def check_chain(a, row=None, grouped_row=None, label=""):
        """A chain call: bit for bit its sub-steps launched one at a
        time on the grouped kernel (each also against its plain version
        and timed), within the tolerance of its plain version; times the
        chain beside the sum of its sub-steps' launches."""
        with torch.no_grad():
            got = shuffle_gemm_chain(**a)
            steps = shuffle_gemm_steps(**a)
            torch.cuda.synchronize()
            if not torch.equal(got, steps):
                bad = (got != steps).nonzero()[0].tolist()
                raise AssertionError(
                    f"{label}chain {describe('shuffle_gemm_chain', a)} is "
                    f"not its sub-steps launched one at a time: at {bad} "
                    f"{float(got[tuple(bad)])} vs {float(steps[tuple(bad)])}")
        k_ms = time_call("shuffle_gemm_chain", a, row, label)
        s_ms, xi = 0.0, a["x"]
        for idx, pads, w, reps, groups, nb, scale in chain_steps(
                a["segment"], a["ws"], xi.device, xi.dtype):
            ga = dict(x=xi, idx=idx, pad_vals=pads, w=w, reps=reps,
                      groups=groups, nb=nb, scale=scale)
            s_ms += time_call("shuffle_gemm_grouped_blocks", ga,
                              grouped_row, label + "  sub-step ")
            with torch.no_grad():
                xi = shuffle_gemm_grouped_blocks(**ga)
        print(f"{label}chain {k_ms * 1e3:.2f} us in one launch, bit-exact; "
              f"its {len(a['ws'])} sub-steps one launch each "
              f"{s_ms * 1e3:.2f} us", flush=True)
        return k_ms, s_ms

    chain_vs_steps = []
    for name, a in calls:
        if name == "shuffle_gemm_chain":
            chain_vs_steps.append(check_chain(
                a, per_kernel[name], per_kernel["shuffle_gemm_grouped_blocks"]))
        else:
            time_call(name, a, per_kernel[name])
    per_kernel["shuffle_gemm_chain"]["steps_ms"] = sum(
        v for _, v in chain_vs_steps)
    # bfloat16: the STFT chain (PAD fill and a diag scale in its first
    # sub-step) bit for bit its sub-steps, and against its plain version
    _, a = next(c for c in calls if c[0] == "shuffle_gemm_chain")
    a16 = dict(a, x=a["x"].to(torch.bfloat16),
               ws=[w.to(torch.bfloat16) for w in a["ws"]])
    with torch.no_grad():
        got = shuffle_gemm_chain(**a16)
        if not torch.equal(got, shuffle_gemm_steps(**a16)):
            raise AssertionError("bfloat16 chain is not its sub-steps")
        err = check_close("shuffle_gemm_chain", a16, got, ref_chain(**a16),
                          "bfloat16")
    print(f"shuffle_gemm_chain bfloat16 (STFT): bit for bit its sub-steps; "
          f"max_abs_err {err:.3e} vs plain (tol {TOL['bfloat16']})",
          flush=True)
    # the grouped kernel's own path: the shuffle_gemm_grouped entry point
    # on the chains' 16 sub-steps, one launch each
    from repro_torch.kernels import shuffle_gemm_grouped
    reset_launch_counts()
    with torch.no_grad():
        entry = []
        for _, a in (c for c in calls if c[0] == "shuffle_gemm_chain"):
            y = a["x"]
            for st, w in zip(a["segment"].steps, a["ws"]):
                y = shuffle_gemm_grouped(y, st.plan, w, st.reps, st.groups,
                                         st.nb, diag=st.diag)
            entry.append((a, y))
        torch.cuda.synchronize()
    grouped_counts = launch_counts()
    if grouped_counts != {"shuffle_gemm_blocks": 0,
                          "shuffle_gemm_grouped_blocks": 16,
                          "shuffle_gemm_chain": 0}:
        raise AssertionError(f"the grouped entry point launched "
                             f"{grouped_counts}")
    with torch.no_grad():
        for a, y in entry:
            if not torch.equal(y, shuffle_gemm_chain(**a)):
                raise AssertionError("shuffle_gemm_grouped step by step is "
                                     "not the chain")
    print(f"shuffle_gemm_grouped entry point on the 16 sub-steps: launches "
          f"{grouped_counts}, equal to the chains", flush=True)

    # -- 3. offline forward: hopper vs reference on the card ----------------
    phase("3 offline")
    reference = graph.compile(LENGTH, fuse=2, backend="reference",
                              device="cuda")
    with torch.no_grad():
        reset_launch_counts()
        out_h = hopper(x, params)
        torch.cuda.synchronize()
        offline_counts = launch_counts()
        out_r = reference(x, params)
        torch.cuda.synchronize()
    print(f"launches in one forward: {offline_counts}")
    if offline_counts != FORWARD_LAUNCHES:
        raise AssertionError(f"one Fig-9 forward launched {offline_counts}, "
                             f"not {FORWARD_LAUNCHES}")
    shapes = {"out": (BATCH, LENGTH),
              "mel_tap": (BATCH, 1 + (LENGTH - 256) // 128, 24)}
    for k, shape in shapes.items():
        h, r = out_h[k], out_r[k]
        if tuple(h.shape) != shape or not bool(torch.isfinite(h).all()):
            raise AssertionError(f"{k}: shape {tuple(h.shape)} (want "
                                 f"{shape}) or non-finite values")
        torch.testing.assert_close(h, r, rtol=1e-4, atol=1e-5)
        print(f"{k}: {tuple(h.shape)} hopper vs reference max abs err "
              f"{float((h - r).abs().max()):.3e} (rtol 1e-4, atol 1e-5)")
    with torch.no_grad():
        fwd_h = wall_ms(torch, lambda: hopper(x, params), iters=10)
        fwd_r = wall_ms(torch, lambda: reference(x, params), iters=10)
    print(f"forward wall time, batch {BATCH}: hopper {fwd_h:.3f} ms, "
          f"reference {fwd_r:.3f} ms", flush=True)
    profile_forward(torch, lambda: hopper(x, params), fwd_h)

    # -- 4. serve: 8 mixed-length requests, one bucket ----------------------
    phase("4 serve")
    svc = SignalService(batch_size=4, backend="hopper", device="cuda")
    svc.register("speech_enhancement", graph, params={"mask": cnn})

    def requests(base):
        return [SignalRequest(rid=base + i, graph="speech_enhancement",
                              samples=s) for i, s in enumerate(xs_serve)]

    svc.serve(requests(0))                 # compiles the 4096 bucket
    torch.cuda.synchronize()
    rids = [100 * (k + 1) + i for k in range(SERVE_ROUNDS) for i in range(8)]
    for k in range(SERVE_ROUNDS):
        for r in requests(100 * (k + 1)):
            svc.submit(r)
    results, step_ms = {}, []
    reset_launch_counts()
    t_serve = time.perf_counter()
    while svc.pending():
        t1 = time.perf_counter()
        results.update(svc.step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    serve_s = time.perf_counter() - t_serve
    serve_counts = launch_counts()
    waves = len(rids) // 4
    print(f"served {len(results)} requests in {len(step_ms)} steps "
          f"(smoke reading, not a benchmark): "
          f"{len(results) / serve_s:.1f} requests/s, p50 step "
          f"{float(np.median(step_ms)):.3f} ms (steps "
          f"{', '.join(f'{s:.3f}' for s in step_ms)} ms); "
          f"stats {svc.stats}; launches {serve_counts}")
    if sorted(results) != rids or serve_counts != {
            n: c * waves for n, c in FORWARD_LAUNCHES.items()}:
        raise AssertionError(f"serving did not run {waves} bucketed waves "
                             f"of {FORWARD_LAUNCHES} launches")
    worst = {"out": 0.0, "mel_tap": 0.0}
    with torch.no_grad():
        for i, t in enumerate(SERVE_LENGTHS):
            off = graph.compile(t, fuse=2, backend="hopper", device="cuda")(
                torch.as_tensor(xs_serve[i][None], device="cuda"),
                {"mask": cnn})
            for (k, (rtol, atol)), rnd in itertools.product(
                    (("out", (0.0, 1e-5)), ("mel_tap", (1e-4, 1e-4))),
                    range(SERVE_ROUNDS)):
                got = results[100 * (rnd + 1) + i][k]
                want = off[k][0].cpu().numpy()
                if got.shape != want.shape or not np.all(np.isfinite(got)):
                    raise AssertionError(f"request {i} ({t}) {k}: shape "
                                         f"{got.shape} vs {want.shape}")
                np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
                worst[k] = max(worst[k], float(np.abs(got - want).max()))
    print(f"served == offline compile at true length: max abs err "
          f"out {worst['out']:.3e} (atol 1e-5), mel_tap "
          f"{worst['mel_tap']:.3e} (rtol 1e-4, atol 1e-4)", flush=True)

    # -- 5. precision: Fig-9q calibrated, solved, served --------------------
    phase("5 precision")
    from repro_torch import precision as pz
    from repro_torch.core import bitwidth as bw
    from repro_torch.kernels import bitserial_mm as bsm
    from repro_torch.signal import HopperBackend
    gq = fig9q_graph(LENGTH)
    fq = gq.compile(LENGTH, fuse=2, backend="hopper", device="cuda")
    q_batches = [rng.standard_normal((BATCH, LENGTH)).astype(np.float32)
                 for _ in range(Q_BATCHES)]
    t0 = time.perf_counter()
    policy, record = pz.auto_policy(fq, q_batches, budget=Q_BUDGET)
    print(f"auto_policy on {Q_BATCHES} batches of ({BATCH}, {LENGTH}) at "
          f"budget {Q_BUDGET} in {time.perf_counter() - t0:.2f} s: "
          f"{dict(policy.widths)}")
    for name in record.gemm_steps():
        st = record.steps[name]
        print(f"  {name}: k {st.k} rows {st.rows} reaches {st.reaches} "
              f"local err {st.local_err}")
    qback = HopperBackend(precision=policy)
    cq = fq.with_backend(qback)
    rep_q = cq.lowering_report()
    print(f"Fig-9q lowering under the policy: {rep_q}")
    n_int = len(policy.widths)
    if not n_int or rep_q["array_passes"]["int_routed"] != n_int:
        raise AssertionError(f"{rep_q['array_passes']} int-routes other "
                             f"than the policy's {n_int} steps")
    with torch.no_grad():
        bsm.reset_launch_counts()
        out_q = cq(x)
        torch.cuda.synchronize()
        offline_q = bsm.launch_counts()
    if offline_q != {"bitserial_matmul_planes": 0,
                     "bitserial_quant_matmul_hopper": n_int}:
        raise AssertionError(f"one Fig-9q forward launched {offline_q}")
    with torch.no_grad():
        fwd_q = wall_ms(torch, lambda: cq(x), iters=10)
    print(f"Fig-9q forward wall time, batch {BATCH}, int-routed: "
          f"{fwd_q:.3f} ms; bitserial launches {offline_q}", flush=True)
    q_launches = profile_forward(torch, lambda: cq(x), fwd_q)
    print(f"Fig-9q forward: "
          f"{'not measured' if q_launches is None else q_launches} device "
          f"launches (kernels and copies, from the profile), {fwd_q:.3f} ms "
          f"wall", flush=True)
    for k, shape in shapes.items():
        if tuple(out_q[k].shape) != shape \
                or not bool(torch.isfinite(out_q[k]).all()):
            raise AssertionError(f"Fig-9q {k}: shape "
                                 f"{tuple(out_q[k].shape)} or non-finite")
    bs_calls = record_calls(torch, lambda: cq(x),
                            "repro_torch.kernels.bitserial_mm.ops",
                            ("bitserial_quant_matmul_hopper",))
    if len(bs_calls) != n_int:
        raise AssertionError(f"{len(bs_calls)} bitserial calls recorded")
    per = (f"sum over the {n_int} int-routed calls of one batch-{BATCH} "
           f"Fig-9q forward")
    rows["bitserial_quant_matmul_hopper"] = new_row(n_int, per)
    rows["bitserial_matmul_planes"] = new_row(
        n_int, per + ", on their quantized digit planes")
    lib_ms, int_mm_ms, int_mm_k_ms, int_mm_calls = 0.0, 0.0, 0.0, 0
    planes_in = []
    with torch.no_grad():
        for _, a in bs_calls:
            h, wf, aw, ww = a["h"], a["w"], a["aw"], a["ww"]
            (m, kk), n = h.shape, wf.shape[1]
            # the one-launch int route against its plain version
            got_q = bsm.bitserial_quant_matmul_hopper(h, wf, aw, ww)
            want_q = bsm.ref_bitserial_quant_matmul(h, wf, aw, ww)
            torch.cuda.synchronize()
            if not torch.equal(got_q, want_q):
                bad = (got_q != want_q).nonzero()[0].tolist()
                raise AssertionError(
                    f"bitserial_quant_matmul_hopper ({m}, {kk}, {n}) "
                    f"{(aw, ww)}: not bit-exact at {bad}: "
                    f"{float(got_q[tuple(bad)])} vs "
                    f"{float(want_q[tuple(bad)])}")
            # the planes kernel on the same call's digit planes
            xq, xs = bw.quantize(h, aw, axis=-1)
            wq, ws = bw.quantize(wf, ww, axis=0)
            ap = torch.stack(bw.split_planes(xq, aw)).contiguous()
            wp = torch.stack(bw.split_planes(wq, ww)).contiguous()
            planes_in.append((xq, wq, aw, ww))
            got = bsm.bitserial_matmul_planes(ap, wp)
            want = bsm.ref_bitserial_matmul_planes(ap, wp)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).nonzero()[0].tolist()
                raise AssertionError(
                    f"bitserial_matmul_planes {tuple(ap.shape)} x "
                    f"{tuple(wp.shape)}: not bit-exact at {bad}: "
                    f"{int(got[tuple(bad)])} vs {int(want[tuple(bad)])}")
            if not torch.equal(got.to(torch.float32) * xs * ws, got_q):
                raise AssertionError("the planes kernel, dequantized, is "
                                     "not the one-launch kernel's output")
            scalar_div = int((torch.clamp(torch.amax(h.abs(), -1,
                                                     keepdim=True), min=1e-8)
                              / float(2 ** (aw - 1) - 1) != xs).sum())
            pa, pw = ap.shape[0], wp.shape[0]
            ops = 2 * m * n * kk * pa * pw
            bq = bound(4 * (m * kk + kk * n + m * n), ops, INT8_OPS_PER_S)
            bp = bound(ap.numel() + wp.numel() + 4 * m * n, ops,
                       INT8_OPS_PER_S)
            kq_ms = device_ms(torch, lambda: bsm.bitserial_quant_matmul_hopper(
                h, wf, aw, ww))
            pq_ms = device_ms(torch, lambda: bsm.ref_bitserial_quant_matmul(
                h, wf, aw, ww))
            k_ms = device_ms(torch,
                             lambda: bsm.bitserial_matmul_planes(ap, wp))
            p_ms = device_ms(torch,
                             lambda: bsm.ref_bitserial_matmul_planes(ap, wp))
            add_call(rows["bitserial_quant_matmul_hopper"], 0.0, kq_ms, pq_ms,
                     bq)
            add_call(rows["bitserial_matmul_planes"], 0.0, k_ms, p_ms, bp)
            f_ms, f_txt = f64_yardstick(torch, xq, wq, got)
            lib_ms += f_ms
            lib = int_mm_operands(torch, xq, wq, aw, ww)
            l_txt = "torch._int_mm none (a 16-bit operand)"
            if lib is not None:
                li = torch._int_mm(*lib)[:m, :n]
                if not torch.equal(li, got):
                    raise AssertionError("torch._int_mm disagrees with the "
                                         "bitserial kernel")
                l_ms = device_ms(torch, lambda: torch._int_mm(*lib))
                int_mm_ms, int_mm_k_ms, int_mm_calls = (
                    int_mm_ms + l_ms, int_mm_k_ms + k_ms, int_mm_calls + 1)
                l_txt = f"torch._int_mm {l_ms * 1e3:8.2f} us (padded)"
            print(f"bitserial call widths {(aw, ww)} planes {pa}x{pw} M "
                  f"{m:6d} K {kk:4d} N {n:4d} | both kernels bit-exact | "
                  f"one-launch kernel {kq_ms * 1e3:7.2f} us  plain "
                  f"{pq_ms * 1e3:8.2f} us  bound {bq[0] * 1e3:6.3f} us | "
                  f"planes kernel {k_ms * 1e3:7.2f} us  plain "
                  f"{p_ms * 1e3:8.2f} us  bound {bp[0] * 1e3:6.3f} us | "
                  f"library {f_txt}; {l_txt} | quantize: a division by the "
                  f"Python number qmax would miss the IEEE scale on "
                  f"{scalar_div} of {m} rows", flush=True)
    # the planes kernel's own path: the bitserial_matmul entry point on
    # the quantized operands of the same calls
    bsm.reset_launch_counts()
    with torch.no_grad():
        entry = [bsm.bitserial_matmul(xq, wq, aw, ww)
                 for xq, wq, aw, ww in planes_in]
        torch.cuda.synchronize()
    planes_counts = bsm.launch_counts()
    if planes_counts != {"bitserial_matmul_planes": n_int,
                         "bitserial_quant_matmul_hopper": 0}:
        raise AssertionError(f"bitserial_matmul launched {planes_counts}")
    for (xq, wq, _, _), y in zip(planes_in, entry):
        if not torch.equal(y, bsm.ref_bitserial_matmul(xq, wq)):
            raise AssertionError("bitserial_matmul is not the exact "
                                 "integer product")
    print(f"bitserial_matmul entry point on the {n_int} calls' quantized "
          f"operands: launches {planes_counts}, exact", flush=True)
    for name in ("bitserial_quant_matmul_hopper", "bitserial_matmul_planes"):
        rows[name].update(library_ms=lib_ms, library=F64_LIBRARY)
    if int_mm_calls:
        rows["bitserial_matmul_planes"].update(
            int_mm_ms=int_mm_ms, int_mm_kernel_ms=int_mm_k_ms,
            int_mm=f"torch._int_mm on the int8 operands (padded to its "
            f"shape rules) of the {int_mm_calls} of {n_int} calls whose "
            f"widths are both at most 8; int_mm_kernel_ms is the kernel's "
            f"time on the same calls")
    errs = pz.policy_errors(record, policy)
    print(f"held-out relative L2 error vs the float32 reference: {errs} "
          f"(budget {Q_BUDGET})")
    if set(errs) != set(shapes) or max(errs.values()) > Q_BUDGET:
        raise AssertionError(f"held-out error {errs} beyond {Q_BUDGET}")

    svc_q = SignalService(batch_size=4, backend="hopper", precision=policy,
                          device="cuda")
    svc_q.register("fig9q", gq)

    def q_requests(base):
        return [SignalRequest(rid=base + i, graph="fig9q", samples=s)
                for i, s in enumerate(xs_serve)]

    svc_q.serve(q_requests(0))             # compiles the 4096 bucket
    torch.cuda.synchronize()
    for k in range(SERVE_ROUNDS):
        for r in q_requests(100 * (k + 1)):
            svc_q.submit(r)
    q_results, q_step_ms = {}, []
    reset_launch_counts()
    bsm.reset_launch_counts()
    t_serve = time.perf_counter()
    while svc_q.pending():
        t1 = time.perf_counter()
        q_results.update(svc_q.step())
        torch.cuda.synchronize()
        q_step_ms.append((time.perf_counter() - t1) * 1e3)
    q_serve_s = time.perf_counter() - t_serve
    q_counts = {**launch_counts(), **bsm.launch_counts()}
    print(f"served {len(q_results)} Fig-9q requests in {len(q_step_ms)} "
          f"steps (smoke reading, not a benchmark): "
          f"{len(q_results) / q_serve_s:.1f} requests/s, p50 step "
          f"{float(np.median(q_step_ms)):.3f} ms (steps "
          f"{', '.join(f'{v:.3f}' for v in q_step_ms)} ms); stats "
          f"{svc_q.stats}; launches {q_counts}")
    if sorted(q_results) != rids \
            or q_counts["bitserial_quant_matmul_hopper"] != n_int * waves \
            or q_counts["bitserial_matmul_planes"]:
        raise AssertionError(f"calibrated serving did not run {waves} "
                             f"waves of {n_int} bitserial launches")
    worst_q = {k: 0.0 for k in shapes}
    with torch.no_grad():
        for i, t in enumerate(SERVE_LENGTHS):
            off = gq.compile(t, fuse=2, backend=qback, device="cuda")(
                torch.as_tensor(xs_serve[i][None], device="cuda"))
            for k, rnd in itertools.product(shapes, range(SERVE_ROUNDS)):
                got = q_results[100 * (rnd + 1) + i][k]
                want = off[k][0].cpu().numpy()
                if got.shape != want.shape or not np.all(np.isfinite(got)):
                    raise AssertionError(f"Fig-9q request {i} ({t}) {k}: "
                                         f"shape {got.shape} vs {want.shape}")
                d = np.abs(got - want)
                if d.max() > 1e-5:
                    j = np.unravel_index(d.argmax(), d.shape)
                    raise AssertionError(
                        f"Fig-9q request {i} ({t}) {k}: served {got[j]} vs "
                        f"offline {want[j]} at {j} ({int((d > 1e-5).sum())} "
                        f"elements beyond atol 1e-5)")
                worst_q[k] = max(worst_q[k], float(d.max()))
    print(f"served == int-routed offline compile at true length: max abs "
          f"err {worst_q} (atol 1e-5)", flush=True)

    # -- 6. entry points: fft_hopper and fir_conv ---------------------------
    phase("6 entry points")
    import torch.nn.functional as F
    from repro_torch.kernels.fft_stage import (
        fft_stage_hopper, fft_stages_hopper, ref_fft_stage_hopper)
    from repro_torch.kernels.fft_stage import ops as fft_ops
    from repro_torch.kernels.fir_conv import fir_conv_hopper
    from repro_torch.signal.graph import hann_window
    n_frames = 1 + (LENGTH - 256) // 128
    frames = np.stack([x_np[:, f * 128:f * 128 + 256]
                       for f in range(n_frames)], axis=1) * hann_window(256)
    z = torch.as_tensor(frames.reshape(-1, 256).astype(np.complex64),
                        device="cuda")
    a, b, rd = fft_entry_reading(torch, z)
    fft_counts = rd["launches"]
    print(f"fft_hopper {tuple(z.shape)} complex64 vs torch.fft.fft: max abs "
          f"err {rd['library_err']:.3e} (rtol = atol = 2e-3); launches "
          f"{fft_counts}")
    n_st, err, k_ms, p_ms = rd["stages"], rd["max_abs_err"], rd["ms"], \
        rd["plain_ms"]
    b_, n2 = a["x"].shape
    rows["fft_stages_hopper"] = new_row(
        1, f"one fft_hopper call on the {z.shape[0]} Fig-9 STFT frames of "
           f"256: its {n_st} stages and the final scatter in one launch")
    add_call(rows["fft_stages_hopper"], err, k_ms, p_ms, b)
    print(f"fft_stages_hopper {n_st} stages + scatter, one launch | "
          f"max_abs_err {err:.3e} (tol 1e-4) | kernel {k_ms * 1e3:8.2f} us  "
          f"plain {p_ms * 1e3:8.2f} us  bound {b[0] * 1e3:6.3f} us",
          flush=True)
    # where the launch's time goes: the same launch over the first s stages
    prefix = []
    with torch.no_grad():
        for s_ in range(1, n_st + 1):
            pa = dict(a, idx=a["idx"][:s_].contiguous(), nb=a["nb"][:s_],
                      tw=a["tw"][:sum(n2 // 4 // nb for nb in a["nb"][:s_])]
                      .contiguous())
            prefix.append(device_ms(torch, lambda: fft_stages_hopper(**pa)))
    print("fft_stages_hopper over the first s stages (+ scatter), us: "
          + ", ".join(f"s={i + 1} {t * 1e3:.2f}"
                      for i, t in enumerate(prefix)), flush=True)
    single = new_row(0, f"sum over the {n_st} stages run one launch each "
                        f"through fft_stage_hopper")
    xr = a["x"]
    with torch.no_grad():
        for st in fft_ops._plan(256).stages:
            sa = dict(x=xr, idx=fft_ops._stage_index(st, "cuda"),
                      tw=torch.as_tensor(st.twiddle, device="cuda"),
                      half=st.half, nb=st.nb)
            got, want = fft_stage_hopper(**sa), ref_fft_stage_hopper(**sa)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            k_ms = device_ms(torch, lambda: fft_stage_hopper(**sa))
            p_ms = device_ms(torch, lambda: ref_fft_stage_hopper(**sa))
            b = bound(2 * 4 * b_ * n2 + 4 * n2 + 4 * sa["tw"].numel(),
                      8 * b_ * n2, FP32_FLOP_PER_S)
            add_call(single, err, k_ms, p_ms, b)
            single["calls"] += 1
            print(f"fft_stage_hopper half {st.half:4d} nb {st.nb:4d} | "
                  f"max_abs_err {err:.3e} (tol 1e-4) | kernel "
                  f"{k_ms * 1e3:8.2f} us  plain {p_ms * 1e3:8.2f} us  bound "
                  f"{b[0] * 1e3:6.3f} us", flush=True)
            xr = got
    print(f"the {single['calls']} stages one launch each: kernel "
          f"{single['ms'] * 1e3:.2f} us, plain {single['plain_ms'] * 1e3:.2f} "
          f"us, summed per-stage bound {single['bound_ms'] * 1e3:.3f} us")
    rows["fft_stages_hopper"].update(
        library_ms=rd["library_ms"],
        library="torch.fft.fft over the same frames (the whole FFT)",
        single_stage={k: single[k] for k in (
            "calls", "max_abs_err", "ms", "plain_ms", "bound_ms", "per")})
    print(f"torch.fft.fft on the same frames: "
          f"{rows['fft_stages_hopper']['library_ms'] * 1e3:.2f} us",
          flush=True)

    h = torch.as_tensor((np.hanning(9) / np.hanning(9).sum())
                        .astype(np.float32), device="cuda")
    a, b, rd = fir_entry_reading(torch, x, h)
    fir_counts = rd["launches"]
    print(f"fir_conv {tuple(x.shape)} 9 taps 8 phases vs causal F.conv1d: "
          f"max abs err {rd['library_err']:.3e} (rtol = atol = 1e-4)")
    rows["fir_conv_hopper"] = new_row(
        1, f"one fir_conv call on the ({BATCH}, {LENGTH}) input, 9 taps, "
           f"8 phases")
    with torch.no_grad():
        # in turns with the copy probe, the launch floor (probe, kernel,
        # kernel, probe)
        turns = [device_ms(torch, f) for f in (
            probe, lambda: fir_conv_hopper(**a), lambda: fir_conv_hopper(**a),
            probe)]
    k_ms, floor_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    m, win, p_ = rd["windows"], rd["window"], rd["phases"]
    add_call(rows["fir_conv_hopper"], rd["max_abs_err"], k_ms,
             rd["plain_ms"], b)
    rows["fir_conv_hopper"]["launch_floor_ms"] = floor_ms
    rows["fir_conv_hopper"].update(
        library_ms=rd["library_ms"],
        library="causal F.conv1d (flipped taps, left pad) on the same "
                "input, without the pad")
    print(f"fir_conv_hopper M {m} L {win} P {p_} | max_abs_err "
          f"{rd['max_abs_err']:.3e} (tol 1e-4) | kernel {k_ms * 1e3:8.3f} us"
          f"  plain {rd['plain_ms'] * 1e3:8.2f} us  bound {b[0] * 1e3:6.3f} "
          f"us  library {rows['fir_conv_hopper']['library_ms'] * 1e3:8.3f} "
          f"us | launch floor (the copy probe) {floor_ms * 1e3:.3f} us; in "
          f"turns probe/kernel/kernel/probe: "
          + ", ".join(f"{t * 1e3:.3f}" for t in turns) + " us",
          flush=True)

    # -- 7. train: Fig 9 through value_and_grad, then AdamW -----------------
    phase("7 train")
    from repro_torch.data import SignalStream
    from repro_torch.pipelines import speech_enhancement as tse
    from repro_torch.signal import PrecisionPolicy
    stream = SignalStream(LENGTH, BATCH, seed=args.seed)
    b0 = stream.batch_at(0)
    noisy = torch.as_tensor(b0["noisy"], device="cuda")
    clean = torch.as_tensor(b0["clean"], device="cuda")
    vag_h = hopper.value_and_grad(tse.loss_fn, wrt=tse.TRAINABLE)
    vag_r = reference.value_and_grad(tse.loss_fn, wrt=tse.TRAINABLE)
    reset_launch_counts()
    loss_h, grads_h = vag_h(params, noisy, clean)
    torch.cuda.synchronize()
    train_counts = launch_counts()
    print(f"launches in one value_and_grad step: {train_counts} (forward "
          f"{FORWARD_LAUNCHES}, backward {BACKWARD_LAUNCHES})")
    if train_counts != TRAIN_LAUNCHES:
        raise AssertionError(f"one Fig-9 value_and_grad step launched "
                             f"{train_counts}, not {TRAIN_LAUNCHES}")
    loss_r, grads_r = vag_r(params, noisy, clean)
    torch.cuda.synchronize()
    leaves = [("loss", loss_h, loss_r),
              ("front.taps", grads_h["front"]["taps"],
               grads_r["front"]["taps"])] + [
        (f"mask[{i}]", a, b)
        for i, (a, b) in enumerate(zip(grads_h["mask"], grads_r["mask"]))]
    for name, a, b in leaves:
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite values")
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        print(f"{name}: {tuple(a.shape)} hopper vs reference max abs err "
              f"{float((a - b).abs().max()):.3e} (rtol 1e-4, atol 1e-5)")
    if not all(float(g.abs().max()) > 0 for _, g, _ in leaves[1:]):
        raise AssertionError("a gradient leaf is all zeros")
    step_h = wall_ms(torch, lambda: vag_h(params, noisy, clean), iters=10)
    step_r = wall_ms(torch, lambda: vag_r(params, noisy, clean), iters=10)
    print(f"value_and_grad step wall time, batch {BATCH}: hopper "
          f"{step_h:.3f} ms, reference {step_r:.3f} ms", flush=True)
    profile_forward(torch, lambda: vag_h(params, noisy, clean), step_h,
                    label="hopper value_and_grad step", grad=True)
    step_calls = record_calls(torch, lambda: vag_h(params, noisy, clean),
                              grad=True)
    fwd_n = sum(FORWARD_LAUNCHES.values())
    check_fig9_calls(step_calls[:fwd_n])
    backward = {n: new_row(0, "sum over the backward calls of one batch-"
                           f"{BATCH} Fig-9 value_and_grad step")
                for n in wrappers}
    for name, a in step_calls[fwd_n:]:
        if name == "shuffle_gemm_chain":
            check_chain(a, backward[name], label="backward ")
        else:
            time_call(name, a, backward[name], label="backward ")
    bw_counts = {n: r["calls"] for n, r in backward.items()}
    if bw_counts != BACKWARD_LAUNCHES:
        raise AssertionError(f"backward calls {bw_counts}")
    for n, r in backward.items():
        print(f"backward {n}: {r['calls']} calls, kernel "
              f"{r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
              f"bound {r['bound_ms'] * 1e3:.3f} us a step")

    t0 = time.perf_counter()
    res = tse.train(hopper, params, stream, steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    print(f"train {TRAIN_STEPS} AdamW steps on hopper in "
          f"{time.perf_counter() - t0:.2f} s: losses "
          f"{[round(v, 6) for v in res.losses]}; held-out loss "
          f"{res.eval_before:.6f} -> {res.eval_after:.6f}")
    if not all(np.isfinite(res.losses)) \
            or not res.eval_after < res.eval_before:
        raise AssertionError("training did not lower the held-out loss")

    # Fig-9q: the int route's straight-through gradient.  With one
    # int-routed step at the end of a path (the mel tap at the phase-5
    # policy's widths) value_and_grad equals that of y_float + (y_int -
    # y_float).detach() exactly, as the JAX package's test asserts; with
    # several int-routed steps in series the later steps see quantized
    # activations, so the full policy's gradient is checked finite and
    # informative instead.
    mel_key = next(k for k in policy.widths if k.startswith("mel_tap"))
    c_mel = fq.with_backend(
        HopperBackend(precision=PrecisionPolicy(
            {mel_key: policy.widths[mel_key]})))
    f_ref = fq.with_backend("reference")
    q_params = fq.init_params()

    def mel_loss(outs):
        return torch.mean(outs["mel_tap"] ** 2)

    bsm.reset_launch_counts()
    l_q, g_q = c_mel.value_and_grad(mel_loss, wrt=("mel_tap",))(q_params, x)
    torch.cuda.synchronize()
    if bsm.launch_counts() != {"bitserial_matmul_planes": 0,
                               "bitserial_quant_matmul_hopper": 1}:
        raise AssertionError(f"Fig-9q mel step launched "
                             f"{bsm.launch_counts()}")
    w_mel = torch.as_tensor(q_params["mel_tap"]["weights"],
                            device="cuda").requires_grad_()
    p_mel = {**q_params, "mel_tap": {"weights": w_mel}}
    y_float = f_ref(x, p_mel)["mel_tap"]
    y_st = y_float + (c_mel(x, p_mel)["mel_tap"] - y_float).detach()
    l_st = torch.mean(y_st ** 2)
    (g_st,) = torch.autograd.grad(l_st, w_mel)
    torch.testing.assert_close(l_q, l_st.detach(), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(g_q["mel_tap"]["weights"], g_st, rtol=1e-4,
                               atol=1e-5)
    if not float(g_st.abs().max()) > 0:
        raise AssertionError("the straight-through gradient is all zeros")
    print(f"Fig-9q {mel_key} {policy.widths[mel_key]} int-routed: "
          f"value_and_grad == y_float + (y_int - y_float).detach(): loss "
          f"err {float((l_q - l_st.detach()).abs()):.3e}, grad max abs err "
          f"{float((g_q['mel_tap']['weights'] - g_st).abs().max()):.3e} "
          f"(rtol 1e-4, atol 1e-5)")
    bsm.reset_launch_counts()
    l_all, g_all = cq.value_and_grad(
        lambda outs: sum(torch.mean(v ** 2) for v in outs.values()))(
        q_params, x)
    torch.cuda.synchronize()
    flat = [g for st in g_all.values() for g in st.values()]
    if bsm.launch_counts() != {"bitserial_matmul_planes": 0,
                               "bitserial_quant_matmul_hopper": n_int} \
            or not all(bool(torch.isfinite(g).all()) for g in flat) \
            or not all(float(g.abs().max()) > 0 for g in flat):
        raise AssertionError(f"Fig-9q value_and_grad under the full policy: "
                             f"launches {bsm.launch_counts()}, grads finite "
                             f"and nonzero?")
    print(f"Fig-9q value_and_grad under the full policy ({n_int} int-routed "
          f"steps): loss {float(l_all):.6f}, {len(flat)} gradient leaves "
          f"finite and nonzero", flush=True)

    # -- 8. attention: flash_attention at shipped configs' widths ----------
    phase("8 attention")
    from repro_torch.kernels import flash_attention, ref_attention
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ref_split_kv
    attn_rng = np.random.default_rng(args.seed + 1)
    attn_in = []
    for label, src, s_, h_, kv_, hd_, win, cap, dt, tol in ATTENTION:
        q, k, v = (torch.as_tensor(attn_rng.standard_normal(
            (1, s_, n, hd_)).astype(np.float32), device="cuda").to(
            getattr(torch, dt)) for n in (h_, kv_, kv_))
        attn_in.append((q, k, v, dict(causal=True, window=win, softcap=cap)))
    # each call is driven with the counts at 0 just before it and read
    # just after, so the launches a call makes are measured by type
    attn_out, call_launches, flash_counts = [], {}, {}
    for (label, *_, dt, _), (q, k, v, kw) in zip(ATTENTION, attn_in):
        flash_kernel.reset_launch_counts()
        with torch.no_grad():
            attn_out.append(flash_attention(q, k, v, **kw))
        torch.cuda.synchronize()
        made = flash_kernel.launch_counts()
        want = {name: flash_kernel.LAUNCHES_PER_CALL[getattr(torch, dt)].get(
            name, 0) for name in made}
        if made != want:
            raise AssertionError(f"the {label} {dt} call launched {made}, "
                                 f"not {want}")
        call_launches[f"{label} {dt}"] = made
        for name, n in made.items():
            flash_counts[name] = flash_counts.get(name, 0) + n
    print(f"flash launches {flash_counts}; by call: {call_launches}",
          flush=True)
    rows["flash_attention_hopper"] = new_row(
        len(ATTENTION), "sum over the four calls: a gemma2-2b local layer "
        "and a starcoder2-3b layer, each in float32 and in bfloat16")
    rows["flash_attention_hopper"]["launches_per_call"] = call_launches
    rows["flash_split_kv_hopper"] = new_row(
        2, "sum over the two float32 calls' pre-pass (K and V split into "
        "TF32 big and small, V transposed, as the attention body's tile "
        "images), one launch a float32 call")
    per_call, lib_ms, lib_k_ms = [], 0.0, 0.0
    fa = flash_kernel.flash_attention_hopper
    split = flash_kernel.flash_split_kv_hopper

    def check(what, got, want, tol):
        """Elementwise at ``tol`` and the whole output's relative L2 error
        under ATTN_REL_L2; returns (max abs error, relative L2 error)."""
        got, want = got.float(), want.float()
        torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1],
                                   msg=lambda m: f"{what}: {m}")
        rel = float((got - want).norm() / want.norm())
        if not rel < ATTN_REL_L2:
            raise AssertionError(f"{what}: relative L2 error {rel:.3e}")
        return float((got - want).abs().max()), rel

    for (label, src, s_, h_, kv_, hd_, win, cap, dt, tol), (q, k, v, kw), \
            got in zip(ATTENTION, attn_in, attn_out):
        with torch.no_grad():
            if not (tuple(got.shape) == tuple(q.shape) and got.dtype == q.dtype
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"{label} {dt}: shape, type or values")
            err, rel = check(f"{label} {dt} vs plain", got,
                             ref_attention(q, k, v, **kw), tol)
            if dt == "float32" and not err <= F32_MAX_ABS:
                raise AssertionError(f"{label} float32: max abs error "
                                     f"{err:.3e} over {F32_MAX_ABS}")
            k_ms = device_ms(torch, lambda: fa(q, k, v, **kw), reps=3,
                             iters=3)
            p_ms = device_ms(torch, lambda: ref_attention(q, k, v, **kw),
                             reps=1, iters=3)
        pairs = sum(min(i + 1, win) if win else i + 1 for i in range(s_))
        flops = 4 * h_ * hd_ * pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        if dt == "float32":
            # the split-TF32 bound (three TF32 products a float32 one) is
            # the row's; the FMA bound is what no FMA kernel can beat
            b = bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
            b_fma = bound(nbytes, flops, FP32_FLOP_PER_S)
            bound_txt = (f"bound split-TF32 {b[0] * 1e3:9.1f} us "
                         f"({100 * b[0] / k_ms:.1f}% of it), FMA "
                         f"{b_fma[0] * 1e3:9.1f} us "
                         f"({100 * b_fma[0] / k_ms:.1f}%)")
            with torch.no_grad():
                blob, want_blob = split(k, v), ref_split_kv(k, v)
                torch.cuda.synchronize()
                if not torch.equal(blob, want_blob):
                    raise AssertionError(f"{label}: flash_split_kv_hopper "
                                         f"differs from its plain version")
                s_ms = device_ms(torch, lambda: split(k, v), reps=5, iters=5)
                sp_ms = device_ms(torch, lambda: ref_split_kv(k, v), reps=1,
                                  iters=3)
            s_b = bound((k.numel() + v.numel()) * 4 + blob.numel() * 4, 0,
                        FP32_FLOP_PER_S)
            add_call(rows["flash_split_kv_hopper"], 0.0, s_ms, sp_ms, s_b)
            bound_txt += (f" | pre-pass {s_ms * 1e3:.1f} us (bit for bit its "
                          f"plain version; plain {sp_ms * 1e3:.1f} us, bound "
                          f"{s_b[0] * 1e3:.2f} us, {blob.numel() * 4} B "
                          f"scratch)")
        else:
            b = bound(nbytes, flops, BF16_FLOP_PER_S)
            bound_txt = (f"bound {b[0] * 1e3:9.1f} us "
                         f"({100 * b[0] / k_ms:.1f}% of it)")
        add_call(rows["flash_attention_hopper"], err, k_ms, p_ms, b)
        l_ms, l_txt = None, "none (softcap)"
        if not cap and not win:
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            with torch.no_grad():
                l_err, l_rel = check(f"{label} {dt} vs SDPA", got,
                                     sdpa().transpose(1, 2), tol)
                l_ms = device_ms(torch, sdpa, reps=3, iters=3)
            lib_ms, lib_k_ms = lib_ms + l_ms, lib_k_ms + k_ms
            l_txt = (f"{l_ms * 1e3:10.1f} us (F.scaled_dot_product_attention"
                     f"; vs kernel max_abs_err {l_err:.3e}, rel L2 "
                     f"{l_rel:.3e})")
        per_call.append({"call": f"{label} {dt}", "max_abs_err": err,
                         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b[0],
                         "library_ms": l_ms, **({"fma_bound_ms": b_fma[0]}
                                                if dt == "float32" else {})})
        print(f"flash_attention_hopper {label} ({src}) {dt}: S {s_} H {h_} "
              f"KV {kv_} hd {hd_} window {win} softcap {cap} | max_abs_err "
              f"{err:.3e} rel L2 {rel:.3e} (rtol {tol[0]}, atol {tol[1]}, "
              f"rel L2 {ATTN_REL_L2}) | kernel {k_ms * 1e3:10.1f} us "
              f"({flops / k_ms / 1e9:.1f} TFLOP/s, {flops} flop, {nbytes} B)"
              f"  plain {p_ms * 1e3:10.1f} us  {bound_txt} | library {l_txt}",
              flush=True)
    rows["flash_attention_hopper"].update(
        library_ms=lib_ms, library_kernel_ms=lib_k_ms, per_call=per_call,
        library="F.scaled_dot_product_attention(is_causal=True, "
        "enable_gqa=True) on the two starcoder2-3b calls; "
        "library_kernel_ms is the kernel's time on the same two calls; "
        "softcap (the gemma2-2b calls) has no library call; per_call "
        "splits the row by call")
    del attn_in, attn_out
    torch.cuda.empty_cache()

    # -- 9. stream: Fig 9 streamed, stacked, trained, calibrated, durable --
    phase("9 stream")
    import tempfile
    from repro_torch.signal import SignalGraph, StreamingRunner
    stream_rows = {n: new_row(0, f"sum over the calls of one steady tick "
                                 f"of {STREAM_SESSIONS} lock-stepped "
                                 f"sessions") for n in wrappers}
    stream_rows["shuffle_gemm_grouped_blocks"]["per"] = (
        "sum over the 16 sub-steps of one steady tick's two chains, one "
        "launch each (the chains' comparison; the tick itself launches "
        "none)")

    def stream_runner(p):
        return StreamingRunner(graph, params=p,
                               block_frames=STREAM_BLOCK_FRAMES,
                               backend="hopper", device="cuda")

    def drive(runner, sig, splits):
        """``sig`` through ``runner`` in the chunks ``splits`` cuts, then
        the flush; the outputs concatenated (mel_tap along its frames)."""
        acc = {}
        pieces = [runner.process(c)
                  for c in torch.tensor_split(sig, splits, dim=-1)]
        for piece in pieces + [runner.flush()]:
            for k, v in piece.items():
                acc.setdefault(k, []).append(v)
        return {k: torch.cat(v, dim=-1 if k == "out" else -2)
                for k, v in acc.items()}

    def hold(what, got, want, rtol, atol):
        if tuple(got.shape) != tuple(want.shape) \
                or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: shape {tuple(got.shape)} (want "
                                 f"{tuple(want.shape)}) or non-finite")
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{what}: {m}")
        return float((got - want).abs().max())

    out_tol = {"out": (0.0, 1e-5), "mel_tap": (1e-5, 1e-4)}
    # one runner, a batch of 4 in uneven chunks, against offline
    with torch.no_grad():
        reset_launch_counts()
        streamed = drive(stream_runner(params), x, STREAM_SPLITS)
        torch.cuda.synchronize()
        runner_counts = launch_counts()
        off = hopper(x, params)
    errs = {k: hold(f"streamed {k}", streamed[k], off[k], *tol)
            for k, tol in out_tol.items()}
    print(f"StreamingRunner(block_frames {STREAM_BLOCK_FRAMES}, hopper), "
          f"batch {BATCH} in chunks {np.diff([0, *STREAM_SPLITS, LENGTH])} "
          f"vs offline compile: max abs err out {errs['out']:.3e} (atol "
          f"1e-5), mel_tap {errs['mel_tap']:.3e} (rtol 1e-5, atol 1e-4); "
          f"launches {runner_counts}", flush=True)

    # N lock-stepped sessions: at most one core call a tick
    def stream_service():
        svc_ = SignalService(backend="hopper", device="cuda",
                             block_frames=STREAM_BLOCK_FRAMES)
        svc_.register("se", graph, params={"mask": cnn})
        return svc_

    def collect(acc, outs):
        for k, v in outs.items():
            acc.setdefault(k, []).append(v)

    def joined(acc):
        return {k: np.concatenate(v, axis=-1 if k == "out" else 0)
                for k, v in acc.items()}

    waves = [rng.standard_normal(LENGTH).astype(np.float32)
             for _ in range(STREAM_SESSIONS)]
    svc_s = stream_service()
    struct = svc_s._graphs["se"].struct
    compile_ms, first_tick_ms = {}, {}
    untimed_core_graph = struct.core_graph

    def timed_core_graph(n_frames, *a):
        before = len(struct._core_cache)
        t0 = time.perf_counter()
        c = untimed_core_graph(n_frames, *a)
        if len(struct._core_cache) > before:
            compile_ms[n_frames] = (time.perf_counter() - t0) * 1e3
        return c
    struct.core_graph = timed_core_graph
    sessions = [svc_s.open_stream("se") for _ in waves]
    accs = [{} for _ in waves]
    stream_counts = {n: 0 for n in STREAM_TICK_LAUNCHES}
    tick_log = []
    for lo in range(0, LENGTH, STREAM_CHUNK):
        seen = set(compile_ms)
        t1 = time.perf_counter()
        for sess, w in zip(sessions, waves):
            sess.feed(w[lo:lo + STREAM_CHUNK])
        reset_launch_counts()
        calls = svc_s.stream_step()
        made = launch_counts()
        for acc, sess in zip(accs, sessions):
            collect(acc, sess.read())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        for n in set(compile_ms) - seen:
            first_tick_ms[n] = ms
        want = {n: c * calls for n, c in STREAM_TICK_LAUNCHES.items()}
        if calls > 1 or made != want:
            raise AssertionError(f"tick at {lo}: {calls} core calls, "
                                 f"launches {made} (want {want})")
        for n, c in made.items():
            stream_counts[n] += c
        tick_log.append((calls, round(ms, 3)))
    for acc, sess in zip(accs, sessions):
        collect(acc, sess.close())
    torch.cuda.synchronize()
    print(f"{STREAM_SESSIONS} sessions, chunks of {STREAM_CHUNK}: ticks "
          f"(core calls, ms incl. compiles) {tick_log}; launches "
          f"{stream_counts}; stats {svc_s.stats}", flush=True)
    if not all(stream_counts[n] for n in ("shuffle_gemm_blocks",
                                          "shuffle_gemm_chain")):
        raise AssertionError(f"the session ticks launched {stream_counts}")
    worst = {"offline": {"out": 0.0, "mel_tap": 0.0},
             "runner": {"out": 0.0, "mel_tap": 0.0}}
    with torch.no_grad():
        for acc, w in zip(accs, waves):
            got = {k: torch.as_tensor(v, device="cuda")
                   for k, v in joined(acc).items()}
            wt = torch.as_tensor(w, device="cuda")
            off = {k: v[0] for k, v in hopper(wt[None], params).items()}
            priv = drive(stream_runner(params), wt,
                         list(range(STREAM_CHUNK, LENGTH, STREAM_CHUNK)))
            for k, tol in out_tol.items():
                worst["offline"][k] = max(worst["offline"][k], hold(
                    f"session {k} vs offline", got[k], off[k], *tol))
                worst["runner"][k] = max(worst["runner"][k], hold(
                    f"session {k} vs private runner", got[k], priv[k],
                    *tol))
    # one session alone and a private runner: bit for bit
    svc_1 = stream_service()
    solo = svc_1.open_stream("se")
    solo_acc = {}
    for lo in range(0, LENGTH, STREAM_CHUNK):
        solo.feed(waves[0][lo:lo + STREAM_CHUNK])
        svc_1.stream_step()
        collect(solo_acc, solo.read())
    collect(solo_acc, solo.close())
    with torch.no_grad():
        priv = drive(stream_runner(params),
                     torch.as_tensor(waves[0], device="cuda"),
                     list(range(STREAM_CHUNK, LENGTH, STREAM_CHUNK)))
    for k, v in joined(solo_acc).items():
        if not torch.equal(torch.as_tensor(v, device="cuda"), priv[k]):
            raise AssertionError(f"one session's {k} is not its private "
                                 f"runner's bit for bit")
    print(f"sessions vs offline compile and vs private runners (out atol "
          f"1e-5, mel_tap rtol 1e-5, atol 1e-4): max abs err {worst}; one "
          f"session == "
          f"its private runner bit for bit", flush=True)
    compiles = {n: round(compile_ms[n], 2) for n in sorted(compile_ms)}
    first = {n: round(first_tick_ms[n], 2) for n in sorted(first_tick_ms)}
    print(f"core compiles by n_frames (ms): {compiles}; the ticks that "
          f"first ran each (ms): {first}", flush=True)

    # where a steady tick goes: kernel calls vs their plain versions,
    # the tick's wall time, the profile
    steady = stream_service()
    steady_sessions = [steady.open_stream("se")
                       for _ in range(STREAM_SESSIONS)]
    feed_rng = np.random.default_rng(args.seed + 2)
    feed_pool = feed_rng.standard_normal(
        (64, STREAM_SESSIONS, STREAM_CHUNK)).astype(np.float32)
    feed_at = itertools.count()

    def tick():
        chunk = feed_pool[next(feed_at) % len(feed_pool)]
        for sess, c in zip(steady_sessions, chunk):
            sess.feed(c)
        steady.stream_step()
        for sess in steady_sessions:
            sess.read()
    for _ in range(6):                    # past the first blocks' compiles
        tick()
    steady_ms = []
    for _ in range(STREAM_STEADY_TICKS):
        t1 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        steady_ms.append((time.perf_counter() - t1) * 1e3)
    tick_p50 = float(np.median(steady_ms))
    reset_launch_counts()
    tick()
    torch.cuda.synchronize()
    steady_tick = launch_counts()
    if steady_tick != STREAM_TICK_LAUNCHES:
        raise AssertionError(f"a steady tick launched {steady_tick}")
    tick_launches = profile_forward(torch, tick, tick_p50,
                                  label=f"stream tick ({STREAM_SESSIONS} "
                                        f"sessions)")
    tick_calls = record_calls(torch, tick)
    if sorted(n for n, _ in tick_calls) != sorted(
            n for n, c in STREAM_TICK_LAUNCHES.items() for _ in range(c)):
        raise AssertionError(f"a steady tick called "
                             f"{[n for n, _ in tick_calls]}")
    for name, a in tick_calls:
        if name == "shuffle_gemm_chain":
            check_chain(a, stream_rows[name],
                        stream_rows["shuffle_gemm_grouped_blocks"],
                        label="stream ")
        else:
            time_call(name, a, stream_rows[name], label="stream ")
    # the first blocks (fewer frames: g0 = 0) against the plain versions too
    first_calls = []
    fresh = stream_service()
    fresh_sessions = [fresh.open_stream("se")
                      for _ in range(STREAM_SESSIONS)]

    def fresh_tick(k):
        for sess, w in zip(fresh_sessions, waves):
            sess.feed(w[k * STREAM_CHUNK:(k + 1) * STREAM_CHUNK])
        fresh.stream_step()
    for k in range(4):
        first_calls += record_calls(torch, lambda: fresh_tick(k))
    with torch.no_grad():
        for name, a in first_calls:
            kern, plain = wrappers[name]
            got = kern(**a)
            err = check_close(name, a, got, plain(**a), "float32")
            if name == "shuffle_gemm_chain" and not torch.equal(
                    got, shuffle_gemm_steps(**a)):
                raise AssertionError("a first-block chain is not its "
                                     "sub-steps launched one at a time")
            d = describe(name, a)
            print(f"stream first blocks {name:20s} "
                  + (f"{d['steps']} sub-steps, {d['tiles']} tiles of "
                     f"{d['tile_floats']}" if name == "shuffle_gemm_chain"
                     else f"rows {d['rows']} t {d['t']} n_out {d['n_out']}")
                  + f" | max_abs_err {err:.3e}")
    print(f"steady tick ({STREAM_SESSIONS} sessions x {STREAM_CHUNK} samples, "
          f"one core call of {STREAM_BLOCK_FRAMES} frames): p50 "
          f"{tick_p50:.3f} ms over {STREAM_STEADY_TICKS} ticks (ticks "
          f"{', '.join(f'{v:.3f}' for v in steady_ms)} ms); "
          f"{STREAM_SESSIONS * STREAM_CHUNK / tick_p50 * 1e3:.0f} samples/s "
          f"streamed; launches a tick {steady_tick}; device "
          f"launches a tick (kernels and copies, from the profile) "
          f"{'not measured' if tick_launches is None else tick_launches}",
          flush=True)

    # gradients through the runner vs offline value_and_grad (phase 7)
    leaves = {"front": {"taps": torch.tensor(
        np.asarray(params["front"]["taps"], np.float32), device="cuda",
        requires_grad=True)},
              "mask": [w.detach().clone().requires_grad_() for w in cnn]}
    flat = [leaves["front"]["taps"], *leaves["mask"]]
    reset_launch_counts()
    out_s = drive(stream_runner({**params, **leaves}), noisy,
                  STREAM_SPLITS)["out"]
    loss_s = tse.loss_fn({"out": out_s}, clean)
    torch.cuda.synchronize()
    fwd_counts = launch_counts()
    reset_launch_counts()
    grads_s = torch.autograd.grad(loss_s, flat)
    torch.cuda.synchronize()
    bwd_counts = launch_counts()
    if not (bwd_counts["shuffle_gemm_blocks"] and
            bwd_counts["shuffle_gemm_chain"]):
        raise AssertionError(f"the streamed backward launched {bwd_counts}")
    g_errs = {}
    for name, a, b in [("loss", loss_s.detach(), loss_h),
                       ("front.taps", grads_s[0], grads_h["front"]["taps"])] \
            + [(f"mask[{i}]", a, b) for i, (a, b) in
               enumerate(zip(grads_s[1:], grads_h["mask"]))]:
        g_errs[name] = hold(f"streamed gradient {name}", a, b, 1e-4, 1e-5)
    if not all(float(g.abs().max()) > 0 for g in grads_s):
        raise AssertionError("a streamed gradient leaf is all zeros")
    print(f"gradients through the runner vs offline value_and_grad (rtol "
          f"1e-4, atol 1e-5): max abs err "
          f"{ {k: float(f'{v:.3e}') for k, v in g_errs.items()} }; "
          f"launches forward {fwd_counts}, backward {bwd_counts}",
          flush=True)

    # calibrated streaming: Fig-9q under the phase-5 policy
    svc_cq = SignalService(backend="hopper", precision=policy,
                           block_frames=STREAM_BLOCK_FRAMES, device="cuda")
    svc_cq.register("fig9q", gq)
    n_int_core = svc_cq._graphs["fig9q"].struct.core_graph(
        STREAM_BLOCK_FRAMES, svc_cq.fuse, svc_cq.backend,
        svc_cq.device).lowering_report()["array_passes"]["int_routed"]
    if not n_int_core:
        raise AssertionError("the Fig-9q core int-routes no step")
    sess_q = svc_cq.open_stream("fig9q")
    xq = rng.standard_normal(LENGTH).astype(np.float32)
    q_acc, q_stream_counts, q_calls = {}, {}, 0
    for lo in range(0, LENGTH, STREAM_CHUNK):
        sess_q.feed(xq[lo:lo + STREAM_CHUNK])
        bsm.reset_launch_counts()
        calls = svc_cq.stream_step()
        made = bsm.launch_counts()
        if made != {"bitserial_matmul_planes": 0,
                    "bitserial_quant_matmul_hopper": n_int_core * calls}:
            raise AssertionError(f"calibrated tick: {calls} core calls "
                                 f"launched {made}")
        q_calls += calls
        for n, c in made.items():
            q_stream_counts[n] = q_stream_counts.get(n, 0) + c
        collect(q_acc, sess_q.read())
    collect(q_acc, sess_q.close())
    if not q_stream_counts["bitserial_quant_matmul_hopper"]:
        raise AssertionError("the calibrated stream launched no bitserial "
                             "kernel")
    q_out = joined(q_acc)
    with torch.no_grad():
        fref = fq.with_backend("reference")(torch.as_tensor(
            xq, device="cuda"))
    q_errs = {}
    for k in ("out", "mel_tap"):
        want = fref[k].cpu().numpy()
        got = q_out[k]
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"calibrated stream {k}: shape "
                                 f"{got.shape} vs {want.shape}")
        q_errs[k] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    if q_errs["out"] > Q_BUDGET:
        raise AssertionError(f"calibrated stream out: relative L2 error "
                             f"{q_errs['out']} beyond {Q_BUDGET}")
    print(f"calibrated Fig-9q stream: {n_int_core} int-routed steps a core "
          f"call, {q_calls} core calls, launches {q_stream_counts}; held-out "
          f"relative L2 error vs the float32 reference {q_errs} (out within "
          f"{Q_BUDGET})", flush=True)

    # durability: save mid-stream, restore in a fresh service, replay
    half = LENGTH // 2
    svc_a = stream_service()
    sa = [svc_a.open_stream("se") for _ in range(2)]
    heads = [{} for _ in sa]
    for lo in range(0, half, STREAM_CHUNK):
        for sess, w in zip(sa, waves):
            sess.feed(w[lo:lo + STREAM_CHUNK])
        svc_a.stream_step()
        for acc, sess in zip(heads, sa):
            collect(acc, sess.read())
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as ck:
        ck_step = svc_a.save_checkpoint(ck)
        svc_b = stream_service()
        if svc_b.restore_from_disk(ck) != ck_step:
            raise AssertionError("restore_from_disk restored another step")
    sb = [svc_b.session_by_sid(sess.sid) for sess in sa]
    tails = []
    for svc_, ss in ((svc_a, sa), (svc_b, sb)):
        tl = [{} for _ in ss]
        for lo in range(half, LENGTH, STREAM_CHUNK):
            for sess, w in zip(ss, waves):
                sess.feed(w[lo:lo + STREAM_CHUNK])
            svc_.stream_step()
            for acc, sess in zip(tl, ss):
                collect(acc, sess.read())
        for acc, sess in zip(tl, ss):
            collect(acc, sess.close())
        tails.append([joined(acc) for acc in tl])
    for i, (ta, tb) in enumerate(zip(*tails)):
        for k in ta:
            if not np.array_equal(ta[k], tb[k]):
                raise AssertionError(f"session {i} {k}: the restored "
                                     f"stream's tail differs")
        whole = joined({k: [*heads[i].get(k, []), tb[k]] for k in tb})
        for k, tol in out_tol.items():
            hold(f"session {i} {k}: head + restored tail vs the "
                 f"uninterrupted stream",
                 torch.as_tensor(whole[k]),
                 torch.as_tensor(joined(accs[i])[k]), *tol)
    print(f"durability: save_checkpoint at sample {half} (step {ck_step}), "
          f"restore_from_disk in a fresh service, feeds replayed: tails "
          f"equal bit for bit; head + tail == the uninterrupted stream, "
          f"nothing delivered twice", flush=True)

    # an IIR -> FIR sample chain (biquad_apply's carry on the card)
    gi = SignalGraph("iir_fir")
    gi.iir_biquad("q", "input", b=[0.2, 0.3, 0.2], a=[1.0, -0.5, 0.25])
    gi.fir("f", "q", taps=np.hanning(9) / np.hanning(9).sum())
    gi.outputs("f")
    xi = torch.as_tensor(rng.standard_normal(IIR_LENGTH).astype(np.float32),
                         device="cuda")
    ri = StreamingRunner(gi, backend="hopper", device="cuda")
    with torch.no_grad():
        got = torch.cat([ri.process(c)["f"]
                         for c in torch.tensor_split(xi, [300, 1100])])
        want = gi.compile(IIR_LENGTH, backend="hopper", device="cuda")(xi)["f"]
    iir_err = hold("streamed iir_biquad -> fir", got, want, 0.0, 1e-5)
    print(f"iir_biquad -> fir sample chain, {IIR_LENGTH} samples in 3 "
          f"chunks on the card vs offline: max abs err {iir_err:.3e} "
          f"(atol 1e-5)", flush=True)
    print(f"stream readings (smoke readings, not metrics) on {smi}: tick "
          f"p50 {tick_p50:.3f} ms, "
          f"{STREAM_SESSIONS * STREAM_CHUNK / tick_p50 * 1e3:.0f} samples/s "
          f"over {STREAM_SESSIONS} sessions, launches a tick "
          f"{sum(STREAM_TICK_LAUNCHES.values())}, core compiles (ms) "
          f"{compiles}", flush=True)

    # -- 10. SigSched: cross-graph waves, per-row params, EDF, streaming ---
    phase("10 sched")
    from repro_torch.serving import SigSched
    if not isinstance(svc.scheduler, SigSched):
        raise AssertionError("SignalService() built no SigSched")
    serve_tol = (("out", (0.0, 1e-5)), ("mel_tap", (1e-4, 1e-4)))
    worst_sched = {"out": 0.0, "mel_tap": 0.0}
    offline_cache = {}

    def offline_row(i, p):
        """Request i's offline compile at its true length with params
        ``p``, as numpy."""
        key = (i, id(p))
        if key not in offline_cache:
            with torch.no_grad():
                out = graph.compile(SERVE_LENGTHS[i], fuse=2,
                                    backend="hopper", device="cuda")(
                    torch.as_tensor(xs_serve[i][None], device="cuda"), p)
            offline_cache[key] = (p, {k: v[0].cpu().numpy()
                                      for k, v in out.items()})
        return offline_cache[key][1]

    def hold_served(what, got, i, p):
        want = offline_row(i, p)
        for k, (rtol, atol) in serve_tol:
            if got[k].shape != want[k].shape \
                    or not np.all(np.isfinite(got[k])):
                raise AssertionError(f"{what} {k}: shape {got[k].shape} vs "
                                     f"{want[k].shape} or non-finite")
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       atol=atol, err_msg=f"{what} {k}")
            worst_sched[k] = max(worst_sched[k],
                                 float(np.abs(got[k] - want[k]).max()))

    # (a) phase 4's serve window through the FIFO pick
    fifo = SignalService(batch_size=4, backend="hopper", device="cuda",
                         scheduler=False)
    fifo.register("speech_enhancement", graph, params={"mask": cnn})
    fifo.serve(requests(0))
    for k in range(SERVE_ROUNDS):
        for r in requests(100 * (k + 1)):
            fifo.submit(r)
    fifo_results = {}
    reset_launch_counts()
    while fifo.pending():
        fifo_results.update(fifo.step())
    torch.cuda.synchronize()
    fifo_counts = launch_counts()
    same = ("batches", "bucketed", "exact", "compiles")
    if {k: svc.stats[k] for k in same} != {k: fifo.stats[k] for k in same} \
            or fifo_counts != serve_counts or sorted(fifo_results) != rids:
        raise AssertionError(f"SigSched stats {svc.stats} / launches "
                             f"{serve_counts} vs FIFO {fifo.stats} / "
                             f"{fifo_counts}")
    a_err = max(float(np.abs(results[r][k] - fifo_results[r][k]).max())
                for r in rids for k in ("out", "mel_tap"))
    if not all(np.array_equal(results[r][k], fifo_results[r][k])
               for r in rids for k in ("out", "mel_tap")):
        raise AssertionError(f"SigSched's phase-4 results are not the FIFO "
                             f"pick's bit for bit (max abs err {a_err})")
    print(f"(a) on {smi}: phase 4's window: SigSched (default) and "
          f"scheduler=False "
          f"{ {k: svc.stats[k] for k in same} }, launches {fifo_counts}; "
          f"results equal bit for bit (max abs err {a_err:.1e}); both held "
          f"to the offline compile in phase 4", flush=True)

    # two registrations of Fig 9, serving 8 requests alternating a / b
    SCHED_BATCH = 8

    def sched_service(pa, pb, **kw):
        s_ = SignalService(batch_size=SCHED_BATCH, backend="hopper",
                           device="cuda", **kw)
        s_.register("a", graph, params=pa)
        s_.register("b", graph, params=pb)
        for g_, x_ in (("a", xs_serve[0]), ("b", xs_serve[1])):
            s_.serve([SignalRequest(rid=-1, graph=g_, samples=x_)])
        return s_

    def mixed(base, n=8):
        return [SignalRequest(rid=base + i, graph="ab"[i % 2],
                              samples=xs_serve[i % 8]) for i in range(n)]

    def counted(s_, reqs, record=False):
        """Serve ``reqs`` with the launch counts set to 0 just before and
        read just after: (results, launches, waves, cross-graph waves,
        recorded shuffle-GEMM calls or None)."""
        b0 = s_.stats["batches"]
        c0 = s_.scheduler.stats["cross_graph_batches"] \
            if s_.scheduler is not None else 0
        reset_launch_counts()
        got, calls_ = {}, None
        if record:
            calls_ = record_calls(torch, lambda: got.update(s_.serve(reqs)))
        else:
            got = s_.serve(reqs)
        torch.cuda.synchronize()
        made = launch_counts()
        c1 = s_.scheduler.stats["cross_graph_batches"] \
            if s_.scheduler is not None else 0
        return got, made, s_.stats["batches"] - b0, c1 - c0, calls_

    # (b) equal params (a copy, not the same objects)
    p_eq_a = {"mask": cnn}
    p_eq_b = {"mask": [w.clone() for w in cnn]}
    s_b = sched_service(p_eq_a, p_eq_b)
    res_b, made_b, waves_b, cross_b, _ = counted(s_b, mixed(1000))
    f_b = sched_service(p_eq_a, p_eq_b, scheduler=False)
    _, made_fb, waves_fb, _, _ = counted(f_b, mixed(1000))
    if waves_b != 1 or cross_b < 1 or made_b != FORWARD_LAUNCHES \
            or waves_fb != 2 or made_fb != {
                n: 2 * c for n, c in FORWARD_LAUNCHES.items()}:
        raise AssertionError(f"(b) SigSched {waves_b} waves, {cross_b} "
                             f"cross-graph, launches {made_b}; FIFO "
                             f"{waves_fb} waves, launches {made_fb}")
    for i in range(8):
        hold_served(f"(b) row {i}", res_b[1000 + i], i, p_eq_a)
    print(f"(b) on {smi}: two registrations, equal params, 8 requests "
          f"alternating: "
          f"SigSched {waves_b} wave ({cross_b} cross-graph), launches "
          f"{made_b}; scheduler=False {waves_fb} waves, launches "
          f"{made_fb}", flush=True)

    # (c) b's FIR taps and mask weights from seed 1: per-row params
    rng1 = np.random.default_rng(1)
    taps_b = (0.3 * rng1.standard_normal(9)).astype(np.float32)
    taps_b[0] += 1.0
    cnn_b = params_from_jax(
        [(rng1.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
         .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])],
        device="cuda")
    p_a = {"front": {"taps": torch.as_tensor(
        params["front"]["taps"], device="cuda")}, "mask": cnn}
    p_b = {"front": {"taps": torch.as_tensor(taps_b, device="cuda")},
           "mask": cnn_b}
    s_c = sched_service(p_a, p_b)
    res_c, made_c, waves_c, cross_c, calls_c = counted(s_c, mixed(2000),
                                                       record=True)
    blocks_w = sorted(tuple(a_["w"].shape) for n_, a_ in calls_c
                      if n_ == "shuffle_gemm_blocks")
    if waves_c != 1 or cross_c != 1 or s_c.stats["param_splits"] \
            or made_c != FORWARD_LAUNCHES \
            or blocks_w != [(8, 9, 1), (129, 24)]:
        raise AssertionError(f"(c) {waves_c} waves, {cross_c} cross-graph, "
                             f"param_splits {s_c.stats['param_splits']}, "
                             f"launches {made_c}, blocks operands "
                             f"{blocks_w}")
    for i in range(8):
        hold_served(f"(c) row {i}", res_c[2000 + i], i, (p_a, p_b)[i % 2])
    print(f"(c) on {smi}: different params (b: FIR taps and mask CNN "
          f"from seed 1): "
          f"{waves_c} wave, param_splits {s_c.stats['param_splits']}, "
          f"launches {made_c}, shuffle_gemm_blocks operands {blocks_w} "
          f"(the FIR call one operand a row); each row vs its own graph's "
          f"offline compile: max abs err out {worst_sched['out']:.3e} (atol "
          f"1e-5), mel_tap {worst_sched['mel_tap']:.3e} (rtol 1e-4, atol "
          f"1e-4)", flush=True)

    # (d) a row budget of 2 against the unsplit wave
    s_d = SignalService(batch_size=SCHED_BATCH, backend="hopper",
                        device="cuda", scheduler={"row_budget": 2})
    s_u = SignalService(batch_size=SCHED_BATCH, backend="hopper",
                        device="cuda")
    for s_ in (s_d, s_u):
        s_.register("a", graph, params={"mask": cnn})
    only_a = [SignalRequest(rid=3000 + i, graph="a", samples=x_)
              for i, x_ in enumerate(xs_serve)]
    res_d, made_d, waves_d, _, _ = counted(s_d, only_a)
    res_u, _, waves_u, _, _ = counted(s_u, [
        SignalRequest(rid=r.rid, graph="a", samples=r.samples)
        for r in only_a])
    d_err = max(float(np.abs(res_d[r][k] - res_u[r][k]).max())
                for r in res_u for k in ("out", "mel_tap"))
    if s_d.scheduler.stats["wave_splits"] < 1 or waves_u != 1 \
            or waves_d != 4 or sorted(res_d) != sorted(res_u) \
            or d_err != 0.0:
        raise AssertionError(f"(d) row_budget 2: {waves_d} chunks, "
                             f"{s_d.scheduler.stats}, max abs err {d_err} "
                             f"against the unsplit wave")
    print(f"(d) on {smi}: row_budget=2: {waves_d} chunks of the 8-row wave "
          f"(wave_splits {s_d.scheduler.stats['wave_splits']}), launches "
          f"{made_d}; equal bit for bit to the unsplit wave", flush=True)

    # (e) EDF and aging
    s_e = SignalService(batch_size=SCHED_BATCH, backend="hopper",
                        device="cuda")
    s_e.register("a", graph, params={"mask": cnn})
    short = rng.standard_normal(2000).astype(np.float32)   # bucket 2048
    s_e.serve([SignalRequest(rid=-1, graph="a", samples=xs_serve[0]),
               SignalRequest(rid=-2, graph="a", samples=short)])
    for i in range(4):
        s_e.submit(SignalRequest(rid=4000 + i, graph="a",
                                 samples=xs_serve[i]))
    s_e.submit(SignalRequest(rid=4099, graph="a", samples=short,
                             deadline=1.0))
    first_pick = list(s_e.step())
    bulk = sorted(s_e.step())
    d0, b0 = s_e.scheduler.stats["deferrals"], s_e.stats["batches"]
    s_e.submit(SignalRequest(rid=4100, graph="a", samples=xs_serve[0],
                             deadline=1e15))
    deferred = s_e.step()
    s_e.submit(SignalRequest(rid=4101, graph="a", samples=xs_serve[1],
                             deadline=1e15))
    fuller = sorted(s_e.step())
    if first_pick != [4099] or bulk != [4000, 4001, 4002, 4003] \
            or deferred != {} or s_e.scheduler.stats["deferrals"] != d0 + 1 \
            or fuller != [4100, 4101] or s_e.stats["batches"] != b0 + 1:
        raise AssertionError(f"(e) EDF pick {first_pick}, then {bulk}; "
                             f"slack-rich tick {deferred}, then {fuller}; "
                             f"{s_e.scheduler.stats}")
    s_g = SignalService(batch_size=1, backend="hopper", device="cuda")
    s_g.register("a", graph, params={"mask": cnn})
    s_g.serve([SignalRequest(rid=-1, graph="a", samples=xs_serve[0]),
               SignalRequest(rid=-2, graph="a", samples=short)])
    s_g.submit(SignalRequest(rid=5000, graph="a", samples=xs_serve[0]))
    aged, got_g = None, {}
    for tick_ in range(6 * s_g.scheduler.starvation_ticks + 1):
        s_g.submit(SignalRequest(rid=tick_, graph="a", samples=short,
                                 deadline=float(s_g.est_cycles)))
        got_g.update(s_g.step())
        if 5000 in got_g:
            aged = tick_
            break
    if aged is None or s_g.scheduler.stats["starvation_picks"] < 1:
        raise AssertionError(f"(e) the deadline-less request starved: "
                             f"{s_g.scheduler.stats}")
    print(f"(e) on {smi}: EDF: the deadline-1 newcomer ran first "
          f"({first_pick}), the "
          f"older bulk group next; a slack-rich request deferred one tick "
          f"and ran in a wave of 2; at batch_size 1 under a finite-deadline "
          f"request every tick the deadline-less one ran at tick {aged} "
          f"(limit {6 * s_g.scheduler.starvation_ticks}), starvation_picks "
          f"{s_g.scheduler.stats['starvation_picks']}", flush=True)

    # (f) streaming: 2 sessions of a and 2 of b, one core call a tick
    s_f = SignalService(backend="hopper", device="cuda",
                        block_frames=STREAM_BLOCK_FRAMES)
    s_f.register("a", graph, params=p_eq_a)
    s_f.register("b", graph, params=p_eq_b)
    f_sessions = [s_f.open_stream("ab"[i % 2]) for i in range(len(waves))]
    f_accs = [{} for _ in waves]
    f_counts = {n: 0 for n in STREAM_TICK_LAUNCHES}
    f_calls = 0
    for lo in range(0, LENGTH, STREAM_CHUNK):
        for sess, w in zip(f_sessions, waves):
            sess.feed(w[lo:lo + STREAM_CHUNK])
        reset_launch_counts()
        calls = s_f.stream_step()
        made = launch_counts()
        for acc, sess in zip(f_accs, f_sessions):
            collect(acc, sess.read())
        want = {n: c * calls for n, c in STREAM_TICK_LAUNCHES.items()}
        if calls > 1 or made != want:
            raise AssertionError(f"(f) tick at {lo}: {calls} core calls, "
                                 f"launches {made}")
        f_calls += calls
        for n, c in made.items():
            f_counts[n] += c
    for acc, sess in zip(f_accs, f_sessions):
        collect(acc, sess.close())
    torch.cuda.synchronize()
    f_cross = s_f.scheduler.stats["cross_graph_batches"]
    if f_calls < 1 or f_cross != f_calls:
        raise AssertionError(f"(f) {f_calls} core calls, {f_cross} "
                             f"cross-graph")
    f_worst = {"out": 0.0, "mel_tap": 0.0}
    with torch.no_grad():
        for acc, w in zip(f_accs, waves):
            got = {k: torch.as_tensor(v, device="cuda")
                   for k, v in joined(acc).items()}
            off = {k: v[0] for k, v in hopper(
                torch.as_tensor(w, device="cuda")[None], params).items()}
            for k, tol in out_tol.items():
                f_worst[k] = max(f_worst[k], hold(
                    f"(f) session {k} vs offline", got[k], off[k], *tol))
    print(f"(f) on {smi}: streaming, sessions a, b, a, b fed "
          f"{STREAM_CHUNK} samples a "
          f"tick: {f_calls} core calls, all cross-graph ({f_cross}), each "
          f"{STREAM_TICK_LAUNCHES}; launches {f_counts}; vs offline max abs "
          f"err {f_worst} (out atol 1e-5, mel_tap rtol 1e-5, atol 1e-4)",
          flush=True)

    # (g) smoke readings: a 16-request a / b window, the per-row FIR call.
    # 16 lengths, all distinct, in the 4096 bucket: a masked wave runs the
    # mask CNN once per distinct length, so windows whose waves held
    # different length mixes would time that, not the dispatch.
    xs_win = [rng.standard_normal(LENGTH - 100 * i).astype(np.float32)
              for i in range(16)]

    def window_reading(s_):
        """Serve 16 requests a / b; (step wall times in ms, requests/s)."""
        for i, x_ in enumerate(xs_win):
            s_.submit(SignalRequest(rid=6000 + i, graph="ab"[i % 2],
                                    samples=x_))
        steps_, done_ = [], {}
        t_w = time.perf_counter()
        while s_.pending():
            t1 = time.perf_counter()
            done_.update(s_.step())
            torch.cuda.synchronize()
            steps_.append((time.perf_counter() - t1) * 1e3)
        return steps_, len(done_) / (time.perf_counter() - t_w)
    win_svc = {label: sched_service(*pair, **kw) for label, pair, kw in (
        ("SigSched per-row params", (p_a, p_b), {}),
        ("SigSched equal params", (p_eq_a, p_eq_b), {}),
        ("scheduler=False", (p_a, p_b), {"scheduler": False}))}
    for s_w in win_svc.values():
        window_reading(s_w)                       # past first-call costs
    win = {label: ([], []) for label in win_svc}
    order = list(win_svc)
    for rnd in range(4):                          # in turns: ABC CBA ABC CBA
        for label in (order if rnd % 2 == 0 else order[::-1]):
            steps_, rate = window_reading(win_svc[label])
            win[label][0].extend(steps_)
            win[label][1].append(rate)
    print(f"(g) 16 requests a / b, batch {SCHED_BATCH}, each window 4 times "
          f"in turns (smoke readings, not metrics) on {smi}: "
          + "; ".join(f"{k} p50 step {float(np.median(v[0])):.3f} ms over "
                      f"{len(v[0])} steps, median {float(np.median(v[1])):.1f}"
                      f" requests/s" for k, v in win.items()), flush=True)
    # where a per-row wave's time goes: the profile of one 8-row wave with
    # per-row params and with equal params, and the mask CNN of one row
    # under torch.func.vmap against the plain call
    for label in ("SigSched per-row params", "SigSched equal params"):
        s_w = win_svc[label]

        def one_wave():
            s_w.serve(mixed(7000))
        profile_forward(torch, one_wave, wall_ms(torch, one_wave, iters=10),
                        label=f"{label} wave (8 rows)")
    from repro_torch.pipelines.speech_enhancement import cnn_mask
    spec_row = torch.polar(
        torch.as_tensor(rng.random((1, 27, 256)), dtype=torch.float32,
                        device="cuda"),
        torch.as_tensor(rng.random((1, 27, 256)), dtype=torch.float32,
                        device="cuda"))
    cnn_rows = [w[None] for w in cnn]
    with torch.no_grad():
        plain_cnn = wall_ms(torch, lambda: cnn_mask(cnn, spec_row))
        vmap_cnn = wall_ms(torch, lambda: torch.func.vmap(
            cnn_mask, in_dims=(0, 0))(cnn_rows, spec_row))
        v_err = float((torch.func.vmap(cnn_mask, in_dims=(0, 0))(
            cnn_rows, spec_row) - cnn_mask(cnn, spec_row)).abs().max())
    print(f"(g) mask CNN on one row of 27 frames (host and device, CUDA "
          f"events over 20 calls) on {smi}: plain {plain_cnn:.3f} ms, under "
          f"torch.func.vmap {vmap_cnn:.3f} ms; max abs difference "
          f"{v_err:.1e}", flush=True)
    fir_row = next(a_ for n_, a_ in calls_c if n_ == "shuffle_gemm_blocks"
                   and a_["w"].ndim == 3)
    shared_fir = dict(fir_row, w=fir_row["w"][0].contiguous())
    with torch.no_grad():
        per = shuffle_gemm_blocks(**fir_row)
        for i in range(fir_row["w"].shape[0]):
            if not torch.equal(per[i], shuffle_gemm_blocks(
                    **dict(fir_row, w=fir_row["w"][i].contiguous()))[i]):
                raise AssertionError(f"per-row FIR row {i} is not the "
                                     f"shared-w call on its operand")
    per_row_row = new_row(0, "the per-row FIR call of one 8-row "
                             "cross-graph wave (w (8, 9, 1)); shared_ms: "
                             "the same call on one shared w")
    print(f"(g) on {smi}:", flush=True)
    time_call("shuffle_gemm_blocks", fir_row, per_row_row, "per-row w   ")
    per_row_row["shared_ms"] = time_call("shuffle_gemm_blocks", shared_fir,
                                         None, "shared w    ")
    per_row_row["launches"] = made_c["shuffle_gemm_blocks"]
    print(f"per-row FIR call {per_row_row['ms'] * 1e3:.2f} us, shared "
          f"{per_row_row['shared_ms'] * 1e3:.2f} us, bound "
          f"{per_row_row['bound_ms'] * 1e3:.3f} us, plain "
          f"{per_row_row['plain_ms'] * 1e3:.2f} us; each row bit for bit "
          f"the shared-w call on its operand", flush=True)

    # -- 20. per-row: two tenants' params as one wave, one operand a row --
    phase("20 per-row")
    per_row = per_row_phase(torch, np, args.seed, smi, {
        "policy": policy, "graph": graph, "params": params})

    # -- 11. models: starcoder2-3b served, and co-served with Fig 9 --------
    phase("11 models")
    with torch.no_grad():
        sig_offline = [
            {k: v[0].cpu().numpy() for k, v in graph.compile(
                t, fuse=2, backend="hopper", device="cuda")(
                torch.as_tensor(xs_serve[i][None], device="cuda"),
                {"mask": cnn}).items()}
            for i, t in enumerate(SERVE_LENGTHS)]

    def fig9_service(batch_size=4):
        """Phase 4's service, warmed on one request (its bucket
        compiled)."""
        s_ = SignalService(batch_size=batch_size, backend="hopper",
                           device="cuda")
        s_.register("speech_enhancement", graph, params={"mask": cnn})
        s_.serve([SignalRequest(rid=-1, graph="speech_enhancement",
                                samples=xs_serve[0])])
        return s_

    lm_row = models_phase(torch, np, args.seed, smi, {
        "service": fig9_service, "signals": xs_serve,
        "offline": sig_offline, "tol": (("out", (0.0, 1e-5)),
                                        ("mel_tap", (1e-4, 1e-4))),
        "counts": launch_counts, "reset": reset_launch_counts,
        "per_wave": FORWARD_LAUNCHES})

    # -- 12. families: every other model family served ---------------------
    phase("12 families")
    t_fam = time.perf_counter()
    families = [serve_family(torch, np, spec, args.seed, smi)
                for spec in FAMILIES]
    print(f"phase 12: {len(families)} configs in "
          f"{time.perf_counter() - t_fam:.1f} s", flush=True)

    # -- 13. LM train: starcoder2-3b trained at full width ------------------
    phase("13 LM train")
    t_train = time.perf_counter()
    train_row = lm_train_phase(torch, np, args.seed, smi)
    print(f"phase 13: {time.perf_counter() - t_train:.1f} s", flush=True)

    # -- 14. mesh: Fig 9 served and streamed over a 4-shard mesh -----------
    phase("14 mesh")
    mesh_rows = mesh_phase(torch, np, args.seed, smi, {
        "graph": graph, "cnn": cnn, "signals": xs_serve,
        "compiled": hopper, "params": params})

    # -- 15. mesh models: gloo ranks sharing the card ---------------------
    phase("15 mesh models")
    mm = mesh_models_phase(torch, np, args.seed, smi)

    # -- 16. launchers: the serve CLI and the dry-run, whose cells trace
    # on the host while 17 trains the other families on the card ----------
    phase("16 launchers")

    def phase17():
        phase("17 family train")
        out = family_train_phase(torch, np, args.seed, smi)
        phase("16b dry-run records")
        return out
    ln = launchers_phase(torch, np, args.seed, smi, during=phase17)
    family_train = ln["during"]

    # -- 19. paper suite: the paper's signal workloads at their sizes -------
    phase("19 paper suite")
    suite = paper_suite_phase(torch, np, args.seed, smi)

    # -- 18. kernel list ----------------------------------------------------
    phase("18 kernels")
    launches = {**serve_counts, **{
                    "shuffle_gemm_grouped_blocks":
                    grouped_counts["shuffle_gemm_grouped_blocks"],
                    "shuffle_gemm_chain_hopper":
                    serve_counts["shuffle_gemm_chain"]},
                "bitserial_quant_matmul_hopper":
                q_counts["bitserial_quant_matmul_hopper"],
                "bitserial_matmul_planes":
                planes_counts["bitserial_matmul_planes"], **fft_counts,
                **fir_counts, **flash_counts, **probe_counts}
    for name, pk in per_kernel.items():
        bw_row = backward[name]
        rows[name] = {**pk, "library_ms": None,
                      "library": "no single PyTorch call computes "
                                 "gather\u2218GEMM"}
        if bw_row["calls"]:
            rows[name]["backward"] = {k: bw_row[k] for k in (
                "calls", "max_abs_err", "ms", "plain_ms", "bound_ms", "per")}
        if name == "shuffle_gemm_blocks":
            rows[name]["per_row"] = {k: per_row_row[k] for k in (
                "launches", "calls", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "shared_ms", "per")}
        rows[name]["stream"] = {
            "launches": stream_counts[name],
            "launches_per_tick": steady_tick[name],
            **{k: stream_rows[name][k] for k in (
                "calls", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "per")}}
    for name, mr in mesh_rows.items():
        rows[name]["mesh"] = mr
    rows["bitserial_quant_matmul_hopper"]["stream"] = {
        "launches": q_stream_counts["bitserial_quant_matmul_hopper"],
        "launches_per_core_call": n_int_core,
        "per": "the calibrated Fig-9q stream's ticks"}
    # the flash row is the serving path's (phase 11); phase 8's four
    # entry-point calls stay beside it
    entry = rows["flash_attention_hopper"]
    rows["flash_attention_hopper"] = {**lm_row, "entry_point": {
        "launches": flash_counts["flash_attention_hopper"],
        **{k: entry[k] for k in (
            "calls", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "library_ms", "library_kernel_ms", "per_call",
            "launches_per_call", "per", "library")}}}
    # phase 12's families: each config's serving shape beside the row;
    # phase 13's training: no launch a step, one a layer in the held-out
    # loss
    rows["flash_attention_hopper"]["families"] = families
    rows["flash_attention_hopper"]["train"] = train_row
    # phase 17: the other families trained, one launch a full-length
    # attention layer in each held-out loss
    rows["flash_attention_hopper"]["family_train"] = family_train
    # phase 15b's pipelined forward: one launch a stage a microbatch, in
    # each rank
    rows["flash_attention_hopper"]["mesh_models"] = {
        "launches": mm["flash_launches"] + mm["family_flash_launches"],
        "launches_per_rank": mm["flash_per_rank"],
        "pipeline_ms_per_rank": mm["pipeline_ms"],
        "families": {"launches": mm["family_flash_launches"],
                     "pre_pass_launches": mm["family_split_launches"],
                     **mm["families"]},
        "per": "spmd_pipeline over 4 gloo ranks on the card, one "
               "starcoder2-3b block a stage, 8 microbatches of 1 x 2048; "
               "families: phase 15e's sharded float32 prefills, one call "
               "a layer a rank on its 8 of qwen2-moe-a2.7b's 16 heads"}
    # phase 16a's serve CLI: one launch a layer a prefill, both runs
    rows["flash_attention_hopper"]["launchers"] = {
        "launches": ln["flash_launches"], "serve": ln["serve"],
        "per": "python -m repro_torch.launch.serve --arch gemma2-2b "
               "--no-reduced, 6 requests at batch 4, max_new 16, bf16 and "
               "--quant-bits 8"}
    launches["flash_attention_hopper"] = (lm_row["launches"]
                                          + mm["flash_launches"]
                                          + mm["family_flash_launches"]
                                          + ln["flash_launches"])
    launches["flash_split_kv_hopper"] += mm["family_split_launches"]
    rows["compiled_supported"]["mesh_models"] = {
        "launches": mm["probe_launches"],
        "per": "each phase-15 rank's first use of the library"}
    launches["compiled_supported"] += mm["probe_launches"]
    rows["shuffle_gemm_chain_hopper"] = rows.pop("shuffle_gemm_chain")
    rows["shuffle_gemm_chain_hopper"]["per"] += (
        " (the wrapper shuffle_gemm_chain); steps_ms: the same sub-steps "
        "one launch each on shuffle_gemm_grouped_blocks")
    # phase 20: the per-row calls beside the shared ones (its waves' main-
    # path launches added to the rows'); the blocks row keeps phase 10's
    for name, pr in per_row["per_row"].items():
        rows[name]["per_row"] = {k: pr[k] for k in (
            "calls", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "shared_ms", "library_ms", "library", "bodies", "per", "wave")
            if k in pr}
    for name, kname in (("shuffle_gemm_blocks", "shuffle_gemm_blocks"),
                        ("shuffle_gemm_grouped_blocks",
                         "shuffle_gemm_grouped_blocks"),
                        ("shuffle_gemm_chain_hopper", "shuffle_gemm_chain"),
                        ("bitserial_quant_matmul_hopper",
                         "bitserial_quant_matmul_hopper"),
                        ("bitserial_matmul_planes",
                         "bitserial_matmul_planes")):
        launches[name] += per_row["launches"][kname]
    # phase 19's paper suite: each kernel call of its fuse-2 forwards (and
    # the entry points at the paper's sizes) under paper_suite, its
    # main-path launches added to the row's
    for name, kname in (("shuffle_gemm_blocks", "shuffle_gemm_blocks"),
                        ("shuffle_gemm_grouped_blocks",
                         "shuffle_gemm_grouped_blocks"),
                        ("shuffle_gemm_chain_hopper", "shuffle_gemm_chain")):
        rows[name]["paper_suite"] = {
            "launches": suite["launches"][kname],
            "calls": suite["readings"][kname],
            "per": "the paper suite's forwards at fuse 0/1/2, front1024's "
                   "value_and_grad and AdamW steps, the served window and "
                   "the streamed FIR; calls: each call of a fuse-2 forward"}
        launches[name] += suite["launches"][kname]
    for name in ("fft_stages_hopper", "fir_conv_hopper"):
        rows[name]["paper_suite"] = {
            "launches": suite["entry_launches"][name],
            "calls": suite["entry"][name],
            "per": "the entry point at the paper's sizes, 4096 rows"}
        launches[name] += suite["entry_launches"][name]
    kernels = []
    for name in TPU_KERNELS:
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bound_bytes_ms"]
            >= r["bound_ops_ms"] else "operations",
            "library_ms": r["library_ms"], "per": r["per"],
            "library": r.get("library", "none"),
            **{k: r[k] for k in ("library_kernel_ms", "per_call",
                                 "backward", "single_stage", "int_mm_ms",
                                 "int_mm_kernel_ms", "int_mm", "steps_ms",
                                 "launches_per_call", "launch_floor_ms",
                                 "stream", "per_row", "mesh",
                                 "entry_point",
                                 "families", "train", "family_train",
                                 "mesh_models",
                                 "launchers", "paper_suite",
                                 "launches_per_prefill", "max_rel_l2")
               if k in r},
        })
    print(f"chip_smoke: {time.perf_counter() - t_main:.1f} s in all, the "
          f"kernel library's build included", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
