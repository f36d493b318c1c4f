#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--only 17,19]

Phases, in order; any failure raises and the script exits nonzero.
``--only`` runs phases 1 and 2, then only the named groups of phases
among 12-19 and 21 (``ALONE``; 14 runs 6b's training first, 21 the
training runs of 6b and 12d with the autotune table on and off), each even
when an earlier one failed, then phase 20 on what they measured, and prints
no summary:

1. Device: CUDA must be available; prints the card's name and power limit.
2. Build: compiles every kernel of the serving and training paths from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (one nvcc per
   source, all started together) and prints the build seconds, ptxas's
   registers, shared memory and spills for each kernel function, and the
   count of tensor-core instructions (HGMMA, HMMA) in each function's SASS
   (``cuobjdump --dump-sass``); fails if a bf16 flash sweep (forward, dq,
   dkv, each at head dim 64, 80, 112 and 128) has no HGMMA or spills.
3. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes in bf16 plus odd-length, sliding-window and fp32 cases
   (tolerances: bf16 outputs 2e-2, lse 1e-3, fp32 1e-5), and times each
   kernel (CUDA events, L2 flushed before each run, median of 30, the runs
   queued behind a device sleep so host time does not show) beside
   its plain version, its bound and, for flash, torch's
   scaled_dot_product_attention as the library yardstick. The flash
   forward (3a): bf16 (the tensor-core sweep) at the serving shape and the
   training shape, both timed, and at ragged S, G = 1, 2 and 4, windowed
   and non-causal cases, bitwise equal from run to run; fp32 (the CUDA-core
   sweep).
4. (4a) A full-width fp32 agreement check (kernel path against the plain
   torch path, logits of a prefill and three decode steps), then (4b) the
   main path: ``repro_torch.launch.serve`` at full width (smollm-135m,
   seeded random weights, bf16, attn_impl='pallas'), 32 requests of 512
   prompt tokens and 64 new tokens over 16 slots, each decode span of 8
   steps one replay of a captured CUDA graph (the first span of a page-table
   width runs eagerly as the warm-up, then is captured). The launch
   counters are set to 0 just before this run and read just after, and
   must equal the engine's formula (``PagedEngine.launches``): 30
   ``flash_fwd`` a prefill dispatch, 30 x 8 ``paged_decode`` a span, the
   spans counted as captures + replays, each capture recording one span's
   formula; the capture seconds print apart from the rate. A second run on
   the same engine only replays, and the same workload through the eager
   span (``capture=False``): greedy tokens bitwise equal to the first run's.
   (4b') temperature 1.0 through the captured span repeats bitwise from the
   same seed. (4c) One shorter run of the same engine under torch.profiler:
   wall time, device busy share, the host's seconds in prefill dispatches
   and spans, the kernels that take the device time, with
   ``paged_decode``'s two passes summed apart beside phase 3b's event time
   (3b: ``paged_decode`` at the decode shape in bf16, windowed, with most
   splits empty, and fp32, each bitwise equal from run to run); then one
   captured span replayed alone: its kernels a decode step and its device
   time a step beside the step's memory-bound floor. (4d) The naive
   dense-cache engine: its fp32 logits against the paged engine's over a
   prefill and three decode steps (1e-3), then 4b's prompts as one lockstep
   batch in bf16 (``flash_fwd`` launched 30 times, for its one prefill),
   its rate beside the paged engine's.
5. The training kernels against their plain PyTorch versions at the
   training main path's shapes, each timed beside its plain version, its
   bound and, where one PyTorch call computes the same function, that call:
   the flash backward (``flash_dq``, ``flash_dkv``; bf16 (tensor-core
   sweeps) and fp32 (CUDA-core sweeps) at the main shape and at ragged S,
   G = 1 and 4, non-causal and windowed cases, against autograd through the
   plain forward, and bitwise equal from run to run; the library yardstick
   is SDPA's backward alone, from one kept forward, three repeats),
   ``matmul_epilogue`` (fp32; every Newton-Schulz product and ragged
   cases in all four operand layouts, A k- or m-fast by B n- or k-fast,
   within 1e-5 of the largest output; the symmetric calls bitwise
   symmetric and bitwise equal to the full computation; X X^T on the w_in
   stack (one triangle, its bound counting the distinct entries) and
   B X + a X timed; library: ``torch.baddbmm``), the full Newton-Schulz
   through it, and ``nesterov`` over all 134,515,008 parameters (bitwise
   equal to its plain version).
6. Training: a full-width fp32 agreement check (loss and every gradient
   leaf with attn_impl pallas against xla, then one Muon step through the
   kernel against the plain fp32 Newton-Schulz), then the main path (6b),
   ``repro_torch.launch.train`` in-process with the command in ``TRAIN``
   (smollm-135m full width, MuLoCo, K=2, H=4, 3 rounds, one round per
   dispatch, 8 x 1024 tokens per worker step, every kernel switch on, inner
   lr 3e-3). Round 1 runs eagerly as the warm-up and is captured in a CUDA
   graph; rounds 2 and 3 are replays. The launch counters are set to 0 just
   before it and read just after, and must equal the port's formula
   (``TrainEngine.launches_per_round``) as captures x replays: the warm-up
   round's eager launches plus, per replay, what the capture recorded,
   which must be one round's formula. Losses must be finite and fall from
   the first round to the last; the capture time prints apart from round
   1's wall. Then (6c) one more replayed round under torch.profiler: device busy share, kernel count, the kernels that
   take the time, and the per-launch device time of the bf16 flash
   forward, the two flash backward sweeps and ``matmul_epilogue`` beside
   phase 3a's, 5a's and 5b's event times. Then (6d) the same command with
   ``capture=False`` (every round eager) and at ``--rounds-per-dispatch 3``
   (one dispatch) must equal 6b bitwise: losses, eval losses, comm_bytes
   and the final state.
8. Compressed pseudogradients: (8a) ``quantize`` (the full function and
   the wire path's codes-only launch, which writes no deq) and
   ``dequantize`` against their plain versions on the card, bitwise, at
   every (rows, cols) shape the two compressed runs below give them (Q1 and
   Q2 of every leaf), at 1, 2, 4 and 8 bits, plus the edges of quantize's
   regimes (``QUANT_EDGES``: the longest rows a warp and a block hold, the
   shortest long row, cols % 4 != 0, unaligned x, single rows, a constant
   row), the kernel's plan equal to the wrapper's mirror of it at each
   shape; the largest call of each layout timed in both forms beside its
   plain version, its read-once bound and its two-read floor
   (``torch.addcmul`` as the dequantizer's library yardstick); (8b) one
   full-width outer sync from one set of deltas with ``wire_impl='pallas'``
   (the kernels) against ``'jnp'`` (plain torch): Psi, the EF residuals and
   the new params bitwise, for global 2-bit and for a row-wise 4-bit
   streaming segment; (8c) the paper's compressed variant in-process, the
   command in ``TRAIN`` plus ``COMPRESSED`` (global 2-bit quantization with
   error feedback), 3 rounds; (8d) row-wise with two streaming partitions,
   ``TRAIN`` plus ``COMPRESSED`` plus ``ROWWISE``, 2 rounds. Both runs
   run captured, assert the launch counts against the formula (captures x
   replays), quantize and dequantize launched, finite losses and the
   per-round ``comm_bytes``; (8c) also that the losses fall, and profiles
   one more round (8c'): the device time of the quantize kernels against
   the round. (8e) Crash drills at ``--reduced`` widths (``DRILL``): the
   command with ``--checkpoint-every 1 --inject-kill-round 2`` in a
   subprocess (SIGKILL), then ``--resume auto`` in a new subprocess (a cold
   restart), whose metrics.csv less wall_s must equal an uninterrupted
   run's byte for byte; then a NaN
   injected at round 2 with the health sentinel on, rolled back into the
   captured round.
9. Elastic MuLoCo, in-process through the CLI entry point: the command in
   ``TRAIN`` plus ``ELASTIC[tag]``. (9a) ``--drop-schedule 1:1`` (worker 1
   out in round 1 of 3): ``active_workers`` [2, 1, 2]; round 0 bitwise
   6b's (the dense program); worker 1's inner state bit-identical across
   round 1 (``RoundSpy`` clones it around the dispatch; round 1 is the
   masked program's warm-up, so eager); two programs captured, dense and
   masked, each recording one round's launch formula; the same command with
   ``capture=False`` bitwise equal; one masked inner step on the card
   leaves worker 1's params and inner state unchanged; then one more round
   with worker 0 out replays the masked graph (captured under [1, 0]):
   worker 0's inner state frozen bitwise, worker 1's moved, and the round
   bitwise equal to the same round eager from a copy of the state.
   (9b) ``--sync-delay 1``: round 0's outer params equal the init bitwise,
   staleness 1, captured = eager bitwise. (9c) the compressed run of 8c
   plus the drop: worker 1's inner state and EF residual bit-identical
   across round 1, ``comm_bytes`` 67,257,680 in rounds 0 and 2 and half of
   it in round 1; the masked replay of 9a, with the EF residuals among the
   frozen fields. Each then profiles one more replayed dispatch (9a', 9b',
   9c'; masked where the run drops a worker): tokens/s, idle share.
10. The data-parallel baselines (10a Muon, 10b AdamW): ``dp_engine`` (K = 1,
   H = 1, Newton-Schulz through ``matmul_epilogue``) at full width, driven
   by ``run_rounds`` over 8 steps of 16 x 1024 tokens, one captured
   one-step round replayed; launches per step counted (``flash_fwd`` 60,
   ``flash_dq`` and ``flash_dkv`` 30, ``matmul_epilogue`` 105 for Muon);
   losses finite and falling; eager and R = 4 bitwise equal; a profiled
   dispatch of four steps. (10c) one full-width attention layer with
   attn_impl='xla' at S = 4096 (the blockwise online softmax, plain torch)
   against the fp32 ``flash_fwd``, batch 1. Then each path's tokens/s, idle
   share and peak memory beside the card's name and power limit.
12. The paper's Gemma3-style ladder at its rung paper-416m (``LADDER``:
   head dim 128, MHA, QK-norm, post-norms, untied head, vocab 128256):
   (12a) flash_fwd, flash_dq / flash_dkv and paged_decode at hd 128 against
   their plain versions as 3a, 5a and 3b check them (``FLASH_FWD_CASES``,
   ``FLASH_BWD_CASES``: ragged S, causal, windowed, non-causal, G = 1, 2
   and 8, bf16 and fp32, bitwise from run to run), timed at the training
   shape q [32, 2048, 1, 128] and the prefill shape [128, 512, 1, 128]
   beside the bound, the plain version and SDPA; paged_decode at 8 kv heads,
   G = 1; (12b) matmul_epilogue at the ladder's Newton-Schulz shapes, whose
   widths are not multiples of the 96-wide tile, in all four layouts, and
   nesterov over the ladder's 416,862,208 parameters; (12c) the full-width
   fp32 agreements of 4a and 6a on paper-416m; (12d) the training main path
   ``TRAIN_LADDER`` (the command of 6b at paper-416m, S = 2048, 4 sequences
   a worker step), its launches against the formula, losses finite and
   falling, a profiled replayed round, and the same command eager, bitwise
   equal; (12e) the serving main path of 4b on paper-416m, captured, and
   (12e') its profile as 4c's. Then the ladder's rates, idle share and peak
   memory beside the card's name and power limit.
13. nemotron-4-15b (``NEMOTRON``: 32 layers, d 6144, 48:8 heads so G = 6,
   hd 128, relu2, vocab 256,000, untied): (13a) flash_fwd
   (``NEMOTRON_FWD_CASES``) and paged_decode at G = 6 against their plain
   versions, bitwise from run to run, timed at the model's serving shapes;
   (13b) 4a's fp32 agreement at full width, depth cut to 2 layers; (13c)
   4b's serving main path at full width, depth cut to 8 layers
   (``NEMOTRON_SERVE_DEPTH``), with bf16 weights through the captured span
   (launches, peak memory, capture seconds, eager = captured bitwise) and
   (13c') its profile, a decode step beside its memory-bound floor.
14. The Muon variants on the training main path (slice 6b, Part A): (14a)
   ``--inner muon_bp --ns-period 1`` (``TRAIN`` otherwise) captured, every
   round's losses and the final state bitwise equal to 6b's ``--inner
   muon`` run; (14b) ``--inner muon_bp --ns-period 4`` and ``--inner
   normuon`` (``VARIANTS``), 3 rounds captured: launches against the formula
   (``matmul_epilogue`` 105 a worker step: MuonBP's off-period steps select
   the momentum over the orthogonalized update, so Newton-Schulz runs every
   step), finite losses (NorMuon's eval falls), the optimizers' own counters;
   each rate beside 6b's.
15. The paper's pseudogradient measurements (Parts B and C) on paper-150m at
   full width (``PROBE``): a DP checkpoint warmed up with ``dp_init`` /
   ``dp_step`` (32 steps of 16 x 1024), then K workers at 16 / K sequences
   and one at 16 branch from it for H = 8 ``inner_step``s (benchmarks/
   common.py's method); for Muon (15a) and AdamW (15b) at K = 2, 4, 8: Fig.
   2's per-matrix cosines of Psi_K against Psi_1 (mean, std, min), Fig. 3's
   relative top-25% interference gap of w_in, Fig. 5's step-norm coefficient
   of variation, and for Muon Prop. 4.2's relative error at H = 1 (within
   1e-4); every branch's launches against its formula; at K = 2 the card's
   cosines and gaps against float64 on the CPU (1e-5). (15c) the
   scaling-law fits of fixed synthetic points on the host (scipy), equal to
   the CPU's (``FIT_EXPECT``).
16. deepseek-moe-16b (``MOE``: 28 layers, d 2048, 16:16 heads of hd 128, 64
   routed experts top-6 of d_ff 1408 plus 2 shared, vocab 102,400, untied):
   (16a) paged_decode at its 16 kv heads, and 4a's fp32 agreement at depth
   2; (16b) 4b's serving main path at full width, depth cut to 8 layers
   (``MOE_SERVE_DEPTH``), with bf16 weights through the captured span, and
   (16b') its profile, a decode step
   beside its memory-bound floor; (16c) matmul_epilogue at the expert
   banks' and the router's Newton-Schulz shapes in all four layouts, timed
   at the bank beside its plain version, bound and torch.baddbmm; (16c') one
   captured MuLoCo round at full width, depth cut (``MOE_TRAIN``): launches,
   the aux term in the loss, eager bitwise, matmul_epilogue's share of the
   round, peak memory.
17. The SSM and hybrid families (slice 7a): mamba2-370m (``MAMBA``: 48
   Mamba2 layers, d 1024, no attention) and zamba2-2.7b (``ZAMBA``: 54
   Mamba2 layers of d 2560 in 9 superblocks, one shared attention block of
   32:32 heads at hd 80, window 4096): (17a) ptxas of the flash sweeps at hd
   64, 80, 112 and 128, then flash_fwd and flash_dq / flash_dkv at hd 80 against
   their plain versions as 3a and 5a check them (``FLASH_FWD_CASES[80]``,
   ``FLASH_BWD_CASES[80]``, bitwise from run to run), timed at zamba2's
   training shape q [32, 8192, 1, 80] with the window beside the bound, the
   plain version and SDPA (the window as a boolean mask); (17b)
   matmul_epilogue at the SSM Newton-Schulz shapes (``SSM_NS_SHAPES``) in
   all four layouts, each in_proj's X X^T and B X + a X timed; (17c) 6a's
   fp32 agreement on mamba2-370m at depth 2 and zamba2-2.7b at one
   superblock and S = 8192, and decode_step stepped over 256 tokens against
   the forward's logits (1e-3); (17d) mamba2-370m's training command
   ``TRAIN_MAMBA`` at full width and depth, 2 rounds, captured: launches against the
   formula (no flash; matmul_epilogue 30 a worker step), losses falling,
   (17d') a profiled replayed round with the SSD scan's share; (17e)
   zamba2-2.7b at one superblock (``ZAMBA_TRAIN``), captured, the same
   checks; (17f) both served through the naive engine, 4b's 32 requests
   and 64 new tokens with 128-token prompts (``SSM_SERVE``) as one lockstep
   batch (zamba2 in bf16 weights): tok/s, a decode step's device time
   beside its floor, peak memory, a shorter repeat bitwise.
18. The audio and VLM families (slice 8): whisper-large-v3 (``WHISPER``: 32
   encoder and 32 decoder layers of d 1280, 20:20 heads of 64, gelu, 1500
   audio frames, 1,602,629,120 parameters) and llama-3.2-vision-90b
   (``VLM``: 100 layers of d 8192 in 20 superblocks of 1 gated cross + 4
   self layers, 64:8 heads of 128, so G = 8): (18a) ptxas of the flash
   sweeps at hd 64, 80, 112 and 128, then flash_fwd and flash_dq / flash_dkv at
   the slice's new shapes against their plain versions as 3a and 5a check
   them (``WHISPER_FWD_CASES``, ``WHISPER_BWD_CASES``: whisper's encoder, q
   [80, 1500, 1, 64], non-causal, a ragged 28-key tail; ``VLM_FWD_CASES``,
   ``VLM_BWD_CASES``: the VLM's self layers, q [8, 2048, 8, 128], causal;
   bf16 and fp32, bitwise from run to run), the bf16 ones timed beside the
   bound, the plain version and SDPA; (18b) matmul_epilogue at whisper's
   Newton-Schulz shapes ([32, 1280, 5120], [32, 1280, 1280]) in all four
   layouts, X X^T on w_in and B X + a X timed beside torch.baddbmm, and
   nesterov over whisper's parameter count; (18c) whisper's fp32 agreement
   at full width and depth, kernels against plain torch: forward logits,
   then fill_context and three decode steps against the forward (1e-3);
   (18d) one MuLoCo run of whisper through TrainEngine at full width and
   depth (``WHISPER_TRAIN``: K 2, H 2, 4 x 448 tokens and their 4 x 1500
   frames a worker step, the batch's "context" leaf), captured: launches
   against the formula, losses falling, (18d') a profiled replayed round
   with the shares of matmul_epilogue, the flash kernels and the rest,
   (18d'') eager bitwise; (18e) whisper served through
   ``launch.serve.serve(engine='naive')`` at full depth (``WHISPER_SERVE``),
   its encoder's 32 non-causal flash_fwd launches counted, two runs bitwise,
   another context other tokens; (18f) the VLM at full width with one
   superblock (``VLM_DEPTH``, bf16 weights, gates opened): served through
   the naive engine over 1600 image tokens (``VLM_SERVE``), then one
   2048-token forward and backward through the G = 8 flash kernels against
   the plain path (loss, the gradients' relative error over the tree and
   on each of the self layers' attention leaves).
19. The last two configurations (slice 9): kimi-k2-1t-a32b (``KIMI``: 61
   MoE layers of d 7168, 64:8 heads of 112, 384 routed experts of d_ff 2048
   top-8 plus one shared, vocab 163,840) and mistral-large-123b
   (``MISTRAL``: 88 dense layers of d 12288, 96:8 heads of 128, so G = 12):
   (19a) ptxas of the flash sweeps at hd 64, 80, 112 and 128, then
   flash_fwd, flash_dq / flash_dkv and paged_decode at hd 112 against their
   plain versions as 3a, 5a and 3b check them (``FLASH_FWD_CASES[112]``,
   ``FLASH_BWD_CASES[112]``: kimi-k2's prefill q [128, 512, 8, 112] and
   training q [32, 2048, 8, 112], ragged, windowed, non-causal, bf16 and
   fp32; paged q [16, 8, 8, 112] over a [1024, 16, 8, 112] pool; bitwise
   from run to run), timed beside the bound, the plain version and SDPA;
   (19b) the same at G = 12 and hd 128 (``MISTRAL_FWD_CASES``,
   ``MISTRAL_BWD_CASES``, paged q [16, 8, 12, 128]), G = 16 once, and the
   fp32 backward at the training shape against float64 (``BWD_FP64_CASES``,
   1e-5 of the largest entry); (19c)
   kimi-k2: 4a's fp32 agreement at depth 1 with 64 experts, 4b's serving
   main path at full width with one layer and all 384 experts, bf16
   weights, through the captured span (launches, replays and the eager
   span bitwise), its profile (a decode step beside its floor), and one 4 x
   2048-token forward and backward at depth 1 with 64 experts against the
   plain path (the loss, the tree's relative error, each attention leaf
   under ``VLM_ATTN_TOL``); (19d) mistral-large: the same at depth 2
   (agreement), 8 (serving) and 1 (forward and backward). Every cut is in
   ``KIMI_CUT`` and ``MISTRAL_CUT`` (PERF.md section 4).
20. The roofline (``repro_torch.roofline``): each captured training run
   above (6b, 12d, 16c', 17d, 17e, 18d: the mean wall of its rounds 2 and
   up) and each replayed decode step (4c, 12e', 13c', 16b', 19c', 19d': its
   device time) read against one H100's peaks, from the results those
   phases return (no new run; under ``--only``, those of the groups that
   ran): ``analytic_terms`` at the run's own K, H, B, S and depth, or the
   engine's slots, mean cache length and depth; the model FLOPs, the
   analytic FLOPs and bytes, the compute, memory and wire terms, the
   dominant one, the model FLOPs utilisation and the roofline share
   (max(compute, memory) over the measured seconds), a round's compute
   term with Newton-Schulz at the fp32 peak beside it, a decode step's
   memory term beside its floor; one record each under
   ``build/chip_smoke_roofline/`` and the roofline table of
   ``repro_torch.roofline.report``. Fails if a share is above 1.05.
21. Autotune (``repro_torch.kernels.autotune``): (21a) every build variant of
   ``matmul_epilogue`` (``matmul.TILE_CANDIDATES``: tiles of 64, 96 and 128,
   K steps of 8, 16 and 32, register tiles of 4, 6 and 8) and ``quantize``
   (``quantize.TILE_CANDIDATES``: threads, long-row unroll and split) built
   from the one source, in parallel, each one's ptxas registers and spills
   printed; (21b) every candidate bitwise equal to the default, Newton-Schulz
   at ``AUTOTUNE_NS_CHECK`` and quantize (full, codes-only) and dequantize at
   ``AUTOTUNE_QUANT_CHECK`` (each candidate's plan its library's), the
   defaults against their plain versions as 5b and 8a hold them; (21c) every
   ``cuda`` entry of the committed table re-verified bitwise at its key's
   shape, and the summary rows' timed calls with the table's variant beside
   the default's; (21d) the ``h100`` sweep suite into
   ``build/chip_smoke_autotune/`` (not the committed table): default and best
   ms, bound and ``torch.baddbmm`` per shape; (21e) 6b's and 12d's training
   commands with ``--autotune off`` against their runs with it on: losses
   and every state leaf bitwise equal, launches counted per variant, walls
   printed.
22. The mesh (slice 12; ``--only 22`` runs it alone after phases 1 and 2):
   two ranks share the card (gloo: NCCL refuses two ranks on one device;
   each rank a process of this script, ``--mesh-child``). (22a) Every kernel
   was built in phase 2, in this process, before any rank starts. (22b) Each
   of the eight kernels at the main path's shapes (``mesh_kernel_cases``)
   through ``kernels/partition.py`` on the (pod=2) mesh and on the (data=2)
   mesh: on replicated DTensors each rank runs the kernel on its block,
   which must equal that block of the one-process call, bitwise (and every
   Newton-Schulz stack of smollm's Muon leaves split over 'data'); on the
   (data=2) mesh local and whole times beside each other (the ranks take
   turns; the world runs beside the training runs below, so the times are
   contended). (22c) ``MESH_TRAIN`` with ``--checkpoint-every 1``
   under torchrun (two ranks, one worker each, 2-bit EF at full width, one
   round a dispatch) against the same command in one process (eager, which
   6d holds to the captured round): the per-round train and eval losses,
   comm_bytes, active_workers and staleness and every outer-param leaf
   bitwise, and ``ckpt_1.npz`` / ``ckpt_2.npz`` byte for byte; tokens/s, the
   sync's wall, the bytes gathered (wire packets, θ from its ZeRO layout).
   In the same torchrun launch, each against one process the same way:
   (22e) streaming, ``--streaming 2 --rowwise`` on the 2-bit EF wire; (22f)
   ``--drop-schedule 1:1 --sync-delay 1`` (worker 1 out in the second of two
   rounds, Psi a round late); (22g) the crash drill: 22c's command with
   ``--inject-kill-round 1`` in two rank processes beside the launch's 22c
   (each must die by SIGKILL; this process runs the one-process commands
   meanwhile), then ``--resume auto`` in a new world of two rank processes
   (the launch goes on alone once these are done), whose
   metrics.csv (but wall_s) and outer leaves must be 22c's mesh run's; (22h)
   Muon DP through ``dp_engine(..., mesh=)`` on the (data=2) mesh,
   ``MESH_DP`` steps in fp32 at a constant LR, within ``MESH_DP_TOL``, and
   the same run with a planted fault (each rank on its own half batch's
   gradients) outside it. Every rank of every run launches every training
   kernel. (22i) Tensor parallelism over 'model' (slice 14,
   ``core/collectives.py``): paper-416m on ``--mesh 1x2``, each rank half of
   every block matrix; ``MESH_TP_FP32`` (fp32, depth 2) within
   ``MESH_TP_TOL`` of one process and the same with a planted fault (each
   rank's QK-norm gradients of its own heads only) outside it, its round
   walls and each rank's peak memory; every rank launching the flash
   kernels, matmul_epilogue and nesterov; with ``--only 22`` also, once the
   rest of the mesh's runs have ended, the same config on 1x2 with each
   worker whole on both ranks (walls and peak memory) and
   ``MESH_TP_TRAIN`` (bf16, full depth, 2 rounds, one sequence a worker
   step): finite, falling train losses, round walls, the bytes each rank
   sums over 'model' and its peak memory. (22j) ``MESH_NS_TRAIN``, one
   round of H = 1 on ``--mesh 2x1``, Newton-Schulz's stacks split over
   'data', bitwise the same round with the engine's routing at
   ``ns_axes=()`` (the trainer's own routing on gloo), each rank's kernels
   on half the stack rows. Two torchrun launches share the card with 22g's
   worlds and this process's one-process runs (``MESH_LAUNCHES``), so every
   wall but those of ``--only 22``'s measurements is contended. (22d) ``MESH_SERVE`` through a
   PagedEngine on the (data=2) mesh (in 22b's processes) against one
   process: greedy tokens exact, launches equal to the engine's formula.
23. Summary: one ``{"kernels": [...]}`` line (each row of the eight with its
   paper-416m timing and launches under ``"paper-416m"``, flash_fwd's and
   paged_decode's at G = 6 under ``"nemotron-4-15b"``, the launches of
   slice 6b's paths under ``"muon_bp"``, ``"normuon"``, ``"paper-150m
   pseudogradients"`` and ``"deepseek-moe-16b"``, with matmul_epilogue's
   expert-bank timing, slice 7a's launches and timings under
   ``"mamba2-370m"`` and ``"zamba2-2.7b"``: the flash rows at hd 80,
   matmul_epilogue at each in_proj; the serving paths launch none, slice
   8's under ``"whisper-large-v3"`` and ``"llama-3.2-vision-90b"``: the
   flash rows at the encoder's non-causal and the VLM's G = 8 shapes,
   matmul_epilogue at whisper's w_in, nesterov over whisper's parameters,
   and slice 9's under ``"kimi-k2-1t-a32b"`` and ``"mistral-large-123b"``:
   the flash and paged rows at hd 112 and at G = 12, their serving and
   forward-and-backward launches; each row's ``"variants"``: the build
   variants its main path launched, by key, and matmul_epilogue's and
   quantize's ``"tuned"``: 21c's timing of the table's variant, and
   ``"across_ranks"``: 22b's verdict, block and times on each mesh, the
   launches of 22c's and 22d's rank 0 and of every rank in 22c and 22e-22j),
   the script's seconds, then the last
   line ``{"ok": true, "device": {...}}``.
   A line ``-- 12a: N s (T s in all)`` follows each phase: its seconds
   and the script's.

Cut for time (the script's limit is 1200 s; slice 8 added ~150 s, slice 9
~50 s with its builds, and hosts differ by ~20%): the earlier slices'
repeats 6c's dispatch of three, 14b' and 17d''/17e'' (the variants',
mamba2's and zamba2's rounds again eager, bitwise, which earlier full runs
held), 17f's repeat shortened to 8 + 8 tokens and its prompts to 128
tokens, the serving depth of 13c and 16b cut to 8 layers, 17d and 17e at
2 rounds (the warm-up and capture, one replay) of H = 2, and 18d at 2
rounds of its 3-round schedule; with slice 14's 22i and 22j, 17f's served
tokens (32 + 32 a request, 128 + 64 before) and 22j's round (H = 1, 2
before), and phase 22's runs spread over two concurrent launches, with
22i's whole-worker twin and bf16 run at full depth left to ``--only 22``;
no kernel check and no bitwise check was cut (PERF.md section 4). The profiles read the
profiler's raw events (:func:`device_times`).

Matmuls in fp32 run in full fp32 (TF32 off for matmul and cuDNN); bf16
GEMMs keep PyTorch's default reduced-precision reduction setting, printed
below. Needs one card and no network.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# peak rates of one H100 SXM (NVIDIA data sheet, dense, 700 W; fp32 the
# CUDA-core rate) and the kernels' bound come from the roofline package, and
# a config's parameter count from its init on the meta device
from repro_torch.roofline.analysis import (  # noqa: E402
    HBM_BW,
    PEAK_FLOPS,
    PEAK_FP32_FLOPS,
    bound,
)
from repro_torch.roofline.terms import param_count  # noqa: E402

MAIN = dict(batch=32, prompt_len=512, max_new=64, slots=16, page_size=16, max_pages=1024,
            decode_steps_per_dispatch=8)
# --lr 3e-3, not the default 2e-2: at the full 49152-token vocabulary the default
# lr's AdamW step moves every entry of the tied embedding by about lr, half its
# init scale, and the eval loss rises at the schedule's peak (round 2); the
# reference does the same at this lr, so the loss-falls check would test the
# hyperparameter, not the port
TRAIN = ["--arch", "smollm-135m", "--inner", "muon", "--outer", "nesterov", "--workers", "2",
         "--sync-interval", "4", "--rounds", "3", "--seq-len", "1024", "--batch-per-worker", "8",
         "--attn-impl", "pallas", "--ns-impl", "pallas", "--outer-kernel", "--seed", "0",
         "--lr", "3e-3", "--rounds-per-dispatch", "1",
         "--out", str(ROOT / "build" / "chip_smoke_train"), "--verbose"]
# slice 6a (12d): the training main path on the paper's own model, paper-416m
# (the rung the reference's launch/dryrun.py names), at the paper's sequence
# length 2048; B x S a worker step stays 8192 tokens and a round 65,536
LADDER = "paper-416m"


def replace_flags(argv: list, **values) -> list:
    """``argv`` with the value after each ``--name`` replaced (``_`` in a
    keyword stands for ``-``)."""
    out = list(argv)
    for name, value in values.items():
        out[out.index("--" + name.replace("_", "-")) + 1] = str(value)
    return out


TRAIN_LADDER = replace_flags(TRAIN, arch=LADDER, seq_len=2048, batch_per_worker=4,
                             out=ROOT / "build" / "chip_smoke_train_ladder")
# the crash drill (8e): the training command at --reduced widths (a
# full-width K = 2 state is ~3.4 GB a checkpoint), a checkpoint every round
DRILL = ["--arch", "smollm-135m", "--reduced", "--inner", "muon", "--outer", "nesterov",
         "--workers", "2", "--sync-interval", "4", "--rounds", "4", "--seq-len", "1024",
         "--batch-per-worker", "8", "--attn-impl", "pallas", "--ns-impl", "pallas",
         "--outer-kernel", "--seed", "0", "--lr", "3e-3", "--checkpoint-every", "1"]
# the paper's compressed variant (README): 2-bit global quantization, error feedback
COMPRESSED = ["--compression", "quant", "--bits", "2", "--error-feedback"]
ROWWISE = ["--rowwise", "--streaming", "2"]
# the reference's measured wire bytes per worker per round at full width, K = 2
COMM_BYTES = {"a": 67_257_680, "b": 70_441_072}
# elastic MuLoCo (9a-9c): the training command plus these flags; worker 1
# drops in round 1 of 3
ELASTIC = {"i": ["--drop-schedule", "1:1"], "ii": ["--sync-delay", "1"],
           "iii": COMPRESSED + ["--drop-schedule", "1:1"]}
# the data-parallel baselines (10a, 10b): one worker, 16 x 1024 tokens a
# step (= K * B of the training command), 8 steps (12 until the mesh's
# slice 13 needed the time)
DP = dict(steps=8, batch=16, seq_len=1024, lr=3e-3)


_T0 = time.perf_counter()
_LAP = [_T0]


def lap(label: str) -> None:
    """``-- label: N s (T s in all)``: the seconds since the last lap and
    since the script started."""
    now = time.perf_counter()
    print(f"-- {label}: {now - _LAP[0]:.1f} s ({now - _T0:.1f} s in all)", flush=True)
    _LAP[0] = now


def time_ms(torch, fn, runs: int = 30) -> float:
    """Median device time of ``fn`` in ms, the 50 MB L2 flushed before each
    run. The runs are queued behind a ~0.1 s device sleep, so the host has
    queued them (unless ``fn`` waits for the card) before the first starts:
    an event pair then brackets the card's work, not the host's, which
    matters for calls of ~0.1 ms on a slow host."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = []
    torch.cuda._sleep(200_000_000)  # clock cycles: ~0.1 s at the H100's 1.98 GHz
    for _ in range(runs):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def check(name: str, err: float, tol: float) -> float:
    print(f"  {name}: max abs err {err:.3e} (tol {tol:g})")
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err


def kernel_name(mangled: str) -> str:
    """The kernel's own name inside a mangled symbol (the last length-prefixed
    name that ends in ``kernel``) with its template arguments where it is a
    template: the element type (``float``, ``bf16``), if it has one, and
    any integer or bool arguments (``<float,1,0,1>``, ``<1,12,1>``); else
    the symbol."""
    found, i = None, 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        start = i + m.end()
        i = start + int(m.group())
        if mangled[start:i].endswith("kernel"):
            found = mangled[start:i]
            t = re.match(r"I(13__nv_bfloat16|f)?((?:L[bi]\d+E)*)", mangled[i:])
            if t and (t.group(1) or t.group(2)):
                args = ([{"f": "float"}.get(t.group(1), "bf16")] if t.group(1) else []) + \
                    re.findall(r"L[bi](\d+)E", t.group(2))
                found += "<" + ",".join(args) + ">"
    return found or mangled


def ptxas_report(log: str) -> dict:
    """{kernel: "N registers, M bytes smem, spills"} from ``-Xptxas -v``."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            fn = kernel_name(m.group(1))
        elif fn and ("spill" in line or "registers" in line):
            out[fn] = (out.get(fn, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


def sass_counts(lib: str) -> dict:
    """{kernel: {"HGMMA": n, "HMMA": m}} in the library's SASS."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", lib], check=True, capture_output=True,
                          text=True, timeout=120).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            out[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn:
            for op in out[fn]:
                out[fn][op] += bool(re.search(rf"\b{op}\.", line))
    return out


def phase_build(_build):
    print("[2] build")
    report = _build.build(verbose=True)
    sass, ptxas = {}, {}
    for name, r in report.items():
        print(f"  {name}: built in {r['seconds']:.2f} s -> {Path(r['path']).name}")
        for fn, line in ptxas_report(r["log"]).items():
            print(f"    {fn}: {line}")
            ptxas[fn] = line
        for fn, ops in sass_counts(r["path"]).items():
            print(f"    {fn}: tensor-core instructions in SASS {ops}")
            sass[fn] = ops
    for fn in (f"flash_{k}_wgmma_kernel<{hd}>" for k in ("fwd", "dq", "dkv")
               for hd in HEAD_DIMS):
        if not sass.get(fn, {}).get("HGMMA"):
            raise AssertionError(f"{fn}: no HGMMA in its SASS (or no such kernel)")
        if not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ptxas.get(fn, "")):
            raise AssertionError(f"{fn}: spills (or no ptxas report): {ptxas.get(fn)}")
    (bq, bkv, rows, keys, bq128, bkv128, bq80, bkv80, bq112, bkv112, smem, smem128, smem80,
     smem112) = _build.kernel_tiles("flash_fwd")
    print(f"  flash_fwd: bf16 sweep tiles of {rows} packed q rows x {keys} keys, one warpgroup "
          f"a block, dynamic shared memory {smem} B (hd 64), {smem80} B (hd 80), {smem112} B (hd "
          f"112) and {smem128} B (hd 128); fp32 sweep {bq} positions x {bkv} keys (hd 64), {bq80} "
          f"x {bkv80} (hd 80), {bq112} x {bkv112} (hd 112), {bq128} x {bkv128} (hd 128), half the "
          "positions past G = 8")
    rows, keys, dq_smem, dkv_smem, dq128, dkv128, dq80, dkv80, dq112, dkv112 = \
        _build.kernel_tiles("flash_bwd")
    print(f"  flash_bwd bf16 sweeps: tiles of {rows} packed q rows x {keys} keys; hd 64: one "
          f"warpgroup a block, dynamic shared memory {dq_smem} B (dq) and {dkv_smem} B (dkv); "
          f"hd 128: {dq128} B (dq, one warpgroup), {dkv128} B (dkv, two warpgroups); hd 80: "
          f"{dq80} B (dq), {dkv80} B (dkv, two warpgroups); hd 112: {dq112} B (dq), {dkv112} B "
          "(dkv, two warpgroups)")
    split, threads, split128, split112 = _build.kernel_tiles("paged_decode")
    print(f"  paged_decode: split-K pass of {split} (hd 64), {split112} (hd 112) or {split128} "
          f"(hd 128) positions a block of {threads} threads, then a combine pass")
    tm, tn, bk, threads = _build.kernel_tiles("matmul_epilogue")
    print(f"  matmul_epilogue: {tm} x {tn} tiles of C, K steps of {bk}, {threads} threads a "
          "block")
    warp_max, block_max, blocks, groups = _build.kernel_tiles("quantize")
    print(f"  quantize: a row of up to {warp_max} entries in a warp's registers, up to "
          f"{block_max} in a block's (read once); longer rows read twice over ~{blocks} blocks "
          f"of at least {groups} float4 groups")
    return ptxas


def flash_pairs(S: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head."""
    total = 0
    for i in range(S):
        hi = i + 1 if causal else S
        lo = max(0, i - window + 1) if window else 0
        total += hi - lo
    return total


_BF16, _FP32 = "bfloat16", "float32"
# the head dims the flash kernels are built for (flash_attention.KERNEL_HEAD_DIM)
HEAD_DIMS = (64, 80, 112, 128)
# flash_fwd's cases per head dim: (BKV, S, G, dtype, causal, window, timed
# as); the main paths' shapes first. hd 64: smollm-135m (serving: 16 slots x
# 3 kv heads, S 512, G 3; training: 8 x 3, S 1024); hd 128: paper-416m
# (serving prefill: 16 slots x 8 heads, S 512, G 1; training: 4 x 8, S 2048)
FLASH_FWD_CASES = {
    64: [(16 * 3, 512, 3, _BF16, True, 0, "serving"),
         (8 * 3, 1024, 3, _BF16, True, 0, "training"),
         (2 * 3, 77, 3, _BF16, True, 0, None),
         (2 * 3, 300, 3, _BF16, True, 100, None),
         # the tensor-core sweep at G = 1, 2 and 4, ragged, non-causal and windowed
         (2 * 2, 130, 1, _BF16, True, 0, None),
         (2 * 1, 96, 4, _BF16, False, 0, None),
         (2 * 2, 77, 2, _BF16, False, 20, None),
         (2 * 1, 130, 4, _BF16, True, 37, None),
         (2 * 3, 130, 3, _FP32, True, 0, None),
         (2 * 1, 96, 4, _FP32, False, 0, None)],
    128: [(4 * 8, 2048, 1, _BF16, True, 0, "training"),
          (16 * 8, 512, 1, _BF16, True, 0, "serving"),
          (2 * 2, 77, 2, _BF16, True, 0, None),
          (2 * 2, 300, 1, _BF16, True, 100, None),
          (2 * 2, 130, 1, _BF16, False, 0, None),
          (2 * 1, 77, 2, _BF16, False, 20, None),
          (2 * 1, 130, 2, _BF16, True, 37, None),
          (1, 70, 8, _BF16, True, 0, None),
          (2 * 2, 130, 1, _FP32, True, 0, None),
          (2 * 1, 96, 2, _FP32, False, 0, None),
          (2 * 1, 77, 2, _FP32, True, 20, None),
          (1, 50, 8, _FP32, True, 0, None)],
    # hd 80: zamba2-2.7b's shared block (17a), the training shape (one
    # sequence of 8192 x 32 kv heads, G = 1, window 4096) first
    80: [(32, 8192, 1, _BF16, True, 4096, "training"),
         (2 * 2, 77, 2, _BF16, True, 0, None),
         (2 * 2, 300, 1, _BF16, True, 100, None),
         (2 * 2, 130, 1, _BF16, False, 0, None),
         (2 * 1, 77, 2, _BF16, False, 20, None),
         (2 * 1, 130, 2, _BF16, True, 37, None),
         (1, 70, 8, _BF16, True, 0, None),
         (2 * 2, 130, 1, _FP32, True, 0, None),
         (2 * 1, 96, 2, _FP32, False, 0, None),
         (2 * 1, 77, 2, _FP32, True, 20, None),
         (1, 50, 8, _FP32, True, 0, None)],
    # hd 112: kimi-k2-1t-a32b (19a: 64:8 heads, so G = 8), the serving
    # prefill (16 slots x 8 kv heads, S 512) and the training shape (4
    # sequences x 8 kv heads, S 2048) first
    112: [(16 * 8, 512, 8, _BF16, True, 0, "serving"),
          (4 * 8, 2048, 8, _BF16, True, 0, "training"),
          (2 * 2, 77, 2, _BF16, True, 0, None),
          (2 * 2, 300, 1, _BF16, True, 100, None),
          (2 * 1, 130, 8, _BF16, False, 0, None),
          (2 * 1, 77, 8, _BF16, False, 20, None),
          (2 * 1, 130, 4, _BF16, True, 37, None),
          (4 * 8, 2048, 8, _FP32, True, 0, None),
          (2 * 1, 96, 2, _FP32, False, 0, None),
          (2 * 1, 77, 8, _FP32, True, 20, None)],
}


# nemotron-4-15b (13a): flash_fwd at hd 128 and G = 6 (48:8 heads), the
# prefill shape of 4b's workload (16 slots x 8 kv heads, S 512) first
NEMOTRON_FWD_CASES = [(16 * 8, 512, 6, _BF16, True, 0, "serving"),
                      (2 * 2, 77, 6, _BF16, True, 0, None),
                      (2 * 1, 300, 6, _BF16, True, 100, None),
                      (2 * 1, 130, 6, _BF16, False, 0, None),
                      (2 * 1, 96, 6, _BF16, False, 20, None),
                      (1, 70, 6, _FP32, True, 0, None),
                      (2, 77, 6, _FP32, False, 20, None)]


def phase_flash(torch, fa, hd: int = 64, phase: str = "3a", cases: list | None = None):
    """[3a] flash_fwd against its plain version at head dim ``hd`` (the
    cases of ``FLASH_FWD_CASES[hd]`` unless ``cases`` are given); bf16
    outputs bitwise equal from run to run. The shapes named there are timed
    beside the plain version, the bound and SDPA's forward: returns {shape:
    row}."""
    print(f"[{phase}] flash_fwd (replaces flash_attention.py:_fwd_kernel) against its plain "
          f"version, hd {hd}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    fp32 = torch.float32
    out = {}
    for BKV, S, G, dt, causal, window, timed in cases or FLASH_FWD_CASES[hd]:
        dt = getattr(torch, dt)
        q = torch.randn((BKV, S, G, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((BKV, S, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((BKV, S, hd), generator=gen, device="cuda").to(dt)
        kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(hd))
        o, lse = fa._fwd_cuda(q, k, v, **kw)
        again = fa._fwd_cuda(q, k, v, **kw)
        o_ref, lse_ref = fa._fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        tag = f"{str(dt)[6:]} q{[BKV, S, G, hd]} causal={causal} window={window}"
        is_fp32 = dt == fp32
        err = check(f"{tag} o", (o.float() - o_ref.float()).abs().max().item(),
                    1e-5 if is_fp32 else 2e-2)
        check(f"{tag} lse", (lse - lse_ref).abs().max().item(), 1e-5 if is_fp32 else 1e-3)
        assert torch.equal(o, again[0]) and torch.equal(lse, again[1]), \
            f"{tag}: not deterministic"
        print(f"  {tag}: bitwise equal over two runs")
        if not timed:
            continue
        ms = time_ms(torch, lambda: fa._fwd_cuda(q, k, v, **kw))
        plain_ms = time_ms(torch, lambda: fa._fwd_plain(q, k, v, **kw))
        qs = q.permute(0, 2, 1, 3).contiguous()  # [BKV, G, S, hd]
        ks = k[:, None].expand(BKV, G, S, hd).contiguous()
        vs = v[:, None].expand(BKV, G, S, hd).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        mask = window_mask(torch, S, window) if window else None
        library_ms = time_ms(torch, lambda: sdpa(qs, ks, vs, is_causal=causal and not window,
                                                 attn_mask=mask))
        if window:
            print(f"  sdpa with the window as a boolean mask: {sdpa_backend(torch, qs, ks, vs, mask)}")
        flops = 4 * hd * flash_pairs(S, causal, window) * BKV * G
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + lse.numel() * 4
        out[timed] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          **bound(flops, nbytes, PEAK_FLOPS))
        print(f"  timed ({timed}) {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {library_ms:.4f} ms, bound {out[timed]['bound_ms']:.4f} ms "
              f"({out[timed]['bound_by']}: {flops:.4g} flop, {nbytes:.4g} B)")
    return out


def phase_paged(torch, fa, hd: int = 64, KV: int = 3, G: int = 3, phase: str = "3b"):
    """[3b] paged_decode against its plain version at head dim ``hd`` (the
    main path's KV heads and group size), bitwise equal from run to run; the
    main path's shape timed beside the plain version and the bound."""
    print(f"[{phase}] paged_decode (replaces flash_attention.py:_paged_kernel) against its "
          f"plain version, hd {hd}, {KV} kv heads, G {G}")
    rng = torch.Generator().manual_seed(2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    ps, table_w, n_pages = 16, 37, 1024
    split = fa.PAGED_SPLITS[hd]
    n_split = fa.paged_splits(table_w, ps, split)
    print(f"  split-K: {n_split} splits of {split} positions a (slot, kv head) at a table of "
          f"{table_w} pages of {ps}")
    cases = [  # (B, dtype, window, min and max length); the first is the main path's
        (16, torch.bfloat16, 0, 512, 584),  # shape, lengths as its decode spans see them
        (16, torch.bfloat16, 100, 1, 584),
        (16, torch.bfloat16, 0, 1, 60),     # most of each slot's splits empty
        (4, torch.float32, 0, 1, 200),
        (4, torch.float32, 100, 1, 592),
    ]
    out = {}
    for B, dt, window, min_len, max_len in cases:
        lengths = torch.randint(min_len, max_len + 1, (B,), generator=rng, dtype=torch.int32)
        lengths[0] = max_len
        table = torch.zeros((B, table_w), dtype=torch.int32)
        free = (torch.randperm(n_pages - 1, generator=rng) + 1).tolist()
        for b in range(B - 1):  # the last slot stays null-padded (an idle slot)
            n = -(-int(lengths[b]) // ps)
            table[b, :n] = torch.tensor([free.pop() for _ in range(n)], dtype=torch.int32)
        lengths[B - 1] = 1
        q = torch.randn((B, KV, G, hd), generator=gen, device="cuda").to(dt)
        kp = torch.randn((n_pages, ps, KV, hd), generator=gen, device="cuda").to(dt)
        vp = torch.randn((n_pages, ps, KV, hd), generator=gen, device="cuda").to(dt)
        table, lengths = table.cuda(), lengths.cuda()
        o = fa._paged_decode_cuda(q, kp, vp, table, lengths, window=window)
        again = fa._paged_decode_cuda(q, kp, vp, table, lengths, window=window)
        o_ref = fa._paged_decode_plain(q, kp, vp, table, lengths, window=window)
        torch.cuda.synchronize()
        tag = f"{str(dt)[6:]} B={B} window={window} lengths {min_len}..{max_len}"
        err = check(f"{tag} out", (o.float() - o_ref.float()).abs().max().item(),
                    1e-5 if dt == torch.float32 else 2e-2)
        assert torch.equal(o, again), f"{tag}: not bitwise equal from run to run"
        lens = lengths.cpu().tolist()
        empty = sum(p0 >= p1 for n in lens for p0, p1 in (
            fa.paged_split_range(s, n, window, table_w, ps, split) for s in range(n_split)))
        print(f"  {tag}: bitwise equal over two runs; {empty} of {B * n_split} (slot, split) "
              "pairs empty")
        if not out:
            ms = time_ms(torch, lambda: fa._paged_decode_cuda(q, kp, vp, table, lengths,
                                                              window=window))
            plain_ms = time_ms(torch, lambda: fa._paged_decode_plain(q, kp, vp, table, lengths,
                                                                     window=window))
            lo = [max(0, n - window) if window else 0 for n in lens]
            positions = sum(n - a for n, a in zip(lens, lo))
            nbytes = (positions * KV * hd * 2 * kp.element_size()   # K and V rows read
                      + 2 * q.numel() * q.element_size()             # q in, out
                      + sum(-(-n // ps) - a // ps for n, a in zip(lens, lo)) * 4 + B * 4)
            flops = 4 * hd * G * KV * positions
            out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                       **bound(flops, nbytes))
            print(f"  timed {tag}: kernel {ms:.4f} ms (both passes), plain {plain_ms:.4f} ms, "
                  f"bound {out['bound_ms']:.5f} ms ({out['bound_by']}: {nbytes} B, "
                  f"{positions} positions)")
    return out


def phase_agreement(torch, get_config, build_model, arch: str = "smollm-135m",
                    phase: str = "4a", n_layers: int | None = None,
                    overrides: dict | None = None):
    """Full width, fp32: the kernel path against the plain torch path
    (``n_layers`` cuts the depth, never a width; ``overrides``, e.g. an
    expert count, are printed)."""
    print(f"[{phase}] full-width fp32 agreement, {arch}: attn_impl pallas (kernels) vs xla "
          "(plain torch)" + (f", depth cut to {n_layers} layers" if n_layers else "")
          + (f", {overrides}" if overrides else ""))
    base = get_config(arch).replace(dtype="float32", **(overrides or {}))
    if n_layers:
        base = base.replace(n_layers=n_layers)
    dev = torch.device("cuda")
    model_k, model_p = build_model(base.replace(attn_impl="pallas")), build_model(base)
    params = model_k.init(torch.Generator(device=dev).manual_seed(0), dev)
    B, P, ps = 2, 45, 16
    tokens = torch.randint(0, base.vocab, (B, P), generator=torch.Generator().manual_seed(5))
    tokens = tokens.to(dev, torch.int32)
    table = torch.arange(1, 1 + B * 4, dtype=torch.int32, device=dev).reshape(B, 4)
    lengths = torch.tensor([P, P - 7], dtype=torch.int32, device=dev)
    with torch.no_grad():
        caches = [m.init_paged_cache(1 + B * 4, ps, dev) for m in (model_k, model_p)]
        lk, _ = model_k.paged_prefill(params, caches[0], tokens, table, lengths)
        lp, _ = model_p.paged_prefill(params, caches[1], tokens, table, lengths)
        assert torch.isfinite(lk).all()
        check("prefill logits", (lk - lp).abs().max().item(), 1e-3)
        tok = torch.argmax(lp[torch.arange(B, device=dev), lengths.long() - 1], -1).int()
        for t in range(3):
            dk, _ = model_k.paged_decode_step(params, caches[0], tok, table, lengths + t,
                                              impl="pallas")
            dp, _ = model_p.paged_decode_step(params, caches[1], tok, table, lengths + t,
                                              impl="xla")
            assert torch.isfinite(dk).all()
            check(f"decode step {t} logits", (dk - dp).abs().max().item(), 1e-3)
            tok = torch.argmax(dp, -1).int()
    del params, caches
    torch.cuda.empty_cache()


def check_serving_launches(engine, launches: dict, stats: dict) -> None:
    """A serving run's launches against the engine's formula: prefill
    dispatches x L ``flash_fwd`` plus spans x L x span ``paged_decode``,
    the spans counted as captures (each a warm-up span run eagerly) plus
    replays (each what its capture recorded); every captured span recorded
    one span's formula."""
    want = engine.launches(stats)
    got = {k: launches[k] for k in want}
    assert got == want and all(v > 0 for v in want.values()), (got, want, stats)
    assert stats["spans"] == stats["captures"] + stats["replays"], stats
    per_span = engine.launches_per_span()
    for key, graph in engine._span_fn.graphs.items():
        recorded = {k: v for k, v in graph.launches.items() if v}
        assert recorded == per_span, (key, recorded, per_span)
    print(f"  launches {got} = {stats['prefill_dispatches']} prefill dispatches x "
          f"{engine.launches_per_prefill()} + ({stats['captures']} captures + "
          f"{stats['replays']} replays) x {per_span} (L x span)")


def phase_main(torch, fa, get_config, serve, arch: str = "smollm-135m", phase: str = "4b",
               overrides: dict | None = None):
    """The serving main path: ``serve`` at full width through the captured
    span; then a second run on the same engine (replays only) and the same
    workload through the eager span (``capture=False``), both bitwise equal
    in their greedy tokens."""
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import random_prompts, requests_for
    from repro_torch.serving import PagedEngine

    print(f"[{phase}] main path: repro_torch.launch.serve, {arch} full width, bf16, pallas, "
          f"captured decode spans {overrides or ''}")
    cfg = get_config(arch).replace(attn_impl="pallas", **(overrides or {}))
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    results, seconds, engine, model, params = serve(cfg, device="cuda", **MAIN)
    launches = _build.LaunchCounts(fa.LAUNCHES, _build.VARIANT_LAUNCHES)
    st = dict(engine.stats)
    engine.peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  {st}, peak {engine.peak_gb:.2f} GB")
    assert len(results) == MAIN["batch"], sorted(results)
    for rid, toks in results.items():
        assert toks.shape == (MAIN["max_new"],), (rid, toks.shape)
        assert ((toks >= 0) & (toks < cfg.vocab)).all(), rid
    assert st["captures"] >= 1 and st["replays"] >= 1, st
    check_serving_launches(engine, launches, st)
    n_new = MAIN["batch"] * MAIN["max_new"]
    engine.tok_s = n_new / seconds
    engine.capture_s = st["capture_s"]
    print(f"  generated {n_new} tokens in {seconds:.3f} s ({engine.tok_s:.1f} tok/s), the "
          f"first span's warm-up {st['warmup_s']:.3f} s and capture {st['capture_s']:.3f} s "
          "included")
    reqs = requests_for(random_prompts(cfg.vocab, MAIN["batch"], MAIN["prompt_len"]),
                        MAIN["max_new"])
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    again = engine.run(reqs)
    torch.cuda.synchronize()
    engine.replay_tok_s = n_new / (time.perf_counter() - t0)
    st2 = dict(engine.stats)
    assert st2["captures"] == 0 and st2["replays"] == st2["spans"] > 0, st2
    check_serving_launches(engine, dict(fa.LAUNCHES), st2)
    for rid in results:
        assert (again[rid] == results[rid]).all(), f"{rid}: second run differs"
    print(f"  second run on the same engine (replays only, {st2['replays']} spans): "
          f"{engine.replay_tok_s:.1f} tok/s, tokens bitwise equal")
    eager = PagedEngine(model, params, capture=False, attn_impl="pallas", device="cuda",
                        **{k: MAIN[k] for k in ("slots", "page_size", "max_pages",
                                                "decode_steps_per_dispatch")})
    t0 = time.perf_counter()
    eager_out = eager.run(reqs)
    torch.cuda.synchronize()
    engine.eager_tok_s = n_new / (time.perf_counter() - t0)
    for rid in results:
        assert (eager_out[rid] == results[rid]).all(), f"{rid}: eager span differs"
    assert eager.stats["captures"] == eager.stats["replays"] == 0
    print(f"  the eager span (capture=False): {engine.eager_tok_s:.1f} tok/s, greedy tokens "
          f"bitwise equal to the captured span's ({n_new} tokens)")
    del eager
    with torch.no_grad():
        prompt = torch.tensor([results["req0"].tolist()], dtype=torch.int32, device="cuda")
        logits, _ = model.forward(params, prompt)
    assert torch.isfinite(logits).all(), "non-finite logits"
    return launches, engine


def phase_sampled(torch, engine) -> None:
    """[4b'] temperature 1.0 through the captured span (the engine's
    generator registered with the graph): two engines from seed 7 give the
    same tokens bitwise, seed 8 other tokens."""
    from repro_torch.serving import PagedEngine, Request

    print("[4b'] sampled decoding (temperature 1.0) through the captured span")
    gen = torch.Generator().manual_seed(9)
    reqs = [Request(f"t{i}", tuple(torch.randint(0, engine.model.cfg.vocab, (64,),
                                                 generator=gen).tolist()), 24)
            for i in range(8)]
    runs = []
    for seed in (7, 7, 8):
        eng = PagedEngine(engine.model, engine.params, slots=8, page_size=16, max_pages=64,
                          decode_steps_per_dispatch=8, temperature=1.0, attn_impl="pallas",
                          device="cuda", seed=seed)
        runs.append(eng.run(reqs))
        assert eng.stats["captures"] == 1 and eng.stats["replays"] >= 1, eng.stats
        del eng
    for rid in runs[0]:
        assert (runs[0][rid] == runs[1][rid]).all(), f"{rid}: seed 7 does not repeat"
    differ = sum(int((runs[0][r] != runs[2][r]).sum()) for r in runs[0])
    assert differ > 0, "seed 8 gave seed 7's tokens"
    print(f"  seed 7 twice: bitwise equal ({8 * 24} tokens); seed 8: {differ} of them differ")


def phase_naive(torch, fa, get_config, build_model, serve, paged_tok_s: float,
                arch: str = "smollm-135m", phase: str = "4d") -> float:
    """The naive dense-cache engine at full width: fp32 logits against the
    paged engine's over a prefill and three decode steps (within 1e-3, as
    4a), then 4b's prompts as one lockstep batch in bf16 through
    ``serve(engine='naive')``: flash_fwd launched L times for its one
    prefill, no paged_decode; its rate beside the paged engine's."""
    from repro_torch.serving import naive_generate

    print(f"[{phase}] naive engine, {arch} full width: fp32 agreement with the paged engine, "
          f"then {MAIN['batch']} x ({MAIN['prompt_len']} + {MAIN['max_new']}) in bf16 as one "
          "lockstep batch")
    dev = torch.device("cuda")
    cfg = get_config(arch).replace(dtype="float32", attn_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    B, P, ps = 2, 45, 16
    tokens = torch.randint(0, cfg.vocab, (B, P), generator=torch.Generator().manual_seed(5))
    tokens = tokens.to(dev, torch.int32)
    table = torch.arange(1, 1 + B * 4, dtype=torch.int32, device=dev).reshape(B, 4)
    lengths = torch.full((B,), P, dtype=torch.int32, device=dev)
    with torch.no_grad():
        pool = model.init_paged_cache(1 + B * 4, ps, dev)
        lp, _ = model.paged_prefill(params, pool, tokens, table, lengths)
        cache = model.init_cache(params, B, P + 8)
        ln, cache = model.prefill_with_cache(params, cache, tokens)
        check("prefill logits (naive vs paged)", (ln - lp).abs().max().item(), 1e-3)
        tok = torch.argmax(lp[:, -1], -1).int()
        for t in range(3):
            dp, _ = model.paged_decode_step(params, pool, tok, table, lengths + t,
                                            impl="pallas")
            dn, cache = model.decode_step(params, cache, tok, P + t)
            assert torch.isfinite(dn).all()
            check(f"decode step {t} logits (naive vs paged)", (dn - dp).abs().max().item(), 1e-3)
            tok = torch.argmax(dp, -1).int()
        ref = naive_generate(model, params, tokens, 4, batched_prefill=False)
        got = naive_generate(model, params, tokens, 4)
        assert torch.equal(ref[:, P:], got[:, P:]), (ref[:, P:], got[:, P:])
        print("  greedy tokens of the batched and the token-stepped prefill equal (fp32)")
    del params, pool, cache
    torch.cuda.empty_cache()
    cfg = get_config(arch).replace(attn_impl="pallas")
    fa.reset_launch_counts()
    results, seconds, _, model, params = serve(cfg, engine="naive", device="cuda", **MAIN)
    launches = dict(fa.LAUNCHES)
    assert launches["flash_fwd"] == cfg.n_layers and launches["paged_decode"] == 0, launches
    for rid, toks in results.items():
        assert toks.shape == (MAIN["max_new"],) and ((toks >= 0) & (toks < cfg.vocab)).all()
    n_new = MAIN["batch"] * MAIN["max_new"]
    print(f"  launches {({k: v for k, v in launches.items() if v})} (L = {cfg.n_layers} for the "
          f"one prefill); generated {n_new} tokens in {seconds:.3f} s: {n_new / seconds:.1f} "
          f"tok/s beside the paged engine's {paged_tok_s:.1f} (4b, captured spans)")
    del params
    torch.cuda.empty_cache()
    return n_new / seconds


def device_times(torch, prof) -> dict:
    """{kernel name (cut to 70 characters): [device ms, launches]} of a
    torch.profiler run, read off the profiler's raw events: ``prof.events()``
    would first build a Python object for each of them (a profiled round has
    up to ~160,000 kernels)."""
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            name = e.name()
            name = name if len(name) < 70 else name[:67] + "..."
            acc = by_name.setdefault(name, [0.0, 0])
            acc[0] += e.duration_ns() / 1e6
            acc[1] += 1
    return by_name


def print_focus(by_name: dict, wall_ms: float, focus: tuple, beside: dict | None = None) -> None:
    """The device time of the kernels whose names hold each key of ``focus``,
    summed apart, with its time per launch beside ``beside[key]`` (the phase
    and its ms per call) where given."""
    for key in focus:
        hits = [(ms, n) for name, (ms, n) in by_name.items() if key in name]
        ms, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
        print(f"  {key}: {ms:.3f} ms device time, x{n}, {100 * ms / wall_ms:.2f}% of "
              "the unprofiled wall" + (f"; {ms / n:.4f} ms per launch" if n else ""))
        if beside and key in beside:
            phase, event_ms = beside[key]
            print(f"    beside phase {phase}'s event time {event_ms:.4f} ms per call (L2 flushed)")


def decode_floor_ms(engine, lengths: list) -> tuple[float, float, float]:
    """The memory-bound floor of one decode step: every weight read once (of
    an untied embedding only the B gathered rows), each slot's K and V rows
    up to its position read once and the new ones written, at 3.35 TB/s.
    Returns (ms, weight bytes, KV bytes)."""
    from repro_torch.utils.tree import tree_bytes

    cfg, params = engine.model.cfg, engine.params
    weights = tree_bytes(params)
    if "head" in params:  # the untied embedding: only the gathered rows
        emb = params["embed"]
        weights -= emb.numel() * emb.element_size()
        weights += len(lengths) * emb.shape[1] * emb.element_size()
    row = cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2 * engine._pool["k"].element_size()
    kv = sum(n + 1 for n in lengths) * row
    return (weights + kv) / HBM_BW * 1e3, weights, kv


def phase_profile(torch, engine, paged_ms: float, phase: str = "4c") -> dict:
    """Where the time goes: one engine run (16 requests, prompt 512, 16 new
    tokens: one prefill dispatch and two decode spans, captured) under
    torch.profiler; paged_decode's two passes summed apart; the host's
    seconds in prefill dispatches and spans (``PagedEngine.stats``); then
    one captured span replayed alone: its kernels a decode step and its
    device time a decode step beside the step's memory-bound floor."""
    print(f"[{phase}] profile: 16 requests x (512 prompt + 16 new) through the same engine")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request, pages_needed

    gen = torch.Generator().manual_seed(7)
    reqs = [Request(f"p{i}", tuple(torch.randint(0, engine.model.cfg.vocab, (512,),
                                                 generator=gen).tolist()), 16)
            for i in range(16)]
    engine.run(reqs)  # warm: captures the span at this run's table width
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    st = dict(engine.stats)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_times(torch, prof)
    busy = sum(v[0] for v in by_name.values())
    idle = 100 * (1 - busy / plain_wall_ms)
    # kernel times are the card's own; the profiler slows the host, so the
    # idle share is taken against the same run's wall time unprofiled
    print(f"  wall {plain_wall_ms:.1f} ms unprofiled ({wall_ms:.1f} ms profiled), device busy "
          f"{busy:.1f} ms: idle {idle:.1f}% of the unprofiled wall, {engine.stats}")
    print(f"  host (unprofiled run): prefill dispatches {1e3 * st['prefill_s']:.1f} ms, spans "
          f"{1e3 * st['span_s']:.1f} ms ({st['replays']} replays), the engine's own "
          f"scheduling {plain_wall_ms - 1e3 * (st['prefill_s'] + st['span_s']):.1f} ms")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {ms:9.3f} ms {100 * ms / plain_wall_ms:5.1f}%  x{n:<6d} {name}")
    # a call launches two kernels: the split-K pass and the combine pass
    hits = [(ms, n) for name, (ms, n) in by_name.items() if "paged_decode" in name]
    ms, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
    calls = (n // 2) or 1
    print(f"  paged_decode (split and combine passes): {ms:.3f} ms device time, x{n} kernels "
          f"({n // 2} calls), {100 * ms / plain_wall_ms:.2f}% of the unprofiled wall; "
          f"{ms / calls:.4f} ms per call beside phase 3b's event time {paged_ms:.4f} ms "
          "(L2 flushed)")
    # one span replayed alone, on the static inputs of this run's last span
    graph = engine._span_fn.graphs[(engine.slots,
                                    pages_needed(512 + 16 + engine.span, engine.page_size))]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.graph.replay()
        torch.cuda.synchronize()
    kernels = sum(n for _, n in device_times(torch, prof).values())
    times = []
    for _ in range(7):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    step_ms = statistics.median(times) / engine.span
    lengths = [n + (engine.span - 1) / 2 for n in graph.lengths.tolist()]
    floor_ms, wbytes, kvbytes = decode_floor_ms(engine, lengths)
    print(f"  one captured span replayed alone: {kernels} kernels, {kernels / engine.span:.0f} "
          f"a decode step; {step_ms:.4f} ms device time a decode step (median of 7 replays / "
          f"{engine.span}) beside its memory-bound floor {floor_ms:.4f} ms (weights "
          f"{wbytes / 1e9:.3f} GB + K/V {kvbytes / 1e9:.4f} GB read once, 3.35 TB/s): "
          f"{step_ms / floor_ms:.2f}x")
    return dict(idle=idle, wall_ms=plain_wall_ms, busy_ms=busy, step_ms=step_ms,
                floor_ms=floor_ms, kernels_per_step=kernels / engine.span,
                read=decode_read(phase, engine, lengths, step_ms, floor_ms))


def window_mask(torch, S: int, window: int):
    """The causal sliding window as SDPA's boolean mask [S, S] (True: attend)."""
    i = torch.arange(S, device="cuda")
    return (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)


def sdpa_backend(torch, q, k, v, mask) -> str:
    """The backend SDPA takes for these inputs, by the name of its backward."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask)
    return type(o.grad_fn).__name__


def sdpa_backward_ms(torch, q, k, v, do, B: int, KV: int, window: int = 0,
                     causal: bool = True) -> float:
    """The library yardstick of the flash backward: SDPA's backward alone (dq,
    dk and dv in one autograd call), from one forward with enable_gqa
    (causal, or with ``window`` the window as a boolean mask, or neither)
    kept with retain_graph. Prints the backend and three repeats of
    ``time_ms``; returns their median."""
    _, S, G, hd = q.shape
    qs = q.reshape(B, KV, S, G, hd).permute(0, 1, 3, 2, 4).reshape(B, KV * G, S, hd)
    dos = do.reshape(B, KV, S, G, hd).permute(0, 1, 3, 2, 4).reshape(B, KV * G, S, hd)
    leaves = [t.detach().requires_grad_(True)
              for t in (qs, k.reshape(B, KV, S, hd), v.reshape(B, KV, S, hd))]
    mask = window_mask(torch, S, window) if window else None
    o = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=causal and not window,
                                                         attn_mask=mask, enable_gqa=True)
    repeats = [time_ms(torch, lambda: torch.autograd.grad(o, leaves, dos, retain_graph=True))
               for _ in range(3)]
    print(f"  sdpa backward ({type(o.grad_fn).__name__}): "
          + ", ".join(f"{r:.4f}" for r in repeats) + " ms")
    return statistics.median(repeats)


# flash_dq / flash_dkv cases per head dim: (B, KV, S, G, dtype, causal,
# window); the first is the main path's shape (hd 64: smollm-135m's
# training step; hd 128: paper-416m's)
FLASH_BWD_CASES = {
    64: [(8, 3, 1024, 3, _BF16, True, 0),
         (8, 3, 1024, 3, _FP32, True, 0),
         (2, 3, 77, 3, _FP32, True, 0),
         (2, 3, 300, 3, _BF16, True, 100),
         (2, 1, 96, 4, _FP32, False, 0),
         (2, 2, 130, 1, _FP32, True, 0),
         # bf16 at the shapes above, so the tensor-core sweeps meet ragged
         # tiles, G = 1 and 4, non-causal and windowed masks
         (2, 3, 77, 3, _BF16, True, 0),
         (2, 1, 96, 4, _BF16, False, 0),
         (2, 2, 130, 1, _BF16, True, 0),
         (2, 1, 130, 4, _BF16, True, 37),
         (2, 2, 77, 2, _BF16, False, 20)],
    128: [(4, 8, 2048, 1, _BF16, True, 0),
          (2, 2, 300, 1, _FP32, True, 0),
          (2, 3, 77, 2, _FP32, True, 0),
          (2, 1, 96, 2, _FP32, False, 0),
          (2, 1, 130, 1, _FP32, True, 37),
          (1, 1, 50, 8, _FP32, True, 0),
          (2, 3, 77, 2, _BF16, True, 0),
          (2, 1, 96, 1, _BF16, False, 0),
          (2, 2, 130, 1, _BF16, True, 0),
          (2, 1, 130, 2, _BF16, True, 37),
          (2, 2, 77, 2, _BF16, False, 20),
          (2, 2, 300, 1, _BF16, True, 100),
          (1, 1, 70, 8, _BF16, True, 0)],
    80: [(1, 32, 8192, 1, _BF16, True, 4096),
         (2, 2, 300, 1, _FP32, True, 0),
         (2, 3, 77, 2, _FP32, True, 0),
         (2, 1, 96, 2, _FP32, False, 0),
         (2, 1, 130, 1, _FP32, True, 37),
         (1, 1, 50, 8, _FP32, True, 0),
         (2, 3, 77, 2, _BF16, True, 0),
         (2, 1, 96, 1, _BF16, False, 0),
         (2, 2, 130, 1, _BF16, True, 0),
         (2, 1, 130, 2, _BF16, True, 37),
         (2, 2, 77, 2, _BF16, False, 20),
         (2, 2, 300, 1, _BF16, True, 100),
         (1, 1, 70, 8, _BF16, True, 0)],
    # hd 112: kimi-k2's training shape (4 sequences x 8 kv heads of 2048, G
    # = 8) first, in bf16 and fp32
    112: [(4, 8, 2048, 8, _BF16, True, 0),
          (4, 8, 2048, 8, _FP32, True, 0),
          (2, 2, 300, 1, _FP32, True, 0),
          (2, 1, 96, 8, _FP32, False, 0),
          (2, 1, 130, 4, _FP32, True, 37),
          (2, 3, 77, 2, _BF16, True, 0),
          (2, 1, 96, 8, _BF16, False, 0),
          (2, 1, 130, 8, _BF16, True, 37),
          (2, 2, 77, 2, _BF16, False, 20),
          (2, 2, 300, 1, _BF16, True, 100)],
}


def phase_flash_bwd(torch, fa, hd: int = 64, phase: str = "5a", cases: list | None = None):
    """[5a] flash_dq and flash_dkv against autograd through the plain forward
    and against their plain versions at head dim ``hd`` (the cases of
    ``FLASH_BWD_CASES[hd]`` unless ``cases`` are given); bitwise equal from
    run to run. The first case (the main path's shape) is timed."""
    print(f"[{phase}] flash_dq / flash_dkv (replace flash_attention.py:_dq_kernel / "
          f"_dkv_kernel), hd {hd}")
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for B, KV, S, G, dt, causal, window in cases or FLASH_BWD_CASES[hd]:
        dt = getattr(torch, dt)
        BKV = B * KV
        fp32 = dt == torch.float32
        q, do = (torch.randn((BKV, S, G, hd), generator=gen, device="cuda").to(dt) for _ in "qd")
        k, v = (torch.randn((BKV, S, hd), generator=gen, device="cuda").to(dt) for _ in "kv")
        kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(hd))
        o, lse = fa._fwd_cuda(q, k, v, **kw)
        dl = torch.sum(do.float() * o.float(), dim=-1)
        args = (q, k, v, do, lse, dl)
        got = fa._bwd_cuda(*args, **kw)
        again = fa._bwd_cuda(*args, **kw)
        plain = (fa._dq_plain(*args, **kw), *fa._dkv_plain(*args, **kw))
        # autograd through the plain forward, a few rows of BKV at a time at
        # S = 8192 (its fp32 scores and probabilities are 8.6 GB a tensor)
        step = max(1, (1 << 28) // (S * S * G))
        parts = []
        for r in range(0, BKV, step):
            leaves = [t[r:r + step].detach().requires_grad_(True) for t in (q, k, v)]
            o_ref, _ = fa._fwd_plain(*leaves, **kw)
            parts.append(torch.autograd.grad(o_ref, leaves, do[r:r + step]))
            del o_ref, leaves
        auto = [torch.cat(p) for p in zip(*parts)]
        del parts
        torch.cuda.synchronize()
        tag = f"{str(dt)[6:]} q{[BKV, S, G, hd]} causal={causal} window={window}"
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{tag}: not deterministic"
        errs = {}
        for name, g, p, a in zip(("dq", "dk", "dv"), got, plain, auto):
            scale = max(1.0, p.float().abs().max().item())
            # fp32: summation order only; bf16: ~2.5 ulps of the largest gradient
            tol = (1e-5 if fp32 else 1e-2) * scale
            errs[name] = check(f"{tag} {name} vs plain", (g.float() - p.float()).abs().max().item(),
                               tol)
            check(f"{tag} {name} vs autograd", (g.float() - a.float()).abs().max().item(), tol)
        print(f"  {tag}: bitwise equal over two runs")
        if out:
            continue
        # the main path's shape: time each kernel, its plain version, the bound
        pairs = sum(hi - lo for lo, hi in (
            (max(0, i - window + 1) if window else 0, i + 1 if causal else S) for i in range(S)))
        rows = BKV * G * pairs
        io = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size() \
            + 2 * lse.numel() * 4  # q, do, k, v read; lse, dl read
        dq_ms = time_ms(torch, lambda: fa._dq_cuda(*args, **kw))
        dkv_ms = time_ms(torch, lambda: fa._dkv_cuda(*args, **kw))
        dq_plain = time_ms(torch, lambda: fa._dq_plain(*args, **kw), runs=5)
        dkv_plain = time_ms(torch, lambda: fa._dkv_plain(*args, **kw), runs=5)
        lib_ms = sdpa_backward_ms(torch, q, k, v, do, B, KV, window, causal)
        out["flash_dq"] = dict(max_abs_err=errs["dq"], ms=dq_ms, plain_ms=dq_plain,
                               library_ms=lib_ms,
                               **bound(6 * hd * rows, io + q.numel() * q.element_size(),
                                       PEAK_FLOPS))
        out["flash_dkv"] = dict(max_abs_err=max(errs["dk"], errs["dv"]), ms=dkv_ms,
                                plain_ms=dkv_plain, library_ms=lib_ms,
                                **bound(8 * hd * rows, io + 2 * k.numel() * k.element_size(),
                                        PEAK_FLOPS))
        for name in ("flash_dq", "flash_dkv"):
            r = out[name]
            print(f"  timed {name} {tag}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), sdpa backward "
                  f"(dq, dk, dv) {lib_ms:.4f} ms; {pairs} unmasked pairs per head")
    return out


def operand_layouts(a, b, d):
    """The four layouts of A [z, m, k] (k-fast or m-fast) by B [z, k, n]
    (n-fast or k-fast), same values: an operand already in a layout stays as
    it is (a view), else it is copied into it. D follows A or B where it is
    the same tensor (c A A + b A, B X + a X), as on the main path."""
    def fast(t, axis):  # t with its values laid out so that ``axis`` has stride 1
        if t.stride(axis) == 1:
            return t
        return t.contiguous() if axis == -1 else t.mT.contiguous().mT
    out = {}
    for an, aa in (("A k-fast", -1), ("A m-fast", -2)):
        for bn, ba in (("B n-fast", -1), ("B k-fast", -2)):
            av, bv = fast(a, aa), fast(b, ba)
            dv = av if d is a else bv if d is b else d
            out[f"{an}, {bn}"] = (av, bv, dv)
    return out


def check_matmul_cases(torch, mm, cases) -> None:
    """Each (name, a, b, d, alpha, beta, symmetric) case in all four operand
    layouts within 1e-5 of the largest output of the plain version; a
    symmetric case also with symmetric=True, bitwise symmetric and bitwise
    equal to the full computation."""
    for name, a, b, d, alpha, beta, sym in cases:
        cp = mm._matmul_plain(a, b, d, alpha=alpha, beta=beta, out_dtype=a.dtype)
        # fp32 summation order only: 1e-5 of the largest output
        tol = 1e-5 * max(1.0, cp.abs().max().item())
        for layout, (av, bv, dv) in operand_layouts(a, b, d).items():
            c = mm.matmul_epilogue(av, bv, dv, alpha=alpha, beta=beta)
            torch.cuda.synchronize()
            check(f"{name}, {layout}", (c - cp).abs().max().item(), tol)
            if sym:
                cs = mm.matmul_epilogue(av, bv, dv, alpha=alpha, beta=beta, symmetric=True)
                torch.cuda.synchronize()
                assert torch.equal(cs, cs.mT), f"{name}, {layout}: triangle not bitwise symmetric"
                assert torch.equal(cs, c), f"{name}, {layout}: triangle != full computation"
        if sym:
            print(f"  {name}: symmetric=True bitwise symmetric and bitwise equal to "
                  "symmetric=False in all four layouts")


def time_matmul(torch, mm, name, a, b, d, alpha, beta, sym, flops, nbytes) -> dict:
    """One matmul_epilogue call timed beside its plain version, its bound
    (fp32 CUDA-core peak) and torch.baddbmm (the full product)."""
    z, m, n = a.shape[0], a.shape[1], b.shape[-1]
    kw = dict(alpha=alpha, beta=beta)
    c = mm.matmul_epilogue(a, b, d, symmetric=sym, **kw)
    cp = mm._matmul_plain(a, b, d, out_dtype=a.dtype, **kw)
    torch.cuda.synchronize()
    err = (c - cp).abs().max().item()
    ms = time_ms(torch, lambda: mm.matmul_epilogue(a, b, d, symmetric=sym, **kw))
    plain_ms = time_ms(torch, lambda: mm._matmul_plain(a, b, d, out_dtype=a.dtype, **kw))
    dst = d if d is not None else torch.empty((z, m, n), device="cuda")
    library_ms = time_ms(torch, lambda: torch.baddbmm(dst, a, b, beta=beta, alpha=alpha))
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               **bound(flops, nbytes, PEAK_FP32_FLOPS))
    print(f"  timed {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, baddbmm "
          f"{library_ms:.4f} ms (the full product), bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}, {flops:.4g} flop at 67 TFLOP/s fp32, {nbytes:.4g} B)")
    return row


def normed(g):
    """Newton-Schulz's first input: g over its Frobenius norm per matrix."""
    import torch

    return g / torch.sqrt(torch.sum(g * g, dim=(-2, -1), keepdim=True))


def phase_matmul(torch, mm, ops, ref):
    """[5b] matmul_epilogue in fp32 at the Newton-Schulz shapes, every case
    in all four operand layouts; symmetric calls bitwise symmetric and
    bitwise equal to the full computation. X X^T (the triangle) and B X + a X
    timed beside their bounds and torch.baddbmm, then the full Newton-Schulz
    of the w_in stack through the kernel."""
    print("[5b] matmul_epilogue (replaces matmul.py:_matmul_epilogue_kernel), fp32, TF32 off")
    from repro_torch.optim.muon import NS_COEFFS

    na, nb, nc = NS_COEFFS
    gen = torch.Generator(device="cuda").manual_seed(12)
    g = torch.randn((30, 576, 1536), generator=gen, device="cuda")
    x = normed(g)
    x_kv = normed(torch.randn((30, 576, 192), generator=gen, device="cuda")).mT  # wk, wv
    A = mm.matmul_epilogue(x, x.mT, symmetric=True)  # the iteration's own A, B
    Bm = mm.matmul_epilogue(A, A, A, alpha=nc, beta=nb, symmetric=True)
    assert torch.equal(A, A.mT), "X X^T is not bitwise symmetric"
    r = g[:2, :200, :70]
    rr = r @ r.mT  # rr + rr^T is bitwise symmetric, as the triangle's D must be
    cases = [  # (name, a, b, d, alpha, beta, symmetric)
        ("X X^T, w_in stack [30, 576, 1536]", x, x.mT, None, 1.0, 0.0, True),
        ("c A A + b A, [30, 576, 576]", A, A, A, nc, nb, True),
        ("B X + a X, [30, 576, 576] x [30, 576, 1536]", Bm, x, x, 1.0, na, False),
        ("X X^T, wk stack transposed [30, 192, 576]", x_kv, x_kv.mT, None, 1.0, 0.0, True),
        ("ragged [3, 77, 50] x [3, 50, 33]", g[:3, :77, :50], g[:3, :50, :33],
         g[:3, 100:177, 7:40], 0.5, -2.0, False),
        ("ragged X X^T [3, 77, 50]", g[:3, :77, :50], g[:3, :77, :50].mT, None, 1.0, 0.0, True),
        ("ragged X X^T + D [2, 200, 70]", r, r.mT, rr + rr.mT, 0.5, -1.5, True),
    ]
    check_matmul_cases(torch, mm, cases)

    z, m, k = x.shape
    # X X^T: X read once (A and B are the same tensor), C written once; the
    # triangle's bound counts its m(m + 1)/2 distinct entries a matrix
    xx_bytes = (x.numel() + z * m * m) * 4
    out = time_matmul(torch, mm, "X X^T, w_in stack [30, 576, 1536], symmetric=True", x, x.mT,
                      None, 1.0, 0.0, True, 2.0 * z * (m * (m + 1) // 2) * k, xx_bytes)
    full = time_matmul(torch, mm,
                       "X X^T, w_in stack [30, 576, 1536], symmetric=False (the full product)",
                       x, x.mT, None, 1.0, 0.0, False, 2.0 * z * m * m * k, xx_bytes)
    # B X + a X: B read, X read once (B and D are the same tensor), C written
    bx = time_matmul(torch, mm, "B X + a X, [30, 576, 576] x [30, 576, 1536]", Bm, x, x, 1.0,
                     na, False, 2.0 * z * m * m * k, (Bm.numel() + 2 * x.numel()) * 4)
    y = ops.ns_orthogonalize(g)
    y_ref = ref.ns_orthogonalize_ref(g)
    torch.cuda.synchronize()
    check("full Newton-Schulz, w_in stack, kernel vs plain fp32", (y - y_ref).abs().max().item(),
          1e-5)
    ns_ms = time_ms(torch, lambda: ops.ns_orthogonalize(g), runs=5)
    ns_plain = time_ms(torch, lambda: ref.ns_orthogonalize_ref(g), runs=5)
    print(f"  timed full Newton-Schulz (15 launches) of the w_in stack: kernel {ns_ms:.3f} ms, "
          f"plain {ns_plain:.3f} ms")
    return out, full, bx


def phase_matmul_ladder(torch, mm, ops, ref):
    """[12b] matmul_epilogue at paper-416m's Newton-Schulz shapes, whose
    widths are not multiples of the 96-wide tile (1024 = 10 x 96 + 64, 2816 =
    29 x 96 + 32): the products of the w_in stack [12, 1024, 2816], of the
    square stacks [12, 1024, 1024] and of w_down [12, 2816, 1024] (taken
    transposed, as a view), each in all four operand layouts within 1e-5 of
    the largest output, the symmetric ones bitwise symmetric; X X^T and
    B X + a X of the w_in stack timed; the full Newton-Schulz of w_in."""
    print("[12b] matmul_epilogue at paper-416m's shapes (ragged tile edges), fp32, TF32 off")
    from repro_torch.optim.muon import NS_COEFFS

    na, nb, nc = NS_COEFFS
    gen = torch.Generator(device="cuda").manual_seed(16)
    g = torch.randn((12, 1024, 2816), generator=gen, device="cuda")
    x = normed(g)  # w_gate / w_up
    xs = normed(torch.randn((12, 1024, 1024), generator=gen, device="cuda"))  # wq, wk, wv, wo
    x_down = normed(torch.randn((12, 2816, 1024), generator=gen, device="cuda")).mT
    A = mm.matmul_epilogue(x, x.mT, symmetric=True)
    Bm = mm.matmul_epilogue(A, A, A, alpha=nc, beta=nb, symmetric=True)
    As = mm.matmul_epilogue(xs, xs.mT, symmetric=True)
    Bs = mm.matmul_epilogue(As, As, As, alpha=nc, beta=nb, symmetric=True)
    check_matmul_cases(torch, mm, [
        ("X X^T, w_in stack [12, 1024, 2816]", x, x.mT, None, 1.0, 0.0, True),
        ("c A A + b A, [12, 1024, 1024]", A, A, A, nc, nb, True),
        ("B X + a X, [12, 1024, 1024] x [12, 1024, 2816]", Bm, x, x, 1.0, na, False),
        ("X X^T, wq stack [12, 1024, 1024]", xs, xs.mT, None, 1.0, 0.0, True),
        ("c A A + b A, wq stack [12, 1024, 1024]", As, As, As, nc, nb, True),
        ("B X + a X, wq stack [12, 1024, 1024] x [12, 1024, 1024]", Bs, xs, xs, 1.0, na, False),
        ("X X^T, w_down stack transposed [12, 1024, 2816]", x_down, x_down.mT, None, 1.0, 0.0,
         True),
    ])
    z, m, k = x.shape
    xx_bytes = (x.numel() + z * m * m) * 4
    out = time_matmul(torch, mm, "X X^T, w_in stack [12, 1024, 2816], symmetric=True", x, x.mT,
                      None, 1.0, 0.0, True, 2.0 * z * (m * (m + 1) // 2) * k, xx_bytes)
    bx = time_matmul(torch, mm, "B X + a X, [12, 1024, 1024] x [12, 1024, 2816]", Bm, x, x, 1.0,
                     na, False, 2.0 * z * m * m * k, (Bm.numel() + 2 * x.numel()) * 4)
    y = ops.ns_orthogonalize(g)
    y_ref = ref.ns_orthogonalize_ref(g)
    torch.cuda.synchronize()
    check("full Newton-Schulz, w_in stack [12, 1024, 2816], kernel vs plain fp32",
          (y - y_ref).abs().max().item(), 1e-5)
    del g, x, xs, x_down, A, Bm, As, Bs, y, y_ref
    torch.cuda.empty_cache()
    return out, bx


def phase_nesterov(torch, ou, n: int = 134_515_008, phase: str = "5c"):
    """[5c] nesterov over the full parameter count ``n`` (smollm-135m's; at
    12c paper-416m's): bitwise equal."""
    print(f"[{phase}] nesterov (replaces outer_update.py:_nesterov_kernel) over {n:,} fp32")
    gen = torch.Generator(device="cuda").manual_seed(13)
    theta, psi, u = (torch.randn(n, generator=gen, device="cuda") * s for s in (1.0, 1e-2, 1e-1))
    kw = dict(lr=0.7, momentum=0.9)
    got = ou._nesterov_cuda(theta, psi, u, **kw)
    want = ou._nesterov_plain(theta, psi, u, **kw)
    small = [ou._nesterov_cuda(theta[1:4099], psi[1:4099], u[1:4099], **kw),  # unaligned
             ou._nesterov_plain(theta[1:4099], psi[1:4099], u[1:4099], **kw),
             ou._nesterov_cuda(theta[:4099].bfloat16(), psi[:4099], u[:4099], **kw),
             ou._nesterov_plain(theta[:4099].bfloat16(), psi[:4099], u[:4099], **kw)]
    torch.cuda.synchronize()
    for (a, b), tag in [((got, want), "full, fp32"), ((small[0], small[1]), "unaligned, fp32"),
                        ((small[2], small[3]), "bf16 theta")]:
        assert all(torch.equal(x, y) for x, y in zip(a, b)), f"nesterov {tag}: not bitwise"
        print(f"  {tag}: theta' and u' bitwise equal to the plain version")
    del got, want, small
    ms = time_ms(torch, lambda: ou._nesterov_cuda(theta, psi, u, **kw))
    plain_ms = time_ms(torch, lambda: ou._nesterov_plain(theta, psi, u, **kw))
    out = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
               **bound(7.0 * n, 5.0 * 4 * n, PEAK_FP32_FLOPS))
    print(f"  timed: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}: {5 * 4 * n} B)")
    return out


def phase_train_agreement(torch, get_config, build_model, arch: str = "smollm-135m",
                          phase: str = "6a", n_layers: int | None = None, S: int = 256):
    """[6a] full width, fp32: loss and gradients pallas vs xla, then one Muon
    step through the kernel vs the plain fp32 Newton-Schulz (``n_layers``
    cuts the depth, never a width)."""
    print(f"[{phase}] full-width fp32 training agreement, {arch} (B=1, S={S})"
          + (f", depth cut to {n_layers} layers" if n_layers else ""))
    from repro_torch.kernels import ref
    from repro_torch.optim import OptimizerConfig, chain, descend, stateless, trace_momentum
    from repro_torch.optim.muon import muon, muon_mults, muon_partition
    from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_paths, tree_map,
                                       tree_map_with_path)

    base = get_config(arch).replace(dtype="float32", **({"n_layers": n_layers} if n_layers
                                                         else {}))
    dev = torch.device("cuda")
    model_k, model_p = build_model(base.replace(attn_impl="pallas")), build_model(base)
    params = model_k.init(torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.randint(0, base.vocab, (1, S + 1), generator=torch.Generator().manual_seed(6))
    batch = {"tokens": toks[:, :-1].to(dev, torch.int32), "labels": toks[:, 1:].to(dev, torch.int32)}
    paths = []
    tree_map_with_path(lambda p, _: paths.append(p), params)  # tree_leaves' order
    grads = {}
    for name, model in (("pallas", model_k), ("xla", model_p)):
        tree = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = model.loss(tree, batch)
        grads[name] = (loss.detach(), torch.autograd.grad(loss, tree_leaves(tree)))
    (lk, gk), (lp, gp) = grads["pallas"], grads["xla"]
    assert torch.isfinite(lk), lk
    check("loss", abs(lk.item() - lp.item()), 1e-4)
    worst = 0.0
    for path, a, b in zip(paths, gk, gp):
        # fp32 kernels vs plain: summation order, 1e-4 of each leaf's largest entry
        worst = max(worst, check(f"grad {path}", (a - b).abs().max().item(),
                                 1e-4 * max(1e-3, b.abs().max().item())))
    icfg = OptimizerConfig(lr=2e-2, weight_decay=1e-4)
    plain_ns = stateless(lambda u, _p: tree_map(lambda m: ref.ns_orthogonalize_ref(m).float(), u))
    plain_opt = descend(muon_partition(icfg, chain(trace_momentum(icfg), plain_ns)), icfg,
                        muon_mults(icfg))
    it = iter(gk)
    g_tree = tree_map(lambda _: next(it), params)
    new_k, _ = muon(icfg, ns_impl="pallas").step(params, g_tree, muon(icfg).init(params))
    new_p, _ = plain_opt.step(params, g_tree, plain_opt.init(params))
    err = max((a - b).abs().max().item() for (_, a), (_, b) in
              zip(tree_leaves_with_paths(new_k), tree_leaves_with_paths(new_p)))
    # the NS kernel differs from the plain fp32 NS by ~1e-6; the step scales it by lr
    check("one Muon step, kernel NS vs plain fp32 NS, every leaf", err, 1e-6)
    del params, grads, new_k, new_p
    torch.cuda.empty_cache()


def phase_train_main(torch, build_parser, train, argv: list = TRAIN, phase: str = "6b",
                     falls: bool = True,
                     kernels: tuple = ("flash_fwd", "flash_dq", "flash_dkv", "matmul_epilogue",
                                       "nesterov"), keep: bool = False):
    """[6b] the training main path through the CLI entry point, in-process;
    ``falls``: the train and eval losses must fall from the first round to
    the last; each of ``kernels`` must have launched; ``keep``: the run's
    read for phase 20 (:func:`round_read`) goes under ``out["read"]``."""
    from repro_torch.kernels import _build

    print(f"[{phase}] main path: repro_torch.launch.train " + " ".join(argv))
    args = build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    out = train(args)
    launches = _build.LaunchCounts(_build.LAUNCHES, _build.VARIANT_LAUNCHES)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    engine, state, hist = out["engine"], out["state"], out["history"]
    per_round = engine.launches_per_round(state["outer_params"])
    want = {k: args.rounds * v for k, v in per_round.items()}
    print(f"  launches {launches}")
    print(f"  formula  {want} (rounds x TrainEngine.launches_per_round)")
    assert launches == want, (launches, want)
    for name in kernels:
        assert launches[name] > 0, name
    check_captures(engine, per_round, args.rounds, [(True, False)])
    print(f"  round 1's wall {hist[0]['wall_s']:.3f} s holds the warm-up round (eager, kernel "
          f"build included) {engine.warmup_s[0]:.3f} s and the capture {engine.capture_s[0]:.3f} s")
    tokens = args.workers * args.sync_interval * args.batch_per_worker * args.seq_len
    for rec in hist:
        assert math.isfinite(rec["train_loss"]) and math.isfinite(rec["eval_loss"]), rec
        print(f"  round {rec['round']}: train {rec['train_loss']:.4f}, eval "
              f"{rec['eval_loss']:.4f}, wall {rec['wall_s']:.3f} s "
              f"({tokens / rec['wall_s']:.0f} tok/s)")
    if falls:
        assert hist[-1]["train_loss"] < hist[0]["train_loss"], "train loss did not fall"
        assert hist[-1]["eval_loss"] < hist[0]["eval_loss"], "eval loss did not fall"
    later = hist[1:]
    tok_s = len(later) * tokens / sum(r["wall_s"] for r in later)
    print(f"  training tokens/s over rounds 2-{len(hist)}: {tok_s:.1f} "
          f"({tokens} tokens per round = K*H*B*S; a round's wall is the time between "
          "the ends of two dispatches on the card's clock)")
    print(f"  peak device memory {peak_gb:.2f} GB; final smoothed eval loss "
          f"{out['final_loss']:.4f}")
    if keep:
        out["read"] = round_read(phase, out["model"].cfg, engine, state, hist,
                                 args.batch_per_worker, args.seq_len, peak_gb)
    out.update(tok_s=tok_s, peak_gb=peak_gb)
    return launches, out


def check_captures(engine, per_round: dict, rounds: int, keys: list) -> None:
    """A captured run's graphs: one capture for each (eval, masked) key in
    ``keys``, a warm-up round for each, replays for the rest, and every
    capture recorded one round's formula."""
    assert sorted(engine._graphs) == sorted(keys), sorted(engine._graphs)
    assert len(engine.warmup_s) == len(engine.capture_s) == len(keys), engine.capture_s
    assert engine.replays == rounds - len(keys), (engine.replays, rounds)
    for key, graph in engine._graphs.items():
        assert graph.launches == per_round, (key, graph.launches, per_round)
    print(f"  captured programs {sorted(engine._graphs)} ((eval, masked)): {len(keys)} "
          f"warm-up rounds + captures ({[round(s, 3) for s in engine.warmup_s]} s, "
          f"{[round(s, 3) for s in engine.capture_s]} s), {engine.replays} replays; each "
          "capture recorded one round's formula")


def profile_dispatch(torch, dispatch, tokens: int, note: str) -> dict:
    """Where a dispatch's time goes: ``dispatch(0)`` unprofiled (its wall on
    the host clock, ending in a device sync), then ``dispatch(1)`` under
    torch.profiler: device busy time, the idle share of the unprofiled wall,
    the kernel count, the kernels that take the time, and ``tokens`` over
    the unprofiled wall. Returns those numbers and the kernels' times."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    dispatch(0)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dispatch(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_times(torch, prof)
    busy = sum(v[0] for v in by_name.values())
    idle = 100 * (1 - busy / plain_wall_ms)
    tok_s = tokens / plain_wall_ms * 1e3
    print(f"  wall {plain_wall_ms:.1f} ms unprofiled ({wall_ms:.1f} ms profiled), device busy "
          f"{busy:.1f} ms: idle {idle:.1f}% of the unprofiled wall; "
          f"{sum(v[1] for v in by_name.values())} kernels; {tok_s:.1f} tokens/s unprofiled, "
          f"{note}")
    assert busy > 0, "the profiler saw no device time in the dispatch"
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"    {ms:9.3f} ms {100 * ms / plain_wall_ms:5.1f}%  x{n:<6d} {name}")
    return dict(wall_ms=plain_wall_ms, busy_ms=busy, idle=idle, tok_s=tok_s, by_name=by_name)


def phase_train_profile(torch, out, args_list, tag: str = "6c", focus: tuple = (),
                        beside: dict | None = None, rounds: int = 1,
                        participation: list | None = None) -> dict:
    """[6c] where a training round's time goes: one more dispatch of
    ``rounds`` rounds (replays of the captured round, with the eval loss,
    every round with the worker mask ``participation`` where given)
    unprofiled, then one under torch.profiler; the device time of the
    kernels whose names hold one of ``focus`` is summed apart, with its time
    per launch beside ``beside[key]`` (the phase and its ms per call) where
    given."""
    from repro_torch.data import DataConfig, MarkovStream, batches_for_span
    from repro_torch.launch.train import build_parser

    print(f"[{tag}] profile: one more dispatch of {rounds} captured training round(s) of the "
          "same run" + (f", worker mask {participation}" if participation else ""))
    args = build_parser().parse_args(args_list)
    engine, state, model = out["engine"], out["state"], out["model"]
    dcfg = dict(vocab=model.cfg.vocab, seq_len=args.seq_len,
                batch_per_worker=args.batch_per_worker)
    data = MarkovStream(DataConfig(**dcfg, n_workers=args.workers, seed=args.seed), "cuda")
    evals = MarkovStream(DataConfig(**dcfg, n_workers=1, seed=args.seed + 10_000), "cuda")
    replays = engine.replays

    def dispatch(i):
        nonlocal state
        r = args.rounds + i * rounds
        eb = {k: v[:, 0] for k, v in evals.batch_stack(r, rounds).items()}
        state, o = engine.superstep(state, batches_for_span(data, r, args.sync_interval, rounds),
                                    eb, participation=(None if participation is None
                                                       else [participation] * rounds))
        return float(o["loss"].mean())

    tokens = rounds * args.workers * args.sync_interval * args.batch_per_worker * args.seq_len
    prof = profile_dispatch(torch, dispatch, tokens, f"{rounds} round(s) a dispatch")
    out["state"] = state
    assert engine.replays == replays + 2 * rounds, "the profiled rounds were not replays"
    print_focus(prof["by_name"], prof["wall_ms"], focus, beside)
    return prof


def _leaf_diffs(torch, a: dict, b: dict) -> list:
    from repro_torch.utils.tree import tree_leaves_with_paths

    la, lb = tree_leaves_with_paths(a), tree_leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    return [(p, (x.double() - y.double()).abs().max().item())
            for (p, x), (_, y) in zip(la, lb) if not torch.equal(x, y)]


def phase_train_equal(torch, build_parser, train, ref_hist: list, ref_state: dict,
                      base: list = TRAIN, phase: str = "6d", with_r3: bool = True):
    """[6d] the main path's run (R = 1: round 1 eager as the warm-up, rounds
    2 and 3 replays of the captured round) against the same command with
    ``capture=False`` (every round eager) and, ``with_r3``, at
    ``--rounds-per-dispatch 3`` (one dispatch), from one TrainState (seed 0):
    losses, eval losses, comm_bytes and the final state, bitwise."""
    print(f"[{phase}] captured = eager" + (" and R = 3 = R = 1" if with_r3 else "")
          + ", bitwise, full width, from one TrainState")
    keys = ("train_loss", "train_loss_last", "eval_loss", "comm_bytes")
    variants = [("eager (capture=False)", [], False)]
    if with_r3:
        variants.append(("--rounds-per-dispatch 3", ["--rounds-per-dispatch", "3"], None))
    for tag, extra, capture in variants:
        argv = list(base) + extra
        argv[argv.index("--out") + 1] = str(ROOT / "build" / "chip_smoke_train_equal")
        out = train(build_parser().parse_args(argv), capture=capture)
        torch.cuda.synchronize()
        hist, tel = out["history"], out["telemetry"]
        for a, b in zip(ref_hist, hist):
            for k in keys:
                assert a[k] == b[k], (tag, a["round"], k, a[k], b[k])
        assert len(hist) == len(ref_hist)
        diffs = _leaf_diffs(torch, ref_state, out["state"])
        print(f"  {tag}: {tel['dispatches']} dispatch(es), {out['engine'].replays} replays; "
              f"{len(hist)} rounds' {', '.join(keys)} equal; state leaves that differ: {diffs}")
        assert not diffs, (tag, diffs)
        later = hist[1:]
        tokens = 65536 * len(later)
        print(f"    round walls {[round(r['wall_s'], 3) for r in hist]} s; tokens/s over "
              f"rounds 2-{len(hist)}: {tokens / sum(r['wall_s'] for r in later):.1f}"
              + (" (one dispatch: each wall is a third of it, warm-up and capture included)"
                 if capture is None else ""))
        if capture is None:
            assert tel["dispatches"] == 1 and tel["rounds_per_dispatch"] == 3, tel
            print(f"    warm-up round {out['engine'].warmup_s[0]:.3f} s, capture "
                  f"{out['engine'].capture_s[0]:.3f} s")
        del out
        torch.cuda.empty_cache()


def wire_shapes(params, J: int, rowwise: bool, K: int = 2) -> set:
    """The (rows, cols) of every quantize call one sync of the compressed
    runs makes: Q1 on the K-stacked (subset) leaf, Q2 on the reduced one."""
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.streaming import streaming_masks, subset_plan
    from repro_torch.core.wire import _row_layout
    from repro_torch.utils.tree import tree_leaves

    ccfg = CompressionConfig(kind="quant", bits=2, rowwise=rowwise)
    leaves = [tuple(p.shape) for p in tree_leaves(params)]
    encoded = []
    for mask in (streaming_masks(params, J) if J > 1 else [None]):
        masks = tree_leaves(mask) if mask is not None else [None] * len(leaves)
        for shape, m in zip(leaves, masks):
            plan, idx = subset_plan(m, shape, ccfg) if m is not None else ("all", None)
            if plan == "rows":
                encoded.append((len(idx), *shape[1:]))
            elif plan != "skip":
                encoded.append(shape)
    return ({_row_layout((K, *s), rowwise, 1) for s in encoded}
            | {_row_layout(s, rowwise, 0) for s in encoded})


# shapes at the edges of quantize's regimes (kernels/quantize.quantize_plan)
# and of its vector path, beside the compressed runs' own: (rows, cols,
# offset of x's first entry from an aligned address, in entries)
QUANT_EDGES = [
    (77, 1001, 0),      # a warp a row, cols % 4 != 0 (entry by entry), a constant row
    (9, 2048, 0),       # the longest row a warp holds, a ragged last block of rows
    (1, 7, 0),          # a single short row, entry by entry
    (13, 1536, 1),      # a warp a row, x not 16-byte aligned (entry by entry)
    (3, 2049, 0),       # the shortest row a block holds, cols % 4 != 0
    (5, 16384, 0),      # the longest row held on chip
    (3, 8192, 1),       # a block a row, x not aligned
    (2, 16385, 0),      # the shortest long row (read twice), cols % 4 != 0
    (1, 16388, 0),      # a single long row, the vector path
    (2, 1_000_000, 1),  # long rows, x not aligned
]


def phase_quantize(torch, q, params):
    """[8a] quantize (full and codes-only) and dequantize against their plain
    versions, bitwise, at the compressed runs' shapes and at the edges of
    quantize's regimes; the largest call of each layout timed in both forms."""
    print("[8a] quantize / dequantize (replace quantize.py:_rowwise_quant_kernel / "
          "_rowwise_dequant_kernel) against their plain versions, bitwise")
    from repro_torch.kernels import _build

    print("  quantize plan (longest row a warp holds, a block holds; blocks a long call, "
          f"least float4 groups a part): {_build.kernel_tiles('quantize')}")
    cases = sorted({(r, c, 0) for r, c in wire_shapes(params, 1, False)
                    | wire_shapes(params, 2, True)} | set(QUANT_EDGES))
    print(f"  {len(cases)} (rows, cols, offset) cases: "
          + ", ".join(f"{r}x{c}{'+' + str(o) if o else ''} {q.quantize_plan(r, c)[0]}"
                      for r, c, o in cases))
    c_plan = _build.load("quantize").quantize_plan
    c_plan.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)]
    c_plan.restype = ctypes.c_int
    for rows, cols, _ in cases:  # the wrapper sizes the scratch from its mirror of the plan
        parts = ctypes.c_longlong()
        code = c_plan(rows, cols, ctypes.byref(parts))
        assert code in (0, 1, 2), (rows, cols, code)
        got = (("warp", "block", "long")[code], parts.value)
        assert got == q.quantize_plan(rows, cols), (rows, cols, got)
    print("  the plan of csrc/quantize.cu == kernels/quantize.quantize_plan at every case")
    gen = torch.Generator(device="cuda").manual_seed(14)
    for rows, cols, offset in cases:
        # per-row magnitudes from 1e-4 to 10; the ragged shape holds a constant row
        mag = torch.exp(torch.empty((rows, 1), device="cuda").uniform_(
            math.log(1e-4), math.log(10.0), generator=gen))
        x = torch.empty(rows * cols + offset, device="cuda")[offset:].view(rows, cols)
        x.copy_(torch.randn((rows, cols), generator=gen, device="cuda") * mag)
        if rows == 77:
            x[3] = 0.375
        for bits in (1, 2, 4, 8):
            got = q._quantize_cuda(x, bits)
            # deq = null: a write through it would fault at the synchronize below
            codes_only = q.rowwise_quantize_codes(x, bits)
            want = q.rowwise_quantize_plain(x, bits)
            qv, lo, scale = q.quant_codes_plain(x, bits)
            vals = q._dequantize_cuda(got[1], got[2], got[3])
            vals_plain = q.rowwise_dequantize_plain(got[1], got[2], got[3])
            torch.cuda.synchronize()
            for name, a, b in zip(("deq", "codes", "lo", "scale", "values", "codes-only codes",
                                   "codes-only lo", "codes-only scale"),
                                  (*got, vals, *codes_only),
                                  (*want, vals_plain, qv.to(torch.uint8), lo, scale)):
                assert torch.equal(a, b), \
                    f"quantize [{rows}, {cols}] +{offset} bits {bits}: {name} differs"
        if rows == 77:
            assert float(got[3][3]) == 1.0 and not got[1][3].any(), "constant row"
        del x, got, codes_only, want, qv, lo, scale, vals, vals_plain
    print(f"  all {len(cases)} cases x bits 1, 2, 4, 8: deq, codes, lo, scale, the "
          "dequantized values and the codes-only launch's codes, lo and scale bitwise equal")
    out = {}
    for tag, rows, cols, bits in (("global Q1 of embed", 2, 28_311_552, 2),
                                  ("row-wise Q1 of w_in", 34_560, 1536, 4)):
        x = torch.randn((rows, cols), generator=gen, device="cuda")
        n = rows * cols
        regime, parts = q.quantize_plan(rows, cols)
        plain_ms = time_ms(torch, lambda: q.rowwise_quantize_plain(x, bits), runs=5)
        for form, fn, once, twice in (
                ("full", lambda: q._quantize_cuda(x, bits), 9, 13),
                ("codes-only", lambda: q._quantize_cuda(x, bits, with_deq=False), 5, 9)):
            ms = time_ms(torch, fn)
            b = bound(6.0 * n, once * n + 8.0 * rows, PEAK_FP32_FLOPS)
            floor = (twice * n + 8.0 * rows) / HBM_BW * 1e3
            print(f"  timed quantize {form}, {tag} [{rows}, {cols}] {bits}-bit ({regime}, "
                  f"{parts} parts a row): kernel {ms:.4f} ms, plain (full) {plain_ms:.4f} ms, "
                  f"bound read once {b['bound_ms']:.4f} ms ({b['bound_by']}: "
                  f"{once * n + 8 * rows} B, {b['bound_ms'] / ms:.2f} of it), read twice "
                  f"{floor:.4f} ms ({twice * n + 8 * rows} B, {floor / ms:.2f} of it)")
            if "quantize" not in out:  # the summary row: the global full-function call
                out["quantize"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                       library_ms=None, **b)
        _, codes, lo, scale = q._quantize_cuda(x, bits)
        ms = time_ms(torch, lambda: q._dequantize_cuda(codes, lo, scale))
        plain_ms = time_ms(torch, lambda: q.rowwise_dequantize_plain(codes, lo, scale), runs=5)
        library_ms = time_ms(torch, lambda: torch.addcmul(lo, codes, scale))
        b = bound(2.0 * n, 5.0 * n + 8.0 * rows, PEAK_FP32_FLOPS)
        print(f"  timed dequantize, {tag} [{rows}, {cols}]: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, torch.addcmul {library_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {5 * n + 8 * rows} B)")
        out["dequantize"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                 library_ms=library_ms, **b)
        del x, codes, lo, scale
    torch.cuda.empty_cache()
    return out


def phase_wire_agreement(torch, get_config, build_model):
    """[8b] one full-width outer sync, wire_impl 'pallas' (the kernels) vs
    'jnp' (plain torch), from one set of deltas: bitwise."""
    print("[8b] full-width outer sync with EF: wire_impl pallas (kernels) vs jnp (plain torch)")
    from repro_torch.core import CompressionConfig, DiLoCoConfig, make_outer, outer_step
    from repro_torch.core.streaming import streaming_masks
    from repro_torch.engine import train_state
    from repro_torch.utils.tree import tree_leaves_with_paths, tree_map

    dev = torch.device("cuda")
    params = build_model(get_config("smollm-135m")).init(
        torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(15)

    def noise(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    K = 2
    base = dict(outer_params=params,
                outer_opt={"u": tree_map(lambda p: noise(p.shape, 1e-3), params)},
                worker_params=tree_map(lambda p: p[None] + noise((K, *p.shape), 1e-3), params),
                inner_state={}, round=torch.zeros((), dtype=torch.int32, device=dev),
                ef=tree_map(lambda p: noise((K, *p.shape), 1e-4), params))
    for tag, ckw, J in (("global 2-bit", dict(bits=2), 1),
                        ("row-wise 4-bit, streaming segment 0 of 2", dict(bits=4, rowwise=True), 2)):
        mask = streaming_masks(params, J)[0] if J > 1 else None
        got = {}
        for impl in ("pallas", "jnp"):
            dcfg = DiLoCoConfig(n_workers=K, compression=CompressionConfig(
                kind="quant", error_feedback=True, wire_impl=impl, **ckw),
                streaming_partitions=J, outer_kernel=True)
            state = train_state(**tree_map(torch.clone, base))
            state, psi = outer_step(dcfg, state, mask=mask, outer=make_outer(dcfg))
            got[impl] = (psi, state["ef"], state["outer_params"])
        torch.cuda.synchronize()
        for name, a, b in zip(("psi", "ef", "theta'"), got["pallas"], got["jnp"]):
            for (path, x), (_, y) in zip(tree_leaves_with_paths(a), tree_leaves_with_paths(b)):
                assert torch.equal(x, y), f"{tag}: {name} {path} differs, pallas vs jnp"
        print(f"  {tag}: psi, ef and theta' bitwise equal over all 11 leaves")
        del got, state, psi
    del params, base
    torch.cuda.empty_cache()


def phase_compressed_run(torch, build_parser, train, tag: str, extra: list, rounds: int,
                         comm: int, falls: bool, profile: str = ""):
    """[8c] / [8d] a compressed run in-process through the CLI entry point;
    ``profile`` names a phase that profiles one more round."""
    from repro_torch.kernels import _build

    argv = [a for a in TRAIN] + extra
    argv[argv.index("--rounds") + 1] = str(rounds)
    argv[argv.index("--out") + 1] = str(ROOT / "build" / f"chip_smoke_train_{tag}")
    print(f"[8{'c' if tag == 'a' else 'd'}] run ({tag}): repro_torch.launch.train " + " ".join(argv))
    args = build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    out = train(args)
    launches = _build.LaunchCounts(_build.LAUNCHES, _build.VARIANT_LAUNCHES)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    engine, state, hist = out["engine"], out["state"], out["history"]
    want = {k: rounds * v for k, v in engine.launches_per_round(state["outer_params"]).items()}
    print(f"  launches {launches}")
    print(f"  formula  {want} (rounds x TrainEngine.launches_per_round)")
    assert launches == want, (launches, want)
    for name in ("flash_fwd", "flash_dq", "flash_dkv", "matmul_epilogue", "nesterov",
                 "quantize", "dequantize"):
        assert launches[name] > 0, name
    check_captures(engine, engine.launches_per_round(state["outer_params"]), rounds,
                   [(True, False)])
    tokens = args.workers * args.sync_interval * args.batch_per_worker * args.seq_len
    for rec in hist:
        assert math.isfinite(rec["train_loss"]) and math.isfinite(rec["eval_loss"]), rec
        assert rec["comm_bytes"] == comm, (rec["comm_bytes"], comm)
        print(f"  round {rec['round']}: train {rec['train_loss']:.4f}, eval "
              f"{rec['eval_loss']:.4f}, comm_bytes {rec['comm_bytes']:.0f}, wall "
              f"{rec['wall_s']:.3f} s ({tokens / rec['wall_s']:.0f} tok/s)")
    if falls:
        assert hist[-1]["train_loss"] < hist[0]["train_loss"], "train loss did not fall"
        assert hist[-1]["eval_loss"] < hist[0]["eval_loss"], "eval loss did not fall"
    later = hist[1:]
    tok_s = len(later) * tokens / sum(r["wall_s"] for r in later)
    print(f"  training tokens/s over rounds 2-{len(hist)}: {tok_s:.1f}; comm_bytes per round "
          f"{comm} (dense: 1,076,120,064); peak device memory {peak_gb:.2f} GB")
    if profile:  # the quantize kernels (csrc/quantize.cu) against the round
        phase_train_profile(torch, out, argv, tag=profile,
                            focus=("quantize_rows_kernel", "quantize_minmax_kernel",
                                   "quantize_encode_kernel", "decode_kernel"))
    del out, engine, state
    torch.cuda.empty_cache()
    return launches



def _rows_sans_wall(path: Path) -> list:
    import csv

    with open(path, newline="") as f:
        return [row[:-1] for row in csv.reader(f)]


def phase_crash_drill(torch, build_parser, train):
    """[8e] crash drills on the card, at --reduced widths (``DRILL``): SIGKILL
    at round 2 in a subprocess, then ``--resume auto`` in a new subprocess,
    a cold restart (the restored state is warmed up and captured anew);
    metrics.csv, less wall_s, must equal an uninterrupted run's (in this
    process, while the killed run starts) byte for byte. Then a NaN injected
    at round 2 with the health sentinel on (in this process, while the
    resumed run starts): the rollback copies the checkpoint into the
    captured round's tensors and the run completes on replays."""
    import contextlib
    import io
    import shutil

    print("[8e] crash drill: repro_torch.launch.train " + " ".join(DRILL))
    root = ROOT / "build" / "chip_smoke_drill"
    shutil.rmtree(root, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def start(extra: list, out: Path):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *DRILL, *extra, "--out", str(out)]
        return (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env, cwd=ROOT), time.perf_counter(), " ".join(extra))

    def finish(run) -> tuple[int, str, str]:
        proc, t0, what = run
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        print(f"  {what}, a subprocess: exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s")
        return proc.returncode, stdout, stderr

    killed = start(["--inject-kill-round", "2"], root / "crash")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train(build_parser().parse_args([*DRILL, "--out", str(root / "ref")]))
    print(f"  (uninterrupted), in this process: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    rc, _, err = finish(killed)
    assert rc == -9, (rc, err[-3000:])
    assert (root / "crash" / "ckpt_2.npz").exists() and not (root / "crash" / "ckpt_3.npz").exists()
    resumed = start(["--resume", "auto"], root / "crash")
    argv = DRILL + ["--health-sentinel", "on", "--health-warmup", "1", "--inject-nan-round", "2",
                    "--out", str(root / "nan")]
    out = train(build_parser().parse_args(argv))
    tel, hist, engine = out["telemetry"], out["history"], out["engine"]
    assert tel["rollbacks"] == 1 and tel["skipped_rounds"] == 1, tel
    assert [r["round"] for r in hist] == [0, 1, 3], hist
    assert all(math.isfinite(r["train_loss"]) and r["health"] == 0 for r in hist), hist
    assert len(engine.capture_s) == 1 and engine.replays >= 3, (engine.capture_s, engine.replays)
    print(f"  NaN at round 2: flagged, rolled back to ckpt_2 inside the captured program "
          f"(1 capture, {engine.replays} replays), round 2 skipped, rounds "
          f"{[r['round'] for r in hist]} finite")
    del out, engine
    torch.cuda.empty_cache()
    rc, stdout, err = finish(resumed)
    assert rc == 0, (rc, err[-3000:])
    assert "resume telemetry: resumed_from=ckpt_2.npz start_round=2" in stdout, stdout[-3000:]
    got, want = _rows_sans_wall(root / "crash" / "metrics.csv"), _rows_sans_wall(root / "ref" / "metrics.csv")
    assert got == want, (got, want)
    print(f"  SIGKILL at round 2 + --resume auto: metrics.csv rows equal the uninterrupted "
          f"run's, less wall_s ({len(got) - 1} rounds)")


class RoundSpy:
    """Watches one ``train()`` run's dispatches (one round each, R = 1):
    ``before(r, state)`` / ``after(r, state)`` run around the dispatch of
    round r. What they clone and compare runs on the card between
    dispatches, so it lands in the run's round walls; the phases read the
    rate off a profiled dispatch instead."""

    def __init__(self, before=None, after=None):
        self.before, self.after = before, after

    def __enter__(self):
        from repro_torch.engine import TrainEngine

        self._orig = orig = TrainEngine.superstep
        spy, count = self, [0]

        def superstep(engine, state, batches, *a, **kw):
            r = count[0]
            count[0] += batches["tokens"].shape[0]
            if spy.before:
                spy.before(r, state)
            state, out = orig(engine, state, batches, *a, **kw)
            if spy.after:
                spy.after(r, state)
            return state, out

        TrainEngine.superstep = superstep
        return self

    def __exit__(self, *exc):
        from repro_torch.engine import TrainEngine

        TrainEngine.superstep = self._orig


def _worker_slices(torch, state: dict, k: int, fields: tuple) -> dict:
    from repro_torch.utils.tree import tree_map

    return {f: tree_map(lambda t: t[k].clone(), state[f]) for f in fields}


def masked_replay_check(torch, out, args, fields: tuple, phase: str) -> None:
    """The masked graph replayed and checked: round 1's drop is the masked
    program's first use, so it ran eagerly (the warm-up). One more round of
    the same run with the other worker out, mask [0, 1] (the capture saw
    [1, 0]), replays the graph; worker 0's ``fields`` keep every bit and
    worker 1's move, and the same round run eagerly from a copy of the
    state gives the same metrics and state, bitwise."""
    from repro_torch.data import DataConfig, MarkovStream, batches_for_span
    from repro_torch.utils.tree import tree_map

    engine, state, model = out["engine"], out["state"], out["model"]
    dcfg = dict(vocab=model.cfg.vocab, seq_len=args.seq_len,
                batch_per_worker=args.batch_per_worker)
    data = MarkovStream(DataConfig(**dcfg, n_workers=args.workers, seed=args.seed), "cuda")
    evals = MarkovStream(DataConfig(**dcfg, n_workers=1, seed=args.seed + 10_000), "cuda")
    r, mask = args.rounds, [[0.0, 1.0]]
    batches = batches_for_span(data, r, args.sync_interval, 1)
    eb = {k: v[:, 0] for k, v in evals.batch_stack(r, 1).items()}
    copy = tree_map(lambda t: t.detach().clone(), state)
    w0, w1 = (_worker_slices(torch, state, k, fields) for k in (0, 1))
    replays = engine.replays
    state, o = engine.superstep(state, batches, eb, participation=mask)
    torch.cuda.synchronize()
    assert engine.replays == replays + 1, "the masked round was not a replay"
    diffs = _leaf_diffs(torch, w0, _worker_slices(torch, state, 0, fields))
    assert not diffs, f"worker 0 (dropped) moved in the replayed masked round: {diffs}"
    assert _leaf_diffs(torch, w1, _worker_slices(torch, state, 1, fields)), "worker 1 froze"
    was, engine.capture = engine.capture, False
    try:
        eager, oe = engine.superstep(copy, batches, eb, participation=mask)
    finally:
        engine.capture = was
    torch.cuda.synchronize()
    assert engine.replays == replays + 1
    for k in ("loss", "comm_bytes", "active_workers", "staleness", "eval_loss"):
        assert torch.equal(o[k], oe[k]), (k, o[k], oe[k])
    diffs = _leaf_diffs(torch, state, eager)
    assert not diffs, f"replayed masked round != eager: {diffs}"
    assert float(o["active_workers"][0]) == 1.0
    out["state"] = state
    print(f"  [{phase}] masked graph replayed with mask [0, 1] (captured under [1, 0]): "
          f"worker 0's {' and '.join(fields)} bit-identical, worker 1's moved; loss, "
          "comm_bytes, active_workers, eval loss and every state leaf bitwise the same round "
          "eager")
    del copy, eager, w0, w1


def phase_elastic(torch, build_parser, train, tag: str, ref_hist: list) -> dict:
    """[9a]-[9c] elastic MuLoCo through the CLI entry point: the training
    command plus ``ELASTIC[tag]``, captured, then (i, ii) eager, bitwise.
    Returns the run's rate, idle share and peak memory."""
    from repro_torch.core import inner_step
    from repro_torch.kernels import _build
    from repro_torch.utils.tree import tree_map

    phase = {"i": "9a", "ii": "9b", "iii": "9c"}[tag]
    argv = list(TRAIN) + ELASTIC[tag]
    argv[argv.index("--out") + 1] = str(ROOT / "build" / f"chip_smoke_elastic_{tag}")
    print(f"[{phase}] elastic run ({tag}): repro_torch.launch.train " + " ".join(argv))
    args = build_parser().parse_args(argv)
    drops, delay = "--drop-schedule" in argv, "--sync-delay" in argv
    fields = ("inner_state",) + (("ef",) if "--error-feedback" in argv else ())
    seen: dict = {}

    def before(r, state):
        if drops and r == 1:  # worker 1 drops in round 1
            seen["frozen"] = _worker_slices(torch, state, 1, fields)
        if delay and r == 0:
            seen["init"] = tree_map(torch.clone, state["outer_params"])

    def after(r, state):
        if drops and r == 1:
            now = _worker_slices(torch, state, 1, fields)
            diffs = _leaf_diffs(torch, seen.pop("frozen"), now)
            assert not diffs, f"dropped worker 1's {fields} moved in round 1: {diffs}"
            print(f"  worker 1's {' and '.join(fields)} bit-identical across round 1 (dropped)")
        if delay and r == 0:
            diffs = _leaf_diffs(torch, seen.pop("init"), state["outer_params"])
            assert not diffs, f"round 0 moved the outer params under --sync-delay 1: {diffs}"
            print("  round 0's outer params equal the init bitwise (the FIFO's zero Psi)")

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with RoundSpy(before, after):
        out = train(args)
    launches = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    engine, state, hist = out["engine"], out["state"], out["history"]
    per_round = engine.launches_per_round(state["outer_params"])
    want = {k: args.rounds * v for k, v in per_round.items()}
    print(f"  launches {launches}")
    print(f"  formula  {want} (rounds x TrainEngine.launches_per_round; the masked program "
          "runs every worker's step and selects)")
    assert launches == want, (launches, want)
    kernels = ["flash_fwd", "flash_dq", "flash_dkv", "matmul_epilogue", "nesterov"]
    for name in kernels + (["quantize", "dequantize"] if tag == "iii" else []):
        assert launches[name] > 0, name
    check_captures(engine, per_round, args.rounds,
                   [(True, False), (True, True)] if drops else [(True, False)])
    active = [r["active_workers"] for r in hist]
    assert active == ([2.0, 1.0, 2.0] if drops else [2.0, 2.0, 2.0]), active
    assert all(r["staleness"] == (1.0 if delay else 0.0) for r in hist), hist
    for rec in hist:
        assert math.isfinite(rec["train_loss"]) and math.isfinite(rec["eval_loss"]), rec
        print(f"  round {rec['round']}: train {rec['train_loss']:.4f}, eval "
              f"{rec['eval_loss']:.4f}, active {rec['active_workers']:.0f}, staleness "
              f"{rec['staleness']:.0f}, comm_bytes {rec['comm_bytes']:.0f}, wall "
              f"{rec['wall_s']:.3f} s")
    if tag == "iii":
        comm = [r["comm_bytes"] for r in hist]
        c = COMM_BYTES["a"]
        assert comm == [c, c / 2, c], comm
        print(f"  comm_bytes {comm}: {c} in rounds 0 and 2, half of it with one of two "
              "workers in round 1")
    if tag == "i":
        keys = ("train_loss", "train_loss_last", "eval_loss", "comm_bytes")
        assert all(hist[0][k] == ref_hist[0][k] for k in keys), (hist[0], ref_hist[0])
        print(f"  round 0 ({', '.join(keys)}) bitwise equal to 6b's round 0 (every worker "
              "present: the dense program)")
    if tag in ("i", "ii"):
        ref_state = tree_map(lambda t: t.detach().clone(), state)
        argv_e = list(argv)
        argv_e[argv_e.index("--out") + 1] += "_eager"
        eager = train(build_parser().parse_args(argv_e), capture=False)
        torch.cuda.synchronize()
        keys = ("train_loss", "train_loss_last", "eval_loss", "comm_bytes", "active_workers",
                "staleness")
        assert len(eager["history"]) == len(hist)
        for a, b in zip(hist, eager["history"]):
            for k in keys:
                assert a[k] == b[k], (tag, a["round"], k, a[k], b[k])
        diffs = _leaf_diffs(torch, ref_state, eager["state"])
        assert not diffs, (tag, diffs)
        print(f"  captured = eager (capture=False), bitwise: {len(hist)} rounds' "
              f"{', '.join(keys)} and every state leaf")
        del eager, ref_state
        torch.cuda.empty_cache()
    if tag == "i":  # a dropped worker's params through a masked step, on the card
        probe = tree_map(torch.clone, {f: state[f] for f in ("worker_params", "inner_state")})
        w1 = _worker_slices(torch, probe, 1, ("worker_params", "inner_state"))
        w0 = tree_map(torch.clone, probe["worker_params"]["embed"][0])
        from repro_torch.data import DataConfig, MarkovStream

        batch = MarkovStream(DataConfig(vocab=engine.model.cfg.vocab, seq_len=args.seq_len,
                                        batch_per_worker=args.batch_per_worker, n_workers=2,
                                        seed=5), "cuda").batch_stack(0, 1)
        batch = {k: v[0] for k, v in batch.items()}
        inner_step(engine.model, engine.opt, probe, batch,
                   participation=torch.tensor([1.0, 0.0], device="cuda"))
        diffs = _leaf_diffs(torch, w1, _worker_slices(torch, probe, 1, ("worker_params",
                                                                         "inner_state")))
        assert not diffs, diffs
        assert not torch.equal(w0, probe["worker_params"]["embed"][0]), "worker 0 did not move"
        print("  a masked inner step on the card (worker 1 out): worker 1's params and inner "
              "state keep every bit, worker 0's move")
        del probe, w1, w0
    if drops:
        masked_replay_check(torch, out, args, fields, phase)
    prof = phase_train_profile(torch, out, argv, tag=f"{phase}'",
                               participation=[1.0, 0.0] if drops else None)
    print(f"  elastic ({tag}): {prof['tok_s']:.1f} tokens/s (a dispatch of one replayed "
          f"{'masked ' if drops else ''}round), idle {prof['idle']:.1f}%, peak device memory "
          f"{peak_gb:.2f} GB of the run")
    del out, engine, state
    torch.cuda.empty_cache()
    return dict(tok_s=prof["tok_s"], idle=prof["idle"], peak_gb=peak_gb)


def phase_dp(torch, get_config, build_model, inner: str) -> dict:
    """[10a] / [10b] the data-parallel baseline (``dp_engine``, K = 1,
    H = 1) at full width, driven by ``run_rounds``: ``DP['steps']`` steps of
    ``DP['batch']`` x 1024 tokens, one captured one-step round replayed;
    then eager and at R = 4, bitwise; then a profiled dispatch of 4 steps."""
    from repro_torch.data import DataConfig, MarkovStream, batches_for_round, batches_for_span
    from repro_torch.engine import dp_engine, run_rounds
    from repro_torch.kernels import _build
    from repro_torch.optim import OptimizerConfig
    from repro_torch.utils.tree import tree_map

    phase = {"muon": "10a", "adamw": "10b"}[inner]
    n, B, S = DP["steps"], DP["batch"], DP["seq_len"]
    print(f"[{phase}] {inner} DP: dp_engine(model, {inner!r}, icfg) by "
          f"run_rounds, {n} steps of {B} x {S} tokens, smollm-135m full width")
    cfg = get_config("smollm-135m").replace(max_seq_len=S, attn_impl="pallas")
    model = build_model(cfg)
    icfg = OptimizerConfig(lr=DP["lr"], weight_decay=1e-4, schedule="cosine",
                           warmup_steps=max(n // 100, 5), total_steps=n)
    data = MarkovStream(DataConfig(vocab=cfg.vocab, seq_len=S, batch_per_worker=B,
                                   n_workers=1, seed=0), "cuda")

    def run(R, capture=None):
        engine = dp_engine(model, inner, icfg, capture=capture)
        state = engine.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        tel: dict = {}
        state, hist = run_rounds(engine, state, lambda r: batches_for_round(data, r, 1), n,
                                 rounds_per_dispatch=R, telemetry=tel,
                                 span_batches_for=lambda r0, m: batches_for_span(data, r0, 1, m))
        torch.cuda.synchronize()
        return engine, state, hist, tel

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    engine, state, hist, tel = run(1)
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = engine.launches_per_round(state["outer_params"], with_eval=False)
    want = {k: n * v for k, v in per_step.items()}
    print(f"  launches {launches}; per step {per_step}")
    assert launches == want, (launches, want)
    L = cfg.n_layers  # full width: flash_fwd 60 (twice a layer, remat), dq and dkv 30
    expect = {"flash_fwd": (2 if cfg.remat else 1) * L, "flash_dq": L, "flash_dkv": L,
              "matmul_epilogue": 105 if inner == "muon" else 0, "nesterov": 0}
    assert {k: per_step[k] for k in expect} == expect, per_step
    check_captures(engine, per_step, n, [(False, False)])
    losses = [r["train_loss"] for r in hist]
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], f"{inner} DP loss did not fall: {losses}"
    assert all(r["comm_bytes"] == 0 and r["active_workers"] == 1 for r in hist), hist
    tokens = B * S
    later = hist[1:]
    tok_s = len(later) * tokens / sum(r["wall_s"] for r in later)
    print(f"  losses {[round(v, 4) for v in losses]}; steps 2-{n}: {tok_s:.1f} tokens/s "
          f"({tokens} tokens a step; walls between dispatch ends on the card's clock); "
          f"peak device memory {peak_gb:.2f} GB")
    ref = (tree_map(lambda t: t.detach().clone(), state), hist)
    del engine, state
    keys = ("train_loss", "train_loss_last", "comm_bytes", "active_workers")
    for label, R, capture in (("eager (capture=False)", 1, False), ("R = 4", 4, None)):
        engine, state, h, t = run(R, capture)
        for a, b in zip(ref[1], h):
            for k in keys:
                assert a[k] == b[k], (label, a["round"], k, a[k], b[k])
        diffs = _leaf_diffs(torch, ref[0], state)
        assert not diffs and len(h) == n, (label, diffs)
        walls = [r["wall_s"] for r in h[1:]]
        print(f"  {label}: {t['dispatches']} dispatches, {engine.replays} replays, bitwise "
              f"equal (records and state); {(n - 1) * tokens / sum(walls):.1f} tokens/s over "
              f"steps 2-{n}")
        if R == 4:
            def dispatch(i):
                nonlocal state
                r = n + 4 * i
                state, _ = engine.superstep(state, batches_for_span(data, r, 1, 4))

            replays = engine.replays
            prof = profile_dispatch(torch, dispatch, 4 * tokens, "4 steps a dispatch (R = 4)")
            assert engine.replays == replays + 8, "the profiled steps were not replays"
        del engine, state
        torch.cuda.empty_cache()
    print(f"  {inner} DP: {prof['tok_s']:.1f} tokens/s (a dispatch of 4 replayed steps), "
          f"idle {prof['idle']:.1f}%, peak device memory {peak_gb:.2f} GB")
    del ref, model
    torch.cuda.empty_cache()
    return dict(tok_s=prof["tok_s"], idle=prof["idle"], peak_gb=peak_gb, launches=launches)


def phase_blockwise(torch, get_config):
    """[10c] one full-width attention layer with attn_impl='xla' at S =
    blockwise_threshold (the blockwise online softmax, plain torch) against
    attn_impl='pallas' (flash_fwd's fp32 sweep), batch 1, fp32."""
    from repro_torch.models import attention

    cfg = get_config("smollm-135m").replace(dtype="float32")
    S = cfg.blockwise_threshold
    print(f"[10c] blockwise attention: one full-width layer, attn_impl xla at S = {S} "
          f"(blocks {cfg.attn_block_q} x {cfg.attn_block_kv}) vs pallas (flash_fwd, fp32)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    p = attention.init_attention(gen, cfg, dev)
    x = torch.randn((1, S, cfg.d_model), generator=gen, device=dev)
    pos = torch.arange(S, device=dev, dtype=torch.int32)
    xla, pallas = cfg.replace(attn_impl="xla"), cfg.replace(attn_impl="pallas")
    with torch.no_grad():
        ob = attention.attend(p, xla, x, pos)
        of = attention.attend(p, pallas, x, pos)
        assert torch.isfinite(ob).all() and ob.shape == (1, S, cfg.d_model)
        scale = of.abs().max().item()
        # two fp32 online softmaxes over other blocks: ~1e-6 of the output's scale
        err = check("blockwise vs flash_fwd (fp32), whole layer output",
                    (ob - of).abs().max().item(), 1e-5 * max(scale, 1.0))
        ms_b = time_ms(torch, lambda: attention.attend(p, xla, x, pos), runs=5)
        ms_f = time_ms(torch, lambda: attention.attend(p, pallas, x, pos), runs=5)
    print(f"  layer output max |o| {scale:.3f}; timed layer: blockwise (plain torch) "
          f"{ms_b:.3f} ms, flash_fwd path {ms_f:.3f} ms")
    del p, x, ob, of
    torch.cuda.empty_cache()
    return err


def slice_4b(torch, get_config, build_model, build_parser, train, ref_hist: list,
             smi: str) -> None:
    """Phases 9 and 10 (elastic MuLoCo, the DP baselines, blockwise
    attention), then each path's rate, idle share and peak memory beside the
    card's name and power limit."""
    elastic = {}
    for tag in ("i", "ii", "iii"):
        elastic[tag] = phase_elastic(torch, build_parser, train, tag, ref_hist)
        lap({"i": "9a", "ii": "9b", "iii": "9c"}[tag])
    dp = {}
    for inner in ("muon", "adamw"):
        dp[inner] = phase_dp(torch, get_config, build_model, inner)
        lap({"muon": "10a", "adamw": "10b"}[inner])
    phase_blockwise(torch, get_config)
    lap("10c")
    smi_line = f"card (nvidia-smi name, power.limit): {smi}"
    for tag, r in elastic.items():
        print(f"elastic MuLoCo ({tag}) {' '.join(ELASTIC[tag])}: {r['tok_s']:.1f} tokens/s, "
              f"idle {r['idle']:.1f}%, peak {r['peak_gb']:.2f} GB; {smi_line}")
    for inner, r in dp.items():
        print(f"{inner} DP ({DP['batch']} x {DP['seq_len']} tokens a step): {r['tok_s']:.1f} "
              f"tokens/s, idle {r['idle']:.1f}%, peak {r['peak_gb']:.2f} GB; launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }; {smi_line}")


def slice_6a(torch, mods: dict, get_config, build_model, build_parser, train, serve,
             smi: str) -> dict:
    """Phases 12a-12e: the paper's Gemma3-style ladder on the card, at its
    rung paper-416m (head dim 128, MHA, QK-norm, post-norms, untied head,
    vocab 128256). Returns each kernel's row for the summary."""
    fa, mm, ops, ref, ou = (mods[k] for k in ("fa", "mm", "ops", "ref", "ou"))
    cfg = get_config(LADDER)
    flash = phase_flash(torch, fa, hd=128, phase="12a")
    bwd = phase_flash_bwd(torch, fa, hd=128, phase="12a")
    paged = phase_paged(torch, fa, hd=128, KV=cfg.n_kv_heads, G=cfg.n_heads // cfg.n_kv_heads,
                        phase="12a")
    lap("12a")
    matmul, matmul_bx = phase_matmul_ladder(torch, mm, ops, ref)
    n_params = param_count(cfg)
    nesterov = phase_nesterov(torch, ou, n_params, phase="12b")
    torch.cuda.empty_cache()
    lap("12b")
    phase_agreement(torch, get_config, build_model, LADDER, "12c")
    phase_train_agreement(torch, get_config, build_model, LADDER, "12c")
    lap("12c")

    train_launches, out = phase_train_main(torch, build_parser, train, TRAIN_LADDER, "12d",
                                           keep=True)
    from repro_torch.utils.tree import tree_map

    ref_hist = out["history"]
    ref_state = tree_map(lambda t: t.detach().clone(), out["state"])
    prof = phase_train_profile(
        torch, out, TRAIN_LADDER, tag="12d'",
        focus=("flash_fwd_wgmma_kernel<128>", "flash_dq_wgmma_kernel<128>",
               "flash_dkv_wgmma_kernel<128>", "matmul_epilogue_kernel", "nesterov",
               "softmax", "nvjet", "gemm"),
        beside={"flash_fwd_wgmma_kernel<128>": ("12a", flash["training"]["ms"]),
                "flash_dq_wgmma_kernel<128>": ("12a", bwd["flash_dq"]["ms"]),
                "flash_dkv_wgmma_kernel<128>": ("12a", bwd["flash_dkv"]["ms"]),
                "matmul_epilogue_kernel": ("12b (X X^T on w_in, symmetric)", matmul["ms"])})
    rate, peak, train_read = out["tok_s"], out["peak_gb"], out["read"]
    del out
    torch.cuda.empty_cache()
    phase_train_equal(torch, build_parser, train, ref_hist, ref_state, base=TRAIN_LADDER,
                      phase="12d''", with_r3=False)
    # phase 21e's run with autotune on (the default)
    autotune_ref = (ref_hist, tree_map(lambda t: t.to("cpu", copy=True), ref_state),
                    train_launches.variants)
    del ref_state
    torch.cuda.empty_cache()
    lap("12d")
    serve_launches, engine = phase_main(torch, fa, get_config, serve, LADDER, "12e")
    serve_prof = phase_profile(torch, engine, paged["ms"], phase="12e'")
    serve_rate, replay_rate, capture_s = engine.tok_s, engine.replay_tok_s, engine.capture_s
    del engine
    torch.cuda.empty_cache()
    lap("12e")
    print(f"{LADDER} training ({' '.join(TRAIN_LADDER[:TRAIN_LADDER.index('--out')])}): "
          f"{rate:.1f} tokens/s over rounds 2-3, one replayed round {prof['tok_s']:.1f} tokens/s "
          f"at idle {prof['idle']:.1f}%, peak {peak:.2f} GB; serving (captured spans) "
          f"{serve_rate:.1f} tok/s (capture {capture_s:.3f} s apart), replays only "
          f"{replay_rate:.1f} tok/s, idle {serve_prof['idle']:.1f}%, launches flash_fwd "
          f"{serve_launches['flash_fwd']}, paged_decode {serve_launches['paged_decode']}; "
          f"card (nvidia-smi name, power.limit): {smi}")
    return {
        "flash_fwd": {"launches": {"serving": serve_launches["flash_fwd"],
                                   "training": train_launches["flash_fwd"]},
                      "serving": flash["serving"], "training": flash["training"]},
        "paged_decode": {"launches": serve_launches["paged_decode"], **paged},
        "flash_dq": {"launches": train_launches["flash_dq"], **bwd["flash_dq"]},
        "flash_dkv": {"launches": train_launches["flash_dkv"], **bwd["flash_dkv"]},
        "matmul_epilogue": {"launches": train_launches["matmul_epilogue"], **matmul,
                            "b_x_plus_a_x": matmul_bx},
        "nesterov": {"launches": train_launches["nesterov"], **nesterov},
        "reads": [train_read, serve_prof["read"]],
        "variants": train_launches.variants,
        "autotune_ref": autotune_ref,
    }


def phase_serve_profiled(torch, fa, get_config, serve, arch: str, phase: str, depth: int,
                         paged_ms: float) -> dict:
    """4b's serving main path at full width, depth ``depth``, bf16 weights,
    through the captured span (:func:`phase_main`: launches against the
    formula, the replays and the eager span bitwise equal), then its
    profile (:func:`phase_profile`: the idle share and a decode step beside
    its memory-bound floor)."""
    launches, engine = phase_main(torch, fa, get_config, serve, arch, phase,
                                  overrides=dict(param_dtype="bfloat16", n_layers=depth))
    prof = phase_profile(torch, engine, paged_ms, phase=phase + "'")
    out = dict(tok_s=engine.tok_s, replay_tok_s=engine.replay_tok_s,
               eager_tok_s=engine.eager_tok_s, capture_s=engine.capture_s,
               peak_gb=engine.peak_gb, step_ms=prof["step_ms"], floor_ms=prof["floor_ms"],
               idle=prof["idle"], launches=launches, depth=depth,
               n_params=param_count(engine.model.cfg), read=prof["read"])
    del engine
    torch.cuda.empty_cache()
    return out


def print_serving(arch: str, s: dict, smi: str) -> None:
    """The summary line of a :func:`phase_serve_profiled` run."""
    print(f"{arch} serving (depth {s['depth']}, bf16 weights, {s['n_params']:,} parameters, "
          f"{MAIN['batch']} x ({MAIN['prompt_len']} + {MAIN['max_new']}), {MAIN['slots']} "
          f"slots, captured spans): {s['tok_s']:.1f} tok/s (capture {s['capture_s']:.3f} s "
          f"apart), replays only {s['replay_tok_s']:.1f} tok/s, eager span "
          f"{s['eager_tok_s']:.1f} tok/s; peak {s['peak_gb']:.2f} GB; a decode step "
          f"{s['step_ms']:.4f} ms on the card against its floor {s['floor_ms']:.4f} ms; idle "
          f"{s['idle']:.1f}%; launches {s['launches']['flash_fwd']} flash_fwd, "
          f"{s['launches']['paged_decode']} paged_decode; card (nvidia-smi name, "
          f"power.limit): {smi}")


# nemotron-4-15b (13c) serves 4b's workload with bf16 weights: ~15.6B
# parameters are ~31 GB in bf16 (fp32, ~62.6 GB, would leave no room for the
# prefill's [16, 512, 256000] logits). For the script's time it serves at
# depth 8 of its 32 layers (PERF.md section 4): the kernels' shapes a layer
# are the full model's
NEMOTRON = "nemotron-4-15b"
NEMOTRON_SERVE_DEPTH = 8


def slice_nemotron(torch, fa, get_config, build_model, serve, smi: str) -> dict:
    """Phase 13: nemotron-4-15b (32 layers, d 6144, 48:8 heads so G = 6,
    hd 128, relu2, vocab 256,000, untied). (13a) flash_fwd and
    paged_decode at G = 6 against their plain versions, bitwise from run to
    run, timed at the model's serving shapes; (13b) the full-width fp32
    agreement of 4a at depth 2; (13c) the serving main path of 4b at full
    width and depth, bf16 weights, through the captured span, with its peak
    memory; (13c') its profile and a decode step beside its memory-bound
    floor. Returns the two kernels' rows for the summary."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[13] {NEMOTRON}: {torch.cuda.memory_allocated() / 1e9:.2f} GB held by earlier "
          "phases")
    cfg = get_config(NEMOTRON)
    G = cfg.n_heads // cfg.n_kv_heads
    flash = phase_flash(torch, fa, hd=cfg.hd, phase="13a", cases=NEMOTRON_FWD_CASES)
    paged = phase_paged(torch, fa, hd=cfg.hd, KV=cfg.n_kv_heads, G=G, phase="13a")
    lap("13a")
    phase_agreement(torch, get_config, build_model, NEMOTRON, "13b", n_layers=2)
    torch.cuda.empty_cache()
    lap("13b")
    s = phase_serve_profiled(torch, fa, get_config, serve, NEMOTRON, "13c",
                             NEMOTRON_SERVE_DEPTH, paged["ms"])
    print_serving(NEMOTRON, s, smi)
    lap("13c")
    launches = s["launches"]
    return {"flash_fwd": {"launches": launches["flash_fwd"], **flash["serving"]},
            "paged_decode": {"launches": launches["paged_decode"], **paged},
            "reads": [s["read"]]}


# ---------------------------------------------------------------------------
# Slice 6b: the Muon variants (14), the paper's pseudogradient analysis and
# scaling-law fits (15), the MoE family's deepseek-moe-16b (16)
# ---------------------------------------------------------------------------

# the Muon variants (14b): the 6b command with another inner optimizer
VARIANTS = {"muon_bp": ["--ns-period", "4"], "normuon": []}


def variant_argv(inner: str) -> list:
    """The 6b command (``TRAIN``) with ``--inner inner`` and its flags."""
    return replace_flags(TRAIN, inner=inner,
                         out=ROOT / "build" / f"chip_smoke_train_{inner}") + VARIANTS[inner]


def phase_muon_bp_is_muon(torch, build_parser, train, ref_hist: list, ref_host: dict) -> None:
    """[14a] ``--inner muon_bp --ns-period 1`` through the captured path (round
    1 the warm-up, rounds 2 and 3 replays) against 6b's ``--inner muon`` run
    from the same TrainState (seed 0): every round's losses, eval loss and
    comm_bytes and the final state, bitwise. At period 1 the periodic stage
    is bypassed, so the two runs launch the same kernels on the same data."""
    from repro_torch.utils.tree import tree_map

    argv = replace_flags(TRAIN, inner="muon_bp", out=ROOT / "build" / "chip_smoke_train_bp1")
    argv += ["--ns-period", "1"]
    print("[14a] repro_torch.launch.train " + " ".join(argv) + ": bitwise 6b's --inner muon")
    out = train(build_parser().parse_args(argv))
    torch.cuda.synchronize()
    hist = out["history"]
    keys = ("train_loss", "train_loss_last", "eval_loss", "comm_bytes")
    assert len(hist) == len(ref_hist)
    for a, b in zip(ref_hist, hist):
        for k in keys:
            assert a[k] == b[k], (a["round"], k, a[k], b[k])
    diffs = _leaf_diffs(torch, ref_host, tree_map(lambda t: t.cpu(), out["state"]))
    assert not diffs, diffs
    assert out["engine"].replays == len(hist) - 1
    print(f"  {len(hist)} rounds ({out['engine'].replays} replayed): {', '.join(keys)} and "
          "every state leaf bitwise equal to 6b's --inner muon")
    del out
    torch.cuda.empty_cache()


def phase_variant(torch, build_parser, train, inner: str, muon_tok_s: float) -> dict:
    """[14b] the 6b command with ``--inner muon_bp --ns-period 4`` or
    ``--inner normuon``, captured, 3 rounds: launches against the formula
    (``matmul_epilogue`` 105 a worker step, as Muon's: MuonBP's off-period
    steps select the momentum over the orthogonalized update, so NS runs on
    every step), finite losses (NorMuon's eval loss falls); the rate beside
    6b's. (The eager repeat, 14b', is cut for time; earlier full runs held
    it bitwise.)"""
    argv = variant_argv(inner)
    launches, out = phase_train_main(torch, build_parser, train, argv, phase=f"14b {inner}",
                                     falls=inner == "normuon")
    per_round = out["engine"].launches_per_round(out["state"]["outer_params"])
    steps = 2 * 4  # K x H
    assert per_round["matmul_epilogue"] == 105 * steps, per_round
    counter = out["state"]["inner_state"]["tx"]["muon"][1 if inner == "muon_bp" else 2]["count"]
    assert counter.tolist() == [12, 12], counter  # 3 rounds x H = 4, per worker
    tok_s = out["tok_s"]
    print(f"  {inner}: {tok_s:.1f} tokens/s over rounds 2-3 beside 6b's --inner muon "
          f"{muon_tok_s:.1f}; matmul_epilogue 105 a worker step (K x H = {steps} a round)")
    del out
    torch.cuda.empty_cache()
    return dict(launches=launches, tok_s=tok_s)


def slice_variants(torch, build_parser, train, ref_hist: list, ref_host: dict,
                   muon_tok_s: float, smi: str) -> dict:
    """Phase 14: the Muon variants (Part A of slice 6b) on the training main
    path. Returns each variant's launches and rate."""
    phase_muon_bp_is_muon(torch, build_parser, train, ref_hist, ref_host)
    lap("14a")
    out = {inner: phase_variant(torch, build_parser, train, inner, muon_tok_s)
           for inner in VARIANTS}
    lap("14b")
    for inner, r in out.items():
        print(f"--inner {inner} {' '.join(VARIANTS[inner])}: {r['tok_s']:.1f} tokens/s beside "
              f"--inner muon's {muon_tok_s:.1f} (6b); card (nvidia-smi name, power.limit): {smi}")
    return out


# the paper's pseudogradient measurements (15), benchmarks/common.py's
# methodology on paper-150m at full width: a DP checkpoint warmed up for
# 4 x H steps at B_tot sequences a step, then K workers at B_tot / K and one
# worker at B_tot branch from it (optimizer state included) for H steps
PROBE = dict(arch="paper-150m", seq_len=1024, b_tot=16, H=8, Ks=(2, 4, 8), warm=32,
             lr=3e-3, weight_decay=1e-4, seed=0)


def probe_stream(vocab: int, n_workers: int, bpw: int, seed: int):
    from repro_torch.data import DataConfig, MarkovStream

    return MarkovStream(DataConfig(vocab=vocab, seq_len=PROBE["seq_len"], batch_per_worker=bpw,
                                   n_workers=n_workers, seed=seed), "cuda")


def warm_checkpoint(torch, model, opt, inner: str, icfg) -> dict:
    """The DP checkpoint: ``dp_init`` (its optimizer state has the same
    leaves for either Newton-Schulz mode) then ``PROBE['warm']`` ``dp_step``s
    of ``opt`` at ``B_tot`` sequences a step (the reference's stream seed
    11)."""
    from repro_torch.core import dp_init, dp_step

    state, _ = dp_init(model, inner, icfg, torch.Generator(device="cuda").manual_seed(
        PROBE["seed"]), "cuda")
    data = probe_stream(model.cfg.vocab, 1, PROBE["b_tot"], seed=11).batch_stack(0, PROBE["warm"])
    losses = []
    for t in range(PROBE["warm"]):
        state, m = dp_step(model, opt, state, {k: v[t, 0] for k, v in data.items()})
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()
    assert all(math.isfinite(v) for v in losses), losses
    print(f"  {inner}: warm-up {PROBE['warm']} DP steps of {PROBE['b_tot']} x "
          f"{PROBE['seq_len']}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return state


def branch(torch, model, opt, ckpt: dict, n_workers: int, H: int, track: bool = False):
    """K = ``n_workers`` workers at B_tot / K sequences each from the
    checkpoint (params and optimizer state), H ``inner_step``s on the
    reference's stream seed 5. Returns (``compute_deltas`` [K, ...], the
    Frobenius norms of each step of w_in [K, H, L] when ``track``)."""
    from repro_torch.core import compute_deltas, inner_step
    from repro_torch.utils.tree import tree_map

    def stack(t):
        return t[None].expand(n_workers, *t.shape).clone()

    state = {"outer_params": ckpt["params"],
             "worker_params": tree_map(stack, ckpt["params"]),
             "inner_state": tree_map(stack, ckpt["opt_state"])}
    data = probe_stream(model.cfg.vocab, n_workers, PROBE["b_tot"] // n_workers,
                        seed=5).batch_stack(0, H)
    norms = []
    for h in range(H):
        w_in = state["worker_params"]["layers"]["mlp"]["w_in"]
        prev = w_in.float().clone() if track else None
        state, _ = inner_step(model, opt, state, {k: v[h] for k, v in data.items()})
        if track:
            step = w_in.float() - prev
            norms.append(torch.sqrt(torch.sum(step * step, dim=(-2, -1))))  # [K, L]
    deltas = compute_deltas(state)
    del state
    return deltas, (torch.stack(norms, dim=1) if track else None)


def branch_launches(model, inner: str, icfg, params, n_workers: int, H: int) -> dict:
    """Kernel launches of a branch: ``TrainEngine.launches_per_round``'s
    worker steps (K x H of them) without the eval loss or an outer sync."""
    from repro_torch.core import DiLoCoConfig
    from repro_torch.engine import TrainEngine

    dcfg = DiLoCoConfig(n_workers=n_workers, sync_interval=H, inner_name=inner, ns_impl="pallas")
    n = TrainEngine(model, dcfg, icfg).launches_per_round(params, with_eval=False)
    return {k: n[k] for k in ("flash_fwd", "flash_dq", "flash_dkv", "matmul_epilogue")}


def relative_gaps(torch, w) -> list:
    """paper_figures.py's Fig. 3 number per layer: the top-25% interference
    gap of the K workers' w_in deltas [K, L, m, n] over the workers' mean
    top-S singular-value mass."""
    from repro_torch.core.analysis import interference_gap, singular_values

    rels = []
    for layer in range(w.shape[1]):
        mats = w[:, layer]
        gap = float(interference_gap(mats, s_frac=0.25))
        sv = singular_values(mats)
        S = max(int(round(0.25 * sv.shape[-1])), 1)
        mass = float(torch.mean(torch.sum(sv[:, :S], dim=-1)))
        rels.append(gap / (mass + 1e-12))
    return rels


def float64_check(torch, deltas, psi_k, psi_1, cos: dict, rels: list) -> tuple[float, float]:
    """The card's fp32 per_matrix_cosines and relative interference gaps
    against the same quantities in float64 on the CPU (numpy), on the same
    deltas: within 1e-5."""
    import numpy as np

    from repro_torch.core.analysis import hidden_matrix_leaves

    b = {p: x.double().cpu().numpy() for p, x in hidden_matrix_leaves(psi_1)}
    worst_cos = 0.0
    for p, x in hidden_matrix_leaves(psi_k):
        a2 = x.double().cpu().numpy().reshape(-1, *x.shape[-2:])
        b2 = b[p].reshape(a2.shape)
        for i in range(a2.shape[0]):
            c = float(np.vdot(a2[i], b2[i]) / (np.linalg.norm(a2[i]) * np.linalg.norm(b2[i])
                                                + 1e-12))
            worst_cos = max(worst_cos, abs(c - cos[f"{p}[{i}]"]))
    w = deltas["layers"]["mlp"]["w_in"].double().cpu().numpy()
    worst_gap = 0.0
    for layer in range(w.shape[1]):
        mats = w[:, layer]
        sv = np.linalg.svd(mats, compute_uv=False)
        S = max(int(round(0.25 * sv.shape[-1])), 1)
        sv_mean = np.linalg.svd(mats.mean(0), compute_uv=False)
        mass = float(np.mean(np.sum(sv[:, :S], axis=-1)))
        rel = (mass - float(np.sum(sv_mean[:S]))) / (mass + 1e-12)
        worst_gap = max(worst_gap, abs(rel - rels[layer]))
    check("per_matrix_cosines, card fp32 vs CPU float64", worst_cos, 1e-5)
    check("relative interference gaps of w_in, card fp32 vs CPU float64", worst_gap, 1e-5)
    return worst_cos, worst_gap


def phase_pseudogradients(torch, get_config, build_model, smi: str) -> dict:
    """[15a] / [15b] the paper's Figs. 2, 3 and 5 and Prop. 4.2 on paper-150m
    at full width (bf16 compute, the kernels: attn_impl 'pallas', Muon's
    Newton-Schulz through matmul_epilogue), for Muon and AdamW at K = 2, 4
    and 8 (``PROBE``). Per (inner, K): the mean, std and min of the
    per-matrix cosines of Psi_K against Psi_1 (Fig. 2), the relative top-25%
    interference gap of w_in per layer and averaged (Fig. 3), the
    coefficient of variation of the per-step Frobenius norms of w_in over
    workers and steps (Fig. 5) and, for Muon, Prop. 4.2's relative error on
    the K workers' single-step w_in deltas (H = 1 from the same checkpoint).
    Checks: cosines finite in [-1, 1]; Prop. 4.2 within 1e-4; launches of
    every branch equal its formula; at K = 2, the card's cosines and gaps
    against float64 on the CPU within 1e-5. Whether Muon's cosines beat
    AdamW's is recorded, not gated."""
    from repro_torch.core.analysis import per_matrix_cosines, prop42_nuclear_identity
    from repro_torch.kernels import _build
    from repro_torch.optim import OptimizerConfig, make_inner_optimizer
    from repro_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    H, B = PROBE["H"], PROBE["b_tot"]
    cfg = get_config(PROBE["arch"]).replace(attn_impl="pallas", max_seq_len=PROBE["seq_len"])
    model = build_model(cfg)
    icfg = OptimizerConfig(lr=PROBE["lr"], weight_decay=PROBE["weight_decay"])
    rows = {}
    launches_total: dict = {}
    for inner in ("muon", "adamw"):
        phase = {"muon": "15a", "adamw": "15b"}[inner]
        print(f"[{phase}] pseudogradients, {PROBE['arch']} full width, --inner {inner}: B_tot "
              f"{B} x {PROBE['seq_len']}, H {H}, K {PROBE['Ks']}, inner lr {PROBE['lr']}, "
              f"weight decay {PROBE['weight_decay']}")
        opt = make_inner_optimizer(inner, icfg, ns_impl="pallas")
        ckpt = warm_checkpoint(torch, model, opt, inner, icfg)
        deltas_1, _ = branch(torch, model, opt, ckpt, 1, H)
        psi_1 = tree_map(lambda d: d[0], deltas_1)
        for K in PROBE["Ks"]:
            _build.reset_launch_counts()
            deltas, norms = branch(torch, model, opt, ckpt, K, H, track=True)
            got = {k: _build.LAUNCHES[k] for k in ("flash_fwd", "flash_dq", "flash_dkv",
                                                   "matmul_epilogue")}
            want = branch_launches(model, inner, icfg, ckpt["params"], K, H)
            assert got == want, (inner, K, got, want)
            for k, v in got.items():
                launches_total[k] = launches_total.get(k, 0) + v
            psi_k = tree_map(lambda d: torch.mean(d, dim=0), deltas)
            cos = per_matrix_cosines(psi_k, psi_1)
            vals = torch.tensor(list(cos.values()), dtype=torch.float64)
            assert torch.isfinite(vals).all() and vals.abs().max() <= 1 + 1e-6, vals
            rels = relative_gaps(torch, deltas["layers"]["mlp"]["w_in"])
            cv = float((torch.std(norms, dim=(0, 1), correction=0)
                        / (torch.mean(norms, dim=(0, 1)) + 1e-12)).mean())
            row = dict(cos_mean=float(vals.mean()), cos_std=float(vals.std(correction=0)),
                       cos_min=float(vals.min()), gap=sum(rels) / len(rels), gaps=rels,
                       step_norm_cv=cv, n_matrices=len(cos))
            if K == PROBE["Ks"][0]:
                row["float64"] = float64_check(torch, deltas, psi_k, psi_1, cos, rels)
            del deltas, psi_k
            if inner == "muon":
                one, _ = branch(torch, model, opt, ckpt, K, 1)
                w = one["layers"]["mlp"]["w_in"][:, 0]  # [K, m, n], layer 0
                lhs, rhs = prop42_nuclear_identity(w[:, None], torch.ones(1, device="cuda"))
                row["prop42_rel_err"] = float(abs(lhs - rhs) / (abs(lhs) + 1e-12))
                check(f"Prop. 4.2, K = {K}, H = 1, w_in layer 0: |lhs - rhs| / |lhs|",
                      row["prop42_rel_err"], 1e-4)
                del one
            rows[(inner, K)] = row
            print(f"  {inner} K = {K} (bpw {B // K}): Fig. 2 cosines over {row['n_matrices']} "
                  f"matrices mean {row['cos_mean']:.4f}, std {row['cos_std']:.4f}, min "
                  f"{row['cos_min']:.4f}; Fig. 3 relative top-25% gap of w_in "
                  f"{row['gap']:.4f} (per layer {[round(g, 4) for g in rels]}); Fig. 5 "
                  f"step-norm CV of w_in {row['step_norm_cv']:.4f}"
                  + (f"; Prop. 4.2 relative error {row['prop42_rel_err']:.3e}"
                     if inner == "muon" else "")
                  + f"; launches {got} = the branch's formula")
            torch.cuda.empty_cache()
        del ckpt, deltas_1, psi_1, opt
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    for K in PROBE["Ks"]:
        m, a = rows[("muon", K)], rows[("adamw", K)]
        print(f"Fig. 2-5 at K = {K}, {PROBE['arch']}: mean cosine muon {m['cos_mean']:.4f} vs "
              f"adamw {a['cos_mean']:.4f} ({'muon' if m['cos_mean'] > a['cos_mean'] else 'adamw'}"
              f" higher; recorded, not gated); relative gap muon {m['gap']:.4f} vs adamw "
              f"{a['gap']:.4f}; step-norm CV muon {m['step_norm_cv']:.4f} vs adamw "
              f"{a['step_norm_cv']:.4f}; card (nvidia-smi name, power.limit): {smi}")
    print(f"  phases 15a-15b took {seconds:.1f} s")
    del model
    torch.cuda.empty_cache()
    return dict(rows=rows, launches=launches_total, seconds=seconds)


# 15c's fits of fixed, noise-free synthetic points (L = 30 C^-0.08 + 1.6 and
# 25 C^-0.07 + 1.7 at C = 1e17 ... 1e21), as the session CPU computed them
# (numpy 2, scipy 1.17.0, seed 0)
FIT_EXPECT = dict(a=30.10953143197206, alpha=-0.08011810022530783, irr=1.6013438674331049,
                  joint_irr=1.236312250231642, muon_alpha=-0.05718532841447603,
                  adamw_alpha=-0.050192431625926355)


def phase_scaling_laws() -> dict:
    """[15c] core/scaling_laws.py on the card's host: scipy is there, and the
    fits of fixed synthetic points equal the CPU's (``FIT_EXPECT``): within
    1e-4 relative, what L-BFGS-B's stopping rule resolves (bitwise with the
    same scipy; another version's L-BFGS-B may stop a step apart)."""
    import numpy as np
    import scipy

    from repro_torch.core import scaling_laws as sl

    print(f"[15c] scaling-law fits on the host: numpy {np.__version__}, scipy {scipy.__version__}")
    C = np.logspace(17, 21, 7)
    L = 30.0 * C ** -0.08 + 1.6
    L2 = 25.0 * C ** -0.07 + 1.7
    fit = sl.fit_power_law(C, L, fit_irr=True, restarts=8)
    irr, fits = sl.fit_joint_irreducible({"muon": (C, L), "adamw": (C, L2)}, n_grid=3,
                                         restarts=2)
    got = dict(a=fit.a, alpha=fit.alpha, irr=fit.irr, joint_irr=irr,
               muon_alpha=fits["muon"].alpha, adamw_alpha=fits["adamw"].alpha)
    for k, want in FIT_EXPECT.items():
        check(f"fit {k}: {got[k]!r} vs the CPU's {want!r} (relative)",
              abs(got[k] - want) / max(abs(want), 1e-30), 1e-4)
    return got


# the MoE family (16): deepseek-moe-16b (28 layers, d 2048, 16:16 heads of hd
# 128, 64 routed experts of d_ff 1408, top-6, plus 2 shared, vocab 102,400,
# untied; ~16.9B parameters). Served at full width and depth with bf16
# weights (~33.8 GB); one captured MuLoCo round at full width with the depth
# cut to MOE_TRAIN["depth"] layers (fp32 params: a K = 2 TrainState of the
# whole model would be ~0.4 TB). Depth 1, not 2: at depth 2 (1.595B
# parameters, a ~42 GB state) the eager warm-up round held 72 GB and ran out
# of the card's 79.18 GiB (an NVIDIA H100 80GB HBM3), less than the 10 GB to
# spare the phase keeps; depth 1 is 1.007B parameters
MOE = "deepseek-moe-16b"
MOE_TRAIN = dict(depth=1, K=2, H=2, batch=8, seq_len=1024, rounds=2, lr=3e-3)
# 16b: deepseek-moe-16b serves at depth 8 of its 28 layers for the script's
# time (PERF.md section 4)
MOE_SERVE_DEPTH = 8


def phase_matmul_moe(torch, mm, ops, ref) -> tuple[dict, dict]:
    """[16c] matmul_epilogue at deepseek-moe-16b's new Newton-Schulz shapes
    (the stacks of two layers; 16c''s depth-1 round runs the same matrices,
    half as many), whose widths are not multiples of the 96-wide tile (64; 1408
    = 14 x 96 + 64; 2048 = 21 x 96 + 32): the expert banks [2 x 64, 1408,
    2048] (w_out as it is, w_in / w_gate as the transposed view) and the
    router [2, 64, 2048] (transposed), each product in all four operand
    layouts within 1e-5 of the largest output, the symmetric ones bitwise
    symmetric; then X X^T and B X + a X of the bank timed beside the plain
    version, the bound and torch.baddbmm, and the full Newton-Schulz of the
    bank through the kernel against the plain fp32 one."""
    print("[16c] matmul_epilogue at deepseek-moe-16b's expert-bank and router shapes "
          "(ragged tile edges), fp32, TF32 off")
    from repro_torch.optim.muon import NS_COEFFS

    na, nb, nc = NS_COEFFS
    gen = torch.Generator(device="cuda").manual_seed(17)
    g = torch.randn((128, 1408, 2048), generator=gen, device="cuda")
    x = normed(g)  # experts/w_out [2, 64, 1408, 2048] as one stack
    x_in = normed(torch.randn((128, 2048, 1408), generator=gen, device="cuda")).mT  # w_in
    xr = normed(torch.randn((2, 2048, 64), generator=gen, device="cuda")).mT  # the router
    A = mm.matmul_epilogue(x, x.mT, symmetric=True)
    Bm = mm.matmul_epilogue(A, A, A, alpha=nc, beta=nb, symmetric=True)
    Ar = mm.matmul_epilogue(xr, xr.mT, symmetric=True)
    Br = mm.matmul_epilogue(Ar, Ar, Ar, alpha=nc, beta=nb, symmetric=True)
    check_matmul_cases(torch, mm, [
        ("X X^T, expert bank w_out [128, 1408, 2048]", x, x.mT, None, 1.0, 0.0, True),
        ("c A A + b A, [128, 1408, 1408]", A, A, A, nc, nb, True),
        ("B X + a X, [128, 1408, 1408] x [128, 1408, 2048]", Bm, x, x, 1.0, na, False),
        ("X X^T, expert bank w_in transposed [128, 1408, 2048]", x_in, x_in.mT, None, 1.0, 0.0,
         True),
        ("X X^T, router transposed [2, 64, 2048]", xr, xr.mT, None, 1.0, 0.0, True),
        ("c A A + b A, router [2, 64, 64]", Ar, Ar, Ar, nc, nb, True),
        ("B X + a X, router [2, 64, 64] x [2, 64, 2048]", Br, xr, xr, 1.0, na, False),
    ])
    z, m, k = x.shape
    xx_bytes = (x.numel() + z * m * m) * 4
    out = time_matmul(torch, mm, "X X^T, expert bank [128, 1408, 2048], symmetric=True", x,
                      x.mT, None, 1.0, 0.0, True, 2.0 * z * (m * (m + 1) // 2) * k, xx_bytes)
    bx = time_matmul(torch, mm, "B X + a X, [128, 1408, 1408] x [128, 1408, 2048]", Bm, x, x,
                     1.0, na, False, 2.0 * z * m * m * k, (Bm.numel() + 2 * x.numel()) * 4)
    del x_in, xr, A, Ar, Br, Bm, x
    y = ops.ns_orthogonalize(g)
    y_ref = ref.ns_orthogonalize_ref(g)
    torch.cuda.synchronize()
    check("full Newton-Schulz, expert bank [128, 1408, 2048], kernel vs plain fp32",
          (y - y_ref).abs().max().item(), 1e-5)
    del g, y, y_ref
    torch.cuda.empty_cache()
    return out, bx


def _state_diffs_host(torch, ref_host: dict, state: dict) -> list:
    """The paths of ``state``'s leaves (on the card) that differ from
    ``ref_host``'s (on the host), compared one leaf at a time."""
    from repro_torch.utils.tree import tree_leaves_with_paths

    la, lb = tree_leaves_with_paths(ref_host), tree_leaves_with_paths(state)
    assert [p for p, _ in la] == [p for p, _ in lb]
    return [p for (p, a), (_, b) in zip(la, lb) if not torch.equal(a, b.cpu())]


def phase_moe_train(torch, get_config, build_model, matmul_ms: dict) -> dict:
    """[16c'] one captured MuLoCo round of deepseek-moe-16b at full width,
    depth cut to ``MOE_TRAIN['depth']``: K = 2, H = 2, fp32 params, bf16
    compute, the flash kernels, Newton-Schulz through matmul_epilogue (the
    expert banks, the router and the attention and shared matrices: 11 Muon
    leaves) and the outer Nesterov kernel, 8 x 1024 tokens a worker step.
    Round 1 is the warm-up (eager) and the capture, round 2 a replay;
    launches against the formula; finite losses with the aux term in them;
    the same rounds eager, bitwise (the state compared leaf by leaf against
    a host copy); one more replayed round profiled: matmul_epilogue's share
    of its device time; the peak memory."""
    from repro_torch.core import DiLoCoConfig
    from repro_torch.data import DataConfig, MarkovStream, batches_for_round, batches_for_span
    from repro_torch.engine import TrainEngine, run_rounds
    from repro_torch.kernels import _build
    from repro_torch.optim import OptimizerConfig
    from repro_torch.utils.tree import tree_count_params, tree_map

    T = MOE_TRAIN
    K, H, B, S, n = T["K"], T["H"], T["batch"], T["seq_len"], T["rounds"]
    cfg = get_config(MOE).replace(n_layers=T["depth"], max_seq_len=S, attn_impl="pallas")
    print(f"[16c'] one captured MuLoCo round, {MOE} full width, depth {cfg.n_layers}: K {K}, "
          f"H {H}, {B} x {S} tokens a worker step, fp32 params, --ns-impl pallas, "
          f"--outer-kernel, inner lr {T['lr']}, {n} rounds (the first the warm-up)")
    model = build_model(cfg)
    dcfg = DiLoCoConfig(n_workers=K, sync_interval=H, inner_name="muon", ns_impl="pallas",
                        outer_kernel=True)
    icfg = OptimizerConfig(lr=T["lr"], weight_decay=1e-4, schedule="cosine", warmup_steps=5,
                           total_steps=n * H)
    data = MarkovStream(DataConfig(vocab=cfg.vocab, seq_len=S, batch_per_worker=B,
                                   n_workers=K, seed=0), "cuda")

    def run(capture):
        engine = TrainEngine(model, dcfg, icfg, capture=capture)
        state = engine.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        state, hist = run_rounds(engine, state, lambda r: batches_for_round(data, r, H), n,
                                 rounds_per_dispatch=1,
                                 span_batches_for=lambda r0, m: batches_for_span(data, r0, H, m))
        torch.cuda.synchronize()
        return engine, state, hist

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    engine, state, hist = run(None)
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = tree_count_params(state["outer_params"])
    per_round = engine.launches_per_round(state["outer_params"], with_eval=False)
    want = {k: n * v for k, v in per_round.items()}
    print(f"  {n_params:,} parameters; launches {launches}")
    print(f"  formula  {want} (rounds x TrainEngine.launches_per_round)")
    assert launches == want, (launches, want)
    assert per_round["matmul_epilogue"] == K * H * 3 * 5 * 11, per_round
    check_captures(engine, per_round, n, [(False, False)])
    losses = [r["train_loss"] for r in hist]
    assert all(math.isfinite(v) for v in losses), losses
    with torch.no_grad():
        batch = {k: v[0, 0] for k, v in data.batch_stack(10_000, 1).items()}
        loss, metrics = model.loss(state["outer_params"], batch)
    aux = metrics["moe_aux"].item()
    assert math.isfinite(loss.item()) and aux > 0, (loss, aux)
    assert loss.item() == (metrics["loss"] + cfg.router_aux_coef * metrics["moe_aux"]).item()
    read = round_read("16c'", cfg, engine, state, hist, B, S, peak_gb)
    tokens = K * H * B * S
    print(f"  losses {[round(v, 4) for v in losses]}; the synced params' loss on a held-out "
          f"batch {loss.item():.4f} = cross-entropy {metrics['loss'].item():.4f} + "
          f"{cfg.router_aux_coef} x aux {aux:.4f} (summed over {cfg.n_layers} layers); round "
          f"walls {[round(r['wall_s'], 3) for r in hist]} s (round 1: warm-up "
          f"{engine.warmup_s[0]:.3f} s + capture {engine.capture_s[0]:.3f} s); peak device "
          f"memory {peak_gb:.2f} GB")
    ref_hist = hist
    ref_host = tree_map(lambda t: t.to("cpu", copy=True), state)

    def dispatch(i):
        nonlocal state
        state, _ = engine.superstep(state, batches_for_span(data, n + i, H, 1))

    replays = engine.replays
    prof = profile_dispatch(torch, dispatch, tokens, "1 round a dispatch")
    assert engine.replays == replays + 2, "the profiled rounds were not replays"
    hits = [(ms, c) for name, (ms, c) in prof["by_name"].items()
            if "matmul_epilogue_kernel" in name]
    mm_ms, mm_n = sum(h[0] for h in hits), sum(h[1] for h in hits)
    assert mm_n == per_round["matmul_epilogue"], (mm_n, per_round)
    share = 100 * mm_ms / prof["busy_ms"]
    print(f"  matmul_epilogue: {mm_ms:.1f} ms of the round's {prof['busy_ms']:.1f} ms device "
          f"time ({share:.1f}%), x{mm_n}; beside 16c's event times X X^T "
          f"{matmul_ms['xx']['ms']:.4f} and B X + a X {matmul_ms['bx']['ms']:.4f} ms on the bank")
    del engine, state
    torch.cuda.empty_cache()
    engine, state, hist = run(False)
    keys = ("train_loss", "train_loss_last", "comm_bytes", "active_workers")
    for a, b in zip(ref_hist, hist):
        for k in keys:
            assert a[k] == b[k], ("eager", a["round"], k, a[k], b[k])
    diffs = _state_diffs_host(torch, ref_host, state)
    assert not diffs, diffs
    print(f"  eager (capture=False): {len(hist)} rounds' {', '.join(keys)} and every state "
          "leaf bitwise equal to the captured run's")
    del engine, state, ref_host, model
    torch.cuda.empty_cache()
    return dict(launches=launches, peak_gb=peak_gb, tok_s=prof["tok_s"], idle=prof["idle"],
                matmul_share=share, busy_ms=prof["busy_ms"], n_params=n_params, read=read)


def slice_moe(torch, mods: dict, get_config, build_model, serve, smi: str) -> dict:
    """Phase 16: deepseek-moe-16b. (16a) paged_decode at its 16 kv heads
    (G = 1, hd 128) against its plain version, and the full-width fp32
    agreement of 4a at depth 2; (16b) the serving main path of 4b at full
    width and depth with bf16 weights through the captured span, and
    (16b') its profile, a decode step beside its memory-bound floor (every
    expert's weights are read: the capacity dispatch runs all E experts on
    their [C, d] slots); (16c) matmul_epilogue at the expert-bank and router
    shapes and (16c') one captured MuLoCo round at depth
    ``MOE_TRAIN['depth']``. Returns the kernels' rows for the summary."""
    import gc

    fa, mm, ops, ref = (mods[k] for k in ("fa", "mm", "ops", "ref"))
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(MOE)
    print(f"[16] {MOE}: {param_count(cfg):,} parameters; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB held by earlier phases")
    paged = phase_paged(torch, fa, hd=cfg.hd, KV=cfg.n_kv_heads,
                        G=cfg.n_heads // cfg.n_kv_heads, phase="16a")
    phase_agreement(torch, get_config, build_model, MOE, "16a", n_layers=2)
    torch.cuda.empty_cache()
    lap("16a")
    serving = phase_serve_profiled(torch, fa, get_config, serve, MOE, "16b", MOE_SERVE_DEPTH,
                                   paged["ms"])
    launches = serving["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    lap("16b")
    xx, bx = phase_matmul_moe(torch, mm, ops, ref)
    lap("16c")
    train_out = phase_moe_train(torch, get_config, build_model, dict(xx=xx, bx=bx))
    lap("16c'")
    print_serving(MOE, serving, smi)
    t = train_out
    print(f"{MOE} training (depth {MOE_TRAIN['depth']}, {t['n_params']:,} parameters, K 2, H 2, "
          f"8 x 1024 tokens a worker step): one replayed round {t['tok_s']:.1f} tokens/s, idle "
          f"{t['idle']:.1f}%, matmul_epilogue {t['matmul_share']:.1f}% of the device time, "
          f"peak {t['peak_gb']:.2f} GB; card (nvidia-smi name, power.limit): {smi}")
    tl = t["launches"]
    return {"flash_fwd": {"launches": {"serving": launches["flash_fwd"],
                                       "training": tl["flash_fwd"]}},
            "paged_decode": {"launches": launches["paged_decode"], **paged},
            "flash_dq": {"launches": tl["flash_dq"]}, "flash_dkv": {"launches": tl["flash_dkv"]},
            "matmul_epilogue": {"launches": tl["matmul_epilogue"], **xx, "b_x_plus_a_x": bx},
            "nesterov": {"launches": tl["nesterov"]}, "reads": [serving["read"], t["read"]]}

# ---------------------------------------------------------------------------
# Slice 7a: the SSM and hybrid families (17): mamba2-370m and zamba2-2.7b
# ---------------------------------------------------------------------------

MAMBA, ZAMBA = "mamba2-370m", "zamba2-2.7b"
# 17d: the training command at mamba2-370m, full width and depth; B x S a
# worker step stays 8192 tokens (seq 1024 is 4 SSD chunks of 256); for the
# script's time H = 2 and 2 rounds (the warm-up and capture, one replay)
TRAIN_MAMBA = replace_flags(TRAIN, arch=MAMBA, seq_len=1024, batch_per_worker=8, rounds=2,
                            sync_interval=2, out=ROOT / "build" / "chip_smoke_train_mamba")
# 17e: zamba2-2.7b at full width, depth cut to one superblock (6 mamba layers
# and the shared block), one sequence of 8192 a worker step (the window of
# 4096 masks), K = 2, H = 2 (for the script's time), 2 rounds, the training
# command's lr
ZAMBA_TRAIN = dict(depth=6, K=2, H=2, batch=1, seq_len=8192, rounds=2, lr=3e-3)
# 17f: the naive serving workload, 4b's 32 requests with the prompt cut to 32
# and the new tokens to 32 (a stepped prefill is host-bound: ~50-130 ms a
# step; 191 steps a run before, 63 now, for the script's time), and its
# run-to-run repeat, (prompt, new)
SSM_SERVE = dict(batch=MAIN["batch"], prompt_len=32, max_new=32)
SERVE_REPEAT = (8, 8)
# 17b: the Newton-Schulz stacks of the Muon leaves, (name, shape, taken
# transposed): each model's in_proj first (timed)
SSM_NS_SHAPES = {
    MAMBA: [("in_proj", (48, 1024, 4384), False), ("out_proj", (48, 2048, 1024), True)],
    ZAMBA: [("in_proj", (6, 2560, 10448), False), ("out_proj", (6, 5120, 2560), True),
            ("shared wq", (1, 2560, 2560), False), ("shared w_in", (1, 2560, 10240), False),
            ("shared w_out", (1, 10240, 2560), True)]}


def phase_ptxas_head_dims(ptxas: dict) -> None:
    """[17a] ptxas's registers, shared memory and spills of the three bf16
    flash sweeps at each head dim, side by side."""
    print(f"[17a] ptxas at the head dims {HEAD_DIMS} (registers, shared memory, spills)")
    for k in ("fwd", "dq", "dkv"):
        for hd in HEAD_DIMS:
            fn = f"flash_{k}_wgmma_kernel<{hd}>"
            print(f"  {fn}: {ptxas.get(fn)}")


def phase_matmul_ssm(torch, mm) -> dict:
    """[17b] matmul_epilogue at the SSM families' Newton-Schulz shapes: the
    mamba2-370m stacks in_proj [48, 1024, 4384] and out_proj [48, 2048, 1024]
    (transposed view), zamba2-2.7b's in_proj [6, 2560, 10448] and out_proj
    [6, 5120, 2560] (transposed; 17e's one superblock: the 4-D [ns, 6, ...]
    leaves fold into the stack) and the shared block's 2-D leaves as stacks
    of 1 (wq [2560, 2560], w_in [2560, 10240], w_out [10240, 2560]
    transposed); each product in all four operand layouts within 1e-5 of the
    largest output, the symmetric ones bitwise symmetric; X X^T and B X + a
    X of each in_proj timed beside the plain version, the bound and
    torch.baddbmm."""
    print("[17b] matmul_epilogue at mamba2-370m's and zamba2-2.7b's Newton-Schulz shapes, "
          "fp32, TF32 off")
    from repro_torch.optim.muon import NS_COEFFS

    na, nb, nc = NS_COEFFS
    gen = torch.Generator(device="cuda").manual_seed(23)
    out = {}
    for arch, leaves in SSM_NS_SHAPES.items():
        for name, shape, transposed in leaves:
            x = normed(torch.randn(shape, generator=gen, device="cuda"))
            x = x.mT if transposed else x  # m <= n, as Newton-Schulz takes it
            z, m, k = x.shape
            A = mm.matmul_epilogue(x, x.mT, symmetric=True)
            Bm = mm.matmul_epilogue(A, A, A, alpha=nc, beta=nb, symmetric=True)
            tag = f"{arch} {name} {list(shape)}" + (" transposed" if transposed else "")
            check_matmul_cases(torch, mm, [
                (f"X X^T, {tag}", x, x.mT, None, 1.0, 0.0, True),
                (f"c A A + b A, [{z}, {m}, {m}]", A, A, A, nc, nb, True),
                (f"B X + a X, [{z}, {m}, {m}] x [{z}, {m}, {k}]", Bm, x, x, 1.0, na, False)])
            if name == "in_proj":
                xx = time_matmul(torch, mm, f"X X^T, {tag}, symmetric=True", x, x.mT, None, 1.0,
                                 0.0, True, 2.0 * z * (m * (m + 1) // 2) * k,
                                 (x.numel() + z * m * m) * 4)
                bx = time_matmul(torch, mm, f"B X + a X, {tag}", Bm, x, x, 1.0, na, False,
                                 2.0 * z * m * m * k, (Bm.numel() + 2 * x.numel()) * 4)
                out[arch] = dict(xx=xx, bx=bx)
            del x, A, Bm
            torch.cuda.empty_cache()
    return out


def phase_ssm_decode_agreement(torch, get_config, build_model, arch: str, n_layers: int,
                               P: int = 256) -> None:
    """[17c] fp32 at full width, depth cut to ``n_layers``: decode_step
    stepped over a prompt of ``P`` tokens (the recurrent SSM update, and
    zamba2's ring cache) against the full forward's logits at every position
    (the chunked SSD and, for zamba2, the fp32 flash kernel), within 1e-3
    as 4a."""
    cfg = get_config(arch).replace(dtype="float32", attn_impl="pallas", n_layers=n_layers)
    dev = torch.device("cuda")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    B = 2
    toks = torch.randint(0, cfg.vocab, (B, P), generator=torch.Generator().manual_seed(9))
    toks = toks.to(dev, torch.int32)
    with torch.no_grad():
        full, _ = model.forward(params, toks)
        cache = model.init_cache(params, B, P)
        worst = 0.0
        for t in range(P):
            logits, cache = model.decode_step(params, cache, toks[:, t], t)
            worst = max(worst, (logits - full[:, t]).abs().max().item())
        assert torch.isfinite(full).all()
    check(f"{arch}, depth {n_layers}: {P} decode steps against the forward's logits", worst,
          1e-3)
    del params, cache, full
    torch.cuda.empty_cache()


def ssd_share(torch, cfg, B: int, S: int, layers: int, steps: int, busy_ms: float) -> float:
    """The chunked SSD scan's share of a round's device time: one layer's
    ``ssm._ssd`` forward and backward timed alone at the round's shapes (CUDA
    events, L2 flushed), times the forwards a worker step runs (two with
    remat: the backward recomputes it) and one backward, over ``layers`` x
    ``steps``, against ``busy_ms`` (the profiled round's device time)."""
    from repro_torch.models import ssm

    gen = torch.Generator(device="cuda").manual_seed(29)
    H, N = cfg.ssm_heads, cfg.ssm_state
    xs = torch.randn((B, S, cfg.d_inner), generator=gen, device="cuda").to(cfg.compute_dtype)
    Bm, Cm = (torch.randn((B, S, N), generator=gen, device="cuda").to(cfg.compute_dtype)
              for _ in "BC")
    dt = torch.rand((B, S, H), generator=gen, device="cuda") * 0.1
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    leaves = [t.requires_grad_(True) for t in (xs, dt, Bm, Cm)]
    y = ssm._ssd(cfg, leaves[0], leaves[1], A, leaves[2], leaves[3])
    g = torch.randn_like(y)
    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: ssm._ssd(cfg, xs, dt, A, Bm, Cm), runs=10)
    bwd_ms = time_ms(torch, lambda: torch.autograd.grad(y, leaves, g, retain_graph=True), runs=10)
    per_step = (2 if cfg.remat else 1) * fwd_ms + bwd_ms
    share = 100 * per_step * layers * steps / busy_ms
    print(f"  SSD scan (models/ssm._ssd) alone at [{B}, {S}], {H} heads: forward {fwd_ms:.3f} ms, "
          f"backward {bwd_ms:.3f} ms; x {layers} layers x {steps} worker steps "
          f"({'2 forwards with remat' if cfg.remat else '1 forward'}): {share:.1f}% of the "
          f"round's {busy_ms:.1f} ms device time")
    del y, leaves, g
    return share


def phase_mamba_train(torch, build_parser, train) -> dict:
    """[17d] mamba2-370m's training main path at full width and depth through
    the CLI (``TRAIN_MAMBA``): launches against the formula (matmul_epilogue
    30 a worker step, 3 products x 5 iterations x 2 Muon leaves; no flash),
    losses finite and falling, and (17d') a profiled replayed round with the
    SSD scan's share. (The eager repeat, 17d'', is cut for time; earlier
    full runs held it bitwise.)"""
    from repro_torch.utils.tree import tree_count_params

    args = build_parser().parse_args(TRAIN_MAMBA)
    launches, out = phase_train_main(torch, build_parser, train, TRAIN_MAMBA, phase="17d",
                                     kernels=("matmul_epilogue", "nesterov"), keep=True)
    steps = args.workers * args.sync_interval
    assert launches["matmul_epilogue"] == args.rounds * steps * 30, launches
    assert launches["flash_fwd"] == launches["flash_dq"] == launches["flash_dkv"] == 0, launches
    n_params = tree_count_params(out["state"]["outer_params"])
    cfg = out["model"].cfg
    prof = phase_train_profile(torch, out, TRAIN_MAMBA, tag="17d'",
                               focus=("matmul_epilogue_kernel",))
    share = ssd_share(torch, cfg, args.batch_per_worker, args.seq_len, cfg.n_layers, steps,
                      prof["busy_ms"])
    res = dict(launches=launches, tok_s=out["tok_s"], peak_gb=out["peak_gb"], idle=prof["idle"],
               replay_tok_s=prof["tok_s"], ssd_share=share, n_params=n_params, read=out["read"])
    del out
    torch.cuda.empty_cache()
    return res


def phase_zamba_train(torch, get_config, build_model) -> dict:
    """[17e] zamba2-2.7b at full width, depth cut to ``ZAMBA_TRAIN['depth']``
    (one superblock: 6 mamba layers and the shared block), one sequence of
    8192 a worker step (the window of 4096 masks), K = 2, H = 2, fp32
    params, bf16 compute, the hd-80 flash kernels, Newton-Schulz through
    matmul_epilogue (in_proj and out_proj as [6, ...] stacks, the shared
    block's 7 matrices as stacks of 1), the outer Nesterov kernel, the eval
    loss in the round. Round 1 is the warm-up (eager) and the capture,
    the later rounds replays; launches against the formula (flash_fwd twice a
    worker step with remat, once for the eval; flash_dq and flash_dkv once;
    matmul_epilogue 15 x 9 Muon leaves); losses finite and falling; (17e')
    one more replayed round profiled, with the SSD scan's share; the peak
    memory. (The eager repeat, 17e'', is cut for time; earlier full runs
    held it bitwise.)"""
    from repro_torch.core import DiLoCoConfig
    from repro_torch.data import DataConfig, MarkovStream, batches_for_round, batches_for_span
    from repro_torch.engine import TrainEngine, run_rounds
    from repro_torch.kernels import _build
    from repro_torch.optim import OptimizerConfig
    from repro_torch.utils.tree import tree_count_params

    T = ZAMBA_TRAIN
    K, H, B, S, n = T["K"], T["H"], T["batch"], T["seq_len"], T["rounds"]
    cfg = get_config(ZAMBA).replace(n_layers=T["depth"], max_seq_len=S, attn_impl="pallas")
    print(f"[17e] captured MuLoCo rounds, {ZAMBA} full width, depth {cfg.n_layers} mamba layers "
          f"+ the shared block: K {K}, H {H}, {B} x {S} tokens a worker step, window "
          f"{cfg.sliding_window}, fp32 params, --ns-impl pallas, --outer-kernel, inner lr "
          f"{T['lr']}, {n} rounds (the first the warm-up)")
    model = build_model(cfg)
    dcfg = DiLoCoConfig(n_workers=K, sync_interval=H, inner_name="muon", ns_impl="pallas",
                        outer_kernel=True)
    icfg = OptimizerConfig(lr=T["lr"], weight_decay=1e-4, schedule="cosine", warmup_steps=5,
                           total_steps=n * H)
    dkw = dict(vocab=cfg.vocab, seq_len=S, batch_per_worker=B)
    data = MarkovStream(DataConfig(**dkw, n_workers=K, seed=0), "cuda")
    evals = MarkovStream(DataConfig(**dkw, n_workers=1, seed=10_000), "cuda")

    def eval_for(r0, m):
        return {k: v[:, 0] for k, v in evals.batch_stack(r0, m).items()}

    def run():
        engine = TrainEngine(model, dcfg, icfg)
        state = engine.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        state, hist = run_rounds(engine, state, lambda r: batches_for_round(data, r, H), n,
                                 rounds_per_dispatch=1,
                                 span_batches_for=lambda r0, m: batches_for_span(data, r0, H, m),
                                 eval_batches_for=eval_for)
        torch.cuda.synchronize()
        return engine, state, hist

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    engine, state, hist = run()
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = tree_count_params(state["outer_params"])
    per_round = engine.launches_per_round(state["outer_params"])
    want = {k: n * v for k, v in per_round.items()}
    print(f"  {n_params:,} parameters; launches {launches}")
    print(f"  formula  {want} (rounds x TrainEngine.launches_per_round)")
    assert launches == want, (launches, want)
    steps, ns = K * H, cfg.n_layers // cfg.hybrid_period
    assert per_round["flash_fwd"] == (2 * steps + 1) * ns, per_round
    assert per_round["flash_dq"] == per_round["flash_dkv"] == steps * ns, per_round
    assert per_round["matmul_epilogue"] == steps * 3 * 5 * 9, per_round
    check_captures(engine, per_round, n, [(True, False)])
    losses = [r["train_loss"] for r in hist]
    evl = [r["eval_loss"] for r in hist]
    assert all(math.isfinite(v) for v in losses + evl), (losses, evl)
    assert losses[-1] < losses[0] and evl[-1] < evl[0], (losses, evl)
    read = round_read("17e", cfg, engine, state, hist, B, S, peak_gb)
    tokens = K * H * B * S
    print(f"  losses {[round(v, 4) for v in losses]}, eval {[round(v, 4) for v in evl]}; round "
          f"walls {[round(r['wall_s'], 3) for r in hist]} s (round 1: warm-up "
          f"{engine.warmup_s[0]:.3f} s + capture {engine.capture_s[0]:.3f} s); peak device "
          f"memory {peak_gb:.2f} GB")
    later = hist[1:]
    tok_s = len(later) * tokens / sum(r["wall_s"] for r in later)

    def dispatch(i):
        nonlocal state
        state, _ = engine.superstep(state, batches_for_span(data, n + i, H, 1),
                                    eval_for(n + i, 1))

    print("[17e'] profile: one more replayed round, then one under torch.profiler")
    replays = engine.replays
    prof = profile_dispatch(torch, dispatch, tokens, "1 round a dispatch")
    assert engine.replays == replays + 2, "the profiled rounds were not replays"
    print_focus(prof["by_name"], prof["wall_ms"], ("flash_fwd_wgmma_kernel",
                                                   "flash_dq_wgmma_kernel",
                                                   "flash_dkv_wgmma_kernel",
                                                   "matmul_epilogue_kernel"))
    share = ssd_share(torch, cfg, B, S, cfg.n_layers, steps, prof["busy_ms"])
    del engine, state, model
    torch.cuda.empty_cache()
    return dict(launches=launches, peak_gb=peak_gb, tok_s=tok_s, replay_tok_s=prof["tok_s"],
                idle=prof["idle"], ssd_share=share, n_params=n_params, read=read)


def ssm_decode_floor_ms(params, cache, batch: int) -> tuple[float, float, float]:
    """The memory-bound floor of one naive decode step: every weight read once
    (of the untied embedding only the ``batch`` gathered rows), the SSM state
    (h and the conv buffer) read and written once, and zamba2's ring cache
    read once, at 3.35 TB/s. Returns (ms, weight bytes, state bytes)."""
    from repro_torch.utils.tree import tree_bytes

    emb = params["embed"]
    weights = tree_bytes(params) - tree_bytes(emb) + batch * emb.shape[1] * emb.element_size()
    state = 2 * tree_bytes(cache.get("ssm", cache)) + (tree_bytes(cache["attn"])
                                                       if "attn" in cache else 0)
    return (weights + state) / HBM_BW * 1e3, weights, state


def phase_ssm_serve(torch, get_config, serve, arch: str, overrides: dict | None = None) -> dict:
    """[17f] serving through the naive engine: ``SSM_SERVE`` (32 requests x
    (32 prompt + 32 new), greedy) as one lockstep batch, the prompt stepped
    through the decode path: tok/s; peak memory; no kernel launched (the
    reference's SSM and hybrid serving has no Pallas kernel: the recurrent
    update and the ring cache's one-token attention are plain). The steps
    are eager and bound by the host, ~60-95 ms a step, so the run-to-run
    check runs 32 requests of ``SERVE_REPEAT`` (prompt, new) tokens twice
    through ``launch.serve.generate`` on the same weights: greedy tokens
    bitwise equal. Then three decode steps of
    the batch under torch.profiler: a step's device time beside its floor
    (:func:`ssm_decode_floor_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate, random_prompts

    print(f"[17f] {arch} serving through the naive engine (stepped prefill), full width and "
          f"depth{' ' + str(overrides) if overrides else ''}: {SSM_SERVE['batch']} x "
          f"({SSM_SERVE['prompt_len']} + {SSM_SERVE['max_new']}) greedy, as one lockstep batch")
    cfg = get_config(arch).replace(attn_impl="pallas", **(overrides or {}))
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    first, seconds, _, model, params = serve(cfg, engine="naive", device="cuda", **SSM_SERVE)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert not launches, launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for rid, toks in first.items():
        assert toks.shape == (SSM_SERVE["max_new"],) and ((toks >= 0) & (toks < cfg.vocab)).all()
    prompts = random_prompts(cfg.vocab, SSM_SERVE["batch"], SERVE_REPEAT[0]).to("cuda", torch.int32)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(generate(model, params, prompts, SERVE_REPEAT[1]))
        torch.cuda.synchronize()
    seconds2 = time.perf_counter() - t0
    assert torch.equal(runs[0], runs[1]), "the repeated run's greedy tokens differ"
    del runs
    n_new = SSM_SERVE["batch"] * SSM_SERVE["max_new"]
    steps = SSM_SERVE["prompt_len"] + SSM_SERVE["max_new"] - 1
    tok_s = n_new / seconds
    host_step_ms = 1e3 * seconds / steps
    print(f"  {param_count(cfg):,} parameters; generated {n_new} tokens in {seconds:.3f} s "
          f"({tok_s:.1f} tok/s; {steps} decode steps, {host_step_ms:.2f} ms a step on the "
          f"host's clock); no kernel launched; peak {peak_gb:.2f} GB; two runs of "
          f"{SERVE_REPEAT[0]} + {SERVE_REPEAT[1]} tokens (the second {seconds2:.3f} s): greedy "
          "tokens bitwise equal")
    B = SSM_SERVE["batch"]
    with torch.no_grad():
        cache = model.init_cache(params, B, SSM_SERVE["prompt_len"] + SSM_SERVE["max_new"])
        tok = torch.zeros((B,), dtype=torch.int32, device="cuda")
        for t in range(3):  # warm
            model.decode_step(params, cache, tok, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for t in range(3, 6):
                model.decode_step(params, cache, tok, t)
            torch.cuda.synchronize()
    by_name = device_times(torch, prof)
    step_ms = sum(v[0] for v in by_name.values()) / 3
    kernels = sum(v[1] for v in by_name.values()) / 3
    floor_ms, wbytes, sbytes = ssm_decode_floor_ms(params, cache, B)
    print(f"  a decode step: {kernels:.0f} kernels, {step_ms:.4f} ms device time (profiled, "
          f"mean of 3) beside its floor {floor_ms:.4f} ms (weights {wbytes / 1e9:.3f} GB read, "
          f"state {sbytes / 1e9:.3f} GB moved, 3.35 TB/s): {step_ms / floor_ms:.2f}x; the host "
          f"takes {host_step_ms:.2f} ms a step")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms / 3:9.4f} ms a step  x{n // 3:<5d} {name}")
    del cache, params, model
    torch.cuda.empty_cache()
    return dict(tok_s=tok_s, step_ms=step_ms, floor_ms=floor_ms, peak_gb=peak_gb,
                host_step_ms=host_step_ms)


def slice_7a(torch, mods: dict, get_config, build_model, build_parser, train, serve,
             ptxas: dict, smi: str) -> dict:
    """Phase 17: the SSM and hybrid families. (17a) the flash kernels at hd
    80 against their plain versions (``FLASH_FWD_CASES[80]``,
    ``FLASH_BWD_CASES[80]``: ragged S, causal, windowed, non-causal, G = 1,
    2 and 8, bf16 and fp32, bitwise from run to run), timed at zamba2's
    training shape q [32, 8192, 1, 80] with the window 4096 beside the
    bound, the plain version and SDPA (the window as a boolean mask), and
    ptxas's report at hd 64, 80, 112 and 128; (17b) matmul_epilogue at the SSM
    Newton-Schulz shapes; (17c) fp32 agreements at full width; (17d)
    mamba2-370m training; (17e) zamba2-2.7b training, depth cut; (17f) both
    served through the naive engine. Returns the kernels' rows."""
    import gc

    fa, mm = mods["fa"], mods["mm"]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[17] {MAMBA} ({param_count(get_config(MAMBA)):,} parameters) and {ZAMBA} "
          f"({param_count(get_config(ZAMBA)):,}); {torch.cuda.memory_allocated() / 1e9:.2f} "
          "GB held by earlier phases")
    phase_ptxas_head_dims(ptxas)
    flash = phase_flash(torch, fa, hd=80, phase="17a")
    bwd = phase_flash_bwd(torch, fa, hd=80, phase="17a")
    torch.cuda.empty_cache()
    lap("17a")
    matmul = phase_matmul_ssm(torch, mm)
    lap("17b")
    print("[17c] full-width fp32 agreements")
    phase_train_agreement(torch, get_config, build_model, MAMBA, "17c", n_layers=2, S=256)
    phase_train_agreement(torch, get_config, build_model, ZAMBA, "17c",
                          n_layers=ZAMBA_TRAIN["depth"], S=8192)
    phase_ssm_decode_agreement(torch, get_config, build_model, MAMBA, 2)
    phase_ssm_decode_agreement(torch, get_config, build_model, ZAMBA, ZAMBA_TRAIN["depth"])
    lap("17c")
    mamba = phase_mamba_train(torch, build_parser, train)
    lap("17d")
    zamba = phase_zamba_train(torch, get_config, build_model)
    lap("17e")
    serving = {MAMBA: phase_ssm_serve(torch, get_config, serve, MAMBA),
               ZAMBA: phase_ssm_serve(torch, get_config, serve, ZAMBA,
                                      dict(param_dtype="bfloat16"))}
    lap("17f")
    for arch, t in ((MAMBA, mamba), (ZAMBA, zamba)):
        depth = "full depth" if arch == MAMBA else f"depth {ZAMBA_TRAIN['depth']} + shared block"
        print(f"{arch} training ({depth}, {t['n_params']:,} parameters, K 2, H 2, 8192 tokens a "
              f"worker step): {t['tok_s']:.1f} tokens/s over the replayed rounds, one profiled "
              "replayed "
              f"round {t['replay_tok_s']:.1f}, idle {t['idle']:.1f}%, SSD scan "
              f"{t['ssd_share']:.1f}% of the device time, peak {t['peak_gb']:.2f} GB; card "
              f"(nvidia-smi name, power.limit): {smi}")
        s = serving[arch]
        print(f"{arch} serving (naive engine, full depth, {SSM_SERVE['batch']} x "
              f"({SSM_SERVE['prompt_len']} + {SSM_SERVE['max_new']}), stepped prefill): "
              f"{s['tok_s']:.1f} "
              f"tok/s, a decode step {s['step_ms']:.4f} ms on the card against its floor "
              f"{s['floor_ms']:.4f} ms and {s['host_step_ms']:.2f} ms on the host's clock; peak "
              f"{s['peak_gb']:.2f} GB; no kernel launched (the reference serves these families "
              f"with no Pallas kernel); card (nvidia-smi name, power.limit): {smi}")
    ml, zl = mamba["launches"], zamba["launches"]
    return {"flash_fwd": {ZAMBA: {"launches": zl["flash_fwd"], **flash["training"]}},
            "flash_dq": {ZAMBA: {"launches": zl["flash_dq"], **bwd["flash_dq"]}},
            "flash_dkv": {ZAMBA: {"launches": zl["flash_dkv"], **bwd["flash_dkv"]}},
            "matmul_epilogue": {MAMBA: {"launches": ml["matmul_epilogue"], **matmul[MAMBA]["xx"],
                                        "b_x_plus_a_x": matmul[MAMBA]["bx"]},
                                ZAMBA: {"launches": zl["matmul_epilogue"], **matmul[ZAMBA]["xx"],
                                        "b_x_plus_a_x": matmul[ZAMBA]["bx"]}},
            "nesterov": {MAMBA: {"launches": ml["nesterov"]},
                         ZAMBA: {"launches": zl["nesterov"]}},
            "reads": [mamba["read"], zamba["read"]]}


# ---------------------------------------------------------------------------
# Slice 8: the audio and VLM families (18): whisper-large-v3 and
# llama-3.2-vision-90b
# ---------------------------------------------------------------------------

WHISPER, VLM = "whisper-large-v3", "llama-3.2-vision-90b"
# 18a: the kernel shapes the slice brings. whisper's encoder: 4 sequences x 20
# kv heads of 1500 frames at hd 64, non-causal (a ragged 28-key tail on the
# 64-key tile), the 18d round's shape; the VLM's self layers: one sequence of
# 2048 tokens x 8 kv heads at hd 128 with G = 8 (64:8 heads), causal, 18f's
WHISPER_FWD_CASES = [(4 * 20, 1500, 1, _BF16, False, 0, "whisper encoder"),
                     (4 * 20, 1500, 1, _FP32, False, 0, None)]
VLM_FWD_CASES = [(8, 2048, 8, _BF16, True, 0, "vlm self"),
                 (8, 2048, 8, _FP32, True, 0, None)]
WHISPER_BWD_CASES = [(4, 20, 1500, 1, _BF16, False, 0), (4, 20, 1500, 1, _FP32, False, 0)]
VLM_BWD_CASES = [(1, 8, 2048, 8, _BF16, True, 0), (1, 8, 2048, 8, _FP32, True, 0)]
# 18d: one MuLoCo run of whisper-large-v3 at full width and depth: K 2, H 2,
# B sequences of 448 decoder tokens (whisper's context length) with their
# [B, 1500, 1280] frames a worker step, 3 rounds (warm-up and capture, two
# replays: at 2 the train loss of the second round does not fall), the
# training command's lr
# 2 rounds (the warm-up and capture, one replay) of an LR schedule that spans 3
WHISPER_TRAIN = dict(K=2, H=2, batch=4, seq_len=448, rounds=2, schedule_rounds=3, lr=3e-3)
# 18e / 18f: the served workloads, (requests, prompt, new tokens)
WHISPER_SERVE = dict(batch=4, prompt_len=16, max_new=64)
WHISPER_REPEAT_NEW = 8  # 18e's run-to-run and context checks: new tokens a run
VLM_SERVE = dict(batch=4, prompt_len=16, max_new=32)
# 18f: the VLM at full width, depth cut to one superblock (1 gated cross and
# 4 self layers), bf16 weights; one sequence of 2048 tokens differentiated
VLM_DEPTH, VLM_SEQ = 5, 2048
# 18f: the self layers' attention leaves ([1, 4, ...] stacks), each held on
# its own: a fault in one flash kernel moves these leaves' gradients, and
# hardly the whole tree's norm. On an H100 the sound run reads 1.08e-2 to
# 1.55e-2 here; query head G - 1 dropped from flash_dq or flash_dkv reads
# 0.357 and 0.431 on the leaf it feeds (tools/chip_probe.py --faults),
# while dq's fault moves the whole tree's error only to 3.79e-2
VLM_ATTN_LEAVES = tuple(f"self_layers/attn/{w}" for w in ("wq", "wk", "wv", "wo"))
VLM_ATTN_TOL = 3e-2


def context_draw(torch, cfg, lead: tuple, seed: int):
    """Audio frames or image patches [*lead, N, d_model] in the compute
    dtype, a normal draw from a generator seeded with ``seed``."""
    n = cfg.n_audio_frames if cfg.arch_type == "audio" else cfg.n_image_tokens
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((*lead, n, cfg.d_model), generator=gen, device="cuda").to(cfg.compute_dtype)


def phase_matmul_whisper(torch, mm) -> tuple[dict, dict]:
    """[18b] matmul_epilogue at whisper-large-v3's Newton-Schulz shapes: the
    MLP stacks [32, 1280, 5120] (w_in; w_out taken transposed) and the
    square attention stacks [32, 1280, 1280] (1280 = 13 x 96 + 32, ragged on
    the 96-wide tile), each product in all four operand layouts within 1e-5
    of the largest output, the symmetric ones bitwise symmetric; X X^T on
    w_in (symmetric) and B X + a X [32, 1280, 1280] x [32, 1280, 5120] timed
    beside the plain version, the bound and torch.baddbmm."""
    print("[18b] matmul_epilogue at whisper-large-v3's Newton-Schulz shapes, fp32, TF32 off")
    from repro_torch.optim.muon import NS_COEFFS

    na, nb, nc = NS_COEFFS
    gen = torch.Generator(device="cuda").manual_seed(31)
    x = normed(torch.randn((32, 1280, 5120), generator=gen, device="cuda"))
    xs = normed(torch.randn((32, 1280, 1280), generator=gen, device="cuda"))
    A = mm.matmul_epilogue(x, x.mT, symmetric=True)
    Bm = mm.matmul_epilogue(A, A, A, alpha=nc, beta=nb, symmetric=True)
    As = mm.matmul_epilogue(xs, xs.mT, symmetric=True)
    Bs = mm.matmul_epilogue(As, As, As, alpha=nc, beta=nb, symmetric=True)
    check_matmul_cases(torch, mm, [
        ("X X^T, w_in stack [32, 1280, 5120]", x, x.mT, None, 1.0, 0.0, True),
        ("c A A + b A, [32, 1280, 1280]", A, A, A, nc, nb, True),
        ("B X + a X, [32, 1280, 1280] x [32, 1280, 5120]", Bm, x, x, 1.0, na, False),
        ("X X^T, wq stack [32, 1280, 1280]", xs, xs.mT, None, 1.0, 0.0, True),
        ("B X + a X, wq stack [32, 1280, 1280] x [32, 1280, 1280]", Bs, xs, xs, 1.0, na, False)])
    z, m, k = x.shape
    xx = time_matmul(torch, mm, "X X^T, w_in stack [32, 1280, 5120], symmetric=True", x, x.mT,
                     None, 1.0, 0.0, True, 2.0 * z * (m * (m + 1) // 2) * k,
                     (x.numel() + z * m * m) * 4)
    bx = time_matmul(torch, mm, "B X + a X, [32, 1280, 1280] x [32, 1280, 5120]", Bm, x, x, 1.0,
                     na, False, 2.0 * z * m * m * k, (Bm.numel() + 2 * x.numel()) * 4)
    del x, xs, A, Bm, As, Bs
    torch.cuda.empty_cache()
    return xx, bx


def phase_whisper_agreement(torch, get_config, build_model) -> None:
    """[18c] whisper-large-v3 at full width and depth in fp32: the kernel path
    (attn_impl pallas: the encoder's non-causal and the decoder's causal fp32
    flash_fwd) against the plain torch path (xla) on one context, forward
    logits within 1e-3 (as 4a); then fill_context (the encoder through the
    kernel, every decoder layer's cross K/V) and three decode steps, each
    step's logits against the forward's at its position (1e-3)."""
    print(f"[18c] full-width fp32 agreement, {WHISPER}: attn_impl pallas (kernels) vs xla (plain "
          "torch), then fill_context + 3 decode steps against the forward")
    dev = torch.device("cuda")
    base = get_config(WHISPER).replace(dtype="float32")
    model_k, model_p = build_model(base.replace(attn_impl="pallas")), build_model(base)
    params = model_k.init(torch.Generator(device=dev).manual_seed(0), dev)
    B, S = 2, 64
    toks = torch.randint(0, base.vocab, (B, S), generator=torch.Generator().manual_seed(5))
    toks = toks.to(dev, torch.int32)
    ctx = context_draw(torch, base, (B,), 41)
    with torch.no_grad():
        lk, _ = model_k.forward(params, toks, context=ctx)
        lp, _ = model_p.forward(params, toks, context=ctx)
        assert torch.isfinite(lk).all()
        check("forward logits (pallas vs xla)", (lk - lp).abs().max().item(), 1e-3)
        cache = model_k.fill_context(params, model_k.init_cache(params, B, S), ctx)
        for t in range(3):
            logits, cache = model_k.decode_step(params, cache, toks[:, t], t)
            err = (logits - lk[:, t]).abs().max().item()
            check(f"decode step {t} logits against the forward's", err, 1e-3)
    del params, cache, lk, lp
    torch.cuda.empty_cache()


def phase_whisper_train(torch, get_config, build_model, mm_ms: dict) -> dict:
    """[18d] whisper-large-v3 at full width and depth through TrainEngine
    (``WHISPER_TRAIN``): K = 2, H = 2, fp32 params, bf16 compute, the flash
    kernels (the encoder's 32 non-causal layers and the decoder's 32 causal
    ones), Newton-Schulz through matmul_epilogue (17 Muon leaves), the outer
    Nesterov kernel, each worker step B sequences of 448 tokens with their
    frames (the batch's "context" leaf, a seeded draw a round), the eval loss
    in the round. Round 1 is the warm-up (eager) and the capture, the later
    rounds replays: launches against the formula (flash_fwd twice a worker
    step with remat and once for the eval, 64 layers; flash_dq and
    flash_dkv once; matmul_epilogue 15 x 17); losses finite and falling;
    (18d') one more replayed round profiled: the shares of matmul_epilogue,
    the flash kernels and the rest; (18d'') the same rounds eager, bitwise
    (the state compared leaf by leaf against a host copy); the peak memory."""
    from repro_torch.core import DiLoCoConfig
    from repro_torch.data import DataConfig, MarkovStream, batches_for_round, batches_for_span
    from repro_torch.engine import TrainEngine, run_rounds
    from repro_torch.kernels import _build
    from repro_torch.optim import OptimizerConfig, muon_label
    from repro_torch.utils.tree import tree_count_params, tree_leaves_with_paths, tree_map

    T = WHISPER_TRAIN
    K, H, B, S, n = T["K"], T["H"], T["batch"], T["seq_len"], T["rounds"]
    cfg = get_config(WHISPER).replace(max_seq_len=S, attn_impl="pallas")
    F = cfg.n_audio_frames
    print(f"[18d] captured MuLoCo rounds, {WHISPER} full width and depth: K {K}, H {H}, {B} x {S} "
          f"tokens and {B} x {F} frames a worker step, fp32 params, --ns-impl pallas, "
          f"--outer-kernel, inner lr {T['lr']}, {n} rounds (the first the warm-up)")
    model = build_model(cfg)
    dcfg = DiLoCoConfig(n_workers=K, sync_interval=H, inner_name="muon", ns_impl="pallas",
                        outer_kernel=True)
    icfg = OptimizerConfig(lr=T["lr"], weight_decay=1e-4, schedule="cosine", warmup_steps=1,
                           total_steps=T["schedule_rounds"] * H)
    dkw = dict(vocab=cfg.vocab, seq_len=S, batch_per_worker=B)
    data = MarkovStream(DataConfig(**dkw, n_workers=K, seed=0), "cuda")
    evals = MarkovStream(DataConfig(**dkw, n_workers=1, seed=10_000), "cuda")

    def frames(lead, r0, m, seed):  # m rounds' frames, stacked
        return torch.stack([context_draw(torch, cfg, lead, seed + r) for r in range(r0, r0 + m)])

    def round_batches(r):
        return {**batches_for_round(data, r, H), "context": frames((H, K, B), r, 1, 1000)[0]}

    def span_batches(r0, m):
        return {**batches_for_span(data, r0, H, m), "context": frames((H, K, B), r0, m, 1000)}

    def eval_for(r0, m):
        return {**{k: v[:, 0] for k, v in evals.batch_stack(r0, m).items()},
                "context": frames((B,), r0, m, 2000)}

    def run(capture):
        engine = TrainEngine(model, dcfg, icfg, capture=capture)
        state = engine.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        state, hist = run_rounds(engine, state, round_batches, n, rounds_per_dispatch=1,
                                 span_batches_for=span_batches, eval_batches_for=eval_for)
        torch.cuda.synchronize()
        return engine, state, hist

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    engine, state, hist = run(None)
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    count = tree_count_params(state["outer_params"])
    per_round = engine.launches_per_round(state["outer_params"])
    want = {k: n * v for k, v in per_round.items()}
    print(f"  {count:,} parameters; launches {launches}")
    print(f"  formula  {want} (rounds x TrainEngine.launches_per_round)")
    assert launches == want, (launches, want)
    steps, L = K * H, model.attention_layers
    n_muon = sum(muon_label(p, t) == "muon" for p, t in tree_leaves_with_paths(state["outer_params"]))
    assert L == cfg.n_encoder_layers + cfg.n_layers and n_muon == 17, (L, n_muon)
    assert per_round["flash_fwd"] == (2 * steps + 1) * L, per_round
    assert per_round["flash_dq"] == per_round["flash_dkv"] == steps * L, per_round
    assert per_round["matmul_epilogue"] == steps * 3 * 5 * n_muon, per_round
    check_captures(engine, per_round, n, [(True, False)])
    losses = [r["train_loss"] for r in hist]
    evl = [r["eval_loss"] for r in hist]
    assert all(math.isfinite(v) for v in losses + evl), (losses, evl)
    assert losses[-1] < losses[0] and evl[-1] < evl[0], (losses, evl)
    read = round_read("18d", cfg, engine, state, hist, B, S, peak_gb)
    tokens, n_frames = steps * B * S, steps * B * F
    later = hist[1:]
    wall = sum(r["wall_s"] for r in later)
    tok_s, frames_s = len(later) * tokens / wall, len(later) * n_frames / wall
    print(f"  losses {[round(v, 4) for v in losses]}, eval {[round(v, 4) for v in evl]}; round "
          f"walls {[round(r['wall_s'], 3) for r in hist]} s (round 1: warm-up "
          f"{engine.warmup_s[0]:.3f} s + capture {engine.capture_s[0]:.3f} s); rounds 2-{n}: "
          f"{tok_s:.1f} decoder tokens/s ({frames_s:.1f} frames/s); peak device memory "
          f"{peak_gb:.2f} GB")
    ref_hist = hist
    ref_host = tree_map(lambda t: t.to("cpu", copy=True), state)

    def dispatch(i):
        nonlocal state
        state, _ = engine.superstep(state, span_batches(n + i, 1), eval_for(n + i, 1))

    print("[18d'] profile: one more replayed round, then one under torch.profiler")
    replays = engine.replays
    prof = profile_dispatch(torch, dispatch, tokens, "1 round a dispatch")
    assert engine.replays == replays + 2, "the profiled rounds were not replays"
    print_focus(prof["by_name"], prof["wall_ms"], ("flash_fwd_wgmma_kernel",
                                                   "flash_dq_wgmma_kernel",
                                                   "flash_dkv_wgmma_kernel",
                                                   "matmul_epilogue_kernel"),
                beside={"matmul_epilogue_kernel": ("18b (X X^T on w_in, symmetric)",
                                                   mm_ms["ms"])})
    busy = prof["busy_ms"]
    shares = {}
    for key in ("matmul_epilogue", "flash_"):
        shares[key] = 100 * sum(ms for name, (ms, _) in prof["by_name"].items()
                                if key in name) / busy
    shares["rest"] = 100 - sum(shares.values())
    print(f"  of the round's {busy:.1f} ms device time: matmul_epilogue "
          f"{shares['matmul_epilogue']:.1f}%, the flash kernels {shares['flash_']:.1f}%, the rest "
          f"{shares['rest']:.1f}%")
    del engine, state
    torch.cuda.empty_cache()
    print("[18d''] the same rounds eager (capture=False)")
    engine, state, hist = run(False)
    keys = ("train_loss", "train_loss_last", "eval_loss", "comm_bytes")
    for a, b in zip(ref_hist, hist):
        for k in keys:
            assert a[k] == b[k], ("eager", a["round"], k, a[k], b[k])
    diffs = _state_diffs_host(torch, ref_host, state)
    assert not diffs, diffs
    print(f"  eager: {len(hist)} rounds' {', '.join(keys)} and every state leaf bitwise equal "
          "to the captured run's")
    del engine, state, ref_host, model
    torch.cuda.empty_cache()
    return dict(launches=launches, peak_gb=peak_gb, tok_s=tok_s, frames_s=frames_s,
                replay_tok_s=prof["tok_s"], idle=prof["idle"], shares=shares, n_params=count,
                read=read)


def decode_profile(torch, model, params, cache, batch: int, pos: int) -> float:
    """A decode step's device time (torch.profiler, mean of 3 steps after 3
    warm ones from position ``pos``), printed with its busiest kernels."""
    from torch.profiler import ProfilerActivity, profile

    tok = torch.zeros((batch,), dtype=torch.int32, device="cuda")
    with torch.no_grad():
        for t in range(pos, pos + 3):
            model.decode_step(params, cache, tok, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for t in range(pos + 3, pos + 6):
                model.decode_step(params, cache, tok, t)
            torch.cuda.synchronize()
    by_name = device_times(torch, prof)
    step_ms = sum(v[0] for v in by_name.values()) / 3
    kernels = sum(v[1] for v in by_name.values()) / 3
    print(f"  a decode step: {kernels:.0f} kernels, {step_ms:.4f} ms device time (profiled, mean "
          "of 3)")
    for name, (ms, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"    {ms / 3:9.4f} ms a step  x{c // 3:<5d} {name}")
    return step_ms


def phase_whisper_serve(torch, get_config, serve) -> dict:
    """[18e] whisper-large-v3 served through ``launch.serve.serve(engine=
    'naive')`` at full width and depth (fp32 weights, bf16 compute,
    ``WHISPER_SERVE``: 4 requests of 16 prompt + 64 new tokens, greedy, the
    reference's zero context): fill_context runs the encoder once, its 32
    non-causal flash_fwd launches counted against the formula (the encoder
    layers; the decode steps launch none), then the prompt and the new tokens
    are stepped through the decode path. The same prompts and context
    through ``generate`` again (``WHISPER_REPEAT_NEW`` new tokens: greedy,
    so the first run's prefix) give the same tokens bitwise, and a seeded
    random context other tokens. Tok/s, the host's time a step, a step's
    device time (profiled)."""
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate, random_prompts, zero_context
    from repro_torch.models.whisper import _n_encoder

    W = WHISPER_SERVE
    print(f"[18e] {WHISPER} serving through the naive engine, full width and depth, fp32 weights, "
          f"bf16 compute: {W['batch']} x ({W['prompt_len']} + {W['max_new']}) greedy, zero context")
    cfg = get_config(WHISPER).replace(attn_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    first, seconds, _, model, params = serve(cfg, engine="naive", device="cuda", **W)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert launches == {"flash_fwd": _n_encoder(cfg)}, launches
    for toks in first.values():
        assert toks.shape == (W["max_new"],) and ((toks >= 0) & (toks < cfg.vocab)).all()
    prompts = random_prompts(cfg.vocab, W["batch"], W["prompt_len"]).to("cuda", torch.int32)
    n = WHISPER_REPEAT_NEW  # greedy: a shorter repeat is the first run's prefix
    again = generate(model, params, prompts, n,
                     context=zero_context(cfg, W["batch"], "cuda"))[:, W["prompt_len"]:].cpu()
    assert all((again[i].numpy() == first[f"req{i}"][:n]).all() for i in range(W["batch"])), \
        "the repeated run's greedy tokens differ"
    other = generate(model, params, prompts, n,
                     context=context_draw(torch, cfg, (W["batch"],), 43))[:, W["prompt_len"]:]
    differ = int((other.cpu() != again).sum())
    assert differ > 0, "another context gave the same tokens"
    n_new = W["batch"] * W["max_new"]
    steps = W["prompt_len"] + W["max_new"] - 1
    tok_s, host_step_ms = n_new / seconds, 1e3 * seconds / steps
    print(f"  launches {launches} ({_n_encoder(cfg)} encoder layers, one fill_context); generated "
          f"{n_new} tokens in {seconds:.3f} s ({tok_s:.1f} tok/s; {steps} decode steps, "
          f"{host_step_ms:.2f} ms a step on the host's clock, the encoder included); peak "
          f"{peak_gb:.2f} GB; a second run of {n} new tokens bitwise equal to the first's, a "
          f"random context changes {differ} of its {W['batch'] * n}")
    with torch.no_grad():
        cache = model.init_cache(params, W["batch"], W["prompt_len"] + W["max_new"])
        model.fill_context(params, cache, zero_context(cfg, W["batch"], "cuda"))
        step_ms = decode_profile(torch, model, params, cache, W["batch"], 0)
    del cache, params, model
    torch.cuda.empty_cache()
    return dict(tok_s=tok_s, host_step_ms=host_step_ms, step_ms=step_ms, peak_gb=peak_gb,
                launches=launches)


def vlm_grads(torch, model, params, batch) -> tuple:
    """One forward and backward of ``batch``: (loss, {leaf path: gradient})."""
    from repro_torch.utils.tree import tree_leaves_with_paths

    paths, leaves = zip(*tree_leaves_with_paths(params))
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), dict(zip(paths, grads))


def grad_errors(grads: dict, ref: dict) -> tuple[float, dict]:
    """The relative error ||g - g_ref|| / ||g_ref|| over the whole tree, and
    leaf by leaf (leaves whose reference is zero left out)."""
    num = den = 0.0
    per_leaf = {}
    for path, g in grads.items():
        d2 = (g.float() - ref[path].float()).square().sum().item()
        p2 = ref[path].float().square().sum().item()
        num, den = num + d2, den + p2
        if p2 > 0:
            per_leaf[path] = (d2 / p2) ** 0.5
    return (num / den) ** 0.5, per_leaf


def phase_vlm(torch, get_config, build_model, after_grads=None) -> dict:
    """[18f] llama-3.2-vision-90b at full width, depth cut to one superblock
    (``VLM_DEPTH``: 1 gated cross + 4 self layers), bf16 weights, the gates
    opened (``gate``, ``mlp_gate`` = 1, as the reference's serving test
    opens them, so the cross path does work): served through the naive
    engine (``launch.serve.generate``, ``VLM_SERVE``: 4 requests of 16 + 32
    tokens over 1600 seeded image tokens; twice bitwise, another context
    other tokens; no kernel launched: the decode path is plain), then one
    forward and backward of one sequence of ``VLM_SEQ`` tokens through the
    kernels (flash_fwd twice a self layer with remat, flash_dq and
    flash_dkv once, all at G = 8, hd 128) against the plain path (xla): the
    loss within 1e-2 (bf16 logits: ~0.1% of the loss, ln V = 11.76), the
    gradients' relative error (||g_k - g_p|| / ||g_p||, globally and the
    largest of any leaf) printed, the global one under 5e-2, and each of
    the self layers' attention leaves (``VLM_ATTN_LEAVES``) under
    ``VLM_ATTN_TOL``. ``after_grads(model, params, batch, plain grads)``,
    when given, runs before the weights are freed."""
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate, random_prompts

    V = VLM_SERVE
    cfg = get_config(VLM).replace(n_layers=VLM_DEPTH, param_dtype="bfloat16", attn_impl="pallas")
    count = param_count(cfg)
    print(f"[18f] {VLM} full width, depth {cfg.n_layers} (one superblock), bf16 weights "
          f"({count:,} parameters), gates open: {V['batch']} x ({V['prompt_len']} + "
          f"{V['max_new']}) through the naive engine, then one {VLM_SEQ}-token forward and "
          "backward, kernels against the plain path")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    cl = params["cross_layers"]
    cl["attn"]["gate"].fill_(1.0)
    cl["mlp_gate"].fill_(1.0)
    prompts = random_prompts(cfg.vocab, V["batch"], V["prompt_len"]).to("cuda", torch.int32)
    ctx = context_draw(torch, cfg, (V["batch"],), 45)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(model, params, prompts, V["max_new"], context=ctx)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)
    again = generate(model, params, prompts, V["max_new"], context=ctx)
    other = generate(model, params, prompts, V["max_new"],
                     context=context_draw(torch, cfg, (V["batch"],), 46))
    assert torch.equal(toks, again), "the repeated run's greedy tokens differ"
    new = slice(V["prompt_len"], None)
    differ = int((other[:, new] != toks[:, new]).sum())
    assert differ > 0, "another image context gave the same tokens"
    n_new = V["batch"] * V["max_new"]
    steps = V["prompt_len"] + V["max_new"] - 1
    tok_s = n_new / seconds
    print(f"  generated {n_new} tokens in {seconds:.3f} s ({tok_s:.1f} tok/s, "
          f"{1e3 * seconds / steps:.2f} ms a step on the host's clock); no kernel launched; a "
          f"second run bitwise equal; another context changes {differ} of {n_new} tokens")
    with torch.no_grad():
        cache = model.init_cache(params, V["batch"], V["prompt_len"] + V["max_new"])
        model.fill_context(params, cache, ctx)
        step_ms = decode_profile(torch, model, params, cache, V["batch"], 0)
    del cache, toks, again, other
    # one forward and backward, the kernels against the plain path
    tokens = torch.randint(0, cfg.vocab, (1, VLM_SEQ + 1),
                           generator=torch.Generator().manual_seed(47)).to("cuda", torch.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "context": context_draw(torch, cfg, (1,), 48)}
    assert model.attention_layers == VLM_DEPTH - 1
    got = grads_against_plain(torch, build_model, model, params, batch, VLM_ATTN_LEAVES,
                              "self layers")
    grads_p = got.pop("grads_p")
    if after_grads is not None:
        after_grads(model, params, batch, grads_p)
    del params, grads_p, model, batch
    torch.cuda.empty_cache()
    return dict(launches=got["launches"], tok_s=tok_s, step_ms=step_ms, peak_gb=got["peak_gb"],
                loss_err=got["loss_err"], grad_rel=got["grad_rel"], n_params=count)


def grads_against_plain(torch, build_model, model, params, batch, leaves: tuple,
                        layers: str) -> dict:
    """One forward and backward of ``batch`` through the kernels (the model's
    attn_impl pallas: flash_fwd twice an attention layer with remat,
    flash_dq and flash_dkv once) against the plain path (xla) on the same
    weights: the loss within 1e-2 (bf16 logits: ~0.1% of a loss of ~ln V),
    the gradients' relative error (||g_k - g_p|| / ||g_p||) printed
    globally and for the largest leaf, the global one under 5e-2, and each
    attention leaf of ``leaves`` under ``VLM_ATTN_TOL``. Returns the
    launches, the errors, the peak memory and the plain path's gradients
    (``grads_p``; the kernel path's are freed)."""
    from repro_torch.kernels import _build

    _build.reset_launch_counts()
    loss_k, grads_k = vlm_grads(torch, model, params, batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    L = model.attention_layers
    assert launches == {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L}, launches
    plain = build_model(model.cfg.replace(attn_impl="xla"))
    loss_p, grads_p = vlm_grads(torch, plain, params, batch)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert all(torch.isfinite(g).all() for g in grads_k.values())
    rel, per_leaf = grad_errors(grads_k, grads_p)
    del grads_k
    worst = max(per_leaf.items(), key=lambda kv: kv[1])
    err = check("loss (pallas vs xla, bf16)", abs(loss_k.item() - loss_p.item()), 1e-2)
    print(f"  loss {loss_k.item():.5f} (kernels) vs {loss_p.item():.5f} (plain); launches "
          f"{launches} ({L} {layers}, the forward twice with remat); gradients' relative "
          f"error {rel:.3e} globally, largest {worst[1]:.3e} ({worst[0]}); peak {peak_gb:.2f} GB")
    assert rel < 5e-2, rel
    attn_err = {p: per_leaf[p] for p in leaves}
    print(f"  the {layers}' attention leaves, relative error (tol {VLM_ATTN_TOL:g} each): "
          + ", ".join(f"{p.rsplit('/', 1)[1]} {e:.3e}" for p, e in attn_err.items()))
    bad = {p: e for p, e in attn_err.items() if not e <= VLM_ATTN_TOL}
    assert not bad, f"attention leaves' gradients off the plain path's: {bad}"
    return dict(launches=launches, loss_err=err, grad_rel=rel, attn_err=attn_err,
                peak_gb=peak_gb, grads_p=grads_p)


def slice_8(torch, mods: dict, get_config, build_model, serve, ptxas: dict, smi: str) -> dict:
    """Phase 18: the audio and VLM families. (18a) the flash kernels at the
    slice's new shapes against their plain versions (whisper's encoder
    non-causal at S 1500, the VLM's self layers at hd 128 and G = 8; bf16
    and fp32, bitwise from run to run), timed beside the bound, the plain
    version and SDPA, and ptxas's report at hd 64, 80, 112 and 128; (18b)
    matmul_epilogue at whisper's Newton-Schulz shapes and nesterov over its
    1,602,629,120 parameters; (18c) the fp32 agreement at full width;
    (18d) whisper training; (18e) whisper serving; (18f) the VLM at one
    superblock. Returns the kernels' rows."""
    import gc

    fa, mm, ou = mods["fa"], mods["mm"], mods["ou"]
    gc.collect()
    torch.cuda.empty_cache()
    w_params = param_count(get_config(WHISPER))
    print(f"[18] {WHISPER} ({w_params:,} parameters) and {VLM} "
          f"({param_count(get_config(VLM)):,}; {param_count(get_config(VLM).replace(n_layers=VLM_DEPTH)):,}"
          f" at one superblock); {torch.cuda.memory_allocated() / 1e9:.2f} GB held by earlier "
          "phases")
    phase_ptxas_head_dims(ptxas)
    flash = {WHISPER: phase_flash(torch, fa, hd=64, phase="18a", cases=WHISPER_FWD_CASES),
             VLM: phase_flash(torch, fa, hd=128, phase="18a", cases=VLM_FWD_CASES)}
    bwd = {WHISPER: phase_flash_bwd(torch, fa, hd=64, phase="18a", cases=WHISPER_BWD_CASES),
           VLM: phase_flash_bwd(torch, fa, hd=128, phase="18a", cases=VLM_BWD_CASES)}
    torch.cuda.empty_cache()
    lap("18a")
    xx, bx = phase_matmul_whisper(torch, mm)
    nesterov = phase_nesterov(torch, ou, w_params, phase="18b")
    torch.cuda.empty_cache()
    lap("18b")
    phase_whisper_agreement(torch, get_config, build_model)
    lap("18c")
    train = phase_whisper_train(torch, get_config, build_model, xx)
    lap("18d")
    serving = phase_whisper_serve(torch, get_config, serve)
    lap("18e")
    vlm = phase_vlm(torch, get_config, build_model)
    lap("18f")
    t, s = train, serving
    print(f"{WHISPER} training (full width and depth, {t['n_params']:,} parameters, K 2, H 2, "
          f"{WHISPER_TRAIN['batch']} x {WHISPER_TRAIN['seq_len']} tokens and their frames a worker "
          f"step): {t['tok_s']:.1f} decoder tokens/s ({t['frames_s']:.1f} frames/s) over the "
          f"replayed rounds, one profiled replayed round {t['replay_tok_s']:.1f}, idle "
          f"{t['idle']:.1f}%, "
          f"matmul_epilogue {t['shares']['matmul_epilogue']:.1f}% / flash "
          f"{t['shares']['flash_']:.1f}% / rest {t['shares']['rest']:.1f}% of the device time, "
          f"peak {t['peak_gb']:.2f} GB; card (nvidia-smi name, power.limit): {smi}")
    print(f"{WHISPER} serving (naive engine, full depth, fp32 weights, {WHISPER_SERVE['batch']} x "
          f"({WHISPER_SERVE['prompt_len']} + {WHISPER_SERVE['max_new']})): {s['tok_s']:.1f} tok/s, "
          f"{s['host_step_ms']:.2f} ms a step on the host's clock, {s['step_ms']:.4f} ms of device "
          f"time a decode step; peak {s['peak_gb']:.2f} GB; card (nvidia-smi name, power.limit): "
          f"{smi}")
    print(f"{VLM} (one superblock, bf16 weights, {vlm['n_params']:,} parameters): serving "
          f"{vlm['tok_s']:.1f} tok/s, {vlm['step_ms']:.4f} ms of device time a decode step; "
          f"{VLM_SEQ}-token forward and backward: loss within {vlm['loss_err']:.2e} of the plain "
          f"path, gradients' relative error {vlm['grad_rel']:.3e}; peak {vlm['peak_gb']:.2f} GB; "
          f"card (nvidia-smi name, power.limit): {smi}")
    tl, vl = train["launches"], vlm["launches"]
    return {"flash_fwd": {WHISPER: {"launches": {"training": tl["flash_fwd"],
                                                 "serving": serving["launches"]["flash_fwd"]},
                                    **flash[WHISPER]["whisper encoder"]},
                          VLM: {"launches": vl["flash_fwd"], **flash[VLM]["vlm self"]}},
            "flash_dq": {WHISPER: {"launches": tl["flash_dq"], **bwd[WHISPER]["flash_dq"]},
                         VLM: {"launches": vl["flash_dq"], **bwd[VLM]["flash_dq"]}},
            "flash_dkv": {WHISPER: {"launches": tl["flash_dkv"], **bwd[WHISPER]["flash_dkv"]},
                          VLM: {"launches": vl["flash_dkv"], **bwd[VLM]["flash_dkv"]}},
            "matmul_epilogue": {WHISPER: {"launches": tl["matmul_epilogue"], **xx,
                                          "b_x_plus_a_x": bx}},
            "nesterov": {WHISPER: {"launches": tl["nesterov"], **nesterov}},
            "reads": [train["read"]]}


# ---------------------------------------------------------------------------
# Slice 9: the last two configurations (19): kimi-k2-1t-a32b (hd 112) and
# mistral-large-123b (G = 12)
# ---------------------------------------------------------------------------

KIMI, MISTRAL = "kimi-k2-1t-a32b", "mistral-large-123b"
# 19b: flash_fwd / flash_dq / flash_dkv at G = 12 (mistral-large's 96:8 heads)
# and hd 128: the serving prefill (16 slots x 8 kv heads, S 512) and the
# training shape (4 sequences x 8 kv heads, S 2048) first; G = 16, the most
# the fp32 sweeps take, once each
MISTRAL_FWD_CASES = [(16 * 8, 512, 12, _BF16, True, 0, "serving"),
                     (4 * 8, 2048, 12, _BF16, True, 0, "training"),
                     (2 * 1, 77, 12, _BF16, True, 0, None),
                     (2 * 1, 300, 12, _BF16, True, 100, None),
                     (2 * 1, 130, 12, _BF16, False, 0, None),
                     (2 * 1, 96, 12, _BF16, False, 20, None),
                     (1, 50, 16, _BF16, True, 0, None),
                     (4 * 8, 2048, 12, _FP32, True, 0, None),
                     (1, 70, 12, _FP32, True, 0, None),
                     (2, 77, 12, _FP32, False, 20, None),
                     (1, 50, 16, _FP32, True, 0, None)]
# fp32 at S = 1024: a dk entry of the fp32 sweep and of its plain version each
# sums S G rows in fp32, in two orders, and at S = 2048, G = 12 (24,576 rows)
# their difference read 1.005x 5a's 1e-5 on an H100 while each was within
# 7.8e-6 of float64: that shape is held against float64 instead
# (``BWD_FP64_CASES``)
MISTRAL_BWD_CASES = [(4, 8, 2048, 12, _BF16, True, 0),
                     (4, 8, 1024, 12, _FP32, True, 0),
                     (2, 1, 77, 12, _FP32, True, 0),
                     (2, 1, 96, 12, _FP32, False, 20),
                     (1, 1, 50, 16, _FP32, True, 0),
                     (2, 1, 130, 12, _BF16, True, 37),
                     (2, 1, 96, 12, _BF16, False, 0),
                     (1, 1, 70, 16, _BF16, True, 0)]
# 19c / 19d: the cuts that fit one card (PERF.md section 4). kimi-k2 serves at
# depth 1 with all 384 experts (19.42B parameters, 38.8 GB in bf16) and is
# held in fp32 and differentiated at depth 1 with its experts cut to 64
# (5.33B: 21.3 GB in fp32; in bf16 the weights, their gradients and the plain
# path's ~32 GB); mistral-large serves at depth 8 (11.9B, 23.8 GB in bf16), is
# held in fp32 at depth 2 (14.3 GB) and differentiated at depth 1
KIMI_CUT = dict(serve_depth=1, grad_depth=1, grad_experts=64)
MISTRAL_CUT = dict(serve_depth=8, agree_depth=2, grad_depth=1)
LAST_GRAD = dict(batch=4, seq_len=2048)  # 19c / 19d: one forward and backward
LAST_ATTN_LEAVES = tuple(f"layers/attn/{w}" for w in ("wq", "wk", "wv", "wo"))


# 19b: (hd, S, G) of the fp32 backward held against float64 (two rows of kv
# heads), mistral-large's training shape
BWD_FP64_CASES = [(128, 2048, 12)]


def bwd_fp64(torch, q, k, v, do, lse, dl, scale):
    """dq, dk, dv of causal attention in float64 from the fp32 inputs and the
    same lse and dl the kernels read."""
    q, k, v, do, lse, dl = (t.double() for t in (q, k, v, do, lse, dl))
    i = torch.arange(q.shape[1], device=q.device)
    mask = (i[:, None] >= i[None, :])[None, :, None, :]
    s = torch.einsum("bqgh,bsh->bqgs", q, k) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (torch.einsum("bqgh,bsh->bqgs", do, v) - dl[..., None])
    return (scale * torch.einsum("bqgs,bsh->bqgh", ds, k),
            scale * torch.einsum("bqgs,bqgh->bsh", ds, q), torch.einsum("bqgs,bqgh->bsh", p, do))


def phase_fp32_bwd_fp64(torch, fa, cases: list, phase: str = "19b"):
    """The fp32 flash backward (causal) and its plain version against a float64
    recomputation from the same inputs, two rows of kv heads a case: the
    largest error of dq, dk and dv over the largest float64 entry. The
    kernel's is held to 5a's fp32 tolerance, 1e-5; the plain version's
    prints beside it. The kernels run twice: bitwise equal from run to
    run."""
    print(f"[{phase}] fp32 flash_dq / flash_dkv against float64 (a dk entry sums S G rows)")
    gen = torch.Generator(device="cuda").manual_seed(11)
    for hd, S, G in cases:
        q, do = (torch.randn((2, S, G, hd), generator=gen, device="cuda") for _ in "qd")
        k, v = (torch.randn((2, S, hd), generator=gen, device="cuda") for _ in "kv")
        kw = dict(causal=True, window=0, scale=1.0 / math.sqrt(hd))
        o, lse = fa._fwd_cuda(q, k, v, **kw)
        dl = torch.sum(do * o, dim=-1)
        args = (q, k, v, do, lse, dl)
        ref = bwd_fp64(torch, *args, kw["scale"])
        got = {"kernel": fa._bwd_cuda(*args, **kw), "plain": fa._bwd_plain(*args, **kw)}
        again = fa._bwd_cuda(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got["kernel"], again)), \
            f"fp32 flash_dq / flash_dkv q[2, {S}, {G}, {hd}] differ from run to run"
        print(f"  fp32 kernel q[2, {S}, {G}, {hd}]: dq, dk, dv bitwise equal from run to run")
        del again
        rel = {side: {n: ((g.double() - r).abs().max() / r.abs().max()).item()
                      for n, g, r in zip(("dq", "dk", "dv"), outs, ref)}
               for side, outs in got.items()}
        for side in got:
            print(f"  fp32 {side} q[2, {S}, {G}, {hd}] ({S * G} rows a dk entry), largest error "
                  "/ largest float64 entry: " + ", ".join(f"{n} {e:.3e}"
                                                          for n, e in rel[side].items()))
        for n, e in rel["kernel"].items():
            check(f"fp32 {n} q[2, {S}, {G}, {hd}] against float64 (relative)", e, 1e-5)
        del ref, got
        torch.cuda.empty_cache()


def phase_last_grads(torch, get_config, build_model, arch: str, phase: str,
                     overrides: dict) -> dict:
    """One forward and backward of ``LAST_GRAD`` (4 x 2048 tokens) at full
    width, bf16 weights, through the kernels against the plain path
    (:func:`grads_against_plain`: the loss, the tree's relative error, each
    attention leaf under ``VLM_ATTN_TOL``)."""
    B, S = LAST_GRAD["batch"], LAST_GRAD["seq_len"]
    cfg = get_config(arch).replace(param_dtype="bfloat16", attn_impl="pallas", **overrides)
    count = param_count(cfg)
    print(f"[{phase}] {arch} full width, {overrides}, bf16 weights ({count:,} parameters): one "
          f"{B} x {S}-token forward and backward, kernels against the plain path")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = torch.randint(0, cfg.vocab, (B, S + 1),
                           generator=torch.Generator().manual_seed(49)).to("cuda", torch.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    got = grads_against_plain(torch, build_model, model, params, batch, LAST_ATTN_LEAVES,
                              "layers")
    del params, got["grads_p"], model, batch
    torch.cuda.empty_cache()
    return dict(got, n_params=count)


def slice_9(torch, fa, get_config, build_model, serve, ptxas: dict, smi: str) -> dict:
    """Phase 19: the last two configurations. (19a) flash_fwd, flash_dq /
    flash_dkv and paged_decode at hd 112 (kimi-k2's shapes, G = 8) against
    their plain versions, bf16 and fp32, bitwise from run to run, timed
    beside the bound, the plain version and SDPA, with ptxas at hd 64, 80,
    112 and 128; (19b) the same at G = 12 (mistral-large's shapes, hd 128);
    (19c) kimi-k2: the fp32 agreement at depth 1 with 64 experts, serving
    at depth 1 with all 384 experts, one forward and backward at depth 1
    with 64 experts; (19d) mistral-large: the fp32 agreement at depth 2,
    serving at depth 8, one forward and backward at depth 1. Returns the
    kernels' rows."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[19] {KIMI} ({param_count(get_config(KIMI)):,} parameters) and {MISTRAL} "
          f"({param_count(get_config(MISTRAL)):,}); {torch.cuda.memory_allocated() / 1e9:.2f} GB held "
          "by earlier phases")
    phase_ptxas_head_dims(ptxas)
    kimi_k = dict(flash=phase_flash(torch, fa, hd=112, phase="19a"),
                  bwd=phase_flash_bwd(torch, fa, hd=112, phase="19a"),
                  paged=phase_paged(torch, fa, hd=112, KV=8, G=8, phase="19a"))
    torch.cuda.empty_cache()
    lap("19a")
    mistral_k = dict(flash=phase_flash(torch, fa, hd=128, phase="19b", cases=MISTRAL_FWD_CASES),
                     bwd=phase_flash_bwd(torch, fa, hd=128, phase="19b", cases=MISTRAL_BWD_CASES),
                     paged=phase_paged(torch, fa, hd=128, KV=8, G=12, phase="19b"))
    phase_fp32_bwd_fp64(torch, fa, BWD_FP64_CASES)
    torch.cuda.empty_cache()
    lap("19b")
    kc, mc = KIMI_CUT, MISTRAL_CUT
    phase_agreement(torch, get_config, build_model, KIMI, "19c", n_layers=kc["grad_depth"],
                    overrides=dict(n_experts=kc["grad_experts"]))
    torch.cuda.empty_cache()
    kimi = dict(serve=phase_serve_profiled(torch, fa, get_config, serve, KIMI, "19c",
                                           kc["serve_depth"], kimi_k["paged"]["ms"]),
                grads=phase_last_grads(torch, get_config, build_model, KIMI, "19c",
                                       dict(n_layers=kc["grad_depth"],
                                            n_experts=kc["grad_experts"])))
    lap("19c")
    phase_agreement(torch, get_config, build_model, MISTRAL, "19d", n_layers=mc["agree_depth"])
    torch.cuda.empty_cache()
    mistral = dict(serve=phase_serve_profiled(torch, fa, get_config, serve, MISTRAL, "19d",
                                              mc["serve_depth"], mistral_k["paged"]["ms"]),
                   grads=phase_last_grads(torch, get_config, build_model, MISTRAL, "19d",
                                          dict(n_layers=mc["grad_depth"])))
    lap("19d")
    for arch, r in ((KIMI, kimi), (MISTRAL, mistral)):
        g = r["grads"]
        print_serving(arch, r["serve"], smi)
        print(f"{arch} forward and backward ({g['n_params']:,} parameters, "
              f"{LAST_GRAD['batch']} x {LAST_GRAD['seq_len']} tokens): loss within "
              f"{g['loss_err']:.2e} of the plain path, gradients' relative error "
              f"{g['grad_rel']:.3e}, attention leaves "
              + ", ".join(f"{p.rsplit('/', 1)[1]} {e:.3e}" for p, e in g["attn_err"].items())
              + f"; peak {g['peak_gb']:.2f} GB; card (nvidia-smi name, power.limit): {smi}")

    def rows(k: dict, r: dict) -> dict:
        sl, gl = r["serve"]["launches"], r["grads"]["launches"]
        return {"flash_fwd": {"launches": {"serving": sl["flash_fwd"], "training": gl["flash_fwd"]},
                              **k["flash"]["serving"], "training_shape": k["flash"]["training"]},
                "flash_dq": {"launches": gl["flash_dq"], **k["bwd"]["flash_dq"]},
                "flash_dkv": {"launches": gl["flash_dkv"], **k["bwd"]["flash_dkv"]},
                "paged_decode": {"launches": sl["paged_decode"], **k["paged"]}}

    kr, mr = rows(kimi_k, kimi), rows(mistral_k, mistral)
    return {**{name: {KIMI: kr[name], MISTRAL: mr[name]} for name in kr},
            "reads": [kimi["serve"]["read"], mistral["serve"]["read"]]}


# ---------------------------------------------------------------------------
# Phase 20: every captured round and replayed decode step against its roofline
# ---------------------------------------------------------------------------

ROOFLINE_DIR = ROOT / "build" / "chip_smoke_roofline"
# a share above this says the card beat its peak: a fault of the count
SHARE_MAX = 1.05


def round_read(phase: str, cfg, engine, state: dict, hist: list, B: int, S: int,
               peak_gb: float) -> dict:
    """What phase 20 reads of a captured training run: its config (depth
    as run), the shapes of its parameters, inner and outer optimizer states,
    its K, H, inner optimizer and compression (``engine.dcfg``), B sequences
    of S tokens a worker step, the [B, S] of the eval batch whose forward the
    captured round folds in (None for a round without one), the mean wall of
    rounds 2 and up (replays), the capture's seconds and the state's bytes
    beside the peak memory."""
    from repro_torch.roofline.terms import meta_like
    from repro_torch.utils.tree import tree_bytes

    later = hist[1:]
    (graph,) = engine._graphs.values()  # the one captured round the replays ran
    evals = None if graph.eval_batch is None else tuple(graph.eval_batch["tokens"].shape)
    return dict(kind="round", phase=phase, cfg=cfg, dcfg=engine.dcfg, B=B, S=S, evals=evals,
                trees=meta_like({k: state[k] for k in ("outer_params", "inner_state",
                                                       "outer_opt")}),
                seconds=sum(r["wall_s"] for r in later) / len(later),
                setup_s=engine.capture_s[0], state_bytes=tree_bytes(state),
                peak_bytes=peak_gb * 1e9)


def decode_read(phase: str, engine, lengths: list, step_ms: float, floor_ms: float) -> dict:
    """What phase 20 reads of a replayed decode step: the engine's config
    (depth as served), its weights' shapes, its slots, the slots' mean cache
    length over the span (``lengths``), the step's device time and floor,
    the span's capture seconds, and the weights' and paged pool's bytes
    beside the peak memory."""
    from repro_torch.roofline.terms import meta_like
    from repro_torch.utils.tree import tree_bytes

    return dict(kind="decode", phase=phase, cfg=engine.model.cfg,
                params=meta_like(engine.params), B=engine.slots,
                S=round(statistics.mean(lengths)), seconds=step_ms / 1e3, floor_ms=floor_ms,
                setup_s=engine.capture_s, state_bytes=tree_bytes(engine.params),
                pool_bytes=tree_bytes(engine._pool), peak_bytes=engine.peak_gb * 1e9)


def phase_roofline(reads: list, smi: str) -> list:
    """[20] each program the earlier phases measured and returned (``reads``:
    :func:`round_read` of the captured training runs of 6b, 12d, 16c', 17d,
    17e and 18d, :func:`decode_read` of the decode steps replayed in 4c,
    12e', 13c', 16b', 19c' and 19d', those of the phases that ran) read
    against the roofline of one H100:
    ``repro_torch.roofline.terms.analytic_terms`` at the run's own shapes
    (a round at its K, H, B, S and depth; a decode step at the engine's
    slots, mean cache length and depth), the model FLOPs, the analytic FLOPs
    and bytes, the compute, memory and wire terms, the dominant one, and the
    measured seconds: the model FLOPs utilisation (model FLOPs over the
    seconds at the bf16 peak) and the roofline share (max(compute, memory)
    over the seconds). A round also prints its compute term with the
    Newton-Schulz part priced at the fp32 peak; a decode step its memory
    term beside ``decode_floor_ms``. Each read is one record of the
    reference's schema under ``build/chip_smoke_roofline/``, and the phase
    prints them as ``repro_torch.roofline.report.roofline_table``. Fails if a
    share is above ``SHARE_MAX``."""
    from repro_torch.core.collectives import measured_sync_bytes
    from repro_torch.models import build_model
    from repro_torch.roofline import report
    from repro_torch.roofline.terms import analytic_terms, card_record, newton_schulz_part

    print(f"[20] roofline: {len(reads)} programs measured above, read against one H100's peaks "
          f"(bf16 {PEAK_FLOPS / 1e12:g} TFLOP/s, fp32 {PEAK_FP32_FLOPS / 1e12:g}, HBM "
          f"{HBM_BW / 1e12:g} TB/s); card (nvidia-smi name, power.limit): {smi}")
    ROOFLINE_DIR.mkdir(parents=True, exist_ok=True)
    for old in ROOFLINE_DIR.glob("*.json"):
        old.unlink()
    records, over = [], []
    for r in reads:
        cfg, B, S = r["cfg"], r["B"], r["S"]
        if r["kind"] == "round":
            d, trees = r["dcfg"], r["trees"]
            K, H, params = d.n_workers, d.sync_interval, trees["outer_params"]
            flops, hbm = analytic_terms("round", cfg, params, seq_len=S, global_batch=K * B,
                                        inner_state=trees["inner_state"],
                                        outer_opt=trees["outer_opt"], inner_name=d.inner_name,
                                        n_workers=K, H=H)
            shape, eval_tokens = f"K{K} H{H} B{B} S{S} L{cfg.n_layers}", 0
            if r["evals"] is not None:  # the round's eval forward, counted as a prefill
                Be, Se = r["evals"]
                ef, eb = analytic_terms("prefill", cfg, params, seq_len=Se, global_batch=Be)
                flops, hbm, eval_tokens = flops + ef, hbm + eb, Be * Se
                shape += f" eval B{Be} S{Se}"
            kw = dict(plan="round_step", kind="round", shape=shape, tokens=K * B * S * H,
                      forward_tokens=eval_tokens, inner=d.inner_name,
                      ns_flops=H * newton_schulz_part(params, d.inner_name),
                      wire_bytes=float(measured_sync_bytes(params, d.compression, K)),
                      argument_bytes=r["state_bytes"], alias_bytes=r["state_bytes"])
        else:
            params = r["params"]
            cache = build_model(cfg).init_cache(params, B, S)
            flops, hbm = analytic_terms("decode", cfg, params, seq_len=S, global_batch=B,
                                        cache=cache)
            kw = dict(plan="serve_step", kind="decode", shape=f"B{B} S{S} L{cfg.n_layers}",
                      tokens=B, argument_bytes=r["state_bytes"] + r["pool_bytes"],
                      alias_bytes=r["pool_bytes"])
        rec = card_record(arch=cfg.name, cfg=cfg, params=params, flops=flops, hbm=hbm,
                          seconds=r["seconds"], setup_s=r["setup_s"],
                          peak_bytes=r["peak_bytes"], card=smi, **kw)
        t, m = rec["roofline"], rec["measured"]
        fp32 = (f" (Newton-Schulz at the fp32 peak: {m['compute_fp32_ns_s'] * 1e3:.4f} ms)"
                if r["kind"] == "round" else "")
        print(f"  {r['phase']:6s} {cfg.name} {rec['plan']} {rec['shape']}: model FLOPs "
              f"{t['model_flops']:.4e}, analytic FLOPs {flops:.4e} and bytes {hbm:.4e}; compute "
              f"{t['compute_s'] * 1e3:.4f} ms{fp32}, memory {t['memory_s'] * 1e3:.4f} ms, "
              f"wire {t['wire_comm_s'] * 1e3:.4f} ms, dominant {t['dominant']}; measured "
              f"{m['seconds'] * 1e3:.4f} ms: model FLOPs utilisation {100 * m['mfu']:.3f}%, "
              f"roofline share {100 * m['roofline_share']:.3f}%")
        if r["kind"] == "decode":
            print(f"         memory term {t['memory_s'] * 1e3:.4f} ms beside decode_floor_ms "
                  f"{r['floor_ms']:.4f} ms: the roofline reads every weight once (all of an "
                  "untied embedding), a dense B x S cache and 2 x (8 d + 2 d_ff) bytes of "
                  "activations a token and layer; the floor reads the B embedding rows "
                  "gathered and each slot's own K/V rows")
        if not m["roofline_share"] <= SHARE_MAX:
            over.append((r["phase"], m["roofline_share"]))
        (ROOFLINE_DIR / f"{r['phase'].replace(chr(39), 'p')}.json").write_text(
            json.dumps([rec], indent=1))
        records.append(rec)
    print(report.roofline_table(records))
    print(f"  {len(records)} records in {ROOFLINE_DIR.relative_to(ROOT)}/ (python -m "
          f"repro_torch.roofline.report --dryrun {ROOFLINE_DIR.relative_to(ROOT)}); "
          f"card (nvidia-smi name, power.limit): {smi}")
    assert not over, f"roofline share above {SHARE_MAX} (a count says the card beat its peak): {over}"
    return records


# the groups of phases that need nothing of the earlier ones but the build
# (14 runs 6b's training first, its reference): ``--only`` runs these
AUTOTUNE_DIR = ROOT / "build" / "chip_smoke_autotune"
# 21b: the shapes every candidate is held at against the default, bitwise:
# smollm's w_in stack and w_out's (its B X + a X reads a transposed view)
AUTOTUNE_NS_CHECK = [(30, 576, 1536), (30, 1536, 576)]
# and quantize's default regimes (a warp a row, a block a row, long rows),
# whose cuts the candidates move: (rows, cols, bits)
AUTOTUNE_QUANT_CHECK = [(34_560, 1536, 4), (1000, 10_000, 4), (2, 28_311_552, 2)]
# 21d: the sweep's timed runs a candidate (best of) and Newton-Schulz
# iterations a run (the committed table's sweep takes the CLI's 3 runs of 5
# iterations; one iteration is a fifth of the work, the same three products)
AUTOTUNE_REPS = 1
AUTOTUNE_NS_ITERS = 1
# nvcc processes 21a's builds run at a time, behind phases 3-20
AUTOTUNE_JOBS = max(1, (os.cpu_count() or 2) // 2)


def ptxas_numbers(line: str) -> tuple[int, int, int]:
    """(registers, spill-store bytes, spill-load bytes) of a ptxas report line."""
    regs = re.search(r"Used (\d+) registers", line)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    return (int(regs.group(1)) if regs else -1,
            *(map(int, spill.groups()) if spill else (-1, -1)))


# threads the script started; joined before it exits, so no nvcc outlives it
BACKGROUND: list = []


def start_autotune_build(_build) -> dict:
    """21a's builds, started after phase 2's: every build variant of
    matmul_epilogue and quantize (the autotune candidates), half the CPU
    cores' worth of nvcc at a time at niceness 19, on the cores the script
    leaves idle, in a thread; 21a waits for them. Returns the thread's box (its
    keys, start, report or error)."""
    import threading

    box = {"keys": [_build.variant_key(lib, v) for lib in ("matmul_epilogue", "quantize")
                    for v in sorted(_build.VARIANTS[lib])], "t0": time.perf_counter()}

    def run():
        try:
            box["report"] = _build.build(box["keys"], verbose=True, jobs=AUTOTUNE_JOBS, nice=19)
        except Exception as e:  # raised again by 21a
            box["error"] = e

    box["thread"] = threading.Thread(target=run, name="autotune-build", daemon=True)
    box["thread"].start()
    BACKGROUND.append(box["thread"])
    return box


def phase_autotune_build(_build, box: dict | None = None) -> dict:
    """[21a] every build variant of matmul_epilogue and quantize (the
    autotune candidates) built from the one source, in parallel (``box``:
    the builds :func:`start_autotune_build` started); each one's ptxas
    registers and spills. A build that fails raises."""
    box = box or start_autotune_build(_build)
    keys = box["keys"]
    print(f"[21a] build every autotune candidate: {len(keys)} variants (and the two defaults "
          f"of phase 2), {AUTOTUNE_JOBS} nvcc at a time, started "
          f"{time.perf_counter() - box['t0']:.1f} s ago")
    box["thread"].join()
    if "error" in box:
        raise box["error"]
    report = box["report"]
    out = {}
    for key in keys:
        fns = {fn: ptxas_numbers(line) for fn, line in ptxas_report(report[key]["log"]).items()}
        assert fns and all(r > 0 for r, _, _ in fns.values()), (key, fns)
        spilled = sorted(fn for fn, (_, st, ld) in fns.items() if st or ld)
        print(f"  {key}: built {report[key]['seconds']:.1f} s after the start, {len(fns)} "
              f"kernels, registers "
              f"{sorted({r for r, _, _ in fns.values()})}, spill stores / loads "
              f"{max(st for _, st, _ in fns.values())} / {max(ld for _, _, ld in fns.values())} "
              f"B at most" + (f" (in {spilled})" if spilled else ""))
        out[key] = fns
    AUTOTUNE_DIR.mkdir(parents=True, exist_ok=True)
    (AUTOTUNE_DIR / "ptxas.json").write_text(json.dumps(out, indent=1, sort_keys=True))
    return out


def phase_autotune_bitwise(torch, _build, mm, q, ops, ref) -> None:
    """[21b] every candidate against the default, bitwise: Newton-Schulz
    through matmul_epilogue at ``AUTOTUNE_NS_CHECK`` (all three products, the
    triangles mirrored), quantize (full and codes-only) and dequantize at
    ``AUTOTUNE_QUANT_CHECK`` with each candidate's plan equal to its
    library's; the defaults against their plain versions as 5b (1e-5) and 8a
    (bitwise) hold them."""
    print("[21b] every candidate bitwise equal to the default; the default against the plain "
          "version")
    gen = torch.Generator(device="cuda").manual_seed(21)
    for shape in AUTOTUNE_NS_CHECK:
        g = torch.randn(shape, generator=gen, device="cuda")
        base = ops.ns_orthogonalize(g, block=mm.DEFAULT_TILE)
        y_ref = ref.ns_orthogonalize_ref(g)
        torch.cuda.synchronize()
        check(f"Newton-Schulz {list(shape)}, default tile vs plain fp32",
              (base - y_ref).abs().max().item(), 1e-5)
        for tile in mm.TILE_CANDIDATES:
            y = ops.ns_orthogonalize(g, block=tile)
            assert torch.equal(y, base), (shape, tile)
        print(f"  Newton-Schulz {list(shape)}: all {len(mm.TILE_CANDIDATES)} candidates bitwise "
              "equal to the default")
        del g, base, y_ref, y
    c_plan = {}
    for rows, cols, bits in AUTOTUNE_QUANT_CHECK:
        x = torch.randn((rows, cols), generator=gen, device="cuda")
        base = q.rowwise_quantize(x, bits)
        want = q.rowwise_quantize_plain(x, bits)
        base_codes = q.rowwise_quantize_codes(x, bits)
        base_vals = q.rowwise_dequantize(*base[1:])
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(base, want)), (rows, cols, "plain")
        regimes = set()
        for tile in q.TILE_CANDIDATES:
            key = _build.variant_key("quantize", q.tile_variant(tile))
            if key not in c_plan:
                fn = _build.load(key).quantize_plan
                fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong,
                               ctypes.POINTER(ctypes.c_longlong)]
                fn.restype = ctypes.c_int
                c_plan[key] = fn
            parts = ctypes.c_longlong()
            code = c_plan[key](rows, cols, ctypes.byref(parts))
            plan = q.quantize_plan(rows, cols, tile)
            assert (("warp", "block", "long")[code], parts.value) == plan, (key, rows, cols)
            regimes.add(plan)
            got = q.rowwise_quantize(x, bits, tile=tile)
            codes_only = q.rowwise_quantize_codes(x, bits, tile=tile)
            vals = q.rowwise_dequantize(*base[1:], tile=tile)
            torch.cuda.synchronize()
            for name, a, b in zip(("deq", "codes", "lo", "scale", "codes-only codes",
                                   "codes-only lo", "codes-only scale", "dequantize"),
                                  (*got, *codes_only, vals), (*base, *base_codes, base_vals)):
                assert torch.equal(a, b), (key, rows, cols, name)
        print(f"  quantize [{rows}, {cols}] {bits}-bit: the default bitwise its plain version; "
              f"all {len(q.TILE_CANDIDATES)} candidates' full, codes-only and dequantize launches "
              f"bitwise the default's, each plan its library's; plans {sorted(regimes)}")
        del x, base, want, base_codes, base_vals, got, codes_only, vals
    torch.cuda.empty_cache()


def phase_autotune_table(torch, mm, q, ops, at) -> list:
    """[21c] every ``cuda`` entry of the committed table re-verified at its
    key's shape: the named candidate's output bitwise the default's."""
    table = at.AutotuneTable.load(at.DEFAULT_TABLE_PATH)
    entries = sorted(k for k in table.entries if k.endswith("/cuda"))
    print(f"[21c] the committed table's {len(entries)} cuda entries ({at.DEFAULT_TABLE_PATH}) "
          "re-verified at their keys' shapes, bitwise")
    assert entries, "the committed table holds no cuda entry"
    gen = torch.Generator(device="cuda").manual_seed(22)
    tuned = []
    for key in entries:
        kernel, dims, dtype, _ = key.split("/")
        shape = tuple(int(d) for d in dims.split("x"))
        config = table.entries[key]["config"]
        (mm if kernel == "ns" else q).tile_variant(config)  # a config off the grid raises
        if kernel == "ns":
            g = torch.randn(shape, generator=gen, device="cuda", dtype=getattr(torch, dtype))
            a, b = (ops.ns_orthogonalize(g, block=config),
                    ops.ns_orthogonalize(g, block=mm.DEFAULT_TILE))
        else:
            x = torch.randn(shape[:2], generator=gen, device="cuda", dtype=getattr(torch, dtype))
            a, b = (ops.quantize_rowwise(x, shape[2], block_rows=config),
                    ops.quantize_rowwise(x, shape[2], block_rows=q.DEFAULT_TILE))
        torch.cuda.synchronize()
        assert at._bitwise_equal(a, b), key
        is_default = config == (mm.DEFAULT_TILE if kernel == "ns" else q.DEFAULT_TILE)
        if not is_default:
            tuned.append(key)
        print(f"  {key}: {config}{' (the default)' if is_default else ''} bitwise the default's")
        del a, b
    torch.cuda.empty_cache()
    return tuned


def phase_autotune_sweep(torch, at) -> dict:
    """[21d] the ``h100`` suite swept on the card into ``AUTOTUNE_DIR`` (not
    the committed table; ``AUTOTUNE_REPS`` timed runs a candidate after its
    checked one): default and best ms, bound and torch.baddbmm per shape."""
    out = AUTOTUNE_DIR / "table.json"
    out.unlink(missing_ok=True)
    print(f"[21d] the h100 suite swept as python -m repro_torch.kernels.autotune --suite h100 "
          f"--out {out} does it (in-process), at {AUTOTUNE_REPS} timed run(s) a candidate and "
          f"{AUTOTUNE_NS_ITERS} Newton-Schulz iteration(s) a run")
    table = at.run_sweeps("h100", out=str(out), reps=AUTOTUNE_REPS, device="cuda",
                          ns_iters=AUTOTUNE_NS_ITERS)
    rows = {}
    for key, ent in sorted(table.entries.items()):
        ev = ent["evidence"]
        assert ev["verified_bitwise"] and ev["device"], key
        rows[key] = dict(config=ent["config"], default_ms=ev["default_s"] * 1e3,
                         best_ms=ev["best_s"] * 1e3)
        if "bound_s" in ev:
            rows[key].update(bound_ms=ev["bound_s"] * 1e3, baddbmm_ms=ev["baddbmm_s"] * 1e3)
    return rows


def phase_autotune_runs(torch, _build, build_parser, train, refs: dict | None = None) -> dict:
    """[21e] 6b's captured smollm command and 12d's paper-416m command with
    ``--autotune off`` and with it on (the default): losses, eval losses,
    comm_bytes and every leaf of the final state (outer parameters, inner
    and outer optimizer state, EF where kept) bitwise equal; the launches
    counted by variant, the tuned variants launched on, the defaults off,
    both runs' replayed rounds' walls printed. ``refs`` (tag -> (history,
    host state, variant launches)) holds the runs with autotune on that 6b
    and 12d made; without them (``--only 21``) they run here first."""
    from repro_torch.kernels.autotune import configure
    from repro_torch.utils.tree import tree_map

    print("[21e] the training commands of 6b and 12d with --autotune off against on, bitwise")
    keys = ("train_loss", "train_loss_last", "eval_loss", "comm_bytes")
    rows = {}
    for tag, argv in (("6b", TRAIN), ("12d", TRAIN_LADDER)):
        runs = {}
        if refs and tag in refs:
            runs["on"] = refs[tag]
        for mode in ("off", "on"):
            if mode in runs:
                continue
            run_argv = replace_flags(argv, out=ROOT / "build" / f"chip_smoke_autotune_{tag}")
            args = build_parser().parse_args(run_argv + ["--autotune", mode])
            _build.reset_launch_counts()
            out = train(args)
            torch.cuda.synchronize()
            runs[mode] = (out["history"],
                          tree_map(lambda t: t.to("cpu", copy=True), out["state"]),
                          dict(_build.VARIANT_LAUNCHES))
            for name, n in _build.LAUNCHES.items():  # every launch counted by one variant
                assert n == sum(v for k, v in _build.VARIANT_LAUNCHES.items()
                                if _build.split_key(k)[0] == name), (tag, mode, name)
            del out
            torch.cuda.empty_cache()
        configure()  # the process default again: the committed table, on
        (h_on, s_on, v_on), (h_off, s_off, v_off) = runs["on"], runs["off"]
        w_on, w_off = ([r["wall_s"] for r in h[1:]] for h in (h_on, h_off))
        assert len(h_on) == len(h_off)
        for a, b in zip(h_on, h_off):
            for k in keys:
                assert a[k] == b[k], (tag, a["round"], k, a[k], b[k])
        diffs = _leaf_diffs(torch, s_on, s_off)
        assert not diffs, (tag, diffs)
        assert all(_build.split_key(k)[1] is None for k in v_off), (tag, v_off)
        tuned = {k: n for k, n in v_on.items() if _build.split_key(k)[1] is not None}
        print(f"  {tag}: {len(h_on)} rounds' {', '.join(keys)} and every state leaf bitwise "
              f"equal; launches by variant with autotune on {v_on}; off {v_off}; the replayed "
              f"rounds' walls on {[round(w, 4) for w in w_on]} s, off "
              f"{[round(w, 4) for w in w_off]} s")
        rows[tag] = dict(variants_on=v_on, variants_off=v_off, tuned=tuned, wall_on_s=w_on,
                         wall_off_s=w_off)
        del runs
    return rows


def tuned_times(torch, mm, q, at) -> dict:
    """The summary rows' own timed calls (5b's X X^T on the w_in stack, 8a's
    global Q1 of embed) with the committed table's variant for their shape,
    beside the default's, in turns (default, tuned, tuned, default)."""
    table = at.AutotuneTable.load(at.DEFAULT_TABLE_PATH)
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = normed(torch.randn((30, 576, 1536), generator=gen, device="cuda"))
    ns_tile = table.lookup("ns", (30, 576, 1536), "float32", "cuda") or mm.DEFAULT_TILE
    xq = torch.randn((2, 28_311_552), generator=gen, device="cuda")
    q_tile = table.lookup("quantize", (2, 28_311_552, 2), "float32", "cuda") or q.DEFAULT_TILE
    calls = {"matmul_epilogue": (ns_tile, lambda t: mm.matmul_epilogue(
                 x, x.mT, symmetric=True, tile=t), mm.DEFAULT_TILE),
             "quantize": (q_tile, lambda t: q.rowwise_quantize(xq, 2, tile=t), q.DEFAULT_TILE)}
    out = {}
    for name, (tile, fn, default) in calls.items():
        times = {"default": [], "tuned": []}
        for side in ("default", "tuned", "tuned", "default"):
            times[side].append(time_ms(torch, lambda: fn(tile if side == "tuned" else default)))
        out[name] = dict(tile=tile, default_ms=statistics.mean(times["default"]),
                         tuned_ms=statistics.mean(times["tuned"]))
        print(f"  {name} at its summary row's shape: default {times['default']} ms, the table's "
              f"{tile} {times['tuned']} ms")
    return out


def phase_autotune(torch, mods: dict, build_parser, train, smi: str,
                   refs: dict | None = None) -> dict:
    """Phase 21: the autotune candidates built, held bitwise, the committed
    table re-verified, the ``h100`` suite swept, and the training commands
    with the table off and on."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import autotune as at

    mm, q, ops, ref = (mods[k] for k in ("mm", "q", "ops", "ref"))
    ptxas = phase_autotune_build(_build, mods.get("autotune_build"))
    lap("21a")
    phase_autotune_bitwise(torch, _build, mm, q, ops, ref)
    lap("21b")
    tuned_keys = phase_autotune_table(torch, mm, q, ops, at)
    times = tuned_times(torch, mm, q, at)
    lap("21c")
    sweep = phase_autotune_sweep(torch, at)
    print(f"  the h100 suite on {smi}: {len(sweep)} shapes")
    lap("21d")
    runs = phase_autotune_runs(torch, _build, build_parser, train, refs)
    lap("21e")
    return dict(ptxas=ptxas, tuned_keys=tuned_keys, times=times, sweep=sweep, runs=runs)


# ---------------------------------------------------------------------------
# Slice 12 (phase 22): the mesh. Two ranks share the one card (gloo: NCCL
# refuses two ranks on one device); each is a process of this script run
# with ``--mesh-child KIND`` (kernels, serve) or under torchrun (train).
# ---------------------------------------------------------------------------

MESH_DIR = ROOT / "build" / "chip_smoke_mesh"
MESH_RANKS = 2
# 22c: the training command of the mesh: smollm-135m at full width, K = 2
# workers over pod = 2, H = 4, 2 rounds, 2-bit EF (README's compressed variant)
MESH_TRAIN = ["--arch", "smollm-135m", "--mesh", "2x1x1", "--workers", "2",
              "--sync-interval", "4", "--rounds", "2", "--seq-len", "1024",
              "--batch-per-worker", "8", "--attn-impl", "pallas", "--ns-impl", "pallas",
              "--outer-kernel", "--compression", "quant", "--bits", "2", "--error-feedback",
              "--lr", "3e-3", "--rounds-per-dispatch", "1", "--out", str(MESH_DIR / "train")]
# 22d: serving on a (data = 2) mesh: 16 requests of 128 prompt tokens and 32
# new over 16 slots (the slots and their page-table rows split over 'data')
MESH_SERVE = dict(batch=16, prompt_len=128, max_new=32, slots=16, page_size=16, max_pages=256,
                  decode_steps_per_dispatch=8)
MESH_TIMING_RUNS = 5
# 22c-22g: the rest of the trainer on the 2x1x1 mesh, each run against the
# same command in one process: 22c's command checkpoints every round (its
# files byte for byte the one process's); 22e streams (J = 2, row-wise 2-bit
# EF); 22f drops worker 1 in round 1 (the second of two) with a sync delay of
# 1; 22g is 22c's command killed after round 1, then resumed in a new world
MESH_CKPT = ["--checkpoint-every", "1"]
MESH_RUNS = {
    "22c": MESH_TRAIN + MESH_CKPT,
    "22e": replace_flags(MESH_TRAIN, out=MESH_DIR / "streaming") + ["--streaming", "2",
                                                                    "--rowwise"],
    "22f": replace_flags(MESH_TRAIN, out=MESH_DIR / "elastic") + ["--drop-schedule", "1:1",
                                                                  "--sync-delay", "1"],
    "22g": replace_flags(MESH_TRAIN, out=MESH_DIR / "drill") + MESH_CKPT,
}
MESH_KILL_ROUND = 1
# written once 22g's resume world has ended: the tensor-parallel launch's
# runs (22j ~11 GB a rank, 22i's fp32 runs ~16.5 GB) wait for it, so the
# card never holds the training launch, the tensor-parallel launch and the
# resume world's ranks at their peaks at once (22j beside the other two and
# this process's ~11.6 GiB ran the card out of memory: PERF.md section 6)
MESH_QUIET = MESH_DIR / "quiet"
# the training kernels every rank of a mesh run must launch
MESH_TRAIN_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "matmul_epilogue", "nesterov",
                      "quantize", "dequantize")
MESH_DP_KERNELS = MESH_TRAIN_KERNELS[:4]  # no outer update and no wire in DP
# 22h: Muon DP (dp_engine, K = 1) on the (data = 2) mesh, each rank 8 of the
# 16 x 1024 rows a step, against one process: fp32 compute and a constant LR
# (every step at the full LR), where a split batch differs from the whole one
# only in the order two half-batch gradients are summed (in bf16 their last
# bits differ, and AdamW's normalised step on Muon's embed and norm leaves
# turns that into a share of a step: PERF.md section 6, PR 28's 2x2x1)
MESH_DP = dict(steps=2, batch=16, seq_len=1024, lr=3e-3)
# 22h's limits on the largest per-step train-loss gap and the largest
# outer-param gap: each the geometric mean of the sound mesh run's reading
# and that of 22h's planted fault (every rank stepping on its own half
# batch's gradients, data_mean skipped), read on the H100 (PERF.md section
# 6, PR 29): losses 9.5e-7 and 2.26e-2 apart, params 2.88e-4 and 1.20e-2
# (embed), so each limit sits ~150x (losses) and ~6x (params) from both
MESH_DP_TOL = dict(loss=1.5e-4, param=1.9e-3)
# 22b: the Newton-Schulz stacks of smollm-135m's Muon leaves (wq, wk / wv,
# w_in / w_gate, w_out), each split over 'data' and held bitwise
MESH_NS_STACKS = [(30, 576, 576), (30, 576, 192), (30, 576, 1536), (30, 1536, 576)]
# 22i: tensor parallelism over 'model' (core/collectives.py) on paper-416m
# (8 heads of 128, d 1024, d_ff 2816, vocab 128256), two ranks sharing the
# card on --mesh 1x2, each rank half of every block matrix: the training
# command of 12d at full depth in bf16 for 2 rounds of H = 2, one sequence
# of 2048 a worker step (12d: 4; every activation of a step is summed over
# 'model' through host memory, so the sums scale with the rows), for the
# walls, the bytes summed over 'model' and each rank's peak memory
MESH_TP_TRAIN = replace_flags(TRAIN_LADDER, sync_interval=2, rounds=2, batch_per_worker=1,
                              out=MESH_DIR / "tp") + ["--mesh", "1x2"]
# 22i's fp32 check: paper-416m at full width, depth cut to 2 layers, K = 2, H
# = 2, 2 sequences of 2048 a worker step, 2 rounds at a constant LR, on 1x2
# against one process, and the same with a planted fault (the QK-norm
# scales' gradients left to each rank's own heads); the same config on 1x2
# with each worker whole on both ranks (the whole-worker layout) gives the
# walls and peak memory the split is held beside
MESH_TP_FP32 = dict(depth=2, K=2, H=2, batch=2, seq_len=2048, rounds=2, lr=3e-3)
# 22i's limit on the largest relative outer-param gap (|a - b| / |a| of a
# leaf, Frobenius) of the fp32 check. Relative, not the largest entry:
# AdamW's normalised step turns the last bits of a nearly cancelling
# gradient into a share of a step on a few of embed's 131M entries, which
# the norm does not see. On the H100 (PERF.md section 6) the sound run read
# 2.19e-5 (ln2_post_scale) and the planted fault 0.906 (q_norm_scale): the
# limit is their geometric mean, ~200x from both. The per-round loss gap is
# printed and not held: at depth 2 the sound run read 0 and the fault only
# 5.15e-5, one step of the check's fp32 losses from each other
MESH_TP_TOL = dict(param=4.5e-3)
# 22j: one round of MESH_TRAIN at H = 1 on (data = 2), each rank both workers
# and half of each batch, Muon's Newton-Schulz stacks split over 'data'
# (which the trainer leaves off where gloo stages through host memory:
# launch/sharding.kernel_specs), against the same round with the engine's
# routing at ns_axes=() (each rank the whole stack): bitwise
MESH_NS_TRAIN = replace_flags(MESH_TRAIN, mesh="2x1", rounds=1, sync_interval=1,
                              out=MESH_DIR / "ns_split")
MESH_RUNS.update({"22i": MESH_TP_TRAIN, "22j_split": MESH_NS_TRAIN,
                  "22j_whole": replace_flags(MESH_NS_TRAIN, out=MESH_DIR / "ns_whole")})
# phase 22's two torchrun launches of two ranks, by the runs each makes in
# turn: "train" starts with 22g's kill world and this process's one-process
# runs; "tp" once those have ended, its runs after 22g's resume world
# (MESH_QUIET). With ``--only 22`` the "tp" launch also runs 22i's
# measurements: the fp32 check's whole-worker twin (each worker whole on
# both ranks; the walls and peak memory the split is held beside) and the
# bf16 run at full depth, after the "train" launch has ended
MESH_LAUNCHES = {"train": ("22c", "22h_fault", "22e", "22f", "22h"),
                 "tp": ("22j_split", "22j_whole", "22i_fault", "22i_fp32")}
MESH_TP_MEASURE = ("22i_whole", "22i")


def mesh_env(rank: int, port: int, world: int = MESH_RANKS) -> dict:
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                PYTHONPATH=str(ROOT / "src"))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(cmd: list, label: str, torchrun: bool = False) -> list:
    """Start ``cmd`` as the mesh's ranks, each a process with its rank's
    environment, or once when ``torchrun`` (the launcher starts the ranks);
    each process writes ``MESH_DIR/<label>.<i>.log``. Returns the processes
    for :func:`wait_ranks`."""
    port = free_port()
    n = 1 if torchrun else MESH_RANKS
    envs = ([dict(os.environ, PYTHONPATH=str(ROOT / "src"))] if torchrun
            else [mesh_env(r, port) for r in range(n)])
    procs = []
    for i, env in enumerate(envs):
        with open(MESH_DIR / f"{label}.{i}.log", "w") as log:
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                          stderr=subprocess.STDOUT, text=True))
    return procs


def wait_ranks(procs: list, label: str, timeout: int = 600, expect: int = 0) -> None:
    """Wait for :func:`start_ranks`' processes and raise with the tail of
    each one whose exit code is not ``expect`` (-9: killed by SIGKILL);
    every process is stopped."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        if p.returncode != expect:
            path = MESH_DIR / f"{label}.{i}.log"
            log = path.read_text()
            why = root_cause(log)
            print(f"  {label}: process {i} exited {p.returncode}; {resources()}; the root "
                  f"cause in {path}:\n{why}", flush=True)
            # the cause last: a reader of the run's error stream sees its end
            raise AssertionError(f"{label}: process {i} exited {p.returncode}, not {expect}; "
                                 f"{resources()}; the log's end:\n{log[-2500:]}\n...\nthe "
                                 f"root cause ({path}):\n{why}")


def root_cause(log: str) -> str:
    """What a failed rank process's log says of why: under torchrun the
    traceback lines of the rank its summary names as the root cause
    (``[rankN]: ...``; the launcher interleaves its ranks' output), else
    the text from the first traceback on."""
    m = re.search(r"Root Cause.*?rank\s*:\s*(\d+)", log, re.S)
    if m:
        lines = [ln for ln in log.splitlines() if ln.startswith(f"[rank{m.group(1)}]:")]
        if lines:
            return "\n".join(lines)[-6000:]
    first = log.find("Traceback")
    return log[first:first + 6000] if first >= 0 else log[-3000:]


def resources() -> str:
    """The card's free memory, the host's available memory and the free
    disk under ``MESH_DIR``, for a failed rank's report."""
    import shutil

    import torch

    free, total = torch.cuda.mem_get_info()
    avail = "not read"
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    avail = f"{int(line.split()[1]) / 2**20:.1f} GiB"
    except OSError:
        pass
    return (f"card free {free / 2**30:.1f} of {total / 2**30:.1f} GiB (this process reserves "
            f"{torch.cuda.memory_reserved() / 2**30:.1f}), host available {avail}, disk free "
            f"{shutil.disk_usage(MESH_DIR).free / 2**30:.1f} GiB")


def _mesh_child_start(torch):
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    return dist.get_rank()


def mesh_kernel_cases(torch, fa, ops, device="cuda"):
    """name -> (body, flash?, inputs): each kernel's wrapper
    body at the main path's shapes (smollm-135m at full width: one worker's
    flash shapes, q [B·KV, S, G, hd] = [24, 1024, 3, 64] bf16; the serving
    decode step, q [16, 9, 64] against a [1024, 16, 3, 64] pool; the
    Newton-Schulz stack and the outer update on w_in [30, 576, 1536] fp32;
    the wire's K-folded rows of w_in, [2, 26,542,080]), made from seed 22 on
    every rank alike. ``flash?``: a flash body on the kernel layout, which
    the caller routes by ``flash_body_specs``; the other bodies are the
    public wrappers, which route themselves."""
    g = torch.Generator(device=device).manual_seed(22)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    bf = torch.bfloat16
    BKV, S, G, hd = 24, 1024, 3, 64
    scale = 1.0 / math.sqrt(hd)
    q, k, v = rand(BKV, S, G, hd, dtype=bf), rand(BKV, S, hd, dtype=bf), rand(BKV, S, hd, dtype=bf)
    do = rand(BKV, S, G, hd, dtype=bf)
    o, lse = fa._fwd(q, k, v, causal=True, window=0, scale=scale)
    dl = torch.sum(do.float() * o.float(), dim=-1)
    kw = dict(causal=True, window=0, scale=scale)
    n_pages, ps, slots, W = 1024, 16, 16, 40
    pq = rand(slots, 9, hd, dtype=bf)
    kp, vp = rand(n_pages, ps, 3, hd, dtype=bf), rand(n_pages, ps, 3, hd, dtype=bf)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(22))[:slots * W]
    table = (perm + 1).reshape(slots, W).to(torch.int32).to(device)
    lengths = torch.randint(1, W * ps, (slots,), generator=torch.Generator().manual_seed(23),
                            dtype=torch.int32).to(device)
    w = rand(30, 576, 1536)
    psi, u = rand(30, 576, 1536), rand(30, 576, 1536)
    rows = rand(2, 30 * 576 * 1536)
    codes, lo_, sc_ = ops.quantize_codes_rowwise(rows, 2)
    return {
        "flash_fwd": (lambda a, b, c: fa._fwd(a, b, c, **kw), True, (q, k, v)),
        "flash_dq": (lambda *a: fa._dq_cuda(*a, **kw), True, (q, k, v, do, lse, dl)),
        "flash_dkv": (lambda *a: fa._dkv_cuda(*a, **kw), True, (q, k, v, do, lse, dl)),
        "paged_decode": (lambda *a: fa.paged_decode_attention(*a, impl="pallas"), False,
                         (pq, kp, vp, table, lengths)),
        "matmul_epilogue": (lambda x: ops.ns_orthogonalize(x), False, (w,)),
        "nesterov": (lambda a, b, c: ops.nesterov_update(a, b, c, lr=0.7, momentum=0.9), False,
                     (w, psi, u)),
        "quantize": (lambda x: ops.quantize_codes_rowwise(x, 2), False, (rows,)),
        "dequantize": (lambda *a: ops.dequantize_rowwise(*a), False, (codes, lo_, sc_)),
    }


def flash_body_specs(fa, part, name: str, lead: int) -> tuple:
    """(in specs, out specs) of a flash kernel's body on the kernel layout,
    as ``gqa_flash_attention`` routes the forward and its backward."""
    q, kv = fa.flash_specs(part, lead)
    row = q[:3]  # lse and dl: [B·KV, S, G]
    if name == "flash_fwd":
        return (q, kv, kv), (q, row)
    ins = (q, kv, kv, q, row, row)
    return ins, (q if name == "flash_dq" else (kv, kv))


def mesh_child_kernels(torch) -> None:
    """[22b, one rank] each kernel through ``kernels/partition.py`` on the
    (pod=2) mesh and on the (data=2) mesh of the two ranks: the routed call
    on replicated DTensors runs the kernel on this rank's block, which must
    equal that block of the one-process call on the whole tensor, bitwise.
    On the (data=2) mesh both are timed (the ranks take turns on the card).
    Then 22d's serving (:func:`mesh_serve`) in the same processes."""
    import json as _json

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.partition import kernel_partitioning, local_block, shard_wrap
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import kernel_specs

    rank = _mesh_child_start(torch)
    cases = mesh_kernel_cases(torch, fa, ops)

    def specs(mesh):  # the split itself, which the trainer leaves off on gloo
        return dataclasses.replace(kernel_specs(mesh), ns_axes=("data",))

    time_ms(torch, lambda: cases["flash_fwd"][0](*cases["flash_fwd"][2]))  # clocks up
    out = {}
    for mesh_name, mesh in (("pod2", make_debug_mesh(1, 1, pod=2, device_type="cuda")),
                            ("data2", make_debug_mesh(2, 1, device_type="cuda"))):
        part = specs(mesh)
        for name, (body, flash, args) in cases.items():
            whole = body(*args)
            whole = whole if isinstance(whole, tuple) else (whole,)
            fn = body
            if flash:  # the kernel layout's bodies, routed as the wrapper routes them
                fn = shard_wrap(body, part, *flash_body_specs(fa, part, name, args[0].shape[0]))
            dts = tuple(DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
                        for a in args)
            before = dict(_build.LAUNCHES)
            with kernel_partitioning(part):
                routed = fn(*dts)
            torch.cuda.synchronize()
            launches = {k: n - before[k] for k, n in _build.LAUNCHES.items() if n != before[k]}
            routed = routed if isinstance(routed, tuple) else (routed,)
            same = all(torch.equal(r.to_local(), local_block(w_, mesh, r.placements))
                       for r, w_ in zip(routed, whole))
            local_shape = list(routed[0].to_local().shape)
            times = {}
            for turn in range(MESH_RANKS if mesh_name == "data2" else 0):
                dist.barrier()
                if turn == rank:
                    with kernel_partitioning(part):
                        times["local_ms"] = time_ms(torch, lambda: fn(*dts), MESH_TIMING_RUNS)
                    times["whole_ms"] = time_ms(torch, lambda: body(*args), MESH_TIMING_RUNS)
                dist.barrier()
            out.setdefault(name, {})[mesh_name] = {
                "bitwise": bool(same), "local": local_shape, "whole": list(whole[0].shape),
                "launches": launches, **times,
                "placements": [str(p) for p in routed[0].placements]}
            del whole, routed
    # every Newton-Schulz stack of smollm-135m's Muon leaves split over 'data'
    mesh = make_debug_mesh(2, 1, device_type="cuda")
    part = specs(mesh)
    g = torch.Generator(device="cuda").manual_seed(23)
    for shape in MESH_NS_STACKS:
        x = torch.randn(shape, generator=g, device="cuda")
        whole = ops.ns_orthogonalize(x)
        with kernel_partitioning(part):
            routed = ops.ns_orthogonalize(
                DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False))
        out["matmul_epilogue"]["data2"].setdefault("stacks", {})[str(list(shape))] = bool(
            torch.equal(routed.to_local(), local_block(whole, mesh, routed.placements)))
    (MESH_DIR / f"kernels.rank{rank}.json").write_text(_json.dumps(out))
    del cases
    torch.cuda.empty_cache()
    mesh_serve(torch, rank)
    dist.barrier()
    dist.destroy_process_group()


def outer_digests(torch, params) -> dict:
    """path -> sha256 of a whole outer-param leaf's bytes (two runs' leaves
    are bitwise equal exactly where their digests are)."""
    import hashlib

    from repro_torch.utils.tree import tree_leaves_with_paths

    return {p: hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()
            for p, t in tree_leaves_with_paths(params)}


def mesh_dp_run(torch, mesh=None, fault: bool = False) -> dict:
    """[22h] Muon DP through ``dp_engine(model, 'muon', icfg, mesh=)`` by
    ``run_rounds``: ``MESH_DP['steps']`` eager steps of smollm-135m at full
    width in fp32 (one process: ``capture=False``, the mesh's arithmetic,
    6d / 10a hold eager = captured). ``fault`` plants the fault 22h's limits
    must catch: each rank steps on its own half batch's gradients (the loss
    is still averaged). Returns the records, the whole params on the host
    and the launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import diloco
    from repro_torch.core.collectives import whole
    from repro_torch.data import DataConfig, MarkovStream, batches_for_round, batches_for_span
    from repro_torch.engine import dp_engine, run_rounds
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.optim import OptimizerConfig
    from repro_torch.utils.tree import tree_leaves_with_paths

    n, B, S = MESH_DP["steps"], MESH_DP["batch"], MESH_DP["seq_len"]
    cfg = get_config("smollm-135m").replace(max_seq_len=S, attn_impl="pallas", dtype="float32")
    icfg = OptimizerConfig(lr=MESH_DP["lr"], weight_decay=1e-4, schedule="constant",
                           total_steps=n)
    data = MarkovStream(DataConfig(vocab=cfg.vocab, seq_len=S, batch_per_worker=B, n_workers=1,
                                   seed=0), "cuda")
    engine = dp_engine(build_model(cfg), "muon", icfg, mesh=mesh, capture=False)
    state = engine.init(torch.Generator(device="cuda").manual_seed(0), torch.device("cuda"))
    _build.reset_launch_counts()
    mean = diloco.data_mean
    if fault:
        diloco.data_mean = lambda x: x if x.dim() else mean(x)
    try:
        state, hist = run_rounds(engine, state, lambda r: batches_for_round(data, r, 1), n,
                                 rounds_per_dispatch=1,
                                 span_batches_for=lambda r0, m: batches_for_span(data, r0, 1, m))
    finally:
        diloco.data_mean = mean
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    params = {p: whole(t).cpu() for p, t in tree_leaves_with_paths(state["outer_params"])}
    return {"history": hist, "params": params, "launches": launches}


def mesh_child_kill(torch) -> None:
    """[22g, one rank] ``MESH_RUNS['22g']`` with ``--inject-kill-round``:
    every rank dies by SIGKILL once rank 0 has written round 1's row."""
    from repro_torch.launch.train import build_parser, train

    _mesh_child_start(torch)
    train(build_parser().parse_args(MESH_RUNS["22g"] + ["--inject-kill-round",
                                                        str(MESH_KILL_ROUND)]))
    raise SystemExit("22g: the rank survived its kill round")


def mesh_cli_runs(torch, label: str, runs: list, quiet_before: str | None = None) -> None:
    """[one rank of 22c-22j] ``runs``, (name, argv) pairs: each command
    through the CLI entry point (``launch/train.py:train``), or with argv
    None 22h's Muon DP on the (data = 2) mesh (names ``22h*``) or 22i's fp32
    check on 1x2 (``22i*``); the run named ``quiet_before`` and those after
    it once ``MESH_QUIET`` exists (22g's resume world has ended); each under
    :func:`_tp_run_patches`. Each
    rank saves ``MESH_DIR/<label>.rank<r>.pt``: per run its launches, the
    bytes it received, the sync's times, its peak memory, whether the round
    split over 'model' and its Newton-Schulz calls; rank 0 the per-round
    records and the digests of the whole outer params (22h, 22i's fp32
    check: the params themselves; a run named ``22h_fault``: 22h with its
    planted fault)."""
    import torch.distributed as dist

    from repro_torch.core import collectives, diloco
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import build_parser, train
    from repro_torch.utils.tree import tree_map

    rank = _mesh_child_start(torch)
    syncs = []
    outer_step = diloco.outer_step

    def timed_sync(*a, **kw):  # the sync's wall and device time, per round
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        res = outer_step(*a, **kw)
        ev[1].record()
        torch.cuda.synchronize()
        syncs.append((time.perf_counter() - t0, ev[0].elapsed_time(ev[1]) / 1e3))
        return res

    diloco.outer_step = timed_sync
    records = {}
    for name, argv in runs:
        if name == quiet_before:  # 22g's resume world has ended
            t0 = time.perf_counter()
            while not MESH_QUIET.exists():
                if time.perf_counter() - t0 > 900:
                    raise TimeoutError("the kill and resume worlds did not end")
                time.sleep(0.2)
        syncs.clear()
        ns_calls: list = []
        _build.reset_launch_counts()
        mesh_mod.reset_traffic()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if argv is None:
            with _tp_run_patches(name, ns_calls):
                run = (mesh_dp_run(torch, make_debug_mesh(2, 1, device_type="cuda"),
                                   fault=name == "22h_fault") if name.startswith("22h")
                       else mesh_tp_fp32_run(torch, make_debug_mesh(1, 2, device_type="cuda")))
            rec = {"launches": run["launches"], "received": dict(mesh_mod.RECEIVED),
                   "seconds": time.perf_counter() - t0, "tp": run.get("tp"),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            if rank == 0:
                rec.update(history=run["history"], params=run["params"])
            records[name] = rec
            del run
            torch.cuda.empty_cache()
            continue
        with _tp_run_patches(name, ns_calls):
            out = train(build_parser().parse_args(argv))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rec = {"launches": dict(_build.LAUNCHES), "received": dict(mesh_mod.RECEIVED),
               "syncs": list(syncs), "seconds": seconds, "staged": dict(mesh_mod.STAGED),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "tp": out["engine"].model_group is not None, "ns": ns_calls}
        whole = tree_map(collectives.whole, out["state"]["outer_params"])  # every rank gathers
        if rank == 0:
            rec.update(history=out["history"], losses=out["losses"],
                       digests=outer_digests(torch, whole))
        records[name] = rec
        del out, whole
        torch.cuda.empty_cache()
    torch.save(records, MESH_DIR / f"{label}.rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def mesh_child_launch(torch, label: str, names: str) -> None:
    """[22c, 22e, 22f, 22h-22j, one rank of the launch ``label``, under
    torchrun] ``mesh_cli_runs`` of the comma-separated run ``names``
    (``MESH_LAUNCHES``); the "tp" launch's runs start once ``MESH_QUIET``
    exists."""
    runs = [(name, MESH_RUNS.get(name)) for name in names.split(",")]
    mesh_cli_runs(torch, label, runs, quiet_before=runs[0][0] if label == "tp" else None)


def mesh_child_resume(torch) -> None:
    """[22g, one rank of the new world] 22g's command with ``--resume auto``."""
    mesh_cli_runs(torch, "resume", [("22g", MESH_RUNS["22g"] + ["--resume", "auto"])])


def mesh_tp_fp32_run(torch, mesh=None) -> dict:
    """[22i] ``MESH_TP_FP32``: paper-416m in fp32 at a cut depth through
    ``TrainEngine`` by ``run_rounds`` (eager), on ``mesh`` or in one
    process. Returns the records, the whole outer params on the host, the
    launches, the peak memory and whether the round split over 'model'."""
    from repro_torch.configs import get_config
    from repro_torch.core import DiLoCoConfig
    from repro_torch.core.collectives import whole
    from repro_torch.data import DataConfig, MarkovStream, batches_for_round, batches_for_span
    from repro_torch.engine import TrainEngine, run_rounds
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.optim import OptimizerConfig
    from repro_torch.utils.tree import tree_leaves_with_paths

    c = MESH_TP_FP32
    cfg = get_config(LADDER).replace(n_layers=c["depth"], max_seq_len=c["seq_len"],
                                     attn_impl="pallas", dtype="float32")
    dcfg = DiLoCoConfig(n_workers=c["K"], sync_interval=c["H"], inner_name="muon",
                        ns_impl="pallas", outer_kernel=True)
    icfg = OptimizerConfig(lr=c["lr"], weight_decay=1e-4, schedule="constant")
    data = MarkovStream(DataConfig(vocab=cfg.vocab, seq_len=c["seq_len"],
                                   batch_per_worker=c["batch"], n_workers=c["K"], seed=0), "cuda")
    torch.cuda.reset_peak_memory_stats()
    engine = TrainEngine(build_model(cfg), dcfg, icfg, mesh=mesh, capture=False)
    state = engine.init(torch.Generator(device="cuda").manual_seed(0), torch.device("cuda"))
    _build.reset_launch_counts()
    state, hist = run_rounds(
        engine, state, lambda r: batches_for_round(data, r, c["H"]), c["rounds"],
        rounds_per_dispatch=1,
        span_batches_for=lambda r0, m: batches_for_span(data, r0, c["H"], m))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    params = {p: whole(t).cpu() for p, t in tree_leaves_with_paths(state["outer_params"])}
    return {"history": hist, "params": params, "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "tp": engine.model_group is not None}


def _tp_run_patches(name: str, ns_calls: list):
    """[22i, 22j] The run ``name``'s stand-ins, undone on exit: 22i's planted
    fault (each rank's QK-norm gradients of its own heads only), 22i's
    whole-worker twin (``tp_compute`` says no, so each rank computes each
    worker whole) and 22j's routing (``ns_axes`` ('data',) and ()); on 22j's
    runs each Newton-Schulz call's stack rows and ms go to ``ns_calls``."""
    import contextlib

    from repro_torch.kernels import ops
    from repro_torch.launch import sharding, steps
    from repro_torch.models import attention

    import torch

    stack = contextlib.ExitStack()

    def patch(mod, attr, value):
        old = getattr(mod, attr)
        setattr(mod, attr, value)
        stack.callback(setattr, mod, attr, old)

    if name == "22i_fault":
        patch(attention, "shared_weight", lambda w: w)
    if name == "22i_whole":
        patch(steps, "tp_compute", lambda cfg, mesh: (False, "22i's whole-worker twin"))
    if name.startswith("22j"):  # split over 'data', or each rank the whole stack
        specs, axes = sharding.kernel_specs, ("data",) if name == "22j_split" else ()
        patch(sharding, "kernel_specs",
              lambda *a, **kw: dataclasses.replace(specs(*a, **kw), ns_axes=axes))
    if name.startswith("22j"):
        local, public = ops._ns_local, ops.ns_orthogonalize

        def counted(g3, *a):  # the stack rows this rank's kernels ran on
            ns_calls.append({"rows": int(g3.shape[0])})
            return local(g3, *a)

        def timed(g, *a, **kw):  # the call's ms, its gather over 'data' included
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = public(g, *a, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            ns_calls[-1]["ms"] = ev[0].elapsed_time(ev[1])
            return out

        patch(ops, "_ns_local", counted)
        patch(ops, "ns_orthogonalize", timed)
    return stack


def mesh_serve(torch, rank: int) -> None:
    """[22d, one rank, in 22b's processes] ``MESH_SERVE``'s requests through
    a PagedEngine on the (data=2) mesh; rank 0 saves the greedy tokens and
    the launches."""
    import json as _json

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import random_prompts, requests_for
    from repro_torch.models import build_model
    from repro_torch.serving import PagedEngine

    cfg = get_config("smollm-135m").replace(attn_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), torch.device("cuda"))
    mesh = make_debug_mesh(2, 1, device_type="cuda")
    kw = {k: MESH_SERVE[k] for k in ("slots", "page_size", "max_pages",
                                      "decode_steps_per_dispatch")}
    engine = PagedEngine(model, params, attn_impl="pallas", device="cuda", mesh=mesh, **kw)
    reqs = requests_for(random_prompts(cfg.vocab, MESH_SERVE["batch"], MESH_SERVE["prompt_len"]),
                        MESH_SERVE["max_new"])
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.run(reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rank == 0:
        (MESH_DIR / "serve.json").write_text(_json.dumps({
            "tokens": {r: t.tolist() for r, t in res.items()}, "seconds": seconds,
            "launches": dict(_build.LAUNCHES), "formula": engine.launches(),
            "stats": engine.stats}))


def phase_mesh_kernels(torch, smi: str, world: list) -> dict:
    """[22b] ``mesh_child_kernels`` on two ranks (``world``, started beside
    phase 22's training runs): every kernel bitwise on both meshes, its
    launches in the routed call, local and whole times (contended)."""
    print(f"[22b] each kernel across {MESH_RANKS} ranks on one card (gloo), through "
          f"kernels/partition.py, bitwise against the one-process call (the same processes "
          f"then serve 22d's requests), beside the mesh's training runs; card: {smi}")
    wait_ranks(world, "kernels")
    per_rank = [json.loads((MESH_DIR / f"kernels.rank{r}.json").read_text())
                for r in range(MESH_RANKS)]
    rows = {}
    for name, meshes in per_rank[0].items():
        rows[name] = {}
        for mesh_name, v in meshes.items():
            others = [pr[name][mesh_name] for pr in per_rank]
            ok = all(o["bitwise"] for o in others)
            launched = all(o["launches"] for o in others)
            stacks = {k: all(o["stacks"][k] for o in others) for k in v.get("stacks", {})}
            timed = (f"; local {v['local_ms']:.4f} ms, whole {v['whole_ms']:.4f} ms (rank 0, "
                     f"contended; card: {smi})" if "local_ms" in v else "")
            print(f"  {name:16s} {mesh_name}: local {v['local']} of {v['whole']} "
                  f"{v['placements']}, bitwise on every rank: {ok}, launches a rank "
                  f"{[o['launches'] for o in others]}{timed}"
                  + (f"; every smollm stack split over data bitwise: {stacks}" if stacks else ""))
            assert ok and all(stacks.values()), (name, mesh_name, stacks)
            assert launched, (name, mesh_name, "no launch")
            rows[name][mesh_name] = {"ranks": MESH_RANKS, "bitwise": ok, "local": v["local"],
                                     "launches": sum(sum(o["launches"].values())
                                                     for o in others),
                                     **{k: v[k] for k in ("local_ms", "whole_ms") if k in v}}
    return rows


def _csv_sans_wall(path) -> list:
    import csv

    with open(path, newline="") as f:
        return [row[:-1] for row in csv.reader(f)]


def same_bytes(a: Path, b: Path, chunk: int = 1 << 26) -> bool:
    """Whether two files hold the same bytes (read 64 MB at a time)."""
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(chunk)
            if x != fb.read(chunk):
                return False
            if not x:
                return True


def _one_argv(argv: list, out) -> list:
    """A mesh command as the one-process command, writing to ``out``."""
    return replace_flags([a for a in argv if a not in ("--mesh", "2x1x1")], out=out)


def phase_mesh_train(torch, build_parser, train, smi: str, procs: list, beside: list,
                     tp_measure: bool = False) -> dict:
    """[22c-22j] the torchrun launch "train" of two ranks (``MESH_LAUNCHES``:
    ``MESH_RUNS``' 22c, 22h's planted fault, 22e, 22f and 22h's Muon DP)
    beside 22g's kill (two rank processes, each dying by SIGKILL after
    round 1's row) and, in this process, the one-process command of 22c,
    22e and 22f (no ``--mesh``; eager rounds, which 6d holds bitwise to the
    captured ones), 22h's one-process DP and 22i's one-process fp32 run;
    once those are done, 22g's ``--resume auto`` in a new world of two and,
    once the processes ``beside`` (22b's world) have also ended, the launch
    "tp", whose runs start once the resume world has ended (22j's two
    rounds, then 22i's planted fault and fp32 check; with ``tp_measure``
    also 22i's whole-worker twin and bf16 run, and all of them once the
    "train" launch has ended). Every wall but those of ``tp_measure``'s runs is contended.
    Bitwise: every run's
    per-round train and eval losses, comm_bytes, active_workers and
    staleness and every outer-param leaf; 22c's checkpoint files byte for
    byte; 22g's resumed metrics.csv (but wall_s) and outer leaves against
    22c's mesh run. 22h within ``MESH_DP_TOL`` and its planted fault
    outside it. Every rank launched every training kernel in every run.
    Prints each mesh run's round walls, the sync's times and the bytes each
    rank gathered a round; ``phase_mesh_tp`` reads 22i's and 22j's, whose
    launch runs on while 22c-22h are checked. Every process it starts goes
    to ``procs`` (the caller stops them if a check fails)."""
    import shutil

    from repro_torch.kernels import _build

    launches = {"train": MESH_LAUNCHES["train"],
                "tp": MESH_LAUNCHES["tp"] + (MESH_TP_MEASURE if tp_measure else ())}
    for sub in ("train", "streaming", "elastic", "drill"):  # a rerun's files
        for d in (MESH_DIR / sub, MESH_DIR / f"{sub}_one"):
            shutil.rmtree(d, ignore_errors=True)
    MESH_QUIET.unlink(missing_ok=True)
    child = [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-child"]
    print(f"[22g] the crash drill on a 2x1x1 mesh (two rank processes, gloo): "
          f"repro_torch.launch.train {' '.join(MESH_RUNS['22g'])} --inject-kill-round "
          f"{MESH_KILL_ROUND}; card: {smi}")
    print(f"[22c-22j] two torchrun launches of {MESH_RANKS} ranks beside 22g's kill world, "
          f"then its resume world, and this process's one-process runs: \"train\" runs 22c "
          f"({' '.join(MESH_RUNS['22c'])}), 22h's planted fault, 22e (+ "
          f"{' '.join(MESH_RUNS['22e'][-3:])}), 22f (+ {' '.join(MESH_RUNS['22f'][-4:])}) and 22h "
          f"(Muon DP, dp_engine on data = 2, {MESH_DP}); \"tp\", once the resume world has ended, 22j "
          f"({' '.join(MESH_NS_TRAIN)}, split over 'data', then at ns_axes=()), 22i's planted "
          f"fault and fp32 check (paper-416m, {MESH_TP_FP32}, --mesh 1x2)"
          + (f", then, once \"train\" has ended, the check's whole-worker twin and 22i "
             f"({' '.join(MESH_TP_TRAIN)})" if tp_measure else "") + f"; card: {smi}")
    def start_launch(label: str) -> list:
        return start_ranks([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                            str(MESH_RANKS), "--master-port", str(free_port())] + child[1:]
                           + [f"launch:{label}:{','.join(launches[label])}"], label,
                           torchrun=True)

    t0 = time.perf_counter()
    killed = start_ranks(child + ["kill"], "kill")
    launch = start_launch("train")
    procs += killed + launch
    refs = {}
    for name in ("22c", "22e", "22f"):  # beside the mesh's runs: walls not kept
        argv = MESH_RUNS[name]
        one_out = Path(str(argv[argv.index("--out") + 1]) + "_one")
        _build.reset_launch_counts()
        one = train(build_parser().parse_args(_one_argv(argv, one_out)), capture=False)
        torch.cuda.synchronize()
        refs[name] = {"history": one["history"], "launches": dict(_build.LAUNCHES),
                      "digests": outer_digests(torch, one["state"]["outer_params"]),
                      "out": one_out}
        del one
        torch.cuda.empty_cache()
    one_dp = mesh_dp_run(torch)
    torch.cuda.empty_cache()
    one_tp = mesh_tp_fp32_run(torch)  # 22i's one-process fp32 run
    torch.cuda.empty_cache()
    refs_s = time.perf_counter() - t0
    wait_ranks(killed, "kill", expect=-9)
    drill = MESH_DIR / "drill"
    ckpts = sorted(f.name for f in drill.glob("ckpt_*.npz"))
    killed_rows = [r[0] for r in _csv_sans_wall(drill / "metrics.csv")[1:]]
    print(f"  22g: every rank exited -9 (SIGKILL) after {time.perf_counter() - t0:.1f} s; "
          f"left {ckpts}, metrics.csv rounds {killed_rows}; the one-process runs "
          f"{refs_s:.1f} s")
    assert ckpts == [f"ckpt_{MESH_KILL_ROUND}.npz"] and killed_rows == ["0", "1"], (
        ckpts, killed_rows)
    resumed = start_ranks(child + ["resume"], "resume")  # a new world of two ranks
    procs += resumed
    for p in beside:  # the card's memory: 22b's world ends first (its caller checks it)
        p.wait(timeout=600)
    tp_launch = start_launch("tp")
    procs += tp_launch
    print(f"  the tensor-parallel launch started at {time.perf_counter() - t0:.1f} s; "
          f"{resources()}")
    wait_ranks(resumed, "resume")
    print(f"  22g: --resume auto in a new world ended after {time.perf_counter() - t0:.1f} s")
    if not tp_measure:
        MESH_QUIET.write_text("")
    wait_ranks(launch, "train", timeout=900)
    print(f"  the training launch: {time.perf_counter() - t0:.1f} s; {resources()}")
    MESH_QUIET.write_text("")  # tp_measure's runs have the card to their launch
    ranks = [{**torch.load(MESH_DIR / f"train.rank{r}.pt", weights_only=False),
              **torch.load(MESH_DIR / f"resume.rank{r}.pt", weights_only=False)}
             for r in range(MESH_RANKS)]
    mesh = ranks[0]
    for name, rec in mesh.items():  # every rank launched every training kernel
        if name.startswith("22i"):  # phase_mesh_tp's
            continue
        names = MESH_DP_KERNELS if name.startswith("22h") else MESH_TRAIN_KERNELS
        for r, per in enumerate(ranks):
            missing = [k for k in names if per[name]["launches"].get(k, 0) <= 0]
            assert not missing, (name, "rank", r, "launched none of", missing)
    keys = ("train_loss", "train_loss_last", "eval_loss", "comm_bytes", "active_workers",
            "staleness")
    tokens = 2 * 4 * 8 * 1024
    runs = {}
    for name in ("22c", "22e", "22f"):
        m, one = mesh[name], refs[name]
        assert len(one["history"]) == len(m["history"]) == 2, name
        for a, b in zip(one["history"], m["history"]):
            for k in keys:
                assert a[k] == b[k], (name, "round", a["round"], k, a[k], b[k])
        apart = [p for p in one["digests"] if one["digests"][p] != m["digests"][p]]
        assert not apart, (name, "outer leaves not bitwise", apart[:3])
        walls = [r["wall_s"] for r in m["history"]]
        print(f"  [{name}] per-round {', '.join(keys)} and all {len(one['digests'])} outer-param "
              f"leaves bitwise the one-process run's; rounds "
              f"{[r['round'] for r in m['history']]}: active "
              f"{[r['active_workers'] for r in m['history']]}, staleness "
              f"{[r['staleness'] for r in m['history']]}, comm_bytes "
              f"{[r['comm_bytes'] for r in m['history']]}")
        # 22c runs beside 22g's worlds and this process's one-process runs,
        # 22e and 22f beside the resume world or the "tp" launch
        rate = (f"contended (beside 22g's worlds and the one-process runs)" if name == "22c"
                else f"{tokens / walls[-1]:.1f} tok/s in round 2 (contended: beside the resume "
                     f"world or the \"tp\" launch)")
        print(f"  [{name}] mesh round walls {[round(w, 3) for w in walls]} s, {rate}; the run "
              f"{m['seconds']:.1f} s; the sync (outer_step, rank 0) wall "
              f"{[round(x[0], 3) for x in m['syncs']]} s, on the card "
              f"{[round(x[1], 4) for x in m['syncs']]} s; bytes rank 0 received over the run "
              f"{m['received']} (each rank, a round: "
              f"{ {k: v // 2 for k, v in m['received'].items()} }); launches rank 0 "
              f"{m['launches']}, rank 1 {ranks[1][name]['launches']}, one process "
              f"{one['launches']}; peak memory a rank "
              f"{[round(per[name]['peak_gb'], 2) for per in ranks]} GB; card: {smi}")
        runs[name] = {"walls": walls, "received": m["received"],
                      "launches": [per[name]["launches"] for per in ranks]}
        if name != "22c":
            runs[name]["tok_s"] = tokens / walls[-1]
        if name == "22c":  # the checkpoints, byte for byte
            mesh_dir = Path(str(MESH_RUNS[name][MESH_RUNS[name].index("--out") + 1]))
            files = sorted(f.name for f in one["out"].glob("ckpt_*.npz"))
            assert files == ["ckpt_1.npz", "ckpt_2.npz"], files
            assert files == sorted(f.name for f in mesh_dir.glob("ckpt_*.npz"))
            for f in files:
                assert same_bytes(mesh_dir / f, one["out"] / f), (f, "differs")
            print(f"  [22c] {files} byte for byte the one-process run's "
                  f"({[(mesh_dir / f).stat().st_size for f in files]} B)")
    g = mesh["22g"]
    resumed, want = (_csv_sans_wall(MESH_DIR / d / "metrics.csv") for d in ("drill", "train"))
    assert resumed == want, ("22g: the resumed metrics.csv", resumed, want)
    apart = [p for p in g["digests"] if g["digests"][p] != mesh["22c"]["digests"][p]]
    assert not apart, ("22g: outer leaves apart from 22c's mesh run", apart[:3])
    print(f"  [22g] resumed from ckpt_{MESH_KILL_ROUND}.npz in a new world: "
          f"metrics.csv (but wall_s, rounds {[r[0] for r in resumed[1:]]}) and all "
          f"{len(g['digests'])} outer leaves equal 22c's uninterrupted mesh run; the resumed "
          f"run {g['seconds']:.1f} s (the load included), round wall "
          f"{[round(r['wall_s'], 3) for r in g['history']]} s")
    def dp_gaps(h: dict) -> tuple:  # (largest loss gap, (leaf, largest param gap))
        loss = max(abs(a["train_loss"] - b["train_loss"])
                   for a, b in zip(one_dp["history"], h["history"]))
        gaps = {p: (one_dp["params"][p].double() - t.double()).abs().max().item()
                for p, t in h["params"].items()}
        return loss, max(gaps.items(), key=lambda kv: kv[1])

    (loss_gap, worst), (fault_loss, fault_worst) = dp_gaps(mesh["22h"]), dp_gaps(
        mesh["22h_fault"])
    h, dp_tokens = mesh["22h"], MESH_DP["batch"] * MESH_DP["seq_len"]
    walls = [r["wall_s"] for r in h["history"]]
    held = loss_gap <= MESH_DP_TOL["loss"] and worst[1] <= MESH_DP_TOL["param"]
    caught = fault_loss > MESH_DP_TOL["loss"] and fault_worst[1] > MESH_DP_TOL["param"]
    print(f"  [22h] Muon DP on data = 2 (fp32, constant LR) against one process (eager): "
          f"losses {[round(b['train_loss'], 6) for b in h['history']]} / "
          f"{[round(a['train_loss'], 6) for a in one_dp['history']]}; largest loss gap "
          f"{loss_gap:.3e} (limit {MESH_DP_TOL['loss']:.1e}), largest param gap {worst[1]:.3e} "
          f"({worst[0]}; limit {MESH_DP_TOL['param']:.1e}): {'held' if held else 'MISSED'}; the "
          f"planted fault (each rank on its half batch's gradients): loss gap {fault_loss:.3e}, "
          f"param gap {fault_worst[1]:.3e} ({fault_worst[0]}): "
          f"{'caught' if caught else 'NOT CAUGHT'}; step walls {[round(w, 3) for w in walls]} s, "
          f"{dp_tokens / walls[-1]:.1f} tok/s in the last step; bytes rank 0 received "
          f"{h['received']}; launches rank 0 {h['launches']}, rank 1 "
          f"{ranks[1]['22h']['launches']}, one process {one_dp['launches']}; peak memory a rank "
          f"{[round(per['22h']['peak_gb'], 2) for per in ranks]} GB; card: {smi}")
    assert held and caught, (loss_gap, worst, fault_loss, fault_worst)
    runs["22h"] = {"walls": walls, "tok_s": dp_tokens / walls[-1], "loss_gap": loss_gap,
                   "param_gap": worst[1], "fault_loss_gap": fault_loss,
                   "fault_param_gap": fault_worst[1], "limits": MESH_DP_TOL,
                   "launches": [per["22h"]["launches"] for per in ranks]}
    runs["22g"] = {"launches": [per["22g"]["launches"] for per in ranks]}
    for f in MESH_DIR.glob("*/ckpt_*.npz"):  # ~4.5 GB each
        f.unlink()
    wait_ranks(tp_launch, "tp", timeout=900)
    print(f"  the tensor-parallel launch: {time.perf_counter() - t0:.1f} s; {resources()}")
    for r, per in enumerate(ranks):
        per.update(torch.load(MESH_DIR / f"tp.rank{r}.pt", weights_only=False))
    return {"launches": mesh["22c"]["launches"], "received": mesh["22c"]["received"],
            "runs": runs, "ranks": ranks, "one_tp": one_tp}


def phase_mesh_tp(torch, trained: dict, smi: str) -> dict:
    """[22i, 22j] the records of the "tp" launch (``phase_mesh_train``):
    22i's fp32 check within ``MESH_TP_TOL`` of this process's one-process
    run and its planted fault outside it, with its round walls and peak
    memory a rank; where the launch ran them (``--only 22``), its
    whole-worker twin's walls and peak memory on the same 1x2 mesh and the
    bf16 run at full depth split over 'model' with finite, falling train
    losses, the bytes each rank summed over 'model'; each rank's launches of
    the training kernels. 22j: the round with Newton-Schulz split over
    'data' bitwise the round with ``ns_axes=()``, each rank's kernels on
    half the stack rows."""
    one = trained.pop("one_tp")
    ranks = trained.pop("ranks")
    mesh = ranks[0]
    measured = [n for n in MESH_TP_MEASURE if n in mesh]
    runs = {}
    for name in ("22i_fp32", "22i_fault", "22i"):  # split over 'model' on every rank
        if name in mesh:
            assert all(per[name]["tp"] for per in ranks), (name, "did not split over 'model'")
    if "22i_whole" in mesh:
        assert not any(per["22i_whole"]["tp"] for per in ranks), "22i_whole split over 'model'"
    for name in ["22i_fp32"] + measured + ["22j_split", "22j_whole"]:
        kernels = MESH_TRAIN_KERNELS if name.startswith("22j") else MESH_TRAIN_KERNELS[:5]
        for r, per in enumerate(ranks):
            missing = [k for k in kernels if per[name]["launches"].get(k, 0) <= 0]
            assert not missing, (name, "rank", r, "launched none of", missing)

    def gaps(h: dict) -> tuple:  # (largest loss gap, (leaf, largest relative param gap))
        loss = max(abs(a[k] - b[k]) for a, b in zip(one["history"], h["history"])
                   for k in ("train_loss", "train_loss_last"))
        g = {p: ((one["params"][p].double() - t.double()).norm()
                 / one["params"][p].double().norm().clamp_min(1e-30)).item()
             for p, t in h["params"].items()}
        return loss, max(g.items(), key=lambda kv: kv[1])

    (loss_gap, worst), (fault_loss, fault_worst) = gaps(mesh["22i_fp32"]), gaps(
        mesh["22i_fault"])
    held = worst[1] <= MESH_TP_TOL["param"]
    caught = fault_worst[1] > MESH_TP_TOL["param"]
    twins = ["22i_fp32"] + [n for n in ("22i_whole",) if n in mesh]
    walls = {n: [round(h["wall_s"], 3) for h in mesh[n]["history"]] for n in twins}
    peaks = {n: [round(per[n]["peak_gb"], 2) for per in ranks] for n in twins}
    f = mesh["22i_fp32"]
    print(f"  [22i fp32] paper-416m at depth {MESH_TP_FP32['depth']} split over 'model' = 2 "
          f"against one process: losses {[round(h['train_loss'], 6) for h in f['history']]} / "
          f"{[round(h['train_loss'], 6) for h in one['history']]}; largest loss gap "
          f"{loss_gap:.3e} (not held), largest relative param gap {worst[1]:.3e} ({worst[0]}; "
          f"limit {MESH_TP_TOL['param']:.1e}): {'held' if held else 'MISSED'}; the planted "
          f"fault (QK-norm gradients of each rank's own heads): loss gap {fault_loss:.3e}, "
          f"relative param gap {fault_worst[1]:.3e} ({fault_worst[0]}): "
          f"{'caught' if caught else 'NOT CAUGHT'}; round walls {walls['22i_fp32']} s, the run "
          f"{f['seconds']:.1f} s; peak memory a rank {peaks['22i_fp32']} GB (one process "
          f"{one['peak_gb']:.2f} GB); card: {smi}")
    runs["22i_fp32"] = {"loss_gap": loss_gap, "param_gap": worst[1], "fault_loss_gap": fault_loss,
                        "fault_param_gap": fault_worst[1], "limits": MESH_TP_TOL,
                        "walls": walls["22i_fp32"], "peak_gb": peaks["22i_fp32"],
                        "one_peak_gb": one["peak_gb"],
                        "launches": [per["22i_fp32"]["launches"] for per in ranks]}
    if "22i_whole" in mesh:
        w = mesh["22i_whole"]
        print(f"  [22i fp32] its whole-worker twin (each rank both halves of every worker), "
              f"once the \"train\" launch had ended: round walls {walls['22i_whole']} s, the run "
              f"{w['seconds']:.1f} s; peak memory a rank {peaks['22i_whole']} GB; bytes rank 0 "
              f"received {w['received']} (the split's {f['received']}); card: {smi}")
        runs["22i_whole"] = {"walls": walls["22i_whole"], "peak_gb": peaks["22i_whole"],
                             "received": w["received"],
                             "launches": [per["22i_whole"]["launches"] for per in ranks]}
    B = int(MESH_TP_TRAIN[MESH_TP_TRAIN.index("--batch-per-worker") + 1])
    tokens = 2 * 2 * B * 2048  # K x H x B x S a round
    for name in [n for n in ("22i",) if n in mesh]:
        m = mesh[name]
        hist = m["history"]
        losses = [h["train_loss"] for h in hist]
        assert all(math.isfinite(x) for h in hist for x in (h["train_loss"], h["eval_loss"]))
        walls = [h["wall_s"] for h in hist]
        model_bytes = [per[name]["received"].get("model", 0) for per in ranks]
        print(f"  [{name}] paper-416m bf16 at full depth, split over 'model' = 2: train losses "
              f"{[round(x, 4) for x in losses]}, eval "
              f"{[round(h['eval_loss'], 4) for h in hist]}; round walls "
              f"{[round(w, 3) for w in walls]} s (two ranks on one card), "
              f"{tokens / walls[-1]:.1f} tok/s in the last; the run {m['seconds']:.1f} s; peak "
              f"memory a rank {[round(per[name]['peak_gb'], 2) for per in ranks]} GB; bytes summed "
              f"over 'model' a rank a round {[b // len(hist) for b in model_bytes]}; bytes rank 0 "
              f"received {m['received']}; launches rank 0 {m['launches']}, rank 1 "
              f"{ranks[1][name]['launches']}; card: {smi}")
        runs[name] = {"walls": walls, "losses": losses, "received": m["received"],
                      "peak_gb": [per[name]["peak_gb"] for per in ranks],
                      "model_bytes_a_round": [b // len(hist) for b in model_bytes],
                      "launches": [per[name]["launches"] for per in ranks]}
    a, b = mesh["22j_split"], mesh["22j_whole"]
    keys = ("train_loss", "train_loss_last", "eval_loss", "comm_bytes")
    apart = [k for h, g in zip(a["history"], b["history"]) for k in keys if h[k] != g[k]]
    apart += [p for p in a["digests"] if a["digests"][p] != b["digests"][p]]
    rows = {n: [sum(c["rows"] for c in per[n]["ns"]) for per in ranks]
            for n in ("22j_split", "22j_whole")}
    ns_ms = {n: [sum(c["ms"] for c in per[n]["ns"]) for per in ranks]
             for n in ("22j_split", "22j_whole")}
    print(f"  [22j] MESH_TRAIN on (data = 2), one round, Newton-Schulz split over 'data' "
          f"against ns_axes=(): losses, comm_bytes and all {len(a['digests'])} outer leaves "
          f"{'bitwise' if not apart else f'APART {apart[:3]}'}; stack rows each rank's kernels "
          f"ran on {rows['22j_split']} against {rows['22j_whole']}; matmul_epilogue launches "
          f"a rank {[per['22j_split']['launches'].get('matmul_epilogue', 0) for per in ranks]} "
          f"against {[per['22j_whole']['launches'].get('matmul_epilogue', 0) for per in ranks]}"
          f" (one launch a product covers the rank's share of a stack); Newton-Schulz calls' ms a "
          f"rank (the gather over 'data' included) {[round(x, 1) for x in ns_ms['22j_split']]} "
          f"against {[round(x, 1) for x in ns_ms['22j_whole']]}; round walls "
          f"{[round(h['wall_s'], 3) for h in a['history']]} / "
          f"{[round(h['wall_s'], 3) for h in b['history']]} s (contended); peak memory a rank "
          f"{[round(per['22j_split']['peak_gb'], 2) for per in ranks]} GB; card: {smi}")
    for n in ("22j_split", "22j_whole"):
        runs[n] = {"ns_rows": rows[n], "ns_ms": ns_ms[n],
                   "launches": [per[n]["launches"] for per in ranks]}
    # every reading is printed above before any check fails
    assert held and caught, (loss_gap, worst, fault_loss, fault_worst)
    if "22i" in runs:
        assert runs["22i"]["losses"][-1] < runs["22i"]["losses"][0], runs["22i"]["losses"]
    assert not apart, apart[:5]
    assert all(2 * x == y for x, y in zip(rows["22j_split"], rows["22j_whole"])), rows
    for f_ in MESH_DIR.glob("*/ckpt_*.npz"):
        f_.unlink()
    return {"runs": runs, "one_fp32_peak_gb": one["peak_gb"]}


def phase_mesh_serve(torch, get_config, serve, smi: str) -> dict:
    """[22d] ``MESH_SERVE`` on the (data=2) mesh against one process: the
    greedy tokens, exact or the count that differ."""
    print(f"[22d] serving on a (data=2) mesh of {MESH_RANKS} ranks, smollm-135m full width, "
          f"{MESH_SERVE}; card: {smi}")
    got = json.loads((MESH_DIR / "serve.json").read_text())  # 22b's ranks served it
    cfg = get_config("smollm-135m").replace(attn_impl="pallas")
    results, seconds, _, model, params = serve(cfg, device="cuda", **MESH_SERVE)
    differ = sum(int(a != b) for rid, toks in results.items()
                 for a, b in zip(toks.tolist(), got["tokens"][rid]))
    n = MESH_SERVE["batch"] * MESH_SERVE["max_new"]
    print(f"  greedy tokens: {n - differ} of {n} equal to one process's "
          f"({'exact' if not differ else f'{differ} differ'}); mesh {n / got['seconds']:.1f} "
          f"tok/s (eager spans, host-staged gathers) against {n / seconds:.1f} (captured); "
          f"launches rank 0 {got['launches']} (formula {got['formula']}); card: {smi}")
    assert got["launches"]["paged_decode"] == got["formula"]["paged_decode"] > 0
    assert got["launches"]["flash_fwd"] == got["formula"]["flash_fwd"] > 0
    assert differ == 0, differ
    del model, params
    torch.cuda.empty_cache()
    return {"launches": got["launches"], "tokens_equal": n}


def slice_12(torch, build_parser, train, get_config, serve, smi: str,
             tp_measure: bool = False) -> dict:
    """Phase 22: (a) the kernels were built in phase 2, in this process,
    before any rank starts (each rank loads them; the build's file lock
    would hold a second builder); (b) the kernels across ranks, whose
    processes then serve (d), beside (c, e-h) the mesh's training: checkpoints,
    streaming, elastic drops with a sync delay, the crash drill and the DP
    baseline; (i, j) tensor parallelism over 'model' and the Newton-Schulz
    split over 'data' (``tp_measure``: also 22i's whole-worker twin and
    bf16 run at full depth); (d) the mesh's serving against one process."""
    import gc

    MESH_DIR.mkdir(parents=True, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[22a] kernels built once in this process (phase 2) before any rank starts; "
          f"{resources()}")
    # 22b's world runs beside the training runs' first minute (~3 GB a rank)
    world = start_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-child", "kernels"],
                        "kernels")
    procs = list(world)  # every rank process of phase 22, stopped if a check fails
    try:
        trained = phase_mesh_train(torch, build_parser, train, smi, procs, world, tp_measure)
        kernels = phase_mesh_kernels(torch, smi, world)
        tensor_parallel = phase_mesh_tp(torch, trained, smi)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lap("22b-22c, 22e-22j")
    served = phase_mesh_serve(torch, get_config, serve, smi)
    lap("22d")
    return {"kernels": kernels, "train": trained, "tp": tensor_parallel, "serve": served}


def mesh_child(kind: str) -> int:
    import torch

    if kind.startswith("launch:"):  # launch:<label>:<run,run,...>
        _, label, names = kind.split(":")
        mesh_child_launch(torch, label, names)
        return 0
    {"kernels": mesh_child_kernels, "kill": mesh_child_kill,
     "resume": mesh_child_resume}[kind](torch)
    return 0


ALONE = ("12", "13", "14", "15", "16", "17", "18", "19", "21", "22")


def main(argv: list | None = None) -> int:
    """The whole script; ``--only 17,19`` runs phases 1 and 2, then only
    the named groups of phases (those of ``ALONE``), each even when an
    earlier one failed, then phase 20 on their reads, and exits 1 if any
    failed, printing no summary."""
    argv = sys.argv[1:] if argv is None else argv
    if "--mesh-child" in argv:  # one rank of phase 22, started by this script
        return mesh_child(argv[argv.index("--mesh-child") + 1])
    only = argv[argv.index("--only") + 1].split(",") if "--only" in argv else None
    if only is not None and not set(only) <= set(ALONE):
        raise SystemExit(f"chip_smoke: --only takes groups of {ALONE}, not {only}")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; the port's "
                         "kernels run on the card only")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import outer_update as ou
    from repro_torch.kernels import quantize as q
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import build_parser, train
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map

    print("[1] device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {smi}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("fp32 matmul: allow_tf32=False (full fp32); bf16 GEMM "
          "allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    mods = dict(fa=fa, mm=mm, ops=ops, ref=ref, ou=ou, q=q)
    ptxas = phase_build(_build)
    if only is None or "21" in only:  # 21a's builds, behind the rest of the script
        mods["autotune_build"] = start_autotune_build(_build)
    lap("2")

    def run_variants(ref6b: tuple | None = None) -> dict:
        if ref6b is None:  # alone: 6b's run is the reference
            _, out = phase_train_main(torch, build_parser, train)
            ref6b = (out["history"], tree_map(lambda t: t.to("cpu", copy=True), out["state"]),
                     out["tok_s"])
            del out
            torch.cuda.empty_cache()
        return slice_variants(torch, build_parser, train, *ref6b, smi)

    def pseudogradients() -> dict:
        probe = phase_pseudogradients(torch, get_config, build_model, smi)
        lap("15a-15b")
        phase_scaling_laws()
        return probe

    group = {
        "12": lambda: slice_6a(torch, mods, get_config, build_model, build_parser, train, serve,
                               smi),
        "13": lambda: slice_nemotron(torch, fa, get_config, build_model, serve, smi),
        "14": run_variants,
        "15": pseudogradients,
        "16": lambda: slice_moe(torch, mods, get_config, build_model, serve, smi),
        "17": lambda: slice_7a(torch, mods, get_config, build_model, build_parser, train, serve,
                               ptxas, smi),
        "18": lambda: slice_8(torch, mods, get_config, build_model, serve, ptxas, smi),
        "19": lambda: slice_9(torch, fa, get_config, build_model, serve, ptxas, smi),
        "21": lambda: phase_autotune(torch, mods, build_parser, train, smi),
        # alone (--only 22), phase 22 also measures 22i's whole-worker twin and
        # bf16 run at full depth, for which the whole script has no room
        "22": lambda: slice_12(torch, build_parser, train, get_config, serve, smi,
                               tp_measure=only is not None),
    }
    if only is not None:
        import gc
        import traceback

        failed, reads = [], []
        for name in only:
            try:
                reads += group[name]().get("reads", [])
            except Exception:  # report every group, then fail
                traceback.print_exc()
                failed.append(name)
            lap(f"phases {name}")
            gc.collect()
            torch.cuda.empty_cache()
        try:  # the roofline of the groups that ran
            phase_roofline(reads, smi)
        except Exception:
            traceback.print_exc()
            failed.append("20")
        lap("20")
        print(f"chip_smoke --only {','.join(only)}: "
              + (f"FAILED {failed}" if failed else "every phase passed"))
        return 1 if failed else 0

    flash = phase_flash(torch, fa)
    lap("3a")
    paged = phase_paged(torch, fa)
    lap("3b")
    phase_agreement(torch, get_config, build_model)
    lap("4a")
    launches, engine = phase_main(torch, fa, get_config, serve)
    phase_sampled(torch, engine)
    lap("4b")
    serve_prof = phase_profile(torch, engine, paged["ms"])
    serve_rates = (engine.tok_s, engine.replay_tok_s, engine.eager_tok_s, engine.capture_s)
    del engine
    torch.cuda.empty_cache()
    lap("4c")
    naive_rate = phase_naive(torch, fa, get_config, build_model, serve, serve_rates[0])
    print(f"smollm-135m serving: paged, captured spans {serve_rates[0]:.1f} tok/s (capture "
          f"{serve_rates[3]:.3f} s apart), replays only {serve_rates[1]:.1f}, eager spans "
          f"{serve_rates[2]:.1f}; idle {serve_prof['idle']:.1f}%, "
          f"{serve_prof['kernels_per_step']:.0f} kernels a decode step; naive "
          f"{naive_rate:.1f} tok/s; card (nvidia-smi name, power.limit): {smi}")
    lap("4d")

    bwd = phase_flash_bwd(torch, fa)
    lap("5a")
    matmul, matmul_full, matmul_bx = phase_matmul(torch, mm, ops, ref)
    nesterov = phase_nesterov(torch, ou)
    lap("5b-5c")
    phase_train_agreement(torch, get_config, build_model)
    lap("6a")
    train_launches, out = phase_train_main(torch, build_parser, train, keep=True)
    reads = [serve_prof["read"], out["read"]]
    ref_hist = out["history"]
    ref_state = tree_map(lambda t: t.detach().clone(), out["state"])
    muon_tok_s = out["tok_s"]
    lap("6b")
    phase_train_profile(torch, out, TRAIN, focus=("flash_fwd_wgmma_kernel",
                                                  "flash_dq_wgmma_kernel", "flash_dkv_wgmma_kernel",
                                                  "matmul_epilogue_kernel"),
                        beside={"flash_fwd_wgmma_kernel": ("3a", flash["training"]["ms"]),
                                "flash_dq_wgmma_kernel": ("5a", bwd["flash_dq"]["ms"]),
                                "flash_dkv_wgmma_kernel": ("5a", bwd["flash_dkv"]["ms"]),
                                "matmul_epilogue_kernel": ("5b (X X^T on w_in, symmetric)",
                                                           matmul["ms"])})
    params = out["state"]["outer_params"]
    del out
    torch.cuda.empty_cache()
    lap("6c")
    phase_train_equal(torch, build_parser, train, ref_hist, ref_state)
    lap("6d")
    ref_host = tree_map(lambda t: t.to("cpu", copy=True), ref_state)  # phases 14a and 21e
    del ref_state
    torch.cuda.empty_cache()

    quant = phase_quantize(torch, q, params)
    del params
    phase_wire_agreement(torch, get_config, build_model)
    lap("8a-8b")
    run_a = phase_compressed_run(torch, build_parser, train, "a", COMPRESSED, 3,
                                 COMM_BYTES["a"], falls=True, profile="8c'")
    lap("8c")
    run_b = phase_compressed_run(torch, build_parser, train, "b", COMPRESSED + ROWWISE, 2,
                                 COMM_BYTES["b"], falls=False)
    lap("8d")
    phase_crash_drill(torch, build_parser, train)
    lap("8e")
    slice_4b(torch, get_config, build_model, build_parser, train, ref_hist, smi)
    ladder = group["12"]()
    nemotron = group["13"]()
    variants = run_variants((ref_hist, ref_host, muon_tok_s))
    probe = group["15"]()
    lap("15c")
    moe = group["16"]()
    ssm = group["17"]()
    eight = group["18"]()
    nine = group["19"]()
    for g in (ladder, nemotron, moe, ssm, eight, nine):
        reads += g.pop("reads")
    phase_roofline(reads, smi)
    lap("20")
    autotune = phase_autotune(torch, mods, build_parser, train, smi, refs={
        "6b": (ref_hist, ref_host, train_launches.variants),
        "12d": ladder.pop("autotune_ref")})
    del ref_host
    lap("21")
    mesh = group["22"]()
    lap("22")

    def new_paths(name: str) -> dict:
        """A kernel's launches on slice 6b's paths (14b, 15, 16), and its
        launches and timings on slice 7a's (17), slice 8's (18) and slice
        9's (19)."""
        rows = {inner: {"launches": v["launches"][name]} for inner, v in variants.items()
                if name != "paged_decode"}
        if name in probe["launches"]:
            rows[f"{PROBE['arch']} pseudogradients"] = {"launches": probe["launches"][name]}
        rows[MOE] = moe[name]
        rows.update(ssm.get(name, {}))
        rows.update(eight.get(name, {}))
        rows.update(nine.get(name, {}))
        return rows

    src = "src/repro_torch/kernels/csrc"
    jax_src = "src/repro/kernels"
    summary = {"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": f"{src}/flash_fwd.cu",
         "replaces": f"{jax_src}/flash_attention.py:184",
         "launches": launches["flash_fwd"], **flash["serving"], LADDER: ladder["flash_fwd"],
         NEMOTRON: nemotron["flash_fwd"], **new_paths("flash_fwd")},
        {"name": "paged_decode", "route": "cuda", "source": f"{src}/paged_decode.cu",
         "replaces": f"{jax_src}/flash_attention.py:439",
         "launches": launches["paged_decode"], **paged, LADDER: ladder["paged_decode"],
         NEMOTRON: nemotron["paged_decode"], **new_paths("paged_decode")},
        {"name": "flash_dq", "route": "cuda", "source": f"{src}/flash_bwd.cu",
         "replaces": f"{jax_src}/flash_attention.py:230",
         "launches": train_launches["flash_dq"], **bwd["flash_dq"], LADDER: ladder["flash_dq"],
         **new_paths("flash_dq")},
        {"name": "flash_dkv", "route": "cuda", "source": f"{src}/flash_bwd.cu",
         "replaces": f"{jax_src}/flash_attention.py:254",
         "launches": train_launches["flash_dkv"], **bwd["flash_dkv"],
         LADDER: ladder["flash_dkv"], **new_paths("flash_dkv")},
        {"name": "matmul_epilogue", "route": "cuda", "source": f"{src}/matmul_epilogue.cu",
         "replaces": f"{jax_src}/matmul.py:47",
         "launches": train_launches["matmul_epilogue"], **matmul,
         LADDER: ladder["matmul_epilogue"], **new_paths("matmul_epilogue")},
        {"name": "nesterov", "route": "cuda", "source": f"{src}/outer_update.cu",
         "replaces": f"{jax_src}/outer_update.py:58",
         "launches": train_launches["nesterov"], **nesterov, LADDER: ladder["nesterov"],
         **new_paths("nesterov")},
        {"name": "quantize", "route": "cuda", "source": f"{src}/quantize.cu",
         "replaces": f"{jax_src}/quantize.py:40",
         "launches": run_a["quantize"], **quant["quantize"]},
        {"name": "dequantize", "route": "cuda", "source": f"{src}/quantize.cu",
         "replaces": f"{jax_src}/quantize.py:87",
         "launches": run_a["dequantize"], **quant["dequantize"]},
    ]}
    # the build variant each main path launched (6b: training; 4b: serving; 8c: run (a))
    main_variants = {"flash_fwd": launches.variants, "paged_decode": launches.variants,
                     "quantize": run_a.variants, "dequantize": run_a.variants}
    for row in summary["kernels"]:
        name = row["name"]
        row["variants"] = {k: n for k, n in main_variants.get(name, train_launches.variants)
                           .items() if _build.split_key(k)[0] == name}
        if LADDER in row:  # 12d's training run
            row[LADDER]["variants"] = {k: n for k, n in ladder["variants"].items()
                                       if _build.split_key(k)[0] == name}
        if name in autotune["times"]:
            row["tuned"] = autotune["times"][name]
        # 22b: across two ranks of a mesh on the card (the kernel on each
        # rank's block, bitwise the whole call); 22c / 22d: the mesh's paths
        row["across_ranks"] = {
            **mesh["kernels"][name],
            "mesh_train_launches": mesh["train"]["launches"].get(name, 0),
            "mesh_serve_launches": mesh["serve"]["launches"].get(name, 0),
            # 22c, 22e-22j: each run's launches on each rank
            "mesh_runs_launches": {run: [per.get(name, 0) for per in v["launches"]]
                                   for run, v in {**mesh["train"]["runs"],
                                                  **mesh["tp"]["runs"]}.items()}}
    t = flash["training"]
    print(f"training main path launches of flash_fwd: {train_launches['flash_fwd']} "
          "(the flash_fwd row counts the serving main path's and times its shape); at the "
          f"training shape: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa "
          f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    print(f"matmul_epilogue: the row times X X^T on w_in with symmetric=True (bound by its "
          f"distinct entries); symmetric=False {matmul_full['ms']:.4f} ms; B X + a X [30, 576, "
          f"576] x [30, 576, 1536]: kernel {matmul_bx['ms']:.4f} ms, plain "
          f"{matmul_bx['plain_ms']:.4f} ms, baddbmm {matmul_bx['library_ms']:.4f} ms, bound "
          f"{matmul_bx['bound_ms']:.4f} ms ({matmul_bx['bound_by']})")
    print(f"compressed runs' launches of quantize / dequantize: run (a) {run_a['quantize']} / "
          f"{run_a['dequantize']} (the rows count run (a)'s), run (b) {run_b['quantize']} / "
          f"{run_b['dequantize']}")
    print(f"tuned variants launched (autotune on, the default): 6b {autotune['runs']['6b']['tuned']}"
          f", 12d {autotune['runs']['12d']['tuned']}; committed cuda entries not the default: "
          f"{autotune['tuned_keys']}")
    print(f"[23] done in {time.perf_counter() - _T0:.1f} s")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        for thread in BACKGROUND:
            thread.join()
    sys.exit(code)
