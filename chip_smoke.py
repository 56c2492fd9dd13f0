#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if anything is off:

1. Prints the card's name and power limit (nvidia-smi), checks compute
   capability 9.0 and builds the CUDA kernels from kernels/csrc/ with nvcc,
   printing each kernel's registers and spills (ptxas -v); the 8
   instances of the fused LoRA kernel, the dense dW kernel, the 4 head-dim
   instances (DT 32, 64, 128, 256) of each flash kernel (forward, dq,
   dk/dv; their registers and spills printed by instance), the 6 of the
   WKV backward, the 2 of the radix top-k, the panel gradient and the 4
   of the one-pass roundtrip must not spill.  While nvcc builds, a thread
   imports torch._dynamo, which torch.utils.checkpoint (phase 18's remat)
   imports at its first call.
2. Holds every ported kernel against its plain PyTorch version on the card
   at the main path's shapes, at ragged shapes and (KD loss, top-k) at a
   generative vocabulary (1280 x 50257), and times the kernel, the plain
   version and one PyTorch library call for the same function (used
   nowhere in the port); the small kernels (and the LoRA panel gradient)
   and their library calls also inside a CUDA graph, and the clip
   kernels also with the L2 flushed before each call.  Tolerances: LoRA
   and attention atol 1e-4 / rtol 1e-4 (fp32 sums over K = 768 in
   another order); KD loss atol 1e-5 /
   rtol 1e-4 (the reference's bar for its kernel); top-k quantization bit
   for bit, its long-row (radix) path also at the generative shape with
   integer values (ties at the threshold) and +0.0 / -0.0 entries, at a
   row too long to stage in shared memory and at k 512 with -inf and
   -1e30 entries; the DP clip kernels atol 1e-6 / rtol 1e-5 (the reference's bar
   for its clip kernel), at the main path's (16, 442368) and at eight
   other shapes: every row clipped, a ragged width, none clipped, half
   clipped, and a row of zeros; one row at the main width, P 3 (fewer
   elements than a cluster's threads), a ragged width over many loads a
   thread, and the main shape with a zero row from a misaligned base;
   the norm kernel's error against an fp64 sqrt(sum(g·g)) within
   FP64_FACTOR times the larger of its fp32 twin's and vector_norm's, and
   its bits the same on two eager calls and two replays of one CUDA
   graph; the clip-accumulate kernel with a client axis (row 14ᶜ) at the
   spmd DP step's (3, 16, 442368) and at four edges (one client, a
   ragged width, a zero row, a misaligned base), each client bit for bit
   one dp_clip_acc launch on its rows, timed beside torch.bmm, and the
   norm kernel and row 4ᵉ's pair at the step's 48 stacked examples;
   the per-row quantizers (int8 and int4
   levels, the int4 pack, and the one-pass roundtrip's dequantized
   values, compared as integers so that the sign of a zero counts) bit
   for bit at the Split boundary's (1280, 768) and at ragged widths (warp
   and block variants, float4 and scalar loads, a misaligned row start,
   a row longer than the roundtrip's registers hold), each with a row of
   zeros and rows of exact half levels, the roundtrip also with +-0 and
   levels that round to -0 and at (1280, 2560) and (1280, 2048), timed
   beside the old way (quantize_rows, q.float(), * scale); the RG-LRU
   scan kernels bit for bit (their
   twins round the same multiply and add) at the train step's (16, 80,
   2560), timed eager, in a graph and with a cold L2, and at the eval
   batch's (64, 80, 2560), a ragged width (2561, scalar loads), one step,
   with an initial state and a gradient of the final state, and with
   misaligned rows; and the LoRA and flash kernels at RecurrentGemma-2B's
   shapes (K = N = 2560; 10 query heads of 256 over one kv head, window
   2048, timed; a window shorter than S and a head dim of 200 checked);
   the LoRA kernels at RWKV-6 1.6B's K = N = 2048 and the fused forward
   and dx at their edges (x and g misaligned for 16-byte copies, a DP
   batch-1 pass's M 80, ranks 64, 1 and 13, K and N that no tile or 8
   divides) and the panel gradient at its edges (M 80 and 1, ranks 1, 13
   and 64, L 770, lhs misaligned, RecurrentGemma-2B's (1280, 2560) and
   (1280, 256)), both layouts out, with a client axis (rows 1ᶜ, 2ᶜ and
   4ᶜ, the spmd backend's stacked clients: GPT-2's (3, 1280, 768, 768),
   RecurrentGemma-2B's and RWKV-6's widths and 8 clients timed eager and
   in a graph beside their twins, the library chain and the old way, C
   launches of rows 1, 2 and 4; C 1, M_c 1279, ranks 1, 13 and 64, a
   ragged (2050, 261) and a misaligned x checked; at every shape each
   client's outputs bit for bit those of the one-client kernel on its
   rows; the flash and KD kernels once at the stacked batch), and with
   an example axis (the DP
   step's per-example dA and dB: GPT-2's (16, 80, 768), RecurrentGemma-2B's
   (16, 80, 2560) and (16, 80, 256), RWKV-6's (16, 80, 2048), a ragged
   (3, 37, 770) at rank 13, S 1 at rank 64 and a misaligned lhs; its
   bits the same on two eager calls and two graph replays, its rms error
   against fp64 within FP64_FACTOR times torch.bmm's, timed beside
   torch.bmm and the old way, B launches of the panel kernel at M 80);
   its pair (a LoRA site's dA and dB in one launch) at each site's (16,
   80, K | N), GPT-2's (768 | 768), RecurrentGemma-2B's (2560 | 2560) and
   (2560 | 256), RWKV-6's (2048 | 2048), and ragged, S 1 and misaligned:
   the bits of the two single launches it replaces, the same over calls
   and graph replays, its rms error against fp64 within PAIR_FP64_FACTOR
   times two torch.bmm calls', timed beside them and the two single
   launches; the launch floor (an empty kernel eager, in a CUDA graph and
   as a bare graph launch);
   the dense dW kernel
   (x (M, K), g (M, N) scaled by M^-0.5) at each of those shapes, at a
   ragged (1279, 770, 97) and at RecurrentGemma-2B's (1280, 2560, 256);
   the LoRA forward, dx and dW kernels' and the panel gradient's (dA =
   xᵀ·gb, dB = xaᵀ·g) rms error against fp64 products at K = N = 768
   and 2560 within FP64_FACTOR times the default BLAS library's for the
   same products; the flash kernels' rms error against an fp64 run of
   their twins (o, lse, dq, dk, dv at GPT-2's and RecurrentGemma-2B's
   shapes) within FP64_FACTOR times the larger of the fp32 twins' and
   SDPA's; flash_dkv's head chunks at G 3 and 5 (chunks of unequal
   size); the flash kernels at G 10, D 256 with a window shorter than S,
   ragged S and a q_offset, and at G 6, D 128 (Qwen2's 12 heads over 2)
   with ragged S and a q_offset; at phase 14's shapes
   (family_kernel_checks) the flash kernels' DT 128 instances at
   Qwen3-1.7B's (BH 256 over 128, S 80, D 128) and Mixtral-8x7B's (512
   over 128, window 4096) train steps, held to their twins, their fp64
   error gated as above and timed beside SDPA, and the LoRA kernels at
   their wq (1280, d, d) and wk/wv (1280, d, 1024), d 2048 and 4096,
   timed beside the matmul chain; and the RWKV-6 WKV
   kernels at the train step's (512, 80, 64) with checkpoints (timed
   eager, in a graph and with a cold L2), at the eval batch's (2048, 80,
   64) without, at a ragged S, one step, head dims 16 and 32, log-decays
   near 0 and down to -e³, with dS_final and du: y and the gradients
   within atol 1e-5 / rtol 1e-4, S_final and every checkpoint bit for
   bit, and at the train shape each output's error against an fp64 run
   of the plain version within twice the fp32 plain version's and the
   backward's bits the same on two eager calls and two replays of one
   CUDA graph.  The
   3xTF32 kernels' (LoRA forward, dx and dW, the three flash kernels)
   operation bound is taken at a third of the card's TF32 rate, and
   their fp32-rate bound printed beside it (kernel_bound).

From phase 3 on a daemon thread draws the seed-0 weights of the
full-width phases 7, 8 and 14-16 on the host, in their order and at
most DRAWS_AHEAD trees ahead (prefetch_draws; family_init uploads them),
so those phases wait only for what is left of a draw: the same trees,
bit for bit, as a draw straight to the card.

The full-width phases judge the kernels by their error, measured from an
fp64 run of the plain path (each_run's "exact": policy ``torch``, the
weights and the initial LoRA cast to float64).  A gate "from fp64" holds
the kernel run's relative L2 distance from the fp64 run's result within
FLOOR_FACTOR times the larger of the two fp32 plain runs' distances
(default BLAS library and the other one; the final LoRA of phases 6
(fp32) and 7 also NUDGED_SEEDS fp32 plain runs from weights nudged one
ulp, each measured from an fp64 run of its own nudged weights) plus
FLOOR_SLACK, and requires the TF32 control (a run of lower precision)
outside that limit.  fp32_gates holds that arithmetic.

3. Runs the paper's SSV case study through ``run_federated`` at the full
   width of GPT-2 (12 layers, d 768, V 50257; random weights from seed 0),
   2 FedLLM rounds over 3 clients, five times from the same weights: with
   kernel policy ``cuda`` (the kernels), and with ``torch`` (plain PyTorch
   on the card) under the default BLAS library, under the other one,
   under TF32 and from the fp64 weights.  First the LoRA gradient of the
   first train step (client 0's first batch) is gated from fp64.  The
   kernel and default plain runs must agree: identical ledger bytes and
   client FLOPs and per-round loss within 1e-3.  The final LoRA trees are
   gated from fp64.  Every kernel's launch counter must equal the count
   the model's shapes predict in the kernel run and be 0 in the plain
   runs.
4. KD-FedLLM (logit distillation over 150 public rows, top-k 8 with int8
   on the wire), 2 rounds, four runs; the KD-loss and top-k kernels are
   counted beside the LoRA and attention ones.  The int8 upload is
   discontinuous as phase 6's boundary is: where two fp32 runs differ in
   the last bits, an uploaded level can move by one, and after that the
   runs part.  So the kernels' precision is gated on client 0's first
   upload, recomputed under each setting from the run's initial LoRA:
   its public-set logits before quantization are gated from fp64; the
   share of uploaded (index, level) pairs that differ from the plain
   run's is printed beside the floor's.  The runs, with NUDGED_SEEDS
   more fp32 plain runs from nudged weights, are then held to
   run_case's gates for a "spread" path (ledger, FLOPs and launches
   exact, the round loss within 1e-3 plus FLOOR_FACTOR times the largest
   fp32 run's difference from the plain run, the final server LoRA within
   SPREAD_FACTOR times the largest fp32 run's distance from the plain run
   plus FLOOR_SLACK, the TF32 control's outside).
5. The same five runs and checks for DP-FedLLM: phase 3's case study with
   DP-SGD clipping at C, noise 0 and secure aggregation, C being the
   median per-example gradient norm of the first batch (computed on the
   card before the runs), so that about half the examples clip.  Every
   local step runs one forward and one backward of its 16 examples
   through the LoRA and attention kernels, whose backward gives each
   example's LoRA gradients through the per-example panel kernel
   (lora_panel_examples_pair, a site's dA and dB in one launch: 3 a
   layer, the summed panel kernel none), then the two clip kernels; its
   first-step gates are on the
   first batch's (16, P) per-example gradient rows and on their clipped
   mean.  The kernel run's norms must show clipping in some but not all
   rows, the ledger must hold the LoRA payloads plus the
   secure-aggregation key exchange and the DP metadata as reckoned by
   hand, and epsilon must be inf (noise 0).  It then times one DP
   step's per-example gradients both ways, one batched pass and 16
   batch-1 passes, through the kernels and plain.
6. Split-FedLLM (client layers 0-1, server layers 2-11 with the head),
   2 rounds, as two sets of runs; every step runs the LoRA and attention
   kernels of all 12 layers.  With an fp32 boundary (bits 0) the path is
   continuous and phase 3's checks hold, the first step's LoRA gradient
   of both halves through the split program and the final joined LoRA
   gated from fp64, the latter with NUDGED_SEEDS nudged fp32 runs (each
   beside an fp64 run of its own weights) in its yardstick as phase 7's:
   Adam's update of a coordinate whose gradient lies near its 1e-8
   epsilon follows the sign that fp32 noise gives it, so some fp32 runs
   part from fp64 by ~1e-4 and others stay within ~1e-5.  This set gates the kernels' precision over
   the whole Split path (both halves forward and backward,
   evaluation).  With an int8 boundary (four runs) every step adds two
   launches of the one-pass roundtrip (quant_roundtrip_rows: c2
   activations up, c4 gradients down) and
   the ledger must equal the hand reckoning (6,518,976 bytes per client
   per round).  This boundary is discontinuous: where two fp32 runs
   differ in the last bits, a value near a half level rounds to the
   neighbouring level (a level flip), and after one flip the runs' losses
   and final LoRA drift apart.  So the set adds NUDGED_SEEDS fp32 plain
   runs from nudged weights and takes phase 4's "spread" gates: the round
   loss within 1e-3 plus FLOOR_FACTOR times the largest fp32 run's
   difference, the final joined LoRA within SPREAD_FACTOR times the
   largest fp32 run's distance from the plain run, TF32 outside; and the
   share of boundary levels at round 0, step 0 that differ from the plain
   run's (c2 and c4) must be within FLOOR_FACTOR times the largest share
   of the fp32 runs (floor and nudged) plus FLOOR_SLACK for the kernel
   run and outside it for the TF32 run.
7. FedLLM on RecurrentGemma-2B at full width and depth (26 layers in the
   pattern (rglru, rglru, local_attn), d 2560, V 256000, 2.66e9
   parameters; random weights from seed 0), phase 3's data, rounds, rank
   and checks, five runs and NUDGED_SEEDS fp32 plain runs from nudged
   weights, each beside an fp64 run of the same nudged weights, which
   join the yardstick of the final LoRA (an fp64 copy of the weights,
   21.3 GB beside the fp32 10.6 GB, lives for its run only; each run
   prints its peak device memory, the nudged and fp64 runs' largest
   after them).  LoRA sits on wq/wk/wv of the 8 local-attention
   layers; every batch runs the RG-LRU scan kernel in the 18 recurrent
   layers, every train step its backward in the 16 that follow the first
   LoRA layer (autograd does not reach layers 0-1).  Then one DP-SGD step
   from the same weights (clip at the median per-example norm of the
   first batch, noise 0): its (16, P) per-example rows and their clipped
   mean gated from fp64 as phase 5's, the pair launched 24 times (8
   layers x wq/wk/wv; at wk/wv dB is 256 wide).  Then Split-FedLLM from
   the same weights with an int8 boundary at split_layer 2 (the client
   holds pattern groups 0-1, layers 0-5 with two local-attention layers;
   the server 18 layers and the 2-layer tail, the final RMSNorm and the
   tied head): the first step's flipped-level share and run_case's
   spread gates, as phase 6's int8 set, the ledger against a hand count
   (c2 1280 x 2560 levels, 1280 scales, 16 labels; c4 the same without
   the labels; the client half's wq/wk/wv of two layers down and up each
   round), 36 roundtrips among the exact launches.

8. RWKV-6 Finch 1.6B at full width and depth (24 rwkv6 layers, d 2048,
   32 heads of 64, d_ff 7168, V 65536, 1.58e9 parameters; random
   weights from seed 0), LoRA on w_r/w_k/w_v/w_g, phase 3's data, rounds
   and rank.  Its FedLLM set runs at full width and RWKV6_FEDLLM_LAYERS
   (6) of the 24 layers, the first 6 of the seed-0 draw (the plain WKV
   twin takes 16-19 s a round at 24); every batch runs the WKV forward
   kernel in all its layers, every train step its backward in all of
   them (layer 0's r, k and v carry LoRA).  Each run prints its peak device memory.
   This path is chaotic at full width: Adam's first update moves every
   LoRA B coordinate by lr times its gradient's sign, so coordinates whose
   gradient sits at the fp32 noise floor step apart and the runs part; a
   round's loss then differs between fp32 plain runs by 1e-2 to 1.4e-1,
   as far as the TF32 control's.  So the kernels' precision is gated on
   the first step: the LoRA gradient of client 0's first batch, gated
   from fp64.  The runs (four, and NUDGED_SEEDS more fp32 plain runs from
   nudged weights, each weight one ulp up or down) are then held to
   run_case's gates for a "spread" path: ledger, FLOPs and launches
   exact; each round's loss within 1e-3 plus FLOOR_FACTOR times the
   largest fp32 run's difference; the final LoRA, which sums every step's
   flips, within SPREAD_FACTOR times the largest fp32 run's distance plus
   FLOOR_SLACK, and the TF32 control's outside.  Then KD (top-k 8 int8;
   client 0's first upload from fp64, one kernel run) and one DP step;
   then Split-FedLLM at split_layer 2 (the client holds layers 0-1),
   judged at the first step only: with an fp32 boundary the LoRA gradient
   of both halves from fp64, with an int8 boundary the flipped-level
   share, then one 2-round int8 run through the kernels alone, its
   ledger (the client half: 2 layers x 4 targets at 2048, fp32) and
   launches (36 roundtrips) exact.

9. The gradient of the classification loss with respect to the bound
   base weights: GPT-2 at full width (seed-0 weights), client 0's first
   batch of phase 3 and the run's initial LoRA (rank 8 on wq/wk/wv), with
   every targeted base W and the LoRA factors requiring a gradient, one
   forward and backward under each of the five settings.  The dW tree
   and the LoRA gradient are each gated from fp64; the kernel run
   launches the dense dW kernel exactly 36 times (12 layers x 3
   projections) beside one train step's LoRA and flash launches, the
   plain runs nothing.  The dense dW kernel launches on no other path.

10. The spmd backend (``FedConfig(backend="spmd")``: the 3 clients
   stacked on a leading axis, each LoRA projection one client-axis pass)
   at full gpt2 width from phase 3's weights and data, through the
   kernels and plain.  FedLLM: each client's LoRA gradient of the first
   stacked step through the kernels gated from fp64 as phase 3 gates
   client 0's (first_step_grads of that client), and the final LoRA of
   the kernel run from phase 3's fp64 run within phase 3's limit, its
   round losses within phase 3's of its plain run.  KD (top-k 8, int8):
   phase 4's spread gates against phase 4's runs.  Split (int8): the
   final LoRA, round losses and launch counts bit for bit those of phase
   6's sequential runs (the server half threads client after client
   through the same split steps).  Every run's ledger and client FLOPs
   equal the sequential kernel run's; the kernel runs' launch counts are
   those the stacked shapes predict (model_launches with ``clients``:
   per stacked train step 36 lora_fwd_clients, 36 lora_dx_clients and 72
   lora_panel_clients; the single model's forwards and backwards keep
   rows 1, 2 and 4), the plain runs' none.  Round times of both
   backends and both policies are printed.  FedLLM async at
   max_staleness 0 under spmd gives the sync spmd kernel run to the last
   bit.  DP-FedLLM under spmd (run_spmd_dp: phase 5's clip, noise 0,
   secure aggregation): each client's (16, P) per-example rows and
   clipped mean of the first stacked step gated from fp64 as phase 5
   gates client 0's, row 14ᶜ's mean held bit for bit to one dp_clip_acc
   launch a client; one kernel run whose ledger, client FLOPs and
   epsilon are phase 5's sequential kernel run's, whose final LoRA lies
   within phase 5's limit of phase 5's fp64 run, and whose stacked step
   launches 36 lora_panel_examples_pair over the 48 stacked examples,
   one dp_clip_norms and one dp_clip_acc_clients.  After phase 11, whose
   runs are their yardsticks (run_spmd_hetero): client ranks (2, 4, 8)
   under spmd, zeropad and svd, and async with max_staleness 2 over 4
   rounds, each within phase 11's limits of phase 11's runs, ledgers and
   launches exact.

11. Heterogeneous client ranks and async aggregation (run_hetero):
   FedLLM at full gpt2 width from phase 3's weights and data with
   client_ranks (2, 4, 8): the first step of the rank-2 and rank-4
   clients gated from fp64; run_case's continuous gates under hetero_agg
   "zeropad" and "svd" (the latter's final LoRA compared through its
   deltas alpha / r * A @ B, the SVD's signs being the library's), and
   under async aggregation with max_staleness 2 over 4 rounds, the
   ledger reckoned by hand from the participation schedule; every
   launch count exact.  Async with max_staleness 0 must give phase 3's
   sync kernel run to the last bit.

12. The cohort backend (run_cohort): FedLLM, KD and Split at full gpt2
   width from phase 3's weights over a lazy DirichletPopulation of 12
   clients drawn from phase 3's training rows (16 rows each, alpha 0.5,
   seed 0), streamed in chunks of 4 (one stacked spmd program and one
   secure-aggregation cohort a chunk) through 2 edge aggregators.
   FedLLM with secure aggregation takes run_case's continuous gates
   (kernels, two fp32 plain runs, TF32, fp64); its ledger by name and by
   hop is reckoned by hand (the client->edge hop equal to the same run's
   total at n_edges 0, two edges' fused payload up and down a round),
   client FLOPs by hand, launches exact, and its peak device memory
   must lie below the same run's with the whole fleet in one chunk.  KD
   (top-k 8, int8) and Split (int8 boundary): one kernel run each
   against a kernel run with cohort_size 0, within the spread limits of
   phases 4 and 6, ledgers and launches exact.

13. Fault tolerance (run_faults) at full gpt2 width from phase 3's
   weights and data: FedLLM with trimmed_mean, the norm screen, dropout
   and a NaN client under secure aggregation takes run_case's
   continuous gates, every run's quarantine and retransmit events and
   rollovers those reckoned from the FaultPlan by hand
   (fault_reckoning); KD (top-k 8 int8, a NaN client, a median
   teacher) quarantines the same uploads as its plain run, within
   phase 4's spread limits; FedLLM under quorum 1.0 with dropout 0.5
   rolls over as reckoned; and kill-and-resume through the kernels
   (FedLLM async with secure aggregation, KD, Split int8, FedLLM under
   cohort with faults, trimmed_mean and a quorum, whose streamed
   quarantines and rollover are the reckoned ones) ends bit for bit as
   each uninterrupted run, the two legs' launches its launches.

Phase 2 also holds the quantizers (rows 10, 11, 12) to their twins on
rows holding a NaN, all NaN, +inf, -inf, all -inf and all three
(nonfinite_checks): the scale NaN as NaN, non-finite where the twin's
dequantized row is, the top-k's indices, the finite rows bit for bit.

14. The registry's decoder-only families at full width (run_families):
   Qwen3-1.7B at full depth (28 layers, d 2048, 16 query heads of 128
   over 8 kv heads with qk-norm, SwiGLU d_ff 6144, V 151936 tied, 1.72e9
   parameters; seed-0 weights), FedLLM on phase 3's data, its first
   step's LoRA gradient and run_case's five runs gated from fp64, ledger
   by hand, launches exact; then Mixtral-8x7B at MIXTRAL_LAYERS (2) of
   its 32 layers (32 hold ~187 GB of fp32 weights; d 4096, 32 heads of
   128 over 8, window 4096, 8 experts of d_ff 14336, top 2, capacity
   factor 1.25, batched dispatch, V 32000 untied, 3.2e9 parameters):
   the first step's routes (each token's top-2 experts at both layers)
   of every run against the fp64 run's; with none changed in the kernel
   run its LoRA gradient and the five runs are gated from fp64, else the
   route flips are gated as a quantized wire's levels (fp32_gates'
   flips, NUDGED_SEEDS nudged runs among the yardsticks) and the runs
   take the spread gates; then one DP-SGD step (dp_first_step), its rows
   and clipped mean from fp64, 6 launches of row 4ᵉ's pair.
15. The registry's encoder-decoder and VLM (run_vlm_encdec), from
   seed-0 weights on phase 3's data, each batch with the stub embeddings
   its forward reads, 0.02·N(0, 1) drawn from a seed on the host
   (run_federated attaches none, as the reference's): Whisper-base at
   full width and depth (6 encoder and 6 decoder layers, d 512, 8 heads
   of 64, V 51865, 1500 stub frames): the first step's LoRA gradient
   (wq/wk/wv of the encoder, the decoder's self-attention and its
   cross-attention: 54 sites, 18 flash calls a pass) and the LoRA after
   WHISPER_STEPS Adam steps, both from fp64; one DP step's rows and
   clipped mean from fp64; the Split encoder-decoder int8 first step
   (client = encoder, boundary (16, 1500, 512)), its flipped levels
   gated as phases 6-8 gate theirs; then LLaVA-NeXT-34B at full width
   and LLAVA_LAYERS (2) of its 60 layers (60 hold ~134 GB of fp32
   weights; d 7168, 56 heads of 128 over 8, d_ff 20480, V 64000, 576
   stub image tokens of dim 1024 projected and prepended, 2.0e9
   parameters): the first step's LoRA gradient from fp64.  Every
   kernel run's launches are the ones its sites predict.

Phase 2 also takes the flash kernels to phase 15's shapes
(vlm_encdec_kernel_checks): non-causal at Whisper's encoder (BH 128, S
1500, D 64), cross-attention (80 queries over 1500 keys) and LLaVA's
causal G 7 (BH 896 over 128, S 656, D 128), each against its twin, its
fp64 error gated as above and timed beside SDPA; the LoRA kernels (rows
1, 2, 4) at (24000, 512, 512) and (10496, 7168, 7168 | 1024); row 4ᵉ's
pair at (16, 1500, 512 | 512); row 10's roundtrip at (24000, 512).

16. Serving (run_serving): the decode path and launch/serve.py, from
   seed-0 weights, batch 4, a 16-token prompt and 32 generated tokens
   (serve.py's defaults: 48 decode steps), an fp32 cache of 48
   positions.  GPT-2 at full width and depth with rank-8 LoRA on
   wq/wk/wv (B drawn nonzero), served bound (row 1 at M 4: 36 launches
   a step) and merged; Whisper-base at full width and depth, 1500 stub
   frames, bound (24 row-1 launches and 6 flash cross-attentions, one
   query over 1500 keys, a step; the prefill's encoder and cross K/V 30
   and 6); Qwen3-1.7B at full depth, bound (84 a step);
   RecurrentGemma-2B at RG_SERVE_LAYERS (one pattern group) and RWKV-6
   at RWKV_SERVE_LAYERS of their layers, full width, merged (no
   launch: the recurrent steps and the cache's attention are plain, as
   in the reference).  Each model (serve_case): the fp64 plain run's
   greedy tokens after the prompt make one sequence that every run
   decodes teacher-forced; the kernel run's logits gated from fp64 over
   all steps (floor_gate, TF32 outside) and at each step; against the
   fp64 plain forward over the same tokens within that limit; GPT-2's
   bound against its merged within it; launches exact; tokens/s batched,
   kernels against plain.  Then ``serve.main`` on GPT-2 (sampled).
   Before the runs, row 1 at (4, 768, 768 | r 8) and (4, 2048, 2048 |
   1024) and row 5 at (BH 32, Sq 1, Skv 1500, D 64) against their
   twins, timed eager and in a CUDA graph beside the matmul chain and
   SDPA, their rms error against fp64 over the yardstick's
   (decode_kernel_checks: "@dec", "@dec-q3", "@dec-q3kv", "@whd").

17. The generative task (run_generative) at full gpt2 width from phase
   3's seed-0 weights and data.  (a) ``launch/train.py --arch gpt2``,
   TRAIN_STEPS (50) steps of 8 x 64 on the synthetic Markov corpus,
   ``--ckpt-dir`` a temporary directory: its first step's LoRA gradient
   and its LoRA after TRAIN_ADAM_STEPS (3) Adam steps gated from fp64;
   the run through the kernels exits 0 (its loss fell), launches 50
   times a step's (36 row 1, 36 row 2, 72 row 4, 12 each of rows 5-7),
   and its checkpoints at steps 25 and 50 restore bit for bit into the
   live tree; a plain run gives the plain step time; rows 1, 2, 4-7 are
   timed at its shapes ("@tr": M 512; BH 96, S 64).  (b) Generative
   FedLLM, 2 rounds, under ``sequential`` (each_run's five settings) and
   ``spmd`` (kernels): ledger and client FLOPs equal phase 3's
   classification run's, the final LoRA of both kernel runs from fp64
   within phase 3's limit, each round's loss within the spread gate,
   launches exact.  (c) One generative DP-SGD step, its rows and clipped
   mean from fp64.  (d) The generative Split int8 first step's flipped
   boundary levels.  (e) The generative KD steps: a public batch of 16 x
   80 through ``logits_fn`` (full logits), ``kd.compress_for_wire`` at
   top-k GEN_TOPK (64) int8 (row 12 at (1280, 50257), bit for bit its
   twin) and one ``kd_step`` (rows 8 and 9 at (1280, 50257)), launches
   exact; the student's LoRA gradient from fp64 (the fp64 run takes the
   KL in fp64); rows 8, 9 and 12 timed on the path's tensors ("@genkd");
   then a generative KD round raises ValueError at b4, as the
   reference's does.

18. The launch layer's step builders (run_launch; launch/steps.py) on
   Qwen3-1.7B at full width and depth, from phase 14's seed-0 weights
   (kept on the host since phase 14, shared with phase 16), fp32.  (a)
   bf16 CUDA tensors into kernels/ops.lora_matmul and ops.mha_attention
   raise ValueError and launch nothing.  (b) ``build_train_step`` at
   train_4k cut to a global batch of 2 (S 4096), an adapter with B drawn
   nonzero: remat none, full and selective, launches exact (84 / 84 /
   168 / 28 / 28 / 28 of rows 1, 2, 4-7; rows 1 and 5 twice under
   recomputation), the first step's LoRA gradient (Adam's first moment)
   and the LoRA after the step compared across them bit for bit; the
   gradient gated from fp64 against plain, cuBLASLt, TF32 and fp64 runs
   at remat full; each step's time and peak memory printed.  (c)
   ``build_prefill_step`` at prefill_32k (batch 1, S 32768; the full
   logits, 19.9 GB), launches exact (84 row 1, 28 row 5), the last
   position's logits from fp64 against runs of the twin's formula in
   blocks of query rows with the head on the last row.  (d)
   ``build_decode_step`` at decode_32k (batch 4, an fp32 cache 32768 deep,
   30.1 GB, its first 32760 positions filled on the card): 8 decode steps
   teacher-forced, their logits from fp64 (the fp64 run casts each
   layer's cache on the fly), 84 row-1 launches a step, the step time.
   (e) ``build_fed_round_step`` at train_4k cut to S 512, 2 clients of
   batch 2, one local step: FedLLM, KD (classification), Split, FedLLM
   under DP (clip at the first step's median per-example norm, noise 0)
   under each_run's five settings, Adam's first moments gated from fp64
   and the signs of the LoRA updates against fp64's (fp32_gates' flips),
   launches exact; FedLLM at n_edges 2 within 1e-6 of n_edges 1.  Phase
   2 also holds rows 1, 2, 4 at train_4k's LoRA sites ((8192, 2048, 2048
   | 1024)) and rows 5-7 at its attention (BH 32 over 16, S 4096, D 128)
   to their twins and to fp64 ("@4k", "@4kkv"), and row 1 at (32768,
   2048, 2048 | 1024) and row 5 at prefill_32k's attention (BH 16 over 8,
   S 32768) on sampled query rows ("@32k", "@32kkv"), timed beside the
   matmul chain and SDPA (launch_kernel_checks).

19. The dry run (run_dry_run; launch/dryrun.py), traced on the host in
   four processes of their own, started after phase 1 (no card visible,
   nice 19, one thread each; start_dry_run): (a) Qwen3-1.7B's train_4k,
   prefill_32k and decode_32k steps and its FedLLM, KD and Split rounds
   at train_4k, bf16, on the 16 x 16 and 2 x 16 x 16 fake meshes, every
   record OK, each printed (GiB a device, FLOPs a device, collective
   bytes by kind, the forced replications); (b) phase 18's cut steps on
   a one-device mesh in fp32 under the plain policy: the argument bytes
   equal what phase 18's argument tensors hold on the card (the served
   adapter's factors left out), the train step's FLOPs equal
   FlopCounterMode's over one more plain train run of phase 18
   (launch_train_measured), its temp + args + outputs within 0.8-1.25 of
   that run's peak with its arguments; (c) the three roofline terms of
   (b)'s steps at the H100's 3xTF32 peak beside phase 18's kernel-run
   step times.

After phase 19 it prints each kernel's launches times its time beyond
max(bound, launch floor) (the rule-2 queue), the final-LoRA margins of
phase 7, Split int8 and RWKV-6, phase 5's first-step and final-LoRA
margins, phase 8's KD and DP shares and the shares of the Split, hetero,
async and fault gates of phases 7, 8, 10-18
(each kernel run's share of its limit, beside the last recorded run's,
or "new"), then one JSON
line with every kernel's numbers and, last, the line ``{"ok": true, "device": {...}}``.  It imports nothing of
JAX.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ATOL, RTOL = 1e-4, 1e-4
KD_ATOL, KD_RTOL = 1e-5, 1e-4
DP_ATOL, DP_RTOL = 1e-6, 1e-5
EXACT = ("topk_quantize", "quantize_rows", "quantize_rows_int4",
         "quantize_pack4", "rglru_fwd", "rglru_bwd", "quant_roundtrip_rows",
         "quant_roundtrip_rows_int4")
# of those, the ones whose fp32 outputs are compared as integers (+0.0 and
# -0.0 apart): the roundtrip's y must be its twin's to the sign of a zero
EXACT_SIGNED = ("quant_roundtrip_rows", "quant_roundtrip_rows_int4")
# outputs compared bit for bit in kernels otherwise held to a tolerance:
# the WKV forward's S_final (its state update rounds as the plain one)
EXACT_OUTPUTS = {"rwkv6_fwd": (1,)}
WKV_ATOL, WKV_RTOL = 1e-5, 1e-4
# kernels also timed inside a CUDA graph, and their library call beside
# them: at the main path's shapes an eager call's host cost exceeds their
# device time
GRAPH_TIMED = ("kd_fwd", "kd_bwd", "kd_bwd_dt", "topk_quantize",
               "dp_clip_norms", "dp_clip_acc", "dp_clip_acc_clients",
               "quantize_rows",
               "quantize_rows_int4", "quantize_pack4", "quant_roundtrip_rows",
               "quant_roundtrip_rows_int4", "rglru_fwd",
               "rglru_bwd", "rwkv6_fwd", "rwkv6_bwd", "lora_panel",
               "lora_panel_t", "lora_panel_examples", "lora_panel_examples_t",
               "lora_panel_examples_pair",
               "lora_fwd_clients", "lora_dx_clients", "lora_panel_clients",
               "lora_panel_clients_t")
# kernels also timed with the L2 flushed before each call: their input
# (28.3 MB at the DP path, 26-39 MB at the RG-LRU's) fits the 50 MB L2, so
# back-to-back calls read it from there, while in a step the passes
# between calls evict it
COLD_TIMED = ("dp_clip_norms", "dp_clip_acc", "rglru_fwd", "rglru_bwd",
              "rwkv6_fwd", "rwkv6_bwd")
L2_FLUSH_BYTES = 100 * 2 ** 20
# data-sheet peaks: (fp32 FLOP/s without tensor cores, memory bytes/s,
# dense TF32 tensor-core FLOP/s)
PEAKS = {"H100 PCIe": (51.2e12, 2.0e12, 378e12),
         "H100 NVL": (60.0e12, 3.9e12, 417.5e12),
         "H100": (67.0e12, 3.35e12, 494.7e12)}
# kernels whose products run on the tensor cores in 3xTF32 (three TF32
# products each): their operation bound is at a third of the TF32 peak
TF32X3 = ("lora_fwd", "lora_dx", "lora_dw", "flash_fwd", "flash_dq",
          "flash_dkv", "lora_fwd_clients", "lora_dx_clients")
BATCH, PAD_LEN, RANK = 16, 80, 8
# the case study's clients, stacked on a leading axis by the spmd backend
CLIENTS = 3
SPLIT_LAYER, SPLIT_BITS = 2, 8
# LoRA parameters per example at gpt2 width: rank 8 on wq/wk/wv, 12 layers
DP_WIDTH = 12 * 3 * 2 * RANK * 768
# gates from fp64: a distance from the fp64 run <= FLOOR_FACTOR times the
# larger of the two fp32 plain runs' + FLOOR_SLACK
FLOOR_FACTOR, FLOOR_SLACK = 3.0, 1e-6
# the final-LoRA gate of a path whose runs part (run_case's "spread"),
# with nudged fp32 runs: relative L2
# <= SPREAD_FACTOR * the largest fp32 run's + slack.  On RWKV-6 four fp32
# runs lie within 4.35e-3 to 4.74e-3 of plain (standard deviation 3.9 %
# of their mean, so 1.2x the largest is six of them above it), TF32 at
# 6.81e-3
SPREAD_FACTOR = 1.2
# the LoRA kernels' rms error against fp64 (forward, dx, dW at K = N of
# GPT-2 and RecurrentGemma-2B), at most this many times the default BLAS
# library's for the same products
FP64_FACTOR = 1.5
# row 4ᵉ's pair: its rms error against fp64 at most this many times
# torch.bmm's, 1.1 times the 0.56-0.57 that the single launches it
# replaces reach at the DP step's four sites
PAIR_FP64_FACTOR = 1.1 * 0.57
# the LoRA (wq of a local-attention layer) and flash shapes of a
# RecurrentGemma-2B train step
RG_SHAPES = dict(M=BATCH * PAD_LEN, K=2560, N=2560, r=RANK, BH=BATCH * 10,
                 BKV=BATCH, S=PAD_LEN, Skv=PAD_LEN, D=256, causal=True,
                 window=2048, q_offset=0)
# RWKV-6 Finch 1.6B: 32 heads of 64; the LoRA shape of its time-mix
# projections (the attention shapes, unused there, are GPT-2's)
RWKV_HEADS = 32
# fp32 plain runs from nudged weights that join the floor run in the
# case studies whose rounds or final LoRA one pair of fp32 runs samples
# too thinly (phases 4, 6 both sets, 7 and 8; on the continuous ones, 6
# fp32 and 7, each beside an fp64 run of its own weights), and in the
# Split int8 set's boundary-level floor
NUDGED_SEEDS = 3
RWKV_SHAPES = dict(M=BATCH * PAD_LEN, K=2048, N=2048, r=RANK, BH=BATCH * 12,
                   BKV=BATCH * 12, S=PAD_LEN, Skv=PAD_LEN, D=64, causal=True,
                   window=0, q_offset=0)
# phase 8's FedLLM set runs the first RWKV6_FEDLLM_LAYERS of RWKV-6's 24
# layers (its plain WKV twin takes 16-19 s a round at 24); KD, DP and
# Split keep all 24
RWKV6_FEDLLM_LAYERS = 6
# phase 14: the LoRA (wq; K = N = d) and flash shapes of a Qwen3-1.7B and
# a Mixtral-8x7B train step, both at head dim 128 (the flash kernels'
# DT = 128 instances); their wk/wv are (d, 8 kv heads x 128 = 1024)
Q3_SHAPES = dict(M=BATCH * PAD_LEN, K=2048, N=2048, r=RANK, BH=BATCH * 16,
                 BKV=BATCH * 8, S=PAD_LEN, Skv=PAD_LEN, D=128, causal=True,
                 window=0, q_offset=0)
MX_SHAPES = dict(M=BATCH * PAD_LEN, K=4096, N=4096, r=RANK, BH=BATCH * 32,
                 BKV=BATCH * 8, S=PAD_LEN, Skv=PAD_LEN, D=128, causal=True,
                 window=4096, q_offset=0)
KV_WIDTH = 8 * 128
# Mixtral-8x7B runs 2 of its 32 layers at full width: 32 are ~187 GB of
# fp32 weights, 2 are 12.7 GB (25.4 GB in fp64)
MIXTRAL_LAYERS = 2
# phase 15: Whisper-base's 1500 stub frames; its encoder's flash and LoRA
# shapes (8 heads of 64 over 16 x 1500 frames; wq/wk/wv and the
# cross-attention's wk/wv at K = N = 512) and its cross-attention (80
# text queries over 1500 frames); LLaVA-NeXT-34B's 576 stub image tokens
# prepended to 80 text tokens, 56 query heads of 128 over 8 kv heads
WH_FRAMES = 1500
WH_SHAPES = dict(M=BATCH * WH_FRAMES, K=512, N=512, r=RANK, BH=BATCH * 8,
                 BKV=BATCH * 8, S=WH_FRAMES, Skv=WH_FRAMES, D=64,
                 causal=False, window=0, q_offset=0)
WHX_SHAPES = dict(WH_SHAPES, M=BATCH * PAD_LEN, S=PAD_LEN)
LV_IMAGE = 576
LV_SHAPES = dict(M=BATCH * (LV_IMAGE + PAD_LEN), K=7168, N=7168, r=RANK,
                 BH=BATCH * 56, BKV=BATCH * 8, S=LV_IMAGE + PAD_LEN,
                 Skv=LV_IMAGE + PAD_LEN, D=128, causal=True, window=0,
                 q_offset=0)
# Whisper's Adam steps: client 0's three batches of round 0
WHISPER_STEPS = 3
# LLaVA-NeXT-34B runs 2 of its 60 layers at full width: 60 are ~134 GB
# of fp32 weights, 2 are 8.1 GB (16.2 GB in fp64)
LLAVA_LAYERS = 2
# phase 16 (serving): serve.py's defaults, batch 4, a 16-token prompt and
# 32 generated, so 48 decode steps over an fp32 cache of 48 positions;
# RecurrentGemma-2B serves one full pattern group (rglru, rglru,
# local_attn) of its 26 layers and RWKV-6 2 of its 24, at full width; a
# served adapter is rank RANK at alpha 32 with B drawn N(0, SERVE_B_STD²)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16, 32
SERVE_LEN = SERVE_PROMPT + SERVE_GEN
RG_SERVE_LAYERS, RWKV_SERVE_LAYERS = 3, 2
SERVE_ALPHA, SERVE_B_STD = 32.0, 0.002
# phase 16's kernel shapes: row 1 at a decode step's M = 4 rows (GPT-2's
# wq/wk/wv; Qwen3-1.7B's wq and its wk/wv), row 5 at Whisper-base's
# cross-attention, one query over the 1500 frames (4 x 8 heads of 64);
# the unused half of each shape is kept small
_NO_ATTN = dict(BH=1, BKV=1, S=1, Skv=1, D=64, causal=False, window=0,
                q_offset=0)
DEC_SHAPES = {
    "dec": ("lora_fwd", dict(M=SERVE_BATCH, K=768, N=768, r=RANK,
                             **_NO_ATTN)),
    "dec-q3": ("lora_fwd", dict(M=SERVE_BATCH, K=2048, N=2048, r=RANK,
                                **_NO_ATTN)),
    "dec-q3kv": ("lora_fwd", dict(M=SERVE_BATCH, K=2048, N=KV_WIDTH, r=RANK,
                                  **_NO_ATTN)),
    "whd": ("flash_fwd", dict(M=SERVE_BATCH, K=512, N=512, r=RANK,
                              BH=SERVE_BATCH * 8, BKV=SERVE_BATCH * 8, S=1,
                              Skv=WH_FRAMES, D=64, causal=False, window=0,
                              q_offset=0)),
}
# phase 17: launch/train.py's run at --arch gpt2 (TRAIN_STEPS steps of
# TRAIN_BATCH x TRAIN_SEQ; its first step and TRAIN_ADAM_STEPS Adam steps
# gated from fp64), its LoRA and flash shapes ("@tr": M 512, BH 96 at S
# 64), and the generative KD steps' top-k (GEN_TOPK of 50257)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_ADAM_STEPS = 50, 8, 64, 3
TR_SHAPES = dict(M=TRAIN_BATCH * TRAIN_SEQ, K=768, N=768, r=RANK,
                 BH=TRAIN_BATCH * 12, BKV=TRAIN_BATCH * 12, S=TRAIN_SEQ,
                 Skv=TRAIN_SEQ, D=64, causal=True, window=0, q_offset=0)
GEN_TOPK = 64
# phase 18 (launch/steps.py's builders on Qwen3-1.7B, 28 layers): phase
# 14's host copy of its seed-0 weights, shared with phases 16 and 18; the
# assigned shapes as cut: train_4k at S 4096 and a global batch of 2 (of
# 256), prefill_32k at batch 1 (of 32), decode_32k at batch 4 (of 128) over
# a cache 32768 deep, its first LAUNCH_DECODE_FILL positions filled; the
# fed_round programs at train_4k cut to S 512, 2 clients of batch 2, one
# local step (at S 1024 the fp64 run's activations, 2.6 GB a layer by a
# meta-device count, would not fit beside the weights); the plain
# prefill's attention in blocks of LAUNCH_CHUNK query rows (fp64:
# LAUNCH_CHUNK_FP64)
QWEN3_HOST = {}
QWEN3_LAYERS = 28
# prefetch_draws' host trees by config, and how many it may draw ahead of
# the phases that take them (each up to 12.7 GB of host memory)
DRAWS = {}
DRAWS_AHEAD = 2
_DRAW_SLOTS = threading.Semaphore(DRAWS_AHEAD)
LAUNCH_TRAIN_SEQ, LAUNCH_TRAIN_BATCH = 4096, 2
LAUNCH_PREFILL_SEQ = 32768
LAUNCH_DECODE_DEPTH, LAUNCH_DECODE_BATCH, LAUNCH_DECODE_FILL = 32768, 4, 32760
LAUNCH_ROUND_SEQ, LAUNCH_CLIENTS, LAUNCH_CLIENT_BATCH = 512, 2, 2
LAUNCH_CHUNK, LAUNCH_CHUNK_FP64 = 2048, 1024
# n_edges 2's aggregate against n_edges 1's: fp32 reassociation only
LAUNCH_EDGES_LIMIT = 1e-6
# phase 2 at phase 18's shapes: rows 1, 2, 4 at train_4k's LoRA sites and
# rows 5-7 at its attention ("@4k"); row 1 at prefill_32k's sites ("@32k",
# the attention part of kernel_cases unused) and row 5 at its attention
# (PREFILL32K_ATTN), held on LONG_ROWS query rows from each of LONG_BLOCKS
TRAIN4K_SHAPES = dict(M=LAUNCH_TRAIN_BATCH * LAUNCH_TRAIN_SEQ, K=2048, N=2048,
                      r=RANK, BH=LAUNCH_TRAIN_BATCH * 16,
                      BKV=LAUNCH_TRAIN_BATCH * 8, S=LAUNCH_TRAIN_SEQ,
                      Skv=LAUNCH_TRAIN_SEQ, D=128, causal=True, window=0,
                      q_offset=0)
PREFILL32K_SHAPES = dict(M=LAUNCH_PREFILL_SEQ, K=2048, N=2048, r=RANK,
                         **_NO_ATTN)
PREFILL32K_ATTN = dict(BH=16, BKV=8, S=LAUNCH_PREFILL_SEQ, D=128)
LONG_ROWS = 64
LONG_BLOCKS = (0, 8192, 16384 - 32, LAUNCH_PREFILL_SEQ - LONG_ROWS)
# phase 19 (launch/dryrun.py): the traces run in a process of their own
# on the host (no card, lowest priority) from phase 2 on, writing
# DRYRUN_JSON; phase 18 leaves in LAUNCH_MEASURED what it measured on the
# card (argument bytes, the plain train run's FlopCounterMode count and
# peak memory, the kernel runs' step times); the memory prediction of
# the plain train step (temp + args + outputs) must lie within
# DRYRUN_BAND of its measured peak with its arguments
LAUNCH_MEASURED = {}
DRYRUN_JSON = ROOT / "build" / "dryrun_phase19.json"   # _<part>.json
DRYRUN_BAND = (0.8, 1.25)
# phase 19 waits for the traces until this long after phase 1 began (the
# script has 1200 s in all)
DRYRUN_DEADLINE_S = 1160


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"chip_smoke: no data-sheet peaks for card {name!r}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
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


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a
    CUDA graph, replayed ``replays`` times, so the host's cost of a call
    (Python, ctypes, allocation) is not in it.  A call whose work autograd
    recorded on another stream (``fn.capture_stream``) is captured on that
    stream, where its backward runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=getattr(fn, "capture_stream", None)):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def cold_graph_ms(fn) -> float:
    """Device time of one call of ``fn`` with a cold L2: calls captured
    after a write of L2_FLUSH_BYTES each, less the time of the writes
    alone."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")

    def flushed():
        flush.zero_()
        fn()

    return graph_ms(flushed) - graph_ms(flush.zero_)


def _flat(out):
    """A kernel's outputs as a flat list of tensors (None dropped)."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [] if out is None else [out]


def tolerance(name: str):
    if name.startswith("kd_"):
        return KD_ATOL, KD_RTOL
    if name.startswith("dp_"):
        return DP_ATOL, DP_RTOL
    if name.startswith("rwkv6_"):
        return WKV_ATOL, WKV_RTOL
    return ATOL, RTOL


def max_err(name: str, got, want) -> float:
    """Largest absolute difference between a kernel's outputs and its plain
    version's; fails unless they agree (bit for bit for the names in
    EXACT and the outputs in EXACT_OUTPUTS, else within the name's
    tolerance)."""
    import torch
    got, want = _flat(got), _flat(want)
    require(len(got) == len(want), f"{name}: {len(got)} outputs, plain "
            f"version {len(want)}")
    atol, rtol = tolerance(name)
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"{name}: output {tuple(g.shape)} {g.dtype} vs plain "
                f"{tuple(w.shape)} {w.dtype}")
        if name in EXACT or i in EXACT_OUTPUTS.get(name, ()):
            diff = g.view(torch.int32) != w.view(torch.int32) \
                if name in EXACT_SIGNED else g != w
            require(not bool(diff.any()),
                    f"{name} is not bit-identical to its plain version: "
                    f"{int(diff.sum())} of {diff.numel()} {g.dtype} entries "
                    f"differ, first at {diff.nonzero()[:1].tolist()}: "
                    f"{g[diff][:4].tolist()} vs {w[diff][:4].tolist()}")
            continue
        require(bool(torch.isfinite(g).all()), f"{name} output not finite")
        require(torch.allclose(g, w, atol=atol, rtol=rtol),
                f"{name} disagrees with its plain version "
                f"(max abs err {(g - w).abs().max().item():.3e})")
        err = max(err, (g - w).abs().max().item())
    return err


# --------------------------------------------------------------------------- #
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #
def kernel_cases(device, M, K, N, r, BH, BKV, S, Skv, D, causal, window,
                 q_offset, seed):
    """{name: (kernel_fn, plain_fn, library_fn or None, bytes, flops)} on
    fresh seeded inputs of the given shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape, std=1.0):
        return torch.randn(shape, device=device, generator=gen) * std

    # every input is scaled so that each output element is O(1): the
    # tolerance then bounds the error of fp32 sums of up to M terms taken
    # in another order, whatever the size of the contraction
    x, g = rn(M, K), rn(M, N)
    w, a, b = rn(K, N, std=K ** -0.5), rn(K, r, std=K ** -0.5), \
        rn(r, N, std=N ** -0.5)
    xa, gb = (x @ a) * M ** -0.5, (g @ b.t()) * M ** -0.5
    gs = g * M ** -0.5
    f4 = 4
    lora_bytes = f4 * (M * K + K * N + K * r + r * N + M * N + M * r)
    lora_flops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N
    cases = {
        "lora_fwd": (lambda: lm.lora_fwd(x, w, a, b),
                     lambda: ref.lora_fwd(x, w, a, b),
                     lambda: x @ w + (x @ a) @ b, lora_bytes, lora_flops),
        "lora_dx": (lambda: lm.lora_dx(g, w, a, b),
                    lambda: ref.lora_dx(g, w, a, b),
                    lambda: g @ w.t() + (g @ b.t()) @ a.t(), lora_bytes,
                    lora_flops),
        "lora_dw": dw_case(x, gs),
        "lora_panel": (lambda: lm.lora_panel(x, gb),
                       lambda: ref.panel_grad(x, gb),
                       lambda: x.t() @ gb, f4 * (M * K + M * r + K * r),
                       2 * M * K * r),
        "lora_panel_t": (lambda: lm.lora_panel(g, xa, True),
                         lambda: ref.panel_grad(g, xa, True),
                         lambda: xa.t() @ g,
                         f4 * (M * N + M * r + N * r), 2 * M * N * r),
    }
    q, k, v, do = rn(BH, S, D), rn(BKV, Skv, D), rn(BKV, Skv, D), rn(BH, S, D)
    o, lse = ref.attention_fwd(q, k, v, causal, window, q_offset)
    dd = (do * o).sum(-1)
    mask = ref._mask(S, Skv, causal, window, q_offset, device)
    pairs = BH * int(mask.sum())
    qb, kvb, rowb = f4 * BH * S * D, f4 * BKV * Skv * D, f4 * BH * S
    cfg = (causal, window, q_offset)
    # the library yardstick: one scaled_dot_product_attention call on the
    # same tensors viewed as (1, heads, S, D), where it computes the same
    # function (no offset, no window shorter than S, and S == Skv when
    # causal: SDPA aligns a causal mask to the top left); with GQA on k
    # and v expanded to the query heads beforehand
    sdpa_ok = q_offset == 0 and (window == 0 or window >= S) and (
        S == Skv or not causal)
    G = BH // BKV
    ke, ve = (t.repeat_interleave(G, dim=0) for t in (k, v))

    def sdpa():
        return F.scaled_dot_product_attention(q[None], ke[None], ve[None],
                                              is_causal=causal)

    sdpa_bwd = None
    if sdpa_ok:
        leaves = [t.detach()[None].requires_grad_(True) for t in (q, ke, ve)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        dout = do[None]

        def sdpa_bwd():
            return torch.autograd.grad(out, leaves, dout, retain_graph=True)

    cases.update({
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, *cfg),
                      lambda: ref.attention_fwd(q, k, v, *cfg),
                      sdpa if sdpa_ok else None,
                      2 * qb + 2 * kvb + rowb, pairs * 4 * D),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, dd, *cfg),
                     lambda: ref.attention_dq(q, k, v, do, lse, dd, *cfg),
                     sdpa_bwd, 3 * qb + 2 * kvb + 2 * rowb, pairs * 6 * D),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, dd, *cfg),
                      lambda: ref.attention_dkv(q, k, v, do, lse, dd, *cfg),
                      sdpa_bwd, 2 * qb + 4 * kvb + 2 * rowb, pairs * 8 * D),
    })
    return cases


def dw_case(x, g):
    """The dW kernel (row 3) on x (M, K) and g (M, N), as a kernel_cases
    entry; the library yardstick is the one product ``x.t() @ g``."""
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ref

    (M, K), N = x.shape, g.shape[1]
    return (lambda: lm.lora_dw(x, g), lambda: ref.lora_dw(x, g),
            lambda: x.t() @ g, 4 * (M * K + M * N + K * N), 2 * M * K * N)


def lora_edge_cases(device, M, K, N, r, offset, seed):
    """The fused LoRA forward and dx kernels on kernel_cases' O(1) inputs
    of (M, K, N) and rank r, with x and g placed ``offset`` floats into
    their storage (misaligned for 16-byte copies at 1), as {name: (kernel,
    plain)}."""
    import torch

    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape, std=1.0, at=0):
        flat = torch.randn(at + math.prod(shape), device=device,
                           generator=gen) * std
        return flat[at:].view(shape)

    x, g = rn(M, K, at=offset), rn(M, N, at=offset)
    w, a, b = rn(K, N, std=K ** -0.5), rn(K, r, std=K ** -0.5), \
        rn(r, N, std=N ** -0.5)
    return {"lora_fwd": (lambda: lm.lora_fwd(x, w, a, b),
                         lambda: ref.lora_fwd(x, w, a, b)),
            "lora_dx": (lambda: lm.lora_dx(g, w, a, b),
                        lambda: ref.lora_dx(g, w, a, b))}


def panel_edge_cases(device, M, L, r, offset, seed):
    """The panel gradient kernel (row 4) on lhs (M, L), placed ``offset``
    floats into its storage (misaligned for 16-byte loads at 1), and an
    (M, r) panel scaled by M^-0.5 (O(1) outputs), untransposed and
    transposed, as kernel_cases entries."""
    import torch

    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(offset + M * L, device=device, generator=gen)
    lhs = flat[offset:].view(M, L)
    panel = torch.randn((M, r), device=device, generator=gen) * M ** -0.5
    nbytes, nflops = 4 * (M * L + M * r + L * r), 2 * M * L * r
    return {"lora_panel": (lambda: lm.lora_panel(lhs, panel),
                           lambda: ref.panel_grad(lhs, panel),
                           lambda: lhs.t() @ panel, nbytes, nflops),
            "lora_panel_t": (lambda: lm.lora_panel(lhs, panel, True),
                             lambda: ref.panel_grad(lhs, panel, True),
                             lambda: panel.t() @ lhs, nbytes, nflops)}


def panel_examples_inputs(device, B, S, L, r, offset, seed):
    """lhs (B, S, L) placed ``offset`` floats into its storage (misaligned
    for 16-byte loads at 1) and a (B, S, r) panel scaled by S^-0.5 (O(1)
    outputs)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(offset + B * S * L, device=device, generator=gen)
    lhs = flat[offset:].view(B, S, L)
    panel = torch.randn((B, S, r), device=device, generator=gen) * S ** -0.5
    return lhs, panel


def panel_examples_cases(device, B, S, L, r, offset, seed):
    """Row 4 with an example axis (each example's lhs_bᵀ·panel_b, the DP
    step's dA and dB) on panel_examples_inputs, untransposed and
    transposed, as kernel_cases entries; the library yardstick is one
    ``torch.bmm``."""
    import torch

    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ref

    lhs, panel = panel_examples_inputs(device, B, S, L, r, offset, seed)
    lhs_t, panel_t = lhs.transpose(1, 2), panel.transpose(1, 2)
    nbytes, nflops = 4 * (B * S * L + B * S * r + B * L * r), 2 * B * S * L * r
    return {"lora_panel_examples": (
                lambda: lm.lora_panel_examples(lhs, panel),
                lambda: ref.panel_grad_examples(lhs, panel),
                lambda: torch.bmm(lhs_t, panel), nbytes, nflops),
            "lora_panel_examples_t": (
                lambda: lm.lora_panel_examples(lhs, panel, True),
                lambda: ref.panel_grad_examples(lhs, panel, True),
                lambda: torch.bmm(panel_t, lhs), nbytes, nflops)}


def panel_examples_checks(device, peaks_) -> dict:
    """Phase 2's part for row 4 with an example axis: the kernel against its
    twin (both layouts) at the DP batch's GPT-2, RecurrentGemma-2B (wq and
    wk/wv) and RWKV-6 widths, a ragged (3, 37, 770) at rank 13, S 1 at
    rank 64 and a misaligned lhs; its bits over two eager calls and two
    graph replays; at the four DP shapes its rms error against fp64
    within FP64_FACTOR times torch.bmm's, and times (kernel, twin,
    torch.bmm, and the old way: B launches of lora_panel on one example's
    (S, L) each).  Returns the timed rows ("<name>", "<name>@rg",
    "<name>@rg256", "<name>@rwkv")."""
    import torch

    from repro_torch.kernels import lora_matmul as lm

    shapes = [(BATCH, PAD_LEN, 768, RANK, 0, ""),
              (BATCH, PAD_LEN, 2560, RANK, 0, "@rg"),
              (BATCH, PAD_LEN, 256, RANK, 0, "@rg256"),
              (BATCH, PAD_LEN, 2048, RANK, 0, "@rwkv"),
              (3, 37, 770, 13, 0, None),
              (5, 1, 768, 64, 0, None),
              (BATCH, PAD_LEN, 768, RANK, 1, None)]
    rows = {}
    for i, (B, S, L, r, offset, tag) in enumerate(shapes):
        where = f"(B {B}, S {S}, L {L}, r {r}, offset {offset})"
        cases = panel_examples_cases(device, B, S, L, r, offset, 180 + i)
        for name, case in cases.items():
            same_bits_repeated(name, case[0])
            if tag is None:
                err = max_err(name, case[0](), case[1]())
                print(f"  {name} {where}: max abs err {err:.3e}; two eager "
                      f"calls and two graph replays bit-identical")
                continue
            print(f"  {name} {where}, two eager calls and two graph "
                  f"replays bit-identical:")
            rows[name + tag] = time_case(name, case, peaks_)
        if tag is None:
            continue
        lhs, panel = panel_examples_inputs(device, B, S, L, r, offset,
                                           180 + i)
        exact = lhs.double().transpose(1, 2) @ panel.double()
        rms = {who: float(((y.double() - exact) ** 2).mean().sqrt())
               for who, y in (("kernel", lm.lora_panel_examples(lhs, panel)),
                              ("bmm", torch.bmm(lhs.transpose(1, 2), panel)))}
        print(f"  lora_panel_examples {where}: rms error against fp64 kernel "
              f"{rms['kernel']:.3e}, torch.bmm {rms['bmm']:.3e} (kernel / "
              f"torch.bmm {rms['kernel'] / rms['bmm']:.2f})")
        require(rms["kernel"] <= FP64_FACTOR * rms["bmm"],
                f"lora_panel_examples {where}: rms error against fp64 "
                f"{rms['kernel']:.3e} exceeds {FP64_FACTOR} times "
                f"torch.bmm's {rms['bmm']:.3e}")
        rows["lora_panel_examples" + tag]["fp64_rms_ratio"] = \
            rms["kernel"] / rms["bmm"]

        def old_way():
            return [lm.lora_panel(lhs[b], panel[b]) for b in range(B)]

        eager, graph = cuda_ms(old_way), graph_ms(old_way, calls=4)
        rows["lora_panel_examples" + tag].update(old_way_ms=eager,
                                                 old_way_graph_ms=graph)
        print(f"  the old way {where}: {B} launches of lora_panel at M {S}, "
              f"eager {eager:.4f} ms, in a graph {graph:.4f} ms")
    return rows


def pair_checks(device, peaks_) -> dict:
    """Phase 2's part for row 4ᵉ's pair (lora_panel_examples_pair: a LoRA
    site's dA = each x_bᵀ·gb_b and dB = each (g_bᵀ·xa_b)ᵀ in one launch),
    at the DP batch's (B, S) = (16, 80), rank 8, for each site's (K | N):
    GPT-2's (768 | 768), RecurrentGemma-2B's wq (2560 | 2560) and wk/wv
    (2560 | 256), RWKV-6's (2048 | 2048); and at a ragged (3, 37, 770 |
    261) at rank 13, S 1 at rank 64 and a misaligned x and g.  At every
    shape its bits are those of the two lora_panel_examples launches it
    replaces (the old way) and the same over two eager calls and two graph
    replays, and it agrees with its twin within the LoRA tolerance; at the
    four sites, at GPT-2's over the spmd DP step's stacked batch of
    CLIENTS x BATCH examples and at Whisper-base's encoder and
    cross-attention wk/wv sites (16, 1500, 512 | 512), its rms error
    against fp64 (dA and dB
    together) is within PAIR_FP64_FACTOR times torch.bmm's, and it is
    timed eager and in a graph beside its twin, two torch.bmm calls (the
    library), the old way and its bound.  Returns the timed rows
    ("lora_panel_examples_pair", "...@c48", "...@rg", "...@rg256",
    "...@rwkv", "...@wh")."""
    import torch

    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ref

    shapes = [(BATCH, PAD_LEN, 768, 768, RANK, 0, ""),
              (CLIENTS * BATCH, PAD_LEN, 768, 768, RANK, 0, "@c48"),
              (BATCH, PAD_LEN, 2560, 2560, RANK, 0, "@rg"),
              (BATCH, PAD_LEN, 2560, 256, RANK, 0, "@rg256"),
              (BATCH, PAD_LEN, 2048, 2048, RANK, 0, "@rwkv"),
              (BATCH, WH_FRAMES, 512, 512, RANK, 0, "@wh"),
              (3, 37, 770, 261, 13, 0, None),
              (5, 1, 768, 768, 64, 0, None),
              (BATCH, PAD_LEN, 768, 768, RANK, 1, None)]
    name = "lora_panel_examples_pair"
    rows = {}
    for i, (B, S, K, N, r, offset, tag) in enumerate(shapes):
        where = f"(B {B}, S {S}, K {K} | N {N}, r {r}, offset {offset})"
        x, gb = panel_examples_inputs(device, B, S, K, r, offset, 250 + i)
        g, xa = panel_examples_inputs(device, B, S, N, r, offset, 260 + i)

        def kern():
            return lm.lora_panel_examples_pair(x, gb, g, xa)

        def old():
            return (lm.lora_panel_examples(x, gb),
                    lm.lora_panel_examples(g, xa, True))

        same_bits_repeated(name, kern)
        for got, was in zip(kern(), old()):
            require(torch.equal(got, was), f"{name} {where}: not the bits of "
                    f"the two lora_panel_examples launches")
        case = (kern, lambda: ref.panel_grad_examples_pair(x, gb, g, xa),
                lambda: (torch.bmm(x.transpose(1, 2), gb),
                         torch.bmm(xa.transpose(1, 2), g)),
                4 * (B * S * (K + N + 2 * r) + B * r * (K + N)),
                2 * B * S * r * (K + N))
        if tag is None:
            err = max_err(name, kern(), case[1]())
            print(f"  {name} {where}: max abs err {err:.3e}; the bits of "
                  f"the two single launches, over two eager calls and two "
                  f"graph replays")
            continue
        print(f"  {name} {where}, the bits of the two single launches, over "
              f"two eager calls and two graph replays:")
        row = time_case(name, case, peaks_)
        exact = (x.double().transpose(1, 2) @ gb.double(),
                 xa.double().transpose(1, 2) @ g.double())

        def rms(outs):
            sq = sum(float(((y.double() - e) ** 2).sum())
                     for y, e in zip(outs, exact))
            return math.sqrt(sq / sum(e.numel() for e in exact))

        ratio = rms(kern()) / rms(case[2]())
        print(f"  {name} {where}: rms error against fp64 {rms(kern()):.3e}, "
              f"torch.bmm {rms(case[2]()):.3e} (pair / torch.bmm "
              f"{ratio:.2f}, limit {PAIR_FP64_FACTOR:.3f})")
        require(ratio <= PAIR_FP64_FACTOR,
                f"{name} {where}: rms error against fp64 {ratio:.3f} times "
                f"torch.bmm's, above {PAIR_FP64_FACTOR:.3f}")
        row.update(fp64_rms_ratio=ratio, old_way_ms=cuda_ms(old),
                   old_way_graph_ms=graph_ms(old, calls=10))
        print(f"  the old way {where}: two lora_panel_examples launches, "
              f"eager {row['old_way_ms']:.4f} ms, in a graph "
              f"{row['old_way_graph_ms']:.4f} ms")
        rows[name + tag] = row
    return rows


def clip_clients_checks(device, peaks_) -> dict:
    """Phase 2's part for row 14ᶜ (dp_clip_acc_clients: each stacked
    client's mean of its clipped rows, the client on a grid axis) at the
    spmd DP step's (CLIENTS, BATCH, DP_WIDTH), half the rows clipped, and
    at edges: one client, a ragged width (scalar loads), a zero row, and
    the main shape from a base one float off 16-byte alignment.  At every
    shape each client's output is bit for bit that of dp_clip_acc (one
    launch a client) on its rows, and the kernel agrees with its twin
    within the DP tolerance; at the main shape it is timed eager and in a
    graph beside its twin, torch.bmm (the library: each client's scales
    (1, B) times its rows) and its bound, and row 13 (one dp_clip_norms
    launch over the C·B rows) is timed beside it.  Returns the rows
    "dp_clip_acc_clients" and "dp_clip_norms@c48"."""
    import torch

    from repro_torch.kernels import dp_clip
    from repro_torch.kernels import ref
    from repro_torch.optim.clip import EPS

    name = "dp_clip_acc_clients"
    shapes = [(1, 8, 384, False, 0, False), (3, 4, 257, False, 0, False),
              (2, 5, 100003, True, 0, False),
              (CLIENTS, BATCH, DP_WIDTH, True, 1, False),
              (CLIENTS, BATCH, DP_WIDTH, False, 0, True)]
    rows = {}
    for i, (C, B, P, zero_row, offset, main) in enumerate(shapes):
        g = dp_rows(device, C * B, P, zero_row, offset, 330 + i).view(C, B, P)
        sq = dp_clip.dp_clip_norms(g.view(C * B, P)).view(C, B)
        clip = float(sq.sqrt().median())
        clipped = int((sq.sqrt() > clip).sum())
        where = (f"({C}, {B}, {P}), C {clip:.4g}, {clipped} of {C * B} rows "
                 f"clipped{', a zero row' if zero_row else ''}"
                 f"{', offset 1' if offset else ''}")
        got = dp_clip.dp_clip_acc_clients(g, sq, clip)
        for c in range(C):
            require(torch.equal(got[c], dp_clip.dp_clip_acc(g[c], sq[c],
                                                            clip)),
                    f"{name} {where}: client {c} not the bits of dp_clip_acc "
                    f"on its rows")

        def lib():
            scale = torch.clamp_max(torch.full_like(sq, clip)
                                    / torch.clamp_min(sq.sqrt(), EPS), 1.0)
            return torch.bmm(scale.view(C, 1, B), g).view(C, P) * (1.0 / B)

        case = (lambda: dp_clip.dp_clip_acc_clients(g, sq, clip),
                lambda: ref.clip_acc_clients(g, sq, clip), lib,
                4 * (C * B * P + C * B + C * P), 2 * C * B * P + 3 * C * B)
        if not main:
            err = max_err(name, case[0](), case[1]())
            print(f"  {name} {where}: max abs err {err:.3e}; each client the "
                  f"bits of dp_clip_acc on its rows")
            continue
        require(0 < clipped < C * B, f"{name}: {clipped} of {C * B} rows "
                f"clipped")
        print(f"  {name} at the spmd DP step's {where}, each client the bits "
              f"of dp_clip_acc on its rows:")
        rows[name] = time_case(name, case, peaks_)
        rows[name].update(old_way_ms=cuda_ms(
            lambda: [dp_clip.dp_clip_acc(g[c], sq[c], clip)
                     for c in range(C)]))
        print(f"  the old way: {C} dp_clip_acc launches, eager "
              f"{rows[name]['old_way_ms']:.4f} ms")
        print(f"  dp_clip_norms over the stacked step's {C * B} rows:")
        rows["dp_clip_norms@c48"] = time_case(
            "dp_clip_norms",
            dp_cases(device, C * B, P, "half", False, 340)[0]["dp_clip_norms"],
            peaks_)
    return rows


def clients_inputs(device, C, M, K, N, r, offset, seed):
    """The client-axis LoRA kernels' inputs: x (C, M, K) and g (C, M, N)
    placed ``offset`` floats into their storage (misaligned for 16-byte
    copies at 1), w (K, N), a (C, K, r), b (C, r, N), and the panels xa
    and gb scaled by M^-0.5 (O(1) outputs)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape, std=1.0, at=0):
        flat = torch.randn(at + math.prod(shape), device=device,
                           generator=gen) * std
        return flat[at:].view(shape)

    x, g = rn(C, M, K, at=offset), rn(C, M, N, at=offset)
    w = rn(K, N, std=K ** -0.5)
    a, b = rn(C, K, r, std=K ** -0.5), rn(C, r, N, std=N ** -0.5)
    xa, gb = (x @ a) * M ** -0.5, (g @ b.transpose(1, 2)) * M ** -0.5
    return x, g, w, a, b, xa, gb


def clients_cases(x, g, w, a, b, xa, gb):
    """Rows 1ᶜ, 2ᶜ and 4ᶜ (both layouts) as {name: (kernel, plain,
    library chain, bytes, flops, the old way: C launches of the
    one-client kernel)}."""
    import torch

    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ref

    C, M, K = x.shape
    N, r = w.shape[1], a.shape[2]
    f4 = 4
    nbytes = f4 * (C * M * K + K * N + C * K * r + C * r * N + C * M * N
                   + C * M * r)
    nflops = 2 * C * M * (K * N + K * r + r * N)
    xt, gt, xat = x.transpose(1, 2), g.transpose(1, 2), xa.transpose(1, 2)
    bt, at_ = b.transpose(1, 2), a.transpose(1, 2)

    def fwd_chain():
        return ((x.reshape(-1, K) @ w).view(C, M, N)
                + torch.bmm(torch.bmm(x, a), b))

    def dx_chain():
        return ((g.reshape(-1, N) @ w.t()).view(C, M, K)
                + torch.bmm(torch.bmm(g, bt), at_))

    def each(fn, *args):
        def old_way():
            return [fn(*(t[c] if t.dim() == 3 else t for t in args))
                    for c in range(C)]
        return old_way

    return {
        "lora_fwd_clients": (lambda: lm.lora_fwd_clients(x, w, a, b),
                             lambda: ref.lora_fwd_clients(x, w, a, b),
                             fwd_chain, nbytes, nflops,
                             each(lm.lora_fwd, x, w, a, b)),
        "lora_dx_clients": (lambda: lm.lora_dx_clients(g, w, a, b),
                            lambda: ref.lora_dx_clients(g, w, a, b),
                            dx_chain, nbytes, nflops,
                            each(lm.lora_dx, g, w, a, b)),
        "lora_panel_clients": (
            lambda: lm.lora_panel_clients(x, gb),
            lambda: ref.panel_grad_clients(x, gb),
            lambda: torch.bmm(xt, gb), f4 * (C * M * K + C * M * r
                                             + C * K * r),
            2 * C * M * K * r, each(lm.lora_panel, x, gb)),
        "lora_panel_clients_t": (
            lambda: lm.lora_panel_clients(g, xa, True),
            lambda: ref.panel_grad_clients(g, xa, True),
            lambda: torch.bmm(xat, g), f4 * (C * M * N + C * M * r
                                             + C * N * r),
            2 * C * M * N * r,
            each(lambda gc, xac: lm.lora_panel(gc, xac, True), g, xa)),
    }


def clients_same_bits(name: str, got, per_client) -> None:
    """Each client's outputs of a client-axis launch are the bits of the
    one-client kernel launched on that client's rows (``per_client``: C
    of its outputs, a tensor or a tuple each)."""
    import torch

    got = _flat(got)
    for c, want in enumerate(per_client):
        for i, (a, b) in enumerate(zip(got, _flat(want))):
            require(torch.equal(a[c], b), f"{name}: output {i} of client "
                    f"{c} differs from the one-client launch in "
                    f"{int((a[c] != b).sum())} of {b.numel()} elements")


def clients_checks(device, peaks_) -> dict:
    """Phase 2's part for rows 1ᶜ, 2ᶜ and 4ᶜ (the spmd backend's stacked
    clients: W shared, A, B and rows per client): at GPT-2's (3, 1280,
    768, 768), RecurrentGemma-2B's (3, 1280, 2560, 2560), RWKV-6's (3,
    1280, 2048, 2048) and C 8 at GPT-2's width, and at the edges (C 1,
    M_c 1279, ranks 1, 13 and 64, a ragged K and N, x and g misaligned),
    each client's outputs bit for bit those of the one-client kernels on
    its rows (the same tiles and summation order) and within the
    tolerance of their plain twins; at the four timed shapes the kernel
    eager and in a CUDA graph beside its twin, the library chain and the
    old way (C launches of the one-client kernel, eager and in a graph).
    Returns the timed rows ("<name>", "<name>@rg", "<name>@rwkv",
    "<name>@c8")."""
    shapes = [(CLIENTS, BATCH * PAD_LEN, 768, 768, RANK, 0, ""),
              (CLIENTS, BATCH * PAD_LEN, 2560, 2560, RANK, 0, "@rg"),
              (CLIENTS, BATCH * PAD_LEN, 2048, 2048, RANK, 0, "@rwkv"),
              (8, BATCH * PAD_LEN, 768, 768, RANK, 0, "@c8"),
              (1, BATCH * PAD_LEN, 768, 768, RANK, 0, None),
              (CLIENTS, 1279, 768, 768, RANK, 0, None),
              (CLIENTS, 333, 768, 768, 1, 0, None),
              (CLIENTS, 333, 2050, 261, 13, 0, None),
              (CLIENTS, 200, 768, 768, 64, 0, None),
              (CLIENTS, BATCH * PAD_LEN, 768, 768, RANK, 1, None)]
    rows = {}
    for i, (C, M, K, N, r, offset, tag) in enumerate(shapes):
        where = f"(C {C}, M_c {M}, K {K}, N {N}, r {r}, offset {offset})"
        cases = clients_cases(*clients_inputs(device, C, M, K, N, r, offset,
                                              230 + i))
        for name, (kern, plain, lib, nbytes, nflops, old) in cases.items():
            clients_same_bits(name, kern(), old())
            if tag is None:
                err = max_err(name, kern(), plain())
                print(f"  {name} {where}: max abs err {err:.3e}; each "
                      f"client bit-identical to the one-client kernel")
                continue
            print(f"  {name} {where}, each client bit-identical to the "
                  f"one-client kernel:")
            row = time_case(name, (kern, plain, lib, nbytes, nflops),
                            peaks_)
            row.update(old_way_ms=cuda_ms(old), old_way_graph_ms=graph_ms(
                old, calls=4))
            print(f"  the old way {where}: {C} launches, eager "
                  f"{row['old_way_ms']:.4f} ms, in a graph "
                  f"{row['old_way_graph_ms']:.4f} ms")
            rows[name + tag] = row
    # the flash and KD kernels once at the stacked batch: BH 3·16·12 heads,
    # 3·64 public rows of KD's b8
    for name, (kern, plain, *_rest) in kernel_cases(
            device, M=64, K=64, N=64, r=RANK, BH=CLIENTS * BATCH * 12,
            BKV=CLIENTS * BATCH * 12, S=PAD_LEN, Skv=PAD_LEN, D=64,
            causal=True, window=0, q_offset=0, seed=240).items():
        if name.startswith("flash_"):
            err = max_err(name, kern(), plain())
            print(f"  {name} at the stacked clients' BH "
                  f"{CLIENTS * BATCH * 12}: max abs err {err:.3e}")
    for name, (kern, plain, *_rest) in kd_cases(
            device, R=CLIENTS * 64, V=77, T=2.0, topk_teacher=True, Rq=150,
            Cq=77, k=8, bits=8, ties=False, seed=241).items():
        if name.startswith("kd_"):
            err = max_err(name, kern(), plain())
            print(f"  {name} at the stacked clients' {CLIENTS * 64} rows: "
                  f"max abs err {err:.3e}")
    return rows


def lora_fp64_errors(device, M, K, N, seed) -> dict:
    """rms error against an fp64 product of the LoRA forward, dx and dW
    kernels, of the panel kernel's dA = xᵀ·gb and dB = xaᵀ·g (transposed
    out), and of the same products through cuBLAS and cuBLASLt, on inputs
    scaled to O(1) outputs (kernel_cases' scaling).  Prints them and each
    kernel's ratio to the default library's; returns {"kernel" | "cublas"
    | "cublaslt": {"fwd" | "dx" | "dw" | "da" | "db": rms}} and the
    default library's name."""
    import torch

    from repro_torch.kernels import lora_matmul as lm

    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape, std=1.0):
        return torch.randn(shape, device=device, generator=gen) * std

    r = RANK
    x, g = rn(M, K), rn(M, N)
    w, a, b = rn(K, N, std=K ** -0.5), rn(K, r, std=K ** -0.5), \
        rn(r, N, std=N ** -0.5)
    gs = g * M ** -0.5
    xa, gb = (x @ a) * M ** -0.5, (g @ b.t()) * M ** -0.5
    x64, g64, w64, a64, b64, gs64, xa64, gb64 = (
        t.double() for t in (x, g, w, a, b, gs, xa, gb))
    exact = {"fwd": x64 @ w64 + (x64 @ a64) @ b64,
             "dx": g64 @ w64.t() + (g64 @ b64.t()) @ a64.t(),
             "dw": x64.t() @ gs64, "da": x64.t() @ gb64,
             "db": xa64.t() @ g64}
    got = {"kernel": {"fwd": lm.lora_fwd(x, w, a, b)[0],
                      "dx": lm.lora_dx(g, w, a, b)[0],
                      "dw": lm.lora_dw(x, gs), "da": lm.lora_panel(x, gb),
                      "db": lm.lora_panel(g, xa, True)}}
    blas = torch.backends.cuda.preferred_blas_library()
    default = "cublaslt" if "lt" in str(blas).lower() else "cublas"
    for lib in ("cublas", "cublaslt"):
        torch.backends.cuda.preferred_blas_library(lib)
        got[lib] = {"fwd": x @ w + (x @ a) @ b,
                    "dx": g @ w.t() + (g @ b.t()) @ a.t(), "dw": x.t() @ gs,
                    "da": x.t() @ gb, "db": xa.t() @ g}
    torch.backends.cuda.preferred_blas_library(blas)
    rms = {who: {op: float(((y.double() - exact[op]) ** 2).mean().sqrt())
                 for op, y in ops_.items()} for who, ops_ in got.items()}
    for op in exact:
        print(f"  LoRA {op} at M {M}, K {K}, N {N}: rms error against fp64 "
              + ", ".join(f"{who} {rms[who][op]:.3e}" for who in rms)
              + f" (kernel / {default} "
              f"{rms['kernel'][op] / rms[default][op]:.2f})")
    del got, exact
    torch.cuda.empty_cache()
    return rms, default


def flash_fp64_errors(device, BH, BKV, S, D, causal, window, seed,
                      Skv=None) -> dict:
    """rms error against an fp64 run of the plain twins of o, lse, dq, dk
    and dv through the flash kernels (forward, then dq and dk/dv from its
    own lse and D = rowsum(do∘o)), through the fp32 twins and through SDPA
    (o, and dq, dk and dv from its backward, dk and dv summed over each
    GQA group; SDPA gives no lse), on kernel_cases' N(0, 1) inputs; S
    queries over ``Skv`` keys (default S; non-causal where they differ).
    Fails unless each kernel error is within FP64_FACTOR times the larger
    of the fp32 twins' and SDPA's; returns {"kernel" | "plain fp32" |
    "sdpa": {output: rms}}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(seed)
    Skv = S if Skv is None else Skv
    q, k, v, do = (torch.randn(shape, device=device, generator=gen)
                   for shape in ((BH, S, D), (BKV, Skv, D), (BKV, Skv, D),
                                 (BH, S, D)))
    cfg = (causal, window, 0)
    G = BH // BKV

    def pipeline(fwd, dq, dkv, *xs):
        o, lse = fwd(*xs[:3], *cfg)
        dd = (xs[3] * o).sum(-1)
        dk, dv = dkv(*xs, lse, dd, *cfg)
        return {"o": o, "lse": lse, "dq": dq(*xs, lse, dd, *cfg), "dk": dk,
                "dv": dv}

    plain = (ref.attention_fwd, ref.attention_dq, ref.attention_dkv)
    exact = pipeline(*plain, *(t.double() for t in (q, k, v, do)))
    got = {"kernel": pipeline(fa.flash_fwd, fa.flash_dq, fa.flash_dkv, q, k,
                              v, do),
           "plain fp32": pipeline(*plain, q, k, v, do)}
    leaves = [q.detach()[None].requires_grad_(True)] + [
        t.repeat_interleave(G, dim=0)[None].requires_grad_(True)
        for t in (k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    dqe, dke, dve = torch.autograd.grad(out, leaves, do[None])
    got["sdpa"] = {"o": out[0].detach(), "dq": dqe[0],
                   "dk": dke[0].view(BKV, G, Skv, D).sum(1),
                   "dv": dve[0].view(BKV, G, Skv, D).sum(1)}
    rms = {who: {name: float(((y.double() - exact[name]) ** 2).mean().sqrt())
                 for name, y in outs.items()} for who, outs in got.items()}
    for name in exact:
        yard = max(rms[who][name] for who in ("plain fp32", "sdpa")
                   if name in rms[who])
        print(f"  flash {name} at BH {BH} over {BKV}, S {S} over {Skv}, D "
              f"{D}: rms "
              f"error against fp64 " + ", ".join(
                  f"{who} {rms[who][name]:.3e}" for who in rms
                  if name in rms[who])
              + f" (kernel / yardstick {rms['kernel'][name] / yard:.2f})")
        require(rms["kernel"][name] <= FP64_FACTOR * yard,
                f"flash {name}: kernel rms error against fp64 "
                f"{rms['kernel'][name]:.3e} exceeds {FP64_FACTOR} times "
                f"{yard:.3e}")
    del got, exact, leaves, out
    torch.cuda.empty_cache()
    return rms


def rglru_cases(device, B, S, W, h0, dh_final, offset, seed):
    """The RG-LRU scan kernels on seeded (B, S, W) inputs, as kernel_cases
    (no PyTorch call computes a linear recurrence, so no library
    yardstick): decays a in (0, 1) as the RG-LRU's gates give them, with
    an initial state ``h0``, and a gradient of h_final (``dh_final``)
    when set (the backward then forms dh0 too).  ``offset`` floats before
    every tensor's start make its rows misaligned for 16-byte loads."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg

    gen = torch.Generator(device=device).manual_seed(seed)

    def place(t):
        flat = torch.empty(offset + t.numel(), device=device)
        out = flat[offset:].view(t.shape)
        out.copy_(t)
        return out

    def rn(*shape):
        return torch.randn(shape, device=device, generator=gen)

    a = place(torch.sigmoid(rn(B, S, W) + 2.0))
    b, dh = place(rn(B, S, W) * 0.1), place(rn(B, S, W))
    s0 = place(rn(B, W)) if h0 else None
    dhf = place(rn(B, W)) if dh_final else None
    h = place(ref.rglru_scan(a, b, s0)[0])
    f4, n, state = 4, B * S * W, B * W
    # the backward reads h0 and dh_final where given and writes dh0
    # when there is an h0
    opt = f4 * state * (2 * int(h0) + int(dh_final))
    return {
        "rglru_fwd": (lambda: rg.rglru_fwd(a, b, s0),
                      lambda: ref.rglru_scan(a, b, s0), None,
                      f4 * (3 * n + state) + f4 * state * int(h0), 2 * n),
        "rglru_bwd": (lambda: rg.rglru_bwd(a, h, s0, dh, dhf, h0),
                      lambda: ref.rglru_scan_bwd(a, h, s0, dh, dhf, h0),
                      None, f4 * 5 * n + opt, 3 * n),
    }


def rwkv_inputs(device, BH, S, D, U, logw, dsf, seed, unit=False):
    """Seeded WKV inputs: r, k, v ~ N(0, 1) (the size the model's
    projections give them), logw "model" (-exp(-4 + 0.5·N(0, 1)), about
    the decay the init gives, -0.018), "zero" (about -1e-4) or "floor"
    (down to the model's -e³, w about 2e-9), u ~ N(0, 0.01) of U rows, dy
    ~ N(0, 1) and, when ``dsf``, dS_final ~ N(0, 1).  With ``unit``, r
    and dy are scaled by D^-0.5 and k, v by S^-0.25, so that every
    output is O(1) whatever S and D: a tolerance then bounds the error
    of fp32 sums over D taken in another order (at the model's sizes y
    is O(50), and two fp32 summation orders differ by up to ~1e-4)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, device=device, generator=gen)

    r, k, v, dy = rn(BH, S, D), rn(BH, S, D), rn(BH, S, D), rn(BH, S, D)
    if unit:
        r, dy = r * D ** -0.5, dy * D ** -0.5
        k, v = k * S ** -0.25, v * S ** -0.25
    z = rn(BH, S, D)
    lw = {"model": -torch.exp(-4.0 + 0.5 * z),
          "zero": -1e-4 * torch.sigmoid(z),
          "floor": -math.exp(3.0) * torch.sigmoid(z + 3.0)}[logw]
    u = rn(U, D) * 0.1
    ds = rn(BH, D, D) if dsf else None
    return r, k, v, lw, u, dy, ds


def rwkv_cases(device, BH, S, D, U, logw, dsf, du, seed, checkpoints=True):
    """The WKV kernels on seeded (BH, S, D) inputs (rwkv_inputs, O(1)
    outputs), as
    kernel_cases (no PyTorch call computes the recurrence, so no library
    yardstick).  The forward writes checkpoints, as in a train step; its
    outputs are compared as (y, S_final), S_final bit for bit (without
    ``checkpoints`` it writes none, as in an eval batch).  The backward
    takes the forward's checkpoints and dS_final when ``dsf``, forms
    dlogw, and du when ``du``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rw

    r, k, v, lw, u, dy, ds = rwkv_inputs(device, BH, S, D, U, logw, dsf,
                                         seed, unit=True)
    ckpt = rw.rwkv6_fwd(r, k, v, lw, u, checkpoints=True)[2]
    f4, n, state = 4, BH * S * D, BH * D * D
    n_ck = BH * -(-S // rw.BT) * D * D
    return {
        "rwkv6_fwd": (lambda: rw.rwkv6_fwd(r, k, v, lw, u,
                                           checkpoints)[:2],
                      lambda: ref.rwkv6_scan(r, k, v, lw, u), None,
                      f4 * (5 * n + U * D + state + int(checkpoints) * n_ck),
                      BH * S * (5 * D * D + 5 * D)),
        "rwkv6_bwd": (lambda: rw.rwkv6_bwd(r, k, v, lw, u, ckpt, dy, ds,
                                           True, du),
                      lambda: ref.rwkv6_scan_bwd(r, k, v, lw, u, dy, ds,
                                                 True, du), None,
                      f4 * (9 * n + U * D + n_ck + int(dsf) * state
                            + int(du) * U * D),
                      BH * S * (14 * D * D + 8 * D)),
    }


def rwkv_checkpoints_exact(device, BH, S, D, seed) -> None:
    """Each checkpoint the forward writes is the plain version's state
    before that step, bit for bit."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rw

    r, k, v, lw, u, _, _ = rwkv_inputs(device, BH, S, D, 1, "model", False,
                                       seed)
    ckpt = rw.rwkv6_fwd(r, k, v, lw, u, checkpoints=True)[2]
    for c in range(ckpt.shape[1]):
        t = c * rw.BT
        want = torch.zeros_like(ckpt[:, 0]) if t == 0 else ref.rwkv6_scan(
            r[:, :t], k[:, :t], v[:, :t], lw[:, :t], u)[1]
        require(torch.equal(ckpt[:, c], want),
                f"rwkv6_fwd checkpoint {c} is not the plain state before "
                f"step {t}")


def rwkv_fp64_errors(device, BH, S, D, U, seed) -> dict:
    """Max abs error against an fp64 run of the plain version, for the
    kernels and for the fp32 plain version, at one shape and the model's
    sizes of r, k, v and dy; fails unless each kernel output is within
    twice the fp32 plain version's error."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rw

    r, k, v, lw, u, dy, _ = rwkv_inputs(device, BH, S, D, U, "model", False,
                                        seed)
    x64 = [t.double() for t in (r, k, v, lw, u, dy)]
    y, sf, ckpt = rw.rwkv6_fwd(r, k, v, lw, u, checkpoints=True)
    outs = {"kernel": (y, sf) + rw.rwkv6_bwd(r, k, v, lw, u, ckpt, dy)[:4],
            "plain fp32": ref.rwkv6_scan(r, k, v, lw, u)
            + ref.rwkv6_scan_bwd(r, k, v, lw, u, dy)[:4]}
    exact = ref.rwkv6_scan(*x64[:5]) + ref.rwkv6_scan_bwd(*x64)[:4]
    names = ("y", "S_final", "dr", "dk", "dv", "dlogw")
    errs = {tag: [float((a.double() - b).abs().max())
                  for a, b in zip(got, exact)] for tag, got in outs.items()}
    for i, name in enumerate(names):
        print(f"  rwkv6 vs fp64 at ({BH}, {S}, {D}): {name} kernel "
              f"{errs['kernel'][i]:.3e}, plain fp32 "
              f"{errs['plain fp32'][i]:.3e}")
        require(errs["kernel"][i] <= 2.0 * errs["plain fp32"][i],
                f"rwkv6 {name}: kernel error against fp64 "
                f"{errs['kernel'][i]:.3e} exceeds twice the plain fp32 "
                f"version's {errs['plain fp32'][i]:.3e}")
    del outs, exact, x64
    torch.cuda.empty_cache()
    return errs


def kd_inputs(device, R, V, topk_teacher, offset, gen):
    """Teacher and student (R, V) logits ~ 3 N(0, 1) (when
    ``topk_teacher``, the teacher the server distills from: the mean of
    three uploads after top-k 8 with int8, whose rows peak near the fill
    value where the supports differ), and an upstream gradient g (R,) ~
    N(0, 1); with ``offset``, the teacher starts that many floats past a
    16-byte boundary (the student does not)."""
    import torch

    from repro_torch.core import compression
    from repro_torch.kernels import ops

    def rn(*shape):
        return torch.randn(shape, device=device, generator=gen) * 3.0

    t, s, g = rn(R, V), rn(R, V), rn(R) / 3.0
    if topk_teacher:
        with ops.policy_scope("torch"):         # inputs: the plain path
            t = sum(compression.topk_dequantize(
                compression.topk_quantize(x, 8, 8)[0])
                for x in (t, rn(R, V), rn(R, V))) / 3
    if offset:
        t = torch.empty(R * V + offset, device=device)[offset:].view(
            R, V).copy_(t)
    return t, s, g


def kd_lib_rows(t, s, T):
    """The library's per-row KD loss: F.kl_div of the log-softmaxes."""
    import torch.nn.functional as F
    return F.kl_div(F.log_softmax(s / T, -1), F.log_softmax(t / T, -1),
                    log_target=True, reduction="none").sum(-1) * T * T


def kd_cases(device, R, V, T, topk_teacher, Rq, Cq, k, bits, ties, seed,
             offset=0):
    """KD-loss and top-k cases, as kernel_cases: the KD loss on (R, V)
    logits at temperature T (kd_inputs), top-k quantization on (Rq, Cq)
    (values rounded to integers, so with many ties, when ``ties``)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    t, s, g = kd_inputs(device, R, V, topk_teacher, offset, gen)
    x = torch.randn((Rq, Cq), device=device, generator=gen) * 3.0
    if ties:
        x = torch.round(x)
    return kd_cases_on(t, s, g, T, x, k, bits)


def kd_cases_on(t, s, g, T, x, k, bits):
    """kd_cases on given tensors: the KD loss on teacher ``t`` and student
    ``s`` (R, V) at temperature T with the upstream gradient ``g`` (R,),
    top-k quantization of ``x`` at ``k`` and ``bits``."""
    import torch

    from repro_torch.kernels import kd_loss as kdl
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref

    R, V = t.shape
    Rq, Cq = x.shape
    rows, stats = ref.kd_loss_fwd(t, s, T)
    # the backward kernel rebuilds t/T as t * (1/T) and its twin as t / T:
    # where 1/T is inexact (T not a power of two) each is fed its own
    # forward's statistics, as KDLoss feeds it.  Fed the other's, it would
    # rebuild p from a maximum one rounding apart, which at a teacher row
    # near the top-k fill value (t/T ~ -2e8, fp32 spacing 16) is a factor
    # of e^16 in p
    kstats = stats if math.frexp(T)[0] == 0.5 else kdl.kd_fwd(t, s, T)[1]
    f4, RV = 4, R * V
    lib_t = t.detach().clone().requires_grad_(True)
    lib_s = s.detach().clone().requires_grad_(True)

    # the library's forward is recorded on a stream of its own, where
    # autograd then runs its backward: a CUDA graph can capture that
    # backward on the same stream (graph_ms)
    device = t.device
    lib_stream = torch.cuda.Stream(device)
    lib_stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(lib_stream):
        lib_out = kd_lib_rows(lib_t, lib_s, T)
        lib_out_s = kd_lib_rows(t, lib_s, T)
    torch.cuda.current_stream(device).wait_stream(lib_stream)

    def lib_bwd():
        return torch.autograd.grad(lib_out_s, lib_s, g, retain_graph=True)

    def lib_bwd_dt():
        return torch.autograd.grad(lib_out, (lib_t, lib_s), g,
                                   retain_graph=True)

    lib_bwd.capture_stream = lib_bwd_dt.capture_stream = lib_stream
    qmax = float((1 << (bits - 1)) - 1)

    def lib_topk():
        v, i = torch.topk(x, k, dim=-1)
        sc = torch.clamp_min(v.abs().amax(-1, keepdim=True) / qmax, 1e-12)
        return torch.clamp(torch.round(v / sc), -qmax, qmax).to(
            torch.int8), i, sc

    return {
        "kd_fwd": (lambda: kdl.kd_fwd(t, s, T),
                   lambda: ref.kd_loss_fwd(t, s, T),
                   lambda: kd_lib_rows(t, s, T),
                   2 * f4 * RV + 6 * f4 * R, 12 * RV),
        "kd_bwd": (lambda: kdl.kd_bwd(t, s, kstats, g, T, need_dt=False),
                   lambda: ref.kd_loss_bwd(t, s, stats, g, T, need_dt=False),
                   lib_bwd, 3 * f4 * RV + 6 * f4 * R, 10 * RV),
        "kd_bwd_dt": (lambda: kdl.kd_bwd(t, s, kstats, g, T),
                      lambda: ref.kd_loss_bwd(t, s, stats, g, T),
                      lib_bwd_dt, 4 * f4 * RV + 6 * f4 * R, 16 * RV),
        "topk_quantize": (lambda: qz.topk_quantize(x, k, bits),
                          lambda: ref.topk_quantize_rows_ref(x, k, bits),
                          lib_topk, f4 * Rq * Cq + 5 * Rq * k + f4 * Rq,
                          Rq * Cq),
    }


def kd_fp64_errors(device, R, V, T, topk_teacher, seed) -> float:
    """rms error of row 8's rows against the same rows in fp64 (log-softmax
    of t/T and s/T in float64), beside F.kl_div's in fp32 on the same
    inputs (kd_inputs); fails unless the kernel's is within FP64_FACTOR
    times the library's.  Prints both; returns their ratio."""
    import torch

    from repro_torch.kernels import kd_loss as kdl

    gen = torch.Generator(device=device).manual_seed(seed)
    t, s, _ = kd_inputs(device, R, V, topk_teacher, 0, gen)
    lp = torch.log_softmax(t.double() / T, -1)
    lq = torch.log_softmax(s.double() / T, -1)
    exact = (lp.exp() * (lp - lq)).sum(-1) * T * T
    rms = {who: float(((y.double() - exact) ** 2).mean().sqrt())
           for who, y in (("kernel", kdl.kd_fwd(t, s, T)[0]),
                          ("F.kl_div", kd_lib_rows(t, s, T)))}
    ratio = rms["kernel"] / rms["F.kl_div"]
    print(f"  kd_fwd rows at ({R}, {V}), T {T}: rms error against fp64 "
          f"kernel {rms['kernel']:.3e}, F.kl_div {rms['F.kl_div']:.3e} "
          f"(kernel / F.kl_div {ratio:.2f}, limit {FP64_FACTOR})")
    require(rms["kernel"] <= FP64_FACTOR * rms["F.kl_div"],
            f"kd_fwd at ({R}, {V}): rms error against fp64 "
            f"{rms['kernel']:.3e} exceeds {FP64_FACTOR} times F.kl_div's "
            f"{rms['F.kl_div']:.3e}")
    return ratio


def topk_wide_cases(device, seed) -> None:
    """The top-k kernel's long-row path (radix selection) bit for bit
    against its plain version: the generative shape with integer values
    (ties at the threshold) and +0.0 / -0.0 entries, a row too long to
    stage in shared memory, and the shortest long row at the largest k,
    with -inf and -1e30 entries."""
    import torch

    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(seed)
    for R, C, k, bits in ((1280, 50257, 64, 8), (3, 100003, 64, 8),
                          (6, 2049, 512, 4)):
        x = torch.round(torch.randn((R, C), device=device, generator=gen)
                        * 3.0)
        x[:, ::7] = 0.0
        x[:, 3::7] = -0.0
        if C == 2049:
            x[:, 5::11] = -math.inf
            x[:, 6::11] = -1e30
        err = max_err("topk_quantize", qz.topk_quantize(x, k, bits),
                      ref.topk_quantize_rows_ref(x, k, bits))
        print(f"  topk_quantize ({R}, {C}), k {k}, int{bits}, integer "
              f"values (ties at the threshold), +0.0 / -0.0 entries: max "
              f"abs err {err:.3e}, bit-identical")


# the rows that nonfinite_rows makes non-finite, in order
NONFINITE_ROWS = ("one NaN", "all NaN", "one +inf", "one -inf", "all -inf",
                  "NaN, +inf and -inf")


def nonfinite_rows(device, R, C, seed):
    """Seeded (R, C) rows whose first len(NONFINITE_ROWS) rows hold what
    NONFINITE_ROWS names, at seeded columns; the rest are finite."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((R, C), device=device, generator=gen) * 3.0
    c0, c1, c2 = torch.randperm(C, generator=gen, device=device)[:3].tolist()
    x[0, c0] = math.nan
    x[1] = math.nan
    x[2, c0] = math.inf
    x[3, c1] = -math.inf
    x[4] = -math.inf
    x[5, c0], x[5, c1], x[5, c2] = math.nan, math.inf, -math.inf
    return x


def dequantized(name: str, out):
    """A quantizer's outputs as the values they stand for: the
    roundtrip's y, else its levels (the pack's nibbles unpacked) times
    the row's scale."""
    from repro_torch.core import compression
    if name.startswith("quant_roundtrip"):
        return out[0]
    q, scale = out[0], out[-1]
    if name == "quantize_pack4":
        q = compression.unpack_int4(q, 2 * q.shape[1])
    return q.float() * scale


def nonfinite_agree(name: str, got, want, n_bad: int) -> int:
    """Holds a quantizer's outputs (``got``, the scale last) to its twin's
    (``want``) on rows whose first ``n_bad`` are non-finite: the rows
    after them bit for bit (max_err), and on the first ``n_bad`` the
    scale (NaN as NaN), the places where the dequantized row is not
    finite and, for top-k, the indices.  Returns how many levels of the
    non-finite rows differ, which is not gated (a NaN level's integer is
    the conversion's)."""
    import torch
    max_err(name, [o[n_bad:] for o in got], [w[n_bad:] for w in want])
    gs, ws = got[-1][:n_bad], want[-1][:n_bad]
    same = (gs == ws) | (torch.isnan(gs) & torch.isnan(ws))
    require(bool(same.all()), f"{name}: scales of non-finite rows "
            f"{gs.flatten().tolist()} vs its twin's {ws.flatten().tolist()}")
    dg = ~torch.isfinite(dequantized(name, got)[:n_bad])
    dw = ~torch.isfinite(dequantized(name, want)[:n_bad])
    require(torch.equal(dg, dw), f"{name}: the dequantized non-finite rows "
            f"are not finite in {int(dg.sum())} places, the twin's in "
            f"{int(dw.sum())}, {int((dg != dw).sum())} apart")
    if name == "topk_quantize":
        require(torch.equal(got[1][:n_bad], want[1][:n_bad]),
                f"{name}: the indices of non-finite rows are not the "
                f"twin's")
    if name.startswith("quant_roundtrip"):
        return 0
    return int((got[0][:n_bad] != want[0][:n_bad]).sum())


def nonfinite_checks(device) -> None:
    """Rows 10, 11 and 12 against their twins on rows with a NaN, all NaN,
    +inf, -inf, all -inf and all three (nonfinite_rows) beside finite
    rows (nonfinite_agree): the levels and the roundtrip at int8 and int4
    and the int4 pack at (150, 77), (1280, 768), C 2048 and 2049; the
    top-k at (150, 77) k 8, (1280, 768) k 8, C 2048 (the last one-warp
    row) and 2049 (radix) at k 64, and the generative shape (1280, 50257)
    k 64."""
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref

    n_bad = len(NONFINITE_ROWS)
    shapes = ((150, 77, 8), (BATCH * PAD_LEN, 768, 8), (16, 2048, 64),
              (16, 2049, 64), (BATCH * PAD_LEN, 50257, 64))
    for i, (R, C, k) in enumerate(shapes):
        x = nonfinite_rows(device, R, C, 700 + i)
        cases = {"topk_quantize": (lambda: qz.topk_quantize(x, k, 8),
                                   lambda: ref.topk_quantize_rows_ref(x, k,
                                                                      8))}
        if C != 50257:
            for bits, tag in ((8, ""), (4, "_int4")):
                cases["quantize_rows" + tag] = (
                    lambda b=bits: qz.quantize_rows(x, b),
                    lambda b=bits: ref.quantize_rows_ref(x, b))
                cases["quant_roundtrip_rows" + tag] = (
                    lambda b=bits: qz.quant_roundtrip_rows(x, b,
                                                           with_scale=True),
                    lambda b=bits: ref.quant_roundtrip_rows_ref(x, b))
            if C % 2 == 0:
                cases["quantize_pack4"] = (
                    lambda: qz.quantize_pack4(x),
                    lambda: ref.quantize_pack4_rows_ref(x))
        for name, (kern, plain) in cases.items():
            differ = nonfinite_agree(name, kern(), plain(), n_bad)
            print(f"  {name} ({R}, {C}){f' k {k}' if 'topk' in name else ''}"
                  f": rows with {', '.join(NONFINITE_ROWS)}: scale (NaN as "
                  f"NaN), non-finite places"
                  f"{' and indices' if 'topk' in name else ''} as the "
                  f"twin's, finite rows bit-identical; levels of the "
                  f"non-finite rows that differ (not gated): {differ}")


def dp_rows(device, B, P, zero_row, offset, seed):
    """(B, P) per-example gradients whose row norms spread over 0.5-1.5x,
    row 3 all zeros when ``zero_row``, placed ``offset`` floats into their
    storage (misaligned for 16-byte loads at 1)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(offset + B * P, device=device, generator=gen)
    g = flat[offset:].view(B, P)
    g *= torch.linspace(0.5, 1.5, B, device=device)[:, None]
    if zero_row:
        g[3] = 0.0
    return g


def dp_cases(device, B, P, clip, zero_row, seed, offset=0):
    """The two DP clip kernels on dp_rows' (B, P) gradients, with the clip
    C at ``clip``: "half" (the median row norm: half the rows clip), "all"
    (half the smallest norm) or "none" (twice the largest).  Returns
    (cases as kernel_cases, C, rows clipped)."""
    import torch

    from repro_torch.kernels import dp_clip
    from repro_torch.kernels import ref
    from repro_torch.optim.clip import EPS

    g = dp_rows(device, B, P, zero_row, offset, seed)
    sq = ref.clip_norms_ref(g)
    norms = sq.sqrt()
    C = {"half": float(norms.median()), "all": float(norms.min()) / 2,
         "none": float(norms.max()) * 2}[clip]
    if zero_row and clip == "all":
        C = float(norms[norms > 0].min()) / 2
    clipped = int((norms > C).sum())

    def lib_acc():
        scale = torch.clamp_max(
            torch.full_like(sq, C) / torch.clamp_min(sq.sqrt(), EPS), 1.0)
        return (scale @ g) * (1.0 / B)

    f4 = 4
    return {
        "dp_clip_norms": (lambda: dp_clip.dp_clip_norms(g),
                          lambda: ref.clip_norms_ref(g),
                          lambda: torch.linalg.vector_norm(g, dim=1),
                          f4 * (B * P + B), 2 * B * P),
        "dp_clip_acc": (lambda: dp_clip.dp_clip_acc(g, sq, C),
                        lambda: ref.clip_acc_ref(g, sq, C), lib_acc,
                        f4 * (B * P + B + P), 2 * B * P + 3 * B),
    }, C, clipped


def dp_norm_fp64_errors(device, seed) -> dict:
    """rms error of the row norms at the main path's (BATCH, DP_WIDTH)
    against an fp64 sqrt(sum(g·g)), through the norm kernel, its fp32 twin
    (both as sqrt of the squared norm, taken in fp64) and ``vector_norm``;
    compared as norms so that no side pays for a squaring.  Fails unless
    the kernel's is within FP64_FACTOR times the larger of the twin's and
    vector_norm's."""
    import torch

    from repro_torch.kernels import dp_clip
    from repro_torch.kernels import ref

    g = dp_rows(device, BATCH, DP_WIDTH, False, 0, seed)
    exact = (g.double() ** 2).sum(1).sqrt()
    got = {"kernel": dp_clip.dp_clip_norms(g).double().sqrt(),
           "plain fp32": ref.clip_norms_ref(g).double().sqrt(),
           "vector_norm": torch.linalg.vector_norm(g, dim=1).double()}
    rms = {who: float(((v - exact) ** 2).mean().sqrt())
           for who, v in got.items()}
    yard = max(rms["plain fp32"], rms["vector_norm"])
    print(f"  dp_clip_norms at ({BATCH}, {DP_WIDTH}): rms error of the norms "
          f"against fp64 " + ", ".join(f"{k} {v:.3e}" for k, v in rms.items())
          + f" (kernel / the larger of the others {rms['kernel'] / yard:.2f})")
    require(rms["kernel"] <= FP64_FACTOR * yard,
            f"dp_clip_norms: rms error against fp64 {rms['kernel']:.3e} "
            f"exceeds {FP64_FACTOR} times {yard:.3e}")
    return rms


def launch_floor(device) -> dict:
    """The least time any launch takes: an empty kernel (csrc/floor.cu)
    timed eager, as one launch among 20 in a CUDA graph, and as a graph of
    its own (a bare graph launch, replayed 50 times back to back)."""
    import ctypes

    from repro_torch.kernels import build

    lib = build.load("floor")
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int

    def empty():
        build.check(lib.empty_launch(build.stream(device)), "empty_launch")

    floor = {"eager_ms": cuda_ms(empty), "graph_ms": graph_ms(empty),
             "graph_launch_ms": graph_ms(empty, calls=1, replays=50)}
    print(f"  launch floor: an empty kernel eager {floor['eager_ms']:.4f} ms, "
          f"in a CUDA graph {floor['graph_ms']:.4f} ms a launch, a bare graph "
          f"launch (one empty kernel a graph) {floor['graph_launch_ms']:.4f} "
          f"ms")
    return floor


def same_bits_repeated(name: str, call) -> None:
    """``call()``'s outputs (a tensor or a list of them) are the same bits
    on a second eager call and on two replays of one CUDA graph that
    captured it."""
    import torch

    first, second = _flat(call()), _flat(call())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _flat(call())
    graph.replay()
    one = [t.clone() for t in out]
    graph.replay()
    two = [t.clone() for t in out]
    for what, got in (("a second eager call", second), ("graph replay 1", one),
                      ("graph replay 2", two)):
        for i, (a, b) in enumerate(zip(first, got)):
            require(torch.equal(a, b), f"{name}: output {i} of {what} "
                    f"differs from the first call in {int((a != b).sum())} "
                    f"of {a.numel()} elements")


def dp_norms_repeat(device, seed) -> None:
    """The norm kernel's bits hold over calls and graph replays at the main
    path's shape."""
    from repro_torch.kernels import dp_clip

    g = dp_rows(device, BATCH, DP_WIDTH, False, 0, seed)
    same_bits_repeated("dp_clip_norms", lambda: dp_clip.dp_clip_norms(g))
    print(f"  dp_clip_norms at ({BATCH}, {DP_WIDTH}): two eager calls and two "
          f"CUDA-graph replays bit-identical")


def quant_cases(device, R, C, special, offset, seed):
    """The per-row quantizers on seeded (R, C) rows, as kernel_cases: the
    one-pass roundtrip's y at int8 and int4 (its library the eager chain
    of quantize and dequantize), int8 and int4 levels, and (C even) the
    int4 pack.  With ``special``, row 1
    is all zeros and rows 2 and 3 hold exact half levels (absmax 127 and
    7, so the scale is exactly 1 at bits 8 and 4; +-0.5, 1.5, 2.5 round
    half to even to 0, +-2, +-2).  ``offset`` floats before the first row
    make its start misaligned for 16-byte loads."""
    import torch

    from repro_torch.core import compression
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(offset + R * C, device=device, generator=gen) * 3.0
    x = flat[offset:].view(R, C)
    if special:
        halves = torch.tensor([0.5, -0.5, 1.5, -1.5, 2.5, -2.5],
                              device=device)
        x[1:4] = 0.0
        x[2, 0], x[3, 0] = 127.0, 7.0
        x[2, 1:7] = x[3, 1:7] = halves

    def lib(bits):
        qmax = float((1 << (bits - 1)) - 1)
        sc = torch.clamp_min(x.abs().amax(-1, keepdim=True) / qmax, 1e-12)
        return torch.clamp(torch.round(x / sc), -qmax, qmax).to(
            torch.int8), sc

    def lib_pack4():
        q, sc = lib(4)
        return compression.pack_int4(q), sc

    def lib_roundtrip(bits):
        q, sc = lib(bits)
        return q.float() * sc

    f4 = 4
    cases = {
        "quant_roundtrip_rows": (lambda: qz.quant_roundtrip_rows(x, 8),
                                 lambda: ref.quant_roundtrip_rows_ref(x, 8)[0],
                                 lambda: lib_roundtrip(8), 2 * f4 * R * C,
                                 3 * R * C),
        "quant_roundtrip_rows_int4": (
            lambda: qz.quant_roundtrip_rows(x, 4),
            lambda: ref.quant_roundtrip_rows_ref(x, 4)[0],
            lambda: lib_roundtrip(4), 2 * f4 * R * C, 3 * R * C),
        "quantize_rows": (lambda: qz.quantize_rows(x, 8),
                          lambda: ref.quantize_rows_ref(x, 8),
                          lambda: lib(8), f4 * R * C + R * C + f4 * R,
                          2 * R * C),
        "quantize_rows_int4": (lambda: qz.quantize_rows(x, 4),
                               lambda: ref.quantize_rows_ref(x, 4),
                               lambda: lib(4), f4 * R * C + R * C + f4 * R,
                               2 * R * C),
    }
    if C % 2 == 0:
        cases["quantize_pack4"] = (
            lambda: qz.quantize_pack4(x),
            lambda: ref.quantize_pack4_rows_ref(x), lib_pack4,
            f4 * R * C + R * C // 2 + f4 * R, 2 * R * C)
    return cases


def roundtrip_checks(device, peaks_) -> dict:
    """Phase 2's part for the Split boundary's one-pass roundtrip
    (quant_roundtrip_rows): at (1280, 768), int8 and int4, and at the next
    Split paths' widths (1280, 2560) and (1280, 2048), with a row of
    zeros, half levels, +-0 and levels that round to -0, its y and scale
    bit for bit its twin's (as integers: the sign of a zero counts), with
    and without the scale asked for; timed eager and in a graph beside
    its twin, the eager torch chain of quantize and dequantize (the
    library), the old way (quantize_rows, then q.float() and * scale) and
    its bound; and at the encoder-decoder Split boundary's (24000, 512).
    Returns the timed rows ("quant_roundtrip_rows", "..._int4", "...@rg",
    "...@rwkv", "...@wh")."""
    import torch

    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref

    rows = {}
    for R, C, tag in ((BATCH * PAD_LEN, 768, ""),
                      (BATCH * PAD_LEN, 2560, "@rg"),
                      (BATCH * PAD_LEN, 2048, "@rwkv"),
                      (BATCH * WH_FRAMES, 512, "@wh")):
        gen = torch.Generator(device=device).manual_seed(270 + C)
        x = torch.randn((R, C), device=device, generator=gen) * 3.0
        x[1:3] = 0.0
        x[2, 0] = 7.0
        x[2, 1:7] = torch.tensor([0.5, -0.5, 0.0, -0.0, -0.01, -1e-30],
                                 device=device)
        for bits in ((8, 4) if C == 768 else (8,)):
            name = "quant_roundtrip_rows" + ("_int4" if bits == 4 else "")
            max_err(name, qz.quant_roundtrip_rows(x, bits, with_scale=True),
                    ref.quant_roundtrip_rows_ref(x, bits))
            print(f"  {name} ({R}, {C}), zeros, half levels, +-0: y and "
                  f"scale bit-identical (as integers)")
            qmax = float((1 << (bits - 1)) - 1)

            def lib(bits=bits, qmax=qmax):
                sc = torch.clamp_min(x.abs().amax(-1, keepdim=True) / qmax,
                                     1e-12)
                q = torch.clamp(torch.round(x / sc), -qmax, qmax)
                return q.to(torch.int8).float() * sc

            def old(bits=bits):
                q, scale = qz.quantize_rows(x, bits)
                return q.float() * scale

            row = time_case(name, (
                lambda bits=bits: qz.quant_roundtrip_rows(x, bits),
                lambda bits=bits: ref.quant_roundtrip_rows_ref(x, bits)[0],
                lib, 8 * R * C, 3 * R * C), peaks_)
            row.update(old_way_ms=cuda_ms(old), old_way_graph_ms=graph_ms(
                old))
            print(f"  the old way ({R}, {C}) int{bits}: quantize_rows, "
                  f"q.float(), * scale: eager {row['old_way_ms']:.4f} ms, in "
                  f"a graph {row['old_way_graph_ms']:.4f} ms")
            rows[name + tag] = row
    return rows


def kernel_bound(name, nbytes, nflops, peaks_) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of its bytes over the memory rate and its operations over the fp32
    rate, or a third of the TF32 tensor-core rate for the 3xTF32 kernels
    (TF32X3; their fp32-rate bound beside it as ``bound_fp32_ms``)."""
    fp32_peak, bytes_peak, tf32_peak = peaks_
    flops_peak = tf32_peak / 3 if name in TF32X3 else fp32_peak
    t_bytes, t_ops = nbytes / bytes_peak, nflops / flops_peak
    out = {"bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if name in TF32X3:
        out["bound_fp32_ms"] = max(t_bytes, nflops / fp32_peak) * 1e3
    return out


def time_case(name, case, peaks_) -> dict:
    """Checks one case and times its kernel, plain and library versions."""
    kern, plain, lib, nbytes, nflops = case
    err = max_err(name, kern(), plain())
    row = {"max_abs_err": err, "ms": cuda_ms(kern),
           "plain_ms": cuda_ms(plain),
           "library_ms": cuda_ms(lib) if lib is not None else None}
    if name in GRAPH_TIMED:
        row["graph_ms"] = graph_ms(kern)
        row["library_graph_ms"] = graph_ms(lib) if lib is not None else None
    if name in COLD_TIMED:
        row["cold_ms"] = cold_graph_ms(kern)
    row.update(kernel_bound(name, nbytes, nflops, peaks_), bytes=nbytes,
               flops=nflops)
    lib_ms = "n/a" if row["library_ms"] is None \
        else f"{row['library_ms']:.4f}"
    atol, rtol = tolerance(name)
    tol = "bit-identical" if name in EXACT else f"atol {atol}, rtol {rtol}"
    if name in EXACT_OUTPUTS:
        tol += f"; outputs {EXACT_OUTPUTS[name]} bit-identical"
    graph = ""
    if "graph_ms" in row:
        lib_graph = row["library_graph_ms"]
        graph = (f" (graph_ms {row['graph_ms']:.4f}, library "
                 + ("n/a" if lib_graph is None else f"{lib_graph:.4f}") + ")")
    if "bound_fp32_ms" in row:
        graph += (f" (3xTF32 on the tensor cores; bound at the fp32 rate "
                  f"{row['bound_fp32_ms']:.4g})")
    if "cold_ms" in row:
        graph += f" (cold L2 {row['cold_ms']:.4f})"
    print(f"  {name}: max abs err {err:.3e} ({tol}) "
          f"kernel_ms {row['ms']:.4f}{graph} plain_ms {row['plain_ms']:.4f} "
          f"library_ms {lib_ms} bound_ms {row['bound_ms']:.4g} "
          f"({row['bound_by']})")
    return row


def check_rwkv_kernels(device, peaks_) -> dict:
    """Phase 2's RWKV-6 part: the LoRA kernels at its projection shape
    (rows "<name>@rwkv") and the WKV kernels (rows "rwkv6_fwd" and
    "rwkv6_bwd" at the train step's shape)."""
    rows = {}
    print(f"  LoRA kernels at RWKV-6 1.6B's time-mix shape (M "
          f"{BATCH * PAD_LEN}, K = N = 2048):")
    for name, case in kernel_cases(device, seed=16, **RWKV_SHAPES).items():
        if name.startswith("lora_"):
            rows[f"{name}@rwkv"] = time_case(name, case, peaks_)
    # RWKV-6 WKV: the eval batch's shape (no checkpoints: forward only),
    # a ragged S, one step, head dims 16 and 32, log-decays near 0 and
    # down to the floor -e³, a nonzero dS_final, du asked for
    H = RWKV_HEADS
    rwkv_checks = [dict(BH=64 * H, S=PAD_LEN, D=64, U=H, logw="model",
                        dsf=False, du=False, checkpoints=False),
                   dict(BH=24, S=37, D=64, U=8, logw="zero", dsf=True,
                        du=True),
                   dict(BH=10, S=1, D=64, U=5, logw="floor", dsf=True,
                        du=True),
                   dict(BH=12, S=37, D=16, U=4, logw="floor", dsf=True,
                        du=True),
                   dict(BH=12, S=45, D=32, U=3, logw="model", dsf=False,
                        du=True),
                   dict(BH=BATCH * H, S=PAD_LEN, D=64, U=H, logw="floor",
                        dsf=True, du=True)]
    for i, shape in enumerate(rwkv_checks):
        cases = rwkv_cases(device, seed=600 + i, **shape)
        if not shape.get("checkpoints", True):
            del cases["rwkv6_bwd"]
        for name, (kern, plain, *_rest) in cases.items():
            err = max_err(name, kern(), plain())
            exact = ", S_final bit-identical" if name == "rwkv6_fwd" else ""
            print(f"  rwkv6 shape {i} {name} ({shape['BH']}, {shape['S']}, "
                  f"{shape['D']}), U {shape['U']}, logw {shape['logw']}, "
                  f"dS_final {shape['dsf']}, du {shape['du']}: max abs err "
                  f"{err:.3e}{exact}")
    rwkv_checkpoints_exact(device, 8, 37, 64, 610)
    print("  rwkv6_fwd checkpoints bit-identical to the plain states")
    print(f"  RWKV-6 WKV kernels at the train step's shape ({BATCH * H}, "
          f"{PAD_LEN}, 64), u (32, 64), checkpoints, dlogw, no dS_final, "
          f"no du:")
    for name, case in rwkv_cases(device, BATCH * H, PAD_LEN, 64, H, "model",
                                 False, False, 14).items():
        rows[name] = time_case(name, case, peaks_)
    rwkv_fp64_errors(device, BATCH * H, PAD_LEN, 64, H, 15)
    rwkv_bwd_repeat(device, 17)
    return rows


def kd_checks(device, peaks_) -> dict:
    """Phase 2's KD part: rows 8, 9 and 12 against their twins at the
    shapes below (row 9 bit for bit where 1/T is exact), then timed at the
    main path's shapes (rows "kd_fwd", "kd_bwd", "kd_bwd_dt",
    "topk_quantize") and at the generative vocabulary ("<name>@generative"),
    with row 8's rms error against fp64 beside F.kl_div's
    (kd_fp64_errors; ``fp64_rms_ratio``)."""
    from repro_torch.kernels import kd_loss as kdl

    rows = {}
    # the main path's server batches (64 and 22 public rows of 77 class
    # logits) and its b3 upload (150 x 77, top-k 8); the forward's narrow
    # instances (1 to 32 values a lane: V 1, 31, 33, 1001 and the
    # crossover NARROW_MAX) and one above it, where the wide kernel takes
    # over; a temperature whose reciprocal is inexact (1.5), one row and
    # ragged R; wide rows that start unaligned (odd V: a scalar head and
    # tail around the float4 body) and a teacher off the student's
    # alignment (scalar loads); a top-k teacher at the generative
    # vocabulary
    kd_main = dict(R=64, V=77, T=2.0, topk_teacher=True, Rq=150, Cq=77, k=8,
                   bits=8, ties=False)
    cross = kdl.narrow_max()
    shapes = [dict(R=22, V=77, T=2.0, topk_teacher=False, Rq=150, Cq=77, k=8,
                   bits=4, ties=False),
              dict(R=37, V=1001, T=1.0, topk_teacher=False, Rq=37, Cq=1001,
                   k=13, bits=8, ties=True),
              dict(R=5, V=4099, T=4.0, topk_teacher=True, Rq=5, Cq=4099,
                   k=100, bits=4, ties=True),
              dict(R=65, V=77, T=1.5, topk_teacher=True, Rq=150, Cq=77, k=8,
                   bits=8, ties=False),
              dict(R=3, V=1, T=2.0, topk_teacher=False, Rq=150, Cq=77, k=8,
                   bits=8, ties=False),
              dict(R=1, V=31, T=1.5, topk_teacher=False, Rq=150, Cq=77, k=8,
                   bits=8, ties=False),
              dict(R=9, V=33, T=1.0, topk_teacher=False, Rq=150, Cq=77, k=8,
                   bits=8, ties=False),
              dict(R=17, V=cross, T=2.0, topk_teacher=False, Rq=150, Cq=77,
                   k=8, bits=8, ties=False),
              dict(R=17, V=cross + 1, T=1.5, topk_teacher=False, Rq=150,
                   Cq=77, k=8, bits=8, ties=False),
              dict(R=1, V=50257, T=2.0, topk_teacher=False, Rq=1, Cq=50257,
                   k=64, bits=8, ties=False),
              dict(R=7, V=50257, T=1.5, topk_teacher=False, Rq=7, Cq=50257,
                   k=64, bits=8, ties=False, offset=1),
              dict(R=3, V=4099, T=2.0, topk_teacher=False, Rq=150, Cq=77,
                   k=8, bits=8, ties=False, offset=3),
              dict(R=64, V=50257, T=2.0, topk_teacher=True, Rq=64, Cq=50257,
                   k=64, bits=8, ties=False)]
    for i, shape in enumerate(shapes):
        for name, (kern, plain, *_rest) in kd_cases(
                device, seed=200 + i, **shape).items():
            err = max_err(name, kern(), plain())
            print(f"  kd shape {i} {name} ({shape['R']}x{shape['V']}, T "
                  f"{shape['T']}, offset {shape.get('offset', 0)}; top-k "
                  f"{shape['Rq']}x{shape['Cq']} k={shape['k']} "
                  f"bits={shape['bits']}): max abs err {err:.3e}")
            # row 9 scales by 1/T as its twin divides by T: the same bits
            # where 1/T is exact
            if name.startswith("kd_bwd") and shape["T"] in (1.0, 2.0, 4.0):
                require(err == 0.0, f"{name} is not its twin's bits at T "
                        f"{shape['T']}")
    print("  KD kernels at the main path's shapes (64 x 77; top-k 150 x 77, "
          "k 8, int8):")
    for name, case in kd_cases(device, seed=8, **kd_main).items():
        rows[name] = time_case(name, case, peaks_)
    rows["kd_fwd"]["fp64_rms_ratio"] = kd_fp64_errors(
        device, 64, 77, 2.0, True, 8)
    print("  KD kernels at a generative vocabulary (1280 x 50257; top-k "
          "k 64, int8):")
    gen_shape = dict(R=1280, V=50257, T=2.0, topk_teacher=False, Rq=1280,
                     Cq=50257, k=64, bits=8, ties=False)
    for name, case in kd_cases(device, seed=9, **gen_shape).items():
        rows[f"{name}@generative"] = time_case(name, case, peaks_)
    rows["kd_fwd@generative"]["fp64_rms_ratio"] = kd_fp64_errors(
        device, 1280, 50257, 2.0, False, 9)
    return rows


def family_kernel_checks(device, peaks_) -> dict:
    """Phase 2 at phase 14's shapes: the flash kernels' DT = 128
    instances at Qwen3-1.7B's (BH 256 over 128, S 80, D 128, causal) and
    Mixtral-8x7B's (512 over 128, window 4096) train steps, held to their
    twins, their rms error against fp64 within FP64_FACTOR times the
    larger of the fp32 twins' and SDPA's, and timed beside SDPA; the LoRA
    kernels (rows 1, 2, 4) at wq's (1280, d, d) and wk/wv's (1280, d,
    1024), d 2048 and 4096, held to their twins and timed beside the
    matmul chain.  Returns the rows, tagged "@q3", "@q3kv", "@mx",
    "@mxkv"."""
    rows = {}
    for tag, shape, seed in (("q3", Q3_SHAPES, 30), ("mx", MX_SHAPES, 31)):
        print(f"  LoRA and flash kernels at {tag}'s shapes (M "
              f"{shape['M']}, K = N = {shape['K']}; BH {shape['BH']} over "
              f"{shape['BKV']}, D {shape['D']}, window {shape['window']}):")
        flash_fp64_errors(device, shape["BH"], shape["BKV"], shape["S"],
                          shape["D"], shape["causal"], shape["window"], seed)
        for name, case in kernel_cases(device, seed=seed, **shape).items():
            if name != "lora_dw":
                rows[f"{name}@{tag}"] = time_case(name, case, peaks_)
        print(f"  LoRA kernels at {tag}'s wk/wv (M {shape['M']}, K "
              f"{shape['K']}, N {KV_WIDTH}):")
        kv = dict(shape, N=KV_WIDTH)
        for name, case in kernel_cases(device, seed=seed + 10, **kv).items():
            if name.startswith("lora_") and name != "lora_dw":
                rows[f"{name}@{tag}kv"] = time_case(name, case, peaks_)
    return rows


def vlm_encdec_kernel_checks(device, peaks_) -> dict:
    """Phase 2 at phase 15's shapes: the flash kernels non-causal at
    Whisper-base's encoder self-attention (BH 128, S 1500, D 64), at its
    cross-attention (80 queries over 1500 keys) and causal at LLaVA's G 7
    (BH 896 over 128, S 656, D 128), each held to its twins, its rms error
    against fp64 within FP64_FACTOR times the larger of the fp32 twins'
    and SDPA's, and timed beside SDPA; the LoRA kernels (rows 1, 2, 4) at
    Whisper's encoder and cross-attention wk/wv sites (24000, 512, 512)
    and at LLaVA's wq (10496, 7168, 7168) and wk/wv (10496, 7168, 1024),
    held to their twins and timed beside the matmul chain.  Returns the
    rows, tagged "@wh", "@whx", "@lv", "@lvkv"."""
    rows = {}
    for tag, shape, seed, what in (
            ("wh", WH_SHAPES, 32, "Whisper-base's encoder"),
            ("whx", WHX_SHAPES, 33, "Whisper-base's cross-attention"),
            ("lv", LV_SHAPES, 34, "LLaVA-NeXT-34B's")):
        print(f"  {what} shapes (LoRA M {shape['M']}, K = N = "
              f"{shape['K']}; flash BH {shape['BH']} over {shape['BKV']}, "
              f"S {shape['S']} over {shape['Skv']}, D {shape['D']}, causal "
              f"{shape['causal']}):")
        flash_fp64_errors(device, shape["BH"], shape["BKV"], shape["S"],
                          shape["D"], shape["causal"], shape["window"], seed,
                          Skv=shape["Skv"])
        for name, case in kernel_cases(device, seed=seed, **shape).items():
            if name == "lora_dw" or (tag == "whx" and name.startswith("lora")):
                continue
            rows[f"{name}@{tag}"] = time_case(name, case, peaks_)
    print(f"  LoRA kernels at LLaVA-NeXT-34B's wk/wv (M {LV_SHAPES['M']}, K "
          f"{LV_SHAPES['K']}, N {KV_WIDTH}):")
    kv = dict(LV_SHAPES, N=KV_WIDTH)
    for name, case in kernel_cases(device, seed=44, **kv).items():
        if name.startswith("lora_") and name != "lora_dw":
            rows[f"{name}@lvkv"] = time_case(name, case, peaks_)
    return rows


def check_kernels(device, card: str):
    """Phase 2.  Returns the per-kernel JSON rows (main-path shapes) and the
    launch floor (launch_floor)."""
    import torch
    peaks_ = peaks(card)
    floor = launch_floor(device)
    cfg = dict(M=BATCH * PAD_LEN, K=768, N=768, r=RANK, BH=BATCH * 12,
               BKV=BATCH * 12, S=PAD_LEN, Skv=PAD_LEN, D=64, causal=True,
               window=0, q_offset=0)
    ragged = [dict(M=1001, K=768, N=768, r=RANK, BH=8, BKV=4, S=24, Skv=32,
                   D=32, causal=True, window=16, q_offset=8),
              dict(M=37, K=130, N=70, r=3, BH=6, BKV=3, S=50, Skv=50,
                   D=100, causal=False, window=0, q_offset=0),
              # RecurrentGemma's attention: 10 heads of 256 on one kv head,
              # a window shorter than S; a head dim the 256 tile masks
              dict(M=333, K=2560, N=256, r=RANK, BH=20, BKV=2, S=80, Skv=80,
                   D=256, causal=True, window=32, q_offset=0),
              dict(M=50, K=2560, N=2560, r=RANK, BH=10, BKV=1, S=50, Skv=70,
                   D=200, causal=True, window=0, q_offset=20),
              # flash_dkv's head chunks of unequal size: G 3 on 32 kv
              # heads (2 chunks of 1 and 2 heads), G 5 on 16 (4 chunks)
              dict(M=64, K=64, N=64, r=RANK, BH=96, BKV=32, S=80, Skv=80,
                   D=64, causal=True, window=0, q_offset=0),
              dict(M=64, K=64, N=64, r=RANK, BH=80, BKV=16, S=80, Skv=80,
                   D=128, causal=True, window=48, q_offset=0)]
    # RG-LRU scan: the eval batch's shape, a ragged width (scalar loads)
    # with a step count that is no multiple of the kernels' 8-step load
    # batches, one step, an initial state and dh_final, misaligned rows
    rglru_checks = [dict(B=64, S=PAD_LEN, W=2560, h0=False, dh_final=False,
                         offset=0),
                    dict(B=3, S=37, W=2561, h0=True, dh_final=True,
                         offset=0),
                    dict(B=5, S=1, W=2560, h0=True, dh_final=False,
                         offset=0),
                    dict(B=16, S=PAD_LEN, W=2560, h0=True, dh_final=True,
                         offset=0),
                    dict(B=4, S=19, W=2560, h0=True, dh_final=True,
                         offset=1)]
    for i, shape in enumerate(ragged):
        for name, (kern, plain, *_rest) in kernel_cases(
                device, seed=100 + i, **shape).items():
            err = max_err(name, kern(), plain())
            print(f"  ragged {i} {name}: max abs err {err:.3e}")
    # the flash kernels (flash_dq's four warps a q tile) at G 10, D 256:
    # a window shorter than S, ragged S and Skv, a q_offset
    flash_edge = dict(M=64, K=64, N=64, r=RANK, BH=10, BKV=1, S=37, Skv=53,
                      D=256, causal=True, window=24, q_offset=16)
    for name, (kern, plain, *_rest) in kernel_cases(
            device, seed=120, **flash_edge).items():
        if name.startswith("flash_"):
            err = max_err(name, kern(), plain())
            print(f"  flash edge (G 10, D 256, S 37 over 53, window 24, "
                  f"q_offset 16) {name}: max abs err {err:.3e}")
    # the flash kernels' DT = 128 instances at G 6 (Qwen2-1.5B's 12 query
    # heads over 2), ragged S and Skv, a q_offset
    d128_edge = dict(M=64, K=64, N=64, r=RANK, BH=12, BKV=2, S=37, Skv=53,
                     D=128, causal=True, window=0, q_offset=16)
    for name, (kern, plain, *_rest) in kernel_cases(
            device, seed=125, **d128_edge).items():
        if name.startswith("flash_"):
            err = max_err(name, kern(), plain())
            print(f"  flash edge (G 6, D 128, S 37 over 53, q_offset 16) "
                  f"{name}: max abs err {err:.3e}")
    # dW: a ragged M, K and N; RecurrentGemma-2B's wk and wv (2560, 256)
    for i, (M, K, N) in enumerate(((1279, 770, 97),
                                   (BATCH * PAD_LEN, 2560, 256))):
        gen = torch.Generator(device=device).manual_seed(150 + i)
        x = torch.randn((M, K), device=device, generator=gen)
        g = torch.randn((M, N), device=device, generator=gen) * M ** -0.5
        kern, plain, *_rest = dw_case(x, g)
        print(f"  lora_dw shape {i} ({M}, {K}, {N}): max abs err "
              f"{max_err('lora_dw', kern(), plain()):.3e}")
    # the fused LoRA kernels' edges: x and g misaligned for 16-byte copies,
    # a DP batch-1 pass (M 80), ranks 64 (eight panel fragments), 1 and
    # 13, and K and N that no tile or 8 divides (K over several K blocks)
    lora_edges = [dict(M=333, K=768, N=768, r=RANK, offset=1),
                  dict(M=PAD_LEN, K=768, N=768, r=RANK, offset=0),
                  dict(M=200, K=768, N=768, r=64, offset=0),
                  dict(M=200, K=2560, N=256, r=1, offset=0),
                  dict(M=301, K=2050, N=260, r=RANK, offset=0),
                  dict(M=301, K=2050, N=261, r=13, offset=1)]
    for i, shape in enumerate(lora_edges):
        for name, (kern, plain) in lora_edge_cases(
                device, seed=160 + i, **shape).items():
            err = max_err(name, kern(), plain())
            print(f"  lora edge {i} {name} (M {shape['M']}, K {shape['K']}, "
                  f"N {shape['N']}, r {shape['r']}, offset "
                  f"{shape['offset']}): max abs err {err:.3e}")
    # the panel gradient's edges: a DP batch-1 pass (M 80: three M
    # slices) and M 1, ranks 1, 13 and 64 (rank groups of 8), a width of 770
    # (4-byte loads), lhs one float off 16-byte alignment, and
    # RecurrentGemma-2B's (1280, 2560) and (1280, 256)
    panel_edges = [dict(M=PAD_LEN, L=768, r=RANK, offset=0),
                   dict(M=1, L=768, r=RANK, offset=0),
                   dict(M=333, L=768, r=1, offset=0),
                   dict(M=333, L=768, r=13, offset=0),
                   dict(M=1280, L=768, r=64, offset=0),
                   dict(M=1001, L=770, r=RANK, offset=0),
                   dict(M=1280, L=768, r=RANK, offset=1),
                   dict(M=BATCH * PAD_LEN, L=2560, r=RANK, offset=0),
                   dict(M=BATCH * PAD_LEN, L=256, r=RANK, offset=0)]
    for i, shape in enumerate(panel_edges):
        for name, (kern, plain, *_rest) in panel_edge_cases(
                device, seed=170 + i, **shape).items():
            err = max_err(name, kern(), plain())
            print(f"  panel edge {i} {name} (M {shape['M']}, L {shape['L']}, "
                  f"r {shape['r']}, offset {shape['offset']}): max abs err "
                  f"{err:.3e}")
    rows = panel_examples_checks(device, peaks_)
    rows.update(pair_checks(device, peaks_))
    rows.update(clients_checks(device, peaks_))
    for i, shape in enumerate(rglru_checks):
        for name, (kern, plain, *_rest) in rglru_cases(
                device, seed=500 + i, **shape).items():
            max_err(name, kern(), plain())
            print(f"  rglru shape {i} {name} ({shape['B']}, {shape['S']}, "
                  f"{shape['W']}), h0 {shape['h0']}, dh_final "
                  f"{shape['dh_final']}, offset {shape['offset']}: "
                  f"bit-identical")
    for name, case in kernel_cases(device, seed=7, **cfg).items():
        rows[name] = time_case(name, case, peaks_)
    print(f"  the panel gradient at a DP batch-1 pass's shape (M {PAD_LEN}, "
          f"L 768, r {RANK}):")
    for name, case in panel_edge_cases(device, PAD_LEN, 768, RANK, 0,
                                       19).items():
        rows[f"{name}@dp"] = time_case(name, case, peaks_)
    for K in (768, 2560):
        rms, lib = lora_fp64_errors(device, BATCH * PAD_LEN, K, K, 17)
        for op, err in rms["kernel"].items():
            require(err <= FP64_FACTOR * rms[lib][op],
                    f"LoRA {op} kernel at K = N = {K}: rms error against "
                    f"fp64 {err:.3e} exceeds {FP64_FACTOR} times {lib}'s "
                    f"{rms[lib][op]:.3e}")
    for shape in (cfg, RG_SHAPES):
        flash_fp64_errors(device, shape["BH"], shape["BKV"], shape["S"],
                          shape["D"], shape["causal"], shape["window"], 18)
    print(f"  LoRA and flash kernels at RecurrentGemma-2B's shapes (M "
          f"{BATCH * PAD_LEN}, K = N = 2560; BH {BATCH * 10}, one kv head a "
          f"batch row, D 256, window 2048):")
    for name, case in kernel_cases(device, seed=12, **RG_SHAPES).items():
        rows[f"{name}@rg"] = time_case(name, case, peaks_)
    print(f"  RG-LRU scan kernels at the train step's shape ({BATCH}, "
          f"{PAD_LEN}, 2560), no h0, no dh_final:")
    for name, case in rglru_cases(device, BATCH, PAD_LEN, 2560, False, False,
                                  0, 13).items():
        rows[name] = time_case(name, case, peaks_)
    rows.update(family_kernel_checks(device, peaks_))
    rows.update(vlm_encdec_kernel_checks(device, peaks_))
    rows.update(launch_kernel_checks(device, peaks_))
    rows.update(check_rwkv_kernels(device, peaks_))
    rows.update(kd_checks(device, peaks_))
    topk_wide_cases(device, 19)
    nonfinite_checks(device)
    # DP: every row clipped (float4 loads), a ragged width (scalar loads),
    # none clipped (scalar), half clipped with a ragged last share and a
    # zero row (float4); one row at the main width; P 3 (fewer elements
    # than a cluster's threads) with a zero row; a ragged width over many
    # loads a thread; the main shape with a zero row and its base one
    # float off 16-byte alignment (scalar)
    dp_checks = [dict(B=8, P=384, clip="all", zero_row=False),
                 dict(B=4, P=257, clip="half", zero_row=False),
                 dict(B=5, P=16385, clip="none", zero_row=False),
                 dict(B=16, P=20004, clip="half", zero_row=True),
                 dict(B=1, P=DP_WIDTH, clip="none", zero_row=False),
                 dict(B=4, P=3, clip="half", zero_row=True),
                 dict(B=5, P=100003, clip="half", zero_row=False),
                 dict(B=BATCH, P=DP_WIDTH, clip="half", zero_row=True,
                      offset=1)]
    for i, shape in enumerate(dp_checks):
        cases, C, clipped = dp_cases(device, seed=300 + i, **shape)
        print(f"  dp shape {i} ({shape['B']}x{shape['P']}, C {C:.4g}, "
              f"{clipped} of {shape['B']} rows clipped"
              f"{', a zero row' if shape['zero_row'] else ''}"
              f"{', offset 1' if shape.get('offset') else ''}):")
        for name, case in cases.items():
            time_case(name, case, peaks_)
    # per-row quantizers: a warp per row with scalar loads at ragged widths
    # (odd C; C = 2 mod 4 for the pack), a block per row above 2048 with
    # float4 and scalar loads, and float4 rows whose start is misaligned
    quant_checks = [dict(R=37, C=129, special=True, offset=0),
                    dict(R=37, C=130, special=True, offset=0),
                    dict(R=5, C=4100, special=True, offset=0),
                    dict(R=4, C=2050, special=True, offset=0),
                    dict(R=16, C=768, special=True, offset=1)]
    for i, shape in enumerate(quant_checks):
        for name, (kern, plain, *_rest) in quant_cases(
                device, seed=400 + i, **shape).items():
            max_err(name, kern(), plain())
            print(f"  quantize shape {i} {name} ({shape['R']}x{shape['C']}"
                  f", offset {shape['offset']}): bit-identical")
    print(f"  per-row quantizers at the Split boundary's shape "
          f"({BATCH * PAD_LEN} x 768), a row of zeros and half levels:")
    for name, case in quant_cases(device, BATCH * PAD_LEN, 768, True, 0,
                                  11).items():
        if not name.startswith("quant_roundtrip"):
            rows[name] = time_case(name, case, peaks_)
    rows.update(roundtrip_checks(device, peaks_))
    print(f"  DP clip kernels at the main path's shape ({BATCH} x "
          f"{DP_WIDTH}, half the rows clipped):")
    cases, C, clipped = dp_cases(device, BATCH, DP_WIDTH, "half", False, 10)
    require(0 < clipped < BATCH, f"{clipped} of {BATCH} rows clipped")
    for name, case in cases.items():
        rows[name] = time_case(name, case, peaks_)
    rows.update(clip_clients_checks(device, peaks_))
    dp_norm_fp64_errors(device, 22)
    dp_norms_repeat(device, 23)
    torch.cuda.empty_cache()
    return rows, floor


# --------------------------------------------------------------------------- #
# Phase 3: the slice
# --------------------------------------------------------------------------- #
def lora_gap(got, want):
    """(share of elements outside atol 5e-5 / rtol 5e-4, relative L2
    distance, max abs difference) between two LoRA trees."""
    from repro_torch import tree as tree_lib
    outside = n = 0
    num = den = worst = 0.0
    for x, y in zip(tree_lib.leaves(got), tree_lib.leaves(want)):
        d = (x - y).abs()
        outside += int((d > 5e-5 + 5e-4 * y.abs()).sum())
        n += d.numel()
        num += float((d * d).sum())
        den += float((y * y).sum())
        worst = max(worst, float(d.max()))
    return outside / n, (num / den) ** 0.5, worst


def rel_l2(got, want) -> float:
    """Relative L2 distance between two lists of tensors taken as one
    vector: |got - want| / |want|."""
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
    return (num / sum(float((b ** 2).sum()) for b in want)) ** 0.5


def floor_gate(what: str, gaps: dict) -> float:
    """Each run's distance from the fp64 run (``gaps[role]``, role
    "kernels", "plain", "floor", "control"): fails unless the kernels' is
    within FLOOR_FACTOR times the larger of the two fp32 plain runs' plus
    FLOOR_SLACK and the TF32 control's outside it; prints where each
    falls and returns the limit."""
    limit = FLOOR_FACTOR * max(gaps["plain"], gaps["floor"]) + FLOOR_SLACK
    print(f"  {what}, distance from fp64: kernels {gaps['kernels']:.3e}, "
          f"plain {gaps['plain']:.3e}, floor {gaps['floor']:.3e}, control "
          f"{gaps['control']:.3e}; limit {limit:.3e}; kernels at "
          f"{gaps['kernels'] / limit:.3f} of it, TF32 control "
          f"{gaps['control'] / limit:.1f}x")
    require(gaps["kernels"] <= limit, f"{what}: the kernel run is further "
            f"from the fp64 run than the fp32 plain runs allow")
    require(gaps["control"] > limit, f"{what}: the gate does not reject the "
            f"TF32 control")
    return limit


FP32_EXCLUDED = ("kernels", "control")


def fp32_gates(kind: str = "continuous", loss=(), lora=None, flips=None,
               loss_kind=None):
    """The limits of the gates that hold a case study's runs to its fp32
    plain runs, and the gates that fail, from the measured distances
    alone.  A role is "kernels", "control" (TF32) or an fp32 plain run's
    ("plain", "floor", "seed <i>"); every role but the first two is an
    fp32 run, and each limit is set by the largest of them.

    kind: "continuous" (each round's loss within 1e-3 of the plain run's;
    the final LoRA, measured from the fp64 run, within FLOOR_FACTOR times
    the largest fp32 distance) or "spread" (runs part: each round's loss
    limit adds FLOOR_FACTOR times the largest fp32 difference from the
    plain run; the final LoRA, measured from the plain run, within
    SPREAD_FACTOR times the largest fp32 distance).  Either way the TF32
    control must fall outside the final-LoRA limit.  ``loss_kind``
    ("continuous" or "spread", default ``kind``) sets the round-loss
    limits alone: a path whose final LoRA holds to fp64 while its round
    losses part beyond 1e-3 between fp32 runs takes the final LoRA's
    continuous gate and the losses' spread one.
    loss: one {role: |round loss - the plain run's|} a round.
    lora: {role: the final LoRA's relative L2 distance from the
    yardstick}, or None.
    flips: {role: share of Split's boundary levels that differ from the
    plain run's}, or None: within FLOOR_FACTOR times the largest fp32
    share plus FLOOR_SLACK, the TF32 control outside.
    Returns ({"loss": [limit a round], "lora": limit or None, "flips":
    limit or None}, [what fails])."""
    def largest(d):
        return max(v for role, v in d.items() if role not in FP32_EXCLUDED)

    limits = {"loss": [], "lora": None, "flips": None}
    failed = []
    for d in loss:
        widen = 0.0 if (loss_kind or kind) == "continuous" \
            else FLOOR_FACTOR * largest(d)
        limits["loss"].append(1e-3 + widen)
    if any(d["kernels"] > lim for d, lim in zip(loss, limits["loss"])):
        failed.append("round loss of the kernel run is off the plain run's "
                      "beyond its limit")
    if lora is not None:
        factor = SPREAD_FACTOR if kind == "spread" else FLOOR_FACTOR
        limits["lora"] = factor * largest(lora) + FLOOR_SLACK
        if lora["kernels"] > limits["lora"]:
            failed.append("final LoRA of the kernel run is off its "
                          "yardstick beyond the fp32 runs' limit")
        if lora["control"] <= limits["lora"]:
            failed.append("the final-LoRA gate does not reject the TF32 "
                          "control run")
    if flips is not None:
        limits["flips"] = FLOOR_FACTOR * largest(flips) + FLOOR_SLACK
        if flips["kernels"] > limits["flips"]:
            failed.append("boundary levels of the kernel run differ from "
                          "the plain run's beyond the fp32 floor")
        if flips["control"] <= limits["flips"]:
            failed.append("the boundary-level gate does not reject the TF32 "
                          "control run")
    return limits, failed


def yardstick(role: str, kind: str) -> str:
    """The run that run_case measures the final LoRA of run ``role``
    from.  A continuous path measures each run from the fp64 run of its
    own weights ("exact", or "exact <i>" for nudged run "seed <i>"): a
    nudged run's distance from the fp64 run of the same nudged weights is
    rounding alone, not the nudge.  A spread path measures from the plain
    run."""
    if kind != "continuous":
        return "plain"
    return f"exact {role.split()[1]}" if role.startswith("seed") else "exact"


def fp64(tree):
    """A copy of ``tree`` with every floating-point leaf in float64."""
    from repro_torch import tree as tree_lib
    return tree_lib.map_(
        lambda t: t.double() if t.is_floating_point() else t, tree)


def from_exact(values: dict, what: str) -> dict:
    """Relative L2 distance of each run's tensors (``values[role]``, a
    list) from the fp64 run's, printed; {role: distance} for the kernels,
    the two fp32 plain runs and the TF32 control."""
    gaps = {role: rel_l2(values[role], values["exact"])
            for role in ("kernels", "plain", "floor", "control")}
    print(f"  {what}, relative L2 from the fp64 run: " + ", ".join(
        f"{role} {gap:.3e}" for role, gap in gaps.items()))
    return gaps


def each_run(exact: bool = False):
    """Yields (role, tag, kernel policy) for the four runs every case
    study makes, with the BLAS library and TF32 set for each and restored
    after it: the kernels ("kernels", tagged "cuda"), plain PyTorch under
    the default BLAS library ("plain", "torch"), under the other one
    ("floor": the same fp32 products summed in another order) and under
    TF32 ("control": a run of lower precision); with ``exact``, then
    plain PyTorch from the weights and LoRA cast to float64 ("exact",
    "torch-fp64": the yardstick the fp64-judged gates measure from; the
    caller casts them)."""
    import torch
    blas = torch.backends.cuda.preferred_blas_library()
    other = "cublas" if "lt" in str(blas).lower() else "cublaslt"
    runs = [("kernels", "cuda", "cuda", blas, False),
            ("plain", "torch", "torch", blas, False),
            ("floor", f"torch-{other}", "torch", other, False),
            ("control", "torch-tf32", "torch", blas, True)]
    if exact:
        runs.append(("exact", "torch-fp64", "torch", blas, False))
    for role, tag, policy, lib, tf32 in runs:
        torch.backends.cuda.preferred_blas_library(lib)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            yield role, tag, policy
        finally:
            torch.backends.cuda.preferred_blas_library(blas)
            torch.backends.cuda.matmul.allow_tf32 = False


def nudged(base, seed: int, device):
    """A copy of ``base`` with every floating-point weight moved one ulp
    up or down, the direction drawn from ``seed``: an fp32 plain run from
    it differs from the plain run by fp32 rounding alone, in an order of
    its own."""
    import torch

    from repro_torch import tree as tree_lib

    gen = torch.Generator(device=device).manual_seed(seed)

    def move(t):
        if not t.is_floating_point():
            return t
        up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
        inf = torch.full_like(t, math.inf)
        return torch.where(up, torch.nextafter(t, inf),
                           torch.nextafter(t, -inf))
    return tree_lib.map_(move, base)


# the kernel run's share of its gate's limit on the paths whose margins
# are watched (ROADMAP §3's margins: the final LoRA, and phase 5's first
# step), keyed by path, and the share the last run recorded in PERF.md
# printed beside it (None: no run recorded it yet)
MARGINS = {}
# phases 3, 4 and 6's runs, launch counts and gate limits (run_case's
# ``keep``), the yardsticks of phase 10's spmd runs (phase 13 keeps its
# faulted FedLLM runs there too)
CASES = {}
MARGINS_BEFORE = {"phase 7": 0.402, "Split int8": 0.862,
                  f"RWKV-6 ({RWKV6_FEDLLM_LAYERS} layers)": 0.782,
                  "DP first step": 0.195, "DP final LoRA": 0.390,
                  "DP first-step rows": 0.199, "RWKV-6 KD upload": 0.215,
                  "RWKV-6 DP first-step rows": 0.198,
                  "RWKV-6 DP first step": 0.198,
                  "RecurrentGemma-2B Split int8 flips": 0.129,
                  "RecurrentGemma-2B Split int8": 0.814,
                  "RWKV-6 Split fp32 first step": 0.197,
                  "RWKV-6 Split int8 flips": 0.263,
                  "hetero zeropad": 0.245, "hetero svd": 0.372,
                  "async": 0.027, "DP spmd final LoRA": 0.541,
                  "hetero zeropad spmd": 0.249, "hetero svd spmd": 0.286,
                  "async spmd": 0.026, "cohort": 0.175, "faults": 0.276,
                  "Qwen3-1.7B first step": 0.209, "Qwen3-1.7B": 0.281,
                  "Mixtral-8x7B route flips": 0.0,
                  "Mixtral-8x7B first step": 0.287, "Mixtral-8x7B": 0.840,
                  "Mixtral-8x7B DP first-step rows": 0.287,
                  "Mixtral-8x7B DP first step": 0.287,
                  "Whisper-base first step": 0.177,
                  f"Whisper-base {WHISPER_STEPS} steps": 0.265,
                  "Whisper-base DP first-step rows": 0.152,
                  "Whisper-base DP first step": 0.154,
                  "Whisper-base Split int8 flips": 0.358,
                  "LLaVA-NeXT-34B first step": 0.278,
                  "gpt2 decode": 0.192, "gpt2 decode vs forward": 0.192,
                  "gpt2 bound vs merged": 0.239,
                  "whisper-base decode": 0.199,
                  "whisper-base decode vs forward": 0.199,
                  "qwen3-1.7b decode": 0.229,
                  "qwen3-1.7b decode vs forward": 0.229,
                  "recurrentgemma-2b decode": 0.181,
                  "recurrentgemma-2b decode vs forward": 0.181,
                  "rwkv6-1.6b decode": 0.240,
                  "rwkv6-1.6b decode vs forward": 0.240,
                  "train.py first step": 0.223,
                  f"train.py {TRAIN_ADAM_STEPS} Adam steps": 0.148,
                  "generative FedLLM": 0.123, "generative FedLLM spmd": 0.237,
                  "generative DP first-step rows": 0.222,
                  "generative DP first step": 0.218,
                  "generative Split int8 flips": 0.277,
                  "generative KD step": 0.191,
                  "launch train_4k first step": 0.315,
                  "launch prefill_32k": 0.179, "launch decode_32k": 0.271,
                  "launch fed_round FedLLM": 0.311,
                  "launch fed_round DP-FedLLM": 0.311,
                  "launch fed_round KD": 0.107,
                  "launch fed_round Split": 0.289}


def rwkv_bwd_repeat(device, seed) -> None:
    """The WKV backward's bits hold over calls and graph replays at the
    train step's shape (dlogw, no dS_final, no du)."""
    from repro_torch.kernels import rwkv6_scan as rw

    BH = BATCH * RWKV_HEADS
    r, k, v, lw, u, dy, _ = rwkv_inputs(device, BH, PAD_LEN, 64, RWKV_HEADS,
                                        "model", False, seed)
    ckpt = rw.rwkv6_fwd(r, k, v, lw, u, checkpoints=True)[2]
    same_bits_repeated("rwkv6_bwd", lambda: rw.rwkv6_bwd(r, k, v, lw, u, ckpt,
                                                         dy)[:4])
    print(f"  rwkv6_bwd at ({BH}, {PAD_LEN}, 64): two eager calls and two "
          f"CUDA-graph replays bit-identical")


def run_case(device, cfg, base, fed, data, ledger, expect,
             kind="continuous", seeds=0, margin=None, keep=None, view=None,
             loss_kind=None):
    """One framework's case study through the kernels and through plain
    PyTorch (under two BLAS libraries, two summation orders of the same
    fp32 products, and under TF32), from the same weights, and ``seeds``
    more fp32 plain runs from ``nudged`` weights (each its own fp32
    rounding).  Checks the runs against each other, the kernel run's
    ledger bytes by name against ``ledger`` and its launch counts against
    ``expect``; returns the kernel run's (launch counts, result).  The
    gates are fp32_gates' of ``kind``.  On a "continuous" path a further
    run, plain PyTorch from the weights cast to float64 (each_run's
    "exact", its fp64 copy of the weights living for that run only), is
    the yardstick of the final LoRA, and each nudged run has one of its
    own (roles "exact <i>", from the same nudged weights): the kernel
    run's distance from the fp64 run within FLOOR_FACTOR times the
    largest fp32 run's from its own (plain, floor, nudged) plus
    FLOOR_SLACK, the TF32 control's outside; each round's loss within
    1e-3 of the plain run's.  A "spread" path turns fp32 noise into discrete changes that move the loss and the
    final LoRA of every run (a quantized wire's level flips; Adam's first
    sign step on RWKV-6 at full width), so an fp64 run parts from the
    others like any other run: there the final LoRA is measured from the
    plain run, each round's loss limit adds FLOOR_FACTOR times the largest
    difference between the plain run and another fp32 run, and such a
    phase gates the kernels' precision on its first step, before the runs
    part.  ``margin`` names the path in MARGINS, where the kernel run's
    final-LoRA share of its limit is then kept; ``keep`` names it in
    CASES, where its runs, launch counts and gate limits are kept for
    phase 10.  ``view`` (a final LoRA tree -> tensors) is what the
    final-LoRA gates compare, the tree's leaves by default (lora_deltas
    for svd-harmonized trees).  ``loss_kind`` is fp32_gates'."""
    import torch

    from repro_torch.core.rounds import run_federated
    from repro_torch.kernels import ops

    pub, clients, test = data
    continuous = kind == "continuous"

    def settings():
        for role, tag, policy in each_run(exact=continuous):
            yield role, tag, policy, None
        for seed in range(seeds):
            yield f"seed {seed}", f"torch-seed{seed}", "torch", seed
            if continuous:
                yield (f"exact {seed}", f"torch-fp64-seed{seed}", "torch",
                       seed)

    results, counts, peaks_gb = {}, {}, {}
    for role, tag, policy, seed in settings():
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        start = base if seed is None else nudged(base, seed, device)
        if role.startswith("exact"):
            start = fp64(start)
        res = run_federated(dataclasses.replace(cfg, kernel_policy=policy),
                            fed, pub, clients, test, batch_size=BATCH,
                            eval_batch=64, device=device, base=start)
        del start
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        wall = time.perf_counter() - t0
        counts[role] = ops.launches()
        results[role] = res
        peaks_gb[role] = torch.cuda.max_memory_allocated() / 1e9
        for h in res.history:
            require(math.isfinite(h.loss) and 0.0 <= h.accuracy <= 1.0,
                    f"round {h.round} metrics out of range")
            print(f"  [{tag}] round {h.round}: acc={h.accuracy:.4f} "
                  f"loss={h.loss:.6f} wall_s={h.seconds:.3f}")
        print(f"  [{tag}] run wall_s={wall:.3f} peak memory "
              f"{peaks_gb[role]:.2f} GB launches={counts[role]}")
    if seeds:
        exact = [r for r in peaks_gb if r.startswith("exact")]
        print(f"  peak device memory: nudged runs up to "
              f"{max(peaks_gb[f'seed {s}'] for s in range(seeds)):.2f} GB"
              + (f", fp64 runs up to {max(peaks_gb[r] for r in exact):.2f}"
                 f" GB" if exact else ""))

    kern, plain = results["kernels"], results["plain"]
    require(kern.ledger.by_name() == ledger,
            f"ledger bytes {kern.ledger.by_name()} != {ledger} from the "
            f"payload shapes")
    require(kern.ledger.by_name() == plain.ledger.by_name(), "ledger by_name")
    require(kern.ledger.per_client_round() == plain.ledger.per_client_round(),
            "ledger per_client_round")
    require(kern.client_flops == plain.client_flops, "client FLOPs")
    # every run's round-loss difference from the plain run (the fp64 run's
    # printed, not gated)
    loss = [{role: abs(res.history[i].loss - hp.loss)
             for role, res in results.items()
             if role != "plain" and not role.startswith("exact")}
            for i, hp in enumerate(plain.history)]
    # Adam divides each update by sqrt(v) + 1e-8, so a coordinate whose
    # gradient sits near the fp32 noise floor moves by a good part of lr in
    # a direction the summation order picks: any two fp32 runs at full
    # width differ by more than atol 5e-5 / rtol 5e-4 in a few elements.
    # The gate is the spread the fp32 plain runs show in this run; the
    # TF32 run shows that the gate rejects a run of lower precision.
    view = view or (lambda tree: tree)
    gaps = {role: lora_gap(view(res.final_lora),
                           view(results[yardstick(role, kind)].final_lora))
            for role, res in results.items()
            if not role.startswith("exact")
            and role != yardstick(role, kind)}
    limits, failed = fp32_gates(
        kind, loss, {role: gap[1] for role, gap in gaps.items()},
        loss_kind=loss_kind)
    for i, (d, lim) in enumerate(zip(loss, limits["loss"])):
        hp = plain.history[i]
        fp64_ = "" if not continuous else \
            f", fp64 {abs(results['exact'].history[i].loss - hp.loss):.3e}"
        print(f"  round {hp.round} loss vs plain: "
              + ", ".join(f"{role} {v:.3e}" for role, v in d.items())
              + f"{fp64_} (limit {lim:.3e}; kernels at "
              f"{d['kernels'] / lim:.3f} of it)")
    for name, (share, rel, worst) in gaps.items():
        yard = "plain" if not continuous else "fp64" + (
            " of its weights" if name.startswith("seed") else "")
        print(f"  final LoRA {name} vs {yard}: relative L2 {rel:.3e} "
              f"(limit {limits['lora']:.3e}, {rel / limits['lora']:.3f} of "
              f"it), outside atol 5e-5/rtol 5e-4 {share:.3e} of elements, "
              f"max abs {worst:.3e}")
    if margin is not None:
        MARGINS[margin] = gaps["kernels"][1] / limits["lora"]
    if keep is not None:
        CASES[keep] = {"results": results, "counts": counts,
                       "limits": limits, "kind": kind}
    require(not failed, "; ".join(failed))

    check_launches(counts["kernels"], expect)
    for role in counts.keys() - {"kernels"}:
        require(all(n == 0 for n in counts[role].values()),
                f"plain run launched kernels: {counts[role]}")
    return counts["kernels"], kern


def check_launches(counts, expect) -> None:
    """Fails unless the kernel run launched each kernel of ``expect``
    exactly that many times (each at least once) and no other kernel."""
    got = {name: n for name, n in counts.items() if name in expect}
    require(got == expect and all(n > 0 for n in expect.values()),
            f"launches {counts} != expected {expect}")
    require(all(n == 0 for name, n in counts.items() if name not in expect),
            f"kernels off this path launched: {counts}")


def kernel_run(device, cfg, base, fed, data, ledger, expect):
    """One run of a case study through the kernels alone (policy
    ``cuda``), for a path whose plain runs are too slow to repeat: every
    round's metrics in range, the ledger bytes by name equal to
    ``ledger`` (reckoned by hand from the payload shapes) and the launch
    counts to ``expect``.  Returns (the launch counts, the result)."""
    import torch

    from repro_torch.core.rounds import run_federated
    from repro_torch.kernels import ops

    pub, clients, test = data
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run_federated(dataclasses.replace(cfg, kernel_policy="cuda"), fed,
                        pub, clients, test, batch_size=BATCH, eval_batch=64,
                        device=device, base=base)
    torch.cuda.synchronize()
    counts = ops.launches()
    for h in res.history:
        require(math.isfinite(h.loss) and 0.0 <= h.accuracy <= 1.0,
                f"round {h.round} metrics out of range")
        print(f"  [cuda] round {h.round}: acc={h.accuracy:.4f} "
              f"loss={h.loss:.6f} wall_s={h.seconds:.3f}")
    print(f"  [cuda] run wall_s={time.perf_counter() - t0:.3f} "
          f"launches={counts}")
    require(res.ledger.by_name() == ledger,
            f"ledger bytes {res.ledger.by_name()} != {ledger} from the "
            f"payload shapes")
    check_launches(counts, expect)
    return counts, res


def model_launches(L, train_steps, fwd_batches, clients: bool = False):
    """LoRA and attention launches the model's shapes predict: 3 LoRA
    projections and one attention per layer; forward in every batch,
    backward in every train step (dx, and two panel grads per projection).
    With ``clients``, the steps and batches are stacked clients' (the
    spmd backend's): the LoRA launches are the client-axis kernels'."""
    fwd = train_steps + fwd_batches
    tag = "_clients" if clients else ""
    return {f"lora_fwd{tag}": 3 * L * fwd, f"lora_dx{tag}": 3 * L * train_steps,
            f"lora_panel{tag}": 6 * L * train_steps, "flash_fwd": L * fwd,
            "flash_dq": L * train_steps, "flash_dkv": L * train_steps}


def add_counts(*counts) -> dict:
    """The sum of launch-count dicts, name by name."""
    out = {}
    for c in counts:
        for name, n in c.items():
            out[name] = out.get(name, 0) + n
    return out


def nonzero(counts) -> dict:
    """The entries of a launch-count dict that are not 0: check_launches'
    ``expect`` names only the kernels a path launches."""
    return {name: n for name, n in counts.items() if n}


def run_slices(device):
    """Phases 3-6: the FedLLM, KD, DP-FedLLM and Split-FedLLM case
    studies at full gpt2 width, from one base model.  Returns {path:
    kernel-run launch counts}."""
    import torch

    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.gpt2_small import gpt2
    from repro_torch.data import banking77, partition
    from repro_torch.models.factory import build_model

    cfg = gpt2()
    pub, train, test = banking77.paper_splits(cfg.vocab_size,
                                              pad_len=PAD_LEN, scale=0.03)
    clients = partition.iid_partition(train, 3)
    data = (pub, clients, test)
    base = build_model(cfg).init(torch.Generator().manual_seed(0), device)
    L, C = cfg.n_layers, len(clients)
    steps = sum(len(c["tokens"]) // BATCH for c in clients)  # per round
    evals = len(test["tokens"]) // 64
    lora_bytes = L * 3 * 2 * RANK * cfg.d_model * 4
    by_path = {}

    t0 = time.perf_counter()
    print("phase 3: FedLLM case study, gpt2 full width, 2 rounds, "
          "3 clients")
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0)
    floor_gate("first-step LoRA gradient",
               first_step_gaps(device, cfg, base, fed, clients))
    by_path["fedllm"], _ = run_case(
        device, cfg, base, fed, data,
        ledger={"lora_params": fed.rounds * C * 2 * lora_bytes},
        expect=model_launches(L, steps * fed.rounds,
                              evals * fed.rounds), keep="fedllm")
    print(f"  phase 3 wall_s={time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    print("phase 4: KD case study, gpt2 full width, 2 rounds, 3 "
          "clients, top-k 8 int8 logits")
    fed = FedConfig(framework="kd", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, logit_topk=8, logit_quant_bits=8)
    ledger, expect = kd_expect(fed, data, steps, evals,
                               lambda train, fwd: model_launches(L, train,
                                                                 fwd))
    # The precision gate: client 0's first upload before the int8 wire
    # (see kd_upload_gaps); the runs are then held to the gates of a
    # chaotic path, since one uploaded level that moves parts them.  The
    # final LoRA takes the spread test: two of three nudged fp32 runs part
    # (1.450e-3 from plain, measured with the FFMA LoRA kernels), the
    # TF32 run 2.2x further (3.149e-3)
    floor_gate("first upload's logits",
               kd_upload_gaps(device, cfg, base, fed, pub))
    by_path["kd"], _ = run_case(
        device, cfg, base, fed, data, ledger=ledger, expect=expect,
        kind="spread", seeds=NUDGED_SEEDS, keep="kd")
    print(f"  phase 4 wall_s={time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    by_path["dp"] = run_dp(device, cfg, base, data, steps, evals,
                           lora_bytes)
    print(f"  phase 5 wall_s={time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    by_path.update(run_split(device, cfg, base, data, steps, evals))
    print(f"  phase 6 wall_s={time.perf_counter() - t0:.1f}")
    return by_path


def kd_expect(fed, data, steps, evals, model, arrived=None):
    """A KD case study's ledger bytes by name and launch counts, from the
    payload shapes and ``model(train steps, forward-only batches)``, the
    model's launches.  Per round: b1 train steps (``steps``); b2 client
    logits and b6 server logits (forward only); b5 server and b8 client
    distillation (kd_epochs passes of kd_step over the public set: one KD
    forward and backward each); evaluation (``evals`` batches).  With
    ``arrived`` (fewer than the clients: the others' uploads quarantined
    every round, none dropped) only the arrivals upload logits and
    distill (b8), and each quarantined upload is charged as
    ``quarantine``."""
    from repro_torch.core import metrics

    pub, clients, _ = data
    C, n_pub = len(clients), len(pub["tokens"])
    A = C if arrived is None else arrived
    pub_batches = -(-n_pub // 64)       # public batches, ragged last
    kd_steps = (1 + A) * fed.kd_epochs * pub_batches
    expect = model((steps + kd_steps) * fed.rounds,
                   ((C + 1) * pub_batches + evals) * fed.rounds)
    expect.update(kd_fwd=kd_steps * fed.rounds,
                  kd_bwd=kd_steps * fed.rounds,
                  topk_quantize=C * fed.rounds)
    wire = metrics.logit_bytes(n_pub, 77, fed.logit_topk,
                               fed.logit_quant_bits)
    ledger = {"logits": fed.rounds * A * 2 * wire}
    if A < C:
        ledger["quarantine"] = fed.rounds * (C - A) * wire
    return ledger, expect


def kd_upload_gaps(device, cfg, base, fed, pub):
    """Client 0's first KD upload (round 0, b2-b3), recomputed under each
    of each_run(exact=True)'s settings from the run's initial LoRA: its
    public-set logits through core/kd.client_logits, then (fp32 runs) the
    top-k / int-bits payload that core/kd.compress_for_wire uploads
    (compression.topk_quantize).  Prints, against the plain run, the
    share of uploaded (index, level) pairs and of row scales that differ;
    returns each run's logits distance from the fp64 run's (from_exact)."""
    import torch

    from repro_torch.core import compression, kd
    from repro_torch.core.fedavg import make_fns
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build_model
    from repro_torch.peft import lora as lora_lib

    # the KD program draws client 0's tree first from seed + 2
    lt = lora_lib.init_lora(torch.Generator().manual_seed(fed.seed + 2),
                            base, fed.lora_targets or lora_lib.DEFAULT_TARGETS,
                            fed.lora_rank, fed.lora_alpha)
    logits, payload = {}, {}
    for role, tag, policy in each_run(exact=True):
        fns = make_fns(build_model(dataclasses.replace(
            cfg, kernel_policy=policy)), fed)
        with ops.policy_scope(policy):
            if role == "exact":
                logits[role] = [kd.client_logits(fns, fp64(base), fp64(lt),
                                                 pub, 64, device)]
                continue
            logits[role] = [kd.client_logits(fns, base, lt, pub, 64, device)]
            payload[role] = compression.topk_quantize(
                logits[role][0], fed.logit_topk, fed.logit_quant_bits)[0]
    torch.cuda.empty_cache()
    shares = {}
    want = payload["plain"]
    for role in ("kernels", "floor", "control"):
        got = payload[role]
        pairs = (got["indices"] != want["indices"]) | \
            (got["values_q"] != want["values_q"])
        scales = int((got["scale"] != want["scale"]).sum())
        shares[role] = float(pairs.float().mean())
        print(f"  round 0 upload of client 0, {role} vs plain: uploaded "
              f"(index, level) pairs that differ {int(pairs.sum())} of "
              f"{pairs.numel()} ({shares[role]:.3e}), row scales {scales} "
              f"of {want['scale'].numel()}")
    return from_exact(logits, "round 0 upload logits of client 0")


def split_level_flips(device, cfg, base, fed, clients, extras=None,
                      task="classification"):
    """Boundary levels of round 0, step 0 (split_first_step) that differ
    between the plain run and the kernel run, the other fp32 plain run
    (the floor), NUDGED_SEEDS fp32 plain runs from nudged weights and the
    TF32 run (the control), at c2 (activations) and c4 (gradients): each
    run's raw boundary tensors quantized by the plain version.  Prints the
    counts; returns {role: share of the levels that differ}."""
    from repro_torch.kernels import ref

    steps = split_first_step(device, cfg, base, fed, clients, exact=False,
                             seeds=NUDGED_SEEDS, extras=extras, task=task)
    levels = {role: [ref.quantize_rows_ref(t.reshape(-1, t.shape[-1]),
                                           SPLIT_BITS)[0]
                     for t in (h, h_grad)]
              for role, (_, h, h_grad) in steps.items()}
    share = {}
    for role in [role for role in levels if role != "plain"]:
        flips = [int((a != b).sum()) for a, b in zip(levels[role],
                                                     levels["plain"])]
        jumps = [int((a.int() - b.int()).abs().max()) for a, b in
                 zip(levels[role], levels["plain"])]
        n = sum(t.numel() for t in levels[role])
        share[role] = sum(flips) / n
        print(f"  round 0 step 0 boundary levels, {role} vs plain: c2 "
              f"{flips[0]}, c4 {flips[1]} of {n // 2} each differ (largest "
              f"difference {max(jumps)} levels)")
    return share


def split_flips_gate(device, cfg, base, fed, clients, extras=None,
                     task="classification") -> float:
    """The precision gate of a quantized Split boundary: a level flips
    where one run's fp32 value crosses a half level that the other's does
    not, so the share of flipped levels at round 0, step 0
    (split_level_flips) measures how far the path up to the boundary (c2)
    and back from the loss (c4) is off the plain run, before training
    amplifies it; within FLOOR_FACTOR times the largest fp32 share, the
    TF32 control outside.  Returns the kernel run's share of the limit."""
    flips = split_level_flips(device, cfg, base, fed, clients, extras, task)
    limits, failed = fp32_gates(flips=flips)
    print("  flipped share: " + ", ".join(
        f"{role} {v:.3e}" for role, v in flips.items())
        + f" (limit {limits['flips']:.3e}; kernels at "
        f"{flips['kernels'] / limits['flips']:.3f} of it)")
    require(not failed, "; ".join(failed))
    return flips["kernels"] / limits["flips"]


def split_wire_bytes(cfg, bits: int):
    """(c2, c4) bytes of one Split step at the case study's batch, by
    hand: BATCH * PAD_LEN boundary rows of d_model values, int(bits)
    levels and a 4-byte scale a row (bits 0: 4 bytes a value); c2 adds
    the batch's int32 labels."""
    rows, d = BATCH * PAD_LEN, cfg.d_model
    payload = rows * d * bits // 8 + rows * 4 if bits else rows * d * 4
    return payload + BATCH * 4, payload


def run_split(device, cfg, base, data, steps, evals):
    """Phase 6: Split-FedLLM, client layers [0, SPLIT_LAYER), with an
    fp32 boundary and with an int(SPLIT_BITS) one.  Returns {"split_fp32"
    | "split": kernel-run launch counts}."""
    from repro_torch.configs.base import FedConfig

    pub, clients, test = data
    L, C, d = cfg.n_layers, len(clients), cfg.d_model
    half = SPLIT_LAYER * 3 * 2 * RANK * d * 4
    by_path = {}
    for path, bits in (("split_fp32", 0), ("split", SPLIT_BITS)):
        print(f"phase 6: Split-FedLLM case study, gpt2 full width, 2 "
              f"rounds, 3 clients, split_layer {SPLIT_LAYER}, "
              f"{f'int{bits}' if bits else 'fp32'} boundary")
        fed = FedConfig(framework="split", rounds=2, lora_rank=RANK,
                        lora_dropout=0.0, split_layer=SPLIT_LAYER,
                        activation_quant_bits=bits)
        # by hand: a c2 transfer is 1280 rows of 768 levels (int8: and a
        # 4-byte scale a row; fp32: 4 bytes a value), plus 16 int32
        # labels; c4 the same without labels; the client half (2 layers x
        # 3 targets x (A + B) fp32) goes down and up each round
        c2, c4 = split_wire_bytes(cfg, bits)
        expect = model_launches(L, steps * fed.rounds, evals * fed.rounds)
        if not bits:
            # the precision gate of the continuous set: round 0, step 0's
            # LoRA gradient of both halves through the split program
            floor_gate("first-step LoRA gradient (split program)", from_exact(
                {role: grads for role, (grads, _, _) in split_first_step(
                    device, cfg, base, fed, clients, exact=True).items()},
                "round 0 step 0 LoRA gradient of both halves"))
        if bits:
            # the precision gate of a quantized boundary (the TF32 control
            # must fail it)
            split_flips_gate(device, cfg, base, fed, clients)
            expect["quant_roundtrip_rows"] = 2 * steps * fed.rounds
        # Both sets add nudged fp32 runs.  The int8 set takes the spread
        # test: its nudged fp32 runs part in a round's loss by more than
        # the TF32 run (up to 4.4e-3 against 1.3e-3 and 6.7e-3), while
        # the final LoRA of twelve of them lies 5.09e-4 to 6.79e-4 from
        # plain and the TF32 run's 9.32e-4 to 9.98e-4.  The fp32 set's
        # final LoRA is measured from fp64: of nine weight sets (the seed
        # and eight nudged), the plain run parts from the fp64 run of the
        # same weights in two (1.08e-4, 1.18e-4), the kernel run in five
        # (7.5e-5 to 1.10e-4), while the nudge moves the fp64 run by at
        # most 5.8e-6, so two fp32 runs sample this spread thinly
        counts, kern = run_case(
            device, cfg, base, fed, data,
            ledger={"lora_params": fed.rounds * C * 2 * half,
                    "activations": fed.rounds * steps * c2,
                    "act_grads": fed.rounds * steps * c4},
            expect=expect, kind="spread" if bits else "continuous",
            seeds=NUDGED_SEEDS, margin="Split int8" if bits else None,
            keep=path)
        per_client = kern.ledger.per_client_round()
        require(all(v == len(clients[ci]["tokens"]) // BATCH * (c2 + c4)
                    + 2 * half for (_, ci), v in per_client.items()),
                f"bytes per client per round {per_client}")
        print(f"  ledger: c2 {c2}, c4 {c4} bytes a step, client half "
              f"{half} each way; per client per round "
              f"{sorted(set(per_client.values()))} bytes (FedLLM: "
              f"{2 * L * 3 * 2 * RANK * d * 4})")
        by_path[path] = counts
    return by_path


def first_batch_clip(device, cfg, base, fed, clients, extras=None,
                     task="classification"):
    """The median per-example gradient norm of client 0's first batch of
    round 0 (with ``extras``, as first_step_inputs) at the run's initial
    LoRA under ``task``'s loss (plain PyTorch on the card)."""
    import torch

    from repro_torch.core.fedavg import make_fns
    from repro_torch.models.factory import build_model

    plain = dataclasses.replace(cfg, kernel_policy="torch")
    lt, batch = first_step_inputs(device, base, fed, clients,
                                  extras=extras)
    fns = make_fns(build_model(plain), fed, task)
    _, rows = fns["per_example_grads"](base, lt, batch)
    norms = torch.linalg.vector_norm(rows, dim=1)
    print("  per-example gradient norms of the first batch: "
          + " ".join(f"{n:.4g}" for n in sorted(norms.tolist())))
    return float(norms.median())


def time_dp_round(device, cfg, base, fed, clients, lora):
    """Host-clock times of the parts of a DP round, each after a warm-up:
    one DP step's per-example gradients through the kernels and plain, as
    the step runs them (one batched forward and backward) and as the
    port ran them before (each of the 16 examples a batch of one: the
    same function on one-example slices), and one round of secure
    aggregation over three LoRA uploads (fixed-point copy to the host,
    pairwise masks, the exact-cancellation check)."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.core import metrics
    from repro_torch.core.fedavg import make_fns, to_device
    from repro_torch.data.loader import epoch_batches
    from repro_torch.models.factory import build_model
    from repro_torch.privacy.secure_agg import SecureAggSession

    batch = to_device(next(iter(epoch_batches(clients[0], BATCH, seed=1))),
                      device)
    ones = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(BATCH)]
    for policy in ("cuda", "torch"):
        step = make_fns(build_model(dataclasses.replace(
            cfg, kernel_policy=policy)), fed)["per_example_grads"]
        for what, passes in (("one batched pass", [batch]),
                             (f"{BATCH} batch-1 passes", ones)):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for one in passes:
                    step(base, lora, one)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            print(f"  [{policy}] one DP step's per-example gradients, "
                  f"{what}: {times[1:]} s (first call {times[0]:.4f} s)")
    times = []
    for rnd in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session, ledger = SecureAggSession(fed), metrics.CommLedger()
        cohort = list(range(len(clients)))
        session.begin_cohort(ledger, rnd, cohort)
        for ci in cohort:
            session.collect(rnd, ci, lora)
        session.deliver(ledger, rnd, [(rnd, ci) for ci in cohort])
        times.append(time.perf_counter() - t0)
    n = sum(t.numel() for t in tree_lib.leaves(lora))
    print(f"  secure aggregation of {len(clients)} uploads of {n} values: "
          f"{times[1:]} s (first {times[0]:.4f} s)")


def run_dp(device, cfg, base, data, steps, evals, lora_bytes):
    """Phase 5: DP-FedLLM (clip C, noise 0, secure aggregation)."""
    from repro_torch.configs.base import FedConfig, PrivacyConfig
    from repro_torch.kernels import dp_clip
    from repro_torch.optim.clip import _clip_scale
    from repro_torch.privacy.secure_agg import key_exchange_bytes

    pub, clients, test = data
    L, C = cfg.n_layers, len(clients)
    print("phase 5: DP-FedLLM case study, gpt2 full width, 2 rounds, "
          "3 clients, DP-SGD clip at the median norm, noise 0, secure "
          "aggregation")
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0,
                    privacy=PrivacyConfig(dp_clip=1.0, secure_agg=True))
    clip = first_batch_clip(device, cfg, base, fed, clients)
    print(f"  C = {clip:.6g}")
    fed = dataclasses.replace(fed, privacy=dataclasses.replace(
        fed.privacy, dp_clip=clip))
    rows_gaps, mean_gaps = dp_first_step_gaps(device, cfg, base, fed,
                                              clients)
    MARGINS["DP first-step rows"] = rows_gaps["kernels"] / floor_gate(
        "first-step per-example gradient rows", rows_gaps)
    MARGINS["DP first step"] = mean_gaps["kernels"] / floor_gate(
        "first-step clipped mean gradient", mean_gaps)

    # the kernel run's norms: count the rows the clip scales (on the card;
    # read after the runs)
    real_norms, seen = dp_clip.dp_clip_norms, []

    def recording_norms(g):
        sq = real_norms(g)
        seen.append(((_clip_scale(sq.sqrt(), clip) < 1).sum(), sq.numel()))
        return sq

    dp_clip.dp_clip_norms = recording_norms
    try:
        dp_steps = steps * fed.rounds
        # one forward and one backward of the batch a DP step, whose
        # backward gives each example's panel gradients (row 4 with an
        # example axis) in place of the summed ones, a site's dA and dB in
        # one launch of the pair
        expect = model_launches(L, dp_steps, evals * fed.rounds)
        expect["lora_panel_examples_pair"] = expect.pop("lora_panel") // 2
        expect.update(dp_clip_norms=dp_steps, dp_clip_acc=dp_steps)
        keys_up, keys_down = key_exchange_bytes(C)
        counts, kern = run_case(
            device, cfg, base, fed, data,
            ledger={"lora_params": fed.rounds * C * 2 * lora_bytes,
                    "secagg_keys": fed.rounds * C * (keys_up + keys_down),
                    "dp_meta": fed.rounds * C * 12},
            expect=expect, margin="DP final LoRA", keep="dp")
        CASES["dp"]["clip"] = clip
    finally:
        dp_clip.dp_clip_norms = real_norms
    clipped = sum(int(n) for n, _ in seen)
    rows = sum(total for _, total in seen)
    print(f"  kernel run: {clipped} of {rows} per-example rows clipped over "
          f"{len(seen)} DP steps")
    time_dp_round(device, cfg, base, fed, clients, kern.final_lora)
    require(rows == dp_steps * BATCH and 0 < clipped < rows,
            f"clipping in {clipped} of {rows} rows")
    require(all(h.epsilon == math.inf for h in kern.history),
            f"epsilon {[h.epsilon for h in kern.history]} at noise 0")
    return counts


def run_recurrent(device):
    """Phase 7: FedLLM on RecurrentGemma-2B at full width and depth (26
    layers: 18 RG-LRU, 8 local attention; random weights from seed 0),
    phase 3's data and checks.  Returns the kernel run's launch counts."""
    import torch

    from repro_torch.configs.base import LOCAL_ATTN, RGLRU, FedConfig
    from repro_torch.configs.recurrentgemma_2b import recurrentgemma_2b
    from repro_torch.data import banking77, partition

    cfg = recurrentgemma_2b()
    print(f"phase 7: FedLLM case study, {cfg.name} full width and depth "
          f"({cfg.param_count() / 1e9:.3f}e9 parameters), 2 rounds, "
          f"3 clients")
    pub, train, test = banking77.paper_splits(cfg.vocab_size,
                                              pad_len=PAD_LEN, scale=0.03)
    clients = partition.iid_partition(train, 3)
    base = family_init(device, cfg)
    kinds, C = cfg.layer_kinds, len(clients)
    n_attn, n_rglru = kinds.count(LOCAL_ATTN), kinds.count(RGLRU)
    # autograd reaches an RG-LRU layer only after the first LoRA-bound
    # (local-attention) layer: before it nothing requires a gradient
    first = kinds.index(LOCAL_ATTN)
    n_rglru_bwd = kinds[first:].count(RGLRU)
    steps = sum(len(c["tokens"]) // BATCH for c in clients)
    evals = len(test["tokens"]) // 64
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0)
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    d = cfg.d_model
    # A (d, r) and B (r, out) of wq, wk and wv in each attention layer
    lora_bytes = n_attn * RANK * ((d + q) + 2 * (d + kv)) * 4
    train_steps, fwd_batches = steps * fed.rounds, evals * fed.rounds
    expect = model_launches(n_attn, train_steps, fwd_batches)
    expect.update(rglru_fwd=n_rglru * (train_steps + fwd_batches),
                  rglru_bwd=n_rglru_bwd * train_steps)
    print(f"  {n_rglru} RG-LRU layers ({n_rglru_bwd} after layer {first}, "
          f"the first with LoRA), {n_attn} local-attention layers; "
          f"{train_steps} train steps, {fwd_batches} eval batches")
    t0 = time.perf_counter()
    floor_gate("first-step LoRA gradient",
               first_step_gaps(device, cfg, base, fed, clients))
    counts, _ = run_case(device, cfg, base, fed, (pub, clients, test),
                         ledger={"lora_params": fed.rounds * C * 2
                                 * lora_bytes},
                         expect=expect, seeds=NUDGED_SEEDS, margin="phase 7")
    print(f"  phase 7 wall_s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    # one DP step's per-example gradients: a forward and a backward of the
    # batch, each LoRA site's dA and dB one launch of the pair
    dp_counts = dp_first_step(device, cfg, base, clients, {
        "lora_fwd": 3 * n_attn, "lora_dx": 3 * n_attn,
        "lora_panel_examples_pair": 3 * n_attn, "flash_fwd": n_attn,
        "flash_dq": n_attn, "flash_dkv": n_attn, "rglru_fwd": n_rglru,
        "rglru_bwd": n_rglru_bwd, "dp_clip_norms": 1, "dp_clip_acc": 1})
    print(f"  phase 7 DP step wall_s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    split_counts = recurrent_split(device, cfg, base, (pub, clients, test),
                                   steps, expect)
    print(f"  phase 7 Split wall_s={time.perf_counter() - t0:.1f}")
    del base
    torch.cuda.empty_cache()
    return counts, dp_counts, split_counts


def recurrent_split(device, cfg, base, data, steps, expect):
    """Phase 7's Split-FedLLM on RecurrentGemma-2B (``cfg``, ``base``) with
    an int(SPLIT_BITS) boundary at SPLIT_LAYER: the flipped-level gate,
    then run_case's spread gates with NUDGED_SEEDS nudged fp32 runs, the
    ledger by hand and the launches of the FedLLM run (``expect``: the
    same layers forward and backward) plus two roundtrips a step.
    Returns the kernel run's launch counts."""
    from repro_torch.configs.base import FedConfig

    pub, clients, test = data
    C, d = len(clients), cfg.d_model
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    print(f"  Split-FedLLM on {cfg.name}, split_layer {SPLIT_LAYER} (the "
          f"client holds pattern groups 0-{SPLIT_LAYER - 1}, layers 0-"
          f"{SPLIT_LAYER * len(cfg.layer_pattern) - 1}), int{SPLIT_BITS} "
          f"boundary:")
    fed = FedConfig(framework="split", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, split_layer=SPLIT_LAYER,
                    activation_quant_bits=SPLIT_BITS)
    MARGINS["RecurrentGemma-2B Split int8 flips"] = split_flips_gate(
        device, cfg, base, fed, clients)
    # by hand: c2 is 1280 rows of 2560 int8 levels, a 4-byte scale a row
    # and 16 int32 labels, c4 the same without the labels; the client
    # half (one local-attention layer a group: A and B of wq, wk and wv,
    # fp32) goes down and up each round
    c2, c4 = split_wire_bytes(cfg, SPLIT_BITS)
    half = SPLIT_LAYER * RANK * ((d + q) + 2 * (d + kv)) * 4
    print(f"  ledger by hand: c2 {c2}, c4 {c4} bytes a step, client half "
          f"{half} bytes each way")
    split_counts, _ = run_case(
        device, cfg, base, fed, (pub, clients, test),
        ledger={"lora_params": fed.rounds * C * 2 * half,
                "activations": fed.rounds * steps * c2,
                "act_grads": fed.rounds * steps * c4},
        expect=dict(expect, quant_roundtrip_rows=2 * steps * fed.rounds),
        kind="spread", seeds=NUDGED_SEEDS,
        margin="RecurrentGemma-2B Split int8")
    return split_counts


def dp_first_step(device, cfg, base, clients, expect, targets=None,
                  margin=None, extras=None, task="classification"):
    """One DP step on ``cfg`` from its weights (phases 7 and 8), LoRA on
    ``targets`` (None: FedConfig's default): DP-SGD (clip at the median
    per-example gradient norm of the first batch, noise 0), the first
    step's (16, P) per-example gradient rows and their clipped mean
    (dp_first_step_gaps) gated from fp64 as phase 5 gates GPT-2's; the
    kernel run's launches must be ``expect``.  With ``margin``, the two
    gates' shares go to MARGINS as "<margin> DP first-step rows" and
    "<margin> DP first step".  ``extras`` (the model's stub embeddings)
    join the batch, as first_step_inputs; ``task`` names the loss.
    Returns the launch counts."""
    from repro_torch.configs.base import FedConfig, PrivacyConfig
    from repro_torch.kernels import ops

    print(f"  DP-SGD first step on {cfg.name} (clip at the median norm, "
          f"noise 0), per-example rows from fp64:")
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0,
                    privacy=PrivacyConfig(dp_clip=1.0, secure_agg=True))
    if targets is not None:
        fed = dataclasses.replace(fed, lora_targets=tuple(targets))
    clip = first_batch_clip(device, cfg, base, fed, clients, extras, task)
    fed = dataclasses.replace(fed, privacy=dataclasses.replace(
        fed.privacy, dp_clip=clip))
    ops.reset_launches()
    rows_gaps, mean_gaps = dp_first_step_gaps(device, cfg, base, fed,
                                              clients, extras, task)
    counts = ops.launches()
    shares = (rows_gaps["kernels"] / floor_gate(
        f"{cfg.name} first-step per-example gradient rows", rows_gaps),
        mean_gaps["kernels"] / floor_gate(
            f"{cfg.name} first-step clipped mean gradient", mean_gaps))
    if margin is not None:
        MARGINS[f"{margin} DP first-step rows"], \
            MARGINS[f"{margin} DP first step"] = shares
    got = {n: k for n, k in counts.items() if k}
    print(f"  {cfg.name} DP step launches (kernel run; the plain runs "
          f"none): {got}")
    require(got == expect, f"{cfg.name} DP step launches {got} != "
            f"expected {expect}")
    return counts


def first_step_inputs(device, base, fed, clients, ci: int = 0,
                      extras=None):
    """The first train step's inputs: the run's initial LoRA (truncated to
    client ``ci``'s rank when ``fed.client_ranks`` gives it one) and
    client ``ci``'s first batch of round 0, on the card, with ``extras``
    (a model's stub embeddings, {name: tensor}) added to it."""
    import torch

    from repro_torch.core.fedavg import to_device
    from repro_torch.data.loader import epoch_batches
    from repro_torch.peft import lora as lora_lib

    lt = lora_lib.init_lora(torch.Generator().manual_seed(fed.seed + 1),
                            base, fed.lora_targets or lora_lib.DEFAULT_TARGETS,
                            fed.lora_rank, fed.lora_alpha)
    if fed.client_ranks:
        lt = lora_lib.maybe_truncate_rank(lt, fed.client_ranks[ci],
                                          fed.lora_rank)
    batch = to_device(next(iter(epoch_batches(
        clients[ci], BATCH, seed=fed.seed * 997))), device)
    return lt, dict(batch, **(extras or {}))


def first_step_grads(device, cfg, base, fed, clients, ci: int = 0,
                     extras=None, task="classification"):
    """The LoRA gradient of FedLLM's first train step (client ``ci``'s
    first batch with ``extras``, the run's initial LoRA, ``task``'s loss)
    under each of each_run(exact=True)'s settings, recomputed under its
    policy and setting (the fp64 run with the batch's floating-point
    entries in fp64 too): {role: gradient leaves}."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.core import tasks
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build_model
    from repro_torch.peft import lora as lora_lib

    lt, batch = first_step_inputs(device, base, fed, clients, ci, extras)
    loss_fn = tasks.get_loss_fn(task)
    grads = {}
    for role, tag, policy in each_run(exact=True):
        model = build_model(dataclasses.replace(cfg, kernel_policy=policy))
        b, l, x = (fp64(base), fp64(lt), fp64(batch)) if role == "exact" \
            else (base, lt, batch)
        with ops.policy_scope(policy):
            live = tree_lib.map_(lambda t: t.detach().requires_grad_(True), l)
            logits, _ = model.forward(lora_lib.bind(
                b, live, fed.lora_alpha,
                lora_lib.tree_rank(live, fed.lora_rank)), x)
            loss, _ = loss_fn(logits, x)
            grads[role] = torch.autograd.grad(loss, tree_lib.leaves(live))
        del b, l, x, logits
    torch.cuda.empty_cache()
    return grads


def first_step_gaps(device, cfg, base, fed, clients, extras=None,
                    task="classification"):
    """Each run's relative L2 distance from the fp64 gradient
    (from_exact) of FedLLM's first train step (first_step_grads, client
    0)."""
    return from_exact(first_step_grads(device, cfg, base, fed, clients,
                                       extras=extras, task=task),
                      "round 0 step 0 LoRA gradient")


def dp_first_step_runs(device, cfg, base, fed, clients, ci: int = 0,
                       extras=None, task="classification"):
    """DP-FedLLM's first train step (client ``ci``'s first batch, the
    run's initial LoRA) under each of each_run(exact=True)'s settings: the
    (B, P) per-example gradient rows of the batched pass and their clipped
    mean, ({role: [rows]}, {role: [clipped mean]})."""
    import torch

    from repro_torch.core.fedavg import make_fns
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build_model
    from repro_torch.privacy import dp as dp_mod

    lt, batch = first_step_inputs(device, base, fed, clients, ci, extras)
    rows, means = {}, {}
    for role, tag, policy in each_run(exact=True):
        model = build_model(dataclasses.replace(cfg, kernel_policy=policy))
        b, l, x = (fp64(base), fp64(lt), fp64(batch)) if role == "exact" \
            else (base, lt, batch)
        with ops.policy_scope(policy):
            _, got = make_fns(model, fed, task)["per_example_grads"](b, l,
                                                                     x)
            rows[role] = [got]
            means[role] = [dp_mod.clipped_grad_mean(got, fed.privacy.dp_clip)]
        del b, l, x
    torch.cuda.empty_cache()
    return rows, means


def dp_first_step_gaps(device, cfg, base, fed, clients, extras=None,
                       task="classification"):
    """dp_first_step_runs of client 0: each run's relative L2 distance from
    the fp64 run's, (rows, clipped mean) (from_exact)."""
    rows, means = dp_first_step_runs(device, cfg, base, fed, clients,
                                     extras=extras, task=task)
    return (from_exact(rows, "round 0 step 0 per-example LoRA gradient "
                       "rows"),
            from_exact(means, "round 0 step 0 clipped mean LoRA gradient"))


def split_first_step(device, cfg, base, fed, clients, exact: bool,
                     seeds: int = 0, extras=None,
                     task="classification") -> dict:
    """Round 0, step 0 of Split-FedLLM (client 0's first batch with
    ``extras``, the run's initial LoRA) through the split program under
    each of
    each_run(exact)'s settings, then plain from ``seeds`` nudged copies of
    the weights (roles "seed <i>"): {role: (the LoRA gradient of both
    halves, the raw boundary activations h, the server's raw gradient of
    them)}."""
    import torch

    from repro_torch.core import split
    from repro_torch.core.fedavg import to_device
    from repro_torch.data.loader import epoch_batches
    from repro_torch.models.factory import build_model
    from repro_torch.peft import lora as lora_lib

    lt = lora_lib.init_lora(torch.Generator().manual_seed(fed.seed + 3),
                            base, fed.lora_targets
                            or lora_lib.default_targets(cfg), fed.lora_rank,
                            fed.lora_alpha)
    batch = dict(to_device(next(iter(epoch_batches(
        clients[0], BATCH, seed=fed.seed * 983))), device), **(extras or {}))

    def settings():
        for role, tag, policy in each_run(exact):
            yield role, policy, None
        for seed in range(seeds):
            yield f"seed {seed}", "torch", seed

    out = {}
    for role, policy, seed in settings():
        sfns = split.make_split_fns(build_model(dataclasses.replace(
            cfg, kernel_policy=policy)), fed, task)
        L = sfns["n_client_layers"]
        b, l, x = (fp64(base), fp64(lt), fp64(batch)) if role == "exact" \
            else (base if seed is None else nudged(base, seed, device), lt,
                  batch)
        c_lt, s_lt = split.split_lora(l, L)
        base_c, base_s = split.split_base(b, L, sfns["enc_dec"])
        _, c_grads, s_grads, h, h_grad = sfns["split_grads"](
            base_c, base_s, c_lt, s_lt, x)
        out[role] = (c_grads + s_grads, h, h_grad)
        del b, l, x, base_c, base_s
    torch.cuda.empty_cache()
    return out


def rwkv_launches(L, n_t, train_steps, fwd_batches):
    """The launches RWKV-6's shapes predict: per layer and batch n_t LoRA
    projections and one WKV forward; per train step their backward (dx
    and two panel grads a projection) and one WKV backward (layer 0's r,
    k and v carry LoRA, so autograd reaches every layer's WKV)."""
    fwd = train_steps + fwd_batches
    return {"lora_fwd": n_t * L * fwd, "lora_dx": n_t * L * train_steps,
            "lora_panel": 2 * n_t * L * train_steps, "rwkv6_fwd": L * fwd,
            "rwkv6_bwd": L * train_steps}


def run_rwkv(device):
    """Phase 8 on RWKV-6 Finch 1.6B at full width and depth (24 rwkv6
    layers, d 2048, 32 heads of 64, V 65536; random weights from seed 0),
    LoRA on w_r/w_k/w_v/w_g, phase 3's data.  FedLLM at full width and
    RWKV6_FEDLLM_LAYERS of its layers (the first of the 24 drawn from
    seed 0, which are the weights ``init`` gives the cut config): the
    first step's gradient gate, then run_case's gates for a chaotic path,
    with NUDGED_SEEDS nudged fp32 runs beside the floor run.  KD (top-k 8,
    int8): client 0's first upload's logits gated from fp64
    (kd_upload_gaps), then one run through the kernels alone (its plain
    rounds take ~20 s each) with its ledger and launches exact.  DP-SGD:
    one step (dp_first_step), its rows and clipped mean from fp64.
    Split (split_layer SPLIT_LAYER): the first step's LoRA gradient of
    both halves through an fp32 boundary from fp64, the flipped-level
    share of an int(SPLIT_BITS) boundary against the fp32 runs', then one
    int8 run through the kernels alone, ledger and launches exact.
    Returns the four kernel runs' launch counts: (FedLLM, KD, DP step,
    Split)."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.rwkv6_1_6b import rwkv6_1_6b
    from repro_torch.data import banking77, partition
    from repro_torch.peft import lora

    cfg = rwkv6_1_6b()
    pub, train, test = banking77.paper_splits(cfg.vocab_size,
                                              pad_len=PAD_LEN, scale=0.03)
    clients = partition.iid_partition(train, 3)
    data = (pub, clients, test)
    base = family_init(device, cfg)
    n_tree = sum(t.numel() for t in tree_lib.leaves(base))
    print(f"phase 8: {cfg.name} full width and depth ({n_tree} parameters "
          f"in the tree, {n_tree * 4 / 1e9:.2f} GB fp32; cfg.param_count() "
          f"{cfg.param_count()}), 2 rounds, 3 clients, LoRA on "
          f"{', '.join(lora.RWKV_TARGETS)}; the FedLLM set at full width "
          f"and {RWKV6_FEDLLM_LAYERS} of its {cfg.n_layers} layers")
    L, C, d = cfg.n_layers, len(clients), cfg.d_model
    steps = sum(len(c["tokens"]) // BATCH for c in clients)
    evals = len(test["tokens"]) // 64
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, lora_targets=lora.RWKV_TARGETS)
    n_t = len(lora.RWKV_TARGETS)
    train_steps, fwd_batches = steps * fed.rounds, evals * fed.rounds
    L6 = RWKV6_FEDLLM_LAYERS
    cfg6 = dataclasses.replace(cfg, n_layers=L6)
    base6 = dict(base, layers=base["layers"][:L6])
    expect = rwkv_launches(L6, n_t, train_steps, fwd_batches)
    print(f"  FedLLM: {L6} rwkv6 layers; {train_steps} train steps, "
          f"{fwd_batches} eval batches; expected launches {expect}")
    t0 = time.perf_counter()
    # The precision gate: the first step's LoRA gradient, before Adam's
    # first update (lr times the gradient's sign) turns the coordinates
    # whose gradient sits at the fp32 noise floor into different steps
    # and the runs part (a round's loss then differs by 1e-2 to 1.4e-1
    # between fp32 plain runs, beyond phase 3's 1e-3)
    floor_gate("first-step LoRA gradient",
               first_step_gaps(device, cfg6, base6, fed, clients))
    counts, _ = run_case(device, cfg6, base6, fed, data,
                         ledger={"lora_params": fed.rounds * C * 2 * L6
                                 * n_t * RANK * (d + d) * 4},
                         expect=expect, kind="spread", seeds=NUDGED_SEEDS,
                         margin=f"RWKV-6 ({L6} layers)")
    del base6
    print(f"  phase 8 FedLLM wall_s={time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    print(f"  KD-FedLLM on {cfg.name}, top-k 8 int8 logits, through the "
          f"kernels:")
    fed = dataclasses.replace(fed, framework="kd", logit_topk=8,
                              logit_quant_bits=8)
    gaps = kd_upload_gaps(device, cfg, base, fed, pub)
    MARGINS["RWKV-6 KD upload"] = gaps["kernels"] / floor_gate(
        "first upload's logits", gaps)
    ledger, expect = kd_expect(
        fed, data, steps, evals,
        lambda train, fwd: rwkv_launches(L, n_t, train, fwd))
    kd_counts, _ = kernel_run(device, cfg, base, fed, data, ledger, expect)
    print(f"  phase 8 KD wall_s={time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    # one forward and one backward of the batch, each LoRA site's dA and
    # dB one launch of the pair
    dp_counts = dp_first_step(device, cfg, base, clients, {
        "lora_fwd": n_t * L, "lora_dx": n_t * L,
        "lora_panel_examples_pair": n_t * L, "rwkv6_fwd": L,
        "rwkv6_bwd": L, "dp_clip_norms": 1, "dp_clip_acc": 1},
        targets=lora.RWKV_TARGETS, margin="RWKV-6")
    print(f"  phase 8 DP step wall_s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    split_counts = rwkv_split(device, cfg, base, data, steps, evals)
    print(f"  phase 8 Split wall_s={time.perf_counter() - t0:.1f}")
    del base
    torch.cuda.empty_cache()
    return counts, kd_counts, dp_counts, split_counts


def rwkv_split(device, cfg, base, data, steps, evals):
    """Phase 8's Split-FedLLM on RWKV-6 (``cfg``, ``base``) at
    SPLIT_LAYER, LoRA on w_r/w_k/w_v/w_g, judged at the first step: the
    LoRA gradient of both halves through an fp32 boundary from fp64, the
    flipped-level share of an int(SPLIT_BITS) boundary; then one int8 run
    through the kernels alone, ledger by hand and launches exact.
    Returns its launch counts."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.peft import lora

    pub, clients, test = data
    L, C, d = cfg.n_layers, len(clients), cfg.d_model
    n_t = len(lora.RWKV_TARGETS)
    print(f"  Split-FedLLM on {cfg.name}, split_layer {SPLIT_LAYER}, judged "
          f"at the first step, then one int{SPLIT_BITS} run through the "
          f"kernels:")
    fed = FedConfig(framework="split", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, split_layer=SPLIT_LAYER,
                    lora_targets=lora.RWKV_TARGETS)
    gaps = from_exact(
        {role: grads for role, (grads, _, _) in split_first_step(
            device, cfg, base, fed, clients, exact=True).items()},
        "round 0 step 0 LoRA gradient of both halves, fp32 boundary")
    MARGINS["RWKV-6 Split fp32 first step"] = gaps["kernels"] / floor_gate(
        "first-step LoRA gradient (split program)", gaps)
    fed = dataclasses.replace(fed, activation_quant_bits=SPLIT_BITS)
    MARGINS["RWKV-6 Split int8 flips"] = split_flips_gate(device, cfg, base,
                                                          fed, clients)
    # by hand: c2 is 1280 rows of 2048 int8 levels, a 4-byte scale a row
    # and 16 int32 labels, c4 the same without the labels; the client
    # half (2 layers x 4 targets x (A + B), fp32) down and up each round
    c2, c4 = split_wire_bytes(cfg, SPLIT_BITS)
    half = SPLIT_LAYER * n_t * RANK * (d + d) * 4
    print(f"  ledger by hand: c2 {c2}, c4 {c4} bytes a step, client half "
          f"{half} bytes each way")
    split_counts, _ = kernel_run(
        device, cfg, base, fed, data,
        {"lora_params": fed.rounds * C * 2 * half,
         "activations": fed.rounds * steps * c2,
         "act_grads": fed.rounds * steps * c4},
        dict(rwkv_launches(L, n_t, steps * fed.rounds, evals * fed.rounds),
             quant_roundtrip_rows=2 * steps * fed.rounds))
    return split_counts


def live_targets(base, targets):
    """(tree, leaves): a copy of ``base`` whose targeted weights are fresh
    leaves that require a gradient, and those leaves in tree order."""
    live = []

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if key in targets and t is not None and t.dim() == 2:
            t = t.detach().requires_grad_(True)
            live.append(t)
        return t

    return walk(base), live


def run_base_grad(device):
    """Phase 9: the gradient of the classification loss with respect to
    the bound base weights (wq, wk, wv of all 12 layers) and the LoRA
    factors, at the full width of GPT-2 (seed-0 weights), on client 0's
    first batch of phase 3 with the run's initial LoRA, under each of
    each_run(exact=True)'s settings.  Both trees are gated as first_step_gaps'
    gradient is; launch counts exact.  Returns the kernel run's counts."""
    import torch

    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.gpt2_small import gpt2
    from repro_torch.core import tasks
    from repro_torch.core.fedavg import to_device
    from repro_torch.data import banking77, partition
    from repro_torch.data.loader import epoch_batches
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build_model
    from repro_torch import tree as tree_lib
    from repro_torch.peft import lora as lora_lib

    cfg = gpt2()
    L, targets = cfg.n_layers, lora_lib.DEFAULT_TARGETS
    print(f"phase 9: gradient with respect to the bound base weights, gpt2 "
          f"full width, LoRA rank {RANK} on {', '.join(targets)} of {L} "
          f"layers, one forward and backward")
    _, train, _ = banking77.paper_splits(cfg.vocab_size, pad_len=PAD_LEN,
                                         scale=0.03)
    clients = partition.iid_partition(train, 3)
    base = build_model(cfg).init(torch.Generator().manual_seed(0), device)
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0)
    lt = lora_lib.init_lora(torch.Generator().manual_seed(fed.seed + 1),
                            base, targets, fed.lora_rank, fed.lora_alpha)
    batch = to_device(next(iter(epoch_batches(
        clients[0], BATCH, seed=fed.seed * 997))), device)
    loss_fn = tasks.get_loss_fn("classification")
    grads, counts = {}, {}
    for role, tag, policy in each_run(exact=True):
        model = build_model(dataclasses.replace(cfg, kernel_policy=policy))
        b, l = (fp64(base), fp64(lt)) if role == "exact" else (base, lt)
        live_base, ws = live_targets(b, targets)
        live = tree_lib.map_(lambda t: t.detach().requires_grad_(True), l)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, _ = model.forward(lora_lib.bind(live_base, live,
                                                fed.lora_alpha, fed.lora_rank),
                                  batch)
        loss, _ = loss_fn(logits, batch)
        got = torch.autograd.grad(loss, ws + tree_lib.leaves(live))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[role] = ops.launches()
        require(all(bool(torch.isfinite(t).all()) for t in got),
                f"[{tag}] gradient not finite")
        grads[role] = (got[:len(ws)], got[len(ws):])
        norm = sum(float((t ** 2).sum()) for t in grads[role][0]) ** 0.5
        print(f"  [{tag}] loss {float(loss.detach()):.6f}, |dW| {norm:.4e} "
              f"over {len(ws)} weights, wall_s={wall:.3f} launches="
              f"{ {k: n for k, n in counts[role].items() if n} }")
    for i, what in enumerate(("dW of the bound base weights",
                              "LoRA gradient")):
        floor_gate(what, from_exact(
            {role: g[i] for role, g in grads.items()}, what))
    expect = model_launches(L, 1, 0)
    expect["lora_dw"] = 3 * L
    got = {name: n for name, n in counts["kernels"].items() if n}
    require(got == expect, f"launches {got} != expected {expect}")
    for role in counts.keys() - {"kernels"}:
        require(all(n == 0 for n in counts[role].values()),
                f"plain run launched kernels: {counts[role]}")
    del base, grads
    torch.cuda.empty_cache()
    return counts["kernels"]


def spmd_first_step(device, cfg, base, fed, clients):
    """The spmd backend's first stacked train step through the kernels:
    every client's first batch of round 0 (first_step_inputs) against the
    run's initial LoRA stacked for the clients, the gradient that the
    stacked train step takes (make_fns' ``grads_clients``, the body of
    ``train_step_clients``) under policy ``cuda`` (the client-axis
    kernels).  Returns each client's LoRA gradient leaves."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.core import fed_spmd
    from repro_torch.core.fedavg import make_fns
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build_model

    C = len(clients)
    inputs = [first_step_inputs(device, base, fed, clients, ci)
              for ci in range(C)]
    slt = fed_spmd.stack_for_clients(inputs[0][0], C)
    batch = {k: torch.cat([b[k] for _, b in inputs]) for k in inputs[0][1]}
    fns = make_fns(build_model(dataclasses.replace(cfg, kernel_policy="cuda")),
                   fed)
    with ops.policy_scope("cuda"):
        _, grads = fns["grads_clients"](base, slt, batch)
    grads = tree_lib.leaves(grads)
    return [[g[c] for g in grads] for c in range(C)]


def run_spmd(device):
    """Phase 10: the spmd backend (the 3 clients stacked on a leading
    axis) at full gpt2 width, from phase 3's weights and data, through
    the kernels and plain, each run held to the sequential runs of phases
    3, 4 and 6 (CASES): FedLLM (each client's first stacked step's LoRA
    gradient and the final LoRA gated from phase 3's fp64 runs with phase
    3's limits), KD top-k 8 int8 (phase 4's spread gates) and Split int8
    (phase 6's final LoRA and launch counts, bit for bit); the ledger and
    client FLOPs equal the sequential runs', and the launch counts the
    stacked shapes' (model_launches with ``clients``).  Returns {path:
    kernel-run launch counts}."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.gpt2_small import gpt2
    from repro_torch.core.rounds import run_federated
    from repro_torch.data import banking77, partition
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build_model

    cfg = gpt2()
    pub, train, test = banking77.paper_splits(cfg.vocab_size,
                                              pad_len=PAD_LEN, scale=0.03)
    clients = partition.iid_partition(train, CLIENTS)
    data = (pub, clients, test)
    base = build_model(cfg).init(torch.Generator().manual_seed(0), device)
    L, C = cfg.n_layers, len(clients)
    stacked = max(len(c["tokens"]) // BATCH for c in clients)  # per round
    evals = len(test["tokens"]) // 64
    pub_batches = -(-len(pub["tokens"]) // 64)

    def run(fed, policy, expect):
        ops.reset_launches()
        t0 = time.perf_counter()
        res = run_federated(dataclasses.replace(cfg, kernel_policy=policy),
                            fed, pub, clients, test, batch_size=BATCH,
                            eval_batch=64, device=device, base=base)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launches()
        for h in res.history:
            require(math.isfinite(h.loss) and 0.0 <= h.accuracy <= 1.0,
                    f"round {h.round} metrics out of range")
            print(f"  [spmd {policy}] round {h.round}: acc={h.accuracy:.4f} "
                  f"loss={h.loss:.6f} wall_s={h.seconds:.3f}")
        print(f"  [spmd {policy}] run wall_s={wall:.3f} launches="
              f"{ {n: k for n, k in counts.items() if k} }")
        want = {n: k for n, k in expect.items() if k} if policy == "cuda" \
            else {}
        require({n: k for n, k in counts.items() if k} == want,
                f"spmd {policy} launches {counts} != expected {want}")
        return res, counts

    def same_accounting(res, seq, what):
        require(res.ledger.by_name() == seq.ledger.by_name(),
                f"{what}: ledger by_name {res.ledger.by_name()} != "
                f"{seq.ledger.by_name()}")
        require(res.ledger.per_client_round() == seq.ledger.per_client_round(),
                f"{what}: ledger per_client_round")
        require(res.client_flops == seq.client_flops, f"{what}: client FLOPs")

    def round_times(path, runs):
        for what, res in runs:
            print(f"  {path} round wall_s, {what}: "
                  + ", ".join(f"{h.seconds:.3f}" for h in res.history))

    by_path = {}
    print(f"phase 10: the spmd backend ({C} clients stacked), gpt2 full "
          f"width, 2 rounds: FedLLM")
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, backend="spmd")
    seq = CASES["fedllm"]
    for ci, grads in enumerate(spmd_first_step(device, cfg, base, fed,
                                               clients)):
        runs = first_step_grads(device, cfg, base, fed, clients, ci)
        runs["kernels"] = grads
        floor_gate(f"client {ci}'s first-step LoRA gradient, stacked "
                   f"kernel step", from_exact(runs, f"round 0 step 0 LoRA "
                                              f"gradient of client {ci}"))
    expect = add_counts(model_launches(L, stacked * fed.rounds, 0, True),
                        model_launches(L, 0, evals * fed.rounds))
    res = {}
    for policy in ("cuda", "torch"):
        res[policy], counts = run(fed, policy, expect)
        same_accounting(res[policy], seq["results"]["kernels"],
                        f"FedLLM spmd {policy}")
        if policy == "cuda":
            by_path["fedllm_spmd"] = counts
    exact, plain = seq["results"]["exact"], seq["results"]["plain"]
    for policy, r in res.items():
        share, rel, worst = lora_gap(r.final_lora, exact.final_lora)
        print(f"  final LoRA spmd {policy} vs phase 3's fp64: relative L2 "
              f"{rel:.3e} (limit {seq['limits']['lora']:.3e}, "
              f"{rel / seq['limits']['lora']:.3f} of it), outside atol "
              f"5e-5/rtol 5e-4 {share:.3e}, max abs {worst:.3e}")
        for h, hp, lim in zip(r.history, plain.history,
                              seq["limits"]["loss"]):
            print(f"  round {h.round} loss spmd {policy} vs phase 3's "
                  f"plain: {abs(h.loss - hp.loss):.3e} (limit {lim:.3e})")
    kern = res["cuda"]
    require(lora_gap(kern.final_lora, exact.final_lora)[1]
            <= seq["limits"]["lora"], "FedLLM spmd: final LoRA of the "
            "kernel run off phase 3's fp64 run beyond phase 3's limit")
    require(all(abs(h.loss - hp.loss) <= lim for h, hp, lim in zip(
        kern.history, plain.history, seq["limits"]["loss"])),
        "FedLLM spmd: round loss of the kernel run off phase 3's plain run")
    round_times("FedLLM", [("spmd kernels", kern), ("spmd plain",
                                                    res["torch"]),
                           ("sequential kernels", seq["results"]["kernels"]),
                           ("sequential plain", plain)])

    print("phase 10: FedLLM, async at max_staleness 0, spmd, against the "
          "sync spmd kernel run")
    r0, counts = run(dataclasses.replace(fed, aggregation="async",
                                         max_staleness=0), "cuda", expect)
    same_accounting(r0, kern, "FedLLM spmd async at max_staleness 0")
    require([(h.loss, h.accuracy) for h in r0.history]
            == [(h.loss, h.accuracy) for h in kern.history]
            and all(torch.equal(a, b) for a, b in zip(
                tree_lib.leaves(r0.final_lora),
                tree_lib.leaves(kern.final_lora))),
            "FedLLM spmd async at max_staleness 0: round metrics or final "
            "LoRA differ from the sync spmd kernel run")
    print("  async at max_staleness 0: round metrics, ledger, FLOPs, launches "
          "and final LoRA bit-identical to the sync spmd kernel run")
    by_path["fedllm_spmd_async0"] = counts

    print("phase 10: KD, top-k 8 int8 logits, spmd")
    fed = FedConfig(framework="kd", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, logit_topk=8, logit_quant_bits=8,
                    backend="spmd")
    seq = CASES["kd"]
    R, kd_steps = fed.rounds, fed.kd_epochs * pub_batches
    # stacked: b1 train steps and b8 distillation (one KD forward and
    # backward each), b2 logits; one model: b5 distillation, b6 logits
    # and evaluation; the b3 top-k upload a client and round
    expect = add_counts(
        model_launches(L, (stacked + kd_steps) * R, pub_batches * R, True),
        model_launches(L, kd_steps * R, (pub_batches + evals) * R),
        {"kd_fwd": 2 * kd_steps * R, "kd_bwd": 2 * kd_steps * R,
         "topk_quantize": C * R})
    res = {}
    for policy in ("cuda", "torch"):
        res[policy], counts = run(fed, policy, expect)
        same_accounting(res[policy], seq["results"]["kernels"],
                        f"KD spmd {policy}")
        if policy == "cuda":
            by_path["kd_spmd"] = counts
    plain = seq["results"]["plain"]
    for policy, r in res.items():
        rel = lora_gap(r.final_lora, plain.final_lora)[1]
        print(f"  final LoRA spmd {policy} vs phase 4's plain: relative L2 "
              f"{rel:.3e} (limit {seq['limits']['lora']:.3e}, "
              f"{rel / seq['limits']['lora']:.3f} of it)")
        for h, hp, lim in zip(r.history, plain.history,
                              seq["limits"]["loss"]):
            print(f"  round {h.round} loss spmd {policy} vs phase 4's "
                  f"plain: {abs(h.loss - hp.loss):.3e} (limit {lim:.3e})")
    kern = res["cuda"]
    require(lora_gap(kern.final_lora, plain.final_lora)[1]
            <= seq["limits"]["lora"], "KD spmd: final LoRA of the kernel "
            "run off phase 4's plain run beyond phase 4's spread limit")
    require(all(abs(h.loss - hp.loss) <= lim for h, hp, lim in zip(
        kern.history, plain.history, seq["limits"]["loss"])),
        "KD spmd: round loss of the kernel run beyond phase 4's limit")
    round_times("KD", [("spmd kernels", kern), ("spmd plain", res["torch"]),
                       ("sequential kernels", seq["results"]["kernels"]),
                       ("sequential plain", plain)])

    print(f"phase 10: Split-FedLLM, split_layer {SPLIT_LAYER}, "
          f"int{SPLIT_BITS} boundary, spmd")
    fed = FedConfig(framework="split", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, split_layer=SPLIT_LAYER,
                    activation_quant_bits=SPLIT_BITS, backend="spmd")
    seq = CASES["split"]
    for policy, role in (("cuda", "kernels"), ("torch", "plain")):
        # the server half threads client after client: the sequential
        # run's split steps on the same batches, so the same launches
        r, counts = run(fed, policy, seq["counts"][role])
        same_accounting(r, seq["results"][role], f"Split spmd {policy}")
        require(all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(r.final_lora),
            tree_lib.leaves(seq["results"][role].final_lora))),
            f"Split spmd {policy}: final LoRA differs from phase 6's "
            f"sequential {role} run")
        require([h.loss for h in r.history]
                == [h.loss for h in seq["results"][role].history],
                f"Split spmd {policy}: round losses differ from phase 6's")
        print(f"  Split spmd {policy}: final LoRA, round losses and launches "
              f"bit-identical to phase 6's sequential {role} run")
        round_times("Split", [(f"spmd {role}", r),
                              (f"sequential {role}", seq["results"][role])])
        if policy == "cuda":
            by_path["split_spmd"] = counts

    by_path["dp_spmd"] = run_spmd_dp(device, cfg, base, data, run,
                                     same_accounting, round_times)
    del base
    torch.cuda.empty_cache()
    return by_path


def spmd_dp_first_step(device, cfg, base, fed, clients):
    """The spmd backend's first stacked DP-SGD step through the kernels:
    every client's first batch of round 0 against the run's initial LoRA
    stacked for the clients, the (C, B, P) per-example rows of the stacked
    pass (make_fns' ``per_example_grads_clients``) and each client's
    clipped mean (privacy/dp.clipped_grad_mean_clients) under policy
    ``cuda``.  Row 14ᶜ's mean is held bit for bit, client by client, to
    one dp_clip_acc launch on the client's rows (the same norms).  Returns
    (rows, means)."""
    import torch

    from repro_torch.core import fed_spmd
    from repro_torch.core.fedavg import make_fns
    from repro_torch.kernels import dp_clip, ops
    from repro_torch.models.factory import build_model
    from repro_torch.privacy import dp as dp_mod

    C = len(clients)
    inputs = [first_step_inputs(device, base, fed, clients, ci)
              for ci in range(C)]
    slt = fed_spmd.stack_for_clients(inputs[0][0], C)
    batch = {k: torch.cat([b[k] for _, b in inputs]) for k in inputs[0][1]}
    fns = make_fns(build_model(dataclasses.replace(cfg, kernel_policy="cuda")),
                   fed)
    clip = fed.privacy.dp_clip
    with ops.policy_scope("cuda"):
        _, rows = fns["per_example_grads_clients"](base, slt, batch)
        means = dp_mod.clipped_grad_mean_clients(rows, clip)
    B, P = rows.shape[1:]
    sq = dp_clip.dp_clip_norms(rows.view(C * B, P)).view(C, B)
    for c in range(C):
        require(torch.equal(means[c], dp_clip.dp_clip_acc(rows[c], sq[c],
                                                          clip)),
                f"spmd DP first step: client {c}'s clipped mean is not the "
                f"bits of dp_clip_acc on its rows")
    print(f"  the stacked step's ({C}, {B}, {P}) rows: each client's clipped "
          f"mean (dp_clip_acc_clients) the bits of dp_clip_acc on its rows")
    return rows, means


def run_spmd_dp(device, cfg, base, data, run, same_accounting, round_times):
    """Phase 10's DP-FedLLM under spmd: phase 5's clip C, noise 0, secure
    aggregation, the 3 clients stacked.  Each client's (B, P) per-example
    rows and clipped mean of the first stacked step gated from fp64 as
    phase 5 gates client 0's; one kernel run: the ledger, client FLOPs
    and epsilon those of phase 5's sequential kernel run, the final LoRA
    from phase 5's fp64 run within phase 5's limit, each round's loss
    within phase 5's limit of its plain run; a stacked step launches 36
    lora_panel_examples_pair over the C·B examples, one dp_clip_norms and
    one dp_clip_acc_clients, no lora_panel_clients.  Returns the launch
    counts."""
    from repro_torch.configs.base import FedConfig, PrivacyConfig
    from repro_torch.kernels import lora_matmul as lm

    pub, clients, test = data
    L, C = cfg.n_layers, len(clients)
    dp = CASES["dp"]
    print(f"phase 10: DP-FedLLM, spmd ({C} clients stacked), phase 5's clip "
          f"C = {dp['clip']:.6g}, noise 0, secure aggregation")
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, backend="spmd",
                    privacy=PrivacyConfig(dp_clip=dp["clip"], secure_agg=True))
    rows, means = spmd_dp_first_step(device, cfg, base, fed, clients)
    for ci in range(C):
        runs_rows, runs_means = dp_first_step_runs(device, cfg, base, fed,
                                                   clients, ci)
        runs_rows["kernels"], runs_means["kernels"] = [rows[ci]], [means[ci]]
        floor_gate(f"client {ci}'s first-step per-example rows, stacked "
                   f"kernel step", from_exact(
                       runs_rows, f"round 0 step 0 per-example rows of "
                       f"client {ci}"))
        floor_gate(f"client {ci}'s first-step clipped mean, stacked kernel "
                   f"step", from_exact(runs_means, f"round 0 step 0 clipped "
                                       f"mean of client {ci}"))
    del rows, means
    stacked = max(len(c["tokens"]) // BATCH for c in clients) * fed.rounds
    evals = len(test["tokens"]) // 64
    expect = add_counts(model_launches(L, stacked, 0, True),
                        model_launches(L, 0, evals * fed.rounds))
    # one pass a stacked step: each LoRA site's per-example dA and dB in
    # one pair launch over the C·B examples, in place of the client-axis
    # panel gradient; the norms over the C·B rows, the clip-accumulate with
    # the client on a grid axis
    expect["lora_panel_examples_pair"] = expect.pop("lora_panel_clients") // 2
    expect.update(dp_clip_norms=stacked, dp_clip_acc_clients=stacked)
    real_pair, examples = lm.lora_panel_examples_pair, set()

    def pair(x, gb, g, xa):
        examples.add(x.shape[0])
        return real_pair(x, gb, g, xa)

    lm.lora_panel_examples_pair = pair
    try:
        kern, counts = run(fed, "cuda", expect)
    finally:
        lm.lora_panel_examples_pair = real_pair
    require(examples == {C * BATCH}, f"spmd DP: pair launches over "
            f"{sorted(examples)} examples, expected {C * BATCH}")
    seq = dp["results"]["kernels"]
    same_accounting(kern, seq, "DP spmd")
    require([h.epsilon for h in kern.history]
            == [h.epsilon for h in seq.history] == [math.inf] * fed.rounds,
            f"DP spmd: epsilon {[h.epsilon for h in kern.history]}")
    exact, plain = dp["results"]["exact"], dp["results"]["plain"]
    share, rel, worst = lora_gap(kern.final_lora, exact.final_lora)
    print(f"  final LoRA spmd kernels vs phase 5's fp64: relative L2 "
          f"{rel:.3e} (limit {dp['limits']['lora']:.3e}, "
          f"{rel / dp['limits']['lora']:.3f} of it), outside atol 5e-5/rtol "
          f"5e-4 {share:.3e}, max abs {worst:.3e}")
    MARGINS["DP spmd final LoRA"] = rel / dp["limits"]["lora"]
    require(rel <= dp["limits"]["lora"], "DP spmd: final LoRA of the kernel "
            "run off phase 5's fp64 run beyond phase 5's limit")
    for h, hp, lim in zip(kern.history, plain.history, dp["limits"]["loss"]):
        print(f"  round {h.round} loss spmd kernels vs phase 5's plain: "
              f"{abs(h.loss - hp.loss):.3e} (limit {lim:.3e})")
        require(abs(h.loss - hp.loss) <= lim, "DP spmd: round loss of the "
                "kernel run off phase 5's plain run beyond phase 5's limit")
    print(f"  a stacked step: {3 * L} pair "
          f"launches over {C * BATCH} examples, one dp_clip_norms, one "
          f"dp_clip_acc_clients")
    round_times("DP-FedLLM", [("spmd kernels", kern),
                              ("sequential kernels", seq),
                              ("sequential plain", plain)])
    return counts


def lora_deltas(tree, alpha: float):
    """Each LoRA leaf's delta alpha / r * A @ B, in tree order: what two
    svd-harmonized trees are compared through, the signs of their
    factors' columns being the SVD library's choice."""
    from repro_torch import tree as tree_lib
    from repro_torch.peft import lora as lora_lib

    return tree_lib.leaves(lora_lib.map_factors(
        lambda f: f["a"] @ f["b"] * (alpha / f["a"].shape[-1]), tree))


def async_reckoning(seed: int, n_clients: int, max_staleness: int,
                    rounds: int):
    """An async run's jobs, reckoned by hand with numpy: a client's
    slowness drawn from ``seed``, each job's delay a Binomial(max_staleness
    + 1, slowness) draw from the client's own generator (seeded (seed,
    7919, client)), a client free again once its job has arrived.
    Returns (starts [(round, client)], arrivals [(round, client,
    staleness)])."""
    import numpy as np

    slowness = np.random.default_rng(seed).uniform(0.15, 0.85, n_clients)
    gens = [np.random.default_rng((seed, 7919, ci))
            for ci in range(n_clients)]
    busy, starts, arrivals = {}, [], []
    for rnd in range(rounds):
        for ci in range(n_clients):
            if ci not in busy:
                delay = int(gens[ci].binomial(max_staleness + 1,
                                              slowness[ci])) \
                    if max_staleness > 0 else 0
                busy[ci] = (rnd, rnd + delay)
                starts.append((rnd, ci))
        for ci in sorted(c for c, (_, end) in busy.items() if end == rnd):
            arrivals.append((rnd, ci, rnd - busy.pop(ci)[0]))
    return starts, arrivals


def run_hetero(device):
    """Phase 11: FedLLM at full gpt2 width from phase 3's weights and data
    with heterogeneous client ranks (2, 4, RANK): the first train step of
    clients 0 and 1 (ranks 2 and 4, the fused LoRA kernels' rank padded
    to one n8 fragment) gated from fp64; then run_case's continuous gates
    under ``hetero_agg`` "zeropad" and "svd" (svd's final LoRA compared
    through its deltas, lora_deltas), and async aggregation with
    max_staleness 2 over 4 rounds (zeropad), ledger reckoned by hand
    (async_reckoning) and launches exact; and async with max_staleness 0,
    which must give phase 3's sync kernel run (CASES) to the last bit.
    Returns the sum of the kernel runs' launch counts."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.gpt2_small import gpt2
    from repro_torch.data import banking77, partition
    from repro_torch.models.factory import build_model

    cfg = gpt2()
    pub, train, test = banking77.paper_splits(cfg.vocab_size,
                                              pad_len=PAD_LEN, scale=0.03)
    clients = partition.iid_partition(train, CLIENTS)
    data = (pub, clients, test)
    base = build_model(cfg).init(torch.Generator().manual_seed(0), device)
    L, C, d = cfg.n_layers, len(clients), cfg.d_model
    ranks = (2, 4, RANK)
    client_steps = [len(c["tokens"]) // BATCH for c in clients]
    evals = len(test["tokens"]) // 64

    def lora_bytes(r):
        # A (d, r) and B (r, d) of wq, wk and wv in every layer, fp32
        return L * 3 * 2 * r * d * 4

    print(f"phase 11: heterogeneous client ranks {ranks} and async "
          f"aggregation, FedLLM, gpt2 full width")
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, client_ranks=ranks)
    for ci in (0, 1):
        floor_gate(f"client {ci}'s first-step LoRA gradient at rank "
                   f"{ranks[ci]}", from_exact(
                       first_step_grads(device, cfg, base, fed, clients, ci),
                       f"round 0 step 0 LoRA gradient of client {ci}"))
    # every client downloads the global tree truncated to its rank and
    # uploads its tree at that rank, each round
    ledger = {"lora_params": fed.rounds * 2 * sum(lora_bytes(r)
                                                  for r in ranks)}
    expect = model_launches(L, sum(client_steps) * fed.rounds,
                            evals * fed.rounds)
    counts = []
    for agg in ("zeropad", "svd"):
        print(f"phase 11: hetero_agg {agg!r}, 2 rounds")
        c, _ = run_case(
            device, cfg, base, dataclasses.replace(fed, hetero_agg=agg),
            data, ledger=ledger, expect=expect, margin=f"hetero {agg}",
            view=None if agg == "zeropad" else
            (lambda t: lora_deltas(t, fed.lora_alpha)), keep=f"hetero {agg}")
        counts.append(c)

    rounds, staleness = 4, 2
    print(f"phase 11: async, max_staleness {staleness}, {rounds} rounds, "
          f"ranks {ranks}, zeropad")
    fed = dataclasses.replace(fed, aggregation="async", rounds=rounds,
                              max_staleness=staleness)
    starts, arrivals = async_reckoning(fed.seed + 17, C, staleness, rounds)
    print(f"  by hand: jobs started {starts}; arrivals (round, client, "
          f"staleness) {arrivals}")
    require(any(0 < s <= staleness for _, _, s in arrivals)
            and any(s > staleness for _, _, s in arrivals),
            "the schedule keeps no stale update or discards none")
    c, _ = run_case(
        device, cfg, base, fed, data,
        ledger={"lora_params": sum(lora_bytes(ranks[ci])
                                   for _, ci in starts)
                + sum(lora_bytes(ranks[ci]) for _, ci, _ in arrivals)},
        expect=model_launches(L, sum(client_steps[ci] for _, ci in starts),
                              evals * rounds), margin="async", keep="async")
    counts.append(c)

    print("phase 11: async, max_staleness 0, against phase 3's sync "
          "kernel run")
    seq = CASES["fedllm"]
    sync = seq["results"]["kernels"]
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, aggregation="async", max_staleness=0)
    c, res = kernel_run(device, cfg, base, fed, data, sync.ledger.by_name(),
                        {n: k for n, k in seq["counts"]["kernels"].items()
                         if k})
    require(res.ledger.per_client_round() == sync.ledger.per_client_round()
            and res.client_flops == sync.client_flops,
            "async at max_staleness 0: ledger or FLOPs differ from sync")
    require([(h.loss, h.accuracy) for h in res.history]
            == [(h.loss, h.accuracy) for h in sync.history],
            "async at max_staleness 0: round metrics differ from sync")
    require(all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(res.final_lora), tree_lib.leaves(sync.final_lora))),
        "async at max_staleness 0: final LoRA differs from sync")
    print("  async at max_staleness 0: round metrics, ledger, FLOPs, launches "
          "and final LoRA bit-identical to phase 3's sync kernel run")
    counts.append(c)
    del base
    torch.cuda.empty_cache()
    return add_counts(*counts)


def run_spmd_hetero(device):
    """Phase 10 after phase 11, whose runs are its yardsticks (CASES):
    the spmd backend with client ranks (2, 4, RANK), one stacked program
    a rank bucket (here one client each), at full gpt2 width from phase
    3's weights and data, through the kernels: hetero_agg "zeropad" and
    "svd" (2 rounds) and async aggregation with max_staleness 2 over 4
    rounds (zeropad), each held to phase 11's sequential runs with phase
    11's continuous gates: the final LoRA from phase 11's fp64 run within
    its limit (svd's through its deltas, lora_deltas), each round's loss
    within its limit of phase 11's plain run; the ledger (the async run's
    reckoned by hand, async_reckoning) and client FLOPs those of phase
    11's kernel runs; launches exact, the LoRA ones the client-axis
    kernels'.  Returns the sum of the launch counts."""
    import torch

    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.gpt2_small import gpt2
    from repro_torch.data import banking77, partition
    from repro_torch.models.factory import build_model

    cfg = gpt2()
    pub, train, test = banking77.paper_splits(cfg.vocab_size,
                                              pad_len=PAD_LEN, scale=0.03)
    clients = partition.iid_partition(train, CLIENTS)
    data = (pub, clients, test)
    base = build_model(cfg).init(torch.Generator().manual_seed(0), device)
    L, C, d = cfg.n_layers, len(clients), cfg.d_model
    ranks = (2, 4, RANK)
    client_steps = [len(c["tokens"]) // BATCH for c in clients]
    evals = len(test["tokens"]) // 64

    def lora_bytes(r):
        return L * 3 * 2 * r * d * 4

    def held(res, seq, what, view=lambda t: t):
        """The spmd kernel run ``res`` against phase 11's runs ``seq``."""
        kern = seq["results"]["kernels"]
        require(res.ledger.per_client_round()
                == kern.ledger.per_client_round()
                and res.client_flops == kern.client_flops,
                f"{what}: ledger or client FLOPs differ from phase 11's")
        share, rel, worst = lora_gap(view(res.final_lora),
                                     view(seq["results"]["exact"].final_lora))
        lim = seq["limits"]["lora"]
        print(f"  final LoRA spmd kernels vs phase 11's fp64: relative L2 "
              f"{rel:.3e} (limit {lim:.3e}, {rel / lim:.3f} of it), outside "
              f"atol 5e-5/rtol 5e-4 {share:.3e}, max abs {worst:.3e}")
        MARGINS[what] = rel / lim
        require(rel <= lim, f"{what}: final LoRA off phase 11's fp64 run "
                f"beyond phase 11's limit")
        plain = seq["results"]["plain"]
        for h, hp, lim in zip(res.history, plain.history,
                              seq["limits"]["loss"]):
            print(f"  round {h.round} loss spmd kernels vs phase 11's plain: "
                  f"{abs(h.loss - hp.loss):.3e} (limit {lim:.3e})")
            require(abs(h.loss - hp.loss) <= lim, f"{what}: round loss off "
                    f"phase 11's plain run beyond its limit")
        print(f"  round wall_s, spmd kernels: "
              + ", ".join(f"{h.seconds:.3f}" for h in res.history)
              + "; phase 11's sequential kernels: "
              + ", ".join(f"{h.seconds:.3f}" for h in kern.history))

    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, client_ranks=ranks, backend="spmd")
    # each bucket (one client here) runs its own steps stacked
    expect = nonzero(add_counts(
        model_launches(L, sum(client_steps) * fed.rounds, 0, True),
        model_launches(L, 0, evals * fed.rounds)))
    counts = []
    for agg in ("zeropad", "svd"):
        print(f"phase 10 (after phase 11): spmd, client ranks {ranks}, "
              f"hetero_agg {agg!r}, 2 rounds")
        seq = CASES[f"hetero {agg}"]
        c, res = kernel_run(device, cfg, base,
                            dataclasses.replace(fed, hetero_agg=agg), data,
                            seq["results"]["kernels"].ledger.by_name(),
                            expect)
        held(res, seq, f"hetero {agg} spmd",
             (lambda t: t) if agg == "zeropad" else
             (lambda t: lora_deltas(t, fed.lora_alpha)))
        counts.append(c)

    rounds, staleness = 4, 2
    print(f"phase 10 (after phase 11): spmd, async, max_staleness "
          f"{staleness}, {rounds} rounds, ranks {ranks}, zeropad")
    fed = dataclasses.replace(fed, aggregation="async", rounds=rounds,
                              max_staleness=staleness)
    starts, arrivals = async_reckoning(fed.seed + 17, C, staleness, rounds)
    c, res = kernel_run(
        device, cfg, base, fed, data,
        {"lora_params": sum(lora_bytes(ranks[ci]) for _, ci in starts)
         + sum(lora_bytes(ranks[ci]) for _, ci, _ in arrivals)},
        nonzero(add_counts(
            model_launches(L, sum(client_steps[ci] for _, ci in starts), 0,
                           True),
            model_launches(L, 0, evals * rounds))))
    held(res, CASES["async"], "async spmd")
    counts.append(c)
    del base
    torch.cuda.empty_cache()
    return add_counts(*counts)


COHORT_CLIENTS, COHORT_SIZE, COHORT_EDGES = 12, 4, 2


def run_cohort(device):
    """Phase 12: the cohort-streaming backend (``backend="cohort"``) at
    full gpt2 width from phase 3's weights, over a lazy
    DirichletPopulation of COHORT_CLIENTS clients drawn from phase 3's
    training rows (shard_size BATCH, alpha 0.5, seed 0), streamed
    COHORT_SIZE clients at a time (each chunk one stacked spmd program and
    one secure-aggregation cohort) with COHORT_EDGES edge aggregators.
    FedLLM with secure aggregation: run_case's continuous gates (kernels,
    the two fp32 plain runs, TF32, fp64); the ledger by name and by hop by
    hand (the client->edge hop equal to a kernel run's total at n_edges 0,
    the edge->server events counted), client FLOPs by hand, launches
    exact; and its peak device memory below the same run's with the whole
    fleet in one chunk (cohort_size 0).  KD (top-k 8, int8) and Split
    (int8 boundary): one kernel run each against a kernel run with
    cohort_size 0, held to the spread limits of phases 4 and 6 (CASES);
    ledgers and launches exact.  Returns {path: launch counts}."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import FedConfig, PrivacyConfig
    from repro_torch.configs.gpt2_small import gpt2
    from repro_torch.core import kd as kd_mod
    from repro_torch.core import metrics
    from repro_torch.core.rounds import run_federated
    from repro_torch.data import banking77, population
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build_model
    from repro_torch.privacy.secure_agg import key_exchange_bytes

    cfg = gpt2()
    pub, train, test = banking77.paper_splits(cfg.vocab_size,
                                              pad_len=PAD_LEN, scale=0.03)
    pop = population.DirichletPopulation(train, COHORT_CLIENTS, alpha=0.5,
                                         seed=0, shard_size=BATCH)
    data = (pub, pop, test)
    base = build_model(cfg).init(torch.Generator().manual_seed(0), device)
    L, d, n = cfg.n_layers, cfg.d_model, COHORT_CLIENTS
    chunks = -(-n // COHORT_SIZE)
    evals = len(test["tokens"]) // 64
    pub_batches = -(-len(pub["tokens"]) // 64)
    lora_bytes = L * 3 * 2 * RANK * d * 4
    by_path = {}

    def run(fed, expect):
        """One kernel run over the population: launches exact; returns
        (result, peak device memory in GB)."""
        ops.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_federated(dataclasses.replace(cfg, kernel_policy="cuda"),
                            fed, pub, pop, test, batch_size=BATCH,
                            eval_batch=64, device=device, base=base)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = ops.launches()
        tag = f"cohort {fed.cohort_size}, n_edges {fed.n_edges}"
        for h in res.history:
            require(math.isfinite(h.loss) and 0.0 <= h.accuracy <= 1.0,
                    f"round {h.round} metrics out of range")
            print(f"  [{fed.framework} {tag}] round {h.round}: "
                  f"acc={h.accuracy:.4f} loss={h.loss:.6f} "
                  f"wall_s={h.seconds:.3f}")
        print(f"  [{fed.framework} {tag}] run wall_s="
              f"{time.perf_counter() - t0:.3f} peak memory {peak:.3f} GB")
        check_launches(counts, expect)
        return res, counts, peak

    def spread(res, whole, case, what):
        """``res`` against the cohort_size 0 run ``whole`` under phase
        ``case``'s spread limits: payload ledger and FLOPs equal."""
        lim = CASES[case]["limits"]
        require(res.ledger.payload_view().per_client_round()
                == whole.ledger.payload_view().per_client_round()
                and res.client_flops == whole.client_flops,
                f"{what}: payload ledger or FLOPs differ from cohort_size 0")
        rel = lora_gap(res.final_lora, whole.final_lora)[1]
        print(f"  {what} final LoRA vs cohort_size 0: relative L2 {rel:.3e} "
              f"(spread limit {lim['lora']:.3e}, {rel / lim['lora']:.3f} of "
              f"it)")
        require(rel <= lim["lora"], f"{what}: final LoRA off the cohort_size "
                f"0 run beyond the spread limit")
        for h, hw, l in zip(res.history, whole.history, lim["loss"]):
            print(f"  round {h.round} loss vs cohort_size 0: "
                  f"{abs(h.loss - hw.loss):.3e} (limit {l:.3e})")
            require(abs(h.loss - hw.loss) <= l, f"{what}: round loss off the "
                    f"cohort_size 0 run beyond the spread limit")

    t0 = time.perf_counter()
    print(f"phase 12: the cohort backend, gpt2 full width, "
          f"DirichletPopulation of {n} clients ({BATCH} rows each, alpha "
          f"0.5), cohort_size {COHORT_SIZE} ({chunks} chunks), n_edges "
          f"{COHORT_EDGES}: FedLLM with secure aggregation")
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, backend="cohort",
                    cohort_size=COHORT_SIZE, n_edges=COHORT_EDGES,
                    privacy=PrivacyConfig(secure_agg=True))
    R = fed.rounds
    # each client trains one step a round: a chunk is one stacked step
    expect = nonzero(add_counts(model_launches(L, chunks * R, 0, True),
                                model_launches(L, 0, evals * R)))
    keys_up, keys_down = key_exchange_bytes(COHORT_SIZE)
    # each round the chunks' groups go to edges 0, 1, 0: two edges each
    # forward one fused tree up and pull the new global down
    edge = R * COHORT_EDGES * 2 * lora_bytes
    ledger = {"lora_params": R * n * 2 * lora_bytes,
              "secagg_keys": R * n * (keys_up + keys_down),
              "edge_agg": edge}
    counts, kern = run_case(device, cfg, base, fed, data, ledger=ledger,
                            expect=expect, margin="cohort")
    by_path["fedllm_cohort"] = counts
    flat, _, peak = run(dataclasses.replace(fed, n_edges=0), expect)
    require(kern.ledger.by_hop() == {
        metrics.CLIENT_EDGE: flat.ledger.total(),
        metrics.EDGE_SERVER: edge}, f"ledger by hop {kern.ledger.by_hop()}")
    events = sorted((e.round, e.client, e.direction, e.bytes)
                    for e in kern.ledger.events
                    if e.hop == metrics.EDGE_SERVER)
    require(events == sorted((r, -(e + 1), w, lora_bytes) for r in range(R)
                             for e in range(COHORT_EDGES)
                             for w in (metrics.UP, metrics.DOWN)),
            f"edge->server events {events}")
    n_lora = L * 3 * 2 * RANK * d
    require(kern.client_flops == [metrics.train_flops(
        cfg, BATCH * PAD_LEN * R, True, n_lora)] * n,
        f"client FLOPs {kern.client_flops}")
    print(f"  ledger by hop {kern.ledger.by_hop()}: the client->edge hop the "
          f"n_edges 0 run's total, {R * COHORT_EDGES * 2} edge->server "
          f"events of {lora_bytes} bytes; client FLOPs by hand")
    whole, _, whole_peak = run(
        dataclasses.replace(fed, cohort_size=0, n_edges=0),
        nonzero(add_counts(model_launches(L, R, 0, True),
                           model_launches(L, 0, evals * R))))
    print(f"  {torch.cuda.get_device_name(0)}: peak device memory, "
          f"cohort_size {COHORT_SIZE} {peak:.3f} GB, whole fleet (cohort_size "
          f"0) {whole_peak:.3f} GB")
    require(peak < whole_peak, "cohort streaming does not lower the peak "
            "device memory")
    print(f"  final LoRA, cohort_size 0 vs {COHORT_SIZE}: relative L2 "
          f"{lora_gap(whole.final_lora, flat.final_lora)[1]:.3e}")

    print(f"phase 12: KD, top-k 8 int8 logits, cohort_size {COHORT_SIZE} "
          f"against cohort_size 0")
    fed = FedConfig(framework="kd", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, logit_topk=8, logit_quant_bits=8,
                    backend="cohort", cohort_size=COHORT_SIZE,
                    n_edges=COHORT_EDGES)
    kd_steps = fed.kd_epochs * pub_batches
    wire = kd_mod.logit_wire_bytes((len(pub["tokens"]),
                                    banking77.N_CLASSES), fed)
    runs = {}
    for size, k in ((COHORT_SIZE, chunks), (0, 1)):
        # per round: b1 one stacked step and b2 the public logits a chunk,
        # b8 the stacked distillation a chunk; b5 and b6 on one model
        expect = add_counts(
            model_launches(L, k * (1 + kd_steps) * R, k * pub_batches * R,
                           True),
            model_launches(L, kd_steps * R, (pub_batches + evals) * R),
            {"kd_fwd": (k + 1) * kd_steps * R,
             "kd_bwd": (k + 1) * kd_steps * R, "topk_quantize": n * R})
        runs[size], c, _ = run(dataclasses.replace(fed, cohort_size=size),
                               expect)
        used = min(k, COHORT_EDGES)
        require(runs[size].ledger.by_name() == {
            "logits": R * n * 2 * wire, "edge_agg": R * used * 2 * wire},
            f"KD ledger {runs[size].ledger.by_name()}")
        if size:
            by_path["kd_cohort"] = c
    spread(runs[COHORT_SIZE], runs[0], "kd", "KD cohort")

    print(f"phase 12: Split-FedLLM, split_layer {SPLIT_LAYER}, "
          f"int{SPLIT_BITS} boundary, cohort_size {COHORT_SIZE} against "
          f"cohort_size 0")
    fed = FedConfig(framework="split", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, split_layer=SPLIT_LAYER,
                    activation_quant_bits=SPLIT_BITS, backend="cohort",
                    cohort_size=COHORT_SIZE, n_edges=COHORT_EDGES)
    c2, c4 = split_wire_bytes(cfg, SPLIT_BITS)
    half = SPLIT_LAYER * 3 * 2 * RANK * d * 4
    expect = model_launches(L, n * R, evals * R)
    expect["quant_roundtrip_rows"] = 2 * n * R
    runs = {}
    for size, k in ((COHORT_SIZE, chunks), (0, 1)):
        runs[size], c, _ = run(dataclasses.replace(fed, cohort_size=size),
                               expect)
        used = min(k, COHORT_EDGES)
        require(runs[size].ledger.by_name() == {
            "lora_params": R * n * 2 * half, "activations": R * n * c2,
            "act_grads": R * n * c4, "edge_agg": R * used * 2 * half},
            f"Split ledger {runs[size].ledger.by_name()}")
        if size:
            by_path["split_cohort"] = c
    spread(runs[COHORT_SIZE], runs[0], "split", "Split cohort")
    same = all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(runs[COHORT_SIZE].final_lora),
        tree_lib.leaves(runs[0].final_lora)))
    print(f"  Split cohort_size {COHORT_SIZE} and 0: final LoRA "
          f"{'bit-identical' if same else 'differ'} (the server half threads "
          f"the clients in the same order; the folds add in client order)")
    print(f"  phase 12 wall_s={time.perf_counter() - t0:.1f}")
    del base
    torch.cuda.empty_cache()
    return by_path


def fault_reckoning(fed, n_clients: int, lora_bytes: int):
    """A sync FedLLM run's fault accounting reckoned by hand from its
    FaultPlan (dropout and ``nan`` or ``inf`` clients, no stragglers,
    every honest payload inside the norm screen): each round every client
    downloads; a dropped upload is a ``retransmit`` (charged as it is
    sent), a corrupt client's a ``quarantine`` (charged when the round's
    arrivals are screened), the others arrive; under secure aggregation each
    arrival uploads a share for every client its round misses; a round
    whose arrivals fall below the quorum rolls over.  Returns (ledger
    bytes by name, [(round, client, name)] of the fault events in order,
    rollovers)."""
    from repro_torch.faults.plan import FaultPlan
    from repro_torch.privacy.secure_agg import SHARE_BYTES, key_exchange_bytes

    fc = fed.faults
    require(fc.straggler_rate == 0.0 and (
        fc.byzantine == 0 or fc.byzantine_mode in ("nan", "inf")),
        "fault_reckoning: stragglers and finite corruption are not reckoned")
    plan, n, R = FaultPlan(fed, n_clients), n_clients, fed.rounds
    ledger = {"lora_params": R * n * lora_bytes}
    events, rollovers, recovery = [], 0, 0
    for rnd in range(R):
        # the lost uploads are charged as they are sent, the quarantined
        # ones when the round's arrivals are screened
        lost = [ci for ci in range(n) if plan.dropped(rnd, ci)]
        bad = [ci for ci in range(n) if ci not in lost and plan.corrupts(ci)]
        kept = [ci for ci in range(n) if ci not in lost + bad]
        for name, cis in (("retransmit", lost), ("quarantine", bad)):
            events += [(rnd, ci, name) for ci in cis]
            if cis:
                ledger[name] = ledger.get(name, 0) + len(cis) * lora_bytes
        ledger["lora_params"] += len(kept) * lora_bytes
        if fed.privacy.secure_agg and kept:
            recovery += len(kept) * (n - len(kept)) * SHARE_BYTES
        rollovers += bool(fed.quorum > 0 and len(kept) < fed.quorum * n)
    if fed.privacy.secure_agg:
        up, down = key_exchange_bytes(n)
        ledger["secagg_keys"] = R * n * (up + down)
        if recovery:
            ledger["secagg_recovery"] = recovery
    return ledger, events, rollovers


def fault_events(res):
    """[(round, client, name)] of a result's fault events, in order."""
    from repro_torch.core import metrics
    return [(e.round, e.client, e.name) for e in res.ledger.events
            if e.name in metrics.FAULT_NAMES]


def resumed_run(device, cfg, base, fed, data, stop: int):
    """A run through the kernels killed after round ``stop`` and resumed:
    rounds 0 to stop - 1 with ``checkpoint_every=1`` into a temporary
    directory, then the whole run with ``resume_from`` it.  Returns (the
    resumed result, the launches of both legs)."""
    import tempfile

    from repro_torch.core.rounds import run_federated
    from repro_torch.kernels import ops

    pub, clients, test = data
    cfg = dataclasses.replace(cfg, kernel_policy="cuda")
    counts = []
    with tempfile.TemporaryDirectory() as ckpt:
        for leg in (dict(fed=dataclasses.replace(fed, rounds=stop),
                         checkpoint_every=1, checkpoint_dir=ckpt),
                    dict(fed=fed, resume_from=ckpt)):
            ops.reset_launches()
            res = run_federated(cfg, leg.pop("fed"), pub, clients, test,
                                batch_size=BATCH, eval_batch=64,
                                device=device, base=base, **leg)
            counts.append(ops.launches())
    return res, add_counts(*counts)


def same_run(res, full, what: str) -> None:
    """Fails unless ``res`` is ``full`` bit for bit: ledger events,
    history but the wall-time ``seconds``, rollovers and the final
    LoRA."""
    import torch

    from repro_torch import tree as tree_lib

    def history(r):
        return [dataclasses.replace(h, seconds=0.0) for h in r.history]

    got, want = (tree_lib.leaves(r.final_lora) for r in (res, full))
    require(res.ledger.events == full.ledger.events, f"{what}: ledger events")
    require(history(res) == history(full), f"{what}: history")
    require(res.rollovers == full.rollovers, f"{what}: rollovers")
    require(len(got) == len(want) > 0 and all(
        torch.equal(a, b) for a, b in zip(got, want)), f"{what}: final LoRA")


def run_faults(device):
    """Phase 13: fault tolerance at full gpt2 width from phase 3's weights
    and data, through the kernels.

    1. FedLLM, 3 rounds, trimmed_mean (trim 0.34), the norm screen at 10,
       dropout 0.3 and one ``nan`` client, secure aggregation: run_case's
       continuous gates (kernels, two fp32 plain runs, TF32, fp64); every
       run's fault events and rollovers those fault_reckoning reckons from
       the plan; ledger by hand, launches exact.
    2. KD, top-k 8 int8 logits, one ``nan`` client, a median teacher, 2
       rounds: a kernel and a plain run, the same quarantines (the
       quantizer keeps the corrupt client's NaN), ledgers by hand, within
       phase 4's spread limits (needs ``CASES["kd"]``), launches exact.
    3. FedLLM under quorum 1.0 with dropout 0.5 and norm_clip, 3 rounds:
       a kernel and a plain run, rollovers and ledger as reckoned.
    4. Kill-and-resume through the kernels (resumed_run, same_run): each
       resumed run bit for bit its own uninterrupted one, its two legs'
       launches the uninterrupted run's.  FedLLM async (``max_staleness``
       2) with secure aggregation stopped after round 2 of 3; KD top-k 8
       int8 and Split int8 after round 1 of 2; FedLLM under ``cohort``
       over phase 12's population (chunks of COHORT_SIZE, COHORT_EDGES
       edges, secure aggregation) with faults (trimmed_mean, quorum 0.75,
       dropout 0.3, one ``nan`` client: the streamed round's screen,
       quarantines, robust buffer and rollover, its fault events and
       rollovers as fault_reckoning reckons them) after round 1 of 2.

    Returns {path: launch counts}."""
    import torch

    from repro_torch.configs.base import (FaultConfig, FedConfig,
                                          PrivacyConfig)
    from repro_torch.configs.gpt2_small import gpt2
    from repro_torch.core.rounds import run_federated
    from repro_torch.data import banking77, partition, population
    from repro_torch.faults.plan import FaultPlan
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build_model

    t0 = time.perf_counter()
    cfg = gpt2()
    pub, train, test = banking77.paper_splits(cfg.vocab_size,
                                              pad_len=PAD_LEN, scale=0.03)
    clients = partition.iid_partition(train, 3)
    data = (pub, clients, test)
    base = build_model(cfg).init(torch.Generator().manual_seed(0), device)
    L, C = cfg.n_layers, len(clients)
    steps = sum(len(c["tokens"]) // BATCH for c in clients)  # per round
    evals = len(test["tokens"]) // 64
    lora_bytes = L * 3 * 2 * RANK * cfg.d_model * 4
    by_path = {}

    def run(fed, policy, data=data):
        """One run from phase 3's weights: its metrics in range; returns
        (result, launch counts)."""
        ops.reset_launches()
        t1 = time.perf_counter()
        res = run_federated(dataclasses.replace(cfg, kernel_policy=policy),
                            fed, data[0], data[1], data[2], batch_size=BATCH,
                            eval_batch=64, device=device, base=base)
        torch.cuda.synchronize()
        for h in res.history:
            require(math.isfinite(h.loss) and 0.0 <= h.accuracy <= 1.0,
                    f"round {h.round} metrics out of range")
            print(f"  [{fed.framework} {policy}] round {h.round}: "
                  f"acc={h.accuracy:.4f} loss={h.loss:.6f} "
                  f"wall_s={h.seconds:.3f}")
        print(f"  [{fed.framework} {policy}] run wall_s="
              f"{time.perf_counter() - t1:.3f} rollovers {res.rollovers}")
        return res, ops.launches()

    def plain_launches_none(counts, what):
        require(not any(counts.values()), f"{what}: the plain run launched "
                f"kernels: {nonzero(counts)}")

    print("phase 13: fault tolerance, gpt2 full width, 3 clients; FedLLM, "
          "3 rounds, trimmed_mean 0.34, screen_factor 10, dropout 0.3, one "
          "nan client, secure aggregation")
    fed = FedConfig(framework="fedllm", rounds=3, lora_rank=RANK,
                    lora_dropout=0.0, robust_agg="trimmed_mean",
                    trim_frac=0.34, screen_factor=10.0,
                    faults=FaultConfig(dropout_rate=0.3, byzantine=1,
                                       byzantine_mode="nan"),
                    privacy=PrivacyConfig(secure_agg=True))
    ledger, events, rollovers = fault_reckoning(fed, C, lora_bytes)
    require({"quarantine", "retransmit"} <= {e[2] for e in events},
            f"the plan's faults {events} hold no quarantine or retransmit")
    by_path["faults_fedllm"], kern = run_case(
        device, cfg, base, fed, data, ledger=ledger,
        expect=model_launches(L, steps * fed.rounds, evals * fed.rounds),
        margin="faults", keep="faults")
    for role, res in CASES["faults"]["results"].items():
        require(fault_events(res) == events and res.rollovers == rollovers,
                f"{role} run: fault events {fault_events(res)}, rollovers "
                f"{res.rollovers}; reckoned {events}, {rollovers}")
    print(f"  every run's fault events as reckoned from the plan: {events}; "
          f"rollovers {rollovers}; fault overhead "
          f"{kern.ledger.fault_overhead_bytes()} bytes")

    print("phase 13: KD, top-k 8 int8 logits, one nan client, median "
          "teacher, 2 rounds, kernels against plain")
    fed = FedConfig(framework="kd", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0, logit_topk=8, logit_quant_bits=8,
                    robust_agg="median",
                    faults=FaultConfig(byzantine=1, byzantine_mode="nan"))
    (bad,) = FaultPlan(fed, C).byzantine
    kd_ledger, expect = kd_expect(
        fed, data, steps, evals,
        lambda train, fwd: model_launches(L, train, fwd), arrived=C - 1)
    kd = {}
    for policy in ("cuda", "torch"):
        kd[policy], counts = run(fed, policy)
        require(kd[policy].ledger.by_name() == kd_ledger,
                f"KD {policy}: ledger {kd[policy].ledger.by_name()} != "
                f"{kd_ledger}")
        require(fault_events(kd[policy]) == [(r, bad, "quarantine")
                                             for r in range(fed.rounds)],
                f"KD {policy}: fault events {fault_events(kd[policy])}")
        if policy == "cuda":
            check_launches(counts, expect)
            by_path["faults_kd"] = counts
        else:
            plain_launches_none(counts, "KD")
    lim = CASES["kd"]["limits"]
    rel = lora_gap(kd["cuda"].final_lora, kd["torch"].final_lora)[1]
    print(f"  KD: client {bad}'s upload quarantined each round in both "
          f"runs; final LoRA vs plain: relative L2 {rel:.3e} (phase 4's "
          f"spread limit {lim['lora']:.3e}, {rel / lim['lora']:.3f} of it)")
    require(rel <= lim["lora"], "KD faulted: final LoRA beyond phase 4's "
            "spread limit")
    for h, hp, limit in zip(kd["cuda"].history, kd["torch"].history,
                            lim["loss"]):
        print(f"  round {h.round} loss vs plain {abs(h.loss - hp.loss):.3e} "
              f"(limit {limit:.3e})")
        require(abs(h.loss - hp.loss) <= limit, "KD faulted: a round's loss "
                "beyond phase 4's spread limit")

    print("phase 13: FedLLM, quorum 1.0, dropout 0.5, norm_clip, 3 rounds, "
          "kernels against plain")
    fed = FedConfig(framework="fedllm", rounds=3, lora_rank=RANK,
                    lora_dropout=0.0, quorum=1.0, robust_agg="norm_clip",
                    faults=FaultConfig(dropout_rate=0.5))
    ledger, events, rollovers = fault_reckoning(fed, C, lora_bytes)
    require(0 < rollovers < fed.rounds, f"the plan rolls {rollovers} of "
            f"{fed.rounds} rounds over")
    quorum = {}
    for policy in ("cuda", "torch"):
        quorum[policy], counts = run(fed, policy)
        res = quorum[policy]
        require(res.rollovers == rollovers and res.ledger.by_name() == ledger
                and fault_events(res) == events,
                f"quorum {policy}: rollovers {res.rollovers}, ledger "
                f"{res.ledger.by_name()}; reckoned {rollovers}, {ledger}")
        if policy == "cuda":
            check_launches(counts, model_launches(L, steps * fed.rounds,
                                                  evals * fed.rounds))
            by_path["faults_quorum"] = counts
        else:
            plain_launches_none(counts, "quorum")
    require(quorum["cuda"].ledger.events == quorum["torch"].ledger.events,
            "quorum: ledger events differ from the plain run's")
    rel = lora_gap(quorum["cuda"].final_lora, quorum["torch"].final_lora)[1]
    print(f"  quorum: {rollovers} of {fed.rounds} rounds rolled over in both "
          f"runs, as reckoned; ledgers equal; final LoRA vs plain: relative "
          f"L2 {rel:.3e}")

    pop = population.DirichletPopulation(train, COHORT_CLIENTS, alpha=0.5,
                                         seed=0, shard_size=BATCH)
    secagg = PrivacyConfig(secure_agg=True)
    resumes = [
        ("FedLLM async, max_staleness 2, secure aggregation", 2, data,
         FedConfig(framework="fedllm", rounds=3, aggregation="async",
                   max_staleness=2, privacy=secagg)),
        ("KD, top-k 8 int8", 1, data,
         FedConfig(framework="kd", rounds=2, logit_topk=8,
                   logit_quant_bits=8)),
        (f"Split, int{SPLIT_BITS} boundary", 1, data,
         FedConfig(framework="split", rounds=2, split_layer=SPLIT_LAYER,
                   activation_quant_bits=SPLIT_BITS)),
        (f"FedLLM cohort, {COHORT_CLIENTS} clients in chunks of "
         f"{COHORT_SIZE}, {COHORT_EDGES} edges, secure aggregation, "
         f"trimmed_mean 0.34, quorum 0.75, dropout 0.3, one nan client", 1,
         (pub, pop, test),
         FedConfig(framework="fedllm", rounds=2, backend="cohort",
                   cohort_size=COHORT_SIZE, n_edges=COHORT_EDGES,
                   privacy=secagg, robust_agg="trimmed_mean",
                   trim_frac=0.34, quorum=0.75,
                   faults=FaultConfig(dropout_rate=0.3, byzantine=1,
                                      byzantine_mode="nan")))]
    resume_counts = []
    for what, stop, rdata, fed in resumes:
        fed = dataclasses.replace(fed, lora_rank=RANK, lora_dropout=0.0)
        print(f"phase 13: kill-and-resume, {what}: stopped after round "
              f"{stop} of {fed.rounds}")
        full, counts = run(fed, "cuda", rdata)
        if fed.faults.enabled:
            # the streamed round's screen, quarantines and rollover
            _, events, rollovers = fault_reckoning(fed, len(rdata[1]),
                                                   lora_bytes)
            require(0 < rollovers < fed.rounds and {"quarantine",
                    "retransmit"} <= {e[2] for e in events},
                    f"{what}: the plan's faults {events}, rollovers "
                    f"{rollovers}, exercise no rollover or no quarantine")
            require(fault_events(full) == events
                    and full.rollovers == rollovers,
                    f"{what}: fault events {fault_events(full)}, rollovers "
                    f"{full.rollovers}; reckoned {events}, {rollovers}")
            print(f"  fault events as reckoned from the plan: {events}; "
                  f"rollovers {rollovers}")
        res, legs = resumed_run(device, cfg, base, fed, rdata, stop)
        same_run(res, full, what)
        require(legs == counts, f"{what}: the two legs launched {legs}, the "
                f"uninterrupted run {counts}")
        resume_counts += [counts, legs]
        print(f"  resumed run bit for bit the uninterrupted one (ledger "
              f"events, history but seconds, rollovers, final LoRA); the "
              f"legs' launches its launches")
    by_path["resume"] = add_counts(*resume_counts)
    del base
    torch.cuda.empty_cache()
    print(f"  phase 13 wall_s={time.perf_counter() - t0:.1f}")
    return by_path


# --------------------------------------------------------------------------- #
# Phase 14: the registry's decoder-only families at full width
# --------------------------------------------------------------------------- #
def family_case(cfg, what: str):
    """Phase 3's data for ``cfg``'s vocabulary, the clients, the steps a
    round and eval batches, and FedLLM's config (2 rounds, rank 8 on
    wq/wk/wv, dropout 0)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.data import banking77, partition

    pub, train, test = banking77.paper_splits(cfg.vocab_size,
                                              pad_len=PAD_LEN, scale=0.03)
    clients = partition.iid_partition(train, 3)
    steps = sum(len(c["tokens"]) // BATCH for c in clients)
    evals = len(test["tokens"]) // 64
    fed = FedConfig(framework="fedllm", rounds=2, lora_rank=RANK,
                    lora_dropout=0.0)
    print(f"phase 14: FedLLM case study, {what}, 2 rounds, 3 clients, LoRA "
          f"rank {RANK} on wq, wk, wv")
    return (pub, clients, test), steps, evals, fed


def prefetch_draws(cfgs) -> None:
    """Draws the seed-0 weights of each config of ``cfgs`` on the host, one
    after another in a daemon thread, at most DRAWS_AHEAD trees ahead of
    the phases that take them (family_init): a full-width phase then
    waits only for what is left of its draw, and the draws of later
    phases overlap the card's work.  Drawn on the host by the same code
    and generator, the trees are bit for bit those of a draw straight to
    the card (every initializer draws on the CPU and then moves)."""
    import torch

    from repro_torch.models.factory import build_model

    order = list(cfgs)
    for cfg in order:
        DRAWS[cfg] = {"done": threading.Event(), "tree": None, "error": None}

    def work():
        for cfg in order:
            _DRAW_SLOTS.acquire()
            entry = DRAWS[cfg]
            try:
                entry["tree"] = build_model(cfg).init(
                    torch.Generator().manual_seed(0), "cpu")
            except BaseException as err:        # raised in family_init
                entry["error"] = err
            entry["done"].set()

    threading.Thread(target=work, daemon=True).start()


def family_init(device, cfg):
    """``cfg``'s seed-0 weights on the card: the prefetched host draw
    (prefetch_draws) uploaded, else drawn on the host here; the wall time
    and the tree's size printed.  Qwen3-1.7B's host tree is kept in
    QWEN3_HOST for phases 16 and 18."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.models.factory import build_model

    t0 = time.perf_counter()
    entry = DRAWS.pop(cfg, None)
    how = "drawn on the host"
    if entry is None:
        base = build_model(cfg).init(torch.Generator().manual_seed(0), device)
    else:
        entry["done"].wait()
        _DRAW_SLOTS.release()
        if entry["error"] is not None:
            raise entry["error"]
        how = f"prefetched, waited {time.perf_counter() - t0:.1f} s"
        base = tree_lib.map_(lambda t: t.to(device), entry["tree"])
        if cfg.name == "qwen3-1.7b" and cfg.n_layers == QWEN3_LAYERS:
            QWEN3_HOST["base"] = entry["tree"]
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_lib.leaves(base))
    print(f"  init wall_s={time.perf_counter() - t0:.1f} ({how}; {n} "
          f"parameters in the tree, {n * 4 / 1e9:.2f} GB fp32; "
          f"cfg.param_count() {cfg.param_count()})")
    return base


def prefetched_configs():
    """The configs of the full-width phases 7, 8 and 14-16 in the order
    they draw (prefetch_draws)."""
    from repro_torch.configs import registry

    def cut(arch, n):
        return dataclasses.replace(registry.get_config(arch), n_layers=n)

    return [registry.get_config("recurrentgemma-2b"),
            registry.get_config("rwkv6-1.6b"),
            registry.get_config("qwen3-1.7b"),
            cut("mixtral-8x7b", MIXTRAL_LAYERS),
            cut("llava-next-34b", LLAVA_LAYERS),
            cut("recurrentgemma-2b", RG_SERVE_LAYERS),
            cut("rwkv6-1.6b", RWKV_SERVE_LAYERS)]


def lora_site_bytes(cfg) -> int:
    """Bytes of one layer's LoRA factors on wq, wk and wv, fp32: A (d, r)
    and B (r, out) each."""
    d = cfg.d_model
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return RANK * ((d + q) + 2 * (d + kv)) * 4


def run_qwen3(device):
    """Phase 14's Qwen3-1.7B at full width and depth (28 layers, d 2048,
    16 query heads of 128 over 8 kv heads with qk-norm, SwiGLU d_ff 6144,
    V 151936 tied; seed-0 weights): FedLLM on phase 3's data, the first
    step's LoRA gradient gated from fp64, then run_case's continuous
    gates (kernels, two fp32 plain runs, TF32, fp64), ledger by hand,
    launches exact.  Returns the kernel run's launch counts."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs import registry

    cfg = registry.get_config("qwen3-1.7b")
    data, steps, evals, fed = family_case(
        cfg, f"{cfg.name} full width and depth ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} over "
        f"{cfg.n_kv_heads}, qk-norm, V {cfg.vocab_size} tied)")
    base = family_init(device, cfg)
    L, C = cfg.n_layers, len(data[1])
    train_steps, fwd_batches = steps * fed.rounds, evals * fed.rounds
    expect = model_launches(L, train_steps, fwd_batches)
    print(f"  {train_steps} train steps, {fwd_batches} eval batches; "
          f"expected launches {expect}")
    gaps = first_step_gaps(device, cfg, base, fed, data[1])
    MARGINS["Qwen3-1.7B first step"] = gaps["kernels"] / floor_gate(
        "first-step LoRA gradient", gaps)
    # on the card the final LoRA holds to fp64 (0.28 of its limit), but
    # round 1's loss parts between fp32 runs by ~4e-3 (the cuBLASLt run
    # 4.4e-3 from plain, fp64 1.9e-3): past 1e-3, so the round losses
    # take the spread gate
    counts, _ = run_case(device, cfg, base, fed, data,
                         ledger={"lora_params": fed.rounds * C * 2 * L
                                 * lora_site_bytes(cfg)},
                         expect=expect, margin="Qwen3-1.7B",
                         loss_kind="spread")
    # phases 16 and 18 take these weights from the host (qwen3_weights)
    if "base" not in QWEN3_HOST:
        QWEN3_HOST["base"] = tree_lib.map_(lambda t: t.cpu(), base)
    del base
    torch.cuda.empty_cache()
    return counts


def first_step_routes(device, cfg, base, fed, clients, roles=None):
    """FedLLM's first train step (client 0's first batch, the run's
    initial LoRA) under each of each_run(exact=True)'s settings (those in
    ``roles``, if given), the MoE layers' routes traced: ({role: LoRA
    gradient leaves}, {role: [each MoE layer's top-k expert ids (B, S,
    k)]})."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.core import tasks
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.factory import build_model
    from repro_torch.peft import lora as lora_lib

    lt, batch = first_step_inputs(device, base, fed, clients)
    loss_fn = tasks.get_loss_fn("classification")
    grads, routes = {}, {}
    for role, tag, policy in each_run(exact=True):
        if roles is not None and role not in roles:
            continue
        model = build_model(dataclasses.replace(cfg, kernel_policy=policy))
        b, l = (fp64(base), fp64(lt)) if role == "exact" else (base, lt)
        with ops.policy_scope(policy), moe.trace_routes() as trace:
            live = tree_lib.map_(lambda t: t.detach().requires_grad_(True), l)
            logits, aux = model.forward(lora_lib.bind(
                b, live, fed.lora_alpha,
                lora_lib.tree_rank(live, fed.lora_rank)), batch)
            loss, _ = loss_fn(logits, batch)
            grads[role] = torch.autograd.grad(loss + aux,
                                              tree_lib.leaves(live))
        routes[role] = trace
        del b, l
    torch.cuda.empty_cache()
    return grads, routes


def route_flips(routes, role: str, yard: str) -> float:
    """Share of (token, MoE layer) pairs whose set of top-k experts in run
    ``role`` differs from run ``yard``'s."""
    flips = n = 0
    for a, b in zip(routes[role], routes[yard]):
        a, b = a.sort(dim=-1).values, b.sort(dim=-1).values
        flips += int((a != b).any(dim=-1).sum())
        n += a.shape[0] * a.shape[1]
    return flips / n


def run_mixtral(device):
    """Phase 14's Mixtral-8x7B at full width and MIXTRAL_LAYERS of its 32
    layers (d 4096, 32 query heads of 128 over 8 kv heads, window 4096,
    8 experts of d_ff 14336, top 2, capacity factor 1.25, ``shard_map``
    dispatch, run as ``batched``; V 32000 untied; seed-0 weights):
    FedLLM on phase 3's data.  The first step's routes (every token's
    top-2 experts at each layer) of each run against the fp64 run's: with
    none changed in the kernel run, the first step's LoRA gradient is
    gated from fp64; with some, the route is a quantized wire (a flipped
    route moves a token to other experts), so the share of flipped
    routes is gated against the fp32 runs' (NUDGED_SEEDS nudged among
    them, fp32_gates' flips).  The rounds, where routes flip, take
    run_case's spread gates with NUDGED_SEEDS nudged runs, each run's
    routes printed against the plain run's.  Ledger by hand, launches
    exact.
    Then one DP-SGD step (dp_first_step: clip at the median per-example
    norm, noise 0), its rows and clipped mean from fp64, the pair of row
    4ᵉ launched 3 x MIXTRAL_LAYERS times.  Returns the two kernel runs'
    launch counts."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import moe

    cfg = dataclasses.replace(registry.get_config("mixtral-8x7b"),
                              n_layers=MIXTRAL_LAYERS)
    data, steps, evals, fed = family_case(
        cfg, f"{cfg.name} full width, {MIXTRAL_LAYERS} of its 32 layers "
        f"(d {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} over "
        f"{cfg.n_kv_heads}, window {cfg.sliding_window}, {cfg.n_experts} "
        f"experts of d_ff {cfg.d_ff}, top {cfg.top_k}, capacity factor "
        f"{cfg.moe_capacity_factor}, {cfg.moe_dispatch} dispatch run as "
        f"batched, V {cfg.vocab_size} untied)")
    base = family_init(device, cfg)
    L, C = cfg.n_layers, len(data[1])
    train_steps, fwd_batches = steps * fed.rounds, evals * fed.rounds
    expect = model_launches(L, train_steps, fwd_batches)
    print(f"  {train_steps} train steps, {fwd_batches} eval batches; "
          f"expected launches {expect}")
    grads, routes = first_step_routes(device, cfg, base, fed, data[1])
    shares = {role: route_flips(routes, role, "exact")
              for role in routes if role != "exact"}
    n = sum(r.shape[0] * r.shape[1] for r in routes["exact"])
    print(f"  round 0 step 0 routes (top-{cfg.top_k} expert sets of {n} "
          f"token-layer pairs), share changed from the fp64 run's: "
          + ", ".join(f"{role} {v:.3e}" for role, v in shares.items()))
    ledger = {"lora_params": fed.rounds * C * 2 * L * lora_site_bytes(cfg)}
    if shares["kernels"] == 0.0:
        gaps = from_exact(grads, "round 0 step 0 LoRA gradient")
        MARGINS["Mixtral-8x7B first step"] = gaps["kernels"] / floor_gate(
            "first-step LoRA gradient", gaps)
    else:
        # the nudged runs' routes join the yardstick: flips against the
        # plain run's, as phase 6 holds its boundary levels
        for seed in range(NUDGED_SEEDS):
            nb = nudged(base, seed, device)
            routes[f"seed {seed}"] = first_step_routes(
                device, cfg, nb, fed, data[1], roles=("plain",))[1]["plain"]
            del nb
        flips = {role: route_flips(routes, role, "plain")
                 for role in routes if role not in ("plain", "exact")}
        limits, failed = fp32_gates(flips=flips)
        print("  route flips against the plain run: " + ", ".join(
            f"{role} {v:.3e}" for role, v in flips.items())
            + f" (limit {limits['flips']:.3e}; kernels at "
            f"{flips['kernels'] / limits['flips']:.3f} of it)")
        require(not failed, "; ".join(failed))
        MARGINS["Mixtral-8x7B first step"] = \
            flips["kernels"] / limits["flips"]
    MARGINS["Mixtral-8x7B route flips"] = shares["kernels"]
    # Over the rounds a route flips somewhere in every run but the ones
    # that share the plain run's bits, and a flipped route sends a token
    # to other experts: the runs part as a quantized wire's do (on the
    # card round 1's loss parted by 2.8e-2 kernels, 5.0e-2 fp64 from
    # plain), so the rounds take the spread gates with nudged runs; the
    # routes of every run are printed against the plain run's
    with moe.trace_routes() as trace:
        counts, _ = run_case(device, cfg, base, fed, data, ledger=ledger,
                             expect=expect, kind="spread",
                             seeds=NUDGED_SEEDS, margin="Mixtral-8x7B")
    roles = ["kernels", "plain", "floor", "control"] + [
        f"seed {seed}" for seed in range(NUDGED_SEEDS)]
    per = len(trace) // len(roles)
    require(per * len(roles) == len(trace) and per == L * (
        train_steps + fwd_batches), f"{len(trace)} traced MoE calls")
    runs = {role: trace[i * per:(i + 1) * per]
            for i, role in enumerate(roles)}
    print(f"  routes over each run ({per} MoE calls), share of token-layer "
          f"pairs changed from the plain run's: " + ", ".join(
              f"{role} {route_flips(runs, role, 'plain'):.3e}"
              for role in roles if role != "plain"))
    del grads, routes
    dp_counts = dp_first_step(device, cfg, base, data[1], {
        "lora_fwd": 3 * L, "lora_dx": 3 * L,
        "lora_panel_examples_pair": 3 * L, "flash_fwd": L, "flash_dq": L,
        "flash_dkv": L, "dp_clip_norms": 1, "dp_clip_acc": 1},
        margin="Mixtral-8x7B")
    del base
    torch.cuda.empty_cache()
    return counts, dp_counts


def run_families(device):
    """Phase 14: Qwen3-1.7B (run_qwen3) and Mixtral-8x7B (run_mixtral).
    Returns {path: kernel-run launch counts}."""
    t0 = time.perf_counter()
    by_path = {"qwen3": run_qwen3(device)}
    print(f"  phase 14 Qwen3-1.7B wall_s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    by_path["mixtral"], by_path["mixtral_dp_step"] = run_mixtral(device)
    print(f"  phase 14 Mixtral-8x7B wall_s={time.perf_counter() - t0:.1f}")
    return by_path


# --------------------------------------------------------------------------- #
# Phase 15: the encoder-decoder (Whisper-base) and the VLM (LLaVA-NeXT-34B)
# --------------------------------------------------------------------------- #
def stub_embeds(device, name: str, shape, seed: int) -> dict:
    """{name: 0.02·N(0, 1) of ``shape``}, drawn on the host from ``seed``:
    the stub frontend's embeddings a batch carries (``enc_embeds``,
    ``img_embeds``)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    return {name: (torch.randn(shape, generator=gen) * 0.02).to(device)}


def vlm_encdec_case(cfg, what: str):
    """Phase 3's data for ``cfg``'s vocabulary over 3 clients and FedLLM's
    config (rank 8 on wq/wk/wv, dropout 0), the model's description
    printed."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.data import banking77, partition

    _, train, _ = banking77.paper_splits(cfg.vocab_size, pad_len=PAD_LEN,
                                         scale=0.03)
    print(f"phase 15: {what}; LoRA rank {RANK} on wq, wk, wv")
    return partition.iid_partition(train, 3), FedConfig(
        framework="fedllm", rounds=1, lora_rank=RANK, lora_dropout=0.0)


def lora_step_launches(sites: int, attn: int) -> dict:
    """The launches of one forward and backward through ``sites`` LoRA
    projections and ``attn`` attentions: per site a fused forward, a dx
    (which gives gb) and two panel gradients (dA, dB); per attention the
    flash forward, dq and dk/dv."""
    return {"lora_fwd": sites, "lora_dx": sites, "lora_panel": 2 * sites,
            "flash_fwd": attn, "flash_dq": attn, "flash_dkv": attn}


def adam_step_runs(device, cfg, base, fed, clients, extras):
    """Client 0's first len(extras) train steps of round 0 (its batches in
    the run's order, batch i with ``extras[i]``) through
    ``make_fns``' train step (Adam), from the run's initial LoRA, under
    each of each_run(exact=True)'s settings (the fp64 run's batches cast
    too): {role: the final LoRA's leaves}."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.core.fedavg import make_fns, to_device
    from repro_torch.data.loader import epoch_batches
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build_model

    lt, _ = first_step_inputs(device, base, fed, clients)
    batches = [dict(to_device(b, device), **x) for b, x in zip(
        epoch_batches(clients[0], BATCH, seed=fed.seed * 997), extras)]
    require(len(batches) == len(extras), f"{len(batches)} batches")
    out = {}
    for role, tag, policy in each_run(exact=True):
        fns = make_fns(build_model(dataclasses.replace(
            cfg, kernel_policy=policy)), fed)
        exact = role == "exact"
        b, l = (fp64(base), fp64(lt)) if exact else (base, lt)
        opt = fns["opt_init"](l)
        with ops.policy_scope(policy):
            for x in batches:
                l, opt, loss = fns["train_step"](b, l, opt,
                                                 fp64(x) if exact else x)
                require(math.isfinite(float(loss)), f"{tag} loss {loss}")
        out[role] = tree_lib.leaves(l)
        del b, l, opt
    torch.cuda.empty_cache()
    return out


def run_whisper(device):
    """Phase 15's Whisper-base at full width and depth (6 encoder and 6
    decoder layers, d 512, 8 heads of 64, GELU, LayerNorm, V 51865
    untied, learned decoder positions; seed-0 weights; each batch with
    1500 stub frames, 0.02·N(0, 1) from a seed): the first step's LoRA
    gradient and the LoRA after WHISPER_STEPS Adam steps from fp64; one
    DP step (dp_first_step) from fp64; the Split encoder-decoder int8
    first step's flipped boundary levels (split_flips_gate).  Launches
    exact for each.  Returns {path: the kernel run's launch counts}."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import ops

    cfg = registry.get_config("whisper-base")
    clients, fed = vlm_encdec_case(
        cfg, f"{cfg.name} full width and depth ({cfg.n_encoder_layers} "
        f"encoder and {cfg.n_layers} decoder layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, V {cfg.vocab_size}, "
        f"{cfg.encoder_seq_len} stub frames a example)")
    base = family_init(device, cfg)
    frames = (BATCH, cfg.encoder_seq_len, cfg.d_model)
    extras = [stub_embeds(device, "enc_embeds", frames, seed)
              for seed in range(WHISPER_STEPS)]
    # LoRA sites of a pass: the encoder's wq/wk/wv, the decoder's self-
    # attention wq/wk/wv and its cross-attention's wq (on the text) and
    # wk/wv (on the encoder's output); attentions: the encoder's, the
    # decoder's self- and cross-attention
    sites = 3 * cfg.n_encoder_layers + 6 * cfg.n_layers
    attn = cfg.n_encoder_layers + 2 * cfg.n_layers
    step = lora_step_launches(sites, attn)
    print(f"  {sites} LoRA sites and {attn} attentions a pass; expected "
          f"launches of a train step {step}")
    by_path = {}
    ops.reset_launches()
    gaps = first_step_gaps(device, cfg, base, fed, clients, extras[0])
    by_path["whisper_first_step"] = ops.launches()
    check_launches(by_path["whisper_first_step"], step)
    MARGINS["Whisper-base first step"] = gaps["kernels"] / floor_gate(
        "first-step LoRA gradient", gaps)
    ops.reset_launches()
    finals = adam_step_runs(device, cfg, base, fed, clients, extras)
    by_path["whisper_steps"] = ops.launches()
    check_launches(by_path["whisper_steps"],
                   {k: WHISPER_STEPS * n for k, n in step.items()})
    gaps = from_exact(finals, f"LoRA after {WHISPER_STEPS} Adam steps")
    MARGINS[f"Whisper-base {WHISPER_STEPS} steps"] = \
        gaps["kernels"] / floor_gate(f"LoRA after {WHISPER_STEPS} steps",
                                     gaps)
    by_path["whisper_dp_step"] = dp_first_step(
        device, cfg, base, clients, {
            "lora_fwd": sites, "lora_dx": sites,
            "lora_panel_examples_pair": sites, "flash_fwd": attn,
            "flash_dq": attn, "flash_dkv": attn, "dp_clip_norms": 1,
            "dp_clip_acc": 1}, margin="Whisper-base", extras=extras[0])
    print(f"  Split encoder-decoder int{SPLIT_BITS} first step (client = "
          f"encoder, boundary ({BATCH}, {cfg.encoder_seq_len}, "
          f"{cfg.d_model})), boundary levels against the plain run's:")
    sfed = dataclasses.replace(fed, framework="split",
                               split_layer=SPLIT_LAYER,
                               activation_quant_bits=SPLIT_BITS)
    ops.reset_launches()
    MARGINS["Whisper-base Split int8 flips"] = split_flips_gate(
        device, cfg, base, sfed, clients, extras[0])
    by_path["whisper_split"] = ops.launches()
    check_launches(by_path["whisper_split"],
                   dict(step, quant_roundtrip_rows=2))
    del base
    torch.cuda.empty_cache()
    return by_path


def run_llava(device):
    """Phase 15's LLaVA-NeXT-34B at full width and LLAVA_LAYERS of its 60
    layers (d 7168, 56 query heads of 128 over 8, SwiGLU d_ff 20480,
    RMSNorm, RoPE, V 64000 untied; seed-0 weights; each batch with 576
    stub image tokens of dim 1024, 0.02·N(0, 1) from a seed, projected by
    ``img_proj`` and prepended to the 80 text tokens): the first step's
    LoRA gradient from fp64, launches exact.  Returns {path: the kernel
    run's launch counts}."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(registry.get_config("llava-next-34b"),
                              n_layers=LLAVA_LAYERS)
    clients, fed = vlm_encdec_case(
        cfg, f"{cfg.name} full width, {LLAVA_LAYERS} of its 60 layers (d "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} over "
        f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, V {cfg.vocab_size}, "
        f"{cfg.n_image_tokens} stub image tokens of dim "
        f"{cfg.image_embed_dim} prepended)")
    base = family_init(device, cfg)
    extras = stub_embeds(device, "img_embeds", (
        BATCH, cfg.n_image_tokens, cfg.image_embed_dim), 0)
    step = lora_step_launches(3 * cfg.n_layers, cfg.n_layers)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    gaps = first_step_gaps(device, cfg, base, fed, clients, extras)
    counts = ops.launches()
    print(f"  launches {nonzero(counts)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check_launches(counts, step)
    MARGINS["LLaVA-NeXT-34B first step"] = gaps["kernels"] / floor_gate(
        "first-step LoRA gradient", gaps)
    del base
    torch.cuda.empty_cache()
    return {"llava_first_step": counts}


def run_vlm_encdec(device):
    """Phase 15: Whisper-base (run_whisper) and LLaVA-NeXT-34B
    (run_llava).  Returns {path: kernel-run launch counts}."""
    t0 = time.perf_counter()
    by_path = run_whisper(device)
    print(f"  phase 15 Whisper-base wall_s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    by_path.update(run_llava(device))
    print(f"  phase 15 LLaVA-NeXT-34B wall_s={time.perf_counter() - t0:.1f}")
    return by_path


# --------------------------------------------------------------------------- #
# Phase 16: serving (the decode path, launch/serve.py)
# --------------------------------------------------------------------------- #
def decode_fp64_ratio(device, name: str, shape: dict, seed: int) -> float:
    """rms error against fp64 of a decode-shape kernel's output over its
    yardstick's: row 1 (``lora_fwd``'s y) against the default BLAS
    library's chain, row 5 (``flash_fwd``'s o) against the larger of its
    fp32 twin's and SDPA's; kernel_cases' N(0, 1) inputs scaled as there.
    Fails above FP64_FACTOR."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*dims, std=1.0):
        return torch.randn(dims, device=device, generator=gen) * std

    if name == "lora_fwd":
        M, K, N, r = (shape[k] for k in ("M", "K", "N", "r"))
        x, w = rn(M, K), rn(K, N, std=K ** -0.5)
        a, b = rn(K, r, std=K ** -0.5), rn(r, N, std=N ** -0.5)
        x64, w64, a64, b64 = (t.double() for t in (x, w, a, b))
        exact = x64 @ w64 + (x64 @ a64) @ b64
        got = {"kernel": lm.lora_fwd(x, w, a, b)[0],
               "yardstick": x @ w + (x @ a) @ b}
    else:
        BH, BKV, S, Skv, D = (shape[k] for k in ("BH", "BKV", "S", "Skv",
                                                 "D"))
        q, k, v = rn(BH, S, D), rn(BKV, Skv, D), rn(BKV, Skv, D)
        exact = ref.attention_fwd(q.double(), k.double(), v.double(),
                                  False)[0]
        G = BH // BKV
        sdpa = F.scaled_dot_product_attention(
            q[None], k.repeat_interleave(G, 0)[None],
            v.repeat_interleave(G, 0)[None])[0]
        got = {"kernel": fa.flash_fwd(q, k, v, False, 0, 0)[0],
               "plain fp32": ref.attention_fwd(q, k, v, False)[0],
               "sdpa": sdpa}
    rms = {who: float(((y.double() - exact) ** 2).mean().sqrt())
           for who, y in got.items()}
    ratio = rms["kernel"] / max(v for who, v in rms.items()
                                if who != "kernel")
    print(f"  {name} rms error against fp64: " + ", ".join(
        f"{who} {v:.3e}" for who, v in rms.items())
        + f" (kernel / yardstick {ratio:.2f})")
    require(ratio <= FP64_FACTOR, f"{name} at a decode shape: rms error "
            f"against fp64 {ratio:.2f} times its yardstick's")
    return ratio


def decode_kernel_checks(device, peaks_) -> dict:
    """Phase 16's kernel rows: row 1 at a decode step's (4, 768, 768 | r
    8) and (4, 2048, 2048 | 1024), row 5 at Whisper's decode
    cross-attention (BH 32, Sq 1 over Skv 1500, D 64, non-causal): each
    held to its twin, timed eager and in a CUDA graph beside the matmul
    chain and SDPA, its rms error against fp64 over the yardstick's.
    Returns the rows, tagged "@dec", "@dec-q3", "@dec-q3kv", "@whd"."""
    rows = {}
    for seed, (tag, (name, shape)) in enumerate(DEC_SHAPES.items(), 60):
        kern, _, lib, _, _ = case = kernel_cases(device, seed=seed,
                                                 **shape)[name]
        print(f"  {name}@{tag} (" + ", ".join(
            f"{k} {v}" for k, v in shape.items()
            if (k in "MKNr") == (name == "lora_fwd")) + "):")
        row = time_case(name, case, peaks_)
        row["graph_ms"], row["library_graph_ms"] = graph_ms(kern), \
            graph_ms(lib)
        row["fp64_rms_ratio"] = decode_fp64_ratio(device, name, shape,
                                                  seed + 10)
        print(f"    in a CUDA graph: kernel {row['graph_ms']:.4f} ms, "
              f"library {row['library_graph_ms']:.4f} ms")
        rows[f"{name}@{tag}"] = row
    return rows


def served_adapter(cfg, base, targets, seed: int):
    """A LoRA tree of rank RANK on ``targets`` as ``init_lora`` draws it,
    with B drawn N(0, SERVE_B_STD²) too (a trained adapter's B is not
    zero), both from ``seed`` on the host."""
    import torch

    from repro_torch.peft import lora

    gen = torch.Generator().manual_seed(seed)
    lt = lora.init_lora(gen, base, targets, RANK, SERVE_ALPHA)
    return lora.map_factors(lambda f: {
        "a": f["a"], "b": (torch.randn(f["b"].shape, generator=gen)
                           * SERVE_B_STD).to(f["b"].device)}, lt)


def serve_case(device, cfg, params, extras, expect, merged=None):
    """Phase 16's gates on one served model (``params``: the served tree,
    an adapter bound or merged; ``extras``: the stub frames an
    encoder-decoder's cache reads).  The fp64 plain run (weights and
    extras cast) generates greedily from a seeded prompt, serve.generate
    at temperature 0; every run then decodes that sequence, the prompt
    and the fp64 run's 32 tokens, teacher-forced (serve.decode_logits:
    init_cache and 48 decode_steps), under each_run's settings.

    1. The kernel run's logits from fp64: relative L2 over all steps
       within FLOOR_FACTOR times the larger fp32 plain run's + slack,
       TF32 outside (floor_gate), and at every step within that step's
       own limit.
    2. The kernel run's decode logits against the fp64 plain forward over
       the same 48 tokens, within gate 1's limit.
    3. With ``merged`` (the same adapter merged): its decode logits
       through the kernel policy against the bound kernel run's, within
       gate 1's limit, and no kernel launched.
    Launches: the kernel run's exactly ``expect``.  Then tokens/s,
    batched, as serve.py counts them (batch x 32 generated over the
    host time of generate's 48 steps after init_cache), for the kernel
    and plain fp32 policies (and the merged tree).  Returns the timed
    kernel generate's launch counts and {setting: tokens/s}."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.factory import build_model

    name = cfg.name

    def model(policy):
        return build_model(dataclasses.replace(cfg, kernel_policy=policy))

    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(1, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen).to(device)
    with torch.inference_mode():
        p64, x64 = fp64(params), fp64(extras)
        m64 = model("torch")
        greedy, _ = serve.generate(m64, p64, prompt, SERVE_GEN, 0.0,
                                   batch=x64, cache_dtype=torch.float64)
        seq = torch.cat([prompt, greedy], dim=1)
        logits = {"exact": serve.decode_logits(m64, p64, seq, x64,
                                               torch.float64)}
        forward = m64.forward(p64, dict(x64, tokens=seq))[0]
        print(f"  {name}: fp64 decode against the fp64 forward "
              f"{rel_l2([logits['exact']], [forward]):.3e}")
        del p64, x64
        for role, tag, policy in each_run():
            ops.reset_launches()
            logits[role] = serve.decode_logits(model(policy), params, seq,
                                               extras)
            torch.cuda.synchronize()
            if role == "kernels":
                print(f"  [{tag}] launches {nonzero(ops.launches())}")
                check_launches(ops.launches(), expect)
            else:
                check_launches(ops.launches(), {})
        gaps = from_exact({r: [lg] for r, lg in logits.items()},
                          f"{name} teacher-forced decode logits")
        limit = floor_gate(f"{name} decode logits", gaps)
        MARGINS[f"{name} decode"] = gaps["kernels"] / limit
        worst = 0.0
        for t in range(SERVE_LEN):
            step = {r: rel_l2([lg[:, t]], [logits["exact"][:, t]])
                    for r, lg in logits.items() if r != "exact"}
            lim = FLOOR_FACTOR * max(step["plain"], step["floor"]) \
                + FLOOR_SLACK
            require(step["kernels"] <= lim, f"{name} decode step {t}: "
                    f"kernels {step['kernels']:.3e} from fp64, limit "
                    f"{lim:.3e}")
            worst = max(worst, step["kernels"] / lim)
        print(f"  every step within its own limit (the largest share "
              f"{worst:.3f})")
        gap = rel_l2([logits["kernels"]], [forward])
        MARGINS[f"{name} decode vs forward"] = gap / limit
        print(f"  kernel decode against the fp64 forward {gap:.3e}, at "
              f"{gap / limit:.3f} of the limit")
        require(gap <= limit, f"{name}: the kernel decode is off the fp64 "
                f"forward beyond the limit")
        del forward
        if merged is not None:
            ops.reset_launches()
            lg = serve.decode_logits(model("cuda"), merged, seq, extras)
            check_launches(ops.launches(), {})
            gap = rel_l2([logits["kernels"]], [lg])
            MARGINS[f"{name} bound vs merged"] = gap / limit
            print(f"  the merged adapter's decode against the bound one's "
                  f"{gap:.3e}, at {gap / limit:.3f} of the limit")
            require(gap <= limit, f"{name}: the bound and the merged "
                    f"adapter's decode disagree beyond the limit")
        del logits

        def tokens_per_s(policy, p):
            m = model(policy)
            cache = m.init_cache(p, SERVE_BATCH, SERVE_LEN, extras,
                                 dtype=torch.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve.generate(m, p, prompt, SERVE_GEN, 0.0, cache=cache)
            torch.cuda.synchronize()
            return SERVE_BATCH * SERVE_GEN / (time.perf_counter() - t0)

        ops.reset_launches()
        rate = {"kernels": tokens_per_s("cuda", params)}
        counts = ops.launches()
        check_launches(counts, expect)
        rate["plain"] = tokens_per_s("torch", params)
        if merged is not None:
            rate["merged"] = tokens_per_s("cuda", merged)
    print(f"  {name}: tokens/s batched " + ", ".join(
        f"{k} {v:.1f}" for k, v in rate.items())
        + f" (kernels / plain {rate['kernels'] / rate['plain']:.3f})")
    return counts, rate


def run_serving(device, peaks_):
    """Phase 16: serving on the H100 (module docstring).  Returns
    ({path: the timed kernel generate's launch counts}, the kernel rows,
    {model: tokens/s})."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.peft import lora

    print("phase 16: serving (decode path, launch/serve.py): batch "
          f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_GEN} generated, an "
          f"fp32 cache of {SERVE_LEN}; seed-0 weights")
    t_start = time.perf_counter()
    rows = decode_kernel_checks(device, peaks_)
    by_path, rates = {}, {}
    qkv = ("wq", "wk", "wv")

    def decode_launches(sites, attn=0, prefill_sites=0, prefill_attn=0):
        out = {"lora_fwd": sites * SERVE_LEN + prefill_sites,
               "flash_fwd": attn * SERVE_LEN + prefill_attn}
        return nonzero(out)

    def one(arch, what, layers=None, targets=qkv, bind=True, extras=None,
            expect=None, merged=False):
        """Serves ``arch`` (cut to ``layers``) with a bound (or merged)
        adapter; ``expect(cfg)`` gives the kernel run's launches."""
        t0 = time.perf_counter()
        cfg = registry.get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        print(f"  {cfg.name}: {what}; adapter rank {RANK} on "
              f"{'/'.join(targets)}, " + ("bound" if bind else "merged")
              + (" and merged" if merged else ""))
        base = qwen3_weights(device, cfg) if arch == "qwen3-1.7b" \
            else family_init(device, cfg)
        lt = served_adapter(cfg, base, targets, seed=1)
        served = lora.bind(base, lt, SERVE_ALPHA, RANK) if bind \
            else lora.merge(base, lt, SERVE_ALPHA, RANK)
        both = lora.merge(base, lt, SERVE_ALPHA, RANK) if merged else None
        by_path[f"serve {arch}"], rates[cfg.name] = serve_case(
            device, cfg, served, extras or {},
            expect(cfg) if expect else {}, merged=both)
        del base, lt, served, both
        torch.cuda.empty_cache()
        print(f"  phase 16 {cfg.name} wall_s={time.perf_counter() - t0:.1f}")

    # a bound adapter's step: wq/wk/wv of every layer through row 1
    one("gpt2", "full width and depth (12 layers, d 768, V 50257)",
        expect=lambda c: decode_launches(3 * c.n_layers), merged=True)
    frames = stub_embeds(device, "enc_embeds", (
        SERVE_BATCH, registry.get_config("whisper-base").encoder_seq_len,
        registry.get_config("whisper-base").d_model), 0)
    # Whisper's step: the self-attention's wq/wk/wv and the
    # cross-attention's wq in each decoder layer, one flash
    # cross-attention a layer; its prefill (init_cache): the encoder's
    # wq/wk/wv and flash, and each layer's cross wk/wv of the encoder's
    # output, once
    one("whisper-base", f"full width and depth, {WH_FRAMES} stub frames a "
        "row", extras=frames,
        expect=lambda c: decode_launches(
            4 * c.n_layers, c.n_layers, 3 * c.n_encoder_layers
            + 2 * c.n_layers, c.n_encoder_layers))
    del frames
    one("qwen3-1.7b", "full width and depth (28 layers, d 2048, qk-norm, "
        "V 151936)", expect=lambda c: decode_launches(3 * c.n_layers))
    one("recurrentgemma-2b", f"full width, {RG_SERVE_LAYERS} of its 26 "
        "layers (one pattern group: rglru, rglru, local_attn)",
        layers=RG_SERVE_LAYERS, bind=False)
    one("rwkv6-1.6b", f"full width, {RWKV_SERVE_LAYERS} of its 24 layers",
        layers=RWKV_SERVE_LAYERS, targets=lora.RWKV_TARGETS, bind=False)
    t0 = time.perf_counter()
    with torch.inference_mode():
        require(serve.main(["--arch", "gpt2", "--device", "cuda"]) == 0,
                "serve.main")
    print(f"  serve.main --arch gpt2 (sampled at temperature 1) wall_s="
          f"{time.perf_counter() - t0:.1f}")
    print(f"  phase 16 wall_s={time.perf_counter() - t_start:.1f}")
    return by_path, rows, rates


# --------------------------------------------------------------------------- #
# Phase 17: the generative task
# --------------------------------------------------------------------------- #
def train_step_runs(device, cfg, base, fed, lt, batches):
    """launch/train.py's first steps from its initial LoRA ``lt`` under
    each of each_run(exact=True)'s settings: the generative loss's LoRA
    gradient at ``batches[0]``, then the LoRA after one train step (Adam)
    on each batch.  Returns ({role: first-step gradient leaves}, {role:
    the LoRA's leaves after the steps})."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.core import tasks
    from repro_torch.core.fedavg import make_fns
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build_model
    from repro_torch.peft import lora as lora_lib

    grads, finals = {}, {}
    for role, tag, policy in each_run(exact=True):
        model = build_model(dataclasses.replace(cfg, kernel_policy=policy))
        fns = make_fns(model, fed, task="generative")
        b, l = (fp64(base), fp64(lt)) if role == "exact" else (base, lt)
        with ops.policy_scope(policy):
            live = tree_lib.map_(lambda t: t.detach().requires_grad_(True), l)
            logits, _ = model.forward(lora_lib.bind(
                b, live, fed.lora_alpha,
                lora_lib.tree_rank(live, fed.lora_rank)), batches[0])
            loss, _ = tasks.generative_loss_fn(logits, batches[0])
            grads[role] = torch.autograd.grad(loss, tree_lib.leaves(live))
            del logits, live
            opt = fns["opt_init"](l)
            for x in batches:
                l, opt, loss = fns["train_step"](b, l, opt, x)
                require(math.isfinite(float(loss)), f"{tag} loss {loss}")
        finals[role] = tree_lib.leaves(l)
        del b, l, opt
    torch.cuda.empty_cache()
    return grads, finals


def run_train_py(device, base):
    """Phase 17 (a): ``launch/train.py --arch gpt2`` (full width, TRAIN_STEPS
    steps of TRAIN_BATCH x TRAIN_SEQ on the Markov corpus, ``--ckpt-dir``
    in a temporary directory) from ``base`` (phase 3's seed-0 weights,
    train.py's own ``--seed 0`` draw).  Its first step's LoRA gradient
    and its LoRA after TRAIN_ADAM_STEPS Adam steps gated from fp64; its
    first step lowers the loss of its own batch; the run through the
    kernels (its exit code the one its losses give; launches TRAIN_STEPS
    times a step's; both checkpoints restore bit for bit into the live
    tree, each equal to the LoRA the loop held at its step), then
    through plain PyTorch for its step time.  From random weights at
    full width the loss stays within the batches' spread over 50 steps
    at any learning rate from 1e-3 to 1e-1 (PERF.md), so
    the exit code is printed, not required to be 0.  Returns {path:
    launch counts}."""
    import argparse
    import itertools
    import tempfile

    import numpy as np
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.fedavg import make_fns, to_device
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.factory import build_model

    by_path = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        args = train.parse_args([
            "--arch", "gpt2", "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-dir", ckpt_dir,
            "--device", device.type])
        cfg = train.arch_config(args)
        L = cfg.n_layers
        print(f"phase 17 (a): launch/train.py --arch gpt2, full width, "
              f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}, LoRA rank "
              f"{args.rank} on wq/wk/wv, --ckpt-dir a temporary directory")
        fed = train.fed_config(cfg, args)
        lt = train.initial_lora(base, fed, args)
        batches = [to_device(b, device) for b in itertools.islice(
            train.lm_batches(cfg, args), TRAIN_ADAM_STEPS)]
        step = lora_step_launches(3 * L, L)
        ops.reset_launches()
        grads, finals = train_step_runs(device, cfg, base, fed, lt, batches)
        counts = ops.launches()
        check_launches(counts, {k: (1 + TRAIN_ADAM_STEPS) * n
                                for k, n in step.items()})
        by_path["train.py fp64 gates"] = counts
        gaps = from_exact(grads, "train.py step 0 LoRA gradient")
        MARGINS["train.py first step"] = gaps["kernels"] / floor_gate(
            "train.py first-step LoRA gradient", gaps)
        gaps = from_exact(finals, f"LoRA after {TRAIN_ADAM_STEPS} Adam steps")
        MARGINS[f"train.py {TRAIN_ADAM_STEPS} Adam steps"] = \
            gaps["kernels"] / floor_gate(
                f"train.py LoRA after {TRAIN_ADAM_STEPS} steps", gaps)
        del grads, finals
        fns = make_fns(build_model(dataclasses.replace(
            cfg, kernel_policy="cuda")), fed, task="generative")
        with ops.policy_scope("cuda"):
            _, before = fns["eval_step"](base, lt, batches[0])
            stepped, _, _ = fns["train_step"](base, lt, fns["opt_init"](lt),
                                              batches[0])
            _, after = fns["eval_step"](base, stepped, batches[0])
        print(f"  the first step on its own batch: loss {float(before):.6f} "
              f"-> {float(after):.6f}")
        require(float(after) < float(before), "train.py's first step does "
                "not lower the loss of its batch")
        del stepped
        for policy in ("cuda", "torch"):
            stamps, held = [], {}

            def on_step(i, l, loss):
                stamps.append(time.perf_counter())
                if (i + 1) % train.CKPT_EVERY == 0:
                    held[i + 1] = tree_lib.map_(torch.clone, l)

            run_args = argparse.Namespace(**dict(
                vars(args), ckpt_dir=ckpt_dir if policy == "cuda" else None))
            ops.reset_launches()
            t0 = time.perf_counter()
            res = train.run(run_args, cfg=dataclasses.replace(
                cfg, kernel_policy=policy), base=base, on_step=on_step)
            wall = time.perf_counter() - t0
            counts = ops.launches()
            step_ms = 1e3 * float(np.median(np.diff(stamps)))
            print(f"  [{policy}] train.py: exit {res.rc}, loss "
                  f"{np.mean(res.losses[:5]):.4f} -> "
                  f"{np.mean(res.losses[-5:]):.4f}, step time (median of "
                  f"{TRAIN_STEPS - 1}) {step_ms:.3f} ms, run wall_s "
                  f"{wall:.2f}")
            fell = np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
            require(res.rc == (0 if fell else 1), f"train.py [{policy}] "
                    f"exited {res.rc}, its losses say {0 if fell else 1}")
            if policy == "torch":
                require(not any(counts.values()),
                        f"plain train.py launched kernels: {nonzero(counts)}")
                continue
            check_launches(counts, {k: TRAIN_STEPS * n
                                    for k, n in step.items()})
            by_path["train.py"] = counts
            mgr = CheckpointManager(ckpt_dir)
            require(mgr.steps() == [25, 50], f"checkpoints {mgr.steps()}")
            for at in mgr.steps():
                back, meta = mgr.restore(res.lora, at)
                require(meta == {"loss": res.losses[at - 1]},
                        f"checkpoint {at} metadata {meta}")
                require(all(x.dtype == y.dtype and x.device == y.device
                            and torch.equal(x, y) for x, y in zip(
                                tree_lib.leaves(back),
                                tree_lib.leaves(held[at]))),
                        f"checkpoint {at} does not restore bit for bit")
            require(all(torch.equal(x, y) for x, y in zip(
                tree_lib.leaves(held[TRAIN_STEPS]),
                tree_lib.leaves(res.lora))), "the last held LoRA")
            print(f"  checkpoints {mgr.steps()} restore bit for bit into "
                  f"the live LoRA tree (dtype, device, values)")
    torch.cuda.empty_cache()
    return by_path


def run_generative_rounds(device, cfg, base, data):
    """Phase 17 (b): generative FedLLM, 2 rounds, phase 3's weights and
    data, under ``sequential`` (each_run's five settings) and ``spmd``
    (kernels): ledger bytes and client FLOPs equal to phase 3's
    classification kernel run (the same LoRA moves) and the spmd run's to
    the sequential's; the final LoRA of both kernel runs from the fp64
    run within phase 3's limit; each round's loss within the spread
    gate (1e-3 + FLOOR_FACTOR x the largest fp32 run's difference from
    the plain run); launches those the shapes predict.  Returns {path:
    launch counts}."""
    import torch

    from repro_torch.configs.base import FedConfig
    from repro_torch.core.rounds import run_federated
    from repro_torch.kernels import ops

    pub, clients, test = data
    L = cfg.n_layers
    R = 2
    steps = sum(len(c["tokens"]) // BATCH for c in clients)
    stacked = max(len(c["tokens"]) // BATCH for c in clients)
    evals = len(test["tokens"]) // 64
    fed = FedConfig(framework="fedllm", rounds=R, lora_rank=RANK,
                    lora_dropout=0.0)
    print(f"phase 17 (b): generative FedLLM, gpt2 full width, {R} rounds, "
          f"{len(clients)} clients, sequential and spmd")
    seq3 = CASES["fedllm"]
    runs, counts = {}, {}

    def one(role, tag, policy, f):
        ops.reset_launches()
        t0 = time.perf_counter()
        start = fp64(base) if role == "exact" else base
        res = run_federated(dataclasses.replace(cfg, kernel_policy=policy),
                            f, pub, clients, test, task="generative",
                            batch_size=BATCH, eval_batch=64, device=device,
                            base=start)
        del start
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[role], runs[role] = ops.launches(), res
        for h in res.history:
            require(math.isfinite(h.loss) and h.accuracy == -h.loss,
                    f"{tag} round {h.round}: loss {h.loss}, accuracy "
                    f"{h.accuracy} (minus the loss)")
            print(f"  [{tag}] round {h.round}: loss={h.loss:.6f} "
                  f"wall_s={h.seconds:.3f}")
        print(f"  [{tag}] run wall_s={wall:.3f} launches="
              f"{nonzero(counts[role])}")

    for role, tag, policy in each_run(exact=True):
        one(role, tag, policy, fed)
    one("spmd kernels", "spmd cuda", "cuda",
        dataclasses.replace(fed, backend="spmd"))
    torch.cuda.empty_cache()
    kern, spmd = runs["kernels"], runs["spmd kernels"]
    cls = seq3["results"]["kernels"]
    for what, r in (("sequential", kern), ("spmd", spmd)):
        require(r.ledger.by_name() == cls.ledger.by_name()
                and r.ledger.per_client_round()
                == cls.ledger.per_client_round()
                and r.client_flops == cls.client_flops,
                f"generative FedLLM {what}: ledger or client FLOPs differ "
                f"from phase 3's classification run")
    print(f"  ledger {kern.ledger.by_name()} and client FLOPs "
          f"{kern.client_flops} equal phase 3's classification run's "
          f"(sequential and spmd)")
    check_launches(counts["kernels"], model_launches(L, steps * R,
                                                     evals * R))
    check_launches(counts["spmd kernels"], nonzero(add_counts(
        model_launches(L, stacked * R, 0, True),
        model_launches(L, 0, evals * R))))
    for role in ("plain", "floor", "control", "exact"):
        require(not any(counts[role].values()),
                f"plain run {role} launched kernels")
    limit = seq3["limits"]["lora"]
    exact = runs["exact"].final_lora
    for role in ("kernels", "spmd kernels", "plain", "floor", "control"):
        share, rel, worst = lora_gap(runs[role].final_lora, exact)
        print(f"  final LoRA {role} vs fp64: relative L2 {rel:.3e} (phase "
              f"3's limit {limit:.3e}, {rel / limit:.3f} of it), outside "
              f"atol 5e-5/rtol 5e-4 {share:.3e}, max abs {worst:.3e}")
        if role in ("kernels", "spmd kernels"):
            require(rel <= limit, f"generative FedLLM {role}: final LoRA "
                    f"off the fp64 run beyond phase 3's limit")
            MARGINS["generative FedLLM" + (" spmd" if "spmd" in role
                                           else "")] = rel / limit
    plain = runs["plain"]
    loss = [{role: abs(runs[role].history[i].loss - hp.loss)
             for role in ("kernels", "floor", "control")}
            for i, hp in enumerate(plain.history)]
    limits, failed = fp32_gates("spread", loss)
    require(not failed, "; ".join(failed))
    for i, (d, lim) in enumerate(zip(loss, limits["loss"])):
        d_spmd = abs(spmd.history[i].loss - plain.history[i].loss)
        print(f"  round {i} loss vs plain: " + ", ".join(
            f"{role} {v:.3e}" for role, v in d.items())
            + f", spmd kernels {d_spmd:.3e}, fp64 "
            f"{abs(runs['exact'].history[i].loss - plain.history[i].loss):.3e}"
            f" (limit {lim:.3e})")
        require(d_spmd <= lim, f"generative FedLLM spmd: round {i} loss off "
                f"the plain run beyond the spread limit")
    print("  round wall_s: " + "; ".join(
        f"{role} " + ", ".join(f"{h.seconds:.3f}" for h in runs[role].history)
        for role in ("kernels", "plain", "spmd kernels")))
    return {"generative_fedllm": counts["kernels"],
            "generative_fedllm_spmd": counts["spmd kernels"]}


def kd_step_grads(device, cfg, base, fed, lt, batch, teacher):
    """The student's LoRA gradient of one generative KD step (its full
    logits on ``batch`` against ``teacher`` (B, S, V), KL at
    ``fed.kd_temperature``, unmasked) under each of
    each_run(exact=True)'s settings; the fp64 run takes the KL itself in
    fp64 (kernels/ops.kd_loss, which the others call, runs in fp32).
    Returns {role: gradient leaves}."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.kernels import ops
    from repro_torch.models import loss as losses
    from repro_torch.models.factory import build_model
    from repro_torch.peft import lora as lora_lib

    T = fed.kd_temperature
    grads = {}
    for role, tag, policy in each_run(exact=True):
        model = build_model(dataclasses.replace(cfg, kernel_policy=policy))
        exact = role == "exact"
        b, l = (fp64(base), fp64(lt)) if exact else (base, lt)
        with ops.policy_scope(policy):
            live = tree_lib.map_(lambda t: t.detach().requires_grad_(True), l)
            logits, _ = model.forward(lora_lib.bind(
                b, live, fed.lora_alpha,
                lora_lib.tree_rank(live, fed.lora_rank)), batch)
            if exact:
                tp = torch.log_softmax(teacher.double() / T, -1)
                sp = torch.log_softmax(logits / T, -1)
                loss = (tp.exp() * (tp - sp)).sum(-1).mean() * T * T
            else:
                loss = losses.kd_kl(logits, teacher, T)
            grads[role] = torch.autograd.grad(loss, tree_lib.leaves(live))
        del b, l, logits, live, loss
    torch.cuda.empty_cache()
    return grads


def run_generative_kd(device, cfg, base, data, peaks_):
    """Phase 17 (e): the generative KD steps at GPT-2's vocabulary.  A
    public batch of BATCH x PAD_LEN through ``logits_fn`` (client 0's
    LoRA of the KD program's seed + 2 draw), ``kd.compress_for_wire`` at
    top-k GEN_TOPK int8 (row 12 over 1280 rows of 50257) and one
    ``kd_step`` of client 1's LoRA against it (rows 8 and 9 at (1280,
    50257)), through the kernels: launches exact, the wire bytes by hand,
    row 12's levels, indices and scales its twin's bit for bit; the
    student's LoRA gradient from fp64; rows 8, 9 and 12 timed on the
    path's tensors ("@genkd").  Then a generative KD round raises
    ValueError at b4, as the reference's does.  Returns ({path: launch
    counts}, kernel rows)."""
    import torch

    from repro_torch.configs.base import FedConfig
    from repro_torch.core import compression, kd
    from repro_torch.core.fedavg import make_fns, to_device
    from repro_torch.core.rounds import run_federated
    from repro_torch.data.loader import epoch_batches
    from repro_torch.kernels import ops, ref
    from repro_torch.models.factory import build_model
    from repro_torch.peft import lora as lora_lib

    pub, clients, test = data
    L, V = cfg.n_layers, cfg.vocab_size
    fed = FedConfig(framework="kd", rounds=1, lora_rank=RANK,
                    lora_dropout=0.0, logit_topk=GEN_TOPK, logit_quant_bits=8)
    print(f"phase 17 (e): generative KD steps, gpt2 full width: a public "
          f"batch of {BATCH} x {PAD_LEN}, logits_fn, compress_for_wire at "
          f"top-k {GEN_TOPK} int8, one kd_step (T {fed.kd_temperature})")
    gen = torch.Generator().manual_seed(fed.seed + 2)
    lt_t, lt_s = (lora_lib.init_lora(gen, base, lora_lib.DEFAULT_TARGETS,
                                     RANK, fed.lora_alpha) for _ in range(2))
    batch = to_device(next(iter(epoch_batches(pub, BATCH, seed=0))), device)
    fns = make_fns(build_model(dataclasses.replace(cfg, kernel_policy="cuda")),
                   fed, task="generative")
    ops.reset_launches()
    with ops.policy_scope("cuda"):
        raw = fns["logits_fn"](base, lt_t, batch)
        teacher, wire = kd.compress_for_wire(raw, fed)
        _, _, kd_loss = fns["kd_step"](base, lt_s, fns["opt_init"](lt_s),
                                       batch, teacher)
    torch.cuda.synchronize()
    counts = ops.launches()
    check_launches(counts, add_counts(
        lora_step_launches(3 * L, L), {"lora_fwd": 3 * L, "flash_fwd": L,
                                       "topk_quantize": 1, "kd_fwd": 1,
                                       "kd_bwd": 1}))
    R = raw.shape[0] * raw.shape[1]
    require(tuple(raw.shape) == (BATCH, PAD_LEN, V)
            and wire == R * GEN_TOPK * (1 + 4) + R * 4
            and math.isfinite(float(kd_loss)),
            f"logits {tuple(raw.shape)}, wire {wire}, loss {kd_loss}")
    print(f"  teacher logits {tuple(raw.shape)}, wire {wire} bytes (by hand: "
          f"{R} rows x ({GEN_TOPK} int8 levels + {GEN_TOPK} int32 indices) + "
          f"a 4-byte scale a row), KD loss {float(kd_loss):.6f}; launches "
          f"{nonzero(counts)}")
    with ops.policy_scope("cuda"):
        got = compression.topk_quantize(raw, GEN_TOPK, 8)[0]
    want = ref.topk_quantize_rows_ref(raw.reshape(R, V), GEN_TOPK, 8)
    require(torch.equal(got["values_q"].reshape(R, -1), want[0])
            and torch.equal(got["indices"].reshape(R, -1).int(),
                            want[1].int())
            and torch.equal(got["scale"].reshape(R, -1), want[2]),
            "row 12 on the teacher's logits is not its twin's bits")
    print(f"  row 12 on the path's ({R}, {V}): levels, indices and scales "
          f"bit-identical to its twin")
    gaps = from_exact(kd_step_grads(device, cfg, base, fed, lt_s, batch,
                                    teacher),
                      "generative KD step: the student's LoRA gradient")
    MARGINS["generative KD step"] = gaps["kernels"] / floor_gate(
        "generative KD step: the student's LoRA gradient", gaps)
    with ops.policy_scope("cuda"):
        student = fns["logits_fn"](base, lt_s, batch).reshape(R, V)
    print(f"  rows 8, 9 and 12 on the path's tensors ((1280, {V}), T "
          f"{fed.kd_temperature}; top-k {GEN_TOPK} int8):")
    cases = kd_cases_on(teacher.reshape(R, V).contiguous(), student,
                        torch.full((R,), 1.0 / R, device=device),
                        fed.kd_temperature, raw.reshape(R, V), GEN_TOPK, 8)
    rows = {f"{name}@genkd": time_case(name, cases[name], peaks_)
            for name in ("kd_fwd", "kd_bwd", "topk_quantize")}
    del raw, teacher, student, cases
    torch.cuda.empty_cache()
    print(f"  a generative KD round (public set cut to {BATCH} rows), "
          f"through the kernels, must raise ValueError at b4:")
    try:
        run_federated(dataclasses.replace(cfg, kernel_policy="cuda"), fed,
                      {k: v[:BATCH] for k, v in pub.items()}, clients, test,
                      task="generative", batch_size=BATCH, eval_batch=64,
                      device=device, base=base)
    except ValueError as err:
        require("(C, N, D)" in str(err), f"the wrong ValueError: {err}")
        print(f"  raised ValueError: {err}")
    else:
        require(False, "a generative KD round ran to its end")
    torch.cuda.empty_cache()
    return {"generative_kd_steps": counts}, rows


def run_generative(device, peaks_):
    """Phase 17: the generative task at full gpt2 width from phase 3's
    seed-0 weights and data (module docstring).  Returns ({path: the
    kernel run's launch counts}, the kernel rows)."""
    import torch

    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.gpt2_small import gpt2
    from repro_torch.data import banking77, partition
    from repro_torch.models.factory import build_model

    t_start = time.perf_counter()
    cfg = gpt2()
    pub, train_rows, test = banking77.paper_splits(
        cfg.vocab_size, pad_len=PAD_LEN, scale=0.03)
    clients = partition.iid_partition(train_rows, CLIENTS)
    data = (pub, clients, test)
    base = build_model(cfg).init(torch.Generator().manual_seed(0), device)
    L = cfg.n_layers
    print(f"phase 17: the generative task, gpt2 full width (phase 3's "
          f"weights and data); rows 1, 2, 4-7 at train.py's shapes (M "
          f"{TR_SHAPES['M']}; BH {TR_SHAPES['BH']}, S {TR_SHAPES['S']}):")
    rows = {}
    for name, case in kernel_cases(device, seed=27, **TR_SHAPES).items():
        if name in ("lora_fwd", "lora_dx", "lora_panel", "flash_fwd",
                    "flash_dq", "flash_dkv"):
            rows[f"{name}@tr"] = time_case(name, case, peaks_)
    t0 = time.perf_counter()
    by_path = run_train_py(device, base)
    print(f"  phase 17 (a) wall_s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    by_path.update(run_generative_rounds(device, cfg, base, data))
    print(f"  phase 17 (b) wall_s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    print("phase 17 (c): generative DP-SGD, one step")
    by_path["generative_dp_step"] = dp_first_step(
        device, cfg, base, clients, {
            "lora_fwd": 3 * L, "lora_dx": 3 * L,
            "lora_panel_examples_pair": 3 * L, "flash_fwd": L,
            "flash_dq": L, "flash_dkv": L, "dp_clip_norms": 1,
            "dp_clip_acc": 1}, margin="generative", task="generative")
    print(f"phase 17 (d): generative Split-FedLLM, int{SPLIT_BITS} boundary "
          f"at split_layer {SPLIT_LAYER}, first step's boundary levels:")
    sfed = FedConfig(framework="split", rounds=2, lora_rank=RANK,
                     lora_dropout=0.0, split_layer=SPLIT_LAYER,
                     activation_quant_bits=SPLIT_BITS)
    from repro_torch.kernels import ops
    ops.reset_launches()
    MARGINS["generative Split int8 flips"] = split_flips_gate(
        device, cfg, base, sfed, clients, task="generative")
    by_path["generative_split_step"] = ops.launches()
    check_launches(by_path["generative_split_step"],
                   dict(lora_step_launches(3 * L, L), quant_roundtrip_rows=2))
    print(f"  phase 17 (c, d) wall_s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    kd_paths, kd_rows = run_generative_kd(device, cfg, base, data, peaks_)
    by_path.update(kd_paths)
    rows.update(kd_rows)
    print(f"  phase 17 (e) wall_s={time.perf_counter() - t0:.1f}")
    del base
    torch.cuda.empty_cache()
    print(f"  phase 17 wall_s={time.perf_counter() - t_start:.1f}")
    return by_path, rows


# --------------------------------------------------------------------------- #
# Phase 18: the launch layer's step builders (launch/steps.py) on Qwen3-1.7B
# --------------------------------------------------------------------------- #
def qwen3_weights(device, cfg):
    """Qwen3-1.7B's seed-0 weights on the card: phase 14's draw, kept on
    the host since (QWEN3_HOST), else drawn (family_init)."""
    from repro_torch import tree as tree_lib
    if cfg.n_layers == QWEN3_LAYERS and "base" in QWEN3_HOST:
        t0 = time.perf_counter()
        base = tree_lib.map_(lambda t: t.to(device), QWEN3_HOST["base"])
        print(f"  phase 14's seed-0 weights uploaded from the host wall_s="
              f"{time.perf_counter() - t0:.1f}")
        return base
    return family_init(device, cfg)


def launch_refusal(device) -> None:
    """Phase 18 (a): bf16 CUDA tensors into kernels/ops.lora_matmul and
    ops.mha_attention (flash) under the ``cuda`` policy raise ValueError,
    and nothing launches."""
    import torch

    from repro_torch.kernels import ops

    gen = torch.Generator(device=device).manual_seed(180)

    def bf16(*shape):
        return torch.randn(shape, device=device, generator=gen).bfloat16()

    calls = {"lora_matmul": lambda: ops.lora_matmul(
                 bf16(8, 64), bf16(64, 64), bf16(64, RANK), bf16(RANK, 64)),
             "mha_attention (flash)": lambda: ops.mha_attention(
                 bf16(1, 16, 4, 128), bf16(1, 16, 2, 128),
                 bf16(1, 16, 2, 128))}
    ops.reset_launches()
    with ops.policy_scope("cuda"):
        for what, call in calls.items():
            try:
                call()
            except ValueError as err:
                print(f"  (a) bf16 CUDA tensors into {what}: ValueError "
                      f"({err})")
                continue
            require(False, f"{what} took bf16 CUDA tensors")
    require(not nonzero(ops.launches()), f"a refused call launched: "
            f"{nonzero(ops.launches())}")


def launch_served(cfg, base):
    """The served tree of phase 18's prefill and decode: a rank-RANK
    adapter on wq/wk/wv (served_adapter: B drawn nonzero) bound to
    ``base``, so that its projections run through row 1."""
    from repro_torch.peft import lora
    lt = served_adapter(cfg, base, lora.DEFAULT_TARGETS, seed=188)
    return lora.bind(base, lt, SERVE_ALPHA, RANK)


def launch_train(device, cfg, base, mesh):
    """Phase 18 (b): build_train_step at train_4k (S 4096, global batch 2)
    under remat none, full and selective: launches exact; the first
    step's LoRA gradient, read as Adam's first moment m = (1 - b1)·g, and
    the LoRA after the step the same bits under the three; the kernel
    run's m from fp64 (floor_gate) against the plain, cuBLASLt and TF32
    runs and the fp64 run, all at remat full.  Returns {path: launch
    counts}."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.optim import adam
    from repro_torch.peft import lora

    L = cfg.n_layers
    shape = ShapeConfig("train_4k", LAUNCH_TRAIN_SEQ, LAUNCH_TRAIN_BATCH,
                        "train")
    print(f"phase 18 (b): build_train_step at train_4k (S {shape.seq_len}, "
          f"global batch {shape.global_batch}, cut from 256), adapter rank "
          f"{RANK} on wq/wk/wv with B drawn N(0, {SERVE_B_STD}²)")
    gen = torch.Generator().manual_seed(181)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (shape.global_batch, shape.seq_len),
        generator=gen).to(device, torch.int32)}
    lt = served_adapter(cfg, base, lora.DEFAULT_TARGETS, seed=182)
    opt = adam.init(lt)
    sites = 3 * L
    expect = lora_step_launches(sites, L)
    by_path, runs = {}, {}
    for remat in ("none", "full", "selective"):
        fn, args, _ = steps.build_train_step(
            dataclasses.replace(cfg, kernel_policy="cuda"), shape, mesh, remat=remat,
            dtype=torch.float32)
        require(tuple(args[3]["tokens"].shape) == tuple(
            batch["tokens"].shape), f"example batch {args[3]}")
        want = dict(expect, lora_fwd=2 * sites, flash_fwd=2 * L) \
            if remat != "none" else expect
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        new_lt, new_opt, loss = fn(base, lt, opt, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launches()
        check_launches(counts, want)
        by_path[f"launch train remat {remat}"] = counts
        if remat == "full":
            LAUNCH_MEASURED["train_kernel_s"] = dt
        runs[remat] = (tree_lib.leaves(new_opt["m"]),
                       tree_lib.leaves(new_lt), float(loss))
        print(f"  [cuda, remat {remat}] step wall_s={dt:.3f} loss "
              f"{float(loss):.6f} peak {torch.cuda.max_memory_allocated() / 1e9:.1f}"
              f" GB; launches {nonzero(counts)}")
        del fn, new_lt, new_opt, loss
    same = {remat: all(torch.equal(a, b) for a, b in zip(
        runs[remat][0] + runs[remat][1], runs["none"][0] + runs["none"][1]))
        for remat in ("full", "selective")}
    print("  remat full / selective against none, first-step gradient and "
          "the LoRA after the step: " + ", ".join(
              f"{r} {'bit for bit' if s else 'DIFFER'}"
              for r, s in same.items()))
    values, new = {"kernels": runs["none"][0]}, {"kernels": runs["none"][1]}
    for role, tag, policy in each_run(exact=True):
        if role == "kernels":
            continue
        fn, _, _ = steps.build_train_step(
            dataclasses.replace(cfg, kernel_policy=policy), shape, mesh, remat="full",
            dtype=torch.float32)
        exact = role == "exact"
        b, l = (fp64(base), fp64(lt)) if exact else (base, lt)
        ops.reset_launches()
        t0 = time.perf_counter()
        new_lt, new_opt, loss = fn(b, l, adam.init(l), batch)
        torch.cuda.synchronize()
        check_launches(ops.launches(), {})
        print(f"  [{tag}, remat full] step wall_s="
              f"{time.perf_counter() - t0:.3f} loss {float(loss):.6f}")
        values[role] = tree_lib.leaves(new_opt["m"])
        new[role] = tree_lib.leaves(new_lt)
        del fn, b, l, new_lt, new_opt, loss
    gaps = from_exact(values, "train_4k first-step LoRA gradient (Adam's m)")
    limit = floor_gate("train_4k first-step LoRA gradient", gaps)
    MARGINS["launch train_4k first step"] = gaps["kernels"] / limit
    for remat in ("full", "selective"):
        if not same[remat]:
            gap = rel_l2(runs[remat][0], values["exact"])
            print(f"  remat {remat}: its own first-step gradient from fp64 "
                  f"{gap:.3e}, at {gap / limit:.3f} of the limit")
            require(gap <= limit, f"remat {remat}: the kernel run's "
                    f"first-step gradient is off fp64 beyond the limit")
    print("  the LoRA after the step (Adam's first step, lr·g/(|g| + eps): "
          "not gated, a sign-like update), relative L2 from fp64: " + ", ".join(
              f"{role} {rel_l2(new[role], new['exact']):.3e}"
              for role in ("kernels", "plain", "floor", "control")))
    del values, new, runs
    launch_train_measured(cfg, base, lt, batch, shape, mesh)
    return by_path


def tree_nbytes(tree) -> int:
    """The bytes of a tree's tensors (ints and generators hold none)."""
    import torch

    from repro_torch import tree as tree_lib
    return sum(t.numel() * t.element_size() for t in tree_lib.leaves(tree)
               if torch.is_tensor(t))


def launch_train_measured(cfg, base, lt, batch, shape, mesh) -> None:
    """For phase 19 (b): one more plain (policy ``torch``) train_4k step
    at remat full, under FlopCounterMode, its peak memory read from the
    allocator (max_memory_allocated less what was allocated before it,
    the arguments included), its arguments' bytes; into
    LAUNCH_MEASURED["train"]."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import steps
    from repro_torch.optim import adam

    fn, _, _ = steps.build_train_step(
        dataclasses.replace(cfg, kernel_policy="torch"), shape, mesh,
        remat="full", dtype=torch.float32)
    opt = adam.init(lt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        out = fn(base, lt, opt, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    args = tree_nbytes((base, lt, opt, batch))
    LAUNCH_MEASURED["train"] = {
        "flops": int(fc.get_total_flops()), "args": args,
        "outs": tree_nbytes(out),
        "peak": torch.cuda.max_memory_allocated() - before + args}
    print(f"  [torch, remat full] under FlopCounterMode: "
          f"{LAUNCH_MEASURED['train']['flops']:.6e} FLOPs, peak "
          f"{LAUNCH_MEASURED['train']['peak'] / 1e9:.3f} GB with its "
          f"{args / 1e9:.3f} GB of arguments, wall_s={dt:.3f}")
    del out


def _chunked_attention(chunk):
    """The plain twin's attention (kernels/ref.attention_ref) in blocks of
    ``chunk`` query rows, each row's softmax over every key it reaches
    (a causal row's later keys are masked out and add exact zeros, so the
    keys stop at the block's last row), for prefill yardsticks whose (BH,
    S, S) scores do not fit.  Returns (patched function, the original)."""
    import torch

    from repro_torch.kernels import ref

    orig = ref.attention_ref

    def attention(q, k, v, causal=True, window=0, q_offset=0):
        outs = []
        for i in range(0, q.shape[1], chunk):
            end = min(q.shape[1], i + chunk)
            kend = q_offset + end if causal else k.shape[1]
            outs.append(orig(q[:, i:end], k[:, :kend], v[:, :kend], causal,
                             window, q_offset + i))
        return torch.cat(outs, dim=1)

    return attention, orig


def _last_row_logits(cfg, params, tokens):
    """The model's logits at the last position, the LM head on that row
    alone (models/transformer.forward's layers and final norm)."""
    from repro_torch.models import common, transformer

    h, positions = transformer.embed_tokens(params, cfg, tokens)
    h, _ = transformer.forward_groups(params, cfg, h, positions, 0,
                                      transformer.n_groups_of(cfg),
                                      include_tail=True)
    h = common.apply_norm(cfg.norm, params["final_norm"], h[:, -1:])
    return transformer.lm_logits(params, cfg, h)[:, 0]


def launch_prefill(device, cfg, base, mesh):
    """Phase 18 (c): build_prefill_step at prefill_32k (S 32768, batch 1),
    the served tree an adapter bound (launch_served): the kernel run as
    built (full logits, the last row returned), launches exact; its last-row logits from fp64 (floor_gate) against plain,
    cuBLASLt, TF32 and fp64 runs of the twin's formula in blocks of query
    rows with the LM head on the last row (_chunked_attention,
    _last_row_logits).  Returns {path: launch counts}."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps

    L = cfg.n_layers
    shape = ShapeConfig("prefill_32k", LAUNCH_PREFILL_SEQ, 1, "prefill")
    print(f"phase 18 (c): build_prefill_step at prefill_32k (S "
          f"{shape.seq_len}, batch 1, cut from 32); full logits "
          f"({shape.seq_len} x {cfg.vocab_size} fp32, "
          f"{shape.seq_len * cfg.vocab_size * 4 / 1e9:.1f} GB)")
    gen = torch.Generator().manual_seed(183)
    tokens = torch.randint(0, cfg.vocab_size, (1, shape.seq_len),
                           generator=gen).to(device, torch.int32)
    params = launch_served(cfg, base)
    fn, _, _ = steps.build_prefill_step(dataclasses.replace(cfg, kernel_policy="cuda"), shape,
                                        mesh, dtype=torch.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits = {"kernels": fn(params, {"tokens": tokens})}
    torch.cuda.synchronize()
    counts = ops.launches()
    t1 = time.perf_counter()
    print(f"  [cuda] prefill wall_s={t1 - t0:.3f} peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; launches "
          f"{nonzero(counts)}")
    check_launches(counts, {"lora_fwd": 3 * L, "flash_fwd": L})
    LAUNCH_MEASURED["prefill"] = {
        "kernel_s": t1 - t0,
        # the builder's arguments: the base and the batch (the served
        # adapter's factors are left out on both sides)
        "args": tree_nbytes((base, {"tokens": tokens}))}
    del fn
    for role, tag, policy in each_run(exact=True):
        if role == "kernels":
            continue
        exact = role == "exact"
        p = fp64(params) if exact else params
        patched, orig = _chunked_attention(LAUNCH_CHUNK_FP64 if exact
                                           else LAUNCH_CHUNK)
        ref.attention_ref = patched
        ops.reset_launches()
        t0 = time.perf_counter()
        try:
            with torch.no_grad(), ops.policy_scope(policy):
                logits[role] = _last_row_logits(cfg, p, tokens)
            torch.cuda.synchronize()
        finally:
            ref.attention_ref = orig
        check_launches(ops.launches(), {})
        print(f"  [{tag}] last-row forward wall_s="
              f"{time.perf_counter() - t0:.3f}")
        del p
    gaps = from_exact({r: [lg] for r, lg in logits.items()},
                      "prefill_32k last-position logits")
    MARGINS["launch prefill_32k"] = gaps["kernels"] / floor_gate(
        "prefill_32k last-position logits", gaps)
    del logits, params
    return {"launch prefill": counts}


def _decode_fp64(cfg, p64, cache, tails, token, pos):
    """transformer.decode_step in fp64 over the fp32 cache: each layer's
    K/V cast to fp64 on the fly, the fp64 K/V of the positions decoded so
    far (``tails[i]``, from fill) laid over it, this position's appended
    to ``tails``; the fp32 cache is left as it is."""
    from repro_torch.models import common, transformer

    h = transformer.embed_token(p64, cfg, token, pos)
    for i, (lp, kind) in enumerate(zip(p64["layers"], cfg.layer_kinds)):
        c = {name: t.double() for name, t in cache["layers"][i].items()}
        for j, kv in enumerate(tails[i]):
            for name, t in kv.items():
                c[name][:, LAUNCH_DECODE_FILL + j] = t
        h, c = transformer.block_decode(lp, cfg, kind, h, c, pos)
        tails[i].append({name: t[:, pos].clone() for name, t in c.items()})
        del c
    h = common.apply_norm(cfg.norm, p64["final_norm"], h)
    return transformer.lm_logits(p64, cfg, h)[:, 0]


def launch_decode(device, cfg, base, mesh):
    """Phase 18 (d): build_decode_step at decode_32k: an fp32 cache
    32768 deep for batch 4, its first 32760 positions filled on the card
    from a seed, then 8 decode steps teacher-forced (seeded tokens) under
    each_run's settings over the same cache (a step writes its position
    before it reads it) and in fp64 (_decode_fp64), the served tree an
    adapter bound (launch_served); the kernel run's
    logits from fp64 (floor_gate), every step within its own limit;
    launches exact (row 1 at M 4).  Returns {path: launch counts}."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.factory import build_model

    L = cfg.n_layers
    shape = ShapeConfig("decode_32k", LAUNCH_DECODE_DEPTH, LAUNCH_DECODE_BATCH,
                        "decode")
    B, n = shape.global_batch, LAUNCH_DECODE_DEPTH - LAUNCH_DECODE_FILL
    t0 = time.perf_counter()
    cache = build_model(cfg).init_cache(base, B, shape.seq_len,
                                        dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(184)
    for layer in cache["layers"]:
        for t in layer.values():
            t[:, :LAUNCH_DECODE_FILL].normal_(generator=gen)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * 4 for layer in cache["layers"]
                 for t in layer.values())
    print(f"phase 18 (d): build_decode_step at decode_32k (batch {B}, cut "
          f"from 128): an fp32 cache {shape.seq_len} deep "
          f"({nbytes / 1e9:.1f} GB), {LAUNCH_DECODE_FILL} positions filled "
          f"on the card wall_s={time.perf_counter() - t0:.1f}; {n} steps")
    tokens = torch.randint(0, cfg.vocab_size, (n, B),
                           generator=torch.Generator().manual_seed(185)
                           ).to(device, torch.int32)
    params = launch_served(cfg, base)
    logits, counts = {}, None
    for role, tag, policy in each_run():
        fn, _, _ = steps.build_decode_step(dataclasses.replace(cfg, kernel_policy=policy),
                                           shape, mesh, dtype=torch.float32)
        ops.reset_launches()
        out, times = [], []
        for s in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = fn(params, cache, tokens[s],
                           torch.tensor(LAUNCH_DECODE_FILL + s))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            out.append(lg)
        logits[role] = torch.stack(out)
        if role == "kernels":
            counts = ops.launches()
            check_launches(counts, {"lora_fwd": 3 * L * n})
            LAUNCH_MEASURED["decode"] = {
                "kernel_s": sorted(times)[n // 2],
                # the base, the cache and a step's token (the served
                # adapter's factors left out on both sides)
                "args": tree_nbytes((base, cache, tokens[0]))}
        else:
            check_launches(ops.launches(), {})
        print(f"  [{tag}] decode step wall_s median "
              f"{sorted(times)[n // 2]:.4f} (first {times[0]:.4f})")
    p64 = fp64(params)
    del params
    tails = [[] for _ in range(L)]
    t0 = time.perf_counter()
    with torch.no_grad(), ops.policy_scope("torch"):
        logits["exact"] = torch.stack([
            _decode_fp64(cfg, p64, cache, tails, tokens[s],
                         LAUNCH_DECODE_FILL + s) for s in range(n)])
    torch.cuda.synchronize()
    print(f"  [torch-fp64] {n} steps wall_s={time.perf_counter() - t0:.3f}")
    del p64, tails, cache
    gaps = from_exact({r: [lg] for r, lg in logits.items()},
                      "decode_32k teacher-forced logits")
    limit = floor_gate("decode_32k logits", gaps)
    MARGINS["launch decode_32k"] = gaps["kernels"] / limit
    worst = 0.0
    for s in range(n):
        step = {r: rel_l2([lg[s]], [logits["exact"][s]])
                for r, lg in logits.items() if r != "exact"}
        lim = FLOOR_FACTOR * max(step["plain"], step["floor"]) + FLOOR_SLACK
        require(step["kernels"] <= lim, f"decode_32k step {s}: kernels "
                f"{step['kernels']:.3e} from fp64, limit {lim:.3e}")
        worst = max(worst, step["kernels"] / lim)
    print(f"  every step within its own limit (the largest share "
          f"{worst:.3f})")
    return {"launch decode": counts}


def _update_flips(got, start, exact) -> float:
    """Share of LoRA entries whose update from ``start`` has another sign
    than the fp64 run's (entries the fp64 run leaves in place skipped)."""
    n = flips = 0
    for g, s, e in zip(got, start, exact):
        de = (e - s.double()).sign()
        live = de != 0
        flips += int(((g.double() - s.double()).sign() != de)[live].sum())
        n += int(live.sum())
    return flips / max(n, 1)


def launch_round_runs(device, cfg, base, mesh, shape, framework, make_args,
                      read, expect, **kw):
    """One fed_round program under each_run(exact=True)'s settings:
    build_fed_round_step for the policy, ``make_args(args, exact)`` the
    real arguments (fp64 trees for the fp64 run) with fresh generators,
    ``read(outputs)`` -> (continuous leaves, LoRA leaves).  Launches of
    the kernel run exact.  Returns ({role: (continuous, LoRA)}, the kernel
    run's launch counts)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    out, counts = {}, None
    for role, tag, policy in each_run(exact=True):
        fn, args, _ = steps.build_fed_round_step(
            dataclasses.replace(cfg, kernel_policy=policy), shape, mesh,
            n_clients=LAUNCH_CLIENTS, n_local_steps=1, framework=framework,
            dtype=torch.float32, **kw)
        real = make_args(args, role == "exact")
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*real)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if role == "kernels":
            counts = ops.launches()
            check_launches(counts, expect)
        else:
            check_launches(ops.launches(), {})
        out[role] = read(res)
        print(f"  [{tag}] round wall_s={dt:.3f}")
        del fn, real, res
    return out, counts


def launch_round_gates(what, runs, start) -> None:
    """The gates of one fed_round program: its continuous outputs (Adam's
    first moments) from fp64 (floor_gate), and the signs of its LoRA
    updates from ``start`` against the fp64 run's (fp32_gates' flips)."""
    gaps = from_exact({r: v[0] for r, v in runs.items()},
                      f"{what}: Adam's first moments")
    MARGINS[f"launch {what}"] = gaps["kernels"] / floor_gate(
        f"{what}: Adam's first moments", gaps)
    flips = {r: _update_flips(v[1], start, runs["exact"][1])
             for r, v in runs.items() if r != "exact"}
    limit = fp32_gates(flips=flips)[0]["flips"]
    print(f"  {what}: share of LoRA update signs off fp64's: " + ", ".join(
        f"{r} {s:.3e}" for r, s in flips.items())
        + f"; limit {limit:.3e}, kernels at {flips['kernels'] / limit:.3f} "
        f"of it, TF32 control {flips['control'] / limit:.1f}x")
    require(flips["kernels"] <= limit, f"{what}: the kernel run's LoRA "
            f"update signs part from fp64's beyond the fp32 runs' limit")
    require(flips["control"] > limit, f"{what}: the update-sign gate does "
            f"not reject the TF32 control run")


def launch_rounds(device, cfg, base, mesh):
    """Phase 18 (e): build_fed_round_step at train_4k cut to S 512, 2
    clients of batch 2, one local step: FedLLM (generative), KD
    (classification), Split (generative), FedLLM under DP (clip at the
    median per-example norm of the first step, noise 0) and FedLLM at
    n_edges 2 (within 1e-6 of n_edges 1, relative L2); each of the first
    four under each_run(exact=True)'s settings, gated by
    launch_round_gates; launches exact.  Returns {path: launch counts}."""
    import numpy as np
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import FedConfig, PrivacyConfig, ShapeConfig
    from repro_torch.core import fed_spmd
    from repro_torch.core import split as split_mod
    from repro_torch.core.fedavg import make_fns
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adam
    from repro_torch.peft import lora

    L, C = cfg.n_layers, LAUNCH_CLIENTS
    sites = 3 * L
    Bc = LAUNCH_CLIENT_BATCH
    shape = ShapeConfig("train_4k", LAUNCH_ROUND_SEQ, C * Bc, "train")
    print(f"phase 18 (e): build_fed_round_step at train_4k cut to S "
          f"{shape.seq_len}: {C} clients of batch {Bc}, one local step")
    rng = np.random.default_rng(186)
    S = shape.seq_len
    tokens = rng.integers(0, cfg.vocab_size, (C, 1, Bc, S)).astype(np.int32)
    valid = np.ones((C, 1), bool)
    weights = np.array([3.0, 1.0], np.float32)
    lt = served_adapter(cfg, base, lora.DEFAULT_TARGETS, seed=187)

    def gens(seed):
        return [torch.Generator().manual_seed(seed + c) for c in range(C)]

    def cast(tree, exact):
        return fp64(tree) if exact else tree

    slt0 = fed_spmd.stack_for_clients(lt, C)
    by_path = {}
    step = {"lora_fwd_clients": sites, "lora_dx_clients": sites,
            "lora_panel_clients": 2 * sites, "flash_fwd": L, "flash_dq": L,
            "flash_dkv": L}

    def fedllm_args(args, exact):
        s = cast(slt0, exact)
        return (cast(base, exact), s, fed_spmd.stack_for_clients(
            adam.init(cast(lt, exact)), C), {"tokens": tokens}, gens(190),
            valid, weights)

    def fedllm_read(res):
        redist, new_opt, _, _ = res
        return (tree_lib.leaves(new_opt["m"]),
                tree_lib.leaves(fed_spmd.unstack_tree(redist, C)[0]))

    start = tree_lib.leaves(lt)
    t0 = time.perf_counter()
    runs, by_path["launch fed_round fedllm"] = launch_round_runs(
        device, cfg, base, mesh, shape, "fedllm", fedllm_args, fedllm_read,
        step)
    launch_round_gates("fed_round FedLLM", runs, start)
    print(f"  fed_round FedLLM wall_s={time.perf_counter() - t0:.1f}")
    flat = runs["kernels"][1]
    del runs

    # n_edges 2: the two-hop aggregate, a kernel run
    from repro_torch.launch import steps
    fn, args, _ = steps.build_fed_round_step(
        dataclasses.replace(cfg, kernel_policy="cuda"), shape, mesh, n_clients=C,
        n_local_steps=1, framework="fedllm", n_edges=2, dtype=torch.float32)
    ops.reset_launches()
    res = fn(*fedllm_args(args, False))
    by_path["launch fed_round fedllm n_edges 2"] = ops.launches()
    check_launches(by_path["launch fed_round fedllm n_edges 2"], step)
    gap = rel_l2(fedllm_read(res)[1], flat)
    print(f"  fed_round FedLLM at n_edges 2 against n_edges 1: relative L2 "
          f"{gap:.3e} (limit {LAUNCH_EDGES_LIMIT:g})")
    require(gap <= LAUNCH_EDGES_LIMIT, "n_edges 2 parts from n_edges 1")
    del fn, res, flat

    # DP-SGD: clip at the median per-example norm of the first step
    fed = FedConfig(lora_rank=RANK, lora_alpha=32.0)
    fns = make_fns(build_model(dataclasses.replace(cfg, kernel_policy="torch")), fed,
                   "generative")
    first = fed_spmd.step_batch(fed_spmd.batches_on({"tokens": tokens},
                                                     device), 0)
    _, rows = fns["per_example_grads_clients"](base, slt0, first, gens(190))
    norms = torch.linalg.vector_norm(rows, dim=2).flatten()
    clip = float(norms.median())
    print("  per-example gradient norms of the first step: " + " ".join(
        f"{x:.4g}" for x in sorted(norms.tolist())) + f"; clip {clip:.6g}")
    require(bool((norms > clip).any() and (norms <= clip).any()),
            "the DP clip clips all rows or none")
    del rows, norms, fns
    dp_step = dict(step, lora_panel_examples_pair=sites, dp_clip_norms=1,
                   dp_clip_acc_clients=1)
    dp_step.pop("lora_panel_clients")
    t0 = time.perf_counter()
    runs, by_path["launch fed_round fedllm dp"] = launch_round_runs(
        device, cfg, base, mesh, shape, "fedllm", fedllm_args, fedllm_read,
        dp_step, privacy=PrivacyConfig(dp_clip=clip))
    launch_round_gates("fed_round DP-FedLLM", runs, start)
    print(f"  fed_round DP-FedLLM wall_s={time.perf_counter() - t0:.1f}")
    del runs

    # KD at classification: labels, lengths and a public batch
    kd_batch = {"tokens": tokens,
                "labels": rng.integers(0, 77, (C, 1, Bc)).astype(np.int32),
                "lengths": rng.integers(S // 2, S + 1, (C, 1, Bc))
                .astype(np.int32)}
    public = {"tokens": rng.integers(0, cfg.vocab_size, (Bc, S))
              .astype(np.int32),
              "lengths": rng.integers(S // 2, S + 1, (Bc,)).astype(np.int32)}
    kd_lts = [served_adapter(cfg, base, lora.DEFAULT_TARGETS, seed=191 + c)
              for c in range(C + 1)]
    kd_slt = fed_spmd.stack_trees(kd_lts[:C])

    def kd_args(args, exact):
        s = cast(kd_slt, exact)
        server = cast(kd_lts[C], exact)
        return (cast(base, exact), s, fed_spmd.stack_for_clients(
            adam.init(cast(kd_lts[0], exact)), C), server, adam.init(server),
            kd_batch, gens(200), valid, weights, public, gens(210),
            torch.Generator().manual_seed(220))

    def kd_read(res):
        slt, sopt, server_lt, server_opt = res
        return (tree_lib.leaves(sopt["m"]) + tree_lib.leaves(server_opt["m"]),
                tree_lib.leaves(slt) + tree_lib.leaves(server_lt))

    # b1 and b8 a stacked step each, b2 a stacked forward, b5 the server's
    # step, b6 its forward; the KD loss (b5, b8) one forward and one
    # backward launch each over its rows
    kd_step = add_counts(step, step, {"lora_fwd_clients": sites,
                                      "flash_fwd": L},
                         lora_step_launches(sites, L),
                         {"lora_fwd": sites, "flash_fwd": L},
                         {"kd_fwd": 2, "kd_bwd": 2})
    t0 = time.perf_counter()
    runs, by_path["launch fed_round kd"] = launch_round_runs(
        device, cfg, base, mesh, shape, "kd", kd_args, kd_read, kd_step)
    launch_round_gates("fed_round KD", runs, tree_lib.leaves(kd_slt)
                       + tree_lib.leaves(kd_lts[C]))
    print(f"  fed_round KD wall_s={time.perf_counter() - t0:.1f}")
    del runs

    # Split at the split point of make_split_fns (FedConfig.split_layer)
    n_client = split_mod.make_split_fns(
        build_model(cfg), FedConfig(framework="split", lora_rank=RANK),
        "generative")["n_client_layers"]
    base_c, base_s = split_mod.split_base(base, n_client)
    c0, s0 = split_mod.split_lora(lt, n_client)

    def split_args(args, exact):
        bc, bs = cast(base_c, exact), cast(base_s, exact)
        c, s = cast(c0, exact), cast(s0, exact)
        return (bc, bs, c, s, adam.init(s), {"tokens": tokens}, gens(230),
                valid, weights)

    def split_read(res):
        c_glob, s_lt, s_opt, _, _ = res
        return (tree_lib.leaves(s_opt["m"]),
                tree_lib.leaves(c_glob) + tree_lib.leaves(s_lt))

    t0 = time.perf_counter()
    runs, by_path["launch fed_round split"] = launch_round_runs(
        device, cfg, base, mesh, shape, "split", split_args, split_read,
        {k: C * v for k, v in lora_step_launches(sites, L).items()})
    launch_round_gates("fed_round Split", runs, tree_lib.leaves(c0)
                       + tree_lib.leaves(s0))
    print(f"  fed_round Split wall_s={time.perf_counter() - t0:.1f}")
    del runs
    return by_path


def launch_kernel_checks(device, peaks_) -> dict:
    """Phase 2 at phase 18's shapes: rows 1, 2, 4 at train_4k's LoRA
    sites (M 8192: wq (8192, 2048, 2048), wk/wv (8192, 2048, 1024)) and
    rows 5-7 at its attention (BH 32 over 16, S 4096, D 128, causal), each
    held to its twin, the flash kernels' rms error against fp64 gated as
    flash_fp64_errors gates it, timed beside the matmul chain and SDPA
    ("@4k", "@4kkv"); row 1 at prefill_32k's sites (M 32768) and row 5 at
    its attention (BH 16 over 8, S 32768, D 128, causal), which no (BH, S,
    S) twin fits beside: held to the twin and to fp64 on blocks of query
    rows (long_prefill_flash), timed beside SDPA and the twin in blocks
    ("@32k", "@32kkv").  Returns the rows."""
    rows = {}
    for tag, shape, seed, names in (
            ("4k", TRAIN4K_SHAPES, 40, ("lora_fwd", "lora_dx", "lora_panel",
                                         "lora_panel_t", "flash_fwd",
                                         "flash_dq", "flash_dkv")),
            ("32k", PREFILL32K_SHAPES, 42, ("lora_fwd",))):
        print(f"  phase 18's kernels at {tag} (M {shape['M']}, K = N = "
              f"{shape['K']}" + (f"; BH {shape['BH']} over {shape['BKV']}, "
                                 f"S {shape['S']}, D {shape['D']}, causal"
                                 if tag == "4k" else "") + "):")
        if tag == "4k":
            flash_fp64_errors(device, shape["BH"], shape["BKV"], shape["S"],
                              shape["D"], True, 0, seed)
            rms, lib = lora_fp64_errors(device, shape["M"], shape["K"],
                                        shape["N"], seed + 5)
            for op, err in rms["kernel"].items():
                require(err <= FP64_FACTOR * rms[lib][op],
                        f"LoRA {op} kernel at {tag}: rms error against fp64 "
                        f"{err:.3e} exceeds {FP64_FACTOR} times {lib}'s "
                        f"{rms[lib][op]:.3e}")
        for name, case in kernel_cases(device, seed=seed, **shape).items():
            if name in names:
                rows[f"{name}@{tag}"] = time_case(name, case, peaks_)
        print(f"  LoRA kernels at {tag}'s wk/wv (M {shape['M']}, K "
              f"{shape['K']}, N {KV_WIDTH}):")
        for name, case in kernel_cases(device, seed=seed + 10, **dict(
                shape, N=KV_WIDTH, **_NO_ATTN)).items():
            if name in names and name.startswith("lora_"):
                rows[f"{name}@{tag}kv"] = time_case(name, case, peaks_)
    rows["flash_fwd@32k"] = long_prefill_flash(device, peaks_, seed=44)
    return rows


def long_prefill_flash(device, peaks_, seed) -> dict:
    """Row 5 at prefill_32k's attention (BH 16 over 8, S 32768, D 128,
    causal), where the twin's (BH, S, S) scores would take 68.7 GB: o and
    lse against the twin (attention_fwd) on blocks of LONG_ROWS query rows
    at LONG_BLOCKS (the first, middle and last rows among them; each
    block's keys up to its last row), and o's rms error there against an
    fp64 run of the twin within FP64_FACTOR times the larger of the fp32
    twin's and SDPA's; timed (few calls) beside SDPA and the twin in
    blocks of LAUNCH_CHUNK rows.  Returns its row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    BH, BKV, S, D = (PREFILL32K_ATTN[k] for k in ("BH", "BKV", "S", "D"))
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, device=device, generator=gen)
               for shape in ((BH, S, D), (BKV, S, D), (BKV, S, D)))
    G = BH // BKV
    o, lse = fa.flash_fwd(q, k, v, True, 0, 0)
    ke, ve = (t.repeat_interleave(G, dim=0) for t in (k, v))
    sdpa = F.scaled_dot_product_attention(q[None], ke[None], ve[None],
                                          is_causal=True)[0]
    err, sq = 0.0, {"kernel": 0.0, "plain fp32": 0.0, "sdpa": 0.0}
    n = 0
    for start in LONG_BLOCKS:
        end = start + LONG_ROWS
        blk = (q[:, start:end], k[:, :end], v[:, :end])
        po, plse = ref.attention_fwd(*blk, True, 0, start)
        eo, _ = ref.attention_fwd(*(t.double() for t in blk), True, 0, start)
        for got, want in ((o[:, start:end], po), (lse[:, start:end], plse)):
            require(bool(torch.isfinite(got).all()), "flash_fwd@32k output "
                    "not finite")
            require(torch.allclose(got, want, atol=ATOL, rtol=RTOL),
                    f"flash_fwd@32k disagrees with its twin on rows "
                    f"[{start}, {end}) (max abs err "
                    f"{(got - want).abs().max().item():.3e})")
            err = max(err, (got - want).abs().max().item())
        for who, y in (("kernel", o[:, start:end]), ("plain fp32", po),
                       ("sdpa", sdpa[:, start:end])):
            sq[who] += float(((y.double() - eo) ** 2).sum())
        n += eo.numel()
    rms = {who: (s / n) ** 0.5 for who, s in sq.items()}
    ratio = rms["kernel"] / max(rms["plain fp32"], rms["sdpa"])
    print(f"  flash o at BH {BH} over {BKV}, S {S}, D {D}, on rows "
          f"{list(LONG_BLOCKS)} (+{LONG_ROWS}): rms error against fp64 "
          + ", ".join(f"{who} {r:.3e}" for who, r in rms.items())
          + f" (kernel / yardstick {ratio:.2f})")
    require(ratio <= FP64_FACTOR, f"flash_fwd@32k: rms error against fp64 "
            f"{ratio:.2f} times its yardstick's")
    del sdpa
    chunked, _ = _chunked_attention(LAUNCH_CHUNK)
    pairs = BH * S * (S + 1) // 2
    f4 = 4
    row = {"max_abs_err": err, "fp64_rms_ratio": ratio,
           "ms": cuda_ms(lambda: fa.flash_fwd(q, k, v, True, 0, 0), iters=5,
                         warmup=1),
           "plain_ms": cuda_ms(lambda: chunked(q, k, v, True, 0, 0), iters=2,
                               warmup=1),
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
               q[None], ke[None], ve[None], is_causal=True), iters=5,
               warmup=1)}
    nbytes = f4 * (2 * BH * S * D + 2 * BKV * S * D + BH * S)
    row.update(kernel_bound("flash_fwd", nbytes, pairs * 4 * D, peaks_),
               bytes=nbytes, flops=pairs * 4 * D)
    print(f"  flash_fwd@32k: max abs err {err:.3e} (atol {ATOL}, rtol "
          f"{RTOL}, on the sampled rows) kernel_ms {row['ms']:.4f} plain_ms "
          f"(the twin in blocks of {LAUNCH_CHUNK} rows) {row['plain_ms']:.4f}"
          f" library_ms {row['library_ms']:.4f} bound_ms "
          f"{row['bound_ms']:.4g} ({row['bound_by']})")
    del q, k, v, o, lse, ke, ve
    torch.cuda.empty_cache()
    return row


def run_launch(device, peaks_):
    """Phase 18: the launch layer's step builders on Qwen3-1.7B at full
    width and depth, seed-0 weights (module docstring).  Returns {path:
    the kernel run's launch counts}."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import mesh as mesh_mod

    t_start = time.perf_counter()
    print("phase 18: launch/steps.py's builders on qwen3-1.7b, full width "
          "and depth, fp32 weights (the CUDA kernels are fp32)")
    launch_refusal(device)
    cfg = registry.get_config("qwen3-1.7b")
    mesh = mesh_mod.make_production_mesh()
    base = qwen3_weights(device, cfg)
    by_path = {}
    for part, fn in (("b", launch_train), ("c", launch_prefill),
                     ("d", launch_decode), ("e", launch_rounds)):
        t0 = time.perf_counter()
        by_path.update(fn(device, cfg, base, mesh))
        torch.cuda.empty_cache()
        print(f"  phase 18 ({part}) wall_s={time.perf_counter() - t0:.1f}")
    del base
    torch.cuda.empty_cache()
    print(f"  phase 18 wall_s={time.perf_counter() - t_start:.1f}")
    return by_path


# phase 19's traces in DRYRUN_PARTS processes of their own: (b) and the
# 16 x 16 records; the 2 x 16 x 16 train, prefill, decode and FedLLM
# records; its KD round; its Split round
DRYRUN_PARTS = 4


def dry_run_records(out_path, part: int) -> None:
    """Part ``part`` of phase 19's traces (launch/dryrun.py), run by
    start_dry_run in a process of its own that sees no card, at the
    lowest priority, one thread: (a) Qwen3-1.7B's train_4k, prefill_32k
    and decode_32k steps and its FedLLM, KD and Split rounds at
    train_4k, bf16, on the 16 x 16 and 2 x 16 x 16 fake meshes; (b) phase
    18's own cut steps on a one-device mesh in fp32 under the plain
    policy (train_4k at global batch 2 under remat full, prefill_32k at
    batch 1, decode_32k at batch 4 over phase 18's fp32 cache).  Writes
    them to ``out_path`` as JSON."""
    import os

    os.nice(19)
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import specs as specs_mod
    from repro_torch.launch import steps
    from repro_torch.models.factory import build_model

    t0 = time.perf_counter()
    out = {"a": [], "b": {}}
    cases = [(False, s, "auto", None) for s in ("train_4k", "prefill_32k",
                                                "decode_32k")]
    cases += [(False, "train_4k", "fed_round", f)
              for f in ("fedllm", "kd", "split")]
    cases += [(True, s, "auto", None) for s in ("train_4k", "prefill_32k",
                                               "decode_32k")]
    cases += [(True, "train_4k", "fed_round", f)
              for f in ("fedllm", "kd", "split")]
    mine = {0: cases[:6], 1: cases[6:10], 2: cases[10:11],
            3: cases[11:]}[part]
    for multi_pod, shape, step, framework in mine:
        out["a"].append(dryrun.run_one(
            "qwen3-1.7b", shape, multi_pod, step=step,
            fed_framework=framework or "fedllm", verbose=False))
    cfg = dataclasses.replace(registry.get_config("qwen3-1.7b"),
                              kernel_policy="torch")
    one = mesh_mod.MeshSpec((1, 1), ("data", "model"))
    for name, shape in (
            ("train", ShapeConfig("train_4k", LAUNCH_TRAIN_SEQ,
                                  LAUNCH_TRAIN_BATCH, "train")),
            ("prefill", ShapeConfig("prefill_32k", LAUNCH_PREFILL_SEQ, 1,
                                    "prefill")),
            ("decode", ShapeConfig("decode_32k", LAUNCH_DECODE_DEPTH,
                                   LAUNCH_DECODE_BATCH, "decode"))):
        if part:
            break
        fn, args, specs = steps.build_step(cfg, shape, one, remat="full",
                                           dtype=torch.float32)
        if name == "decode":
            args = list(args)
            args[1] = specs_mod.abstract_cache(build_model(cfg), args[0],
                                               shape, dtype=torch.float32)
        prog = dryrun.trace_step(fn, args, specs, one, shape.mode, shape)[0]
        out["b"][name] = dict(prog, shape=shape.name,
                              batch=shape.global_batch, seq=shape.seq_len)
    out["wall_s"] = time.perf_counter() - t0
    out["cpu_s"] = time.process_time()
    Path(out_path).write_text(json.dumps(out))


def _part_path(part: int) -> Path:
    return DRYRUN_JSON.with_name(f"{DRYRUN_JSON.stem}_{part}.json")


def start_dry_run():
    """Starts dry_run_records' parts, each in a process of its own (no
    card visible, its output to build/dryrun_phase19_<part>.log); phase 19
    collects them."""
    import os

    DRYRUN_JSON.parent.mkdir(parents=True, exist_ok=True)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.dry_run_records(sys.argv[2], int(sys.argv[3]))")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for part in range(DRYRUN_PARTS):
        path = _part_path(part)
        path.unlink(missing_ok=True)
        with open(path.with_suffix(".log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(ROOT), str(path),
                 str(part)], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def stop(procs) -> None:
    for proc in procs or ():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_dry_run(procs, deadline: float) -> None:
    """Phase 19: the dry run's records (dry_run_records, traced beside
    phases 2-18).  (a) every record OK, printed: GiB a device, FLOPs a
    device, collective bytes by kind, the forced replications.  (b) on
    the one-device mesh, against phase 18's measurements on the card:
    the argument bytes equal, the train step's FLOPs equal
    FlopCounterMode's over the plain run, its temp + args + outputs
    within DRYRUN_BAND of the plain run's peak with its arguments.  (c)
    the three roofline terms of (b)'s steps on the H100 (the 3xTF32 peak:
    fp32 runs) beside phase 18's kernel-run step times.  It waits for the
    traces until ``deadline`` (a perf_counter time), then fails."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.roofline import analysis

    t0 = time.perf_counter()
    print("phase 19: launch/dryrun.py on Qwen3-1.7B (traced on the host "
          "beside phases 2-18) against phase 18's runs on the card")
    rec = {"a": [], "b": {}}
    for part, proc in enumerate(procs):
        try:
            rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            stop(procs)
            require(False, f"the dry run's part {part} had not finished "
                    f"{time.perf_counter() - t0:.1f} s after phase 18")
        log = _part_path(part).with_suffix(".log").read_text()
        require(rc == 0, f"the dry run's part {part} exited {rc}:\n"
                f"{log[-4000:]}")
        got = json.loads(_part_path(part).read_text())
        rec["a"] += got["a"]
        rec["b"].update(got["b"])
        print(f"  traces, part {part}: wall_s={got['wall_s']:.1f} "
              f"cpu_s={got['cpu_s']:.1f} in a process of its own")
    print(f"  waited {time.perf_counter() - t0:.1f} s for them after "
          f"phase 18")
    print("  (a) Qwen3-1.7B on the production meshes, bf16 (GiB a device: "
          "args / temp / out; FLOPs a device; collective GB by kind)")
    for r in rec["a"]:
        step = r["step"] + (f" {r['fed_framework']}"
                            if r["step"] == "fed_round" else "")
        print(f"    [{r['status']}] {r['shape']} {step} ({r['mesh']}): "
              f"trace_s={r.get('trace_s')} GiB {r.get('arg_gib_per_dev')} / "
              f"{r.get('temp_gib_per_dev')} / {r.get('out_gib_per_dev')}; "
              f"FLOPs {r.get('hlo_flops', 0):.4e}; bytes "
              f"{r.get('hlo_bytes', 0):.4e}; collectives " + ", ".join(
                  f"{k} {v / 1e9:.3f}" for k, v in sorted(
                      r.get("collective_bytes", {}).items()))
              + f"; replicated at {r.get('replicated_at')}")
        require(r["status"] == "OK", f"dry-run record {r['shape']} {step} "
                f"{r['mesh']}: {r['status']}")

    print(f"  (b) phase 18's steps on a one-device mesh, fp32, plain policy "
          f"(memory band {DRYRUN_BAND[0]}-{DRYRUN_BAND[1]})")
    b = rec["b"]
    for name in ("train", "prefill", "decode"):
        got, want = b[name]["arg_bytes_per_dev"], LAUNCH_MEASURED[name]["args"]
        print(f"    {name}: argument bytes {got} traced, {want} on the card")
        require(got == want, f"phase 19 (b) {name}: argument bytes {got} "
                f"traced, {want} on the card")
    train, meas = b["train"], LAUNCH_MEASURED["train"]
    print(f"    train: FLOPs {train['hlo_flops']:.0f} traced, "
          f"{meas['flops']} by FlopCounterMode on the card")
    require(train["hlo_flops"] == meas["flops"], "phase 19 (b): the traced "
            "train step's FLOPs are not FlopCounterMode's on the card")
    pred = (train["temp_bytes_per_dev"] + train["arg_bytes_per_dev"]
            + train["out_bytes_per_dev"])
    ratio = pred / meas["peak"]
    print(f"    train: temp + args + outputs {pred / 1e9:.3f} GB traced "
          f"(temp {train['temp_bytes_per_dev'] / 1e9:.3f}, outputs "
          f"{train['out_bytes_per_dev'] / 1e9:.3f} beside "
          f"{meas['outs'] / 1e9:.3f} on the card), peak with arguments "
          f"{meas['peak'] / 1e9:.3f} GB on the card: ratio {ratio:.4f}")
    require(DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1], f"phase 19 (b): the "
            f"memory prediction is {ratio:.4f} of the card's peak")

    print("  (c) roofline of (b)'s steps on the H100 (3xTF32 peak, HBM "
          "3.35 TB/s) beside phase 18's kernel-run step times")
    cfg = registry.get_config("qwen3-1.7b")
    measured = {"train": LAUNCH_MEASURED["train_kernel_s"],
                "prefill": LAUNCH_MEASURED["prefill"]["kernel_s"],
                "decode": LAUNCH_MEASURED["decode"]["kernel_s"]}
    for name in ("train", "prefill", "decode"):
        r = b[name]
        shape = ShapeConfig(r["shape"], r["seq"], r["batch"],
                            {"train": "train", "prefill": "prefill",
                             "decode": "decode"}[name])
        t = analysis.RooflineTerms(
            "qwen3-1.7b", r["shape"], "1x1", 1, hlo_flops=r["hlo_flops"],
            hlo_bytes=r["hlo_bytes"],
            collective_bytes=float(r["collective_total"]),
            model_flops=analysis.model_flops_for(cfg, shape), dtype="3xtf32")
        print(f"    {name} ({r['shape']}, batch {r['batch']}): compute "
              f"{t.t_compute * 1e3:.3f} ms, memory {t.t_memory * 1e3:.3f} ms "
              f"(unfused bytes), collective {t.t_collective * 1e3:.3f} ms -> "
              f"{t.dominant}; measured {measured[name] * 1e3:.3f} ms, "
              f"{measured[name] / t.t_compute:.3f} x the compute term; "
              f"useful {t.useful_ratio:.3f}")
    print(f"  phase 19 wall_s={time.perf_counter() - t0:.1f}")


# the kernels that must not spill: {kernel: (source, instances)}
NO_SPILLS = {"lora_fused_kernel": ("lora_matmul", 8),
             "lora_dw_kernel": ("lora_matmul", 1),
             "flash_fwd_kernel": ("flash_attention", 4),
             "flash_dq_kernel": ("flash_attention", 4),
             "flash_dkv_kernel": ("flash_attention", 4),
             "rwkv6_bwd_kernel": ("rwkv6_scan", 6),
             "topk_radix_kernel": ("quantize", 2),
             "panel_grad_kernel": ("lora_matmul", 1),
             "kd_fwd_kernel": ("kd_loss", 7),
             "quant_roundtrip_kernel": ("quantize", 4)}


def kernel_spills(log: str, kernel: str) -> dict:
    """{instance of ``kernel``: bytes of spill stores plus loads} from a
    ptxas -v report (each "Function properties for" line is followed by
    its stack and spill line)."""
    return {name: spill for name, (spill, _) in
            kernel_resources(log, kernel).items()}


def kernel_resources(log: str, kernel: str) -> dict:
    """{instance of ``kernel``: (spill bytes, registers)} from a ptxas -v
    report: each "Function properties for" line is followed by its stack
    and spill line, then its "Used N registers" line."""
    import re
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        if "properties for" in line and kernel in line:
            nums = re.findall(r"(\d+) bytes spill", lines[i + 1])
            regs = re.findall(r"Used (\d+) registers", " ".join(
                lines[i + 2:i + 3]))
            out[line.split("properties for")[-1].strip()] = (
                sum(int(n) for n in nums), int(regs[0]) if regs else -1)
    return out


def flash_instances(log: str) -> None:
    """Prints each flash kernel's four head-dim instances (DT 32, 64, 128,
    256) with their registers and spill bytes."""
    import re
    for kernel in ("flash_fwd_kernel", "flash_dq_kernel",
                   "flash_dkv_kernel"):
        by_dt = {}
        for name, (spill, regs) in kernel_resources(log, kernel).items():
            dt = re.search(kernel + r"ILi(\d+)E", name)
            by_dt[int(dt.group(1)) if dt else name] = (regs, spill)
        print(f"  {kernel}: " + ", ".join(
            f"DT {dt} {regs} registers {spill} bytes spilled"
            for dt, (regs, spill) in sorted(by_dt.items())))


REPLACES = {
    "lora_fwd": ("src/repro/kernels/lora_matmul.py:74", "lora_matmul.cu"),
    "lora_dx": ("src/repro/kernels/lora_matmul.py:140", "lora_matmul.cu"),
    "lora_dw": ("src/repro/kernels/lora_matmul.py:186", "lora_matmul.cu"),
    "lora_panel": ("src/repro/kernels/lora_matmul.py:226", "lora_matmul.cu"),
    # row 4 under the vmap of the DP-SGD step's per-example loss
    # (VMAPPED), which gives it an example axis
    "lora_panel_examples": ("src/repro/kernels/lora_matmul.py:226",
                            "lora_matmul.cu"),
    # a LoRA site's two row-4ᵉ products (dA and dB) in one launch
    "lora_panel_examples_pair": ("src/repro/kernels/lora_matmul.py:226",
                                 "lora_matmul.cu"),
    "flash_fwd": ("src/repro/kernels/flash_attention.py:116",
                  "flash_attention.cu"),
    "flash_dq": ("src/repro/kernels/flash_attention.py:223",
                 "flash_attention.cu"),
    "flash_dkv": ("src/repro/kernels/flash_attention.py:248",
                  "flash_attention.cu"),
    "kd_fwd": ("src/repro/kernels/kd_loss.py:92", "kd_loss.cu"),
    "kd_bwd": ("src/repro/kernels/kd_loss.py:128", "kd_loss.cu"),
    "topk_quantize": ("src/repro/kernels/quantize.py:135", "quantize.cu"),
    "dp_clip_norms": ("src/repro/kernels/dp_clip.py:65", "dp_clip.cu"),
    "dp_clip_acc": ("src/repro/kernels/dp_clip.py:73", "dp_clip.cu"),
    "quantize_rows": ("src/repro/kernels/quantize.py:42", "quantize.cu"),
    # row 10 with its dequantization in the same pass, the form the
    # reference's compression.quant_roundtrip runs at the Split boundary
    "quant_roundtrip_rows": ("src/repro/kernels/quantize.py:42",
                             "quantize.cu"),
    "quantize_pack4": ("src/repro/kernels/quantize.py:79", "quantize.cu"),
    "rglru_fwd": ("src/repro/kernels/rglru_scan.py:56", "rglru_scan.cu"),
    # the gradient of row 15 (the reference differentiates the scan
    # through XLA)
    "rglru_bwd": ("src/repro/kernels/rglru_scan.py:56", "rglru_scan.cu"),
    "rwkv6_fwd": ("src/repro/kernels/rwkv6_scan.py:58", "rwkv6_scan.cu"),
    # the gradient of row 16 (the reference differentiates its WKV
    # through XLA)
    "rwkv6_bwd": ("src/repro/kernels/rwkv6_scan.py:58", "rwkv6_scan.cu"),
    # rows 1, 2 and 4 under the vmap over clients of the spmd backend's
    # stacked local update (VMAPPED), which gives them a client axis
    "lora_fwd_clients": ("src/repro/kernels/lora_matmul.py:74",
                         "lora_matmul.cu"),
    "lora_dx_clients": ("src/repro/kernels/lora_matmul.py:140",
                        "lora_matmul.cu"),
    "lora_panel_clients": ("src/repro/kernels/lora_matmul.py:226",
                           "lora_matmul.cu"),
    # row 14 under the vmap over clients of the spmd backend's stacked
    # DP-SGD step (VMAPPED), which gives it a client axis
    "dp_clip_acc_clients": ("src/repro/kernels/dp_clip.py:73", "dp_clip.cu"),
}


# the kernels that port a TPU kernel in the form a reference ``vmap`` gives
# it: {kernel: the vmap's file:line}
VMAPPED = {"lora_panel_examples": "src/repro/core/fedavg.py:83",
           "lora_panel_examples_pair": "src/repro/core/fedavg.py:83",
           "lora_fwd_clients": "src/repro/core/fed_spmd.py:319",
           "lora_dx_clients": "src/repro/core/fed_spmd.py:319",
           "lora_panel_clients": "src/repro/core/fed_spmd.py:319",
           "dp_clip_acc_clients": "src/repro/core/fed_spmd.py:319"}


def rule2_queue(kernels, floor) -> None:
    """Prints each kernel's device time lost in this run beyond what the
    card could do, largest first: launches x (time - max(bound, floor)),
    the time and floor in a CUDA graph where the kernel was timed in one
    (else eager, against the eager floor)."""
    lost = []
    for k in kernels:
        graph = "graph_ms" in k
        ms = k["graph_ms"] if graph else k["ms"]
        least = max(k["bound_ms"], floor["graph_ms" if graph else "eager_ms"])
        lost.append((k["launches"] * max(ms - least, 0.0), k["name"], ms,
                     least, k["launches"], graph))
    print("rule-2 queue (launches x (time - max(bound, floor)), ms lost in "
          "this run; [graph] times in a CUDA graph):")
    for total, name, ms, least, n, graph in sorted(lost, reverse=True):
        print(f"  {name}: {n} x ({ms:.4f} - {least:.4f}) = {total:.4f}"
              + (" [graph]" if graph else ""))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    card = torch.cuda.get_device_name(0)
    require(torch.cuda.get_device_capability(0) == (9, 0),
            f"compute capability {torch.cuda.get_device_capability(0)}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} card {card}")

    print("phase 1: build")
    t_start = t0 = time.perf_counter()
    # torch.utils.checkpoint (phase 18's remat) imports torch._dynamo at
    # its first call, some 15-25 s of imports where the installed
    # packages' bytecode is not compiled yet: import it while nvcc builds
    warm = threading.Thread(target=importlib.import_module,
                            args=("torch._dynamo",))
    warm.start()
    report = build.build_all()
    warm.join()
    for name, info in report.items():
        print(f"  nvcc {name}.cu: {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if any(word in line for word in ("properties for", "registers",
                                             "spill", "error")):
                print("    " + line.strip())
    for kernel, (source, instances) in NO_SPILLS.items():
        if source not in report:
            continue
        spills = kernel_spills(report[source]["log"], kernel)
        require(len(spills) == instances, f"{len(spills)} {kernel} "
                f"instances in the ptxas report, expected {instances}")
        require(not any(spills.values()), f"{kernel} spills: "
                f"{ {k: v for k, v in spills.items() if v} }")
        print(f"  {kernel}: {len(spills)} instances, no spills")
    flash_instances(report["flash_attention"]["log"])
    print(f"  build wall_s={time.perf_counter() - t0:.1f}")
    # phase 19's traces, on the host beside phases 2-18
    dry = start_dry_run()
    try:
        return phases(device, card, smi, t_start, dry)
    finally:
        stop(dry)


def phases(device, card, smi, t_start, dry) -> int:
    """Phases 2-19 and the closing lines (main runs phase 1 and starts
    phase 19's traces)."""
    import torch

    t0 = time.perf_counter()
    print("phase 2: kernels against their plain versions")
    rows, floor = check_kernels(device, card)
    print(f"  phase 2 wall_s={time.perf_counter() - t0:.1f}")

    # the full-width phases' host draws, in a thread from here on
    prefetch_draws(prefetched_configs())
    by_path = run_slices(device)
    (by_path["recurrentgemma"], by_path["recurrentgemma_dp_step"],
     by_path["split_rg"]) = run_recurrent(device)
    t0 = time.perf_counter()
    (by_path["rwkv6"], by_path["rwkv6_kd"], by_path["rwkv6_dp_step"],
     by_path["split_rwkv"]) = run_rwkv(device)
    print(f"  phase 8 wall_s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    by_path["base_grad"] = run_base_grad(device)
    print(f"  phase 9 wall_s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    by_path.update(run_spmd(device))
    print(f"  phase 10 wall_s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    by_path["hetero_async"] = run_hetero(device)
    print(f"  phase 11 wall_s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    by_path["hetero_async_spmd"] = run_spmd_hetero(device)
    print(f"  phase 10 after phase 11 wall_s={time.perf_counter() - t0:.1f}")
    print(f"  phases 1-11 wall_s={time.perf_counter() - t_start:.1f}")
    by_path.update(run_cohort(device))
    print(f"  phases 1-12 wall_s={time.perf_counter() - t_start:.1f}")
    by_path.update(run_faults(device))
    print(f"  phases 1-13 wall_s={time.perf_counter() - t_start:.1f}")
    t0 = time.perf_counter()
    by_path.update(run_families(device))
    print(f"  phase 14 wall_s={time.perf_counter() - t0:.1f}")
    print(f"  phases 1-14 wall_s={time.perf_counter() - t_start:.1f}")
    t0 = time.perf_counter()
    by_path.update(run_vlm_encdec(device))
    print(f"  phase 15 wall_s={time.perf_counter() - t0:.1f}")
    print(f"  phases 1-15 wall_s={time.perf_counter() - t_start:.1f}")
    serving, dec_rows, _ = run_serving(device, peaks(card))
    by_path.update(serving)
    rows.update(dec_rows)
    print(f"  phases 1-16 wall_s={time.perf_counter() - t_start:.1f}")
    generative, gen_rows = run_generative(device, peaks(card))
    by_path.update(generative)
    rows.update(gen_rows)
    print(f"  phases 1-17 wall_s={time.perf_counter() - t_start:.1f}")
    by_path.update(run_launch(device, peaks(card)))
    print(f"  phases 1-18 wall_s={time.perf_counter() - t_start:.1f}")
    run_dry_run(dry, t_start + DRYRUN_DEADLINE_S)
    print(f"  phases 1-19 wall_s={time.perf_counter() - t_start:.1f}")
    print("margins (share of the limit; the last recorded run's in "
          "parentheses): " + ", ".join(
              f"{path} {MARGINS[path]:.3f} ("
              + ("new" if before is None else f"{before:.3f}") + ")"
              for path, before in MARGINS_BEFORE.items()))

    # ``launches`` sums the kernel runs of the paths; ``launches_by_path``
    # keeps them apart.  Rows are at the main path's shapes (GPT-2's;
    # the RG-LRU scan's at RecurrentGemma-2B's train step), the LoRA and
    # flash rows with their RecurrentGemma-2B shapes under
    # ``at_recurrentgemma`` (RWKV-6's under ``at_rwkv6``, the panel's at
    # a DP batch-1 pass under ``at_dp_batch1``, the client-axis rows'
    # at 8 clients under ``at_8_clients``, rows 4ᵉ's pair and 13 at the
    # spmd DP step's 48 stacked examples under ``at_48_examples``; phase
    # 14's under ``at_qwen3``, ``at_mixtral`` and their ``_wk_wv``, phase
    # 15's under ``at_whisper_encoder`` (rows 1, 2, 4, 4ᵉ's pair, 5-7 and
    # the roundtrip at the encoder's shapes), ``at_whisper_cross``,
    # ``at_llava`` and ``at_llava_wk_wv``; phase 16's under
    # ``at_*_decode``; phase 17's rows 1, 2, 4-7 at train.py's shapes
    # under ``at_gpt2_train``; phase 18's at train_4k's and prefill_32k's
    # under ``at_train_4k``, ``at_prefill_32k`` and their ``_wk_wv``); the
    # KD kernels at a generative vocabulary
    # on phase 2's random inputs under ``at_generative`` and on phase
    # 17's KD step's tensors under ``at_generative_kd_step``.  The per-example
    # panel's rows add its fp64 error over torch.bmm's, and its and the
    # client-axis rows the old way's times (B or C launches of the
    # one-example or one-client kernel, eager and in a graph).
    extra = ("fp64_rms_ratio", "old_way_ms", "old_way_graph_ms")
    kernels = []
    for name, (replaces, src) in REPLACES.items():
        row = rows[name]
        per_path = {path: n[name] for path, n in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces,
            **({"under_vmap_of": VMAPPED[name]} if name in VMAPPED else {}),
            "launches": sum(per_path.values()),
            "launches_by_path": per_path,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **{key: row[key] for key in ("graph_ms", "library_graph_ms",
                                         "cold_ms", "bound_fp32_ms") + extra
               if key in row}})
        for tag, key in (("rg", "at_recurrentgemma"),
                         ("rg256", "at_recurrentgemma_wk_wv"),
                         ("rwkv", "at_rwkv6"), ("dp", "at_dp_batch1"),
                         ("c8", "at_8_clients"),
                         ("c48", "at_48_examples"), ("q3", "at_qwen3"),
                         ("q3kv", "at_qwen3_wk_wv"), ("mx", "at_mixtral"),
                         ("mxkv", "at_mixtral_wk_wv"),
                         ("wh", "at_whisper_encoder"),
                         ("whx", "at_whisper_cross"), ("lv", "at_llava"),
                         ("lvkv", "at_llava_wk_wv"),
                         ("dec", "at_gpt2_decode"),
                         ("dec-q3", "at_qwen3_decode"),
                         ("dec-q3kv", "at_qwen3_decode_wk_wv"),
                         ("whd", "at_whisper_decode"),
                         ("tr", "at_gpt2_train"),
                         ("generative", "at_generative"),
                         ("genkd", "at_generative_kd_step"),
                         ("4k", "at_train_4k"),
                         ("4kkv", "at_train_4k_wk_wv"),
                         ("32k", "at_prefill_32k"),
                         ("32kkv", "at_prefill_32k_wk_wv")):
            if f"{name}@{tag}" in rows:
                at = rows[f"{name}@{tag}"]
                kernels[-1][key] = {
                    field: at[field] for field in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "bound_fp32_ms",
                        "graph_ms", "library_graph_ms") + extra
                    if field in at}
    rule2_queue(kernels, floor)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
