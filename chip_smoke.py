#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each a check that exits non-zero when it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, from ``src/repro_torch/kernels/
   csrc``, one ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serve path gives it, bit for bit (the gathers are
   copies), with its time, the plain version's, one PyTorch library call's
   and the bound (HBM bytes over 3.35 TB/s): the page gather at the olmo-1b
   serve shape (and, untimed, phase 7's per-rank pool of 4 KV heads); the
   MoE row gather at mixtral-8x22b's d = 6,144 bf16 on
   routing tables built by the port's ``dispatch_tables`` — a decode
   dispatch (4 tokens into 4 x 8 x 1 slots), a 64-token prefill group
   (into 8 x 32 slots), 8 groups of 1,024 tokens at capacity factor 1.25
   (8,192 rows into 20,480 slots, timed) and its combine — plus an f32
   case at d = 256, a table with every row empty and, untimed, phase 7's
   expert-parallel dispatch (one rank's 2 of 8 experts: a contiguous
   slot range of the 8 x 1,024 table, its inverse rebased). Each dispatch
   runs
   both routes, checked bitwise: the gather (no ``inv``) and the read-once
   route with ``inv`` = the tables' ``comb`` (forced at every size); the
   timed dispatches print both routes' times, the gather's first, and keep
   the times of the route ``moe_ffn``'s call takes (read-once where it
   spares >= ``_READ_ONCE_MIN_BYTES`` of reads: the 8 x 1,024 dispatch),
   which the ``kernels`` line reports. Wherever a
   kernel is timed beside a library call (here and in phases 4 and 7), the
   two are timed as ten alternating pairs and each is reported as its
   median;
4. flash attention: the kernel's (o, lse) against the plain version at (a)
   the olmo-1b training shape (8,1024,16,128) bf16 causal, (b) an olmo-1b
   prefill (4,64,16,128) bf16 with pad rows, (c) gemma-2b (2,1024,8,256)
   with one KV head, (d) f32 hd 64, ragged 100, window 32, GQA 4/2, with
   pad rows, (e) non-causal with Sq != Skv, (f) phi-3-vision's prefill
   (2,1024,32,96) bf16 causal, (g) zamba2-7b's attention (2,1024,32,112)
   bf16 causal, (h) an olmo-1b prefill of 4,096 tokens (2,4096,16,128)
   bf16 causal, where the tile loop dominates the blocks' start-up, (i)
   mixtral-8x22b's windowed prefill (2,6000,48 / 8 KV,128) bf16 causal
   with a window of 4,096 (phase 6g's shape), (j) phi-3-vision-4.2b's
   prefill of 576 patches + 448 text tokens (4,1024,32,96) bf16 causal
   (phase 6j's shape), (k) musicgen-large's prefill of 1,000 frames
   (4,1000,32,64) bf16 causal (phase 6k's; Sq not a multiple of the
   tile), (l) musicgen-large's prefill of 64 frames (4,64,32,64) bf16
   causal (phase 6k's second group, on the kernel's variant for Sq <= 64),
   (m) olmo-1b's per-rank prefill at tp 4 (4,64,4,128) bf16 causal with
   pad rows, (n) mixtral-8x22b's per-rank prefill at tp 4 (8,1024,12 / 2
   KV,128) bf16 causal (GQA 6:1), (o) mixtral-8x22b's per-rank serve
   prefill at tp 4 (4,64,12 / 2 KV,128) bf16 causal with pad rows (GQA
   6:1 on the variant for Sq <= 64; phase 7's shapes), (p) gemma-2b's
   short prefill (4,64,8 / 1 KV,256) bf16 causal with pad rows (head_dim
   256 with one KV head on the variant for Sq <= 64; phase 18a's shape).
   f32 within 2e-5; bf16 within 1.25 x the plain bf16 version's error
   (+1e-3), both measured against the plain version run in f32 on the
   upcast inputs. A second launch gives equal bits; one launch counted a
   call. At (a), (b), (f)-(o): kernel, plain,
   ``scaled_dot_product_attention`` and bound times (at (i) SDPA takes
   the window as an explicit boolean mask and K/V repeated to the 48
   query heads; the plain version runs one batch row at a time where its
   f32 logits would pass 8 GB);
5. serve: full-width olmo-1b (16 layers, bf16 params from a seed) through
   ``ServeEngine`` with the paged cache — 8 requests on 4 slots, so slots
   are recycled — with the launch counts zeroed just before and read just
   after: every decode step must launch the gather 2 x 16 times and every
   prefill call (admissions included) the flash kernel 16 times. Then the
   same requests on the contiguous cache must give the same tokens;
6. reference: olmo-1b-smoke in float32 (TF32 off), paged prefill + decode
   on the card against the same code on the CPU, logits within 1e-4, the
   prefill through the flash kernel;
6b. MoE serve: mixtral-8x22b at full width (d 6,144, 48 heads / 8 KV of
   128, d_ff 16,384, 8 experts top-2, vocab 32,768) with its depth cut to
   4 layers (10.4 B params, bf16 from a seed) through the same engine and
   requests as phase 5, paged and contiguous: every forward call (prefill
   or decode step) must launch the row gather 2 x 4 times (dispatch and
   combine), the page gather and flash kernel as in phase 5, and the two
   layouts must give the same tokens; then 8 prompts of 1,024 tokens in
   one prefill call (contiguous, 8 slots, 4 new tokens each; after a
   warm-up), with the counts zeroed just before and read just after: 2 x 4 row-gather
   launches a forward call, the prefill's dispatch (8,192 token rows) on
   the read-once route (4 launches) and nothing else on it, and the same
   tokens as a second run with the read-once route switched off; then a
   profile of a short run; then phase 6g on the same params;
6c. MoE reference: mixtral-8x22b-smoke in float32, paged prefill + greedy
   decode on the card and on the CPU, at its own capacity and at a
   dropping one (capacity_factor_eval 0.5): identical routing tables
   (experts and kept slots of every assignment), logits within 1e-4,
   identical greedy tokens, the row gather launched 2 x L a call;
6d. SSD kernel: the Mamba2 intra-chunk kernel against its plain version
   (TF32 off, both in f32 on the same inputs), max |diff| <= 2e-5 x
   max(1, max |plain|) for y and for the states, at the mamba2-780m serve
   prefill (b 4, s 1,024, h 48, p 64, g 1, n 128, chunk 256; x/B/C bf16,
   dt/cum f32; the tensor-core path), at the second serve call's shape
   (b 4, s 256: one chunk) and in f32 with g 2, 3 heads a group and s = 2
   chunks (the FFMA path), and at zamba2-7b's serve prefill ("hybrid": b
   4, s 1,024, h 112, p 64, g 1, n 64, chunk 256; 112 heads on one
   group), and at a model rank's share of 16e's full-width mamba2-780m
   prefill ("rank tp4": b 4, s 512, h 12 of 48, the block split over
   model 4); a second launch gives equal bits; kernel, plain and bound
   times at the four serve shapes (no single PyTorch call computes it:
   library "none");
6e. SSM serve: mamba2-780m at full width (d 1,536, 48 heads of 64,
   d_state 128, chunk 256, vocab 50,280, tied; bf16 params from a seed),
   its depth cut to ``SSM_SERVE_LAYERS`` = 24 of 48 layers, through
   ``ServeEngine``'s grouped equal-length path
   on 4 slots: 4 prompts of 1,000 tokens (padded to 1,024 inside the scan:
   4 chunks) and 4 of 64, 32 new tokens each, max_len 1,056 — 2 groups, 2
   prefill calls, 62 decode steps; the launch count zeroed just before and
   read just after: L SSD launches a prefill call; then a profile, and
   a line with the prefill seconds and the SSD kernel's share of the
   profiled run's device time;
6f. SSM reference: mamba2-780m-smoke in float32 (TF32 off), prefill of 50
   tokens (padded, 2 chunks) + 4 greedy decode steps on the card and on
   the CPU: logits within 1e-4, identical greedy tokens, the kernel run
   once a layer a prefill; and the grouped engine's tokens on mixed
   prompt lengths identical on card and CPU;
6g. windowed MoE serve: phase 6b's mixtral-8x22b params (4 layers) past
   the 4,096-token window, through ``ServeEngine`` at max_len 6,144: a
   ring cache of 4,096 slots, batch 2, the grouped path. 2 prompts of
   6,000 tokens (the prefill keeps the last 4,096 and rolls them by
   6,000 % 4,096 = 1,904) and 2 of 4,080 (decode fills the ring after 16
   steps, then wraps it), 32 new tokens each, after a warm-up; the counts
   zeroed just before and read just after: 4 flash launches a prefill
   call, 2 x 4 row-gather launches a forward call, the prefill
   dispatches (12,000 and 8,160 token rows) on the read-once route as
   ``moe_gather``'s rule picks it, no page gather;
   ``cache_bytes_resident`` equal to the ring's shapes (268,435,464 B at
   an f32 cache, beside 402,653,192 B for a contiguous 6,144); the
   4,080-token group's first 16 tokens equal to a contiguous run at
   max_len 4,096 (the same cache shape, no ring) with 16 new tokens; ms a
   decode step, tok/s, prefill s and a profile's idle share; then one
   layer's wrapped ring cache split into 4 shards, ``partial_attention``
   on each and ``combine_partials`` over them within 2e-5 of
   ``decode_attention`` (f32);
6h. hybrid serve: zamba2-7b at full width (d 3,584, 112 SSM heads of 64,
   d_state 64, shared-attention sites of 32 heads at head_dim 112, bf16
   params from a seed), its depth cut to ``HYB_SERVE_LAYERS`` = 15 of 81
   layers (2 sites), through the
   grouped engine on 4 slots, max_len 1,056: 4 prompts of 1,000 tokens
   and 4 of 64, 32 new tokens each (2 prefill calls, 62 decode steps);
   the counts zeroed just before and read just after: L SSD and L // 6
   flash launches a prefill call, no row or page gather;
   ``cache_bytes_resident`` equal to the shapes' count (KV, SSD state,
   conv tails); ms a decode step, tok/s, prefill s, a profile's idle
   share and the SSD and flash shares of its device time;
6i. ring, hybrid, VLM, audio and the archs of phase 18: mixtral-8x22b-
   smoke (window 64) with a prompt of 80, zamba2-7b-smoke at 5 layers
   (two groups and a remainder), phi-3-vision-4.2b-smoke (16 patches + 24
   text tokens), musicgen-large-smoke (40 frames of 4 codebooks),
   gemma-2b-smoke (one KV head), command-r-35b-smoke (the parallel
   LayerNorm block) and arctic-480b-smoke (128 -> 4 experts beside a
   dense residual FFN), f32 with TF32 off,
   from the same params: prefill + 8 greedy decode steps on the card and
   on the CPU, logits within 1e-4, identical tokens, the flash kernel
   launched once an attention layer (and the SSD kernel once a hybrid
   layer) in the card's prefill; the grouped engine's tokens and
   ``cache_bytes_resident`` identical on card and CPU on mixed prompt
   lengths (every arch but the VLM, which the engine refuses);
6j. VLM serve: phi-3-vision-4.2b at full width and depth (32 layers, d
   3,072, 32 heads of 96, d_ff 8,192, vocab 32,064, 576 patches of 1,024;
   3.82 B bf16 params + ``img_proj`` from a seed) through the reference's
   VLM serving path, ``make_prefill`` on a batch holding ``image_embeds``
   then ``make_serve_step`` (the engine refuses a VLM, as the reference's
   cannot serve one): 4 rows of 576 patch embeddings (standard normal,
   numpy seed) + 448 text tokens into an f32 contiguous cache of 1,056,
   then 32 greedy decode steps, after a warm-up; the counts zeroed just
   before and read just after: 32 flash launches in the prefill call,
   none in a decode step, no page, row or SSD launch; the cache's length
   1,024 after the prefill and its bytes the shapes' count; prefill s, ms
   a decode step, tok/s and a profile's idle and flash shares;
6k. audio serve: musicgen-large at full width (d 2,048, 32 heads of 64,
   d_ff 8,192, layernorm with biases, gelu, 4 codebooks of 2,048; bf16
   params from a seed), its depth cut to ``AUDIO_SERVE_LAYERS`` = 12 of
   48 layers, through the grouped
   engine on 4 slots, max_len 1,056: 4 prompts of (4, 1,000) codebook
   frames and 4 of (4, 64), 32 new frames each (2 prefill calls, 62 decode
   steps), after a warm-up; the counts zeroed just before and read just
   after: L flash launches a prefill call, no page, row or SSD launch;
   (4, 32) tokens a request; ``cache_bytes_resident`` the shapes' count;
   ms a decode step, tok/s, prefill s, a profile's idle and flash shares;
7. tensor-parallel serve: ``TP_WORLD`` = 4 ranks spawned once on the one
   card (mesh data 1 x model 4), joined by gloo (NCCL refuses two ranks on
   one device), with CUDA tensors in every collective
   (``launch/serve.py::join_ranks``; a refusal raises); they build nothing (phase 2 built
   the kernels). Each rank makes ``init_params``' leaves one at a time and
   cuts each to its shard (the ranks take turns). olmo-1b at full width
   and depth (phase 5's requests, f32 cache) paged and contiguous at
   ``num_vcis`` 8, then paged through the GSPMD route (16d, below);
   mixtral-8x22b at full width, 4 layers,
   expert-parallel (2 experts a rank), paged at ``num_vcis`` 8, then phase
   6b's 8 x 1,024-token prefill call. Held against tp 1 (phases 5 and 6b):
   the first prefill's last-position logits within ``TP_LOGIT_TOL`` x max
   |tp 1| (the share of equal greedy tokens printed); each rank's paged
   pool exactly 1/4 of tp 1's; no page leaked; every forward call 2 x L +
   2 collectives by purpose (``tp_attn`` and ``tp_mlp`` or ``moe`` a
   layer, two on ``sample``); at ``num_vcis`` 1 every context on VCI 0
   with 4 fallback hits, at 8 four distinct VCIs; the flash, page-gather
   and row-gather launches per call as in phases 5 and 6b, on each rank
   (the long prefill's dispatch on the read-once route). Then the smoke
   archs olmo-1b-smoke and mixtral-8x22b-smoke in f32 on the same ranks
   regrouped data 2 x model 2, contiguous (the tokens gathered over data,
   counted apart) and paged (admission under the mesh; olmo-1b-smoke's
   also at ``num_vcis`` 1), then both layouts through the GSPMD route:
   tokens equal to the port's CPU engine's. Printed per case (rank 0): ms a decode step,
   prefill s, tok/s, the rank's ``cache_bytes_resident``, the collectives'
   share of the host clock, the launches. Four ranks time-share one card
   and their collectives cross host memory: the times are not a TP
   speed-up and not a wire measurement;
8. bucket kernels: the tile-gather pack/unpack kernel against its plain
   version, bit for bit, on the tables of the full-width olmo-1b plan
   (``get_comm_plan(params, num_streams=8, pack="pallas")``): every
   bucket's pack and the step's unpack in f32, the largest bucket's pack
   in bf16; device times of the largest pack and of the unpack beside the
   plain version, one ``index_select`` and the HBM bound;
9. train: full-width olmo-1b (16 layers, bf16 params from a seed,
   ``remat="block"``) through ``make_train_step(comm="vci",
   pack="pallas", num_streams=8, num_vcis=8, progress="hybrid")`` on a
   one-rank NCCL group, batch 8 x seq 1024: a warm-up step, then 5 timed
   steps with the launch counts zeroed just before and read just after
   (pack once a bucket a step, unpack once a step, the flash kernel twice a
   layer a step: the forward and remat's recompute), finite loss and grad
   norm; ``reduce_gradients`` with ``pack="pallas"`` equal bit for bit to
   ``pack="xla"`` on one real gradient tree; a profile of 2 steps; then
   one step at ``remat="dots"`` (the matmul outputs and the flash op's
   (o, lse) kept for the backward): the flash kernel once a layer, its
   peak memory printed beside ``remat="block"``'s; the bytes one forward
   keeps for its backward (saved-tensor hooks plus the selective
   checkpoint's store) under "block", "dots" and "none", "dots" strictly
   between the two;
10. reference training: olmo-1b-smoke in float32 (TF32 off), 3 steps of the
   same train step on the card (attention through the flash kernel) and on
   the CPU from the same params and batches: loss and grad norm within rtol 1e-5, params within rtol 2e-5 /
   atol 1e-4 with at most 1 element in 10^4 outside atol 1e-6 (AdamW turns
   summation-order noise in a near-zero gradient into an update of up to
   ``lr``; ``tests/test_torch_train.py`` states the same tolerance);
11. ZeRO-1 and overlap training: phase 9's olmo-1b step (same seed,
   batches and knobs, one-rank NCCL group) as ZeRO-1 post, replicated
   overlap and ZeRO-1 overlap, a warm-up and 5 timed steps each, the
   counts zeroed just before the timed steps and read just after: the
   ZeRO-1 post step launches the pack kernel once a bucket and the unpack
   none, the overlap steps neither (their hooks pack by per-slot copies),
   the flash kernel twice a layer; step 1's loss and grad norm within
   1e-5 of phase 9's; replicated overlap's every step within 1e-5 of
   phase 9's and its bf16 params within one ulp (the count of differing
   elements printed: one rank's reduce is exact); ZeRO-1 overlap's f32
   master after step 1 within rtol 2e-5 / atol 1e-6 of ZeRO-1 post's and
   its later steps' loss and grad norm within 2^-10 (the two plans sum
   the grad norm in other orders, the bf16 params rounded from the f32
   master then differ by an ulp here and there, and the bf16 forward
   carries that on); the hooks issue every bucket inside the backward in
   ready order. Printed: step ms, tok/s, peak memory, the
   optimizer state's bytes, the launches, and how many buckets were
   issued before the last leaf gradient arrived;
12. ZeRO-1 on four ranks: ``ZERO1_WORLD`` = 4 ranks spawned once on the
   one card, joined by gloo with CUDA tensors (as phase 7; a collective
   gloo refused would raise; the port refuses gloo's point-to-point sends
   of CUDA tensors, which this path does not make); olmo-1b at full width
   cut to 2 layers, the global batch 8 x 1,024 (2 rows a rank), ZeRO-1
   post then ZeRO-1 overlap, 2 steps each: every rank's metrics equal,
   its optimizer state exactly a quarter of one rank's (12 B a padded
   element + the count), the pack kernel once a bucket a post step and
   none in overlap, flash twice a layer; overlap's step 1 within 1e-5 of
   post's and its params after it within one bf16 ulp, its step 2's
   loss and grad norm within 2^-10 (phase 11's reason); the hooks issue
   every bucket inside the backward in ready order. Four ranks time-share one
   card and their collectives cross host memory: no time here is a
   speed-up;
13a. the MoE row moves' backwards (each phase 13 first frees what earlier
   phases hold and fails if more than 4 GB stays allocated): the
   gather-sum kernel and, at K = 1, the gather kernel against their plain
   versions, bit for bit, at mixtral-8x22b's d = 6,144 bf16 on
   ``dispatch_tables`` of 8 groups x 1,024 tokens at the training
   capacity factor 1.25 (C = 320, 20,480 slots): the dispatch backward
   (20,480, 6,144) -> (8,192, 6,144) over ``comb`` (K = 2) and the
   combine backward (16,384, 6,144) -> (20,480, 6,144) over ``asg``
   (K = 1); an f32 case at d = 256, a skewed routing that drops
   assignments and a table with every entry empty; ``row_gather``'s
   autograd at the full-width tables against autograd of the plain
   gather; both backwards timed beside the bound and one library call
   (``index_add_`` into zeros; ``index_select``), medians of ten
   alternating pairs;
13b. MoE training: ``mixtral-8x22b`` at full width (d 6,144, 8 experts
   top-2, window 4,096), depth cut to 1 of 56 layers (2.907 B params:
   bf16 params, f32 moments, bf16 grads and the f32 bucket arena are
   ≈46.5 GB before activations; two layers would not fit), phase 9's
   step and batch, a warm-up and 5 timed steps: per step and layer 5
   ``row_gather`` launches (dispatch and combine, their recompute, the
   combine's backward; the two dispatches on the read-once route), 1
   ``row_gather_sum`` (the dispatch's backward), 2 flash, and the pack
   once a bucket; finite loss, grad norm, load balance and router z; a
   profile of 2 steps; then mixtral-8x22b-smoke card vs CPU as phase 10
   (load balance and router z too);
13c. VLM and audio training: ``phi-3-vision-4.2b`` at full width, 24 of
   32 layers, batch 4 x (576 patches + 448 tokens), and
   ``musicgen-large`` at full width and depth, batch 4 x 1,000 frames x
   4 codebooks, each a warm-up and 3 timed steps (flash twice a layer a
   step, finite metrics), then its smoke arch card vs CPU as phase 10;
14a. the SSD backward kernel (``ssd_chunk_bwd``, each phase 14 first frees
   what earlier phases hold, as phase 13 does) against its plain version
   run in f32 on the same inputs, each case on its route (printed; bf16 on
   the tensor cores, ``csrc/ssd_chunk_bwd_tc.cu``, f32 on FFMA,
   ``csrc/ssd_chunk_bwd.cu``): at the mamba2-780m training shape (b 8,
   s 1,024, h 48, p 64, g 1, n 128, chunk 256, x/B/C bf16, dy and dst f32),
   the zamba2-7b one (b 4, h 112, n 64), a model rank's share of 16e's
   mamba2-780m training run ("rank tp2": b 4, h 24 of 48, the block split
   over model 2), an f32 case, a g = 2 case and the
   overflow case in f32 and in bf16 (one chunk of 256, dt 0.1, A =
   -linspace(1, 16, 4): above the diagonal exp would overflow): f32
   outputs within 2e-5 x max(1, max|plain|), bf16 outputs within one bf16
   ulp of the plain f32 result plus that term; a second launch gives equal
   bits and each launch is counted on its route; at the three training
   shapes the tensor-core and FFMA routes' times as ten alternating pairs,
   and plain against the tensor cores as four (medians), beside the bound
   (bytes: inputs once, outputs once; the same count of work whichever
   route does it; library "none": no single PyTorch call computes it);
14b. SSM training: ``mamba2-780m`` at full width, ``SSM_TRAIN_LAYERS`` =
   24 of 48 layers (d 1,536, bf16 params from a seed, ``remat="block"``),
   phase 9's step and batch (8 x 1,024), a warm-up and 5 timed steps: per
   step 2 x L ``ssd_chunk`` launches (each layer's forward and remat's
   recompute), L ``ssd_chunk_bwd``, all on the tensor cores, the pack
   once a bucket, the unpack once, no flash; finite loss and grad norm; a
   profile of 2 steps (the backward's share of device time, both routes'
   kernels counted); then
   mamba2-780m-smoke card vs CPU as phase 10 (the SSD forward and backward
   kernels on the card);
14c. hybrid training: ``zamba2-7b`` at full width (d 3,584, 112 SSM heads
   of 64, d_state 64, the shared attention block of 32 heads at head_dim
   112, d_ff 14,336), depth cut to ``HYB_TRAIN_LAYERS`` = 15 of 81 layers
   (2 groups of 6 and the 3-layer remainder, as 81 = 13 x 6 + 3; the full
   6.750 B would need ~150 GB at the ~22 B a param phase 13 measured),
   batch 4 x 1,024, a warm-up and 3 timed steps: per step 2 x L
   ``ssd_chunk``, L ``ssd_chunk_bwd`` (all on the tensor cores) and 2 x
   L // 6 flash launches (the sites, forward and
   recompute), the pack once a bucket; finite metrics; a profile of 2
   steps; then zamba2-7b-smoke card vs CPU as phase 10. Phase 10's
   parameter rule gets one more kind of exempt element for these two smoke
   archs: one whose gradient, at the first step that reaches it, is within
   the noise of zero (under 1e-5 of its leaf's largest on the CPU);
   AdamW's first update is then about ``lr`` times the sign of that noise,
   so it is held to ``3 x lr`` (``tests/test_torch_train.py`` states the
   same rule);
15a. ``comm="gspmd"`` on one rank: full-width ``olmo-1b`` (phase 9's
   config, batch and ``remat="block"``), a warm-up and 5 timed steps; the
   first step's loss and grad norm within 1e-5 of a ``comm="vci"`` post
   step from the same state and batch (on one rank the same math), 2 x 16
   flash launches a step, no collective; ms a step beside phase 9's, peak;
15b. FSDP on ``GSPMD_WORLD`` = 4 gloo ranks sharing the card (phase 12's
   pattern): ``olmo-1b`` at full width and ``GSPMD_LAYERS`` = 2 layers, in f32 (so that
   ``tests/test_torch_train.py``'s f32 rules apply), global batch 8 x
   1,024, 2 steps: every rank's metrics equal, within 1e-5 of a one-rank
   run here on the same batches; every param element within 1e-4 + 2e-5
   relative of the one-rank run's, and the count beyond 1e-6 + 2e-5
   relative no more than the tests' one in 10^4 or twice what another
   order of the same sums gives (the one-rank run with the ranks' rows as
   4 microbatches); each rank holds a quarter of the params and moments
   (every olmo-1b leaf is sliced), to the byte; a step's all-gathers (7 a
   layer, forward and recompute, and the tied table twice),
   reduce-scatters and all-reduces as predicted, with their bytes;
15c. checkpoints: the bf16 2-layer FSDP state on the same ranks, saved
   after step 2 as whole leaves (rank 0 writes), restored on the 4 ranks
   and on one rank here, each equal to the saved state bit for bit (sha256
   of every rank's slices); step 3 after the resume against the
   uninterrupted step 3 on the 4 ranks (bit for bit expected; the
   difference is printed), and on one rank; the directory removed; then
   the CLI at smoke size on the card: ``--steps 4 --ckpt-every 2`` and
   ``--steps 6`` in the same directory, which must print ``resumed from
   step 4``;
16a. a ``data x model`` mesh, on phase 15's ranks as data 2 x model 2
   (FSDP over each data line, Megatron tensor parallelism over each model
   line, each line's collectives on its one group): 15b's f32 config and
   batches with ``comm="gspmd"``: every rank's loss and grad norm equal,
   within 1e-5 of 15b's one-rank run; the param elements by 15b's rules
   against the same run and yardstick; each rank holds 15b's bytes
   (every olmo-1b leaf divides both axes); the data line's and the model
   line's collectives a step printed apart; then one step on the pod mesh
   2 x 1 x 2 (pod x data x model: its data line is the two pods, its
   lines those of 2 x 2) from the same init: its loss and every param
   leaf's bytes equal 16a's first step on every rank;
16b. the same config and mesh with ``comm="vci"`` post (8 buckets,
   ``pack="pallas"``): the params whole on every rank, the buckets
   reduced on VCI groups along the data lines, 8 pack and 1 unpack
   launches a step; the first loss within 1e-5 of 16a's;
16c. ``mixtral-8x22b`` at full width, ``AXIS_MOE_LAYERS`` = 1 layer,
   bf16, ``comm="gspmd"``, global batch ``AXIS_MOE_BATCH`` x
   ``AXIS_MOE_SEQ`` = 4 x 512, on the same ranks as data 2 x model 2 (4
   of the 8 experts a data rank, their ff dim over model) and as 4 x 1 (2
   experts a rank): the expert tables never gathered (the dispatch and
   combine exchanged by all_to_all over the data lines), 2 steps each,
   the losses equal on every rank and 2 x 2 within 2^-7 relative of 4 x
   1, the row gather 5, the gather-sum 1 and flash 2 launches a layer a
   step; each rank's peak memory;
16d. the GSPMD serve route (a mesh without a comm plan) in phase 7's
   world: olmo-1b at full width and depth on data 1 x model 4 from phase
   7's params (the rule table cuts them as ``serve_param_specs`` does),
   paged: tokens equal to the manual-TP path's on every rank (the same
   partial sums), 2 x L + 1 all-reduces and one all-gather a forward call
   on the model line's one group, printed beside ``ServeCommPlan``'s
   count by purpose; flash and page-gather launches as phase 7's; and the
   smoke archs on data 2 x model 2, contiguous and paged: tokens equal to
   the CPU engine's;
16e. the GSPMD serve route on the SSM and the hybrid in the same world,
   their Mamba2 blocks tensor-parallel over model (a rank projects,
   convolves and scans its heads and conv channels, gathers the conv
   output once, sums the gated norm's squares and out_proj's partial
   sums; its decode state is its slice): mamba2-780m-smoke and
   zamba2-7b-smoke on data 2 x model 2 (grouped): tokens equal to the
   CPU engine's; then at full width mamba2-780m, cut to
   ``SSM_GSPMD_LAYERS`` = 2 layers, and zamba2-7b, cut to one group of
   6 Mamba2 blocks closed by one shared-attention site (tensor-parallel
   over model), bf16, on data 1 x model 4: 4 prompts of 512 tokens, 8
   new: the ranks' tokens equal, and at least ``SSM_GSPMD_AGREE`` of
   them equal to one rank's engine on the card; a rank's state
   ``(L, 4, 3, CH/4)`` and ``(L, 4, H/4, N, P)``, its bytes a quarter of
   one rank's; one SSD launch a layer a prefill, every one at H/4 heads;
   one flash launch a site a prefill; a decode step's collectives on the
   model line as predicted (2 gathers and 2 all-reduces a block, the
   lookup's all-reduce and the logits' gather, 2 all-reduces a site); the
   first prefill's last-position logits within ``SSM_TP_LOGIT_TOL`` of
   one rank's (the replicated block's) on the card. Then, on phase 15's
   ranks after 16c, mamba2-780m at full width, ``SSM_AXIS_LAYERS`` = 2
   layers, bf16, ``remat="block"``, ``comm="gspmd"`` on data 2 x model 2,
   phase 9's global batch (8 x 1,024), 2 steps: the losses equal on every
   rank, the first within 2^-7 relative of one rank's gspmd step here;
   ``ssd_chunk`` 2 and ``ssd_chunk_bwd`` 1 launches a layer a step, every
   one at 24 heads and the backward's on the tensor cores; each rank's
   peak memory;
16f. the GSPMD route's sequence-split decode cache in the same world:
   gemma-2b-smoke (one KV head) f32 on data 1 x model 4, its cache's
   sequence over model: tokens equal to the CPU engine's; then gemma-2b
   at full width, ``SPLIT_LAYERS`` = 2 layers, f32 (TF32 off): 4 of phase
   5's requests, 16 new, on 1 x 4 (the sequence over model), and one
   request of a
   ``SPLIT_PROMPT`` = 4,000-token prompt, 2 new, on 2 x 2 (a batch of
   one does not divide the data line: the sequence over all four ranks):
   a rank holds a quarter of the cache's bytes, at least
   ``SSM_GSPMD_AGREE`` of the greedy tokens equal one rank's whole-cache
   engine on the card (its FFN and head partial sums round otherwise),
   one flash launch a layer a prefill; the collectives of the last decode
   step printed by line, the slices' partial attention gathered once a
   layer on the line that holds the split;
17. ``kv_fp8`` cache storage, ``yi-9b`` at full width, its depth cut to
   ``FP8_LAYERS`` = 12 of 48 layers (bf16, random from seed 0): (a) the
   port's
   cache cast (a clamp to +-448, then torch's cast) of all 65,536 bf16
   patterns: the card's bytes equal the CPU's on every non-NaN pattern
   (a NaN gives an fp8 NaN on both, whose sign bit may differ), 466 and
   inf give 448
   (torch's own cast is printed beside it: its overflow differs between
   torch builds); then
   ``ServeEngine`` with 8 requests (prompts of 512-2,048 tokens, 64 new)
   on 4 slots of 4,096 positions, pages of 16, four runs: a bf16 cache
   and ``kv_fp8``, each paged and contiguous: the K/V bytes under
   ``kv_fp8`` exactly half the bf16 ones (201,326,592 against
   402,653,184 contiguous at 12 layers), paged tokens equal to contiguous
   under ``kv_fp8``, every logit sampled from finite, 2 x L page-gather
   launches a decode step and L flash launches a prefill call; each
   run's ms a decode step, tok/s, prefill s, ``cache_bytes_resident``,
   peak memory and the device idle share of one profiled decode step;
   the fp8 cache's teacher-forced top-1 agreement with the bf16 one
   (recorded, not gated); (b) the page gather on fp8 pools at yi-9b's
   decode shape (8 KiB pages): kernel equal to the plain version bit for
   bit, its time beside the plain version's, ``index_select``'s and the
   bound at 1 B an element;
18. the archs the card had not run, at full width (bf16 params from a
   seed, each freed before the next; ``ServeEngine`` with a bf16 cache,
   paged then contiguous, phase 5's 8 requests of 16-64 tokens on 4
   slots, 32 new, the paged tokens equal to the contiguous ones; the
   counts zeroed just before each run and read just after: flash L a
   prefill call, the page gather 2 x L a paged decode step, the row gather
   2 x L a forward call of the MoE; ms a decode step, tok/s, prefill s,
   ``cache_bytes_resident``, peak memory): (a) gemma-2b at full depth (18
   layers, d 2,048, 8 heads / 1 KV of 256, GeGLU 16,384, vocab 256,000
   tied; 2.51 B), max_len 1,056, also one group of 4 prompts of 1,024;
   then trained from the same params (vci post, ``pack="pallas"``,
   ``remat="block"``, 4 x 1,024, a warm-up and 3 timed steps: the packs,
   one unpack and flash 2 x L a step counted; ms, tok/s, peak memory,
   optimizer bytes), then one ``comm="gspmd"`` step (phase 15a's); (b)
   command-r-35b at full depth (40 layers, d 8,192, 64 heads / 8 KV,
   d_ff 22,528, the parallel LayerNorm block, vocab 256,000 tied; 30.28
   B, 60.7 GB) on 4 slots of 2,048, then its first layer trained the same
   way at 4 x 512 (2.80 B with the 2.10 B-element embedding); (c)
   arctic-480b at full width, ``ARCTIC_SERVE_LAYERS`` = 2 of 35 layers
   (128 experts top-2 of d_ff 4,864 beside a dense residual FFN, d 7,168;
   27.68 B, 55.6 GB), max_len 256, then its first layer's forward and
   backward (remat block) at 4 x 512 with no optimizer step (its full
   step needs ≈113 GB before activations: two cards), 3 timed after a
   warm-up: the row gather 5 (2 read-once), the gather-sum 1 and flash 2
   a step; (d) yi-9b at ``YI_TRAIN_LAYERS`` = 12 of 48 layers trained as
   (a) at 8 x 1,024; (e) the four smoke archs' training on the card
   against the CPU (phase 10's rules; arctic's bf16 moments carry one
   bf16 ulp of a moment a step). ``init_params`` draws a bf16 leaf of
   more than 2^28 elements in pieces (``models/layers.py``): drawn as one
   float32 tensor a leaf, command-r-35b's init does not fit the card.

It prints a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Without CUDA, or without the package beside it, it fails and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense tensor-core bf16, same sheet
SERVE_ARCH = "olmo-1b"
BATCH, MAX_LEN, PAGE_SIZE = 4, 256, 16
N_REQUESTS, PROMPT_LO, PROMPT_HI, MAX_NEW = 8, 16, 64, 32
COLD_POOLS = 16                  # 16 pools of 8.5 (f32) / 4.3 MB > 50 MB L2
MOE_ARCH, MOE_LAYERS = "mixtral-8x22b", 4
# one prefill call of 8 x 1,024 tokens: the dispatch's 8,192 token rows
# take the row gather's read-once route
MOE_LONG_GROUP, MOE_LONG_PROMPT, MOE_LONG_NEW = 8, 1024, 4
SSM_ARCH, SSM_MAX_LEN = "mamba2-780m", 1056
SSM_PROMPTS = (1000,) * 4 + (64,) * 4
# phase 6g: the MoE past its window, a ring of 4,096 slots
WIN_MAX_LEN, WIN_BATCH, WIN_NEW = 6144, 2, 32
WIN_PROMPTS = (6000, 4080)       # 2 prompts of each length
WIN_EXACT_LEN, WIN_EXACT_NEW = 4096, 16
HYB_ARCH, HYB_MAX_LEN = "zamba2-7b", 1056
# serve phases cut in depth to keep the script in its time: 6e's
# mamba2-780m to 24 of 48 layers, 6h's zamba2-7b to 15 of 81 (2
# shared-attention sites), 6k's musicgen-large and 17's yi-9b to 12 of 48
SSM_SERVE_LAYERS, HYB_SERVE_LAYERS, AUDIO_SERVE_LAYERS, FP8_LAYERS = \
    24, 15, 12, 12
# phases 6j and 6k: 4 rows of 576 patches + 448 text tokens; 4 prompts of
# 1,000 frames and 4 of 64 (20 s and 1.3 s of 50 Hz EnCodec frames)
VLM_ARCH, VLM_TEXT, VLM_STEPS, MM_MAX_LEN = "phi-3-vision-4.2b", 448, 32, 1056
AUDIO_ARCH, AUDIO_PROMPTS = "musicgen-large", (1000,) * 4 + (64,) * 4
# name, x/B/C dtype, (b, s, h, p, g, n, chunk), timed
SSD_CASES = (
    ("serve", "bfloat16", (4, 1024, 48, 64, 1, 128, 256), True),
    ("second call", "bfloat16", (4, 256, 48, 64, 1, 128, 256), True),
    ("f32 g2", "float32", (2, 512, 6, 64, 2, 128, 256), False),
    ("hybrid", "bfloat16", (4, 1024, 112, 64, 1, 64, 256), True),
    # a model rank's heads of 16e's mamba2-780m prefill at tp 4
    ("rank tp4", "bfloat16", (4, 512, 12, 64, 1, 128, 256), True),
)
TRAIN_ARCH = "olmo-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 5
TRAIN_KNOBS = dict(comm="vci", pack="pallas", num_streams=8, num_vcis=8,
                   progress="hybrid")
# name, dtype, (B, Sq, Skv, H, KV, hd), causal, window, start, timed
FLASH_CASES = (
    ("a", "bfloat16", (8, 1024, 1024, 16, 16, 128), True, None, None, True),
    ("b", "bfloat16", (4, 64, 64, 16, 16, 128), True, None, (0, 9, 33, 63),
     True),
    ("c", "bfloat16", (2, 1024, 1024, 8, 1, 256), True, None, None, False),
    ("d", "float32", (2, 100, 100, 4, 2, 64), True, 32, (0, 37), False),
    ("e", "bfloat16", (2, 96, 160, 8, 2, 128), False, None, None, False),
    ("f", "bfloat16", (2, 1024, 1024, 32, 32, 96), True, None, None, True),
    ("g", "bfloat16", (2, 1024, 1024, 32, 32, 112), True, None, None, True),
    ("h", "bfloat16", (2, 4096, 4096, 16, 16, 128), True, None, None, True),
    ("i", "bfloat16", (2, 6000, 6000, 48, 8, 128), True, 4096, None, True),
    ("j", "bfloat16", (4, 1024, 1024, 32, 32, 96), True, None, None, True),
    ("k", "bfloat16", (4, 1000, 1000, 32, 32, 64), True, None, None, True),
    ("l", "bfloat16", (4, 64, 64, 32, 32, 64), True, None, None, True),
    # phase 7's per-rank prefills at tp 4: olmo-1b's 4 of 16 heads, and
    # mixtral-8x22b's 12 query heads on 2 KV heads (GQA 6:1) at 8 x 1,024
    # and in the serve batch's prefill (the variant for Sq <= 64)
    ("m", "bfloat16", (4, 64, 64, 4, 4, 128), True, None, (0, 9, 33, 63),
     True),
    ("n", "bfloat16", (8, 1024, 1024, 12, 2, 128), True, None, None, True),
    ("o", "bfloat16", (4, 64, 64, 12, 2, 128), True, None, (0, 9, 33, 63),
     True),
    # gemma-2b's short prefill (phase 18a): hd 256 with one KV head on the
    # variant for Sq <= 64, with pad rows
    ("p", "bfloat16", (4, 64, 64, 8, 1, 256), True, None, (0, 9, 33, 63),
     True),
)
# phase 12: ZeRO-1 on ranks sharing the one card, spawned once
ZERO1_WORLD, ZERO1_LAYERS, ZERO1_STEPS, ZERO1_TIMEOUT_S = 4, 2, 2, 420
PAIRS = 10                       # alternating kernel / library timings
# phases 13b and 13c: MoE, VLM and audio training at full width, depth cut
# to what one card's memory holds (see the docstring)
MOE_TRAIN_LAYERS, VLM_TRAIN_LAYERS, MM_TRAIN_STEPS = 1, 24, 3
MM_TRAIN_BATCH, AUDIO_TRAIN_FRAMES = 4, 1000
# phase 15: comm="gspmd" training (FSDP over the data ranks) and
# checkpoints: 15a's steps, 15b/15c's ranks on the one card, layers, steps
GSPMD_STEPS = 5
# (2 layers: the ranks' gloo traffic through host memory is most of the
# phase's time)
GSPMD_WORLD, GSPMD_LAYERS, GSPMD_RANK_STEPS, GSPMD_TIMEOUT_S = 4, 2, 2, 600
# phase 16c: mixtral-8x22b at full width, its depth cut to 1 layer, bf16,
# 4 x 512 tokens a step on the 4 ranks as data 2 x model 2 and 4 x 1
AXIS_MOE_LAYERS, AXIS_MOE_BATCH, AXIS_MOE_SEQ = 1, 4, 512
# 16e's training run: mamba2-780m at full width, 2 layers, on the same
# ranks as data 2 x model 2 (24 of 48 heads a model rank)
SSM_AXIS_LAYERS = 2
# phases 14a-14c: the SSD backward and SSM / hybrid training
SSM_TRAIN_ARCH, SSM_TRAIN_LAYERS, HYB_TRAIN_LAYERS = "mamba2-780m", 24, 15
FP32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
# phase 17: yi-9b at full width and depth through ServeEngine, bf16 cache
# and kv_fp8, paged and contiguous: 8 requests of 512-2,048 tokens, 64 new,
# on 4 slots of 4,096 positions, pages of 16; the decode step profiled
FP8_ARCH, FP8_BATCH, FP8_MAX_LEN, FP8_PAGE, FP8_NEW = "yi-9b", 4, 4096, 16, 64
FP8_PROMPTS = (512, 2048, 1024, 1536, 768, 1792, 640, 1280)
FP8_PROFILE_AT = 20
# phase 18: the archs the card had not run, at full width. Serve (bf16
# cache, paged and contiguous): gemma-2b at full depth, also one group of 4
# prompts of 1,024 tokens; command-r-35b at full depth on 4 slots of 2,048;
# arctic-480b at ARCTIC_SERVE_LAYERS of 35. Train (vci post, pack pallas,
# remat block; then one gspmd step): yi-9b at YI_TRAIN_LAYERS of 48, 8 x
# 1,024; gemma-2b at full depth, 4 x 1,024; command-r-35b at 1 layer, 4 x
# 512; arctic-480b one layer's forward and backward, 4 x 512, no optimizer
# step (its full step needs two cards: see the docstring)
GEMMA_ARCH, GEMMA_MAX_LEN, GEMMA_LONG = "gemma-2b", 1056, (1024,) * 4
CMDR_ARCH, CMDR_MAX_LEN = "command-r-35b", 2048
ARCTIC_ARCH, ARCTIC_SERVE_LAYERS = "arctic-480b", 2
YI_TRAIN_LAYERS, ARCH_TRAIN_STEPS = 12, 3
# (arch, layers (None: all), batch, seq)
ARCH_TRAINS = (("yi-9b", YI_TRAIN_LAYERS, 8, 1024),
               (GEMMA_ARCH, None, 4, 1024),
               (CMDR_ARCH, 1, 4, 512))
ARCTIC_GRAD_BATCH, ARCTIC_GRAD_SEQ, ARCTIC_GRAD_STEPS = 4, 512, 3
# 16f: the sequence-split decode cache on the GSPMD route in phase 7's
# world: gemma-2b at full width, SPLIT_LAYERS layers, f32, on 1 x 4 (its
# one KV head: the sequence over model; 4 of phase 5's requests) and one
# request of a SPLIT_PROMPT-token prompt on 2 x 2 (the sequence over all
# four ranks), SPLIT_NEW and SPLIT_LONG_NEW new tokens (2 x 2's FSDP
# gathers of the f32 weights through gloo take ≈3 s a decode step)
SPLIT_LAYERS, SPLIT_PROMPT, SPLIT_NEW, SPLIT_LONG_NEW = 2, 4000, 16, 2
# name, x/B/C dtype, (b, s, h, p, g, n, chunk), timed
SSD_BWD_CASES = (
    ("mamba2-780m train", "bfloat16", (8, 1024, 48, 64, 1, 128, 256), True),
    ("zamba2-7b train", "bfloat16", (4, 1024, 112, 64, 1, 64, 256), True),
    # a model rank's heads of 16e's mamba2-780m training run at tp 2 (a
    # data rank's 4 rows)
    ("rank tp2", "bfloat16", (4, 1024, 24, 64, 1, 128, 256), True),
    ("f32", "float32", (2, 512, 8, 64, 1, 128, 256), False),
    ("g2", "bfloat16", (2, 512, 8, 64, 2, 64, 256), False),
    ("overflow", "float32", (1, 256, 4, 64, 1, 128, 256), False),
    ("overflow", "bfloat16", (1, 256, 4, 64, 1, 128, 256), False),
)
# what a phase 13 may find still allocated when it starts (a leaked
# autograd graph once left 35 GB behind)
FRESH_MAX_BYTES = 4 << 30
# phase 7: TP ranks sharing the one card, spawned once
# (olmo-1b at num_vcis 8 only: the one-VCI fallback is checked on a smoke
# case, which saves two full-width decode runs of ~25 s each)
TP_WORLD, TP_VCIS, TP_TIMEOUT_S = 4, (8,), 600
TP_SMOKE = ("olmo-1b-smoke", "mixtral-8x22b-smoke")
# 16e: the GSPMD route on the SSM and the hybrid, their smoke archs on
# data 2 x model 2 (against the CPU engine) and at full width on 1 x 4
# (against one rank on the card): mamba2 at 2 layers, zamba2 at its
# hybrid_attn_every = 6 (one shared-attention site); 4 prompts of 512, 8 new
GSPMD_SMOKE = ("mamba2-780m-smoke", "zamba2-7b-smoke")
SSM_GSPMD_LAYERS, SSM_GSPMD_PROMPT, SSM_GSPMD_NEW = 2, 512, 8
# 16e's 1 x 4 tokens against one rank's: the lookup and head split
# exactly, but each Mamba2 block's out_proj partial sums (and the site's)
# are rounded to bf16 before their all-reduce and the head's vocab slices
# are GEMMs of other shapes, which can flip a near-tied argmax; one flip
# in one of the 4 requests moves at most its 8 tokens, a quarter, while a
# broken route agrees on almost none of them (vocabs of 50,280 and
# 32,000)
SSM_GSPMD_AGREE = 0.75
# 16e's tp 4 first-prefill logits against one rank's, as a share of max
# |one rank|: bf16 weights and activations; the ranks' out_proj partial
# sums are rounded to bf16 before their all-reduce (one rank rounds one
# f32-accumulated sum), and the gated norm's sum of squares is summed in
# another order, so each block's output moves by a few bf16 ulps, as
# phase 7's TP_LOGIT_TOL allows over 16 layers
SSM_TP_LOGIT_TOL = 0.05
# tp 4's first-prefill logits against tp 1's, as a share of max |tp 1|:
# bf16 weights and activations, and each layer's wo / w_down outputs
# rounded to bf16 as 4 partial sums before their all-reduce (tp 1 rounds
# one f32-accumulated sum), so every layer's two sums differ by a few bf16
# ulps (2^-8 relative each) and 16 layers of residuals carry them on;
# 0.05 leaves a margin of several times that drift
TP_LOGIT_TOL = 0.05


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, n_iter: int = 100, reps: int = 5) -> float:
    """Device time of one ``fn(i)``: ``n_iter`` calls captured in a CUDA
    graph after a warm-up, the graph replayed ``reps`` times between CUDA
    events. The graph takes the Python wrapper out of the timing, so this
    is the card's time, not the host's launch rate."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_iter):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * n_iter)


def paired_ms(fn, lib, pairs: int = PAIRS, **kw) -> tuple:
    """Medians of ``pairs`` alternating ``time_ms`` readings of ``fn`` and
    ``lib`` (fn, lib, lib, fn, ...: neither always goes first), and the
    number of pairs in which ``fn`` was the faster."""
    a, b = [], []
    for i in range(pairs):
        order = ((fn, a), (lib, b)) if i % 2 == 0 else ((lib, b), (fn, a))
        for f, out in order:
            out.append(time_ms(f, **kw))
    med = lambda x: sorted(x)[len(x) // 2]  # noqa: E731
    return med(a), med(b), sum(x < y for x, y in zip(a, b))


def eager_ms(fn, n_iter: int = 200) -> float:
    """Wall time of one eager ``fn(i)`` in a loop, host overhead included."""
    import torch
    for i in range(10):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_iter):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_iter


def phase_device() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    line = r.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.time()
    logs = _build.build_all()
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"build {name}: {ln.strip()}")
    print(f"build: {len(logs)} kernel(s) compiled in {time.time() - t0:.2f}s "
          f"({sorted(_build.KERNELS)})", flush=True)


def phase_kernels() -> dict:
    """paged_gather vs paged_gather_plain at the olmo-1b serve shape."""
    import torch
    from repro_torch.kernels.paged_kv import paged_gather, paged_gather_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    np_, b, maxp = 1 + BATCH * (MAX_LEN // PAGE_SIZE), BATCH, MAX_LEN // PAGE_SIZE
    table = torch.randint(0, np_, (b, maxp), generator=gen, device=dev,
                          dtype=torch.int32)
    table[torch.rand((b, maxp), generator=gen, device=dev) < 0.25] = -1
    table[0, 0] = -1
    ids = table.long().clamp(0, np_ - 1).reshape(-1)
    mapped = table[table >= 0].unique().numel()
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        pools = torch.randn((COLD_POOLS, np_, PAGE_SIZE, 16, 128),
                            generator=gen, device=dev).to(dtype)
        got = paged_gather(pools[0], table)
        want = paged_gather_plain(pools[0], table)
        torch.cuda.synchronize()
        ib = torch.int32 if dtype == torch.float32 else torch.int16
        check(torch.equal(got.view(ib), want.view(ib)),
              f"paged_gather kernel != plain version ({dtype})")
        err = (got.float() - want.float()).abs().max().item()
        kernel_ms, library_ms, wins = paired_ms(
            lambda i: paged_gather(pools[i % COLD_POOLS], table),
            lambda i: pools[i % COLD_POOLS].index_select(0, ids))
        plain_ms = time_ms(lambda i: paged_gather_plain(pools[i % COLD_POOLS],
                                                        table))
        host_ms = eager_ms(lambda i: paged_gather(pools[i % COLD_POOLS],
                                                  table))
        page_bytes = pools[0, 0].numel() * pools.element_size()
        nbytes = mapped * page_bytes + table.nbytes + got.nbytes
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        res[str(dtype).replace("torch.", "")] = dict(
            max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms)
        print(f"kernel paged_gather {dtype}: pool {tuple(pools.shape[1:])} "
              f"table {tuple(table.shape)} ({int((table < 0).sum())} "
              f"unmapped) bitwise equal to plain, max_abs_err={err}; "
              f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms(index_select)={library_ms:.5f} (medians of "
              f"{PAIRS} alternating pairs, the kernel faster in {wins}) "
              f"bound_ms={bound_ms:.5f} ({nbytes} B); eager call incl. "
              f"host {host_ms:.5f} ms", flush=True)
        del pools
    # phase 7's per-rank pool at tp 4: 4 of olmo-1b's 16 KV heads, f32
    pool = torch.randn((np_, PAGE_SIZE, 16 // TP_WORLD, 128), generator=gen,
                       device=dev)
    got, want = paged_gather(pool, table), paged_gather_plain(pool, table)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          "paged_gather kernel != plain version at the tp-rank pool")
    print(f"kernel paged_gather float32 at phase 7's rank pool "
          f"{tuple(pool.shape)}: bitwise equal to plain", flush=True)
    return res


def _routed(groups, tokens, experts, top_k, cf, gen):
    """Routing tables of ``groups`` groups of ``tokens`` tokens, each token
    sent to ``top_k`` distinct random experts, through the port's own
    ``dispatch_tables`` at the capacity ``moe_ffn`` gives that group."""
    import torch
    from repro_torch.models.moe import capacity, dispatch_tables
    eidx = torch.rand((groups, tokens, experts), generator=gen,
                      device="cuda").argsort(-1)[..., :top_k]
    cap = min(capacity(tokens, experts, cf, top_k), tokens)
    return dispatch_tables(eidx, experts, cap)


def _read_once_forced(src, idx, inv):
    """``row_gather`` on the read-once route whatever the size (the wrapper
    takes it only where it spares >= ``_READ_ONCE_MIN_BYTES`` of reads)."""
    from repro_torch.kernels import moe_gather
    floor = moe_gather._READ_ONCE_MIN_BYTES
    moe_gather._READ_ONCE_MIN_BYTES = 0
    try:
        return moe_gather.row_gather(src, idx, inv)
    finally:
        moe_gather._READ_ONCE_MIN_BYTES = floor


def phase_row_gather() -> dict:
    """row_gather vs row_gather_plain, bit for bit, at the MoE serve
    path's shapes (see the docstring); times at the bandwidth-sized case."""
    import torch
    from repro_torch.kernels.moe_gather import (_read_once, row_gather,
                                                row_gather_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    d = 6144
    dec, dec_inv, _ = _routed(4, 1, 8, 2, 2.0, gen)      # decode: C = 1
    pre, pre_inv, _ = _routed(1, 64, 8, 2, 2.0, gen)     # prefill: C = 32
    big, comb, _ = _routed(8, 1024, 8, 2, 1.25, gen)     # C = 320
    smoke, smoke_inv, _ = _routed(4, 20, 4, 2, 2.0, gen)  # smoke, f32
    # phase 7's expert-parallel dispatch at tp 4: rank 1's 2 of 8 experts,
    # one contiguous slot range of the table, its inverse rebased
    lo, hi = 2 * 8 * 320, 4 * 8 * 320
    rank_inv = torch.where((comb >= lo) & (comb < hi), comb - lo,
                           -1).to(torch.int32)
    # name, dtype, source rows, table, its inverse (the dispatch's comb,
    # as moe_ffn passes it), timed
    cases = (("decode dispatch", torch.bfloat16, 4, dec, dec_inv, True),
             ("prefill dispatch", torch.bfloat16, 64, pre, pre_inv, True),
             ("8x1024 dispatch", torch.bfloat16, 8192, big, comb, True),
             ("8x1024 combine", torch.bfloat16, big.numel(), comb, None,
              False),
             ("smoke dispatch f32 d=256", torch.float32, 80, smoke,
              smoke_inv, False),
             ("8x1024 tp-rank dispatch", torch.bfloat16, 8192, big[lo:hi],
              rank_inv, False),
             ("every row empty", torch.bfloat16, 4,
              torch.full((32,), -1, dtype=torch.int32, device=dev),
              torch.full((8,), -1, dtype=torch.int32, device=dev), False))
    res = {"max_abs_err": 0.0}
    for name, dtype, t, idx, inv, timed in cases:
        width = 256 if dtype == torch.float32 else d
        src = torch.randn((t, width), generator=gen, device=dev).to(dtype)
        want = row_gather_plain(src, idx)
        valid = int((idx >= 0).sum())
        what = (f"row_gather {name}: src {tuple(src.shape)} {dtype}, idx "
                f"{tuple(idx.shape)} ({valid} valid)")
        routes = (("gather", lambda: row_gather(src, idx)),)
        if inv is not None:
            routes += (("read-once",
                        lambda: _read_once_forced(src, idx, inv)),)
        for route, call in routes:
            got = call()
            torch.cuda.synchronize()
            check(torch.equal(_bits(got), _bits(want)),
                  f"{what}, {route} route: kernel != plain version")
            err = (got.float() - want.float()).abs().max().item()
            res["max_abs_err"] = max(res["max_abs_err"], err)
            print(f"kernel {what}, {route} route: bitwise equal to plain, "
                  f"max_abs_err={err}", flush=True)
        if not timed:
            continue
        ids = idx.long().clamp(0, t - 1)
        plain_ms = time_ms(lambda i: row_gather_plain(src, idx), n_iter=20,
                           reps=3)
        # each distinct source row read once, every output row written
        # once, the table read once
        row = width * src.element_size()
        distinct = int(idx[idx >= 0].unique().numel())
        nbytes = distinct * row + got.nbytes + idx.nbytes
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # both routes; moe_ffn's call (row_gather(x, disp, comb)) takes the
        # read-once route where it spares >= _READ_ONCE_MIN_BYTES of reads,
        # and its times are the ones kept
        taken = ("read-once" if inv is not None and
                 _read_once(src, inv.numel() // t) else "gather")
        for route, call in routes:
            kernel_ms, library_ms, wins = paired_ms(
                lambda i: call(), lambda i: src.index_select(0, ids),
                n_iter=20, reps=3)
            host_ms = eager_ms(lambda i: call())
            if route == taken:
                res[name] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                 library_ms=library_ms, bound_ms=bound_ms)
            print(f"kernel row_gather {name} times, {route} route"
                  f"{' (the one moe_ffn takes)' if route == taken else ''}: "
                  f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
                  f"library_ms(index_select)={library_ms:.5f} (medians of "
                  f"{PAIRS} alternating pairs, the kernel faster in {wins}) "
                  f"bound_ms={bound_ms:.5f} ({nbytes} B: "
                  f"{distinct} distinct rows read for {valid} valid, "
                  f"{idx.numel()} written; {bound_ms / kernel_ms:.3f} of the "
                  f"bound, {nbytes / kernel_ms / 1e9:.3f} TB/s of them); "
                  f"eager call incl. host {host_ms:.5f} ms", flush=True)
        del src, got, want
    torch.cuda.empty_cache()
    return res


def flash_work(q, k, kw) -> tuple:
    """(FLOPs, bytes) the attention of these inputs needs: 4 * hd FLOPs per
    (query, valid key) pair over all heads, a row with no valid key
    counting all Skv keys (its mean of V); q, k, v and o once, lse, start."""
    import torch
    from repro_torch.kernels.flash_attention import attention_mask
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    n = attention_mask(sq, skv, device=q.device, **kw).sum(-1)
    pairs = int(torch.where(n == 0, skv, n).expand(b, sq).sum()) * h
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + \
        b * h * sq * 4 + (0 if kw["start"] is None else b * 4)
    return 4 * hd * pairs, nbytes


def _flash_plain(q, k, v, kw) -> tuple:
    """``flash_attention_fwd_plain``, one batch row at a time where its
    (B,H,Sq,Skv) f32 logits would pass 8 GB (the same math per row)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_fwd_plain
    b, sq, h, _ = q.shape
    if b == 1 or b * h * sq * k.shape[1] * 4 <= 8e9:
        return flash_attention_fwd_plain(q, k, v, **kw)
    st = kw["start"]
    rows = [flash_attention_fwd_plain(
        q[i:i + 1], k[i:i + 1], v[i:i + 1],
        **dict(kw, start=None if st is None else st[i:i + 1]))
        for i in range(b)]
    return torch.cat([o for o, _ in rows]), torch.cat([l for _, l in rows])


def phase_flash() -> dict:
    """The flash-attention kernel against its plain version at (a)-(o)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    res = {"max_abs_err": 0.0}
    for (name, dt, (b, sq, skv, h, kvh, hd), causal, window, start,
         timed) in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                                 (b, skv, kvh, hd)))
        st = None if start is None else torch.tensor(
            start, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, window=window, start=st)
        n0 = fa.flash_attention.launches
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        o2, lse2 = fa.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        what = (f"flash ({name}) {dt} q{tuple(q.shape)} kv{tuple(k.shape)} "
                f"causal={causal} window={window} start={start}")
        check(fa.flash_attention.launches == n0 + 2,
              f"{what}: 2 calls counted {fa.flash_attention.launches - n0}")
        check(torch.equal(_bits(o), _bits(o2)) and
              torch.equal(_bits(lse), _bits(lse2)),
              f"{what}: a second launch gave other bits")
        check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
              f"{what}: non-finite output")
        if dtype == torch.float32:
            po, plse = _flash_plain(q, k, v, kw)
            eo = (o - po).abs().max().item()
            el = (lse - plse).abs().max().item()
            tol_o = tol_l = 2e-5
            rule = "vs plain f32, tol 2e-5"
        else:
            ro, rlse = _flash_plain(q.float(), k.float(), v.float(), kw)
            po, plse = _flash_plain(q, k, v, kw)
            eo = (o.float() - ro).abs().max().item()
            el = (lse - rlse).abs().max().item()
            po_err = (po.float() - ro).abs().max().item()
            plse_err = (plse - rlse).abs().max().item()
            tol_o, tol_l = 1.25 * po_err + 1e-3, 1.25 * plse_err + 1e-3
            rule = (f"vs plain f32 on upcast inputs; plain {dt} errs o "
                    f"{po_err:.3e} lse {plse_err:.3e}")
            del ro, rlse
        check(eo <= tol_o and el <= tol_l,
              f"{what}: o err {eo:.3e} (tol {tol_o:.3e}), lse err {el:.3e} "
              f"(tol {tol_l:.3e})")
        pad = 0 if st is None else int(sum(min(x, sq) for x in start)) * h
        res["max_abs_err"] = max(res["max_abs_err"], eo)
        print(f"kernel {what}: o err {eo:.3e} (tol {tol_o:.3e}), lse err "
              f"{el:.3e} (tol {tol_l:.3e}) [{rule}]; {pad} pad rows; "
              f"second launch bit-equal", flush=True)
        del po, plse
        if timed:
            # SDPA: is_causal, or the window as an explicit boolean mask;
            # K/V repeated to the query heads where they are fewer
            qt, kt, vt = (fa.repeat_kv(t, h // t.shape[2]).transpose(
                1, 2).contiguous() for t in (q, k, v))
            lib_kw, lib = dict(is_causal=True), "sdpa is_causal"
            if window is not None:
                lib_kw = dict(attn_mask=fa.attention_mask(
                    sq, skv, causal=causal, window=window, device=dev)[0])
                lib = "sdpa bool mask"
            if kvh != h:
                lib += f", K/V repeated {kvh}->{h} heads"
            kernel_ms, library_ms, wins = paired_ms(
                lambda i: fa.flash_attention_fwd(q, k, v, **kw),
                lambda i: F.scaled_dot_product_attention(
                    qt, kt, vt, **lib_kw), n_iter=20, reps=3)
            plain_ms = time_ms(lambda i: _flash_plain(q, k, v, kw),
                               n_iter=3, reps=2)
            flops, nbytes = flash_work(q, k, kw)
            flop_ms = flops / BF16_FLOPS_PER_S * 1e3
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(flop_ms, byte_ms)
            bound_by = "operations" if flop_ms > byte_ms else "bytes"
            res[name] = dict(ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
            print(f"kernel flash ({name}) times: kernel_ms={kernel_ms:.5f} "
                  f"plain_ms={plain_ms:.5f} library_ms({lib})="
                  f"{library_ms:.5f} (medians of {PAIRS} alternating pairs, "
                  f"the kernel faster in {wins}) "
                  f"bound_ms={bound_ms:.5f} ({bound_by}: "
                  f"{flops} FLOPs -> {flop_ms:.5f} ms, {nbytes} B -> "
                  f"{byte_ms:.5f} ms; {bound_ms / kernel_ms:.3f} of the "
                  f"bound, {flops / kernel_ms / 1e9:.1f} TFLOP/s)",
                  flush=True)
            del qt, kt, vt, lib_kw
        del q, k, v, o, lse, o2, lse2
    torch.cuda.empty_cache()
    return res


def _requests(vocab: int):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, vocab, (int(rng.integers(
        PROMPT_LO, PROMPT_HI + 1)),), dtype=np.int32),
        max_new_tokens=MAX_NEW) for _ in range(N_REQUESTS)]


class _Timed:
    """Wraps an engine's prefill/step callable: host time to completion;
    ``last`` is the last call's output."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls, self.last = fn, 0.0, 0, None

    def __call__(self, *a, **kw):
        import torch
        t0 = time.perf_counter()
        out = self.fn(*a, **kw)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.last = out
        return out


def phase_serve(cfg) -> dict:
    """``cfg`` at full width through ``ServeEngine``, paged then contiguous
    (see the docstring: phase 5 for olmo-1b, 6b for the MoE)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gather import row_gather
    from repro_torch.kernels.paged_kv import paged_gather
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Request, ServeEngine

    moe = cfg.moe is not None
    t0 = time.time()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # the init's float32 temporaries
    print(f"serve: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          + (f"experts={cfg.moe.num_experts} top_k={cfg.moe.top_k} "
             if moe else "")
          + f"params={cfg.param_count() / 1e9:.3f}B {cfg.param_dtype} "
          f"(init {time.time() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated()} B on the card)", flush=True)
    from repro_torch.models.transformer import Model
    runs = {"first_logits": _first_logits(cfg, Model(cfg), params)}
    for layout in ("paged", "contiguous"):
        eng = ServeEngine(cfg, params, batch_size=BATCH, max_len=MAX_LEN,
                          device="cuda", paged=layout == "paged",
                          page_size=PAGE_SIZE)
        eng.generate([Request(prompt=r.prompt[:PROMPT_LO], max_new_tokens=2)
                      for r in _requests(cfg.vocab_size)[:2]])  # warm-up
        reqs = _requests(cfg.vocab_size)
        eng._prefill, eng._step = _Timed(eng._prefill), _Timed(eng._step)
        torch.cuda.synchronize()
        paged_gather.launches = flash_attention.launches = 0
        row_gather.launches = 0
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, flash = paged_gather.launches, flash_attention.launches
        rows = row_gather.launches
        n_tok = sum(len(r.generated) for r in reqs)
        for i, r in enumerate(reqs):
            g = r.generated
            check(len(g) == MAX_NEW, f"{layout}: request {i} made {len(g)} "
                  f"tokens, want {MAX_NEW}")
            check(bool(((g >= 0) & (g < cfg.vocab_size)).all()),
                  f"{layout}: request {i} has out-of-range ids")
        steps = eng.decode_steps
        runs[layout] = dict(tokens=[r.generated.tolist() for r in reqs],
                            launches=launches, flash=flash, rows=rows,
                            bytes=eng.cache_bytes_resident,
                            step_ms=eng._step.seconds / max(steps, 1) * 1e3,
                            tok_s=n_tok / dt)
        print(f"serve {cfg.name} {layout}: {len(reqs)} requests (prompts "
              f"{[len(r.prompt) for r in reqs]}), {n_tok} new tokens in "
              f"{dt:.3f}s ({n_tok / dt:.1f} tok/s) decode_steps={steps} "
              f"decode_s={eng._step.seconds:.3f} "
              f"({eng._step.seconds / max(steps, 1) * 1e3:.3f} ms/step) "
              f"prefill_s={eng._prefill.seconds:.3f} "
              f"({eng._prefill.calls} prefills incl. admissions) "
              f"paged_gather.launches={launches} "
              f"flash_attention.launches={flash} "
              f"row_gather.launches={rows} "
              f"cache_bytes_resident={eng.cache_bytes_resident}", flush=True)
        calls = eng._prefill.calls + steps
        want = 2 * cfg.num_layers * calls if moe else 0
        check(rows == want,
              f"{layout} run launched row_gather {rows} times, want "
              + (f"2 x {cfg.num_layers} x {calls} forward calls = {want}"
                 if moe else "0 (no MoE layer)"))
        want = cfg.num_layers * eng._prefill.calls
        check(eng._prefill.calls > 0 and flash == want,
              f"{layout} run launched flash_attention {flash} times, want "
              f"{cfg.num_layers} x {eng._prefill.calls} prefill calls = "
              f"{want}")
        if layout == "paged":
            want = 2 * cfg.num_layers * steps
            check(steps > 0 and launches == want,
                  f"paged run launched paged_gather {launches} times, want "
                  f"2 x {cfg.num_layers} x {steps} = {want}")
            owner = eng._pages.owner
            check(bool((owner[1:] == -1).all()), "pages leaked after drain")
        else:
            check(launches == 0, "contiguous run launched the page gather")
    for i, (a, b) in enumerate(zip(runs["paged"]["tokens"],
                                   runs["contiguous"]["tokens"])):
        check(a == b, f"request {i}: paged tokens {a} != contiguous {b}")
    print(f"serve {cfg.name}: paged tokens identical to contiguous tokens "
          f"for all {N_REQUESTS} requests; resident cache bytes "
          f"paged/contiguous = "
          f"{runs['paged']['bytes']}/{runs['contiguous']['bytes']}",
          flush=True)
    if moe:
        runs["long"] = serve_moe_long(cfg, params)
    profile_decode(cfg, params)
    if moe:
        runs["window"] = serve_moe_window(cfg, params)
    del params
    torch.cuda.empty_cache()
    return runs


def _long_prompts(vocab: int):
    import numpy as np
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, (MOE_LONG_PROMPT,), dtype=np.int32)
            for _ in range(MOE_LONG_GROUP)]


def _first_batch(vocab: int):
    """The engine's first prefill batch of the serve requests: the first
    ``BATCH`` prompts left-padded, and their pad offsets."""
    import numpy as np
    prompts = [r.prompt for r in _requests(vocab)[:BATCH]]
    pad = max(len(p) for p in prompts)
    tokens = np.zeros((BATCH, pad), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, pad - len(p):] = p
    return tokens, np.asarray([pad - len(p) for p in prompts], np.int32)


def _first_logits(cfg, model, params, kv_heads=None):
    """Last-position logits (f32, on the host) of the first prefill batch
    through ``model`` into a fresh f32 cache (``kv_heads``: a TP rank's)."""
    import torch
    from repro_torch.models.transformer import init_cache
    tokens, start = _first_batch(cfg.vocab_size)
    cache = init_cache(cfg, BATCH, tokens.shape[1], dtype=torch.float32,
                       device="cuda", kv_heads=kv_heads)
    with torch.inference_mode():
        logits, _, _ = model.forward(
            params, {"tokens": torch.as_tensor(tokens, device="cuda")},
            cache=cache, start=torch.as_tensor(start, device="cuda"))
    out = logits[:, -1].float().cpu().numpy()
    del cache, logits
    torch.cuda.empty_cache()
    return out


def serve_moe_long(cfg, params) -> dict:
    """Phase 6b's long prompts (see the docstring): the row gather's
    read-once route on the serve path. Returns the first run's counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import moe_gather
    from repro_torch.kernels.moe_gather import row_gather
    from repro_torch.serve.engine import Request, ServeEngine

    prompts = _long_prompts(cfg.vocab_size)
    eng = ServeEngine(cfg, params, batch_size=MOE_LONG_GROUP,
                      max_len=MOE_LONG_PROMPT + MOE_LONG_NEW, device="cuda",
                      paged=False)
    # warm-up: the first call at these shapes sets up what the two timed
    # runs then share
    eng.generate([Request(prompt=p, max_new_tokens=1) for p in prompts])
    eng._prefill = _Timed(eng._prefill)
    got = {}
    floor = moe_gather._READ_ONCE_MIN_BYTES
    for route in ("read-once", "gather only"):
        reqs = [Request(prompt=p, max_new_tokens=MOE_LONG_NEW)
                for p in prompts]
        eng._prefill.seconds = eng._prefill.calls = 0
        if route == "gather only":
            moe_gather._READ_ONCE_MIN_BYTES = 1 << 62
        torch.cuda.synchronize()
        row_gather.launches = row_gather.read_once_launches = 0
        try:
            eng.generate(reqs)
            torch.cuda.synchronize()
        finally:
            moe_gather._READ_ONCE_MIN_BYTES = floor
        rows, once = row_gather.launches, row_gather.read_once_launches
        calls = eng._prefill.calls + eng.decode_steps
        for i, r in enumerate(reqs):
            g = r.generated
            check(len(g) == MOE_LONG_NEW and bool(
                ((g >= 0) & (g < cfg.vocab_size)).all()),
                f"long prompts, {route}: request {i} made {g.tolist()}")
        check(rows == 2 * cfg.num_layers * calls,
              f"long prompts, {route}: row_gather launched {rows} times, "
              f"want 2 x {cfg.num_layers} x {calls} forward calls")
        want = cfg.num_layers * eng._prefill.calls \
            if route == "read-once" else 0
        check(eng._prefill.calls == 1 and once == want,
              f"long prompts, {route}: {eng._prefill.calls} prefill calls, "
              f"{once} read-once launches, want 1 and {want}")
        got[route] = dict(tokens=[r.generated.tolist() for r in reqs],
                          rows=rows, read_once=once)
        print(f"serve {cfg.name} long prompts, {route}: {MOE_LONG_GROUP} x "
              f"{MOE_LONG_PROMPT} tokens in {eng._prefill.calls} prefill "
              f"call ({eng._prefill.seconds:.3f}s) + {eng.decode_steps} "
              f"decode steps: row_gather.launches={rows}, "
              f"{once} of them on the read-once route", flush=True)
    check(got["read-once"]["tokens"] == got["gather only"]["tokens"],
          "long prompts: the read-once route changed the tokens")
    print(f"serve {cfg.name} long prompts: tokens identical with and "
          f"without the read-once route", flush=True)
    del eng
    torch.cuda.empty_cache()
    return got["read-once"]


def serve_moe_window(cfg, params) -> dict:
    """Phase 6g (see the docstring): ``cfg`` past its sliding window
    through the ring cache. Returns the run's counts."""
    import numpy as np
    import torch
    from repro_torch.device import torch_dtype
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gather import _read_once, row_gather
    from repro_torch.kernels.paged_kv import paged_gather
    from repro_torch.models.attention import (KVCache, combine_partials,
                                              decode_attention,
                                              partial_attention)
    from repro_torch.serve.engine import Request, ServeEngine

    w, layers = cfg.sliding_window, cfg.num_layers
    rng = np.random.default_rng(10)
    prompts = {n: [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
                   for _ in range(WIN_BATCH)] for n in WIN_PROMPTS}

    def make_requests(new=WIN_NEW, lens=WIN_PROMPTS):
        return [Request(prompt=p, max_new_tokens=new) for n in lens
                for p in prompts[n]]

    eng = ServeEngine(cfg, params, batch_size=WIN_BATCH,
                      max_len=WIN_MAX_LEN, device="cuda", paged=True)
    check(eng._ring and not eng._paged,
          f"window {w} < max_len {WIN_MAX_LEN}: want the grouped ring path")
    eng.generate(make_requests(new=2))      # warm-up: both prefill shapes
    eng._prefill, eng._step = _Timed(eng._prefill), _Timed(eng._step)
    reqs = make_requests()
    torch.cuda.synchronize()
    flash_attention.launches = paged_gather.launches = 0
    row_gather.launches = row_gather.read_once_launches = 0
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    flash, pages = flash_attention.launches, paged_gather.launches
    rows, once = row_gather.launches, row_gather.read_once_launches
    calls, steps = eng._prefill.calls, eng.decode_steps
    for i, r in enumerate(reqs):
        g = r.generated
        check(len(g) == WIN_NEW and bool(
            ((g >= 0) & (g < cfg.vocab_size)).all()),
            f"window run: request {i} made {g.tolist()}")
    check(calls == len(WIN_PROMPTS) and steps == calls * (WIN_NEW - 1),
          f"window run: {calls} prefill calls and {steps} decode steps")
    check(flash == layers * calls, f"window run launched flash_attention "
          f"{flash} times, want {layers} x {calls} prefill calls")
    check(rows == 2 * layers * (calls + steps),
          f"window run launched row_gather {rows} times, want 2 x {layers} "
          f"x {calls + steps} forward calls")
    check(pages == 0, f"window run launched paged_gather {pages} times")
    # each prefill's dispatch goes the way moe_gather's rule sends it (a
    # decode step's 2 token rows take the gather route)
    routes = {n: _read_once(torch.empty(
        (WIN_BATCH * n, cfg.d_model), dtype=torch_dtype(cfg.dtype),
        device="meta"), cfg.moe.top_k) for n in WIN_PROMPTS}
    want = layers * sum(routes.values())
    check(once == want, f"window run: {once} read-once launches, want {want}")
    # K and V of every layer in f32, and the two int32 cursors
    ring_b, full_b = (layers * 2 * WIN_BATCH * n * cfg.num_kv_heads
                      * cfg.head_dim * 4 + 8 for n in (w, WIN_MAX_LEN))
    check(eng.cache_bytes_resident == ring_b,
          f"window run: cache_bytes_resident {eng.cache_bytes_resident}, "
          f"the ring's shapes give {ring_b}")
    step_ms = eng._step.seconds / steps * 1e3
    prefill_s = eng._prefill.seconds
    n_tok = sum(len(r.generated) for r in reqs)
    print(f"serve {cfg.name} window: {len(reqs)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}), max_len {WIN_MAX_LEN}, ring "
          f"of {w} slots, {n_tok} new tokens in {dt:.3f}s "
          f"({n_tok / dt:.1f} tok/s) decode_steps={steps} decode_s="
          f"{eng._step.seconds:.3f} ({step_ms:.3f} ms/step) prefill_s="
          f"{prefill_s:.3f} ({calls} prefill calls) "
          f"flash_attention.launches={flash} row_gather.launches={rows} "
          f"({once} read-once) paged_gather.launches={pages} "
          f"cache_bytes_resident={eng.cache_bytes_resident} (the ring's "
          f"shapes; a contiguous {WIN_MAX_LEN} would hold {full_b})",
          flush=True)
    print("serve " + cfg.name + " window: prefill dispatch routes: " + ", ".join(
        f"{WIN_BATCH * n} token rows -> "
        f"{'read-once' if routes[n] else 'gather'}" for n in WIN_PROMPTS),
        flush=True)

    # the sequence-sharded combine over layer 0's wrapped ring (the last
    # step's cache: the 6,000-token group, 6,031 positions in 4,096 slots)
    kv = eng._step.last[1].kv
    k, v = kv.k[0], kv.v[0]
    gen = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn((WIN_BATCH, 1, cfg.num_heads, cfg.head_dim),
                    generator=gen, device="cuda")
    want_o = decode_attention(cfg, q, KVCache(k, v, kv.length, ring=True))
    valid = torch.arange(w, device="cuda") < min(kv.length, w)
    ws = w // 4
    parts = [partial_attention(q, k[:, i * ws:(i + 1) * ws],
                               v[:, i * ws:(i + 1) * ws],
                               valid[i * ws:(i + 1) * ws]) for i in range(4)]
    got = combine_partials(*(torch.stack(t) for t in zip(*parts)))
    err = (got - want_o).abs().max().item()
    check(bool(torch.allclose(got, want_o, atol=2e-5, rtol=2e-5)),
          f"sharded combine differs from decode_attention by {err:.3e}")
    print(f"serve {cfg.name} window: layer 0's ring ({kv.length} positions "
          f"in {w} slots, {k.dtype}) in 4 shards, partial_attention + "
          f"combine_partials vs decode_attention: max |diff| = {err:.3e} "
          f"(tol 2e-5)", flush=True)
    del kv, k, v, eng

    # exactness: until the ring wraps it computes what a contiguous cache
    # of the same shape does
    ref = ServeEngine(cfg, params, batch_size=WIN_BATCH,
                      max_len=WIN_EXACT_LEN, device="cuda")
    check(not ref._ring, "the contiguous reference took the ring")
    exact = ref.generate(make_requests(new=WIN_EXACT_NEW,
                                       lens=(WIN_PROMPTS[1],)))
    ring_toks = [r.generated[:WIN_EXACT_NEW].tolist() for r in reqs
                 if len(r.prompt) == WIN_PROMPTS[1]]
    check(ring_toks == [r.generated.tolist() for r in exact],
          f"the ring's first {WIN_EXACT_NEW} tokens {ring_toks} != the "
          f"contiguous {WIN_EXACT_LEN} run's "
          f"{[r.generated.tolist() for r in exact]}")
    print(f"serve {cfg.name} window: the {WIN_PROMPTS[1]}-token group's "
          f"first {WIN_EXACT_NEW} tokens equal a contiguous max_len "
          f"{WIN_EXACT_LEN} run's", flush=True)
    del ref
    prof = profile_decode(cfg, params, eng=ServeEngine(
        cfg, params, batch_size=WIN_BATCH, max_len=WIN_MAX_LEN,
        device="cuda"), make_requests=lambda: make_requests(
            new=20, lens=(WIN_PROMPTS[1],)))
    idle = f"{prof['idle']:.4f}" if prof else "not measured"
    print(f"serve {cfg.name} window: {step_ms:.3f} ms/decode step, "
          f"{n_tok / dt:.1f} tok/s, prefill_s={prefill_s:.3f}, idle share "
          f"{idle} (profile of 2 x {WIN_PROMPTS[1]} tokens, 20 new: the "
          f"ring wraps)", flush=True)
    torch.cuda.empty_cache()
    return dict(flash=flash, rows=rows, read_once=once)


def profile_run(what, run) -> dict:
    """Where ``run()``'s time goes on the card: ``torch.profiler`` over one
    call — device busy time, the device's idle share of the same call's
    wall time without the profiler, and the kernels by time. Measures only;
    the checks are done. ``what()`` names the run once it has run. Returns
    the port's kernels' device ms, ``busy_ms`` and the idle share ``idle``
    ({} when the profiler saw no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def wall() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms = wall()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = wall()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if busy_ms <= 0:
        print("profile: the profiler recorded no device time (not measured)",
              flush=True)
        return {}
    print(f"profile: {what()}: wall {wall_ms:.2f} ms ({prof_wall_ms:.2f} "
          f"under the profiler), device busy {busy_ms:.2f} ms, device idle "
          f"share {1 - busy_ms / wall_ms:.4f}; {sum(e.count for e in kern)} "
          f"kernel launches", flush=True)
    own = [(name, sum(e.self_device_time_total for e in kern
                      if sym in e.key) / 1e3)
           for name, sym in (("paged_gather", "paged_gather_kernel"),
                             ("flash_attention", "flash_fwd_"),
                             ("row_gather", "row_gather_kernel"),
                             ("ssd_chunk", "ssd_chunk_kernel"))]
    print("profile: the port's kernels: " + ", ".join(
        f"{name} {ms:.3f} ms = {ms / busy_ms:.4f} of device time"
        for name, ms in own), flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d} x {e.self_device_time_total / max(e.count, 1):8.2f}"
              f" us  {e.key[:90]}", flush=True)
    return dict(own, busy_ms=busy_ms, idle=1 - busy_ms / wall_ms)


def profile_decode(cfg, params, eng=None, make_requests=None) -> dict:
    """:func:`profile_run` over a short serve run (by default paged, 4
    requests, 16 new tokens each)."""
    from repro_torch.serve.engine import ServeEngine

    if eng is None:
        eng = ServeEngine(cfg, params, batch_size=BATCH, max_len=MAX_LEN,
                          device="cuda", paged=True, page_size=PAGE_SIZE)
    if make_requests is None:
        def make_requests():
            reqs = _requests(cfg.vocab_size)[:BATCH]
            for r in reqs:
                r.max_new_tokens = 16
            return reqs
    probe = make_requests()
    layout = "paged" if eng._paged else "contiguous"
    return profile_run(
        lambda: f"{layout} {cfg.name}, {len(probe)} requests x "
                f"{probe[0].max_new_tokens} tokens, {eng.decode_steps} "
                f"decode steps", lambda: eng.generate(make_requests()))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_reference() -> None:
    """The same paged prefill + decode on the card and on the CPU (f32):
    the CPU run decodes greedily, the card is fed the CPU's tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.transformer import (Model, init_paged_cache,
                                                init_params)

    cfg = get_config("olmo-1b-smoke")
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    b, s, ps, max_len, steps = 4, 20, 8, 64, 4
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    start = torch.tensor([0, 5, 11, 19], dtype=torch.int32)
    table = torch.arange(1, 1 + b * (max_len // ps),
                         dtype=torch.int32).reshape(b, -1)
    model = Model(cfg)
    logits = {}
    feeds = []
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            p = _to(params, dev)
            cache = init_paged_cache(cfg, b, max_len, page_size=ps,
                                     num_pages=1 + table.numel(),
                                     dtype=torch.float32, device=dev)
            cache.kv.table.copy_(table)
            st = start.to(dev)
            flash_attention.launches = 0
            out, _, cache = model.forward(p, {"tokens": tokens.to(dev)},
                                          cache=cache, start=st)
            if dev == "cuda":
                check(flash_attention.launches == cfg.num_layers,
                      f"the card's prefill launched flash_attention "
                      f"{flash_attention.launches} times, want "
                      f"{cfg.num_layers}")
            seq = [out[:, -1:].cpu()]
            for t in range(steps):
                if dev == "cpu":
                    feeds.append(seq[-1].argmax(-1).to(torch.int32))
                out, cache = model.decode_step(p, feeds[t].to(dev), cache,
                                               start=st)
                seq.append(out.cpu())
            logits[dev] = seq
    worst = 0.0
    for a, c in zip(logits["cpu"], logits["cuda"]):
        check(bool(torch.isfinite(c).all()), "non-finite logits on the card")
        worst = max(worst, (a - c).abs().max().item())
        check(torch.allclose(c, a, atol=1e-4, rtol=1e-4),
              f"card logits differ from the CPU's by {worst:.3e}")
    print(f"reference: olmo-1b-smoke f32 paged prefill (flash kernel, "
          f"{cfg.num_layers} launches) + {steps} decode steps, card vs CPU "
          f"max |logit diff| = {worst:.3e} (tol 1e-4)", flush=True)


def phase_moe_reference() -> None:
    """mixtral-8x22b-smoke f32: the same paged prefill + greedy decode on
    the card and on the CPU, at the config's capacity and at a dropping
    one; every routing table of every layer and call recorded on both."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gather import row_gather
    from repro_torch.models import moe
    from repro_torch.models.transformer import (Model, init_paged_cache,
                                                init_params)

    base = get_config("mixtral-8x22b-smoke")
    b, s, ps, max_len, steps = 4, 20, 8, 64, 4
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(
        rng.integers(0, base.vocab_size, (b, s)).astype(np.int32))
    start = torch.tensor([0, 6, 13, 19], dtype=torch.int32)
    table = torch.arange(1, 1 + b * (max_len // ps),
                         dtype=torch.int32).reshape(b, -1)
    tables = moe.dispatch_tables

    def recording(log):
        def wrapped(eidx, num_experts, cap, **kw):
            disp, comb, asg = tables(eidx, num_experts, cap, **kw)
            log.append((eidx.cpu(), comb.cpu()))
            return disp, comb, asg
        return wrapped

    for cf in (base.moe.capacity_factor_eval, 0.5):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor_eval=cf))
        params = init_params(cfg, 0, device="cpu")
        model = Model(cfg)
        runs = {}
        try:
            for dev in ("cpu", "cuda"):
                log = []
                moe.dispatch_tables = recording(log)
                p = _to(params, dev)
                cache = init_paged_cache(cfg, b, max_len, page_size=ps,
                                         num_pages=1 + table.numel(),
                                         dtype=torch.float32, device=dev)
                cache.kv.table.copy_(table)
                st = start.to(dev)
                row_gather.launches = 0
                with torch.inference_mode():
                    out, _, cache = model.forward(
                        p, {"tokens": tokens.to(dev)}, cache=cache, start=st)
                    seq, toks = [out[:, -1:].cpu()], []
                    for _ in range(steps):
                        toks.append(seq[-1].argmax(-1).to(torch.int32))
                        out, cache = model.decode_step(p, toks[-1].to(dev),
                                                       cache, start=st)
                        seq.append(out.cpu())
                if dev == "cuda":
                    torch.cuda.synchronize()
                    want = 2 * cfg.num_layers * (1 + steps)
                    check(row_gather.launches == want,
                          f"the card's MoE run launched row_gather "
                          f"{row_gather.launches} times, want {want}")
                runs[dev] = (seq, toks, log)
        finally:
            moe.dispatch_tables = tables
        (sc, tc, lc), (sg, tg, lg) = runs["cpu"], runs["cuda"]
        check(len(lc) == len(lg) == cfg.num_layers * (1 + steps),
              f"{len(lc)}/{len(lg)} routing tables recorded")
        dropped = 0
        for i, ((ec, cc), (eg, cg)) in enumerate(zip(lc, lg)):
            check(torch.equal(ec, eg), f"call/layer {i}: the card routed "
                  f"tokens to other experts than the CPU")
            check(torch.equal(cc, cg), f"call/layer {i}: the card kept "
                  f"other assignments (or slots) than the CPU")
            dropped += int((cc < 0).sum())
        check(dropped > 0 or cf == base.moe.capacity_factor_eval,
              f"capacity_factor_eval {cf} dropped no assignment")
        worst = 0.0
        for a, c in zip(sc, sg):
            check(bool(torch.isfinite(c).all()),
                  "non-finite MoE logits on the card")
            worst = max(worst, (a - c).abs().max().item())
            check(torch.allclose(c, a, atol=1e-4, rtol=1e-4),
                  f"card MoE logits differ from the CPU's by {worst:.3e}")
        check(all(torch.equal(a, c) for a, c in zip(tc, tg)),
              "greedy tokens differ between the card and the CPU")
        print(f"MoE reference: mixtral-8x22b-smoke f32 capacity_factor_eval="
              f"{cf}: paged prefill + {steps} greedy decode steps, card vs "
              f"CPU: {len(lc)} routing tables identical ({dropped} "
              f"assignments dropped), greedy tokens identical, max |logit "
              f"diff| = {worst:.3e} (tol 1e-4); row_gather launched "
              f"{2 * cfg.num_layers * (1 + steps)} times on the card",
              flush=True)


def ssd_work(x, B, chunk) -> tuple:
    """(FLOPs, bytes) the intra-chunk step needs: per (batch, head, chunk)
    of c rows, the c(c+1)/2 causal (i, j) pairs at 2n FLOPs for C B^T and
    2p for W x, and 2 c n p for the state; x, dt, cum, B, C read once, y
    and the states written once (f32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    flops = b * h * nc * (pairs * 2 * (n + p) + 2 * chunk * n * p)
    nbytes = (x.numel() + 2 * B.numel()) * x.element_size() + \
        2 * b * s * h * 4 + b * s * h * p * 4 + b * nc * h * n * p * 4
    return flops, nbytes


def _ssd_inputs(dtype, b, s, h, p, g, n, chunk, gen):
    """x/B/C ~ N(0,1) in ``dtype``; dt in softplus(dt_bias)'s range
    [1e-3, 0.1]; cum the per-chunk cumsum of dt * A, A in [-16, -1]."""
    import torch
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    dt = 1e-3 + 0.099 * torch.rand((b, s, h), generator=gen, device="cuda")
    A = -1.0 - 15.0 * torch.rand((h,), generator=gen, device="cuda")
    cum = (dt * A).reshape(b, s // chunk, chunk, h).cumsum(2).reshape(b, s, h)
    B = torch.randn((b, s, g, n), generator=gen, device="cuda").to(dtype)
    C = torch.randn((b, s, g, n), generator=gen, device="cuda").to(dtype)
    return x, dt, cum, B, C


def phase_ssd() -> dict:
    """The SSD intra-chunk kernel against its plain version (see 6d)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_plain

    gen = torch.Generator(device="cuda").manual_seed(5)
    res = {"max_abs_err": 0.0}
    for name, dt_name, (b, s, h, p, g, n, chunk), timed in SSD_CASES:
        args = _ssd_inputs(getattr(torch, dt_name), b, s, h, p, g, n, chunk,
                           gen)
        n0 = ssd_chunk.launches
        y, st = ssd_chunk(*args, chunk)
        y2, st2 = ssd_chunk(*args, chunk)
        torch.cuda.synchronize()
        what = (f"ssd_chunk ({name}) x/B/C {dt_name} (b,s,h,p)=({b},{s},{h},"
                f"{p}) g={g} n={n} chunk={chunk}")
        check(ssd_chunk.launches == n0 + 2,
              f"{what}: 2 calls counted {ssd_chunk.launches - n0}")
        check(torch.equal(_bits(y), _bits(y2)) and
              torch.equal(_bits(st), _bits(st2)),
              f"{what}: a second launch gave other bits")
        check(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
              f"{what}: non-finite output")
        wy, wst = ssd_chunk_plain(*args, chunk)
        errs = []
        for out, want, label in ((y, wy, "y"), (st, wst, "states")):
            tol = 2e-5 * max(1.0, want.abs().max().item())
            err = (out - want).abs().max().item()
            check(err <= tol, f"{what}: {label} err {err:.3e} > tol "
                  f"{tol:.3e} (2e-5 x max(1, max|plain|))")
            errs.append(f"{label} err {err:.3e} (tol {tol:.3e})")
            res["max_abs_err"] = max(res["max_abs_err"], err)
        print(f"kernel {what}: {', '.join(errs)} [vs plain f32, TF32 off]; "
              f"second launch bit-equal", flush=True)
        del wy, wst, y2, st2
        if timed:
            kernel_ms = time_ms(lambda i: ssd_chunk(*args, chunk), n_iter=20,
                                reps=3)
            plain_ms = time_ms(lambda i: ssd_chunk_plain(*args, chunk),
                               n_iter=3, reps=2)
            host_ms = eager_ms(lambda i: ssd_chunk(*args, chunk), n_iter=50)
            flops, nbytes = ssd_work(args[0], args[3], chunk)
            flop_ms = flops / BF16_FLOPS_PER_S * 1e3
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(flop_ms, byte_ms)
            bound_by = "operations" if flop_ms > byte_ms else "bytes"
            res[name] = dict(ms=kernel_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
            print(f"kernel ssd_chunk ({name}) times: kernel_ms="
                  f"{kernel_ms:.5f} plain_ms={plain_ms:.5f} library_ms=none "
                  f"bound_ms={bound_ms:.5f} ({bound_by}: {nbytes} B -> "
                  f"{byte_ms:.5f} ms, {flops} causal FLOPs -> {flop_ms:.5f} "
                  f"ms at 989 TFLOP/s; {bound_ms / kernel_ms:.4f} of the "
                  f"bound, {flops / kernel_ms / 1e9:.2f} TFLOP/s); eager "
                  f"call incl. host {host_ms:.5f} ms", flush=True)
        del args, y, st
    torch.cuda.empty_cache()
    return res


def phase_ssm_serve() -> int:
    """Full-width mamba2-780m through the grouped engine (see 6e); returns
    the run's SSD kernel launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config(SSM_ARCH),
                              num_layers=SSM_SERVE_LAYERS)
    t0 = time.time()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    c = cfg.ssm
    print(f"SSM serve: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"d_inner={c.d_inner(cfg.d_model)} heads={c.num_heads(cfg.d_model)}"
          f"x{c.head_dim} d_state={c.d_state} chunk={c.chunk_size} "
          f"vocab={cfg.vocab_size} tied={cfg.tie_embeddings} "
          f"params={cfg.param_count() / 1e9:.3f}B {cfg.param_dtype} (init "
          f"{time.time() - t0:.1f}s, {torch.cuda.memory_allocated()} B on "
          f"the card)", flush=True)
    rng = np.random.default_rng(8)

    def make_requests(max_new=MAX_NEW):
        return [Request(prompt=rng.integers(0, cfg.vocab_size, (n,),
                                            dtype=np.int32),
                        max_new_tokens=max_new) for n in SSM_PROMPTS]

    eng = ServeEngine(cfg, params, batch_size=BATCH, max_len=SSM_MAX_LEN,
                      device="cuda", paged=True)
    check(not eng._paged, "the SSM engine took the paged path")
    eng.generate([Request(prompt=r.prompt[:64], max_new_tokens=2)
                  for r in make_requests()[:2]])            # warm-up
    reqs = make_requests()
    eng._prefill, eng._step = _Timed(eng._prefill), _Timed(eng._step)
    torch.cuda.synchronize()
    ssd_chunk.launches = flash_attention.launches = 0
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, flash = ssd_chunk.launches, flash_attention.launches
    n_tok = sum(len(r.generated) for r in reqs)
    for i, r in enumerate(reqs):
        g = r.generated
        check(len(g) == MAX_NEW, f"SSM request {i} made {len(g)} tokens, "
              f"want {MAX_NEW}")
        check(bool(((g >= 0) & (g < cfg.vocab_size)).all()),
              f"SSM request {i} has out-of-range ids")
    steps, calls = eng.decode_steps, eng._prefill.calls
    check(calls == 2 and steps == 2 * (MAX_NEW - 1),
          f"SSM run: {calls} prefill calls and {steps} decode steps, want 2 "
          f"and {2 * (MAX_NEW - 1)}")
    want = cfg.num_layers * calls
    check(launches == want, f"SSM run launched ssd_chunk {launches} times, "
          f"want {cfg.num_layers} x {calls} prefill calls = {want}")
    check(flash == 0, f"the SSM run launched flash_attention {flash} times")
    step_ms = eng._step.seconds / steps * 1e3
    print(f"SSM serve {cfg.name}: {len(reqs)} requests (prompts "
          f"{list(SSM_PROMPTS)}), {n_tok} new tokens in {dt:.3f}s "
          f"({n_tok / dt:.1f} tok/s) decode_steps={steps} decode_s="
          f"{eng._step.seconds:.3f} ({step_ms:.3f} ms/step) prefill_s="
          f"{eng._prefill.seconds:.3f} ({calls} prefill calls) "
          f"ssd_chunk.launches={launches} "
          f"cache_bytes_resident={eng.cache_bytes_resident}", flush=True)
    prof = profile_decode(cfg, params, eng=ServeEngine(
        cfg, params, batch_size=BATCH, max_len=SSM_MAX_LEN, device="cuda"),
        make_requests=lambda: make_requests(max_new=8))
    share = (f"{prof['ssd_chunk'] / prof['busy_ms']:.4f} of the profiled "
             f"run's device time ({prof['ssd_chunk']:.3f} of "
             f"{prof['busy_ms']:.3f} ms)") if prof else "not measured"
    print(f"SSM serve {cfg.name}: prefill_s={eng._prefill.seconds:.3f} "
          f"({calls} prefill calls, {launches} SSD launches); the SSD "
          f"kernel's share: {share}", flush=True)
    del params, eng
    torch.cuda.empty_cache()
    return launches


def phase_ssm_reference() -> None:
    """mamba2-780m-smoke f32 on the card against the CPU (see 6f)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_chunk
    from repro_torch.models.transformer import Model, init_cache, init_params
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config("mamba2-780m-smoke")
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(9)
    b, s, steps = 4, 50, 4
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
               for n in (9, 50, 9, 9, 33)]
    model = Model(cfg)
    runs = []
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            p = _to(params, dev)
            cache = init_cache(cfg, b, 64, dtype=torch.float32, device=dev)
            ssd_chunk.launches = 0
            out, _, cache = model.forward(p, {"tokens": tokens.to(dev)},
                                          cache=cache)
            if dev == "cuda":
                torch.cuda.synchronize()
                check(ssd_chunk.launches == cfg.num_layers,
                      f"the card's SSM prefill launched ssd_chunk "
                      f"{ssd_chunk.launches} times, want {cfg.num_layers}")
            seq, toks = [out[:, -1:].cpu()], []
            for _ in range(steps):
                toks.append(seq[-1].argmax(-1).to(torch.int32))
                out, cache = model.decode_step(p, toks[-1].to(dev), cache)
                seq.append(out.cpu())
            eng = ServeEngine(cfg, p, batch_size=2, max_len=64, device=dev)
            done = eng.generate([Request(prompt=q, max_new_tokens=8)
                                 for q in prompts])
            runs.append((seq, toks, [r.generated.tolist() for r in done]))
    (sc, tc, ec), (sg, tg, eg) = runs
    worst = 0.0
    for a, c in zip(sc, sg):
        check(bool(torch.isfinite(c).all()), "non-finite SSM logits on the "
              "card")
        worst = max(worst, (a - c).abs().max().item())
        check(torch.allclose(c, a, atol=1e-4, rtol=1e-4),
              f"card SSM logits differ from the CPU's by {worst:.3e}")
    check(all(torch.equal(a, c) for a, c in zip(tc, tg)),
          "SSM greedy tokens differ between the card and the CPU")
    check(ec == eg, f"SSM engine tokens differ: card {eg} vs CPU {ec}")
    print(f"SSM reference: mamba2-780m-smoke f32 prefill of {b} x {s} "
          f"tokens (padded to 64: 2 chunks; ssd_chunk launched "
          f"{cfg.num_layers} times on the card) + {steps} greedy decode "
          f"steps, card vs CPU: greedy tokens identical, max |logit diff| = "
          f"{worst:.3e} (tol 1e-4); grouped engine on prompts "
          f"{[len(q) for q in prompts]} (3 groups, one split): tokens "
          f"identical", flush=True)


def phase_hybrid_serve() -> dict:
    """Full-width zamba2-7b through the grouped engine (see 6h); returns
    the run's SSD and flash launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gather import row_gather
    from repro_torch.kernels.paged_kv import paged_gather
    from repro_torch.kernels.ssd_scan import ssd_chunk
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config(HYB_ARCH),
                              num_layers=HYB_SERVE_LAYERS)
    t0 = time.time()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    c, L = cfg.ssm, cfg.num_layers
    sites = L // cfg.hybrid_attn_every
    d_in, h = c.d_inner(cfg.d_model), c.num_heads(cfg.d_model)
    print(f"hybrid serve: {cfg.name} L={L} d={cfg.d_model} d_inner={d_in} "
          f"heads={h}x{c.head_dim} d_state={c.d_state} g={c.ngroups} "
          f"chunk={c.chunk_size}; {sites} shared-attention sites (every "
          f"{cfg.hybrid_attn_every} layers, {L % cfg.hybrid_attn_every} "
          f"remainder) of {cfg.num_heads} heads x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}; vocab={cfg.vocab_size} params="
          f"{cfg.param_count() / 1e9:.3f}B {cfg.param_dtype} (init "
          f"{time.time() - t0:.1f}s, {torch.cuda.memory_allocated()} B on "
          f"the card)", flush=True)
    rng = np.random.default_rng(11)

    def make_requests(max_new=MAX_NEW):
        return [Request(prompt=rng.integers(0, cfg.vocab_size, (n,),
                                            dtype=np.int32),
                        max_new_tokens=max_new) for n in SSM_PROMPTS]

    eng = ServeEngine(cfg, params, batch_size=BATCH, max_len=HYB_MAX_LEN,
                      device="cuda", paged=True)
    check(not eng._paged and not eng._ring,
          "the hybrid engine took the paged path or a ring")
    eng.generate([Request(prompt=r.prompt[:64], max_new_tokens=2)
                  for r in make_requests()[:2]])            # warm-up
    reqs = make_requests()
    eng._prefill, eng._step = _Timed(eng._prefill), _Timed(eng._step)
    torch.cuda.synchronize()
    ssd_chunk.launches = flash_attention.launches = 0
    row_gather.launches = paged_gather.launches = 0
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, flash = ssd_chunk.launches, flash_attention.launches
    others = row_gather.launches + paged_gather.launches
    n_tok = sum(len(r.generated) for r in reqs)
    for i, r in enumerate(reqs):
        g = r.generated
        check(len(g) == MAX_NEW and bool(
            ((g >= 0) & (g < cfg.vocab_size)).all()),
            f"hybrid request {i} made {g.tolist()}")
    steps, calls = eng.decode_steps, eng._prefill.calls
    check(calls == 2 and steps == 2 * (MAX_NEW - 1),
          f"hybrid run: {calls} prefill calls and {steps} decode steps, "
          f"want 2 and {2 * (MAX_NEW - 1)}")
    check(launches == L * calls, f"hybrid run launched ssd_chunk "
          f"{launches} times, want {L} x {calls} prefill calls")
    check(flash == sites * calls, f"hybrid run launched flash_attention "
          f"{flash} times, want {sites} x {calls} prefill calls")
    check(others == 0, f"hybrid run launched a row or page gather "
          f"{others} times")
    # f32 cache: K and V of every site, the SSD state and conv tail of
    # every layer, the two int32 cursors
    kv_b = sites * 2 * BATCH * HYB_MAX_LEN * cfg.num_kv_heads * \
        cfg.head_dim * 4
    ssd_b = L * BATCH * h * c.d_state * c.head_dim * 4
    conv_b = L * BATCH * (c.conv_width - 1) * (
        d_in + 2 * c.ngroups * c.d_state) * 4
    want_b = kv_b + ssd_b + conv_b + 8
    check(eng.cache_bytes_resident == want_b,
          f"hybrid run: cache_bytes_resident {eng.cache_bytes_resident}, "
          f"the shapes give {want_b}")
    step_ms = eng._step.seconds / steps * 1e3
    prefill_s = eng._prefill.seconds
    print(f"hybrid serve {cfg.name}: {len(reqs)} requests (prompts "
          f"{list(SSM_PROMPTS)}), {n_tok} new tokens in {dt:.3f}s "
          f"({n_tok / dt:.1f} tok/s) decode_steps={steps} decode_s="
          f"{eng._step.seconds:.3f} ({step_ms:.3f} ms/step) prefill_s="
          f"{prefill_s:.3f} ({calls} prefill calls) ssd_chunk.launches="
          f"{launches} flash_attention.launches={flash} "
          f"cache_bytes_resident={eng.cache_bytes_resident} (KV {kv_b} + "
          f"SSD state {ssd_b} + conv {conv_b} + 8)", flush=True)
    prof = profile_decode(cfg, params, eng=ServeEngine(
        cfg, params, batch_size=BATCH, max_len=HYB_MAX_LEN, device="cuda"),
        make_requests=lambda: make_requests(max_new=8))
    share = (f"idle share {prof['idle']:.4f}; SSD "
             f"{prof['ssd_chunk'] / prof['busy_ms']:.4f} and flash "
             f"{prof['flash_attention'] / prof['busy_ms']:.4f} of the "
             f"profiled run's device time ({prof['ssd_chunk']:.3f} and "
             f"{prof['flash_attention']:.3f} of {prof['busy_ms']:.3f} ms)"
             ) if prof else "not measured"
    print(f"hybrid serve {cfg.name}: {step_ms:.3f} ms/decode step, "
          f"{n_tok / dt:.1f} tok/s, prefill_s={prefill_s:.3f}; {share}",
          flush=True)
    del params, eng
    torch.cuda.empty_cache()
    return dict(ssd=launches, flash=flash)


def phase_family_references() -> None:
    """mixtral-8x22b-smoke past its window of 64, zamba2-7b-smoke at 5
    layers, phi-3-vision-4.2b-smoke, musicgen-large-smoke, gemma-2b-smoke,
    command-r-35b-smoke and arctic-480b-smoke, f32, on the card against
    the CPU (see 6i)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk
    from repro_torch.models.transformer import Model, init_cache, init_params
    from repro_torch.serve.engine import Request, ServeEngine

    hyb = get_config("zamba2-7b-smoke")
    b, steps = 2, 8
    # name, config, prefill positions, max_len, the engine's prompt lengths
    # (none: the engine refuses a VLM), new tokens
    cases = (("ring", get_config("mixtral-8x22b-smoke"), 80, 160,
              (80, 40, 80), 32),
             ("hybrid", dataclasses.replace(hyb, num_layers=5), 40, 96,
              (40, 9, 40, 5), 16),
             ("VLM", get_config("phi-3-vision-4.2b-smoke"), 40, 64, (), 0),
             ("audio", get_config("musicgen-large-smoke"), 40, 64,
              (24, 9, 24, 5), 6),
             ("one KV head", get_config("gemma-2b-smoke"), 40, 64,
              (24, 9, 24, 5), 6),
             ("parallel block", get_config("command-r-35b-smoke"), 40, 64,
              (24, 9, 24, 5), 6),
             ("dense residual MoE", get_config("arctic-480b-smoke"), 40, 64,
              (24, 9, 24, 5), 6))
    for name, cfg, s, max_len, lens, new in cases:
        params = init_params(cfg, 0, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
            cfg, b, s, seed=15).items() if k != "labels"}
        rng = np.random.default_rng(12)
        lead = (cfg.num_codebooks,) if cfg.modality == "audio" else ()
        prompts = [rng.integers(0, cfg.vocab_size, lead + (n,),
                                dtype=np.int32) for n in lens]
        sites = (cfg.num_layers // cfg.hybrid_attn_every
                 if cfg.family == "hybrid" else cfg.num_layers)
        model = Model(cfg)
        runs = []
        for dev in ("cpu", "cuda"):
            p = _to(params, dev)
            cache = init_cache(cfg, b, max_len, dtype=torch.float32,
                               device=dev)
            flash_attention.launches = ssd_chunk.launches = 0
            with torch.inference_mode():
                out, _, cache = model.forward(p, _to(batch, dev), cache=cache)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    want = (sites, cfg.num_layers if name == "hybrid" else 0)
                    got = (flash_attention.launches, ssd_chunk.launches)
                    check(got == want, f"{name} reference: the card's "
                          f"prefill launched (flash, ssd) {got}, want {want}")
                seq, toks = [out[..., -1:, :].cpu()], []
                for _ in range(steps):
                    toks.append(seq[-1].argmax(-1).to(torch.int32))
                    out, cache = model.decode_step(p, toks[-1].to(dev), cache)
                    seq.append(out.cpu())
            check(cache.kv.ring == (name == "ring") and
                  cache.length == s + steps,
                  f"{name} reference: ring={cache.kv.ring}, length "
                  f"{cache.length}")
            done, nbytes = [], None
            if prompts:
                eng = ServeEngine(cfg, p, batch_size=2, max_len=max_len,
                                  device=dev)
                done = [r.generated.tolist() for r in eng.generate(
                    [Request(prompt=q, max_new_tokens=new) for q in prompts])]
                nbytes = eng.cache_bytes_resident
            runs.append((seq, toks, done, nbytes))
        (sc, tc, ec, bc), (sg, tg, eg, bg) = runs
        worst = 0.0
        for a, c in zip(sc, sg):
            check(bool(torch.isfinite(c).all()),
                  f"non-finite {name} logits on the card")
            worst = max(worst, (a - c).abs().max().item())
            check(torch.allclose(c, a, atol=1e-4, rtol=1e-4),
                  f"card {name} logits differ from the CPU's by {worst:.3e}")
        check(all(torch.equal(a, c) for a, c in zip(tc, tg)),
              f"{name} greedy tokens differ between the card and the CPU")
        check(ec == eg, f"{name} engine tokens differ: card {eg} vs CPU {ec}")
        check(bc == bg, f"{name} engine cache bytes: card {bg} vs CPU {bc}")
        what = {"vlm": f"({cfg.num_patches} patches + "
                       f"{s - cfg.num_patches} text tokens)",
                "audio": f"({s} frames of {cfg.num_codebooks} codebooks)"
                }.get(cfg.modality, f"{s} tokens")
        engine = (f"grouped engine on prompts {list(lens)}, {new} new tokens:"
                  f" tokens identical, cache_bytes_resident {bg}" if prompts
                  else "no engine run (the engine refuses a VLM)")
        print(f"{name} reference: {cfg.name} L={cfg.num_layers} f32 prefill "
              f"of {b} x {what} (window {cfg.sliding_window}, max_len "
              f"{max_len}) + {steps} greedy decode steps, card vs CPU: "
              f"greedy tokens identical, max |logit diff| = {worst:.3e} "
              f"(tol 1e-4); {engine}", flush=True)


def _mm_header(cfg, t0) -> str:
    import torch
    extra = (f"{cfg.num_patches} patches of 1,024, "
             if cfg.modality == "vlm" else
             f"{cfg.num_codebooks} codebooks, {cfg.norm}, {cfg.hidden_act}, "
             f"bias={cfg.use_bias}, ")
    return (f"{cfg.name} L={cfg.num_layers} d={cfg.d_model} "
            f"H={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
            f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} {extra}params="
            f"{cfg.param_count() / 1e9:.3f}B {cfg.param_dtype} (init "
            f"{time.time() - t0:.1f}s, {torch.cuda.memory_allocated()} B on "
            f"the card)")


def _kv_bytes(cfg, batch: int, max_len: int) -> int:
    """An f32 contiguous cache's K and V, every layer."""
    return 2 * cfg.num_layers * batch * max_len * cfg.num_kv_heads * \
        cfg.head_dim * 4


def phase_vlm_serve() -> int:
    """Full-width phi-3-vision-4.2b through ``make_prefill`` +
    ``make_serve_step`` (see 6j); returns the run's flash launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gather import row_gather
    from repro_torch.kernels.paged_kv import paged_gather
    from repro_torch.kernels.ssd_scan import ssd_chunk
    from repro_torch.models.transformer import (IMG_EMBED_DIM, init_cache,
                                                init_params)
    from repro_torch.serve.engine import make_prefill, make_serve_step

    cfg = get_config(VLM_ARCH)
    t0 = time.time()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"VLM serve: {_mm_header(cfg, t0)}", flush=True)
    rng = np.random.default_rng(13)
    b, p = BATCH, cfg.num_patches
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, VLM_TEXT), dtype=np.int32)).cuda(),
        "image_embeds": torch.from_numpy(rng.standard_normal(
            (b, p, IMG_EMBED_DIM)).astype(np.float32)).cuda()}
    prefill = _Timed(make_prefill(cfg))
    step = _Timed(make_serve_step(cfg))

    def run(rows: int, steps: int):
        part = {k: v[:rows] for k, v in batch.items()}
        cache = init_cache(cfg, rows, MM_MAX_LEN, dtype=torch.float32,
                           device="cuda")
        nxt, cache = prefill(params, part, cache)
        toks = [nxt]
        for _ in range(steps):
            nxt, cache = step(params, nxt, cache)
            toks.append(nxt)
        return torch.cat(toks, 1).cpu().numpy(), cache

    with torch.inference_mode():
        run(1, 2)                                           # warm-up
        prefill.seconds = step.seconds = 0.0
        torch.cuda.synchronize()
        flash_attention.launches = row_gather.launches = 0
        paged_gather.launches = ssd_chunk.launches = 0
        t0 = time.perf_counter()
        cache = init_cache(cfg, b, MM_MAX_LEN, dtype=torch.float32,
                           device="cuda")
        nxt, cache = prefill(params, batch, cache)
        flash = flash_attention.launches
        others = row_gather.launches + paged_gather.launches + \
            ssd_chunk.launches
        check(flash == cfg.num_layers and others == 0,
              f"VLM prefill launched flash {flash} times and a row, page or "
              f"SSD kernel {others} times, want {cfg.num_layers} and 0")
        check(cache.length == cache.kv.length == p + VLM_TEXT,
              f"VLM cache length {cache.length} after the prefill, want "
              f"{p + VLM_TEXT}")
        kv_b = _kv_bytes(cfg, b, MM_MAX_LEN)
        check(cache.nbytes() == kv_b + 8, f"VLM cache bytes "
              f"{cache.nbytes()}, the shapes give {kv_b} + 8")
        toks = [nxt]
        for _ in range(VLM_STEPS):
            nxt, cache = step(params, nxt, cache)
            toks.append(nxt)
        toks = torch.cat(toks, 1).cpu().numpy()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    decode_flash = flash_attention.launches
    others = row_gather.launches + paged_gather.launches + ssd_chunk.launches
    check(decode_flash == flash and others == 0,
          f"VLM decode steps launched flash {decode_flash - flash} times and "
          f"a row, page or SSD kernel {others} times, want 0 and 0")
    check(toks.shape == (b, VLM_STEPS + 1) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all()),
        f"VLM tokens {toks.shape}: {toks[:, :8].tolist()}")
    check(cache.length == p + VLM_TEXT + VLM_STEPS,
          f"VLM cache length {cache.length} after the steps")
    n_tok = toks.size
    step_ms = step.seconds / VLM_STEPS * 1e3
    prefill_s = prefill.seconds
    print(f"VLM serve {cfg.name}: {b} rows of {p} patches + {VLM_TEXT} text "
          f"tokens, prefill + {VLM_STEPS} greedy decode steps, {n_tok} "
          f"tokens in {dt:.3f}s ({n_tok / dt:.1f} tok/s) prefill_s="
          f"{prefill_s:.3f} decode_s={step.seconds:.3f} "
          f"({step_ms:.3f} ms/step) flash_attention.launches={flash} (all "
          f"in the prefill call) cache bytes {cache.nbytes()} (KV {kv_b} + "
          f"8); first tokens {toks[0, :8].tolist()}", flush=True)
    del cache
    with torch.inference_mode():
        prof = profile_run(
            lambda: f"VLM {cfg.name}, {b} rows, prefill of "
                    f"{p + VLM_TEXT} positions + 8 decode steps",
            lambda: run(b, 8))
    print(f"VLM serve {cfg.name}: {step_ms:.3f} ms/decode step, "
          f"{n_tok / dt:.1f} tok/s, prefill_s={prefill_s:.3f}; "
          + _shares(prof), flush=True)
    del params
    torch.cuda.empty_cache()
    return flash


def _shares(prof) -> str:
    if not prof:
        return "idle share not measured"
    return (f"idle share {prof['idle']:.4f}; flash "
            f"{prof['flash_attention'] / prof['busy_ms']:.4f} of the profiled "
            f"run's device time ({prof['flash_attention']:.3f} of "
            f"{prof['busy_ms']:.3f} ms)")


def phase_audio_serve() -> int:
    """Full-width musicgen-large through the grouped engine (see 6k);
    returns the run's flash launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gather import row_gather
    from repro_torch.kernels.paged_kv import paged_gather
    from repro_torch.kernels.ssd_scan import ssd_chunk
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config(AUDIO_ARCH),
                              num_layers=AUDIO_SERVE_LAYERS)
    t0 = time.time()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"audio serve: {_mm_header(cfg, t0)}", flush=True)
    rng = np.random.default_rng(14)
    k = cfg.num_codebooks

    def make_requests(max_new=MAX_NEW):
        return [Request(prompt=rng.integers(0, cfg.vocab_size, (k, n),
                                            dtype=np.int32),
                        max_new_tokens=max_new) for n in AUDIO_PROMPTS]

    eng = ServeEngine(cfg, params, batch_size=BATCH, max_len=MM_MAX_LEN,
                      device="cuda", paged=True)
    check(not eng._paged and not eng._ring,
          "the audio engine took the paged path or a ring")
    eng.generate([Request(prompt=r.prompt[:, :64], max_new_tokens=2)
                  for r in make_requests()[:2]])            # warm-up
    reqs = make_requests()
    eng._prefill, eng._step = _Timed(eng._prefill), _Timed(eng._step)
    torch.cuda.synchronize()
    flash_attention.launches = row_gather.launches = 0
    paged_gather.launches = ssd_chunk.launches = 0
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    flash = flash_attention.launches
    others = row_gather.launches + paged_gather.launches + ssd_chunk.launches
    for i, r in enumerate(reqs):
        g = r.generated
        check(g.shape == (k, MAX_NEW) and bool(
            ((g >= 0) & (g < cfg.vocab_size)).all()),
            f"audio request {i} made {g.shape}: {g[:, :8].tolist()}")
    steps, calls = eng.decode_steps, eng._prefill.calls
    check(calls == 2 and steps == 2 * (MAX_NEW - 1),
          f"audio run: {calls} prefill calls and {steps} decode steps, "
          f"want 2 and {2 * (MAX_NEW - 1)}")
    check(flash == cfg.num_layers * calls, f"audio run launched "
          f"flash_attention {flash} times, want {cfg.num_layers} x {calls} "
          f"prefill calls")
    check(others == 0, f"audio run launched a row, page or SSD kernel "
          f"{others} times")
    kv_b = _kv_bytes(cfg, BATCH, MM_MAX_LEN)
    check(eng.cache_bytes_resident == kv_b + 8,
          f"audio run: cache_bytes_resident {eng.cache_bytes_resident}, "
          f"the shapes give {kv_b} + 8")
    n_tok = sum(r.generated.size for r in reqs)
    frames = sum(r.generated.shape[-1] for r in reqs)
    step_ms = eng._step.seconds / steps * 1e3
    prefill_s = eng._prefill.seconds
    print(f"audio serve {cfg.name}: {len(reqs)} requests (prompts of {k} x "
          f"{list(AUDIO_PROMPTS)} frames), {frames} new frames = {n_tok} "
          f"tokens in {dt:.3f}s ({n_tok / dt:.1f} tok/s, {frames / dt:.1f} "
          f"frames/s) decode_steps={steps} decode_s={eng._step.seconds:.3f} "
          f"({step_ms:.3f} ms/step) prefill_s={prefill_s:.3f} ({calls} "
          f"prefill calls) flash_attention.launches={flash} "
          f"cache_bytes_resident={eng.cache_bytes_resident} (KV {kv_b} + 8)",
          flush=True)
    prof = profile_decode(cfg, params, eng=ServeEngine(
        cfg, params, batch_size=BATCH, max_len=MM_MAX_LEN, device="cuda"),
        make_requests=lambda: make_requests(max_new=8))
    print(f"audio serve {cfg.name}: {step_ms:.3f} ms/decode step, "
          f"{n_tok / dt:.1f} tok/s, prefill_s={prefill_s:.3f}; "
          + _shares(prof), flush=True)
    del params, eng
    torch.cuda.empty_cache()
    return flash


def _bits(t):
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def init_data_group() -> str:
    """A one-rank data group for the train step: NCCL for CUDA tensors and
    gloo for CPU tensors (the reference phase trains on both), joined
    through a FileStore in a temporary directory. Returns the directory."""
    import tempfile
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    return tmp


def phase_bucket_kernels(params) -> dict:
    """bucket_pack/bucket_unpack vs the plain version on the tables of the
    full-width plan of ``params`` (random f32 arena of the plan's size)."""
    import numpy as np
    import torch
    from repro_torch.core import get_comm_plan
    from repro_torch.kernels.bucket_pack import (bucket_pack,
                                                 bucket_pack_plain,
                                                 bucket_unpack,
                                                 bucket_unpack_plain)

    dev = torch.device("cuda")
    cp = get_comm_plan(params, num_streams=8, pack="pallas")
    plan = cp.plan
    tile, _, arena_size, _, _ = cp.tables
    pack_tables, (ublk, uval) = cp.device_tables(dev)
    bases = np.cumsum([0] + [b.padded_size for b in plan.buckets]).tolist()
    gen = torch.Generator(device=dev).manual_seed(1)
    arena = torch.randn(arena_size, generator=gen, device=dev)
    staged = torch.empty(plan.total_padded, device=dev)
    err = {"bucket_pack": 0.0, "bucket_unpack": 0.0}

    def held(name, got, want, what):
        torch.cuda.synchronize()
        check(torch.equal(_bits(got), _bits(want)),
              f"{name} kernel != plain version ({what})")
        err[name] = max(err[name],
                        (got.float() - want.float()).abs().max().item())

    for bid, (b, (blk, val)) in enumerate(zip(plan.buckets, pack_tables)):
        got = bucket_pack(arena, blk, val, b.padded_size,
                          out=staged[bases[bid]:bases[bid + 1]])
        held("bucket_pack", got, bucket_pack_plain(arena, blk, val,
                                                    b.padded_size),
             f"bucket {bid}, f32")
    held("bucket_unpack", bucket_unpack(staged, ublk, uval, arena_size),
         bucket_unpack_plain(staged, ublk, uval, arena_size), "f32")
    big = max(range(plan.num_buckets),
              key=lambda i: plan.buckets[i].padded_size)
    size = plan.buckets[big].padded_size
    blk, val = pack_tables[big]
    a16 = arena.to(torch.bfloat16)
    held("bucket_pack", bucket_pack(a16, blk, val, size),
         bucket_pack_plain(a16, blk, val, size), f"bucket {big}, bf16")
    del a16
    print(f"kernel bucket_pack/bucket_unpack: {plan.num_buckets} buckets, "
          f"{plan.total_padded // tile} packed tiles, arena {arena_size} "
          f"f32 ({arena_size // tile} tiles): every pack and the unpack "
          f"bitwise equal to plain in f32, bucket {big} also in bf16",
          flush=True)

    res = {}
    for name, src, (blk, val), n_out in (
            ("bucket_pack", arena, pack_tables[big], size),
            ("bucket_unpack", staged, (ublk, uval), arena_size)):
        fn = bucket_pack if name == "bucket_pack" else bucket_unpack
        out = torch.empty(n_out, device=dev)
        ids = blk.long()
        kernel_ms, library_ms, wins = paired_ms(
            lambda i: fn(src, blk, val, n_out, out=out),
            lambda i: src.view(-1, tile).index_select(0, ids), n_iter=10,
            reps=3)
        plain_ms = time_ms(lambda i: bucket_pack_plain(src, blk, val, n_out),
                           n_iter=10, reps=3)
        # valid source bytes read once + the output written once + tables
        nbytes = int(val.sum()) * 4 + n_out * 4 + 8 * val.numel()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = dict(max_abs_err=err[name], ms=kernel_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms)
        print(f"kernel {name} f32 ({'largest bucket, ' if name == 'bucket_pack' else ''}"
              f"{n_out} elements, {val.numel()} tiles): kernel_ms="
              f"{kernel_ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms(index_select)={library_ms:.5f} (medians of "
              f"{PAIRS} alternating pairs, the kernel faster in {wins}) "
              f"bound_ms={bound_ms:.5f} ({nbytes} B, "
              f"{bound_ms / kernel_ms:.3f} of the bound)", flush=True)
        del out
    del arena, staged
    torch.cuda.empty_cache()
    return res


def _grads(cfg, params, batch):
    """One gradient tree of ``params`` on ``batch`` (autograd, no comm)."""
    import torch
    from repro_torch.models.transformer import Model
    from repro_torch.train.losses import total_loss
    from repro_torch.tree import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    b = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    logits, aux, _ = Model(cfg).forward(tree_unflatten(treedef, leaves), b)
    loss, _ = total_loss(cfg, logits, b["labels"], aux)
    return tree_unflatten(treedef, list(torch.autograd.grad(loss, leaves)))


def _saved_bytes(cfg, params, batch) -> tuple:
    """What one training forward of ``cfg`` keeps for its backward on the
    card: the bytes that reach the autograd saved-tensor hooks plus, under
    ``remat="dots"``, the selective checkpoint's own store (each storage
    once, the params left out); the store's bytes by op; and the growth of
    ``memory_allocated`` from before the forward to after the loss."""
    import torch
    import repro_torch.models.transformer as ttf
    from repro_torch.train.losses import total_loss
    from repro_torch.tree import tree_flatten, tree_unflatten
    stores, seen, by_op = [], {}, {}

    def contexts():
        ctx = ttf.create_selective_checkpoint_contexts(ttf._dots_policy)
        stores.append(ctx[0].storage)
        return ctx

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        # a detached alias: a node that saves its own output would hold
        # the output's grad_fn, itself, and the graph would never be freed
        return t.detach()

    def tensors(x):      # the store's (version-wrapped) outputs, any nesting
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, (list, tuple)):
            for v in x:
                yield from tensors(v)
            return
        t = getattr(x, "val", x)
        if isinstance(t, torch.Tensor):
            yield t

    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    params_ptrs = {p.untyped_storage().data_ptr() for p in leaves}
    b = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    real = ttf._dots_contexts
    ttf._dots_contexts = contexts
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            logits, aux, _ = ttf.Model(cfg).forward(
                tree_unflatten(treedef, leaves), b)
            loss, _ = total_loss(cfg, logits, b["labels"], aux)
    finally:
        ttf._dots_contexts = real
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    for store in stores:
        for op, outs in store.items():
            for t in tensors(outs):
                ptr = t.untyped_storage().data_ptr()
                if ptr not in seen:
                    name = str(op[0] if isinstance(op, tuple) else op)
                    by_op[name] = by_op.get(name, 0) + \
                        t.untyped_storage().nbytes()
                seen[ptr] = t.untyped_storage().nbytes()
    check((cfg.remat == "dots") == bool(stores),
          f"remat={cfg.remat!r}: {len(stores)} selective checkpoint stores")
    del logits, aux, loss, leaves, b
    return (sum(n for p, n in seen.items() if p not in params_ptrs), by_op,
            held)


def phase_train() -> dict:
    """Full-width olmo-1b VCI training on the card (see the docstring)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import get_comm_plan, reduce_gradients
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.bucket_pack import bucket_pack, bucket_unpack
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.train.trainer import make_train_step, train_state_init
    from repro_torch.tree import tree_flatten

    cfg = get_config(TRAIN_ARCH)
    check(cfg.remat == "block", f"{cfg.name} remat={cfg.remat}")
    t0 = time.time()
    state = train_state_init(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    print(f"train: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"params={cfg.param_count() / 1e9:.3f}B {cfg.param_dtype}, "
          f"moments {cfg.optimizer_dtype}, remat={cfg.remat}, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_KNOBS} (init "
          f"{time.time() - t0:.1f}s)", flush=True)
    kern = phase_bucket_kernels(state.params)

    torch.cuda.reset_peak_memory_stats()   # the state stays counted
    step = make_train_step(cfg, **TRAIN_KNOBS)
    batches = [synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, step=i)
               for i in range(TRAIN_STEPS + 3)]
    t0 = time.perf_counter()
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    print(f"train: warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms, "
          f"loss {float(m['loss']):.4f}", flush=True)
    first = (float(m["loss"]), float(m["grad_norm"]))
    cp = get_comm_plan(state.params, num_streams=8, num_vcis=8,
                       pack="pallas")
    n_buckets = cp.plan.num_buckets
    times, losses, norms = [], [], []
    torch.cuda.synchronize()
    bucket_pack.launches = bucket_unpack.launches = 0
    flash_attention.launches = 0
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batches[1 + i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = (bucket_pack.launches, bucket_unpack.launches)
    flash = flash_attention.launches
    # phase 11 holds the overlap schedule against these steps' results
    post = dict(metrics=[first] + list(zip(losses, norms)),
                params=[t.clone() for t in tree_flatten(state.params)[0]])
    check(launches == (n_buckets * TRAIN_STEPS, TRAIN_STEPS),
          f"{TRAIN_STEPS} steps launched pack/unpack {launches} times, want "
          f"({n_buckets} x {TRAIN_STEPS}, {TRAIN_STEPS})")
    # each layer's attention runs once in the forward and once more when
    # the non-reentrant checkpoint of remat="block" reruns the block's
    # forward in the backward (the backward itself is the plain recompute)
    want = 2 * cfg.num_layers * TRAIN_STEPS
    check(flash == want, f"{TRAIN_STEPS} steps launched flash_attention "
          f"{flash} times, want 2 x {cfg.num_layers} x {TRAIN_STEPS} = {want}")
    check(all(map(math.isfinite, losses + norms)),
          f"non-finite loss/gnorm {losses} {norms}")
    ms = sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated()
    print(f"train: {TRAIN_STEPS} steps, step ms {[round(t, 3) for t in times]}"
          f" (mean {ms:.3f}), {TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f} tok/s, "
          f"loss {[round(v, 4) for v in losses]}, gnorm "
          f"{[round(v, 4) for v in norms]}, max_memory_allocated {peak} B; "
          f"plan {n_buckets} buckets, {cp.plan.total_padded // 1024} packed "
          f"tiles, arena {cp.tables[2] // 1024} tiles; launches pack "
          f"{launches[0]} unpack {launches[1]} flash_attention {flash}",
          flush=True)

    grads = _grads(cfg, state.params, batches[0])
    red = {}
    for pack in ("pallas", "xla"):
        cpk = get_comm_plan(grads, num_streams=8, num_vcis=8, pack=pack)
        red[pack] = tree_flatten(reduce_gradients(cpk.runtime(), grads, cpk,
                                                  pack=pack))[0]
    torch.cuda.synchronize()
    for i, (a, b, g) in enumerate(zip(red["pallas"], red["xla"],
                                      tree_flatten(grads)[0])):
        check(torch.equal(_bits(a), _bits(b)),
              f"leaf {i}: pack='pallas' reduced grads != pack='xla'")
        check(torch.equal(_bits(a), _bits(g)),
              f"leaf {i}: one-rank reduced grads != the grads")
    print(f"train: reduce_gradients pack='pallas' == pack='xla' bit for bit "
          f"on one olmo-1b gradient tree ({len(red['xla'])} leaves, both "
          f"equal to the unreduced grads: a one-rank sum is exact)",
          flush=True)
    del grads, red
    profile_train(step, state, batches[-2:])
    # remat="dots" (the matmul outputs kept for the backward, the rest
    # recomputed): one step, its peak beside remat="block"'s on one state
    dstep = make_train_step(dataclasses.replace(cfg, remat="dots"),
                            **TRAIN_KNOBS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    state, m = dstep(state, batches[-1])
    torch.cuda.synchronize()
    dms = (time.perf_counter() - t0) * 1e3
    dpeak = torch.cuda.max_memory_allocated()
    dflash = flash_attention.launches
    check(math.isfinite(float(m["loss"])), f"remat='dots': loss {m['loss']}")
    # the selective checkpoint keeps the flash op's (o, lse): no second
    # forward in the backward
    check(dflash == cfg.num_layers, f"a remat='dots' step launched "
          f"flash_attention {dflash} times, want {cfg.num_layers}")
    print(f"train: remat='dots' one step {dms:.3f} ms (its first), loss "
          f"{float(m['loss']):.4f}, max_memory_allocated {dpeak} B beside "
          f"remat='block''s {peak} B ({dpeak / peak:.3f}x); flash_attention "
          f"launches {dflash} (remat='block': {2 * cfg.num_layers} a step)",
          flush=True)
    # what each policy's forward keeps for the backward on this path (the
    # CUDA flash kernel, bf16): "dots" must keep the matmul outputs, so
    # strictly more than "block" and less than "none"
    saved = {}
    for remat in ("block", "dots", "none"):
        saved[remat] = _saved_bytes(dataclasses.replace(cfg, remat=remat),
                                    state.params, batches[-1])
        torch.cuda.empty_cache()
        print(f"train: remat={remat!r} forward keeps {saved[remat][0]} B for "
              f"the backward (saved-tensor hooks + the checkpoint's store; "
              f"the store by op {saved[remat][1]}); memory_allocated grew "
              f"{saved[remat][2]} B over the forward and loss", flush=True)
    check(saved["block"][0] < saved["dots"][0] < saved["none"][0],
          f"remat='dots' keeps {saved['dots'][0]} B, not strictly between "
          f"'block' {saved['block'][0]} and 'none' {saved['none'][0]}")
    del state
    torch.cuda.empty_cache()
    return dict(kern, launches=launches, flash=flash + dflash, step_ms=ms,
                post=post, peak=peak)


def _f32_leaves(plan, masters) -> list:
    """The f32 master buffers of a one-rank ZeRO-1 state (each shard the
    whole bucket), cut into leaves in leaf order."""
    out = [None] * plan.num_leaves
    for b, m in zip(plan.buckets, masters):
        for s in b.slots:
            out[s.index] = m[s.offset:s.offset + s.size]
    return out


def phase_train_zero1(rep: dict) -> dict:
    """Phase 11: phase 9's olmo-1b step as ZeRO-1 post, replicated overlap
    and ZeRO-1 overlap (see the module docstring); ``rep`` holds phase 9's
    metrics of its 6 steps and its params after them, which this drops."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import get_comm_plan
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.bucket_pack import bucket_pack, bucket_unpack
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.train.trainer import (make_train_step, optimizer_bytes,
                                           train_state_init)
    from repro_torch.tree import tree_flatten

    cfg = get_config(TRAIN_ARCH)
    batches = [synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, step=i)
               for i in range(TRAIN_STEPS + 1)]
    out, masters = {}, {}
    for optimizer, schedule in (("zero1", "post"), ("replicated", "overlap"),
                                ("zero1", "overlap")):
        name = f"{optimizer}/{schedule}"
        knobs = dict(TRAIN_KNOBS, optimizer=optimizer, schedule=schedule)
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        t0 = time.time()
        state = train_state_init(cfg, 0, device="cuda", optimizer=optimizer,
                                 num_streams=8, pack="pallas",
                                 schedule=schedule)
        step = make_train_step(cfg, **knobs)
        cp = get_comm_plan(state.params, num_streams=8, num_vcis=8,
                           pack="pallas", schedule=schedule)
        n_buckets = cp.plan.num_buckets
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, m = step(state, batches[0])
        metrics = [(float(m["loss"]), float(m["grad_norm"]))]
        warm_s = time.time() - t0
        if optimizer == "zero1":     # the f32 master after step 1
            masters[schedule] = [t.clone() for t in _f32_leaves(
                cp.plan, state.opt.master)]
        times = []
        torch.cuda.synchronize()
        bucket_pack.launches = bucket_unpack.launches = 0
        flash_attention.launches = 0
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batches[1 + i])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        packs, unpacks = bucket_pack.launches, bucket_unpack.launches
        flash = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        opt_bytes = optimizer_bytes(state.opt)
        check(all(map(math.isfinite, sum(metrics, ()))),
              f"{name}: non-finite loss/gnorm {metrics}")
        # step 1 starts from phase 9's params and batch: the same loss and
        # grad norm as the replicated post step (the ZeRO-1 master is the
        # params in f32; later steps differ in bf16, where ZeRO-1 keeps f32)
        for got, want, what in zip(metrics[0], rep["metrics"][0],
                                   ("loss", "grad norm")):
            check(abs(got - want) <= 1e-5 * abs(want),
                  f"{name} step 1 {what} {got} vs replicated post {want}")
        want_packs = n_buckets * TRAIN_STEPS if name == "zero1/post" else 0
        check((packs, unpacks) == (want_packs, 0),
              f"{name}: {TRAIN_STEPS} steps launched pack/unpack "
              f"{(packs, unpacks)}, want ({want_packs}, 0)")
        check(flash == 2 * cfg.num_layers * TRAIN_STEPS,
              f"{name}: flash_attention launched {flash} times")
        issue = ""
        if schedule == "overlap":
            last = step.last_issue
            check(last["order"] == cp.ready_order and
                  last["in_backward"] == n_buckets,
                  f"{name}: hooks issued {last}, ready order "
                  f"{cp.ready_order}")
            early = sum(1 for v in last["hooks_seen"].values()
                        if v < last["leaves"])
            issue = (f"; hooks issued all {last['in_backward']} buckets "
                     f"before the backward returned, in ready order "
                     f"{last['order']}, {early} of them before the last "
                     f"leaf gradient arrived (leaf gradients seen at each "
                     f"issue {last['hooks_seen']})")
            # replicated: one rank's reduce is exact, so overlap repeats
            # post's f32 arithmetic step by step. ZeRO-1: the two plans lay
            # the buckets out apart, so the grad norm, and through the clip
            # every update, differs in the last f32 bits; the bf16 params
            # rounded from the f32 master then differ by one ulp here and
            # there, and from step 2 on the bf16 forward carries that on:
            # step 1 is held to f32 (above and its master below), later
            # steps to a quarter of a bf16 ulp (2^-10)
            base = rep if optimizer == "replicated" else out["zero1/post"]
            tol = 1e-5
            for i, (a, b) in enumerate(zip(metrics, base["metrics"])):
                if i and optimizer == "zero1":
                    tol = 2 ** -10
                for x, y in zip(a, b):
                    check(abs(x - y) <= tol * abs(y),
                          f"{name} step {i + 1}: {a} vs post {b} (rtol "
                          f"{tol})")
            drift = max(abs(x - y) / abs(y) for a, b in
                        zip(metrics, base["metrics"]) for x, y in zip(a, b))
            issue += (f"; loss/gnorm against post's: max relative diff "
                      f"{drift:.3e}")
        ms = sum(times) / len(times)
        print(f"train {name}: {cfg.name}, {TRAIN_KNOBS}, batch {TRAIN_BATCH} "
              f"x {TRAIN_SEQ}: warm-up (init included) {warm_s:.1f} s; step "
              f"ms {[round(t, 3) for t in times]} (mean {ms:.3f}), "
              f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f} tok/s; loss "
              f"{[round(v[0], 4) for v in metrics]}, gnorm "
              f"{[round(v[1], 4) for v in metrics]}; max_memory_allocated "
              f"{peak} B ({before} B allocated before the state was made: "
              f"phase 9's params kept for the comparison); optimizer state "
              f"{opt_bytes} B a rank; launches "
              f"pack {packs} unpack {unpacks} flash_attention {flash}{issue}",
              flush=True)
        out[name] = dict(metrics=metrics, ms=ms, peak=peak, packs=packs,
                         flash=flash, opt_bytes=opt_bytes)
        leaves = tree_flatten(state.params)[0]
        if name == "replicated/overlap":
            # one rank's reduce is exact: equal bits, unless the backward's
            # kernels sum in another order from run to run, which may move
            # a bf16 param by one ulp (a relative 2^-7 at most)
            off = worst = 0
            for a, b in zip(leaves, rep["params"]):
                d = (a.float() - b.float()).abs()
                off += int((d > 0).sum())
                worst = max(worst, (d / b.float().abs().clamp(min=1e-30)
                                    ).max().item())
            check(worst <= 2 ** -7, f"{name}: params off post's by {worst} "
                  f"relative (> one bf16 ulp)")
            print(f"train {name}: params after {TRAIN_STEPS + 1} steps "
                  f"against phase 9's post schedule's: {off} elements "
                  f"differ (max relative diff {worst:.3e}; one bf16 ulp is "
                  f"<= {2 ** -7:.3e})", flush=True)
        del state, step, leaves
        torch.cuda.empty_cache()
    # step 1 from equal params and batch: the f32 masters within f32
    # tolerance (the clip scale is the only difference)
    worst = 0.0
    for a, b in zip(masters["overlap"], masters["post"]):
        d = (a - b).abs()
        worst = max(worst, d.max().item())
        check(bool((d <= 1e-6 + 2e-5 * b.abs()).all()),
              f"zero1 overlap's f32 master after step 1 differs from post's "
              f"by {d.max().item()}")
    print(f"train zero1/overlap: f32 master after step 1 within rtol 2e-5 "
          f"/ atol 1e-6 of zero1/post's (max abs diff {worst:.3e})",
          flush=True)
    del masters
    rep.pop("params")
    torch.cuda.empty_cache()
    return out


def profile_train(step, state, batches) -> None:
    """Device busy time and idle share of 2 train steps, the kernels by
    time, and the pack+unpack share. Measures only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            step(state, b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = run()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if busy_ms <= 0:
        print("profile train: the profiler recorded no device time (not "
              "measured)", flush=True)
        return
    pack_ms = sum(e.self_device_time_total for e in kern
                  if "bucket_pack_kernel" in e.key) / 1e3
    flash_ms = sum(e.self_device_time_total for e in kern
                   if "flash_fwd_" in e.key) / 1e3
    gather_ms = sum(e.self_device_time_total for e in kern
                    if "row_gather_kernel" in e.key) / 1e3
    gsum_ms = sum(e.self_device_time_total for e in kern
                  if "row_gather_sum_kernel" in e.key) / 1e3
    ssd_ms = sum(e.self_device_time_total for e in kern
                 if "ssd_chunk_kernel" in e.key) / 1e3
    ssd_bwd_ms = sum(e.self_device_time_total for e in kern
                     if "ssd_chunk_bwd_kernel" in e.key
                     or "ssd_group_sum_kernel" in e.key
                     or "ssd_bwd_" in e.key) / 1e3
    ports = pack_ms + flash_ms + gather_ms + gsum_ms + ssd_ms + ssd_bwd_ms
    print(f"profile train: {len(batches)} steps: wall {wall_ms:.2f} ms "
          f"({prof_wall_ms:.2f} under the profiler), device busy "
          f"{busy_ms:.2f} ms, device idle share {1 - busy_ms / wall_ms:.4f};"
          f" pack+unpack {pack_ms:.3f} ms = {pack_ms / busy_ms:.4f} of "
          f"device time; flash_attention {flash_ms:.3f} ms = "
          f"{flash_ms / busy_ms:.4f} of device time; row_gather "
          f"{gather_ms:.3f} ms = {gather_ms / busy_ms:.4f}; row_gather_sum "
          f"{gsum_ms:.3f} ms = {gsum_ms / busy_ms:.4f}; ssd_chunk "
          f"{ssd_ms:.3f} ms = {ssd_ms / busy_ms:.4f}; ssd_chunk_bwd (both "
          f"routes, with their sums) {ssd_bwd_ms:.3f} ms = "
          f"{ssd_bwd_ms / busy_ms:.4f}"
          f"; the port's kernels "
          f"together {ports / busy_ms:.4f} of device time; "
          f"{sum(e.count for e in kern)} kernel launches",
          flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile train:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d} x {e.self_device_time_total / max(e.count, 1):9.2f}"
              f" us  {e.key[:90]}", flush=True)


def _first_noise(moments, i):
    """Leaf ``i``'s elements whose gradient, at the first step that reached
    them, was nonzero and under 1e-5 of the leaf's largest (see 14c);
    ``moments``: the first moments after each step (the gradient of step t
    is ``(m_t - 0.9 m_(t-1)) / 0.1``, exact where ``m_(t-1)`` is 0)."""
    import numpy as np
    seen = first = prev = 0
    for m in moments:
        m = m[i].numpy()
        grad = (m - 0.9 * prev) / 0.1
        new = (grad != 0) & ~np.asarray(seen, bool)
        first = first | (new & (np.abs(grad) < 1e-5 * np.abs(grad).max()))
        seen, prev = seen | (grad != 0), m
    return np.asarray(first, bool)


def phase_reference_train(arch: str = "olmo-1b-smoke") -> None:
    """``arch`` (a smoke arch, f32): 3 steps of the same train step on the
    card and on the CPU, from the same params and batches; an MoE arch's
    load balance and router z too, and its row moves through both row
    gather kernels; an SSM or hybrid arch's SSD step through its forward
    and backward kernels."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gather import row_gather, row_gather_sum
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_bwd
    from repro_torch.models.transformer import init_params
    from repro_torch.train.trainer import make_train_step, train_state_init
    from repro_torch.tree import tree_flatten, tree_map

    cfg = get_config(arch)
    keys = ("loss", "grad_norm") + (("load_balance", "router_z")
                                    if cfg.moe is not None else ())
    ssm = cfg.family in ("ssm", "hybrid")
    params = init_params(cfg, 0, device="cpu")
    runs, moments = {}, []
    for dev in ("cuda", "cpu"):
        state = train_state_init(cfg, params=tree_map(
            lambda t: t.clone().to(dev), params))
        step = make_train_step(cfg, **TRAIN_KNOBS)
        metrics = []
        flash_attention.launches = 0
        row_gather.launches = row_gather_sum.launches = 0
        ssd_chunk.launches = ssd_chunk_bwd.launches = 0
        for i in range(3):
            state, m = step(state, synthetic_batch(cfg, 4, 64, seed=i))
            metrics.append(tuple(float(m[k]) for k in keys))
            if dev == "cpu" and ssm:
                moments.append([t.clone() for t in
                                tree_flatten(state.opt.m)[0]])
        if dev == "cuda":
            flash = flash_attention.launches
            check(cfg.family == "ssm" or flash > 0,
                  f"{arch}: the card's train steps launched no flash "
                  f"attention")
            moved = (row_gather.launches, row_gather_sum.launches)
            check(cfg.moe is None or min(moved) > 0,
                  f"{arch}: the card's steps launched row_gather / "
                  f"row_gather_sum {moved} times")
            ssd = (ssd_chunk.launches, ssd_chunk_bwd.launches)
            # the forward once a layer a step (twice under remat="block")
            runs_fwd = 2 if cfg.remat == "block" else 1
            check(not ssm or ssd == (runs_fwd * 3 * cfg.num_layers,
                                     3 * cfg.num_layers),
                  f"{arch}: the card's steps launched ssd_chunk / "
                  f"ssd_chunk_bwd {ssd} times")
        runs[dev] = (metrics, [t.cpu() for t in tree_flatten(state.params)[0]])
    worst = 0.0
    for card, cpu in zip(runs["cuda"][0], runs["cpu"][0]):
        for c, a in zip(card, cpu):
            check(c == c, f"{arch}: non-finite metric on the card")
            worst = max(worst, abs(c - a) / abs(a))
            check(abs(c - a) <= 1e-5 * abs(a),
                  f"{arch}: card {keys} {card} vs CPU {cpu} (rtol 1e-5)")
    off = total = first = 0
    pworst = nworst = 0.0
    # bf16 moments (arctic): one bf16 ulp of a moment moves a step's update
    # by up to 2^-8 lr, carried once a step (tests/test_torch_train.py)
    atol = 1e-6 + (3 * 2 ** -8 * 3e-4 if cfg.optimizer_dtype == "bfloat16"
                   else 0.0)
    for i, (c, a) in enumerate(zip(runs["cuda"][1], runs["cpu"][1])):
        c, a = c.numpy(), a.numpy()
        d = np.abs(c - a)
        noise = _first_noise(moments, i) if moments else \
            np.zeros(a.shape, bool)
        first += int(noise.sum())
        nworst = max(nworst, float(d[noise].max(initial=0.0)))
        check(bool((d[noise] <= 3 * 3e-4 * (1 + 1e-6)).all()),
              f"{arch}: a first-noise param element moved {nworst:.3e}")
        pworst = max(pworst, float(d[~noise].max(initial=0.0)))
        check(bool((d[~noise] <= 1e-4 + 2e-5 * np.abs(a[~noise])).all()),
              f"{arch}: card params differ from the CPU's by "
              f"{d[~noise].max(initial=0.0):.3e}")
        off += int((d > atol + 2e-5 * np.abs(a)).sum())
        total += a.size
    check(off <= total * 1e-4, f"{arch}: {off} of {total} param elements "
          f"off")
    extra = ssd_note = ""
    if cfg.moe is not None:
        extra = f", row_gather / row_gather_sum {moved}"
    if ssm:
        extra += f", ssd_chunk / ssd_chunk_bwd {ssd}"
        ssd_note = (f", {first} first-noise elements, max abs diff "
                    f"{nworst:.3e} (tol 3 x lr)")
    print(f"reference train: {arch} f32, 3 steps card (flash launches "
          f"{flash}{extra}) vs CPU: {'/'.join(keys)} max rel diff "
          f"{worst:.3e} (tol 1e-5), params max abs diff {pworst:.3e} (tol "
          f"1e-4 + 2e-5 rel), {off} of {total} elements beyond {atol:.3e} + "
          f"2e-5 rel{ssd_note}", flush=True)


# ---------------------------------------------------------------------------
# phase 12: ZeRO-1 and overlap training on four ranks of the one card
# ---------------------------------------------------------------------------

def _zero1_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One of phase 12's ranks: join the shared-card group (gloo, CUDA
    tensors), train ZeRO-1 post then ZeRO-1 overlap from the same params
    and batches, hold the two against each other, write what it saw to
    ``out_dir/zero1_rank<r>.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import get_comm_plan
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.bucket_pack import bucket_pack
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import join_ranks
    from repro_torch.train.trainer import (make_train_step, optimizer_bytes,
                                           train_state_init)
    from repro_torch.tree import tree_flatten

    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device, backend, why = join_ranks(rank, world, "cuda", store)
    out = dict(backend=backend, why=why, runs={})
    try:
        cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                                  num_layers=ZERO1_LAYERS)
        batches = [synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                                   step=i) for i in range(ZERO1_STEPS)]
        post = None
        for schedule in ("post", "overlap"):
            state = train_state_init(cfg, 0, device=device,
                                     optimizer="zero1", num_streams=8,
                                     pack="pallas", schedule=schedule)
            step = make_train_step(cfg, **dict(TRAIN_KNOBS, optimizer="zero1",
                                               schedule=schedule))
            cp = get_comm_plan(state.params, num_streams=8, num_vcis=8,
                               pack="pallas", schedule=schedule)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            bucket_pack.launches = flash_attention.launches = 0
            times, metrics = [], []
            for i, b in enumerate(batches):
                dist.barrier()
                t0 = time.perf_counter()
                state, m = step(state, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
                times.append((time.perf_counter() - t0) * 1e3)
                if i:
                    continue
                # after step 1 from equal params: ZeRO-1's params are its
                # f32 masters rounded to bf16, and the two plans sum the
                # grad norm in other orders, so a master may round to the
                # neighbouring bf16 value: one ulp
                leaves = tree_flatten(state.params)[0]
                if schedule == "post":
                    post = [t.clone() for t in leaves]
                else:
                    param_rel = max(
                        ((a.float() - c.float()).abs()
                         / c.float().abs().clamp(min=1e-30)).max().item()
                        for a, c in zip(leaves, post))
                del leaves
            run = dict(metrics=metrics, ms=times,
                       packs=bucket_pack.launches,
                       flash=flash_attention.launches,
                       buckets=cp.plan.num_buckets,
                       total_padded=cp.plan.total_padded,
                       opt_bytes=optimizer_bytes(state.opt),
                       peak=torch.cuda.max_memory_allocated())
            if schedule == "overlap":
                last = step.last_issue
                run.update(order=list(last["order"]),
                           ready_order=list(cp.ready_order),
                           in_backward=last["in_backward"],
                           param_rel=param_rel)
            out["runs"][schedule] = run
            del state, step
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        with open(os.path.join(out_dir, f"zero1_rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def phase_zero1_ranks(card: str) -> dict:
    """Phase 12 (see the docstring): ``ZERO1_WORLD`` ranks on the one card,
    spawned once. Returns the pack and flash launches summed over the
    ranks."""
    import tempfile
    import torch

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_zero1_")
    t0 = time.time()
    ctx = torch.multiprocessing.start_processes(
        _zero1_rank, args=(ZERO1_WORLD, os.path.join(out_dir, "store"),
                           out_dir),
        nprocs=ZERO1_WORLD, start_method="spawn", join=False)
    try:
        while not ctx.join(timeout=5):
            if time.time() - t0 > ZERO1_TIMEOUT_S:
                for proc in ctx.processes:
                    proc.kill()
                fail(f"phase 12: the ranks ran past {ZERO1_TIMEOUT_S} s")
    except Exception as e:   # a rank raised: its traceback is in stderr
        fail(f"phase 12: a rank failed: {e}")
    ranks = []
    for r in range(ZERO1_WORLD):
        with open(os.path.join(out_dir, f"zero1_rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]
    print(f"zero1 ranks: {ZERO1_WORLD} ranks on one card ({card}) in "
          f"{time.time() - t0:.1f}s, backend={r0['backend']} ({r0['why']}),"
          f" CUDA tensors; {TRAIN_ARCH} at full width, {ZERO1_LAYERS} "
          f"layers, global batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{ZERO1_STEPS} steps, {TRAIN_KNOBS}", flush=True)
    launches = dict(packs=0, flash=0)
    for schedule in ("post", "overlap"):
        runs = [r["runs"][schedule] for r in ranks]
        run = runs[0]
        n_b, padded = run["buckets"], run["total_padded"]
        # one rank's ZeRO-1 state is f32 master + m + v over every padded
        # element (+ the int32 count); a rank of 4 holds a quarter of it
        one = 12 * padded + 4
        for r, got in enumerate(runs):
            check(got["metrics"] == run["metrics"],
                  f"zero1 {schedule}: rank {r}'s metrics differ from rank "
                  f"0's (the step means them over the group)")
            check(got["opt_bytes"] == 12 * padded // ZERO1_WORLD + 4,
                  f"zero1 {schedule}: rank {r} holds {got['opt_bytes']} B "
                  f"of optimizer state, want 1/{ZERO1_WORLD} of {one}")
            want = n_b * ZERO1_STEPS if schedule == "post" else 0
            check(got["packs"] == want, f"zero1 {schedule}: rank {r} "
                  f"launched bucket_pack {got['packs']} times, want {want}")
            check(got["flash"] == 2 * ZERO1_LAYERS * ZERO1_STEPS,
                  f"zero1 {schedule}: rank {r} launched flash "
                  f"{got['flash']} times")
            launches["packs"] += got["packs"]
            launches["flash"] += got["flash"]
        check(all(map(math.isfinite, sum(map(tuple, run["metrics"]), ()))),
              f"zero1 {schedule}: non-finite {run['metrics']}")
        extra = ""
        if schedule == "overlap":
            check(run["order"] == run["ready_order"] and
                  run["in_backward"] == n_b,
                  f"zero1 overlap: hooks issued {run['order']} "
                  f"({run['in_backward']} in the backward), ready order "
                  f"{run['ready_order']}")
            # step 1 in f32 terms, later steps in bf16 terms (phase 11)
            drift = 0.0
            for i, (a, b) in enumerate(zip(
                    run["metrics"], ranks[0]["runs"]["post"]["metrics"])):
                tol = 2 ** -10 if i else 1e-5
                for x, y in zip(a, b):
                    drift = max(drift, abs(x - y) / abs(y))
                    check(abs(x - y) <= tol * abs(y),
                          f"zero1 overlap step {i + 1} {a} vs post {b} "
                          f"(rtol {tol})")
            worst = max(r["param_rel"] for r in runs)
            check(worst <= 2 ** -7, f"zero1 overlap params after step 1 off "
                  f"post's by {worst} relative (> one bf16 ulp)")
            extra = (f"; hooks issued all {n_b} buckets inside the backward "
                     f"in ready order {run['order']}; loss/gnorm against "
                     f"post's: max relative diff {drift:.3e} (step 1 within "
                     f"1e-5, later 2^-10), params after step 1 within "
                     f"{worst:.3e} relative (one bf16 ulp is <= "
                     f"{2 ** -7:.3e})")
        print(f"zero1 ranks {schedule}: step ms (rank 0) "
              f"{[round(t, 1) for t in run['ms']]}, loss "
              f"{[round(m[0], 4) for m in run['metrics']]}, gnorm "
              f"{[round(m[1], 4) for m in run['metrics']]}; optimizer state "
              f"a rank {[r['opt_bytes'] for r in runs]} B (one rank's "
              f"ZeRO-1 state {one} B / {ZERO1_WORLD}); peak a rank "
              f"{[r['peak'] for r in runs]} B; launches a rank: pack "
              f"{run['packs']}, flash {run['flash']}{extra}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 7: tensor-parallel serving on four ranks of the one card
# ---------------------------------------------------------------------------

def _smoke_requests(vocab: int):
    """``tests/test_torch_serve_tp.py``'s requests: mixed prompt lengths,
    5 new tokens each."""
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(7)
    return [Request(prompt=rng.integers(0, vocab, (plen,), dtype=np.int32),
                    max_new_tokens=5) for plen in (5, 9, 3, 7)]


def _launch_counts(zero: bool = False) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gather import row_gather
    from repro_torch.kernels.paged_kv import paged_gather
    from repro_torch.kernels.ssd_scan import ssd_chunk
    if zero:
        flash_attention.launches = paged_gather.launches = 0
        row_gather.launches = row_gather.read_once_launches = 0
        ssd_chunk.launches = 0
    return dict(flash=flash_attention.launches, gather=paged_gather.launches,
                rows=row_gather.launches,
                read_once=row_gather.read_once_launches,
                ssd=ssd_chunk.launches)


def _ssm_gspmd_requests(vocab: int):
    """16e's full-width requests: 4 prompts of ``SSM_GSPMD_PROMPT``
    tokens (one group), ``SSM_GSPMD_NEW`` new tokens each."""
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(16)
    return [Request(prompt=rng.integers(0, vocab, (SSM_GSPMD_PROMPT,),
                                        dtype=np.int32),
                    max_new_tokens=SSM_GSPMD_NEW) for _ in range(4)]


def _ssm_gspmd_cfg(arch: str):
    """16e's full-width config: ``SSM_GSPMD_LAYERS`` Mamba2 blocks, or a
    hybrid's one group of them with its shared-attention site."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, num_layers=cfg.hybrid_attn_every or SSM_GSPMD_LAYERS)


def _ssm_states(eng) -> list:
    """Records each decode cache ``eng`` makes: its SSM state's conv and
    SSD shapes and their bytes as made (16e)."""
    states = []

    def new_cache(b, n, make=eng._new_cache):
        cache = make(b, n)
        st = cache.ssm
        states.append(dict(conv=list(st.conv.shape), ssd=list(st.ssd.shape),
                           bytes=st.conv.nbytes + st.ssd.nbytes))
        return cache

    eng._new_cache = new_cache
    return states


@contextlib.contextmanager
def _ssd_heads():
    """The head counts that the Mamba2 blocks hand the SSD kernel while
    the context is open (16e)."""
    from repro_torch.models import ssm
    seen, kernel = set(), ssm.ssd_chunk

    def record(x, *a, **kw):
        seen.add(int(x.shape[2]))
        return kernel(x, *a, **kw)

    ssm.ssd_chunk = record
    try:
        yield seen
    finally:
        ssm.ssd_chunk = kernel


def _ssm_first_logits(cfg, model, params, cache):
    """Last-position logits (f32, on the host) of the prefill of 16e's 4
    prompts through ``model`` into ``cache``."""
    import numpy as np
    import torch
    tokens = np.stack([r.prompt for r in _ssm_gspmd_requests(
        cfg.vocab_size)])
    with torch.inference_mode():
        logits, _, _ = model.forward(
            params, {"tokens": torch.as_tensor(tokens, device="cuda")},
            cache=cache)
    out = logits[:, -1].float().cpu().numpy()
    del logits
    torch.cuda.empty_cache()
    return out


def _ssm_one_rank() -> dict:
    """16e's yardstick: the SSM and the hybrid, cut in depth, through one
    rank's engine on the card (the block replicated, the state whole),
    from the same ``init_params(cfg, 0)``: tokens, state bytes and the
    first prefill's logits."""
    import torch
    from repro_torch.models.transformer import Model, init_cache, init_params
    from repro_torch.serve.engine import ServeEngine
    got = {}
    for arch in (SSM_ARCH, HYB_ARCH):
        cfg = _ssm_gspmd_cfg(arch)
        max_len = SSM_GSPMD_PROMPT + SSM_GSPMD_NEW
        params = init_params(cfg, 0, device="cuda")
        eng = ServeEngine(cfg, params, batch_size=4, device="cuda",
                          max_len=max_len)
        states = _ssm_states(eng)
        reqs = _ssm_gspmd_requests(cfg.vocab_size)
        eng.generate(reqs)
        logits = _ssm_first_logits(cfg, Model(cfg), params, init_cache(
            cfg, 4, max_len, dtype=torch.float32, device="cuda"))
        got[arch] = dict(tokens=[r.generated.tolist() for r in reqs],
                         state_bytes=max(x["bytes"] for x in states),
                         logits=logits)
        del eng, params
        torch.cuda.empty_cache()
    return got


def _split_cfg():
    """16f's full-width config: gemma-2b cut to ``SPLIT_LAYERS``, in f32
    (TF32 off): with random weights its 256,000 logits lie so close
    together that bf16's rounding of the ranks' partial sums flips a
    greedy token as often as not (0.5859 of the tokens equal one rank's
    in bf16 on an H100), which would hide what the split itself does."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(GEMMA_ARCH),
                               num_layers=SPLIT_LAYERS, dtype="float32",
                               param_dtype="float32")


def _split_case(cfg, name: str) -> tuple:
    """16f's (batch, max_len, requests): the first 4 of phase 5's
    requests on 4 slots, ``SPLIT_NEW`` new tokens each, or one request of
    ``SPLIT_PROMPT`` tokens."""
    if name == "split1x4":
        reqs = _requests(cfg.vocab_size)[:BATCH]
        for r in reqs:
            r.max_new_tokens = SPLIT_NEW
        return BATCH, MAX_LEN, reqs
    # the cache's positions a multiple of the 4 ranks, so that they split
    # over all of them
    max_len = -(-(SPLIT_PROMPT + SPLIT_LONG_NEW) // 4) * 4
    return 1, max_len, _arch_requests(cfg.vocab_size, (SPLIT_PROMPT,),
                                      SPLIT_LONG_NEW, 16)


def _split_one_rank() -> dict:
    """16f's yardstick: the same cases through one rank's engine on the
    card, its cache whole: tokens and ``cache_bytes_resident``."""
    import torch
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine
    cfg = _split_cfg()
    params = init_params(cfg, 0, device="cuda")
    got = {}
    for name in ("split1x4", "split2x2"):
        batch, max_len, reqs = _split_case(cfg, name)
        eng = ServeEngine(cfg, params, batch_size=batch, device="cuda",
                          max_len=max_len)
        eng.generate(reqs)
        got[name] = dict(tokens=[r.generated.tolist() for r in reqs],
                         bytes=eng.cache_bytes_resident)
        del eng
    del params
    torch.cuda.empty_cache()
    return got


def _tp_init(cfg, mesh, rank: int):
    """This rank's shard of ``init_params(cfg, 0)`` on the card, each leaf
    cut as it is made; the ranks take turns, so one full leaf (and its f32
    temporaries) is on the card at a time."""
    import torch
    import torch.distributed as dist
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.comm import param_sharder
    params = None
    for turn in range(mesh.size):
        if turn == rank:
            params = init_params(cfg, 0, device="cuda", shard=param_sharder(
                cfg, mesh.model, mesh.coords(rank)[1]))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    return params


def _tp_run(eng, plan, reqs) -> dict:
    """One measured ``generate`` of a TP engine: the kernel launches and
    the collectives by purpose counted from zero, host clock around each
    synchronised call, the collectives' host seconds (device synchronised
    before each clock starts)."""
    import torch
    eng._prefill, eng._step = _Timed(eng._prefill), _Timed(eng._step)
    plan.tally.reset()
    plan.tally.timed = True
    torch.cuda.synchronize()
    _launch_counts(zero=True)
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = _launch_counts()
    steps = eng.decode_steps
    n_tok = sum(len(r.generated) for r in reqs)
    out.update(
        tokens=[r.generated.tolist() for r in reqs], steps=steps,
        prefills=eng._prefill.calls, wall_s=dt, tok_s=n_tok / dt,
        step_ms=eng._step.seconds / max(steps, 1) * 1e3,
        prefill_s=eng._prefill.seconds, comm_s=plan.tally.seconds,
        counts=dict(plan.tally.counts), bytes=eng.cache_bytes_resident,
        vcis=sorted(plan.vci_map().values()),
        fallback_hits=plan.stats.fallback_hits,
        leaked=(int((eng._pages.owner[1:] != -1).sum()) if eng._paged
                else 0))
    return out


def _gspmd_run(eng, reqs) -> dict:
    """One measured ``generate`` of a GSPMD-route engine (16d): launches
    and the Sharder's collectives counted from zero, host clock around
    each synchronised call."""
    import torch
    shard = eng._sharder
    eng._prefill, timed = _Timed(eng._prefill), _Timed(eng._step)
    last = {}

    def step(*a, **kw):
        """The timed step; ``last``: the collectives it issued."""
        before = dict(shard.tally)
        out = timed(*a, **kw)
        last.clear()
        last.update({k: v - before.get(k, 0) for k, v in shard.tally.items()
                     if v != before.get(k, 0) and not k.endswith("_bytes")})
        return out

    eng._step = step
    shard.tally.clear()
    shard.reset_tally()
    torch.cuda.synchronize()
    _launch_counts(zero=True)
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = _launch_counts()
    counts = {k: v for k, v in shard.tally.items()
              if v and not k.endswith("_bytes")}
    steps = eng.decode_steps
    out.update(
        tokens=[r.generated.tolist() for r in reqs], steps=steps,
        prefills=eng._prefill.calls, wall_s=dt,
        tok_s=sum(len(r.generated) for r in reqs) / dt,
        step_ms=timed.seconds / max(steps, 1) * 1e3,
        prefill_s=eng._prefill.seconds, counts=counts, step_counts=last,
        bytes=eng.cache_bytes_resident,
        leaked=(int((eng._pages.owner[1:] != -1).sum()) if eng._paged
                else 0))
    return out


def _tp_serve(cfg, params, mesh, layout: str, num_vcis: int,
              warm: bool) -> dict:
    """The serve requests through a TP engine (phase 5's shapes)."""
    from repro_torch.serve.comm import ServeCommPlan
    from repro_torch.serve.engine import Request, ServeEngine
    plan = ServeCommPlan(num_vcis=num_vcis)
    eng = ServeEngine(cfg, params, batch_size=BATCH, max_len=MAX_LEN,
                      device="cuda", mesh=mesh, comm_plan=plan,
                      paged=layout == "paged", page_size=PAGE_SIZE)
    if warm:
        eng.generate([Request(prompt=r.prompt[:PROMPT_LO], max_new_tokens=2)
                      for r in _requests(cfg.vocab_size)[:2]])
    return _tp_run(eng, plan, _requests(cfg.vocab_size))


def _tp_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One of phase 7's ranks: join the shared-card group, serve every
    case, write what it saw to ``out_dir/rank<r>.json`` (rank 0 also the
    first prefill's logits)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.collectives import RankMesh
    from repro_torch.dist.sharding import Sharder
    from repro_torch.launch.serve import join_ranks
    from repro_torch.models.transformer import Model, init_params
    from repro_torch.serve.comm import ServeCommPlan, shard_params
    from repro_torch.serve.engine import Request, ServeEngine, gspmd_cache

    # the ranks' caches hand freed blocks back between the cases
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device, backend, why = join_ranks(rank, world, "cuda", store)
    out = dict(backend=backend, why=why, cases={}, gspmd={})
    try:
        mesh = RankMesh(1, world)
        for arch, layers in ((SERVE_ARCH, None), (MOE_ARCH, MOE_LAYERS)):
            cfg = get_config(arch)
            if layers:
                cfg = dataclasses.replace(cfg, num_layers=layers)
            t0 = time.time()
            params = _tp_init(cfg, mesh, rank)
            out[f"{arch} init_s"] = time.time() - t0
            out[f"{arch} card_free"] = torch.cuda.mem_get_info()[0]
            out[f"{arch} param_bytes"] = torch.cuda.memory_allocated()
            plan = ServeCommPlan(num_vcis=8)
            logits = _first_logits(
                cfg, Model(cfg, comm=plan.comm(mesh=mesh)), params,
                kv_heads=cfg.num_kv_heads // world)
            if rank == 0:
                np.save(os.path.join(out_dir, f"logits_{arch}.npy"), logits)
            if layers is None:
                for nv in TP_VCIS:
                    for layout in ("paged", "contiguous"):
                        out["cases"][f"{arch} {layout} num_vcis={nv}"] = \
                            _tp_serve(cfg, params, mesh, layout, nv,
                                      warm=nv == TP_VCIS[0])
                # 16d: the GSPMD route on the same params (the rule table
                # cuts olmo-1b over model as serve_param_specs does)
                eng = ServeEngine(cfg, params, batch_size=BATCH,
                                  max_len=MAX_LEN, device="cuda", mesh=mesh,
                                  paged=True, page_size=PAGE_SIZE)
                out["gspmd"][f"{arch} paged"] = _gspmd_run(
                    eng, _requests(cfg.vocab_size))
                del eng
            else:
                out["cases"][f"{arch} paged num_vcis=8"] = _tp_serve(
                    cfg, params, mesh, "paged", 8, warm=True)
                plan = ServeCommPlan(num_vcis=8)
                eng = ServeEngine(cfg, params, batch_size=MOE_LONG_GROUP,
                                  max_len=MOE_LONG_PROMPT + MOE_LONG_NEW,
                                  device="cuda", mesh=mesh, comm_plan=plan)
                out["cases"][f"{arch} long num_vcis=8"] = _tp_run(
                    eng, plan, [Request(prompt=p, max_new_tokens=MOE_LONG_NEW)
                                for p in _long_prompts(cfg.vocab_size)])
                del eng
            out[f"{arch} peak_bytes"] = torch.cuda.max_memory_allocated()
            del params
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        # the smoke archs in f32 on the same ranks regrouped data 2 x model 2,
        # through the manual-TP path (olmo's paged also at one VCI: the
        # fallback) and the GSPMD route (16d)
        mesh = RankMesh(2, world // 2)
        for arch in TP_SMOKE:
            cfg = get_config(arch)
            full = init_params(cfg, 0, device="cpu")
            params = _to(shard_params(cfg, full, mesh.model,
                                      mesh.coords(rank)[1]), "cuda")
            layouts = (("contiguous", dict(batch_size=4)),
                       ("paged", dict(batch_size=2, paged=True,
                                      page_size=8, num_pages=11)))
            for layout, kw in layouts:
                for nv in (8, 1) if (arch, layout) == (
                        TP_SMOKE[0], "paged") else (8,):
                    plan = ServeCommPlan(num_vcis=nv)
                    eng = ServeEngine(cfg, params, max_len=48, device="cuda",
                                      mesh=mesh, comm_plan=plan, **kw)
                    vcis = "" if nv == 8 else " num_vcis=1"
                    out["cases"][f"{arch} {layout}{vcis} data2xmodel2"] = \
                        _tp_run(eng, plan, _smoke_requests(cfg.vocab_size))
            params = _to(Sharder(mesh, cfg, rank=rank).shard_params(full),
                         "cuda")
            for layout, kw in layouts:
                eng = ServeEngine(cfg, params, max_len=48, device="cuda",
                                  mesh=mesh, **kw)
                out["gspmd"][f"{arch} {layout} data2xmodel2"] = _gspmd_run(
                    eng, _smoke_requests(cfg.vocab_size))
        # 16e: the GSPMD route on the SSM and the hybrid (grouped, their
        # blocks computed replicated over model)
        for arch in GSPMD_SMOKE:
            cfg = get_config(arch)
            params = _to(Sharder(mesh, cfg, rank=rank).shard_params(
                init_params(cfg, 0, device="cpu")), "cuda")
            eng = ServeEngine(cfg, params, batch_size=4, max_len=48,
                              device="cuda", mesh=mesh)
            out["gspmd"][f"{arch} contiguous data2xmodel2"] = _gspmd_run(
                eng, _smoke_requests(cfg.vocab_size))
        mesh = RankMesh(1, world)
        for arch in (SSM_ARCH, HYB_ARCH):
            cfg = _ssm_gspmd_cfg(arch)
            max_len = SSM_GSPMD_PROMPT + SSM_GSPMD_NEW
            params = Sharder(mesh, cfg, rank=rank).shard_params(
                init_params(cfg, 0, device="cuda"))
            torch.cuda.empty_cache()
            eng = ServeEngine(cfg, params, batch_size=4, device="cuda",
                              max_len=max_len, mesh=mesh)
            states = _ssm_states(eng)
            with _ssd_heads() as heads:
                run = _gspmd_run(eng, _ssm_gspmd_requests(cfg.vocab_size))
            run.update(states=states, heads=sorted(heads))
            out["gspmd"][f"{arch} contiguous 1x4"] = run
            logits = _ssm_first_logits(
                cfg, Model(cfg, eng._sharder), params, gspmd_cache(
                    cfg, eng._sharder, 4, max_len, dtype=torch.float32,
                    device="cuda"))
            if rank == 0:
                np.save(os.path.join(out_dir, f"ssm_logits_{arch}.npy"),
                        logits)
            del eng, params
            torch.cuda.empty_cache()
        # 16f: the sequence-split decode cache: gemma-2b-smoke f32 on 1 x 4
        # against the CPU engine, then gemma-2b at full width on 1 x 4 (the
        # sequence over model) and one long request on 2 x 2 (over every
        # rank)
        cfg = get_config("gemma-2b-smoke")
        params = _to(Sharder(mesh, cfg, rank=rank).shard_params(
            init_params(cfg, 0, device="cpu")), "cuda")
        eng = ServeEngine(cfg, params, batch_size=4, max_len=48,
                          device="cuda", mesh=mesh)
        out["gspmd"][f"{cfg.name} smoke split1x4"] = _gspmd_run(
            eng, _smoke_requests(cfg.vocab_size))
        cfg = _split_cfg()
        full = init_params(cfg, 0, device="cuda")
        for m, name in ((mesh, "split1x4"), (RankMesh(2, world // 2),
                                              "split2x2")):
            params = Sharder(m, cfg, rank=rank).shard_params(full)
            batch, max_len, reqs = _split_case(cfg, name)
            eng = ServeEngine(cfg, params, batch_size=batch, device="cuda",
                              max_len=max_len, mesh=m)
            out["gspmd"][f"{cfg.name} full {name}"] = _gspmd_run(
                eng, reqs)
            del eng, params
        del full
        torch.cuda.empty_cache()
        dist.barrier()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def _cpu_smoke_tokens() -> dict:
    """The port's CPU engine (one rank) on the smoke archs: the tokens the
    TP ranks must give, from the same ``init_params(cfg, 0)`` params."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine
    got = {}
    for arch in TP_SMOKE + GSPMD_SMOKE + ("gemma-2b-smoke",):
        cfg = get_config(arch)
        eng = ServeEngine(cfg, init_params(cfg, 0, device="cpu"),
                          batch_size=4, max_len=48, device="cpu")
        reqs = _smoke_requests(cfg.vocab_size)
        eng.generate(reqs)
        got[arch] = [r.generated.tolist() for r in reqs]
    return got


def phase_tp_serve(olmo_runs: dict, moe_runs: dict, card: str) -> dict:
    """Phase 7 (see the docstring): ``TP_WORLD`` ranks on the one card
    (``card``: its name and power limit), spawned once, every case inside
    them; held against phases 5 and 6b (tp 1) and the CPU engine. Returns
    the launches of the olmo-1b and mixtral-8x22b runs summed over ranks
    (the smoke archs' cross-checks are not the main path)."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    smoke_ref = _cpu_smoke_tokens()
    ssm_ref = _ssm_one_rank()
    ssm_ref.update(_split_one_rank())
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"tp serve: before the ranks, this process holds "
          f"{torch.cuda.memory_allocated()} B allocated, "
          f"{torch.cuda.memory_reserved()} B reserved; the card has {free} "
          f"of {total} B free", flush=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    t0 = time.time()
    ctx = torch.multiprocessing.start_processes(
        _tp_rank, args=(TP_WORLD, os.path.join(out_dir, "store"), out_dir),
        nprocs=TP_WORLD, start_method="spawn", join=False)
    try:
        while not ctx.join(timeout=5):
            if time.time() - t0 > TP_TIMEOUT_S:
                for proc in ctx.processes:
                    proc.kill()
                fail(f"phase 7: the ranks ran past {TP_TIMEOUT_S} s")
    except Exception as e:   # a rank raised: its traceback is in stderr
        fail(f"phase 7: a rank failed: {e}")
    ranks = []
    for r in range(TP_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    print(f"tp serve: {TP_WORLD} ranks on one card ({card}) in "
          f"{time.time() - t0:.1f}s (spawned once), backend="
          f"{r0['backend']} ({r0['why']}), CUDA tensors", flush=True)
    for arch, tp1 in ((SERVE_ARCH, olmo_runs), (MOE_ARCH, moe_runs)):
        got = np.load(os.path.join(out_dir, f"logits_{arch}.npy"))
        want = tp1["first_logits"]
        err = float(np.abs(got - want).max())
        tol = TP_LOGIT_TOL * float(np.abs(want).max())
        agree = float((got.argmax(-1) == want.argmax(-1)).mean())
        print(f"tp serve {arch}: first prefill's last-position logits at tp "
              f"{TP_WORLD} vs tp 1: max |diff| {err:.5f} (tol {tol:.5f} = "
              f"{TP_LOGIT_TOL} x max |tp 1| {np.abs(want).max():.4f}), "
              f"argmax equal in {agree:.2f} of rows; init "
              f"{r0[f'{arch} init_s']:.1f}s, rank 0's params "
              f"{r0[f'{arch} param_bytes']} B, peak "
              f"{r0[f'{arch} peak_bytes']} B; the card had "
              f"{r0[f'{arch} card_free']} B free with every rank's shard "
              f"made", flush=True)
        check(err <= tol, f"tp serve {arch}: first prefill's logits off by "
              f"{err} > {tol}")
    launches = dict(flash=0, gather=0, rows=0)
    for name in r0["cases"]:
        res = [rk["cases"][name] for rk in ranks]
        c = res[0]
        arch, layout = name.split()[:2]
        cfg = get_config(arch)
        if arch == MOE_ARCH:
            cfg = dataclasses.replace(cfg, num_layers=MOE_LAYERS)
        if not name.endswith("data2xmodel2"):  # the main path's runs
            for k in ("flash", "gather", "rows"):
                launches[k] += sum(x[k] for x in res)
        for x in res[1:]:
            check(x["tokens"] == c["tokens"],
                  f"tp serve {name}: ranks disagree on the tokens")
        calls = c["prefills"] + c["steps"]
        ffn = "moe" if cfg.moe is not None else "tp_mlp"
        want = {"tp_attn": cfg.num_layers * calls,
                ffn: cfg.num_layers * calls, "sample": 2 * calls}
        if name.endswith("data2xmodel2") and layout == "contiguous":
            want["tokens"] = calls
        check(c["counts"] == want, f"tp serve {name}: collectives "
              f"{c['counts']}, want {want} (2 x {cfg.num_layers} + 2 a "
              f"forward call, {calls} calls)")
        vcis, hits = set(c["vcis"]), c["fallback_hits"]
        check((vcis == {0} and hits == 4) if "num_vcis=1" in name
              else (len(vcis) == 4 and hits == 0),
              f"tp serve {name}: VCI map {c['vcis']}, fallback hits {hits}")
        check(all(x["leaked"] == 0 for x in res),
              f"tp serve {name}: pages leaked")
        want_flash = cfg.num_layers * c["prefills"]
        check(c["flash"] == want_flash, f"tp serve {name}: flash launched "
              f"{c['flash']} times on rank 0, want {want_flash}")
        want_gather = 2 * cfg.num_layers * c["steps"] \
            if layout == "paged" else 0
        check(c["gather"] == want_gather, f"tp serve {name}: paged gather "
              f"launched {c['gather']} times on rank 0, want {want_gather}")
        want_rows = 2 * cfg.num_layers * calls if cfg.moe is not None else 0
        check(c["rows"] == want_rows, f"tp serve {name}: row gather "
              f"launched {c['rows']} times on rank 0, want {want_rows}")
        if name.endswith("data2xmodel2"):
            check(c["tokens"] == smoke_ref[arch], f"tp serve {name}: tokens "
                  f"{c['tokens']} != the CPU engine's {smoke_ref[arch]}")
            same = "== the CPU engine's (one rank)"
        else:
            ref = (moe_runs if arch == MOE_ARCH else olmo_runs)
            ref = ref["long"] if layout == "long" else ref[layout]
            pairs = [(a, b) for x, y in zip(c["tokens"], ref["tokens"])
                     for a, b in zip(x, y)]
            share = sum(a == b for a, b in pairs) / len(pairs)
            same = f"{share:.4f} of greedy tokens equal tp 1's"
            if layout == "paged":
                tp1_pool = ref["bytes"] - _table_bytes() - 8
                pool = c["bytes"] - _table_bytes() - 8
                check(pool * TP_WORLD == tp1_pool, f"tp serve {name}: rank "
                      f"pool {pool} B x {TP_WORLD} != tp 1's {tp1_pool} B")
        if layout == "long":
            check(c["read_once"] == cfg.num_layers,
                  f"tp serve {name}: {c['read_once']} read-once launches on "
                  f"rank 0, want {cfg.num_layers} (its prefill's dispatch)")
            same += f"; {c['read_once']} row-gather launches read-once"
        print(f"tp serve {name}: {c['steps']} decode steps "
              f"{c['step_ms']:.3f} ms/step, {c['prefills']} prefills "
              f"{c['prefill_s']:.3f}s, {c['tok_s']:.1f} tok/s, "
              f"cache_bytes_resident/rank={c['bytes']}, collectives "
              f"{c['counts']} ({c['comm_s'] / c['wall_s']:.4f} of the "
              f"run's host clock), VCIs {c['vcis']} fallback_hits="
              f"{c['fallback_hits']}; rank 0 launched flash "
              f"{c['flash']}, paged gather {c['gather']}, row gather "
              f"{c['rows']}; {same}", flush=True)
    launches["ssd"] = 0
    _check_gspmd_route(ranks, olmo_runs, smoke_ref, ssm_ref, launches,
                       out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches


def _check_split(name: str, c: dict, res: list, smoke_ref: dict,
                 ssm_ref: dict, launches: dict) -> str:
    """16f: a sequence-split run against the CPU engine (the smoke arch,
    f32: equal tokens) or one rank's whole-cache engine on the card (at
    least ``SSM_GSPMD_AGREE`` of the tokens; a rank holds a quarter of its
    cache's bytes); one flash launch a layer a prefill; a decode step's
    partial attention gathered once a layer on the split's line. Adds the
    full-width runs' launches (the main path) to ``launches``."""
    from repro_torch.configs import get_config
    arch, kind, case = name.split()
    cfg = get_config(arch) if kind == "smoke" else _split_cfg()
    L = cfg.num_layers
    line = "world" if case == "split2x2" else "model"
    step = c["step_counts"]
    check(step.get(f"{line}_all_gather", 0) >= L and
          (line == "model" or step.get("world_all_gather") == L),
          f"16f {name}: a decode step's collectives {step}, want the "
          f"partial attention gathered {L} times on the {line} line")
    check(c["flash"] == L * c["prefills"] and c["gather"] == 0,
          f"16f {name}: flash {c['flash']}, paged gather {c['gather']} on "
          f"rank 0, want {L} x {c['prefills']} and 0")
    if kind == "smoke":
        check(c["tokens"] == smoke_ref[arch], f"16f {name}: tokens "
              f"{c['tokens']} != the CPU engine's {smoke_ref[arch]}")
        return "== the CPU engine's (one rank)"
    for k in ("flash", "gather", "rows"):
        launches[k] += sum(x[k] for x in res)
    ref = ssm_ref[case]
    check(4 * (c["bytes"] - 8) == ref["bytes"] - 8, f"16f {name}: a rank "
          f"holds {c['bytes']} B of cache, one rank {ref['bytes']} B")
    pairs = [(a, b) for x, y in zip(c["tokens"], ref["tokens"])
             for a, b in zip(x, y)]
    share = sum(a == b for a, b in pairs) / len(pairs)
    check(share >= SSM_GSPMD_AGREE, f"16f {name}: {share:.4f} of greedy "
          f"tokens equal one rank's on the card, want >= {SSM_GSPMD_AGREE}")
    return (f"{share:.4f} of greedy tokens equal one rank's whole-cache "
            f"engine on the card (>= {SSM_GSPMD_AGREE}); a rank holds "
            f"{c['bytes']} B of cache, one rank {ref['bytes']} B")


def _check_ssm_tp(name: str, c: dict, ref: dict, out_dir: str) -> str:
    """16e at full width on 1 x 4 (``c``: rank 0's run) against one rank's
    on the card (``ref``): tokens, the state's slices and bytes, the SSD
    launches and their heads, flash, a decode step's collectives on the
    model line, the first prefill's logits. Returns what it printed."""
    import numpy as np
    arch = name.split()[0]
    cfg = _ssm_gspmd_cfg(arch)
    sc, L = cfg.ssm, cfg.num_layers
    d_in = sc.d_inner(cfg.d_model)
    ch, h = d_in + 2 * sc.ngroups * sc.d_state, sc.num_heads(cfg.d_model)
    sites = L // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
    tp = TP_WORLD
    check(c["ssd"] == L * c["prefills"] and c["heads"] == [h // tp],
          f"gspmd route {name}: ssd_chunk launched {c['ssd']} times at "
          f"heads {c['heads']} on rank 0, want {L} x {c['prefills']} at "
          f"{h // tp}")
    check(c["flash"] == sites * c["prefills"],
          f"gspmd route {name}: flash launched {c['flash']} times on rank "
          f"0, want {sites} x {c['prefills']}")
    for st in c["states"]:
        b = st["conv"][1]
        check(st["conv"] == [L, b, sc.conv_width - 1, ch // tp] and
              st["ssd"] == [L, b, h // tp, sc.d_state, sc.head_dim],
              f"gspmd route {name}: a rank's state {st}, want conv (L, B, "
              f"{sc.conv_width - 1}, {ch // tp}) and ssd (L, B, {h // tp}, "
              f"{sc.d_state}, {sc.head_dim})")
    state = max(st["bytes"] for st in c["states"])
    check(tp * state == ref["state_bytes"], f"gspmd route {name}: a rank "
          f"holds {state} B of SSM state, one rank {ref['state_bytes']} B")
    # a Mamba2 block: in_proj and the conv output gathered, the gated
    # norm's sum of squares and out_proj all-reduced; the vocab-parallel
    # lookup's all-reduce and the logits' gather; a site's attention and
    # FFN all-reduced
    step = c["step_counts"]
    want = dict(model_all_gather=2 * L + 1,
                model_all_reduce=2 * L + 1 + 2 * sites)
    check(all(step.get(k) == v for k, v in want.items()) and
          not step.get("model_reduce_scatter"),
          f"gspmd route {name}: a decode step's collectives {step}, want "
          f"{want}")
    got = np.load(os.path.join(out_dir, f"ssm_logits_{arch}.npy"))
    err = float(np.abs(got - ref["logits"]).max())
    tol = SSM_TP_LOGIT_TOL * float(np.abs(ref["logits"]).max())
    check(err <= tol, f"gspmd route {name}: first prefill's logits off one "
          f"rank's by {err} > {tol}")
    pairs = [(a, b) for x, y in zip(c["tokens"], ref["tokens"])
             for a, b in zip(x, y)]
    share = sum(a == b for a, b in pairs) / len(pairs)
    check(share >= SSM_GSPMD_AGREE, f"gspmd route {name}: {share:.4f} of "
          f"greedy tokens equal one rank's on the card, want >= "
          f"{SSM_GSPMD_AGREE}")
    return (f"{share:.4f} of greedy tokens equal one rank's on the card "
            f"(>= {SSM_GSPMD_AGREE}); a rank's state {c['states'][0]['conv']}"
            f" + {c['states'][0]['ssd']}, {state} B against one rank's "
            f"{ref['state_bytes']} B; ssd_chunk at {c['heads']} heads; a "
            f"decode step's model-line collectives as predicted {want}; "
            f"first prefill's last-position logits max |diff| {err:.5f} "
            f"from one rank's (tol {tol:.5f} = {SSM_TP_LOGIT_TOL} x max "
            f"|one rank|)")


def _check_gspmd_route(ranks, olmo_runs: dict, smoke_ref: dict,
                       ssm_ref: dict, launches: dict, out_dir: str) -> None:
    """16d-16e: the GSPMD route's runs in phase 7's world against the
    manual-TP path's (olmo-1b: the same params and the same partial sums,
    so the same tokens), the CPU engine's (the smoke archs on data 2 x
    model 2, the SSM and the hybrid among them) and one rank's on the card
    (the SSM and the hybrid at full width, cut in depth, on 1 x 4: at
    least ``SSM_GSPMD_AGREE`` of the tokens, a quarter of the state, the
    first prefill's logits within ``SSM_TP_LOGIT_TOL``: :func:`_check_ssm_tp`);
    adds the full-width runs' launches (the main path) to ``launches``."""
    from repro_torch.configs import get_config
    r0 = ranks[0]
    for name in r0["gspmd"]:
        res = [rk["gspmd"][name] for rk in ranks]
        c = res[0]
        arch, layout = name.split()[:2]
        cfg = get_config(arch)
        for x in res[1:]:
            check(x["tokens"] == c["tokens"],
                  f"gspmd route {name}: ranks disagree on the tokens")
        check(all(x["leaked"] == 0 for x in res),
              f"gspmd route {name}: pages leaked")
        calls = c["prefills"] + c["steps"]
        if "split" in name:
            same = _check_split(name, c, res, smoke_ref, ssm_ref, launches)
            tp_counts = None
        elif name.endswith("data2xmodel2"):
            check(c["tokens"] == smoke_ref[arch], f"gspmd route {name}: "
                  f"tokens {c['tokens']} != the CPU engine's "
                  f"{smoke_ref[arch]}")
            tp_counts = r0["cases"].get(name, {}).get("counts")
            same = "== the CPU engine's (one rank)"
        elif name.endswith("1x4"):
            for k in ("flash", "gather", "rows", "ssd"):
                launches[k] += sum(x[k] for x in res)
            tp_counts = None
            same = _check_ssm_tp(name, c, ssm_ref[arch], out_dir)
        else:
            tp = r0["cases"][f"{arch} {layout} num_vcis=8"]
            check(c["tokens"] == tp["tokens"], f"gspmd route {name}: tokens "
                  f"differ from the manual-TP path's on the same params")
            want = {"model_all_reduce": (2 * cfg.num_layers + 1) * calls,
                    "model_all_gather": calls}
            check(c["counts"] == want, f"gspmd route {name}: collectives "
                  f"{c['counts']}, want {want}")
            check(c["flash"] == cfg.num_layers * c["prefills"] and
                  c["gather"] == 2 * cfg.num_layers * c["steps"],
                  f"gspmd route {name}: flash {c['flash']}, paged gather "
                  f"{c['gather']} on rank 0")
            for k in ("flash", "gather", "rows"):
                launches[k] += sum(x[k] for x in res)
            tp_counts = tp["counts"]
            pairs = [(a, b) for x, y in zip(c["tokens"],
                                             olmo_runs[layout]["tokens"])
                     for a, b in zip(x, y)]
            same = (f"== the manual-TP path's; "
                    f"{sum(a == b for a, b in pairs) / len(pairs):.4f} of "
                    f"greedy tokens equal tp 1's")
        print(f"gspmd route {name}: {c['steps']} decode steps "
              f"{c['step_ms']:.3f} ms/step, {c['prefills']} prefills "
              f"{c['prefill_s']:.3f}s, {c['tok_s']:.1f} tok/s, "
              f"cache_bytes_resident/rank={c['bytes']}; collectives on one "
              f"group a line {c['counts']} beside ServeCommPlan's by "
              f"purpose {tp_counts}, the last decode step's by line "
              f"{c['step_counts']}; rank 0 launched flash {c['flash']}, "
              f"paged gather {c['gather']}, row gather {c['rows']}; {same}",
              flush=True)


# ---------------------------------------------------------------------------
# phases 13a-13c: MoE, VLM and audio training
# ---------------------------------------------------------------------------

def _fresh(what: str) -> None:
    """Free what earlier phases hold; fail if more than ``FRESH_MAX_BYTES``
    stays allocated."""
    import torch
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"{what}: memory_allocated {held} B at its start", flush=True)
    check(held <= FRESH_MAX_BYTES, f"{what}: {held} B still allocated from "
          f"earlier phases (limit {FRESH_MAX_BYTES} B)")


def phase_row_gather_bwd() -> dict:
    """Phase 13a: the backwards of the MoE row moves against their plain
    versions, bit for bit, at mixtral-8x22b's training shapes (see the
    docstring), and through ``row_gather``'s autograd; times beside the
    bound and one library call."""
    import torch
    from repro_torch.kernels.moe_gather import (row_gather, row_gather_plain,
                                                row_gather_sum,
                                                row_gather_sum_plain)
    from repro_torch.models.moe import capacity, dispatch_tables

    _fresh("phase 13a")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    d, t = 6144, 8 * 1024
    disp, comb, asg = _routed(8, 1024, 8, 2, 1.25, gen)   # C = 320
    sdisp, scomb, sasg = _routed(4, 20, 4, 2, 2.0, gen)   # smoke, f32
    # skewed: every token to experts 0 and 1, so most assignments drop
    crowd = torch.arange(2, device=dev).expand(8, 1024, 2)
    kdisp, kcomb, kasg = dispatch_tables(
        crowd, 8, min(capacity(1024, 8, 1.25, 2), 1024))
    dropped = int((kcomb < 0).sum())
    check(dropped > 0, "phase 13a: the skewed routing dropped nothing")
    empty = torch.full((64,), -1, dtype=torch.int32, device=dev)
    # name, dtype, width, gradient rows, inverse table, K, timed
    cases = (("dispatch bwd", torch.bfloat16, d, disp.numel(), comb, 2, True),
             ("combine bwd", torch.bfloat16, d, comb.numel(), asg, 1, True),
             ("smoke dispatch bwd f32 d=256", torch.float32, 256,
              sdisp.numel(), scomb, 2, False),
             ("smoke combine bwd f32 d=256", torch.float32, 256,
              scomb.numel(), sasg, 1, False),
             ("skewed dispatch bwd", torch.bfloat16, d, kdisp.numel(), kcomb,
              2, False),
             ("skewed combine bwd", torch.bfloat16, d, kcomb.numel(), kasg,
              1, False),
             ("every entry empty", torch.bfloat16, d, 16, empty, 2, False))
    res = {"max_abs_err": 0.0}
    for name, dtype, width, m, inv, k, timed in cases:
        src = torch.randn((m, width), generator=gen, device=dev).to(dtype)
        n0 = (row_gather_sum.launches, row_gather.launches)
        got = row_gather_sum(src, inv, k)
        torch.cuda.synchronize()
        n1 = (row_gather_sum.launches - n0[0], row_gather.launches - n0[1])
        check(n1 == ((1, 0) if k > 1 else (0, 1)),
              f"row_gather_sum {name}: launches {n1}")
        want = row_gather_sum_plain(src, inv, k)
        valid = int((inv >= 0).sum())
        what = (f"row_gather_sum {name}: src {tuple(src.shape)} {dtype}, inv "
                f"{tuple(inv.shape)} ({valid} valid), K={k}")
        check(torch.equal(_bits(got), _bits(want)),
              f"{what}: kernel != plain version")
        err = (got.float() - want.float()).abs().max().item()
        res["max_abs_err"] = max(res["max_abs_err"], err)
        print(f"kernel {what}: bitwise equal to plain "
              f"({'the gather-sum kernel' if k > 1 else 'the gather kernel'})"
              f", max_abs_err={err}", flush=True)
        if not timed:
            continue
        rows = inv.numel() // k
        if k > 1:   # the library: index_add_ of the kept slots into zeros
            ids = disp.long().clamp(min=0)
            kept = torch.where((disp >= 0)[:, None], src,
                               torch.zeros((), dtype=dtype, device=dev))

            def lib(i):
                return torch.zeros((rows, width), dtype=dtype,
                                   device=dev).index_add_(0, ids, kept)
            lib_name = "index_add_ into zeros"
        else:       # K = 1 is a gather: index_select of the clamped ids
            ids = inv.long().clamp(min=0)

            def lib(i):
                return src.index_select(0, ids)
            lib_name = "index_select"
        kernel_ms, library_ms, wins = paired_ms(
            lambda i: row_gather_sum(src, inv, k), lib, n_iter=20, reps=3)
        plain_ms = time_ms(lambda i: row_gather_sum_plain(src, inv, k),
                           n_iter=20, reps=3)
        # each valid entry's row read once, every output row written once,
        # the table read once
        row = width * src.element_size()
        nbytes = valid * row + rows * row + inv.nbytes
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = dict(ms=kernel_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms)
        print(f"kernel row_gather_sum {name} times: kernel_ms="
              f"{kernel_ms:.5f} plain_ms={plain_ms:.5f} library_ms("
              f"{lib_name})={library_ms:.5f} (medians of {PAIRS} "
              f"alternating pairs, the kernel faster in {wins}) bound_ms="
              f"{bound_ms:.5f} ({nbytes} B: {valid} rows read, {rows} "
              f"written; {bound_ms / kernel_ms:.3f} of the bound)",
              flush=True)
        del src, got, want, lib, ids
    # through row_gather's autograd at the full-width tables: the dispatch
    # (x -> slots, inverse comb) and the combine (slots -> assignments,
    # inverse asg), each against autograd of the plain gather
    for name, idx, inv, rows in (("dispatch", disp, comb, t),
                                 ("combine", comb, asg, disp.numel())):
        src = torch.randn((rows, d), generator=gen, device=dev).to(
            torch.bfloat16)
        dy = torch.randn((idx.numel(), d), generator=gen, device=dev).to(
            torch.bfloat16)
        a = src.clone().requires_grad_()
        row_gather(a, idx, inv).backward(dy)
        b = src.clone().requires_grad_()
        row_gather_plain(b, idx).backward(dy)
        torch.cuda.synchronize()
        check(torch.equal(_bits(a.grad), _bits(b.grad)),
              f"row_gather's {name} backward != autograd of the plain "
              f"gather")
        print(f"kernel row_gather autograd, the {name} at 8 x 1,024 tokens: "
              f"gradient bitwise equal to autograd of the plain gather",
              flush=True)
        del src, dy, a, b
    torch.cuda.empty_cache()
    return res


def _train_run(cfg, batches, what: str, profile: bool = False,
               params=None, keep: bool = False) -> dict:
    """``make_train_step(cfg, **TRAIN_KNOBS)`` on the card from seeded
    params (or ``params``, e.g. a serve phase's): a warm-up step on
    ``batches[0]``, then the other batches as timed steps, the launch
    counts zeroed just before them and read just after; checks the counts
    and finite metrics; with ``profile``, a profile of 2 more steps.
    Returns the numbers (with ``keep``, also the trained params)."""
    import torch
    from repro_torch.core import get_comm_plan
    from repro_torch.kernels.bucket_pack import bucket_pack, bucket_unpack
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gather import row_gather, row_gather_sum
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_bwd
    from repro_torch.train.trainer import (make_train_step, optimizer_bytes,
                                           train_state_init)

    steps = len(batches) - 1 - (2 if profile else 0)
    t0 = time.time()
    state = train_state_init(cfg, 0, device="cuda", params=params)
    del params
    torch.cuda.synchronize()
    print(f"{what}: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"params={cfg.param_count() / 1e9:.3f}B {cfg.param_dtype}, "
          f"moments {cfg.optimizer_dtype}, remat={cfg.remat}, batch "
          f"{tuple(batches[0]['tokens'].shape)}, {TRAIN_KNOBS} (init "
          f"{time.time() - t0:.1f}s)", flush=True)
    torch.cuda.reset_peak_memory_stats()   # the state stays counted
    step = make_train_step(cfg, **TRAIN_KNOBS)
    t0 = time.perf_counter()
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    print(f"{what}: warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms, "
          f"loss {float(m['loss']):.4f}", flush=True)
    n_buckets = get_comm_plan(state.params, num_streams=8, num_vcis=8,
                              pack="pallas").plan.num_buckets
    kernels = {"bucket_pack": bucket_pack, "bucket_unpack": bucket_unpack,
               "flash_attention": flash_attention, "row_gather": row_gather,
               "row_gather_sum": row_gather_sum, "ssd_chunk": ssd_chunk,
               "ssd_chunk_bwd": ssd_chunk_bwd}
    for fn in kernels.values():
        fn.launches = 0
    row_gather.read_once_launches = 0
    ssd_chunk_bwd.tc_launches = 0
    times, metrics = [], []
    for b in batches[1:1 + steps]:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                 "load_balance",
                                                 "router_z")})
    counts = {k: fn.launches for k, fn in kernels.items()}
    counts["row_gather read-once"] = row_gather.read_once_launches
    counts["ssd_chunk_bwd tc"] = ssd_chunk_bwd.tc_launches
    layers, moe = cfg.num_layers, cfg.moe is not None
    ssm = layers if cfg.family in ("ssm", "hybrid") else 0
    attn = {"ssm": 0, "hybrid": layers // max(cfg.hybrid_attn_every, 1)
            }.get(cfg.family, layers)
    # a layer's attention runs in the forward and again in remat's
    # recompute; an MoE layer's two row moves likewise, plus the combine's
    # backward (the gather over asg) and the dispatch's (the gather-sum);
    # the dispatch takes the read-once route at 8 x 1,024 tokens; a Mamba2
    # layer's SSD step runs in the forward and the recompute, its backward
    # once (bf16, chunk 256: on the tensor cores); a hybrid's attention
    # runs once a site
    want = {"bucket_pack": n_buckets * steps, "bucket_unpack": steps,
            "flash_attention": 2 * attn * steps,
            "row_gather": 5 * layers * steps if moe else 0,
            "row_gather_sum": layers * steps if moe else 0,
            "ssd_chunk": 2 * ssm * steps, "ssd_chunk_bwd": ssm * steps,
            "row_gather read-once": 2 * layers * steps if moe else 0,
            "ssd_chunk_bwd tc": ssm * steps}
    check(counts == want, f"{what}: {steps} steps launched {counts}, want "
          f"{want}")
    check(all(math.isfinite(v) for mt in metrics for v in mt.values()),
          f"{what}: non-finite metrics {metrics}")
    check(not moe or all(mt["load_balance"] > 0 and mt["router_z"] > 0
                         for mt in metrics),
          f"{what}: MoE aux metrics {metrics}")
    ms = sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated()
    opt_bytes = optimizer_bytes(state.opt)
    tokens = int(batches[0]["labels"].size)
    print(f"{what}: {steps} steps, step ms {[round(x, 3) for x in times]} "
          f"(mean {ms:.3f}), {tokens / ms * 1e3:.1f} label positions/s "
          f"({tokens} a step), metrics {metrics}, max_memory_allocated "
          f"{peak} B, optimizer state {opt_bytes} B; launches {counts} "
          f"({n_buckets} buckets)", flush=True)
    if profile:
        profile_train(step, state, batches[-2:])
    out = dict(ms=ms, tok_s=tokens / ms * 1e3, peak=peak,
               opt_bytes=opt_bytes, counts=counts)
    if keep:
        out["params"] = state.params
    del state, step
    return out


def phase_train_moe() -> dict:
    """Phase 13b: full-width mixtral-8x22b training, one layer of 56 (see
    the docstring); then mixtral-8x22b-smoke card vs CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch

    _fresh("phase 13b")
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=MOE_TRAIN_LAYERS, remat="block")
    batches = [synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, step=i)
               for i in range(TRAIN_STEPS + 3)]
    run = _train_run(cfg, batches, "train moe", profile=True)
    phase_reference_train(MOE_ARCH + "-smoke")
    return run


def phase_train_mm() -> dict:
    """Phase 13c: full-width phi-3-vision-4.2b (24 of 32 layers) and
    musicgen-large (all 48) training (see the docstring), each followed by
    its smoke arch card vs CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch

    runs = {}
    for arch, layers, seq in ((VLM_ARCH, VLM_TRAIN_LAYERS, VLM_TEXT),
                              (AUDIO_ARCH, None, AUDIO_TRAIN_FRAMES)):
        _fresh(f"phase 13c {arch}")
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, remat="block",
                                  num_layers=layers or cfg.num_layers)
        seq += cfg.num_patches       # the VLM's labels span image + text
        batches = [synthetic_batch(cfg, MM_TRAIN_BATCH, seq, seed=0, step=i)
                   for i in range(MM_TRAIN_STEPS + 1)]
        runs[arch] = _train_run(cfg, batches, f"train {cfg.modality}")
        phase_reference_train(arch + "-smoke")
    return runs

# ---------------------------------------------------------------------------
# phases 14a-14c: the SSD backward, SSM and hybrid training
# ---------------------------------------------------------------------------

def ssd_bwd_work(x, B, chunk) -> tuple:
    """(FLOPs, bytes) the SSD backward needs: per (batch, group, chunk) of
    c rows the c(c+1)/2 causal pairs at 2n FLOPs for C B^T; per (batch,
    head, chunk) the pairs at 2p for dy x^T, 2p for W^T dy and 2n each for
    dC and dB, plus 4 c n p for B dst and x dst^T; x, dt, cum, B, C, dy
    (f32) and dst (f32) read once, dx, ddt, dcum, dB and dC written once."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    flops = b * g * nc * pairs * 2 * n + \
        b * h * nc * (pairs * 2 * (2 * p + 2 * n) + 4 * chunk * n * p)
    io = 2 * (x.numel() + 2 * B.numel()) * x.element_size()  # in and out
    nbytes = io + 4 * (4 * b * s * h + b * s * h * p + b * nc * h * n * p)
    return flops, nbytes


def phase_ssd_bwd() -> dict:
    """Phase 14a: the SSD backward kernel's two routes against its plain
    version (see the docstring)."""
    import torch
    from repro_torch.kernels.ssd_scan import (bwd_route, ssd_chunk_bwd,
                                              ssd_chunk_bwd_plain)

    _fresh("phase 14a")
    gen = torch.Generator(device="cuda").manual_seed(14)
    res = {"max_abs_err": 0.0}
    for name, dt_name, (b, s, h, p, g, n, chunk), timed in SSD_BWD_CASES:
        dtype = getattr(torch, dt_name)
        x, dt, cum, B, C = _ssd_inputs(dtype, b, s, h, p, g, n, chunk, gen)
        if name == "overflow":
            dt = torch.full((b, s, h), 0.1, device="cuda")
            A = -torch.linspace(1.0, 16.0, h, device="cuda")
            cum = (dt * A).reshape(b, s // chunk, chunk, h).cumsum(2) \
                .reshape(b, s, h)
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dst = torch.randn((b, s // chunk, h, n, p), generator=gen,
                          device="cuda")
        args = (x, dt, cum, B, C, dy, dst, chunk)
        route = bwd_route(x, B, C, dy, dst, chunk)
        check(route == ("tc" if dtype == torch.bfloat16 else "ffma"),
              f"ssd_chunk_bwd ({name}, {dt_name}) takes the {route} route")
        n0 = (ssd_chunk_bwd.launches, ssd_chunk_bwd.tc_launches)
        got = ssd_chunk_bwd(*args)
        again = ssd_chunk_bwd(*args)
        torch.cuda.synchronize()
        what = (f"ssd_chunk_bwd ({name}) x/B/C {dt_name} (b,s,h,p)=({b},{s},"
                f"{h},{p}) g={g} n={n} chunk={chunk} route {route}")
        counted = (ssd_chunk_bwd.launches - n0[0],
                   ssd_chunk_bwd.tc_launches - n0[1])
        check(counted == (2, 2 if route == "tc" else 0),
              f"{what}: 2 calls counted (all, tc) {counted}")
        want = ssd_chunk_bwd_plain(x.float(), dt, cum, B.float(), C.float(),
                                   dy, dst, chunk)
        errs = []
        for out, out2, ref, label in zip(got, again, want,
                                         ("dx", "ddt", "dcum", "dB", "dC")):
            check(torch.equal(_bits(out), _bits(out2)),
                  f"{what}: {label}: a second launch gave other bits")
            check(bool(torch.isfinite(out).all()),
                  f"{what}: {label} not finite")
            tol = 2e-5 * max(1.0, ref.abs().max().item())
            diff = (out.float() - ref).abs()
            err = diff.max().item()
            if out.dtype == torch.bfloat16:   # one bf16 ulp of the f32 value
                _, e = torch.frexp(ref)
                diff = diff - torch.ldexp(torch.ones_like(ref), e - 8)
            over = diff.max().item()
            check(over <= tol, f"{label} of {what}: err {err:.3e} beyond "
                  f"{'one bf16 ulp + ' if out.dtype == torch.bfloat16 else ''}"
                  f"tol {tol:.3e} by {over - tol:.3e}")
            errs.append(f"{label} {err:.3e}")
            res["max_abs_err"] = max(res["max_abs_err"], err)
        print(f"kernel {what}: max abs err vs plain f32 {', '.join(errs)} "
              f"(tol 2e-5 x max(1, max|plain|)"
              f"{' + one bf16 ulp' if dtype == torch.bfloat16 else ''}); "
              f"second launch bit-equal", flush=True)
        del got, again, want
        if timed:
            # the two routes as one pair, then the plain version against
            # the tensor cores; the FFMA route is the row's earlier kernel
            tc_ms, ffma_ms, wins = paired_ms(
                lambda i: ssd_chunk_bwd(*args),
                lambda i: ssd_chunk_bwd(*args, route="ffma"), n_iter=3,
                reps=2)
            _, plain_ms, plain_wins = paired_ms(
                lambda i: ssd_chunk_bwd(*args),
                lambda i: ssd_chunk_bwd_plain(*args), pairs=4, n_iter=3,
                reps=2)
            flops, nbytes = ssd_bwd_work(x, B, chunk)
            flop_ms = flops / (BF16_FLOPS_PER_S if dtype == torch.bfloat16
                               else FP32_FLOPS_PER_S) * 1e3
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(flop_ms, byte_ms)
            bound_by = "operations" if flop_ms > byte_ms else "bytes"
            res[name] = dict(ms=tc_ms, ffma_ms=ffma_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
            print(f"kernel ssd_chunk_bwd ({name}) times: tc_ms={tc_ms:.5f} "
                  f"ffma_ms={ffma_ms:.5f} (medians of {PAIRS} alternating "
                  f"pairs, tc faster in {wins}; {ffma_ms / tc_ms:.2f}x) "
                  f"plain_ms={plain_ms:.5f} (4 pairs, tc faster in "
                  f"{plain_wins}) library_ms=none bound_ms={bound_ms:.5f} "
                  f"({bound_by}: {nbytes} B -> {byte_ms:.5f} ms, {flops} "
                  f"causal FLOPs -> {flop_ms:.5f} ms; tc {bound_ms / tc_ms:.4f}"
                  f" of the bound, {flops / tc_ms / 1e9:.2f} TFLOP/s; ffma "
                  f"{bound_ms / ffma_ms:.4f}, {flops / ffma_ms / 1e9:.2f} "
                  f"TFLOP/s)", flush=True)
        del args, x, dt, cum, B, C, dy, dst
    torch.cuda.empty_cache()
    return res


def phase_train_ssm() -> dict:
    """Phase 14b: full-width mamba2-780m training (see the docstring); then
    mamba2-780m-smoke card vs CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch

    _fresh("phase 14b")
    cfg = dataclasses.replace(get_config(SSM_TRAIN_ARCH), remat="block",
                              num_layers=SSM_TRAIN_LAYERS)
    batches = [synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, step=i)
               for i in range(TRAIN_STEPS + 3)]
    run = _train_run(cfg, batches, "train ssm", profile=True)
    phase_reference_train(SSM_TRAIN_ARCH + "-smoke")
    return run


def phase_train_hybrid() -> dict:
    """Phase 14c: full-width zamba2-7b training, 33 of 81 layers (see the
    docstring); then zamba2-7b-smoke card vs CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch

    _fresh("phase 14c")
    cfg = dataclasses.replace(get_config(HYB_ARCH), remat="block",
                              num_layers=HYB_TRAIN_LAYERS)
    batches = [synthetic_batch(cfg, MM_TRAIN_BATCH, TRAIN_SEQ, seed=0,
                               step=i) for i in range(MM_TRAIN_STEPS + 3)]
    run = _train_run(cfg, batches, "train hybrid", profile=True)
    phase_reference_train(HYB_ARCH + "-smoke")
    return run


# ---------------------------------------------------------------------------
# phase 15: comm="gspmd" training (FSDP) and checkpoints
# ---------------------------------------------------------------------------

def phase_gspmd(train_ms: float) -> dict:
    """Phase 15a (see the docstring): one rank, ``comm="gspmd"``,
    full-width olmo-1b. Returns the flash launches and the step's ms."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.train.trainer import make_train_step, train_state_init

    _fresh("gspmd 1 rank")
    cfg = get_config(TRAIN_ARCH)
    batches = [synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, step=i)
               for i in range(GSPMD_STEPS + 1)]
    flash_attention.launches = 0
    # the paper's mode from the same state and batch: on one rank the two
    # steps are the same math
    state = train_state_init(cfg, 0, device="cuda")
    state, m = make_train_step(cfg, **TRAIN_KNOBS)(state, batches[0])
    want = (float(m["loss"]), float(m["grad_norm"]))
    del state, m
    _fresh("gspmd 1 rank, after its vci step")
    state = train_state_init(cfg, 0, device="cuda", comm="gspmd")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()   # the state stays counted
    step = make_train_step(cfg)            # comm="gspmd", the default
    t0 = time.perf_counter()
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    warm = (time.perf_counter() - t0) * 1e3
    got = (float(m["loss"]), float(m["grad_norm"]))
    for k, a, b in zip(("loss", "grad_norm"), got, want):
        check(abs(a - b) <= 1e-5 * abs(b), f"gspmd step 1 {k} {a} vs the vci "
              f"step's {b} (rtol 1e-5)")
    times, losses = [], []
    for b in batches[1:]:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    check(all(map(math.isfinite, losses)), f"gspmd: loss {losses}")
    flash = flash_attention.launches
    want_flash = 2 * cfg.num_layers * (GSPMD_STEPS + 2)
    check(flash == want_flash, f"gspmd: flash_attention launched {flash} "
          f"times, want 2 x {cfg.num_layers} x {GSPMD_STEPS + 2}")
    check(all(v == 0 for v in step.comm_tally.values()),
          f"gspmd on one rank issued collectives {step.comm_tally}")
    ms = sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated()
    print(f"gspmd 1 rank: {cfg.name} full width and depth, {cfg.param_dtype}"
          f", remat={cfg.remat}, batch {TRAIN_BATCH} x {TRAIN_SEQ}; step 1 "
          f"loss/gnorm {got} vs the vci post step's {want} (rtol 1e-5); "
          f"warm-up {warm:.1f} ms, {GSPMD_STEPS} steps ms "
          f"{[round(t, 3) for t in times]} (mean {ms:.3f}; phase 9's vci "
          f"step {train_ms:.3f}), {TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f} "
          f"tok/s, max_memory_allocated {peak} B, flash_attention launches "
          f"{flash} (the vci step, the warm-up and {GSPMD_STEPS} steps), "
          f"collectives {step.comm_tally}", flush=True)
    del state, step
    _fresh("gspmd 1 rank, done")
    return dict(flash=flash, ms=ms, peak=peak)


def _digest(t) -> str:
    """sha256 of a tensor's bytes (its bits, whatever its dtype)."""
    import hashlib
    import torch
    return hashlib.sha256(t.detach().reshape(-1).contiguous().view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()


def _gspmd_cfgs():
    """15b's f32 config and 15c's bf16 one: olmo-1b at full width,
    ``GSPMD_LAYERS`` layers."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=GSPMD_LAYERS)
    return dataclasses.replace(cfg, param_dtype="float32",
                               dtype="float32"), cfg


def _params_off(got, want) -> tuple:
    """``tests/test_torch_train.py``'s parameter rules on one leaf (or a
    rank's slice of it): (the largest difference, whether every element
    lies within 1e-4 + 2e-5 relative, the count beyond 1e-6 + 2e-5
    relative, which the tests allow in one element of 10^4)."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    return (float(d.max()), bool((d <= 1e-4 + 2e-5 * w).all()),
            int((d > 1e-6 + 2e-5 * w).sum()))


def _axis_moe(rank: int, world: int, device) -> dict:
    """16c on one of phase 15's ranks: mixtral-8x22b at full width,
    ``AXIS_MOE_LAYERS`` layer(s), bf16, ``comm="gspmd"`` on the ranks as
    data 2 x model 2 (4 of 8 experts a data rank, their ff dim over
    model), then as 4 x 1 (2 experts a rank), ``GSPMD_RANK_STEPS`` steps
    each from the same seed and batches: losses, times, launches, peaks."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.collectives import RankMesh
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gather import row_gather, row_gather_sum
    from repro_torch.train.trainer import make_train_step, train_state_init
    from repro_torch.tree import tree_flatten

    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=AXIS_MOE_LAYERS)
    batches = [synthetic_batch(cfg, AXIS_MOE_BATCH, AXIS_MOE_SEQ, seed=0,
                               step=i) for i in range(GSPMD_RANK_STEPS)]
    out = {}
    for name, mesh in (("2x2", RankMesh(2, world // 2)),
                       ("4x1", RankMesh(world, 1))):
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = row_gather.launches = 0
        row_gather_sum.launches = 0
        state = train_state_init(cfg, 0, device=device, comm="gspmd",
                                 mesh=mesh)
        step = make_train_step(cfg, mesh=mesh)
        shard = step.sharder()
        experts = state.params["layers"]["moe"]["w_gate"].shape
        losses, times = [], []
        for b in batches:
            dist.barrier()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(
            losses=losses, ms=times, tally=dict(step.comm_tally),
            experts=list(experts), flash=flash_attention.launches,
            rows=row_gather.launches, rows_sum=row_gather_sum.launches,
            ep=shard.expert_parallel(("layers", "moe", "w_gate")),
            param_bytes=sum(t.nbytes for t in tree_flatten(state.params)[0]),
            peak=torch.cuda.max_memory_allocated())
        del state, step, shard
        torch.cuda.empty_cache()
    return out


def _ssm_axis_cfg():
    """16e's training config: mamba2-780m at full width,
    ``SSM_AXIS_LAYERS`` layers, bf16, ``remat="block"``."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SSM_ARCH), remat="block",
                               num_layers=SSM_AXIS_LAYERS)


def _axis_ssm(rank: int, world: int, device) -> dict:
    """16e's training run on one of phase 15's ranks: mamba2-780m
    (:func:`_ssm_axis_cfg`), ``comm="gspmd"`` on the ranks as data 2 x
    model 2 (the Mamba2 blocks tensor-parallel: 24 of 48 heads a rank),
    ``GSPMD_RANK_STEPS`` steps of phase 9's global batch: losses, times,
    the SSD launches and their heads, the step's collectives, peak."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.collectives import RankMesh
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_bwd
    from repro_torch.train.trainer import make_train_step, train_state_init

    cfg = _ssm_axis_cfg()
    mesh = RankMesh(2, world // 2)
    torch.cuda.reset_peak_memory_stats()
    ssd_chunk.launches = 0
    ssd_chunk_bwd.launches = ssd_chunk_bwd.tc_launches = 0
    state = train_state_init(cfg, 0, device=device, comm="gspmd", mesh=mesh)
    step = make_train_step(cfg, mesh=mesh)
    losses, times = [], []
    with _ssd_heads() as heads:
        for i in range(GSPMD_RANK_STEPS):
            b = synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, step=i)
            dist.barrier()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
    out = dict(losses=losses, ms=times, tally=dict(step.comm_tally),
               heads=sorted(heads), ssd=ssd_chunk.launches,
               ssd_bwd=ssd_chunk_bwd.launches,
               ssd_bwd_tc=ssd_chunk_bwd.tc_launches,
               peak=torch.cuda.max_memory_allocated())
    del state, step
    torch.cuda.empty_cache()
    return out


def _gspmd_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One of phase 15's ranks (15b and 15c): join the shared-card group,
    train FSDP in f32 against the one-rank run in ``ref.pt``, then in bf16
    through a checkpoint and a resume; write what it saw to
    ``gspmd_rank<r>.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import load_state, save_state
    from repro_torch.core.collectives import RankMesh
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.dist.sharding import param_shapes
    from repro_torch.kernels.bucket_pack import bucket_pack, bucket_unpack
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import join_ranks
    from repro_torch.train.trainer import make_train_step, train_state_init
    from repro_torch.tree import tree_flatten, tree_flatten_with_paths

    def leaves(tree):
        return [t for _, t in tree_flatten_with_paths(tree)]

    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device, backend, why = join_ranks(rank, world, "cuda", store)
    out = dict(backend=backend, why=why)
    try:
        f32, bf16 = _gspmd_cfgs()
        batches = [synthetic_batch(f32, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                                   step=i) for i in range(3)]
        # 15b: FSDP in f32 against the one-rank run
        ref = torch.load(os.path.join(out_dir, "ref.pt"), mmap=True)
        flash_attention.launches = 0
        state = train_state_init(f32, 0, device=device, comm="gspmd")
        step = make_train_step(f32)
        shard = step.sharder()
        metrics, tallies, times = [], [], []
        for b in batches[:GSPMD_RANK_STEPS]:
            dist.barrier()
            t0 = time.perf_counter()
            state, m = step(state, b)
            metrics.append([float(m[k]) for k in ("loss", "grad_norm")])
            times.append((time.perf_counter() - t0) * 1e3)
            tallies.append(dict(step.comm_tally))
        sliced = {"/".join(p): shard.sharded_dim(p) is not None
                  for p, _ in tree_flatten_with_paths(state.params)}
        want_p = want_m = 0
        for p, leaf in tree_flatten_with_paths(param_shapes(f32)):
            part = world if sliced["/".join(p)] else 1
            want_p += leaf.numel() * 4 // part
            want_m += 2 * leaf.numel() * 4 // part
        close = [_params_off(t, shard.shard_leaf(p, ref[i]).to(device))
                 for i, (p, t) in enumerate(
                     tree_flatten_with_paths(state.params))]
        close = dict(worst=max(c[0] for c in close),
                     rule1=all(c[1] for c in close),
                     off=[c[2] for c in close],
                     total=sum(t.numel() for t in tree_flatten(
                         state.params)[0]))
        out["b"] = dict(
            metrics=metrics, ms=times, tally=tallies,
            flash=flash_attention.launches,
            param_bytes=sum(t.nbytes for t in tree_flatten(state.params)[0]),
            moment_bytes=sum(t.nbytes for t in tree_flatten(
                (state.opt.m, state.opt.v))[0]),
            want_param_bytes=want_p, want_moment_bytes=want_m,
            sliced=sum(sliced.values()), leaves=len(sliced),
            peak=torch.cuda.max_memory_allocated(), **close)
        del state, step, ref
        torch.cuda.empty_cache()

        # 16a: the same f32 run on the ranks as data 2 x model 2 (FSDP over
        # the data lines, TP over the model lines)
        mesh = RankMesh(2, world // 2)
        ref = torch.load(os.path.join(out_dir, "ref.pt"), mmap=True)
        flash_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        state = train_state_init(f32, 0, device=device, comm="gspmd",
                                 mesh=mesh)
        step = make_train_step(f32, mesh=mesh)
        shard = step.sharder()
        metrics, tallies, times = [], [], []
        for b in batches[:GSPMD_RANK_STEPS]:
            dist.barrier()
            t0 = time.perf_counter()
            state, m = step(state, b)
            metrics.append([float(m[k]) for k in ("loss", "grad_norm")])
            times.append((time.perf_counter() - t0) * 1e3)
            tallies.append(dict(step.comm_tally))
            if len(metrics) == 1:   # 16a's first step, for the pod mesh
                first = [_digest(t) for t in leaves(state.params)]
        close = [_params_off(t, shard.shard_leaf(p, ref[i]).to(device))
                 for i, (p, t) in enumerate(
                     tree_flatten_with_paths(state.params))]
        out["a"] = dict(
            metrics=metrics, ms=times, tally=tallies,
            flash=flash_attention.launches,
            param_bytes=sum(t.nbytes for t in tree_flatten(state.params)[0]),
            moment_bytes=sum(t.nbytes for t in tree_flatten(
                (state.opt.m, state.opt.v))[0]),
            both=sum(shard.split_key(p) == "both"
                     for p, _ in tree_flatten_with_paths(state.params)),
            peak=torch.cuda.max_memory_allocated(),
            worst=max(c[0] for c in close), rule1=all(c[1] for c in close),
            off=[c[2] for c in close])
        del state, step, ref, shard
        torch.cuda.empty_cache()

        # 16a on the pod mesh 2 x 1 x 2: the data line is the two pods, the
        # lines those of 2 x 2, so its first step is 16a's bit for bit
        pod = RankMesh(2, 1, world // 2)
        flash_attention.launches = 0
        state = train_state_init(f32, 0, device=device, comm="gspmd",
                                 mesh=pod)
        step = make_train_step(f32, mesh=pod)
        dist.barrier()
        state, m = step(state, batches[0])
        out["a"]["pod"] = dict(
            loss=float(m["loss"]), loss_2x2=metrics[0][0],
            same=[_digest(t) for t in leaves(state.params)] == first,
            flash=flash_attention.launches)
        del state, step
        torch.cuda.empty_cache()

        # 16b: comm="vci" on the same mesh: the model whole on every rank,
        # the buckets reduced over the data lines
        flash_attention.launches = 0
        bucket_pack.launches = bucket_unpack.launches = 0
        torch.cuda.reset_peak_memory_stats()
        knobs = dict(comm="vci", pack="pallas", num_streams=8)
        state = train_state_init(f32, 0, device=device, mesh=mesh, **knobs)
        step = make_train_step(f32, mesh=mesh, num_vcis=8, **knobs)
        metrics, times = [], []
        for b in batches[:GSPMD_RANK_STEPS]:
            dist.barrier()
            t0 = time.perf_counter()
            state, m = step(state, b)
            metrics.append([float(m[k]) for k in ("loss", "grad_norm")])
            times.append((time.perf_counter() - t0) * 1e3)
        out["vci"] = dict(
            metrics=metrics, ms=times, flash=flash_attention.launches,
            packs=bucket_pack.launches, unpacks=bucket_unpack.launches,
            param_bytes=sum(t.nbytes for t in tree_flatten(state.params)[0]),
            peak=torch.cuda.max_memory_allocated())
        del state, step
        torch.cuda.empty_cache()

        # 15c: bf16 FSDP, a checkpoint after step 2, a resume, step 3
        flash_attention.launches = 0
        state = train_state_init(bf16, 0, device=device, comm="gspmd")
        step = make_train_step(bf16)
        shard = step.sharder()
        for b in batches[:2]:
            state, _ = step(state, b)
        ckpt = os.path.join(out_dir, "ckpt")
        t0 = time.perf_counter()
        save_state(ckpt, 2, state, shard=shard, metadata={"arch": bf16.name})
        save_s = time.perf_counter() - t0
        saved = [t.clone() for t in leaves(state)]
        out["c"] = dict(save_s=save_s, digests=[
            _digest(t) for t in saved])
        state, m = step(state, batches[2])
        full = [t.clone() for t in leaves(state)]
        loss3 = float(m["loss"])
        del state
        like = train_state_init(bf16, 1, device=device, comm="gspmd")
        t0 = time.perf_counter()
        back = load_state(ckpt, 2, like, shard=shard)
        load_s = time.perf_counter() - t0
        del like
        same = [_digest(a) == d for a, d in
                zip(leaves(back), out["c"]["digests"])]
        check(all(same), f"15c rank {rank}: the restored state differs "
              f"from the saved one at leaves "
              f"{[i for i, s in enumerate(same) if not s]}")
        back, m = step(back, batches[2])
        diffs = [float((a.float() - b.float()).abs().max())
                 for a, b in zip(leaves(back), full)]
        out["c"].update(load_s=load_s, loss3=loss3,
                        loss3_resumed=float(m["loss"]),
                        resume_bitwise=all(
                            _digest(a) == _digest(b) for a, b in
                            zip(leaves(back), full)),
                        resume_max_diff=max(diffs),
                        flash=flash_attention.launches)
        del back, full, saved
        torch.cuda.empty_cache()
        out["moe"] = _axis_moe(rank, world, device)
        out["ssm"] = _axis_ssm(rank, world, device)
        dist.barrier()
    finally:
        with open(os.path.join(out_dir, f"gspmd_rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def phase_gspmd_ranks(card: str) -> dict:
    """Phases 15b and 15c (see the docstring): the one-rank f32 run here,
    then ``GSPMD_WORLD`` ranks on the one card, spawned once, then the
    checkpoint restored on one rank here. Returns the flash launches."""
    import tempfile
    import torch
    from repro_torch.checkpoint import load_state
    from repro_torch.core.collectives import RankMesh
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.dist.sharding import Sharder
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.train.trainer import make_train_step, train_state_init
    from repro_torch.tree import tree_flatten, tree_flatten_with_paths

    _fresh("gspmd ranks")
    f32, bf16 = _gspmd_cfgs()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_gspmd_")
    batches = [synthetic_batch(f32, TRAIN_BATCH, TRAIN_SEQ, seed=0, step=i)
               for i in range(3)]
    # the one-rank run (no group: one rank) the ranks are held against
    flash_attention.launches = 0
    state = train_state_init(f32, 0, device="cuda", comm="gspmd")
    step = make_train_step(f32)
    ref_metrics = []
    for b in batches[:GSPMD_RANK_STEPS]:
        state, m = step(state, b)
        ref_metrics.append([float(m["loss"]), float(m["grad_norm"])])
    torch.save([t.cpu() for t in tree_flatten(state.params)[0]],
               os.path.join(out_dir, "ref.pt"))
    # the yardstick: the same math with another order of the same sums,
    # one rank taking the ranks' rows as GSPMD_WORLD microbatches
    alt = train_state_init(f32, 0, device="cuda", comm="gspmd")
    astep = make_train_step(f32, accum_steps=GSPMD_WORLD)
    for b in batches[:GSPMD_RANK_STEPS]:
        alt, _ = astep(alt, b)
    order = [_params_off(a, w) for a, w in zip(
        tree_flatten(alt.params)[0], tree_flatten(state.params)[0])]
    flash = flash_attention.launches
    del state, step, alt, astep
    _fresh("gspmd ranks, after the one-rank run")
    # 16e's yardstick: the mamba2 training run's first step on one rank
    ssm_cfg = _ssm_axis_cfg()
    state = train_state_init(ssm_cfg, 0, device="cuda", comm="gspmd")
    _, m = make_train_step(ssm_cfg)(state, synthetic_batch(
        ssm_cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, step=0))
    ssm_loss = float(m["loss"])
    del state, m
    _fresh("gspmd ranks, after 16e's one-rank step")

    t0 = time.time()
    ctx = torch.multiprocessing.start_processes(
        _gspmd_rank, args=(GSPMD_WORLD, os.path.join(out_dir, "store"),
                           out_dir),
        nprocs=GSPMD_WORLD, start_method="spawn", join=False)
    try:
        while not ctx.join(timeout=5):
            if time.time() - t0 > GSPMD_TIMEOUT_S:
                for proc in ctx.processes:
                    proc.kill()
                fail(f"phase 15: the ranks ran past {GSPMD_TIMEOUT_S} s")
    except Exception as e:   # a rank raised: its traceback is in stderr
        fail(f"phase 15: a rank failed: {e}")
    ranks = []
    for r in range(GSPMD_WORLD):
        with open(os.path.join(out_dir, f"gspmd_rank{r}.json")) as f:
            ranks.append(json.load(f))
    spawn_s = time.time() - t0
    b0 = ranks[0]["b"]
    for r, rk in enumerate(ranks):
        b = rk["b"]
        check(b["metrics"] == b0["metrics"], f"15b: rank {r}'s metrics "
              f"{b['metrics']} differ from rank 0's {b0['metrics']}")
        check(b["param_bytes"] == b["want_param_bytes"] and
              b["moment_bytes"] == b["want_moment_bytes"],
              f"15b: rank {r} holds {b['param_bytes']} B of params and "
              f"{b['moment_bytes']} B of moments, want "
              f"{b['want_param_bytes']} and {b['want_moment_bytes']}")
        flash += b["flash"] + rk["c"]["flash"] + rk["a"]["flash"] \
            + rk["a"]["pod"]["flash"] + rk["vci"]["flash"] + sum(x["flash"] for x in rk["moe"].values())
    for got, want in zip(b0["metrics"], ref_metrics):
        for a, w in zip(got, want):
            check(abs(a - w) <= 1e-5 * abs(w), f"15b: {GSPMD_WORLD} ranks' "
                  f"loss/gnorm {got} vs one rank's {want} (rtol 1e-5)")
    total = sum(rk["b"]["total"] for rk in ranks)
    off = [sum(rk["b"]["off"][i] for rk in ranks)
           for i in range(len(b0["off"]))]
    yard = [c[2] for c in order]
    print(f"gspmd ranks: 15b params against the one-rank run, by leaf: "
          f"beyond 1e-6 + 2e-5 rel {off} ({sum(off)} of {total}; the tests "
          f"allow {total // 10 ** 4}), max abs diff "
          f"{max(rk['b']['worst'] for rk in ranks):.3e} (tol 1e-4 + 2e-5 "
          f"rel); one rank with {GSPMD_WORLD} microbatches against one "
          f"rank with one: {yard} ({sum(yard)}), max abs diff "
          f"{max(c[0] for c in order):.3e}", flush=True)
    check(all(rk["b"]["rule1"] for rk in ranks), "15b: a param element off "
          "the one-rank run by more than 1e-4 + 2e-5 rel")
    # at full width the count of elements at the summation noise outgrows
    # the tests' share: held to what another order of the same sums gives
    check(sum(off) <= max(total // 10 ** 4, 2 * sum(yard)),
          f"15b: {sum(off)} of {total} param elements beyond 1e-6 + 2e-5 "
          f"rel, against {sum(yard)} from another order of the sums")
    check(b0["sliced"] > 0 and b0["param_bytes"] * GSPMD_WORLD >
          b0["want_param_bytes"], "15b: nothing was sliced")
    tally = b0["tally"][-1]
    print(f"gspmd ranks: {GSPMD_WORLD} ranks on one card ({card}) in "
          f"{spawn_s:.1f}s, backend={ranks[0]['backend']} "
          f"({ranks[0]['why']}), CUDA tensors; 15b: {TRAIN_ARCH} at full "
          f"width, {GSPMD_LAYERS} layers, f32, global batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {GSPMD_RANK_STEPS} steps: loss/gnorm {b0['metrics']}"
          f" equal on every rank, one rank's {ref_metrics} (rtol 1e-5); "
          f"params within the train tests' rules; a rank holds "
          f"{b0['param_bytes']} B of params and {b0['moment_bytes']} B of "
          f"moments ({b0['sliced']} of {b0['leaves']} leaves sliced 1/"
          f"{GSPMD_WORLD}, to the byte); a step: {tally['all_gather']} "
          f"all-gathers ({tally['gather_bytes']} B received), "
          f"{tally['reduce_scatter']} reduce-scatters "
          f"({tally['scatter_bytes']} B sent), {tally['all_reduce']} "
          f"all-reduces; step ms (rank 0) "
          f"{[round(t, 1) for t in b0['ms']]}; peak a rank "
          f"{[rk['b']['peak'] for rk in ranks]} B", flush=True)
    per_layer = 7
    check(tally["all_gather"] == 2 * per_layer * GSPMD_LAYERS + 2 and
          tally["reduce_scatter"] == per_layer * GSPMD_LAYERS + 2,
          f"15b: a step's collectives {tally}, predicted "
          f"{2 * per_layer * GSPMD_LAYERS + 2} gathers and "
          f"{per_layer * GSPMD_LAYERS + 2} reduce-scatters")

    # 15c: the checkpoint restored on one rank, each leaf's 4 slices
    # against the digests of the ranks' saved slices
    c0 = ranks[0]["c"]
    like = train_state_init(bf16, 1, device="cuda", comm="gspmd")
    t0 = time.perf_counter()
    back = load_state(os.path.join(out_dir, "ckpt"), 2, like)
    load_s = time.perf_counter() - t0
    del like
    cuts = [Sharder(RankMesh(GSPMD_WORLD, 1), bf16, rank=r)
            for r in range(GSPMD_WORLD)]
    for i, (p, t) in enumerate(tree_flatten_with_paths(back)):
        for r, cut in enumerate(cuts):
            part = t
            if p[0] == "params":
                part = cut.shard_leaf(p[1:], t)
            elif p[0] == "opt" and p[1] in ("m", "v"):
                part = cut.shard_leaf(p[2:], t)
            check(_digest(part) == ranks[r]["c"]["digests"][i],
                  f"15c: leaf {'/'.join(p)} restored on one rank differs "
                  f"from rank {r}'s saved slice")
    step = make_train_step(bf16)
    back, m = step(back, batches[2])
    one_loss3 = float(m["loss"])
    del back, step
    ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in
                     os.walk(os.path.join(out_dir, "ckpt")) for f in fs)
    shutil.rmtree(out_dir, ignore_errors=True)
    bitwise = all(rk["c"]["resume_bitwise"] for rk in ranks)
    print(f"gspmd ranks: 15c: {TRAIN_ARCH} {GSPMD_LAYERS} layers bf16 FSDP "
          f"on {GSPMD_WORLD} ranks, saved after step 2 as whole leaves "
          f"({ckpt_bytes} B on disk, {c0['save_s']:.2f} s), restored on "
          f"{GSPMD_WORLD} ranks ({c0['load_s']:.2f} s) and on one "
          f"({load_s:.2f} s): equal to the saved state bit for bit on both; "
          f"step 3 after the resume on {GSPMD_WORLD} ranks "
          f"{'equals' if bitwise else 'differs from'} the uninterrupted "
          f"step 3 bit for bit (max abs diff "
          f"{max(rk['c']['resume_max_diff'] for rk in ranks):.3e}; loss "
          f"{c0['loss3_resumed']} vs {c0['loss3']}); on one rank its loss "
          f"{one_loss3}", flush=True)
    check(math.isfinite(one_loss3) and abs(one_loss3 - c0["loss3"]) <=
          2 ** -7 * abs(c0["loss3"]), f"15c: one rank's step 3 loss "
          f"{one_loss3} vs {GSPMD_WORLD} ranks' {c0['loss3']}")
    launches = _check_axis(ranks, ref_metrics, yard, total, card)
    launches.update(_check_axis_ssm(ranks, ssm_loss, card))
    _fresh("gspmd ranks, done")
    return dict(flash=flash, bitwise=bitwise, **launches)


def _check_axis(ranks, ref_metrics, yard, total: int, card: str) -> dict:
    """Phase 16a-16c's checks on phase 15's ranks (see the docstring);
    returns their pack, unpack, row-gather and gather-sum launches, summed
    over the ranks."""
    a0, b0 = ranks[0]["a"], ranks[0]["b"]
    for r, rk in enumerate(ranks):
        a = rk["a"]
        check(a["metrics"] == a0["metrics"], f"16a: rank {r}'s metrics "
              f"{a['metrics']} differ from rank 0's {a0['metrics']}")
        # every olmo-1b leaf divides both axes: a rank holds a quarter on
        # 2 x 2 as on 4 x 1
        check(a["param_bytes"] == b0["want_param_bytes"] and
              a["moment_bytes"] == b0["want_moment_bytes"],
              f"16a: rank {r} holds {a['param_bytes']} B of params and "
              f"{a['moment_bytes']} B of moments, want "
              f"{b0['want_param_bytes']} and {b0['want_moment_bytes']}")
        check(rk["vci"]["metrics"] == ranks[0]["vci"]["metrics"],
              f"16b: rank {r}'s metrics differ from rank 0's")
    for got, want in zip(a0["metrics"], ref_metrics):
        for x, w in zip(got, want):
            check(abs(x - w) <= 1e-5 * abs(w), f"16a: 2 x 2 loss/gnorm "
                  f"{got} vs one rank's {want} (rtol 1e-5)")
    off = [sum(rk["a"]["off"][i] for rk in ranks)
           for i in range(len(a0["off"]))]
    check(all(rk["a"]["rule1"] for rk in ranks), "16a: a param element off "
          "the one-rank run by more than 1e-4 + 2e-5 rel")
    check(sum(off) <= max(total // 10 ** 4, 2 * sum(yard)),
          f"16a: {sum(off)} of {total} param elements beyond 1e-6 + 2e-5 "
          f"rel, against {sum(yard)} from another order of the sums")
    t = a0["tally"][-1]
    print(f"axis 16a: {TRAIN_ARCH} at full width, {GSPMD_LAYERS} layers, "
          f"f32, comm=gspmd on {GSPMD_WORLD} ranks of one card ({card}) as "
          f"data 2 x model 2: loss/gnorm {a0['metrics']} equal on every "
          f"rank, one rank's {ref_metrics} (rtol 1e-5); params beyond 1e-6 "
          f"+ 2e-5 rel {off} ({sum(off)} of {total}; yardstick "
          f"{sum(yard)}), max abs diff "
          f"{max(rk['a']['worst'] for rk in ranks):.3e}; a rank holds "
          f"{a0['param_bytes']} B of params and {a0['moment_bytes']} B of "
          f"moments ({a0['both']} leaves sliced over both axes); a step: "
          f"data line {t['all_gather']} all-gathers ({t['gather_bytes']} "
          f"B), {t['reduce_scatter']} reduce-scatters, {t['all_reduce']} "
          f"all-reduces; model line {t['model_all_reduce']} all-reduces, "
          f"{t['model_all_gather']} all-gathers; flash launches "
          f"{a0['flash']} on rank 0; step ms (rank 0) "
          f"{[round(x, 1) for x in a0['ms']]}; peak a rank "
          f"{[rk['a']['peak'] for rk in ranks]} B", flush=True)
    for r, rk in enumerate(ranks):
        p = rk["a"]["pod"]
        check(p["same"] and p["loss"] == p["loss_2x2"], f"16a: rank {r}'s "
              f"step on 2 x 1 x 2 differs from its 2 x 2 step (loss "
              f"{p['loss']} vs {p['loss_2x2']}, params bitwise "
              f"{p['same']})")
    print(f"axis 16a: one step on the pod mesh 2 x 1 x 2 (pod x data x "
          f"model) equals the 2 x 2 step bit for bit on every rank: loss "
          f"{a0['pod']['loss']}, every param leaf's bytes", flush=True)
    v0 = ranks[0]["vci"]
    check(abs(v0["metrics"][0][0] - a0["metrics"][0][0]) <=
          1e-5 * abs(a0["metrics"][0][0]), f"16b: vci loss "
          f"{v0['metrics'][0][0]} vs 16a's {a0['metrics'][0][0]} (rtol "
          f"1e-5)")
    check(v0["param_bytes"] == b0["want_param_bytes"] * GSPMD_WORLD,
          f"16b: a rank holds {v0['param_bytes']} B of params, not the "
          f"whole {b0['want_param_bytes'] * GSPMD_WORLD}")
    check(v0["packs"] == 8 * GSPMD_RANK_STEPS and
          v0["unpacks"] == GSPMD_RANK_STEPS, f"16b: {v0['packs']} packs, "
          f"{v0['unpacks']} unpacks on rank 0, want 8 and 1 a step")
    print(f"axis 16b: the same config, comm=vci post (8 buckets on the data "
          f"lines' VCIs, pack=pallas) on data 2 x model 2: loss/gnorm "
          f"{v0['metrics']} equal on every rank (16a's first loss "
          f"{a0['metrics'][0][0]}); params whole on each rank "
          f"({v0['param_bytes']} B); rank 0 launched pack {v0['packs']}, "
          f"unpack {v0['unpacks']}, flash {v0['flash']}; step ms (rank 0) "
          f"{[round(x, 1) for x in v0['ms']]}; peak a rank "
          f"{[rk['vci']['peak'] for rk in ranks]} B", flush=True)
    m0 = ranks[0]["moe"]
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    e = cfg.moe.num_experts
    for name, want_e, want_ff in (("2x2", e // 2, cfg.d_ff // 2),
                                  ("4x1", e // GSPMD_WORLD, cfg.d_ff)):
        x = m0[name]
        check(all(rk["moe"][name]["losses"] == x["losses"] for rk in ranks),
              f"16c {name}: the ranks' losses differ")
        check(all(map(math.isfinite, x["losses"])), f"16c {name}: loss "
              f"{x['losses']}")
        check(x["ep"] and x["experts"][1] == want_e and
              x["experts"][3] == want_ff, f"16c {name}: expert table slice "
              f"{x['experts']}, want {want_e} experts of ff {want_ff}")
        n = AXIS_MOE_LAYERS * GSPMD_RANK_STEPS
        check(x["rows"] == 5 * n and x["rows_sum"] == n and
              x["flash"] == 2 * n, f"16c {name}: row_gather {x['rows']}, "
              f"row_gather_sum {x['rows_sum']}, flash {x['flash']} on rank "
              f"0, want 5, 1 and 2 a layer a step")
        # dispatch and combine, forward, remat's recompute and backward
        check(x["tally"]["all_to_all"] == 6 * AXIS_MOE_LAYERS,
              f"16c {name}: {x['tally']['all_to_all']} all_to_alls a step")
    a, b = m0["2x2"]["losses"], m0["4x1"]["losses"]
    check(all(abs(x - y) <= 2 ** -7 * abs(y) for x, y in zip(a, b)),
          f"16c: 2 x 2 losses {a} vs 4 x 1 {b} (2^-7 rel)")
    for name in ("2x2", "4x1"):
        x = m0[name]
        print(f"axis 16c: {MOE_ARCH} at full width, {AXIS_MOE_LAYERS} "
              f"layer, bf16, comm=gspmd, global batch {AXIS_MOE_BATCH} x "
              f"{AXIS_MOE_SEQ}, {name}: losses {x['losses']} (2 x 2 against "
              f"4 x 1 within 2^-7 rel), expert tables a rank {x['experts']} "
              f"(never gathered), a step {x['tally']}; rank 0 launched "
              f"row_gather {x['rows']}, row_gather_sum {x['rows_sum']}, "
              f"flash {x['flash']}; params a rank {x['param_bytes']} B; step "
              f"ms (rank 0) {[round(t, 1) for t in x['ms']]}; peak a rank "
              f"{[rk['moe'][name]['peak'] for rk in ranks]} B "
              f"({sum(rk['moe'][name]['peak'] for rk in ranks)} B on the "
              f"card)", flush=True)
    return dict(
        packs=sum(rk["vci"]["packs"] for rk in ranks),
        unpacks=sum(rk["vci"]["unpacks"] for rk in ranks),
        rows=sum(x["rows"] for rk in ranks for x in rk["moe"].values()),
        rows_sum=sum(x["rows_sum"] for rk in ranks
                     for x in rk["moe"].values()))


def _check_axis_ssm(ranks, one_loss: float, card: str) -> dict:
    """16e's training run on phase 15's ranks (see the docstring) against
    one rank's first loss ``one_loss``; returns its SSD forward and
    backward launches, summed over the ranks."""
    cfg = _ssm_axis_cfg()
    L = cfg.num_layers
    h = cfg.ssm.num_heads(cfg.d_model) // (GSPMD_WORLD // 2)
    x = ranks[0]["ssm"]
    check(all(rk["ssm"]["losses"] == x["losses"] for rk in ranks),
          "16e train: the ranks' losses differ")
    check(all(map(math.isfinite, x["losses"])), f"16e train: loss "
          f"{x['losses']}")
    check(abs(x["losses"][0] - one_loss) <= 2 ** -7 * abs(one_loss),
          f"16e train: 2 x 2 first loss {x['losses'][0]} vs one rank's "
          f"{one_loss} (2^-7 rel)")
    n = L * GSPMD_RANK_STEPS
    for r, rk in enumerate(ranks):
        y = rk["ssm"]
        check(y["ssd"] == 2 * n and y["ssd_bwd"] == n and
              y["ssd_bwd_tc"] == n and y["heads"] == [h],
              f"16e train: rank {r} launched ssd_chunk {y['ssd']}, "
              f"ssd_chunk_bwd {y['ssd_bwd']} ({y['ssd_bwd_tc']} on the "
              f"tensor cores) at heads {y['heads']}, want 2, 1 and 1 a "
              f"layer a step at {h}")
    print(f"axis 16e train: {SSM_ARCH} at full width, {L} layers, bf16, "
          f"remat=block, comm=gspmd, global batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, data 2 x model 2 on one card ({card}): the Mamba2 "
          f"blocks tensor-parallel ({h} heads a rank); losses {x['losses']} "
          f"equal on every rank, first against one rank's {one_loss} "
          f"(2^-7 rel); rank 0 launched ssd_chunk {x['ssd']}, "
          f"ssd_chunk_bwd {x['ssd_bwd']} (tensor cores {x['ssd_bwd_tc']}) "
          f"at {x['heads']} heads; a step {x['tally']}; step ms (rank 0) "
          f"{[round(t, 1) for t in x['ms']]}; peak a rank "
          f"{[rk['ssm']['peak'] for rk in ranks]} B", flush=True)
    return dict(ssd=sum(rk["ssm"]["ssd"] for rk in ranks),
                ssd_bwd=sum(rk["ssm"]["ssd_bwd"] for rk in ranks))


def phase_ckpt_cli() -> None:
    """15c's CLI: ``--steps 4 --ckpt-every 2`` at smoke size on the card,
    then ``--steps 6`` in the same directory, which must resume."""
    import tempfile
    ck = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    outs = []
    try:
        for steps in (4, 6):
            t0 = time.time()
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 "olmo-1b-smoke", "--steps", str(steps), "--batch", "4",
                 "--seq", "32", "--log-every", "1", "--ckpt-every", "2",
                 "--ckpt-dir", ck], capture_output=True, text=True,
                timeout=300, env=env, cwd=HERE)
            check(r.returncode == 0, f"15c: the CLI (--steps {steps}) "
                  f"failed:\n{r.stdout}\n{r.stderr}")
            outs.append((r.stdout, time.time() - t0))
        check("resumed from step 4" in outs[1][0], f"15c: the CLI did not "
              f"resume:\n{outs[1][0]}")
        check(sorted(os.listdir(ck)) == [f"step_{s:08d}" for s in
                                         (2, 4, 6)], f"15c: {os.listdir(ck)}")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    lines = [ln for ln in outs[1][0].splitlines()
             if ln.startswith(("resumed", "step"))]
    print(f"ckpt cli: olmo-1b-smoke on the card, --steps 4 --ckpt-every 2 "
          f"({outs[0][1]:.1f} s) then --steps 6 ({outs[1][1]:.1f} s): "
          f"{lines}", flush=True)


# ---------------------------------------------------------------------------
# phase 17: kv_fp8 cache storage, yi-9b at full width and depth
# ---------------------------------------------------------------------------

def phase_fp8_cast() -> int:
    """17a: the port's cache cast (``to_cache_dtype``: a clamp to +-448,
    then torch's cast) of all 65,536 bf16 bit patterns to float8_e4m3fn:
    the card's bytes equal the CPU's on every non-NaN pattern (a NaN gives
    an fp8 NaN on both; its sign bit may differ), and both saturate (466
    and inf give 448). torch's own cast is printed beside it, on the card and on this
    machine's CPU: its overflow differs between torch builds (2.13's CPU
    cast saturates; 2.11's gives NaN from 466 up), which is why the port
    clamps first."""
    import numpy as np
    import torch
    from repro_torch.models.attention import to_cache_dtype
    f8 = torch.float8_e4m3fn
    bits = torch.from_numpy(np.arange(65536, dtype=np.uint16).view(
        np.int16).copy()).view(torch.bfloat16)
    cpu = to_cache_dtype(bits, f8).view(torch.uint8)
    card = to_cache_dtype(bits.cuda(), f8).view(torch.uint8).cpu()
    nan = torch.isnan(bits.float())
    off = int((cpu != card)[~nan].sum())
    bad = (cpu != card).nonzero().flatten()[:8].tolist()
    check(off == 0, f"17a: the card's cache cast differs from the CPU's on "
          f"{off} of {int((~nan).sum())} non-NaN bf16 patterns (first: "
          f"{[(hex(i), int(cpu[i]), int(card[i])) for i in bad]})")
    # a NaN input (no finite K/V makes one) gives an fp8 NaN on both; only
    # its sign bit may differ
    check(bool(((cpu[nan] & 0x7f) == 0x7f).all() and
               ((card[nan] & 0x7f) == 0x7f).all()),
          "17a: a NaN bf16 pattern did not cast to an fp8 NaN")
    nan_sign = int((cpu != card)[nan].sum())
    big = torch.tensor([466.0, float("inf"), -466.0], dtype=torch.bfloat16)
    sat = [float(to_cache_dtype(big[i:i + 1].cuda(), f8).float())
           for i in range(3)]
    check(sat == [448.0, 448.0, -448.0], f"17a: the cache cast gives {sat} "
          f"for 466, inf, -466 on the card, want +-448")
    raw_off = int((bits.to(f8).view(torch.uint8) != bits.cuda().to(
        f8).view(torch.uint8).cpu()).sum())
    raw = [float(big[i:i + 1].cuda().to(f8).float()) for i in range(3)]
    raw_cpu = [float(big[i:i + 1].to(f8).float()) for i in range(3)]
    print(f"fp8 cast: the cache cast equals the CPU's on all "
          f"{int((~nan).sum())} non-NaN bf16 patterns on the card (the "
          f"{int(nan.sum())} NaN patterns give an fp8 NaN on both, its "
          f"sign differing on {nan_sign}) and saturates (466, inf, -466 "
          f"-> {sat}); "
          f"torch {torch.__version__}'s own cast: card vs CPU differ on "
          f"{raw_off} of the whole array, and one element of 466, inf, "
          f"-466 gives {raw} on the card, {raw_cpu} on the CPU", flush=True)
    return off


def phase_fp8_gather() -> dict:
    """17b: the page gather on fp8 pools at yi-9b's decode shape (pool
    ``(1 + 4 x 256, 16, 4, 128)``, one 8 KiB page a (slot, logical page);
    a table of distinct pages, each slot mapped up to a decode run's
    length: 2,112, 1,600, 1,088 and 576 positions): kernel against
    ``paged_gather_plain`` bit for bit, timed beside the plain version and
    ``index_select``; the bound at 1 B an element."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_kv import paged_gather, paged_gather_plain

    cfg = get_config(FP8_ARCH)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    maxp = FP8_MAX_LEN // FP8_PAGE
    np_ = FP8_BATCH * maxp + 1
    table = (1 + torch.randperm(np_ - 1, generator=gen, device=dev)).view(
        FP8_BATCH, maxp).to(torch.int32)
    for b, n in enumerate((2112, 1600, 1088, 576)):
        table[b, -(-n // FP8_PAGE):] = -1
    shape = (np_, FP8_PAGE, cfg.num_kv_heads, cfg.head_dim)
    pools = torch.randint(0, 256, (COLD_POOLS,) + shape, generator=gen,
                          device=dev, dtype=torch.uint8)
    # no NaN pattern (0x7f / 0xff): the cache never holds one (saturating)
    pools[(pools & 0x7f) == 0x7f] = 0
    pools = pools.view(torch.float8_e4m3fn)
    page_bytes = FP8_PAGE * cfg.num_kv_heads * cfg.head_dim
    check(page_bytes % 16 == 0 and page_bytes == 8192,
          f"17b: an fp8 page is {page_bytes} B, want 8 KiB (16-byte rule)")
    got = paged_gather(pools[0], table)
    want = paged_gather_plain(pools[0], table)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
          "17b: paged_gather kernel != plain version on an fp8 pool")
    ids = table.long().clamp(0, np_ - 1).reshape(-1)
    kernel_ms, library_ms, wins = paired_ms(
        lambda i: paged_gather(pools[i % COLD_POOLS], table),
        lambda i: pools[i % COLD_POOLS].index_select(0, ids))
    plain_ms = time_ms(lambda i: paged_gather_plain(pools[i % COLD_POOLS],
                                                    table))
    mapped = int(table[table >= 0].unique().numel())
    nbytes = mapped * page_bytes + table.nbytes + got.nbytes
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"kernel paged_gather float8_e4m3fn at {FP8_ARCH}'s decode shape: "
          f"pool {shape} table {tuple(table.shape)} "
          f"({int((table < 0).sum())} unmapped) bitwise equal to plain; "
          f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms(index_select)={library_ms:.5f} (medians of {PAIRS} "
          f"alternating pairs, the kernel faster in {wins}) "
          f"bound_ms={bound_ms:.5f} ({nbytes} B at 1 B an element)",
          flush=True)
    del pools
    return dict(max_abs_err=0.0, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms)


def _fp8_requests(vocab: int):
    """17's requests: 8 prompts of 512-2,048 tokens (varied), 64 new."""
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(17)
    return [Request(prompt=rng.integers(0, vocab, (int(p),), dtype=np.int32),
                    max_new_tokens=FP8_NEW) for p in FP8_PROMPTS]


class _ProfiledStep:
    """An engine's decode step whose ``at``-th call is also profiled: run
    once on the host clock, then again under ``torch.profiler`` (a decode
    step is idempotent: it rewrites the same cache slot from the same
    inputs). The idle share is that profiled run's: its device busy time
    over its own wall time (the host clock around the profiled call,
    profiler overhead included); the unprofiled run's wall is kept beside
    it."""

    def __init__(self, fn, at: int):
        self.fn, self.at, self.n, self.idle = fn, at, 0, None
        self.busy_ms = self.wall_ms = self.plain_wall_ms = None
        self.extra = 0   # the profiled step's second run

    def __call__(self, *a, **kw):
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        self.n += 1
        if self.n != self.at:
            return self.fn(*a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.fn(*a, **kw)
        torch.cuda.synchronize()
        self.plain_wall_ms = (time.perf_counter() - t0) * 1e3
        self.extra = 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = self.fn(*a, **kw)
            torch.cuda.synchronize()
            self.wall_ms = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        self.busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        if self.busy_ms > 0:
            self.idle = 1 - self.busy_ms / self.wall_ms
        return out


def _fp8_agreement(cfg, params) -> float:
    """17's top-1 agreement of a ``kv_fp8`` cache with a bf16 one (the
    reference's rule, teacher-forced): 4 rows of 256 tokens, the first 224
    prefilled, then 32 steps fed the true next token; the share of the
    32 x 4 positions whose argmax agrees. Recorded, not gated."""
    import torch
    from repro_torch.models.transformer import Model, init_cache
    reqs = _fp8_requests(cfg.vocab_size)[:4]
    toks = torch.stack([torch.from_numpy(r.prompt[:256]) for r in reqs]).to(
        "cuda")
    tops = {}
    for name, c in (("bf16", cfg), ("fp8", cfg.with_opts("kv_fp8"))):
        model = Model(c)
        cache = init_cache(c, 4, 257, dtype=torch.bfloat16, device="cuda")
        out = []
        with torch.inference_mode():
            _, _, cache = model.forward(params, {"tokens": toks[:, :224]},
                                        cache=cache)
            for t in range(224, 256):
                lg, cache = model.decode_step(params, toks[:, t:t + 1], cache)
                out.append(lg.argmax(-1))
        tops[name] = torch.cat(out, 1)
    return float((tops["bf16"] == tops["fp8"]).float().mean())


def phase_fp8_serve(card: str) -> dict:
    """17 (see the docstring): yi-9b at full width and depth, random from
    seed 0, bf16 params, through ``ServeEngine`` with a bf16 cache and
    with ``kv_fp8``, paged and contiguous; the gates and the measurements
    (ms a decode step, tok/s, prefill s, ``cache_bytes_resident``, peak
    memory, one profiled step's idle share)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_kv import paged_gather
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import engine as tengine

    t17 = time.time()
    _fresh("phase 17")
    phase_fp8_cast()
    base = dataclasses.replace(get_config(FP8_ARCH), num_layers=FP8_LAYERS)
    t0 = time.time()
    params = init_params(base, 0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"fp8 serve: {base.name} L={base.num_layers} d={base.d_model} "
          f"H={base.num_heads}/{base.num_kv_heads} hd={base.head_dim} "
          f"d_ff={base.d_ff} vocab={base.vocab_size} "
          f"params={base.param_count() / 1e9:.3f}B {base.param_dtype} "
          f"(init {time.time() - t0:.1f}s, {torch.cuda.memory_allocated()} B "
          f"on the card) on {card}", flush=True)
    # every logit the engines sample from is checked finite
    finite = {"ok": torch.ones((), dtype=torch.bool, device="cuda"), "n": 0}
    select = tengine.select_tokens

    def checked(logits, *a, **kw):
        finite["ok"] &= torch.isfinite(logits).all()
        finite["n"] += 1
        return select(logits, *a, **kw)

    tengine.select_tokens = checked
    runs = {}
    try:
        for dt in ("bf16", "fp8"):
            cfg = base.with_opts("kv_fp8") if dt == "fp8" else base
            for layout in ("paged", "contiguous"):
                eng = tengine.ServeEngine(
                    cfg, params, batch_size=FP8_BATCH, max_len=FP8_MAX_LEN,
                    device="cuda", paged=layout == "paged",
                    page_size=FP8_PAGE, cache_dtype=torch.bfloat16)
                if dt == "bf16":   # warm-up (first calls' set-up)
                    eng.generate([tengine.Request(prompt=r.prompt[:64],
                                                  max_new_tokens=2)
                                  for r in _fp8_requests(cfg.vocab_size)[:2]])
                reqs = _fp8_requests(cfg.vocab_size)
                eng._prefill = _Timed(eng._prefill)
                eng._step = _ProfiledStep(_Timed(eng._step), FP8_PROFILE_AT)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                paged_gather.launches = flash_attention.launches = 0
                t0 = time.perf_counter()
                eng.generate(reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                steps, timed = eng.decode_steps, eng._step.fn
                n_tok = sum(len(r.generated) for r in reqs)
                run = dict(
                    tokens=[r.generated.tolist() for r in reqs],
                    steps=steps, gather=paged_gather.launches,
                    flash=flash_attention.launches,
                    step_ms=timed.seconds / max(steps, 1) * 1e3,
                    tok_s=n_tok / wall, prefill_s=eng._prefill.seconds,
                    prefills=eng._prefill.calls,
                    bytes=eng.cache_bytes_resident,
                    peak=torch.cuda.max_memory_allocated(),
                    idle=eng._step.idle, busy_ms=eng._step.busy_ms,
                    profiled_wall_ms=eng._step.wall_ms,
                    plain_wall_ms=eng._step.plain_wall_ms)
                runs[f"{dt} {layout}"] = run
                for i, r in enumerate(reqs):
                    check(len(r.generated) == FP8_NEW and bool(
                        ((r.generated >= 0) & (r.generated < cfg.vocab_size))
                        .all()), f"17 {dt} {layout}: request {i} made "
                        f"{r.generated.tolist()[:4]}... ({len(r.generated)})")
                runs_of_step = steps + eng._step.extra
                want = 2 * cfg.num_layers * runs_of_step \
                    if layout == "paged" else 0
                check(run["gather"] == want, f"17 {dt} {layout}: paged gather "
                      f"launched {run['gather']} times, want {want} (2 x "
                      f"{cfg.num_layers} a decode step, {runs_of_step} runs "
                      f"of the step with the profiled one's second)")
                check(run["flash"] == cfg.num_layers * run["prefills"],
                      f"17 {dt} {layout}: flash launched {run['flash']} "
                      f"times, want {cfg.num_layers} x {run['prefills']}")
                # K and V of the contiguous cache: its bytes less the two
                # cursors (the reference's int32 scalars)
                kv = run["bytes"] - 8 if layout == "contiguous" else None
                run["kv_bytes"] = kv
                idle = "not measured" if run["idle"] is None else (
                    f"wall {run['profiled_wall_ms']:.2f} ms under the "
                    f"profiler ({run['plain_wall_ms']:.2f} without), device "
                    f"busy {run['busy_ms']:.2f} ms, idle share of the "
                    f"profiled run {run['idle']:.4f}")
                print(f"fp8 serve {cfg.name} {dt} cache {layout}: "
                      f"{len(reqs)} requests (prompts "
                      f"{[len(r.prompt) for r in reqs]}), {n_tok} new tokens "
                      f"in {wall:.3f}s ({run['tok_s']:.1f} tok/s) "
                      f"decode_steps={steps} ({run['step_ms']:.3f} ms/step) "
                      f"prefill_s={run['prefill_s']:.3f} ({run['prefills']} "
                      f"prefills) paged_gather.launches={run['gather']} "
                      f"flash_attention.launches={run['flash']} "
                      f"cache_bytes_resident={run['bytes']}"
                      + (f" (K/V {kv} B)" if kv else "")
                      + f" peak={run['peak']} B; profiled step "
                      f"{FP8_PROFILE_AT}: {idle}", flush=True)
                del eng
                torch.cuda.empty_cache()
    finally:
        tengine.select_tokens = select
    check(bool(finite["ok"]), f"17: a logit was not finite in "
          f"{finite['n']} sampling calls")
    want = 2 * base.num_layers * FP8_BATCH * FP8_MAX_LEN * base.num_kv_heads \
        * base.head_dim
    check(runs["bf16 contiguous"]["kv_bytes"] == 2 * want and
          runs["fp8 contiguous"]["kv_bytes"] == want,
          f"17: K/V bytes bf16 {runs['bf16 contiguous']['kv_bytes']} / fp8 "
          f"{runs['fp8 contiguous']['kv_bytes']}, want {2 * want} / {want}")
    for dt in ("bf16", "fp8"):
        a, b = runs[f"{dt} paged"]["tokens"], runs[f"{dt} contiguous"]["tokens"]
        same = a == b
        if dt == "fp8":
            check(same, "17: under kv_fp8 paged tokens != contiguous tokens")
        runs[f"{dt} paged"]["same_as_contiguous"] = same
    pairs = [(x, y) for p, q in zip(runs["fp8 contiguous"]["tokens"],
                                    runs["bf16 contiguous"]["tokens"])
             for x, y in zip(p, q)]
    gen_agree = sum(x == y for x, y in pairs) / len(pairs)
    top1 = _fp8_agreement(base, params)
    print(f"fp8 serve: {finite['n']} sampling calls, every logit finite; "
          f"K/V bytes fp8 {runs['fp8 contiguous']['kv_bytes']} = half of "
          f"bf16's {runs['bf16 contiguous']['kv_bytes']}; fp8 paged tokens "
          f"== contiguous; bf16 paged == contiguous: "
          f"{runs['bf16 paged']['same_as_contiguous']}; fp8 against bf16 "
          f"(recorded, not gated): teacher-forced top-1 agreement {top1:.4f} "
          f"(4 rows x 32 steps), greedy tokens equal at {gen_agree:.4f} of "
          f"positions", flush=True)
    del params
    torch.cuda.empty_cache()
    gather = phase_fp8_gather()
    print(f"phase 17 took {time.time() - t17:.1f}s", flush=True)
    return dict(runs=runs, gather=gather, top1=top1,
                launches=sum(r["gather"] for r in runs.values()),
                flash=sum(r["flash"] for r in runs.values()))


# ---------------------------------------------------------------------------
# phase 18: gemma-2b, command-r-35b and arctic-480b served and trained at
# full width, yi-9b trained
# ---------------------------------------------------------------------------

def _arch_header(cfg, t0) -> str:
    import torch
    moe = cfg.moe
    return (f"{cfg.name} L={cfg.num_layers} d={cfg.d_model} "
            f"H={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
            f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
            + (f"experts={moe.num_experts} top_k={moe.top_k} "
               f"dense_residual={moe.dense_residual} " if moe else "")
            + f"norm={cfg.norm} parallel_block={cfg.parallel_block} "
            f"params={cfg.param_count() / 1e9:.3f}B {cfg.param_dtype} (init "
            f"{time.time() - t0:.1f}s, {torch.cuda.memory_allocated()} B on "
            f"the card)")


def _arch_requests(vocab: int, lens, new: int, seed: int):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, vocab, (n,), dtype=np.int32),
                    max_new_tokens=new) for n in lens]


def _arch_serve(cfg, params, max_len: int, groups) -> dict:
    """``cfg`` through ``ServeEngine`` with a bf16 cache, paged then
    contiguous: each of ``groups`` (a name and a function making its
    requests) one ``generate``, the launches counted from zero before it
    and checked after it (flash L a prefill call, the page gather 2 x L a
    paged decode step, the row gather 2 x L a forward call of an MoE);
    paged tokens equal to contiguous. Returns each run's numbers."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    L, moe = cfg.num_layers, cfg.moe is not None
    out = {}
    for layout in ("paged", "contiguous"):
        eng = ServeEngine(cfg, params, batch_size=BATCH, max_len=max_len,
                          device="cuda", paged=layout == "paged",
                          page_size=PAGE_SIZE, cache_dtype=torch.bfloat16)
        for name, make in groups:
            reqs = make()
            eng._prefill, eng._step = _Timed(eng._prefill), _Timed(eng._step)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _launch_counts(zero=True)
            t0 = time.perf_counter()
            eng.generate(reqs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            c = _launch_counts()
            steps, calls = eng.decode_steps, eng._prefill.calls
            n_tok = sum(len(r.generated) for r in reqs)
            for i, r in enumerate(reqs):
                g = r.generated
                check(len(g) == r.max_new_tokens and
                      bool(((g >= 0) & (g < cfg.vocab_size)).all()),
                      f"18 {cfg.name} {name} {layout}: request {i} made "
                      f"{g.tolist()}")
            want = dict(flash=L * calls,
                        gather=2 * L * steps if layout == "paged" else 0,
                        rows=2 * L * (calls + steps) if moe else 0)
            got = {k: c[k] for k in want}
            check(calls > 0 and got == want, f"18 {cfg.name} {name} "
                  f"{layout}: launches {got}, want {want} ({calls} prefill "
                  f"calls, {steps} decode steps)")
            run = dict(tokens=[r.generated.tolist() for r in reqs],
                       step_ms=eng._step.seconds / max(steps, 1) * 1e3,
                       tok_s=n_tok / dt, prefill_s=eng._prefill.seconds,
                       prefills=calls, steps=steps,
                       bytes=eng.cache_bytes_resident,
                       peak=torch.cuda.max_memory_allocated(), **got)
            out[f"{name} {layout}"] = run
            print(f"serve {cfg.name} {name} {layout}: {len(reqs)} requests "
                  f"(prompts {[len(r.prompt) for r in reqs]}), {n_tok} new "
                  f"tokens in {dt:.3f}s ({run['tok_s']:.1f} tok/s), "
                  f"{steps} decode steps {run['step_ms']:.3f} ms/step, "
                  f"prefill_s={run['prefill_s']:.3f} ({calls} calls incl. "
                  f"admissions), cache_bytes_resident={run['bytes']}, "
                  f"max_memory_allocated={run['peak']} B, launches {got}",
                  flush=True)
            if layout == "paged":
                check(bool((eng._pages.owner[1:] == -1).all()),
                      f"18 {cfg.name} {name}: pages leaked")
        del eng
        torch.cuda.empty_cache()
    for name, _ in groups:
        a, b = out[f"{name} paged"], out[f"{name} contiguous"]
        check(a["tokens"] == b["tokens"], f"18 {cfg.name} {name}: paged "
              f"tokens {a['tokens']} != contiguous {b['tokens']}")
        print(f"serve {cfg.name} {name}: paged tokens identical to "
              f"contiguous for all {len(a['tokens'])} requests", flush=True)
    return out


def _arch_batches(cfg, batch: int, seq: int, n: int):
    from repro_torch.data.pipeline import synthetic_batch
    return [synthetic_batch(cfg, batch, seq, seed=0, step=i)
            for i in range(n)]


def _arch_train(cfg, holder: dict, batch: int, seq: int) -> dict:
    """``cfg`` trained at full width from ``holder["params"]`` (taken out
    of it, so that the state owns them): the paper's mode (vci post, pack
    pallas, remat block) by :func:`_train_run`, then one ``comm="gspmd"``
    step (phase 15a's) from the trained params. Returns the numbers."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.train.trainer import make_train_step, train_state_init
    cfg = dataclasses.replace(cfg, remat="block")
    batches = _arch_batches(cfg, batch, seq, ARCH_TRAIN_STEPS + 2)
    run = _train_run(cfg, batches[:-1], f"train {cfg.name}",
                     params=holder.pop("params"), keep=True)
    params = run.pop("params")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = train_state_init(cfg, params=params, comm="gspmd")
    del params
    step = make_train_step(cfg)            # comm="gspmd", the default
    flash_attention.launches = 0
    t0 = time.perf_counter()
    state, m = step(state, batches[-1])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    loss = float(m["loss"])
    check(math.isfinite(loss), f"18 {cfg.name}: gspmd step loss {loss}")
    check(flash_attention.launches == 2 * cfg.num_layers,
          f"18 {cfg.name}: the gspmd step launched flash "
          f"{flash_attention.launches} times, want 2 x {cfg.num_layers}")
    run["gspmd"] = dict(ms=ms, loss=loss,
                        peak=torch.cuda.max_memory_allocated(),
                        flash=flash_attention.launches)
    print(f"train {cfg.name}: one comm=\"gspmd\" step (one rank) {ms:.3f} ms "
          f"(its first: warm-up included), loss {loss:.4f}, "
          f"max_memory_allocated {run['gspmd']['peak']} B, flash "
          f"{flash_attention.launches}", flush=True)
    del state, step
    _fresh(f"18 {cfg.name}, trained")
    return run


def _keep_layers(params, n: int) -> None:
    """Cut ``params``' stacked layers to their first ``n``, in place, one
    leaf at a time: each leaf's other layers are freed before the next
    leaf is cut, so the card never holds two copies of the params."""
    import torch

    def cut(d):
        for k in list(d):
            if isinstance(d[k], dict):
                cut(d[k])
            else:
                d[k] = d[k][:n].clone()
                torch.cuda.empty_cache()

    cut(params["layers"])


def _arctic_grad(cfg, params) -> dict:
    """arctic-480b's one full-width layer, forward and backward (remat
    block), no optimizer step: the loss's gradient of every param leaf
    (bf16, as the params), ``ARCTIC_GRAD_STEPS`` timed after a warm-up,
    the launches counted over the timed ones: the row gather 5 a layer (2
    on the read-once route), the gather-sum 1, flash 2."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gather import row_gather, row_gather_sum
    from repro_torch.models.transformer import Model
    from repro_torch.train.trainer import _loss_fn
    from repro_torch.tree import tree_flatten
    cfg = dataclasses.replace(cfg, remat="block")
    model = Model(cfg)
    leaves = tree_flatten(params)[0]
    for t in leaves:
        t.requires_grad_(True)
    batches = _arch_batches(cfg, ARCTIC_GRAD_BATCH, ARCTIC_GRAD_SEQ,
                            ARCTIC_GRAD_STEPS + 1)
    torch.cuda.reset_peak_memory_stats()
    times, losses, norms = [], [], []
    for i, b in enumerate(batches):
        if i == 1:
            flash_attention.launches = row_gather.launches = 0
            row_gather.read_once_launches = row_gather_sum.launches = 0
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
        t0 = time.perf_counter()
        loss, _ = _loss_fn(model, cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
        # the norm in f32, a piece of each gradient at a time (a whole
        # expert table's f32 copy would take 17.8 GB)
        norms.append(float(torch.sqrt(sum(
            torch.linalg.vector_norm(c, dtype=torch.float32).square()
            for g in grads for c in g.reshape(-1).split(1 << 28)))))
        del grads, loss
    steps = ARCTIC_GRAD_STEPS
    got = dict(row_gather=row_gather.launches,
               read_once=row_gather.read_once_launches,
               row_gather_sum=row_gather_sum.launches,
               flash=flash_attention.launches)
    want = dict(row_gather=5 * steps, read_once=2 * steps,
                row_gather_sum=steps, flash=2 * steps)
    check(got == want, f"18 {cfg.name}: {steps} forward + backward "
          f"launched {got}, want {want}")
    check(all(map(math.isfinite, losses + norms)),
          f"18 {cfg.name}: losses {losses}, gradient norms {norms}")
    ms = sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated()
    tokens = ARCTIC_GRAD_BATCH * ARCTIC_GRAD_SEQ
    print(f"train {cfg.name}: one full-width layer's forward + backward "
          f"(no optimizer step), batch {ARCTIC_GRAD_BATCH} x "
          f"{ARCTIC_GRAD_SEQ}, remat=block: {steps} steps ms "
          f"{[round(t, 3) for t in times]} (mean {ms:.3f}), "
          f"{tokens / ms * 1e3:.1f} tok/s, losses {losses}, gradient norms "
          f"{norms}, max_memory_allocated {peak} B; launches a step "
          f"{ {k: v // steps for k, v in got.items()} }", flush=True)
    for t in leaves:
        t.requires_grad_(False)
    return dict(ms=ms, tok_s=tokens / ms * 1e3, peak=peak, counts=got)


def _arch_init(cfg) -> dict:
    """``init_params(cfg, 0)`` on the card, after freeing what earlier
    phases hold, in a holder that the train runs take it out of."""
    import torch
    from repro_torch.models.transformer import init_params
    _fresh(f"18 {cfg.name}")
    t0 = time.time()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    print(f"18: {_arch_header(cfg, t0)}", flush=True)
    return {"params": params}


def _short(cfg):
    """Phase 5's requests, their prompts made from ``cfg``'s vocabulary."""
    return lambda: _arch_requests(
        cfg.vocab_size, [len(r.prompt) for r in _requests(cfg.vocab_size)],
        MAX_NEW, 0)


def phase_gemma() -> dict:
    """18a: gemma-2b at full depth served (prompts of <= 64 rows, then 4
    of 1,024) and trained from the same params."""
    from repro_torch.configs import get_config
    cfg = get_config(GEMMA_ARCH)
    held = _arch_init(cfg)
    serve = _arch_serve(cfg, held["params"], GEMMA_MAX_LEN, (
        ("short", _short(cfg)),
        ("long", lambda: _arch_requests(cfg.vocab_size, GEMMA_LONG, MAX_NEW,
                                        18))))
    return {"gemma serve": serve,
            "gemma train": _arch_train(cfg, held, 4, 1024)}


def phase_cmdr() -> dict:
    """18b: command-r-35b at full depth served, its first layer trained."""
    from repro_torch.configs import get_config
    cfg = get_config(CMDR_ARCH)
    held = _arch_init(cfg)
    serve = _arch_serve(cfg, held["params"], CMDR_MAX_LEN,
                        (("short", _short(cfg)),))
    _keep_layers(held["params"], 1)
    return {"command-r serve": serve, "command-r train": _arch_train(
        dataclasses.replace(cfg, num_layers=1), held, 4, 512)}


def phase_arctic() -> dict:
    """18c: arctic-480b at ``ARCTIC_SERVE_LAYERS`` layers served, then its
    first layer's forward and backward."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(ARCTIC_ARCH),
                              num_layers=ARCTIC_SERVE_LAYERS)
    held = _arch_init(cfg)
    serve = _arch_serve(cfg, held["params"], MAX_LEN,
                        (("short", _short(cfg)),))
    _keep_layers(held["params"], 1)
    return {"arctic serve": serve, "arctic grad": _arctic_grad(
        dataclasses.replace(cfg, num_layers=1), held.pop("params"))}


def phase_yi_train() -> dict:
    """18d: yi-9b at ``YI_TRAIN_LAYERS`` of 48 layers trained."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=YI_TRAIN_LAYERS)
    return {"yi train": _arch_train(cfg, _arch_init(cfg), 8, 1024)}


def phase_smoke_train() -> None:
    """18e: the four archs' smoke configs trained on the card against the
    CPU (phase 10's rules; bf16 moments carried for arctic)."""
    for arch in ("yi-9b", GEMMA_ARCH, CMDR_ARCH, ARCTIC_ARCH):
        phase_reference_train(arch + "-smoke")
    _fresh("18, done")


def _table_bytes() -> int:
    """The page table of phase 5's paged cache: ``BATCH`` rows of
    ``MAX_LEN / PAGE_SIZE`` int32 entries."""
    return BATCH * (-(-MAX_LEN // PAGE_SIZE)) * 4


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script drives the "
             "port on a CUDA card")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"allow_tf32=False", flush=True)

    t_all = time.time()
    took: dict = {}

    def timed(fn, *a, name: str = ""):
        """``fn(*a)``, its wall seconds kept under ``name`` (default the
        phase function's name)."""
        t0 = time.time()
        out = fn(*a)
        took[name or fn.__name__[len("phase_"):]] = round(
            time.time() - t0, 1)
        return out

    card = timed(phase_device)
    timed(phase_build)
    kern = timed(phase_kernels)
    rows = timed(phase_row_gather)
    flash = timed(phase_flash)
    from repro_torch.configs import get_config
    runs = timed(phase_serve, get_config(SERVE_ARCH))
    timed(phase_reference)
    moe_runs = timed(phase_serve, dataclasses.replace(
        get_config(MOE_ARCH), num_layers=MOE_LAYERS), name="serve_moe")
    timed(phase_moe_reference)
    ssd = timed(phase_ssd)
    ssm_launches = timed(phase_ssm_serve)
    timed(phase_ssm_reference)
    hyb = timed(phase_hybrid_serve)
    timed(phase_family_references)
    vlm_flash = timed(phase_vlm_serve)
    audio_flash = timed(phase_audio_serve)
    tp = timed(phase_tp_serve, runs, moe_runs, card)
    import torch.distributed as dist
    tmp = init_data_group()
    try:
        train = timed(phase_train)
        timed(phase_reference_train)
        zero1 = timed(phase_train_zero1, train.pop("post"))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    ranks = timed(phase_zero1_ranks, card)
    bwd = timed(phase_row_gather_bwd)
    tmp = init_data_group()
    try:
        moe_train = timed(phase_train_moe)
        mm_train = timed(phase_train_mm)
        ssd_bwd = timed(phase_ssd_bwd)
        ssm_train = timed(phase_train_ssm)
        hyb_train = timed(phase_train_hybrid)
        gspmd = timed(phase_gspmd, train["step_ms"])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    gspmd_ranks = timed(phase_gspmd_ranks, card)
    timed(phase_ckpt_cli)
    fp8 = timed(phase_fp8_serve, card)
    tmp = init_data_group()
    try:
        archs = {}
        for fn in (phase_gemma, phase_cmdr, phase_arctic, phase_yi_train):
            archs.update(timed(fn))
        timed(phase_smoke_train)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase seconds: {json.dumps(took)}", flush=True)
    trained = [moe_train, ssm_train, hyb_train] + list(mm_train.values()) \
        + [archs[k] for k in ("gemma train", "command-r train", "yi train")]
    served = [r for k, v in archs.items() if k.endswith("serve")
              for r in v.values()]
    grad = archs["arctic grad"]["counts"]

    f32 = kern["float32"]
    line = {"kernels": [{
        "name": "paged_gather",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_gather.cu",
        "replaces": "src/repro/kernels/paged_kv.py:42",
        "launches": runs["paged"]["launches"] + moe_runs["paged"]["launches"]
        + tp["gather"] + fp8["launches"] + sum(r["gather"] for r in served),
        "max_abs_err": max(k["max_abs_err"] for k in kern.values()),
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": "bytes",
        "library_ms": f32["library_ms"],
        # phase 17's fp8 pool at yi-9b's decode shape (1 B an element)
        "fp8_ms": fp8["gather"]["ms"],
        "fp8_plain_ms": fp8["gather"]["plain_ms"],
        "fp8_bound_ms": fp8["gather"]["bound_ms"],
        "fp8_library_ms": fp8["gather"]["library_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bucket_pack.cu",
        "replaces": f"src/repro/kernels/bucket_pack.py:{line}",
        "launches": launches,
        "max_abs_err": train[name]["max_abs_err"],
        "ms": train[name]["ms"],
        "plain_ms": train[name]["plain_ms"],
        "bound_ms": train[name]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": train[name]["library_ms"],
    } for name, line, launches in (
        ("bucket_pack", 83, train["launches"][0]
         + zero1["zero1/post"]["packs"] + ranks["packs"]
         + sum(r["counts"]["bucket_pack"] for r in trained)
         + gspmd_ranks["packs"]),
        ("bucket_unpack", 110, train["launches"][1]
         + sum(r["counts"]["bucket_unpack"] for r in trained)
         + gspmd_ranks["unpacks"]))] + [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:95",
        "launches": sum(r[layout]["flash"] for r in (runs, moe_runs)
                        for layout in ("paged", "contiguous"))
        + moe_runs["window"]["flash"] + hyb["flash"] + vlm_flash
        + audio_flash + train["flash"] + tp["flash"] + ranks["flash"]
        + sum(r["flash"] for r in zero1.values())
        + sum(r["counts"]["flash_attention"] for r in trained)
        + gspmd["flash"] + gspmd_ranks["flash"] + fp8["flash"]
        + sum(r["flash"] for r in served) + grad["flash"]
        + sum(archs[k]["gspmd"]["flash"] for k in
              ("gemma train", "command-r train", "yi train")),
        "max_abs_err": flash["max_abs_err"],
        "ms": flash["a"]["ms"],
        "plain_ms": flash["a"]["plain_ms"],
        "bound_ms": flash["a"]["bound_ms"],
        "bound_by": flash["a"]["bound_by"],
        "library_ms": flash["a"]["library_ms"],
        # (p): gemma-2b's short prefill, head_dim 256 on one KV head
        "p_ms": flash["p"]["ms"],
        "p_plain_ms": flash["p"]["plain_ms"],
        "p_bound_ms": flash["p"]["bound_ms"],
        "p_library_ms": flash["p"]["library_ms"],
    }, {
        "name": "row_gather",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/row_gather.cu",
        "replaces": "src/repro/kernels/moe_gather.py:29",
        "launches": sum(moe_runs[k]["rows"]
                        for k in ("paged", "contiguous", "long", "window"))
        + tp["rows"] + moe_train["counts"]["row_gather"]
        + gspmd_ranks["rows"] + sum(r["rows"] for r in served)
        + grad["row_gather"],
        "max_abs_err": rows["max_abs_err"],
        "ms": rows["8x1024 dispatch"]["ms"],
        "plain_ms": rows["8x1024 dispatch"]["plain_ms"],
        "bound_ms": rows["8x1024 dispatch"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": rows["8x1024 dispatch"]["library_ms"],
    }, {
        "name": "row_gather_sum",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/row_gather.cu",
        # no TPU kernel: row_gather_pallas has no backward (XLA
        # differentiates the reference's gathers); this is row_gather's
        "replaces": None,
        "backward_of": "src/repro/kernels/moe_gather.py:29",
        "launches": moe_train["counts"]["row_gather_sum"]
        + gspmd_ranks["rows_sum"] + grad["row_gather_sum"],
        "max_abs_err": bwd["max_abs_err"],
        "ms": bwd["dispatch bwd"]["ms"],
        "plain_ms": bwd["dispatch bwd"]["plain_ms"],
        "bound_ms": bwd["dispatch bwd"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": bwd["dispatch bwd"]["library_ms"],
    }, {
        "name": "ssd_chunk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:56",
        "launches": ssm_launches + hyb["ssd"] + tp["ssd"]
        + sum(r["counts"]["ssd_chunk"] for r in trained)
        + gspmd_ranks["ssd"],
        "max_abs_err": ssd["max_abs_err"],
        "ms": ssd["serve"]["ms"],
        "plain_ms": ssd["serve"]["plain_ms"],
        "bound_ms": ssd["serve"]["bound_ms"],
        "bound_by": ssd["serve"]["bound_by"],
        "library_ms": None,
        # a model rank's 12 of 48 heads (16e's prefill at tp 4)
        "rank_ms": ssd["rank tp4"]["ms"],
        "rank_plain_ms": ssd["rank tp4"]["plain_ms"],
        "rank_bound_ms": ssd["rank tp4"]["bound_ms"],
    }, {
        "name": "ssd_chunk_bwd",
        "route": "cuda",
        # the tensor-core route, which the training path takes (bf16); the
        # FFMA route (csrc/ssd_chunk_bwd.cu, f32 and what the tensor cores
        # do not take) is timed beside it as ffma_ms
        "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd_tc.cu",
        # no TPU kernel: ssd_chunk_pallas has no backward (XLA
        # differentiates the reference's einsums); this is ssd_chunk's
        "replaces": None,
        "backward_of": "src/repro/kernels/ssd_scan.py:56",
        "launches": sum(r["counts"]["ssd_chunk_bwd"] for r in trained)
        + gspmd_ranks["ssd_bwd"],
        "max_abs_err": ssd_bwd["max_abs_err"],
        "ms": ssd_bwd["mamba2-780m train"]["ms"],
        "ffma_ms": ssd_bwd["mamba2-780m train"]["ffma_ms"],
        "plain_ms": ssd_bwd["mamba2-780m train"]["plain_ms"],
        "bound_ms": ssd_bwd["mamba2-780m train"]["bound_ms"],
        "bound_by": ssd_bwd["mamba2-780m train"]["bound_by"],
        "library_ms": None,
        # a model rank's 24 of 48 heads (16e's training run at tp 2)
        "rank_ms": ssd_bwd["rank tp2"]["ms"],
        "rank_plain_ms": ssd_bwd["rank tp2"]["plain_ms"],
        "rank_bound_ms": ssd_bwd["rank tp2"]["bound_ms"],
    }]}
    print(f"row_gather on the main path: {line['kernels'][4]['launches']} "
          f"launches, {moe_runs['long']['read_once']} (long prompts) + "
          f"{moe_runs['window']['read_once']} (past the window) + "
          f"{moe_train['counts']['row_gather read-once']} (phase 13b's "
          f"training) of them on the read-once route that its ms measures "
          f"(the 8 x 1,024 dispatch); row_gather_sum "
          f"{line['kernels'][5]['launches']} (phase 13b)", flush=True)
    print(f"chip_smoke: all phases passed in {time.time() - t_all:.1f}s",
          flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
