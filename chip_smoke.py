#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero.
Two exceptions to the order, to keep the run well inside its time
limit: phase 2's D = 256 (Gemma) parts and the embeddings' shapes run
after phase 3's servers, while two helper processes (``warm_flex``)
compile their ``flex_attention`` yardsticks into Inductor's cache in
the checkout as the servers run, so the timed calls load them (a third
compiles the ring rows' beside the ``parallel`` phase's ranks); and each
server of phase 3 starts with the one before it (SERVER_MODES' order
keeps any two within 69 GB of the card), as the ``--weights`` server
starts during the export round trip.

1. Print the card's name and power limit (``nvidia-smi``), build the
   hand-written kernels from ``dstack_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the build time; read every compiled
   form's registers and spill bytes from its ``-Xptxas -v`` log (all seven
   sources): a spill fails the run, and so does a head width of K1, K2 or
   K3 (64, 128, 192, 256), or K1's D = 576 form or its combine, or W8's
   forms (the byte-streaming form, the chunk form in 256-column tiles
   and with paired k tiles), or A8's (bf16 and f32 parameters), with no
   compiled form.
2. Kernel phase: each kernel against its plain PyTorch version on the
   card in bf16, within atol = rtol = 2e-2: flash prefill (K1) at the
   serving shapes (C = 16 and 256 with q_offset 0 and 512); ragged flash
   decode (K4) with positions from 0 to 2047 in its four forms: the bf16
   and the int8 cache (f32 per-token scales), one row group a slot
   (q [8,8,4,64]) and speculative verify (S = 5: q [8,8,20,64]), each row with
   the NSPLIT and row groups of its split plan; and the
   backward kernels K2 (dq) and K3 (dk, dv) at the training shape q/dO
   [4,32,2048,64], k/v [4,8,2048,64] (causal; window 512 with softcap 30;
   a ragged T = 1000), where K1 is timed once more, and K1, K2, K3 and
   the SDPA forward and backward are timed again at the trainer's shape
   q/dO [8,32,2048,64], k/v [8,8,2048,64]. Times each kernel,
   its plain version and one PyTorch library call of the same function
   (``scaled_dot_product_attention`` forward with an explicit mask, or its
   backward for K2+K3: yardsticks the port never calls; none reads an int8
   cache, so the int8 forms have none) with CUDA events, L2 flushed before
   each launch, and reckons each call's bound from the bytes it must move
   at 3.35 TB/s and its FLOPs at 989 TFLOP/s. Then the gpt-oss forms at
   gpt-oss-20b's shapes (64/8 heads, G = 8): K1 at q [1,64,256,64],
   q_offset 512, over k/v [1,8,2048,64] with windows 128 and 0 (o, lse
   and the sink-rescaled output against the plain versions), and K4's
   four attention-sinks forms (q [8,8,8,64] and verify q [8,8,40,64],
   cache [8,8,2048,64], positions 0..2047, sinks drawn from N(0, 1)) with
   windows 0 and 128. Their SDPA yardstick has no sink column. Then the
   D = 256 forms at Gemma's shapes (8/4 heads, G = 2): K1 at q
   [1,8,256,256], q_offset 512, over k/v [1,4,2048,256] with gemma-3-4b's
   window 1024 and with window 0, and gemma-2-2b's window 4096 with
   softcap 50 (plus a chunk at q_offset 1536, where the window's floor
   lies inside the row), and K4's four forms (q [8,4,2,256] and verify q
   [8,4,10,256], cache [8,4,2048,256]) each with window 1024, window 0
   and softcap 50. With a softcap, and in a window at D = 256 (where SDPA
   with a mask leaves its flash path), the library yardstick is
   ``flex_attention`` compiled to Triton (the tanh softcap as its
   score_mod, the causal, window or per-slot mask as its block mask), held
   to the plain version first; the int8 forms have none. Then the D = 128
   forms at glm-4-9b's shapes (32/2 heads, G = 16; ``d128_kernel_phase``):
   K1 at q [1,32,256,128], q_offset 512, over k/v [1,2,2048,128], and K4's
   four forms (decode q [8,2,16,128], verify q [8,2,80,128], cache
   [8,2,2048,128]), each beside olmo-2-7b's G = 1 (k/v and cache with 32
   KV heads), and K1 beside llama-4-scout's G = 5 (q [1,40,256,128] over
   k/v [1,8,2048,128]), every output held by both rules (element-wise and per
   32-row tile), timed beside its bound, the plain version and SDPA with
   the mask (none for int8); the ptxas report of the D = 128 forms goes in
   their rows. Then,
   K1, K2 and K3 at D = 256: q/dO [4,8,2048,256] over k/v [4,4,2048,256],
   causal (the FLOPs of the D = 64 rows), on gemma-3-4b's sliding layer
   (window 1024) and global layer and gemma-2-2b's (window 4096, softcap
   50): o, lse, dq, dk and dv each held to the plain version, two
   launches bit-identical, each kernel timed beside its bound, the plain
   version and the library backward (SDPA's ``is_causal`` on the global
   layer; in the window and with the softcap the backward of the
   compiled ``flex_attention``, its gradients held to the plain version
   first); K1 timed at that shape. Then the same checks, timed beside the
   bounds, at each Gemma fine-tune run's own micro-batch on each window
   its layers use: q/dO [8,8,2048,256] over k/v [8,4,2048,256] (gemma-3-4b,
   windows 1024 and 0; gemma-2-2b, windows 4096 and 0 with softcap 50)
   and [4,4,2048,256] over [4,1,2048,256] (gemma-3-1b, windows 512 and
   0), each kernel beside the library's call of the same function (SDPA
   on a global layer without a softcap, else the compiled
   ``flex_attention``). Every K2/K3 gradient, at D = 64, 192 and 256, and
   K1's o at D = 192 and 256, is also held tile by tile (32 rows of one
   batch row and head) within 1e-2 relative RMS error (``grad_close``).
   Last, K1's absorbed-MLA entry (``flash_mla_with_lse``: D = 576,
   ``csrc/flash_fwd_mla.cu``, V read as the latent row's first 512
   columns) at deepseek-v2-lite's chunks (``MLA_SHAPES``): q [1,16,C,576]
   over the latent row [1,1,2048,576] at C = 256 with q_offsets 512, 0 and
   1792, C = 32 at 0 and 1792, C = 40 at 260; o (512 wide) and lse held
   by both rules against the plain version, whose value is the row with
   its rope columns zeroed as the engine builds it; reruns bit-identical;
   each shape timed beside its bound, the plain version and SDPA with the
   offset-causal mask and the row expanded to 16 heads (the backend SDPA
   takes is named), and its split plan against the other NSPLITs in
   turns; the same at deepseek-v3's 128 heads (``MLA_V3_SHAPES``: q
   [1,128,C,576] at C = 256 with q_offsets 512 and 0, C = 64 and 16 at 0,
   C = 16 at 1792, which the plan splits; a block owns one position of 64
   heads). Then
   K1, K2 and K3 at MLA's training width (D = 192: deepseek-v2-lite's q/k
   heads of 128 + 64, v padded from 128), 16 heads, causal, scale
   192^-0.5: q/k/v/dO [4,16,2048,192] and the training run's micro-batch
   [8,16,2048,192] (v's and dO's padded columns zero, as training gives
   them), o, lse, dq, dk and dv held by both rules, reruns bit-identical,
   timed beside the bounds, the plain versions (at B = 4) and SDPA's
   ``is_causal`` forward and backward (the backend named). Last, W8 (the
   int8-weight product, ``csrc/w8_matmul.cu``; ``w8_kernel_phase``) in its
   three forms at the shapes its paths give it: llama-3-70b's projections
   at M = 1, 8, 40, 256 and 1024, a K and an N that are not multiples of
   the tile, its head, mixtral-8x7b's expert stacks at the M its decode,
   verify, chunks and packed waves give (8, 40, 24, 80, 320); each held
   by both rules against ``w8_matmul_plain``, a rerun bit-identical, timed
   beside its bound (the int8 weight, scales, x and the output once; 2 M K
   N FLOPs), the plain version, ``torch._weight_int8pack_mm`` where the
   card's torch has it for CUDA and the bf16 product of the shape (a
   reference line); one decode-shaped launch replayed from a CUDA graph,
   its split counters found at 0 after the replay. Then A8 (the 8-bit
   AdamW step, ``csrc/adam8.cu``; ``adam8_kernel_phase``) at llama-3-8b's
   embedding [128256, 4096], its stacked w_gate [32, 4096, 14336] and a
   [64, 256] leaf (one block a row) with bf16 parameters, and the
   embedding with f32 ones; a mid-run moment state (a sixteenth of the
   rows idle: no gradient, moments where eps weighs in), the scalars of
   step 3 (the clip on at the large leaves) and a step size of 1e-2;
   against ``opt8.adam8_update_plain``: the parameters by both rules, the
   update p_new - p_old within 2e-3 (bf16) or 1e-4 (f32) relative RMS in
   every 32-row tile, while the kernel launched with weight decay or eps
   dropped, or the step 5 % long, must fail that limit; the codes within
   one step in at most 1e-3 of them, the scales within 1e-6 relative, a
   rerun bitwise; timed beside its byte bound, the plain
   version and the port's bf16-moment ``AdamW.update`` on the same leaf
   (no PyTorch call computes these moments: no library time). Then K1,
   K2 and K3 at llama-3-8b's training micro-batch (q/dO [8,32,2048,128]
   over k/v [8,8,2048,128], causal; ``d128_train_kernel_phase``) by both
   rules, reruns bitwise, timed beside the bounds, the plain versions and
   SDPA; and again at starcoder2-7b's training micro-batch, G = 9 (q/dO
   [8,36,2048,128] over k/v [8,4,2048,128]: rows ``*_d128_g9``).
3. Path phase: start ``python -m dstack_tpu_torch.serve.openai_server
   --decode-kernel flash`` with no ``--device`` flag (the server runs on
   ``cuda`` by default, which ``/health`` must show; full width and depth, random
   weights from seed 0) on a free port six times, one after another: llama-3.2-1b on the
   serial path (``--prefill-pack 1 --spec-draft 0 --turbo-steps 0
   --no-prefix-cache``), at the engine's defaults (packed prefill,
   speculative verify, turbo macro-steps, the prefix cache), and at the
   defaults with ``--kv-quant int8``; then gpt-oss-20b at the defaults
   (24 layers, 32 experts with 4 a token, attention sinks, windows of 128
   on even layers), gemma-3-4b at the defaults (34 layers, head_dim
   256, windows of 1024 on 5 of every 6 layers, q/k norms, dual rope),
   and deepseek-v2-lite at the defaults (27 layers: MLA's latent cache,
   64 experts with 6 a token and 2 shared ones, the dense first layer;
   K1's D = 576 form n_layers times a serial chunk and no K4 launch:
   MLA's decode and verify are products over the latent row, in JAX too),
   then glm-4-9b (40 layers, head_dim 128, 32 query heads over 2 KV heads,
   interleaved rope over half of each head, q/k/v biases, sandwich norms:
   K1's <128, 64> form and K4's D = 128 forms at G = 16) and olmo-2-7b (32
   layers, G = 1, no input norms, flat q/k norms) and qwen-3-30b-a3b (48
   layers, 61.1 GB: 128 experts with 8 a token, G = 8, q/k norms; its
   lone 256-token chunk's TTFT and its plain decode step's host ms
   against the 17.3 ms its experts' read takes at 3.35 TB/s) at the
   defaults, and llama-3.2-1b at the defaults with ``--quantize int8``
   (the seed-0 tree built and quantized on the host, W8 on every
   projection: its launches by form n_layers x 7 a forward pass, none on
   the bf16 servers), whose greedy completion equals, token for token, an
   in-process int8 graph engine over the same tree (``w8_server_check``).
   Every server runs its decode-side and prefill steps as CUDA graphs
   (the engine's step sites, ``serve/graphs.py``; K1 inside the chunk
   graphs). Every server but the serial one warms its paths up before it
   listens (``_warmup_engine``, which captures every decode-side variant,
   the prefill keys of JAX's warmup grid (``PREFILL_GRID``) and every
   prefix-copy length, and marks the engine warm): its first ``/health``
   must show that the warmup ran and left no slot or prefix behind (and
   gives the allocator's reserved bytes), and every count and metric below
   is the difference from that snapshot; at the end of its drive no
   decode-side site has captured anything more, every prefill capture
   after the warm mark is of a key outside JAX's grid (each logged with its
   capture seconds), and ``/metrics`` reads no decode-side recompile or
   gap and one prefill recompile a new variant. The
   serial server runs with ``--no-warmup``, and its counts must read 0. Each server first
   answers one 40-token completion alone (its TTFT: cold on the serial
   path, warm elsewhere), then 4 concurrent greedy ``/v1/completions``
   (prompts of 40, 200, 300 and 700 byte tokens) and one streamed
   ``/v1/chat/completions``, 32 tokens each; the default servers then get
   a 4-token phrase x 30 prompt and two prompts sharing a 512-token
   prefix, one after the other. The default llama server then gets the
   feature drive (``feature_drive``: token logprobs held against this
   process's engine and a teacher-forced f32 forward, a streamed chat
   with logprobs, ``n``, tools and ``response_format``, ``/v1/embeddings``
   of 5 to 2,047 tokens held against the plain forward, a greedy
   completion against one with logprobs), and the gpt-oss, gemma and
   deepseek, glm, olmo and qwen3moe servers one logprobs completion and one
   100-token embedding each (``family_features``); an embedding launches
   K1 n_layers times.
   Check every answer's shape and read
   ``/health``: on the serial path K1 ran n_layers times per prefill
   chunk and K4 n_layers times per decode step; on the default paths K1
   ran n_layers times per serial chunk (packed waves take the masked
   attention), K4 n_layers times per plain, verify and turbo device step,
   packed, turbo and prefix-cache dispatches all ran, and K4 ran only the
   forms of the server's cache (on gpt-oss, only its sinks forms). On the
   default llama server, ``/metrics`` is scraped before and after the
   common traffic, and again after the extra prompts and one ``n: 2``
   completion: each time the registry's requests, TTFT count, generated
   tokens, prefill dispatches and step seconds must equal what was sent
   and what the engine's stats counted, and the compile families the
   step sites' variants (``_metrics_identities``). Last, the lifecycle
   server (``robust``, ``robust_phase``): llama-3.2-1b without the warmup,
   with QoS, a watchdog over a hang planted on slot 7 (``ROBUST_ENV``'s
   ``DTPU_FAULT_PLAN``) and ``DTPU_PROFILER_DIR``; a tenant's burst shed
   and deferred, a deadline ending a decode with 504, the eighth request
   wedged and aborted while the next gives the baseline's greedy tokens,
   a greedy resume equal to the uninterrupted stream, ``X-DTPU-Trace`` on
   every response and its spans in ``/debug/traces``, the boot stages,
   every family of the JAX server's ``/metrics`` with the lifecycle
   counters fed, and a live profiler window whose chrome trace names K1's
   and K4's kernels (its device ms by kernel logged), then K1's and K4's
   launch identities. Then
   the serving bench (``bench_phase``): ``dstack_tpu_torch/serve/bench.py``
   on llama-3.2-1b at full width and depth (``BENCH_ARGS``: batch 8,
   256-token prompts, 128 tokens, bursts of 8), the default engine once
   through ``python -m dstack_tpu_torch.serve.bench`` in a fresh process
   (CUDA graphs), then three pairs of the eager engine
   (``run_bench(graphs=False)``) and the graph engine in this process,
   alternated (each set's median and spread logged, with the host's
   counters of each run), then the serial engine as a pair, the int8
   cache and a repetitive prompt with spec_draft 4; each run's K4 launches
   over its timed sections must be n_layers x its plain, verify and turbo
   device steps, its K1 launches n_layers x its serial chunks. Then the
   multi-replica paths (ROADMAP A4.2), in this process, llama-3.2-1b at
   full width and depth on graphs, each with the counts set to 0 before
   it and read after (K1 and K4 must launch): the session bench
   (``sessions_phase``: ``run_session_bench`` with SESSION_ARGS, 2
   replicas sharing one tree, 8 sessions of 4 turns, 32 tokens a turn,
   chunk 256) logs warm-turn TTFT p50/p95 with affinity on and off, cold
   TTFT p50, prefix hits and ``same_replica_rate``, and fails unless the
   affinity-on pass has more prefix hits than the off pass; then the two
   loadgen soaks of the JAX package's acceptance (``soak_phase``:
   ``run_soak`` over ``default_spec(30 s, 1.5 rps)`` at seed 7, 2 replicas
   behind the port's router with QoS; at 3 rps the soak's ASCII bias
   saturates the event loop): the chaos soak (a drain, then a kill that
   waits up to 3 s for its replica to hold a request) and the boot soak (a
   cold scale-up replica built on the card under its own boot recorder at
   10 % of the schedule). Each logs goodput and TTFT by class, its windows
   and the router's counters, the boot soak the scale-up replica's boot
   stages, the chaos soak the host ms a request spends on the soak's
   128,128-entry ASCII bias; each fails unless no client saw a 5xx or a
   failure, every event fired, the sheds were honest and the report's
   digest is the compiled schedule's, and, for the chaos soak, a breaker
   opened, a stream resumed or a request failed over, the kill window
   served and the tail recovered, for the boot soak, every boot stage and
   mark was recorded, the replica served, the join window served and
   goodput held at 0.5 or more. Then the
   graph phase (``graph_phase``): in this process, llama-3.2-1b,
   gpt-oss-20b, gemma-3-4b and glm-4-9b on both caches and
   deepseek-v2-lite and olmo-2-7b at full width (llama-3.2-1b at full
   depth, the others at ``GRAPH_LAYERS``' depths: gpt-oss-20b 2,
   gemma-3-4b 6, deepseek-v2-lite 2, glm-4-9b 2, olmo-2-7b 2), the graph
   engine against the eager engine
   (``graphs=False``) on the same traffic (a burst of four prompts, a
   verify, seeded sampling with penalties and logprobs, a seed skip): the
   same tokens, bitwise the same logits of every serial chunk, packed
   wave, plain decode and verify call and the same cache after the
   traffic, the same launches by form (K1 n_layers times a serial chunk,
   credited at each chunk graph's replay); each site's captures and
   capture seconds; then the host ms of a lone prompt's prefill up to its
   first token (a serial chunk at (256, 0) and at (16, 0), a packed wave
   of 4 x 256), and of a plain step, a turbo macro-step of 8 and a verify
   at 8 live slots, eager and graph in turns. Then the remaining
   families in this process (``family_engine_phase``): mixtral-8x7b at its
   full 32 layers on its int8 tree (46.8 GB drawn on the card; W8's
   projection, expert and head forms every pass), llama-4-scout at 8 of
   48 (NoPE layers 3 and 7) and
   deepseek-v3 at 4 of 61 (3 dense layers and one of 256 experts), full
   width, the graph engine against the eager one on one greedy 300-token
   request of 32 tokens: the same tokens, logits and cache bitwise, the
   same launches, K1 n_layers times a serial chunk, K4 n_layers times a
   device step on mixtral and none on llama-4-scout (its chunk mask takes
   the einsum, as in JAX; the reason is logged) or deepseek-v3. Then
   llama-3-70b at full width and depth with int8 weights through the
   bench (``w8_bench_phase``: the tree drawn on the card, 8 slots of
   2048, BENCH_ARGS' traffic; 4 slots if 8 do not fit): the bench's launch
   identities and W8's by form, peak memory, the decode value against the
   weight-read bound. Then,
   in this process, a teacher-forced
   comparison on one prompt over the prefill, 8 decode steps and one
   verify of 5 tokens, on the bf16 and on the int8 cache: the kernel
   path's logits against the plain path's, both held to the plain path
   in f32 (the kernel path's relative RMS logit error may be at most 1.5
   times the plain bf16 path's). It runs on llama-3.2-1b and on
   gpt-oss-20b at full width and 4 of its 24 layers (2 sliding, 2 global:
   an f32 copy of all 24 would not fit the card) with sinks and biases
   drawn nonzero; on gpt-oss it launches all four sinks forms of K4. Then
   on gemma-3-4b at full width and depth on both caches, with a prompt of
   1,100 tokens (past its window of 1024) and its q/k norms at identity
   (``gemma_tf_params``), and on gemma-2-2b (26 layers, softcap 50 and
   the logit cap 30) on the bf16 cache, and on deepseek-v2-lite at full
   width and 4 layers (the dense prelude and 3 MoE layers), routing
   pinned as on gpt-oss, on its latent cache; then the dense families at
   full width and 4 layers (``family_tf_params``: biases drawn nonzero and
   norms drawn around identity, FAMILY_NONZERO), glm-4-9b on both caches
   (K4's int8 D = 128 forms) and qwen-2.5-7b, qwen-3-8b, mistral-7b,
   starcoder2-7b, minitron-4b, llama-3.2-3b, command-r-35b and llama-3-70b
   on the bf16 cache (FAMILY_TF), each held by the 1.5x rule and with the
   kernel path's greedy tokens the plain path's but for near-ties of the
   f32 logits; then the same for mixtral-8x7b, qwen-3-30b-a3b,
   llama-4-scout (its kernel path decodes on the einsum) and Command-R7B
   (cohere2, from its HF fields) at 4 layers, routing pinned, and
   deepseek-v3 at 4 layers, whose f32 path reads its routed experts'
   bf16 stack through ``F32Experts`` (an f32 copy would not fit); last,
   llama-3.2-1b on the server's int8 tree (W8_TF): the kernel path on W8,
   the plain and f32 paths on its plain version (``plain_w8``), W8's
   launches n_layers x 7 a pass. One
   decode step of gpt-oss
   and of deepseek-v2-lite at the server's batch of 8 on those 4 layers,
   traced with torch.profiler, eager and as a CUDA graph's replay: device
   time by kernel family and the device's busy share of the step.
4. Training path phase: the fine-tune driver's entry point
   (``python -m dstack_tpu_torch.train.finetune``'s ``main``, called in
   this process with the command line's arguments) at ``--batch 8
   --seq-len 2048`` (full width, random weights from seed 0; full depth
   but where TRAIN_RUNS cuts it),
   each run's launch counts set to 0 by the driver (TRAIN_RUNS): llama-3.2-1b ``--full --opt-bits 8`` for 6 steps (int8
   moments through A8, a checkpoint every 3 steps, a seeded held-out
   ``.npy`` evaluated every 3 steps and at the end, 2 batches each:
   ``OPT8_FLAGS``), then the same run resumed from its step-3 checkpoint
   (the step-6 one removed) to step 6, whose ``model_weights.npz`` must
   equal the first run's bitwise and whose eval losses the first run's
   (``resume_check``); llama-3.2-1b in the default LoRA mode for 4 steps;
   then Gemma at head_dim 256 for 5 steps each: gemma-3-4b LoRA (12 of
   its 34 layers) and gemma-2-2b LoRA (8 of 26; softcap 50 in K1-K3, the
   logit cap 30 in the loss, windows of 4096 on alternate layers) in one
   micro-batch, gemma-3-1b ``--full`` (12 of 26) at ``--grad-accum 2``;
   gpt-oss-20b LoRA at full width and 4 of its 24 layers at
   ``--grad-accum 4``, 3 steps. From each summary line: finite losses, the first within
   1.0 of ln(vocab), per micro-batch of every step K1, K2 and K3 once a
   flash layer each (K1's residuals are kept across remat; gpt-oss's
   sinks take the masked attention, as JAX trains them, so its run
   launches none) and K1 n_layers times more an eval batch, A8 once a
   quantized leaf a step of the opt8 runs and never in the others; a LoRA
   run's base weights bitwise as drawn (``tree_digest`` before the first
   step and after the run) and every adapter's B factor moved from 0; the
   median step time, tokens/s, MFU and peak memory are printed.
   Then one more full fine-tune step in this process, traced with
   torch.profiler: device time by kernel family and the device's busy
   share of the step. Then deepseek-v2-lite fully fine-tuned in this
   process through ``init_train_state`` and ``make_train_step``
   (``deepseek_train_phase``): full width, 4 layers (the dense prelude and
   3 MoE layers), batch 8 x 2048 in one micro-batch, 6 steps; MLA's
   non-absorbed attention runs K1-K3 at D = 192, the loss carries the
   router aux loss; the counts set to 0 before the steps and read after
   (K1, K2 and K3 4 a micro-batch), finite losses, the first CE
   within 1.0 of ln(vocab); step seconds (the median after the first),
   tokens/s, MFU on the active parameters, peak memory, CE and aux. Then
   llama-3-8b and then starcoder2-7b (LayerNorm with a bias, every bias,
   the gateless MLP) fully fine-tuned in this process at full width and
   8 and 4 of their 32 layers (``train_opt8_phase``:
   ``default_optimizer(opt_bits=8)``, ``make_train_step``, whose default
   loss at batch 8 x 2048 in one micro-batch is the chunked one; out of
   memory fails it; 4 steps each): K1, K2 and K3 once a layer a step, A8 once a quantized leaf a step, finite
   losses, the first within 1.0 of ln(vocab); step seconds, tokens/s,
   MFU, peak memory beside the bytes of the parameters and the moments.
   The llama full and LoRA runs also write ``--export-hf`` directories,
   which ``load_checkpoint(..., device="cuda")`` gives back bitwise as the
   trained tree and the merged one, each forward bitwise the original's
   (``export_phase``).
   Then a seventh server, started with ``--weights`` on the llama full
   fine-tune's ``model_weights.npz``, serves a greedy completion with
   logprobs equal to this process's engine over the same file loaded by
   ``load_weights_npz`` (``weights_server_phase``).
5. Gradient-parity phase: the full fine-tune loss (random weights from
   seed 0, one batch of 1 x 2048 tokens) of llama-3.2-1b at full width
   and depth, of gemma-3-4b and gemma-3-1b at 6 layers and gemma-2-2b at
   4 (full width, norms at identity), of deepseek-v2-lite at full
   width and 4 layers (routing pinned to the f32 path's choices), of
   qwen-2.5-7b, glm-4-9b, olmo-2-7b, command-r-35b, minitron-4b and
   starcoder2-7b at full width and 4 layers (biases and norms drawn), of
   gpt-oss-20b at 4 (two sliding, two global layers, sinks and biases
   drawn), and llama-4-scout's LoRA loss at 4 (layers 0-2 rope, layer 3
   NoPE), differentiated on three paths (kernels in bf16, plain in bf16,
   plain in f32): for every parameter (or adapter) leaf the kernel
   path's relative RMS gradient error against f32 may be at most 1.5
   times the plain bf16 path's; the two bf16 losses agree within 2e-2,
   and each lies within the model's limit of the f32 loss
   (``GRAD_PARITY``: 2e-3, gemma-3-4b 6e-2, gpt-oss-20b 5e-3,
   llama-4-scout 6e-3).
6. Parallel phase (``parallel_phase``, ROADMAP A6.1): 2 ranks share the
   card over gloo (NCCL refuses two ranks on one device), started once by
   torchrun (``chip_smoke.py --parallel-worker DIR``). In them: the ring
   and Ulysses at llama-3.2-1b's, deepseek-v2-lite's (D = 192),
   gemma-3-1b's local (window 512) and gemma-2-2b's (window 4096, softcap
   50) full-width shapes at T = 2048, forward and backward on each rank's
   half of the sequence, their launches counted by form, each held to the
   same ring (or Ulysses) on the plain per-step functions and to the
   single-rank K1-K3 call over the whole sequence (2e-2 element-wise, 1e-2
   relative RMS a 32-row tile, on o, dq, dk and dv); llama-3.2-1b's
   gradients at 4 layers on ``sp=2`` and ``fsdp=2``; then the fine-tune
   driver's ``main`` on both ranks at 8 x 2048 for 3 steps: llama-3.2-1b
   at full depth on ``--sp 2`` (the ring), ``--sp 2 --seq-parallel
   ulysses`` and ``--fsdp 2``, deepseek-v2-lite at 4 layers on ``--sp
   2``. Then in this process, the card its own: K1, K2 and K3 in the
   ring's new forms (non-causal at one rank's shard; non-causal at
   ``q_offset`` 1024 under the window) checked against their plain
   versions and timed beside their bounds, the plain versions and SDPA;
   the mesh gradients' relative RMS error against the single-rank f32
   path, leaf by leaf, at most 1.5 times the single-rank kernel path's;
   each fine-tune's first loss within 2e-3 of the single rank's (the same
   parameters and first batch through the step's objective), its first
   line naming gloo and both ranks on the card, and its launches by form
   the ring's (rank 1 also non-causal), Ulysses' or the flash call's.
7. Print the ``kernels`` JSON line (K1 at the llama, the gpt-oss, the
   Gemma, the dense families' D = 128 (with G = 5, and llama-3-8b's
   training micro-batch and starcoder2-7b's at G = 9), the MLA serving (at
   16 and, in its own row, at deepseek-v3's 128 heads) and the MLA
   training shape, K2 and K3 at head_dim 64, 128 (llama-3-8b's and, in
   their own rows, starcoder2-7b's micro-batch), 192 and 256, A8 with its
   four leaves, K1, K2 and K3 in the ring's non-causal and offset forms,
   K4 as one row per
   form, eight at head_dim 64, four at 128 and four at 256, each with its launches on
   every path of its models; a form launched on no path fails the run;
   every row carries its kernel's ptxas report, K1 its training- and
   trainer-shape times, K2 and K3 their trainer-shape times, K4 its
   NSPLIT; W8 one row a form, with every shape timed), then the card
   line, then the last line
   ``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import torch

from dstack_tpu_torch.models import convert_hf, llama, moe, quant
from dstack_tpu_torch.models.llama import embed_padded_len, embed_vectors, load_weights_npz
from dstack_tpu_torch.ops import adam8, cuda_build, flash, flash_decode, w8_matmul
from dstack_tpu_torch.ops.attention import attention
from dstack_tpu_torch.serve import engine
from dstack_tpu_torch.serve.chat_template import render_chat
from dstack_tpu_torch.serve.graphs import GraphSet
from dstack_tpu_torch.serve.tokenizer import ByteTokenizer
from dstack_tpu_torch.train import finetune
from dstack_tpu_torch.train import lora as train_lora
from dstack_tpu_torch.train import opt8
from dstack_tpu_torch.train import step as train_step

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"  # the card; the servers' default device
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
TOL = 2e-2  # bf16: atol = rtol, the JAX package's own bf16 tolerance
# K2's and K3's gradients are mostly about TOL in size, so beside the
# element-wise rule each is held, tile by tile (GRAD_TILE_ROWS rows of one
# batch row and head), to a relative RMS error against the plain version
# (see grad_close); a tile whose plain gradient has an RMS below
# GRAD_RMS_FLOOR is rounding noise (a query row that sees only its own
# key has dq = 0 in exact arithmetic) and is judged against the floor
GRAD_TILE_ROWS = 32
GRAD_RMS_TOL = 1e-2
GRAD_RMS_FLOOR = 1e-3
# end to end, the kernel path's relative RMS logit error against the f32
# path may be at most this multiple of the plain bf16 path's (see
# teacher_forced_phase)
KERNEL_RMS_MARGIN = 1.5
MODEL = "llama-3.2-1b"
GPT_OSS = "gpt-oss-20b"
GEMMA3 = "gemma-3-4b"  # Gemma's head width of 256: K1 and K4's D = 256 forms
GEMMA2 = "gemma-2-2b"  # ... with gemma-2's attention softcap and logit cap
GEMMA = (GEMMA3, GEMMA2)
GEMMA3_1B = "gemma-3-1b"  # the full fine-tune at head_dim 256
D256 = (*GEMMA, GEMMA3_1B)  # the models whose paths run the D = 256 forms
# the teacher-forced prompt on gemma-3-4b: past its sliding window of 1024,
# so the window masks keys in the last prefill chunk and every decode step
GEMMA_TF_PROMPT = 1100
GPT_OSS_TF_LAYERS = 4  # depth of the in-process gpt-oss comparison: 2 sliding, 2 global
DEEPSEEK = "deepseek-v2-lite"  # MLA: K1's D = 576 form on every serial prefill chunk
# depth of the in-process DeepSeek comparison: the dense prelude layer and
# 3 MoE layers (an f32 copy of all 27 would not fit the card beside bf16's)
DEEPSEEK_TF_LAYERS = 4
# the DeepSeek full fine-tune in this process, at full width and this
# depth (the dense prelude and 3 MoE layers: the whole model's weights,
# gradients and moments, 126 GB, do not fit one card; full depth waits for
# fsdp): batch 8 x 2048 in this many micro-batches, for this many steps
# (the first one's start-up left out of the median)
DEEPSEEK_TRAIN_LAYERS = 4
DEEPSEEK_TRAIN = (1, 6)  # (--grad-accum, steps)
# K1-K3 at MLA's training width: B, H, Hkv, T, D (deepseek-v2-lite's 16
# heads, MHA; q/k heads of 128 + 64, v padded from 128); the causal FLOPs
# of [4,16,2048,192]
MLA_TRAIN_SHAPE = (4, 16, 16, 2048, 192)
# the dense families at head_dim 128: K1's <128, 64> form and K4's D = 128
# forms. Two serve at full width and depth: glm-4-9b (G = 16, interleaved
# partial rope, q/k/v biases, sandwich norms) and olmo-2-7b (G = 1,
# post-norm-only layers, flat q/k norms); the others, with glm-4-9b again on
# both caches, run teacher-forced at full width and FAMILY_TF_LAYERS layers
GLM = "glm-4-9b"
OLMO = "olmo-2-7b"
FAMILY_TF = ("qwen-2.5-7b", "qwen-3-8b", "mistral-7b", "starcoder2-7b", "minitron-4b", "llama-3.2-3b",
             "command-r-35b", "llama-3-70b")
FAMILY_TF_LAYERS = 4
# the graph phase's depths (their servers run at full depth; llama-3.2-1b
# runs there at its full 16): every form and site, gpt-oss-20b's sliding
# and global layer, gemma-3-4b's global layer 5 beside five local ones,
# deepseek-v2-lite's dense layer and an MoE layer, so that the run keeps
# its margin under the 1200 s limit on a slow host: the graph phase took
# 159.6-218.8 s at the depths gpt-oss 24, gemma 34, deepseek 27, glm 10,
# olmo 8, 108.2 s at 8, 12, 9, 6, 4 in a whole run of 1106.8 s, and 86.8 s
# at 4, 6, 5, 6, 4 on a slow host (its bench 114.7 s against 92.5 in a
# whole run of 745.3 s), on an NVIDIA H100 80GB HBM3 at 700 W; with the
# training phases of every served family (ROADMAP A5.7-A5.9) gpt-oss-20b,
# deepseek-v2-lite, glm-4-9b and olmo-2-7b run here at 2
GRAPH_LAYERS = {GPT_OSS: 2, GEMMA3: 6, DEEPSEEK: 2, GLM: 2, OLMO: 2}
# the remaining families (ROADMAP A3.2-A3.4). qwen-3-30b-a3b serves at full
# width and depth (61.1 GB; 128 experts, 8 a token, G = 8); mixtral-8x7b
# (G = 4), llama-4-scout (G = 5, NoPE layers, chunked attention, the
# sigmoid-input router: its decode routes to the einsum, as in JAX) and
# deepseek-v3 (MLA at 128 heads: K1's D = 576 form in 64-head groups) run
# at full width in in-process engines at FAMILY_ENGINES' depths, the depths
# that fit one card beside a second engine's cache; each runs teacher-forced
# at FAMILY_TF_LAYERS layers with Command-R7B (cohere2, from its HF fields)
MIXTRAL = "mixtral-8x7b"
QWEN_MOE = "qwen-3-30b-a3b"
LLAMA4 = "llama-4-scout"
DEEPSEEK_V3 = "deepseek-v3"
COHERE2 = "command-r7b"  # a label: cohere2 has no CONFIGS entry, in JAX either
# model → (depth, weights): mixtral-8x7b at full depth with its int8 tree
# (46.8 GB, drawn on the card: random_quantized_params_on_device), the
# others in bf16
FAMILY_ENGINES = {MIXTRAL: (32, "int8"), LLAMA4: (8, None), DEEPSEEK_V3: (4, None)}
# Command-R7B's config.json fields (CohereForAI/c4ai-command-r7b-12-2024)
COHERE2_HF = {
    "model_type": "cohere2", "vocab_size": 256000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
    "rope_theta": 50000.0, "layer_norm_eps": 1e-5, "logit_scale": 0.25, "max_position_embeddings": 132096,
    "sliding_window": 4096, "sliding_window_pattern": 4, "tie_word_embeddings": True,
}
# the expert-read floor of a qwen-3-30b-a3b decode step: the port's MoE
# reads every expert's weights (48 x 128 x 3 x 2048 x 768 bf16) at 3.35 TB/s
QWEN_MOE_FLOOR_MS = 48 * 128 * 3 * 2048 * 768 * 2 / PEAK_BYTES_S * 1e3
# llama-3-8b and starcoder2-7b (LayerNorm with a bias, every bias, the
# gateless MLP) fully fine-tuned in this process (train_opt8_phase) at full
# width and depth: int8 moments (A8), the chunked loss, TRAIN_OPT8's rows of
# 2048 tokens in one micro-batch and steps; K1-K3 at their micro-batches
# (B, H, Hkv, T, D; starcoder2-7b's G = 9) in the kernel phase
LLAMA_8B = "llama-3-8b"
STARCODER2 = "starcoder2-7b"
# model → (rows, steps, layers): at full width, 8 of llama-3-8b's 32 layers
# and 4 of starcoder2-7b's 32 since the parallel phase came (the run's
# time; both trained here at full depth before)
TRAIN_OPT8 = {LLAMA_8B: (8, 4, 8), STARCODER2: (8, 4, 4)}
D128_TRAIN_SHAPE = (8, 32, 8, 2048, 128)
D128_G9_TRAIN_SHAPE = (8, 36, 4, 2048, 128)
D128 = (GLM, OLMO, *FAMILY_TF, MIXTRAL, QWEN_MOE, LLAMA4, COHERE2, LLAMA_8B)  # the models whose paths run the D = 128 forms
# std of the seeded values drawn in the dense families' comparison over
# init_params' zero biases and around its identity norms (a norm's scale
# row, and a stacked norm's bias row at FAMILY_NORM_BIAS_STD), which would
# hide a wrong LayerNorm, a wrong flat q/k norm or a missing bias
FAMILY_NONZERO = {"bq": 0.05, "bk": 0.05, "bv": 0.05, "bo": 0.02, "b_up": 0.05, "b_down": 0.02}
FAMILY_NORM_STD = 0.1
FAMILY_NORM_BIAS_STD = 0.02
# std of the seeded values drawn over init_params' zero sinks and biases
# in the gpt-oss comparison (JAX's init leaves them 0, which hides them)
GPT_OSS_NONZERO = {
    "sinks": 1.0, "b_router": 0.5, "bq": 0.05, "bk": 0.05, "bv": 0.05, "bo": 0.02,
    "b_gate": 0.05, "b_up_e": 0.05, "b_down_e": 0.02,
}
PROMPT_LENS = (40, 200, 300, 700)
PREFIX_LEN = 512  # the shared prefix of the prefix-cache pair: two 256-token chunks
MAX_TOKENS = 32
CHUNK = 256  # the server's --prefill-chunk default
PREFILL_SITES = ("chunk", "packed", "copy", "mark_prompt")
# the prefill keys JAX's warmup grid visits on the servers' engine (chunk
# 256, pack 4, 8 slots, max_seq 2048): a capture of one of them after the
# warm mark is a fault; mark_prompt's variants by the padded length
PREFILL_GRID = {("chunk", repr((CHUNK, 0))), ("chunk", repr((16, 0))),
                ("packed", repr((2, CHUNK))), ("packed", repr((4, CHUNK))),
                *(("copy", repr(p)) for p in range(CHUNK, 2048, CHUNK)),
                ("mark_prompt", repr([16])), ("mark_prompt", repr([CHUNK]))}
# the fine-tune runs at batch 8 x 2048: run → (model, mode, --grad-accum,
# steps); each Gemma run at the smallest --grad-accum that fits the 80 GB
# card (its vocabulary's f32 logits: with one micro-batch gemma-3-4b LoRA
# peaked at 62.5 GB and gemma-2-2b LoRA at 74.6 GB, and gemma-3-1b full
# ran out of memory, on an NVIDIA H100 80GB HBM3 at 700 W)
# run → (model, mode, grad_accum, steps[, layers]): the Gemma runs and
# gpt-oss-20b's at full width and a cut depth since the parallel phase came
# (the run's time; their full depths trained here before): gemma-3's 12
# layers hold two global ones, gemma-2's 8 and gpt-oss's 4 alternate
# sliding and global
TRAIN_RUNS = {
    "full": (MODEL, "full", 1, 6),  # with OPT8_FLAGS, then resumed (RESUME_RUN)
    "lora": (MODEL, "lora", 1, 4),
    "gemma3_lora": (GEMMA3, "lora", 1, 5, 12),
    "gemma2_lora": (GEMMA2, "lora", 1, 5, 8),
    "gemma3_1b_full": (GEMMA3_1B, "full", 2, 5, 12),
    # gpt-oss-20b: every layer's sinks take the masked attention, as JAX
    # trains them, so no K1-K3 launch; its [B, 64, 2048, 2048] f32 scores
    # set the micro-batch: at full depth and --grad-accum 2 a layer's
    # backward ran out of the card's memory (66.4 GiB allocated and 8.4
    # reserved at a 4 GiB request, NVIDIA H100 80GB HBM3)
    "gptoss_lora": (GPT_OSS, "lora", 4, 3, 4),
}
DIGEST_CHUNK = 1 << 26  # elements a leaf's digest reads at once (tree_digest)
# the llama full run trains with int8 moments (--opt-bits 8: A8 on every
# quantized leaf), checkpoints every 3 steps into <out>/ckpt and evaluates
# EVAL_ROWS seeded rows of 2049 tokens (EVAL_PATH, written by the script)
# every 3 steps and at the end, EVAL_BATCHES batches each; RESUME_RUN then
# resumes it from its step-3 checkpoint (the step-6 one removed) to step 6,
# and its weights must equal the first run's bitwise
OPT8_RUN = "full"
RESUME_RUN = "full_resume"
RESUME_FROM = 3
EVAL_EVERY, EVAL_BATCHES, EVAL_ROWS = 3, 2, 16
OPT8_FLAGS = ["--opt-bits", "8", "--ckpt-every", str(RESUME_FROM), "--eval-every", str(EVAL_EVERY),
              "--eval-batches", str(EVAL_BATCHES)]
EVAL_PATH = ROOT / "build" / "chip_smoke_eval.npy"
# the runs that also write their weights as an HF checkpoint (--export-hf
# <out>/hf): the trained tree, and the base with the adapters merged in
EXPORT_RUNS = ("full", "lora")
BWD_SHAPE = (4, 32, 8, 2048, 64)  # B, H, Hkv, T, D of the backward kernel phase
BWD_TRAIN_BATCH = 8  # the trainer's batch: K2 and K3 are timed again at it
# K2 and K3 at Gemma's head width: the causal FLOPs of BWD_SHAPE
BWD_D256_SHAPE = (4, 8, 4, 2048, 256)
# gradient parity: model → (layers, the limit on each bf16 loss's distance
# from the f32 loss: a few times what sound runs read). gemma-3's first
# global layer is its sixth. On an NVIDIA H100 80GB HBM3 at 700 W the bf16
# losses sat 4e-4 (llama), 5e-4 (gemma-2-2b) and 4e-5 (gemma-3-1b) from
# f32's, gemma-3-4b's 0.020, and deepseek-v2-lite's 1.2e-4 (kernel) and
# 3e-5 (plain)
GRAD_PARITY = {MODEL: (None, 2e-3), GEMMA3: (6, 6e-2), GEMMA2: (4, 2e-3), GEMMA3_1B: (6, 2e-3),
               DEEPSEEK: (DEEPSEEK_TF_LAYERS, 2e-3),
               # the families the trainer took on with ROADMAP A5.7-A5.9, at
               # full width and 4 layers (family_tf_params' biases and norms;
               # gpt-oss-20b's two sliding and two global layers with nonzero
               # sinks and biases: gpt_oss_tf_params). Read on an NVIDIA H100
               # 80GB HBM3 at 700 W:
               # 1.8e-4 to 8.0e-4 on the dense families, gpt-oss-20b's 1.65e-3
               # (its kernel path is the plain one: the masked attention),
               # llama-4-scout's LoRA 1.96e-3 (kernel) and 1.08e-3 (plain)
               **{name: (FAMILY_TF_LAYERS, 2e-3) for name in (
                   "qwen-2.5-7b", GLM, OLMO, "command-r-35b", "minitron-4b", STARCODER2)},
               GPT_OSS: (GPT_OSS_TF_LAYERS, 5e-3), LLAMA4: (FAMILY_TF_LAYERS, 6e-3)}
# the models whose parity is of the LoRA gradients: llama-4-scout's f32
# tree with its gradients does not fit the card at 4 layers (~35 GB of f32
# weights and as many again in gradients), so its adapters' gradients are
# held, the base weights' f32 path reading the expert stacks through
# F32Experts
GRAD_PARITY_LORA = (LLAMA4,)
SPEC_ROWS = 5  # rows a query head verifies: the server's --spec-draft 4, plus one
# the server runs (mode → model, flags): the serial path of the first
# slice, without the start-up warmup (its first request pays the card's
# start-up), the JAX server's default engine on the bf16 and on the int8
# cache, then gpt-oss-20b, gemma-3-4b, deepseek-v2-lite, glm-4-9b,
# olmo-2-7b and qwen-3-30b-a3b at the defaults, and llama-3.2-1b at the
# defaults with int8 weights (--quantize int8: W8 on every projection),
# and last the lifecycle server (robust_phase: QoS, a watchdog over a
# planted hang, deadlines, resume, traces, the debug routes and the live
# profiler) without the warmup, so that the planted hang's slot is the
# eighth request's: a fresh engine gives request k slot k - 1 (an
# admission prefers a slot holding no cached prefix), and no warmup step
# reaches it first
#
# Each server starts with the one before it (``_server``'s ``then``), so
# two share the card; the order pairs each large model with a small one.
# Reserved bytes after the warmup on an NVIDIA H100 80GB HBM3:
# llama-3.2-1b 3.5-5.2 GB, gpt-oss-20b 46.7, gemma-3-4b 13.1,
# deepseek-v2-lite 34.1, glm-4-9b 28.0, olmo-2-7b 31.5, qwen-3-30b-a3b
# 64.8; the largest pair is 69 GB, and the flex warm-up processes
# (warm_flex) have ended before it starts
SERVER_MODES = {
    "serial": (MODEL, ["--prefill-pack", "1", "--spec-draft", "0", "--turbo-steps", "0",
                       "--no-prefix-cache", "--no-warmup"]),
    "gptoss": (GPT_OSS, []),
    "default": (MODEL, []),
    "deepseek": (DEEPSEEK, []),
    "gemma": (GEMMA3, []),
    "olmo": (OLMO, []),
    "glm": (GLM, []),
    "int8": (MODEL, ["--kv-quant", "int8"]),
    "w8": (MODEL, ["--quantize", "int8"]),
    "robust": (MODEL, ["--qos-rps", "0.05", "--qos-burst", "2", "--qos-tenant-inflight", "1", "--no-warmup"]),
    "qwen3moe": (QWEN_MOE, []),
}
ROBUST_WATCHDOG_S = 4.0
ROBUST_HANG_S = 10.0
ROBUST_HANG_SLOT = 7
ROBUST_PROFILE_DIR = ROOT / "build" / "chip_smoke_robust_profile"
ROBUST_ENV = {
    "DTPU_ENGINE_WATCHDOG_SECONDS": str(ROBUST_WATCHDOG_S),
    "DTPU_FAULT_PLAN": json.dumps({"seed": 0, "rules": [{
        "point": "serve.engine.step", "action": "hang", "seconds": ROBUST_HANG_S,
        "ctx": {"slot": ROBUST_HANG_SLOT}, "times": 1}]}),
    "DTPU_PROFILER_DIR": str(ROBUST_PROFILE_DIR),
}

# the request features beside plain completions (logprobs, n, tools,
# response_format, /v1/embeddings): driven in full on this mode's server,
# in brief (one logprobs completion, one embedding) on the other families'
FEATURE_MODE = "default"
FAMILY_FEATURE_MODES = ("gptoss", "gemma", "deepseek", "glm", "olmo", "qwen3moe")
LOGPROBS_PROMPT_LEN = 40
LOGPROBS_TOKENS = 8
EMBED_LENS = (5, 100, 1000, 2047)  # /v1/embeddings inputs on llama-3.2-1b (max_seq 2048)
FAMILY_EMBED_LEN = 100
EOS_ID = ByteTokenizer.eos_id
# the serving bench (dstack_tpu_torch/serve/bench.py) on llama-3.2-1b at
# full width and depth: its runs and the settings of each
BENCH_ARGS = dict(model=MODEL, batch=8, max_seq=2048, prompt_len=256, gen_len=128,
                  prefill_chunk=256, prefill_pack=4, arrival_burst=8, turbo_steps=8, spec_draft=0)
# the default engine (turbo 8, spec 0) once through the bench's entry
# point in a fresh process (CUDA graphs, its default), then in this process
# BENCH_PAIRS pairs of the eager engine and the graph engine, alternated
# (eager first in odd pairs); then the other modes here: the serial
# engine as a pair, the int8 cache and the repetitive prompt on graphs
BENCH_PAIRS = 3
BENCH_RUNS = {
    "serial": ({"turbo_steps": 0, "prefill_pack": 1}, (False, True)),
    "int8": ({"kv_quant": "int8"}, (True,)),
    "repetitive": ({"repetitive": True, "spec_draft": 4}, (True,)),
}
# W8, the int8-weight product (ops/w8_matmul.py), at the shapes its paths
# give it: llama-3-70b's projections (what, M, K, N) at decode (8 rows),
# verify (40), a serial chunk (256), a packed wave (1024) and M = 1, and a
# K and an N that are not multiples of the tile (64 and 128); its head; and
# mixtral-8x7b's expert stacks (what, E, M, K, N), M being the batch rows
# times each expert's capacity (``moe.expert_capacity``): decode (8 slots,
# one slot each), verify (8 x 5), a 64-token chunk (24: one partial
# 64-row tile), a serial chunk of 256 (80: a whole tile and a partial one)
# and a packed wave of 4 x 256 (320)
W8_PROJ_SHAPES = (
    ("wq", 8, 8192, 8192), ("wk", 8, 8192, 1024), ("w_gate", 8, 8192, 28672), ("w_down", 8, 28672, 8192),
    ("w_gate", 1, 8192, 28672), ("w_gate", 40, 8192, 28672), ("w_gate", 256, 8192, 28672),
    ("w_gate", 1024, 8192, 28672), ("wk", 256, 8192, 1024), ("odd", 8, 8200, 1008), ("odd", 256, 8200, 1008),
)
W8_HEAD_SHAPES = (("lm_head", 8, 8192, 128256), ("lm_head", 40, 8192, 128256))
W8_EXPERT_SHAPES = (
    ("w_gate", 8, 8, 4096, 14336), ("w_down", 8, 8, 14336, 4096), ("w_gate", 8, 40, 4096, 14336),
    ("w_gate", 8, 24, 4096, 14336), ("w_down", 8, 24, 14336, 4096),
    ("w_gate", 8, 80, 4096, 14336), ("w_down", 8, 80, 14336, 4096),
    ("w_gate", 8, 320, 4096, 14336), ("w_down", 8, 320, 14336, 4096),
)
W8_LIBRARY_NOTE = "no PyTorch call on CUDA takes a bf16 x int8 product with per-channel scales"
W8_LIBRARY = {"ok": False, "note": W8_LIBRARY_NOTE}
# the int8-weight paths: llama-3.2-1b served with --quantize int8 (its tree
# built and quantized on the host, as the server builds it) and teacher-
# forced on that tree (W8_TF, a label); mixtral-8x7b's int8 tree at full
# depth in the family engines; llama-3-70b's through the bench at full
# depth (W8_BENCH_ARGS: the tree drawn on the card, 71.6 GB)
W8_TF = "llama-3.2-1b-w8"
W8_70B = "llama-3-70b"
W8_BENCH_ARGS = {**BENCH_ARGS, "model": W8_70B, "quantize": "int8"}
# each phase's wall seconds, logged before the total
PHASE_S: dict = {}
# set in the flex warm-up processes only (warm_flex): time_ms calls once
WARM_ONLY = False
WARMUP_RE = re.compile(r"warmup: \d+ requests ran \S+ in ([\d.]+)s")


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    """Adds the block's wall seconds to ``PHASE_S[name]`` and logs them (a run cut
    at its time limit still shows where its time went)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_S[name] = round(PHASE_S.get(name, 0.0) + time.perf_counter() - t0, 1)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")


def free_card() -> None:
    """Return what this process no longer holds to the card: an engine and
    its step sites refer to each other (``serve/graphs.py``), so their
    tensors wait for the cycle collector, which knows nothing of the
    card's memory."""
    gc.collect()
    torch.cuda.empty_cache()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30) -> float:
    """Mean device time of ``fn`` from CUDA events, each launch after a
    64 MiB write that evicts the inputs from the 50 MB L2 (the serving
    path reads each layer's K/V cold). A spin of about 1 ms on the card
    before the start event lets the host finish enqueueing ``fn`` (the
    plain versions are a dozen eager ops), so the events bracket device
    work and no host-side gap. In a flex warm-up process
    (:func:`warm_flex`) ``fn`` runs once and nothing is timed."""
    if WARM_ONLY:
        fn()
        return 0.0
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def assert_close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    err = (got.float() - want.float()).abs()
    limit = TOL + TOL * want.float().abs()
    if not bool((err <= limit).all()):
        raise AssertionError(f"{what}: max |err| {err.max().item():.4g} beyond atol=rtol={TOL}")
    return err.max().item()


def tile_rel_rms(got: torch.Tensor, want: torch.Tensor, floor: float = GRAD_RMS_FLOOR) -> float:
    """The worst relative RMS error of ``got`` against ``want`` ([B, H, T,
    D]) over tiles of GRAD_TILE_ROWS rows of one batch row and head, each
    tile's reference RMS at least ``floor``: a fault confined to a few
    keys or one query tile shows in its tile undiluted."""
    b, h, t, d = want.shape
    pad = (0, 0, 0, -t % GRAD_TILE_ROWS)
    err = torch.nn.functional.pad(got.float() - want.float(), pad).reshape(b, h, -1, GRAD_TILE_ROWS * d)
    ref = torch.nn.functional.pad(want.float(), pad).reshape(b, h, -1, GRAD_TILE_ROWS * d)
    n = torch.full((err.shape[2],), GRAD_TILE_ROWS * d, device=err.device)
    n[-1] = (t - (err.shape[2] - 1) * GRAD_TILE_ROWS) * d  # the last tile's real rows
    e_rms = (err.pow(2).sum(-1) / n).sqrt()
    r_rms = (ref.pow(2).sum(-1) / n).sqrt().clamp_min(floor)
    return (e_rms / r_rms).max().item()


def grad_close(got: torch.Tensor, want: torch.Tensor, what: str) -> tuple[float, float]:
    """A K2/K3 gradient against the plain version's: element-wise within
    atol = rtol = TOL, and within GRAD_RMS_TOL relative RMS in every tile.
    → (max |err|, the worst tile's relative RMS error)."""
    err = assert_close(got, want, what)
    rms = tile_rel_rms(got, want)
    if not rms <= GRAD_RMS_TOL:
        raise AssertionError(f"{what}: a tile's relative RMS error {rms:.4g} beyond {GRAD_RMS_TOL}")
    return err, rms


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase() -> dict:
    c = llama.LLAMA_32_1B
    g = torch.Generator(device="cuda").manual_seed(0)
    h, hkv, d, t = c.n_heads, c.n_kv_heads, c.head_dim, 2048
    scale = c.attention_scale
    rows = {}

    k = torch.randn(1, hkv, t, d, generator=g, device="cuda").bfloat16()
    v = torch.randn(1, hkv, t, d, generator=g, device="cuda").bfloat16()
    err_fwd, fwd = 0.0, None
    for chunk in (16, 256):
        for q_offset in (0, 512):
            q = torch.randn(1, h, chunk, d, generator=g, device="cuda").bfloat16()
            kw = dict(scale=scale, q_offset=q_offset)
            o, lse = flash.flash_attention_with_lse(q, k, v, **kw)
            po, plse = flash.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err_fwd = max(err_fwd, assert_close(o, po, f"flash_fwd C={chunk} q_offset={q_offset}"))
            assert_close(lse, plse, f"flash_fwd lse C={chunk} q_offset={q_offset}")
            qi = q_offset + torch.arange(chunk, device="cuda")[:, None]
            mask = qi >= torch.arange(t, device="cuda")[None, :]
            keys = q_offset + chunk  # the causal frontier: what this call needs
            nbytes = 2 * q.numel() * 2 + lse.numel() * 4 + 2 * keys * hkv * d * 2
            flops = 4 * d * h * (chunk * q_offset + chunk * (chunk + 1) // 2)
            b_ms, b_by = bound_ms(nbytes, flops)
            row = {
                "ms": time_ms(lambda: flash.flash_attention_with_lse(q, k, v, **kw)),
                "plain_ms": time_ms(lambda: flash.flash_attention_plain(q, k, v, **kw)),
                "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)),
                "bound_ms": b_ms,
                "bound_by": b_by,
            }
            log(f"kernel flash_fwd C={chunk} q_offset={q_offset}: {json.dumps(row)}")
            if (chunk, q_offset) == (256, 512):
                fwd = row  # the reported shape: a middle chunk of a long prompt
    rows["flash_fwd"] = {**fwd, "max_abs_err": err_fwd}

    b, grp = 8, h // hkv
    q = torch.randn(b, hkv, grp, d, generator=g, device="cuda").bfloat16()
    qv = torch.randn(b, hkv, grp * SPEC_ROWS, d, generator=g, device="cuda").bfloat16()
    kc = torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16()
    vc = torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16()
    int8 = (*engine.kv_quantize(kc), *engine.kv_quantize(vc))  # k, k_s, v, v_s
    pos = torch.tensor([0, 40, 200, 300, 700, 1024, 1500, 2047], dtype=torch.int32, device="cuda")
    # verify: the last row of a slot reads up to pos + S - 1 <= 2047
    pos_v = torch.tensor([0, 40, 200, 300, 700, 1024, 1500, 2043], dtype=torch.int32, device="cuda")
    for name, qq, pp, s_rows, quant in (
        ("flash_decode", q, pos, 1, False),
        ("flash_decode_verify", qv, pos_v, SPEC_ROWS, False),
        ("flash_decode_int8", q, pos, 1, True),
        ("flash_decode_int8_verify", qv, pos_v, SPEC_ROWS, True),
    ):
        k_, v_ = (int8[0], int8[2]) if quant else (kc, vc)
        kw = dict(scale=scale, rows_per_slot=s_rows)
        if quant:
            kw.update(k_scale=int8[1], v_scale=int8[3])
        rows[name] = decode_row(name, qq, k_, v_, pp, kw)
    return rows


def decode_row(name: str, q, k, v, pos, kw: dict, tiles: bool = False) -> dict:
    """One K4 variant against its plain version (with ``tiles`` by the
    tile-wise relative RMS rule too, ``tile_rel_rms`` over 32 rows of one
    slot and KV head, reported as ``tile_rel_rms``), then timed with its
    bound: every live key's K and V read once (bf16, or int8 plus its f32
    scale; with a window only the keys inside it), q (and the sinks) read
    and o written once; 4 D FLOP per live (row, key) pair. The library
    yardstick is SDPA with the explicit per-row mask and no sink column
    (no PyTorch call takes a sink logit), or with a softcap, and in a
    window at D = 256 (where SDPA with a mask leaves its flash path),
    :func:`flex_fwd`; no single PyTorch call reads an int8 cache with
    per-token scales."""
    o = flash_decode.flash_decode(q, k, v, pos, **kw)
    po = flash_decode.flash_decode_plain(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    b, hkv, r, d = q.shape
    t, s_rows, quant = k.shape[2], kw["rows_per_slot"], "k_scale" in kw
    window, sinks, softcap = kw.get("window", 0), kw.get("sinks"), kw.get("softcap", 0.0)
    err = assert_close(o, po, name)
    rms = tile_rel_rms(o, po) if tiles else None
    if rms is not None and not rms <= GRAD_RMS_TOL:
        raise AssertionError(f"{name}: a tile's relative RMS error {rms:.4g} beyond {GRAD_RMS_TOL}")
    qpos = pos.long()[:, None] + torch.arange(r, device="cuda")[None, :] % s_rows  # [B, R]
    kj = torch.arange(t, device="cuda")[None, None, :]
    mask = kj <= qpos[:, :, None]  # [B, R, T]
    if window:
        mask = mask & (qpos[:, :, None] - kj < window)
    # keys each KV head of a slot reads: its rows' union
    lo = (pos.long() - window + 1).clamp(min=0) if window else torch.zeros_like(pos.long())
    keys = int(((pos.long() + s_rows).clamp(max=t) - lo).sum())
    pairs = hkv * int(mask.sum())
    nbytes = 2 * q.numel() * 2 + pos.numel() * 4 + 2 * keys * hkv * (d + 4 if quant else 2 * d)
    if sinks is not None:
        nbytes += sinks.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 4 * d * pairs)
    flex = (softcap or (window and d == 256)) and not quant
    if flex:
        def keep(bb, hh, qi, kj):
            qp = pos[bb] + qi % s_rows
            live = kj <= qp
            return live & (qp - kj < window) if window else live
        library = flex_fwd(q, k, v, keep, kw["scale"], softcap, po)
    else:
        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask[:, None], scale=kw["scale"])
    rows_per_block, nsplit = flash_decode.decode_plan(
        b, hkv, r, t, d, window, s_rows, quant, torch.cuda.get_device_properties(0).multi_processor_count)
    row = {
        "nsplit": nsplit,
        "rows_per_block": rows_per_block,
        "ms": time_ms(lambda: flash_decode.flash_decode(q, k, v, pos, **kw)),
        "plain_ms": time_ms(lambda: flash_decode.flash_decode_plain(q, k, v, pos, **kw)),
        "library_ms": None if quant else time_ms(library),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "max_abs_err": err,
    }
    if rms is not None:
        row["tile_rel_rms"] = rms
    if quant:
        row["library_note"] = "no single PyTorch call reads an int8 cache with per-token scales"
    elif softcap:
        row["library_note"] = FLEX_NOTE
    elif flex:
        row["library_note"] = FLEX_WINDOW_FWD_NOTE
    elif sinks is not None:
        row["library_note"] = "SDPA over the same keys without the sink column: no PyTorch call takes sinks"
    log(f"kernel {name} q {list(q.shape)} cache {list(k.shape)} {k.dtype} window={window} "
        f"softcap={softcap} positions={pos.tolist()}: " + json.dumps(row))
    return row


FLEX_NOTE = "flex_attention compiled, tanh softcap as its score_mod, the mask as its block mask"
FLEX_WINDOW_FWD_NOTE = "flex_attention compiled, the causal window as its block mask"
_FLEX: list = []  # the compiled flex_attention, made on first use


def _flex(q, k, keep, cap: float) -> tuple:
    """(``flex_attention`` compiled to Triton, the block mask of ``keep(b,
    h, q_idx, kv_idx)``, ``cap * tanh(s / cap)`` as a score_mod, or None
    with no cap): the library yardstick of the softcap forms, and of K2 +
    K3 in a window. The port never calls it."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    if not _FLEX:
        # every shape, mask and softcap is its own compile of the one
        # function; past dynamo's default limit of 8 it would fall back to
        # the eager flex_attention, 10-20x slower, and time that instead
        torch._dynamo.config.recompile_limit = 64
        _FLEX.append(torch.compile(flex_attention, dynamic=False))
    block = create_block_mask(keep, B=q.shape[0], H=None, Q_LEN=q.shape[2], KV_LEN=k.shape[2],
                              device=q.device)

    def score_mod(s, b, h, qi, kj):
        return cap * torch.tanh(s / cap)

    return _FLEX[0], block, score_mod if cap else None


def flex_fwd(q, k, v, keep, scale: float, cap: float, want: torch.Tensor):
    """The library yardstick of a softcap form and of a windowed form at D
    = 256 (:func:`_flex`: the mask ``keep`` as its block mask, the cap as
    its score_mod where ``cap``), with the lse returned beside o. Its o is
    first held to ``want`` (the plain version's, or the kernel's where
    that was held to the plain version) within the kernels' tolerance, so
    it is timed computing the same function. → the call to time."""
    flex, block, score_mod = _flex(q, k, keep, cap)

    def call():
        return flex(q, k, v, score_mod=score_mod, block_mask=block, scale=scale,
                    enable_gqa=q.shape[1] != k.shape[1], return_lse=True)

    assert_close(call()[0], want, f"flex_attention softcap {cap} yardstick")
    return call


def _flex_fwd_ms(q, k, v, window: int, scale: float, cap: float, want: torch.Tensor) -> float:
    """:func:`flex_fwd` timed on causal square inputs with ``window``."""
    def keep(bb, hh, qi, kj):
        return (kj <= qi) & (qi - kj < window) if window else kj <= qi

    return time_ms(flex_fwd(q, k, v, keep, scale, cap, want))


def k1_row(what: str, q, k, v, kw: dict, sinks=None, tiles: bool = False) -> tuple[dict, float]:
    """K1 on a serving chunk against its plain version (o and lse), then
    timed with its bound: q read and o written once, the f32 lse written,
    the K and V of the keys the chunk can see (from the window's floor to
    its causal frontier) read once; 4 D FLOP per live (query, key) pair.
    With ``sinks`` the row also times the serving route (K1 then
    ``sink_postscale``) and the plain version takes the sink column. The
    library yardstick is SDPA with the explicit causal and window mask
    (without the sink column), or with a softcap, and in a window at D =
    256 (where SDPA with a mask leaves its flash path), :func:`flex_fwd`.
    With ``tiles`` o and lse are also held by the tile-wise relative RMS
    rule (``tile_rel_rms``, GRAD_RMS_TOL), reported as ``tile_rel_rms``.
    → (row, max |err|)."""
    o, lse = flash.flash_attention_with_lse(q, k, v, **kw)
    po, plse = flash.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = assert_close(o, po, what)
    assert_close(lse, plse, what + " lse")
    rms = None
    if tiles:
        rms = max(tile_rel_rms(o, po), tile_rel_rms(lse[..., None], plse[..., None]))
        if not rms <= GRAD_RMS_TOL:
            raise AssertionError(f"{what}: a tile's relative RMS error {rms:.4g} beyond {GRAD_RMS_TOL}")
    (_, h, c, d), (hkv, t) = q.shape, k.shape[1:3]
    q_offset, window, softcap = kw["q_offset"], kw.get("window", 0), kw.get("softcap", 0.0)
    qi = q_offset + torch.arange(c, device="cuda")[:, None]
    kj = torch.arange(t, device="cuda")[None, :]
    mask = qi >= kj
    if window:
        mask = mask & (qi - kj < window)
    lo = max(0, q_offset - window + 1) if window else 0
    nbytes = 2 * q.numel() * 2 + lse.numel() * 4 + 2 * (q_offset + c - lo) * hkv * d * 2
    b_ms, b_by = bound_ms(nbytes, 4 * d * h * int(mask.sum()))
    flex = softcap or (window and d == 256)
    if flex:
        def keep(bb, hh, qq, kk):
            qp = q_offset + qq
            live = kk <= qp
            return live & (qp - kk < window) if window else live
        library = flex_fwd(q, k, v, keep, kw["scale"], softcap, po)
    else:
        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=kw["scale"], enable_gqa=True)
    row = {"ms": time_ms(lambda: flash.flash_attention_with_lse(q, k, v, **kw))}
    if sinks is not None:
        row["route_ms"] = time_ms(lambda: attention(q, k, v, sinks=sinks, sinks_forward_only=True, **kw))
    row.update({
        "plain_ms": time_ms(lambda: flash.flash_attention_plain(q, k, v, sinks=sinks, **kw)),
        "library_ms": time_ms(library),
        "bound_ms": b_ms,
        "bound_by": b_by,
    })
    if rms is not None:
        row["tile_rel_rms"] = rms
    if softcap:
        row["library_note"] = FLEX_NOTE
    elif flex:
        row["library_note"] = FLEX_WINDOW_FWD_NOTE
    log(f"kernel {what} q {list(q.shape)} q_offset={q_offset} k/v {list(k.shape)} window={window} "
        f"softcap={softcap}: " + json.dumps(row))
    return row, err


def gemma_kernel_phase() -> dict:
    """K1 and K4 at Gemma's head width of 256. K1: a middle chunk of a long
    prompt on gemma-3-4b (q [1,8,256,256] at q_offset 512 over k/v
    [1,4,2048,256]) on a sliding layer (window 1024, the reported row) and
    a global one, and gemma-2-2b's sliding form (window 4096, softcap 50);
    a chunk at q_offset 1536, where the window's floor lies inside the
    row, is checked too. K4: its four forms (bf16 and int8 cache, decode
    q [8,4,2,256] and verify q [8,4,10,256]) over an [8,4,2048,256] cache
    at positions 0..2047, each on a gemma-3-4b sliding layer (window 1024,
    the reported row), a global layer, and gemma-2-2b's softcap 50."""
    c3, c2 = llama.CONFIGS[GEMMA3], llama.CONFIGS[GEMMA2]
    g = torch.Generator(device="cuda").manual_seed(6)
    h, hkv, d, t, q_offset = c3.n_heads, c3.n_kv_heads, c3.head_dim, 2048, 512
    win, rows = c3.sliding_window, {}

    q = torch.randn(1, h, CHUNK, d, generator=g, device="cuda").bfloat16()
    k = torch.randn(1, hkv, t, d, generator=g, device="cuda").bfloat16()
    v = torch.randn(1, hkv, t, d, generator=g, device="cuda").bfloat16()
    k1, errs = {}, []
    for key, cfg, window, softcap in (("sliding", c3, win, 0.0), ("global", c3, 0, 0.0),
                                      ("softcap", c2, c2.sliding_window, c2.attn_softcap)):
        kw = dict(scale=cfg.attention_scale, q_offset=q_offset, window=window, softcap=softcap)
        k1[key], err = k1_row(f"flash_fwd d256 {key}", q, k, v, kw)
        errs.append(err)
    kw = dict(scale=c3.attention_scale, q_offset=1536, window=win)
    o, lse = flash.flash_attention_with_lse(q, k, v, **kw)
    po, plse = flash.flash_attention_plain(q, k, v, **kw)
    errs += [assert_close(o, po, "flash_fwd d256 q_offset=1536"), assert_close(lse, plse, "lse q_offset=1536")]
    rows["flash_fwd_d256"] = {**k1["sliding"], "max_abs_err": max(errs), "window_0": k1["global"],
                              "softcap_50": k1["softcap"]}

    b, grp = 8, h // hkv
    kc = torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16()
    vc = torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16()
    int8 = (*engine.kv_quantize(kc), *engine.kv_quantize(vc))  # k, k_s, v, v_s
    pos = torch.tensor([0, 40, 200, 300, 700, 1024, 1500, 2047], dtype=torch.int32, device="cuda")
    pos_v = torch.tensor([0, 40, 200, 300, 700, 1024, 1500, 2043], dtype=torch.int32, device="cuda")
    for name, s_rows, quant in (
        ("flash_decode_d256", 1, False),
        ("flash_decode_verify_d256", SPEC_ROWS, False),
        ("flash_decode_int8_d256", 1, True),
        ("flash_decode_int8_verify_d256", SPEC_ROWS, True),
    ):
        qq = torch.randn(b, hkv, grp * s_rows, d, generator=g, device="cuda").bfloat16()
        k_, v_ = (int8[0], int8[2]) if quant else (kc, vc)
        forms = {}
        for key, window, softcap in (("sliding", win, 0.0), ("global", 0, 0.0),
                                     ("softcap", 0, c2.attn_softcap)):
            kw = dict(scale=c3.attention_scale, rows_per_slot=s_rows, window=window, softcap=softcap)
            if quant:
                kw.update(k_scale=int8[1], v_scale=int8[3])
            forms[key] = decode_row(f"{name} {key}", qq, k_, v_, pos_v if s_rows > 1 else pos, kw)
        rows[name] = {
            **forms["sliding"],
            "max_abs_err": max(r["max_abs_err"] for r in forms.values()),
            "window_0": forms["global"], "softcap_50": forms["softcap"],
        }
    return rows


def d128_kernel_phase() -> dict:
    """K1 and K4 at the dense families' head width of 128, at glm-4-9b's
    serving shapes (32 query heads over 2 KV heads, G = 16), with
    olmo-2-7b's G = 1 (32 over 32) beside each: K1 on a middle chunk of a
    long prompt, q [1,32,256,128] at q_offset 512 over k/v [1,2,2048,128]
    (the reported row) and over [1,32,2048,128] (``g1``); K4's four forms,
    decode q [8,2,16,128] and verify q [8,2,80,128] (G 16 x S 5: five row
    groups of 16) over an [8,2,2048,128] cache at positions 0..2047 (the
    reported rows), and q [8,32,1,128] / [8,32,5,128] over [8,32,2048,128]
    (``g1``: one live row in a 16-row tile). Every output is held to the
    plain version by both rules (element-wise and per 32-row tile), and
    timed beside its bound, the plain version and SDPA with the mask (none
    for the int8 forms)."""
    cg, co = llama.CONFIGS[GLM], llama.CONFIGS[OLMO]
    g = torch.Generator(device="cuda").manual_seed(12)
    h, d, t, q_offset = cg.n_heads, cg.head_dim, 2048, 512
    rows = {}

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()

    q = randn(1, h, CHUNK, d)
    k1, errs = {}, []
    for key, hkv in (("glm", cg.n_kv_heads), ("g1", co.n_kv_heads)):
        kw = dict(scale=cg.attention_scale, q_offset=q_offset)
        k1[key], err = k1_row(f"flash_fwd d128 {key}", q, randn(1, hkv, t, d), randn(1, hkv, t, d), kw, tiles=True)
        errs.append(err)
    # llama-4-scout's chunk: 40 query heads over 8 KV heads (G = 5), its
    # prefill chunks all in the first 8192-token attention chunk
    c4 = llama.CONFIGS[LLAMA4]
    k1["g5"], err = k1_row("flash_fwd d128 g5", randn(1, c4.n_heads, CHUNK, d), randn(1, c4.n_kv_heads, t, d),
                           randn(1, c4.n_kv_heads, t, d), dict(scale=c4.attention_scale, q_offset=q_offset),
                           tiles=True)
    errs.append(err)
    rows["flash_fwd_d128"] = {**k1["glm"], "max_abs_err": max(errs), "g1": k1["g1"], "g5": k1["g5"]}

    b = 8
    pos = torch.tensor([0, 40, 200, 300, 700, 1024, 1500, 2047], dtype=torch.int32, device="cuda")
    pos_v = torch.tensor([0, 40, 200, 300, 700, 1024, 1500, 2043], dtype=torch.int32, device="cuda")
    caches = {}
    for key, hkv in (("glm", cg.n_kv_heads), ("g1", co.n_kv_heads)):
        kc, vc = randn(b, hkv, t, d), randn(b, hkv, t, d)
        caches[key] = (hkv, kc, vc, (*engine.kv_quantize(kc), *engine.kv_quantize(vc)))
    for name, s_rows, quant in (
        ("flash_decode_d128", 1, False),
        ("flash_decode_verify_d128", SPEC_ROWS, False),
        ("flash_decode_int8_d128", 1, True),
        ("flash_decode_int8_verify_d128", SPEC_ROWS, True),
    ):
        forms = {}
        for key, (hkv, kc, vc, int8) in caches.items():
            qq = randn(b, hkv, (h // hkv) * s_rows, d)
            k_, v_ = (int8[0], int8[2]) if quant else (kc, vc)
            kw = dict(scale=cg.attention_scale, rows_per_slot=s_rows)
            if quant:
                kw.update(k_scale=int8[1], v_scale=int8[3])
            forms[key] = decode_row(f"{name} {key}", qq, k_, v_, pos_v if s_rows > 1 else pos, kw, tiles=True)
        rows[name] = {**forms["glm"], "max_abs_err": max(r["max_abs_err"] for r in forms.values()),
                      "tile_rel_rms": max(r["tile_rel_rms"] for r in forms.values()), "g1": forms["g1"]}
    return rows


def gpt_oss_kernel_phase() -> dict:
    """K1 and K4's sinks forms at gpt-oss-20b's shapes (64 query heads, 8
    KV heads, G = 8), sinks drawn from N(0, 1) (JAX's init sets them to 0).
    K1: a middle chunk of a long prompt (q [1,64,256,64] at q_offset 512
    over k/v [1,8,2048,64]) on a sliding (window 128, the reported row)
    and on a global layer; its o and lse against the plain versions, and
    the serving route (K1 then ``sink_postscale``) against the plain
    attention with ``sink_softmax``. K4: its four sinks forms at q
    [8,8,8,64] and verify q [8,8,40,64] (G 8 x S 5) over an [8,8,2048,64]
    cache at positions 0..2047, each with window 0 (the reported row) and
    128."""
    c = llama.CONFIGS[GPT_OSS]
    g = torch.Generator(device="cuda").manual_seed(5)
    h, hkv, d, t = c.n_heads, c.n_kv_heads, c.head_dim, 2048
    scale, win, q_offset = c.attention_scale, c.sliding_window, 512
    rows = {}

    q = torch.randn(1, h, CHUNK, d, generator=g, device="cuda").bfloat16()
    k = torch.randn(1, hkv, t, d, generator=g, device="cuda").bfloat16()
    v = torch.randn(1, hkv, t, d, generator=g, device="cuda").bfloat16()
    sinks = torch.randn(h, generator=g, device="cuda")
    errs, k1 = [], {}
    for window in (win, 0):
        kw = dict(scale=scale, q_offset=q_offset, window=window)
        what = f"flash_fwd gpt-oss window={window}"
        k1[window], err = k1_row(what, q, k, v, kw, sinks=sinks)
        so = attention(q, k, v, sinks=sinks, sinks_forward_only=True, **kw)
        pso = flash.flash_attention_plain(q, k, v, sinks=sinks, **kw)[0]
        errs += [err, assert_close(so, pso, what + " with sinks")]
    rows["flash_fwd_gpt_oss"] = {
        **k1[win], "max_abs_err": max(errs), "window_0": k1[0],
        "library_note": "SDPA with the explicit causal and window mask, without the sink column",
    }

    b, grp = 8, h // hkv
    kc = torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16()
    vc = torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16()
    int8 = (*engine.kv_quantize(kc), *engine.kv_quantize(vc))  # k, k_s, v, v_s
    pos = torch.tensor([0, 40, 200, 300, 700, 1024, 1500, 2047], dtype=torch.int32, device="cuda")
    pos_v = torch.tensor([0, 40, 200, 300, 700, 1024, 1500, 2043], dtype=torch.int32, device="cuda")
    for name, s_rows, quant in (
        ("flash_decode_sinks", 1, False),
        ("flash_decode_verify_sinks", SPEC_ROWS, False),
        ("flash_decode_int8_sinks", 1, True),
        ("flash_decode_int8_verify_sinks", SPEC_ROWS, True),
    ):
        qq = torch.randn(b, hkv, grp * s_rows, d, generator=g, device="cuda").bfloat16()
        row_sinks = torch.randn(hkv, grp * s_rows, generator=g, device="cuda")
        k_, v_ = (int8[0], int8[2]) if quant else (kc, vc)
        by_window = {}
        for window in (0, win):
            kw = dict(scale=scale, rows_per_slot=s_rows, window=window, sinks=row_sinks)
            if quant:
                kw.update(k_scale=int8[1], v_scale=int8[3])
            by_window[window] = decode_row(f"{name} window={window}", qq, k_, v_,
                                           pos_v if s_rows > 1 else pos, kw)
        rows[name] = {
            **by_window[0],
            "max_abs_err": max(r["max_abs_err"] for r in by_window.values()),
            f"window_{win}": {n: x for n, x in by_window[win].items() if n != "library_note"},
        }
    return rows


def live_pairs(t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps for a square [t, t] call at
    offset 0: what the kernels must compute, not the tiles they walk."""
    if not causal:
        return t * t
    if not window:
        return t * (t + 1) // 2
    return sum(min(i + 1, window) for i in range(t))


def ptxas_report(name: str) -> dict:
    """Registers and spill bytes of each compiled form of ``csrc/<name>.cu``
    (form = the kernel's name and template arguments, e.g.
    ``flash_decode_kernel<64,1,3>``: D, int8, M-tiles), from the
    ``-Xptxas -v`` log that ``cuda_build.build_all`` writes. The registers
    are the launch allocation: warp-specialised kernels move them between
    warpgroups with setmaxnreg at run time."""
    text = (cuda_build.BUILD_DIR / f"{name}.ptxas.log").read_text()
    forms = {}
    for m in re.finditer(r"Compiling entry function '([^']+)'.*?(\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads.*?Used (\d+) registers", text, re.S):
        mangled = m.group(1)
        base = re.search(r"((?:flash|w8)_[a-z_]*?_kernel|adam8_kernel)(?=I|E)", mangled)
        args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[base.end():]) if base else None
        form = (base.group(1) if base else mangled) + (
            "<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">" if args else "")
        forms[form] = {
            "registers": int(m.group(4)), "spill_stores": int(m.group(2)),
            "spill_loads": int(m.group(3)),
        }
    if not forms:
        raise AssertionError(f"no ptxas report for {name} in {cuda_build.BUILD_DIR}")
    return forms


def _bwd_bounds(q, k, lse, window: int = 0) -> dict:
    """Bound of K2 and K3 on causal square inputs: each reads q, k, v, dO,
    lse and delta once; K2 writes dq (3 products), K3 dk and dv (4), each
    2 D FLOP a live (query, key) pair."""
    b, h, t, d = q.shape
    gemm = 2 * b * h * live_pairs(t, True, window) * d  # FLOPs of one masked [T, T] x [T, D] product
    qb, kvb, rowb = q.numel() * 2, k.numel() * 2, lse.numel() * 4
    return {
        "flash_bwd_dq": bound_ms(2 * qb + 2 * kvb + 2 * rowb + qb, 3 * gemm),
        "flash_bwd_dkv": bound_ms(2 * qb + 2 * kvb + 2 * rowb + 2 * kvb, 4 * gemm),
    }


def _sdpa_bwd_ms(q, k, v, do) -> float:
    """The SDPA backward (dq, dk, dv together, ``is_causal``): the
    yardstick for K2 + K3 on causal layers."""
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    so = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    return time_ms(lambda: torch.autograd.grad(so, (qs, ks, vs), do, retain_graph=True))


FLEX_WINDOW_NOTE = "flex_attention compiled, the causal window as its block mask (its backward)"


def _flex_bwd(q, k, v, do, window: int, scale: float, cap: float, want: tuple, keep=None):
    """The yardstick of K2 + K3 in a window or with a softcap: the
    backward of :func:`_flex` (the causal window as its block mask, or
    the mask ``keep``; the tanh cap as its score_mod where ``cap``), its
    (dq, dk, dv) first held to the plain version's ``want``. → the call
    to time."""
    if keep is None:
        def keep(bb, hh, qi, kj):
            return (kj <= qi) & (qi - kj < window) if window else kj <= qi

    flex, block, score_mod = _flex(q, k, keep, cap)
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    fo = flex(qs, ks, vs, score_mod=score_mod, block_mask=block, scale=scale, enable_gqa=True)
    got = torch.autograd.grad(fo, (qs, ks, vs), do, retain_graph=True)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert_close(a, w, f"flex_attention window {window} softcap {cap} backward yardstick {name}")
    return lambda: torch.autograd.grad(fo, (qs, ks, vs), do, retain_graph=True)


def fwd_bwd_check(q, k, v, do, kw: dict, what: str) -> dict:
    """K1, K2 and K3 at one form against their plain versions: o by
    :func:`grad_close` (its worst tile under "flash_fwd_tiles") and lse
    within TOL; dq, dk and dv each by :func:`grad_close`; two launches of
    K2 and K3 bit-identical. → the forward's o, lse and delta, the plain
    gradients and the errors."""
    o, lse = flash.flash_attention_with_lse(q, k, v, **kw)
    po, plse = flash.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    o_err, o_rms = grad_close(o, po, f"flash_fwd {what}")
    fwd_err = max(o_err, assert_close(lse, plse, f"flash_fwd lse {what}"))
    del po, plse
    delta = flash.bwd_delta(o, do)

    def bwd():
        return (flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                *flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))

    got, again = bwd(), bwd()
    want = flash.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    checks = [grad_close(a, w, f"{n} {what}") for n, a, w in zip(("dq", "dk", "dv"), got, want)]
    if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
        raise AssertionError(f"K2/K3 {what}: two launches differ")
    return {
        "o": o, "lse": lse, "delta": delta, "want": want, "flash_fwd": fwd_err, "flash_fwd_tiles": o_rms,
        "flash_bwd_dq": checks[0], "flash_bwd_dkv": tuple(map(max, zip(*checks[1:]))),
    }


def gemma_backward_kernel_phase() -> dict:
    """K1, K2 and K3 at Gemma's head width of 256. First q/dO
    [4,8,2048,256] over k/v [4,4,2048,256], causal (the FLOPs of the D =
    64 rows), on gemma-3-4b's sliding layer (window 1024, the reported
    row), its global layer and gemma-2-2b's (window 4096, softcap 50):
    each form held to the plain versions (:func:`fwd_bwd_check`), then each
    kernel timed beside its bound, the plain version (dq, dk, dv together)
    and the library's backward (dq, dk, dv together): SDPA's ``is_causal``
    for the global layer, the compiled ``flex_attention`` in the window
    and with the softcap; K1 timed on the sliding layer. Then each Gemma
    fine-tune run's own micro-batch (TRAIN_RUNS: batch 8 over its
    ``--grad-accum``, the model's heads) on each of its layers' windows,
    with its softcap: held to the plain versions the same way and timed
    beside the bounds (``trainer_shapes``)."""
    c3, c2 = llama.CONFIGS[GEMMA3], llama.CONFIGS[GEMMA2]
    b, h, hkv, t, d = BWD_D256_SHAPE
    g = torch.Generator(device="cuda").manual_seed(7)
    q, do = (torch.randn(b, h, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    forms = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    fwd = None
    for key, cfg, window, softcap in (("sliding", c3, c3.sliding_window, 0.0), ("global", c3, 0, 0.0),
                                      ("softcap", c2, c2.sliding_window, c2.attn_softcap)):
        kw = dict(scale=cfg.attention_scale, window=window, softcap=softcap)
        what = f"d256 {key} window={window} softcap={softcap}"
        r = fwd_bwd_check(q, k, v, do, kw, what)
        o, lse, delta = r["o"], r["lse"], r["delta"]
        bounds = _bwd_bounds(q, k, lse, window)
        plain_ms = time_ms(lambda: flash.flash_bwd_plain(q, k, v, o, lse, do, **kw), iters=10)
        if softcap or window:
            library_ms = time_ms(_flex_bwd(q, k, v, do, window, kw["scale"], softcap, r["want"]))
        else:
            library_ms = _sdpa_bwd_ms(q, k, v, do)
        for name, fn in (
            ("flash_bwd_dq", lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw)),
            ("flash_bwd_dkv", lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)),
        ):
            row = {"ms": time_ms(fn), "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "max_abs_err": r[name][0],
                   "tile_rel_rms": r[name][1], "shape": list(BWD_D256_SHAPE)}
            if softcap:
                row["library_note"] = FLEX_NOTE + " (its backward)"
            elif window:
                row["library_note"] = FLEX_WINDOW_NOTE
            forms[name][key] = row
            log(f"kernel {name} q/dO [{b},{h},{t},{d}] k/v [{b},{hkv},{t},{d}] causal window={window} "
                f"softcap={softcap}: " + json.dumps(row))
        if key == "sliding":
            gemm = 2 * b * h * live_pairs(t, True, window) * d
            b_ms, b_by = bound_ms(2 * q.numel() * 2 + 2 * k.numel() * 2 + lse.numel() * 4, 2 * gemm)
            fwd = {"ms": time_ms(lambda: flash.flash_attention_with_lse(q, k, v, **kw)),
                   "plain_ms": time_ms(lambda: flash.flash_attention_plain(q, k, v, **kw), iters=10),
                   "library_ms": _flex_fwd_ms(q, k, v, window, kw["scale"], 0.0, o),
                   "library_note": FLEX_WINDOW_FWD_NOTE,
                   "bound_ms": b_ms, "bound_by": b_by, "shape": list(BWD_D256_SHAPE), "window": window,
                   "max_abs_err": r["flash_fwd"]}
            log(f"kernel flash_fwd (Gemma training shape) q [{b},{h},{t},{d}] window={window}: "
                + json.dumps(fwd))
        del r, o, lse, delta
    rows = {
        f"{name}_d256": {
            **by["sliding"], "max_abs_err": max(r["max_abs_err"] for r in by.values()),
            "tile_rel_rms": max(r["tile_rel_rms"] for r in by.values()),
            "window_0": by["global"], "softcap_50": by["softcap"], "trainer_shapes": {},
        }
        for name, by in forms.items()
    }
    rows["flash_fwd_d256"] = {"training_shape": fwd, "trainer_shapes": {}}
    del q, k, v, do
    free_card()

    # each Gemma fine-tune run's micro-batch, on every window its layers use
    for run, (model, _, accum, *_) in TRAIN_RUNS.items():
        if model not in D256:
            continue
        c = llama.CONFIGS[model]
        b, h, hkv = BWD_TRAIN_BATCH // accum, c.n_heads, c.n_kv_heads
        q, do = (torch.randn(b, h, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        for window in sorted(set(llama.layer_windows(c)), reverse=True):
            kw = dict(scale=c.attention_scale, window=window, softcap=c.attn_softcap)
            key = f"{run}_w{window}"
            r = fwd_bwd_check(q, k, v, do, kw, f"d256 {key} [{b},{h},{hkv}] softcap={c.attn_softcap}")
            lse, delta = r["lse"], r["delta"]
            gemm = 2 * b * h * live_pairs(t, True, window) * d
            bounds = {"flash_fwd": bound_ms(2 * q.numel() * 2 + 2 * k.numel() * 2 + lse.numel() * 4, 2 * gemm),
                      **_bwd_bounds(q, k, lse, window)}
            # the library's call of the same function: SDPA's is_causal on a
            # global layer without a softcap, else the compiled flex_attention
            # (the window its block mask, the softcap its score_mod), each
            # held to the kernels' outputs or the plain gradients first
            flex = bool(window or c.attn_softcap)
            note = FLEX_NOTE if c.attn_softcap else FLEX_WINDOW_FWD_NOTE if window else "SDPA, is_causal"
            if flex:
                library = {
                    "flash_fwd": _flex_fwd_ms(q, k, v, window, kw["scale"], c.attn_softcap, r["o"]),
                    "bwd": time_ms(_flex_bwd(q, k, v, do, window, kw["scale"], c.attn_softcap, r["want"])),
                }
            else:
                library = {
                    "flash_fwd": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=True, scale=kw["scale"], enable_gqa=True)),
                    "bwd": _sdpa_bwd_ms(q, k, v, do),
                }
            for name, fn in (
                ("flash_fwd", lambda: flash.flash_attention_with_lse(q, k, v, **kw)),
                ("flash_bwd_dq", lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw)),
                ("flash_bwd_dkv", lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)),
            ):
                err = r[name] if name == "flash_fwd" else r[name][0]
                row = {"shape": [b, h, hkv, t, d], "window": window, "softcap": c.attn_softcap,
                       "ms": time_ms(fn), "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                       "library_ms": library["flash_fwd" if name == "flash_fwd" else "bwd"],
                       "library_note": f"{note}; " + ("forward" if name == "flash_fwd"
                                                      else "backward: dq, dk, dv together"),
                       "max_abs_err": err}
                if name != "flash_fwd":
                    row["tile_rel_rms"] = r[name][1]
                    agg = rows[f"{name}_d256"]
                    agg["max_abs_err"] = max(agg["max_abs_err"], err)
                    agg["tile_rel_rms"] = max(agg["tile_rel_rms"], r[name][1])
                rows[f"{name}_d256"]["trainer_shapes"][key] = row
                log(f"kernel {name} ({run}'s micro-batch) q [{b},{h},{t},{d}] k/v [{b},{hkv},{t},{d}] "
                    f"window={window} softcap={c.attn_softcap}: " + json.dumps(row))
            del r, lse, delta
        del q, k, v, do
        free_card()
    return rows


def _sdpa_backend(q, k, v, mask, scale: float, causal: bool = False) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these
    inputs (its flash path stops at D = 256)."""
    try:
        gqa = {"enable_gqa": True} if q.shape[1] != k.shape[1] else {}
        choice = torch._fused_sdp_choice(q, k, v, mask, 0.0, causal, scale=scale, **gqa)
    except Exception as e:  # noqa: BLE001 - a private helper: name what went wrong
        return f"unknown ({type(e).__name__}: {e})"
    try:
        return torch.nn.attention.SDPBackend(choice).name
    except Exception:  # noqa: BLE001 - an enum without an int constructor
        return str(choice)


# K1's MLA entry at deepseek-v2-lite's chunks (C, q_offset) over a 2048-slot
# row: the serving chunk at three depths, a short prompt's only chunk, the
# ragged chunk, and a short turn deep in the row. The first is the
# reported row.
MLA_SHAPES = ((256, 512), (256, 0), (256, 1792), (32, 0), (40, 260), (32, 1792))
# ... and at deepseek-v3's 128 heads (64-head blocks, two a position): its
# serial chunk at q_offset 512 (the reported row) and 0, a 64-token and a
# 16-token prompt's only chunk, and a 16-token turn deep in the row (the
# one the plan splits: 32 blocks over 29 tiles)
MLA_V3_SHAPES = ((256, 512), (256, 0), (64, 0), (16, 0), (16, 1792))


def mla_bound(h: int, c: int, q_offset: int, d: int, rank: int) -> tuple[float, str]:
    """The least time of one MLA chunk: q read, o (``rank`` wide) and the
    f32 lse written, the row's keys up to the causal frontier read once;
    2 x D FLOP a live (query, key) pair for S and 2 x ``rank`` for P V,
    since o is ``rank`` wide."""
    live = h * (c * q_offset + c * (c + 1) // 2)
    nbytes = h * c * d * 2 + h * c * rank * 2 + h * c * 4 + (q_offset + c) * d * 2
    return bound_ms(nbytes, (2 * d + 2 * rank) * live)


def mla_kernel_phase(name: str = DEEPSEEK, mla_shapes: tuple = MLA_SHAPES, key: str = "flash_fwd_d576") -> dict:
    """K1's absorbed-MLA entry (``flash.flash_mla_with_lse``: D = 576,
    ``csrc/flash_fwd_mla.cu``) at deepseek-v2-lite's chunks (MLA_SHAPES),
    or with ``name`` another MLA model's heads at its chunks
    (deepseek-v3's 128 at MLA_V3_SHAPES, the row ``key``):
    q [1,H,C,576] over the latent row [1,1,2048,576], whose value is the
    row with its 64 rope columns zeroed, as the engine gives it. o (512
    wide) and lse against the plain version, o under the element-wise rule
    and the tile-wise relative RMS rule (``grad_close``); two launches
    bit-identical. Each shape is timed beside its bound (``mla_bound``),
    the plain version and one SDPA call with the offset-causal mask and
    the row expanded to the H heads (its value zeroed past 512, naming
    the backend SDPA takes), and the split plan against the other NSPLITs
    in turns (each candidate, then each again in reverse order): 1, half
    the plan's, and the split that fills the SMs. The floor of the timing
    (an empty kernel through ``time_ms``) is reported beside them."""
    c = llama.CONFIGS[name]
    g = torch.Generator(device="cuda").manual_seed(8)
    h, rank, t = c.n_heads, c.kv_lora_rank, 2048
    d, scale = rank + c.qk_rope_head_dim, c.attention_scale
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = torch.randn(1, 1, t, d, generator=g, device="cuda").bfloat16()
    value = flash.mla_value(row, rank)
    kx, vx = row.expand(1, h, t, d), value.expand(1, h, t, d)
    shapes, errs, tiles = {}, [], []
    for chunk, q_offset in mla_shapes:
        q = torch.randn(1, h, chunk, d, generator=g, device="cuda").bfloat16()
        kw = dict(rank=rank, scale=scale, q_offset=q_offset)
        what = f"flash_fwd_mla H={h} C={chunk} q_offset={q_offset}"
        o, lse = flash.flash_mla_with_lse(q, row, **kw)
        o2, lse2 = flash.flash_mla_with_lse(q, row, **kw)
        po, plse = flash.flash_mla_plain(q, row, **kw)
        torch.cuda.synchronize()
        err, rms = grad_close(o, po, what)
        err = max(err, assert_close(lse, plse, what + " lse"))
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"{what}: two launches differ")
        plan = flash.mla_plan(1, h, chunk, t, q_offset, sms)
        reach = min(-(-t // flash.MLA_TILE), (q_offset + chunk - 1) // flash.MLA_TILE + 1)
        fill = max(1, min(reach, sms // flash.mla_blocks(1, h, chunk)))
        candidates = sorted({plan, 1, max(1, plan // 2), fill})
        for ns in candidates:
            if ns != plan:
                oo, olse = flash._flash_mla_launch(q, row, nsplit=ns, **kw)
                grad_close(oo, po, f"{what} nsplit={ns}")
                assert_close(olse, plse, f"{what} nsplit={ns} lse")
        split_ms: dict = {}
        for ns in candidates + candidates[::-1]:
            split_ms.setdefault(str(ns), []).append(
                time_ms(lambda ns=ns: flash._flash_mla_launch(q, row, nsplit=ns, **kw)))
        ms = sum(split_ms[str(plan)]) / 2
        qi = q_offset + torch.arange(chunk, device="cuda")[:, None]
        mask = qi >= torch.arange(t, device="cuda")[None, :]
        backend = _sdpa_backend(q, kx, vx, mask, scale)

        def library(q=q, mask=mask):
            return torch.nn.functional.scaled_dot_product_attention(q, kx, vx, attn_mask=mask, scale=scale)

        b_ms, b_by = mla_bound(h, chunk, q_offset, d, rank)
        entry = {
            "ms": ms, "nsplit": plan, "split_ab_ms": split_ms,
            "plain_ms": time_ms(lambda: flash.flash_mla_plain(q, row, **kw)),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err, "tile_rel_rms": rms,
        }
        try:
            assert_close(library()[..., :rank], po, f"SDPA yardstick at D = 576, {what}")
            entry["library_ms"] = time_ms(library)
            entry["library_note"] = f"SDPA, offset-causal mask, the row expanded to {h} heads; backend {backend}"
        except (RuntimeError, AssertionError) as e:
            entry["library_ms"] = None
            entry["library_note"] = f"no single SDPA call computes it here ({backend}): {str(e)[:200]}"
        log(f"kernel flash_fwd_mla q {list(q.shape)} q_offset={q_offset} row {list(row.shape)}: "
            + json.dumps(entry))
        shapes[f"C{chunk}_q{q_offset}"] = entry
        errs.append(err)
        tiles.append(rms)
    reported = shapes["C%d_q%d" % mla_shapes[0]]
    floor = time_ms(lambda: torch.cuda._sleep(1))
    log(f"timing floor (an empty kernel through time_ms): {floor} ms")
    return {key: {**reported, "max_abs_err": max(errs), "tile_rel_rms": max(tiles),
                  "shapes": shapes, "timing_floor_ms": floor}}


def mla_train_kernel_phase() -> dict:
    """K1, K2 and K3 at MLA's training width (D = 192: deepseek-v2-lite's
    q/k heads of 128 + 64, v padded from 128 to 192), 16 heads (MHA),
    causal, scale 192^-0.5. First q/k/v/dO [4,16,2048,192], random: o,
    lse, dq, dk and dv held to the plain versions by both rules
    (:func:`fwd_bwd_check`: element-wise and tile by tile),
    reruns bit-identical, each kernel timed beside its bound, the plain
    version and SDPA's ``is_causal`` forward, or its backward (dq, dk, dv
    together), naming the backend SDPA takes. Then the same at the
    DeepSeek training run's micro-batch [8,16,2048,192], with v's and dO's
    last 64 columns zero as the training path gives them (o's and dv's
    come out zero there), timed beside the bounds and SDPA."""
    c = llama.CONFIGS[DEEPSEEK]
    b, h, hkv, t, d = MLA_TRAIN_SHAPE
    kw = dict(scale=c.attention_scale)
    g = torch.Generator(device="cuda").manual_seed(9)
    rows = {}
    for key, batch in (("main", b), ("trainer", BWD_TRAIN_BATCH // DEEPSEEK_TRAIN[0])):
        q, do = (torch.randn(batch, h, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(batch, hkv, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        if key == "trainer":
            v[..., c.v_head_dim:] = 0
            do[..., c.v_head_dim:] = 0
        shape = [batch, h, hkv, t, d]
        r = fwd_bwd_check(q, k, v, do, kw, f"d192 {shape}")
        o, lse, delta = r["o"], r["lse"], r["delta"]
        if key == "trainer" and (o[..., c.v_head_dim:].any() or r["want"][2][..., c.v_head_dim:].any()):
            raise AssertionError("d192: the zero value columns gave nonzero o or dv")
        gemm = 2 * batch * h * live_pairs(t, True, 0) * d
        bounds = {"flash_fwd": bound_ms(2 * q.numel() * 2 + 2 * k.numel() * 2 + lse.numel() * 4, 2 * gemm),
                  **_bwd_bounds(q, k, lse)}
        backend = _sdpa_backend(q, k, v, None, kw["scale"], causal=True)
        library = {
            "flash_fwd": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=kw["scale"])),
            "bwd": _sdpa_bwd_ms(q, k, v, do),  # SDPA's default scale is 192^-0.5 too
        }
        plain = {}
        if key == "main":  # the trainer's batch doubles the plain version's [B, H, T, T] f32 tensors
            plain = {"flash_fwd": time_ms(lambda: flash.flash_attention_plain(q, k, v, **kw), iters=10),
                     "bwd": time_ms(lambda: flash.flash_bwd_plain(q, k, v, o, lse, do, **kw), iters=10)}
        for name, fn in (
            ("flash_fwd", lambda: flash.flash_attention_with_lse(q, k, v, **kw)),
            ("flash_bwd_dq", lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw)),
            ("flash_bwd_dkv", lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)),
        ):
            fwd = name == "flash_fwd"
            row = {"shape": shape, "ms": time_ms(fn), "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                   "library_ms": library[name if fwd else "bwd"],
                   "library_note": f"SDPA, is_causal, backend {backend}; "
                                   + ("forward" if fwd else "backward: dq, dk, dv together"),
                   "max_abs_err": r[name] if fwd else r[name][0],
                   "tile_rel_rms": r["flash_fwd_tiles"] if fwd else r[name][1]}
            if key == "main":
                row["plain_ms"] = plain[name if fwd else "bwd"]
                rows[f"{name}_d192"] = row
            else:
                rows[f"{name}_d192"]["trainer_shape"] = row
            log(f"kernel {name} d192 q/dO [{batch},{h},{t},{d}] k/v [{batch},{hkv},{t},{d}] causal"
                f"{' (the training micro-batch, v and dO zero-padded)' if key == 'trainer' else ''}: "
                + json.dumps(row))
        del q, k, v, do, r, o, lse, delta
        free_card()
    return rows


def w8_bound(form: str, e: int, m: int, k: int, n: int) -> tuple:
    """W8's bound at one shape: the int8 weight, its f32 scales, x and the
    output (bf16, f32 for the head) each moved once, 2 M K N FLOPs."""
    out_bytes = 4 if form == "head" else 2
    return bound_ms(e * (k * n + 4 * n + 2 * m * k + out_bytes * m * n), 2 * e * m * k * n)


def _w8_time_row(what: str, form: str, x, q, s) -> dict:
    """One W8 shape: the kernel against ``w8_matmul_plain`` by both rules
    (element-wise within TOL, and the worst 32-row tile within
    GRAD_RMS_TOL relative RMS), a second launch bit-identical, then timed
    (CUDA events, L2 flushed) beside its bound, the plain version, the
    library call where the card's torch has one and the bf16 product of
    the same shape (a reference line: another function, twice the weight
    bytes)."""
    fn = {"proj": w8_matmul.w8_proj, "head": w8_matmul.w8_head, "experts": w8_matmul.w8_experts}[form]
    got = fn(x, q, s)
    want = w8_matmul.w8_matmul_plain(x, q, s, form)
    again = fn(x, q, s)
    torch.cuda.synchronize()
    err = assert_close(got, want, f"w8 {what}")
    g3, w3 = (got, want) if got.dim() == 3 else (got[None], want[None])
    rms = tile_rel_rms(g3[:, None].float(), w3[:, None].float())
    if not rms <= GRAD_RMS_TOL:
        raise AssertionError(f"w8 {what}: a tile's relative RMS error {rms:.4g} beyond {GRAD_RMS_TOL}")
    if not torch.equal(got, again):
        raise AssertionError(f"w8 {what}: two launches differ")
    e = q.shape[0] if q.dim() == 3 else 1
    m, k, n = x.shape[-2], q.shape[-2], q.shape[-1]
    b_ms, b_by = w8_bound(form, e, m, k, n)
    wb = q.to(torch.bfloat16)
    row = {"what": what, "form": form, "E": e, "M": m, "K": k, "N": n,
           "plan": list(w8_matmul.w8_plan(e, m, k, n)),
           "ms": time_ms(lambda: fn(x, q, s)), "plain_ms": time_ms(lambda: w8_matmul.w8_matmul_plain(x, q, s, form)),
           "bf16_matmul_ms": time_ms(lambda: torch.matmul(x, wb)),
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err, "tile_rel_rms": rms,
           "library_ms": None, "library_note": W8_LIBRARY["note"]}
    del wb
    # _weight_int8pack_mm takes one matrix, and beyond M = 40 a call takes
    # 0.1-0.5 s: there its time is the mean of 3 launches
    if W8_LIBRARY["ok"] and form != "experts":
        qt, sb = q.t().contiguous(), s.to(torch.bfloat16)
        row["library_ms"] = time_ms(lambda: torch._weight_int8pack_mm(x.reshape(-1, k), qt, sb),
                                    iters=30 if m <= 40 else 3)
        row["library_note"] = "torch._weight_int8pack_mm (weight [N, K], bf16 scales: its own roundings)"
        del qt, sb
    elif W8_LIBRARY["ok"]:
        row["library_note"] = "torch._weight_int8pack_mm takes no batch of experts"
    log(f"kernel w8 {what} [{form}] E={e} M={m} K={k} N={n}: {json.dumps(row)}")
    return row


def _w8_library_probe() -> None:
    """Whether the card's torch has ``torch._weight_int8pack_mm`` for CUDA
    bf16 (the one PyTorch call of a bf16 x int8 product with per-channel
    scales): W8's library column is its time, else null with the reason."""
    x = torch.randn(8, 256, device="cuda").bfloat16()
    w = torch.randint(-127, 128, (128, 256), device="cuda", dtype=torch.int8)
    try:
        torch._weight_int8pack_mm(x, w, torch.rand(128, device="cuda").bfloat16())
        torch.cuda.synchronize()
        W8_LIBRARY["ok"] = True
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        W8_LIBRARY["note"] = f"torch._weight_int8pack_mm on CUDA bf16: {type(e).__name__}: {str(e)[:160]}"
    log(f"w8 library yardstick: {json.dumps(W8_LIBRARY)}")


def w8_kernel_phase() -> dict:
    """W8 (``csrc/w8_matmul.cu``) against its plain version at the shapes
    its paths give it (W8_PROJ_SHAPES, W8_HEAD_SHAPES, W8_EXPERT_SHAPES:
    llama-3-70b's projections at M = 1, 8, 40, 256 and 1024, its head,
    mixtral-8x7b's expert stacks at decode, verify, a 64- and a 256-token
    chunk and a packed wave, and a K and an N that are not
    multiples of the tile), random int8 weights with scales of the random
    trees' range, x ~ N(0, 1); then one decode-shaped launch (a split
    plan) captured in a CUDA graph and replayed on new inputs: the same
    function, no host sync, the count bumped by the capture alone. → the
    kernels line's rows ``w8_proj`` (reported at w_gate, M = 8),
    ``w8_head`` (M = 8) and ``w8_experts`` (w_gate), each with every shape."""
    _w8_library_probe()
    g = torch.Generator(device="cuda").manual_seed(8)

    def weights(*shape):
        q = torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)
        s = (0.8 + 0.4 * torch.rand(*shape[:-2], shape[-1], generator=g, device="cuda")) * (0.02 / 127)
        return q, s

    def rows_of(form, shapes):
        out = []
        for what, *dims in shapes:
            *es, m, k, n = dims
            q, s = weights(*es, k, n)
            x = torch.randn(*es, m, k, generator=g, device="cuda").bfloat16()
            out.append(_w8_time_row(what, form, x, q, s))
            del q, s, x
        return out

    rows = {}
    for name, form, shapes, key in (("w8_proj", "proj", W8_PROJ_SHAPES, ("w_gate", 8)),
                                    ("w8_head", "head", W8_HEAD_SHAPES, ("lm_head", 8)),
                                    ("w8_experts", "experts", W8_EXPERT_SHAPES, ("w_gate", 8))):
        done = rows_of(form, shapes)
        main = next(r for r in done if (r["what"], r["M"]) == key)
        rows[name] = {**main, "shapes": done}
    # the decode-shaped launch in a CUDA graph
    q, s = weights(8192, 1024)
    x = torch.randn(8, 8192, generator=g, device="cuda").bfloat16()
    w8_matmul.w8_proj(x, q, s)
    torch.cuda.synchronize()
    graph, before = torch.cuda.CUDAGraph(), w8_matmul.LAUNCHES
    with torch.cuda.graph(graph):
        out = w8_matmul.w8_proj(x, q, s)
    x.copy_(torch.randn(8, 8192, generator=g, device="cuda").bfloat16())
    graph.replay()
    torch.cuda.synchronize()
    err = assert_close(out, w8_matmul.w8_matmul_plain(x, q, s), "w8 replayed from a CUDA graph")
    if w8_matmul.LAUNCHES != before + 1 or w8_matmul.w8_plan(1, 8, 8192, 1024).splits < 2:
        raise AssertionError(f"w8 in a graph: launches {w8_matmul.LAUNCHES - before} (want 1 at capture)")
    if int(w8_matmul.arrival_counts().abs().sum()):
        raise AssertionError("w8 in a graph: a split counter left above 0 after the replay")
    rows["w8_proj"]["graph_replay_max_abs_err"] = err
    del graph, out, q, s, x
    return rows


# A8 (ops/adam8.py) at the leaves of llama-3-8b's full fine-tune: its
# embedding, its stacked w_gate, and a leaf whose last axis is a single
# block, in bf16, and the embedding in f32 too. Beside the two rules on the
# parameters, the update p_new - p_old is held to the plain version's in
# every GRAD_TILE_ROWS-row tile of the leaf seen as [R, D], to a relative
# RMS of ADAM8_UPDATE_TOL by the parameters' dtype: a dropped weight decay
# or eps, or a step size 5 % off, moves it far beyond that (the
# ADAM8_MUTANTS, launched on the embedding in both dtypes, must fail it).
# The codes may differ from the plain version's by one step, in at most
# ADAM8_CODE_SHARE of them, and the scales by ADAM8_SCALE_RTOL relative;
# the plain version runs over slices of at most ADAM8_SLICE elements (the
# update is elementwise a block)
ADAM8_SHAPES = (("embed", (128256, 4096), torch.bfloat16), ("w_gate", (32, 4096, 14336), torch.bfloat16),
                ("one_block", (64, 256), torch.bfloat16), ("embed_f32", (128256, 4096), torch.float32))
ADAM8_UPDATE_TOL = {torch.bfloat16: 2e-3, torch.float32: 1e-4}
ADAM8_MUTANTS = ("no_weight_decay", "no_eps", "step_x1.05")
ADAM8_MUTANT_SHAPES = ("embed", "embed_f32")
ADAM8_CODE_SHARE = 1e-3
ADAM8_SCALE_RTOL = 1e-6
ADAM8_SLICE = 1 << 26
# the step size: 50 x the fine-tune's default, so that the update is many
# bf16 ulps of p and lr * wd * p, the weight decay's share, many f32 ulps
ADAM8_LR = 1e-2
ADAM8_HP = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)  # default_optimizer's
# every ADAM8_IDLE_EVERY-th row of a leaf is one the batch did not reach
# (an embedding's unseen token): no gradient, and moments small enough
# that eps weighs in its update
ADAM8_IDLE_EVERY = 16
ADAM8_LIBRARY_NOTE = "no PyTorch call computes Adam moments on an int8 log grid"


def adam8_leaf(shape, dtype, gen: torch.Generator) -> tuple:
    """A leaf of ``shape`` a few steps into a fine-tune, on ``gen``'s
    device → (p, g, mu_q, mu_s, nu_q, nu_s): p ~ N(0, 0.02^2) and g ~ N(0,
    1e-6) in ``dtype``; the moments drawn in f32, mu ~ N(0, (3e-4)^2) and
    nu = 1e-6 (0.5 + z^2) / 1.5 (so the update's |mu| / sqrt(nu) is about
    0.3), and coded with ``opt8.q8_encode``. Every ADAM8_IDLE_EVERY-th row
    of the leaf seen as [R, D] has g = 0, mu 1e-5 and nu 1e-10 of that (a
    sqrt(nu) about eps). Drawn ADAM8_SLICE elements at a time."""
    dev = gen.device
    d = shape[-1]
    rows = math.prod(shape) // d
    p = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)
    g = (torch.randn(shape, generator=gen, device=dev) * 1e-3).to(dtype)
    mu_q, nu_q = (torch.empty(shape, dtype=torch.int8, device=dev) for _ in range(2))
    mu_s, nu_s = (torch.empty((*shape[:-1], d // opt8.BLOCK), device=dev) for _ in range(2))
    g.view(rows, d)[::ADAM8_IDLE_EVERY] = 0
    per = max(1, ADAM8_SLICE // d)
    for r0 in range(0, rows, per):
        r1 = min(rows, r0 + per)
        idle = (torch.arange(r0, r1, device=dev) % ADAM8_IDLE_EVERY == 0)[:, None]
        mu = torch.randn((r1 - r0, d), generator=gen, device=dev) * 3e-4
        nu = (0.5 + torch.randn((r1 - r0, d), generator=gen, device=dev).square()) * (1e-6 / 1.5)
        mu = torch.where(idle, mu * 1e-5, mu)
        nu = torch.where(idle, nu * 1e-10, nu)
        for codes, scales, x in ((mu_q, mu_s, mu), (nu_q, nu_s, nu)):
            q, sc = opt8.q8_encode(x)
            codes.view(rows, d)[r0:r1] = q
            scales.view(rows, d // opt8.BLOCK)[r0:r1] = sc
    return p, g, mu_q, mu_s, nu_q, nu_s


def adam8_update_rms(p0: torch.Tensor, got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst relative RMS error of the update ``got - p0`` against
    ``want - p0`` (in f32) over the tiles of GRAD_TILE_ROWS rows of the
    leaf seen as [R, D]."""
    d = p0.shape[-1]
    base = p0.float()
    return tile_rel_rms((got.float() - base).reshape(1, 1, -1, d), (want.float() - base).reshape(1, 1, -1, d),
                        floor=torch.finfo(torch.float32).tiny)


def _adam8_plain_slices(p, g, mu_q, mu_s, nu_q, nu_s, scalars):
    """``opt8.adam8_update_plain`` over row slices of the leaf seen as
    [R, D] → (row slice, (p, mu_q, mu_s, nu_q, nu_s)) each."""
    d = p.shape[-1]
    rows = p.numel() // d
    per = max(1, ADAM8_SLICE // d)

    def flat(t, w):
        return t.reshape(rows, w)

    for r0 in range(0, rows, per):
        sl = slice(r0, min(rows, r0 + per))
        yield sl, opt8.adam8_update_plain(
            flat(p, d)[sl], flat(g, d)[sl], flat(mu_q, d)[sl], flat(mu_s, d // opt8.BLOCK)[sl],
            flat(nu_q, d)[sl], flat(nu_s, d // opt8.BLOCK)[sl], scalars, **ADAM8_HP)


def adam8_mutant(name: str, scalars: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """One of ADAM8_MUTANTS as the arguments a faulty kernel would act on
    → (ADAM8_HP changed, the device scalars changed)."""
    if name == "no_weight_decay":
        return {**ADAM8_HP, "weight_decay": 0.0}, scalars
    if name == "no_eps":
        return {**ADAM8_HP, "eps": 0.0}, scalars
    if name == "step_x1.05":
        return ADAM8_HP, torch.cat([scalars[:4], scalars[4:] * 1.05])
    raise ValueError(f"no mutant {name!r}")


def adam8_kernel_phase() -> dict:
    """A8 (``csrc/adam8.cu``) against ``opt8.adam8_update_plain`` at
    ADAM8_SHAPES, each leaf from :func:`adam8_leaf`, with the device
    scalars of the update at count 3 and step size ADAM8_LR (the
    gradients' global norm clips the large leaves, not the single-block
    one). The updated parameters by both rules (element-wise
    within TOL, every 32-row tile within GRAD_RMS_TOL relative RMS), the
    update itself within ADAM8_UPDATE_TOL in every tile
    (:func:`adam8_update_rms`), the codes within one step everywhere and
    differing in at most ADAM8_CODE_SHARE of them, the scales within
    ADAM8_SCALE_RTOL relative, and a rerun from the same inputs bitwise
    the first. At ADAM8_MUTANT_SHAPES the kernel also runs each of
    ADAM8_MUTANTS, and the update rule must fail every one. Then timed
    (CUDA events, L2 flushed) beside its bound (the bytes of
    ``adam8.bytes_moved``), the plain version and, for bf16, the port's
    bf16-moment ``AdamW.update`` on the same leaf (its global norm and
    clip included). → the kernels line's row ``adam8`` (the bf16
    embedding), each shape in its ``shapes``."""
    g = torch.Generator(device="cuda").manual_seed(20)
    shapes = []
    for what, shape, dtype in ADAM8_SHAPES:
        p, grad, mu_q, mu_s, nu_q, nu_s = ins = adam8_leaf(shape, dtype, g)
        norm = train_step.global_norm({"w": grad})
        scalars = opt8.adam8_scalars(norm, 1.0, 3, ADAM8_HP["b1"], ADAM8_HP["b2"], -ADAM8_LR)

        def launch(hp=ADAM8_HP, sc=scalars):
            out = [p.clone(), mu_q.clone(), mu_s.clone(), nu_q.clone(), nu_s.clone()]
            adam8.adam8_update(out[0], grad, out[1], out[2], out[3], out[4], sc, **hp)
            return out

        got, again = launch(), launch()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"adam8 {what}: two launches from the same inputs differ")
        del again
        mutants = {m: launch(*adam8_mutant(m, scalars))[0] for m in ADAM8_MUTANTS} \
            if what in ADAM8_MUTANT_SHAPES else {}
        d = shape[-1]
        p_rows = p.reshape(-1, d)
        flat = [t.reshape(-1, w) for t, w in zip(got, (d, d, d // opt8.BLOCK, d, d // opt8.BLOCK))]
        mut_rows = {m: t.reshape(-1, d) for m, t in mutants.items()}
        err = rms = upd = scale_rel = 0.0
        mut_upd = dict.fromkeys(mutants, 0.0)
        differ = 0
        for sl, want in _adam8_plain_slices(*ins, scalars):
            kp, wp = flat[0][sl], want[0]
            err = max(err, assert_close(kp, wp, f"adam8 {what} parameters"))
            rms = max(rms, tile_rel_rms(kp[None, None], wp[None, None]))
            upd = max(upd, adam8_update_rms(p_rows[sl], kp, wp))
            for m, t in mut_rows.items():
                mut_upd[m] = max(mut_upd[m], adam8_update_rms(p_rows[sl], t[sl], wp))
            for i, name in ((1, "mu"), (3, "nu")):
                step = (flat[i][sl].int() - want[i].int()).abs()
                if int(step.max()) > 1:
                    raise AssertionError(f"adam8 {what}: {name} codes {int(step.max())} steps from the plain version's")
                differ += int(step.count_nonzero())
                rel = ((flat[i + 1][sl] - want[i + 1]).abs() / want[i + 1].abs()).max().item()
                scale_rel = max(scale_rel, rel)
            del want
        share = differ / (2 * p.numel())
        tol = ADAM8_UPDATE_TOL[dtype]
        if not rms <= GRAD_RMS_TOL:
            raise AssertionError(f"adam8 {what}: a tile's relative RMS error {rms:.4g} beyond {GRAD_RMS_TOL}")
        if not upd <= tol:
            raise AssertionError(f"adam8 {what}: a tile's update {upd:.4g} relative RMS from the plain "
                                 f"version's (limit {tol})")
        blind = [m for m, e in mut_upd.items() if not e > tol]
        if blind:
            raise AssertionError(f"adam8 {what}: the update rule passes the faulty {blind}: {mut_upd}")
        if not share <= ADAM8_CODE_SHARE:
            raise AssertionError(f"adam8 {what}: {share:.3g} of the codes differ (limit {ADAM8_CODE_SHARE})")
        if not scale_rel <= ADAM8_SCALE_RTOL:
            raise AssertionError(f"adam8 {what}: scales {scale_rel:.3g} relative from the plain version's")
        del got, flat, mutants, mut_rows
        b_ms, b_by = bound_ms(adam8.bytes_moved(p), 0)
        work = [p.clone(), mu_q.clone(), mu_s.clone(), nu_q.clone(), nu_s.clone()]
        ms = time_ms(lambda: adam8.adam8_update(work[0], grad, work[1], work[2], work[3], work[4], scalars,
                                                **ADAM8_HP))
        del work
        big = p.numel() > ADAM8_SLICE
        plain_ms = time_ms(lambda: [x for _, x in _adam8_plain_slices(*ins, scalars)], iters=3 if big else 30)
        adamw_ms = None
        if dtype == torch.bfloat16:
            bf16 = train_step.AdamW(lambda count: ADAM8_LR, b1=ADAM8_HP["b1"], b2=ADAM8_HP["b2"],
                                    weight_decay=ADAM8_HP["weight_decay"])
            pw = {"w": p.clone()}
            st = {"count": 2, "mu": {"w": (torch.randn(shape, generator=g, device="cuda") * 1e-4).bfloat16()},
                  "nu": {"w": (torch.rand(shape, generator=g, device="cuda") * 1e-7).bfloat16()}}
            adamw_ms = time_ms(lambda: bf16.update({"w": grad}, st, pw), iters=5 if big else 30)
            del pw, st
        row = {"what": what, "shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
               "clipped": bool(norm >= 1.0), "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": adam8.bytes_moved(p), "max_abs_err": err, "tile_rel_rms": rms,
               "update_tile_rel_rms": upd, "update_tol": tol, "mutants_update_tile_rel_rms": mut_upd,
               "code_differ_share": share, "scale_max_rel_err": scale_rel,
               "adamw_bf16_ms": adamw_ms, "library_ms": None, "library_note": ADAM8_LIBRARY_NOTE}
        log(f"kernel adam8 {what} {list(shape)} {row['dtype']}: {json.dumps(row)}")
        shapes.append(row)
        del p, grad, mu_q, nu_q, mu_s, nu_s, ins
        free_card()
    return {"adam8": {**shapes[0], "shapes": shapes}}


def d128_train_kernel_phase(model: str = LLAMA_8B, train_shape: tuple = D128_TRAIN_SHAPE,
                            suffix: str = "") -> dict:
    """K1, K2 and K3 at ``model``'s training micro-batch: llama-3-8b's
    (D128_TRAIN_SHAPE: q/dO [8,32,2048,128] over k/v [8,8,2048,128],
    causal), the shapes ``train_opt8_phase`` gives them, or starcoder2-7b's
    at G = 9 (D128_G9_TRAIN_SHAPE, its fine-tune's; ``suffix`` "_g9"): o,
    lse, dq, dk and dv held to the plain versions by both rules
    (:func:`fwd_bwd_check`), K2/K3 reruns bit-identical, each kernel timed
    beside its bound, the plain version and SDPA's ``is_causal`` forward
    or backward (the backend named). → K1's as ``train_shape<suffix>`` of
    the ``flash_fwd_d128`` row, and the rows ``flash_bwd_dq_d128<suffix>``,
    ``flash_bwd_dkv_d128<suffix>``."""
    c = llama.CONFIGS[model]
    b, h, hkv, t, d = train_shape
    kw = dict(scale=c.attention_scale)
    g = torch.Generator(device="cuda").manual_seed(21)
    q, do = (torch.randn(b, h, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    shape = [b, h, hkv, t, d]
    r = fwd_bwd_check(q, k, v, do, kw, f"d128 {shape}")
    o, lse, delta = r["o"], r["lse"], r["delta"]
    del r["want"]
    gemm = 2 * b * h * live_pairs(t, True, 0) * d
    bounds = {"flash_fwd": bound_ms(2 * q.numel() * 2 + 2 * k.numel() * 2 + lse.numel() * 4, 2 * gemm),
              **_bwd_bounds(q, k, lse)}
    backend = _sdpa_backend(q, k, v, None, kw["scale"], causal=True)
    library = {"flash_fwd": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, is_causal=True, scale=kw["scale"], enable_gqa=True)),
               "bwd": _sdpa_bwd_ms(q, k, v, do)}
    plain = {"flash_fwd": time_ms(lambda: flash.flash_attention_plain(q, k, v, **kw), iters=3),
             "bwd": time_ms(lambda: flash.flash_bwd_plain(q, k, v, o, lse, do, **kw), iters=3)}
    rows = {}
    for name, fn in (
        ("flash_fwd", lambda: flash.flash_attention_with_lse(q, k, v, **kw)),
        ("flash_bwd_dq", lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw)),
        ("flash_bwd_dkv", lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)),
    ):
        fwd = name == "flash_fwd"
        row = {"shape": shape, "ms": time_ms(fn), "plain_ms": plain[name if fwd else "bwd"],
               "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
               "library_ms": library[name if fwd else "bwd"],
               "library_note": f"SDPA, is_causal, backend {backend}; "
                               + ("forward" if fwd else "backward: dq, dk, dv together"),
               "max_abs_err": r[name] if fwd else r[name][0],
               "tile_rel_rms": r["flash_fwd_tiles"] if fwd else r[name][1]}
        rows[name] = row
        log(f"kernel {name} d128 q/dO [{b},{h},{t},{d}] k/v [{b},{hkv},{t},{d}] causal "
            f"({model}'s training micro-batch): " + json.dumps(row))
    del q, k, v, do, r, o, lse, delta
    free_card()
    return {"flash_fwd_d128": {f"train_shape{suffix}": rows["flash_fwd"]},
            f"flash_bwd_dq_d128{suffix}": rows["flash_bwd_dq"], f"flash_bwd_dkv_d128{suffix}": rows["flash_bwd_dkv"]}


def embed_kernel_phase(rows: dict) -> None:
    """K1 at the shapes /v1/embeddings gives it, which no serving chunk
    does: one square causal call a layer, B = 1, q_offset 0, Tq = Tk =
    the input's padded length (``embed_padded_len``). llama-3.2-1b at q
    [1,32,T,64] over k/v [1,8,T,64] for EMBED_LENS (T 16, 128, 1024,
    2048; at 16 the keys fill less than one 64-key tile); and
    FAMILY_EMBED_LEN's T = 128 on the other families: gpt-oss-20b's sinks
    route on a sliding (window 128) and a global layer, gemma-3-4b at D =
    256 on a sliding (window 1024) and a global layer, glm-4-9b at D = 128
    (q [1,32,128,128] over k/v [1,2,128,128]), and DeepSeek's
    non-absorbed form at D = 192 (q/k/v [1,16,128,192], v's last 64
    columns zero as ``_attn_qkv`` pads them). o and lse are held to
    the plain version by the element-wise and the tile-wise rule, the
    sinks route's output too, and each shape is timed beside its bound
    (``k1_row``). Each result goes under ``embeddings`` in its kernel's
    row, whose ``max_abs_err`` then covers it."""
    g = torch.Generator(device="cuda").manual_seed(10)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()

    def add(name: str, key: str, row: dict, err: float) -> None:
        rows[name].setdefault("embeddings", {})[key] = {**row, "max_abs_err": err}
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)

    c = llama.LLAMA_32_1B
    for n in EMBED_LENS:
        t = embed_padded_len(n)
        q, k, v = randn(1, c.n_heads, t, c.head_dim), randn(1, c.n_kv_heads, t, c.head_dim), \
            randn(1, c.n_kv_heads, t, c.head_dim)
        kw = dict(scale=c.attention_scale, q_offset=0)
        add("flash_fwd", f"T{t}", *k1_row(f"flash_fwd embedding T={t}", q, k, v, kw, tiles=True))

    t = embed_padded_len(FAMILY_EMBED_LEN)
    c = llama.CONFIGS[GPT_OSS]
    q, k, v = randn(1, c.n_heads, t, c.head_dim), randn(1, c.n_kv_heads, t, c.head_dim), \
        randn(1, c.n_kv_heads, t, c.head_dim)
    sinks = torch.randn(c.n_heads, generator=g, device="cuda")
    for window in (c.sliding_window, 0):
        kw = dict(scale=c.attention_scale, q_offset=0, window=window)
        what = f"flash_fwd gpt-oss embedding T={t} window={window}"
        row, err = k1_row(what, q, k, v, kw, sinks=sinks, tiles=True)
        so = attention(q, k, v, sinks=sinks, sinks_forward_only=True, **kw)
        pso = flash.flash_attention_plain(q, k, v, sinks=sinks, **kw)[0]
        serr, srms = grad_close(so, pso, what + " with sinks")
        row["tile_rel_rms"] = max(row["tile_rel_rms"], srms)
        add("flash_fwd_gpt_oss", f"T{t}_window{window}", row, max(err, serr))

    c = llama.CONFIGS[GEMMA3]
    q, k, v = randn(1, c.n_heads, t, c.head_dim), randn(1, c.n_kv_heads, t, c.head_dim), \
        randn(1, c.n_kv_heads, t, c.head_dim)
    for window in (c.sliding_window, 0):
        kw = dict(scale=c.attention_scale, q_offset=0, window=window)
        add("flash_fwd_d256", f"T{t}_window{window}",
            *k1_row(f"flash_fwd d256 embedding T={t} window={window}", q, k, v, kw, tiles=True))

    c = llama.CONFIGS[GLM]
    q, k, v = randn(1, c.n_heads, t, c.head_dim), randn(1, c.n_kv_heads, t, c.head_dim), \
        randn(1, c.n_kv_heads, t, c.head_dim)
    kw = dict(scale=c.attention_scale, q_offset=0)
    add("flash_fwd_d128", f"T{t}", *k1_row(f"flash_fwd d128 embedding T={t}", q, k, v, kw, tiles=True))

    c = llama.CONFIGS[DEEPSEEK]
    d = c.qk_head_dim
    q, k, v = randn(1, c.n_heads, t, d), randn(1, c.n_heads, t, d), randn(1, c.n_heads, t, d)
    v[..., c.v_head_dim:] = 0
    kw = dict(scale=c.attention_scale, q_offset=0)
    add("flash_fwd_d192", f"T{t}", *k1_row(f"flash_fwd d192 embedding T={t}", q, k, v, kw, tiles=True))


def ptxas_gate() -> dict:
    """Each kernel's registers and spills, every compiled form, from
    ptxas: a spill fails the run, and so does a missing head width of K1,
    K2 or K3 (64, 128, 192, 256). The softcap is a branch inside
    each compiled form, so one report covers both paths."""
    ptxas = {}
    for name in cuda_build.KERNEL_SOURCES:
        ptxas[name] = ptxas_report(name)
        log(f"ptxas {name}: {json.dumps(ptxas[name])}")
        spilled = {f: r for f, r in ptxas[name].items() if r["spill_stores"] or r["spill_loads"]}
        if spilled:
            raise AssertionError(f"{name} spills registers: {spilled}")
        if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            missing = [d for d in flash.HEAD_DIMS
                       if not any(f.startswith(f"{name}_kernel<{d}") for f in ptxas[name])]
            if missing:
                raise AssertionError(f"{name}: no compiled form for head_dim {missing}: {ptxas[name]}")
        if name == "flash_decode" and not any(f.startswith(f"{name}_kernel<128,") for f in ptxas[name]):
            raise AssertionError(f"{name}: no compiled D = 128 form: {ptxas[name]}")
        if name == "flash_fwd_mla" and not {f"{name}_kernel<{flash.MLA_HEAD_DIM}>",
                                            "flash_mla_combine_kernel"} <= set(ptxas[name]):
            raise AssertionError(f"{name}: no compiled D = {flash.MLA_HEAD_DIM} form or combine: {ptxas[name]}")
        if name == "adam8" and not {"adam8_kernel<0>", "adam8_kernel<1>"} <= set(ptxas[name]):
            raise AssertionError(f"{name}: a form (f32, bf16 parameters) is not compiled: {ptxas[name]}")
        if name == "w8_matmul" and not {"w8_stream_kernel", "w8_wgmma_kernel<0>",
                                        "w8_wgmma_kernel<1>"} <= set(ptxas[name]):
            raise AssertionError(f"{name}: a form (byte-streaming, chunk, chunk with paired k tiles) is not "
                                 f"compiled: {ptxas[name]}")
    return ptxas


def backward_kernel_phase() -> dict:
    """K2 and K3 against flash_bwd_plain at the training shape, then
    timed: each kernel alone (delta computed beforehand), the plain
    version (dq, dk, dv together) and the SDPA backward (dq, dk, dv
    together: the yardstick for K2 + K3); then K2, K3 and the SDPA
    backward again at the trainer's batch. K1 is timed at both shapes
    beside them (its ``training_shape`` and ``trainer_shape``)."""
    b, h, hkv, t, d = BWD_SHAPE
    g = torch.Generator(device="cuda").manual_seed(2)
    err = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    rms = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    main = None
    for t_case, kw in ((t, {}), (t, dict(window=512, softcap=30.0)), (1000, {})):
        q = torch.randn(b, h, t_case, d, generator=g, device="cuda").bfloat16()
        do = torch.randn(b, h, t_case, d, generator=g, device="cuda").bfloat16()
        k = torch.randn(b, hkv, t_case, d, generator=g, device="cuda").bfloat16()
        v = torch.randn(b, hkv, t_case, d, generator=g, device="cuda").bfloat16()
        o, lse = flash.flash_attention_with_lse(q, k, v, **kw)
        dq, dk, dv = flash.flash_bwd(q, k, v, o, lse, do, **kw)
        pdq, pdk, pdv = flash.flash_bwd_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        what = f"T={t_case} {kw or 'causal'}"
        for kernel, got, want, name in (("flash_bwd_dq", dq, pdq, "dq"), ("flash_bwd_dkv", dk, pdk, "dk"),
                                        ("flash_bwd_dkv", dv, pdv, "dv")):
            e, r = grad_close(got, want, f"{kernel} {name} {what}")
            err[kernel], rms[kernel] = max(err[kernel], e), max(rms[kernel], r)
        if main is None:
            main = (q, k, v, o, lse, do)
        del dq, dk, dv, pdq, pdk, pdv
    q, k, v, o, lse, do = main
    delta = flash.bwd_delta(o, do)
    bounds = _bwd_bounds(q, k, lse)
    # K1 at the shape the trainer gives it (its kernels-line row stays at
    # the serving shape): 2 causal GEMMs, reads q, k, v, writes o and lse
    fwd = {
        "ms": time_ms(lambda: flash.flash_attention_with_lse(q, k, v)),
        "plain_ms": time_ms(lambda: flash.flash_attention_plain(q, k, v), iters=10),
        "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
    }
    gemm = 2 * b * h * live_pairs(t, True, 0) * d
    b_ms, b_by = bound_ms(2 * q.numel() * 2 + 2 * k.numel() * 2 + lse.numel() * 4, 2 * gemm)
    fwd.update(bound_ms=b_ms, bound_by=b_by, shape=[b, h, hkv, t, d])
    log(f"kernel flash_fwd (training shape) q [{b},{h},{t},{d}] k/v [{b},{hkv},{t},{d}] causal: {json.dumps(fwd)}")
    plain_ms = time_ms(lambda: flash.flash_bwd_plain(q, k, v, o, lse, do), iters=10)
    sdpa_ms = _sdpa_bwd_ms(q, k, v, do)
    rows = {
        "flash_bwd_dq": {"ms": time_ms(lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta))},
        "flash_bwd_dkv": {"ms": time_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta))},
        "flash_fwd": {"training_shape": fwd},
    }
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        row = rows[name]
        row.update(
            plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bounds[name][0],
            bound_by=bounds[name][1], max_abs_err=err[name], tile_rel_rms=rms[name],
        )
        log(f"kernel {name} q/dO [{b},{h},{t},{d}] k/v [{b},{hkv},{t},{d}] causal: {json.dumps(row)}")
    del main, q, k, v, o, lse, do, delta
    free_card()

    # the trainer's shape: twice the batch (the plain version, ~4 GB a
    # [B, H, T, T] f32 intermediate here, is not timed again)
    b = BWD_TRAIN_BATCH
    q, do = (torch.randn(b, h, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    o, lse = flash.flash_attention_with_lse(q, k, v)
    delta = flash.bwd_delta(o, do)
    bounds = _bwd_bounds(q, k, lse)
    sdpa_ms = _sdpa_bwd_ms(q, k, v, do)
    gemm = 2 * b * h * live_pairs(t, True, 0) * d
    b_ms, b_by = bound_ms(2 * q.numel() * 2 + 2 * k.numel() * 2 + lse.numel() * 4, 2 * gemm)
    row = {"shape": [b, h, hkv, t, d], "ms": time_ms(lambda: flash.flash_attention_with_lse(q, k, v)),
           "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True)), "bound_ms": b_ms, "bound_by": b_by}
    rows["flash_fwd"]["trainer_shape"] = row
    log(f"kernel flash_fwd q [{b},{h},{t},{d}] k/v [{b},{hkv},{t},{d}] causal (trainer's shape): "
        + json.dumps(row))
    for name, fn in (("flash_bwd_dq", lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta)),
                     ("flash_bwd_dkv", lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta))):
        row = {"shape": [b, h, hkv, t, d], "ms": time_ms(fn), "library_ms": sdpa_ms,
               "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
        rows[name]["trainer_shape"] = row
        log(f"kernel {name} q/dO [{b},{h},{t},{d}] k/v [{b},{hkv},{t},{d}] causal (trainer's shape): "
            + json.dumps(row))
    return rows


# ---------------------------------------------------------------------------
# phase 3: the serving path through the server, then teacher forcing
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _post(url: str, body: dict, timeout: float = 300) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _stream(url: str, body: dict) -> tuple[list, float, list]:
    """POST an SSE request → (events, send time, arrival time of each event)."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    events, arrivals = [], []
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                events.append("[DONE]")
                break
            events.append(json.loads(line[len("data: "):]))
            arrivals.append(time.perf_counter())
    return events, t0, arrivals


def _post_status(url: str, body: dict) -> tuple[int, dict]:
    """POST → (status, JSON body), an HTTP error status included."""
    try:
        return 200, _post(url, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _chunks(n_tokens: int) -> int:
    """Prefill chunks the engine runs for a prompt: one bucket up to
    CHUNK tokens, else ceil(n / CHUNK)."""
    return 1 if n_tokens <= CHUNK else -(-n_tokens // CHUNK)


def _text(n: int, step: int = 7, shift: int = 0) -> str:
    """An n-token prompt of lowercase letters (one byte token each)."""
    return "".join(chr(97 + (i * step + n + shift) % 26) for i in range(n))


# servers started ahead of their phase (:func:`spawn_server`): name →
# (process, its log file, port, start time)
_SPAWNED: dict = {}


def spawn_server(name: str, model: str, flags: list, env=None) -> None:
    """Start ``python -m dstack_tpu_torch.serve.openai_server`` for
    :func:`_server` ``name`` now, on a free port, with no ``--device``
    flag (cuda is the server's default) and ``env`` added to this
    process's environment; :func:`_server` takes it over. Its log is
    ``build/chip_smoke_server_<name>.log``."""
    port = _free_port()
    server_log = ROOT / "build" / f"chip_smoke_server_{name}.log"
    server_log.parent.mkdir(parents=True, exist_ok=True)
    with open(server_log, "w") as log_f:  # the child keeps its own descriptor
        proc = subprocess.Popen(
            [sys.executable, "-m", "dstack_tpu_torch.serve.openai_server",
             "--model", model, "--decode-kernel", "flash",
             "--port", str(port), "--seed", "0", *flags],
            cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT, env={**os.environ, **(env or {})},
        )
    _SPAWNED[name] = (proc, server_log, port, time.perf_counter())


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def stop_spawned() -> None:
    """Stop every server started ahead that no phase took over."""
    while _SPAWNED:
        _stop(_SPAWNED.popitem()[1][0])


@contextlib.contextmanager
def _server(name: str, model: str, flags: list, env=None, then=None):
    """The server ``name`` (started now by :func:`spawn_server`, or taken
    over where it was started ahead) once ``/health`` answers → (base URL,
    the first ``/health``, seconds from its start to ready, the start-up
    warmup's seconds from its log or None). A fresh process: every count
    starts at 0. ``then`` (the arguments of :func:`spawn_server`) is the
    next server, started now, so that its start-up overlaps this one's
    start-up and drive. The process is stopped on the way out; its log
    is printed on failure."""
    if name not in _SPAWNED:
        spawn_server(name, model, flags, env)
    proc, server_log, port, t0 = _SPAWNED.pop(name)
    base = f"http://127.0.0.1:{port}"
    if then is not None:
        spawn_server(*then)
    try:
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"server exited with {proc.returncode} before it was ready")
            try:
                h0 = _get(base + "/health")
                break
            except OSError:
                if time.perf_counter() - t0 > 600:
                    raise RuntimeError("server not ready after 600 s")
                time.sleep(0.5)
        ready_s = time.perf_counter() - t0
        m = WARMUP_RE.search(server_log.read_text())
        yield base, h0, ready_s, float(m.group(1)) if m else None
    except BaseException:
        log(f"server [{name}] log tail:\n" + server_log.read_text()[-4000:])
        raise
    finally:
        _stop(proc)


def _scrape(base: str) -> dict:
    """``GET /metrics`` → {series (name with its labels): value}; the page
    must be ``text/plain``."""
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        if not r.headers.get("Content-Type", "").startswith("text/plain"):
            raise AssertionError(f"/metrics content type {r.headers.get('Content-Type')}")
        text = r.read().decode()
    series = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.split(" # ", 1)[0].rsplit(" ", 1)
            series[key] = float(value)
    return series


def _family_sum(m: dict, name: str) -> float:
    """The sum of a labelled family's series in a scrape."""
    return sum(v for k, v in m.items() if k.startswith(name + "{"))


def _site_sum(m: dict, name: str, prefill: bool) -> float:
    """The sum of a compile family's series in a scrape (or a difference
    of two) over the prefill sites, or over the others."""
    return sum(v for k, v in m.items()
               if k.startswith(name + "{") and (k.split('"')[1] in PREFILL_SITES) == prefill)


def _metrics_identities(what: str, sent: int, m0: dict, m1: dict, h0: dict, h1: dict) -> dict:
    """The registry's series on ``/metrics`` against what was served
    between two scrapes (each beside a ``/health`` read, no request in
    flight): requests by the requests sent (``n`` fanned out), TTFTs by the
    requests admitted, tokens by the step kinds' tokens plus one first
    token a request, prefill dispatches by the stats', and the step
    seconds' sum by the step kinds' seconds within 1e-6. The compile
    families, whole: one compile and one compile-seconds observation a
    captured variant of the step sites (``/health``'s ``graph_sites``),
    the turbo, chunk, packed and copy compile-cache entries those sites',
    and after the warm mark no decode-side recompile or warmup-coverage
    gap, one prefill recompile a prefill variant new between the scrapes
    and one gap a new chunk, packed or copy key (mark_prompt's variants
    carry no key, as in JAX)."""
    d = {k: m1.get(k, 0.0) - m0.get(k, 0.0) for k in m1}
    st, _, _ = _since(h1, h0)
    sites = h1["graph_sites"]
    new = {fn: sites.get(fn, {"entries": 0})["entries"] - h0["graph_sites"].get(fn, {"entries": 0})["entries"]
           for fn in PREFILL_SITES}
    got = {
        "requests": d["dtpu_serve_requests_total"],
        "ttft_count": d["dtpu_serve_ttft_seconds_count"],
        "tokens": d["dtpu_serve_tokens_generated_total"],
        "prefill_dispatches": d["dtpu_serve_prefill_dispatches_total"],
        "step_seconds": d["dtpu_serve_decode_step_seconds_sum"],
        "compiles": _family_sum(m1, "dtpu_serve_compiles_total"),
        "compile_seconds_count": sum(v for k, v in m1.items() if k.startswith("dtpu_serve_compile_seconds_count")),
        "cache_entries": {fn: m1.get(f'dtpu_serve_compile_cache_entries{{fn="{fn}"}}')
                          for fn in ("turbo", "chunk", "packed", "copy")},
        "decode_side_recompiles_and_gaps": (_site_sum(m1, "dtpu_serve_recompiles_total", False)
                                            + _site_sum(m1, "dtpu_serve_warmup_gap_compiles_total", False)),
        "prefill_recompiles": _site_sum(d, "dtpu_serve_recompiles_total", True),
        "prefill_gaps": _site_sum(d, "dtpu_serve_warmup_gap_compiles_total", True),
    }
    want = {
        "requests": sent,
        "ttft_count": st["ttft_count"],
        "tokens": sum(st[f"{k}_tokens"] for k in ("decode", "spec", "turbo")) + st["ttft_count"],
        "prefill_dispatches": st["prefill_dispatches"],
        "step_seconds": sum(st[f"{k}_seconds"] for k in ("decode", "spec", "turbo")),
        "compiles": sum(r["entries"] for r in sites.values()),
        "compile_seconds_count": sum(r["entries"] for r in sites.values()),
        "cache_entries": {fn: sites[fn]["entries"] for fn in ("turbo", "chunk", "packed", "copy")},
        "decode_side_recompiles_and_gaps": 0,
        "prefill_recompiles": sum(new.values()),
        "prefill_gaps": sum(v for fn, v in new.items() if fn != "mark_prompt"),
    }
    if not (all(got[k] == want[k] for k in got if k != "step_seconds") and st["ttft_count"] == sent
            and abs(got["step_seconds"] - want["step_seconds"]) <= 1e-6):
        raise AssertionError(f"/metrics over {what}: {got} != served {want} ({sent} requests sent)")
    log(f"/metrics over {what}: {json.dumps(got)} (held)")
    return got


def _grid_key(cap: list) -> tuple:
    """A ``/health`` ``graph_captures`` entry as a ``PREFILL_GRID`` key:
    (site, key), or for mark_prompt (no key) its padded length."""
    return (cap[0], repr(cap[2][1][:1])) if cap[0] == "mark_prompt" else (cap[0], cap[1])


def _counts(h: dict) -> dict:
    """A ``/health`` body's counts: engine stats and kernel launches."""
    return {**h["stats"], **h["kernel_launches"], **{f"k4_{k}": v for k, v in h["flash_decode_launches"].items()},
            **{f"w8_{k}": v for k, v in h["w8_matmul_launches"].items()}}


def _since(h: dict, h0: dict) -> tuple[dict, dict, dict]:
    """(stats, launches (W8's by form too, ``w8_<form>``), K4 launches by
    form) that ran between two ``/health`` reads (the stats' running
    maximum has no difference)."""
    st = {k: v - h0["stats"][k] for k, v in h["stats"].items() if k != "ttft_max_s"}
    launches = {k: v - h0["kernel_launches"][k] for k, v in h["kernel_launches"].items()}
    launches.update({f"w8_{k}": v - h0["w8_matmul_launches"][k] for k, v in h["w8_matmul_launches"].items()})
    variants = {k: v - h0["flash_decode_launches"][k] for k, v in h["flash_decode_launches"].items()}
    return st, launches, variants


def server_spec(mode: str) -> tuple:
    """The arguments of :func:`spawn_server` for ``mode``'s server."""
    model, flags = SERVER_MODES[mode]
    return mode, model, flags, ROBUST_ENV if mode == "robust" else None


def path_phase(mode: str, then=None) -> dict:
    """One server process in ``mode`` (SERVER_MODES), driven and checked
    → its counts and serving metrics. ``then``: the next mode, whose
    server starts with this one."""
    model, flags = SERVER_MODES[mode]
    then = server_spec(then) if then else None
    if mode == "robust":
        return robust_phase(then)
    maker = None
    if mode == "w8":  # this process's copy of the server's tree, made while the server makes its own
        maker = threading.Thread(target=w8_llama_tree)
        maker.start()
    try:
        with _server(mode, model, flags, then=then) as (base, h0, ready_s, warmup_s):
            path = _drive_server(llama.CONFIGS[model], base, mode, h0, ready_s, warmup_s)
            if maker is not None:
                maker.join()
                path["w8"] = w8_server_check(llama.CONFIGS[model], base)
            return path
    finally:
        if maker is not None:
            maker.join()


def _call(url: str, body=None, headers=None, timeout: float = 300) -> tuple:
    """POST ``body`` (GET when None) → (status, response headers, JSON
    body), an HTTP error status included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _families(base: str) -> set:
    """The family names ``/metrics`` declares (its ``# TYPE`` lines)."""
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        return set(re.findall(r"^# TYPE (\S+) ", r.read().decode(), re.M))


def _profile_kernels(trace_dir: Path) -> dict:
    """The chrome trace the server's profiler wrote → {kernel name: [device
    ms, launches]} over its device events (``cat`` kernel)."""
    [trace] = sorted(trace_dir.glob("dtpu_trace_*.json"))
    events = json.loads(trace.read_text())["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            row = out.setdefault(e["name"], [0.0, 0])
            row[0] += e["dur"] / 1e3
            row[1] += 1
    return out


def robust_phase(then=None) -> dict:
    """The lifecycle server (SERVER_MODES["robust"], ROBUST_ENV): the JAX
    server's request lifecycle on llama-3.2-1b at full width and depth on
    the default engine (CUDA graphs, K1 and K4), each feature held to what
    it must do:

    1. QoS: a tenant's burst of three (a burst of 2, an in-flight cap of 1)
       is two served, the second deferred at the cap, and one 429 with a
       Retry-After; ``dtpu_qos_*`` counts the shed, the admissions and the
       deferral.
    2. A deadline of 1 s on a 1,900-token completion (eos banned) ends
       mid-decode with a 504: a ``deadline_abort`` post-mortem names its
       slot, ``dtpu_serve_deadline_expired_total`` is 1, and the slot is
       free for the next request.
    3. The planted hang (ROBUST_ENV's fault plan: ``serve.engine.step`` on
       slot 7, once, for 10 s under a 4 s watchdog): seven requests fill
       slots 0-6, the eighth takes slot 7 and gets the watchdog's 500, and
       the request behind it gives the greedy tokens this server gave its
       prompt before; one watchdog abort, and ``/debug/flight`` holds the
       post-mortem naming slot 7 and the eighth request's trace.
    4. A ``dtpu_resume`` continuation of a greedy chat (biased to the ASCII
       ids, so the delivered text re-encodes to its tokens) gives the rest
       of the uninterrupted text; a resume asking for logprobs is refused.
    5. ``X-DTPU-Trace`` on every completion and chat response; a trace
       continued from a header holds its request, queue, prefill and
       decode spans in ``/debug/traces``; ``/debug/boot`` lists the
       start-up stages.
    6. ``/metrics`` declares every family of the port's serve, QoS, trace,
       SLO, flight and boot registries (the families the JAX server
       renders: held equal on the CPU), and the four lifecycle families
       read what the scenario fed them.
    7. ``/debug/profiler/start``, three 300-token requests of 32 tokens,
       ``/stop``: a chrome trace whose device events name K1's and K4's
       kernels; the device ms by kernel name over the window is logged
       with the card (no claim rides on it).
    8. The launch identities of the default server: K1 n_layers a serial
       chunk, K4 n_layers a device step (the abandoned step dispatched
       nothing)."""
    from dstack_tpu_torch.obs import boot as obs_boot
    from dstack_tpu_torch.obs import flight as obs_flight
    from dstack_tpu_torch.obs import slo as obs_slo
    from dstack_tpu_torch.obs import tracing as obs_tracing
    from dstack_tpu_torch.qos import metrics as qos_metrics
    from dstack_tpu_torch.serve.metrics import new_serve_registry

    model, flags = SERVER_MODES["robust"]
    c = llama.CONFIGS[model]
    shutil.rmtree(ROBUST_PROFILE_DIR, ignore_errors=True)
    checks: dict = {}
    traced: list = []  # every completion and chat response's (status, its X-DTPU-Trace)

    def call(base, path, body, tenant, **headers):
        status, hdrs, data = _call(base + path, body, {"X-DTPU-Tenant": tenant, **headers})
        traced.append((status, hdrs.get("X-DTPU-Trace")))
        return status, hdrs, data

    with _server("robust", model, flags, env=ROBUST_ENV, then=then) as (base, h0, ready_s, _):
        if any(_counts(h0).values()) or h0["device"] != DEVICE:
            raise AssertionError(f"[robust] counts not zero, or not on the card, before the phase: {h0}")
        t_phase = time.perf_counter()
        same = _text(40, shift=3)
        one = {"prompt": same, "max_tokens": 64, "temperature": 0}
        status, _, base_body = call(base, "/v1/completions", one, "r1")  # slot 0
        if status != 200:
            raise AssertionError(f"[robust] the baseline failed: {status} {base_body}")
        trace_ids = []
        for i in range(2, 8):  # slots 1-6, each a continued trace
            tid = f"{i:016x}"
            status, hdrs, body = call(base, "/v1/completions", {"prompt": _text(20 + i), "max_tokens": 8},
                                      f"r{i}", **{"X-DTPU-Trace": f"{tid}-{i:08x}"})
            if status != 200 or hdrs.get("X-DTPU-Trace") != tid:
                raise AssertionError(f"[robust] request {i}: {status} {hdrs} {body}")
            trace_ids.append(tid)
        # 3. the eighth request takes slot 7 and wedges; the next waits behind it
        victim_trace = "00000000000000ee"
        out: dict = {}

        def send(key, body, tenant, **headers):
            out[key] = call(base, "/v1/completions", body, tenant, **headers)

        t_wedge = time.perf_counter()
        th_v = threading.Thread(target=send, args=("victim", {"prompt": _text(40, shift=9), "max_tokens": 64},
                                                  "victim"), kwargs={"X-DTPU-Trace": f"{victim_trace}-000000ee"})
        th_v.start()
        time.sleep(0.5)
        th_s = threading.Thread(target=send, args=("survivor", one, "survivor"))
        th_s.start()
        th_v.join(timeout=120)
        th_s.join(timeout=120)
        wedge_s = time.perf_counter() - t_wedge
        (vs, _, vbody), (ss, _, sbody) = out["victim"], out["survivor"]
        flight_view = _call(base + "/debug/flight?limit=4&postmortems=4")[2]
        pm = [p for p in flight_view["postmortems"] if p["reason"] == "watchdog_abort"]
        if not (vs == 500 and vbody == {"detail": "engine watchdog aborted a wedged decode step"}
                and ss == 200 and sbody["choices"][0]["text"] == base_body["choices"][0]["text"]
                and sbody["usage"] == base_body["usage"] and len(pm) == 1
                and pm[0]["ctx"]["wedge"] == f"slot:{ROBUST_HANG_SLOT}"
                and pm[0]["ctx"]["slots"].get(str(ROBUST_HANG_SLOT)) == victim_trace
                and pm[0]["records"][-1]["phase"] == "wedge"):
            raise AssertionError(f"[robust] the watchdog: victim {vs} {vbody}, survivor {ss} {sbody} against "
                                 f"{base_body}, post-mortems {json.dumps(flight_view['postmortems'])[:3000]}")
        checks["watchdog"] = {"seconds": round(wedge_s, 3), "survivor_tokens": sbody["usage"]["completion_tokens"],
                              "postmortem_ctx": pm[0]["ctx"]}
        # 1. QoS: three at once from one tenant
        burst: list = [None] * 3

        def burst_one(i):
            burst[i] = call(base, "/v1/completions", {"prompt": _text(30 + i), "max_tokens": 32}, "qa")

        ths = [threading.Thread(target=burst_one, args=(i,)) for i in range(3)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=120)
        statuses = sorted(b[0] for b in burst)
        shed = [b for b in burst if b[0] == 429]
        m = _scrape(base)
        qos_counts = {k: m.get(f'{k}{{tenant="qa"}}') for k in (
            "dtpu_qos_admitted_total", "dtpu_qos_shed_total", "dtpu_qos_inflight_deferred_total")}
        if not (statuses == [200, 200, 429] and int(shed[0][1].get("Retry-After", 0)) >= 1
                and qos_counts == {"dtpu_qos_admitted_total": 2.0, "dtpu_qos_shed_total": 1.0,
                                   "dtpu_qos_inflight_deferred_total": 1.0}):
            raise AssertionError(f"[robust] QoS: {burst} {qos_counts}")
        checks["qos"] = {"statuses": statuses, "retry_after": shed[0][1]["Retry-After"], **qos_counts}
        # 2. a deadline that ends a long decode, its sampled path's sites
        # captured first: without the warmup their first captures eat into
        # the deadline (one run decoded 14 tokens in its second, another 115)
        no_eos = {"logit_bias": {str(EOS_ID): -100}}
        call(base, "/v1/completions", {"prompt": _text(40, shift=6), "max_tokens": 16, **no_eos}, "dl0")
        tok0 = _scrape(base)["dtpu_serve_tokens_generated_total"]
        status, _, body = call(base, "/v1/completions",
                               {"prompt": _text(40, shift=5), "max_tokens": 1900, **no_eos},
                               "dl", **{"X-DTPU-Deadline": "1"})
        m = _scrape(base)
        h = _get(base + "/health")
        pms = _call(base + "/debug/flight?limit=1&postmortems=4")[2]["postmortems"]
        dl_tokens = m["dtpu_serve_tokens_generated_total"] - tok0
        after = call(base, "/v1/completions", {"prompt": _text(30), "max_tokens": 8}, "dl2")[0]
        if not (status == 504 and body == {"detail": "request deadline exceeded"}
                and m["dtpu_serve_deadline_expired_total"] == 1 and 1 < dl_tokens < 1900
                and pms[-1]["reason"] == "deadline_abort" and h["inflight"] == 0 and h["active_slots"] == 0
                and after == 200):
            raise AssertionError(f"[robust] the deadline: {status} {body}, {dl_tokens} tokens, {pms[-1:]}, "
                                 f"inflight {h['inflight']}, next request {after}")
        checks["deadline"] = {"tokens_before_expiry": dl_tokens, "slots": pms[-1]["ctx"]["slots"]}
        # 4. resume: ASCII only, so the delivered text re-encodes to its
        # tokens (a bias of +100 on the 128 ASCII ids: banning the other
        # 128k would be a body past aiohttp's 1 MB limit)
        ascii_only = {str(i): 100 for i in range(128)}
        chat = {"messages": [{"role": "user", "content": "Tell me about foxes."}], "max_tokens": 16,
                "temperature": 0, "logit_bias": ascii_only}
        status, _, full = call(base, "/v1/chat/completions", chat, "rs")
        text = full["choices"][0]["message"]["content"]
        cut = 6
        rstatus, _, rbody = call(base, "/v1/chat/completions", {**chat, "dtpu_resume": {"text": text[:cut]}},
                                 "rs2", **{"X-DTPU-Resume": "1"})
        lstatus, _, lbody = call(base, "/v1/chat/completions",
                                 {**chat, "logprobs": True, "dtpu_resume": {"text": text[:cut]}}, "rs3",
                                 **{"X-DTPU-Resume": "1"})
        rest = rbody["choices"][0]["message"]["content"] if rstatus == 200 else None
        if not (status == rstatus == 200 and len(text) == 16 and rest == text[cut:]
                and lstatus == 400 and lbody == {"detail": "a resumed continuation cannot carry logprobs"}):
            raise AssertionError(f"[robust] resume: {text!r} then {rest!r} ({rstatus}), logprobs {lstatus} {lbody}")
        checks["resume"] = {"text": text, "continuation": rest}
        # 5. traces and boot
        spans = _call(base + f"/debug/traces?id={trace_ids[-1]}")[2]["trace"]["spans"]
        names = {sp["name"] for sp in spans}
        boot_view = _call(base + "/debug/boot")[2]
        stages = [e["stage"] for e in boot_view["timeline"]]
        # the kernels' build is the card's share of warmup_compile, before the config
        want_stages = ["warmup_compile"] * (h0["device"] == "cuda") + [
            "config_load", "weights_load", "engine_init", "tokenizer_load", "listener_up",
            obs_boot.READY_MARK, obs_boot.SERVED_MARK]
        untraced = [t for t in traced if not t[1]]
        if not (names >= {"serve.request", "serve.queue", "serve.prefill", "serve.decode"} and not untraced
                and stages == want_stages):
            raise AssertionError(f"[robust] traces {names}, untraced responses {untraced}, boot stages {stages}")
        checks["trace_spans"] = sorted(names)
        checks["boot"] = boot_view["summary"]["stages"]
        # 7. the live profiler, its shapes captured first
        profiled = {"prompt": _text(300, shift=1), "max_tokens": 32, "temperature": 0}
        call(base, "/v1/completions", profiled, "p0")
        started = _call(base + "/debug/profiler/start", {})
        for i in range(1, 4):
            call(base, "/v1/completions", {**profiled, "prompt": _text(300, shift=1 + i)}, f"p{i}")
        stopped = _call(base + "/debug/profiler/stop", {})
        if not (started[:1] == (200,) and started[2] == {"tracing": True, "dir": str(ROBUST_PROFILE_DIR)}
                and stopped[:1] == (200,) and stopped[2] == {"tracing": False, "dir": str(ROBUST_PROFILE_DIR)}):
            raise AssertionError(f"[robust] profiler replies: {started} {stopped}")
        by_kernel = _profile_kernels(ROBUST_PROFILE_DIR)
        mine = {name: [sum(v[i] for k, v in by_kernel.items() if sym in k) for i in (0, 1)]
                for name, sym in (("K1", "flash_fwd_kernel"), ("K4", "flash_decode_kernel"),
                                  ("K4_combine", "flash_decode_combine_kernel"))}
        k1, k4 = mine["K1"][1], mine["K4"][1]
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
        log(f"[robust] live profiler, llama-3.2-1b at full depth, 3 requests of 300 + 32 tokens: device ms and "
            f"launches by kernel over the traced window ({card_line()}): hand-written "
            + json.dumps({k: [round(v[0], 3), v[1]] for k, v in mine.items()}) + "; the 12 largest "
            + json.dumps({k[:120]: [round(v[0], 3), v[1]] for k, v in top})
            + f"; total {sum(v[0] for v in by_kernel.values()):.3f} ms over {len(by_kernel)} kernels")
        if not (k1 and k4):
            raise AssertionError(f"[robust] the profiler's trace names no K1 ({k1}) or K4 ({k4}) launch: "
                                 f"{sorted(by_kernel)[:40]}")
        checks["profiler"] = {"by_kernel": mine, "device_ms": round(sum(v[0] for v in by_kernel.values()), 3)}
        # 6. every family, the lifecycle families fed
        fams = _families(base)
        want = set()
        for reg in (new_serve_registry(), qos_metrics.new_qos_registry(), obs_tracing.new_trace_registry(),
                    obs_slo.new_slo_registry(), obs_flight.new_flight_registry(), obs_boot.new_boot_registry()):
            want |= set(reg.metric_names())
        m = _scrape(base)
        fed = {k: m[k] for k in ("dtpu_serve_watchdog_aborts_total", "dtpu_serve_deadline_expired_total",
                                 "dtpu_serve_resumed_requests_total", "dtpu_serve_postmortems_total")}
        if not (want <= fams and fed == {"dtpu_serve_watchdog_aborts_total": 1.0,
                                         "dtpu_serve_deadline_expired_total": 1.0,
                                         "dtpu_serve_resumed_requests_total": 1.0,
                                         "dtpu_serve_postmortems_total": 2.0}):
            raise AssertionError(f"[robust] /metrics lacks {sorted(want - fams)} or reads {fed}")
        checks["metrics"] = {"families": len(fams), **fed}
        # 8. the launch identities
        h = _get(base + "/health")
        st, launches, variants = _since(h, h0)
        n = c.n_layers
        serial_chunks = st["prefill_dispatches"] - st["packed_dispatches"]
        steps = st["decode_steps"] + st["spec_steps"] + st["turbo_device_steps"]
        if not (launches["flash_fwd"] == n * serial_chunks and serial_chunks
                and launches["flash_decode"] == n * steps and steps
                and variants["bf16_decode"] + variants["bf16_verify"] == launches["flash_decode"]):
            raise AssertionError(f"[robust] launches {launches} {variants} against {st}")
        phase_s = round(time.perf_counter() - t_phase, 1)
    report = {"launches": {**launches, **variants}, "stats": st, "ready_s": ready_s, "seconds": phase_s, **checks}
    log("[robust] " + json.dumps(report))
    return report


_W8_TREE: dict = {}


def w8_llama_tree() -> dict:
    """llama-3.2-1b's int8 tree as ``--quantize int8`` builds it: the
    seed-0 weights drawn on the host, quantized there (``quantize_tree``);
    kept on the host once made, moved to the card by each user."""
    if not _W8_TREE:
        c = llama.CONFIGS[MODEL]
        t0 = time.perf_counter()
        params = llama.init_params(c, torch.Generator().manual_seed(0), device="cpu")
        _W8_TREE.update(quant.quantize_tree(params, c))
        log(f"w8: llama-3.2-1b's int8 tree made on the host in {time.perf_counter() - t0:.1f} s")
    return _W8_TREE


def w8_server_check(c, base: str) -> dict:
    """The ``--quantize int8`` server against this process: a greedy
    completion with ``logprobs: 0`` equals, token for token (its text,
    token count and chosen logprobs), an in-process int8 graph engine
    over the same tree; the server's ``/health`` device memory; and the
    host ms of a plain graph decode step at 8 live slots on that tree
    beside the bf16 tree's (``_host_ms``, bf16 and int8 in turns)."""
    prompt = _text(LOGPROBS_PROMPT_LEN, shift=13)
    body = _complete(base, prompt, MAX_TOKENS, logprobs=0)
    h = _get(base + "/health")
    params = quant.tree_to(w8_llama_tree(), DEVICE)
    toks, entries = _engine_logprobs(c, params, list(prompt.encode()), MAX_TOKENS, 0)
    nbytes = sum(w.numel() * w.element_size() for v in params.values()
                 for w in (v.values() if isinstance(v, dict) else [v]))
    engines, rng = {}, torch.Generator().manual_seed(1)
    for kind, tree in (("int8", params), ("bf16", llama_tf_params()[1])):
        e = engines[kind] = _graph_engine(c, tree, None, True)
        for _ in range(e.max_batch):
            e.start_request(torch.randint(1, c.vocab_size, (CHUNK,), generator=rng).tolist(),
                            engine.GenParams(max_new_tokens=1500))
        while e.prefilling_slots():
            e.prefill_wave()
    step_ms = {"bf16": [], "int8": []}
    for kind in ("bf16", "int8", "int8", "bf16"):
        step_ms[kind].append(round(_host_ms(engines[kind], "plain", 8), 3))
    del params, engines, tree, e
    free_card()
    ch = body["choices"][0]
    served = ch["logprobs"]["token_logprobs"]
    if not (ch["text"] == ByteTokenizer().decode(toks) and len(served) == len(toks)
            and body["usage"]["completion_tokens"] == len(toks)
            and max(abs(a - e[0]) for a, e in zip(served, entries)) <= 1e-4):
        raise AssertionError(f"--quantize int8 server: {body} != this process's int8 engine: {toks}, {entries}")
    report = {"tokens": len(toks), "tree_bytes": nbytes, "device_memory": h["device_memory"],
              "plain_graph_step_host_ms": step_ms}
    log("w8 server [--quantize int8] against this process's int8 graph engine: " + json.dumps(report))
    return report


def _complete(base: str, prompt: str, max_tokens: int = MAX_TOKENS, **extra) -> dict:
    body = _post(base + "/v1/completions",
                 {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0, **extra})
    ch, u = body["choices"][0], body["usage"]
    if not (body["object"] == "text_completion" and isinstance(ch["text"], str)
            and ch["finish_reason"] in ("length", "stop")
            and u["prompt_tokens"] == len(prompt)
            and 1 <= u["completion_tokens"] <= max_tokens * extra.get("n", 1)):
        raise AssertionError(f"malformed completion for a {len(prompt)}-token prompt: {body}")
    return body


def _serving_metrics(st: dict) -> dict:
    """TTFT, decode tokens/s over every step kind, and host ms a call of
    each kind (a turbo call runs up to 8 device steps) from the engine
    stats of a stretch of traffic (``_since``)."""
    tokens = st["decode_tokens"] + st["spec_tokens"] + st["turbo_tokens"]
    seconds = st["decode_seconds"] + st["spec_seconds"] + st["turbo_seconds"]
    return {
        "ttft_mean_s": st["ttft_sum_s"] / st["ttft_count"],
        "decode_tokens": tokens,
        "decode_tokens_per_s": tokens / seconds,
        "ms_per_call": {
            kind: 1e3 * st[f"{kind}_seconds"] / st[count]
            for kind, count in (("decode", "decode_steps"), ("spec", "spec_steps"),
                                ("turbo", "turbo_dispatches"))
            if st[count]
        },
    }


def _check_logprobs_completion(body: dict, what: str) -> list:
    """A greedy completion's ``logprobs`` block → its chosen logprobs:
    one entry a generated token, each alternative <= 0, sorted, the
    chosen token's value the best of them. The byte tokenizer keys the
    alternatives by their text and keeps the best of those alike (every
    id past 255 reads as ""), so a token carries 1 to 5 of them."""
    ch = body["choices"][0]
    lp, n = ch["logprobs"], body["usage"]["completion_tokens"]
    if not (len(lp["tokens"]) == len(lp["token_logprobs"]) == len(lp["top_logprobs"]) == n):
        raise AssertionError(f"{what}: {n} tokens, logprobs {lp}")
    for chosen, tops in zip(lp["token_logprobs"], lp["top_logprobs"]):
        vals = list(tops.values())
        if not (1 <= len(vals) <= 5 and vals == sorted(vals, reverse=True) and vals[0] <= 0.0
                and abs(vals[0] - chosen) <= 1e-6):
            raise AssertionError(f"{what}: chosen {chosen} against its alternatives {tops}")
    return lp["token_logprobs"]


def _embed_check(base: str, c, texts: list) -> dict:
    """POST each text to /v1/embeddings alone → {"vectors", "ms" (host
    clock a request)}, each vector of the model's width with unit norm,
    and K1 launched n_layers times an input and no K4 (``/health``
    around the requests)."""
    h0 = _get(base + "/health")
    vectors, ms = [], []
    for text in texts:
        t0 = time.perf_counter()
        body = _post(base + "/v1/embeddings", {"input": text})
        ms.append(1e3 * (time.perf_counter() - t0))
        vec = body["data"][0]["embedding"]
        norm = math.sqrt(sum(x * x for x in vec))
        if len(vec) != c.hidden_size or abs(norm - 1.0) > 1e-4 or body["usage"]["prompt_tokens"] != len(text):
            raise AssertionError(f"embedding of {len(text)} tokens: width {len(vec)}, norm {norm}, "
                                 f"usage {body['usage']}")
        vectors.append(vec)
    _, launches, _ = _since(_get(base + "/health"), h0)
    want = {"flash_fwd": c.n_layers * len(texts), "flash_fwd_mla": 0, "flash_decode": 0, "w8_matmul": 0,
            **{f"w8_{k}": 0 for k in w8_matmul.FORMS}}
    if launches != want:
        raise AssertionError(f"embeddings of {[len(t) for t in texts]} tokens launched {launches}, not {want}")
    return {"vectors": vectors, "ms": ms}


def _f32_copy(params: dict) -> dict:
    return {k: {n: w.float() for n, w in v.items()} if isinstance(v, dict) else v.float()
            for k, v in params.items()}


def _engine_logprobs(c, params, prompt: list, max_tokens: int, top: int) -> tuple[list, list]:
    """The port's engine in this process, at the server's defaults, over
    ``params``: one greedy request with logprobs, alone, as a server that
    serves it alone runs it (a serial chunk, then plain decode steps) →
    (tokens, the engine's entries: (logprob, [(id, logprob), ...]))."""
    eng = engine.InferenceEngine(c, params, device=DEVICE)
    slot, tok = eng.add_request(prompt, engine.GenParams(max_new_tokens=max_tokens, eos_id=EOS_ID,
                                                         logprobs=top))
    toks, entries = [tok], [eng.take_logprobs(slot)]
    while eng.active[slot]:
        for t in eng.step().get(slot, []):
            toks.append(t)
            entries.append(eng.take_logprobs(slot))
    eng.release(slot)
    if toks[-1] == EOS_ID:
        toks, entries = toks[:-1], entries[:-1]
    return toks, entries


def _rms(a: torch.Tensor, ref: torch.Tensor) -> float:
    return (a - ref).pow(2).mean().sqrt().item()


def feature_drive(c, base: str) -> dict:
    """The request features beside plain completions, on the default
    llama-3.2-1b server at full width and depth (random weights from seed
    0, made again in this process for the references); each check raises:

    - ``logprobs: 5`` on a greedy completion: the structure
      (``_check_logprobs_completion``), the chosen logprobs equal to this
      process's engine on the same request (which gives the token ids the
      byte tokenizer's text hides; each entry 5 alternatives, sorted,
      <= 0, the chosen id first), and the served chosen and alternative
      logprobs held against ``log_softmax`` of a teacher-forced plain
      forward in f32 over prompt + generated tokens: the served path's
      RMS error at most KERNEL_RMS_MARGIN times the plain bf16 forward's;
    - a streamed chat with ``logprobs: true, top_logprobs: 2``, biased to
      the letters so each token is one char of text: one entry a
      delivered token, its text the token's, 2 alternatives each;
    - ``n``: 2 greedy choices alike; 3 at temperature 0.8 with seed 7, choice
      i the single request with seed 7 + i; ``n: 2`` streamed is a 400;
    - tools with a tool-call history and ``json_object`` get 200s,
      ``tool_choice: "required"`` and ``json_schema`` 400s;
    - /v1/embeddings of EMBED_LENS tokens (``_embed_check``), each held
      against ``embed_vectors`` on the plain path in bf16 and f32 by the
      same rule, and one over max_seq, a 400;
    - a greedy completion against the same one with logprobs, in turns
      (host clock): what leaving the turbo and argmax paths costs."""
    report: dict = {}
    prompt = _text(LOGPROBS_PROMPT_LEN, shift=3)
    ids = list(prompt.encode())
    body = _complete(base, prompt, LOGPROBS_TOKENS, logprobs=5)
    served = _check_logprobs_completion(body, "logprobs completion")
    _, params = llama_tf_params()
    toks, entries = _engine_logprobs(c, params, ids, LOGPROBS_TOKENS, 5)
    if len(toks) != len(served) or max(abs(a - e[0]) for a, e in zip(served, entries)) > 1e-4:
        raise AssertionError(f"served logprobs {served} != this process's engine's {entries}")
    for tok, (lp, alts) in zip(toks, entries):
        vals = [v for _, v in alts]
        if not (len(alts) == 5 and alts[0] == (tok, lp) and vals == sorted(vals, reverse=True)
                and vals[0] <= 0.0):
            raise AssertionError(f"engine entry of token {tok}: {(lp, alts)}")
    seq = torch.tensor([ids + toks[:-1]], device=DEVICE)
    rows = torch.arange(len(ids) - 1, len(ids) - 1 + len(toks), device=DEVICE)
    pick = torch.tensor([[tok] + [i for i, _ in alts] for tok, (_, alts) in zip(toks, entries)], device=DEVICE)
    got = torch.tensor([[lp] + [v for _, v in alts] for lp, alts in entries], device=DEVICE)
    c32, params32 = dataclasses.replace(c, dtype=torch.float32), _f32_copy(params)
    with torch.no_grad():
        ref = {name: torch.log_softmax(llama.forward(w, seq, cfg, impl="plain")[0, rows], dim=-1).gather(1, pick)
               for name, (w, cfg) in (("f32", (params32, c32)), ("plain", (params, c)))}
    err = {"served": _rms(got, ref["f32"]), "plain_bf16": _rms(ref["plain"], ref["f32"])}
    if not err["served"] <= KERNEL_RMS_MARGIN * err["plain_bf16"]:
        raise AssertionError(f"served logprobs drift from the f32 forward: {err}")
    report["logprobs_rms_vs_f32"] = err

    bias = {str(i): 100 for i in range(97, 123)}
    events, _, _ = _stream(base + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Spell a word."}], "max_tokens": 16,
        "temperature": 0, "logprobs": True, "top_logprobs": 2, "logit_bias": bias, "stream": True,
    })
    chunks = [e["choices"][0] for e in events[:-1]]
    text = "".join(ch["delta"].get("content") or "" for ch in chunks)
    lp_entries = [x for ch in chunks for x in (ch.get("logprobs") or {}).get("content", [])]
    if not (len(text) == 16 and [x["token"] for x in lp_entries] == list(text)
            and all(len(x["top_logprobs"]) == 2 and x["logprob"] <= 0.0 for x in lp_entries)):
        raise AssertionError(f"streamed chat logprobs: text {text!r}, entries {lp_entries}")

    two = _complete(base, prompt, 8, n=2)["choices"]
    if [ch["index"] for ch in two] != [0, 1] or {**two[0], "index": 1} != two[1]:
        raise AssertionError(f"n = 2 greedy choices differ: {two}")
    sampled = {"temperature": 0.8, "seed": 7}
    three = _complete(base, prompt, 8, n=3, **sampled)
    singles = [_complete(base, prompt, 8, **{**sampled, "seed": 7 + i})["choices"][0] for i in range(3)]
    if [(ch["text"], ch["finish_reason"]) for ch in three["choices"]] != [
            (ch["text"], ch["finish_reason"]) for ch in singles]:
        raise AssertionError(f"n = 3 choices {three['choices']} != seeds 7, 8, 9: {singles}")
    status, err_body = _post_status(base + "/v1/completions", {"prompt": prompt, "n": 2, "stream": True})
    if status != 400:
        raise AssertionError(f"n = 2 streamed: {status} {err_body}")

    tools = [{"type": "function", "function": {"name": "get_weather", "parameters": {
        "type": "object", "properties": {"city": {"type": "string"}}}}}]
    history = [
        {"role": "user", "content": "Weather in Paris?"},
        {"role": "assistant", "content": None, "tool_calls": [{
            "id": "call_1", "type": "function",
            "function": {"name": "get_weather", "arguments": "{\"city\": \"Paris\"}"}}]},
        {"role": "tool", "tool_call_id": "call_1", "content": "sunny"},
    ]
    statuses = {
        what: _post_status(base + "/v1/chat/completions", {"messages": history, "max_tokens": 4, **extra})[0]
        for what, extra in (("tools", {"tools": tools}),
                            ("required", {"tools": tools, "tool_choice": "required"}),
                            ("json_schema", {"response_format": {"type": "json_schema"}}),
                            ("json_object", {"response_format": {"type": "json_object"}}))
    }
    if statuses != {"tools": 200, "required": 400, "json_schema": 400, "json_object": 200}:
        raise AssertionError(f"tools / response_format statuses: {statuses}")

    texts = [_text(n, step=3) for n in EMBED_LENS]
    emb = _embed_check(base, c, texts)
    status, err_body = _post_status(base + "/v1/embeddings", {"input": _text(2049)})
    if status != 400 or "over the model's 2048 maximum" not in err_body["detail"]:
        raise AssertionError(f"an embedding over max_seq: {status} {err_body}")
    served_v = torch.tensor(emb["vectors"], device=DEVICE)
    id_lists = [list(t.encode()) for t in texts]
    ref_v = {"f32": embed_vectors(params32, c32, id_lists, impl="plain"),
             "plain": embed_vectors(params, c, id_lists, impl="plain")}
    del params32
    emb_err = []
    for i, n in enumerate(EMBED_LENS):
        e = {"tokens": n, "ms": emb["ms"][i], "served": _rms(served_v[i], ref_v["f32"][i]),
             "plain_bf16": _rms(ref_v["plain"][i], ref_v["f32"][i])}
        if not e["served"] <= KERNEL_RMS_MARGIN * e["plain_bf16"]:
            raise AssertionError(f"the served embedding of {n} tokens drifts from the f32 forward: {e}")
        emb_err.append(e)
    report["embeddings"] = emb_err
    report["embed_inputs"] = len(texts)

    timed = []
    for extra in ({}, {"logprobs": 5}, {"logprobs": 5}, {}):
        t0 = time.perf_counter()
        _complete(base, prompt, **extra)
        timed.append(("logprobs" if extra else "greedy", time.perf_counter() - t0))
    report["greedy_vs_logprobs_s"] = timed
    del params
    free_card()
    log("feature drive [default]: " + json.dumps(report))
    return report


def family_features(c, base: str, mode: str) -> dict:
    """One greedy ``logprobs: 5`` completion (its structure) and one
    FAMILY_EMBED_LEN-token embedding (unit norm, K1 n_layers times) on a
    family's server."""
    body = _complete(base, _text(LOGPROBS_PROMPT_LEN, shift=3), LOGPROBS_TOKENS, logprobs=5)
    _check_logprobs_completion(body, f"[{mode}] logprobs completion")
    emb = _embed_check(base, c, [_text(FAMILY_EMBED_LEN, step=3)])
    report = {"embed_inputs": 1, "embed_ms": emb["ms"][0]}
    if c.n_experts and not c.mla and not c.attn_sinks:  # qwen-3-30b-a3b: a lone chunk's TTFT
        h0 = _get(base + "/health")
        _complete(base, _text(CHUNK, step=7, shift=5), 1)
        h1 = _get(base + "/health")
        report["lone_chunk_256_ttft_ms"] = 1e3 * (h1["stats"]["ttft_sum_s"] - h0["stats"]["ttft_sum_s"])
    log(f"feature drive [{mode}]: " + json.dumps(report))
    return report


def _drive_server(c, base: str, mode: str, h0: dict, ready_s: float, warmup_s) -> dict:
    log(f"server [{mode}] ready in {ready_s:.1f} s (warmup {warmup_s} s): {json.dumps(h0['engine'])}; "
        f"captures {len(h0['graph_captures'])} in {sum(cap[3] for cap in h0['graph_captures']):.2f} s; "
        f"device memory after the warmup {json.dumps(h0['device_memory'])}")
    if h0["device"] != DEVICE:  # started with no --device flag: the server's default
        raise AssertionError(f"[{mode}] the server runs on {h0['device']}, not {DEVICE}")
    if warmup_s is None:
        # --no-warmup: the counts start at 0 in the fresh server process
        if any(_counts(h0).values()):
            raise AssertionError(f"counts not zero before the path phase: {h0}")
    elif not (h0["stats"]["prefill_dispatches"] and h0["stats"]["decode_steps"]
              and h0["active_slots"] == 0 and h0["prefix_slots"] == 0):
        raise AssertionError(f"[{mode}] the warmup ran no path or left a slot or prefix behind: {h0}")
    # from here every count and metric is the difference from h0

    first_prompt = _text(PROMPT_LENS[0], step=5)
    _complete(base, first_prompt, 4)
    h_first = _get(base + "/health")
    t_m = time.perf_counter()
    m_first = _scrape(base) if mode == FEATURE_MODE else None
    metrics_s = time.perf_counter() - t_m
    first_ttft = h_first["stats"]["ttft_sum_s"] - h0["stats"]["ttft_sum_s"]
    log(f"[{mode}] first request TTFT ({'warm' if warmup_s is not None else 'cold'}): {first_ttft:.4f} s")

    prompts = [_text(n) for n in PROMPT_LENS]
    results: list = [None] * len(prompts)
    errors: list = []

    def one(i: int) -> None:
        try:
            results[i] = _complete(base, prompts[i])
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    t_batch = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    batch_s = time.perf_counter() - t_batch
    if errors or any(th.is_alive() for th in threads):
        raise RuntimeError(f"completions failed: {errors}")
    log(f"[{mode}] 4 concurrent completions in {batch_s:.3f} s: "
        + json.dumps([b["usage"]["completion_tokens"] for b in results]))

    # random weights over a 128k vocab rarely pick one of the 256 byte
    # ids, so a stream may carry few content deltas: TTFT comes from the
    # engine's own count (admission to first sampled token)
    h_before = _get(base + "/health")
    messages = [{"role": "user", "content": "Name three colours of the rainbow."}]
    events, t_send, arrivals = _stream(
        base + "/v1/chat/completions",
        {"messages": messages, "max_tokens": MAX_TOKENS, "temperature": 0, "stream": True},
    )
    body = events[:-1]
    if (events[-1] != "[DONE]" or not body
            or body[-1]["choices"][0]["finish_reason"] not in ("length", "stop")
            or not all(e["object"] == "chat.completion.chunk" for e in body)):
        raise AssertionError(f"malformed chat stream: {events[-3:]}")
    chat_s = arrivals[-1] - t_send
    text = "".join(e["choices"][0]["delta"].get("content", "") for e in body)
    # the traffic every mode serves: the burst and the chat (since h_first)
    h_common = _get(base + "/health")
    metrics_check = {}
    if mode == FEATURE_MODE:
        t_m = time.perf_counter()
        m_common = _scrape(base)
        metrics_check["common_traffic"] = _metrics_identities(
            "the common traffic", len(PROMPT_LENS) + 1, m_first, m_common, h_first, h_common)
        metrics_s += time.perf_counter() - t_m
    chat_ttft = h_common["stats"]["ttft_sum_s"] - h_before["stats"]["ttft_sum_s"]
    log(f"[{mode}] chat stream: TTFT {chat_ttft:.4f} s (engine), whole stream {chat_s:.4f} s, "
        f"{len(body) - 1} content deltas, {len(text)} chars")

    extra = []
    if mode != "serial":
        # a repetitive prompt (prompt-lookup drafts may fire), then two
        # prompts sharing a 512-token prefix, one after the other: the
        # second copies the first's cached rows
        shared = "".join(chr(97 + (i * 11) % 26) for i in range(PREFIX_LEN))
        extra = ["abcd" * 30, shared + " first tail", shared + " and a second, longer tail"]
        for prompt in extra:
            _complete(base, prompt)
    if mode == FEATURE_MODE:
        # and one completion with n = 2, which the server fans out into two
        # requests
        t_m = time.perf_counter()
        _complete(base, extra[0], 8, n=2)
        metrics_check["extra_and_n2"] = _metrics_identities(
            "the extra prompts and an n = 2 completion", len(extra) + 2, m_common, _scrape(base),
            h_common, _get(base + "/health"))
        metrics_check["seconds"] = round(metrics_s + time.perf_counter() - t_m, 3)
        log(f"/metrics identities took {metrics_check['seconds']} s (scrapes, checks, the n = 2 completion)")
    features = {}
    if mode == FEATURE_MODE:
        features = feature_drive(c, base)
    elif mode in FAMILY_FEATURE_MODES:
        features = family_features(c, base, mode)

    h = _get(base + "/health")
    st, launches, variants = _since(h, h0)
    n = c.n_layers
    # the step sites: after a warmup every decode-side variant the traffic
    # reached was captured before the warm mark (no recompile, no gap);
    # a prefill capture after it must be of a key JAX's grid leaves cold
    m_end = _scrape(base)
    late = [cap for cap in h["graph_captures"] if cap not in h0["graph_captures"]]
    compile_check = {
        "flight_warm": h["flight_warm"],
        "compiles": _family_sum(m_end, "dtpu_serve_compiles_total"),
        "recompiles": {k: v for k, v in m_end.items() if k.startswith("dtpu_serve_recompiles_total{")},
        "warmup_gaps": {k: v for k, v in m_end.items() if k.startswith("dtpu_serve_warmup_gap_compiles_total{")},
        "sites_after_warmup": h0["graph_sites"],
        "sites": h["graph_sites"],
        "captures_after_warmup": late,
        "device_memory_after_warmup": h0["device_memory"],
    }
    if warmup_s is not None:
        decode_side = {k: v for k, v in h["graph_sites"].items() if k not in PREFILL_SITES}
        faults = [cap for cap in late if cap[0] not in PREFILL_SITES or _grid_key(cap) in PREFILL_GRID]
        late_compiles = sum(v["entries"] - h0["graph_sites"].get(k, {"entries": 0})["entries"]
                            for k, v in h["graph_sites"].items())
        if not (h["flight_warm"] and not faults
                and decode_side == {k: v for k, v in h0["graph_sites"].items() if k not in PREFILL_SITES}
                and sum(compile_check["recompiles"].values()) == late_compiles == len(late)
                and _site_sum(m_end, "dtpu_serve_recompiles_total", False) == 0
                and _site_sum(m_end, "dtpu_serve_warmup_gap_compiles_total", False) == 0):
            raise AssertionError(f"[{mode}] the traffic compiled past the warmup: {json.dumps(compile_check)}")
        for cap in late:
            log(f"[{mode}] captured after the warm mark (a key JAX's grid leaves cold): {cap[0]} {cap[1]} "
                f"shapes {cap[2]} in {cap[3]:.4f} s")
    log(f"[{mode}] step sites: " + json.dumps(compile_check))
    embed_k1 = n * features.get("embed_inputs", 0)  # the embeddings' forwards
    if c.mla:
        # K1's D = 576 form on every serial chunk; no K4: MLA's decode and
        # verify attend over the latent row with plain products, in JAX too
        # (flash_decode_supported excludes MLA); K1's D = 192 form only in
        # the embeddings' forwards (MLA's non-absorbed form)
        serial_chunks = st["prefill_dispatches"] - st["packed_dispatches"]
        if launches["flash_fwd_mla"] != n * serial_chunks or not serial_chunks:
            raise AssertionError(f"[{mode}] flash_fwd_mla launches {launches} != {n} x serial chunks: {st}")
        if launches["flash_fwd"] != embed_k1 or launches["flash_decode"] or any(variants.values()):
            raise AssertionError(f"[{mode}] an MLA server launched K4, or K1's D <= 256 forms "
                                 f"outside the embeddings: {launches}")
        if not (st["packed_dispatches"] >= 1 and st["turbo_dispatches"] >= 1 and st["prefix_hits"] >= 1):
            raise AssertionError(f"[{mode}] packed, turbo and prefix-cache dispatches must all run: {st}")
    elif launches["flash_fwd_mla"]:
        raise AssertionError(f"[{mode}] K1's D = 576 form ran on a model without MLA: {launches}")
    elif mode == "serial":
        want_chunks = (_chunks(len(first_prompt)) + sum(_chunks(k) for k in PROMPT_LENS)
                       + _chunks(len(render_chat(messages))))
        if st["prefill_dispatches"] != want_chunks:
            raise AssertionError(f"prefill chunks {st['prefill_dispatches']} != {want_chunks}")
        if launches["flash_fwd"] != n * st["prefill_dispatches"] or not launches["flash_fwd"]:
            raise AssertionError(f"flash_fwd launches {launches} vs stats {st}")
        if launches["flash_decode"] != n * st["decode_steps"] or not launches["flash_decode"]:
            raise AssertionError(f"flash_decode launches {launches} vs stats {st}")
        if variants["bf16_decode"] != launches["flash_decode"]:
            raise AssertionError(f"serial path ran K4 variants other than bf16 decode: {variants}")
    else:
        serial_chunks = st["prefill_dispatches"] - st["packed_dispatches"]
        steps = st["decode_steps"] + st["spec_steps"] + st["turbo_device_steps"]
        if launches["flash_fwd"] != n * serial_chunks + embed_k1:
            raise AssertionError(f"flash_fwd launches {launches} != {n} x serial chunks "
                                 f"+ {embed_k1} for the embeddings: {st}")
        if launches["flash_decode"] != n * steps or not steps:
            raise AssertionError(f"flash_decode launches {launches} != {n} x device steps: {st}")
        if not (st["packed_dispatches"] >= 1 and st["turbo_dispatches"] >= 1 and st["prefix_hits"] >= 1):
            raise AssertionError(f"[{mode}] packed, turbo and prefix-cache dispatches must all run: {st}")
        # only the forms of the server's cache, and of its model's sinks
        own = ("int8" if mode == "int8" else "bf16", "_sinks" if c.attn_sinks else "")
        ours = {f"{own[0]}_decode{own[1]}", f"{own[0]}_verify{own[1]}"}
        if (sum(v for k, v in variants.items() if k not in ours)
                or sum(variants[k] for k in ours) != launches["flash_decode"]
                or variants[f"{own[0]}_verify{own[1]}"] != n * st["spec_steps"]):
            raise AssertionError(f"[{mode}] K4 variants {variants} vs stats {st}")
    # W8: every projection of an int8 server's passes, none elsewhere
    passes = st["prefill_dispatches"] + st["decode_steps"] + st["spec_steps"] + st["turbo_device_steps"]
    if "--quantize" in SERVER_MODES[mode][1]:
        check_w8(f"[{mode}]", c, launches, passes)
    elif launches["w8_matmul"]:
        raise AssertionError(f"[{mode}] a bf16 server launched W8: {launches}")
    path = {
        "launches": {**launches, **variants},
        "warmup_launches": {**h0["kernel_launches"], **h0["flash_decode_launches"],
                            **{f"w8_{k}": v for k, v in h0["w8_matmul_launches"].items()}},
        "stats": st,
        "prefix_stats": {k: h[k] for k in ("prefix_hits", "prefix_slots", "prefix_tokens")},
        "requests": 1 + len(PROMPT_LENS) + 1 + len(extra),
        "ready_s": ready_s,
        "warmup_s": warmup_s,
        "first_request_ttft_s": first_ttft,
        "burst_s": batch_s,
        "chat_ttft_s": chat_ttft,
        "chat_stream_s": chat_s,
        "common_traffic": _serving_metrics(_since(h_common, h_first)[0]),
        "all_traffic": _serving_metrics(st),
        "features": features,
        "metrics_check": metrics_check,
        "compile_check": compile_check,
    }
    if mode == "qwen3moe":
        path["plain_step_ms_vs_floor"] = {"plain_step_ms": path["all_traffic"]["ms_per_call"].get("decode"),
                                          "expert_read_floor_ms": QWEN_MOE_FLOOR_MS}
    log(f"path [{mode}]: " + json.dumps(path))
    return path


def _bench_line(name: str, r: dict) -> dict:
    """The numbers of one bench result that the log keeps."""
    x, burst = r["extra"], r["extra"]["concurrent"]
    return {
        "run": name, "value": r["value"], "wall_tokens_per_sec": x["wall_tokens_per_sec"],
        "ttft_ms_p50": x["ttft_ms_p50"], "ttft_ms_p99": x["ttft_ms_p99"],
        "ttft_long_cold_ms": x["ttft_long_cold_ms"], "ttft_prefix_hit_ms": x["ttft_prefix_hit_ms"],
        "burst_dispatches": [burst["packed"]["prefill_dispatches"], burst["serial"]["prefill_dispatches"]],
        "burst_ttft_ms_p50": [burst["packed"]["ttft_ms_p50"], burst["serial"]["ttft_ms_p50"]],
        "decode_steps": x["decode_steps"], "tokens": x["tokens"],
        "timed_steps": x["timed_steps"], "kernel_launches": x["kernel_launches"], "host": x["host"],
    }


def _check_bench(name: str, r: dict, seconds: float, args: dict = BENCH_ARGS) -> dict:
    """One bench result: its keys, a positive rate, every slot's tokens,
    and the launch identities over its timed sections (K4 n_layers times a
    plain, verify and turbo device step; K1 n_layers times a serial
    chunk; with int8 weights W8 by form every pass, :func:`check_w8`) →
    its logged line, with the run's wall ``seconds``."""
    x = r["extra"]
    c = llama.CONFIGS[args["model"]]
    n, st, lc = c.n_layers, x["timed_steps"], x["kernel_launches"]
    steps = st["decode_steps"] + st["spec_steps"] + st["turbo_device_steps"]
    serial_chunks = st["prefill_dispatches"] - st["packed_dispatches"]
    want_tokens = args["batch"] * (args["gen_len"] - 1)
    if not (r["metric"] == f"serve_decode_tokens_per_sec[{args['model']},batch={args['batch']}]"
            and r["value"] > 0 and x["tokens"] == want_tokens and x["backend"] == "cuda"
            and x["decode_kernel"] == "flash" and x["concurrent"]["burst"] == args["arrival_burst"]):
        raise AssertionError(f"bench [{name}]: {json.dumps(r)}")
    if lc["flash_decode"] != n * steps or not steps or lc["flash_fwd"] != n * serial_chunks or lc["flash_fwd_mla"]:
        raise AssertionError(f"bench [{name}]: launches {lc} against {n} x the timed steps {st}")
    w8 = {"w8_matmul": lc["w8_matmul"], **{f"w8_{k}": v for k, v in lc["w8_matmul_by_form"].items()}}
    if args.get("quantize"):
        check_w8(f"bench [{name}]", c, w8, st["prefill_dispatches"] + steps)
    elif lc["w8_matmul"]:
        raise AssertionError(f"bench [{name}]: a bf16 tree launched W8: {lc}")
    if x["graphs"] != (not name.startswith("eager")):
        raise AssertionError(f"bench [{name}] ran with graphs={x['graphs']}")
    line = {**_bench_line(name, r), "seconds": round(seconds, 2), "timed_compiles": x["timed_compiles"],
            "capture_s": round(sum(v["capture_s"] for v in x["graph_sites"].values()), 3)}
    log(f"bench [{name}]: " + json.dumps(line))
    return line


def _spread(values: list) -> dict:
    v = sorted(values)
    return {"median": v[len(v) // 2], "spread": v[-1] - v[0],
            "spread_share": (v[-1] - v[0]) / v[len(v) // 2] if v[len(v) // 2] else None}


def bench_phase() -> dict:
    """The serving bench (``serve/bench.py``) on llama-3.2-1b at full
    width and depth. The default engine (turbo 8, spec 0) runs once
    through ``python -m dstack_tpu_torch.serve.bench`` in a fresh process
    (its one JSON line parsed; CUDA graphs, the entry point's default),
    then BENCH_PAIRS times as the eager engine (``run_bench(graphs=False)``)
    and as the graph engine in this process, alternated; then here the
    serial engine as a pair, and the int8 cache and a repetitive prompt
    with spec_draft 4 on graphs (BENCH_RUNS). Each run's launches over its
    timed sections are held to its dispatch counts; the counts of each
    in-process run are set to 0 before it and read after (its path in the
    kernels line), the fresh process's are its own. Each run logs the
    host's counters over its timed sections (``extra.host``), the
    variants first compiled inside them, its capture seconds and its wall
    seconds. → {"runs", "launches" by run, "default": median and spread
    of each set, and their ratio}."""
    from dstack_tpu_torch.serve.bench import run_bench

    runs, launches = {}, {}
    cmd = [sys.executable, "-m", "dstack_tpu_torch.serve.bench", "--device", DEVICE]
    for k, v in BENCH_ARGS.items():
        cmd += [f"--{k.replace('_', '-')}", str(v)]

    def in_process(name: str, delta: dict, graphs: bool) -> None:
        reset_counts()
        t0 = time.perf_counter()
        r = run_bench(**{**BENCH_ARGS, **delta}, device=DEVICE, graphs=graphs)
        launches[name] = read_counts()
        runs[name] = _check_bench(name, r, time.perf_counter() - t0)
        free_card()

    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the bench's entry point exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    runs["process"] = _check_bench("process", r, time.perf_counter() - t0)
    lc = r["extra"]["kernel_launches"]
    launches["process"] = {"flash_fwd": lc["flash_fwd"], "flash_decode": lc["flash_decode"],
                           **lc["flash_decode_by_variant"], "w8_matmul": lc["w8_matmul"]}
    for i in range(1, BENCH_PAIRS + 1):
        for graphs in ((False, True) if i % 2 else (True, False)):
            in_process(f"{'graph' if graphs else 'eager'}_{i}", {}, graphs)
    for name, (delta, kinds) in BENCH_RUNS.items():
        for graphs in kinds:
            in_process(f"{'graph' if graphs else 'eager'}_{name}", delta, graphs)
    default = {}
    for kind in ("eager", "graph"):
        sel = [runs[f"{kind}_{i}"] for i in range(1, BENCH_PAIRS + 1)]
        default[kind] = {"value": _spread([r["value"] for r in sel]),
                         "ttft_ms_p50": _spread([r["ttft_ms_p50"] for r in sel]),
                         "burst_ttft_ms_p50_packed": _spread([r["burst_ttft_ms_p50"][0] for r in sel]),
                         # the share of the timed wall time the engine's thread ran on a
                         # core, and the collector's seconds in it
                         "thread_cpu_share": _spread([r["host"]["thread_cpu_s"] / r["host"]["wall_s"]
                                                      for r in sel]),
                         "gc_s": _spread([r["host"]["gc_s"] for r in sel])}
    default["graph_over_eager"] = default["graph"]["value"]["median"] / default["eager"]["value"]["median"]
    log(f"bench [default, {BENCH_PAIRS} pairs of the eager and the graph engine]: " + json.dumps(default))
    return {"runs": runs, "launches": launches, "default": default}


# the multi-replica paths (ROADMAP A4.2): the session bench and the soaks.
# The soak's ASCII bias (128,128 entries, a 1.94 MB body) costs each request
# 0.27-0.39 s of the one event loop that the driver, the router and the
# replicas share (the client's encoding, the router's and the server's JSON
# parses, the server's checks and the engine's bias row; bias_host_ms, PERF.md
# section 5). At the 3 rps of the JAX package's chaos soaks
# (tests/chaos/test_chaos_loadgen.py, test_chaos_boot.py), whose small
# vocabulary makes the bias cheap, that loop saturates on the card, its
# queue grows and goodput fell to 0.09-0.14; so the soaks here run at 1.5
# rps, where seed 7 draws 33 events (ROADMAP B16, open). As in the JAX
# package's acceptance, the kill and the scale-up run in soaks of their own,
# each at that acceptance's fractions: a cold replica's warmup captures hold
# the replicas' device lock for 5-17 s, and booted beside the drain and the
# kill of one 30 s soak it left a backlog that failed "the tail recovered" in
# two soaks of six on an H100 (PERF.md section 6). The chaos soak keeps three
# replicas, so that two serve after the kill, as in that soak once the
# scale-up replica had joined: with two, the one survivor failed the tail in
# two soaks of three. At 33 events the planned kill found the doomed replica
# idle in two more of the six (no resume or failover), so the kill waits up
# to SOAK_KILL_WAIT_S for it to hold a request
SESSION_ARGS = dict(model=MODEL, replicas=2, sessions=8, turns=4, gen_len=32, prefill_chunk=256)
SOAK_SEED, SOAK_DURATION_S, SOAK_RATE_RPS, SOAK_KILL_WAIT_S = 7, 30.0, 1.5, 3.0
# the server's --prefill-chunk default, as the bench and the session bench
# run (SoakConfig's 64 is the JAX soak's, for llama-tiny on the CPU): at 64 a
# 1,000-token turn prefills in 16 serial chunks, each a turn of the shared
# device lock, and prefill was the largest phase of the kill window's worst
# TTFTs (0.65-1.19 s of 1.04-1.58 s)
SOAK_PREFILL_CHUNK = 256
# tests/chaos/test_chaos_loadgen.py's fractions, and test_chaos_boot.py's
SOAK_CHAOS = dict(replicas=3, chaos=True, drain_start_frac=0.20, drain_end_frac=0.35, kill_frac=0.55,
                  kill_wait_s=SOAK_KILL_WAIT_S)
SOAK_BOOT = dict(replicas=2, chaos=False, scale_up=True, scale_up_frac=0.1, scale_up_window_s=10.0)


def _launch_check(what: str, launches: dict) -> None:
    """K1 and K4 (bf16 decode) must have launched on the path."""
    if not (launches["flash_fwd"] and launches["bf16_decode"]):
        raise AssertionError(f"[{what}] K1 or K4 launched no time: {launches}")


def sessions_phase(card: str) -> dict:
    """``run_session_bench`` (SESSION_ARGS) on the card: two in-process
    replicas of llama-3.2-1b sharing one tree, routed by the port's pool
    picker with prefix affinity on, then off. → {"launches", "result"}."""
    from dstack_tpu_torch.serve.bench import run_session_bench

    reset_counts()
    t0 = time.perf_counter()
    r = run_session_bench(**SESSION_ARGS, device=DEVICE)
    launches = read_counts()
    seconds = time.perf_counter() - t0
    x = r["extra"]
    on, off = x["affinity_on"], x["affinity_off"]
    log(f"[sessions] {card}: " + json.dumps({
        "seconds": round(seconds, 1), "affinity_on": on, "affinity_off": off,
        "warm_ttft_speedup_p50": x["warm_ttft_speedup_p50"], "timed_launches": x["kernel_launches"],
        "launches": {k: launches[k] for k in ("flash_fwd", "bf16_decode", "bf16_verify")}}))
    if not on["prefix_hits"] > off["prefix_hits"]:
        raise AssertionError(f"[sessions] affinity on hit the prefix cache {on['prefix_hits']} times, "
                             f"off {off['prefix_hits']}: {x}")
    if x["graphs"] is not True or x["backend"] != "cuda":
        raise AssertionError(f"[sessions] not on the card's graphs: {x}")
    _launch_check("sessions", launches)
    free_card()
    return {"launches": launches, "result": r}


def bias_host_ms(c, iters: int = 5) -> dict:
    """The host ms one soak request spends on its ASCII bias (128,128
    entries at llama-3.2-1b's vocabulary): the driver's JSON encoding, the
    router's parse, the server's parse, check and sampling parameters, and
    the engine's bias row; each the median of ``iters`` calls."""
    from dstack_tpu_torch.routing import forward
    from dstack_tpu_torch.serve import openai_server

    bias = {str(i): -100 for i in range(128, c.vocab_size)}
    payload = {"model": MODEL, "max_tokens": 8, "stream": True, "temperature": 0.0, "logit_bias": bias,
               "messages": [{"role": "user", "content": _text(200)}]}
    body = json.dumps(payload).encode()
    tok = ByteTokenizer()
    gen = openai_server._gen_params(payload, tok)
    steps = {
        "client_encode": lambda: json.dumps(payload).encode(),
        "router_parse": lambda: forward._json_payload(body),
        "server_parse": lambda: json.loads(body),
        "server_check": lambda: openai_server._bad_sampling_params(payload),
        "server_gen_params": lambda: openai_server._gen_params(payload, tok),
        "engine_bias_row": lambda: engine.bias_row(gen.logit_bias, c.vocab_size),
    }
    out = {}
    for name, fn in steps.items():
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = round(sorted(ts)[len(ts) // 2], 3)
    out["total"] = round(sum(out.values()), 3)
    out["body_bytes"] = len(body)
    return out


def soak_phase(card: str, kind: str) -> dict:
    """``run_soak`` on the card: ``default_spec(SOAK_DURATION_S,
    SOAK_RATE_RPS)`` at SOAK_SEED through the port's router over two
    replicas of llama-3.2-1b (one tree, one device lock) with QoS. The
    ``chaos`` soak (SOAK_CHAOS) flips a drain and kills a replica,
    mid-stream; the ``boot`` soak (SOAK_BOOT) builds a cold scale-up
    replica on the card under its own boot recorder. Each is held to its
    JAX acceptance test's checks (tests/chaos/test_chaos_loadgen.py,
    test_chaos_boot.py). → {"launches", "report"}."""
    from dstack_tpu_torch.loadgen import compile_schedule, default_spec
    from dstack_tpu_torch.loadgen.soak import SoakConfig, run_soak

    what = f"soak_{kind}"
    out = {}
    if kind == "chaos":
        out["bias_host_ms"] = bias_ms = bias_host_ms(llama.CONFIGS[MODEL])
        log(f"[{what}] host ms a request spends on the ASCII bias ({card}'s host): {json.dumps(bias_ms)}")
    schedule = compile_schedule(default_spec(duration_s=SOAK_DURATION_S, rate_rps=SOAK_RATE_RPS), SOAK_SEED)
    cfg = SoakConfig(model=MODEL, prefill_chunk=SOAK_PREFILL_CHUNK, output=None, device=DEVICE,
                     **(SOAK_CHAOS if kind == "chaos" else SOAK_BOOT))
    reset_counts()
    t0 = time.perf_counter()
    rep = run_soak(schedule, cfg)
    launches = read_counts()
    seconds = time.perf_counter() - t0
    boot = rep["boot"] or {}
    log(f"[{what}] {card}: " + json.dumps({
        "seconds": round(seconds, 1), "events": rep["events"], "goodput": rep["value"], "chaos": rep["chaos"],
        "classes": {name: {k: cls.get(k) for k in ("requests", "goodput_ratio", "ttft_ms_p50", "ttft_ms_p95",
                                                    "tpot_ms_p50", "ttft_slo_ms", "tpot_slo_ms")}
                    for name, cls in rep["classes"].items()},
        "outcomes": rep["overall"]["outcomes"], "client_5xx": rep["client_5xx"], "failures": rep["failures"],
        "router": rep["router"], "windows": {k: {m: v.get(m) for m in ("start", "end", "requests", "goodput_ratio",
                                                                         "ttft_ms_p95", "recovered",
                                                                         "baseline_goodput_ratio",
                                                                         "tail_goodput_ratio")}
                                             for k, v in rep["windows"].items()},
        "sheds": rep["overall"]["sheds"], "open_loop": rep["open_loop"],
        "boot": {k: boot.get(k) for k in ("replica", "t_spawn", "stages", "marks", "time_to_ready_s", "ttfst_s",
                                          "manifest_variants", "warm")},
        "flight": {k: (rep["flight"] or {}).get(k) for k in ("compiles", "recompiles", "compile_seconds",
                                                              "postmortems", "peak_memory_bytes")},
        "launches": {k: launches[k] for k in ("flash_fwd", "bf16_decode", "bf16_verify")},
        "backend": rep["backend"], "device": rep.get("device"), "power_limit": rep.get("power_limit")}))
    checks = {
        "no client 5xx": rep["client_5xx"] == 0,
        "no failures": rep["failures"] == 0,
        "every event fired": rep["overall"]["requests"] == len(schedule.events),
        "honest sheds": rep["overall"]["sheds"]["honest"] is True,
        "the compiled schedule's digest": rep["schedule_digest"] == schedule.digest(),
        "on the card": rep["backend"] == "cuda",
    }
    if kind == "chaos":
        router, kill = rep["router"], rep["windows"]["kill"]
        checks.update({
            "a breaker opened": router["dtpu_router_breaker_opens_total"] >= 1,
            "a resume or a failover": router["dtpu_router_stream_resumes_total"]
            + router["dtpu_router_failovers_total"] >= 1,
            "the kill window served": kill["requests"] >= 1 and (kill["goodput_ratio"] or 0.0) >= 0.25,
            "the tail recovered": rep["windows"]["_recovery"]["recovered"] is True,
        })
    else:
        stages, marks, up = boot.get("stages") or {}, boot.get("marks") or {}, rep["windows"]["scale_up"]
        checks.update({
            "every boot stage": all(stages.get(n, 0.0) > 0.0 for n in (
                "weights_load", "engine_init", "warmup_compile", "warm_prefix_copies")),
            "every boot mark, in order": all(marks.get(n) is not None for n in (
                "listener_up", "first_probe", "first_served_token"))
            and marks["listener_up"] <= marks["first_probe"] <= marks["first_served_token"],
            "the stages within TTFST": boot.get("ttfst_s") is not None
            and sum(stages.values()) <= boot["ttfst_s"] + 1e-6,
            "the scale-up replica booted and served": bool(boot.get("warm")) and boot.get("ttfst_s") is not None
            and boot.get("manifest_variants", 0) >= 1,
            "the join window served": up["requests"] >= 1 and up["goodput_ratio"] is not None,
            "goodput held": (rep["overall"]["goodput_ratio"] or 0.0) >= 0.5,
        })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"[{what}] failed: {failed}")
    _launch_check(what, launches)
    free_card()
    return {**out, "launches": launches, "report": rep}


def w8_bench_phase() -> dict:
    """llama-3-70b at full width and depth with int8 weights through the
    bench (``run_bench(**W8_BENCH_ARGS)``: the tree drawn on the card,
    71.6 GB; 8 slots, max_seq 2048, the bf16 cache; 8 random 256-token
    prompts of 128 tokens, a cold 512-token prompt then a prefix hit, a
    burst of 8), CUDA graphs. Its launches held as every bench run's (W8
    by form every pass); the card's peak reserved and allocated bytes;
    the decode value against the weight-read bound of a step (every int8
    byte and scale read once at 3.35 TB/s, 8 tokens a step). If the 8
    slots do not fit the card, 4 do and the run says so; the model is
    never cut."""
    from dstack_tpu_torch.serve.bench import run_bench

    free_card()
    c = llama.CONFIGS[W8_70B]
    shapes = llama.param_shapes(c)
    int8 = [*((n, sh) for n, sh in shapes["layers"].items() if n in quant.LAYER_TARGETS),
            ("lm_head", shapes["lm_head"])]
    read = sum(math.prod(sh) + 4 * math.prod(sh[:-2] + sh[-1:]) for _, sh in int8)  # int8 bytes and f32 scales
    args = dict(W8_BENCH_ARGS)
    for batch in (args["batch"], args["batch"] // 2):
        args.update(batch=batch, arrival_burst=min(args["arrival_burst"], batch))
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            r = run_bench(**args, device=DEVICE)
            break
        except torch.cuda.OutOfMemoryError as e:
            if batch < W8_BENCH_ARGS["batch"]:
                raise
            log(f"bench [llama-3-70b int8]: {batch} slots do not fit the card ({str(e)[:200]}); halving them")
            free_card()
    line = _check_bench("w8_70b", r, time.perf_counter() - t0, args)
    step_bound_ms = read / PEAK_BYTES_S * 1e3
    report = {
        **line, "slots": args["batch"], "launches": read_counts(),
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "weight_read_bytes_a_step": read, "step_bound_ms": step_bound_ms,
        "bound_tokens_per_sec": args["batch"] / step_bound_ms * 1e3,
    }
    free_card()
    log("bench [llama-3-70b, int8 weights, full depth]: " + json.dumps(report))
    return report


# ---------------------------------------------------------------------------
# the compiled step sites: the graph engine against the eager engine
# ---------------------------------------------------------------------------


def _graph_models() -> list:
    """(key, config, params factory, kv_quant) of ``graph_phase``: every
    model at full width, at GRAPH_LAYERS' depths (llama-3.2-1b at its full
    depth), random weights from seed 0 (gpt-oss with its sinks and biases
    drawn nonzero, Gemma with its norms at identity): llama-3.2-1b,
    gpt-oss-20b, gemma-3-4b and glm-4-9b on both caches, deepseek-v2-lite
    and olmo-2-7b on their one (bf16; MLA's latent)."""
    def full(name):
        c = llama.CONFIGS[name]
        if name in GRAPH_LAYERS:
            c = dataclasses.replace(c, n_layers=GRAPH_LAYERS[name])
        return c, llama.init_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda")

    def gpt_oss():
        c, params = full(GPT_OSS)
        g = torch.Generator(device="cuda").manual_seed(1)
        for name, std in GPT_OSS_NONZERO.items():
            leaf = params["layers"][name]
            leaf.copy_(torch.randn(leaf.shape, generator=g, device="cuda") * std)
        return c, params

    return [(MODEL, lambda: full(MODEL), (None, "int8")), (GPT_OSS, gpt_oss, (None, "int8")),
            (GEMMA3, lambda: gemma_tf_params(GEMMA3, GRAPH_LAYERS[GEMMA3]), (None, "int8")),
            (DEEPSEEK, lambda: full(DEEPSEEK), (None,)),
            (GLM, lambda: full(GLM), (None, "int8")), (OLMO, lambda: full(OLMO), (None,))]


def _graph_engine(c, params, kv_quant, graphs: bool):
    """The server's default engine (max_batch 8, max_seq 2048, chunk 256,
    pack 4, spec 4, turbo 8), arrival-busy throughout so that both engines
    pick the same turbo steps."""
    return engine.InferenceEngine(c, params, max_batch=8, max_seq=2048, prefill_chunk=CHUNK,
                                  kv_quant=kv_quant, turbo_quiet_s=1e9, graphs=graphs, device="cuda")


def _graph_traffic(e, vocab: int) -> tuple:
    """``graph_phase``'s traffic on one engine → (tokens of each request,
    the logits of each serial chunk, packed wave, plain decode and verify
    call, the launches). A burst of PROMPT_LENS random prompts of
    MAX_TOKENS greedy tokens (packed waves, serial chunks at later starts,
    plain steps beside a prefilling prompt, turbo), a verify of a draft
    (``warm_verify``: random weights rarely draft), a seeded sampled
    request with penalties and logprobs, and one with a seed skip."""
    logits = []

    def keep(site):
        return lambda *a: logits.append(site(*a).clone()) or logits[-1]

    sites = {name: getattr(e, name) for name in ("_decode", "_verify")}
    for name, site in sites.items():
        setattr(e, name, keep(site))
    e._chunk_fn = lambda cl, start, make=e._chunk_fn: keep(make(cl, start))
    e._packed_fn = lambda g, cl, make=e._packed_fn: keep(make(g, cl))
    rng = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, vocab, (n,), generator=rng).tolist() for n in PROMPT_LENS]
    reset_counts()
    slots = {e.start_request(p, engine.GenParams(max_new_tokens=MAX_TOKENS)): i for i, p in enumerate(prompts)}
    outs = [[] for _ in prompts]
    while e.prefilling_slots() or any(e.active[s] for s in slots):
        for s, t in e.prefill_wave().items():
            outs[slots[s]].append(t)
        for s, toks in e.step().items():
            outs[slots[s]].extend(toks)
    for s in slots:
        e.release(s)
    e.warm_verify()
    for gen in (engine.GenParams(max_new_tokens=16, temperature=0.8, seed=3, repetition_penalty=1.1,
                                 presence_penalty=0.2, logprobs=3),
                engine.GenParams(max_new_tokens=8, temperature=1.0, seed=5, seed_skip=3, top_k=40)):
        outs.append(e.generate(prompts[0][:100], gen))
    for name, site in sites.items():
        setattr(e, name, site)
    del e._chunk_fn, e._packed_fn
    return outs, logits, read_counts()


def _host_ms(e, kind: str, calls: int) -> float:
    """Median host ms of ``calls`` engine calls of ``kind`` with 8 slots
    live, each ending in its tokens' copy to the host: a plain decode step
    (turbo off), a turbo macro-step of 8, or a verify of 4 drafted tokens a
    slot. One untimed call first."""
    live = [i for i in range(e.max_batch) if e.active[i]]
    turbo, spec = e.turbo_steps, e.spec_draft
    e.turbo_steps = 8 if kind == "turbo" else 0
    e.spec_draft = spec if kind == "verify" else 0  # no draft turns a step into a verify
    if kind == "verify":
        call = lambda: e._spec_step(live, {i: [e.last_token[i]] * e.spec_draft for i in live})  # noqa: E731
    else:
        call = e.step
    times = []
    for _ in range(calls + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    e.turbo_steps, e.spec_draft = turbo, spec
    times = sorted(times[1:])
    return 1e3 * times[len(times) // 2]


def _prefill_host_ms(e, kind: str, calls: int, rng) -> float:
    """Median host ms of ``calls`` lone prefills of ``kind`` up to their
    first token (on the host, as a request's TTFT ends): a 256-token
    prompt (one serial chunk at (256, 0)), a 10-token one (a chunk at
    (16, 0)) or four 256-token prompts (one packed wave at (4, 256)), on an
    idle engine. Fresh random prompts (no prefix hit); one untimed call
    first."""
    n, length = {"chunk_256": (1, CHUNK), "chunk_16": (1, 10), "packed_4x256": (4, CHUNK)}[kind]
    times = []
    for _ in range(calls + 1):
        slots = [e.start_request(torch.randint(1, e.config.vocab_size, (length,), generator=rng).tolist(),
                                 engine.GenParams(max_new_tokens=2)) for _ in range(n)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = e.prefill_wave()
        times.append(time.perf_counter() - t0)
        if sorted(first) != sorted(slots):
            raise AssertionError(f"prefill [{kind}]: one wave gave {first} for slots {slots}")
        for s in slots:
            e.release(s)
    times = sorted(times[1:])
    return 1e3 * times[len(times) // 2]


def _prefill_device_ms(e, c) -> dict:
    """Device ms of the graph engine's chunk at (256, 0) (one replay,
    CUDA events, ``time_ms``), and of the part of it that gathers the
    slot's cache row for each layer (``_cread_row``: K and V, dequantized
    on the int8 cache; MLA's latent row), which a slot index on the
    device makes a copy where a host index took a view."""
    dev = e.device
    toks = torch.randint(1, c.vocab_size, (1, CHUNK), generator=torch.Generator().manual_seed(3)).to(dev)
    site, slot, last = e._chunk_fn(CHUNK, 0), e.slot_index(1), torch.tensor([CHUNK - 1], device=dev)
    si = engine._slot_ix(slot, e.max_batch, dev)
    if c.mla:
        rows = [e.cache["ckv"][i].unsqueeze(1) for i in range(c.n_layers)]
    else:
        rows = [ckv for i in range(c.n_layers) for ckv in engine._cache_layer(e.cache, i)]
    return {"chunk_replay": round(time_ms(lambda: site(toks, slot, last)), 4),
            "row_gathers": round(time_ms(lambda: [engine._cread_row(r, si, c.dtype) for r in rows]), 4),
            "gathers": len(rows)}


def graph_phase() -> dict:
    """The step sites as CUDA graphs (``serve/graphs.py``) against the
    eager engine (``graphs=False``), in this process, on llama-3.2-1b,
    gpt-oss-20b and gemma-3-4b on the bf16 and the int8 cache (K4's every
    form inside the decode-side graphs, K1 inside the chunk graphs) and
    deepseek-v2-lite (K1's D = 576 form), at full width and depth: the same
    traffic (``_graph_traffic``) must give the same tokens, the same
    logits of every serial chunk, packed wave, plain decode and verify
    call and the same cache after it (bitwise: the same kernels on the
    same inputs), the same kernel launches by form, and K1 n_layers times
    a serial chunk in both engines. Each site's captures and capture
    seconds and the compile-cache entries are reported. Then, on the idle
    engines, the host ms of a lone prefill up to its first token (a serial
    chunk at (256, 0) and at (16, 0), a packed wave of 4 x 256), and with 8
    slots live at 256-token prompts the host ms of a plain step, a turbo
    macro-step of 8 and a verify, eager and graph in turns (eager, graph,
    graph, eager). → {key: report}; the launches by path go to the kernels
    line."""
    out = {}
    for name, make, caches in _graph_models():
        c, params = make()
        for kv_quant in caches:
            key = f"{name}_{kv_quant or 'bf16'}"
            t0 = time.perf_counter()
            engines = {g: _graph_engine(c, params, kv_quant, g) for g in (True, False)}
            runs = {g: _graph_traffic(e, c.vocab_size) for g, e in engines.items()}
            (gout, glog, glaunch), (eout, elog, elaunch) = runs[True], runs[False]
            diffs = [float((a - b).abs().max()) for a, b in zip(glog, elog)]
            cache_equal = {n: torch.equal(engines[True].cache[n], engines[False].cache[n])
                           for n in engines[False].cache}
            k1 = "flash_fwd_mla" if c.mla else "flash_fwd"
            serial = {g: e.stats["prefill_dispatches"] - e.stats["packed_dispatches"] for g, e in engines.items()}
            if (gout != eout or len(glog) != len(elog) or not glog or any(diffs) or glaunch != elaunch
                    or not all(cache_equal.values()) or serial[True] != serial[False]
                    or glaunch[k1] != c.n_layers * serial[True] or not serial[True]):
                raise AssertionError(
                    f"graph [{key}]: tokens equal {gout == eout}, logit calls {len(glog)}/{len(elog)}, "
                    f"max |diff| {max(diffs, default=None)}, caches equal {cache_equal}, launches {glaunch} "
                    f"!= {elaunch}, serial chunks {serial} ({k1} {c.n_layers} a chunk)")
            ge = engines[True]
            ge.update_state_gauges()
            report = {
                "requests": len(gout), "tokens": sum(len(o) for o in gout), "logit_calls": len(glog),
                "max_abs_logit_diff": max(diffs), "caches_equal": cache_equal, "launches": glaunch,
                "serial_chunks": serial[True], "packed_waves": ge.stats["packed_dispatches"],
                "sites": {k: {"entries": v["entries"], "captures": v["captures"],
                              "capture_s": round(v["capture_s"], 4)} for k, v in ge.graphs.report().items()},
                "compile_cache_entries": {fn: ge.metrics.family("dtpu_serve_compile_cache_entries").value(fn)
                                          for fn in ("turbo", "chunk", "packed", "copy")},
                "memory_reserved_bytes": torch.cuda.memory_reserved(),
            }
            prefill_host = {kind: {"eager": [], "graph": []} for kind in ("chunk_256", "chunk_16", "packed_4x256")}
            rng = torch.Generator().manual_seed(2)
            for g in (False, True, True, False):
                for kind, calls in (("chunk_256", 6), ("chunk_16", 6), ("packed_4x256", 4)):
                    prefill_host[kind]["graph" if g else "eager"].append(
                        round(_prefill_host_ms(engines[g], kind, calls, rng), 3))
            report["prefill_host_ms"] = prefill_host
            report["prefill_device_ms"] = _prefill_device_ms(ge, c)
            rng = torch.Generator().manual_seed(1)
            for e in engines.values():
                for _ in range(e.max_batch):
                    e.start_request(torch.randint(1, c.vocab_size, (CHUNK,), generator=rng).tolist(),
                                    engine.GenParams(max_new_tokens=1500))
                while e.prefilling_slots():
                    e.prefill_wave()
            host = {kind: {"eager": [], "graph": []} for kind in ("plain", "turbo", "verify")}
            for g in (False, True, True, False):
                for kind, calls in (("plain", 8), ("turbo", 4), ("verify", 4)):
                    host[kind]["graph" if g else "eager"].append(round(_host_ms(engines[g], kind, calls), 3))
            report["host_ms"] = host
            report["seconds"] = round(time.perf_counter() - t0, 1)
            log(f"graph [{key}]: " + json.dumps(report))
            out[key] = report
            del engines, runs
            free_card()
        del params
        free_card()
    return out


FAMILY_PROMPT_LEN = 300  # family_engine_phase's request: two serial chunks, (256, 0) and (64, 256)


def family_engine_phase() -> dict:
    """The remaining families' models at full width in this process, at
    FAMILY_ENGINES' depths (mixtral-8x7b at its full 32 layers on its int8
    tree, 46.8 GB, every projection and expert product through W8;
    llama-4-scout 8 of 48, 39.4 GB, its NoPE layers 3 and 7; deepseek-v3 4
    of 61, 30.2 GB: its 3 dense layers and one MoE layer of 256 experts),
    random weights from seed 0: the server's default engine as CUDA graphs
    against the eager engine on one greedy FAMILY_PROMPT_LEN-token request
    of MAX_TOKENS tokens. The same tokens, bitwise the same logits of every
    serial chunk and decode call and the same cache, the same launches by
    form: K1 n_layers times a serial chunk (its D = 576 form in 64-head
    groups on deepseek-v3), K4 n_layers times a device step on mixtral, and
    none on llama-4-scout (its chunk mask routes decode to the einsum, as
    in JAX) or deepseek-v3 (MLA). → {model: report}."""
    out = {}
    for name, (layers, weights) in FAMILY_ENGINES.items():
        free_card()  # an engine and its sites form a cycle: collect the last phase's and model's
        out[name] = _family_engine_pair(name, layers, weights)
    free_card()
    return out


def _family_engine_pair(name: str, layers: int, weights=None) -> dict:
    """:func:`family_engine_phase` on one model → its report; with
    ``weights="int8"`` on its random int8 tree, W8 launched by form as
    every pass implies."""
    t0 = time.perf_counter()
    c = dataclasses.replace(llama.CONFIGS[name], n_layers=layers)
    if weights == "int8":
        params = quant.random_quantized_params_on_device(c, 0, device="cuda")
    else:
        params = llama.init_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = torch.randint(1, c.vocab_size, (FAMILY_PROMPT_LEN,),
                           generator=torch.Generator().manual_seed(4)).tolist()
    runs, engines = {}, {}
    for g in (True, False):
        e = engines[g] = _graph_engine(c, params, None, g)
        logits = []

        def keep(site):
            return lambda *a: logits.append(site(*a).clone()) or logits[-1]

        sites = (e._decode, e._verify)
        e._decode, e._verify = (keep(site) for site in sites)
        e._chunk_fn = lambda cl, start, make=e._chunk_fn: keep(make(cl, start))
        reset_counts()
        t1 = time.perf_counter()
        toks = e.generate(prompt, engine.GenParams(max_new_tokens=MAX_TOKENS))
        torch.cuda.synchronize()
        runs[g] = (toks, logits, read_counts(), time.perf_counter() - t1)
        (e._decode, e._verify), _ = sites, e.__dict__.pop("_chunk_fn")
    (gtok, glog, gl, gs), (etok, elog, el, es) = runs[True], runs[False]
    diffs = [float((a - b).abs().max()) for a, b in zip(glog, elog)]
    cache_equal = {n: torch.equal(engines[True].cache[n], engines[False].cache[n]) for n in engines[False].cache}
    st = engines[True].stats
    serial = st["prefill_dispatches"] - st["packed_dispatches"]
    steps = st["decode_steps"] + st["spec_steps"] + st["turbo_device_steps"]
    k1 = "flash_fwd_mla" if c.mla else "flash_fwd"
    want_k4 = 0 if (c.mla or c.attention_chunk_size) else c.n_layers * steps
    if (gtok != etok or not gtok or len(glog) != len(elog) or not glog or any(diffs)
            or gl != el or not all(cache_equal.values()) or gl[k1] != c.n_layers * serial or not serial
            or gl["flash_decode"] != want_k4 or not steps):
        raise AssertionError(f"family engine [{name}]: tokens equal {gtok == etok} ({len(gtok)}), logit calls "
                             f"{len(glog)}/{len(elog)}, max |diff| {max(diffs, default=None)}, caches equal "
                             f"{cache_equal}, launches {gl} != {el}, serial chunks {serial}, device steps "
                             f"{steps}, K4 launches want {want_k4}")
    if weights == "int8":
        check_w8(f"family engine [{name}]", c, gl, st["prefill_dispatches"] + steps)
    elif gl["w8_matmul"]:
        raise AssertionError(f"family engine [{name}]: a bf16 tree launched W8: {gl}")
    if c.attention_chunk_size:
        log(f"family engine [{name}]: 0 K4 launches: its attention_chunk_size {c.attention_chunk_size} is a "
            f"chunk mask no decode kernel takes, so the engine's default decode route is the einsum "
            f"(decode_kernel {engines[True].decode_kernel!r}), as JAX's engine routes a chunked config")
    report = {
        "layers": layers, "weights": weights or "bf16",
        "weights_gb": round(sum(w.numel() * w.element_size() for v in params.values()
                                for w in (v.values() if isinstance(v, dict) else [v])) / 1e9, 2),
        "tokens": len(gtok), "logit_calls": len(glog), "max_abs_logit_diff": max(diffs),
        "caches_equal": cache_equal, "launches": gl, "serial_chunks": serial, "device_steps": steps,
        "decode_kernel": engines[True].decode_kernel, "generate_s": {"graph": round(gs, 3), "eager": round(es, 3)},
        "graph": _serving_metrics(engines[True].stats), "eager": _serving_metrics(engines[False].stats),
        "memory_reserved_bytes": torch.cuda.memory_reserved(),
        "memory_allocated_bytes": torch.cuda.memory_allocated(), "init_s": round(init_s, 1),
        "seconds": round(time.perf_counter() - t0, 1),
    }
    log(f"family engine [{name}]: " + json.dumps(report))
    return report


WEIGHTS_NPZ = ROOT / "build" / "chip_smoke_train_full" / "model_weights.npz"
WEIGHTS_SERVER = ("weights", MODEL, ["--weights", str(WEIGHTS_NPZ)])  # spawn_server's arguments


def weights_server_phase() -> dict:
    """A server started with ``--weights`` on the llama full fine-tune's
    ``model_weights.npz`` (TRAIN_RUNS["full"]) serves a greedy completion
    with ``logprobs: 0``: its text, token count and logprobs equal this
    process's engine over the same file loaded by ``load_weights_npz``
    (the logprobs stand for the token ids the byte tokenizer's text
    hides). → the server's launches and the numbers."""
    path = WEIGHTS_NPZ
    prompt = _text(LOGPROBS_PROMPT_LEN, shift=11)
    with _server(*WEIGHTS_SERVER) as (base, h0, ready_s, warmup_s):
        body = _complete(base, prompt, MAX_TOKENS, logprobs=0)
        _, launches, variants = _since(_get(base + "/health"), h0)
    c, params = llama_tf_params()
    t0 = time.perf_counter()
    load_weights_npz(params, path)
    load_s = time.perf_counter() - t0
    toks, entries = _engine_logprobs(c, params, list(prompt.encode()), MAX_TOKENS, 0)
    del params
    free_card()
    ch = body["choices"][0]
    served = ch["logprobs"]["token_logprobs"]
    if not (ch["text"] == ByteTokenizer().decode(toks) and len(served) == len(toks)
            and body["usage"]["completion_tokens"] == len(toks)
            and max(abs(a - e[0]) for a, e in zip(served, entries)) <= 1e-4):
        raise AssertionError(f"--weights server: {body} != this process's engine: {toks}, {entries}")
    report = {"launches": {**launches, **variants}, "ready_s": ready_s, "warmup_s": warmup_s,
              "load_s_in_process": load_s, "tokens": len(toks)}
    log("--weights server: " + json.dumps(report))
    return report


def llama_tf_params() -> tuple:
    """llama-3.2-1b at full width and depth, random weights from seed 0."""
    c = llama.CONFIGS[MODEL]
    return c, llama.init_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda")


def gpt_oss_tf_params() -> tuple:
    """gpt-oss-20b at full width and GPT_OSS_TF_LAYERS layers, random
    weights from seed 0, with the sinks and biases drawn nonzero."""
    c = dataclasses.replace(llama.CONFIGS[GPT_OSS], n_layers=GPT_OSS_TF_LAYERS)
    params = llama.init_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    for name, std in GPT_OSS_NONZERO.items():
        leaf = params["layers"][name]
        leaf.copy_(torch.randn(leaf.shape, generator=g, device="cuda") * std)
    return c, params


def deepseek_tf_params(name: str = DEEPSEEK) -> tuple:
    """deepseek-v2-lite (or deepseek-v3) at full width and
    DEEPSEEK_TF_LAYERS layers (the dense prelude, then MoE layers: one on
    deepseek-v3, whose prelude is 3 layers), random weights from seed 0."""
    c = dataclasses.replace(llama.CONFIGS[name], n_layers=DEEPSEEK_TF_LAYERS)
    return c, llama.init_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda")


def cohere2_tf_params() -> tuple:
    """Command-R7B (cohere2) from its HF fields (COHERE2_HF) through the
    port's ``config_from_hf``, at full width and FAMILY_TF_LAYERS layers
    (three sliding layers with rope and a window of 4096, then a global
    NoPE layer), biases and norms as ``family_tf_params`` draws them."""
    from dstack_tpu_torch.models.convert_hf import config_from_hf

    c = dataclasses.replace(config_from_hf(COHERE2_HF), n_layers=FAMILY_TF_LAYERS)
    return _family_draws(c)


def gemma_tf_params(name: str, n_layers=None) -> tuple:
    """A Gemma model at full width and depth (or ``n_layers``), random
    weights from seed 0, every norm at identity: the (1 + w) norms at w = 0, as ``init_params``
    makes them, and the q/k norms too. ``init_params`` sets those to 1, as
    JAX does, which under the (1 + w) convention doubles q and k: scores
    of standard deviation ~4 make gemma-3-4b's attention nearly an argmax,
    and through 34 layers both bf16 paths then drift ~50 % (relative RMS)
    from the f32 one, which leaves the 1.5x rule no power to see a
    kernel's error. At identity they drift ~1.9 % (measured on an NVIDIA
    H100 80GB HBM3 at 700 W)."""
    c = llama.CONFIGS[name]
    if n_layers:
        c = dataclasses.replace(c, n_layers=n_layers)
    params = llama.init_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    for leaf in ("q_norm", "k_norm"):
        if leaf in params["layers"]:
            params["layers"][leaf].zero_()
    return c, params


def family_tf_params(name: str, n_layers: int = FAMILY_TF_LAYERS) -> tuple:
    """A dense family's model at full width and ``n_layers`` layers, random
    weights from seed 0, with its biases drawn nonzero and its norms drawn
    around their identity (FAMILY_NONZERO): each norm's scale row plus
    N(0, FAMILY_NORM_STD), a stacked norm's bias row N(0,
    FAMILY_NORM_BIAS_STD)."""
    return _family_draws(dataclasses.replace(llama.CONFIGS[name], n_layers=n_layers))


def _family_draws(c) -> tuple:
    """``c``'s random weights from seed 0 with ``family_tf_params``' draws."""
    params = llama.init_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    for name_, leaf in [*params["layers"].items(), ("final_norm", params["final_norm"])]:
        if name_ in FAMILY_NONZERO:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device="cuda") * FAMILY_NONZERO[name_])
        elif name_.endswith("norm"):
            noise = torch.randn(leaf.shape, generator=g, device="cuda") * FAMILY_NORM_STD
            if c.stacked_norms and name_ not in ("q_norm", "k_norm"):
                noise[..., 1, :] *= FAMILY_NORM_BIAS_STD / FAMILY_NORM_STD
            leaf.add_(noise.to(leaf.dtype))
    return c, params


def reset_counts() -> None:
    flash.LAUNCHES = flash.LAUNCHES_MLA = flash.LAUNCHES_DQ = flash.LAUNCHES_DKV = flash_decode.LAUNCHES = 0
    w8_matmul.LAUNCHES = adam8.LAUNCHES = 0
    for key in flash_decode.LAUNCHES_BY_VARIANT:
        flash_decode.LAUNCHES_BY_VARIANT[key] = 0
    for key in w8_matmul.LAUNCHES_BY_FORM:
        w8_matmul.LAUNCHES_BY_FORM[key] = 0


def read_counts() -> dict:
    return {"flash_fwd": flash.LAUNCHES, "flash_fwd_mla": flash.LAUNCHES_MLA,
            "flash_bwd_dq": flash.LAUNCHES_DQ, "flash_bwd_dkv": flash.LAUNCHES_DKV,
            "flash_decode": flash_decode.LAUNCHES, **flash_decode.LAUNCHES_BY_VARIANT,
            "w8_matmul": w8_matmul.LAUNCHES, **{f"w8_{k}": v for k, v in w8_matmul.LAUNCHES_BY_FORM.items()},
            "adam8": adam8.LAUNCHES}


def w8_per_pass(c) -> dict:
    """W8's launches by form in one forward pass of an int8 tree of
    ``c`` (a prefill chunk or wave, a decode, turbo or verify step): a
    launch a layer for each int8 projection leaf, three a MoE layer for
    the expert stacks, one for an untied head."""
    dense = 4 + (3 if c.moe_shared_expert else 0) if c.n_experts else 6 + (0 if c.mlp_gateless else 1)
    return {"w8_proj": c.n_layers * dense, "w8_experts": c.n_layers * 3 if c.n_experts else 0,
            "w8_head": 0 if c.tie_embeddings else 1}


def check_w8(what: str, c, launches: dict, passes: int) -> None:
    """The launches of ``passes`` forward passes of an int8 tree: W8 by
    form as :func:`w8_per_pass` says, and nothing else of W8."""
    want = {k: v * passes for k, v in w8_per_pass(c).items()}
    got = {k: launches.get(k, 0) for k in want}
    if got != want or launches.get("w8_matmul") != sum(want.values()) or not passes:
        raise AssertionError(f"{what}: W8 launches {got} (total {launches.get('w8_matmul')}) != {want} "
                             f"for {passes} forward passes")


@contextlib.contextmanager
def plain_w8():
    """W8's wrappers swapped for its plain version (``w8_matmul_plain``,
    JAX's cast, product and scale in torch): the teacher-forced plain and
    f32 paths take it on an int8 tree, as they take the plain attention."""
    saved = {f: getattr(w8_matmul, f"w8_{f}") for f in w8_matmul.FORMS}
    try:
        for f in w8_matmul.FORMS:
            setattr(w8_matmul, f"w8_{f}", lambda x, q, s, f=f: w8_matmul.w8_matmul_plain(x, q, s, f))
        yield
    finally:
        for f, fn in saved.items():
            setattr(w8_matmul, f"w8_{f}", fn)


def kernel_path_only(fn):
    """``fn(name, path)`` with W8's plain version on every path but the
    kernel path."""
    def run(name, path):
        with contextlib.nullcontext() if name == "kernel" else plain_w8():
            fn(name, path)
    return run


class PinnedRouting:
    """``moe.router`` for the teacher-forced comparison: on the first path
    of each step it routes as usual and keeps each call's expert choices;
    on the others it hands those choices back, call by call, so every path
    sends each token to the same experts (with its own gates). A near-tie
    between two experts' router logits otherwise flips a choice between
    the bf16 paths and the f32 one and moves a whole token's logits: on
    gpt-oss such flips swing single checks far past the margin in either
    direction, whichever K4 runs. Dense models never call it."""

    def __init__(self, router):
        self.router, self.replay, self.choices, self.i = router, False, [], 0

    def __call__(self, *args, **kw):
        if self.replay:
            self.i += 1
            return self.router(*args, expert=self.choices[self.i - 1], **kw)
        out = self.router(*args, **kw)
        self.choices.append(out[0])
        return out

    def run(self, paths: dict, fn) -> None:
        """``fn(name, path)`` for each path: the first routes, the rest replay."""
        moe.router, self.choices = self, []
        try:
            for n, (name, path) in enumerate(paths.items()):
                self.replay, self.i = n > 0, 0
                fn(name, path)
        finally:
            moe.router = self.router


class F32Experts(torch.Tensor):
    """A bf16 expert stack ([L, E, ...] or a layer's [E, ...]) that the
    f32 path reads as f32 without an f32 copy: a product with it upcasts
    EXPERT_SLICE experts at a time (each expert's product is the same f32
    arithmetic as on an f32 copy), and indexing keeps the wrapper. The
    teacher-forced comparison holds deepseek-v3's f32 path so: the f32
    copy of its 4-layer stack (45 GB of routed experts) would not fit the
    card beside the bf16 weights; so does llama-4-scout's gradient parity
    (the training forward unbinds the stack into layers, which keep the
    wrapper too)."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_subclass(cls, t)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__) and isinstance(args[1], cls):
            x, w = args[0], args[1].as_subclass(torch.Tensor)
            return torch.cat([torch.matmul(x[e:e + EXPERT_SLICE], w[e:e + EXPERT_SLICE].float())
                              for e in range(0, w.shape[0], EXPERT_SLICE)])
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **kwargs)
        if func in (torch.Tensor.unbind, torch.unbind):  # the training forward's layers
            return tuple(cls(o) for o in out)
        return cls(out) if func is torch.Tensor.__getitem__ else out


EXPERT_SLICE = 32  # experts a product of F32Experts upcasts at once (5.6 GB at deepseek-v3's width)
F32_COPY_LIMIT = 40e9  # bytes: an f32 path larger than this keeps its expert stacks bf16 (F32Experts)


def f32_params(params: dict) -> dict:
    """The f32 path's weights: every leaf upcast, but where that copy would
    pass F32_COPY_LIMIT the routed expert stacks (4-d leaves) stay bf16
    behind :class:`F32Experts`."""
    nbytes = 2 * sum(w.numel() * w.element_size() for v in params.values()
                     for w in (v.values() if isinstance(v, dict) else [v]))
    wrap = nbytes > F32_COPY_LIMIT

    def f32(n, w):
        return F32Experts(w) if wrap and w.dim() == 4 and n in ("w_gate", "w_up", "w_down") else w.float()

    return {k: {n: f32(n, w) for n, w in v.items()} if isinstance(v, dict) else v.float()
            for k, v in params.items()}


def teacher_forced_phase(c, params, kv_quant=None, prompt_len: int = 300, greedy: bool = False) -> dict:
    """Kernel path vs plain path on the card, teacher-forced: one
    ``prompt_len``-token prompt (300 by default: two chunks, the second
    at q_offset 256; gemma-3-4b takes GEMMA_TF_PROMPT), then 8
    decode steps fed the kernel path's greedy tokens, then one
    speculative verify of S = 5 tokens whose draft is the kernel path's
    own next 4 greedy tokens (decoded on a copy of its cache). With
    ``kv_quant="int8"`` every path keeps the int8 cache (the f32 path
    dequantizes to f32). On an int8 weight tree the plain and f32 paths
    take W8's plain version (:func:`plain_w8`: the f32 path on the int8
    values and scales upcast) and the kernel path W8. The counts are set to 0 first; the report
    carries the kernel launches of the run.

    Through 16 bf16 layers the two paths drift apart by the model's own
    bf16 noise (each attention call agrees within one bf16 ulp, yet
    logits of scale ~4 differ by ~0.1 at the worst of 128k entries), so
    both are held to a third path, the plain one in f32 on the same
    weights. The max over correlated logits is a noisy statistic; the
    relative RMS error is not, and at every step the kernel path's may
    be at most KERNEL_RMS_MARGIN times the plain bf16 path's. A wrong
    mask or a dropped key shows as a multiple of that noise. On a MoE
    model every path routes with the f32 path's expert choices
    (``PinnedRouting``), so the rule holds the kernels' error and not a
    router's near-ties. The kernel path decodes on the engine's default
    route: K4, but the einsum for a chunked config (llama-4-scout), whose
    chunk mask no kernel takes. The f32 path's weights are
    :func:`f32_params`'s."""
    reset_counts()
    c32 = dataclasses.replace(c, dtype=torch.float32)
    params32 = f32_params(params)
    route = "einsum" if c.attention_chunk_size else "flash"
    paths = {  # name → (params, config, prefill impl, decode kernel); f32 routes first
        "f32": (params32, c32, "plain", "einsum"),
        "kernel": (params, c, None, route),
        "plain": (params, c, "plain", "einsum"),
    }
    pinned = PinnedRouting(moe.router)
    prompt = [(i * 7 + 300) % 26 + 97 for i in range(prompt_len)]
    caches = {
        p: engine.init_cache(cfg, 1, 2048, device="cuda", kv_quant=kv_quant)
        for p, (_, cfg, _, _) in paths.items()
    }
    logits = {}
    for start in range(0, len(prompt), CHUNK):
        part = prompt[start : start + CHUNK]
        tokens = torch.tensor([part + [0] * (CHUNK - len(part))], device="cuda")

        def prefill(p, path, tokens=tokens, start=start, n=len(part)):
            w, cfg, impl, _ = path
            logits[p], caches[p] = engine.prefill_chunk_step(
                w, caches[p], tokens, 0, n - 1, cfg, start=start, impl=impl,
            )

        pinned.run(paths, kernel_path_only(prefill))
    report = {
        "max_kernel_vs_plain": 0.0, "max_kernel_vs_f32": 0.0, "max_plain_vs_f32": 0.0,
        "rel_rms_kernel_vs_f32": 0.0, "rel_rms_plain_vs_f32": 0.0, "argmax_agree": 0, "argmax_ties": 0,
    }
    by_check = report["rel_rms_by_check"] = {}  # check → [kernel, plain] vs f32

    def rel_rms(a, ref):
        return ((a - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()

    def check(what: str) -> None:
        k, p, f = logits["kernel"], logits["plain"], logits["f32"]
        e = {
            "max_kernel_vs_plain": (k - p).abs().max().item(),
            "max_kernel_vs_f32": (k - f).abs().max().item(),
            "max_plain_vs_f32": (p - f).abs().max().item(),
            "rel_rms_kernel_vs_f32": rel_rms(k, f),
            "rel_rms_plain_vs_f32": rel_rms(p, f),
        }
        if not e["rel_rms_kernel_vs_f32"] <= KERNEL_RMS_MARGIN * e["rel_rms_plain_vs_f32"]:
            raise AssertionError(f"{what} [{c.n_layers} layers, {kv_quant or 'bf16'} cache]: "
                                 f"kernel path drifts from the f32 path: {e}")
        by_check[what] = [e["rel_rms_kernel_vs_f32"], e["rel_rms_plain_vs_f32"]]
        for name, v in e.items():
            report[name] = max(report[name], v)
        ka, pa = logits["kernel"].argmax(dim=-1), logits["plain"].argmax(dim=-1)
        same = bool((ka == pa).all())
        report["argmax_agree"] += int(same)
        if greedy and not same:
            gap = (f.gather(-1, ka[..., None]) - f.gather(-1, pa[..., None])).abs()[..., 0]
            tie = (p - f).abs().amax(dim=-1)
            if not bool((gap <= tie)[ka != pa].all()):
                raise AssertionError(f"{what} [{c.n_layers} layers, {kv_quant or 'bf16'} cache]: greedy tokens "
                                     f"{ka.tolist()} != the plain path's {pa.tolist()}, f32 gap {gap.tolist()} "
                                     f"beyond the plain path's error {tie.tolist()}")
            report["argmax_ties"] += 1

    check("prefill")
    pos = len(prompt)
    for step in range(8):
        tok = logits["kernel"].argmax(dim=-1)
        positions = torch.tensor([pos], dtype=torch.int32, device="cuda")

        def decode(p, path, tok=tok, positions=positions):
            w, cfg, _, kern = path
            logits[p], caches[p] = engine.decode_step(w, caches[p], tok, positions, cfg, decode_kernel=kern)

        pinned.run(paths, kernel_path_only(decode))
        check(f"decode step {step}")
        pos += 1
    # the draft: the kernel path's own next greedy tokens, from a copy
    draft = [logits["kernel"].argmax(dim=-1)]
    scratch = {n: a.clone() for n, a in caches["kernel"].items()}
    for i in range(SPEC_ROWS - 1):
        positions = torch.tensor([pos + i], dtype=torch.int32, device="cuda")
        nxt, scratch = engine.decode_step(params, scratch, draft[-1], positions, c, decode_kernel=route)
        draft.append(nxt.argmax(dim=-1))
    del scratch
    tokens = torch.stack(draft, dim=1)  # [1, S]
    positions = torch.tensor([pos], dtype=torch.int32, device="cuda")
    write = torch.ones(1, dtype=torch.bool, device="cuda")

    def verify(p, path):
        w, cfg, _, kern = path
        logits[p], caches[p] = engine.verify_step(w, caches[p], tokens, positions, cfg, write, decode_kernel=kern)

    pinned.run(paths, kernel_path_only(verify))
    check("verify")
    # how many draft tokens the kernel path's verify accepts (all of
    # them, up to bf16 ties between the decode and verify computations)
    preds = logits["kernel"].argmax(dim=-1)[0, :-1]
    report["verify_accepts"] = int((preds == tokens[0, 1:]).cumprod(0).sum())
    report["launches"] = read_counts()
    if route == "einsum" and report["launches"]["flash_decode"]:
        raise AssertionError(f"a chunked config launched K4: {report['launches']}")
    if quant.is_quantized(params):  # the kernel path's passes: chunks, 8 decodes, the draft's, one verify
        check_w8("teacher-forced int8 tree", c, report["launches"], -(-prompt_len // CHUNK) + 8 + SPEC_ROWS)
    elif report["launches"]["w8_matmul"]:
        raise AssertionError(f"a bf16 tree launched W8: {report['launches']}")
    log(f"teacher-forced logits [{c.n_layers}-layer {c.vocab_size}-vocab model, "
        f"{kv_quant or 'bf16'} cache] over a {prompt_len}-token prefill + 8 decode steps "
        f"+ one verify of S = 5: "
        + json.dumps(report))
    return report


# ---------------------------------------------------------------------------
# phase 4: the training path through the fine-tune entry point
# ---------------------------------------------------------------------------


def _quantized_leaves(c) -> int:
    """The leaves of ``c``'s tree that keep int8 moments: one A8 launch
    each a step of an opt8 run."""
    return sum(opt8._is_quantized(tuple(shape)) for shape in train_step.tree_leaves(llama.param_shapes(c)))


def tree_digest(tree) -> list:
    """Each leaf's bits as integers, summed plainly and weighted by
    position (int64, wrapping), DIGEST_CHUNK elements at a time on the
    leaf's device: a leaf whose digest moved was written."""
    out = []
    for leaf in train_step.tree_leaves(tree):
        bits = leaf.detach().reshape(-1).view(torch.int16 if leaf.element_size() == 2 else torch.int32)
        plain = weighted = 0
        for i in range(0, bits.numel(), DIGEST_CHUNK):
            part = bits[i:i + DIGEST_CHUNK].long()
            pos = torch.arange(i, i + part.numel(), device=part.device) % 65521 + 1
            plain += int(part.sum())
            weighted += int((part * pos).sum())
        out.append((plain, weighted))
    return out


def _finetune(run: str, resume: bool = False) -> dict:
    """One run of TRAIN_RUNS through the fine-tune driver's entry point
    (``python -m dstack_tpu_torch.train.finetune``'s ``main``, called in
    this process with the command line's arguments) at batch 8 x 2048 →
    its summary. The driver sets its launch counts to 0
    before its first step, and each step of ``--grad-accum`` micro-batches
    launches K1, K2 and K3 once a flash layer a micro-batch (K1's
    residuals are kept across remat; ``llama.masked_attention``: gpt-oss's
    sinks and a chunk mask past the first chunk launch none), plus K1
    n_layers times an eval batch; an opt8 run (the OPT8_RUN, with
    OPT8_FLAGS: a checkpoint and an eval every 3 steps) launches A8 once a
    quantized leaf a step, the others never. A LoRA run's base weights must come out
    bitwise as ``init_params`` drew them (:func:`tree_digest` before the
    first step and after the run) and every adapter's B factor, drawn 0,
    must have moved. With ``resume`` the OPT8_RUN runs again with
    ``--resume`` from its RESUME_FROM checkpoint (the later ones removed
    first) into its own output directory."""
    model, mode, accum, steps, *cut = TRAIN_RUNS[run]
    layers = cut[0] if cut else None  # a depth cut (None: the model's depth)
    name = RESUME_RUN if resume else run
    out = ROOT / "build" / f"chip_smoke_train_{name}"
    log_path = ROOT / "build" / f"chip_smoke_train_{name}.log"
    cmd = [sys.executable, "-m", "dstack_tpu_torch.train.finetune", "--model", model,
           "--steps", str(steps), "--grad-accum", str(accum), "--log-every", "1",
           "--device", "cuda", "--out", str(out)]
    if mode == "full":
        cmd.append("--full")
    if run in EXPORT_RUNS and not resume:
        cmd += ["--export-hf", str(out / "hf")]
    opt8_run = run == OPT8_RUN
    start = 0
    if opt8_run:
        ckpt = ROOT / "build" / f"chip_smoke_train_{run}" / "ckpt"
        cmd += [*OPT8_FLAGS, "--ckpt-dir", str(ckpt), "--eval-data", str(EVAL_PATH)]
        if resume:
            for later in [d for d in ckpt.iterdir() if d.name.isdigit() and int(d.name) > RESUME_FROM]:
                shutil.rmtree(later)
            cmd.append("--resume")
            start = RESUME_FROM
        else:
            c0 = llama.CONFIGS[model]
            np.save(EVAL_PATH, np.random.default_rng(7).integers(0, c0.vocab_size, size=(EVAL_ROWS, 2049))
                    .astype(np.int32))
    t0 = time.perf_counter()
    # a LoRA run's base weights, digested as the driver draws them
    base, draw = [], llama.init_params
    if mode == "lora":
        def init_params(*args, **kw):
            params = draw(*args, **kw)
            base.append((params, tree_digest(params)))
            return params

        llama.init_params = init_params
    # the driver's entry point in this process (a process of its own would
    # add its start-up, ~10 s a run), its output into the run's log
    sigterm = signal.getsignal(signal.SIGTERM)
    with open(log_path, "w") as log_f, contextlib.redirect_stdout(log_f), contextlib.redirect_stderr(log_f), \
            _layers(model, layers):
        try:
            rc = finetune.main(cmd[3:])
        except SystemExit as e:
            rc = e.code
        except Exception:  # noqa: BLE001 - logged with its traceback, then raised below
            import traceback

            traceback.print_exc()
            rc = "an exception"
        finally:
            signal.signal(signal.SIGTERM, sigterm)
            llama.init_params = draw
    base_moved = None
    if base:
        (params, digest), = base
        base_moved = [i for i, (a, b) in enumerate(zip(digest, tree_digest(params))) if a != b]
        del params, base
    free_card()
    text = log_path.read_text()
    if rc != 0:
        raise RuntimeError(f"finetune {name} exited {rc}:\n{text[-4000:]}")
    if base_moved:
        raise AssertionError(f"finetune {name}: LoRA wrote base leaves {base_moved} (sorted-key order)")
    if mode == "lora":
        with np.load(out / "lora_adapters.npz") as f:
            still = [k for k in f.files if k.endswith("_lora_b") and not f[k].any()]
        if still:
            raise AssertionError(f"finetune {name}: adapters {still} did not move from 0")
    for line in text.splitlines():
        if line.startswith(("step ", "eval[", "resumed ", "checkpoint ")):
            log(f"  finetune {name}: {line}")
    summary = json.loads(text.strip().splitlines()[-1])
    summary["grad_accum"] = accum
    if mode == "lora":
        summary["base_bitwise_unchanged"] = True
    summary["layers"] = layers
    log(f"finetune {name} ({time.perf_counter() - t0:.1f} s with start-up): {json.dumps(summary)}")
    c = llama.CONFIGS[model]
    if layers:
        c = dataclasses.replace(c, n_layers=layers)
    ln_v = math.log(c.vocab_size)
    first, last = summary["first_loss"], summary["last_loss"]
    if not (math.isfinite(first) and math.isfinite(last) and (resume or abs(first - ln_v) <= 1.0)):
        raise AssertionError(f"finetune {name}: losses {first}, {last} vs ln V = {ln_v:.3f}")
    micro = (steps - start) * accum
    evals = 0
    if opt8_run:
        evals = sum((i + 1) % EVAL_EVERY == 0 for i in range(start, steps)) + 1
        if summary["start_step"] != start or len(summary["eval"]) != evals or summary["opt_bits"] != 8:
            raise AssertionError(f"finetune {name}: start {summary['start_step']}, evals {summary['eval']}, "
                                 f"opt_bits {summary['opt_bits']} (want {start}, {evals} evals, 8)")
        if not all(math.isfinite(e["loss"]) for e in summary["eval"]):
            raise AssertionError(f"finetune {name}: eval losses {summary['eval']}")
    eval_batches = evals * min(EVAL_BATCHES, EVAL_ROWS // 8)
    flash_layers = sum(not llama.masked_attention(c, 2048, nope) for nope in llama.layer_nope(c))
    want = {"flash_fwd": flash_layers * micro + c.n_layers * eval_batches, "flash_bwd_dq": flash_layers * micro,
            "flash_bwd_dkv": flash_layers * micro,
            "adam8": _quantized_leaves(c) * (steps - start) if opt8_run else 0}
    if summary["launches"] != want:
        raise AssertionError(f"finetune {name}: launches {summary['launches']} != {want}")
    return summary


NPZ_CHUNK = 1 << 26  # bytes of each file _npz_differ reads at once


def _npz_differ(a_path: Path, b_path: Path) -> tuple[list, int]:
    """(the entries of two ``.npz`` files whose stored bytes differ, or
    that one file lacks; the first file's entry count): each entry's
    ``.npy`` bytes, header (dtype and shape) and data, compared in
    NPZ_CHUNK reads, each checked against its CRC-32 (loading and
    comparing the arrays took ~21 s for two 5 GB files)."""
    with zipfile.ZipFile(a_path) as za, zipfile.ZipFile(b_path) as zb:
        names_a, names_b = set(za.namelist()), set(zb.namelist())
        differ = sorted(names_a ^ names_b)
        for name in sorted(names_a & names_b):
            with za.open(name) as fa, zb.open(name) as fb:
                while True:
                    x, y = fa.read(NPZ_CHUNK), fb.read(NPZ_CHUNK)
                    if x != y:
                        differ.append(name)
                        break
                    if not x:
                        break
    return [n.removesuffix(".npy") for n in differ], len(names_a)


def resume_check(first: dict) -> dict:
    """The opt8 run resumed from its step-RESUME_FROM checkpoint
    (:func:`_finetune` with ``resume``): its ``model_weights.npz`` equals
    the uninterrupted run's bitwise, leaf for leaf and the step."""
    summary = _finetune(OPT8_RUN, resume=True)
    differ, leaves = _npz_differ(ROOT / "build" / f"chip_smoke_train_{OPT8_RUN}" / "model_weights.npz",
                                 ROOT / "build" / f"chip_smoke_train_{RESUME_RUN}" / "model_weights.npz")
    if differ:
        raise AssertionError(f"resume: leaves {differ} differ from the uninterrupted run's")
    evals = {e["tag"]: e["loss"] for e in first["eval"]}
    same = {e["tag"]: e["loss"] == evals.get(e["tag"]) for e in summary["eval"]}
    log(f"resume [{OPT8_RUN} from step {RESUME_FROM}]: model_weights.npz bitwise equal ({leaves} entries); "
        f"eval losses equal by tag: {json.dumps(same)}")
    if not all(same.values()):
        raise AssertionError(f"resume: eval losses {summary['eval']} differ from {first['eval']}")
    return summary


def export_phase() -> dict:
    """The HF export round trip of the llama-3.2-1b fine-tunes (EXPORT_RUNS,
    ``finetune --export-hf``): ``load_checkpoint(DIR, device="cuda")`` gives
    back, bitwise, the ``--full`` run's trained tree (its
    ``model_weights.npz`` over the seed-0 weights) and the LoRA run's base
    with its adapters merged (``merge_lora_params`` on the card, as the
    run merged them), and a teacher-forced forward of each loaded tree
    (one 300-token prompt) is bitwise the original's. → seconds and sizes."""
    report = {}
    prompt = torch.tensor([[(i * 7 + 300) % 26 + 97 for i in range(300)]], device=DEVICE)
    for run in EXPORT_RUNS:
        out = ROOT / "build" / f"chip_smoke_train_{run}"
        c, want = llama_tf_params()
        if run == "full":
            load_weights_npz(want, out / "model_weights.npz")
        else:
            with np.load(out / "lora_adapters.npz") as f:
                adapters = {k.removeprefix("layers."): torch.from_numpy(f[k]).to(DEVICE) for k in f.files}
            want = train_lora.merge_lora_params(want, {"layers": adapters}, train_lora.LoRAConfig())
        t0 = time.perf_counter()
        c2, got = convert_hf.load_checkpoint(out / "hf", device=DEVICE)
        load_s = time.perf_counter() - t0
        flat = {**{k: v for k, v in got.items() if not isinstance(v, dict)},
                **{f"layers/{k}": v for k, v in got["layers"].items()}}
        ref = {**{k: v for k, v in want.items() if not isinstance(v, dict)},
               **{f"layers/{k}": v for k, v in want["layers"].items()}}
        differ = [k for k in ref if k not in flat or flat[k].dtype != ref[k].dtype or not torch.equal(flat[k], ref[k])]
        if differ or set(flat) != set(ref) or c2.n_layers != c.n_layers:
            raise AssertionError(f"export [{run}]: leaves {differ} differ from the trained tree")
        with torch.no_grad():
            a, b = llama.forward(got, prompt, c), llama.forward(want, prompt, c)
        if not torch.equal(a, b):
            raise AssertionError(f"export [{run}]: the loaded tree's forward differs by {(a - b).abs().max()}")
        size = (out / "hf" / "model.safetensors").stat().st_size
        report[run] = {"leaves": len(ref), "safetensors_bytes": size, "load_s": round(load_s, 2)}
        del want, got, a, b
        free_card()
    log("export round trip [finetune --export-hf]: " + json.dumps(report))
    return report


def _kernel_family(name: str) -> str:
    for key, fam in (("flash_fwd_kernel", "K1 flash_fwd"), ("flash_fwd_mla_kernel", "K1 flash_fwd_mla"),
                     ("flash_bwd_dq_kernel", "K2 flash_bwd_dq"),
                     ("flash_bwd_dkv_kernel", "K3 flash_bwd_dkv"),
                     ("flash_decode_kernel", "K4 flash_decode"),
                     ("flash_decode_combine_kernel", "K4 flash_decode"),
                     ("flash_mla_combine_kernel", "K1 flash_fwd_mla")):
        if key in name:
            return fam
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "foreach" in low or "multi_tensor" in low:
        return "optimizer (foreach)"
    if any(k in low for k in ("index", "scatter", "gather")):
        return "gather/scatter"
    if "reduce" in low:
        return "reductions"
    return "elementwise and other"


def profile_step(fn) -> dict:
    """``fn()`` once as a warm-up, then traced with torch.profiler: device
    time by kernel family, and the device's busy share of the call's
    host-clock time (kernel intervals merged). The profiler's own host
    cost lengthens the call, so the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_family: dict = {}
    by_name: dict = {}
    spans = []
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        fam = _kernel_family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + ms
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + ms
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {
        "step_ms_profiled": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / wall_us if wall_us else None,
        "kernel_ms_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
        "kernels_seen": len(kernels),
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12]),
    }


def train_profile_phase() -> dict:
    """One full fine-tune step at the fine-tune defaults (batch 8 x 2048),
    traced after a warm-up step in this process (``profile_step``)."""
    c = llama.CONFIGS[MODEL]
    opt = train_step.default_optimizer(lr=2e-4, decay_steps=10)
    state = train_step.init_train_state(c, opt, seed=0, device="cuda")
    fn = train_step.make_train_step(c, opt)
    g = torch.Generator(device="cuda").manual_seed(3)
    tok = torch.randint(0, c.vocab_size, (8, 2048), generator=g, device="cuda")
    mask = torch.ones_like(tok)
    mask[:, -1] = 0
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, dims=1), "mask": mask}
    report = profile_step(lambda: fn(state, batch))
    log("train step profile (full fine-tune, batch 8 x 2048): " + json.dumps(report))
    del state, fn, batch
    free_card()
    return report


def deepseek_train_phase() -> dict:
    """deepseek-v2-lite fully fine-tuned in this process through
    ``init_train_state`` and ``make_train_step``: full width,
    DEEPSEEK_TRAIN_LAYERS layers (the dense prelude, then MoE layers),
    random weights from seed 0, bf16, batch 8 x 2048 of random tokens in
    DEEPSEEK_TRAIN's micro-batches, for its steps. Every attention call is
    MLA's non-absorbed form at D = 192 (v padded from 128). The launch
    counts are set to 0 just before the steps and read just after: per
    micro-batch K1, K2 and K3 n_layers times each (K1's residuals are kept
    across remat), and no other kernel. The first CE lies within 1.0
    of ln(vocab) and every loss is finite. → step seconds (the median of
    the steps after the first, which carries the start-up), tokens/s, MFU
    on the active parameters (``flops_per_token``), peak memory, losses,
    launches, and one more step traced (``profile_step``: device time by
    kernel family, the device's busy share)."""
    accum, steps = DEEPSEEK_TRAIN
    c = dataclasses.replace(llama.CONFIGS[DEEPSEEK], n_layers=DEEPSEEK_TRAIN_LAYERS)
    opt = train_step.default_optimizer(lr=2e-4, decay_steps=steps)
    t0 = time.perf_counter()
    state = train_step.init_train_state(c, opt, seed=0, device="cuda")
    step = train_step.make_train_step(c, opt, grad_accum=accum)
    init_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(4)
    tokens_per_step = BWD_TRAIN_BATCH * 2048

    def batch() -> dict:
        tok = torch.randint(0, c.vocab_size, (BWD_TRAIN_BATCH, 2048), generator=g, device="cuda")
        mask = torch.ones_like(tok)
        mask[:, -1] = 0  # the roll wraps the last target
        return {"tokens": tok, "targets": torch.roll(tok, -1, dims=1), "mask": mask}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ce, aux, times = [], [], []
    reset_counts()
    for _ in range(steps):
        data = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, data)
        ce.append(float(m["loss"]))  # waits for the step
        aux.append(float(m["aux_loss"]))
        times.append(time.perf_counter() - t0)
    launches = read_counts()
    med = sorted(times[1:])[len(times[1:]) // 2]
    tps = tokens_per_step / med
    report = {
        "model": DEEPSEEK, "layers": c.n_layers, "batch": [BWD_TRAIN_BATCH, 2048], "grad_accum": accum,
        "steps": steps, "init_s": init_s, "first_step_s": times[0], "median_step_s": med, "step_s": times,
        "tokens_per_s": tps, "mfu": train_step.flops_per_token(c, 2048) * tps / PEAK_BF16_FLOPS,
        "mfu_peak": "H100 SXM dense bf16 peak, 989 TFLOP/s", "active_params": c.num_active_params(),
        "params": c.num_params(), "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "ce": ce, "aux_loss": aux, "launches": launches,
    }
    log(f"{DEEPSEEK} full fine-tune ({c.n_layers} layers, batch {BWD_TRAIN_BATCH} x 2048, --grad-accum {accum}): "
        + json.dumps(report))
    ln_v = math.log(c.vocab_size)
    if not all(math.isfinite(x) for x in ce + aux) or abs(ce[0] - ln_v) > 1.0:
        raise AssertionError(f"deepseek training: losses CE {ce}, aux {aux} vs ln V = {ln_v:.3f}")
    micro = steps * accum
    want = {"flash_fwd": c.n_layers * micro, "flash_bwd_dq": c.n_layers * micro,
            "flash_bwd_dkv": c.n_layers * micro}
    if {k: n for k, n in launches.items() if n} != want:
        raise AssertionError(f"deepseek training: launches {launches} != {want}")
    report["profile"] = profile_step(lambda: step(state, batch()))
    log(f"{DEEPSEEK} train step profile ({c.n_layers} layers, batch {BWD_TRAIN_BATCH} x 2048): "
        + json.dumps(report["profile"]))
    del state, step
    free_card()
    return report


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in train_step.tree_leaves(tree) if isinstance(t, torch.Tensor))


def train_opt8_phase(model: str = LLAMA_8B) -> dict:
    """``model`` fully fine-tuned in this process at full width and
    TRAIN_OPT8's depth (llama-3-8b: 8 of 32 layers; starcoder2-7b: 4 of
    32, with LayerNorm's bias, every bias and the gateless MLP),
    random weights from seed 0, bf16, through ``init_train_state`` and
    ``make_train_step`` with ``default_optimizer(opt_bits=8)``, as
    ``finetune --full --opt-bits 8`` builds them (in this process, not
    through the driver, whose ``model_weights.npz`` would write a 7 B
    model's 28.7 GB of f32 to the machine's disk): TRAIN_OPT8's rows of
    2048 random tokens in one micro-batch, whose f32 logits make the
    step's default loss the chunked one (``loss_impl_for``), for its
    steps. Running out of the card's memory fails the phase. The counts
    are set to 0 just before the steps and read just after: per step K1,
    K2 and K3 once a layer each and A8 once a quantized leaf, and no
    other kernel. Every loss finite, the first within 1.0 of ln(vocab).
    → the step seconds (the median after the first, which carries the
    start-up), tokens/s, MFU against the bf16 peak,
    ``max_memory_allocated`` beside the bytes of the parameters and the
    optimizer state."""
    rows, steps, layers = TRAIN_OPT8[model]
    c = llama.CONFIGS[model]
    if layers:
        c = dataclasses.replace(c, n_layers=layers)
    loss_impl = train_step.loss_impl_for(rows, 2048, c.vocab_size)
    if loss_impl != "chunked":
        raise AssertionError(f"{model} training: the default loss at {rows} x 2048 is {loss_impl!r}")
    opt = train_step.default_optimizer(lr=2e-4, decay_steps=steps, opt_bits=8)
    t0 = time.perf_counter()
    state = train_step.init_train_state(c, opt, seed=0, device="cuda")
    step = train_step.make_train_step(c, opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    quantized = _quantized_leaves(c)
    g = torch.Generator(device="cuda").manual_seed(6)

    def batch() -> dict:
        tok = torch.randint(0, c.vocab_size, (rows, 2048), generator=g, device="cuda")
        mask = torch.ones_like(tok)
        mask[:, -1] = 0  # the roll wraps the last target
        return {"tokens": tok, "targets": torch.roll(tok, -1, dims=1), "mask": mask}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ce, times = [], []
    reset_counts()
    for _ in range(steps):
        data = batch()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, data)
        ce.append(float(m["loss"]))  # waits for the step
        times.append(time.perf_counter() - t1)
    launches = read_counts()
    med = sorted(times[1:])[len(times[1:]) // 2]
    tps = rows * 2048 / med
    report = {
        "model": model, "layers": c.n_layers, "params": c.num_params(), "batch": [rows, 2048],
        "grad_accum": 1, "loss_impl": loss_impl, "opt_bits": 8, "steps": steps, "init_s": init_s,
        "first_step_s": times[0], "median_step_s": med, "step_s": times, "tokens_per_s": tps,
        "mfu": train_step.flops_per_token(c, 2048) * tps / PEAK_BF16_FLOPS,
        "mfu_peak": "H100 SXM dense bf16 peak, 989 TFLOP/s",
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "param_bytes": _tree_bytes(state["params"]),
        "moment_bytes": _tree_bytes({k: v for k, v in state["opt_state"].items() if k != "count"}),
        "quantized_leaves": quantized, "ce": ce, "launches": launches,
    }
    log(f"{model} full fine-tune (opt8, {loss_impl} loss, {rows} x 2048, one micro-batch): " + json.dumps(report))
    ln_v = math.log(c.vocab_size)
    if not all(math.isfinite(x) for x in ce) or abs(ce[0] - ln_v) > 1.0:
        raise AssertionError(f"{model} training: losses {ce} vs ln V = {ln_v:.3f}")
    want = {"flash_fwd": c.n_layers * steps, "flash_bwd_dq": c.n_layers * steps,
            "flash_bwd_dkv": c.n_layers * steps, "adam8": quantized * steps}
    if {k: n for k, n in launches.items() if n} != want:
        raise AssertionError(f"{model} training: launches {launches} != {want}")
    del state, step
    free_card()
    return report


def decode_profile_phase(name: str, c, params) -> dict:
    """One ``decode_step`` of model ``name`` at the server's batch (8
    slots, the bf16 cache, positions 300-1700; on gpt-oss K4's sinks form,
    on deepseek-v2-lite the latent products), traced with
    ``profile_step``, and its host-clock time untraced (median of 10):
    where a decode step's time goes, per layer of ``c`` (the comparison's
    depth; the servers run 24 and 27). Then the same step as a CUDA graph
    (a step site of ``serve/graphs.py``, captured once) traced and timed
    alike beside it: the device's busy share of a replay."""
    b = 8
    cache = engine.init_cache(c, b, 2048, device="cuda")
    tok = torch.arange(b, device="cuda") + 97
    positions = torch.arange(300, 1900, 200, dtype=torch.int32, device="cuda")

    def step():
        return engine.decode_step(params, cache, tok, positions, c)[0]

    def timed_ms(fn) -> float:
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return 1e3 * sorted(times)[len(times) // 2]

    report = profile_step(step)
    report["step_ms"] = timed_ms(step)
    report["layers"] = c.n_layers
    replay = GraphSet("cuda", capture=True).site("decode", step)
    replay()  # the capture
    graph = profile_step(replay)
    graph["step_ms"] = timed_ms(replay)
    report["graph"] = graph
    log(f"decode step profile ({c.n_layers}-layer {name}, batch {b}, eager; graph under 'graph'): "
        + json.dumps(report))
    return report


# ---------------------------------------------------------------------------
# phase 5: gradient parity
# ---------------------------------------------------------------------------


def grad_parity_phase(name: str = MODEL) -> dict:
    """Gradients of the full fine-tune loss on three paths. Through the
    bf16 layers the kernel and plain paths differ by the model's own bf16
    noise, so both are held to the plain f32 path by relative RMS error,
    leaf by leaf (stacked layers: one leaf per weight name). llama-3.2-1b
    whole; gemma-3-4b and gemma-3-1b at 6 layers (5 sliding, then their
    first global one; gemma-3-1b's GQA group of 4 and window of 512) and
    gemma-2-2b at 4 (2 sliding, 2 global: softcap 50 and the logit cap 30
    in the loss), full width, norms at identity (``gemma_tf_params``);
    deepseek-v2-lite at full width and 4 layers (``deepseek_tf_params``:
    MLA at D = 192, the MoE and its router aux loss in the loss); the dense
    families at full width and 4 layers with their biases and norms drawn
    (``family_tf_params``: qwen-2.5-7b G = 7, glm-4-9b G = 16, olmo-2-7b and
    command-r-35b G = 1, minitron-4b G = 3, starcoder2-7b G = 9, K1-K3 at D
    = 128 on every layer); gpt-oss-20b at 4 (``gpt_oss_tf_params``: two
    sliding and two global layers, nonzero sinks and biases; the masked
    attention everywhere, so its kernel path runs no kernel); and
    llama-4-scout at 4 (layers 0-2 rope, layer 3 NoPE, all in the first
    chunk at T = 2048: K1-K3 on each), whose LoRA gradients are held
    (GRAD_PARITY_LORA: adapters with B drawn nonzero, so A gets a
    gradient), its f32 path reading the bf16 expert stacks through
    :class:`F32Experts`. Every MoE path routes with the f32 path's expert
    choices (``PinnedRouting``) and without remat (under remat the
    backward's recompute calls the router again, in reverse layer order).
    The paths run in turn: the f32 tree is made for its path and freed
    after it, so only its gradients stay beside the bf16 paths'; on a full
    fine-tune's paths the bf16 tree is freed while the f32 path runs and
    made again from the f32 copy after it (the same bits: the copy is
    exact), as command-r-35b's f32 path (its tied 256k x 8192 embedding's
    gradients) does not fit beside it. The two bf16 losses agree within
    TOL, and each lies within the model's GRAD_PARITY limit of the f32
    loss."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 path in full f32
    torch.backends.cudnn.allow_tf32 = False
    n_layers, loss_tol = GRAD_PARITY[name]
    if name == MODEL:
        c = llama.CONFIGS[name]
        params = llama.init_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    elif name == DEEPSEEK:
        c, params = deepseek_tf_params()
    elif name == GPT_OSS:
        c, params = gpt_oss_tf_params()
    elif name in D256:
        c, params = gemma_tf_params(name, n_layers)
    else:
        c, params = family_tf_params(name, n_layers)
    if c.n_experts:
        c = dataclasses.replace(c, remat=False)
    c32 = dataclasses.replace(c, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, c.vocab_size, (1, 2048), generator=g, device="cuda")
    mask = torch.ones_like(tokens)
    mask[:, -1] = 0
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1), "mask": mask}
    lora_conf = lora = None
    if name in GRAD_PARITY_LORA:
        lora_conf = train_lora.LoRAConfig()
        lora = train_lora.init_lora_params(c, lora_conf, g, device="cuda")
        for key, leaf in lora["layers"].items():
            if key.endswith("_lora_b"):
                leaf.copy_(torch.randn(leaf.shape, generator=g, device="cuda") * 0.02)
    # f32 first: on a MoE model it routes, and the bf16 paths take its choices
    paths = {"f32": (c32, "plain"), "kernel": (c, None), "plain": (c, "plain")}
    loss, grads = {}, {}
    tree = {"params": params}  # the bf16 tree, freed and made again around a full f32 path
    dtypes = train_step.tree_map(lambda w: w.dtype, params)
    del params

    def run(path, spec):
        cfg, impl = spec
        f32 = path == "f32"
        if lora is None:
            p = train_step.tree_map(lambda w: w.float(), tree.pop("params")) if f32 else tree["params"]
            free_card()
            value, grads[path] = train_step.value_and_grad(train_step.full_loss, p, batch, cfg, impl)
            if f32:
                tree["params"] = train_step.tree_map(lambda w, d: w.to(d), p, dtypes)
        else:
            base = f32_params(tree["params"]) if f32 else tree["params"]
            wrt = train_step.tree_map(lambda w: w.float(), lora) if f32 else lora
            value, grads[path] = train_step.value_and_grad(train_lora.lora_loss, wrt, batch, base, cfg,
                                                           lora_conf, impl)
        loss[path] = float(value)

    PinnedRouting(moe.router).run(paths, run)
    if (abs(loss["kernel"] - loss["plain"]) > TOL
            or any(abs(loss[a] - loss["f32"]) > loss_tol for a in ("kernel", "plain"))):
        raise AssertionError(f"gradient parity {name}: losses disagree beyond {TOL} "
                             f"(against f32: {loss_tol}): {loss}")

    def rel_rms(a, ref):
        return ((a.float() - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()

    def flat(tree, prefix=""):  # "layers/wq" → leaf; every stack's leaves
        out = {}
        for key in sorted(tree):
            out.update(flat(tree[key], f"{prefix}{key}/") if isinstance(tree[key], dict)
                       else {prefix + key: tree[key]})
        return out

    leaves = {}
    by_path = {path: flat(g) for path, g in grads.items()}
    for leaf, ref in by_path["f32"].items():
        if not ref.any():  # a leaf the loss does not reach (a selection bias): zero on every path
            if by_path["kernel"][leaf].any() or by_path["plain"][leaf].any():
                raise AssertionError(f"gradient parity {name}: {leaf} is zero on the f32 path only")
            leaves[leaf] = {"kernel": 0.0, "plain": 0.0}
            continue
        k_err = rel_rms(by_path["kernel"][leaf], ref)
        p_err = rel_rms(by_path["plain"][leaf], ref)
        leaves[leaf] = {"kernel": k_err, "plain": p_err}
        if not k_err <= KERNEL_RMS_MARGIN * p_err:
            raise AssertionError(f"gradient parity {name}: {leaf} kernel rel RMS {k_err:.4g} > "
                                 f"{KERNEL_RMS_MARGIN} x plain {p_err:.4g}")
    report = {"model": name, "layers": c.n_layers, "lora": lora is not None, "loss": loss,
              "rel_rms_vs_f32": leaves}
    log(f"gradient parity {name} (rel RMS vs the f32 path, per leaf): " + json.dumps(report))
    del tree, lora, grads
    free_card()
    return report


# ---------------------------------------------------------------------------
# the parallel package (ROADMAP A6.1): 2 ranks on the one card over gloo
# ---------------------------------------------------------------------------

PAR_RANKS = 2  # ranks sharing the card: NCCL refuses two on one device, so gloo carries their bytes
# the ring and Ulysses at full width, forward and backward: model → (B, H, Hkv, T, D, window, softcap)
PAR_SHAPES = {
    MODEL: (8, 32, 8, 2048, 64, 0, 0.0),
    DEEPSEEK: (4, 16, 16, 2048, 192, 0, 0.0),  # MLA's training form: v zero-padded to 192
    GEMMA3_1B: (8, 4, 1, 2048, 256, 512, 0.0),  # its local layer
    GEMMA2: (8, 8, 4, 2048, 256, 4096, 50.0),
}
# the ring's new kernel forms, each timed at one rank's shard (T/sp = 1024):
# row → (model whose shape, the form's q_offset); the ring's diagonal step is
# the causal form every earlier row times
PAR_FORMS = {"noncausal": (MODEL, 0), "offset": (GEMMA3_1B, 1024)}
PAR_FORM_EXTRA = {"noncausal": DEEPSEEK, "offset": GEMMA2}  # checked and timed beside the row's shape
# torchrun fine-tunes at 8 x 2048, PAR_STEPS steps: run → (model, layers (None: all), mesh flags)
PAR_TRAIN = {
    "sp2_ring": (MODEL, None, ["--sp", "2"]),
    "sp2_ulysses": (MODEL, None, ["--sp", "2", "--seq-parallel", "ulysses"]),
    "fsdp2": (MODEL, None, ["--fsdp", "2"]),
    "deepseek_sp2": (DEEPSEEK, DEEPSEEK_TRAIN_LAYERS, ["--sp", "2"]),
}
PAR_STEPS = 3
PAR_LOSS_RTOL = 2e-3  # first-step loss against the single-rank run of the same seed and flags
# gradient parity on meshes: llama-3.2-1b at full width and PAR_PARITY_LAYERS
# layers, a [2, 2048] batch (two rows: one for each fsdp rank)
PAR_PARITY_LAYERS = 4
PAR_PARITY_MESHES = {"sp2_ring": dict(fsdp=1, sp=2), "fsdp2": dict(fsdp=2)}
PAR_DIR = ROOT / "build" / "chip_smoke_parallel"


def _par_inputs(name: str) -> tuple:
    """The whole sequence's q, k, v, dO of PAR_SHAPES[name] (seed 11: the
    same on every rank) and the call's keywords."""
    b, h, hkv, t, d, window, cap = PAR_SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(11)
    q, do = (torch.randn(b, h, t, d, generator=g, device="cuda", dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, hkv, t, d, generator=g, device="cuda", dtype=torch.bfloat16) for _ in range(2))
    return q, k, v, do, dict(window=window, softcap=cap)


def _par_parity_inputs() -> tuple:
    c = dataclasses.replace(llama.CONFIGS[MODEL], n_layers=PAR_PARITY_LAYERS)
    params = llama.init_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, c.vocab_size, (2, 2048), generator=g, device="cuda")
    mask = torch.ones_like(tokens)
    mask[:, -1] = 0
    return c, params, {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1), "mask": mask}


def parallel_worker(out_dir: str) -> None:
    """One rank of the parallel phase, started by torchrun
    (``chip_smoke.py --parallel-worker DIR``). (1) The ring and Ulysses at
    each PAR_SHAPES shape, this rank's sequence shard, forward and
    backward: the launches by form counted on that run alone, then held
    to the same ring (or Ulysses) on the plain per-step functions and to
    the single-rank K1-K3 call over the whole sequence, o, dq, dk and dv
    by :func:`grad_close`. (2) llama-3.2-1b's gradients at
    PAR_PARITY_LAYERS layers on each PAR_PARITY_MESHES mesh, put back
    whole on rank 0 (``grads_<mesh>.pt``). (3) Each PAR_TRAIN fine-tune
    through the entry point's ``finetune.main`` in these ranks (one spawn
    for the phase: a torchrun a run would start the ranks' imports and
    process group again),
    rank 0's output into ``train_<run>.log``, the weights it writes
    removed once the run ends. → ``rank<r>.json``."""
    from dstack_tpu_torch.parallel.mesh import Mesh, MeshConfig, init_distributed
    from dstack_tpu_torch.parallel.ring_attention import ring_attention
    from dstack_tpu_torch.parallel.ulysses import ulysses_attention

    env = init_distributed("cuda")
    mesh = Mesh(MeshConfig(fsdp=1, sp=PAR_RANKS), env)
    rank, out = env.rank, {"forms": {}, "counts": {}, "seconds": {}}
    for name in PAR_SHAPES:
        q, k, v, do, kw = _par_inputs(name)
        tl = q.shape[2] // PAR_RANKS
        sl = slice(rank * tl, (rank + 1) * tl)

        def run(kind, plain=False):
            ql, kl, vl = (x[:, :, sl].contiguous().requires_grad_(True) for x in (q, k, v))
            if kind == "ring":
                o = ring_attention(ql, kl, vl, mesh=mesh, plain=plain, **kw)
            else:
                o = ulysses_attention(ql, kl, vl, mesh=mesh, impl="plain" if plain else None, **kw)
            o.backward(do[:, :, sl].contiguous())
            return o.detach(), ql.grad, kl.grad, vl.grad

        qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        whole = flash.flash_attention(qs, ks, vs, **kw)
        whole.backward(do)
        one = tuple(x[:, :, sl] for x in (whole.detach(), qs.grad, ks.grad, vs.grad))
        del qs, ks, vs, whole
        for kind in ("ring", "ulysses"):
            mesh.barrier()
            t0 = time.perf_counter()
            flash.LAUNCHES_BY_FORM.clear()
            got = run(kind)
            torch.cuda.synchronize()
            out["counts"][f"{name}/{kind}"] = dict(flash.LAUNCHES_BY_FORM)
            out["seconds"][f"{name}/{kind}"] = time.perf_counter() - t0
            errs = {}
            for ref_name, ref in (("plain", run(kind, plain=True)), ("single_rank", one)):
                for part, a, w in zip(("o", "dq", "dk", "dv"), got, ref):
                    errs[f"{ref_name}/{part}"] = grad_close(a, w, f"parallel {name} {kind} {part} vs {ref_name}")
            out["forms"][f"{name}/{kind}"] = errs
            del got
        del q, k, v, do, one
        free_card()
    # gradients on meshes, whole on rank 0
    c, params, batch = _par_parity_inputs()
    for mname, axes in PAR_PARITY_MESHES.items():
        pm = Mesh(MeshConfig(**axes), env)
        layout = train_step.param_layout(c, pm)
        shards = train_step.shard_tree(params, layout, pm)
        local = train_step.local_batch(batch, pm)
        loss, grads = train_step.value_and_grad(
            lambda p, b: train_step.sharded_objective(p, b, c, None, None, pm, layout)[0], shards, local)
        grads = train_step.reduce_grads(grads, layout, shards, pm)
        loss = pm.all_reduce(loss, train_step.DATA_AXES)
        full = {path: leaf.cpu() for path, leaf in train_step.gathered_leaves(grads, layout, pm)}
        if rank == 0:
            torch.save(full, Path(out_dir) / f"grads_{mname}.pt")
        out[f"loss_{mname}"] = float(loss)
        del shards, grads, full
        free_card()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del c, params, batch
    free_card()
    # the fine-tunes, each through the entry point on both ranks
    out["train_seconds"] = {}
    for run, (model, layers, flags) in PAR_TRAIN.items():
        dest = Path(out_dir) / f"train_{run}"
        argv = ["--model", model, "--full", "--steps", str(PAR_STEPS), "--log-every", "1", "--out", str(dest),
                *flags]
        mesh.barrier()
        t0 = time.perf_counter()
        with open(Path(out_dir) / f"train_{run}.log" if rank == 0 else os.devnull, "w") as log_f, \
                contextlib.redirect_stdout(log_f), _layers(model, layers):
            rc = finetune.main(argv)
        out["train_seconds"][run] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"parallel finetune {run} rank {rank} returned {rc}")
        if rank == 0:
            shutil.rmtree(dest, ignore_errors=True)
        free_card()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    mesh.barrier()


def _form_pairs(t: int, q_offset: int, window: int) -> int:
    """Live (query, key) pairs of a non-causal [t, t] call at ``q_offset``
    with ``window``: 0 <= q_offset + i - j < window (every pair when
    neither is set)."""
    if not window:
        return t * t
    return sum(max(0, min(t, q_offset + i + 1) - max(0, q_offset + i - window + 1)) for i in range(t))


def _par_form_row(form: str, name: str) -> dict:
    """K1, K2 and K3 at one ring form on one rank's shard of PAR_SHAPES[name]
    (T/sp = 1024; "offset": the block of the rank before, q_offset 1024,
    under the window): held to the plain versions (:func:`fwd_bwd_check`),
    then each timed beside its bound, the plain version and the library
    on the same block: SDPA (``is_causal=False``) without a window or cap,
    else the compiled ``flex_attention`` (:func:`_flex`: the offset window
    as its block mask, the cap as its score_mod), its backward timed for
    dq, dk and dv together."""
    b, h, hkv, t, d, window, cap = PAR_SHAPES[name]
    tl = t // PAR_RANKS
    q_offset = PAR_FORMS[form][1] if form == "offset" else 0
    g = torch.Generator(device="cuda").manual_seed(12)
    q, do = (torch.randn(b, h, tl, d, generator=g, device="cuda", dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, hkv, tl, d, generator=g, device="cuda", dtype=torch.bfloat16) for _ in range(2))
    kw = dict(causal=False, q_offset=q_offset, window=window if form == "offset" else 0, softcap=cap)
    chk = fwd_bwd_check(q, k, v, do, kw, f"ring {form} {name}")
    o, lse, delta = chk["o"], chk["lse"], chk["delta"]
    pairs = _form_pairs(tl, q_offset, kw["window"])
    gemm = 2 * b * h * pairs * d
    qb, kvb, rowb = q.numel() * 2, k.numel() * 2, lse.numel() * 4
    bounds = {"flash_fwd": bound_ms(2 * qb + 2 * kvb + rowb, 2 * gemm),
              "flash_bwd_dq": bound_ms(2 * qb + 2 * kvb + 2 * rowb + qb, 3 * gemm),
              "flash_bwd_dkv": bound_ms(2 * qb + 2 * kvb + 2 * rowb + 2 * kvb, 4 * gemm)}
    ms = {"flash_fwd": time_ms(lambda: flash.flash_attention_with_lse(q, k, v, **kw)),
          "flash_bwd_dq": time_ms(lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw)),
          "flash_bwd_dkv": time_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))}
    plain_fwd = time_ms(lambda: flash.flash_attention_plain(q, k, v, **kw), iters=5)
    plain_bwd = time_ms(lambda: flash.flash_bwd_plain(q, k, v, o, lse, do, **kw), iters=5)
    library = {}
    if kw["window"] or cap:
        win = kw["window"]

        def keep(bb, hh, qi, kj):
            ahead = q_offset + qi - kj
            return (ahead >= 0) & (ahead < win) if win else qi >= 0  # no window: every pair

        scale = d ** -0.5
        library["flash_fwd"] = time_ms(flex_fwd(q, k, v, keep, scale, cap, o))
        library["flash_bwd_dq"] = library["flash_bwd_dkv"] = time_ms(
            _flex_bwd(q, k, v, do, win, scale, cap, chk["want"], keep=keep))
        note = FLEX_NOTE if cap else "flex_attention compiled, the offset window as its block mask"
    else:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library["flash_fwd"] = time_ms(lambda: sdpa(q, k, v, enable_gqa=True))
        qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
        so = sdpa(qs, ks, vs, enable_gqa=True)
        library["flash_bwd_dq"] = library["flash_bwd_dkv"] = time_ms(
            lambda: torch.autograd.grad(so, (qs, ks, vs), do, retain_graph=True))
        del qs, ks, vs, so
        note = "SDPA, is_causal=False"
    rows = {}
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        err = chk[kernel]
        rows[kernel] = {
            "max_abs_err": err if kernel == "flash_fwd" else err[0],
            "tile_rel_rms": chk["flash_fwd_tiles"] if kernel == "flash_fwd" else err[1],
            "ms": ms[kernel], "plain_ms": plain_fwd if kernel == "flash_fwd" else plain_bwd,
            "bound_ms": bounds[kernel][0], "bound_by": bounds[kernel][1], "library_ms": library[kernel],
            "library_note": note + (" (its backward: dq, dk, dv)" if kernel != "flash_fwd" else ""),
            "shape": f"q [{b},{h},{tl},{d}] over k/v [{b},{hkv},{tl},{d}] ({name}), q_offset {q_offset}, "
                     f"window {kw['window']}, softcap {cap}",
        }
    del q, k, v, do, chk, o, lse, delta
    free_card()
    return rows


def _par_finetune(run: str, card: str, seconds: float) -> dict:
    """One PAR_TRAIN run's report from rank 0's log (:func:`parallel_worker`:
    the entry point's ``finetune.main`` on 2 ranks at 8 x 2048, PAR_STEPS
    steps, ``seconds`` of wall time): its first line must name gloo and
    both ranks on the card, its first-step loss must equal the single-rank
    run's (the same seed and flags, in this process, one step) within
    PAR_LOSS_RTOL, and its launches by form must be the ring's, Ulysses'
    or the flash call's."""
    model, layers, flags = PAR_TRAIN[run]
    lines = (PAR_DIR / f"train_{run}.log").read_text().splitlines()
    summary = json.loads([ln for ln in lines if ln.startswith('{"event": "summary"')][-1])
    if not lines[0].startswith("backend=gloo") or "1: 'cuda:0'" not in lines[0]:
        raise AssertionError(f"parallel finetune {run}: first line {lines[0]!r}")
    for line in lines:
        if line.startswith(("backend=", "model=", "step ")):
            log(f"  parallel finetune {run}: {line}")
    single = _par_single_first_loss(model, layers)
    rel = abs(summary["first_loss"] - single) / abs(single)
    if not rel <= PAR_LOSS_RTOL:
        raise AssertionError(f"parallel finetune {run}: first loss {summary['first_loss']} vs single rank {single}"
                             f" (rel {rel:.3g} > {PAR_LOSS_RTOL})")
    c = dataclasses.replace(llama.CONFIGS[model], n_layers=layers or llama.CONFIGS[model].n_layers)
    per = c.n_layers * PAR_STEPS  # flash layers x steps, each rank
    ring = flags[:2] == ["--sp", "2"] and "ulysses" not in flags
    for r, rank in enumerate(summary["by_rank"]):
        want = {f"{k}/causal": per for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        if ring and r == 1:  # the block of rank 0: non-causal; rank 0 skips rank 1's
            want.update({f"{k}/noncausal": per for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})
        if rank["launches_by_form"] != want:
            raise AssertionError(f"parallel finetune {run} rank {r}: launches {rank['launches_by_form']} != {want}")
    report = {"run": run, "model": model, "layers": c.n_layers, "flags": flags, "seconds": seconds,
              "first_loss": summary["first_loss"], "single_rank_first_loss": single, "rel": rel,
              "last_loss": summary["last_loss"], "median_step_s": summary["median_step_s"],
              "tokens_per_s": summary["tokens_per_s"], "mfu_per_rank": summary["mfu"], "mesh": summary["mesh"],
              "peak_memory_bytes_by_rank": [x["peak_memory_bytes"] for x in summary["by_rank"]],
              "launches_by_form": summary["launches_by_form"],
              "launches_by_form_all_ranks": _sum_counts([x["launches_by_form"] for x in summary["by_rank"]]),
              "card": card}
    log(f"parallel finetune {run} (2 ranks sharing one card over gloo, not a multi-GPU speed): "
        + json.dumps(report))
    return report


_SINGLE_FIRST: dict = {}


def _par_single_first_loss(model: str, layers) -> float:
    """The first-step loss of the single-rank run of the same seed and
    flags: the entry point's parameters (``--seed`` 0) and first
    synthetic batch through the step's objective in this one process,
    autograd off (the loss a step reports is its forward's, taken before
    its update; the mesh flags change no loss), cached by model and
    depth."""
    key = (model, layers)
    if key not in _SINGLE_FIRST:
        args = finetune._parser().parse_args(["--model", model, "--full"])
        with _layers(model, layers):
            c = llama.CONFIGS[model]
        params = llama.init_params(c, torch.Generator(device="cuda").manual_seed(args.seed), device="cuda")
        batch = finetune._synthetic_batch(0, args, c, torch.device("cuda"))
        with torch.no_grad():
            _SINGLE_FIRST[key] = float(train_step.objective(params, batch, c)[1][0])
        del params, batch
        free_card()
    return _SINGLE_FIRST[key]


@contextlib.contextmanager
def _layers(model: str, layers):
    """llama.CONFIGS[model] cut to ``layers`` (None: as it is) while the
    block runs."""
    full = llama.CONFIGS[model]
    if layers:
        llama.CONFIGS[model] = dataclasses.replace(full, n_layers=layers)
    try:
        yield
    finally:
        llama.CONFIGS[model] = full


def _sum_counts(counts: list) -> dict:
    out = collections.Counter()
    for c in counts:
        out.update(c)
    return dict(sorted(out.items()))


def _par_grad_parity(card: str) -> dict:
    """Each leaf's relative RMS error of the ranks' bf16 gradients on each
    PAR_PARITY_MESHES mesh against the single-rank f32 path, at most
    KERNEL_RMS_MARGIN times the single-rank bf16 kernel path's own (as
    :func:`grad_parity_phase` holds the kernel path to the plain one)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c, params, batch = _par_parity_inputs()
    loss = {}
    loss["kernel"], kernel = train_step.value_and_grad(train_step.full_loss, params, batch, c, None)
    p32 = train_step.tree_map(lambda w: w.float(), params)
    del params
    free_card()
    loss["f32"], f32 = train_step.value_and_grad(train_step.full_loss, p32, batch,
                                                 dataclasses.replace(c, dtype=torch.float32), "plain")
    del p32
    free_card()

    def flat(tree, prefix=""):
        out = {}
        for key in sorted(tree):
            out.update(flat(tree[key], f"{prefix}{key}/") if isinstance(tree[key], dict) else {prefix + key: tree[key]})
        return out

    def rel_rms(a, ref):
        return ((a.float() - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()

    kernel, f32 = flat(kernel), flat(f32)
    report = {"layers": c.n_layers, "loss": {k: float(v) for k, v in loss.items()}, "leaves": {}}
    for mname in PAR_PARITY_MESHES:
        got = torch.load(PAR_DIR / f"grads_{mname}.pt")
        for leaf, ref in f32.items():
            k_err, m_err = rel_rms(kernel[leaf], ref), rel_rms(got[leaf].cuda(), ref)
            report["leaves"].setdefault(leaf, {"kernel": k_err})[mname] = m_err
            if not m_err <= KERNEL_RMS_MARGIN * k_err:
                raise AssertionError(f"parallel gradient parity {mname}: {leaf} rel RMS {m_err:.4g} > "
                                     f"{KERNEL_RMS_MARGIN} x single-rank kernel {k_err:.4g}")
        del got
    log("parallel gradient parity (rel RMS vs the single-rank f32 path, per leaf; " + card + "): "
        + json.dumps(report))
    del kernel, f32
    free_card()
    return report


def parallel_phase(card: str) -> tuple[dict, dict, dict]:
    """The parallel package on the card (ROADMAP A6.1): PAR_RANKS ranks
    share it over gloo (NCCL refuses two ranks on one device). One torchrun
    spawn (:func:`parallel_worker`) runs (a) the ring and Ulysses at
    PAR_SHAPES, (c)'s mesh gradients and (b) the PAR_TRAIN fine-tunes;
    then, the card this process's alone, the ring's new kernel forms are
    timed (:func:`_par_form_row`), (c) the gradients held to the
    single-rank paths (:func:`_par_grad_parity`) and (b) each run's first
    loss to the single-rank run's (:func:`_par_finetune`). → (kernel rows,
    launch counts by path, the report)."""
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    PAR_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    log_path = PAR_DIR / "worker.log"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(PAR_RANKS), "--master-port",
           str(_free_port()), str(ROOT / "chip_smoke.py"), "--parallel-worker", str(PAR_DIR)]
    # torchrun would give each rank 1 thread: the ranks' host work (a
    # weights file's bf16 -> f32 conversion) may share the cores (8 on the
    # card's machine) up to 4 a rank
    threads = max(1, min(4, len(os.sched_getaffinity(0)) // PAR_RANKS))
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    # the windowed ring rows' flex_attention yardsticks compile beside the
    # ranks (a few GB of the card), so the timed calls below load them
    start_flex_warm(("ring",))
    with open(log_path, "w") as log_f:
        rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=log_f, stderr=subprocess.STDOUT,
                            timeout=600).returncode
    wait_flex_warm()
    if rc != 0:
        raise RuntimeError(f"parallel worker exited {rc}:\n{log_path.read_text()[-6000:]}")
    ranks = [json.loads((PAR_DIR / f"rank{r}.json").read_text()) for r in range(PAR_RANKS)]
    log(f"parallel worker ({time.perf_counter() - t0:.1f} s with start-up; {card}): "
        + json.dumps({"forms": ranks[0]["forms"], "counts_by_rank": [r["counts"] for r in ranks],
                      "seconds": ranks[0]["seconds"], "train_seconds": ranks[0]["train_seconds"],
                      "peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks]}))
    # the driven run's launches: every shape's ring and Ulysses, both ranks
    ring_counts = _sum_counts([c for r in ranks for c in r["counts"].values()])
    rows = {}
    for form, (name, _) in PAR_FORMS.items():
        main = _par_form_row(form, name)
        extra = _par_form_row(form, PAR_FORM_EXTRA[form])
        for kernel, row in main.items():
            rows[f"{kernel}_ring_{form}"] = {**row, "also": extra[kernel]}
    parity = _par_grad_parity(card)
    train = {run: _par_finetune(run, card, ranks[0]["train_seconds"][run]) for run in PAR_TRAIN}
    by_path = {"parallel_ring_ulysses": ring_counts,
               **{f"parallel_train_{run}": t["launches_by_form_all_ranks"] for run, t in train.items()}}
    return rows, by_path, {"parity": parity, "train": train}


# the flex warm-up processes' parts: each process compiles its parts'
# flex_attention graphs (the embeddings reach flex at gemma-3-4b's D = 256;
# "ring", started by parallel_phase beside its ranks: the ring's windowed forms)
WARM_PARTS = {"gemma": ("gemma", "embed"), "gemma_bwd": ("gemma_bwd",), "ring": ("ring",)}
_WARM: list = []  # the flex warm-up processes, once started


def warm_flex(which: str) -> None:
    """A flex warm-up process's work: the kernel parts WARM_PARTS[which]
    (of ``gemma_kernel_phase``, ``gemma_backward_kernel_phase`` and
    ``embed_kernel_phase``, the parts that call the compiled
    ``flex_attention``), run once with nothing timed (WARM_ONLY), so that
    each flex graph they compile lands in Inductor's and Triton's caches
    in the checkout (TORCHINDUCTOR_CACHE_DIR, TRITON_CACHE_DIR, set by
    :func:`main`). The main process makes the same calls after the
    servers and loads them from there instead of compiling them again."""
    global WARM_ONLY
    WARM_ONLY = True
    # the other families' rows are made by parts this process skips
    rows = collections.defaultdict(lambda: {"max_abs_err": 0.0})
    fns = {"gemma": gemma_kernel_phase, "gemma_bwd": gemma_backward_kernel_phase,
           "embed": lambda: embed_kernel_phase(rows),
           "ring": lambda: [_par_form_row("offset", name) for name in (PAR_FORMS["offset"][0],
                                                                      PAR_FORM_EXTRA["offset"])]}
    for part in WARM_PARTS[which]:
        with phase(f"warm_{part}"):
            fns[part]()
    log(f"peak reserved bytes {torch.cuda.max_memory_reserved()}")


def start_flex_warm(names=("gemma", "gemma_bwd")) -> None:
    """Start :func:`warm_flex` in one process for each of ``names``, keys
    of WARM_PARTS (the output of each in
    ``build/chip_smoke_flex_warm_<which>.log``)."""
    for which in names:
        with open(ROOT / "build" / f"chip_smoke_flex_warm_{which}.log", "w") as log_f:  # the child keeps its own
            _WARM.append((which, subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.warm_flex({which!r})"],
                cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT)))
    log(f"flex warm-up processes started: {list(names)}")


def wait_flex_warm() -> None:
    """Wait for the flex warm-up processes. A failure costs time only:
    the main process then compiles what it finds missing."""
    for which, proc in _WARM:
        if proc.returncode is not None:
            continue
        t0 = time.perf_counter()
        try:
            rc = proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(timeout=30)
        text = (ROOT / "build" / f"chip_smoke_flex_warm_{which}.log").read_text()
        log(f"flex warm-up [{which}] exited {rc} after {time.perf_counter() - t0:.1f} s of waiting: "
            + json.dumps({"parts_s": re.findall(r"\[phase\] (warm_\w+): ([\d.]+) s", text),
                          "peak_reserved_bytes": re.findall(r"peak reserved bytes (\d+)", text)}))
        if rc != 0:
            log(f"flex warm-up [{which}] log tail:\n" + text[-4000:])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    # the compiled library yardstick's caches stay in the checkout, where
    # the flex warm-up process fills them for this one (the FX graph and
    # the AOTAutograd caches on), and Inductor compiles in the process
    # that asks (no worker pool to stop)
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    for var, value in (("TORCHINDUCTOR_COMPILE_THREADS", "1"), ("TORCHINDUCTOR_FX_GRAPH_CACHE", "1"),
                       ("TORCHINDUCTOR_AUTOGRAD_CACHE", "1")):
        os.environ.setdefault(var, value)
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    with phase("build"):
        seconds = cuda_build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (per source: {json.dumps(seconds)})")

    try:
        return _main(card, t_all)
    finally:
        stop_spawned()
        for _, proc in _WARM:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def _kernel_parts(parts, rows: dict) -> None:
    """Run each kernel part, its rows merged into ``rows`` and its seconds
    under its own key (PHASE_S "k_<part>")."""
    for part, fn in parts:
        with phase(f"k_{part}"):
            for name, row in (fn() or {}).items():
                rows.setdefault(name, {}).update(row)


def _main(card: str, t_all: float) -> int:
    with phase("kernels"):
        ptxas = ptxas_gate()
        rows = {}
        _kernel_parts((("k1_k4", kernel_phase), ("bwd", backward_kernel_phase),
                       ("gpt_oss", gpt_oss_kernel_phase), ("d128", d128_kernel_phase),
                       ("mla", mla_kernel_phase),
                       ("mla_h128", lambda: mla_kernel_phase(DEEPSEEK_V3, MLA_V3_SHAPES, "flash_fwd_d576_h128")),
                       ("mla_train", mla_train_kernel_phase), ("w8", w8_kernel_phase),
                       ("adam8", adam8_kernel_phase), ("d128_train", d128_train_kernel_phase),
                       ("d128_train_g9", lambda: d128_train_kernel_phase(STARCODER2, D128_G9_TRAIN_SHAPE, "_g9"))),
                      rows)
    free_card()  # the servers need the card's memory
    # the Gemma parts' flex_attention yardsticks compile in helper
    # processes while the servers run; the parts run after the servers
    start_flex_warm()
    serve = {}
    modes = list(SERVER_MODES)
    for mode, then in zip(modes, [*modes[1:], None]):
        if then == "qwen3moe":  # the largest pair on the card (69 GB): no other process beside it
            wait_flex_warm()
        with phase(f"server_{mode}"):
            serve[mode] = path_phase(mode, then)
    wait_flex_warm()
    with phase("kernels_d256"):
        _kernel_parts((("gemma", gemma_kernel_phase), ("gemma_bwd", gemma_backward_kernel_phase),
                       ("embed", lambda: embed_kernel_phase(rows))), rows)
    free_card()
    with phase("bench"):
        bench = bench_phase()
    free_card()
    with phase("sessions"):
        sessions = sessions_phase(card)
    soaks = {}
    for kind in ("chaos", "boot"):
        with phase(f"soak_{kind}"):
            soaks[kind] = soak_phase(card, kind)
    with phase("graphs"):
        graphs = graph_phase()
    with phase("family_engines"):
        family_engines = family_engine_phase()
    with phase("bench_w8_70b"):
        w8_bench = w8_bench_phase()
    teacher = {}
    for name, make, caches, prompt_len in (
        (MODEL, llama_tf_params, (None, "int8"), 300),
        (GPT_OSS, gpt_oss_tf_params, (None, "int8"), 300),
        (GEMMA3, lambda: gemma_tf_params(GEMMA3), (None, "int8"), GEMMA_TF_PROMPT),
        (GEMMA2, lambda: gemma_tf_params(GEMMA2), (None,), 300),
        (DEEPSEEK, deepseek_tf_params, (None,), 300),
        (GLM, lambda: family_tf_params(GLM), (None, "int8"), 300),
        *((name, lambda name=name: family_tf_params(name), (None,), 300) for name in FAMILY_TF),
        *((name, lambda name=name: family_tf_params(name), (None,), 300) for name in (MIXTRAL, QWEN_MOE, LLAMA4)),
        (COHERE2, cohere2_tf_params, (None,), 300),
        (DEEPSEEK_V3, lambda: deepseek_tf_params(DEEPSEEK_V3), (None,), 300),
        (W8_TF, lambda: (llama.CONFIGS[MODEL], quant.tree_to(w8_llama_tree(), DEVICE)), (None,), 300),
    ):
        with phase("teacher_forced"):
            c, params = make()
            for kv_quant in caches:
                teacher[f"{name}_{kv_quant or 'bf16'}"] = teacher_forced_phase(
                    c, params, kv_quant, prompt_len, greedy=name in D128)
            if name in (GPT_OSS, DEEPSEEK):
                decode_profile_phase(name, c, params)
            del params
            free_card()
    train = {}
    for run in TRAIN_RUNS:
        with phase(f"train_{run}"):
            train[run] = _finetune(run)
        if run == OPT8_RUN:
            with phase(f"train_{RESUME_RUN}"):
                train[RESUME_RUN] = resume_check(train[run])
    spawn_server(*WEIGHTS_SERVER)  # its start-up overlaps the export's checks
    with phase("export"):
        export = export_phase()
    with phase("server_weights"):
        weights_server = weights_server_phase()
    with phase("train_profile"):
        train_profile_phase()
    with phase("train_deepseek"):
        deepseek_train = deepseek_train_phase()
    with phase("train_8b_opt8"):
        train_8b = train_opt8_phase()
    with phase("train_starcoder2_opt8"):
        train_sc2 = train_opt8_phase(STARCODER2)
    with phase("grad_parity"):
        for name in GRAD_PARITY:
            grad_parity_phase(name)
    with phase("parallel"):
        par_rows, par_by_path, par = parallel_phase(card)
    rows.update(par_rows)

    # path → (its model, its launch counts)
    by_path = {
        **{f"serve_{mode}": (SERVER_MODES[mode][0], path["launches"]) for mode, path in serve.items()},
        "serve_weights": (MODEL, weights_server["launches"]),
        **{f"bench_{name}": (MODEL, counts) for name, counts in bench["launches"].items()},
        "sessions": (MODEL, sessions["launches"]),
        **{f"soak_{kind}": (MODEL, soak["launches"]) for kind, soak in soaks.items()},
        **{f"graph_{key}": (key.rsplit("_", 1)[0], report["launches"]) for key, report in graphs.items()},
        **{f"family_engine_{name}": (name, report["launches"]) for name, report in family_engines.items()},
        **{f"teacher_forced_{key}": (key.rsplit("_", 1)[0], report["launches"])
           for key, report in teacher.items()},
        **{f"train_{run}": (MODEL if run == RESUME_RUN else TRAIN_RUNS[run][0], summary["launches"])
           for run, summary in train.items()},
        "train_deepseek": (DEEPSEEK, deepseek_train["launches"]),
        "train_8b_opt8": (LLAMA_8B, train_8b["launches"]),
        "train_starcoder2_opt8": (STARCODER2, train_sc2["launches"]),
        "bench_w8_70b": (W8_70B, w8_bench["launches"]),
        # the parallel phase's paths count K1-K3 by form (flash.LAUNCHES_BY_FORM)
        **{path: ("parallel", counts) for path, counts in par_by_path.items()},
    }
    k1 = ("dstack_tpu_torch/csrc/flash_fwd.cu", "dstack_tpu/ops/flash.py:190", "flash_fwd")
    k4 = ("dstack_tpu_torch/csrc/flash_decode.cu", "dstack_tpu/ops/flash_decode.py:266")
    k2 = ("dstack_tpu_torch/csrc/flash_bwd_dq.cu", "dstack_tpu/ops/flash.py:467", "flash_bwd_dq")
    k3 = ("dstack_tpu_torch/csrc/flash_bwd_dkv.cu", "dstack_tpu/ops/flash.py:523", "flash_bwd_dkv")
    k1_mla = ("dstack_tpu_torch/csrc/flash_fwd_mla.cu", "dstack_tpu/ops/flash.py:190", "flash_fwd_mla")
    w8 = ("dstack_tpu_torch/csrc/w8_matmul.cu",
          "none: XLA folds the int8 cast into the dot, dstack_tpu/models/llama.py:1117")
    a8 = ("dstack_tpu_torch/csrc/adam8.cu",
          "none: XLA fuses scale_by_adam8's per_leaf, dstack_tpu/train/opt8.py:96", "adam8")
    d64 = (MODEL, GPT_OSS)  # the head_dim 64 models; Gemma's is 256
    meta = {  # kernel row → (source, replaces, its count in by_path, the models whose paths count)
        "flash_fwd": (*k1, (MODEL,)),
        "flash_fwd_gpt_oss": (*k1, (GPT_OSS,)),
        "flash_fwd_d256": (*k1, D256),
        "flash_fwd_d128": (*k1, D128),
        "flash_fwd_d576": (*k1_mla, (DEEPSEEK,)),
        "flash_fwd_d576_h128": (*k1_mla, (DEEPSEEK_V3,)),  # the same source's 64-head groups
        "flash_fwd_d192": (*k1, (DEEPSEEK,)),  # MLA training: K1-K3 at D = 192
        "flash_bwd_dq_d192": (*k2, (DEEPSEEK,)),
        "flash_bwd_dkv_d192": (*k3, (DEEPSEEK,)),
        "flash_bwd_dq": (*k2, d64),
        "flash_bwd_dkv": (*k3, d64),
        "flash_bwd_dq_d256": (*k2, D256),
        "flash_bwd_dkv_d256": (*k3, D256),
        "flash_bwd_dq_d128": (*k2, (LLAMA_8B,)),  # llama-3-8b's training: K2/K3 at D = 128
        "flash_bwd_dkv_d128": (*k3, (LLAMA_8B,)),
        # the dense families' training at G = 9 (starcoder2-7b's fine-tune)
        "flash_bwd_dq_d128_g9": (*k2, (STARCODER2,)),
        "flash_bwd_dkv_d128_g9": (*k3, (STARCODER2,)),
        **{name: (*k4, form, d64) for name, form in (
            ("flash_decode", "bf16_decode"),
            ("flash_decode_verify", "bf16_verify"),
            ("flash_decode_int8", "int8_decode"),
            ("flash_decode_int8_verify", "int8_verify"),
            ("flash_decode_sinks", "bf16_decode_sinks"),
            ("flash_decode_verify_sinks", "bf16_verify_sinks"),
            ("flash_decode_int8_sinks", "int8_decode_sinks"),
            ("flash_decode_int8_verify_sinks", "int8_verify_sinks"),
        )},
        **{name: (*k4, form, D256) for name, form in (
            ("flash_decode_d256", "bf16_decode"),
            ("flash_decode_verify_d256", "bf16_verify"),
            ("flash_decode_int8_d256", "int8_decode"),
            ("flash_decode_int8_verify_d256", "int8_verify"),
        )},
        **{name: (*k4, form, D128) for name, form in (
            ("flash_decode_d128", "bf16_decode"),
            ("flash_decode_verify_d128", "bf16_verify"),
            ("flash_decode_int8_d128", "int8_decode"),
            ("flash_decode_int8_verify_d128", "int8_verify"),
        )},
        # W8 on the int8 paths: llama-3.2-1b's server (its model's path) and
        # teacher-forced tree, mixtral-8x7b's engines, llama-3-70b's bench
        "w8_proj": (*w8, "w8_proj", (MODEL, W8_TF, MIXTRAL, W8_70B)),
        "w8_head": (*w8, "w8_head", (MIXTRAL, W8_70B)),
        "w8_experts": (*w8, "w8_experts", (MIXTRAL,)),
        # A8 on the opt8 runs: llama-3.2-1b's fine-tune and its resume,
        # llama-3-8b's and starcoder2-7b's
        "adam8": (*a8, (MODEL, LLAMA_8B, STARCODER2)),
        # the ring's new forms (the parallel phase: 2 ranks on the card)
        **{f"{k[2]}_ring_{form}": (k[0], k[1], f"{k[2]}/{form}", ("parallel",))
           for k in (k1, k2, k3) for form in PAR_FORMS},
    }
    kernels = []
    for name, (src, rep, count, models) in meta.items():
        counts = {p: n[count] for p, (m, n) in by_path.items() if n.get(count) and m in models}
        if not counts:
            raise AssertionError(f"{name} was launched on no path: {by_path}")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(counts.values()), "launches_by_path": counts,
            **{k: rows[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")},
            **{k: rows[name][k] for k in ("tile_rel_rms", "training_shape", "trainer_shape", "trainer_shapes",
                                          "train_shape_g9",
                                          "nsplit", "rows_per_block", "library_note", "window_0",
                                          "softcap_50", "shapes", "timing_floor_ms", "embeddings", "g1", "g5",
                                          "E", "M", "K", "N", "plan", "bf16_matmul_ms",
                                          "graph_replay_max_abs_err", "train_shape", "adamw_bf16_ms",
                                          "code_differ_share", "scale_max_rel_err", "shape", "also")
               if k in rows[name]},
            "ptxas": ptxas[src.rsplit("/", 1)[1][:-3]],
        })
        if name.endswith("_d128"):  # the forms this row's width runs
            kernels[-1]["ptxas_d128"] = {f: r for f, r in kernels[-1]["ptxas"].items()
                                         if "<128," in f or "<128>" in f}
    log("int8 weights: " + json.dumps({
        "plain_graph_step_host_ms": serve["w8"]["w8"]["plain_graph_step_host_ms"],
        "server_device_memory": serve["w8"]["w8"]["device_memory"],
        "llama-3-70b": {k: w8_bench[k] for k in ("value", "slots", "step_bound_ms", "bound_tokens_per_sec",
                                                  "ttft_ms_p50", "ttft_long_cold_ms", "ttft_prefix_hit_ms",
                                                  "peak_reserved_bytes", "peak_allocated_bytes")},
        "export": export}))
    log("training: " + json.dumps({
        "opt8_run": {k: train[OPT8_RUN][k] for k in ("median_step_s", "tokens_per_s", "mfu", "peak_memory_bytes",
                                                     "eval", "launches")},
        "resume": {k: train[RESUME_RUN][k] for k in ("start_step", "median_step_s", "eval", "launches")},
        LLAMA_8B: {k: train_8b[k] for k in ("batch", "median_step_s", "tokens_per_s", "mfu", "peak_memory_bytes",
                                           "param_bytes", "moment_bytes")},
        "gptoss_lora": {k: train["gptoss_lora"][k] for k in (
            "grad_accum", "median_step_s", "tokens_per_s", "mfu", "peak_memory_bytes", "first_loss", "last_loss",
            "launches")},
        STARCODER2: {k: train_sc2[k] for k in ("batch", "median_step_s", "tokens_per_s", "mfu", "peak_memory_bytes",
                                              "param_bytes", "moment_bytes", "launches")}}))
    log(f"phase seconds: {json.dumps(PHASE_S)}")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:  # a rank of parallel_phase, under torchrun
        parallel_worker(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
