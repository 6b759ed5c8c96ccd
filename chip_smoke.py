"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. the card (name, power limit) and the torch / CUDA versions;
2. build the hand-written kernels from ``pegainfer_tpu_torch/csrc`` (K1-K9,
   the bf16 weight streams, the int8 expert stream and the fp4 decode
   variants; one nvcc per source, all at once, sm_90a)
   and print ptxas's registers / shared memory / spills;

The bf16 weight streams (the TPU studies S2 and S1, at Qwen3-4B's shapes),
while the card is empty:

2a. stream_sum (bulk and ldg forms), gemv and layer_gemv against their plain
    versions (``gemv_stream_study.check``) at the gate_up-, lm_head- and
    qkv-like shapes, a ragged N and a ragged K; then the stream study's sweep
    (``pegainfer_tpu_torch/studies/gemv_stream_study.py``) over bytes a
    stage, stages and blocks an SM on the three shapes, W rotated over
    copies beyond 2 x L2, beside torch.sum and torch's GEMV in both layouts:
    the **read ceiling** (the best stream_sum form above L2, the median of
    its re-timings) and the records at the wrappers' defaults;
2b. gemv_chain, 36 layers of gate_up (3.59 GB), against its plain chain
    (``gemv_chain_study.check``: one layer, every layer on the kernel's own
    x, whole chains of 2 and 36 within twice the f32 plain chains' drift
    from f64), then the five chain forms (eager torch GEMVs, their CUDA
    graph, layer_gemv launches, their graph, gemv_chain), each with device
    and wall time;

The int8 expert stream and the fp4 decode variants (the TPU studies S3 and
S4, at DeepSeek-V4-Flash's expert shapes), on weights made on the card from
the seed:

2c. expert_gemv (convert and native forms, 16 / 32 / 64 rows a block) and
    expert_gemv_in_flight against their plain versions, each routed row to
    its own limit, the native form bit for bit
    (``expert_stream_study.check``: q int8 [256, 2048, 4096], 2.15 GB, at M
    12 with repeated experts and M 1; a ragged OUT of 2018; sums near 2^24),
    then the study's forms timed beside K6 and torch's bmm
    (``pegainfer_tpu_torch/studies/expert_stream_study.py``);
2d. fp4_variant_gemv (floor, bits_noscale, bits, arith x 16 / 32 / 64 rows)
    against their plain versions, row by row (``fp4_kernel_study.check``:
    q uint8 [256, 2048, 2048] and bf16 scales, 1.2 GB; the same cases;
    bits and arith weight for weight), the scale loads of floor and
    bits_noscale counted in the SASS, then the sweep beside K3 and its bmm
    (``pegainfer_tpu_torch/studies/fp4_kernel_study.py``);

Qwen3-4B bf16 (full width and depth, random weights from a seed):

3. hold K1 and K2 against their plain versions at the main path's shapes
   (bf16 tolerances of the JAX package's kernel tests: 3e-2 decode, 2e-2
   prefill);
4. serve through ``start_engine_from_params`` -> ``EngineHandle.submit``
   (with ``OLD_DEFAULTS``: no chunks, no prefix cache, as in phases 11, 14,
   17 and 20, which were written before the defaults became the JAX
   engine's; and, as in every Qwen3 phase up to 8h, ``EAGER``: the decode
   step eager, not graphed):
   one greedy 1024-token prompt with 256 output tokens, then two shorter
   requests at once so decode runs at batch 2;
5. every request must end in ``Finished`` with its full token count;
6. the launch counters must equal 36 x prefills (K2) and 36 x decode steps
   (K1);
7. the 1024-token prefill's last logits with the kernels against the same
   model with the plain attention: max |diff| <= LOGITS_RTOL x max |logit|,
   and the argmax agrees unless the plain run's top-2 gap is below the diff;
8. timings: TTFT and TPOT of the 1024/256 request, a torch.profiler step
   profile, and each kernel's time against its bound, its plain version and
   a library call (SDPA for both; K1 also at K1_SHAPES).

Chunked prefill, the prefix cache and the fused mixed step, on the same
weights:

8a. a second engine with ``CHUNK_OPTS`` (the JAX engine's defaults: pieces
    of 2,048, of 256 under decode load, the prefix cache on): 300/192 and
    500/192, then 4,096/16 once both have decoded a token, then 4,096/16
    again alone; every request ends in ``Finished`` with its count;
8b. the cold prompt ran as 16 fused pieces of 256 rows with 2 decode rows
    each, the warm one hit 4,032 cached tokens; launches equal 36 x (whole
    prefills + pieces) K2 and 36 x (decode steps + fused pieces) K1;
8c. logits under rule 7: the cold chunked prompt against one whole
    prefill, the warm hit against the cold, one ``mixed_chunk`` against
    ``prefill_chunk`` + ``decode`` apart on a copy of the pool and against
    ``plain_kernels=True``; a torch.profiler profile of a fused piece, a
    chunk piece and the per-layer k/v gather alone;
8d. cold and warm TTFT, the streams' largest token gap during the cold
    prefill against a piece's wall time, and K2 at K2_CHUNK_SHAPES against
    its bound, its plain version and masked SDPA. The engine, weights and KV
    pool are then freed;
8e. PD handoff (``engine/pd.py``): two ``TorchExecutor``s of PD_PAGES pages
    on the same weights; B's allocator churned by a throwaway request; a
    greedy 1024/16 request that A has run alone is prefilled and exported
    by A (16 pages, 151.0 MB, to the host) and imported by B, which decodes
    it: the tokens equal A's own run, the last step's logits by rule 7;
    the payload's bytes and the export and import walls;
8f. int8 weight-only Qwen3-4B: ``start_engine_from_params(quantize="int8")``
    with ``OLD_DEFAULTS`` on a shallow copy of the same bf16 weights (the
    engine quantizes its copy; bytes before and after): 64/4, the greedy
    1024/256 request, then SHORT at once; every request ``Finished``;
    launches of the int8 linear kernel (``ops/cuda/int8_linear.py``) = 145
    (4 a layer: wq / wk / wv in one, wo, w_gate_up, w_down; and the head) x
    the decode steps within ``quant.INT8_GEMV_ROWS`` + 1 a prefill (the head
    on the prompt's last row), K6 none, K1 / K2 as phase 6; the prefill's
    last logits and one B = 2 decode step against ``plain_kernels=True``
    (rule 7); the cosine of the int8 prefill logits with the bf16 model's
    (reported beside the JAX package's 0.999); TTFT, TPOT and a B = 1 decode
    step's profile (the kernel's share, the op count) beside phase 8's bf16
    step;
8g. the int8 linear kernel on [8f]'s int8 weights
    (``int8_linear_study.sweep_forms``) at each launch of a decode step
    (the wq / wk / wv group, wo, w_gate_up, w_down, the head) and 1-64
    rows, each row against its plain version (outputs NaN-filled first),
    then beside K6 at one expert with its multiply and cast, bf16 ``x @
    w``, the JAX form (``quant.int8_mm``), ``torch._weight_int8pack_mm``
    and its plain version; a decode step's sums and the gates (below the K6
    route, below bf16 ``matmul``, within 2x the measured bound) by row
    count; K6 at one expert, off the path now, still against its plain
    version (``k6_study.dense_check``) and timed alone at w_gate_up;
8h. echo under CHUNK_OPTS (bf16): a 4,096-token prompt alone (cached), then
    the CHUNK_STREAMS decoding and the prompt as an echo request with
    logprobs=1: ``PromptTokens`` first, 16 plain pieces, none fused, no
    cache lookup; its prompt logprobs within 2 x LOGITS_RTOL x max |logit|
    of a whole all-logits prefill's; an echo request without logprobs gets
    ``PromptTokens`` with all None;
8i. the host profile of the eager decode step: B = 1 at context 1,025
    through ``TorchExecutor.execute_decode`` (its own pool, a whole prefill
    of phase 4's prompt first), bf16 and int8: the step's wall split into
    the batch assembly with its host-to-device copies, the forward's
    dispatch, the wait at the token read and the logprobs; the forward once
    under ``torch.cuda.set_sync_debug_mode("error")``; device time,
    operations and idle share (torch.profiler, CUDA activity) and the top
    host ops by self time (CPU activity); phase 4's TPOT p50 beside its
    ``execute_decode`` wall p50 gives the time a step the scheduler adds;
8j. Qwen3's decode step under CUDA graphs: engines under the graph defaults
    (``OLD_DEFAULTS`` otherwise), their B ladder captured at start at width 8
    (count, seconds, the pool's bytes): in bf16 phase 4's prompts (warm-up,
    1024/256, SHORT at once), whose greedy tokens must equal phase 4's, with
    K1 = 36 x decode steps and K2 = 36 x prefills through the replays'
    accounting; in int8 (``quantize="int8"``) phase 8f's, equal to 8f's
    tokens, with the int8 linear kernel 145 x decode steps + 1 a prefill (K6
    none); TTFT, TPOT p50 /
    p95, the ``execute_decode`` wall, the graphs captured at first use and
    the token gaps that held one; the allocated memory back within the
    pool's bytes after shutdown; then 8i's step measurement on the graphed
    step in both modes (device time, idle share, the graph's replay alone on
    CUDA events);
8k. on the first BLOCK_LAYERS = 12 layers at full width (to keep the smoke
    within its limit beside [29]): decode blocks under the JAX defaults,
    graphed, bf16 and int8, against the one-token eager engine's tokens at
    that depth (``block_oracles``: [4]'s and [8f]'s prompts) and an eager
    block engine (``block_phase``).

Checkpoints and the serving entry point, on the same Qwen3-4B weights after
the block phases:

26a. the weights cut to CKPT_LAYERS layers at full width (1.18 GB, tied
    embedding) written by the smoke's own safetensors writer as an HF
    checkpoint (config.json, two shards and model.safetensors.index.json)
    into a temporary directory: the port's reader gives every tensor back
    bit for bit, so do the stacked leaves and ``start_engine(path)``'s
    engine; its 64/16 greedy tokens equal ``start_engine_from_params``'s on
    the same tensors; the load's wall time and GB/s (warm page cache);
26b. ``python3 -m pegainfer_tpu_torch.server.main --sim --port 0`` in a
    process of its own: /health, a blocking and a streamed completion with
    ``http.client``, then SIGINT; the exit code must be 0;
26c. ``OpenAIApp`` on ``httpd.serve`` in front of Qwen3-4B at full depth,
    the engine's options ``load_options`` of the CLI's defaults with
    ``--max-num-pages`` HTTP_PAGES, the tokenizer ``SimTokenizer`` (token-list
    prompts; the ``tok<id>`` text gives the ids back): /health, /v1/models,
    the blocking 1024/256 request with logprobs 1 (its ids equal phase 4's,
    as [8j]'s graphed engine's do), the same request streamed (its text
    equals the blocking text; finish "length", ``data: [DONE]`` last) and on the
    handle, each after the prefix cache is emptied (a miss, as the first),
    and blocking again (its wall beside the handle's), then streamed again
    (a hit: its tokens against the miss's, and its first logits against
    the miss's by rule 7, reported), an
    echo request with logprobs (its prompt logprobs equal a
    handle-submitted echo request's), a stop string that
    cuts the text, two concurrent streams HTTP_PAIR (their tokens against
    B = 1 handle runs reported), a prompt too long for the pool and a bad
    JSON body (400 each), /metrics counting what was sent; K2 = 36 x (whole
    prefills + pieces), K1 = 36 x (tokens computed + fused pieces); TTFT,
    gaps and wall at the client beside the handle's.

Tensor parallelism, last on the Qwen3 weights (``parallel/``): two ranks
on the one card (``device_ordinals=[0, 0]``: the device group is gloo,
through the host), eager (``precompile=False``), ``OLD_DEFAULTS``; it
checks the sharded path at full width and measures no TP speed:

29a. K1 and K2 at one rank's heads (Hq / Hkv 16 / 4): timed beside their
    bounds, plain versions and SDPA (K1 at contexts 1,152 and {1,088,
    532}; K2 at T = S = 1,024 and a 256-row chunk at q_offset 1,024), and
    phase 3's checks at those heads; the int8 linear kernel at Qwen3-4B's
    TP 2 and TP 4 shards (``int8_linear_study.tp_launches``; wo and w_down
    through its f32-output epilogue) at 1, 8, 16, 64 rows, each row
    against its plain version, timed beside its bound, the plain version
    and bf16 ``torch.mm``;
29b. bf16 through ``start_engine_from_params(..., tp_size=2)``: TP_MAIN
    (1024/64), then TP_PAIR (300/32 + 500/32) at once, on phase 4's prompts
    (drawn again, ``tp_prompts``); every request ``Finished``; rank 0's K1
    / K2 launches and each rank's (read back
    from the workers, ``rank_stats``) equal 36 x decode steps / 36 x
    prefills, every rank's counters equal, 2 x 36 + 1 collectives a
    forward; rank 0's 1,024-token prefill logits and one B = 2 decode step
    (``tp_decode_logits``, on the idle engine) against the one-process
    port's by rule 7, the fraction printed; the streams equal phase 4's
    one-process eager ones up to the first step whose one-process top-2
    gap is within the measured diff; no worker alive after the shutdown; the
    backend, each rank's parameter bytes, TTFT, TPOT p50 and the seconds;
29c. [29b] in ``quantize="int8"`` on [8f]'s prompts and streams (quantized
    in rank 0 before the split; the int8 linear kernel 145 x decode steps +
    1 a prefill on each rank).

The Qwen3.5 hybrid at the JAX package's ``qwen35.bench_config()`` (32
layers: 8 groups of 3 Gated Delta Net layers and 1 gated full-attention
layer, hidden 2048; full width and depth), random bf16 weights made on the
card from the seed, run after the Qwen3 engines are freed; as in phases
4-8h, every hybrid phase but 25g passes ``EAGER`` (its tokens are 25g's
oracle), and so does every DeepSeek-V4 phase below but 13a and the graphed
phases 13g and 18g:

19. hold K1 and K2 against their plain versions at its full-attention heads
    (Hq 16, Hkv 2, hd 256) by phase 3's per-row rules: K2 at T 1,024 and a
    ragged 300, K1 at B 1 and context 1,025 and at contexts {300, 500, 200}
    padded to the batch bucket 4 by a dead row (exactly 0);
20. serve through ``qwen35_engine.start_engine_from_params`` with 2 state
    slots and the pool sized by ``compute_num_pages``: a 64/4 warm-up, the
    greedy 1024/256 request, then 300/64, 500/64 and 200/16 at once; every
    request ends in ``Finished`` with its count, the third is prefilled only
    after a slot frees, the first two decode at B = 2; launches equal 8 x
    prefills (K2) and 8 x decode steps (K1);
21. the 1,024-token prefill's last logits, and one decode step at B = 3
    with a dead row from the concurrent prompts' prefilled slots, with the
    kernels against ``plain_kernels=True`` (rule 7, row by row); TTFT and
    TPOT of 1024/256; a torch.profiler profile of one prefill and one B = 1
    decode step (K2's and K1's device time in them) and of the GDN ops
    alone at the model's shapes; K1 at hd 256 against its bound, plain
    version and SDPA.

Chunked prefill, the fused mixed step and the hybrid prefix cache (state
snapshots), on the same weights:

22. K2 at the hybrid's chunk shapes ``Q35_K2_CHUNK_SHAPES`` (Hq 16, Hkv 2,
    hd 256 at a query offset) against its plain version by phase 3's
    per-row rule, and its time against its bound, its plain version and
    masked SDPA;
23. a second engine with ``CHUNK_OPTS`` and ``Q35_CHUNK_SLOTS`` state
    slots: 300/192 and 500/192, then 4,096/16 once both have decoded a
    token, then 4,096/16 again alone, then the prompt extended by
    ``Q35_CHUNK_EXT`` new tokens; every request ends in ``Finished`` with
    its count; the cold prompt ran as 16 fused pieces of 256 rows with 2
    decode rows (the last, at 3,840, after the fine tail), kept snapshots
    at 3,840 and 4,096, and the two later prompts hit 3,840 and 4,096
    cached tokens, each re-running one piece; launches equal 8 x (whole
    prefills + pieces) K2 and 8 x (decode steps + fused pieces) K1;
24. logits under rule 7: the cold prompt's against one whole ``prefill``
    of it, the warm hit's against the cold's, the extended prompt's against
    a whole prefill of it, each with its share of the limit;
25. cold, warm and extended TTFT, the streams' largest token gap during the
    cold prefill against a piece's wall time, and a torch.profiler profile
    of the last fused piece (K2's and K1's device time in it), of its GDN
    ops alone and of its k/v gather alone;
25a. PD handoff as in 8e between two ``HybridExecutor``s of 2 slots and
    PD_PAGES pages: the payload is 16 pages (16.8 MB) and the slot's
    recurrent and conv rows (53.5 MB), imported on B's other slot;
25b. [8f] and [8g] on the hybrid: the int8 linear kernel 129 (4 a layer:
    a GDN layer's wq / wk / wv / wz in one launch, a full layer's wq /
    wgate / wk / wv in one, the out projection and the MLP's two; and the
    head) x the decode steps within the cut + 1 a prefill, K6 none, the
    concurrent requests on its 2 slots (the third waits);
25g. the hybrid's decode step under CUDA graphs: engines under the graph
    defaults (``OLD_DEFAULTS`` otherwise, 2 slots), their B ladder captured
    at start at width 8, in bf16 on [20]'s traffic (tokens equal [20]'s)
    and in int8 on [25b]'s (tokens equal [25b]'s), with K1 = 8 x decode
    steps, K2 = 8 x prefills and the int8 linear kernel 129 x decode steps
    + 1 a prefill (0 in bf16; K6 none) through the replays; TTFT, TPOT p50 / p95 against the eager
    run's (the graphed p50 must lie below the eager p50 by more than the
    eager p50-p95 spread), captures at first use, the pool's bytes, the
    memory back after shutdown; [8i]'s step measurement on a 1-slot
    executor, eager (its forward under sync-debug "error" first) and
    graphed;
25c. [8h] on the hybrid (3 slots). The engines, weights and state are then
    freed.

DeepSeek-V4-Flash, 8 layers at full width, random resident fp8 / packed-fp4
weights made on the card from the seed:

9. build the weights (about 33 GB);
10. hold K3, K4 and K5 against their plain versions on the model's weights
    at the path's shapes and at ragged cases (K4 at the seven shapes of a
    decode step at M = 1, 2 and 8; K3 at M 1, 6 and 12 with repeated
    experts, B = 2's shared experts and ids -1 and E, whose rows must be
    exactly 0; skewed routing with empty experts, segments across tiles, a
    tile of 56 rows; K3 and K5 also with w1's scales given random bf16
    mantissas), K5 each row within GROUPED_ROW_RTOL of its max |ref|;
11. serve through ``dsv4_engine.start_engine_from_params`` (2 slots,
    max_model_len 2048): a 16/4 warm-up, the greedy 1024/64 request, then
    300/32, 500/32 and 200/16 at once;
12. every request ends in ``Finished`` with its count; the third concurrent
    request is prefilled only after a slot frees, and the first two decode
    at B = 2; launches equal 24 x prefills (K5), 24 x decode steps (K3) and
    59 x decode steps (K4); the 1024-token prefill's last logits, and one
    decode step after it from the plain prefill's caches, with the kernels
    against ``plain_kernels=True``, the kernel run routed as the plain run
    (same rule as 7, DSV4_LOGITS_RTOL);
13. timings: TTFT and TPOT of the 1024/64 request, a torch.profiler step
    profile of one prefill and one B = 1 decode step (K4's and K3's device
    time in it), and K3-K5 against their bounds, plain versions and a library call
    each (bmm, matmul, grouped_mm on bf16 weights); K3 at w1 and w2 at B = 1
    and at B = 2's shared routing, and its sum over a B = 1 step's launches;
    K4 at each of the seven shapes of a decode step and their sum over the
    step's launches; K5 at
    w1, at w2 and at skewed routing, each beside one grouped_mm, and its
    plan's time.

DeepSeek-V4's slot prefix cache and PD handoff, on the same weights:

13g. DeepSeek-V4's decode step under CUDA graphs, [25g] for DSv4 on phase
    11's traffic (each bucket captured at first use, no ladder): fp4 with
    the chain off against [11]'s eager run (K3 = 24 and K4 = 59 x decode
    steps through the replays), then with ``moe_chain=True`` against an
    eager run of the same traffic here (K9 = 8 x decode steps, no K3);
13a. an engine under the defaults (``EngineLoadOptions(max_batch_size=2,
    max_model_len=2048, seed=SEED)``: the slot prefix cache on, chunks of
    2,048, the decode step as CUDA graphs) serves, one after another, (a) P (1,024 tokens) / 16 with
    logprobs (a miss, a fresh prefill, a snapshot kept with its logits),
    (b) P / 16 greedy (a hit that skips the forward: no K5 launch, (a)'s
    tokens), (c) P + 16 new tokens (a hit resumed through 16 replays of
    the B = 1 graph), (d) P + 128 other new tokens (a hit past the threshold of 72:
    a fresh prefill); every request ends in ``Finished`` with its count;
    hits 3, misses 1; launches K5 = 24 x fresh prefills, K3 = 24 x (decode
    steps + 16) and K4 = 59 x (decode steps + 16), and inside the
    resume, read from the counts around each of the executor's resumes, K3
    = 24 x 16 and K4 = 59 x 16; the TTFTs;
13b. (c)'s resume on the model: ``slot_export`` of the slot that prefilled
    P, ``slot_import`` into the other slot and ``prefill_resume`` of the
    16 tokens give, bit for bit, the logits of 16 ``decode`` steps on the
    original slot, and the resume launches K3 24 x 16 and K4 59 x 16
    times; ``snapshot_bytes`` is the rows' sum (6,413,056 B); the
    resumed logits against one whole prefill of P + 16, reported as a
    share of rule 7's limit with the argmax (not gated: decode and prefill
    run other kernels); the same resume through a ``SlotExecutor``'s B = 1
    graph (captured first) on a state of its own: its first token and slot
    rows equal the eager resume's, K3 / K4 through the replays; the
    resume's ms a token eager and graphed, one fresh prefill's and the
    crossover suffix below which each resume is faster, beside the JAX
    threshold ``max(32, T // 16)`` (kept);
13c. PD handoff as in 8e between two ``SlotExecutor``s: the payload is the
    slot's rows (6.41 MB), imported on B's other slot; the tokens and the
    last step's logits equal A's own run bit for bit;
13d. an engine under the defaults serves P with logprobs, then P + 16 new
    tokens as an echo request with logprobs=1: no slot-cache lookup (hits,
    misses and resume steps unchanged), a fresh prefill with every row's
    logits, its snapshot kept with its last logits; its prompt logprobs
    against ``plain_kernels=True``'s [T, V] logits, that run routed as the
    engine's, by [8h]'s bound.

On the same weights, the opt-in fp4 chain and then the int8-experts mode:

14. K9 (the fused fp4 chain) against its plain version on one score-gated
    layer at M = 6, 12 (repeated experts) and 16 (one expert), in both
    perm13 forms (permuted copies of the layer's w1 / w3, freed after), each
    row within CHAIN_ROW_RTOL of its max |ref|; its timing at B = 1 and 2
    beside the chain-off sequence (K3, SwiGLU, K3, K3); the 300/32 + 500/32
    pair served with ``moe_chain=True`` (launches: L x decode steps K9, no
    K3, 3L x prefills K5); one decode step's logits, chain vs plain, under
    the plain run's routing, and that step profiled with the chain on and
    off;
15. requantize the experts to int8 through ``start_engine_from_params(
    quantize="int8-experts")``: time, bytes before and after, peak reserved
    memory, and the codes of one expert that differ from the host
    ``quantize_int8_stack`` (none expected);
16. K6, K7 and K8 against their plain versions on the model's int8 weights
    (K6 each row within INT8_GEMV_RTOL of its max |ref|, y NaN-filled
    first, at w1 / w2 / w3 and M 1, 6, 12, 18, 20 with distinct, repeated
    and B = 2's shared experts, 20 rows on one expert and ids -1 and E,
    whose rows must be exactly 0; K7 at phase 10's skews and tiles, each row
    within GROUPED_ROW_RTOL of its max |ref|; K8 at M = 1, 6, 12, 16);
17. serve phase 11's traffic in int8 (K7 prefill, K8 decode): Finished
    counts, the slot wait, B = 2, launches (3L x prefills K7, L x decode
    steps K8, 59 x decode steps K4, no K3 / K5 / K6), prefill and decode
    logits against the plain versions; then the 300/32 + 500/32 pair with
    ``moe_chain=False`` (3L x decode steps K6, no K8);
18. timings: TTFT and TPOT of the int8 1024/64 request, torch.profiler
    step profiles with the chain on and off (K4's and K6's device time in
    them), and K6-K9 against their bounds, plain versions and (K6, K7) a
    library call; K6 at w1 and w2 at M 1, 6, 12 and B = 2's shared 12 beside
    bmm (and matmul at M 1), and its sum over a chain-off step's launches;
    K7 at w1, at w2 and at skewed routing, each beside one grouped_mm, and
    its plan's time;
18g. [13g] in int8 under the default chain against [17]'s eager run (K8 =
    8 x decode steps, K7 = 24 x prefills through the replays).

DeepSeek-V4 from an mp8 checkpoint (``models/dsv4_weights.py``), between
[14] and [15] while the fp4 weights are whole, and after [18h] once they
are freed:

27a. [9]'s layers 2 and 3 (ratio 4 with the indexer and a hash gate, ratio
    128 with a score gate) as a 2-layer model (``num_hash_layers`` 1,
    ``compress_ratios`` [4, 128]) written by the smoke's own writer as the
    eight rank files ``mp8/model{r}-mp8.safetensors`` in the real dtypes
    (``F8_E4M3`` linears, ``F8_E8M0`` scales, packed ``F4`` experts, about
    10 GB; the temp directory's free space is checked first), then loaded
    by ``dsv4_engine.start_engine(path)``: every leaf bit for bit against
    [9]'s; the load's wall and GB/s (warm page cache), the process's peak
    and current RSS before and after, device bytes against ``params_bytes``;
27b. that engine (the defaults: graphs, decode blocks) serves 1024/64
    twice (the second warm: the first captures the block graphs) and 16/4,
    greedy: the ids equal an in-memory engine's on [9]'s sliced tree;
    launches K3 = 3 x 2 x decode steps, K4 = 15 x decode steps, K5 = 3 x 2 x
    prefills; then ``server/main.py::build_engine`` from the path behind
    ``OpenAIApp`` + ``httpd`` (``SimTokenizer``) answers 16/4 with the same
    ids;
27c. after [18h], with [9]'s weights freed: the resident tree loaded again
    and the bf16 mode (``quantize="bf16"``, about 29 GB) from the same
    files through ``start_engine``: load wall, GB/s, RSS, bytes; the 1,024
    prefill's last logits against the resident ones, the resident run's
    routing replayed (rule 7 with DSV4_LOGITS_RTOL); [27b]'s requests served
    in bf16 (no K3 / K4 / K5 launch) with their ids' agreement with [27b]'s
    (reported) and the warm steady TPOT beside [27b]'s fp4 one.

DeepSeek-V2-Lite at its published config (27 layers, the first dense, 64
routed experts top-6 and 2 shared, MLA with kv_lora_rank 512; full width
and depth), random bf16 weights made on the card from the seed (31.4 GB),
after every DSv4 tree is freed; no K1-K9 kernel is on its path (torch ops,
as the JAX package leaves the family to XLA):

28a. ``dsv2lite.start_engine_from_params`` under the JAX defaults (decode
    graphs and blocks, 2 slots, 4,096 latent rows a slot): 1024/256 twice
    (the second warm: TTFT, the JAX bench's steady TPOT and the p50 over
    16-token windows), then 1024/32 twice at once (B 2); an eager engine
    (``enable_cuda_graph=False``) serves 1024/32 and the pair, whose ids
    must equal the graphed ones bit for bit; the K1-K9 launches must be 0;
    captures, pool, latent state and peak device bytes;
28b. the MLA identity: one ``prefill(return_all_logits=True)`` over the
    prompt and the first DSV2_CHECK_IDS generated ids (materialized K/V,
    grouped experts): each row's argmax must be the next generated id
    (absorbed MLA over the latent cache, gathered experts), unless that
    id's logit lies within rule 7's limit of the row's max;
28c. one full-width MoE layer's gathered decode form (B 1, 2) and grouped
    form (T 16) against ``_moe_dense`` (all 64 experts in f32), each row
    to its limit (DSV2_GATHERED_ROW_RTOL, DSV2_GROUPED_ROW_RTOL), the
    allocator's free memory NaN-filled first;
28d. the dense layer 0 and one MoE layer at full width written by the
    smoke's writer as an HF checkpoint (config.json, model.safetensors):
    ``start_engine(path)``'s tree bit for bit against the cut, the load's
    GB/s and RSS, its ids (64/16, 16/4) equal to an in-memory engine's on
    the cut, then the CLI's ``build_engine`` behind ``OpenAIApp`` +
    ``httpd`` (``SimTokenizer``) answering 16/4 with the same ids.

The last lines are the kernels' JSON record (the weight streams, the S3 /
S4 kernels, K1-K9 and the int8 linear kernel, with [8g]'s and [25b]'s
sweeps under ``shapes``, ``steps`` and ``gates`` and K6 at one expert,
which it replaced, under ``replaced``; with the read ceiling, and the S3 /
S4 kernels, K3, K4, K6, the int8 linear kernel, K8 and K9 also
bound by their bytes over it as
``measured_bound_ms``; K1's and K2's launches on the chunked and the
Qwen3.5 paths; K3's and K4's launches inside 13a's resumes, read from
their counts, as ``launches_resume``; the Qwen3.5 serving and step
records under ``qwen35``, 13a-13b's under ``dsv4_cache``, 8e's, 25a's and
13c's under ``pd``; the graphed paths' launches as
``launches_graphed_path``, the hybrid's as ``launches_qwen35_graphed_path``,
[26c]'s as ``launches_http_path``, [26]'s record under ``serving``'s ``http``,
[27b]'s as ``launches_mp8_path`` and [27]'s record under ``dsv4_mp8``,
[28]'s under ``dsv2lite``, [29]'s under ``serving``'s ``tp`` (K1's, K2's and the int8
linear kernel's ``launches_tp_path`` and ``tp_shapes``);
25g's, 13g's and 18g's records under each family's ``graphs``), the card
line from nvidia-smi and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 1234
PAGE = 64
PROMPT, OUT = 1024, 256  # the main path's traffic
SHORT = ((300, 64), (500, 64))  # two concurrent requests: decode at B = 2
# K1 is also timed at the concurrent pair's contexts and at one long context
K1_SHAPES = ([300, 500], [8192])
DECODE_TOL, PREFILL_TOL = 3e-2, 2e-2
# phases 8a-8d: a second engine with the JAX engine's defaults for chunked
# prefill and the prefix cache (pegainfer_tpu/engine/contract.py); two
# streams decode while the long prompt arrives, then it comes again alone
# the phases written before decode blocks decode one token a dispatch and
# read it before the next (the JAX engine's defaults are blocks of 4, steady
# blocks of 16, depth 2: the block phases [8k], [25h], [13h], [18h]), so
# their numbers stay comparable with the runs before
ONE_TOKEN = dict(decode_block=1, decode_block_max=1, decode_pipeline_depth=1)
CHUNK_OPTS = dict(prefill_chunk=2048, prefill_chunk_mixed=256, enable_prefix_cache=True,
                  **ONE_TOKEN)
# phases 4, 11, 14, 17 and 20 were written when the port's defaults had
# chunked prefill and the prefix cache off; they keep those options
# explicitly, so they run exactly as before the defaults became the JAX
# engine's (CHUNK_OPTS)
WHOLE = dict(prefill_chunk=None, enable_prefix_cache=False)
OLD_DEFAULTS = dict(**WHOLE, **ONE_TOKEN)
# Qwen3's decode step runs as CUDA graphs under the defaults (precompile and
# enable_cuda_graph, as in the JAX engine); phases 4-8h keep the eager step
# explicitly, so their numbers stay comparable with the runs before the
# graphs and their tokens are [8j]'s oracle
EAGER = dict(enable_cuda_graph=False)
# [8k], [25h], [13h], [18h]: the JAX engine's decode-block defaults (blocks
# of 4, steady blocks of 16, depth 2; EngineLoadOptions' own), graphed, with
# WHOLE prompts as the one-token graphed phases whose tokens they are held
# to. After the main request: a pair whose second request is submitted
# right after the first's BLOCK_ARRIVAL_AT-th token (from the scheduler's
# thread, so the join is the same in every run), and for Qwen3 (first, on
# the fresh engine) a sampled stream beside a logprobs stream at B = 2; both
# held against an eager block engine (precompile=False) with the same seed.
# Qwen3's int8 mode serves the main request and the sampled pair only (its
# arrival pair's block graphs would add about 25 s of captures to the run)
BLOCK_PAIR = ((300, 192), (500, 192))
BLOCK_ARRIVAL_AT = 20
BLOCK_SAMPLED = ((300, 64), (500, 64))
BLOCK_SAMPLING = dict(temperature=0.8, top_k=20, top_p=0.9)
BLOCK_LOGPROBS = 5
# [8i] / [8j]: decode steps of one request at context PROMPT + 1 driven
# through TorchExecutor.execute_decode, STEP_ITERS timed after STEP_WARMUP;
# the host ops listed by self time
STEP_WARMUP, STEP_ITERS = 3, 20
TOP_HOST_OPS = 12
CHUNK_STREAMS = ((300, 192), (500, 192))
CHUNK_PROMPT, CHUNK_OUT = 4096, 16
# K2 at chunk shapes, (T, S, q_offset): the last fused piece of the 4,096
# prompt and the second of its two 2,048 chunks when it runs alone
K2_CHUNK_SHAPES = ((256, 4096, 3840), (2048, 4096, 2048))
# K1 is held row by row to min(DECODE_TOL, DECODE_RTOL x the row's max
# |ref|): a decode output averages n tokens' values and is about sqrt(e / n)
# in size (0.013 at 16,384), below a fixed 3e-2; 2e-2 of the row's largest
# output is about 2.5 bf16 ulps of it
DECODE_RTOL = 2e-2
# K2 likewise, each query row (position, head) to min(PREFILL_TOL,
# PREFILL_RTOL x the row's max |ref|): a late row of a 1,024-token prompt
# averages about a thousand values and is about 0.05 in size, so a fixed 2e-2
# passes a kernel that drops a key tile; a right kernel rounds p and the
# output to bf16 once, a fraction of a percent of the row's largest value
PREFILL_RTOL = 2e-2
# K2 is also timed at a long prompt at Qwen3-4B's heads and at Qwen3.5's
# full-attention heads (pegainfer_tpu/models/qwen35.py:285): (T, Hq, Hkv, hd)
K2_SHAPES = ((4096, 32, 8, 128), (1024, 16, 2, 256))
# bf16 activations through 36 layers: the kernels round where the f32 plain
# attention does not (its output is cast to bf16 once), and each layer's
# difference rides the residual stream to the logits
LOGITS_RTOL = 5e-2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12
TOP_OPS = 8  # device operations listed per profiled step, by device time
# the decode GEMVs whose device time a step profile picks out: (record
# name, kernel, the CUDA kernel's name)
STEP_KERNELS = (("fp8_gemv", "K4", "fp8_gemv_kernel"), ("moe_fp4_gemv", "K3", "fp4_gemv_kernel"),
                ("moe_int8_gemv", "K6", "int8_gemv_kernel"))

# DeepSeek-V4-Flash phases
DSV4_LAYERS = 8
DSV4_SLOTS = 2
DSV4_MAX_MODEL_LEN = 2048
DSV4_WARMUP = (16, 4)
DSV4_PROMPT, DSV4_OUT = 1024, 64  # scripts/dsv4_flagship_engine.py's defaults
DSV4_CONCURRENT = ((300, 32), (500, 32), (200, 16))  # the third waits for a slot
# K3 / K4 form the same exact f32 products as their plain versions, in
# another summation order (the JAX kernel tests' atol, on unit-RMS outputs)
QUANT_GEMV_TOL = 2e-5
# K4's linears in a decode step (models/dsv4.py), one of each shape
K4_STEP_KEYS = ("wq_a", "wq_b", "wkv", "wo_b", "shared_w1", "shared_w2", "idx_wq_b")
# the library yardsticks of K3, K5 and K7 round their products or outputs
# to bf16 (the JAX grouped test's 2e-2 of max |y|)
GROUPED_RTOL = 2e-2
# the kernel run is routed as the plain run (RoutingReplay); through 8
# random layers bf16 roundings of the activations (in both runs) turn the
# kernels' f32 sum-order differences into bf16-ulp differences; as for
# Qwen3, 5% of max |logit|
DSV4_LOGITS_RTOL = 5e-2
# int8 phases: K6 forms its plain version's exact f32 products in another
# order, on unscaled outputs of magnitude 1e4 (codes up to 127), so its
# tolerance is relative; the chains K8 / K9 round act to bf16, where an f32
# sum-order difference moves an element by one bf16 ulp now and then
INT8_GEMV_RTOL = 1e-5
CHAIN_RTOL = 2e-3
# K9 holds each row to CHAIN_ROW_RTOL of the row's max |ref|, and a row of an
# invalid expert id to exactly 0. A right kernel's products are exact and
# only their f32 sum order differs (its worst row at 6e-6 of its max on an
# H100, scripts/k9_study.py); an act element that this moves across a bf16
# rounding boundary moves y by one ulp of it times one weight, at most
# about 3e-4 of the row's max. One dropped product of act and w2, or one
# act channel lost, moves y by that element times a weight, 256 times the
# ulp (scripts/k7_mutant_check.py --kernel k9)
CHAIN_ROW_RTOL = 1e-3
# the grouped GEMMs K5 and K7 form the same exact f32 products as their
# plain versions on the tensor cores (K5 rounds each weight to bf16 once, as
# its plain version does), only summed in another order: each row within
# 1e-4 of the row's max |ref| (rows of about 1e4 for K7's unscaled codes,
# about 1 for K5); a row of zeros must be exactly 0. 2e-2 of the global max
# passes a kernel that drops one product of one row
# (scripts/k7_mutant_check.py [--kernel k5])
GROUPED_ROW_RTOL = 1e-4
DSV4_CHAIN_PAIR = ((300, 32), (500, 32))  # the chain-switch runs' traffic

# phases 13a-13b: DeepSeek-V4's slot prefix cache under the engine's
# defaults: P (DSV4_CACHE_PROMPT tokens) with logprobs, P again, P extended
# by DSV4_CACHE_EXT new tokens (resumed through that many decode steps), and
# P extended by DSV4_CACHE_FAR other new tokens (past the resume threshold
# max(32, T // 16) = 72: a fresh prefill); DSV4_CACHE_OUT tokens each
DSV4_CACHE_PROMPT, DSV4_CACHE_OUT = 1024, 16
DSV4_CACHE_EXT, DSV4_CACHE_FAR = 16, 128
# one slot's rows at DSV4_LAYERS and DSV4_MAX_MODEL_LEN (models/dsv4.py
# make_state: window ring, compressed rows, compressor rings), bf16 and f32
DSV4_SNAPSHOT_BYTES = 6_413_056
# phases 8e, 13c, 25a: PD handoff (engine/pd.py) of one greedy PD_PROMPT /
# PD_OUT request from executor A to executor B, against A's own run of it;
# the paged executors have PD_PAGES pages each
PD_PROMPT, PD_OUT = 1024, 16
PD_PAGES = 64
PD_OPTS = dict(enable_prefix_cache=False, **ONE_TOKEN)  # A's own run and the handoff prefill alike

# Qwen3.5 hybrid phases: the main request is PROMPT / OUT, as for Qwen3
Q35_SLOTS = 2
Q35_WARMUP = (64, 4)
Q35_CONCURRENT = ((300, 64), (500, 64), (200, 16))  # the third waits for a slot
# K1 at its decode shapes: B 1 at context 1,025, and the concurrent requests'
# contexts padded to the batch bucket 4 by a dead row; K2 at a whole prompt
# and a ragged one
Q35_K1_CASES = ([PROMPT + 1], [300, 500, 200, 0])
Q35_K2_T = (PROMPT, 300)
# phases 22-25: the hybrid under CHUNK_OPTS, 3 slots (two streams and the
# long prompt), CHUNK_STREAMS and CHUNK_PROMPT as for Qwen3, then the prompt
# extended by Q35_CHUNK_EXT new tokens (a multi-turn follow-up)
Q35_CHUNK_SLOTS = 3
Q35_CHUNK_EXT = 192
# K2 at the hybrid's chunk shapes, (T, S, q_offset): the cold prompt's last
# fused piece and the warm hit's piece; a lone prompt's second 2,048 chunk;
# the extended prompt's piece
Q35_K2_CHUNK_SHAPES = ((256, 4096, 3840), (2048, 4096, 2048),
                       (Q35_CHUNK_EXT, CHUNK_PROMPT + Q35_CHUNK_EXT, CHUNK_PROMPT))

# phases 2a-2b: the bf16 weight streams (S2, S1). The limits of their checks
# are the studies' (gemv_stream_study.check: stream_sum to 1e-5 of sqrt(N K)
# max |W|, a GEMV to 1e-5 of max |y|; gemv_chain_study.check for the chain).
CHAIN_L, CHAIN_N, CHAIN_K = 36, 19456, 2560  # Qwen3-4B's gate_up, 36 layers
# the GEMV kernels whose byte bound the measured read ceiling restates
MEASURED_BOUND_KERNELS = ("moe_fp4_gemv", "fp8_gemv", "moe_int8_gemv", "int8_linear",
                          "moe_int8_chain",
                          "moe_fp4_chain", "expert_gemv_convert", "expert_gemv_native",
                          "expert_gemv_in_flight", "fp4_variant_floor", "fp4_variant_bits_noscale",
                          "fp4_variant_bits", "fp4_variant_arith")
INT8_OPS = 1979e12  # H100 SXM dense int8 (NVIDIA data sheet)


T_START = time.perf_counter()  # a phase's header carries the seconds since


def log(msg: str) -> None:
    if msg.startswith("["):  # a phase's header: the seconds since the start
        msg = f"{msg}  (at {time.perf_counter() - T_START:.1f} s)"
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def qwen3_4b_config(q3):
    """Qwen3-4B (bench.py's config): the HF Qwen/Qwen3-4B config.json."""
    return q3.Qwen3Config(
        hidden_size=2560, intermediate_size=9728, num_hidden_layers=36,
        num_attention_heads=32, num_key_value_heads=8, head_dim=128,
        vocab_size=151936, rms_norm_eps=1e-6, rope_theta=1000000.0,
        tie_word_embeddings=True, eos_token_id=151645, stop_token_ids=(151645,),
        max_position_embeddings=40960,
    )


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call ``fn(i)``, by CUDA events over ``iters``
    calls, a device sleep ahead of the start event hiding the host's
    enqueue (``pegainfer_tpu_torch/studies/timing.py::device_ms``). Keep a
    window to a few hundred launches: more than the device's queue of
    pending launches would block the host until the sleep ends."""
    from pegainfer_tpu_torch.studies.timing import device_ms

    return device_ms(fn, iters, warmup)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ── phase 3: kernels against their plain versions ───────────────────────


def _pages_for(seq_lens, ps, first=1):
    tables, nxt = [], first
    P = max(1, max(-(-s // ps) for s in seq_lens))
    for s in seq_lens:
        n = -(-s // ps)
        tables.append(list(range(nxt, nxt + n)) + [0] * (P - n))
        nxt += n
    return tables, nxt


def decode_case(gen, cfg, seq_lens, form, layers=2):
    """Inputs of one paged-decode call at the main path's head shapes."""
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    tables, n_pages = _pages_for(seq_lens, PAGE)
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    pool = rnd(layers, Hkv, n_pages, 2, PAGE, hd)
    B = len(seq_lens)
    args = dict(
        q=rnd(B, Hq, hd),
        page_tables=torch.tensor(tables, dtype=torch.int32, device=dev),
        seq_lens=torch.tensor(seq_lens, dtype=torch.int32, device=dev),
        scale=hd ** -0.5,
    )
    if form in ("pool", "pool_cur"):
        args.update(k_pages=pool, v_pages=pool, layer_id=layers - 1)
    else:
        args.update(k_pages=pool[0, :, :, 0], v_pages=pool[0, :, :, 1])
    if form in ("layer_cur", "pool_cur"):
        args.update(cur_k=rnd(B, Hkv, hd), cur_v=rnd(B, Hkv, hd))
    return args


def row_err(out, ref, dims, tol, rtol):
    """max |diff| of a kernel to its plain version and the worst row's share
    of its limit, min(tol, rtol x the row's max |ref|), a row's values
    spanning ``dims``. A row whose limit is 0 must be exactly 0."""
    d = (out.float() - ref.float()).abs().amax(dim=dims)
    lim = torch.clamp(rtol * ref.float().abs().amax(dim=dims), max=tol)
    share = torch.where(d > 0, d / lim, torch.zeros_like(d))  # d > 0 at lim 0: inf
    return d.max().item(), share.max().item()


def decode_err(out, ref):
    """K1's error: each row (request) against min(DECODE_TOL, DECODE_RTOL x
    its max |ref|); a dead row must be exactly 0."""
    return row_err(out, ref, (1, 2), DECODE_TOL, DECODE_RTOL)


def prefill_err(out, ref):
    """K2's error: each query row (position, head) against min(PREFILL_TOL,
    PREFILL_RTOL x its max |ref|)."""
    return row_err(out, ref, 2, PREFILL_TOL, PREFILL_RTOL)


def grouped_err(out, ref):
    """K5's and K7's error: each row against GROUPED_ROW_RTOL x its max
    |ref| (no cap)."""
    return row_err(out, ref, 1, float("inf"), GROUPED_ROW_RTOL)


def check_kernels(cfg, pd, fp):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    errs = {"paged_decode": 0.0, "flash_prefill": 0.0}
    decode_cases = [
        ("B=1 ctx 1024, per-layer pages", [1024], "layer"),
        ("B=1 ctx 1024, pool + layer_id + cur", [1024], "pool_cur"),
        ("B=5 ragged {1,63,700,1280} + dead row, pool + layer_id", [1, 63, 700, 1280, 0], "pool"),
        ("B=5 ragged {1,63,700,1280} + dead row, pool + layer_id + cur",
         [1, 63, 700, 1280, 0], "pool_cur"),
        ("B=5 ragged + dead row, per-layer pages + cur", [1, 63, 700, 1280, 0], "layer_cur"),
        # long contexts (many pages a split), a row shorter than one split
        # beside a long one, and 64 rows (one split, no merge)
        ("B=2 ctx 8192 + dead row, pool + layer_id + cur", [8192, 0], "pool_cur"),
        ("B=1 ctx 16384, per-layer pages", [16384], "layer"),
        ("B=3 {40, 3000} + dead row, pool + layer_id + cur", [40, 3000, 0], "pool_cur"),
        ("B=64 ragged + dead row, pool + layer_id + cur",
         [(37 * i) % 900 + 1 for i in range(63)] + [0], "pool_cur"),
    ]
    for name, seq_lens, form in decode_cases:
        a = decode_case(gen, cfg, seq_lens, form)
        out = pd.paged_attention_decode(**a)
        torch.cuda.synchronize()
        ref = pd.paged_attention_decode_plain(**a)
        err, share = decode_err(out, ref)
        dead = [b for b, s in enumerate(seq_lens) if s == 0]
        dead_ok = all(out[b].abs().max().item() == 0.0 for b in dead)
        ok = share <= 1.0 and dead_ok and bool(torch.isfinite(out).all())
        log(f"  K1 paged_decode  {name}: max_abs_err {err:.3e}, worst row at {share:.3f} of "
            f"its limit min({DECODE_TOL}, {DECODE_RTOL} x max |ref|)"
            f"{' dead row 0' if dead else ''} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("paged decode kernel disagrees with its plain version")
        errs["paged_decode"] = max(errs["paged_decode"], err)

    # (name, T, S, kv_valid, q_offset, Hq, Hkv, hd)
    prefill_cases = [
        ("T=S=1024", 1024, 1024, 1024, 0, Hq, Hkv, hd),
        ("T=S=1000 (not a multiple of the query tile)", 1000, 1000, 1000, 0, Hq, Hkv, hd),
        ("chunk continuation T=256 at q_offset 768, S=1024", 256, 1024, 1024, 768, Hq, Hkv, hd),
        ("chunk T=256 at q_offset 768, kv_valid 1000 < S=1280", 256, 1280, 1000, 768, Hq, Hkv,
         hd),
        ("T=S=4096", 4096, 4096, 4096, 0, Hq, Hkv, hd),
        # the end of a 32k context: there a dropped key tile stays under 2e-2
        ("chunk T=64 at q_offset 32704, S=32768", 64, 32768, 32768, 32704, Hq, Hkv, hd),
    ] + [(f"T=S={T}, Hq {hq}, Hkv {hkv}, hd {d}", T, T, T, 0, hq, hkv, d)
         for T, hq, hkv, d in K2_SHAPES[1:]]
    for name, T, S, kv_valid, q_offset, hq, hkv, d in prefill_cases:
        q = torch.randn((T, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((S, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((S, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        out = fp.flash_attention(q, k, v, kv_valid, q_offset, d ** -0.5)
        torch.cuda.synchronize()
        ref = fp.att.causal_attention(q, k, v, kv_valid, q_offset, d ** -0.5)
        live = min(T, kv_valid - q_offset)
        err, share = prefill_err(out[:live], ref[:live])
        ok = share <= 1.0 and bool(torch.isfinite(out[:live]).all())
        log(f"  K2 flash_prefill {name}: max_abs_err {err:.3e}, worst row at {share:.3f} of its "
            f"limit min({PREFILL_TOL}, {PREFILL_RTOL} x max |ref|) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("flash prefill kernel disagrees with its plain version")
        errs["flash_prefill"] = max(errs["flash_prefill"], err)
    return errs


# ── phase 4: serve through the engine ───────────────────────────────────


def run_request(contract, handle, prompt, max_tokens, logprobs=0):
    """Submit one greedy request that ignores EOS. Returns (channel, submit
    time)."""
    ch = contract.TokenChannel()
    t0 = time.perf_counter()
    handle.submit(contract.GenerateRequest(
        prompt_tokens=prompt, max_tokens=max_tokens,
        params=contract.SamplingParams(ignore_eos=True), channel=ch, logprobs=logprobs))
    return ch, t0


def submit_together(contract, handle, reqs):
    """Submit ``reqs`` [(prompt, max_tokens)] so that the scheduler takes them
    in one drain, whatever the threads' timing: the interpreter's switch
    interval is raised while they are queued, so the scheduler thread cannot
    run between two submits (the batches, and so each row's roundings, are
    those of every run). Returns [(channel, prompt length, max_tokens)]."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(10.0)
    try:
        return [(run_request(contract, handle, p, m)[0], len(p), m) for p, m in reqs]
    finally:
        sys.setswitchinterval(old)


def drain(contract, ch, timeout_s=600):
    toks, times = [], []
    while True:
        ev = ch.get(timeout=timeout_s)
        if ev is None:
            raise SystemExit("no event from the engine within the time limit")
        if isinstance(ev, contract.Token):
            toks.append(ev.id)
            times.append(time.perf_counter())
        elif contract.is_terminal(ev):
            return toks, ev, times


def expect_finished(contract, label, toks, fin, want):
    ok = isinstance(fin, contract.Finished) and fin.completion_tokens == want \
        and len(toks) == want
    log(f"  {label}: {type(fin).__name__} {len(toks)}/{want} tokens "
        f"{'ok' if ok else 'FAIL ' + repr(fin)}")
    if not ok:
        raise SystemExit(f"request {label} did not finish with {want} tokens")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "pegainfer_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: pegainfer_tpu_torch/ is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))  # the checkout's package, not an installed one
    from pegainfer_tpu_torch.ops.cuda import build

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    build.load("paged_decode")  # builds every source, in parallel
    log(f"[2] kernels built and loaded in {time.perf_counter() - t:.1f} s")
    for name, text in build.build_logs.items():
        log(f"  --- ptxas: {name} ---")
        for line in text.splitlines():
            if "spill" in line or ("ptxas" in line and ("registers" in line
                                                        or "Compiling entry" in line)):
                log("  " + line.strip())

    s_records, read_ceiling, s_extra, layer_err = run_streams()
    ceiling = read_ceiling["bytes_per_s"]
    c_records, c_extra = run_chain(layer_err)
    gc.collect()
    torch.cuda.empty_cache()
    e_records, e_extra = run_expert_stream()
    gc.collect()
    torch.cuda.empty_cache()
    f_records, f_extra = run_fp4_study()
    gc.collect()
    torch.cuda.empty_cache()

    q_records, q_serving, q_steps = run_qwen3(ceiling)
    # the Qwen3 engine, weights and KV pool are gone with run_qwen3's frame
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  Qwen3 freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    h_serving, h_steps, h_launches, hc_launches, hc_shapes = run_qwen35(ceiling)
    for r in q_records:  # the hybrid's served paths' launches beside Qwen3's
        r["launches_qwen35_path"] = h_launches[r["name"]]
        r["launches_qwen35_chunked_path"] = hc_launches[r["name"]]
    next(r for r in q_records if r["name"] == "flash_prefill")["qwen35_chunk_shapes"] = hc_shapes
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  Qwen3.5 freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    cfg, params, d_records, d_serving, d_steps = run_dsv4()
    dsv4_cache, dsv4_pd, resume_launches = run_dsv4_cache(cfg, params)
    dsv4_cache["echo"] = run_dsv4_echo(cfg, params)
    for r in d_records:  # K3's and K4's launches inside [13a]'s resumes
        if r["name"] in resume_launches:
            r["launches_resume"] = resume_launches[r["name"]]
    k9_record, chain_serving = run_dsv4_fp4_chain(cfg, params)
    mp8_dir = tempfile.mkdtemp(prefix="pegainfer-mp8-")
    try:
        mp8 = run_mp8(cfg, params, mp8_dir)
        for r in d_records:  # [27b]'s launches from the checkpoint
            if r["name"] in mp8["launches"]:
                r["launches_mp8_path"] = mp8["launches"][r["name"]]
        i_records, i_serving, i_steps = run_dsv4_int8(cfg, params, k9_record)
        # [9]'s weights (int8 experts now) have no user left
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  DeepSeek-V4-Flash freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
            "allocated")
        mp8["bf16"] = run_mp8_bf16(cfg, mp8_dir, mp8)
    finally:
        shutil.rmtree(mp8_dir, ignore_errors=True)
    # DeepSeek-V2-Lite, once every DSv4 tree is gone
    gc.collect()
    torch.cuda.empty_cache()
    dsv2 = run_dsv2lite()
    linear = linear_record(q_serving["int8"], h_serving["int8"])
    # [8j]'s graphed paths: K1 / K2 in bf16, the int8 linear kernel in int8;
    # the hybrid's ([25g]) likewise; [8k]'s int8 block path
    h_graphs = h_serving["graphs"]
    linear["launches_graphed_path"] = q_serving["graphs"]["int8"]["launches"]["int8_linear"]
    linear["launches_qwen35_graphed_path"] = h_graphs["int8"]["launches"]["int8_linear"]
    linear["launches_block_path"] = q_serving["graphs"]["blocks"]["int8"]["launches"][
        "int8_linear"]
    # [29]'s int8 path at TP 2 (rank 0's launches) and the TP 2 / TP 4 shards
    linear["launches_tp_path"] = q_serving["tp"]["launches"]["int8_linear"]
    linear["tp_shapes"] = q_serving["tp"]["kernel_shapes"]["int8_linear"]
    for r in q_records:
        r["launches_graphed_path"] = q_serving["graphs"]["bf16"]["launches"][r["name"]]
        r["launches_qwen35_graphed_path"] = h_graphs["bf16"]["launches"][r["name"]]
    # DSv4's graphed paths ([13g], [18g]): K3 / K4 with the chain off, K9
    # with moe_chain=True, K8 in int8
    d_graphs = d_serving["graphs"]
    graphed = {"moe_fp4_gemv": d_graphs["fp4"]["launches"]["moe_fp4_gemv"],
               "fp8_gemv": d_graphs["fp4"]["launches"]["fp8_gemv"],
               "moe_fp4_chain": d_graphs["fp4_chain"]["launches"]["moe_fp4_chain"],
               "moe_int8_chain": i_serving["graphs"]["launches"]["moe_int8_chain"]}
    for r in d_records + i_records:
        if r["name"] in graphed:
            r["launches_graphed_path"] = graphed[r["name"]]
    records = (s_records + c_records + e_records + f_records + q_records + d_records + i_records
               + [linear])
    for r in records:
        if r["name"] in MEASURED_BOUND_KERNELS:
            # the same bytes over the measured ceiling (every one is bound by bytes)
            r["measured_bound_ms"] = (r["bound_ms"] * HBM_BYTES_PER_S / ceiling
                                      if r["bound_by"] == "bytes" else None)
            for sub in r.get("shapes", {}).values():  # K4's shapes of a decode step
                sub["measured_bound_ms"] = sub["bound_ms"] * HBM_BYTES_PER_S / ceiling
            if "step_bound_ms" in r:
                r["step_measured_bound_ms"] = r["step_bound_ms"] * HBM_BYTES_PER_S / ceiling
                log(f"  {r['name']} over a decode step: {r['step_ms'] * 1e3:.2f} us, "
                    f"{r['step_measured_bound_ms'] / r['step_ms']:.1%} of its bound at the "
                    "measured read ceiling")
            log(f"  {r['name']}: {r['ms'] * 1e3:.2f} us, {r['bound_ms'] / r['ms']:.1%} of its "
                f"nominal bound, {r['bound_ms'] * HBM_BYTES_PER_S / ceiling / r['ms']:.1%} of "
                "its bound at the measured read ceiling")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records, "read_ceiling_bytes_per_s": ceiling,
                      "read_ceiling": read_ceiling, "weight_streams": s_extra, "gemv_chain": c_extra,
                      "expert_stream": e_extra, "fp4_study": f_extra,
                      "serving": q_serving, "steps": q_steps,
                      "qwen35": {"serving": h_serving, "steps": h_steps},
                      "dsv4": {"serving": d_serving, "steps": d_steps},
                      "dsv4_cache": dsv4_cache,
                      "pd": {"qwen3": q_serving.pop("pd"), "qwen35": h_serving.pop("pd"),
                             "dsv4": dsv4_pd},
                      "dsv4_fp4_chain": {"serving": chain_serving},
                      "dsv4_int8": {"serving": i_serving, "steps": i_steps},
                      "dsv4_mp8": mp8, "dsv2lite": dsv2}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ── phases 2a-2b: the bf16 weight streams ──────────────────────────────


def stream_err(label, got, ref, limit):
    err = (got - ref).abs().max().item()
    log(f"  {label}: max |diff| {err:.3e} of {limit:.3e} "
        f"{'ok' if err <= limit else 'FAIL'}")
    if not err <= limit:
        raise SystemExit(f"{label}: the kernel disagrees with its plain version")
    return err


def run_streams():
    """Phase 2a: stream_sum (both forms), gemv and layer_gemv against their
    plain versions (gemv_stream_study.check); then the study's sweep on the
    three shapes (the main path, counted) and the wrappers' defaults timed.
    Returns (records, the read ceiling, the sweep's best per shape,
    layer_gemv's largest error)."""
    from pegainfer_tpu_torch.ops.cuda import gemv_stream as gs
    from pegainfer_tpu_torch.studies import gemv_stream_study as study

    # the plain versions' f32 products in true f32, not TF32 (torch's
    # default already; set so that the oracle is never looser than the kernel)
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[2a] bf16 weight streams (S2: stream_sum, gemv; S1a: layer_gemv) against their "
        "plain versions")
    saved = dict(gs.launches)
    rows = study.check(seed=SEED + 11)
    gs.launches.update(saved)
    errs = {k: 0.0 for k in gs.launches}
    for name, err, lim in rows:
        log(f"  {name}: max |diff| {err:.3e} of {lim:.3e} {'ok' if err <= lim else 'FAIL'}")
        kernel = name.split()[0]
        errs[kernel] = max(errs[kernel], err)
    if not all(err <= lim for _, err, lim in rows):
        raise SystemExit("a weight-stream kernel disagrees with its plain version")

    for k in gs.launches:
        gs.launches[k] = 0
    log(f"  sweep (pegainfer_tpu_torch/studies/gemv_stream_study.py): defaults {gs.RING}, "
        f"{gs.LDG}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    results = []
    for N, K in study.SHAPES:
        W = (torch.randn((N, K), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
        x = (torch.randn((1, K), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
        s = torch.zeros((1, 1), device="cuda")
        log(f"  W [{N}, {K}] = {N * K * 2 / 1e6:.1f} MB over {study.copies_for(N * K * 2)} "
            "copies")
        results.append(study.study_shape(W, x, s))
        if (N, K) == study.SHAPES[0]:  # the records: gate_up, the defaults
            records = stream_records(gs, study, W, x, s, errs, results[-1])
        del W
        torch.cuda.empty_cache()
    for r in records:
        r["launches"] = gs.launches[r["name"]]
    ceiling = study.read_ceiling(results)
    log(f"  read ceiling {ceiling['bytes_per_s'] / 1e12:.4f} TB/s ({ceiling['kind']} "
        f"{ceiling['cfg']} at [{ceiling['N']}, {ceiling['K']}], median of {ceiling['retimes']} "
        f"re-timings, range {ceiling['min_bytes_per_s'] / 1e12:.4f}-"
        f"{ceiling['max_bytes_per_s'] / 1e12:.4f}), "
        f"{ceiling['bytes_per_s'] / HBM_BYTES_PER_S:.1%} of {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
        f"launches {gs.launches}")
    log_records(records)
    for r in records:
        if r["launches"] < 1:
            raise SystemExit(f"{r['name']} was not launched on its path")
    return records, ceiling, [{"N": r["N"], "K": r["K"], "copies": r["copies"],
                               "best": r["best"], "library_call": r["library_call"]}
                              for r in results], errs["layer_gemv"]


def stream_records(gs, study, W, x, s, errs, res):
    """Records of stream_sum (bulk, ldg) and gemv at the gate_up shape with
    the wrappers' defaults, W rotated over copies beyond 2 x L2; the plain
    versions; the library calls from the sweep's rows."""
    N, K = W.shape
    n = study.copies_for(N * K * 2)
    ws = [W] + [W.clone() for _ in range(n - 1)]
    lib = {r["kind"]: r for r in res["rows"] if r["kind"].startswith("torch")}
    src = "pegainfer_tpu_torch/csrc/gemv_stream.cu"
    out = []
    for name, fn, plain, nbytes, flops, replaces, lib_kind in (
            ("stream_sum_bulk", lambda i: gs.stream_sum(ws[i % n], s, "bulk"),
             lambda i: gs.stream_sum_plain(ws[i % n], s), N * K * 2 + 8, N * K,
             "scripts/gemv_stream_study.py:41", "torch.sum"),
            ("stream_sum_ldg", lambda i: gs.stream_sum(ws[i % n], s, "ldg"),
             lambda i: gs.stream_sum_plain(ws[i % n], s), N * K * 2 + 8, N * K,
             "scripts/gemv_stream_study.py:41", "torch.sum"),
            ("gemv", lambda i: gs.gemv(x, ws[i % n], s),
             lambda i: gs.gemv_plain(x, ws[i % n], s), N * K * 2 + K * 2 + 4 + N * 4,
             2 * N * K, "scripts/gemv_stream_study.py:90", "torch gemv [N,K]")):
        b, by = bound(nbytes, flops)
        out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": None, "max_abs_err": errs[name], "ms": time_ms(fn, 100),
                    "plain_ms": time_ms(plain, 10), "bound_ms": b, "bound_by": by,
                    "library_ms": lib[lib_kind]["ms"],
                    "library_call": f"{lib_kind} {lib[lib_kind]['cfg']}", "shape": [N, K]})
    out[-1]["library_kn_ms"] = lib["torch gemv [K,N]"]["ms"]
    return out


def run_chain(layer_err):
    """Phase 2b: gemv_chain against its plain chain (gemv_chain_study.check:
    L 1, every layer of 36 on the kernel's own x, whole chains of 2 and 36;
    the same for a square chain of 4 layers, whose x needs every block),
    then the study's five chain forms (the main path, counted); layer_gemv
    timed at the chain's shape. Returns (layer_gemv and gemv_chain records,
    the forms)."""
    from pegainfer_tpu_torch.ops.cuda import gemv_chain as gc
    from pegainfer_tpu_torch.ops.cuda import gemv_stream as gs
    from pegainfer_tpu_torch.studies import gemv_chain_study as study
    from pegainfer_tpu_torch.studies.gemv_stream_study import LIBRARY_GEMV, library_gemv

    log(f"[2b] the persistent GEMV chain (S1b) against its plain chain, L {CHAIN_L}, "
        f"N {CHAIN_N}, K {CHAIN_K}")
    x, stack = study.card_inputs(CHAIN_L, CHAIN_N, CHAIN_K, seed=SEED)
    saved = gc.launches
    rows = study.check(x, stack)
    gc.launches = saved
    for name, err, lim in rows:
        if not name.startswith("layer") or not err <= lim:
            log(f"  {name}: max |diff| {err:.3e} of {lim:.3e} {'ok' if err <= lim else 'FAIL'}")
    worst = max(rows[1:CHAIN_L], key=lambda r: r[1] / r[2])
    log(f"  layers 1-{CHAIN_L - 1} on the kernel's own x: worst {worst[0]} at "
        f"{worst[1] / worst[2]:.3f} of its limit")
    if not all(err <= lim for _, err, lim in rows):
        raise SystemExit("gemv_chain disagrees with its plain chain")

    gc.launches = 0
    gs.launches["layer_gemv"] = 0
    log("  the five chain forms (pegainfer_tpu_torch/studies/gemv_chain_study.py):")
    forms = study.time_forms(x, stack)
    L = CHAIN_L
    layer_ms = time_ms(lambda i: gs.layer_gemv(x, stack, i % L), 100)
    launches = {"layer_gemv": gs.launches["layer_gemv"], "gemv_chain": gc.launches}
    log(f"  launches {launches}")
    if min(launches.values()) < 1:
        raise SystemExit(f"a chain kernel was not launched on its path: {launches}")
    nbytes = CHAIN_N * CHAIN_K * 2
    lb, lby = bound(nbytes + CHAIN_K * 2 + CHAIN_N * 4, 2 * CHAIN_N * CHAIN_K)
    cb, cby = bound(L * nbytes + CHAIN_K * 2 + CHAIN_N * 4, 2 * L * CHAIN_N * CHAIN_K)
    records = [
        {"name": "layer_gemv", "route": "cuda", "source": "pegainfer_tpu_torch/csrc/gemv_stream.cu",
         "replaces": "scripts/gemv_chain_study.py:41", "launches": launches["layer_gemv"],
         "max_abs_err": layer_err, "ms": layer_ms,
         "plain_ms": time_ms(lambda i: gs.layer_gemv_plain(x, stack, i % L), 10),
         "bound_ms": lb, "bound_by": lby,
         "library_ms": time_ms(lambda i: library_gemv(x, stack[i % L].T), 100),
         "library_call": LIBRARY_GEMV},
        {"name": "gemv_chain", "route": "cuda", "source": "pegainfer_tpu_torch/csrc/gemv_chain.cu",
         "replaces": "scripts/gemv_chain_study.py:96", "launches": launches["gemv_chain"],
         "max_abs_err": max(err for _, err, _ in rows), "ms": forms["gemv_chain"]["device_ms"],
         "plain_ms": time_ms(lambda i: gc.gemv_chain_plain(x, stack), 2),
         "bound_ms": cb, "bound_by": cby, "library_ms": None,
         "library_call": "none (no one call); the chain forms beside it"},
    ]
    log_records(records)
    return records, {"checks": rows, "forms": forms}


# ── phases 2c-2d: the int8 expert stream and the fp4 decode variants ────


def log_checks(rows, label):
    """Log a study's check rows; fail if one is over its limit. Returns the
    largest error of each kernel (the first word of a row's name)."""
    errs = {}
    for name, err, lim in rows:
        log(f"  {name}: max |diff| {err:.3e} of {lim:.3e} {'ok' if err <= lim else 'FAIL'}")
        kernel = name.split()[0]
        errs[kernel] = max(errs.get(kernel, 0.0), err)
    if not all(err <= lim for _, err, lim in rows):
        raise SystemExit(f"a {label} kernel disagrees with its plain version")
    return errs


def check_launched(launches, label):
    log(f"  launches {launches}")
    if min(launches.values()) < 1:
        raise SystemExit(f"a {label} kernel was not launched on its path: {launches}")


def run_expert_stream():
    """Phase 2c: expert_gemv (both forms) and expert_gemv_in_flight against
    their plain versions (expert_stream_study.check) on q int8 [256, 2048,
    4096] made on the card; then the study's forms timed (the main path,
    counted), K6 and torch's bmm beside them. Records at rows 32 (the
    wrapper's default), bounds over the distinct experts of the timed calls.
    Returns (records, the study's table)."""
    from pegainfer_tpu_torch.ops.cuda import expert_stream as es
    from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
    from pegainfer_tpu_torch.studies import expert_stream_study as study

    t0 = time.perf_counter()
    E, I, D, M = study.E, study.I, study.D, study.M
    log(f"[2c] int8 expert stream (S3: expert_gemv convert / native, expert_gemv_in_flight) "
        f"against its plain versions, q int8 [{E}, {I}, {D}]")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    q = torch.randint(-127, 128, (E, I, D), generator=gen, dtype=torch.int8, device="cuda")
    saved = dict(es.launches)
    errs = log_checks(study.check(q=q, seed=SEED + 14), "expert-stream")
    es.launches.update(saved)

    x8 = torch.randint(-127, 128, (M, D), generator=gen, dtype=torch.int8, device="cuda")
    idx_all = torch.randint(0, E, (study.ITERS, M), generator=gen, device="cuda").int()
    for k in es.launches:
        es.launches[k] = 0
    k6_saved = k6.launches
    log("  forms (pegainfer_tpu_torch/studies/expert_stream_study.py):")
    res = study.study(q, x8, idx_all)
    k6.launches = k6_saved
    launches = dict(es.launches)
    check_launched(launches, "expert-stream")
    by = {r["form"]: r for r in res["table"]}
    xb = x8.to(torch.bfloat16)
    n = study.ITERS
    plain = {"expert_gemv_convert": lambda i: es.expert_gemv_plain(xb, q, idx_all[i % n]),
             "expert_gemv_native": lambda i: es.expert_gemv_plain(x8, q, idx_all[i % n], True)}
    plain["expert_gemv_in_flight"] = plain["expert_gemv_convert"]
    distinct = res["distinct_bytes"]
    src = "pegainfer_tpu_torch/csrc/expert_stream.cu"
    records = []
    for name, form, replaces, peak in (
            ("expert_gemv_convert", "convert rows 32", "scripts/expert_stream_study.py:123",
             BF16_FLOPS),
            ("expert_gemv_native", "native rows 32", "scripts/expert_stream_study.py:123",
             INT8_OPS),
            ("expert_gemv_in_flight", "in flight", "scripts/expert_stream_study.py:155",
             BF16_FLOPS)):
        x_bytes = M * D * (1 if name == "expert_gemv_native" else 2)
        nbytes = distinct + x_bytes + M * 4 + M * I * 4
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * M * I * D / peak * 1e3
        records.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": by[form]["ms"],
            "plain_ms": time_ms(plain[name], 10), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": by[study.LIBRARY_CALL]["ms"], "library_call": study.LIBRARY_CALL,
            "library_gather_ms": by[study.GATHER_CALL]["ms"], "form": form,
            **res["bytes_in_flight"][form]})
    log_records(records)
    log(f"  [2c] took {time.perf_counter() - t0:.1f} s")
    del q
    return records, res


def run_fp4_study():
    """Phase 2d: fp4_variant_gemv in its four variants and three tiles
    against their plain versions (fp4_kernel_study.check) on q uint8 [256,
    2048, 2048] and bf16 scales made on the card, bits and arith weight for
    weight; the scale loads of floor and bits_noscale in the SASS; then the
    sweep (the main path, counted) beside K3 and its bmm. Records at rows 32
    (the wrapper's default), bounds over the distinct experts of the timed
    calls. Returns (records, the sweep's table, decode's cost, the SASS
    counts)."""
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.cuda import fp4_study as fs
    from pegainfer_tpu_torch.studies import fp4_kernel_study as study
    from pegainfer_tpu_torch.studies.expert_stream_study import distinct_bytes

    t0 = time.perf_counter()
    E, OUT, IN, M = study.E, study.OUT, study.IN, study.M
    S = IN // study.GROUP
    log(f"[2d] fp4 decode variants (S4: floor, bits_noscale, bits, arith) against their plain "
        f"versions, q uint8 [{E}, {OUT}, {IN // 2}], s bf16 [{E}, {OUT}, {S}]")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    q = torch.randint(0, 256, (E, OUT, IN // 2), generator=gen, dtype=torch.uint8, device="cuda")
    s = study.random_scales(gen, (E, OUT, S), "cuda", pow2=True)
    saved = dict(fs.launches)
    errs = log_checks(study.check(q=q, s=s, seed=SEED + 16), "fp4 decode")
    fs.launches.update(saved)
    loads = study.scale_loads()
    log(f"  16-bit global (scale) loads in the SASS: {loads}")
    if not study.scale_loads_kept(loads):
        raise SystemExit("a floor or bits_noscale kernel lost its scale loads")

    xb = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
    idx_all = torch.randint(0, E, (study.ITERS, M), generator=gen, device="cuda").int()
    for k in fs.launches:
        fs.launches[k] = 0
    k3_saved = k3.launches
    log("  sweep (pegainfer_tpu_torch/studies/fp4_kernel_study.py):")
    table = study.sweep(q, s, xb, idx_all)
    k3.launches = k3_saved
    launches = dict(fs.launches)
    check_launched(launches, "fp4 decode")
    cost = study.decode_cost(table)
    log("  decode above floor (us, by rows): " + json.dumps(
        {k: {r: round(v * 1e3, 3) for r, v in d.items()} for k, d in cost.items()
         if k.endswith("floor")}) + f"; best {cost['best']}; K3 {cost['K3_ms'] * 1e3:.2f} us")
    by = {r["form"]: r for r in table}
    n = study.ITERS
    # each distinct expert's packed codes and scales, x, idx, y
    nbytes = (distinct_bytes(idx_all.cpu().numpy(), OUT, IN // 2 + S * 2)
              + M * IN * 2 + M * 4 + M * OUT * 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * M * OUT * IN / BF16_FLOPS * 1e3
    records = []
    for v in fs.VARIANTS:
        name = f"fp4_variant_{v}"
        records.append({
            "name": name, "route": "cuda", "source": "pegainfer_tpu_torch/csrc/fp4_study.cu",
            "replaces": "scripts/fp4_kernel_study.py:105", "launches": launches[name],
            "max_abs_err": errs[name], "ms": by[f"{v} rows 32"]["ms"],
            "plain_ms": time_ms(
                lambda i, v=v: fs.fp4_variant_gemv_plain(xb, q, s, idx_all[i % n], v), 10),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "library_ms": by[study.LIBRARY_CALL]["ms"],
            "library_call": study.LIBRARY_CALL, "form": f"{v} rows 32",
            "best_rows": cost["best"][v]["rows"], "best_ms": cost["best"][v]["ms"],
            "scale_loads_in_sass": {k: c for k, c in loads.items() if k.split()[0] == v}})
    log_records(records)
    log(f"  [2d] took {time.perf_counter() - t0:.1f} s")
    del q, s
    return records, {"table": table, "decode_cost": cost, "scale_loads": loads}


def run_qwen3(ceiling):
    """Phases 3-8h on Qwen3-4B (``ceiling``: the measured read ceiling,
    bytes / s, for the int8 linear kernel's bounds). Returns (K1/K2 records,
    serving, steps)."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import qwen3 as q3
    from pegainfer_tpu_torch.models.qwen3_engine import start_engine_from_params
    from pegainfer_tpu_torch.ops import attention as att
    from pegainfer_tpu_torch.ops.cuda import flash_prefill as fp
    from pegainfer_tpu_torch.ops.cuda import paged_decode as pd

    cfg = qwen3_4b_config(q3)
    log("[3] kernels against their plain versions")
    errs = check_kernels(cfg, pd, fp)

    log("[4] serving Qwen3-4B bf16 (36 layers, random weights) through the engine")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t = time.perf_counter()
    params = q3.init_random_params_device(cfg, gen, "cuda")
    torch.cuda.synchronize()
    log(f"  weights: {q3.params_bytes(params) / 1e9:.2f} GB in {time.perf_counter() - t:.1f} s")
    handle = start_engine_from_params(
        cfg, params, contract.EngineLoadOptions(kv_memory_fraction=0.5, seed=SEED,
                                                **OLD_DEFAULTS, **EAGER),
        device="cuda")
    ex = handle._scheduler.executor
    step_walls = watch_steps(ex)
    log(f"  KV pool: {ex.kv_pages.shape[2]} pages x {PAGE} tokens "
        f"({ex.kv_pages.numel() * 2 / 1e9:.1f} GB)")
    rng = np.random.default_rng(SEED)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    try:
        # warm-up (cuBLAS handles, allocator) before the counted run
        ch, _ = run_request(contract, handle, prompt(64), 4)
        toks, fin, _ = drain(contract, ch)
        expect_finished(contract, "warm-up 64/4", toks, fin, 4)

        pd.launches = fp.launches = 0
        ex.prefills = ex.decode_steps = 0
        main_prompt = prompt(PROMPT)
        step_walls.clear()
        ch, t0 = run_request(contract, handle, main_prompt, OUT)
        toks, fin, times = drain(contract, ch)
        expect_finished(contract, f"main {PROMPT}/{OUT}", toks, fin, OUT)
        ttft_ms = (times[0] - t0) * 1e3
        gaps = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
        main_step_walls = [(b - a) * 1e3 for a, b in step_walls]
        steps_alone = ex.decode_steps
        chans = submit_together(contract, handle, [(prompt(n), m) for n, m in SHORT])
        eager_tokens = {"main": toks, "concurrent": []}
        for ch, n, m in chans:
            toks_s, fin_s, _ = drain(contract, ch)
            expect_finished(contract, f"concurrent {n}/{m}", toks_s, fin_s, m)
            eager_tokens["concurrent"].append(toks_s)
        steps_pair = ex.decode_steps - steps_alone
        launches = {"paged_decode": pd.launches, "flash_prefill": fp.launches}
        prefills, decode_steps = ex.prefills, ex.decode_steps
    finally:
        handle.shutdown()
        handle._thread.join(timeout=60)
    del handle, ex  # the executor holds the KV pool

    L = cfg.num_hidden_layers
    log(f"[5] all requests Finished with their token counts; the concurrent pair "
        f"took {steps_pair} decode steps for {sum(m - 1 for _, m in SHORT)} decode tokens")
    if steps_pair >= sum(m - 1 for _, m in SHORT):
        raise SystemExit("the two concurrent requests never decoded in one batch")
    want = {"flash_prefill": L * prefills, "paged_decode": L * decode_steps}
    log(f"[6] launches {launches}; expected {want} "
        f"({prefills} prefills, {decode_steps} decode steps, {L} layers)")
    if launches != want:
        raise SystemExit("kernel launch counts do not match the path")

    log("[7] 1024-token prefill logits: kernels vs plain attention, on the card")
    kv = q3.make_kv_pages(cfg, PROMPT // PAGE + 1, PAGE, device="cuda")
    toks_t = torch.tensor(main_prompt, dtype=torch.int32, device="cuda")
    table = torch.arange(1, PROMPT // PAGE + 1, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        lk, _ = q3.prefill(cfg, params, kv, toks_t, table)
        lp, _ = q3.prefill(cfg, params, kv, toks_t, table, plain_kernels=True)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(lk).all()) and lk.shape == (cfg.vocab_size,)):
        raise SystemExit("kernel-path logits are not finite [V]")
    check_logits(lk, lp, LOGITS_RTOL, "kernel-path logits disagree with the "
                 "plain-attention model")
    del kv

    log("[8] timings")
    steps = step_profile(cfg, q3, params, toks_t, int(lk.argmax()))
    tpot = statistics.median(gaps)
    tpot95 = float(np.percentile(gaps, 95))  # 12 of the 255 gaps lie beyond it
    log(f"  main {PROMPT}/{OUT}: TTFT {ttft_ms:.3f} ms, TPOT p50 {tpot:.3f} ms, "
        f"p95 {tpot95:.3f} ms over {len(gaps)} gaps (host clock, per streamed token)")
    step_wall = statistics.median(main_step_walls)
    log(f"  its execute_decode wall p50 {step_wall:.3f} ms over {len(main_step_walls)} steps: "
        f"{tpot - step_wall:.3f} ms of the TPOT p50 lies outside the step (scheduler, events)")
    log_steps(steps)
    records, k1_shapes, k2_shapes = time_kernels(cfg, pd, fp, att, errs, launches)
    log_records(records)
    chunked, chunk_launches, k2_chunks = run_chunked(cfg, q3, params, contract,
                                                     start_engine_from_params, pd, fp, att)
    for r in records:  # the chunked path's own launches beside the main path's
        r["launches_chunked_path"] = chunk_launches[r["name"]]
    next(r for r in records if r["name"] == "flash_prefill")["chunk_shapes"] = k2_chunks
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[8e] Qwen3 PD handoff between two TorchExecutors of {PD_PAGES} pages on the same "
        f"weights: {PD_PROMPT}/{PD_OUT}")
    from pegainfer_tpu_torch.engine.torch_executor import TorchExecutor

    def make():
        return TorchExecutor(cfg, params, q3.make_kv_pages(cfg, PD_PAGES, PAGE, device="cuda"),
                             contract.EngineLoadOptions(**PD_OPTS, **EAGER))

    pd_record = run_pd("[8e]", make, cfg.vocab_size,
                       PD_PROMPT // PAGE * q3.kv_bytes_per_page(cfg, PAGE), exact=False)
    gc.collect()
    torch.cuda.empty_cache()
    from pegainfer_tpu_torch.models import qwen3_engine as q3e
    from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
    from pegainfer_tpu_torch.ops.cuda import int8_linear as il

    log(f"[8f] Qwen3-4B int8 weight-only (quantize=\"int8\") served on the same weights: "
        f"{PROMPT}/{OUT}, then {SHORT} at once")
    int8, q8, int8_tokens = run_int8_engine("[8f]", "qwen3", cfg, q3, q3e, params, contract,
                               {"paged_decode": pd, "flash_prefill": fp},
                               qwen3_int8_launches(cfg), cfg.num_hidden_layers,
                               steps[f"decode step B=1 ctx {PROMPT + 1}"][1])
    log("[8g] the int8 linear kernel on the int8 weights of [8f], beside K6 at one expert and "
        "the other forms")
    int8["dense"] = run_linear_sweep("[8g]", "qwen3", q8, params, ceiling)
    del q8
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[8h] echo with prompt logprobs under CHUNK_OPTS (bf16): a {CHUNK_PROMPT}-token "
        f"echo request while {len(CHUNK_STREAMS)} streams decode")
    echo = run_echo("[8h]", "qwen3", cfg, q3, q3e, params, contract)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[8i] host profile of the eager decode step: B = 1 at context {PROMPT + 1} through "
        "TorchExecutor.execute_decode, bf16 and int8")
    t_graphs = time.perf_counter()
    host_profile, q8 = run_host_profile(cfg, q3, params, contract, main_prompt)
    log("[8j] Qwen3's decode step under CUDA graphs (the defaults precompile=True, "
        "enable_cuda_graph=True), bf16 and int8, against the eager runs of [4] and [8f]")
    graphed = run_graphed(cfg, q3, q3e, params, q8, contract, {"paged_decode": pd,
                          "flash_prefill": fp, "int8_linear": il, "moe_int8_gemv": k6},
                          eager_tokens, int8_tokens, host_profile, main_prompt)
    graphed["phases_s"] = time.perf_counter() - t_graphs
    log(f"  [8i] and [8j] took {graphed['phases_s']:.1f} s")
    del q8
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[8k] Qwen3-4B cut to its first {BLOCK_LAYERS} layers: decode blocks under the JAX "
        "defaults (decode_block 4, decode_block_max 16, decode_pipeline_depth 2), graphed, bf16 "
        "and int8, against the one-token eager engine's tokens at that depth and an eager block "
        "engine")
    t = time.perf_counter()
    bcfg, bparams = cut_depth(cfg, params, BLOCK_LAYERS)
    b_eager, b_int8 = block_oracles(bcfg, q3e, bparams, contract)
    graphed["blocks"] = run_blocks_qwen3(bcfg, q3e, bparams, contract, {
        "paged_decode": pd, "flash_prefill": fp, "int8_linear": il, "moe_int8_gemv": k6},
        b_eager, b_int8)
    graphed["blocks"]["layers"] = BLOCK_LAYERS
    del bparams
    graphed["blocks"]["phase_s"] = time.perf_counter() - t
    log(f"  [8k] took {graphed['blocks']['phase_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    http, http_launches = run_serving(cfg, q3, q3e, params, contract, {
        "paged_decode": pd, "flash_prefill": fp}, main_prompt, eager_tokens["main"])
    for r in records:  # the served path's launches beside the main path's
        r["launches_http_path"] = http_launches[r["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    tp = run_tp(cfg, q3, q3e, params, contract, {"paged_decode": pd, "flash_prefill": fp,
                                                 "int8_linear": il}, att, ceiling,
                {"bf16": eager_tokens, "int8": int8_tokens})
    for r in records:  # rank 0's launches at TP 2 (bf16) and the rank's shapes
        r["launches_tp_path"] = tp["launches"][r["name"]]
        r["tp_shapes"] = tp["kernel_shapes"][r["name"]]
    serving = {"ttft_ms": ttft_ms, "tpot_p50_ms": tpot, "tpot_p95_ms": tpot95,
               "step_wall_p50_ms": step_wall,
               "prompt": PROMPT, "output": OUT, "paged_decode_shapes": k1_shapes,
               "flash_prefill_shapes": k2_shapes, "chunked": chunked, "pd": pd_record,
               "int8": int8, "echo": echo, "host_profile": host_profile, "graphs": graphed,
               "http": http, "tp": tp}
    return records, serving, steps_json(steps)


def logits_rule(lk, lp, rtol):
    """Rule 7's figures for logits ``lk`` against ``lp``: max |diff|, the
    limit rtol x max |lp|, the share, the argmax agreement and lp's top-2
    gap; ``ok``: the diff within the limit, and the argmax equal unless the
    gap is below the diff."""
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    top2 = torch.topk(lp, 2).values
    gap = (top2[0] - top2[1]).item()
    argmax_same = int(lk.argmax()) == int(lp.argmax())
    log(f"  max |diff| {diff:.4e}, max |logit| {scale:.4e}, tolerance "
        f"{rtol} x max |logit| = {rtol * scale:.4e} ({diff / (rtol * scale):.3f} of it); "
        f"argmax agrees: {argmax_same} (plain top-2 gap {gap:.4e})")
    return {"max_diff": diff, "max_logit": scale, "limit": rtol * scale,
            "share": diff / (rtol * scale), "argmax_same": argmax_same, "top2_gap": gap,
            "ok": diff <= rtol * scale and (argmax_same or gap <= diff)}


def check_logits(lk, lp, rtol, message):
    """max |diff| <= rtol x max |logit| of the plain run, and the argmax
    agrees unless the plain run's top-2 gap is below the diff. Returns the
    diff's share of that limit."""
    rule = logits_rule(lk, lp, rtol)
    if not rule["ok"]:
        raise SystemExit(message)
    return rule["share"]


def log_steps(steps):
    for name, (wall, dev, n, *_) in steps.items():
        log(f"  {name}: wall {wall:.3f} ms, device time {dev:.3f} ms in {n:.0f} "
            f"kernels and copies (torch.profiler), device idle {1 - dev / wall:.1%}")


def steps_json(steps):
    """A step's times, and its kernels' where the profile picked them out."""
    return {k: {"wall_ms": w, "device_ms": d, "device_ops": n, **(more[0] if more else {})}
            for k, (w, d, n, *more) in steps.items()}


def log_records(records):
    for r in records:
        log(f"  {r['name']}: {r['ms'] * 1e3:.2f} us vs bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}), plain {r['plain_ms'] * 1e3:.2f} us, library "
            + (f"{r['library_ms'] * 1e3:.2f} us" if r["library_ms"] is not None
               else r.get("library_call", "none")))


def step_profile(cfg, q3, params, prompt_t, first_token, iters=5):
    """Wall time (host clock, each call ending in a synchronize, as the
    executor's token read does), device time and the number of device
    operations (kernels and copies; torch.profiler, CUDA activity only) of
    one 1024-token prefill and one B = 1 decode step at context 1025,
    called directly on the model."""
    kv = q3.make_kv_pages(cfg, PROMPT // PAGE + 2, PAGE, device="cuda")
    table = torch.arange(1, PROMPT // PAGE + 2, dtype=torch.int32, device="cuda")
    dec = [torch.tensor(x, dtype=torch.int32, device="cuda") for x in
           ([first_token], [PROMPT], [table.tolist()], [PROMPT + 1])]
    return profile_calls({
        f"prefill {PROMPT}": lambda: q3.prefill(cfg, params, kv, prompt_t, table[:-1]),
        f"decode step B=1 ctx {PROMPT + 1}": lambda: q3.decode(cfg, params, kv, *dec),
    }, iters)


def profile_calls(calls, iters=5, kernels=None):
    """Per call ``fn()`` of ``calls``: wall time (host clock to a
    synchronize), device time and the number of device operations (kernels
    and copies; torch.profiler, CUDA activity only), with the attention
    kernels' share and the top TOP_OPS operations logged. With ``kernels``
    ({label: a substring of the CUDA kernel's name}) each call's tuple ends
    in a dict of their device time a call, ``{label}_ms``."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(iters):
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            wall = statistics.mean(walls)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                    torch.cuda.synchronize()
            ka = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                        key=lambda e: -e.self_device_time_total)
            dev = sum(e.self_device_time_total for e in ka) / iters / 1e3
            out[name] = (wall, dev, sum(e.count for e in ka) / iters)
            if kernels:
                out[name] += ({f"{label}_ms": sum(e.self_device_time_total for e in ka
                                                   if key in e.key) / iters / 1e3
                               for label, key in kernels.items()},)
            attn = sum(e.self_device_time_total for e in ka
                       if "flash_prefill" in e.key or "paged_decode" in e.key) / iters / 1e3
            # the profiler now and then records no device activity for a
            # call (the hybrid's k/v gather did once): say so, not divide
            share = (f"{attn / dev:.1%} of device time" if dev
                     else "no device time recorded by torch.profiler")
            log(f"    {name}: wall per call {min(walls):.3f}-{max(walls):.3f} ms over {iters} "
                f"calls; attention kernel (K1 / K2) {attn:.3f} ms, {share}")
            for e in ka[:TOP_OPS]:
                log(f"    {name}: {e.self_device_time_total / iters / 1e3:7.3f} ms in "
                    f"{e.count / iters:4.0f} x {e.key[:90]}")
    return out


def time_decode(gen, cfg, pd, seq_lens, plain=False):
    """K1 at one shape: rows of contexts ``seq_lens``, each row's last token
    in flight, read from the full 36-layer pool with the layer cycled so the
    pages stay out of L2, as in a decode step; its bound from these inputs;
    with ``plain`` its plain version; and the SDPA yardstick
    (``sdpa_decode_library``)."""
    L, Hq, Hkv, hd = (cfg.num_hidden_layers, cfg.num_attention_heads,
                      cfg.num_key_value_heads, cfg.head_dim)
    a = decode_case(gen, cfg, seq_lens, "pool_cur", layers=L)

    def k1(i):
        a["layer_id"] = i % L
        return pd.paged_attention_decode(**a)

    def k1_plain(i):
        a["layer_id"] = i % L
        pd.paged_attention_decode_plain(**a)

    saved = pd.launches
    out = {"seq_lens": list(seq_lens), "ms": time_ms(k1, 360)}
    if plain:
        out["plain_ms"] = time_ms(k1_plain, 12)
    B = len(seq_lens)
    nbytes = (2 * B * Hq * hd * 2  # q in, out
              + sum(2 * (s - 1) * Hkv * hd * 2 for s in seq_lens)  # live k and v rows
              + 2 * B * Hkv * hd * 2  # cur k, v
              + a["page_tables"].numel() * 4 + B * 4)
    out["bound_ms"], out["bound_by"] = bound(nbytes, sum(2 * 2 * Hq * hd * s for s in seq_lens))
    out["library_ms"], out["library_call"] = sdpa_decode_library(a, L, k1(0))
    pd.launches = saved
    return out


def sdpa_decode_library(a, L, ref):
    """K1's library yardstick: the device time of
    ``torch.nn.functional.scaled_dot_product_attention`` on the
    [B, Hq, 1, hd] queries and one layer's live K / V (paged tokens, then the
    in-flight one), gathered out of the pages into contiguous
    [B, Hkv, ctx, hd] tensors per layer before the timed call, the layer
    cycled as K1's is. ``is_causal`` stays False: with one query row a
    causal mask aligns top-left and leaves that query only the first key.
    Held against K1's output on layer 0 (``ref``) at DECODE_TOL. The call
    takes ``enable_gqa=True``. Where this torch refuses it, or where rows of
    unequal length are masked (a masked call may leave the fused backends),
    the call on K / V whose kv heads are repeated outside the timed call
    (bytes counted in no bound) is timed too; with a mask, so is one
    unmasked call a row on that row's own keys (the B calls timed as one).
    The fastest is the yardstick. Returns (ms, what was called), or (None,
    "none: why")."""
    q, pool, tables, seq_lens = a["q"], a["k_pages"], a["page_tables"], a["seq_lens"]
    B, Hq, hd = q.shape
    Hkv, ps = pool.shape[1], pool.shape[4]
    lens = seq_lens.tolist()
    ctx = max(lens)
    ks, vs = [], []
    for layer in range(L):
        k = torch.zeros((B, Hkv, ctx, hd), dtype=q.dtype, device=q.device)
        v = torch.zeros_like(k)
        for b, n in enumerate(lens):
            pages = pool[layer][:, tables[b, : -(-n // ps)].long()]  # [Hkv, n, 2, ps, hd]
            k[b, :, : n - 1] = pages[:, :, 0].reshape(Hkv, -1, hd)[:, : n - 1]
            v[b, :, : n - 1] = pages[:, :, 1].reshape(Hkv, -1, hd)[:, : n - 1]
            k[b, :, n - 1], v[b, :, n - 1] = a["cur_k"][b], a["cur_v"][b]
        ks.append(k)
        vs.append(v)
    mask = None
    if min(lens) < ctx:
        mask = (torch.arange(ctx, device=q.device)[None, :] < seq_lens[:, None])[:, None, None]
    qh = q[:, :, None, :]
    scale = a["scale"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    got, why = {}, []

    def attempt(name, call, iters):
        """``call(layer)`` returns the outputs of its rows, in order."""
        try:
            y = torch.cat(call(0))
            torch.cuda.synchronize()
        except (RuntimeError, TypeError) as exc:
            log(f"  K1 library: {name} refused ({str(exc).splitlines()[0][:160]})")
            why.append(f"{name} refused")
            return
        err = (y[:, :, 0].float() - ref.float()).abs().max().item()
        if not err <= DECODE_TOL:
            log(f"  K1 library: {name} disagrees with K1 by {err:.4g} (tol {DECODE_TOL})")
            why.append(f"{name} disagrees with K1")
            return
        got[name] = time_ms(lambda i: call(i % L), iters)
        log(f"  K1 library: {name} on contexts {lens}: {got[name] * 1e3:.2f} us "
            f"(max |diff| to K1 {err:.3e}, tol {DECODE_TOL})")

    # a masked call of several launches must still fit time_ms's sleep window
    iters = 360 if mask is None else 32
    masked = " masked" if mask is not None else ""
    attempt(f"scaled_dot_product_attention(enable_gqa=True){masked}",
            lambda l: [sdpa(qh, ks[l], vs[l], attn_mask=mask, scale=scale, enable_gqa=True)],
            iters)
    if mask is not None:
        rows = [[(k[b:b + 1, :, :n].contiguous(), v[b:b + 1, :, :n].contiguous())
                 for b, n in enumerate(lens)] for k, v in zip(ks, vs)]
        attempt("scaled_dot_product_attention(enable_gqa=True), one unmasked call a row",
                lambda l: [sdpa(qh[b:b + 1], kb, vb, scale=scale, enable_gqa=True)
                           for b, (kb, vb) in enumerate(rows[l])], 360 // B)
    if not got or mask is not None:
        G = Hq // Hkv
        kr = [k.repeat_interleave(G, dim=1) for k in ks]
        vr = [v.repeat_interleave(G, dim=1) for v in vs]
        attempt(f"scaled_dot_product_attention (kv heads repeated){masked}",
                lambda l: [sdpa(qh, kr[l], vr[l], attn_mask=mask, scale=scale)], iters)
    if not got:
        return None, "none: " + "; ".join(why)
    name = min(got, key=got.get)
    return got[name], name


def time_prefill(gen, fp, att, T, Hq, Hkv, hd, plain=False):
    """K2 on one whole prompt of T tokens at these heads: its time, its bound
    from these inputs, with ``plain`` its plain version's time, and the SDPA
    yardstick (``sdpa_prefill_library``)."""
    q = torch.randn((T, Hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((T, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((T, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    scale = hd ** -0.5
    saved = fp.launches
    out = {"T": T, "Hq": Hq, "Hkv": Hkv, "hd": hd,
           "ms": time_ms(lambda i: fp.flash_prefill(q, k, v, T, scale), 100)}
    ref = fp.flash_prefill(q, k, v, T, scale)
    fp.launches = saved
    if plain:
        out["plain_ms"] = time_ms(lambda i: att.prefill_attention(q, k, v, T, scale), 10)
    nbytes = (2 * T * Hq * hd + 2 * T * Hkv * hd) * 2
    out["bound_ms"], out["bound_by"] = bound(nbytes, 2 * 2 * Hq * hd * (T * (T + 1) // 2))
    out["library_ms"], out["library_call"] = sdpa_prefill_library(q, k, v, scale, ref)
    return out


def sdpa_prefill_library(q, k, v, scale, ref, q_offset=None):
    """K2's library yardstick: ``scaled_dot_product_attention(is_causal=True)``
    on [1, H, T, hd] copies made outside the timed call, once with
    ``enable_gqa=True`` on the Hkv heads and once on kv heads repeated to Hq
    (bytes counted in no bound), each held against K2's output ``ref`` at
    K2's row limit. With ``q_offset`` (a chunk: queries at q_offset + i
    over S keys) the causal mask is an explicit boolean [T, S]
    ``attn_mask``, made outside the timed call. The faster is the
    yardstick. Returns (ms, what was called), or (None, "none: why")."""
    T, Hq, hd = q.shape
    G = Hq // k.shape[1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.transpose(0, 1).unsqueeze(0).contiguous() for x in (q, k, v))
    kr, vr = (x.repeat_interleave(G, dim=1) for x in (kh, vh))
    if q_offset is None:
        mask, form = dict(is_causal=True), "is_causal=True"
    else:
        keys = torch.arange(k.shape[0], device=q.device)
        mask = dict(attn_mask=keys[None, :] <= q_offset + torch.arange(T, device=q.device)[:, None])
        form = "attn_mask=bool [T, S]"
    calls = {
        f"scaled_dot_product_attention({form}, enable_gqa=True)":
            lambda i: sdpa(qh, kh, vh, **mask, scale=scale, enable_gqa=True),
        f"scaled_dot_product_attention({form}), kv heads repeated":
            lambda i: sdpa(qh, kr, vr, **mask, scale=scale),
    }
    got, why = {}, []
    for name, call in calls.items():
        try:
            y = call(0)[0].transpose(0, 1)
            torch.cuda.synchronize()
        except (RuntimeError, TypeError) as exc:
            log(f"  K2 library: {name} refused ({str(exc).splitlines()[0][:160]})")
            why.append(f"{name} refused")
            continue
        err, share = prefill_err(y, ref)
        if not share <= 1.0:
            log(f"  K2 library: {name} disagrees with K2 (worst row at {share:.3f} of its limit)")
            why.append(f"{name} disagrees with K2")
            continue
        got[name] = time_ms(call, 100)
        log(f"  K2 library: {name} at T={T}, S={k.shape[0]}, Hq {Hq}, hd {hd}: "
            f"{got[name] * 1e3:.2f} us "
            f"(max |diff| to K2 {err:.3e}, worst row at {share:.3f} of K2's limit)")
    if not got:
        return None, "none: " + "; ".join(why)
    name = min(got, key=got.get)
    return got[name], name


def k2_host_cost(fp, T, Hq, Hkv, hd, iters=200):
    """Host time of K2's launch path at one shape: one cuTensorMapEncodeTiled
    of its Q map through libcuda by ctypes (less an empty driver call, the
    ctypes cost), and one whole wrapper call (plan, four encodes, launch),
    enqueued behind a device sleep. Means over ``iters`` calls, host clock."""
    import ctypes

    from pegainfer_tpu_torch.studies.timing import SLEEP_CYCLES
    q = torch.zeros((T, Hq, hd), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((T, Hkv, hd), dtype=torch.bfloat16, device="cuda")
    G = Hq // Hkv
    cuda = ctypes.CDLL("libcuda.so.1")
    buf = ctypes.create_string_buffer(128 + 64)
    args = (ctypes.c_void_p((ctypes.addressof(buf) + 63) & ~63),
            ctypes.c_int(9), ctypes.c_uint32(3), ctypes.c_void_p(q.data_ptr()),  # bf16, 3-D
            (ctypes.c_uint64 * 3)(hd, Hq, T), (ctypes.c_uint64 * 2)(hd * 2, Hq * hd * 2),
            (ctypes.c_uint32 * 3)(64, G, 128 // G), (ctypes.c_uint32 * 3)(1, 1, 1),
            ctypes.c_int(0), ctypes.c_int(3), ctypes.c_int(3), ctypes.c_int(0))  # SW128, L2 256B
    version = ctypes.c_int()

    def per_call_us(fn):
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) / iters * 1e6

    if cuda.cuTensorMapEncodeTiled(*args) != 0:
        raise SystemExit("cuTensorMapEncodeTiled refused K2's Q map")
    encode = per_call_us(lambda: cuda.cuTensorMapEncodeTiled(*args))
    empty = per_call_us(lambda: cuda.cuDriverGetVersion(ctypes.byref(version)))
    saved = fp.launches
    fp.flash_prefill(q, k, k, T, hd ** -0.5)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    call = per_call_us(lambda: fp.flash_prefill(q, k, k, T, hd ** -0.5))
    torch.cuda.synchronize()
    fp.launches = saved
    log(f"  K2 host cost: cuTensorMapEncodeTiled {encode:.2f} us a call by ctypes (an empty "
        f"driver call {empty:.2f} us), the whole wrapper {call:.2f} us a call")
    return {"encode_us": encode, "empty_driver_call_us": empty, "wrapper_call_us": call}


def time_kernels(cfg, pd, fp, att, errs, launches):
    """Each kernel at the main path's shape, its bound from these inputs,
    its plain version and one library call on the same inputs; K1 also at
    K1_SHAPES, K2 also at K2_SHAPES (and its host cost in its record).
    Returns (records, K1 at K1_SHAPES, K2 at K2_SHAPES)."""
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # K1: B = 1 in mid-decode (context 1152 = 1024 + 128), full pool with
    # layer_id and the in-flight token as the main path calls it
    k1 = time_decode(gen, cfg, pd, [PROMPT + OUT // 2], plain=True)
    shapes = [time_decode(gen, cfg, pd, s) for s in K1_SHAPES]
    for r in shapes:
        log(f"  paged_decode at contexts {r['seq_lens']}: {r['ms'] * 1e3:.2f} us vs bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), library "
            + (f"{r['library_ms'] * 1e3:.2f} us" if r["library_ms"] is not None
               else r["library_call"]))
    torch.cuda.empty_cache()

    # K2: the whole 1024-token prompt, then K2_SHAPES
    k2 = time_prefill(gen, fp, att, PROMPT, Hq, Hkv, hd, plain=True)
    k2_shapes = [time_prefill(gen, fp, att, *shape) for shape in K2_SHAPES]
    for r in k2_shapes:
        log(f"  flash_prefill at T=S={r['T']}, Hq {r['Hq']}, Hkv {r['Hkv']}, hd {r['hd']}: "
            f"{r['ms'] * 1e3:.2f} us vs bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            "library " + (f"{r['library_ms'] * 1e3:.2f} us" if r["library_ms"] is not None
                          else r["library_call"]))
    return [
        {"name": "paged_decode", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/paged_decode.cu",
         "replaces": "pegainfer_tpu/ops/pallas/paged_decode.py:248",
         "launches": launches["paged_decode"], "max_abs_err": errs["paged_decode"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
         "library_call": k1["library_call"]},
        {"name": "flash_prefill", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/flash_prefill.cu",
         "replaces": "pegainfer_tpu/ops/pallas/flash_prefill.py:114",
         "launches": launches["flash_prefill"], "max_abs_err": errs["flash_prefill"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
         "library_call": k2["library_call"], "host": k2_host_cost(fp, PROMPT, Hq, Hkv, hd)},
    ], shapes, k2_shapes


# ── phases 8a-8d: chunked prefill, the prefix cache, the fused mixed step ─


def read_tokens(contract, ch, n, timeout_s=600):
    """The first ``n`` tokens of a stream and their arrival times."""
    toks, times = [], []
    while len(toks) < n:
        ev = ch.get(timeout=timeout_s)
        if ev is None or contract.is_terminal(ev):
            raise SystemExit(f"stream ended or stalled before {n} tokens: {ev!r}")
        if isinstance(ev, contract.Token):
            toks.append(ev.id)
            times.append(time.perf_counter())
    return toks, times


def drain_in_background(contract, ch):
    """Drain ``ch`` on a thread (token times taken as they arrive while the
    main thread reads another stream). ``join()`` returns (toks, fin,
    times)."""
    import threading

    out = []
    t = threading.Thread(target=lambda: out.append(drain(contract, ch)), daemon=True)
    t.start()

    def join():
        t.join(timeout=600)
        if not out:
            raise SystemExit("a stream did not finish within the time limit")
        return out[0]

    return join


def record_chunked_path(ex, lookup="match"):
    """Log what the chunked path ran: each fused piece (start, rows,
    decode rows, wall ms up to its sampled tokens on the host), each
    prefix-cache lookup's cached tokens (``lookup``: the cache's ``match``,
    or ``match_hybrid`` for a model with state), each state snapshot kept
    (prompt length, position), and each prompt's last logits (by request
    id)."""
    rec = {"pieces": [], "matches": [], "snaps": [], "logits": {}}
    cache = ex.prefix_cache
    run_mixed, first_token = ex._run_mixed_piece, ex._first_token
    match, insert_snapshot = getattr(cache, lookup), cache.insert_snapshot

    def logged_mixed(item, items, chunk_tokens, start, valid, table):
        t = time.perf_counter()
        last = run_mixed(item, items, chunk_tokens, start, valid, table)
        rec["pieces"].append((start, valid, len(items), (time.perf_counter() - t) * 1e3))
        return last

    def logged_first(item, last_logits):
        rec["logits"][item.request_id] = last_logits.clone()
        return first_token(item, last_logits)

    def logged_match(tokens):
        res = match(tokens)
        rec["matches"].append(res[0])
        return res

    def logged_snapshot(tokens, pos, snap):
        rec["snaps"].append((len(tokens), pos))
        insert_snapshot(tokens, pos, snap)

    ex._run_mixed_piece, ex._first_token = logged_mixed, logged_first
    setattr(cache, lookup, logged_match)
    cache.insert_snapshot = logged_snapshot
    return rec


def run_chunked(cfg, q3, params, contract, start_engine_from_params, pd, fp, att):
    """Phases 8a-8d on the same Qwen3-4B weights. Returns (serving record,
    the phase's K1 / K2 launches, K2 at K2_CHUNK_SHAPES)."""
    L = cfg.num_hidden_layers
    gc.collect()  # the first engine's pool (its handle and scheduler form a cycle)
    torch.cuda.empty_cache()
    log("[8a] a second engine on the same weights: " + ", ".join(
        f"{k}={v}" for k, v in CHUNK_OPTS.items()))
    handle = start_engine_from_params(
        cfg, params, contract.EngineLoadOptions(kv_memory_fraction=0.5, seed=SEED, **CHUNK_OPTS,
                                                **EAGER),
        device="cuda")
    ex = handle._scheduler.executor
    rec = record_chunked_path(ex)
    rng = np.random.default_rng(SEED + 4)
    streams = [(rng.integers(0, cfg.vocab_size, n).tolist(), m) for n, m in CHUNK_STREAMS]
    long_prompt = rng.integers(0, cfg.vocab_size, CHUNK_PROMPT).tolist()
    label = f"{CHUNK_PROMPT}/{CHUNK_OUT}"
    try:
        pd.launches = fp.launches = 0
        chans = [run_request(contract, handle, p, m)[0] for p, m in streams]
        early = [read_tokens(contract, ch, 2) for ch in chans]  # both have decoded a token
        joins = [drain_in_background(contract, ch) for ch in chans]
        ch, t_cold = run_request(contract, handle, long_prompt, CHUNK_OUT)
        toks, fin, times_cold = drain(contract, ch)
        expect_finished(contract, f"cold {label} under decode load", toks, fin, CHUNK_OUT)
        stream_times = []
        for (toks0, times0), join, (p, m) in zip(early, joins, streams):
            toks, fin, times = join()
            expect_finished(contract, f"stream {len(p)}/{m}", toks0 + toks, fin, m)
            stream_times.append(times0 + times)
        ch, t_warm = run_request(contract, handle, long_prompt, CHUNK_OUT)
        toks, fin, times_warm = drain(contract, ch)
        expect_finished(contract, f"warm {label} alone", toks, fin, CHUNK_OUT)
        launches = {"paged_decode": pd.launches, "flash_prefill": fp.launches}
        counts = {"prefills": ex.prefills, "chunk_pieces": ex.chunk_pieces,
                  "mixed_pieces": ex.mixed_pieces, "decode_steps": ex.decode_steps,
                  "cache_hits": ex.prefix_cache.hits}
    finally:
        handle.shutdown()
        handle._thread.join(timeout=60)
    del handle, ex
    gc.collect()
    torch.cuda.empty_cache()

    n_pieces = CHUNK_PROMPT // CHUNK_OPTS["prefill_chunk_mixed"]
    want_pieces = [(i * CHUNK_OPTS["prefill_chunk_mixed"], CHUNK_OPTS["prefill_chunk_mixed"],
                    len(CHUNK_STREAMS)) for i in range(n_pieces)]
    cached = (CHUNK_PROMPT - 1) // PAGE * PAGE
    log(f"[8b] {counts}; fused pieces (start, rows, decode rows): "
        f"{[p[:3] for p in rec['pieces']]}; cached tokens per lookup {rec['matches']}")
    if ([p[:3] for p in rec["pieces"]] != want_pieces or counts["mixed_pieces"] != n_pieces
            or counts["chunk_pieces"] != n_pieces + 1 or counts["cache_hits"] != 1
            or rec["matches"][-1] != cached):
        raise SystemExit(f"the cold prompt did not run as {n_pieces} fused pieces of "
                         f"{CHUNK_OPTS['prefill_chunk_mixed']} with {len(CHUNK_STREAMS)} decode "
                         f"rows, or the warm one did not hit {cached} cached tokens")
    want = {"flash_prefill": L * (counts["prefills"] + counts["chunk_pieces"]),
            "paged_decode": L * (counts["decode_steps"] + counts["mixed_pieces"])}
    log(f"  launches {launches}; expected {want} ({L} x (whole prefills + pieces) K2, "
        f"{L} x (decode steps + fused pieces) K1)")
    if launches != want:
        raise SystemExit("kernel launch counts do not match the chunked path")

    rid_cold, rid_warm = len(streams), len(streams) + 1  # the scheduler's ids, in order
    cold, warm = rec["logits"][rid_cold], rec["logits"][rid_warm]
    log("[8c] logits on the card: the cold chunked prompt against one whole prefill")
    n_long = CHUNK_PROMPT // PAGE
    n_dec = [-(-(len(p) + 1) // PAGE) for p, _ in streams]
    kv = q3.make_kv_pages(cfg, 1 + n_long + sum(n_dec), PAGE, device="cuda")
    table = torch.arange(1, n_long + 1, dtype=torch.int32, device="cuda")
    dec_tables = torch.zeros((len(streams), max(n_dec)), dtype=torch.int32, device="cuda")
    nxt = n_long + 1
    with torch.no_grad():
        whole, _ = q3.prefill(cfg, params, kv, torch.tensor(long_prompt, dtype=torch.int32,
                                                            device="cuda"), table)
        check_logits(cold, whole, LOGITS_RTOL, "chunked-prefill logits disagree with the "
                     "whole prefill")
        log("  the warm hit's logits against the cold ones")
        check_logits(warm, cold, LOGITS_RTOL, "the prefix-cache hit's logits disagree with "
                     "the cold prompt's")
        for b, ((p, _), n) in enumerate(zip(streams, n_dec)):
            dec_tables[b, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
            q3.prefill(cfg, params, kv, torch.tensor(p, dtype=torch.int32, device="cuda"),
                       dec_tables[b, :n])
            nxt += n
        m = CHUNK_OPTS["prefill_chunk_mixed"]
        start = CHUNK_PROMPT - m
        chunk = torch.tensor(long_prompt[start:], dtype=torch.int32, device="cuda")
        dec = (torch.tensor([p[-1] for p, _ in streams], dtype=torch.int32, device="cuda"),
               torch.tensor([len(p) for p, _ in streams], dtype=torch.int32, device="cuda"),
               dec_tables,
               torch.tensor([len(p) + 1 for p, _ in streams], dtype=torch.int32, device="cuda"))
        runs = {}
        for name in ("fused", "apart", "plain"):
            pool = kv.clone()
            if name == "apart":
                last = q3.prefill_chunk(cfg, params, pool, chunk, start, m, table)
                runs[name] = (last, q3.decode(cfg, params, pool, *dec))
            else:
                runs[name] = q3.mixed_chunk(cfg, params, pool, chunk, start, m, table, *dec,
                                            plain_kernels=name == "plain")
            del pool
    torch.cuda.synchronize()
    log("  where a piece's time goes (the chunk at the prompt's end, on the model)")
    Hkv, hd = cfg.num_key_value_heads, cfg.head_dim
    pages = table.long()
    steps = profile_calls({
        f"fused piece {m} + {len(streams)} decode rows at {start}":
            lambda: q3.mixed_chunk(cfg, params, kv, chunk, start, m, table, *dec),
        f"chunk piece {m} at {start}":
            lambda: q3.prefill_chunk(cfg, params, kv, chunk, start, m, table),
        f"the k/v gather alone, {L} layers x {CHUNK_PROMPT} tokens":
            lambda: [kv[li][:, pages].permute(2, 1, 3, 0, 4).reshape(2, -1, Hkv, hd)
                     for li in range(L)],
    })
    log_steps(steps)
    for ref in ("apart", "plain"):
        log(f"  one mixed_chunk (chunk at {start}, rows of contexts "
            f"{[len(p) + 1 for p, _ in streams]}) against "
            + ("prefill_chunk + decode on a copy of the pool" if ref == "apart"
               else "plain_kernels=True"))
        for i, (got, want_l) in enumerate(zip(
                [runs["fused"][0], *runs["fused"][1]], [runs[ref][0], *runs[ref][1]])):
            if not (bool(torch.isfinite(got).all()) and got.shape == (cfg.vocab_size,)):
                raise SystemExit("mixed-step logits are not finite [V]")
            check_logits(got, want_l, LOGITS_RTOL, f"mixed-step logits (row {i}) disagree "
                         f"with {ref}")
    del kv

    log("[8d] timings of the chunked path (host clock)")
    ttft_cold = (times_cold[0] - t_cold) * 1e3
    ttft_warm = (times_warm[0] - t_warm) * 1e3
    # a gap overlapping the cold prompt's prefill (submit to first token)
    gaps = [(b - a) * 1e3 for ts in stream_times for a, b in zip(ts, ts[1:])
            if b > t_cold and a < times_cold[0]]
    walls = [p[3] for p in rec["pieces"]]
    log(f"  TTFT {label}: cold under decode load {ttft_cold:.3f} ms ({n_pieces} fused pieces), "
        f"warm alone {ttft_warm:.3f} ms ({cached} tokens cached, "
        f"{CHUNK_PROMPT - cached} re-run)")
    log(f"  streams' largest token gap during the cold prefill {max(gaps):.3f} ms over "
        f"{len(gaps)} gaps; one fused piece's wall: median {statistics.median(walls):.3f} ms, "
        f"max {max(walls):.3f} ms")
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    shapes = [time_chunk(gen, fp, att, T, S, q_offset, Hq, Hkv, hd)
              for T, S, q_offset in K2_CHUNK_SHAPES]
    for r in shapes:
        log(f"  flash_prefill chunk T={r['T']}, S={r['S']}, q_offset {r['q_offset']}: "
            f"{r['ms'] * 1e3:.2f} us vs bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            f"plain {r['plain_ms'] * 1e3:.2f} us, library "
            + (f"{r['library_ms'] * 1e3:.2f} us" if r["library_ms"] is not None
               else r["library_call"]))
    serving = {"options": CHUNK_OPTS, "prompt": CHUNK_PROMPT, "output": CHUNK_OUT,
               "streams": CHUNK_STREAMS, "ttft_cold_ms": ttft_cold, "ttft_warm_ms": ttft_warm,
               "max_gap_during_prefill_ms": max(gaps), "piece_wall_ms": walls, **counts,
               "steps": steps_json(steps)}
    return serving, launches, shapes


# ── phases 8e, 13c, 25a: PD handoff ─────────────────────────────────────


def tensors_of(tree):
    """The tensors of a tree of dicts, lists and tensors."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)


def decode_steps_on(ex, rid, first, n):
    """``n`` greedy decode steps of request ``rid`` on ``ex`` from
    ``first``. Returns (the stream, the last step's logits [V])."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.engine import executor as tx

    last = []
    model = ex._decode_model

    def logged(*args):
        out = model(*args)
        last[:] = [out[0].clone()]
        return out

    ex._decode_model = logged
    try:
        toks = [first]
        for _ in range(n):
            res = ex.execute_decode(tx.DecodePlan(requests=[tx.DecodeStepItem(
                request_id=rid, token_id=toks[-1],
                params=contract.SamplingParams(ignore_eos=True))]))
            toks.append(res.requests[0].token)
    finally:
        del ex._decode_model  # the class's hook again
    return toks, last[0]


def run_pd(phase, make, vocab, want_bytes, exact):
    """One PD handoff (``engine/pd.py``) of a greedy PD_PROMPT / PD_OUT
    request: A runs it alone first (A's own run), then prefills it again and
    exports it; B, with a throwaway request holding its first pages (and
    slot), imports it and decodes. The stream must equal A's own, the last
    step's logits bit for bit (``exact``) or by rule 7, and the payload must
    hold ``want_bytes``. Returns the record (payload bytes, export and import
    walls on the host clock)."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.engine import executor as tx
    from pegainfer_tpu_torch.engine import pd as tpd

    rng = np.random.default_rng(SEED + 11)
    prompt = rng.integers(0, vocab, PD_PROMPT).tolist()

    def item(rid, toks):
        return tx.PrefillStepItem(request_id=rid, prompt_tokens=toks,
                                  params=contract.SamplingParams(ignore_eos=True))

    a, b = make(), make()
    res = a.execute_prefill(tx.PrefillPlan(requests=[item(1, prompt)]))
    own, own_logits = decode_steps_on(a, 1, res.requests[0].first_token, PD_OUT - 1)
    own_pages = list(a.acct.get(1).pages)
    own_slot = getattr(a, "_slots", {}).get(1)
    a.release_request(1)
    b.execute_prefill(tx.PrefillPlan(requests=[item(999, prompt[:100])]))  # churn B

    prefill_ms = []
    execute_prefill = a.execute_prefill

    def timed_prefill(plan):
        t = time.perf_counter()
        out = execute_prefill(plan)  # ends in a host read of the first token
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        return out

    a.execute_prefill = timed_prefill
    t = time.perf_counter()
    payload = tpd.prefill_and_export(a, item(2, prompt))
    export_ms = (time.perf_counter() - t) * 1e3 - prefill_ms[0]
    del a.execute_prefill
    torch.cuda.synchronize()
    t = time.perf_counter()
    tpd.import_request(b, payload)
    torch.cuda.synchronize()
    import_ms = (time.perf_counter() - t) * 1e3
    moved, moved_logits = decode_steps_on(b, 2, payload.first_token, PD_OUT - 1)
    shipped = list(tensors_of([payload.kv_rows, payload.state_snap]))
    nbytes = sum(t.numel() * t.element_size() for t in shipped)
    on_host = all(t.device.type == "cpu" for t in shipped)
    b_pages = list(b.acct.get(2).pages)
    b_slot = getattr(b, "_slots", {}).get(2)
    log(f"  payload {nbytes / 1e6:.2f} MB on the host ({'ok' if on_host else 'FAIL'}; "
        f"expected {want_bytes / 1e6:.2f} MB); export {export_ms:.3f} ms after the "
        f"{prefill_ms[0]:.3f} ms prefill, import {import_ms:.3f} ms (host clock)")
    log(f"  pages on A {own_pages[:3]}..., on B {b_pages[:3]}...; slot on A {own_slot}, "
        f"on B {b_slot}")
    if nbytes != want_bytes or not on_host or payload.prompt_len != PD_PROMPT:
        raise SystemExit(f"{phase} the payload is not the request's pages and rows on the host")
    if a.acct.get(2) is not None and a.acct.get(2).pages:
        raise SystemExit(f"{phase} A kept the request's pages after the export")
    if (own_pages and b_pages[:len(own_pages)] == own_pages) or (
            own_slot is not None and b_slot == own_slot):
        raise SystemExit(f"{phase} the import landed on A's page ids or slot; no churn")
    log(f"  B's stream {moved[:6]}... against A's own {own[:6]}...")
    if moved != own:
        raise SystemExit(f"{phase} the handed-off stream differs from A's own run")
    if exact:
        same = torch.equal(moved_logits, own_logits)
        log(f"  the last step's logits equal A's own bit for bit: {same}")
        if not same:
            raise SystemExit(f"{phase} the handed-off logits are not A's own bit for bit")
        share = 0.0
    else:
        log("  the last step's logits against A's own run")
        share = check_logits(moved_logits, own_logits, LOGITS_RTOL,
                             f"{phase} the handed-off logits disagree with A's own run")
    return {"prompt": PD_PROMPT, "output": PD_OUT, "payload_bytes": nbytes,
            "export_ms": export_ms, "import_ms": import_ms, "prefill_ms": prefill_ms[0],
            "tokens_equal": True, "logits_share_of_limit": share, "exact": exact}


# ── phases 8f-8h, 25b-25c, 13d: int8 weight-only Qwen3 / Qwen3.5, echo ──


def shallow_tree(params):
    """A copy of a params tree's dicts, sharing its tensors: what the int8
    quantizers consume (each matrix replaced in the copy), so the bf16
    weights stay in the caller's tree."""
    return {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}


def dense_stacks(family, params):
    """{DENSE_SHAPES name: (q [L, OUT, IN], s [L, OUT], bf16 w [L, IN, OUT])}
    from an int8 tree and its bf16 tree (``params`` = (int8, bf16)); the
    stacks' own shapes checked against the table's."""
    from pegainfer_tpu_torch.studies import k6_study as k6s

    q8, bf = params
    if family == "qwen3":
        keys = {"qwen3 wq": ("layers", "wq"), "qwen3 wk / wv": ("layers", "wk"),
                "qwen3 wo": ("layers", "wo"), "qwen3 w_gate_up": ("layers", "w_gate_up"),
                "qwen3 w_down": ("layers", "w_down"), "qwen3 lm_head": (None, "lm_head")}
    else:
        keys = {"qwen35 gdn wq / wk": ("lin", "wq"),
                "qwen35 gdn wv / wz, full wq / wgate": ("lin", "wv"),
                "qwen35 out_proj / wo": ("lin", "out_proj"), "qwen35 full wk / wv": ("full", "wk"),
                "qwen35 mlp_gate_up": ("lin", "mlp_gate_up"),
                "qwen35 mlp_down": ("lin", "mlp_down"), "qwen35 lm_head": (None, "lm_head")}
    out = {}
    for name, OUT, IN, _ in k6s.DENSE_SHAPES:
        if name not in keys:
            continue
        part, key = keys[name]
        c, w = (q8[key], bf[key]) if part is None else (q8[part][key], bf[part][key])
        q, s = c["q"].reshape(-1, OUT, IN), c["s"].reshape(-1, OUT)
        w = w.reshape(-1, IN, OUT)
        if q.shape[0] != w.shape[0]:
            raise SystemExit(f"{name}: the int8 and bf16 stacks differ")
        out[name] = (q, s, w)
    return out


def qwen3_int8_launches(cfg):
    """The int8 linear kernel's launches a Qwen3 decode step: a layer's wq /
    wk / wv in one, wo, w_gate_up and w_down, and the head (145 at 36
    layers)."""
    return 4 * cfg.num_hidden_layers + 1


def qwen35_int8_launches(cfg):
    """... a hybrid decode step: 4 a layer (a GDN layer's wq / wk / wv / wz in
    one, out_proj, mlp_gate_up, mlp_down; a full layer's wq / wgate / wk /
    wv in one, wo, mlp_gate_up, mlp_down), and the head (129 at
    ``bench_config()``'s 32 layers)."""
    return 4 * cfg.num_groups * cfg.period + 1


def int8_path_launches(n_linear, run):
    """The counted kernels of an int8 path: the int8 linear kernel
    ``n_linear`` a decode step and 1 a prefill (the head on the prompt's
    last row), K6 (``moe_int8_gemv``, whose count K6 at one expert shares)
    none."""
    return {"int8_linear": n_linear * run["decode_steps"] + run["prefills"], "moe_int8_gemv": 0}


# the served trees' weights of each int8_linear_study.STEP_LAUNCHES launch:
# (part of the tree or None for the root, key) a weight; the hybrid's
# out_proj stands for the full layers' wo and its lin mlp for theirs (the
# same shapes)
LINEAR_KEYS = {
    "qwen3 wq / wk / wv": (("layers", "wq"), ("layers", "wk"), ("layers", "wv")),
    "qwen3 wo": (("layers", "wo"),), "qwen3 w_gate_up": (("layers", "w_gate_up"),),
    "qwen3 w_down": (("layers", "w_down"),), "qwen3 lm_head": ((None, "lm_head"),),
    "qwen35 gdn wq / wk / wv / wz": tuple(("lin", k) for k in ("wq", "wk", "wv", "wz")),
    "qwen35 full wq / wgate / wk / wv": tuple(("full", k) for k in ("wq", "wgate", "wk", "wv")),
    "qwen35 out_proj / wo": (("lin", "out_proj"),), "qwen35 mlp_gate_up": (("lin", "mlp_gate_up"),),
    "qwen35 mlp_down": (("lin", "mlp_down"),), "qwen35 lm_head": ((None, "lm_head"),),
}
LINEAR_CALLS = 30  # timed calls of a form in [8g] / [25b], one turn (the study: 60, two)


def linear_stacks(family, q8, bf):
    """{STEP_LAUNCHES name: [(q [L, OUT, IN], s [L, OUT], bf16 w [L, IN,
    OUT]) a weight]} from the served int8 tree and its bf16 tree, the shapes
    checked against the table's."""
    from pegainfer_tpu_torch.studies import int8_linear_study as ils

    out = {}
    for name, outs, IN, _ in ils.STEP_LAUNCHES[family]:
        ws = []
        for (part, key), OUT in zip(LINEAR_KEYS[name], outs):
            c, w = (q8[key], bf[key]) if part is None else (q8[part][key], bf[part][key])
            q, sc = c["q"].reshape(-1, OUT, IN), c["s"].reshape(-1, OUT)
            w = w.reshape(-1, IN, OUT)
            if q.shape[0] != w.shape[0]:
                raise SystemExit(f"{name}: the int8 and bf16 stacks differ")
            ws.append((q, sc, w))
        out[name] = ws
    return out


def run_linear_sweep(label, family, q8, bf, ceiling):
    """The int8 linear kernel on a family's served int8 weights
    (``int8_linear_study.sweep_forms``): at each launch of a decode step and
    each bucket of 1-64 rows, held row by row to its plain version (the
    outputs NaN-filled first), then timed beside K6 at one expert with its
    multiply and cast, bf16 ``matmul``, the JAX form, the library call and
    its plain version; the step sums and the gates. K6 at one expert, off
    the main path now, is still held to its plain version
    (``k6_study.dense_check``) and timed alone at w_gate_up, 1 row, for its
    record. Returns the record of the sweep."""
    from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
    from pegainfer_tpu_torch.studies import int8_linear_study as ils
    from pegainfer_tpu_torch.studies import k6_study as k6s

    t = time.perf_counter()
    rows = k6s.dense_check(dense_stacks(family, (q8, bf)))
    k6_worst, k6_err = max(r[2] for r in rows), max(r[1] for r in rows)
    log(f"  {label} K6 at one expert against its plain version at {len(rows)} cases: max |diff| "
        f"{k6_err:.4g}, worst row at {k6_worst:.3f} of its limit {'ok' if k6_worst <= 1 else 'FAIL'}")
    if not k6_worst <= 1.0:
        raise SystemExit(f"{label} K6 at one expert disagrees with its plain version")
    stacks = linear_stacks(family, q8, bf)
    table = ils.sweep_forms(stacks, family, ceiling, calls=LINEAR_CALLS, log=log, turns=1)
    worst = max(r["row_share"] for r in table)
    err = max(r["max_abs_err"] for r in table)
    log(f"  {label} the int8 linear kernel against its plain version at {len(table)} launches x "
        f"rows: max |diff| {err:.4g}, worst row at {worst:.3f} of its limit (one bf16 ulp of "
        f"the row's max |ref|) {'ok' if worst <= 1 else 'FAIL'}")
    if not worst <= 1.0:
        raise SystemExit(f"{label} the int8 linear kernel disagrees with its plain version")
    totals = ils.step_totals(table, family)
    gates = ils.gates(totals)
    ils.log_steps(family, totals, gates, log)
    out = {"err": err, "table": table, "steps": totals, "gates": gates,
           "k6_err": k6_err, "k6_worst_share": k6_worst}
    if family == "qwen3":  # K6 alone (unscaled f32) at the records' shape
        q, _, _ = stacks["qwen3 w_gate_up"][0]
        x = torch.randn((1, q.shape[2]), device="cuda").to(torch.bfloat16)
        L = q.shape[0]
        saved = k6.launches
        out["k6_ms"] = time_ms(lambda i: k6.int8_gemv_dense(x, q[i % L]), 60)
        out["k6_plain_ms"] = time_ms(lambda i: k6.int8_gemv_dense_plain(x, q[i % L]), 6)
        k6.launches = saved
    out["phase_s"] = time.perf_counter() - t
    log(f"  {label} sweep took {out['phase_s']:.1f} s")
    return out


def linear_record(q_int8, h_int8):
    """The int8 linear kernel in the kernels line: its numbers at Qwen3-4B's
    w_gate_up at one row (the record's own), its launches on the int8 paths
    of [8f] (Qwen3) and [25b] (the hybrid), every launch and row count of
    the two sweeps under ``shapes``, each decode step's sums and gates by
    row count under ``steps`` and ``gates``, and K6 at one expert, which it
    replaced (off the main path: no launch there), under ``replaced``."""
    q, h = q_int8.pop("dense"), h_int8.pop("dense")
    main = next(r for r in q["table"] if r["shape"] == "qwen3 w_gate_up" and r["M"] == 1)
    # K6 at one expert's bytes: the codes, x in bf16 and y in f32, once
    gb = main["outs"][0] * main["IN"] + 2 * main["M"] * main["IN"] + 4 * main["M"] * main["outs"][0]
    return {"name": "int8_linear", "route": "cuda",
            "source": "pegainfer_tpu_torch/csrc/int8_linear.cu",
            "replaces": "pegainfer_tpu/ops/pallas/fp4_gemm.py:521",
            "computes": "pegainfer_tpu/ops/quant.py:117",
            "launches": q_int8["launches"]["int8_linear"], "max_abs_err": max(q["err"], h["err"]),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library_call": main["library_call"],
            "record_shape": f"qwen3 w_gate_up ({main['outs'][0]} x {main['IN']}) at M 1",
            "launches_qwen35_int8_path": h_int8["launches"]["int8_linear"],
            "shapes": {f"{r['shape']} M={r['M']}": r for r in q["table"] + h["table"]},
            "steps": {"qwen3": q["steps"], "qwen35": h["steps"]},
            "gates": {"qwen3": q["gates"], "qwen35": h["gates"]},
            "replaced": {"name": "int8_gemv_dense (K6 at one expert)",
                         "source": "pegainfer_tpu_torch/csrc/int8_gemv.cu",
                         "launches": q_int8["launches"]["moe_int8_gemv"],
                         "launches_qwen35_int8_path": h_int8["launches"]["moe_int8_gemv"],
                         "max_abs_err": max(q["k6_err"], h["k6_err"]), "ms": q["k6_ms"],
                         "plain_ms": q["k6_plain_ms"],
                         "bound_ms": gb / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}}


def read_events(contract, ch, timeout_s=600):
    """Every event of a stream up to its terminal one."""
    events = []
    while not events or not contract.is_terminal(events[-1]):
        ev = ch.get(timeout=timeout_s)
        if ev is None:
            raise SystemExit("no event from the engine within the time limit")
        events.append(ev)
    return events


def check_echo_events(contract, label, events, prompt, want_tokens, logprobs):
    """PromptTokens with the prompt's ids first, before any token; its
    logprobs None for the first and numbers after (all None without
    ``logprobs``); then the tokens and Finished. Returns the logprobs."""
    kinds = [type(ev).__name__ for ev in events]
    want = ["Scheduled", "PromptTokens"] + ["Token"] * want_tokens + ["Finished"]
    pt = events[1] if len(events) > 1 else None
    ok = kinds == want and pt.ids == prompt and len(pt.logprobs) == len(prompt) and (
        pt.logprobs[0] is None and all(
            (t is not None and t.logprob <= 0) if logprobs else t is None
            for t in pt.logprobs[1:]))
    log(f"  {label}: events {kinds[:3]} ... {kinds[-1]} ({len(events)}), PromptTokens of "
        f"{len(pt.logprobs) if pt else 0} logprobs {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label}: PromptTokens did not come first with the prompt")
    return pt.logprobs


def check_prompt_logprobs(label, got, all_logits, prompt_t):
    """An echo request's prompt logprobs against log-softmax of one run's
    [T, V] logits: |Δ logprob| <= 2 x LOGITS_RTOL x max |logit| (log-softmax
    moves by at most twice the logits' largest change). Returns the worst
    share of that limit."""
    from pegainfer_tpu_torch.ops import sampling as smp

    ref = smp.token_logprob(all_logits[:-1], prompt_t[1:]).double().cpu()
    mine = torch.tensor([t.logprob for t in got[1:]], dtype=torch.float64)
    limit = 2 * LOGITS_RTOL * all_logits.abs().max().item()
    diff = (mine - ref).abs().max().item()
    log(f"  {label}: {len(mine)} prompt logprobs against the whole all-logits run's: max "
        f"|diff| {diff:.4g}, limit 2 x {LOGITS_RTOL} x max |logit| = {limit:.4g} "
        f"({diff / limit:.3f} of it)")
    if not diff <= limit:
        raise SystemExit(f"{label}: the prompt logprobs disagree with the whole prefill's")
    return diff / limit


def run_int8_engine(label, family, cfg, model, engine, params, contract, kernels, n_linear,
                    base, bf16_step):
    """Phases 8g / 25b: the family's engine with quantize="int8" (OLD_DEFAULTS,
    its bf16 weights in ``params`` untouched, a shallow copy quantized at
    start): a warm-up, the greedy PROMPT / OUT request, then two at once
    (phase 4's SHORT; the hybrid's Q35_CONCURRENT on its slots). Launches:
    the int8 linear kernel ``n_linear`` x the decode steps within the row
    cut (``int8_path_launches``; K6 none), K1 / K2 = ``base`` x decode steps
    / prefills. Logits of the prompt's prefill and of a B = 2 decode step
    against ``plain_kernels=True`` (rule 7); the cosine of the int8 logits
    against the bf16 model's; TTFT / TPOT; a B = 1 decode step's profile
    beside the bf16 one (``bf16_step``: its device ms); a whole prefill's
    head on its last row is one more int8 linear launch. Returns (record,
    the engine's int8 tree)."""
    from pegainfer_tpu_torch.ops import quant
    from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
    from pegainfer_tpu_torch.ops.cuda import int8_linear as il

    before = model.params_bytes(params)
    opts = dict(kv_memory_fraction=0.5, seed=SEED, quantize="int8", **OLD_DEFAULTS, **EAGER)
    if family == "qwen35":
        opts["max_batch_size"] = Q35_SLOTS
    t = time.perf_counter()
    handle = engine.start_engine_from_params(cfg, shallow_tree(params),
                                             contract.EngineLoadOptions(**opts), device="cuda")
    start_s = time.perf_counter() - t
    ex = handle._scheduler.executor
    q8 = ex.params
    after = model.params_bytes(q8)
    log(f"  engine up in {start_s:.1f} s (quantize included): weights {before / 1e9:.3f} GB "
        f"bf16 -> {after / 1e9:.3f} GB int8; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    rows = []
    decode = ex._decode_model

    def logged(items, tokens, *args):
        rows.append(tokens.shape[0])
        return decode(items, tokens, *args)

    ex._decode_model = logged
    kernels = {**kernels, "int8_linear": il, "moe_int8_gemv": k6}
    if family == "qwen3":
        run = serve_slots(cfg, contract, handle, kernels, concurrent=SHORT,
                          shapes=((64, 4), (PROMPT, OUT)))
    else:
        run = serve_slots(cfg, contract, handle, kernels, concurrent=Q35_CONCURRENT,
                          shapes=(Q35_WARMUP, (PROMPT, OUT)))
    del handle, ex
    within = sum(1 for r in rows[-run["decode_steps"]:] if r <= quant.INT8_GEMV_ROWS)
    log(f"  all requests Finished with their token counts; decode batch rows "
        f"{sorted(set(rows))}, {within} of {run['decode_steps']} steps within the kernel's row "
        f"cut of {quant.INT8_GEMV_ROWS}")
    # a whole prefill's head runs on its last row alone: one launch
    check_launches(run["launches"], {**int8_path_launches(
                       n_linear, {"decode_steps": within, "prefills": run["prefills"]}),
                                     "paged_decode": base * run["decode_steps"],
                                     "flash_prefill": base * run["prefills"]},
                   f"{n_linear} int8 linear launches a decode step within the cut and 1 a "
                   f"prefill (its head's last row), none of K6, {run['prefills']} prefills, "
                   f"{run['decode_steps']} decode steps")

    log(f"  the {PROMPT}-token prefill's last logits and one decode step at B = 2, int8, "
        "kernels against plain_kernels=True")
    prompt_t = torch.tensor(run["main_prompt"], dtype=torch.int32, device="cuda")
    per = -(-(PROMPT + 1) // PAGE)
    with torch.no_grad():
        if family == "qwen3":
            def fresh():
                return model.make_kv_pages(cfg, 1 + 2 * per, PAGE, device="cuda")

            def pre(p, st, plain=False):
                return model.prefill(cfg, p, st, prompt_t, table, plain_kernels=plain)[0]
        else:
            def fresh():
                return model.make_state(cfg, 1 + 2 * per, PAGE, 2, device="cuda")

            def pre(p, st, plain=False):
                return model.prefill(cfg, p, st, prompt_t, table, 0, plain_kernels=plain)[0]
        table = torch.arange(1, 1 + per, dtype=torch.int32, device="cuda")
        st_k, st_p, st_b = fresh(), fresh(), fresh()
        lk, lp, lb = pre(q8, st_k), pre(q8, st_p, True), pre(params, st_b)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(lk).all()) and lk.shape == (cfg.vocab_size,)):
            raise SystemExit(f"{label} int8 prefill logits are not finite [V]")
        check_logits(lk, lp, LOGITS_RTOL, f"{label} int8 prefill logits disagree with the "
                     "plain kernels'")
        cos = (torch.dot(lk.double(), lb.double())
               / (lk.double().norm() * lb.double().norm())).item()
        log(f"  cosine of the int8 prefill logits with the bf16 model's on the same weights: "
            f"{cos:.6f} (the JAX package's test threshold 0.999)")
        # a B = 2 decode step: the prompt's row and a second row on a copy
        # of its pages (and, for the hybrid, of its slot), each run on its
        # own prefill (kernels / plain)
        first = int(lk.argmax())
        tables = torch.stack([table, table + per])
        for st in (st_k, st_p):
            kv = st if family == "qwen3" else st["kv"]
            kv[:, :, 1 + per:] = kv[:, :, 1:1 + per]
            if family == "qwen35":
                st["rec"][:, :, 1] = st["rec"][:, :, 0]
                st["conv"][:, :, 1] = st["conv"][:, :, 0]

        def col(*v):
            return torch.tensor(v, dtype=torch.int32, device="cuda")

        step = (col(first, (first + 1) % cfg.vocab_size), col(PROMPT, PROMPT), tables,
                col(PROMPT + 1, PROMPT + 1)) + ((col(0, 1),) if family == "qwen35" else ())
        dk = model.decode(cfg, q8, st_k, *step)
        dp = model.decode(cfg, q8, st_p, *step, plain_kernels=True)
        torch.cuda.synchronize()
        for b in range(2):
            log(f"  decode row {b}:")
            check_logits(dk[b], dp[b], LOGITS_RTOL, f"{label} int8 decode logits disagree with "
                         "the plain kernels'")
        del st_k, st_p, st_b
        dec_state = fresh()
        pre(q8, dec_state)
        one = (col(first), col(PROMPT), table[None], col(PROMPT + 1)) + (
            (col(0),) if family == "qwen35" else ())
        prof = profile_calls({f"{family} int8 decode step B=1 ctx {PROMPT + 1}":
                              lambda: model.decode(cfg, q8, dec_state, *one)},
                             iters=5, kernels={"int8_linear": "int8_linear_kernel",
                                               "K1": "paged_decode"})
    (wall, dev, n_ops, ks), = prof.values()
    gaps = run["gaps"]
    record = {"weight_bytes_bf16": before, "weight_bytes_int8": after, "engine_start_s": start_s,
              "ttft_ms": run["ttft_ms"], "tpot_p50_ms": statistics.median(gaps),
              "tpot_p95_ms": float(np.percentile(gaps, 95)), "prompt": PROMPT, "output": OUT,
              "prefills": run["prefills"], "decode_steps": run["decode_steps"],
              "decode_steps_within_cut": within, "row_cut": quant.INT8_GEMV_ROWS,
              "launches": run["launches"], "cosine_vs_bf16": cos,
              "decode_step": {"wall_ms": wall, "device_ms": dev, "device_ops": n_ops,
                              "int8_linear_ms": ks["int8_linear_ms"], "K1_ms": ks["K1_ms"],
                              "bf16_device_ms": bf16_step}}
    log(f"  int8 {PROMPT}/{OUT}: TTFT {record['ttft_ms']:.3f} ms, TPOT p50 "
        f"{record['tpot_p50_ms']:.3f} ms, p95 {record['tpot_p95_ms']:.3f} ms (host clock); "
        f"decode step B = 1: device {dev:.3f} ms (bf16 {bf16_step:.3f} ms), int8 linear "
        f"{ks['int8_linear_ms']:.3f} ms ({ks['int8_linear_ms'] / dev:.1%}), ops {n_ops:.0f}, "
        f"wall {wall:.3f} ms, idle "
        f"{1 - dev / wall:.1%}")
    return record, q8, {"main": run["main_tokens"], "concurrent": run["concurrent_tokens"]}


def watch_steps(ex):
    """Record each decode block's host-clock span (start, end) in seconds,
    from its dispatch (``ex.execute_decode_async``) to the end of its read
    (``ex._pending_rows``): a one-token block read before the next
    dispatch (``ONE_TOKEN``) spans what ``execute_decode`` did before
    decode blocks. Returns the list it appends to."""
    spans = []
    dispatch, rows = ex.execute_decode_async, ex._pending_rows

    def timed_dispatch(*args, **kwargs):
        t = time.perf_counter()
        pending = dispatch(*args, **kwargs)
        pending.dispatched_at = t
        return pending

    def timed_rows(pending):
        out = rows(pending)
        if getattr(pending, "dispatched_at", None) is not None:
            spans.append((pending.dispatched_at, time.perf_counter()))
        return out

    ex.execute_decode_async, ex._pending_rows = timed_dispatch, timed_rows
    return spans


# the kernels whose device time a step record picks out: (label, a part
# of the CUDA kernel's name)
QWEN_STEP_KERNELS = (("K1", "paged_decode"), ("int8_linear", "int8_linear_kernel"))
DSV4_STEP_KERNELS = (("K3", "fp4_gemv_kernel"), ("K4", "fp8_gemv_kernel"),
                     ("K6", "int8_gemv_kernel"), ("K8", "int8_chain_kernel"),
                     ("K9", "fp4_chain_kernel"))
# the pool of an executor_steps run: the prompt and every step it takes
STEP_PAGES = -(-(PROMPT + 2 * (STEP_WARMUP + 3 * STEP_ITERS)) // PAGE) + 2


def executor_steps(label, make_ex, contract, prompt, graphs, kernels=QWEN_STEP_KERNELS):
    """B = 1 decode steps at context PROMPT + 1 through the executor
    ``make_ex(graphs)`` builds (a pool or slots of its own), with the
    graphed step (``graphs``; a ladder, where the executor has one,
    precompiled) or the eager one, after a whole prefill of ``prompt``:
    STEP_WARMUP steps, then STEP_ITERS timed on the host clock (each ends in
    the token read, so the card is done), each split into the batch
    assembly with its host-to-device copies (``_decode_inputs``; graphed,
    and DSv4's eager step: ``_decode_host``, whose copies then count with
    the rest; both ``_decode_inputs`` since decode blocks), the forward's
    dispatch (``_decode_model``; graphed: the buffers' copy and the replay,
    ``DecodeGraphs.run``), and the wait for the token and its read
    (``resolve_pending``: ``execute_decode`` is a one-token block, sampled
    on the card after the forward); then one step with
    the forward under ``torch.cuda.set_sync_debug_mode("error")`` (a host
    read there raises); then torch.profiler over STEP_ITERS // 4 steps with
    CUDA activity (device time, operations, ``kernels``) and again with CPU
    activity (the host ops by self time); graphed, also CUDA events around
    STEP_ITERS replays of the step's graph alone. The context grows by one
    token a step. Returns the record."""
    from torch.profiler import ProfilerActivity, profile

    from pegainfer_tpu_torch.engine.executor import (DecodePlan, DecodeStepItem, PrefillPlan,
                                                      PrefillStepItem)

    ex = make_ex(graphs)
    if hasattr(ex, "precompile"):
        ex.precompile()
    sp = contract.SamplingParams()
    tok = [ex.execute_prefill(PrefillPlan(requests=[PrefillStepItem(
        request_id=0, prompt_tokens=prompt, params=sp)])).requests[0].first_token]

    def step():
        res = ex.execute_decode(DecodePlan(requests=[DecodeStepItem(
            request_id=0, token_id=tok[0], params=sp)]))
        tok[0] = res.requests[0].token

    parts = {"inputs": 0.0, "forward": 0.0, "sample_wait": 0.0}
    sync_check = [False]

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            check = sync_check[0] and name == "forward"
            t = time.perf_counter()
            if check:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                if check:
                    torch.cuda.set_sync_debug_mode("default")
                parts[name] += time.perf_counter() - t
        return wrapped

    host, fwd = ("_decode_host", "run") if graphs else ("_decode_inputs", "_decode_model")
    setattr(ex, host, timed("inputs", getattr(ex, host)))
    owner = ex._graphs if graphs else ex
    setattr(owner, fwd, timed("forward", getattr(owner, fwd)))
    ex.resolve_pending = timed("sample_wait", ex.resolve_pending)
    try:
        for _ in range(STEP_WARMUP):
            step()
        torch.cuda.synchronize()
        for k in parts:
            parts[k] = 0.0
        walls = []
        for _ in range(STEP_ITERS):
            t = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t) * 1e3)
        parts_ms = {k: v * 1e3 / STEP_ITERS for k, v in parts.items()}
        sync_check[0] = True
        step()  # raises at a host read in the forward
        sync_check[0] = False
        n = max(STEP_ITERS // 4, 1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        dev = sum(e.self_device_time_total for e in ka) / n / 1e3
        ops = sum(e.count for e in ka) / n
        kern = {lab: sum(e.self_device_time_total for e in ka if key in e.key) / n / 1e3
                for lab, key in kernels}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(n):
                step()
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:TOP_HOST_OPS]
        host_ops = [{"op": e.key, "self_ms": e.self_cpu_time_total / n / 1e3,
                     "calls": e.count / n} for e in top]
        replay_ms = None
        if graphs:  # the step's graph: B = 1 at the widest table (DSv4's: P = 0)
            gstep = ex._graphs.steps[max(k for k in ex._graphs.steps if k[0] == 1)]
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(STEP_ITERS):
                gstep.graph.replay()
            e1.record()
            e1.synchronize()
            replay_ms = e0.elapsed_time(e1) / STEP_ITERS
    finally:
        del ex.resolve_pending  # the class's method again
    wall = statistics.median(walls)
    rec = {"graphs": graphs, "wall_p50_ms": wall, "wall_min_ms": min(walls),
           "wall_max_ms": max(walls), "parts_ms": parts_ms,
           "outside_parts_ms": statistics.mean(walls) - sum(parts_ms.values()),
           "device_ms": dev, "device_ops": ops, "idle": 1 - dev / wall,
           **{f"{lab}_ms": v for lab, v in kern.items()}, "host_ops": host_ops,
           "forward_sync_free": True, "graph_captures": ex.graph_captures,
           "graph_replay_device_ms": replay_ms, "context": PROMPT + 1}
    log(f"  {label}: step wall p50 {wall:.3f} ms ({min(walls):.3f}-{max(walls):.3f}) over "
        f"{STEP_ITERS} steps; device {dev:.3f} ms in {ops:.0f} operations ("
        + ", ".join(f"{lab} {v:.3f}" for lab, v in kern.items() if v)
        + f"), idle {1 - dev / wall:.1%}"
        + (f"; the graph's replay alone {replay_ms:.3f} ms on CUDA events" if graphs else ""))
    log(f"  {label}: host parts a step (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts_ms.items())
        + f", the rest of execute_decode {rec['outside_parts_ms']:.3f}; the forward made no "
        "host sync (set_sync_debug_mode('error'))")
    for o in host_ops:
        log(f"    {label} host op: {o['self_ms']:7.3f} ms self in {o['calls']:5.0f} calls x "
            f"{o['op'][:80]}")
    del ex
    return rec


def qwen3_executor(cfg, q3, params, contract):
    """``executor_steps``' executor for Qwen3: a TorchExecutor on a pool of
    STEP_PAGES pages."""
    from pegainfer_tpu_torch.engine import torch_executor as tx

    def make(graphs):
        return tx.TorchExecutor(cfg, params, q3.make_kv_pages(cfg, STEP_PAGES, PAGE,
                                                              device="cuda"),
                                contract.EngineLoadOptions(max_batch_size=1,
                                                           enable_cuda_graph=graphs,
                                                           **OLD_DEFAULTS))
    return make


def run_host_profile(cfg, q3, params, contract, prompt):
    """Phase 8i: ``executor_steps`` of the eager step in bf16 and int8 (the
    int8 tree quantized here from a shallow copy, as the engine does).
    Returns (records, the int8 tree)."""
    q8 = q3.quantize_params_int8(shallow_tree(params))
    torch.cuda.synchronize()
    out = {mode: executor_steps(f"eager {mode}", qwen3_executor(cfg, q3, w, contract),
                                contract, prompt, graphs=False)
           for mode, w in (("bf16", params), ("int8", q8))}
    return out, q8


def serve_graphed(label, start, cfg, contract, kernels, traffic, want, expected):
    """One engine under the graph defaults, started by ``start()`` (its
    ladder, where the family has one, captured at start), serving
    ``serve_slots``' ``traffic``; the tokens must equal ``want`` (the eager
    engine's), the launches ``expected(run)`` (the path's, through the
    replays' accounting), and the memory must come back after shutdown.
    ``start`` makes any tree it quantizes itself, so that only the engine
    holds it. Returns the record."""
    # torch keeps a cuBLAS workspace for every stream that ran a cuBLAS
    # call, a graph's capture stream too, for the life of the process; no
    # graph is alive here, so the earlier ones go before the baseline
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    t = time.perf_counter()
    handle = start()
    start_s = time.perf_counter() - t
    ex = handle._scheduler.executor
    graphs = ex._graphs
    ladder = list(graphs.capture_log)
    log(f"  engine up in {start_s:.2f} s: {len(ladder)} decode graphs captured at start "
        f"(B, P, s): {[(b, p, round(sec, 3)) for b, p, _, sec, _ in ladder]}; pool "
        f"{graphs.pool_bytes / 1e6:.1f} MB")
    spans = watch_steps(ex)
    run = serve_slots(cfg, contract, handle, kernels, **traffic)
    later = graphs.capture_log[len(ladder):]
    pool_bytes = graphs.pool_bytes
    steps, prefills = run["decode_steps"], run["prefills"]
    check_launches(run["launches"], expected(run),
                   f"{prefills} prefills, {steps} decode steps, through the graphs' replays")
    same_main = run["main_tokens"] == want["main"]
    same_pair = run["concurrent_tokens"] == want["concurrent"]
    main_in, main_out = traffic.get("shapes", (None, (DSV4_PROMPT, DSV4_OUT)))[1]
    log(f"  greedy tokens equal the eager engine's: main {main_in}/{main_out} {same_main}, the "
        f"concurrent requests {same_pair}")
    if not (same_main and same_pair):
        raise SystemExit(f"{label}: the graphed engine's tokens differ from the eager engine's")
    times = run["times"]
    held = [i for i, (a, b) in enumerate(zip(times, times[1:]))
            if any(a <= end <= b for *_, end in later)]
    walls = [(b - a) * 1e3 for a, b in spans if times[0] <= a <= times[-1]]
    gaps = run["gaps"]
    rec = {"engine_start_s": start_s, "ladder": [(b, p, sec) for b, p, _, sec, _ in ladder],
           "captures_at_first_use": [(b, p, sec) for b, p, _, sec, _ in later],
           "gaps_holding_a_capture": held, "pool_bytes": pool_bytes,
           "ttft_ms": run["ttft_ms"], "tpot_p50_ms": statistics.median(gaps),
           "tpot_p95_ms": float(np.percentile(gaps, 95)),
           "step_wall_p50_ms": statistics.median(walls), "prefills": prefills,
           "decode_steps": steps, "launches": run["launches"]}
    log(f"  {main_in}/{main_out}: TTFT {rec['ttft_ms']:.3f} ms, TPOT p50 "
        f"{rec['tpot_p50_ms']:.3f} ms, p95 {rec['tpot_p95_ms']:.3f} ms; execute_decode wall p50 "
        f"{rec['step_wall_p50_ms']:.3f} ms; captured at first use (B, P, s): "
        f"{rec['captures_at_first_use']}, in the main request's gaps {held} "
        f"({[round(gaps[i], 3) for i in held]} ms)")
    del handle, ex, graphs, run
    gc.collect()
    torch.cuda.empty_cache()
    back = torch.cuda.memory_allocated() - mem0
    torch._C._cuda_clearCublasWorkspaces()  # the engine's streams' (see above)
    gc.collect()
    torch.cuda.empty_cache()
    engine_back = torch.cuda.memory_allocated() - mem0
    rec["allocated_after_shutdown_bytes"] = back
    rec["allocated_after_shutdown_without_cublas_workspaces_bytes"] = engine_back
    log(f"  after shutdown: {back / 1e6:.3f} MB more allocated than before the start, "
        f"{engine_back / 1e6:.3f} MB once torch's cuBLAS workspaces are cleared (the graphs' "
        f"pool {pool_bytes / 1e6:.1f} MB)")
    if engine_back > pool_bytes:
        raise SystemExit(f"{label}: the graphed engine's memory did not come back")
    return rec


def block_idle(ex, contract, prompt, blocks=4):
    """The device's idle share over ``blocks`` steady blocks of
    ``decode_block_max`` tokens of one greedy request of ``prompt``, driven
    on the executor as the scheduler's pipeline drives it (each block after
    the first dispatched on the last one's tokens on the card before that
    one is read), the card idle before the first. Three runs: the pipeline
    alone (its wall from the first dispatch to the end of the last read;
    each later block's dispatch and each read, the host's ms in
    ``execute_decode_async`` and ``resolve_pending_multi``); one block
    alone between CUDA events (its span on the card, copies included); the
    pipeline again under torch.profiler (CUDA activity: the kernels' device
    time against that run's wall). Returns the record."""
    from torch.profiler import ProfilerActivity, profile

    from pegainfer_tpu_torch.engine.executor import DecodeStepItem, PrefillPlan, PrefillStepItem

    rid, N = 1 << 30, ex.decode_block_max
    sp = contract.SamplingParams(ignore_eos=True)
    first = ex.execute_prefill(PrefillPlan([PrefillStepItem(
        request_id=rid, prompt_tokens=prompt, params=sp)])).requests[0].first_token
    items = [DecodeStepItem(request_id=rid, token_id=first, params=sp)]

    def pipeline():
        torch.cuda.synchronize()
        dispatch, read = [], []
        t0 = time.perf_counter()
        prev = ex.execute_decode_async(items, n_tokens=N)
        for _ in range(blocks - 1):
            t = time.perf_counter()
            nxt = ex.execute_decode_async(items, tokens_dev=prev.tokens_dev, n_tokens=N)
            dispatch.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            ex.resolve_pending_multi(prev)
            read.append((time.perf_counter() - t) * 1e3)
            prev = nxt
        t = time.perf_counter()
        ex.resolve_pending_multi(prev)
        t1 = time.perf_counter()
        read.append((t1 - t) * 1e3)
        return (t1 - t0) * 1e3, dispatch, read

    try:
        wall, dispatch, read = pipeline()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        pend = ex.execute_decode_async(items, n_tokens=N)
        e1.record()
        ex.resolve_pending_multi(pend)
        span = e0.elapsed_time(e1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prof_wall, prof_dispatch, _ = pipeline()
        busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    finally:
        ex.release_request(rid)
    return {"blocks": blocks, "wall_ms": wall, "dispatch_ms": dispatch, "read_ms": read,
            "block_span_ms": span, "idle_between_blocks": 1 - blocks * span / wall,
            "profiled_wall_ms": prof_wall, "profiled_dispatch_ms": prof_dispatch,
            "busy_ms": busy, "idle": 1 - busy / prof_wall,
            "ms_per_token": wall / (blocks * N)}


def arrival_pair(contract, handle, prompts, at):
    """Submit ``prompts`` [(prompt, max_tokens)] x 2 greedy: the second
    right after the first's ``at``-th token is sent (by the scheduler's
    thread, so the second joins at the same block in every run). Returns
    each stream's (tokens, times)."""
    (p1, m1), (p2, m2) = prompts
    second = contract.TokenChannel()

    class First(contract.TokenChannel):
        sent = 0

        def send(self, event):
            ok = super().send(event)
            if isinstance(event, contract.Token):
                self.sent += 1
                if self.sent == at:
                    handle.submit(contract.GenerateRequest(
                        prompt_tokens=p2, max_tokens=m2,
                        params=contract.SamplingParams(ignore_eos=True), channel=second))
            return ok

    first = First()
    handle.submit(contract.GenerateRequest(prompt_tokens=p1, max_tokens=m1,
                                           params=contract.SamplingParams(ignore_eos=True),
                                           channel=first))
    out = []
    for ch, n, m in ((first, len(p1), m1), (second, len(p2), m2)):
        toks, fin, times = drain(contract, ch)
        expect_finished(contract, f"arrival pair {n}/{m}", toks, fin, m)
        out.append((toks, times))
    return out


def sampled_pair(contract, handle, cfg, seed):
    """BLOCK_SAMPLED at B = 2, submitted in one drain: a sampled stream
    (BLOCK_SAMPLING) and a greedy one with BLOCK_LOGPROBS logprobs a token,
    prompts from a stream seeded ``seed``. Returns (the sampled tokens, the
    logprobs stream's tokens, its [(chosen, [(id, value)])] a token)."""
    rng = np.random.default_rng(seed)
    (n1, m1), (n2, m2) = BLOCK_SAMPLED
    chans = [contract.TokenChannel(), contract.TokenChannel()]
    reqs = [contract.GenerateRequest(
                prompt_tokens=rng.integers(0, cfg.vocab_size, n1).tolist(), max_tokens=m1,
                params=contract.SamplingParams(ignore_eos=True, **BLOCK_SAMPLING),
                channel=chans[0]),
            contract.GenerateRequest(
                prompt_tokens=rng.integers(0, cfg.vocab_size, n2).tolist(), max_tokens=m2,
                params=contract.SamplingParams(ignore_eos=True), channel=chans[1],
                logprobs=BLOCK_LOGPROBS)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(10.0)
    try:
        for r in reqs:
            handle.submit(r)
    finally:
        sys.setswitchinterval(old)
    out = []
    for ch, m in zip(chans, (m1, m2)):
        toks, lps = [], []
        for ev in read_events(contract, ch):
            if isinstance(ev, contract.Token):
                toks.append(ev.id)
                if ev.logprob is not None:
                    lps.append((ev.logprob.logprob, ev.logprob.top_logprobs))
        if len(toks) != m:
            raise SystemExit(f"a sampled-pair stream gave {len(toks)} of {m} tokens")
        out.append((toks, lps))
    if len(out[1][1]) != m2 or out[0][1]:
        raise SystemExit("the logprobs stream lacks logprobs, or the sampled one has some")
    return out[0][0], out[1][0], out[1][1]


def block_phase(label, start, start_eager, cfg, contract, kernels, expected, want, shapes,
                seed, pair="arrival", sampled=True):
    """One block phase ([8k], [25h], [13h], [18h]): the engine ``start()``
    makes (the JAX engine's block defaults, graphed) serves, with ``sampled``
    first ``sampled_pair``, then a warm-up and the main request (``shapes``,
    prompts from a stream seeded ``seed`` as ``serve_slots`` draws them):
    its tokens must equal ``want["main"]`` (the one-token graphed engine's),
    its launches ``expected`` of the tokens computed, and those equal the
    tokens emitted; then with ``pair`` "arrival" the arrival pair, with
    "concurrent" DSV4_CONCURRENT submitted together (tokens equal
    ``want["concurrent"]``); then, the scheduler stopped, ``block_idle`` on
    a prompt of the main one's length. The engine ``start_eager()``
    makes (precompile=False) serves the sampled pair and the arrival pair,
    where the phase ran them, with the same seed: their tokens must be
    equal. Prints TTFT, the JAX
    bench's steady TPOT, the gaps' p50 / p95 / max, blocks per token, the
    captures and the gaps that held them, the pool, the memory after
    shutdown. Returns the record."""
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    t = time.perf_counter()
    handle = start()
    start_s = time.perf_counter() - t
    ex = handle._scheduler.executor
    graphs = ex._graphs
    n_ladder = len(graphs.capture_log)
    log(f"  engine up in {start_s:.2f} s: blocks of {ex.decode_block}, steady "
        f"{ex.decode_block_max}, depth {ex.decode_pipeline_depth}; {n_ladder} one-token graphs "
        "captured at start")
    rng = np.random.default_rng(seed)
    (warm_in, warm_out), (main_in, main_out) = shapes

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    rec = {"engine_start_s": start_s}
    try:
        if sampled:
            got_sampled = sampled_pair(contract, handle, cfg, seed + 7)
        ch, _ = run_request(contract, handle, prompt(warm_in), warm_out)
        toks, fin, _ = drain(contract, ch)
        expect_finished(contract, f"warm-up {warm_in}/{warm_out}", toks, fin, warm_out)
        main_prompt = prompt(main_in)
        # the main request twice, as the JAX bench warms its shapes: the
        # first run holds the first-use captures, the second is timed
        ch, _ = run_request(contract, handle, main_prompt, main_out)
        first_toks, fin, first_times = drain(contract, ch)
        expect_finished(contract, f"main {main_in}/{main_out} (first)", first_toks, fin,
                        main_out)
        for mod in kernels.values():
            mod.launches = 0
        ex.prefills = ex.decode_steps = ex.decode_blocks = 0
        ch, t0 = run_request(contract, handle, main_prompt, main_out)
        toks, fin, times = drain(contract, ch)
        expect_finished(contract, f"main {main_in}/{main_out}", toks, fin, main_out)
        main_steps, main_blocks = ex.decode_steps, ex.decode_blocks
        log(f"  main {main_in}/{main_out}: greedy tokens equal the one-token graphed "
            f"engine's: {toks == want['main']} (the first run's {first_toks == want['main']}); "
            f"{main_steps} tokens computed a row for {main_out - 1} emitted after the first, "
            f"in {main_blocks} blocks")
        if toks != want["main"] or first_toks != want["main"]:
            raise SystemExit(f"{label}: the block engine's tokens differ from the one-token "
                             "graphed engine's")
        if main_steps != main_out - 1:
            raise SystemExit(f"{label}: tokens computed differ from tokens emitted")
        if pair == "arrival":
            got_pair = arrival_pair(contract, handle, [(prompt(n), m) for n, m in BLOCK_PAIR],
                                    BLOCK_ARRIVAL_AT)
        elif pair == "concurrent":
            chans = submit_together(contract, handle, [(prompt(n), m) for n, m in
                                                       DSV4_CONCURRENT])
            conc = []
            for c, n, m in chans:
                toks_c, fin_c, _ = drain(contract, c)
                expect_finished(contract, f"concurrent {n}/{m}", toks_c, fin_c, m)
                conc.append(toks_c)
            same = conc == want["concurrent"]
            log(f"  the concurrent requests' greedy tokens equal the one-token graphed "
                f"engine's: {same}")
            if not same:
                raise SystemExit(f"{label}: the concurrent tokens differ from the one-token "
                                 "graphed engine's")
        launches = {name: mod.launches for name, mod in kernels.items()}
        run = {"decode_steps": ex.decode_steps, "prefills": ex.prefills}
        check_launches(launches, expected(run), f"{run['prefills']} prefills, "
                       f"{run['decode_steps']} tokens computed a row in {ex.decode_blocks} "
                       "blocks, through the block graphs' replays")
    finally:
        handle.shutdown()
        handle._thread.join(timeout=60)
    # the scheduler has stopped: its executor is this thread's now
    idle = block_idle(ex, contract, prompt(main_in))
    later = graphs.capture_log[n_ladder:]
    captures = []
    for (b, p, n, sec, end), (body, inst) in zip(later, graphs.capture_split[n_ladder:]):
        held = [i for i, (a, c) in enumerate(zip(first_times, first_times[1:]))
                if a <= end <= c]
        captures.append({"key": [b, p, n], "seconds": sec, "capturing_s": body,
                         "instantiating_s": inst, "main_gap": held[0] if held else None})
    k = min(2, len(times) - 2)  # pegainfer_tpu/bench/serving.py: skip the first stamps
    steady = (times[-1] - times[k]) * 1e3 / (len(times) - 1 - k)
    gaps = [(b - a) * 1e3 for a, b in zip(times[k:], times[k + 1:])]
    rec.update({
        "ttft_ms": (times[0] - t0) * 1e3, "steady_tpot_ms": steady,
        "gap_p50_ms": statistics.median(gaps), "gap_p95_ms": float(np.percentile(gaps, 95)),
        "gap_max_ms": max(gaps), "blocks_per_token": main_blocks / main_steps,
        "main_blocks": main_blocks, "idle": idle["idle"], "pipeline": idle,
        "captures": captures, "pool_bytes": graphs.pool_bytes,
        "launches": launches, "decode_steps": run["decode_steps"],
        "prefills": run["prefills"]})
    log(f"  {main_in}/{main_out}: TTFT {rec['ttft_ms']:.3f} ms, steady TPOT {steady:.3f} ms "
        f"(the JAX bench's, from the third token), gaps p50 {rec['gap_p50_ms']:.3f} / p95 "
        f"{rec['gap_p95_ms']:.3f} / max {rec['gap_max_ms']:.3f} ms; "
        f"{rec['blocks_per_token']:.4f} blocks a token")
    log(f"  {idle['blocks']} steady blocks of {ex.decode_block_max} pipelined on the executor: "
        f"{idle['wall_ms']:.1f} ms, {idle['ms_per_token']:.3f} ms a token; a block alone "
        f"spans {idle['block_span_ms']:.2f} ms on the card, so {idle['idle_between_blocks']:.1%} "
        f"idle between blocks; dispatches {', '.join(f'{x:.2f}' for x in idle['dispatch_ms'])} "
        f"ms, reads {', '.join(f'{x:.2f}' for x in idle['read_ms'])} ms; under torch.profiler "
        f"the kernels take {idle['busy_ms']:.1f} of {idle['profiled_wall_ms']:.1f} ms, device "
        f"idle {idle['idle']:.1%} (dispatches "
        f"{', '.join(f'{x:.2f}' for x in idle['profiled_dispatch_ms'])} ms)")
    log(f"  block graphs captured at first use (B, P, N, s (capturing + instantiating), the "
        f"first main run's gap): "
        + ", ".join(f"({c['key'][0]}, {c['key'][1]}, {c['key'][2]}, {c['seconds']:.3f} "
                    f"({c['capturing_s']:.3f} + {c['instantiating_s']:.3f}), {c['main_gap']})"
                    for c in captures)
        + f"; pool {graphs.pool_bytes / 1e6:.1f} MB")
    if pair == "arrival":
        (t1, s1), (t2, s2) = got_pair
        g1 = [(b - a) * 1e3 for a, b in zip(s1, s1[1:])]
        rec["arrival_first_gap_max_ms"] = max(g1)
        log(f"  arrival pair: the first stream's largest gap {max(g1):.3f} ms (the second "
            f"joined after its token {BLOCK_ARRIVAL_AT}), steady TPOT of the second "
            f"{(s2[-1] - s2[2]) * 1e3 / (len(s2) - 3):.3f} ms")
    del handle, ex, graphs
    gc.collect()
    torch.cuda.empty_cache()
    back = torch.cuda.memory_allocated() - mem0
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    torch.cuda.empty_cache()
    engine_back = torch.cuda.memory_allocated() - mem0
    rec["allocated_after_shutdown_bytes"] = back
    rec["allocated_after_shutdown_without_cublas_workspaces_bytes"] = engine_back
    log(f"  after shutdown: {back / 1e6:.3f} MB more allocated than before the start, "
        f"{engine_back / 1e6:.3f} MB once torch's cuBLAS workspaces are cleared")
    if engine_back > rec["pool_bytes"]:
        raise SystemExit(f"{label}: the block engine's memory did not come back")
    if start_eager is None:
        return rec
    handle = start_eager()
    try:
        eager_sampled = sampled_pair(contract, handle, cfg, seed + 7) if sampled else None
        if pair == "arrival":
            rng = np.random.default_rng(seed)
            prompt(warm_in), prompt(main_in)  # the graphed run's draws before the pair
            got_eager = arrival_pair(contract, handle,
                                     [(prompt(n), m) for n, m in BLOCK_PAIR], BLOCK_ARRIVAL_AT)
    finally:
        handle.shutdown()
        handle._thread.join(timeout=60)
    if pair == "arrival":
        same_pair = [t for t, _ in got_pair] == [t for t, _ in got_eager]
        log(f"  the arrival pair's greedy tokens equal the eager block engine's: {same_pair}")
        if not same_pair:
            raise SystemExit(f"{label}: the arrival pair differs from the eager block engine's")
    if sampled:
        (gs, gl_toks, gl), (es, el_toks, el) = got_sampled, eager_sampled
        lp_diff = max(max(abs(a[0] - b[0]), *(abs(x[1] - y[1]) for x, y in zip(a[1], b[1])))
                      for a, b in zip(gl, el))
        ids_same = all([i for i, _ in a[1]] == [i for i, _ in b[1]] for a, b in zip(gl, el))
        rec["sampled_equal"], rec["logprobs_max_diff"] = gs == es, lp_diff
        log(f"  against the eager block engine with the same seed: sampled tokens equal "
            f"{gs == es}, logprobs stream tokens equal {gl_toks == el_toks}, top ids equal "
            f"{ids_same}, largest logprob difference {lp_diff:.3e}")
        if not (gs == es and gl_toks == el_toks):
            raise SystemExit(f"{label}: the sampled or logprobs stream differs from the eager "
                             "block engine's")
    del handle
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# [8k]'s depth: Qwen3-4B's first 12 of 36 layers at full width keep the
# smoke within its time limit beside [29] (its block graphs, captures and
# eager twin a third of the full depth's; the oracle made at that depth)
BLOCK_LAYERS = 12


def cut_depth(cfg, params, n):
    """A Qwen3 config and tree of the first ``n`` layers (the layer stacks'
    leading views; the embedding, norms and head shared)."""
    import dataclasses

    return (dataclasses.replace(cfg, num_hidden_layers=n),
            {**params, "layers": {k: v[:n] for k, v in params["layers"].items()}})


def block_oracles(cfg, q3e, params, contract):
    """[8k]'s oracles at ``cfg``'s depth: the one-token eager engine's
    (``OLD_DEFAULTS``, ``EAGER``) main-request streams on [4]'s (bf16) and
    [8f]'s (int8, quantized at start) prompts, as [4] and [8f] make them at
    full depth. Returns (bf16, int8) token records."""
    out = []
    for mode, seed in ((None, SEED), ("int8", SEED + 3)):
        handle = q3e.start_engine_from_params(
            cfg, shallow_tree(params), contract.EngineLoadOptions(
                kv_memory_fraction=0.5, seed=SEED, quantize=mode, **OLD_DEFAULTS, **EAGER),
            device="cuda")
        run = serve_slots(cfg, contract, handle, {}, concurrent=(),
                          shapes=((64, 4), (PROMPT, OUT)), seed=seed)
        out.append({"main": run["main_tokens"], "concurrent": []})
    return out


def run_blocks_qwen3(cfg, q3e, params, contract, kernels, eager_tokens, int8_tokens):
    """Phase 8k: ``block_phase`` on Qwen3-4B in bf16 (the main request's
    oracle [8j]'s, equal to [4]'s; K1 / K2 counted) and int8 (the oracle
    [8f]'s; the int8 linear kernel 145 x tokens computed + 1 a prefill, K6
    none). Returns the record."""
    L = cfg.num_hidden_layers

    def start(graphs=True, **opts):
        return lambda: q3e.start_engine_from_params(
            cfg, shallow_tree(params), contract.EngineLoadOptions(
                kv_memory_fraction=0.5, seed=SEED, precompile=graphs, **WHOLE, **opts),
            device="cuda")

    def expected(n_linear):
        return lambda run: {"paged_decode": L * run["decode_steps"],
                            "flash_prefill": L * run["prefills"],
                            **(int8_path_launches(n_linear, run) if n_linear else {})}

    out = {}
    for mode, opts, want, seed, n_linear in (("bf16", {}, eager_tokens, SEED, 0),
                                             ("int8", {"quantize": "int8"}, int8_tokens,
                                              SEED + 3, qwen3_int8_launches(cfg))):
        log(f"  {mode}:")
        ks = kernels if n_linear else {k: kernels[k] for k in ("paged_decode", "flash_prefill")}
        out[mode] = block_phase(f"[8k] {mode}", start(**opts), start(False, **opts), cfg,
                                contract, ks, expected(n_linear), {"main": want["main"]},
                                ((64, 4), (PROMPT, OUT)), seed,
                                pair=None if n_linear else "arrival")
    return out


# ── phase 26: checkpoints and the serving entry point ───────────────────


# [26a]: Qwen3-4B at full width cut to CKPT_LAYERS layers, written as a
# sharded safetensors checkpoint; [26c]: the CLI's engine options with the
# pool cut to HTTP_PAGES pages (beside the weights the smoke holds)
CKPT_LAYERS = 2
CKPT_REQUEST = (64, 16)
HTTP_PAGES = 256
HTTP_PAIR = ((300, 64), (500, 64))
HTTP_ECHO_OUT = 4
HTTP_STOP_OUT = 16
_ST_DTYPES = {torch.bfloat16: "BF16", torch.float32: "F32"}


def write_safetensors(path, tensors):
    """A safetensors file of CPU ``tensors`` (the format's header, then the
    bytes in order), written without the safetensors package."""
    write_raw_safetensors(path, [(name, _ST_DTYPES[t.dtype], list(t.shape), t)
                                 for name, t in tensors.items()])


def write_raw_safetensors(path, entries):
    """A safetensors file of ``entries`` [(name, dtype name, shape, tensor)]:
    each tensor's bytes as stored (on any device; moved to the host one at a
    time as it is written), under the given dtype and shape, so a packed F4
    tensor of uint8 [..., n / 2] is written with its logical shape."""
    header, off = {}, 0
    for name, dtype, shape, t in entries:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": dtype, "shape": shape, "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for _, _, _, t in entries:
            f.write(t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(head) + off


def hf_state_dict(cfg, params, layers):
    """The first ``layers`` layers of a Qwen3 tree in the HF checkpoint's
    names and [out, in] layout, on the host (tied: no ``lm_head``)."""
    ly, inter = params["layers"], cfg.intermediate_size
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_ln"]}
    for i in range(layers):
        pre = f"model.layers.{i}."
        gate_up = ly["w_gate_up"][i]
        sd.update({
            pre + "input_layernorm.weight": ly["input_ln"][i],
            pre + "self_attn.q_proj.weight": ly["wq"][i].T,
            pre + "self_attn.k_proj.weight": ly["wk"][i].T,
            pre + "self_attn.v_proj.weight": ly["wv"][i].T,
            pre + "self_attn.o_proj.weight": ly["wo"][i].T,
            pre + "self_attn.q_norm.weight": ly["q_norm"][i],
            pre + "self_attn.k_norm.weight": ly["k_norm"][i],
            pre + "post_attention_layernorm.weight": ly["post_ln"][i],
            pre + "mlp.gate_proj.weight": gate_up[:, :inter].T,
            pre + "mlp.up_proj.weight": gate_up[:, inter:].T,
            pre + "mlp.down_proj.weight": ly["w_down"][i].T,
        })
    return {k: v.contiguous().cpu() for k, v in sd.items()}


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8), b.contiguous().reshape(-1).view(torch.uint8))


def greedy_tokens(contract, handle, prompt, n):
    ch, _ = run_request(contract, handle, prompt, n)
    toks, fin, _ = drain(contract, ch)
    expect_finished(contract, f"{len(prompt)}/{n}", toks, fin, n)
    return toks


def run_checkpoint(cfg, q3, q3e, params, contract):
    """Phase 26a: write, load and serve a CKPT_LAYERS-layer cut of the
    Qwen3-4B weights as an HF checkpoint. Returns the record."""
    import dataclasses
    import tempfile

    from pegainfer_tpu_torch.utils.weights import load_state_dict

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=CKPT_LAYERS)
    sd = hf_state_dict(cfg, params, CKPT_LAYERS)
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    hf_config = {"architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
                 "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
                 "num_hidden_layers": CKPT_LAYERS, "num_attention_heads": cfg.num_attention_heads,
                 "num_key_value_heads": cfg.num_key_value_heads, "head_dim": cfg.head_dim,
                 "vocab_size": cfg.vocab_size, "rms_norm_eps": cfg.rms_norm_eps,
                 "rope_theta": cfg.rope_theta, "tie_word_embeddings": cfg.tie_word_embeddings,
                 "eos_token_id": cfg.eos_token_id,
                 "max_position_embeddings": cfg.max_position_embeddings,
                 "torch_dtype": "bfloat16"}
    shards = {"model-00001-of-00002.safetensors":
              [k for k in sd if not k.startswith("model.layers.")],
              "model-00002-of-00002.safetensors": [k for k in sd if k.startswith("model.layers.")]}
    opts = contract.EngineLoadOptions(max_num_pages=64, max_batch_size=2, seed=SEED)
    rng = np.random.default_rng(SEED + 26)
    prompt = rng.integers(0, cfg.vocab_size, CKPT_REQUEST[0]).tolist()
    with tempfile.TemporaryDirectory(prefix="pegainfer-ckpt-") as d:
        t = time.perf_counter()
        (Path(d) / "config.json").write_text(json.dumps(hf_config))
        weight_map = {}
        for name, keys in shards.items():
            write_safetensors(str(Path(d) / name), {k: sd[k] for k in keys})
            weight_map.update({k: name for k in keys})
        (Path(d) / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {"total_size": nbytes}, "weight_map": weight_map}))
        write_s = time.perf_counter() - t
        log(f"  wrote {len(sd)} tensors, {nbytes / 1e9:.3f} GB in 2 shards with an index, in "
            f"{write_s:.2f} s")
        # the engine's load: the files read by the port's reader and moved
        # to the card (the files were just written: the page cache is warm)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loaded = q3.params_from_state_dict(q3.Qwen3Config.from_model_path(d),
                                           load_state_dict(d), device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        log(f"  load (read, stack, to the card): {load_s:.3f} s, {nbytes / load_s / 1e9:.2f} GB/s "
            "(warm page cache)")
        host = load_state_dict(d)
        bad = [k for k in sd if not same_bits(host[k], sd[k])]
        if sorted(host) != sorted(sd) or bad:
            raise SystemExit(f"[26a] the reader's tensors differ from the written ones: {bad}")
        ref = q3.params_from_state_dict(cfg2, sd, device="cuda")
        bad = [f"leaf {i}" for i, (a, b) in enumerate(zip(tensors_of(loaded), tensors_of(ref)))
               if not same_bits(a, b)]
        del loaded, host
        handle = q3e.start_engine(d, opts, device="cuda")
        try:
            ex_params = handle._scheduler.executor.params
            bad += [f"engine leaf {i}" for i, (a, b) in enumerate(zip(tensors_of(ex_params),
                                                                      tensors_of(ref)))
                    if not same_bits(a, b)]
            disk = greedy_tokens(contract, handle, prompt, CKPT_REQUEST[1])
        finally:
            handle.shutdown()
            handle._thread.join(timeout=60)
    log(f"  every tensor read back bit for bit ({len(sd)} by the reader, "
        f"{len(list(tensors_of(ref)))} stacked leaves, the engine's too): {not bad}")
    if bad:
        raise SystemExit(f"[26a] loaded tensors differ from the written ones: {bad}")
    handle = q3e.start_engine_from_params(cfg2, ref, opts, device="cuda")
    try:
        mem = greedy_tokens(contract, handle, prompt, CKPT_REQUEST[1])
    finally:
        handle.shutdown()
        handle._thread.join(timeout=60)
    log(f"  {CKPT_REQUEST[0]}/{CKPT_REQUEST[1]} greedy from the checkpoint equals "
        f"start_engine_from_params on the same tensors: {disk == mem}")
    if disk != mem:
        raise SystemExit("[26a] the checkpoint's tokens differ from the in-memory engine's")
    del handle, ref
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": CKPT_LAYERS, "bytes": nbytes, "tensors": len(sd), "write_s": write_s,
            "load_s": load_s, "load_gb_per_s": nbytes / load_s / 1e9, "page_cache": "warm",
            "tokens_equal": True}


def http_call(port, method, path, body=None, timeout_s=600):
    """One request on a fresh connection: (status, headers, parsed body,
    wall seconds from the request to the body's end)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout_s)
    try:
        data = body if body is None or isinstance(body, bytes) else json.dumps(body).encode()
        t0 = time.perf_counter()
        conn.request(method, path, body=data,
                     headers={} if data is None else {"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read()
        wall = time.perf_counter() - t0
        ctype = r.getheader("Content-Type", "")
        parsed = json.loads(raw) if ctype.startswith("application/json") else raw.decode()
        return r.status, dict(r.getheaders()), parsed, wall
    finally:
        conn.close()


def http_stream(port, body, timeout_s=600):
    """A streamed completion: (status, events (JSON or "[DONE]"), each
    event's arrival time, the request's time), read chunk by chunk."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout_s)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/completions", body=json.dumps({**body, "stream": True}).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        if not r.getheader("Content-Type", "").startswith("text/event-stream"):
            return r.status, [r.read().decode()], [], t0
        buf, events, times = b"", [], []
        while True:
            data = r.read1(65536)
            if not data:
                break
            now = time.perf_counter()
            buf += data
            while b"\n\n" in buf:
                block, buf = buf.split(b"\n\n", 1)
                text = block.decode()
                if not text.startswith("data: "):
                    raise SystemExit(f"a malformed SSE event {text!r}")
                text = text[len("data: "):]
                events.append(text if text == "[DONE]" else json.loads(text))
                times.append(now)
        return r.status, events, times, t0
    finally:
        conn.close()


def stream_text(label, status, events, want_finish="length"):
    """The streamed text, after checking the stream's form: 200, text
    chunks, the finish reason, ``data: [DONE]`` last."""
    if status != 200 or not events or events[-1] != "[DONE]":
        raise SystemExit(f"{label}: status {status}, stream {events[-3:]!r}")
    chunks = [e for e in events[:-1] if e.get("choices")]
    if chunks[-1]["choices"][0]["finish_reason"] != want_finish:
        raise SystemExit(f"{label}: finish reason {chunks[-1]['choices'][0]['finish_reason']}")
    return "".join(e["choices"][0]["text"] for e in chunks)


def text_ids(text):
    """Token ids from ``SimTokenizer``'s ``tok<id>`` text."""
    return [int(w[3:]) for w in text.split()]


def run_cli():
    """Phase 26b: the CLI as an operator starts it, ``--sim`` on a free
    port, in a process of its own; one blocking and one streamed completion;
    SIGINT must end it with exit code 0. Returns the record."""
    import queue
    import re
    import signal
    import threading

    cmd = [sys.executable, "-m", "pegainfer_tpu_torch.server.main", "--sim", "--host",
           "127.0.0.1", "--port", "0"]
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True)
    reader.start()
    out = []
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None:
            try:
                line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise SystemExit(f"[26b] the CLI did not report its port: {out[-5:]}") from None
            out.append(line.rstrip())
            m = re.search(r"serving \S+ on http://[\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        up_s = time.perf_counter() - t
        status, _, health, _ = http_call(port, "GET", "/health")
        status_b, _, blocking, _ = http_call(port, "POST", "/v1/completions",
                                             {"prompt": [5, 6, 7], "max_tokens": 8})
        status_s, events, _, _ = http_stream(port, {"prompt": [5, 6, 7], "max_tokens": 8})
        streamed = stream_text("[26b] stream", status_s, events)
        ok = (status, health, status_b) == (200, {"status": "ok"}, 200) and \
            blocking["choices"][0]["text"] == streamed and len(streamed.split()) == 8
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=10)
    while not lines.empty():
        out.append(lines.get().rstrip())
    log(f"  `{' '.join(cmd[1:])}` up in {up_s:.2f} s on port {port}; /health, a blocking and "
        f"a streamed 3/8 completion (texts equal: {ok}); exit code {rc} after SIGINT")
    if not ok or rc != 0:
        raise SystemExit(f"[26b] the CLI failed: rc {rc}, output {out[-10:]}")
    return {"start_s": up_s, "exit_code": rc}


def forget_prefixes(handle, timeout_s=60):
    """Empty the engine's prefix cache between requests: once the scheduler
    has retired every request (its releases done), it only waits for the
    next submission, so the cache is not touched meanwhile."""
    sched = handle._scheduler
    deadline = time.monotonic() + timeout_s
    while sched.active or sched.deferred:
        if time.monotonic() > deadline:
            raise SystemExit("the scheduler did not go idle")
        time.sleep(0.01)
    time.sleep(0.2)  # past the loop's drain into its blocking receive
    sched.executor.prefix_cache.clear()


def run_http(cfg, q3e, params, contract, kernels, main_prompt, want_main):
    """Phase 26c: ``OpenAIApp`` on ``httpd.serve`` in front of a Qwen3-4B
    engine (the CLI's options, HTTP_PAGES pages). Returns (the record, K1 /
    K2 launches)."""
    import threading

    from pegainfer_tpu_torch.server import httpd
    from pegainfer_tpu_torch.server import main as server_main
    from pegainfer_tpu_torch.server.api import OpenAIApp
    from pegainfer_tpu_torch.server.tokenizer import SimTokenizer

    L = cfg.num_hidden_layers
    args = server_main.parse_args(["--model-path", "Qwen3-4B", "--max-num-pages", str(HTTP_PAGES)])
    opts = server_main.load_options(args)
    t = time.perf_counter()
    handle = q3e.start_engine_from_params(cfg, shallow_tree(params), opts, device="cuda")
    start_s = time.perf_counter() - t
    ex = handle._scheduler.executor
    firsts = []  # each prompt's last logits, in the order prefilled
    first_token = ex._first_token

    def logged_first(item, last_logits):
        firsts.append(last_logits.clone())
        return first_token(item, last_logits)

    ex._first_token = logged_first
    app = OpenAIApp(handle, SimTokenizer(vocab_size=cfg.vocab_size), "Qwen3-4B").build()
    server = httpd.serve(app, "127.0.0.1", 0, threads=max(64, opts.max_batch_size))
    port = server.port
    log(f"  engine up in {start_s:.2f} s with the CLI's options ({opts}); the tokenizer is "
        "SimTokenizer (no transformers on this machine): prompts go as token lists and the "
        "tok<id> text gives the ids back")
    rng = np.random.default_rng(SEED + 27)
    body = {"prompt": main_prompt, "max_tokens": OUT, "logprobs": 1, "ignore_eos": True}
    sent = {"requests": 0, "prompt_tokens": 0, "completion_tokens": 0, "rejected": 0}

    def count(prompt_len, blocking_tokens=0, rejected=0):
        sent["requests"] += 1
        sent["prompt_tokens"] += prompt_len
        sent["completion_tokens"] += blocking_tokens
        sent["rejected"] += rejected

    rec = {"engine_start_s": start_s, "options": str(opts), "tokenizer": "SimTokenizer"}
    try:
        status, _, health, _ = http_call(port, "GET", "/health")
        status_m, _, models, _ = http_call(port, "GET", "/v1/models")
        if (status, health, status_m, models["data"][0]["id"]) != (
                200, {"status": "ok"}, 200, "Qwen3-4B"):
            raise SystemExit(f"[26c] /health or /v1/models: {health}, {models}")
        for mod in kernels.values():
            mod.launches = 0
        ex.prefills = ex.chunk_pieces = ex.mixed_pieces = ex.decode_steps = ex.decode_blocks = 0
        # the main request, blocking: a miss, prefilled whole
        n_miss = len(firsts)
        status, _, blocking, wall_miss = http_call(port, "POST", "/v1/completions", body)
        miss_logits = firsts[n_miss]
        count(PROMPT, OUT)
        ch = blocking["choices"][0]
        ids, lps = text_ids(ch["text"]), ch["logprobs"]["token_logprobs"]
        ok = (status == 200 and ch["finish_reason"] == "length" and ids == want_main
              and len(lps) == OUT and all(np.isfinite(v) and v <= 0 for v in lps))
        log(f"  blocking {PROMPT}/{OUT} with logprobs 1: status {status}, {len(ids)} ids equal "
            f"[4]'s main-request tokens: {ids == want_main}, logprobs finite and "
            f"<= 0: {all(np.isfinite(v) and v <= 0 for v in lps)}; wall {wall_miss * 1e3:.1f} ms")
        if not ok:
            raise SystemExit("[26c] the blocking request's tokens or logprobs are wrong")
        # the same request streamed, then on the handle, each a miss too: a
        # prefix-cache hit computes the prompt's last piece in another shape
        # (another rounding), so the cache is emptied first, with the
        # scheduler idle
        forget_prefixes(handle)
        status, events, times, t0 = http_stream(port, body)
        count(PROMPT)
        text = stream_text("[26c] stream", status, events)
        log(f"  streamed (a miss): {len(events)} SSE events, [DONE] last; the joined text equals "
            f"the blocking text: {text == ch['text']}")
        if text != ch["text"]:
            raise SystemExit("[26c] the streamed text differs from the blocking text")
        token_times = [tm for e, tm in zip(events, times)
                       if e != "[DONE]" and e.get("choices") and e["choices"][0]["text"]]
        forget_prefixes(handle)
        ch_h, t0_h = run_request(contract, handle, main_prompt, OUT, logprobs=1)
        toks_h, fin_h, times_h = drain(contract, ch_h)
        expect_finished(contract, f"handle {PROMPT}/{OUT} (a miss)", toks_h, fin_h, OUT)
        if toks_h != want_main:
            raise SystemExit("[26c] the handle's tokens differ from [8k]'s")
        # blocking again, a miss: its wall beside the handle's (the first
        # one's held the block graphs' first-use captures)
        forget_prefixes(handle)
        status, _, again, wall_miss2 = http_call(port, "POST", "/v1/completions", body)
        count(PROMPT, OUT)
        if status != 200 or again["choices"][0]["text"] != ch["text"]:
            raise SystemExit("[26c] the repeated blocking request gave other tokens")
        # streamed again: a prefix-cache hit (reported against the miss)
        n_hit = len(firsts)
        status, events, _, _ = http_stream(port, body)
        count(PROMPT)
        hit_text = stream_text("[26c] stream (hit)", status, events)
        hit_ids = text_ids(hit_text)
        first_diff = next((i for i, (a, b) in enumerate(zip(hit_ids, want_main)) if a != b), None)
        log(f"  streamed again (a hit, {ex.prefix_cache.hits} so far): tokens equal the miss's: "
            f"{hit_ids == want_main}" + ("" if first_diff is None else
                                         f", first differing at token {first_diff}")
            + " (reported, not gated); the hit's first logits against the miss's, rule 7 "
            "(reported):")
        hit_rule = logits_rule(firsts[n_hit], miss_logits, LOGITS_RTOL)
        log(f"  within rule 7: {hit_rule['ok']}")
        # echo with logprobs, against the same request on the handle
        echo_body = {**body, "max_tokens": HTTP_ECHO_OUT, "echo": True}
        status, _, echo, _ = http_call(port, "POST", "/v1/completions", echo_body)
        count(PROMPT, HTTP_ECHO_OUT)
        ch_e = contract.TokenChannel()
        handle.submit(contract.GenerateRequest(
            prompt_tokens=main_prompt, max_tokens=HTTP_ECHO_OUT, logprobs=1, echo=True,
            params=contract.SamplingParams(ignore_eos=True), channel=ch_e))
        ev_e = read_events(contract, ch_e)
        pt = next(e for e in ev_e if isinstance(e, contract.PromptTokens))
        want_lp = [None if lp is None else lp.logprob for lp in pt.logprobs]
        got_lp = echo["choices"][0]["logprobs"]["token_logprobs"] if status == 200 else []
        echo_ok = (status == 200 and got_lp[:PROMPT] == want_lp and len(got_lp) ==
                   PROMPT + HTTP_ECHO_OUT and want_lp[0] is None)
        log(f"  echo with logprobs 1: {PROMPT} prompt logprobs equal a handle-submitted echo "
            f"request's: {echo_ok}")
        if not echo_ok:
            raise SystemExit("[26c] the echo request's prompt logprobs differ from the handle's")
        # a stop string that cuts the text (a hit, as the stream before)
        text16 = " ".join(hit_text.split()[:HTTP_STOP_OUT])
        stop = text16.split()[2]
        status, _, cut, _ = http_call(port, "POST", "/v1/completions",
                                      {**body, "max_tokens": HTTP_STOP_OUT, "stop": stop})
        count(PROMPT, HTTP_STOP_OUT)
        stop_ok = (status == 200 and cut["choices"][0]["finish_reason"] == "stop"
                   and cut["choices"][0]["text"] == text16[:text16.find(stop)])
        log(f"  stop {stop!r}: finish_reason {cut['choices'][0]['finish_reason']}, the text cut "
            f"before it: {stop_ok}")
        if not stop_ok:
            raise SystemExit("[26c] the stop string did not cut the text")
        # two concurrent streams, then each alone on the handle (B = 1)
        pair = [(rng.integers(0, cfg.vocab_size, n).tolist(), m) for n, m in HTTP_PAIR]
        results = [None, None]

        def go(i, p, m):
            results[i] = http_stream(port, {"prompt": p, "max_tokens": m, "ignore_eos": True})

        threads = [threading.Thread(target=go, args=(i, p, m)) for i, (p, m) in enumerate(pair)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        pair_ids, pair_equal = [], []
        for (p, m), res in zip(pair, results):
            count(len(p))
            if res is None:
                raise SystemExit("[26c] a concurrent stream did not end")
            got = text_ids(stream_text(f"[26c] stream {len(p)}/{m}", res[0], res[1]))
            if len(got) != m:
                raise SystemExit(f"[26c] a concurrent stream gave {len(got)} of {m} tokens")
            pair_ids.append(got)
            pair_equal.append(got == greedy_tokens(contract, handle, p, m))
        log(f"  concurrent streams {HTTP_PAIR}: each finished with its count; tokens equal "
            f"their B = 1 handle runs: {pair_equal} (reported, not gated)")
        # refusals
        too_long = rng.integers(0, cfg.vocab_size, ex.max_request_pages() * PAGE + 1).tolist()
        status_l, _, long_err, _ = http_call(port, "POST", "/v1/completions",
                                             {"prompt": too_long, "max_tokens": 16})
        count(len(too_long), rejected=1)
        status_j, _, json_err, _ = http_call(port, "POST", "/v1/completions", b"{not json")
        log(f"  a {len(too_long)}-token prompt: {status_l} ({long_err['error']['message'][:60]}"
            f"...); a bad JSON body: {status_j} ({json_err['error']['message']})")
        if status_l != 400 or "KV pages" not in long_err["error"]["message"] or status_j != 400:
            raise SystemExit("[26c] a refused request did not get its 400")
        status, _, metrics, _ = http_call(port, "GET", "/metrics")
        got_m = {"requests": metrics["requests_total"],
                 "prompt_tokens": metrics["prompt_tokens_total"],
                 "completion_tokens": metrics["completion_tokens_total"],
                 "rejected": metrics["requests_rejected"]}
        log(f"  /metrics {got_m}; sent {sent}")
        if status != 200 or got_m != sent or metrics["requests_errored"] != 0:
            raise SystemExit("[26c] /metrics does not count the requests sent")
        launches = {name: mod.launches for name, mod in kernels.items()}
        counts = {"prefills": ex.prefills, "chunk_pieces": ex.chunk_pieces,
                  "mixed_pieces": ex.mixed_pieces, "decode_steps": ex.decode_steps,
                  "cache_hits": ex.prefix_cache.hits}
        check_launches(launches, {
            "flash_prefill": L * (counts["prefills"] + counts["chunk_pieces"]),
            "paged_decode": L * (counts["decode_steps"] + counts["mixed_pieces"])},
            f"{counts}: {L} x (whole prefills + pieces) K2, {L} x (tokens computed + fused "
            "pieces) K1")
    finally:
        server.close()
        handle.shutdown()
        handle._thread.join(timeout=60)
    k = min(2, len(token_times) - 2)
    gaps = [(b - a) * 1e3 for a, b in zip(token_times, token_times[1:])]
    gaps_h = [(b - a) * 1e3 for a, b in zip(times_h, times_h[1:])]
    rec.update({
        "http": {"ttft_ms": (token_times[0] - t0) * 1e3, "gap_p50_ms": statistics.median(gaps),
                 "gap_p95_ms": float(np.percentile(gaps, 95)), "gap_max_ms": max(gaps),
                 "steady_tpot_ms": (token_times[-1] - token_times[k]) * 1e3
                 / (len(token_times) - 1 - k),
                 "blocking_wall_ms": wall_miss2 * 1e3,
                 "first_blocking_wall_ms": wall_miss * 1e3},
        "handle": {"ttft_ms": (times_h[0] - t0_h) * 1e3, "gap_p50_ms": statistics.median(gaps_h),
                   "gap_p95_ms": float(np.percentile(gaps_h, 95)), "gap_max_ms": max(gaps_h),
                   "steady_tpot_ms": (times_h[-1] - times_h[k]) * 1e3 / (len(times_h) - 1 - k),
                   "wall_ms": (times_h[-1] - t0_h) * 1e3},
        "launches": launches, **counts, "concurrent_equal_b1": pair_equal,
        "hit_equal_miss": hit_ids == want_main, "hit_first_difference": first_diff,
        "hit_first_logits": hit_rule,
        "requests": sent})
    h, c = rec["http"], rec["handle"]
    log(f"  {PROMPT}/{OUT} (misses), at the client over HTTP vs on the handle: "
        f"TTFT {h['ttft_ms']:.3f} vs {c['ttft_ms']:.3f} ms; gaps p50 {h['gap_p50_ms']:.3f} vs "
        f"{c['gap_p50_ms']:.3f}, p95 {h['gap_p95_ms']:.3f} vs {c['gap_p95_ms']:.3f}, max "
        f"{h['gap_max_ms']:.3f} vs {c['gap_max_ms']:.3f} ms; steady TPOT {h['steady_tpot_ms']:.3f}"
        f" vs {c['steady_tpot_ms']:.3f} ms; blocking wall {h['blocking_wall_ms']:.1f} ms vs the "
        f"handle's last token at {c['wall_ms']:.1f} ms (the first blocking request, with the "
        f"block graphs' first-use captures: {h['first_blocking_wall_ms']:.1f} ms)")
    del handle, ex
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def run_serving(cfg, q3, q3e, params, contract, kernels, main_prompt, want_main):
    """Phase 26 on the Qwen3-4B weights of phases 4-8k. Returns (the
    record, [26c]'s K1 / K2 launches)."""
    t = time.perf_counter()
    log(f"[26a] a Qwen3-4B checkpoint at full width cut to {CKPT_LAYERS} layers: written "
        "(sharded, with an index), loaded by start_engine(path), served")
    rec = {"checkpoint": run_checkpoint(cfg, q3, q3e, params, contract)}
    log("[26b] the CLI: python3 -m pegainfer_tpu_torch.server.main --sim in a process of its own")
    rec["cli"] = run_cli()
    log(f"[26c] the OpenAI server (httpd) in front of Qwen3-4B at full depth, {HTTP_PAGES} pages")
    rec["http"], launches = run_http(cfg, q3e, params, contract, kernels, main_prompt, want_main)
    rec["phase_s"] = time.perf_counter() - t
    log(f"  [26] took {rec['phase_s']:.1f} s")
    return rec, launches


def run_graphed(cfg, q3, q3e, params, q8, contract, kernels, eager_tokens, int8_tokens,
                host_profile, prompt):
    """Phase 8j: the graphed engine in bf16 (phase 4's traffic and prompts,
    its tokens the oracle; K1 / K2 counted) and in int8 (phase 8f's, its
    tokens the oracle; the int8 linear kernel 145 x decode steps + 1 a
    prefill, K6 none), then ``executor_steps`` of the graphed step in both
    beside [8i]'s eager ones. Returns the record."""
    L = cfg.num_hidden_layers
    out = {}

    def start(**opts):
        return lambda: q3e.start_engine_from_params(
            cfg, shallow_tree(params), contract.EngineLoadOptions(
                kv_memory_fraction=0.5, seed=SEED, **OLD_DEFAULTS, **opts), device="cuda")

    def expected(n_linear):
        return lambda run: {"paged_decode": L * run["decode_steps"],
                            "flash_prefill": L * run["prefills"],
                            **(int8_path_launches(n_linear, run) if n_linear else {})}

    traffic = dict(concurrent=SHORT, shapes=((64, 4), (PROMPT, OUT)))
    log("  bf16:")
    out["bf16"] = serve_graphed("[8j] bf16", start(), cfg, contract,
                                {k: kernels[k] for k in ("paged_decode", "flash_prefill")},
                                {**traffic, "seed": SEED}, eager_tokens, expected(0))
    log("  int8 (quantize=\"int8\" at start on a shallow copy):")
    out["int8"] = serve_graphed("[8j] int8", start(quantize="int8"), cfg, contract, kernels,
                                {**traffic, "seed": SEED + 3}, int8_tokens,
                                expected(qwen3_int8_launches(cfg)))
    for mode, w in (("bf16", params), ("int8", q8)):
        g = out[mode]["step"] = executor_steps(f"graphed {mode}",
                                               qwen3_executor(cfg, q3, w, contract), contract,
                                               prompt, graphs=True)
        e = host_profile[mode]
        log(f"  {mode}: step wall {e['wall_p50_ms']:.3f} -> {g['wall_p50_ms']:.3f} ms, device "
            f"{e['device_ms']:.3f} -> {g['device_ms']:.3f} ms, idle {e['idle']:.1%} -> "
            f"{g['idle']:.1%} (eager -> graphed, execute_decode at B = 1)")
    return out


def graphed_mode(label, cfg, contract, prompt, make_ex, step_kernels, eager, start, kernels,
                 traffic, expected):
    """One mode of phases 25g, 13g and 18g: ``executor_steps`` of the eager
    step (its forward under sync-debug "error" before the mode's first
    capture), ``serve_graphed`` against the eager engine's run ``eager``
    (its tokens, TPOT p50 and p95), then ``executor_steps`` of the graphed
    step. TPOT p50 under graphs must lie below the eager p50 by more than
    the eager run's p50-p95 spread. Returns the record."""
    eager_step = executor_steps(f"{label} eager", make_ex, contract, prompt, graphs=False,
                                kernels=step_kernels)
    rec = serve_graphed(label, start, cfg, contract, kernels, traffic, eager["tokens"],
                        expected)
    rec["step"] = {"eager": eager_step,
                   "graphed": executor_steps(f"{label} graphed", make_ex, contract, prompt,
                                             graphs=True, kernels=step_kernels)}
    e50, e95, g50 = eager["tpot_p50_ms"], eager["tpot_p95_ms"], rec["tpot_p50_ms"]
    rec["eager_tpot_p50_ms"], rec["eager_tpot_p95_ms"] = e50, e95
    g, e = rec["step"]["graphed"], eager_step
    log(f"  {label}: TPOT p50 {e50:.3f} -> {g50:.3f} ms (eager p95 {e95:.3f}, graphed "
        f"{rec['tpot_p95_ms']:.3f}); step wall {e['wall_p50_ms']:.3f} -> {g['wall_p50_ms']:.3f} "
        f"ms, device {e['device_ms']:.3f} -> {g['device_ms']:.3f} ms, idle {e['idle']:.1%} -> "
        f"{g['idle']:.1%} (eager -> graphed, execute_decode at B = 1)")
    if not e50 - g50 > e95 - e50:
        raise SystemExit(f"{label}: TPOT p50 under graphs is not below the eager p50 by more "
                         "than the eager run's p50-p95 spread")
    return rec


def run_hybrid_graphed(cfg, q35, q35e, params, q8, contract, kernels, eager, prompt):
    """Phase 25g: the hybrid's engine under the graph defaults (its ladder
    captured at start) in bf16 and int8, against [20]'s and [25b]'s eager
    runs (``eager``: mode -> tokens and TPOT): tokens equal, K1 / K2 and the
    int8 linear kernel counted through the replays (0 in bf16; K6 none),
    ``graphed_mode``'s step records on a 1-slot executor. Returns the
    record."""
    from pegainfer_tpu_torch.engine.hybrid_executor import HybridExecutor

    G = cfg.num_groups
    n_linear = qwen35_int8_launches(cfg)
    traffic = dict(concurrent=Q35_CONCURRENT, shapes=(Q35_WARMUP, (PROMPT, OUT)))

    def start(**opts):
        return lambda: q35e.start_engine_from_params(
            cfg, shallow_tree(params), contract.EngineLoadOptions(
                max_batch_size=Q35_SLOTS, kv_memory_fraction=0.5, seed=SEED, **OLD_DEFAULTS,
                **opts), device="cuda")

    def make_ex(w):
        def make(graphs):
            state = q35.make_state(cfg, STEP_PAGES, PAGE, 1, device="cuda")
            return HybridExecutor(cfg, w, state, contract.EngineLoadOptions(
                max_batch_size=1, enable_cuda_graph=graphs, **OLD_DEFAULTS))
        return make

    def expected(n):
        return lambda run: {"paged_decode": G * run["decode_steps"],
                            "flash_prefill": G * run["prefills"],
                            **(int8_path_launches(n, run) if n else
                               {"int8_linear": 0, "moe_int8_gemv": 0})}

    out = {}
    for mode, w, opts, n in (("bf16", params, {}, 0),
                             ("int8", q8, {"quantize": "int8"}, n_linear)):
        log(f"  {mode}:")
        out[mode] = graphed_mode(f"[25g] {mode}", cfg, contract, prompt, make_ex(w),
                                 QWEN_STEP_KERNELS, eager[mode], start(**opts), kernels,
                                 traffic, expected(n))
    return out


def dsv4_executor(cfg, d4, d4e, params, contract, moe_chain):
    """``executor_steps``' executor for DSv4: a SlotExecutor of one slot."""
    from pegainfer_tpu_torch.engine.slot_executor import SlotExecutor

    def make(graphs):
        state = d4.make_state(cfg, 1, d4e.max_blocks_for(cfg, DSV4_MAX_MODEL_LEN),
                              dtype=torch.bfloat16, device="cuda")
        return SlotExecutor(cfg, params, state, 1, DSV4_MAX_MODEL_LEN,
                            contract.EngineLoadOptions(max_batch_size=1,
                                                       enable_cuda_graph=graphs,
                                                       **OLD_DEFAULTS), moe_chain)
    return make


def dsv4_graphed(label, cfg, params, contract, prompt, eager, kernels, expected,
                 quantize=None, moe_chain=None):
    """One DSv4 mode of phases 13g / 18g: ``graphed_mode`` on phase 11's
    traffic (the engine's graphs captured per bucket at first use)."""
    from pegainfer_tpu_torch.models import dsv4 as d4
    from pegainfer_tpu_torch.models import dsv4_engine as d4e

    def start():
        return d4e.start_engine_from_params(cfg, params, contract.EngineLoadOptions(
            max_batch_size=DSV4_SLOTS, max_model_len=DSV4_MAX_MODEL_LEN, seed=SEED,
            quantize=quantize, **OLD_DEFAULTS), device="cuda", moe_chain=moe_chain)

    return graphed_mode(label, cfg, contract, prompt,
                        dsv4_executor(cfg, d4, d4e, params, contract, moe_chain),
                        DSV4_STEP_KERNELS, eager, start, kernels, {}, expected)


def eager_record(run):
    """A served run's tokens and TPOT p50 / p95 (``graphed_mode``'s eager
    side)."""
    gaps = run["gaps"]
    return {"tokens": {"main": run["main_tokens"], "concurrent": run["concurrent_tokens"]},
            "tpot_p50_ms": statistics.median(gaps),
            "tpot_p95_ms": float(np.percentile(gaps, 95))}


def run_echo(label, family, cfg, model, engine, params, contract):
    """Phases 8h / 25c: the family's engine with CHUNK_OPTS (bf16). A prompt
    P of CHUNK_PROMPT tokens alone (cached); then CHUNK_STREAMS decoding and,
    once both decoded a token, P as an echo request with logprobs=1: it runs
    as plain pieces (no fused piece, no prefix-cache lookup, the streams
    decoding between them); then a shorter echo request without logprobs
    (PromptTokens all None). P's prompt logprobs against one whole
    all-logits prefill of P (``check_prompt_logprobs``). Returns the
    record."""
    opts = dict(kv_memory_fraction=0.5, seed=SEED, **CHUNK_OPTS, **EAGER)
    if family == "qwen35":
        opts["max_batch_size"] = Q35_CHUNK_SLOTS
    handle = engine.start_engine_from_params(cfg, params, contract.EngineLoadOptions(**opts),
                                             device="cuda")
    ex = handle._scheduler.executor
    cache = ex.prefix_cache
    rng = np.random.default_rng(SEED + 14)
    P = rng.integers(0, cfg.vocab_size, CHUNK_PROMPT).tolist()
    streams = [(rng.integers(0, cfg.vocab_size, n).tolist(), m) for n, m in CHUNK_STREAMS]
    short = rng.integers(0, cfg.vocab_size, 600).tolist()
    try:
        ch, _ = run_request(contract, handle, P, 1)
        toks, fin, _ = drain(contract, ch)
        expect_finished(contract, f"P {CHUNK_PROMPT}/1 alone (cached)", toks, fin, 1)
        chans = [run_request(contract, handle, p, m)[0] for p, m in streams]
        early = [read_tokens(contract, ch, 2) for ch in chans]
        joins = [drain_in_background(contract, ch) for ch in chans]
        counts0 = (ex.mixed_pieces, ex.chunk_pieces, cache.hits, cache.misses, ex.decode_steps)
        ch = contract.TokenChannel()
        t0 = time.perf_counter()
        handle.submit(contract.GenerateRequest(
            prompt_tokens=P, max_tokens=CHUNK_OUT, echo=True, logprobs=1, channel=ch,
            params=contract.SamplingParams(ignore_eos=True)))
        events = read_events(contract, ch)
        echo_s = time.perf_counter() - t0
        counts1 = (ex.mixed_pieces, ex.chunk_pieces, cache.hits, cache.misses, ex.decode_steps)
        for (toks0, _), join, (p, m) in zip(early, joins, streams):
            toks, fin, _ = join()
            expect_finished(contract, f"stream {len(p)}/{m}", toks0 + toks, fin, m)
        got = check_echo_events(contract, f"echo {CHUNK_PROMPT}/{CHUNK_OUT} with logprobs=1",
                                events, P, CHUNK_OUT, True)
        ch = contract.TokenChannel()
        handle.submit(contract.GenerateRequest(
            prompt_tokens=short, max_tokens=4, echo=True, channel=ch,
            params=contract.SamplingParams(ignore_eos=True)))
        check_echo_events(contract, "echo 600/4 without logprobs", read_events(contract, ch),
                          short, 4, False)
    finally:
        handle.shutdown()
        handle._thread.join(timeout=60)
    del handle, ex, cache
    gc.collect()
    torch.cuda.empty_cache()
    pieces = counts1[1] - counts0[1]
    want_pieces = CHUNK_PROMPT // CHUNK_OPTS["prefill_chunk_mixed"]
    log(f"  the echo prompt ran as {pieces} pieces, {counts1[0] - counts0[0]} fused; cache "
        f"hits {counts0[2]} -> {counts1[2]}, misses {counts0[3]} -> {counts1[3]}; "
        f"{counts1[4] - counts0[4]} decode steps of the streams meanwhile")
    if (counts1[0] != counts0[0] or counts1[2:4] != counts0[2:4] or pieces != want_pieces
            or counts1[4] == counts0[4]):
        raise SystemExit(f"{label}: the echo prompt did not run as {want_pieces} plain pieces "
                         "without a cache lookup while the streams decoded")
    prompt_t = torch.tensor(P, dtype=torch.int32, device="cuda")
    per = -(-CHUNK_PROMPT // PAGE)
    table = torch.arange(1, 1 + per, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        if family == "qwen3":
            kv = model.make_kv_pages(cfg, 1 + per, PAGE, device="cuda")
            _, every = model.prefill(cfg, params, kv, prompt_t, table, return_all_logits=True)
        else:
            kv = model.make_state(cfg, 1 + per, PAGE, 1, device="cuda")
            _, every = model.prefill(cfg, params, kv, prompt_t, table, 0,
                                     return_all_logits=True)
        share = check_prompt_logprobs(label, got, every, prompt_t)
    del kv, every
    return {"prompt": CHUNK_PROMPT, "output": CHUNK_OUT, "pieces": pieces, "fused": 0,
            "echo_wall_s": echo_s, "logprobs_share_of_limit": share}


def run_dsv4_echo(cfg, params):
    """Phase 13d: an engine under the defaults (the slot cache on) serves P
    (DSV4_CACHE_PROMPT tokens) with logprobs (a miss, a snapshot with its
    logits), then P + DSV4_CACHE_EXT new tokens as an echo request with
    logprobs=1: no cache lookup (hits and misses as before, no resume
    step), a fresh whole prefill with every row's logits, its snapshot
    inserted with its last logits, as the JAX executor leaves its cache.
    Its prompt logprobs against log-softmax of ``plain_kernels=True``'s
    [T, V] logits, that run routed as the engine's (RoutingReplay), by
    ``check_prompt_logprobs``'s bound."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import dsv4 as d4
    from pegainfer_tpu_torch.models import dsv4_engine as d4e

    log(f"[13d] a DSv4 echo request with logprobs after its prompt's prefix was cached: "
        f"{DSV4_CACHE_PROMPT} + {DSV4_CACHE_EXT} tokens")
    handle = d4e.start_engine_from_params(cfg, params, contract.EngineLoadOptions(
        max_batch_size=DSV4_SLOTS, max_model_len=DSV4_MAX_MODEL_LEN, seed=SEED, **ONE_TOKEN,
        **EAGER), device="cuda")
    ex = handle._scheduler.executor
    cache = ex.slot_prefix_cache
    rng = np.random.default_rng(SEED + 15)
    P = rng.integers(0, cfg.vocab_size, DSV4_CACHE_PROMPT).tolist()
    ext = P + rng.integers(0, cfg.vocab_size, DSV4_CACHE_EXT).tolist()
    replay = RoutingReplay(d4)
    try:
        ch, _ = run_request(contract, handle, P, 4, logprobs=1)
        toks, fin, _ = drain(contract, ch)
        expect_finished(contract, f"P {DSV4_CACHE_PROMPT}/4 with logprobs", toks, fin, 4)
        before = (cache.hits, cache.misses, ex.resume_steps, ex.prefills)
        replay.record()
        ch = contract.TokenChannel()
        handle.submit(contract.GenerateRequest(
            prompt_tokens=ext, max_tokens=4, echo=True, logprobs=1, channel=ch,
            params=contract.SamplingParams(ignore_eos=True)))
        events = read_events(contract, ch)
        replay.restore()
        after = (cache.hits, cache.misses, ex.resume_steps, ex.prefills)
        entry = cache._entries.get(tuple(ext))
    finally:
        replay.restore()
        handle.shutdown()
        handle._thread.join(timeout=60)
    del handle, ex
    got = check_echo_events(contract, f"echo {len(ext)}/4 with logprobs=1", events, ext, 4, True)
    log(f"  cache (hits, misses, resume steps, prefills) {before} -> {after}; the echo "
        f"prompt's entry kept " + ("no entry" if entry is None else
                                   "its logits" if entry[1] is not None else "no logits"))
    if (after[:3] != before[:3] or after[3] != before[3] + 1 or entry is None
            or entry[1] is None):
        raise SystemExit("[13d] the echo request looked the slot cache up, resumed, or left "
                         "no entry with its logits")
    with torch.no_grad():
        replay.replay()
        try:
            every, _ = d4.prefill(cfg, params, torch.tensor(ext, dtype=torch.int32,
                                                            device="cuda"), plain_kernels=True)
        finally:
            replay.restore()
        replay.report("the plain run against the engine's")
        share = check_prompt_logprobs("[13d]", got, every, torch.tensor(
            ext, dtype=torch.int32, device="cuda"))
    del every, cache
    return {"prompt": len(ext), "logprobs_share_of_limit": share,
            "routing_flips": replay.flips, "routing_decisions": replay.decisions}


# ── phase 29: tensor parallelism, two ranks on the one card ─────────────

TP_SIZE = 2
TP_ORDINALS = [0, 0]  # both ranks on card 0: the device group is gloo
TP_MAIN = (1024, 64)
TP_PAIR = ((300, 32), (500, 32))  # at once: decode at B = 2
TP_OPTS = dict(precompile=False, **OLD_DEFAULTS)  # the eager step, as TP runs it
TP_REF_PAGES = 64  # the one-process executor of the B = 2 logits check
TP_KV_FRACTION = 0.2  # the TP engine's pool: each rank half of it (two ranks a card)
TP_DECODE_IDS = (90000, 90001)  # request ids of the B = 2 logits check
TP_LINEAR_CALLS = 30


def tp_children():
    import multiprocessing

    return [p for p in multiprocessing.active_children() if p.name.startswith("pegainfer-tp")]


def tp_prompts(cfg, seed):
    """The prompts of [4]'s traffic (seed SEED) or [8f]'s (SEED + 3), drawn
    again in their order (the 64-token warm-up's, the main request's, the
    pair's): TP_MAIN's prompt and TP_PAIR's, whose one-process eager
    tokens are the first TP_MAIN[1] / TP_PAIR's of those phases' streams
    (greedy, one token a step, the pair at B = 2 throughout)."""
    rng = np.random.default_rng(seed)
    rng.integers(0, cfg.vocab_size, 64)
    main_prompt = rng.integers(0, cfg.vocab_size, PROMPT).tolist()
    pair = [(rng.integers(0, cfg.vocab_size, n).tolist(), m)
            for (n, _), (_, m) in zip(SHORT, TP_PAIR)]
    return main_prompt, pair


def tp_traffic(contract, handle, main_prompt, pair):
    """[29]'s traffic: TP_MAIN alone, then TP_PAIR at once; every request
    must finish. Returns the streams and the main request's TTFT / TPOT p50
    (host clock)."""
    ch, t0 = run_request(contract, handle, main_prompt, TP_MAIN[1])
    toks, fin, times = drain(contract, ch)
    expect_finished(contract, f"TP {TP_MAIN[0]}/{TP_MAIN[1]}", toks, fin, TP_MAIN[1])
    out = {"main": toks, "pair": [], "ttft_ms": (times[0] - t0) * 1e3,
           "tpot_p50_ms": statistics.median((b - a) * 1e3 for a, b in zip(times, times[1:]))}
    for ch, n, m in submit_together(contract, handle, pair):
        toks_s, fin_s, _ = drain(contract, ch)
        expect_finished(contract, f"TP concurrent {n}/{m}", toks_s, fin_s, m)
        out["pair"].append(toks_s)
    return out


def tp_decode_logits(ex, local, prompts, tokens):
    """One B = 2 decode step's logits [2, V] on executor ``ex`` (``local``:
    the executor whose model call runs here, rank 0's under TP): the two
    prompts prefilled, then one step with logprobs on, fed ``tokens``."""
    from pegainfer_tpu_torch.engine.executor import (DecodePlan, DecodeStepItem, PrefillPlan,
                                                     PrefillStepItem)
    from pegainfer_tpu_torch.engine.contract import SamplingParams

    caught = []
    model = local._decode_model
    local._decode_model = lambda items, *a: caught.append(model(items, *a)) or caught[-1]
    try:
        ex.execute_prefill(PrefillPlan(requests=[
            PrefillStepItem(request_id=r, prompt_tokens=p, params=SamplingParams())
            for r, p in zip(TP_DECODE_IDS, prompts)]))
        ex.execute_decode(DecodePlan(requests=[
            DecodeStepItem(request_id=r, token_id=t, params=SamplingParams(), logprobs=1)
            for r, t in zip(TP_DECODE_IDS, tokens)]))
    finally:
        del local._decode_model
        for r in TP_DECODE_IDS:
            ex.release_request(r)
    return caught[0][:len(prompts)].float()


def tp_token_check(label, cfg, q3, tree, prompt, got, want, limit):
    """``got`` must equal the one-process engine's ``want`` up to the first
    step whose one-process top-2 gap (its logits given the same prefix, by
    one prefill) is within ``limit``, the measured diff."""
    k = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if k is None:
        log(f"  {label}: {len(got)} tokens equal the one-process engine's")
        return {"equal": True}
    ids = torch.tensor(prompt + want[:k], dtype=torch.int32, device="cuda")
    n_pages = -(-ids.shape[0] // PAGE)
    kv = q3.make_kv_pages(cfg, n_pages + 1, PAGE, device="cuda")
    with torch.no_grad():
        lp, _ = q3.prefill(cfg, tree, kv, ids, torch.arange(1, n_pages + 1, dtype=torch.int32,
                                                            device="cuda"))
    top2 = torch.topk(lp, 2).values
    gap = (top2[0] - top2[1]).item()
    log(f"  {label}: equal for {k} of {len(got)} tokens; at step {k} the one-process "
        f"top-2 gap is {gap:.4e} against the measured diff {limit:.4e}")
    if gap > limit:
        raise SystemExit(f"[29] {label}: the TP tokens leave the one-process engine's at step "
                         f"{k}, where its top-2 gap {gap:.4e} exceeds the measured diff")
    return {"equal": False, "first_diff_step": k, "top2_gap": gap, "limit": limit}


def tp_delta(after, before):
    """Each rank's counters run between two ``rank_stats`` reads."""
    keys = ("prefills", "chunk_pieces", "mixed_pieces", "decode_steps", "decode_blocks",
            "collectives")
    return [{**{k: a[k] - b[k] for k in keys},
             "launches": {n: a["launches"][n] - b["launches"][n] for n in a["launches"]}}
            for a, b in zip(after, before)]


def tp_mode(label, mode, cfg, q3, q3e, params, contract, kernels, oracle, seed):
    """[29b] / [29c] in one weight mode (None: bf16, "int8"): the TP engine
    (two ranks on card 0) on [4]'s (bf16) or [8f]'s (int8) prompts
    (``tp_prompts(cfg, seed)``), its counts, every rank's; rank 0's prefill
    logits and a B = 2 decode step against the one-process model (rule 7);
    the streams against those phases' one-process eager streams
    (``oracle``); no worker left after the shutdown."""
    from pegainfer_tpu_torch.engine.torch_executor import TorchExecutor

    pd, fp, il = kernels["paged_decode"], kernels["flash_prefill"], kernels["int8_linear"]
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    opts = dict(seed=SEED, quantize=mode, **TP_OPTS)
    main_prompt, pair = tp_prompts(cfg, seed)
    want = {"main": oracle["main"][:TP_MAIN[1]],
            "pair": [t[:m] for t, (_, m) in zip(oracle["concurrent"], pair)]}

    t_start = time.perf_counter()
    handle = q3e.start_engine_from_params(
        cfg, shallow_tree(params), contract.EngineLoadOptions(
            kv_memory_fraction=TP_KV_FRACTION, device_ordinals=TP_ORDINALS, **opts),
        device="cuda", tp_size=TP_SIZE)
    start_s = time.perf_counter() - t_start
    ex = handle._scheduler.executor
    prefill_logits = []
    first = ex.local._first_token
    ex.local._first_token = lambda item, last: (prefill_logits.append(last.float().clone()),
                                                first(item, last))[1]
    try:
        pd.launches = fp.launches = il.launches = 0
        before = ex.rank_stats()  # the workers' counts at the start
        got = tp_traffic(contract, handle, main_prompt, pair)
        launches = {"paged_decode": pd.launches, "flash_prefill": fp.launches,
                    "int8_linear": il.launches}
        after = ex.rank_stats()
        del ex.local._first_token
        tp_step = tp_decode_logits(ex, ex.local, [p for p, _ in pair],
                                   [t[0] for t in want["pair"]])
    finally:
        handle.shutdown()
        handle._thread.join(timeout=120)
    alive = tp_children()
    if alive or handle._thread.is_alive():
        raise SystemExit(f"[29] {label}: workers {alive} or the scheduler outlived the shutdown")
    final = ex.final_stats
    del handle, ex
    gc.collect()
    torch.cuda.empty_cache()

    deltas = tp_delta(after, before)
    run = deltas[0]
    want_launches = {"flash_prefill": L * run["prefills"], "paged_decode": L * run["decode_steps"],
                     "int8_linear": ((4 * L + 1) * run["decode_steps"] + run["prefills"]
                                     if mode else 0)}
    log(f"  [29] {label}: rank 0's launches {launches}; each rank's "
        f"{[d['launches'] for d in deltas]}; expected {want_launches} ({run['prefills']} "
        f"prefills, {run['decode_steps']} decode steps, {L} layers)")
    if launches != want_launches or any(d["launches"] != want_launches for d in deltas):
        raise SystemExit(f"[29] {label}: kernel launch counts do not match the path")
    if any({k: v for k, v in d.items() if k != "launches"}
           != {k: v for k, v in run.items() if k != "launches"} for d in deltas):
        raise SystemExit(f"[29] {label}: the ranks' executors ran different calls: {deltas}")
    forwards = run["prefills"] + run["decode_steps"]
    per_forward = run["collectives"] / forwards
    if run["collectives"] != (2 * L + 1) * forwards:
        raise SystemExit(f"[29] {label}: {run['collectives']} collectives for {forwards} "
                         f"forwards, not {2 * L + 1} each")

    # rank 0's logits against the one-process model on the same inputs
    ref_tree = q3.quantize_params_int8(shallow_tree(params)) if mode else params
    n_pages = TP_MAIN[0] // PAGE + 1
    kv = q3.make_kv_pages(cfg, n_pages + 1, PAGE, device="cuda")
    toks_t = torch.tensor(main_prompt, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        lp, _ = q3.prefill(cfg, ref_tree, kv, toks_t,
                           torch.arange(1, n_pages + 1, dtype=torch.int32, device="cuda"))
    del kv
    log(f"  [29] {label}: rank 0's {TP_MAIN[0]}-token prefill logits against the one-process "
        "port's (rule 7)")
    prefill_rule = logits_rule(prefill_logits[0], lp.float(), LOGITS_RTOL)
    ref_ex = TorchExecutor(cfg, ref_tree, q3.make_kv_pages(cfg, TP_REF_PAGES, PAGE,
                                                           device="cuda"),
                           contract.EngineLoadOptions(max_num_pages=TP_REF_PAGES, **opts))
    ref_step = tp_decode_logits(ref_ex, ref_ex, [p for p, _ in pair],
                                [t[0] for t in want["pair"]])
    del ref_ex
    decode_rules = []
    for b in range(len(pair)):
        log(f"  [29] {label}: B = 2 decode step, row {b}, against the one-process port's (rule 7)")
        decode_rules.append(logits_rule(tp_step[b], ref_step[b], LOGITS_RTOL))
    if not (prefill_rule["ok"] and all(r["ok"] for r in decode_rules)):
        raise SystemExit(f"[29] {label}: rank 0's logits disagree with the one-process port")
    limit = max([prefill_rule["max_diff"]] + [r["max_diff"] for r in decode_rules])
    tokens = {"main": tp_token_check(f"{label} main", cfg, q3, ref_tree, main_prompt,
                                     got["main"], want["main"], limit)}
    tokens["pair"] = [tp_token_check(f"{label} pair {i}", cfg, q3, ref_tree, p, g, w, limit)
                      for i, ((p, _), g, w) in enumerate(zip(pair, got["pair"], want["pair"]))]
    del ref_tree
    out = {"backend": after[0]["backend"], "devices": [st["device"] for st in after],
           "params_bytes": [st["params_bytes"] for st in after],
           "num_pages": after[0]["num_pages"], "start_s": start_s,
           "ttft_ms": got["ttft_ms"], "tpot_p50_ms": got["tpot_p50_ms"],
           "launches": launches, "launches_each_rank": [d["launches"] for d in deltas],
           "collectives_per_forward": per_forward, "counters": run,
           "final_stats": final, "prefill_logits": prefill_rule, "decode_logits": decode_rules,
           "tokens": tokens, "phase_s": time.perf_counter() - t0}
    log(f"  [29] {label}: device group {out['backend']} on {out['devices']}; parameters "
        f"{[round(b / 1e9, 3) for b in out['params_bytes']]} GB a rank; {out['num_pages']} pages "
        f"a rank; start {start_s:.1f} s; TTFT {got['ttft_ms']:.1f} ms, TPOT p50 "
        f"{got['tpot_p50_ms']:.2f} ms; {per_forward:.0f} collectives a forward; "
        f"{out['phase_s']:.1f} s; two ranks on one card through the host, not a TP speed; "
        f"{card_line()}")
    return out


def tp_linear_shapes(il, ils, gen, ceiling):
    """The int8 linear kernel at one rank's launches at TP 2 and TP 4
    (``int8_linear_study.tp_launches``: wo and w_down through the f32-output
    epilogue) and TP_ROWS rows: each row against its plain version, then
    the kernel, the plain version and bf16 ``torch.mm`` on the same
    weights, layers rotated past 2 x L2, one turn; the bound by these
    inputs."""
    table = {}
    saved = il.launches
    for tp in (2, 4):
        for name, outs, IN, per_step, f32 in ils.tp_launches(tp):
            L = max(2, -(-2 * ils.L2_BYTES // (sum(outs) * IN)) + 1)
            ws = [ils.random_weight(gen, L, o, IN, "cuda", bf16=True) for o in outs]
            qs, ss, bw = [w[0] for w in ws], [w[1] for w in ws], [w[2] for w in ws]
            for M in ils.TP_ROWS:
                x = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
                ils.nan_poison(M * sum(outs) * (2 if f32 else 1))
                ys = il.int8_linear(x, [q[0] for q in qs], [s[0] for s in ss], f32_out=f32)
                refs = il.int8_linear_plain(x, [q[0] for q in qs], [s[0] for s in ss],
                                            f32_out=f32)
                errs = [ils.row_err(y, r) for y, r in zip(ys, refs)]
                share = max(e[1] for e in errs)
                if not share <= 1.0:
                    raise SystemExit(f"[29a] the int8 linear kernel disagrees with its plain "
                                     f"version at {name} M={M} ({share:.3f} of its limit)")
                fns = {"kernel": lambda i: il.int8_linear(x, [q[i % L] for q in qs],
                                                          [s[i % L] for s in ss], f32_out=f32),
                       "plain": lambda i: il.int8_linear_plain(x, [q[i % L] for q in qs],
                                                               [s[i % L] for s in ss],
                                                               f32_out=f32),
                       "library": lambda i: [torch.mm(x, w[i % L]) for w in bw]}
                ms = {f: sum(t) / len(t) for f, t in ils.timed_in_turns(
                    fns, max(L, TP_LINEAR_CALLS - TP_LINEAR_CALLS % L), L, 1).items()}
                b = ils.bounds(outs, IN, M, ceiling, 4 if f32 else 2)
                table[f"{name} M={M}"] = {
                    "outs": list(outs), "IN": IN, "M": M, "f32_out": f32,
                    "launches_a_step": per_step, "max_abs_err": max(e[0] for e in errs),
                    "row_share": share, "ms": ms["kernel"], "plain_ms": ms["plain"],
                    "library_ms": ms.get("library"), "library_call": "torch.mm (bf16 weights)",
                    "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                    "measured_bound_ms": b["measured_bound_ms"]}
                log(f"  {name} ({'+'.join(map(str, outs))} x {IN}) M={M:2d}"
                    f"{' f32 out' if f32 else ''}: kernel {ms['kernel'] * 1e3:.2f} us, bound "
                    f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}), plain "
                    f"{ms['plain'] * 1e3:.2f} us, torch.mm "
                    + (f"{ms['library'] * 1e3:.2f} us" if "library" in ms else "-")
                    + f"; worst row {share:.3f} of its limit")
            del ws, qs, ss, bw
            torch.cuda.empty_cache()
    il.launches = saved
    steps = {}  # a rank's decode step: each launch's time x its launches a step
    for tp in (2, 4):
        for M in ils.TP_ROWS:
            rows = [table[f"{name} M={M}"] for name, *_ in ils.tp_launches(tp)]
            steps[f"tp{tp} M={M}"] = st = {
                k: sum(r["launches_a_step"] * r[k] for r in rows)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms", "measured_bound_ms")}
            log(f"  a TP {tp} rank's decode step at {M} rows: the kernel's 145 launches "
                f"{st['ms'] * 1e3:.1f} us, bound {st['bound_ms'] * 1e3:.1f} (measured "
                f"{st['measured_bound_ms'] * 1e3:.1f}), plain {st['plain_ms'] * 1e3:.1f}, "
                f"torch.mm {st['library_ms'] * 1e3:.1f}")
    return {"shapes": table, "steps": steps}


def run_tp(cfg, q3, q3e, params, contract, kernels, att, ceiling, oracles):
    """Phase 29: Qwen3-4B (36 layers, [4]'s weights) tensor-parallel at TP
    2 with both ranks on the one card (``device_ordinals=[0, 0]``, gloo):
    [29a] the kernels at one rank's shapes (K1 and K2 at Hq / Hkv 16 / 4,
    the int8 linear kernel at the TP 2 and TP 4 shards) against their
    plain versions and timed; [29b] bf16, [29c] int8: the traffic, the
    counts, rule 7, the streams against ``oracles`` ([4]'s and [8f]'s
    one-process eager streams; ``tp_mode``). Checks the sharded path at
    full width; measures no TP speed."""
    from pegainfer_tpu_torch.parallel import sharding
    from pegainfer_tpu_torch.studies import int8_linear_study as ils

    t0 = time.perf_counter()
    pd, fp, il = kernels["paged_decode"], kernels["flash_prefill"], kernels["int8_linear"]
    lcfg = sharding.local_config(cfg, TP_SIZE)
    Hq, Hkv, hd = lcfg.num_attention_heads, lcfg.num_key_value_heads, lcfg.head_dim
    log(f"[29a] the kernels at one rank's shapes of TP {TP_SIZE} (Hq / Hkv {Hq} / {Hkv}) and "
        "the int8 linear kernel at the TP 2 and TP 4 shards, each against its plain version")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    k1 = [time_decode(gen, lcfg, pd, s, plain=True) for s in ([PROMPT + OUT // 2], [1088, 532])]
    k2 = [time_prefill(gen, fp, att, PROMPT, Hq, Hkv, hd, plain=True),
          time_chunk(gen, fp, att, 256, 1280, 1024, Hq, Hkv, hd)]
    for r in k1:
        log(f"  paged_decode at TP {TP_SIZE} heads, contexts {r['seq_lens']}: "
            f"{r['ms'] * 1e3:.2f} us vs bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            f"plain {r['plain_ms'] * 1e3:.2f} us, library "
            + (f"{r['library_ms'] * 1e3:.2f} us" if r["library_ms"] is not None
               else r["library_call"]))
    for r in k2:
        log(f"  flash_prefill at TP {TP_SIZE} heads, T {r['T']}"
            + (f" at q_offset {r['q_offset']}" if "q_offset" in r else "")
            + f": {r['ms'] * 1e3:.2f} us vs bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}), plain {r['plain_ms'] * 1e3:.2f} us, library "
            + (f"{r['library_ms'] * 1e3:.2f} us" if r["library_ms"] is not None
               else r["library_call"]))
    # K1's and K2's checks at these heads (their timings above check nothing)
    errs = check_kernels(lcfg, pd, fp)
    linear = tp_linear_shapes(il, ils, gen, ceiling)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"tp_size": TP_SIZE, "device_ordinals": TP_ORDINALS,
           "note": "two ranks on one card through the host (gloo): the sharded path checked "
                   "at full width, no TP speed",
           "kernel_shapes": {"paged_decode": k1, "flash_prefill": k2, "int8_linear": linear},
           "kernel_errs": errs}
    for mode, seed in ((None, SEED), ("int8", SEED + 3)):
        label = mode or "bf16"
        log(f"[29{'b' if mode is None else 'c'}] Qwen3-4B {label} at TP {TP_SIZE} on "
            f"device_ordinals {TP_ORDINALS}: {TP_MAIN[0]}/{TP_MAIN[1]}, then {TP_PAIR} at once, "
            f"on {'[4]' if mode is None else '[8f]'}'s prompts, against its one-process streams")
        out[label] = tp_mode(label, mode, cfg, q3, q3e, params, contract, kernels,
                             oracles[label], seed)
    out["launches"] = {"paged_decode": out["bf16"]["launches"]["paged_decode"],
                       "flash_prefill": out["bf16"]["launches"]["flash_prefill"],
                       "int8_linear": out["int8"]["launches"]["int8_linear"]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"  [29] took {out['phase_s']:.1f} s ({card_line()})")
    return out


def time_chunk(gen, fp, att, T, S, q_offset, Hq, Hkv, hd):
    """K2 on one chunk: T queries at q_offset + i over S = q_offset + T keys,
    against its plain version (each query row at K2's limit); its time, its
    bound from these inputs, the plain version's time and the SDPA
    yardstick with an explicit boolean mask."""
    q = torch.randn((T, Hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((S, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((S, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    scale = hd ** -0.5
    saved = fp.launches
    out = {"T": T, "S": S, "q_offset": q_offset,
           "ms": time_ms(lambda i: fp.flash_attention(q, k, v, S, q_offset, scale), 100)}
    ref = fp.flash_attention(q, k, v, S, q_offset, scale)
    fp.launches = saved
    plain = att.causal_attention(q, k, v, S, q_offset, scale)
    out["max_abs_err"], share = prefill_err(ref, plain)
    out["share_of_limit"] = share
    if not share <= 1.0:
        raise SystemExit(f"flash prefill kernel disagrees with its plain version at the chunk "
                         f"T={T}, S={S} (worst row at {share:.3f} of its limit)")
    out["plain_ms"] = time_ms(lambda i: att.causal_attention(q, k, v, S, q_offset, scale), 10)
    nbytes = (2 * T * Hq * hd + 2 * S * Hkv * hd) * 2
    keys = T * q_offset + T * (T + 1) // 2  # keys each query attends, summed
    out["bound_ms"], out["bound_by"] = bound(nbytes, 2 * 2 * Hq * hd * keys)
    out["library_ms"], out["library_call"] = sdpa_prefill_library(q, k, v, scale, ref,
                                                                  q_offset=q_offset)
    return out


# ── phases 19-21: the Qwen3.5 hybrid ─────────────────────────────────────


def run_qwen35(ceiling):
    """Phases 19-25c on the Qwen3.5 hybrid at the JAX package's
    ``qwen35.bench_config()``. Returns (serving, steps, K1 / K2 launches on
    its served path and on its chunked path, K2 at Q35_K2_CHUNK_SHAPES); the
    engines, weights and state are freed with this frame."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import qwen35 as q35
    from pegainfer_tpu_torch.models import qwen35_engine as q35e
    from pegainfer_tpu_torch.ops.cuda import flash_prefill as fp
    from pegainfer_tpu_torch.ops.cuda import paged_decode as pd

    cfg = q35.bench_config()
    G = cfg.num_groups
    log(f"[19] Qwen3.5 hybrid ({cfg.num_hidden_layers} layers: {G} groups of "
        f"{cfg.period - 1} GDN + 1 gated full attention; hidden {cfg.hidden_size}): K1 and K2 "
        f"at its full-attention heads (Hq {cfg.num_attention_heads}, Hkv "
        f"{cfg.num_key_value_heads}, hd {cfg.head_dim}) against their plain versions")
    errs = check_hybrid_kernels(cfg, pd, fp)

    log(f"[20] serving it through qwen35_engine.start_engine_from_params, random bf16 "
        f"weights (seed {SEED}), {Q35_SLOTS} state slots")
    t = time.perf_counter()
    params = q35.init_random_params_device(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                           "cuda")
    torch.cuda.synchronize()
    log(f"  weights: {q35.params_bytes(params) / 1e9:.2f} GB in {time.perf_counter() - t:.1f} s")
    handle = q35e.start_engine_from_params(cfg, params, contract.EngineLoadOptions(
        max_batch_size=Q35_SLOTS, kv_memory_fraction=0.5, seed=SEED, **OLD_DEFAULTS, **EAGER),
        device="cuda")
    ex = handle._scheduler.executor
    pool = {"pages": ex.kv_pages.shape[2], "page_tokens": PAGE,
            "kv_bytes": ex.kv_pages.numel() * ex.kv_pages.element_size(),
            "slots": Q35_SLOTS, "slot_bytes": q35.slot_bytes(cfg),
            "state_bytes": sum(ex.state[k].numel() * 4 for k in ("rec", "conv"))}
    log(f"  KV pool: {pool['pages']} pages x {PAGE} tokens ({pool['kv_bytes'] / 1e9:.1f} GB); "
        f"recurrent + conv state {pool['state_bytes'] / 1e6:.1f} MB for {Q35_SLOTS} slots and "
        f"the dead one ({pool['slot_bytes'] / 1e6:.2f} MB a slot)")
    kernels = {"paged_decode": pd, "flash_prefill": fp}
    run = serve_slots(cfg, contract, handle, kernels, concurrent=Q35_CONCURRENT,
                      shapes=(Q35_WARMUP, (PROMPT, OUT)))
    eager = {"bf16": eager_record(run)}
    del handle, ex  # the executor holds the pool and the slots
    log("  all requests Finished with their token counts; " + check_slot_events(
        run["events"], third_waits=True, slots=Q35_SLOTS))
    prefills, steps = run["prefills"], run["decode_steps"]
    check_launches(run["launches"], {"paged_decode": G * steps, "flash_prefill": G * prefills},
                   f"{prefills} prefills, {steps} decode steps, {G} full-attention layers")

    log(f"[21] logits on the card: the {PROMPT}-token prefill and one decode step at B = 3 "
        "(and a dead row), kernels against plain_kernels=True")
    toks_t = torch.tensor(run["main_prompt"], dtype=torch.int32, device="cuda")
    first = check_hybrid_logits(cfg, q35, params, toks_t)
    gaps = run["gaps"]
    serving = {"ttft_ms": run["ttft_ms"], "tpot_p50_ms": statistics.median(gaps),
               "tpot_p95_ms": float(np.percentile(gaps, 95)), "prompt": PROMPT,
               "output": OUT, "pool": pool, "prefills": prefills, "decode_steps": steps}
    log(f"  main {PROMPT}/{OUT}: TTFT {serving['ttft_ms']:.3f} ms, TPOT p50 "
        f"{serving['tpot_p50_ms']:.3f} ms, p95 {serving['tpot_p95_ms']:.3f} ms over "
        f"{len(gaps)} gaps (host clock, per streamed token)")
    steps_prof = hybrid_step_profile(cfg, q35, params, toks_t, first)
    log_steps(steps_prof)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    serving["paged_decode_hd256"] = k1 = time_decode(gen, cfg, pd, [PROMPT + OUT // 2],
                                                     plain=True)
    log(f"  K1 at hd {cfg.head_dim}, G {cfg.num_attention_heads // cfg.num_key_value_heads}, "
        f"context {PROMPT + OUT // 2}: {k1['ms'] * 1e3:.2f} us vs bound "
        f"{k1['bound_ms'] * 1e3:.2f} us ({k1['bound_by']}), plain {k1['plain_ms'] * 1e3:.2f} "
        "us, library " + (f"{k1['library_ms'] * 1e3:.2f} us" if k1["library_ms"] is not None
                          else k1["library_call"]))
    serving["max_abs_err"] = errs
    serving["chunked"], c_launches, c_shapes = run_qwen35_chunked(cfg, q35, q35e, params,
                                                                 contract, pd, fp)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[25a] Qwen3.5 PD handoff between two HybridExecutors of {Q35_SLOTS} slots and "
        f"{PD_PAGES} pages on the same weights: {PD_PROMPT}/{PD_OUT}")
    from pegainfer_tpu_torch.engine.hybrid_executor import HybridExecutor

    def make():
        state = q35.make_state(cfg, PD_PAGES, PAGE, Q35_SLOTS, device="cuda")
        return HybridExecutor(cfg, params, state, contract.EngineLoadOptions(
            max_batch_size=Q35_SLOTS, **PD_OPTS, **EAGER))

    serving["pd"] = run_pd("[25a]", make, cfg.vocab_size,
                           PD_PROMPT // PAGE * q35.kv_bytes_per_page(cfg, PAGE)
                           + q35.slot_bytes(cfg), exact=False)
    gc.collect()
    torch.cuda.empty_cache()
    from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
    from pegainfer_tpu_torch.ops.cuda import int8_linear as il

    log(f"[25b] the hybrid int8 weight-only (quantize=\"int8\") on the same weights: "
        f"{PROMPT}/{OUT}, then {Q35_CONCURRENT} on {Q35_SLOTS} slots; the int8 linear kernel")
    int8, q8, int8_tokens = run_int8_engine(
        "[25b]", "qwen35", cfg, q35, q35e, params, contract,
        {"paged_decode": pd, "flash_prefill": fp}, qwen35_int8_launches(cfg), G,
        steps_prof[f"qwen35 decode step B=1 ctx {PROMPT + 1}"][1])
    int8["dense"] = run_linear_sweep("[25b]", "qwen35", q8, params, ceiling)
    serving["int8"] = int8
    eager["int8"] = {"tokens": int8_tokens, "tpot_p50_ms": int8["tpot_p50_ms"],
                     "tpot_p95_ms": int8["tpot_p95_ms"]}
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[25g] the hybrid's decode step under CUDA graphs (the defaults precompile=True, "
        f"enable_cuda_graph=True), bf16 and int8, {Q35_SLOTS} slots, against the eager runs "
        "of [20] and [25b]")
    t = time.perf_counter()
    serving["graphs"] = run_hybrid_graphed(cfg, q35, q35e, params, q8, contract,
                                           {"paged_decode": pd, "flash_prefill": fp,
                                            "int8_linear": il, "moe_int8_gemv": k6}, eager,
                                           run["main_prompt"])
    serving["graphs"]["phase_s"] = time.perf_counter() - t
    log(f"  [25g] took {serving['graphs']['phase_s']:.1f} s")
    del q8
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[25h] the hybrid's decode blocks under the JAX defaults, graphed, bf16, "
        f"{Q35_SLOTS} slots, against [25g]'s one-token graphed tokens")
    t = time.perf_counter()

    def start():
        return q35e.start_engine_from_params(
            cfg, shallow_tree(params), contract.EngineLoadOptions(
                max_batch_size=Q35_SLOTS, kv_memory_fraction=0.5, seed=SEED, **WHOLE),
            device="cuda")

    serving["blocks"] = block_phase(
        "[25h] bf16", start, None, cfg, contract,
        {"paged_decode": pd, "flash_prefill": fp, "int8_linear": il, "moe_int8_gemv": k6},
        lambda r: {"paged_decode": G * r["decode_steps"], "flash_prefill": G * r["prefills"],
                   "int8_linear": 0, "moe_int8_gemv": 0},
        {"main": eager["bf16"]["tokens"]["main"]}, (Q35_WARMUP, (PROMPT, OUT)), SEED + 3,
        sampled=False)
    serving["blocks"]["phase_s"] = time.perf_counter() - t
    log(f"  [25h] took {serving['blocks']['phase_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[25c] echo with prompt logprobs on the hybrid under CHUNK_OPTS (bf16): a "
        f"{CHUNK_PROMPT}-token echo request while {len(CHUNK_STREAMS)} streams decode")
    serving["echo"] = run_echo("[25c]", "qwen35", cfg, q35, q35e, params, contract)
    return serving, steps_json(steps_prof), run["launches"], c_launches, c_shapes


def run_qwen35_chunked(cfg, q35, q35e, params, contract, pd, fp):
    """Phases 22-25 on the hybrid's weights. Returns (serving record, the
    phase's K1 / K2 launches, K2 at Q35_K2_CHUNK_SHAPES)."""
    from pegainfer_tpu_torch.ops import attention as att

    G = cfg.num_groups
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    gc.collect()  # the first engine's pool (its handle and scheduler form a cycle)
    torch.cuda.empty_cache()
    log(f"[22] K2 at the hybrid's chunk shapes (T, S, q_offset) {Q35_K2_CHUNK_SHAPES}, Hq {Hq}, "
        f"Hkv {Hkv}, hd {hd}: against its plain version per query row, and timed")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    shapes = [time_chunk(gen, fp, att, T, S, q_offset, Hq, Hkv, hd)
              for T, S, q_offset in Q35_K2_CHUNK_SHAPES]
    for r in shapes:
        log(f"  K2 flash_attention T={r['T']}, S={r['S']}, q_offset {r['q_offset']}: max_abs_err "
            f"{r['max_abs_err']:.3e}, worst row at {r['share_of_limit']:.3f} of its limit ok; "
            f"{r['ms'] * 1e3:.2f} us vs bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            f"plain {r['plain_ms'] * 1e3:.2f} us, library "
            + (f"{r['library_ms'] * 1e3:.2f} us" if r["library_ms"] is not None
               else r["library_call"]))

    log(f"[23] a second Qwen3.5 engine on the same weights, {Q35_CHUNK_SLOTS} state slots: "
        + ", ".join(f"{k}={v}" for k, v in CHUNK_OPTS.items()))
    handle = q35e.start_engine_from_params(cfg, params, contract.EngineLoadOptions(
        max_batch_size=Q35_CHUNK_SLOTS, kv_memory_fraction=0.5, seed=SEED, **CHUNK_OPTS,
        **EAGER),
        device="cuda")
    ex = handle._scheduler.executor
    pool = {"pages": ex.kv_pages.shape[2], "snapshot_cap": ex.prefix_cache.max_snapshots,
            "snapshot_bytes": q35.slot_bytes(cfg)}
    log(f"  KV pool: {pool['pages']} pages x {PAGE} tokens; up to {pool['snapshot_cap']} state "
        f"snapshots of {pool['snapshot_bytes'] / 1e6:.2f} MB kept off it")
    rec = record_chunked_path(ex, "match_hybrid")
    rng = np.random.default_rng(SEED + 10)
    streams = [(rng.integers(0, cfg.vocab_size, n).tolist(), m) for n, m in CHUNK_STREAMS]
    long_prompt = rng.integers(0, cfg.vocab_size, CHUNK_PROMPT).tolist()
    ext_prompt = long_prompt + rng.integers(0, cfg.vocab_size, Q35_CHUNK_EXT).tolist()
    label, ext_label = f"{CHUNK_PROMPT}/{CHUNK_OUT}", f"{len(ext_prompt)}/{CHUNK_OUT}"
    try:
        pd.launches = fp.launches = 0
        chans = [run_request(contract, handle, p, m)[0] for p, m in streams]
        early = [read_tokens(contract, ch, 2) for ch in chans]  # both have decoded a token
        joins = [drain_in_background(contract, ch) for ch in chans]
        ch, t_cold = run_request(contract, handle, long_prompt, CHUNK_OUT)
        toks, fin, times_cold = drain(contract, ch)
        expect_finished(contract, f"cold {label} under decode load", toks, fin, CHUNK_OUT)
        stream_times = []
        for (toks0, times0), join, (p, m) in zip(early, joins, streams):
            toks, fin, times = join()
            expect_finished(contract, f"stream {len(p)}/{m}", toks0 + toks, fin, m)
            stream_times.append(times0 + times)
        ch, t_warm = run_request(contract, handle, long_prompt, CHUNK_OUT)
        toks, fin, times_warm = drain(contract, ch)
        expect_finished(contract, f"warm {label} alone", toks, fin, CHUNK_OUT)
        ch, t_ext = run_request(contract, handle, ext_prompt, CHUNK_OUT)
        toks, fin, times_ext = drain(contract, ch)
        expect_finished(contract, f"extended {ext_label} alone", toks, fin, CHUNK_OUT)
        launches = {"paged_decode": pd.launches, "flash_prefill": fp.launches}
        counts = {"prefills": ex.prefills, "chunk_pieces": ex.chunk_pieces,
                  "mixed_pieces": ex.mixed_pieces, "decode_steps": ex.decode_steps,
                  "cache_hits": ex.prefix_cache.hits}
    finally:
        handle.shutdown()
        handle._thread.join(timeout=60)
    del handle, ex
    gc.collect()
    torch.cuda.empty_cache()

    m = CHUNK_OPTS["prefill_chunk_mixed"]
    n_pieces = CHUNK_PROMPT // m
    want_pieces = [(i * m, m, len(CHUNK_STREAMS)) for i in range(n_pieces)]
    tail = CHUNK_PROMPT - m  # the fine tail's last piece starts here
    want_snaps = [(CHUNK_PROMPT, tail), (CHUNK_PROMPT, CHUNK_PROMPT)]
    want_matches = [0] * (len(streams) + 1) + [tail, CHUNK_PROMPT]
    log(f"[23] {counts}; fused pieces (start, rows, decode rows): "
        f"{[p[:3] for p in rec['pieces']]}; snapshots kept (prompt, position) {rec['snaps']}; "
        f"cached tokens per lookup {rec['matches']}")
    if ([p[:3] for p in rec["pieces"]] != want_pieces or counts["mixed_pieces"] != n_pieces
            or counts["chunk_pieces"] != n_pieces + 2 or counts["cache_hits"] != 2
            or rec["snaps"][:2] != want_snaps or rec["matches"] != want_matches):
        raise SystemExit(f"the cold prompt did not run as {n_pieces} fused pieces of {m} with "
                         f"{len(CHUNK_STREAMS)} decode rows and snapshots at {tail} and "
                         f"{CHUNK_PROMPT}, or the later prompts did not hit {tail} and "
                         f"{CHUNK_PROMPT} cached tokens with one piece each")
    check_launches(launches, {"flash_prefill": G * (counts["prefills"] + counts["chunk_pieces"]),
                              "paged_decode": G * (counts["decode_steps"]
                                                   + counts["mixed_pieces"])},
                   f"{G} x (whole prefills + pieces) K2, {G} x (decode steps + fused pieces) K1")

    rid_cold = len(streams)  # the scheduler's ids, in order
    cold, warm, ext = (rec["logits"][rid_cold + i] for i in range(3))
    log("[24] logits on the card: the cold chunked prompt against one whole prefill")
    per = -(-len(ext_prompt) // PAGE)
    table = torch.arange(1, per + 1, dtype=torch.int32, device="cuda")
    shares = {}
    with torch.no_grad():
        st = q35.make_state(cfg, per + 1, PAGE, 1, device="cuda")
        whole, _ = q35.prefill(cfg, params, st, torch.tensor(long_prompt, dtype=torch.int32,
                                                             device="cuda"), table, 0)
        shares["cold_vs_whole"] = check_logits(cold, whole, LOGITS_RTOL, "the chunked "
                                               "prefill's logits disagree with the whole prefill")
        log("  the warm hit's logits against the cold ones")
        shares["warm_vs_cold"] = check_logits(warm, cold, LOGITS_RTOL, "the prefix-cache hit's "
                                              "logits disagree with the cold prompt's")
        log("  the extended prompt's logits (a hit at the cold prompt's end) against one "
            "whole prefill of it")
        whole_ext, _ = q35.prefill(cfg, params, st, torch.tensor(ext_prompt, dtype=torch.int32,
                                                                 device="cuda"), table, 0)
        shares["extended_vs_whole"] = check_logits(ext, whole_ext, LOGITS_RTOL, "the extended "
                                                   "prompt's logits disagree with its whole "
                                                   "prefill")
        for got in (cold, warm, ext):
            if not (bool(torch.isfinite(got).all()) and got.shape == (cfg.vocab_size,)):
                raise SystemExit("chunked-path logits are not finite [V]")
    del st

    log("[25] timings of the chunked path (host clock)")
    ttft = {"cold_ms": (times_cold[0] - t_cold) * 1e3, "warm_ms": (times_warm[0] - t_warm) * 1e3,
            "extended_ms": (times_ext[0] - t_ext) * 1e3}
    gaps = [(b - a) * 1e3 for ts in stream_times for a, b in zip(ts, ts[1:])
            if b > t_cold and a < times_cold[0]]
    walls = [p[3] for p in rec["pieces"]]
    log(f"  TTFT {label}: cold under decode load {ttft['cold_ms']:.3f} ms ({n_pieces} fused "
        f"pieces), warm alone {ttft['warm_ms']:.3f} ms ({tail} tokens cached, "
        f"{CHUNK_PROMPT - tail} re-run); extended {ext_label} {ttft['extended_ms']:.3f} ms "
        f"({CHUNK_PROMPT} cached, {Q35_CHUNK_EXT} re-run)")
    log(f"  streams' largest token gap during the cold prefill {max(gaps):.3f} ms over "
        f"{len(gaps)} gaps; one fused piece's wall: median {statistics.median(walls):.3f} ms, "
        f"max {max(walls):.3f} ms")
    steps = hybrid_piece_profile(cfg, q35, params, long_prompt, streams)
    log_steps(steps)
    serving = {"options": CHUNK_OPTS, "slots": Q35_CHUNK_SLOTS, "prompt": CHUNK_PROMPT,
               "extended_prompt": len(ext_prompt), "output": CHUNK_OUT,
               "streams": CHUNK_STREAMS, "pool": pool, **{f"ttft_{k}": v for k, v in ttft.items()},
               "max_gap_during_prefill_ms": max(gaps), "piece_wall_ms": walls, **counts,
               "snapshots": rec["snaps"], "cached_tokens": rec["matches"],
               "logits_share_of_limit": shares, "steps": steps_json(steps)}
    return serving, launches, shapes


def hybrid_piece_profile(cfg, q35, params, long_prompt, streams, iters=3):
    """profile_calls on the cold prompt's last fused piece (256 rows at
    3,840 and one decode row per stream, 16 tokens into its output), called
    directly on the model on a fresh state, with K2's and K1's device time;
    the GDN ops of such a piece alone, on inputs at its shapes (a chunk's
    conv continuation and chunk loop, a decode row's conv and recurrence
    steps, for each of the 24 GDN layers); and the piece's k/v gather alone
    (each full-attention layer's pages of the 4,096 tokens)."""
    from pegainfer_tpu_torch.ops import gdn

    m = CHUNK_OPTS["prefill_chunk_mixed"]
    start = CHUNK_PROMPT - m
    n_long = CHUNK_PROMPT // PAGE
    ctx = [len(p) + 16 for p, _ in streams]
    n_dec = [-(-(n + 1) // PAGE) for n in ctx]
    state = q35.make_state(cfg, 1 + n_long + sum(n_dec), PAGE, len(streams) + 1, device="cuda")
    table = torch.arange(1, n_long + 1, dtype=torch.int32, device="cuda")
    tables = torch.zeros((len(streams), max(n_dec)), dtype=torch.int32, device="cuda")
    nxt = n_long + 1
    for b, n in enumerate(n_dec):
        tables[b, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n

    def col(vals):
        return torch.tensor(vals, dtype=torch.int32, device="cuda")

    chunk = col(long_prompt[start:])
    dec = (col([p[-1] for p, _ in streams]), col(ctx), tables, col([n + 1 for n in ctx]),
           col(list(range(len(streams)))))
    slot = len(streams)
    n_lin = cfg.num_groups * (cfg.period - 1)
    Hv, dk, dv = cfg.linear_num_value_heads, cfg.linear_key_head_dim, cfg.linear_value_head_dim
    K, C, B = cfg.linear_conv_kernel_dim, cfg.conv_dim, len(streams)
    Hkv, hd = cfg.num_key_value_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    conv_w = params["lin"]["conv_w"][0, 0]
    x_c, q_c, k_c, v_c = rnd(m, C), rnd(m, Hv, dk), rnd(m, Hv, dk), rnd(m, Hv, dv)
    g_c = -torch.nn.functional.softplus(rnd(m, Hv, dtype=torch.float32))
    b_c = torch.sigmoid(rnd(m, Hv, dtype=torch.float32))
    conv0, s0 = rnd(K, C, dtype=torch.float32), rnd(Hv, dk, dv, dtype=torch.float32)
    x_d, conv_d = rnd(B, C), rnd(B, K, C, dtype=torch.float32)
    rec_d = rnd(B, Hv, dk, dv, dtype=torch.float32)

    def gdn_piece():
        for _ in range(n_lin):
            gdn.causal_conv1d_cont(x_c, conv_w, conv0, m)
            gdn.gdn_chunk(q_c, k_c, v_c, g_c, b_c, s0)
            gdn.causal_conv1d_step(x_d, conv_w, conv_d)
            gdn.gdn_step(q_c[:B], k_c[:B], v_c[:B], g_c[:B], b_c[:B], rec_d)

    pages = table.long()
    return profile_calls({
        f"qwen35 fused piece {m} at {start} + {B} decode rows": lambda: q35.mixed_chunk(
            cfg, params, state, chunk, start, m, table, slot, *dec),
        f"qwen35 GDN ops of that piece ({n_lin} x conv continuation + chunk loop + conv "
        "step + recurrence step)": gdn_piece,
        f"qwen35 k/v gather alone, {cfg.num_groups} layers x {CHUNK_PROMPT} tokens":
            lambda: [state["kv"][gi][:, pages].permute(2, 1, 3, 0, 4).reshape(
                2, -1, Hkv, hd).contiguous() for gi in range(cfg.num_groups)],
    }, iters, kernels={"K2": "flash_prefill", "K1": "paged_decode"})


def check_hybrid_kernels(cfg, pd, fp):
    """K1 and K2 at the hybrid's shapes (Q35_K1_CASES, Q35_K2_T) against
    their plain versions by the per-row rules of phase 3; a dead row must be
    exactly 0. Returns each kernel's max |diff|."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    errs = {"paged_decode": 0.0, "flash_prefill": 0.0}
    for seq_lens in Q35_K1_CASES:
        a = decode_case(gen, cfg, seq_lens, "pool_cur", layers=cfg.num_groups)
        out = pd.paged_attention_decode(**a)
        torch.cuda.synchronize()
        ref = pd.paged_attention_decode_plain(**a)
        err, share = decode_err(out, ref)
        dead = [b for b, n in enumerate(seq_lens) if n == 0]
        ok = (share <= 1.0 and all(out[b].abs().max().item() == 0.0 for b in dead)
              and bool(torch.isfinite(out).all()))
        log(f"  K1 paged_decode  contexts {seq_lens}, pool of {cfg.num_groups} layers + "
            f"layer_id + cur: max_abs_err {err:.3e}, worst row at {share:.3f} of its limit"
            f"{' dead row 0' if dead else ''} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("paged decode kernel disagrees with its plain version at the "
                             "hybrid's shapes")
        errs["paged_decode"] = max(errs["paged_decode"], err)
    for T in Q35_K2_T:
        q, k, v = (torch.randn((T, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        out = fp.flash_prefill(q, k, v, T, hd ** -0.5)
        torch.cuda.synchronize()
        ref = fp.att.prefill_attention(q, k, v, T, hd ** -0.5)
        err, share = prefill_err(out, ref)
        ok = share <= 1.0 and bool(torch.isfinite(out).all())
        log(f"  K2 flash_prefill T=S={T}, Hq {Hq}, Hkv {Hkv}, hd {hd}: max_abs_err {err:.3e}, "
            f"worst row at {share:.3f} of its limit {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("flash prefill kernel disagrees with its plain version at the "
                             "hybrid's shapes")
        errs["flash_prefill"] = max(errs["flash_prefill"], err)
    return errs


def check_hybrid_logits(cfg, q35, params, prompt_t):
    """Phase 7's rule on the hybrid: the prompt's last prefill logits with
    the kernels against ``plain_kernels=True``, each into a fresh state;
    then the concurrent requests' prompts prefilled (kernels) into slots 0-2,
    the state copied, and one decode step at B = 3 padded to 4 (seq_len 0,
    the null page, the dead slot) run on each copy, kernels against plain,
    row by row. Returns the prompt's greedy first token."""
    lens = [n for n, _ in Q35_CONCURRENT]
    per = -(-(max(lens + [PROMPT]) + 1) // PAGE)
    n_pages = 1 + per * (len(lens) + 1)

    def state():
        return q35.make_state(cfg, n_pages, PAGE, 4, device="cuda")

    table = torch.arange(1, 1 + per, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        lk, _ = q35.prefill(cfg, params, state(), prompt_t, table, 3)
        lp, _ = q35.prefill(cfg, params, state(), prompt_t, table, 3, plain_kernels=True)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(lk).all()) and lk.shape == (cfg.vocab_size,)):
            raise SystemExit("Qwen3.5 kernel-path prefill logits are not finite [V]")
        check_logits(lk, lp, LOGITS_RTOL, "Qwen3.5 kernel-path prefill logits disagree "
                     "with the plain-attention model")

        rng = np.random.default_rng(SEED + 7)
        st_k = state()
        B = 4
        tables = torch.zeros((B, per), dtype=torch.int32, device="cuda")
        toks = []
        for b, n in enumerate(lens):
            tables[b] = torch.arange(1 + (b + 1) * per, 1 + (b + 2) * per)
            p = torch.tensor(rng.integers(0, cfg.vocab_size, n), dtype=torch.int32,
                             device="cuda")
            last, _ = q35.prefill(cfg, params, st_k, p, tables[b], b)
            toks.append(int(last.argmax()))
        st_p = {k: v.clone() for k, v in st_k.items()}

        def col(vals, dead):
            return torch.tensor(vals + [dead], dtype=torch.int32, device="cuda")

        step = (col(toks, 0), col(lens, 0), tables, col([n + 1 for n in lens], 0),
                col([0, 1, 2], 4))
        dk = q35.decode(cfg, params, st_k, *step)
        dp = q35.decode(cfg, params, st_p, *step, plain_kernels=True)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(dk[:3]).all()) and dk.shape == (B, cfg.vocab_size)):
            raise SystemExit("Qwen3.5 kernel-path decode logits are not finite [B, V]")
        for b, n in enumerate(lens):
            log(f"  decode row {b} (context {n + 1}):")
            check_logits(dk[b], dp[b], LOGITS_RTOL, "Qwen3.5 kernel-path decode logits "
                         "disagree with the plain-attention model")
    return int(lk.argmax())


def hybrid_step_profile(cfg, q35, params, prompt_t, first_token, iters=3):
    """profile_calls on one 1,024-token prefill and one B = 1 decode step at
    context 1,025, called directly on the model, with K2's and K1's device
    time; and the GDN ops alone, as the model calls them in its 24 GDN
    layers, on inputs at their shapes: the conv and the chunk loop of a
    prefill (``causal_conv1d``, ``gdn_chunk``), the conv step and the
    recurrence step of a decode step (``causal_conv1d_step``,
    ``gdn_step``)."""
    from pegainfer_tpu_torch.ops import gdn

    per = -(-(PROMPT + 1) // PAGE)
    state = q35.make_state(cfg, 1 + per, PAGE, 1, device="cuda")
    table = torch.arange(1, 1 + per, dtype=torch.int32, device="cuda")
    dec = [torch.tensor(x, dtype=torch.int32, device="cuda") for x in
           ([first_token], [PROMPT], [table.tolist()], [PROMPT + 1], [0])]
    n_lin = cfg.num_groups * (cfg.period - 1)
    Hv, dk, dv = cfg.linear_num_value_heads, cfg.linear_key_head_dim, cfg.linear_value_head_dim
    K, C = cfg.linear_conv_kernel_dim, cfg.conv_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    conv_w = params["lin"]["conv_w"][0, 0]
    x_p, q_p, k_p, v_p = rnd(PROMPT, C), rnd(PROMPT, Hv, dk), rnd(PROMPT, Hv, dk), rnd(
        PROMPT, Hv, dv)
    g_p = -torch.nn.functional.softplus(rnd(PROMPT, Hv, dtype=torch.float32))
    b_p = torch.sigmoid(rnd(PROMPT, Hv, dtype=torch.float32))
    s0 = torch.zeros((Hv, dk, dv), device="cuda")
    x_d, conv_d, rec_d = rnd(1, C), rnd(1, K, C, dtype=torch.float32), rnd(
        1, Hv, dk, dv, dtype=torch.float32)

    def gdn_prefill():
        for _ in range(n_lin):
            gdn.causal_conv1d(x_p, conv_w)
            gdn.gdn_chunk(q_p, k_p, v_p, g_p, b_p, s0)

    def gdn_decode():
        for _ in range(n_lin):
            gdn.causal_conv1d_step(x_d, conv_w, conv_d)
            gdn.gdn_step(q_p[:1], k_p[:1], v_p[:1], g_p[:1], b_p[:1], rec_d)

    return profile_calls({
        f"qwen35 prefill {PROMPT}": lambda: q35.prefill(cfg, params, state, prompt_t, table, 0),
        f"qwen35 decode step B=1 ctx {PROMPT + 1}": lambda: q35.decode(cfg, params, state,
                                                                       *dec),
        f"qwen35 GDN ops of a prefill ({n_lin} x conv + chunk loop)": gdn_prefill,
        f"qwen35 GDN ops of a decode step ({n_lin} x conv step + recurrence step)": gdn_decode,
    }, iters, kernels={"K2": "flash_prefill", "K1": "paged_decode"})


# ── DeepSeek-V4-Flash, 8 layers, resident fp8 / fp4 weights ────────────


def dsv4_flash_config(d4):
    """DeepSeek-V4-Flash at its published widths (huggingface.co/deepseek-ai/
    DeepSeek-V4-Flash config.json, as scripts/dsv4_flagship_probe.py sets
    them: hidden 4096, 64 heads of 512, q-LoRA 1024, o-LoRA 8 x 1024, rope
    64, window 128, 256 routed experts top-6 of width 2048, indexer 64 x 128
    top-512, vocab 129,280, 3 hash layers), cut to its first 8 layers; their
    compress ratios [0, 0, 4, 128, 4, 128, 4, 128] cover every attention
    class and both gates."""
    return d4.DSv4Config(
        vocab_size=129280, dim=4096, moe_inter_dim=2048, n_layers=DSV4_LAYERS,
        num_attention_heads=64, head_dim=512, q_lora_rank=1024, qk_rope_head_dim=64,
        o_groups=8, o_lora_rank=1024, sliding_window=128, n_routed_experts=256,
        n_shared_experts=1, n_activated_experts=6, n_hash_layers=3,
        routed_scaling_factor=1.5, swiglu_limit=7.0, rms_norm_eps=1e-6,
        index_n_heads=64, index_head_dim=128, index_topk=512,
        max_position_embeddings=1048576, rope_theta=10000.0, compress_rope_theta=10000.0,
        compress_ratios=(0, 0, 4, 128, 4, 128, 4, 128), yarn_original_seq_len=65536,
        yarn_factor=16.0)


def fp8_per_decode_step(cfg):
    """K4 launches in one decode step: 7 fp8 linears a layer (wq_a, wq_b,
    wkv, wo_b, shared w1 / w3 / w2) and idx_wq_b on the ratio-4 layers."""
    return sum(7 + (r == 4) for r in cfg.compress_ratios)


def run_dsv4():
    """Phases 9-13 on DeepSeek-V4-Flash. Returns (cfg, the fp4 params, K3-K5
    records, serving, steps)."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import dsv4 as d4
    from pegainfer_tpu_torch.models import dsv4_engine as d4e
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
    from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4

    cfg = dsv4_flash_config(d4)
    log(f"[9] DeepSeek-V4-Flash, {cfg.n_layers} layers at full width, random resident "
        f"fp8 / fp4 weights (seed {SEED})")
    t = time.perf_counter()
    params = d4.init_random_resident_device(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    log(f"  weights: {d4.params_bytes(params) / 1e9:.2f} GB in "
        f"{time.perf_counter() - t:.1f} s")

    log("[10] K3, K4, K5 against their plain versions on the model's weights")
    errs = check_quant_kernels(cfg, params, k3, k4, k5)

    log(f"[11] serving through dsv4_engine.start_engine_from_params "
        f"({DSV4_SLOTS} slots, max_model_len {DSV4_MAX_MODEL_LEN})")
    kernels = {"moe_fp4_gemv": k3, "fp8_gemv": k4, "moe_fp4_grouped": k5}
    run = serve_slots(cfg, contract, dsv4_engine(cfg, contract, d4e, params), kernels)
    launches, prefills, decode_steps = run["launches"], run["prefills"], run["decode_steps"]
    main_prompt, ttft_ms, gaps = run["main_prompt"], run["ttft_ms"], run["gaps"]
    log("[12] all requests Finished with their token counts; " + check_slot_events(
        run["events"], third_waits=True))
    L = cfg.n_layers
    want = {"moe_fp4_gemv": 3 * L * decode_steps,
            "fp8_gemv": fp8_per_decode_step(cfg) * decode_steps,
            "moe_fp4_grouped": 3 * L * prefills}
    log(f"  launches {launches}; expected {want} ({prefills} prefills, {decode_steps} "
        f"decode steps, {L} layers, {fp8_per_decode_step(cfg)} fp8 linears a step)")
    if launches != want:
        raise SystemExit("DSv4 kernel launch counts do not match the path")

    log(f"  {DSV4_PROMPT}-token prefill and one decode step: kernels vs plain versions, "
        f"the kernel run routed as the plain run")
    toks_t = torch.tensor(main_prompt, dtype=torch.int32, device="cuda")
    state_k, step = check_dsv4_logits(cfg, d4, d4e, params, toks_t)

    log("[13] DSv4 timings")
    steps = dsv4_step_profile(cfg, d4, params, toks_t, state_k, step)
    tpot = statistics.median(gaps)
    tpot95 = float(np.percentile(gaps, 95))
    log(f"  main {DSV4_PROMPT}/{DSV4_OUT}: TTFT {ttft_ms:.3f} ms, TPOT p50 {tpot:.3f} ms, "
        f"p95 {tpot95:.3f} ms over {len(gaps)} gaps (host clock, per streamed token)")
    log_steps(steps)
    records = time_quant_kernels(cfg, params, k3, k4, k5, errs, launches)
    log_records(records)
    serving = {"ttft_ms": ttft_ms, "tpot_p50_ms": tpot, "tpot_p95_ms": tpot95,
               "prompt": DSV4_PROMPT, "output": DSV4_OUT}
    log("[13g] DSv4's decode step under CUDA graphs (the defaults precompile=True, "
        "enable_cuda_graph=True; each bucket captured at first use): fp4 with the chain off "
        "(K3 / K4) against [11]'s eager run, and with moe_chain=True (K9) against an eager "
        "run of the same traffic here")
    t = time.perf_counter()
    serving["graphs"] = run_dsv4_graphed(cfg, params, contract, run, kernels)
    serving["graphs"]["phase_s"] = time.perf_counter() - t
    log(f"  [13g] took {serving['graphs']['phase_s']:.1f} s")
    log("[13h] DSv4 decode blocks under the JAX defaults, graphed, fp4 with the chain off "
        "(K3 / K4), against [11]'s tokens (equal to [13g]'s one-token graphed ones)")
    t = time.perf_counter()
    serving["blocks"] = dsv4_blocks("[13h] fp4", cfg, params, contract, run, kernels,
                                    lambda r: {"moe_fp4_gemv": 3 * L * r["decode_steps"],
                                               "fp8_gemv": fp8_per_decode_step(cfg)
                                               * r["decode_steps"],
                                               "moe_fp4_grouped": 3 * L * r["prefills"]})
    serving["blocks"]["phase_s"] = time.perf_counter() - t
    log(f"  [13h] took {serving['blocks']['phase_s']:.1f} s")
    return cfg, params, records, serving, steps_json(steps)


def dsv4_blocks(label, cfg, params, contract, run, kernels, expected, quantize=None):
    """Phases 13h / 18h: ``block_phase`` on phase 11's traffic (the main
    request and DSV4_CONCURRENT, its tokens ``run``'s), with its idle
    window over the main request's steady blocks."""
    from pegainfer_tpu_torch.models import dsv4_engine as d4e

    def start():
        return d4e.start_engine_from_params(cfg, params, contract.EngineLoadOptions(
            max_batch_size=DSV4_SLOTS, max_model_len=DSV4_MAX_MODEL_LEN, seed=SEED,
            quantize=quantize, **WHOLE), device="cuda")

    return block_phase(label, start, None, cfg, contract, kernels, expected,
                       {"main": run["main_tokens"], "concurrent": run["concurrent_tokens"]},
                       (DSV4_WARMUP, (DSV4_PROMPT, DSV4_OUT)), SEED + 3,
                       pair="concurrent", sampled=False)


def run_dsv4_graphed(cfg, params, contract, run, kernels):
    """Phase 13g on the fp4 params: ``dsv4_graphed`` with the chain off
    (the oracle [11]'s ``run``; K3 3L and K4 ``fp8_per_decode_step`` a
    step) and with ``moe_chain=True`` (the oracle an eager run here; K9 L a
    step, no K3). Returns the record."""
    from pegainfer_tpu_torch.models import dsv4_engine as d4e
    from pegainfer_tpu_torch.ops.cuda import fp4_chain as k9

    L, f8 = cfg.n_layers, fp8_per_decode_step(cfg)

    def expected(chain):
        def want(r):
            steps = r["decode_steps"]
            out = {"moe_fp4_gemv": 0 if chain else 3 * L * steps, "fp8_gemv": f8 * steps,
                   "moe_fp4_grouped": 3 * L * r["prefills"]}
            if chain:
                out["moe_fp4_chain"] = L * steps
            return out
        return want

    out = {"fp4": dsv4_graphed("[13g] fp4", cfg, params, contract, run["main_prompt"],
                               eager_record(run), kernels, expected(False))}
    chain_kernels = {**kernels, "moe_fp4_chain": k9}
    log("  the eager engine with moe_chain=True on phase 11's traffic (the oracle of K9's "
        "graphs)")
    eager = serve_slots(cfg, contract, dsv4_engine(cfg, contract, d4e, params, moe_chain=True),
                        chain_kernels)
    check_launches(eager["launches"], expected(True)(eager),
                   f"{eager['prefills']} prefills, {eager['decode_steps']} eager decode steps")
    out["fp4_chain"] = dsv4_graphed("[13g] fp4 + K9", cfg, params, contract, run["main_prompt"],
                                    eager_record(eager), chain_kernels, expected(True),
                                    moe_chain=True)
    return out


# ── phases 13a-13c: DeepSeek-V4's slot prefix cache and PD handoff ──────


def run_dsv4_cache(cfg, params):
    """Phases 13a-13c on the fp4 params. Returns (the cache record, the PD
    record, K3's and K4's launches inside the engine's resumes, read from
    their counts)."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.engine.slot_executor import SlotExecutor
    from pegainfer_tpu_torch.models import dsv4 as d4
    from pegainfer_tpu_torch.models import dsv4_engine as d4e
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
    from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4

    opts = contract.EngineLoadOptions(max_batch_size=DSV4_SLOTS,
                                      max_model_len=DSV4_MAX_MODEL_LEN, seed=SEED, **ONE_TOKEN)
    log(f"[13a] the slot prefix cache under the engine's defaults (enable_prefix_cache="
        f"{opts.enable_prefix_cache}, prefill_chunk={opts.prefill_chunk}): P "
        f"{DSV4_CACHE_PROMPT}/{DSV4_CACHE_OUT} with logprobs, P again, P + {DSV4_CACHE_EXT}, "
        f"P + {DSV4_CACHE_FAR} other tokens, one after another")
    if not (opts.enable_prefix_cache and opts.prefill_chunk == 2048):
        raise SystemExit("the engine's defaults are not the JAX engine's")
    handle = d4e.start_engine_from_params(cfg, params, opts, device="cuda")
    ex = handle._scheduler.executor
    cache = ex.slot_prefix_cache
    if cache is None:
        raise SystemExit("the DSv4 engine built no slot prefix cache under the defaults")
    log(f"  cache: {cache.max_entries} entries of {ex.snapshot_bytes / 1e6:.3f} MB")
    rng = np.random.default_rng(SEED + 12)
    P = rng.integers(0, cfg.vocab_size, DSV4_CACHE_PROMPT).tolist()
    ext = P + rng.integers(0, cfg.vocab_size, DSV4_CACHE_EXT).tolist()
    far = P + rng.integers(0, cfg.vocab_size, DSV4_CACHE_FAR).tolist()
    plan = (("a", P, 1), ("b", P, 0), ("c", ext, 0), ("d", far, 0))
    kernels = {"moe_fp4_gemv": k3, "fp8_gemv": k4, "moe_fp4_grouped": k5}
    out = {}
    # K3's and K4's launches inside the engine's resumes (replays of its
    # B = 1 graph under the defaults), read from their counts before and
    # after each resume
    resume_launches = {"moe_fp4_gemv": 0, "fp8_gemv": 0}
    resume = ex._resume
    if ex._graphs is None:
        raise SystemExit("the DSv4 engine under the defaults built no decode graphs")

    def counted_resume(*args, **kwargs):
        before = {n: kernels[n].launches for n in resume_launches}
        logits = resume(*args, **kwargs)
        for n in resume_launches:
            resume_launches[n] += kernels[n].launches - before[n]
        return logits

    ex._resume = counted_resume
    try:
        for mod in kernels.values():
            mod.launches = 0
        ex.prefills = ex.decode_steps = ex.resume_steps = 0
        for name, prompt, logprobs in plan:
            k5_before = k5.launches
            ch, t0 = run_request(contract, handle, prompt, DSV4_CACHE_OUT, logprobs=logprobs)
            toks, fin, times = drain(contract, ch)
            expect_finished(contract, f"({name}) {len(prompt)}/{DSV4_CACHE_OUT}", toks, fin,
                            DSV4_CACHE_OUT)
            out[name] = {"prompt": len(prompt), "ttft_ms": (times[0] - t0) * 1e3,
                         "tokens": toks, "k5_launches": k5.launches - k5_before}
        launches = {n: mod.launches for n, mod in kernels.items()}
        counts = {"hits": cache.hits, "misses": cache.misses, "prefills": ex.prefills,
                  "decode_steps": ex.decode_steps, "resume_steps": ex.resume_steps,
                  "graph_captures": [(b, round(sec, 3)) for b, _, _, sec, _ in
                                     ex._graphs.capture_log]}
    finally:
        handle.shutdown()
        handle._thread.join(timeout=60)
    del handle, ex, cache
    gc.collect()
    torch.cuda.empty_cache()

    L, steps = cfg.n_layers, counts["decode_steps"]
    log(f"  {counts}; TTFT " + ", ".join(f"({n}) {r['ttft_ms']:.3f} ms" for n, r in out.items())
        + " (host clock)")
    if (counts["hits"], counts["misses"], counts["prefills"], counts["resume_steps"]) != (
            3, 1, 2, DSV4_CACHE_EXT):
        raise SystemExit("the cache did not take (a) as a miss and (b)-(d) as hits, with "
                         f"fresh prefills for (a) and (d) and {DSV4_CACHE_EXT} resume steps")
    if out["b"]["k5_launches"] or out["b"]["tokens"] != out["a"]["tokens"]:
        raise SystemExit("(b) ran a prefill or streamed other tokens than (a)")
    run_steps = steps + counts["resume_steps"]
    check_launches(launches, {"moe_fp4_gemv": 3 * L * run_steps,
                              "fp8_gemv": fp8_per_decode_step(cfg) * run_steps,
                              "moe_fp4_grouped": 3 * L * counts["prefills"]},
                   f"{counts['prefills']} fresh prefills, {steps} decode steps + "
                   f"{counts['resume_steps']} resume steps")
    check_launches(resume_launches, {"moe_fp4_gemv": 3 * L * counts["resume_steps"],
                                     "fp8_gemv": fp8_per_decode_step(cfg)
                                     * counts["resume_steps"]},
                   f"K3 / K4 inside the engine's resumes, {counts['resume_steps']} steps")

    log(f"[13b] (c)'s resume on the model: P prefilled into slot 0, its snapshot imported "
        f"into slot 1, {DSV4_CACHE_EXT} tokens resumed there against {DSV4_CACHE_EXT} decode "
        "steps on slot 0")
    blocks = d4e.max_blocks_for(cfg, DSV4_MAX_MODEL_LEN)
    state = d4.make_state(cfg, DSV4_SLOTS, blocks, dtype=torch.bfloat16, device="cuda")
    suffix = torch.tensor(ext[DSV4_CACHE_PROMPT:], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        d4.prefill(cfg, params, torch.tensor(P, dtype=torch.int32, device="cuda"), state=state,
                   slot=0, last_only=True)
        snap = d4.slot_export(state, 0)
        d4.slot_import(state, snap, 1)
        torch.cuda.synchronize()
        before = {n: kernels[n].launches for n in resume_launches}
        t = time.perf_counter()
        resumed = d4.prefill_resume(cfg, params, state, suffix, DSV4_CACHE_PROMPT, 1)
        torch.cuda.synchronize()
        resume_ms = (time.perf_counter() - t) * 1e3
        check_launches({n: kernels[n].launches - before[n] for n in resume_launches},
                       {"moe_fp4_gemv": 3 * L * DSV4_CACHE_EXT,
                        "fp8_gemv": fp8_per_decode_step(cfg) * DSV4_CACHE_EXT},
                       f"K3 / K4 inside the model's resume of {DSV4_CACHE_EXT} tokens")
        one = torch.zeros(1, dtype=torch.int32, device="cuda")
        for i in range(DSV4_CACHE_EXT):
            direct = d4.decode(cfg, params, state, suffix[i:i + 1],
                               torch.tensor([DSV4_CACHE_PROMPT + i], dtype=torch.int32,
                                            device="cuda"), one)[0]
        ext_t = torch.tensor(ext, dtype=torch.int32, device="cuda")
        d4.prefill(cfg, params, ext_t, last_only=True)  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        whole, _ = d4.prefill(cfg, params, ext_t, last_only=True)
        torch.cuda.synchronize()
        fresh_ms = (time.perf_counter() - t) * 1e3
        # the same resume through a SlotExecutor's B = 1 graph (captured
        # first, outside the timing), on slot 1 of a state of its own
        gex = SlotExecutor(cfg, params, d4.make_state(cfg, DSV4_SLOTS, blocks,
                                                      dtype=torch.bfloat16, device="cuda"),
                           DSV4_SLOTS, DSV4_MAX_MODEL_LEN,
                           contract.EngineLoadOptions(enable_prefix_cache=False, **ONE_TOKEN))
        gex._graphs.prepare(1)
        gex.slot_import(snap, 1)
        torch.cuda.synchronize()
        before = {n: kernels[n].launches for n in resume_launches}
        t = time.perf_counter()
        g_resumed = gex._resume(ext[DSV4_CACHE_PROMPT:], DSV4_CACHE_PROMPT, 1)
        torch.cuda.synchronize()
        g_resume_ms = (time.perf_counter() - t) * 1e3
        check_launches({n: kernels[n].launches - before[n] for n in resume_launches},
                       {"moe_fp4_gemv": 3 * L * DSV4_CACHE_EXT,
                        "fp8_gemv": fp8_per_decode_step(cfg) * DSV4_CACHE_EXT},
                       f"K3 / K4 inside the graphed resume of {DSV4_CACHE_EXT} tokens, "
                       "through the replays")
    g_token = int(g_resumed.argmax()) == int(resumed.argmax())
    g_rows = all(torch.equal(gl[k][1], el[k][1])
                 for gl, el in zip(gex.state["layers"], state["layers"]) for k in gl)
    g_bits = torch.equal(g_resumed, resumed)
    log(f"  the graphed resume against the eager one: first token equal {g_token}, slot rows "
        f"equal {g_rows}, logits bit for bit {g_bits}")
    if not (g_token and g_rows):
        raise SystemExit("the graphed resume differs from the eager resume")
    del gex
    same = torch.equal(resumed, direct)
    rows = sum(t.numel() * t.element_size() for ls in snap["layers"] for t in ls.values())
    log(f"  resumed logits equal the direct decode steps' bit for bit: {same}; "
        f"snapshot_bytes {d4.snapshot_bytes(state)}, the rows' sum {rows}, expected "
        f"{DSV4_SNAPSHOT_BYTES}")
    if not same:
        raise SystemExit("the resume from an imported snapshot differs from the decode steps")
    if not d4.snapshot_bytes(state) == rows == DSV4_SNAPSHOT_BYTES:
        raise SystemExit("snapshot_bytes is not the sum of one slot's rows")
    if not (bool(torch.isfinite(resumed).all()) and resumed.shape == (cfg.vocab_size,)):
        raise SystemExit("the resumed logits are not finite [V]")
    diff = (resumed - whole[0]).abs().max().item()
    limit = DSV4_LOGITS_RTOL * whole[0].abs().max().item()
    argmax_same = int(resumed.argmax()) == int(whole[0].argmax())
    step_ms = resume_ms / DSV4_CACHE_EXT
    crossover = int(fresh_ms // step_ms)
    g_step_ms = g_resume_ms / DSV4_CACHE_EXT
    g_crossover = int(fresh_ms // g_step_ms)
    threshold = max(32, len(ext) // 16)
    log(f"  resumed logits against one whole prefill of P + {DSV4_CACHE_EXT} (reported, not "
        f"gated: decode and prefill run other kernels, and routing flips on near ties): "
        f"max |diff| {diff:.4g}, {diff / limit:.3f} of rule 7's limit; argmax agrees: "
        f"{argmax_same}")
    log(f"  resume {resume_ms:.3f} ms for {DSV4_CACHE_EXT} tokens ({step_ms:.3f} ms a step); "
        f"one fresh prefill of {len(ext)} tokens {fresh_ms:.3f} ms; the resume is faster "
        f"below a suffix of about {crossover} tokens (host clock)")
    log(f"  the resume's ms a token: eager {step_ms:.3f}, graphed {g_step_ms:.3f}; crossover "
        f"against the fresh prefill: eager {crossover} tokens, graphed {g_crossover} tokens; "
        f"the JAX threshold at T = {len(ext)}: max(32, T // 16) = {threshold} (kept)")
    del state, snap
    record = {"options": {"enable_prefix_cache": True, "prefill_chunk": 2048},
              "requests": {n: {k: v for k, v in r.items() if k != "tokens"}
                           for n, r in out.items()}, **counts,
              "snapshot_bytes": rows, "resume_bit_exact": same,
              "resume_vs_whole_share_of_limit": diff / limit,
              "resume_vs_whole_argmax_agrees": argmax_same, "resume_ms": resume_ms,
              "resume_step_ms": step_ms, "fresh_prefill_ms": fresh_ms,
              "crossover_tokens": crossover, "graphed_resume_ms": g_resume_ms,
              "graphed_resume_step_ms": g_step_ms, "graphed_crossover_tokens": g_crossover,
              "graphed_resume_bit_exact": g_bits, "jax_threshold_tokens": threshold}

    log(f"[13c] DSv4 PD handoff between two SlotExecutors on the same weights: "
        f"{PD_PROMPT}/{PD_OUT}")

    def make():
        state = d4.make_state(cfg, DSV4_SLOTS, blocks, dtype=torch.bfloat16, device="cuda")
        return SlotExecutor(cfg, params, state, DSV4_SLOTS, DSV4_MAX_MODEL_LEN,
                            contract.EngineLoadOptions(**PD_OPTS, **EAGER))

    with torch.no_grad():
        pd_record = run_pd("[13c]", make, cfg.vocab_size, DSV4_SNAPSHOT_BYTES, exact=True)
    return record, pd_record, resume_launches


def check_dsv4_logits(cfg, d4, d4e, params, toks_t, prefill=True, moe_chain=None,
                      label=""):
    """The prompt's last prefill logits (with ``prefill``) and one decode
    step after it from the plain prefill's caches, with the kernels against
    ``plain_kernels=True``, the kernel run routed as the plain run (rule of
    phase 7, DSV4_LOGITS_RTOL). Returns the kernel run's state and the
    step's inputs."""
    blocks = d4e.max_blocks_for(cfg, DSV4_MAX_MODEL_LEN)
    state_k = d4.make_state(cfg, 1, blocks, dtype=torch.bfloat16, device="cuda")
    state_p = d4.make_state(cfg, 1, blocks, dtype=torch.bfloat16, device="cuda")
    replay = RoutingReplay(d4)
    kw = dict(moe_chain=moe_chain)
    try:
        with torch.no_grad():
            replay.record()
            lp, _ = d4.prefill(cfg, params, toks_t, state=state_p, slot=0, last_only=True,
                               plain_kernels=True, **kw)
            if prefill:
                replay.replay()
                lk, _ = d4.prefill(cfg, params, toks_t, state=state_k, slot=0, last_only=True,
                                   **kw)
                torch.cuda.synchronize()
                if not (bool(torch.isfinite(lk).all()) and lk.shape == (1, cfg.vocab_size)):
                    raise SystemExit(f"DSv4{label} kernel-path prefill logits are not finite "
                                     "[1, V]")
                replay.report("prefill")
                check_logits(lk[0], lp[0], DSV4_LOGITS_RTOL,
                             f"DSv4{label} kernel-path prefill logits disagree with the plain "
                             "versions")
            # the decode step starts both runs from the plain prefill's
            # caches, so it holds the decode kernels alone against their
            # plain versions
            for ls_k, ls_p in zip(state_k["layers"], state_p["layers"]):
                for key, cache in ls_p.items():
                    ls_k[key].copy_(cache)
            step = [torch.tensor([x], dtype=torch.int32, device="cuda")
                    for x in (int(lp.argmax()), toks_t.shape[0], 0)]
            replay.record()
            dp = d4.decode(cfg, params, state_p, *step, plain_kernels=True, **kw)
            replay.replay()
            dk = d4.decode(cfg, params, state_k, *step, **kw)
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(dk).all()) and dk.shape == (1, cfg.vocab_size)):
                raise SystemExit(f"DSv4{label} kernel-path decode logits are not finite [1, V]")
            replay.report("decode step")
            check_logits(dk[0], dp[0], DSV4_LOGITS_RTOL,
                         f"DSv4{label} kernel-path decode logits disagree with the plain "
                         "versions")
    finally:
        replay.restore()
    return state_k, step


def dsv4_engine(cfg, contract, d4e, params, quantize=None, moe_chain=None):
    return d4e.start_engine_from_params(
        cfg, params, contract.EngineLoadOptions(
            max_batch_size=DSV4_SLOTS, max_model_len=DSV4_MAX_MODEL_LEN, seed=SEED,
            quantize=quantize, **OLD_DEFAULTS, **EAGER),
        device="cuda", moe_chain=moe_chain)


def serve_slots(cfg, contract, handle, kernels, warmup=True, main=True,
                concurrent=DSV4_CONCURRENT, shapes=(DSV4_WARMUP, (DSV4_PROMPT, DSV4_OUT)),
                seed=SEED + 3):
    """Phase 11's traffic on ``handle`` (``shapes``: the warm-up's and the
    main request's prompt / output lengths), prompts from one stream seeded
    with ``seed``: a warm-up, then (counters of ``kernels`` and of the
    executor at 0) the greedy main request and the concurrent ones. Shuts
    the engine down and returns the counts, the slot events from the main
    request on and the main request's prompt, TTFT, token gaps and token
    times, and every counted request's tokens."""
    ex = handle._scheduler.executor
    events = record_slot_events(ex)
    rng = np.random.default_rng(seed)
    out = {"main_prompt": None, "ttft_ms": None, "gaps": [], "times": [], "main_tokens": None,
           "concurrent_tokens": []}
    (warm_in, warm_out), (main_in, main_out) = shapes

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    try:
        if warmup:
            ch, _ = run_request(contract, handle, prompt(warm_in), warm_out)
            toks, fin, _ = drain(contract, ch)
            expect_finished(contract, f"warm-up {warm_in}/{warm_out}", toks, fin, warm_out)
        for mod in kernels.values():
            mod.launches = 0
        ex.prefills = ex.decode_steps = 0
        events.clear()
        if main:
            out["main_prompt"] = prompt(main_in)
            ch, t0 = run_request(contract, handle, out["main_prompt"], main_out)
            toks, fin, times = drain(contract, ch)
            expect_finished(contract, f"main {main_in}/{main_out}", toks, fin, main_out)
            out["ttft_ms"] = (times[0] - t0) * 1e3
            out["gaps"] = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
            out["times"], out["main_tokens"] = times, toks
            events.clear()
        chans = submit_together(contract, handle, [(prompt(n), m) for n, m in concurrent])
        for ch, n, m in chans:
            toks_c, fin_c, _ = drain(contract, ch)
            expect_finished(contract, f"concurrent {n}/{m}", toks_c, fin_c, m)
            out["concurrent_tokens"].append(toks_c)
        out["launches"] = {name: mod.launches for name, mod in kernels.items()}
        out["prefills"], out["decode_steps"] = ex.prefills, ex.decode_steps
    finally:
        handle.shutdown()
        handle._thread.join(timeout=60)
    out["events"] = events
    return out


def check_slot_events(events, third_waits, slots=DSV4_SLOTS):
    """The concurrent requests decoded at B = ``slots`` and, with
    ``third_waits``, the third was prefilled only after a slot freed.
    Returns the summary."""
    rids = sorted({rid for kind, rid in events if kind == "prefill"})
    batches = [n for kind, n in events if kind == "decode"]
    text = f"decode batch sizes {sorted(set(batches))}"
    if third_waits:
        third = events.index(("prefill", rids[2]))
        freed = [i for i, (kind, rid) in enumerate(events)
                 if kind == "release" and rid in rids[:2]]
        text = (f"the third concurrent request was prefilled at event {third}, after a slot "
                f"freed at event {freed[0] if freed else None}; " + text)
        if not freed or third < freed[0]:
            raise SystemExit("the third request was scheduled before a slot freed")
    if slots not in batches:
        raise SystemExit(f"the first two requests never decoded at B = {slots}")
    return text


def check_launches(launches, want, label):
    log(f"  launches {launches}; expected {want} ({label})")
    if launches != want:
        raise SystemExit(f"kernel launch counts do not match the path ({label})")


def max_err_verdict(errs, name, label, err, tol):
    ok = err <= tol
    log(f"  {name} {label}: max_abs_err {err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version")
    errs[name] = max(errs.get(name, 0.0), err)


def _distinct_idx(gen, E, M, repeat):
    idx = torch.randperm(E, generator=gen, device="cuda")[:M].to(torch.int32)
    if repeat:
        idx[M // 2:] = idx[: M - M // 2]
    return idx


# ── phase 14: the opt-in fp4 chain ──────────────────────────────────────


def run_dsv4_fp4_chain(cfg, params):
    """Phase 14 on the fp4 params. Returns (the K9 record, serving)."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import dsv4 as d4
    from pegainfer_tpu_torch.models import dsv4_engine as d4e
    from pegainfer_tpu_torch.ops.cuda import fp4_chain as k9
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
    from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4

    log("[14] the fp4 chain (K9): against its plain version, served with moe_chain=True")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    errs = {}
    lw = params["layers"][3]  # a score-gated layer
    E, D, limit = cfg.n_routed_experts, cfg.dim, cfg.swiglu_limit
    natural = (lw["experts_w1"], lw["experts_w3"])
    permuted = tuple(k9.permute_w13(w) for w in natural)
    for perm13, (w1, w3) in ((False, natural), (True, permuted)):
        for M, routing in ((6, "distinct"), (12, "repeated experts"), (16, "one expert")):
            x = torch.randn((M, D), generator=gen, device="cuda")
            idx = _distinct_idx(gen, E, M, routing == "repeated experts")
            if routing == "one expert":
                idx[:] = idx[0]
            y = k9.moe_fp4_chain(x, w1, w3, lw["experts_w2"], idx, limit, perm13=perm13)
            torch.cuda.synchronize()
            ref = k9.moe_fp4_chain_plain(x, w1, w3, lw["experts_w2"], idx, limit, perm13)
            err, share = row_err(y, ref, 1, float("inf"), CHAIN_ROW_RTOL)
            log(f"  moe_fp4_chain M={M} {routing} perm13={perm13}: max_abs_err {err:.3e}, "
                f"worst row at {share:.4f} of {CHAIN_ROW_RTOL:g} x its max |ref| "
                f"{'ok' if share <= 1.0 else 'FAIL'}")
            if not share <= 1.0:
                raise SystemExit("moe_fp4_chain disagrees with its plain version")
            errs["moe_fp4_chain"] = max(errs.get("moe_fp4_chain", 0.0), err)
    del permuted
    torch.cuda.empty_cache()
    record = time_fp4_chain(cfg, params, k9, errs)

    kernels = {"moe_fp4_chain": k9, "moe_fp4_gemv": k3, "fp8_gemv": k4, "moe_fp4_grouped": k5}
    run = serve_slots(cfg, contract, dsv4_engine(cfg, contract, d4e, params, moe_chain=True),
                     kernels, warmup=False, main=False, concurrent=DSV4_CHAIN_PAIR)
    log("  the pair Finished with its token counts; " + check_slot_events(
        run["events"], third_waits=False))
    L, steps, prefills = cfg.n_layers, run["decode_steps"], run["prefills"]
    check_launches(run["launches"], {"moe_fp4_chain": L * steps, "moe_fp4_gemv": 0,
                                     "fp8_gemv": fp8_per_decode_step(cfg) * steps,
                                     "moe_fp4_grouped": 3 * L * prefills},
                   f"{prefills} prefills, {steps} decode steps, {L} layers")
    record["launches"] = run["launches"]["moe_fp4_chain"]
    log("  one decode step after a 300-token prefill: the chain vs its plain version, the "
        "kernel run routed as the plain run")
    prompt = np.random.default_rng(SEED + 6).integers(0, cfg.vocab_size, 300).tolist()
    state, step = check_dsv4_logits(cfg, d4, d4e, params, torch.tensor(
        prompt, dtype=torch.int32, device="cuda"), prefill=False, moe_chain=True,
        label=" fp4-chain")
    log("  one decode step at B = 1, context 301, with the chain on (K9) and off (K3)")
    prof = {}
    for chain in (True, False):
        prof.update(dsv4_step_profile(cfg, d4, params, None, state, step, moe_chain=chain))
    log_steps(prof)
    return record, {"launches": run["launches"], "decode_steps": steps, "prefills": prefills,
                    "steps": steps_json(prof)}


def time_fp4_chain(cfg, params, k9, errs):
    """K9 at B = 1 (6 distinct routed rows) and B = 2 (two tokens' top-6
    experts, 12 rows, repeats as they fall), each call on the next layer's
    weights (a layer's routed bytes for 6 rows are 85 MB, beyond L2), beside
    the path's sequence with the chain off at the same rows: K3 on w1 and on
    w3, the SwiGLU, K3 on w2 (``models/dsv4.py``). Bounds over every routed
    row's weights and, at B = 2, over the distinct experts' alone."""
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.moe import swiglu

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    layers, E, D, limit = params["layers"], cfg.n_routed_experts, cfg.dim, cfg.swiglu_limit
    L = len(layers)
    ws = [(lw["experts_w1"], lw["experts_w3"], lw["experts_w2"]) for lw in layers]
    w1, w3, w2 = ws[0]
    I = w1["q"].shape[1]
    w_bytes = sum(w["q"][0].numel() + w["s"][0].numel() * 2 for w in (w1, w3, w2))

    def chain_off(x, w1, w3, w2, idx):
        act = swiglu(k3.moe_fp4_gemv(x, w1["q"], w1["s"], idx),
                     k3.moe_fp4_gemv(x, w3["q"], w3["s"], idx), limit)
        return k3.moe_fp4_gemv(act, w2["q"], w2["s"], idx)

    out = {}
    for label, tokens in (("B=1", 1), ("B=2", 2)):
        M = 6 * tokens
        x = torch.randn((M, D), generator=gen, device="cuda")
        idxs = [torch.cat([torch.randperm(E, generator=gen, device="cuda")[:6]
                           for _ in range(tokens)]).to(torch.int32) for _ in range(L)]
        saved = k9.launches, k3.launches
        ms = time_ms(lambda i: k9.moe_fp4_chain(x, *ws[i % L], idxs[i % L], limit), 100)
        # about 10 launches a call: a window the device's queue holds
        off_ms = time_ms(lambda i: chain_off(x, *ws[i % L], idxs[i % L]), 24)
        k9.launches, k3.launches = saved
        io = x.numel() * 4 + M * 4 + M * D * 4
        flops = 2 * M * 3 * I * D
        distinct = sum(int(torch.unique(i).numel()) for i in idxs) / L
        bound_ms, by = bound(M * w_bytes + io, flops)
        distinct_ms, _ = bound(distinct * w_bytes + io, flops)
        out[label] = {"ms": ms, "chain_off_ms": off_ms, "bound_ms": bound_ms, "bound_by": by,
                      "distinct_experts": distinct, "bound_distinct_ms": distinct_ms}
        log(f"  moe_fp4_chain {label} ({M} rows, {distinct:.2f} distinct experts a layer): "
            f"{ms * 1e3:.2f} us, chain off (K3, SwiGLU, K3, K3) {off_ms * 1e3:.2f} us, bound "
            f"{bound_ms * 1e3:.2f} us over every row ({by}), {distinct_ms * 1e3:.2f} us over "
            "the distinct experts")
        if label == "B=1":  # the plain version at B = 1 only: it gathers and decodes
            plain_ms = time_ms(
                lambda i: k9.moe_fp4_chain_plain(x, *ws[i % L], idxs[i % L], limit), 8)
    b1 = out["B=1"]
    return {"name": "moe_fp4_chain", "route": "cuda",
            "source": "pegainfer_tpu_torch/csrc/fp4_chain.cu",
            "replaces": "pegainfer_tpu/ops/pallas/fp4_gemm.py:1047",
            "launches": None, "max_abs_err": errs["moe_fp4_chain"], "ms": b1["ms"],
            "plain_ms": plain_ms, "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
            "library_ms": None, "chain_off_ms": b1["chain_off_ms"], "b2": out["B=2"]}


# ── phases 15-18: the int8-experts mode ─────────────────────────────────


def run_dsv4_int8(cfg, params, k9_record):
    """Phases 15-18: requantize ``params`` to int8 in place, check and
    serve. Returns (K6-K9 records, serving, steps)."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import dsv4 as d4
    from pegainfer_tpu_torch.models import dsv4_engine as d4e
    from pegainfer_tpu_torch.ops import quant
    from pegainfer_tpu_torch.ops.cuda import fp4_chain as k9
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
    from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4
    from pegainfer_tpu_torch.ops.cuda import int8_chain as k8
    from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
    from pegainfer_tpu_torch.ops.cuda import int8_grouped as k7

    log("[15] int8 requantization through start_engine_from_params(quantize='int8-experts')")
    probe = params["layers"][3]["experts_w1"]
    slice_q, slice_s = probe["q"][7:8].cpu(), probe["s"][7:8].cpu()
    del probe
    host = quant.quantize_int8_stack(quant.dequant_any({"q": slice_q, "s": slice_s},
                                                       torch.float32).numpy())
    before = d4.params_bytes(params)
    gc.collect()
    torch.cuda.empty_cache()
    engine_log = logging.getLogger("pegainfer_torch.dsv4")
    engine_log.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("  engine: %(message)s"))
    engine_log.addHandler(handler)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    handle = dsv4_engine(cfg, contract, d4e, params, quantize="int8-experts")
    torch.cuda.synchronize()
    requant_s = time.perf_counter() - t
    after = d4.params_bytes(params)
    peak = torch.cuda.max_memory_reserved()
    new = params["layers"][3]["experts_w1"]
    differ = int((new["q"][7].cpu() != host["q"][0]).sum()) + int(
        (new["s"][7].cpu() != host["s"][0]).sum())
    log(f"  engine start with the requantization: {requant_s:.1f} s; params {before / 1e9:.2f} "
        f"GB -> {after / 1e9:.2f} GB; peak reserved {peak / 1e9:.2f} GB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB; layer 3 w1 "
        f"expert 7: {differ} codes and scales differ from the host quantize_int8_stack")
    if differ or new["q"].dtype != torch.int8:
        raise SystemExit("the device requantization differs from the host quantize_int8_stack")
    del new
    requant = {"seconds": requant_s, "bytes_before": before, "bytes_after": after,
               "peak_reserved_bytes": peak, "codes_differing": differ}

    log("[16] K6, K7, K8 against their plain versions on the model's int8 weights")
    errs = check_int8_kernels(cfg, params, k6, k7, k8)

    log("[17] serving phase 11's traffic with int8 experts (K7 prefill, K8 decode)")
    kernels = {"moe_int8_gemv": k6, "moe_int8_grouped": k7, "moe_int8_chain": k8,
               "moe_fp4_chain": k9, "moe_fp4_gemv": k3, "fp8_gemv": k4, "moe_fp4_grouped": k5}
    run = serve_slots(cfg, contract, handle, kernels)
    del handle
    log("  all requests Finished with their token counts; " + check_slot_events(
        run["events"], third_waits=True))
    L, steps, prefills = cfg.n_layers, run["decode_steps"], run["prefills"]
    zero = dict.fromkeys(kernels, 0)
    check_launches(run["launches"], {**zero, "moe_int8_grouped": 3 * L * prefills,
                                     "moe_int8_chain": L * steps,
                                     "fp8_gemv": fp8_per_decode_step(cfg) * steps},
                   f"{prefills} prefills, {steps} decode steps, {L} layers")
    launches = dict(run["launches"])
    log(f"  {DSV4_PROMPT}-token int8 prefill and one decode step: kernels vs plain versions, "
        f"the kernel run routed as the plain run")
    toks_t = torch.tensor(run["main_prompt"], dtype=torch.int32, device="cuda")
    state_k, step = check_dsv4_logits(cfg, d4, d4e, params, toks_t, label=" int8")
    log("  the 300/32 + 500/32 pair with moe_chain=False (K6 decode)")
    off = serve_slots(cfg, contract, dsv4_engine(cfg, contract, d4e, params,
                                                quantize="int8-experts", moe_chain=False),
                     kernels, warmup=False, main=False, concurrent=DSV4_CHAIN_PAIR)
    check_slot_events(off["events"], third_waits=False)
    check_launches(off["launches"], {**zero, "moe_int8_grouped": 3 * L * off["prefills"],
                                     "moe_int8_gemv": 3 * L * off["decode_steps"],
                                     "fp8_gemv": fp8_per_decode_step(cfg) * off["decode_steps"]},
                   f"{off['prefills']} prefills, {off['decode_steps']} decode steps")
    launches["moe_int8_gemv"] = off["launches"]["moe_int8_gemv"]

    log("[18] int8 timings")
    steps_prof = dsv4_step_profile(cfg, d4, params, toks_t, state_k, step)
    # the same decode step with the chain off: K6's three GEMVs a layer
    steps_prof.update(dsv4_step_profile(cfg, d4, params, None, state_k, step, moe_chain=False))
    gaps = run["gaps"]
    tpot, tpot95 = statistics.median(gaps), float(np.percentile(gaps, 95))
    log(f"  int8 main {DSV4_PROMPT}/{DSV4_OUT}: TTFT {run['ttft_ms']:.3f} ms, TPOT p50 "
        f"{tpot:.3f} ms, p95 {tpot95:.3f} ms over {len(gaps)} gaps (host clock, per "
        "streamed token)")
    log_steps(steps_prof)
    del state_k
    records, extra = time_int8_kernels(cfg, params, k6, k7, k8, errs, launches)
    records.append(k9_record)
    log_records(records)
    log("[18g] the int8-experts decode step under CUDA graphs under its default chain (K8), "
        "against [17]'s eager run")
    t = time.perf_counter()
    f8 = fp8_per_decode_step(cfg)
    graphs = dsv4_graphed(
        "[18g] int8 + K8", cfg, params, contract, run["main_prompt"], eager_record(run),
        kernels, lambda r: {**zero, "moe_int8_grouped": 3 * L * r["prefills"],
                            "moe_int8_chain": L * r["decode_steps"],
                            "fp8_gemv": f8 * r["decode_steps"]}, quantize="int8-experts")
    graphs["phase_s"] = time.perf_counter() - t
    log(f"  [18g] took {graphs['phase_s']:.1f} s")
    log("[18h] int8-experts decode blocks under the JAX defaults, graphed, with K8, against "
        "[17]'s tokens (equal to [18g]'s one-token graphed ones)")
    t = time.perf_counter()
    graphs["blocks"] = dsv4_blocks(
        "[18h] int8 + K8", cfg, params, contract, run, kernels,
        lambda r: {**zero, "moe_int8_grouped": 3 * L * r["prefills"],
                   "moe_int8_chain": L * r["decode_steps"], "fp8_gemv": f8 * r["decode_steps"]},
        quantize="int8-experts")
    graphs["blocks"]["phase_s"] = time.perf_counter() - t
    log(f"  [18h] took {graphs['blocks']['phase_s']:.1f} s")
    serving = {"ttft_ms": run["ttft_ms"], "tpot_p50_ms": tpot, "tpot_p95_ms": tpot95,
               "prompt": DSV4_PROMPT, "output": DSV4_OUT, "requantization": requant,
               "chain_off_pair": {"launches": off["launches"],
                                  "decode_steps": off["decode_steps"]}, "graphs": graphs,
               **extra}
    return records, serving, steps_json(steps_prof)


def check_int8_kernels(cfg, params, k6, k7, k8):
    from pegainfer_tpu_torch.studies import k6_study as k6s

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    errs = {}
    lw, E, limit = params["layers"][3], cfg.n_routed_experts, cfg.swiglu_limit
    # K6 row by row: each row within INT8_GEMV_RTOL of its max |ref|, a row of
    # an invalid id exactly 0; y's block is NaN-filled first, so an element
    # left unwritten fails. The reference is the plain version on the valid
    # ids, with the rows of invalid ids 0.
    for key, M, routing in (("experts_w1", 6, "distinct"), ("experts_w2", 6, "distinct"),
                            ("experts_w1", 1, "distinct"), ("experts_w3", 12, "repeated"),
                            ("experts_w1", 12, "shared"), ("experts_w2", 12, "shared"),
                            ("experts_w1", 18, "repeated"), ("experts_w2", 20, "distinct"),
                            ("experts_w1", 20, "one"), ("experts_w1", 6, "invalid"),
                            ("experts_w2", 20, "invalid")):
        w = lw[key]
        idx = k6s.route(routing, M, E, torch.randperm(E, generator=gen, device="cuda"))
        x = torch.randn((M, w["q"].shape[2]), generator=gen, device="cuda")
        poison = torch.full((M, w["q"].shape[1]), float("nan"), device="cuda")
        del poison
        y = k6.moe_int8_gemv(x, w["q"], idx)
        torch.cuda.synchronize()
        valid = (idx >= 0) & (idx < E)
        ref = k6.moe_int8_gemv_plain(x, w["q"], torch.where(valid, idx, 0)) * valid[:, None]
        err, share = k6s.row_err(y, ref, INT8_GEMV_RTOL)
        log(f"  moe_int8_gemv {key} M={M} {routing} (unscaled): max_abs_err {err:.3e}, worst row "
            f"at {share:.3f} of {INT8_GEMV_RTOL:g} x its max |ref| {'ok' if share <= 1.0 else 'FAIL'}")
        if not share <= 1.0:
            raise SystemExit("moe_int8_gemv disagrees with its plain version")
        errs["moe_int8_gemv"] = max(errs.get("moe_int8_gemv", 0.0), err)
    for key, M, skew in (("experts_w1", 6 * DSV4_PROMPT, False),
                         ("experts_w2", 6 * DSV4_PROMPT, True),
                         ("experts_w3", 54, True), ("experts_w1", 300, False)):
        w = lw[key]
        x, tm, _, seg = grouped_inputs(gen, M, w["q"].shape[2], E, skew)
        y = k7.moe_int8_grouped(x, w["q"], *seg, tm=tm)
        torch.cuda.synchronize()
        ref = k7.moe_int8_grouped_plain(x, w["q"], *seg, tm=tm)
        err, share = grouped_err(y, ref)
        label = (f"{key} M={M} tm={tm} {'skewed, empty experts' if skew else 'spread'}, "
                 f"{int((seg[3]).max())} segments at most in a tile (unscaled)")
        log(f"  moe_int8_grouped {label}: max_abs_err {err:.3e}, global share "
            f"{err / ref.abs().max().item():.3e}, worst row at {share:.3f} of "
            f"{GROUPED_ROW_RTOL:g} x its max |ref| {'ok' if share <= 1.0 else 'FAIL'}")
        if not share <= 1.0:
            raise SystemExit("moe_int8_grouped disagrees with its plain version")
        errs["moe_int8_grouped"] = max(errs.get("moe_int8_grouped", 0.0), err)
    w1, w3, w2 = lw["experts_w1"], lw["experts_w3"], lw["experts_w2"]
    for M in (1, 6, 12, 16):
        idx = _distinct_idx(gen, E, M, M == 12)
        x = torch.randn((M, cfg.dim), generator=gen, device="cuda")
        args = (x, w1["q"], w3["q"], w2["q"], w1["s"], w3["s"], w2["s"], idx, limit)
        y = k8.moe_int8_chain(*args)
        torch.cuda.synchronize()
        ref = k8.moe_int8_chain_plain(*args)
        max_err_verdict(errs, "moe_int8_chain", f"M={M}{' repeated experts' if M == 12 else ''}",
                        (y - ref).abs().max().item(), CHAIN_RTOL * ref.abs().max().item())
    return errs


def time_int8_kernels(cfg, params, k6, k7, k8, errs, launches):
    """K6 (``time_int8_gemv``) at w1 and w2 at M 1, 6 and 12, and its sum
    over a chain-off step's launches; K7 at w1 over a 1,024-token prefill,
    K8 at B = 1 (6 distinct rows), each call on the next layer's weights;
    bounds from these inputs, at the bf16 peak for the operations; the plain
    versions; K7 (``time_grouped``) also at w2 and at skewed routing, each
    beside one bf16 grouped GEMM (``grouped_mm_library``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    layers, E, D, limit = params["layers"], cfg.n_routed_experts, cfg.dim, cfg.swiglu_limit
    L = len(layers)
    w1 = [lw["experts_w1"] for lw in layers]
    _, OUT, IN = w1[0]["q"].shape

    # K6 at w1 and w2 at M 1, 6 and 12 (distinct, and shared by two tokens);
    # the record's own numbers are w1's at M 6, the path's shape (B = 1)
    k6_cases = time_int8_gemv(layers, k6, gen, E)
    k6_main = k6_cases["w1 M=6"]
    k6_step_ms = 2 * L * k6_main["ms"] + L * k6_cases["w2 M=6"]["ms"]
    k6_step_bound = 2 * L * k6_main["bound_ms"] + L * k6_cases["w2 M=6"]["bound_ms"]
    log(f"  moe_int8_gemv over a chain-off decode step at B = 1 ({3 * L} launches): "
        f"{k6_step_ms * 1e3:.2f} us against a bound of {k6_step_bound * 1e3:.2f} us")

    # K7 over a 1,024-token prefill (6,144 routed rows): w1 with spread
    # routing (the record), then w2 and w1 with skewed routing; the plan is
    # built once outside the timed calls, as models/dsv4.py shares it
    M7 = 6 * DSV4_PROMPT
    x7, tm, e7, seg = grouped_inputs(gen, M7, IN, E, skew=False)
    k7_ms, k7_bound, k7_by, k7_lib_ms, k7_lib_call, k7_plan_ms = time_grouped(
        k7, "w1", x7, tm, e7, seg, w1, E)
    k7_plain_ms = time_synced_ms(lambda i: k7.moe_int8_grouped_plain(
        x7, w1[i % L]["q"], *seg, tm=tm), 3)
    w2 = [lw["experts_w2"] for lw in layers]
    x7b = torch.randn((x7.shape[0], w2[0]["q"].shape[2]), generator=gen,
                      device="cuda").to(torch.bfloat16)
    k7_w2 = time_grouped(k7, "w2", x7b, tm, e7, seg, w2, E)
    del x7b
    x7s, tms, e7s, segs = grouped_inputs(gen, M7, IN, E, skew=True)
    k7_skew = time_grouped(k7, "w1, skewed routing", x7s, tms, e7s, segs, w1, E)
    del x7s, x7

    # K8: B = 1, 6 distinct rows
    ws = [(lw["experts_w1"], lw["experts_w3"], lw["experts_w2"]) for lw in layers]
    x8 = torch.randn((6, D), generator=gen, device="cuda")
    idx8 = [_distinct_idx(gen, E, 6, False) for _ in range(L)]

    def k8_args(i):
        a, b, c = ws[i % L]
        return (x8, a["q"], b["q"], c["q"], a["s"], b["s"], c["s"], idx8[i % L], limit)

    saved = k8.launches
    k8_ms = time_ms(lambda i: k8.moe_int8_chain(*k8_args(i)), 200)
    k8.launches = saved
    k8_plain_ms = time_ms(lambda i: k8.moe_int8_chain_plain(*k8_args(i)), 8)
    b8 = 6 * 3 * OUT * IN + x8.numel() * 4 + 6 * 4 + 6 * (2 * OUT + D) * 4 + 6 * D * 4
    k8_bound, k8_by = bound(b8, 2 * 6 * 3 * OUT * IN)

    src = "pegainfer_tpu/ops/pallas/fp4_gemm.py"
    records = [
        {"name": "moe_int8_gemv", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/int8_gemv.cu", "replaces": f"{src}:521",
         "launches": launches["moe_int8_gemv"], "max_abs_err": errs["moe_int8_gemv"],
         "ms": k6_main["ms"], "plain_ms": k6_main["plain_ms"], "bound_ms": k6_main["bound_ms"],
         "bound_by": k6_main["bound_by"], "library_ms": k6_main["library_ms"],
         "library_call": k6_main["library_call"], "shapes": k6_cases, "step_ms": k6_step_ms,
         "step_bound_ms": k6_step_bound},
        {"name": "moe_int8_grouped", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/int8_grouped.cu", "replaces": f"{src}:644",
         "launches": launches["moe_int8_grouped"], "max_abs_err": errs["moe_int8_grouped"],
         "ms": k7_ms, "plain_ms": k7_plain_ms, "bound_ms": k7_bound, "bound_by": k7_by,
         "library_ms": k7_lib_ms, "library_call": k7_lib_call},
        {"name": "moe_int8_chain", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/int8_chain.cu", "replaces": f"{src}:787",
         "launches": launches["moe_int8_chain"], "max_abs_err": errs["moe_int8_chain"],
         "ms": k8_ms, "plain_ms": k8_plain_ms, "bound_ms": k8_bound, "bound_by": k8_by,
         "library_ms": None},
    ]
    extra = {"k7_plan_ms": k7_plan_ms}
    for name, (ms, b, by, lib, call, _) in (("k7_w2", k7_w2), ("k7_skewed", k7_skew)):
        extra[name] = {"ms": ms, "bound_ms": b, "bound_by": by, "library_ms": lib,
                       "library_call": call}
    return records, extra


def time_int8_gemv(layers, k6, gen, E):
    """K6 at w1 and w2 at M 1, 6 and 12 with distinct experts and at 12 rows
    routed as two tokens sharing 3 of their 6 experts (B = 2: 9 distinct),
    x in bf16, each call on the next layer's codes and expert ids (the 8
    layers' routed experts at M 6, 403 MB, come from device memory); beside
    the bound of the distinct experts' bytes; one ``torch.bmm`` of the
    routed experts gathered and converted to bf16 outside the timed call
    (sets for twice the L2), held against K6 at GROUPED_RTOL x max |y| (it
    rounds its output to bf16); at M 1 ``torch.matmul`` on the expert's bf16
    weight (copies for twice the L2); at w1 M 6 the plain version. Returns
    {case: record}."""
    from pegainfer_tpu_torch.studies import k6_study as k6s

    L = len(layers)
    perm = torch.randperm(E, generator=gen, device="cuda")
    out = {}
    for key, M, routing in (("w1", 1, "distinct"), ("w2", 1, "distinct"),
                            ("w1", 6, "distinct"), ("w2", 6, "distinct"),
                            ("w1", 12, "distinct"), ("w2", 12, "distinct"),
                            ("w1", 12, "shared"), ("w2", 12, "shared")):
        qs = [lw[f"experts_{key}"]["q"] for lw in layers]
        _, OUT, IN = qs[0].shape
        x = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
        idxs = [k6s.route(routing, M, E, perm, i) for i in range(L)]
        saved = k6.launches
        ms = time_ms(lambda i: k6.moe_int8_gemv(x, qs[i % L], idxs[i % L]), 200)
        y = k6.moe_int8_gemv(x, qs[0], idxs[0])
        k6.launches = saved
        n = k6s.distinct(routing, M)
        b, by = bound(k6s.bytes_moved(n, M, OUT, IN), 2 * M * OUT * IN)
        n_wg = min(L, max(2, -(-2 * k6s.L2_BYTES // (M * OUT * IN * 2)) + 1))
        wg = [qs[i][idxs[i].long()].to(torch.bfloat16) for i in range(n_wg)]
        xb = x[:, :, None]
        err = (torch.bmm(wg[0], xb)[:, :, 0].float() - y).abs().max().item()
        tol = GROUPED_RTOL * y.abs().max().item()
        lib_ms, lib_call = None, "none: torch.bmm disagrees with K6"
        if err <= tol:
            lib_ms = time_ms(lambda i: torch.bmm(wg[i % n_wg], xb), 100)
            lib_call = "torch.bmm (bf16, experts gathered ahead)"
        name = f"{key} M={M}{' shared' if routing == 'shared' else ''}"
        rec = {"OUT": OUT, "IN": IN, "M": M, "routing": routing, "experts": n, "ms": ms,
               "bound_ms": b, "bound_by": by, "library_ms": lib_ms, "library_call": lib_call,
               "launches_a_step": (2 if key == "w1" else 1) * L}
        if M == 1:
            rec["matmul_ms"] = time_ms(lambda i: torch.matmul(x, wg[i % n_wg][0].T), 200)
        if name == "w1 M=6":
            rec["plain_ms"] = time_ms(lambda i: k6.moe_int8_gemv_plain(x, qs[i % L],
                                                                       idxs[i % L]), 16)
        del wg
        out[name] = rec
        more = "" if M > 1 else f", torch.matmul {rec['matmul_ms'] * 1e3:.2f} us"
        log(f"  moe_int8_gemv {name} ({n} experts): {ms * 1e3:.2f} us ({b / ms:.1%} of "
            f"{b * 1e3:.2f} us), torch.bmm "
            f"{'none' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'} (max |diff| {err:.4g}, "
            f"tol {tol:.4g}){more}")
    return out


def time_grouped(mod, label, x, tm, e_sorted, seg, ws, E):
    """K5 (``mod`` the fp4_grouped module) or K7 (int8_grouped) on the rows
    ``x`` (sorted by ``e_sorted``, segments ``seg``), each call on the next
    layer's stack of ``ws``, with a plan built once; its bound from these
    inputs (each hit expert's codes, and K5's scales, read once); the plan's
    own time; one bf16 grouped GEMM on the first layer's stack as its
    library yardstick (K5: dequantized with its scales; K7: its codes,
    unscaled as K7's output is). Returns (ms, bound_ms, bound_by,
    library_ms, library_call, plan_ms)."""
    fp4 = hasattr(mod, "moe_fp4_grouped")
    name = "K5" if fp4 else "K7"
    L, (M, IN) = len(ws), x.shape
    OUT = ws[0]["q"].shape[1]

    def call(w, work):
        if fp4:
            return mod.moe_fp4_grouped(x, w["q"], w["s"], *seg, tm=tm, plan=work)
        return mod.moe_int8_grouped(x, w["q"], *seg, tm=tm, plan=work)

    work = mod.plan(*seg, tm, E)
    saved = mod.launches
    ms = time_ms(lambda i: call(ws[i % L], work), 24)
    plan_ms = time_ms(lambda i: mod.plan(*seg, tm, E), 10)  # about 60 launches a plan
    hit = int(torch.unique(e_sorted).numel())
    w_bytes = ws[0]["q"][0].nbytes + (ws[0]["s"][0].nbytes if fp4 else 0)  # one expert
    b_ms, by = bound(hit * w_bytes + x.numel() * 2 + M * OUT * 4, 2 * M * OUT * IN)
    y = call(ws[0], work)
    mod.launches = saved
    log(f"  {name} at {label}: {M} rows over {hit} experts, {int(work.n_items[0])} row "
        f"chunks: {ms * 1e3:.2f} us, {hit * w_bytes / ms / 1e9:.3f} TB/s of weights, bound "
        f"{b_ms * 1e3:.2f} us ({by}; the kernel at {b_ms / ms:.1%} of the bound's rate); its "
        f"plan {plan_ms * 1e3:.2f} us")
    # the stack in bf16 [E, IN, OUT] (column-major per expert; 4.3 GB at w1)
    wb = dequant_stack_bf16(ws[0]) if fp4 else ws[0]["q"].to(torch.bfloat16)
    lib_ms, lib_call = grouped_mm_library(name, x, e_sorted, wb.transpose(1, 2), y, label)
    del y, wb
    torch.cuda.empty_cache()
    return ms, b_ms, by, lib_ms, lib_call, plan_ms


def grouped_mm_library(label, x_sorted, e_sorted, wb, y_ref, what="w1"):
    """The library yardstick of a grouped GEMM kernel (K5, K7): the device
    time of one PyTorch grouped GEMM (``torch.nn.functional.grouped_mm``,
    else ``torch._grouped_mm``) of the rows of ``x_sorted`` (bf16, sorted by
    expert ``e_sorted``, no tile padding) with ``wb``, the weight stack in
    bf16 [E, IN, OUT], made outside the timed call; held against the
    kernel's output ``y_ref`` at GROUPED_RTOL. Its output is bf16 (torch
    2.11 refuses an f32 output for bf16 inputs). Returns (ms, what was
    called), or (None, why not) where this torch has no such call, it
    refuses these inputs or it disagrees."""
    fn = getattr(torch.nn.functional, "grouped_mm", None)
    name = "torch.nn.functional.grouped_mm"
    if fn is None:
        fn, name = getattr(torch, "_grouped_mm", None), "torch._grouped_mm"
    if fn is None:
        log(f"  {label} library: this torch has no grouped_mm")
        return None, "none: this torch has no grouped_mm"
    E = wb.shape[0]
    offs = torch.cumsum(torch.bincount(e_sorted.long(), minlength=E), 0).to(torch.int32)
    try:
        y = fn(x_sorted, wb, offs=offs)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as exc:
        log(f"  {label} library: {name} refused: {str(exc).splitlines()[0][:200]}")
        return None, f"none: {name} refused these inputs"
    err = (y.float() - y_ref).abs().max().item()
    tol = GROUPED_RTOL * y_ref.abs().max().item()
    del y
    if not err <= tol:
        log(f"  {label} library: {name} disagrees with {label} by {err:.4g} (tol {tol:.4g})")
        return None, f"none: {name} disagrees with {label}"
    ms = time_ms(lambda i: fn(x_sorted, wb, offs=offs), 24)
    log(f"  {label} library: {name} (bf16 out) on {what} in bf16, {x_sorted.shape[0]} rows: "
        f"{ms * 1e3:.2f} us (max |diff| to {label} {err:.4g}, tol {tol:.4g})")
    return ms, name


def dequant_stack_bf16(w):
    """An fp4 / fp8 / int8 expert stack {"q", "s"} -> bf16 [E, OUT, IN] with
    its scales applied, 16 experts at a time (one f32 intermediate of the
    whole stack would take 8.6 GB at DSv4-Flash's w1)."""
    from pegainfer_tpu_torch.ops import quant

    chunk = 16
    E = w["q"].shape[0]
    first = quant.dequant_any({"q": w["q"][:1], "s": w["s"][:1]}, torch.bfloat16)
    out = torch.empty((E, *first.shape[1:]), dtype=torch.bfloat16, device=first.device)
    for i in range(0, E, chunk):
        out[i:i + chunk] = quant.dequant_any({"q": w["q"][i:i + chunk], "s": w["s"][i:i + chunk]},
                                             torch.bfloat16)
    return out


class RoutingReplay:
    """Score-gate decisions of one run handed to the next. The plain run
    records each call's (weights, experts); the kernel run then routes as
    the plain run did and counts the token-layer decisions where its own
    choice of experts differs. A decision whose 6th and 7th expert scores
    are closer than the kernels' error (1e-6) flips on that error and swaps
    an expert, which moves the logits by far more than the kernels' error;
    replaying the routing keeps the comparison on the kernels."""

    def __init__(self, d4):
        self.d4, self.gate = d4, d4.score_gate
        self.saved, self.flips, self.decisions = [], 0, 0

    def record(self):
        self.saved.clear()

        def gate(*args, **kwargs):
            out = self.gate(*args, **kwargs)
            self.saved.append(out)
            return out

        self.d4.score_gate = gate

    def replay(self):
        saved = iter(self.saved)
        self.flips = self.decisions = 0

        def gate(*args, **kwargs):
            _, own = self.gate(*args, **kwargs)
            weights, experts = next(saved)
            same = (torch.sort(own, dim=-1).values
                    == torch.sort(experts, dim=-1).values).all(dim=-1)
            self.flips += int((~same).sum())
            self.decisions += same.numel()
            return weights, experts

        self.d4.score_gate = gate

    def report(self, label):
        log(f"  {label}: the kernel run's own routing differs in {self.flips} of "
            f"{self.decisions} token-layer decisions")

    def restore(self):
        self.d4.score_gate = self.gate


def record_slot_events(ex):
    """Log the executor's prefills (request id), releases (request id) and
    decode blocks (batch size), in order."""
    events = []
    prefill_one, release, decode = ex._prefill_one, ex.release_request, ex.execute_decode_async

    def logged_prefill(item):
        events.append(("prefill", item.request_id))
        return prefill_one(item)

    def logged_release(request_id):
        events.append(("release", request_id))
        release(request_id)

    def logged_decode(items, *args, **kwargs):
        events.append(("decode", len(items)))
        return decode(items, *args, **kwargs)

    ex._prefill_one, ex.release_request, ex.execute_decode_async = (
        logged_prefill, logged_release, logged_decode)
    return events


def _routing(gen, M, E, skew):
    """Sorted expert ids of M routed rows: skewed onto a few experts (the
    rest empty, long segments crossing tiles) or spread over all."""
    if skew:
        hot = torch.tensor([0, 3, 3, 3, 3, 3, 7, E * 25 // 32, E - 1], device="cuda")
        ids = hot[torch.randint(0, len(hot), (M,), generator=gen, device="cuda")]
    else:
        ids = torch.randint(0, E, (M,), generator=gen, device="cuda")
    return torch.sort(ids).values.to(torch.int32)


def grouped_inputs(gen, M, IN, E, skew):
    """x_sorted, tm and segments of one K5 call for M routed rows, padded as
    models/dsv4.py pads them."""
    from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5

    tm = 128 if M >= 128 else -(-M // 8) * 8
    Mp = -(-M // tm) * tm
    e = _routing(gen, M, E, skew)
    e = torch.cat([e, e[-1:].expand(Mp - M)])
    x = torch.randn((Mp, IN), generator=gen, device="cuda").to(torch.bfloat16)
    return x, tm, e, k5.tile_segments(e, tm, E)


def check_quant_kernels(cfg, params, k3, k4, k5):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    errs = {"moe_fp4_gemv": 0.0, "fp8_gemv": 0.0, "moe_fp4_grouped": 0.0}
    lw, lw4 = params["layers"][3], params["layers"][2]

    # K4 at the seven shapes of a decode step (shared_w3 has shared_w1's)
    for key in K4_STEP_KEYS:
        w = (lw4 if key == "idx_wq_b" else lw)[key]
        for M in (1, 2, 8):
            x = torch.randn((M, w["q"].shape[1]), generator=gen, device="cuda")
            y = k4.fp8_gemv(x, w["q"], w["s"])
            torch.cuda.synchronize()
            err = (y - k4.fp8_gemv_plain(x, w["q"], w["s"])).abs().max().item()
            max_err_verdict(errs, "fp8_gemv", f"{key} {tuple(w['q'].shape)} M={M}", err,
                            QUANT_GEMV_TOL)

    # K3: the model's scales are powers of two; w1 with random bf16 mantissas
    # makes the decode round each weight (K5 too, below); M 1, B = 2's shared
    # routing and ids -1 and E (rows of 0) beside the main path's rows
    from pegainfer_tpu_torch.studies import k3_study as k3s

    E = cfg.n_routed_experts
    w1 = lw["experts_w1"]
    mant = 1 + torch.rand(w1["s"].shape, generator=gen, device="cuda")
    w1_arb = {"q": w1["q"], "s": (w1["s"].float() * mant).to(torch.bfloat16)}
    del mant
    for key, w, M, routing in (("experts_w1", w1, 6, "distinct"),
                               ("experts_w1", w1, 12, "repeated"),
                               ("experts_w2", lw["experts_w2"], 12, "repeated"),
                               ("experts_w3", lw["experts_w3"], 12, "distinct"),
                               ("experts_w1", w1, 1, "distinct"),
                               ("experts_w2", lw["experts_w2"], 12, "shared"),
                               ("experts_w1 codes, bf16 scales", w1_arb, 6, "distinct"),
                               ("experts_w1 codes, bf16 scales", w1_arb, 12, "shared"),
                               ("experts_w2", lw["experts_w2"], 6, "invalid")):
        idx = k3s.route(routing, M, E, torch.randperm(E, generator=gen, device="cuda"))
        x = torch.randn((M, 2 * w["q"].shape[2]), generator=gen, device="cuda")
        y = k3.moe_fp4_gemv(x, w["q"], w["s"], idx)
        torch.cuda.synchronize()
        ref = k3.moe_fp4_gemv_plain(x, w["q"], w["s"], idx)
        err = (y - ref).abs().max().item()
        if routing == "invalid" and not (y[(ref == 0).all(dim=1)] == 0).all():
            err = float("inf")  # a row of an invalid id must be exactly 0
        max_err_verdict(errs, "moe_fp4_gemv", f"{key} M={M} {routing}", err, QUANT_GEMV_TOL)

    for key, w, M, skew in (("experts_w1", w1, 6 * DSV4_PROMPT, False),
                            ("experts_w2", lw["experts_w2"], 6 * DSV4_PROMPT, True),
                            ("experts_w3", lw["experts_w3"], 54, True),
                            ("experts_w1", w1, 300, False),
                            ("experts_w1 codes, bf16 scales", w1_arb, 6 * DSV4_PROMPT, False)):
        x, tm, _, seg = grouped_inputs(gen, M, 2 * w["q"].shape[2], E, skew)
        y = k5.moe_fp4_grouped(x, w["q"], w["s"], *seg, tm=tm)
        torch.cuda.synchronize()
        ref = k5.moe_fp4_grouped_plain(x, w["q"], w["s"], *seg, tm=tm)
        err, share = grouped_err(y, ref)
        label = (f"{key} M={M} tm={tm} {'skewed, empty experts' if skew else 'spread'}, "
                 f"{int((seg[3]).max())} segments at most in a tile")
        log(f"  moe_fp4_grouped {label}: max_abs_err {err:.3e}, global share "
            f"{err / ref.abs().max().item():.3e}, worst row at {share:.3f} of "
            f"{GROUPED_ROW_RTOL:g} x its max |ref| {'ok' if share <= 1.0 else 'FAIL'}")
        if not share <= 1.0:
            raise SystemExit("moe_fp4_grouped disagrees with its plain version")
        errs["moe_fp4_grouped"] = max(errs["moe_fp4_grouped"], err)
    del w1_arb
    return errs


def dsv4_step_profile(cfg, d4, params, prompt_t, state, step, iters=3, moe_chain=None):
    """Wall time (host clock, each call ending in a synchronize), device time
    and device operations (torch.profiler, CUDA activity) of one
    1,024-token prefill into a slot (unless ``prompt_t`` is None) and one
    B = 1 decode step at the context of ``step``, called directly on the
    model, with ``moe_chain`` as the model takes it; the device time and
    launches in each of the kernels of STEP_KERNELS (K4, K3, K6), logged
    where they launched."""
    from torch.profiler import ProfilerActivity, profile

    ctx = int(step[1]) + 1
    calls = {} if prompt_t is None else {
        f"dsv4 prefill {DSV4_PROMPT}": lambda: d4.prefill(
            cfg, params, prompt_t, state=state, slot=0, last_only=True)}
    chain = "" if moe_chain is None else f", chain {'on' if moe_chain else 'off'}"
    calls[f"dsv4 decode step B=1 ctx {ctx}{chain}"] = lambda: d4.decode(
        cfg, params, state, *step, moe_chain=moe_chain)
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(iters):
                fn()
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t) / iters * 1e3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                    torch.cuda.synchronize()
            ka = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                        key=lambda e: -e.self_device_time_total)
            dev = sum(e.self_device_time_total for e in ka) / iters / 1e3
            more = {}
            for kernel, label, key in STEP_KERNELS:
                ev = [e for e in ka if key in e.key]
                more[f"{kernel}_ms"] = sum(e.self_device_time_total for e in ev) / iters / 1e3
                more[f"{kernel}_launches"] = sum(e.count for e in ev) / iters
            out[name] = (wall, dev, sum(e.count for e in ka) / iters, more)
            for e in ka[:TOP_OPS]:
                log(f"    {name}: {e.self_device_time_total / iters / 1e3:7.3f} ms in "
                    f"{e.count / iters:5.0f} x {e.key[:90]}")
            for kernel, label, _ in STEP_KERNELS:
                ms = more[f"{kernel}_ms"]
                if more[f"{kernel}_launches"]:
                    log(f"    {name}: {kernel} ({label}) {ms:.3f} ms in "
                        f"{more[f'{kernel}_launches']:.0f} launches, {ms / dev:.1%} of the "
                        "device time")
    return out


def time_synced_ms(fn, iters: int) -> float:
    """Host clock over calls that each end in a synchronize: for a plain
    version that reads back to the host inside the call (K5's picks its
    experts on the host), where the device-sleep timing cannot apply."""
    fn(0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(iters):
        fn(i)
        torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def time_quant_kernels(cfg, params, k3, k4, k5, errs, launches):
    """K3, K4 and K5 at the main path's shapes, each call on the next layer's
    weights so that the weights come from device memory as in a step (eight
    layers of wq_b are 268 MB, beyond the 50 MB L2); bounds from these
    inputs, at the bf16 peak for the operations (the products are of bf16
    values); the plain versions; the library yardsticks: K4 ``torch.matmul``
    on the bf16 weight, K3 ``torch.bmm`` (``bmm_library``), K5
    (``time_grouped``, also at w2 and at skewed routing) one bf16 grouped
    GEMM (``grouped_mm_library``)."""
    from pegainfer_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    layers = params["layers"]
    L, E = len(layers), cfg.n_routed_experts

    # K4 at B = 1 at each shape of a decode step; the record's own numbers
    # are wq_b's (32768 x 1024, the largest decode linear)
    k4_shapes = time_fp8_shapes(layers, k4, gen)
    k4_step_ms = sum(r["launches_a_step"] * r["ms"] for r in k4_shapes.values())
    k4_step_bound = sum(r["launches_a_step"] * r["bound_ms"] for r in k4_shapes.values())
    log(f"  fp8_gemv over a decode step ({fp8_per_decode_step(cfg)} launches at B = 1): "
        f"{k4_step_ms * 1e3:.2f} us against a bound of {k4_step_bound * 1e3:.2f} us")
    wq_b = k4_shapes["wq_b"]

    # K3 at w1 and w2, B = 1 (6 rows, distinct experts) and B = 2 (12 rows, two
    # tokens sharing 3 of their 6 experts); the record's own numbers are w1's
    # at B = 1
    k3_cases = time_fp4_gemv(layers, k3, gen, E)
    k3_main = k3_cases["w1 M=6"]
    k3_step_ms = 2 * L * k3_main["ms"] + L * k3_cases["w2 M=6"]["ms"]
    k3_step_bound = 2 * L * k3_main["bound_ms"] + L * k3_cases["w2 M=6"]["bound_ms"]
    log(f"  moe_fp4_gemv over a decode step at B = 1 ({3 * L} launches): "
        f"{k3_step_ms * 1e3:.2f} us against a bound of {k3_step_bound * 1e3:.2f} us")
    w1 = [lw["experts_w1"] for lw in layers]
    IN2 = w1[0]["q"].shape[2]

    # K5 over a 1,024-token prefill (6,144 routed rows): w1 with spread
    # routing (the record), then w2 and w1 with skewed routing; the plan is
    # built once outside the timed calls, as models/dsv4.py shares it
    M = 6 * DSV4_PROMPT
    x5, tm, e5, seg = grouped_inputs(gen, M, 2 * IN2, E, skew=False)
    k5_ms, k5_bound, k5_by, k5_lib_ms, k5_lib_call, k5_plan_ms = time_grouped(
        k5, "w1", x5, tm, e5, seg, w1, E)
    k5_plain_ms = time_synced_ms(lambda i: k5.moe_fp4_grouped_plain(
        x5, w1[i % L]["q"], w1[i % L]["s"], *seg, tm=tm), 3)
    w2 = [lw["experts_w2"] for lw in layers]
    x5b = torch.randn((x5.shape[0], 2 * w2[0]["q"].shape[2]), generator=gen,
                      device="cuda").to(torch.bfloat16)
    k5_more = {"w2": time_grouped(k5, "w2", x5b, tm, e5, seg, w2, E)}
    del x5b
    x5s, tms, e5s, segs = grouped_inputs(gen, M, 2 * IN2, E, skew=True)
    k5_more["skewed"] = time_grouped(k5, "w1, skewed routing", x5s, tms, e5s, segs, w1, E)
    del x5s, x5

    fp4_src = "pegainfer_tpu/ops/pallas/fp4_gemm.py"
    return [
        {"name": "moe_fp4_gemv", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/fp4_gemv.cu", "replaces": f"{fp4_src}:1139",
         "launches": launches["moe_fp4_gemv"], "max_abs_err": errs["moe_fp4_gemv"],
         "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"], "bound_ms": k3_main["bound_ms"],
         "bound_by": k3_main["bound_by"], "library_ms": k3_main["library_ms"],
         "library_call": k3_main["library_call"], "shapes": k3_cases, "step_ms": k3_step_ms,
         "step_bound_ms": k3_step_bound},
        {"name": "fp8_gemv", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/fp8_gemv.cu", "replaces": f"{fp4_src}:410",
         "launches": launches["fp8_gemv"], "max_abs_err": errs["fp8_gemv"],
         "ms": wq_b["ms"], "plain_ms": wq_b["plain_ms"], "bound_ms": wq_b["bound_ms"],
         "bound_by": wq_b["bound_by"], "library_ms": wq_b["library_ms"],
         "library_call": "torch.matmul (bf16, weight dequantized ahead)", "shapes": k4_shapes,
         "step_ms": k4_step_ms, "step_bound_ms": k4_step_bound},
        {"name": "moe_fp4_grouped", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/fp4_grouped.cu", "replaces": f"{fp4_src}:283",
         "launches": launches["moe_fp4_grouped"], "max_abs_err": errs["moe_fp4_grouped"],
         "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound, "bound_by": k5_by,
         "library_ms": k5_lib_ms, "library_call": k5_lib_call, "plan_ms": k5_plan_ms,
         **{name: {"ms": ms, "bound_ms": b, "bound_by": by, "library_ms": lib,
                   "library_call": call, "plan_ms": plan}
            for name, (ms, b, by, lib, call, plan) in k5_more.items()}},
    ]


def time_fp8_shapes(layers, k4, gen):
    """K4 at B = 1 at each shape of a decode step (K4_STEP_KEYS), each call
    on the next of the layers' weights and clones of them, as many as the
    K4 study's copies (twice the L2; wkv's eight layers are 17 MB), so that
    no call finds its weight there; beside its bound, its plain version and
    ``torch.matmul`` on the weight dequantized to bf16 ahead (copies for
    twice the L2 too). Returns {key: record}."""
    from pegainfer_tpu_torch.ops import quant
    from pegainfer_tpu_torch.studies.k4_study import copies

    out = {}
    for key in K4_STEP_KEYS:
        ws = [lw[key] for lw in layers if key in lw]
        n_step = sum(key in lw for lw in layers) * (2 if key == "shared_w1" else 1)
        OUT, IN = ws[0]["q"].shape
        n = len(ws)
        for i in range(n, copies(OUT, IN)):
            ws.append({"q": ws[i % n]["q"].clone(), "s": ws[i % n]["s"]})
        x = torch.randn((1, IN), generator=gen, device="cuda").to(torch.bfloat16)
        saved = k4.launches
        ms = time_ms(lambda i: k4.fp8_gemv(x, ws[i % len(ws)]["q"], ws[i % len(ws)]["s"]), 200)
        k4.launches = saved
        plain_ms = time_ms(lambda i: k4.fp8_gemv_plain(x, ws[i % len(ws)]["q"],
                                                       ws[i % len(ws)]["s"]), 16)
        wd = [quant.dequant_any(w, torch.bfloat16)  # outside the timed call
              for w in ws[:max(2, copies(OUT, IN) // 2)]]
        lib_ms = time_ms(lambda i: torch.matmul(x, wd[i % len(wd)].T), 100)
        del wd
        b, by = bound(OUT * IN + ws[0]["s"].numel() * 2 + IN * 2 + OUT * 4, 2 * OUT * IN)
        out[key] = {"OUT": OUT, "IN": IN, "launches_a_step": n_step, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": lib_ms}
        log(f"  fp8_gemv {key} [{OUT}, {IN}] B = 1: {ms * 1e3:.2f} us ({b / ms:.1%} of "
            f"{b * 1e3:.2f} us), plain {plain_ms * 1e3:.2f} us, torch.matmul "
            f"{lib_ms * 1e3:.2f} us, {n_step} launches a step")
        del ws
        torch.cuda.empty_cache()
    return out


def time_fp4_gemv(layers, k3, gen, E):
    """K3 at w1 and w2 at B = 1 (6 rows, distinct experts) and B = 2 (12 rows
    routed as two tokens sharing 3 of their 6 experts: 9 distinct), x in
    bf16, each call on the next layer's weights and expert ids (the 8
    layers' routed experts, 225 MB at B = 1, come from device memory);
    beside the bound of the distinct experts' bytes, the bf16 ``torch.bmm``
    (``bmm_library``) and, at w1 B = 1, the plain version. Returns {case:
    record}."""
    from pegainfer_tpu_torch.studies import k3_study as k3s

    L = len(layers)
    perm = torch.randperm(E, generator=gen, device="cuda")
    out = {}
    for key, M, routing in (("w1", 6, "distinct"), ("w2", 6, "distinct"),
                            ("w1", 12, "shared"), ("w2", 12, "shared")):
        ws = [lw[f"experts_{key}"] for lw in layers]
        _, OUT, IN2 = ws[0]["q"].shape
        S = ws[0]["s"].shape[2]
        x = torch.randn((M, 2 * IN2), generator=gen, device="cuda").to(torch.bfloat16)
        idxs = [k3s.route(routing, M, E, perm, i) for i in range(L)]
        saved = k3.launches
        ms = time_ms(lambda i: k3.moe_fp4_gemv(x, ws[i % L]["q"], ws[i % L]["s"],
                                               idxs[i % L]), 200)
        k3.launches = saved
        n = k3s.distinct(routing, M)
        b, by = bound(n * (OUT * IN2 + OUT * S * 2) + x.numel() * 2 + M * OUT * 4,
                      2 * M * OUT * 2 * IN2)
        lib_ms, lib_call = bmm_library(k3, x, ws, idxs)
        name = f"{key} M={M}{' shared' if routing == 'shared' else ''}"
        out[name] = {"OUT": OUT, "IN": 2 * IN2, "M": M, "routing": routing, "experts": n,
                     "ms": ms, "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
                     "library_call": lib_call, "launches_a_step": (2 if key == "w1" else 1) * L}
        if name == "w1 M=6":
            out[name]["plain_ms"] = time_ms(lambda i: k3.moe_fp4_gemv_plain(
                x, ws[i % L]["q"], ws[i % L]["s"], idxs[i % L]), 16)
        log(f"  moe_fp4_gemv {name} ({n} experts): {ms * 1e3:.2f} us ({b / ms:.1%} of "
            f"{b * 1e3:.2f} us), torch.bmm "
            f"{'none' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}")
    return out


def bmm_library(k3, xs, ws, idxs):
    """K3's library yardstick: the device time of one ``torch.bmm`` of the
    routed experts of ``ws``, gathered and dequantized to bf16 outside the
    timed call (two layers, alternated, so the 100 MB of one call at 6 rows
    come from device memory), with x cast to bf16; held against K3's output
    at GROUPED_RTOL x max |y| (the call rounds its products and output to
    bf16, which QUANT_GEMV_TOL does not allow for). Returns (ms, what was
    called), or (None, "none: why")."""
    from pegainfer_tpu_torch.ops import quant

    saved = k3.launches
    ref = k3.moe_fp4_gemv(xs, ws[0]["q"], ws[0]["s"], idxs[0])
    k3.launches = saved
    wg = [quant.gather_dequant(ws[i], idxs[i].long(), torch.bfloat16) for i in range(2)]
    xb = xs.to(torch.bfloat16)[:, :, None]
    y = torch.bmm(wg[0], xb)[:, :, 0]
    err = (y.float() - ref).abs().max().item()
    tol = GROUPED_RTOL * ref.abs().max().item()
    if not err <= tol:
        log(f"  K3 library: torch.bmm disagrees with K3 by {err:.4g} (tol {tol:.4g})")
        return None, "none: torch.bmm disagrees with K3"
    ms = time_ms(lambda i: torch.bmm(wg[i % 2], xb), 100)
    log(f"  K3 library: torch.bmm on {xs.shape[0]} gathered bf16 experts: {ms * 1e3:.2f} us "
        f"(max |diff| to K3 {err:.4g}, tol {tol:.4g})")
    return ms, "torch.bmm"


# ── phase 27: DeepSeek-V4 from an mp8 checkpoint ────────────────────────


# [27]: [9]'s layers MP8_LAYERS as a model of their own, written as the
# mp8 checkpoint's eight rank files; the requests served from it
MP8_LAYERS = (2, 3)
MP8_WORLD = 8
MP8_REQUESTS = ((DSV4_PROMPT, DSV4_OUT), (16, 4))
_MP8_DTYPES = {torch.bfloat16: "BF16", torch.float32: "F32", torch.int32: "I32",
               torch.float8_e4m3fn: "F8_E4M3"}


def mp8_config(cfg):
    """[9]'s config cut to MP8_LAYERS: its layer 2 (ratio 4, the indexer, a
    hash gate) and layer 3 (ratio 128, a score gate) become layers 0 and 1,
    with one hash layer."""
    import dataclasses

    ratios = tuple(cfg.compress_ratios[i] for i in MP8_LAYERS)
    if ratios != (4, 128) or not MP8_LAYERS[0] < cfg.n_hash_layers <= MP8_LAYERS[1]:
        raise SystemExit(f"[27] [9]'s layers {MP8_LAYERS} are not a hash ratio-4 layer and a "
                         "score ratio-128 layer")
    return dataclasses.replace(cfg, n_layers=2, n_hash_layers=1, compress_ratios=ratios)


def mp8_config_json(cfg):
    """The checkpoint's config.json (the keys ``DSv4Config.from_model_path``
    reads, with their published names)."""
    return {"model_type": "deepseek_v4", "architectures": ["DeepseekV4ForCausalLM"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
            "moe_intermediate_size": cfg.moe_inter_dim, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.num_attention_heads, "num_key_value_heads": 1,
            "head_dim": cfg.head_dim, "q_lora_rank": cfg.q_lora_rank,
            "qk_rope_head_dim": cfg.qk_rope_head_dim, "o_groups": cfg.o_groups,
            "o_lora_rank": cfg.o_lora_rank, "sliding_window": cfg.sliding_window,
            "n_routed_experts": cfg.n_routed_experts, "n_shared_experts": cfg.n_shared_experts,
            "num_experts_per_tok": cfg.n_activated_experts, "num_hash_layers": cfg.n_hash_layers,
            "scoring_func": "sqrtsoftplus", "routed_scaling_factor": cfg.routed_scaling_factor,
            "swiglu_limit": cfg.swiglu_limit, "rms_norm_eps": cfg.rms_norm_eps,
            "index_n_heads": cfg.index_n_heads, "index_head_dim": cfg.index_head_dim,
            "index_topk": cfg.index_topk, "max_position_embeddings": cfg.max_position_embeddings,
            "rope_theta": cfg.rope_theta, "compress_rope_theta": cfg.compress_rope_theta,
            "compress_ratios": list(cfg.compress_ratios),
            "rope_scaling": {"type": "yarn", "factor": cfg.yarn_factor,
                             "beta_fast": cfg.yarn_beta_fast, "beta_slow": cfg.yarn_beta_slow,
                             "original_max_position_embeddings": cfg.yarn_original_seq_len},
            "hc_mult": cfg.hc_mult, "hc_sinkhorn_iters": cfg.hc_sinkhorn_iters,
            "hc_eps": cfg.hc_eps, "bos_token_id": cfg.bos_token_id,
            "eos_token_id": cfg.eos_token_id}


def mp8_tree(params):
    """[9]'s tree with its layers cut to MP8_LAYERS (the same tensors)."""
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": [params["layers"][i] for i in MP8_LAYERS]}


def e8m0_codes(s):
    """bf16 powers of two -> their E8M0 codes (the exponent field), uint8,
    on the card; a scale that is no positive normal power of two fails."""
    bits = s.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    if bool(((bits & 0x807F) != 0).any()) or bool(((bits >> 7) == 0).any()):
        raise SystemExit("[27a] a scale is no positive normal power of two")
    return (bits >> 7).to(torch.uint8)


def mp8_rank_entries(cfg, tree, rank, codes):
    """Rank ``rank``'s tensors [(name, dtype, shape, tensor on the card)]
    in the mp8 layout (models/dsv4_manifest.py): vocab, head, o-group and
    index-head shards (``wo_b`` on its input axis), experts rank x E / 8
    onwards, the rest whole. ``codes`` caches each container's E8M0 codes."""
    out = []

    def put(name, t, dtype=None, shape=None):
        out.append((name, dtype or _MP8_DTYPES[t.dtype], list(shape or t.shape), t))

    def shard(t, axis=0):
        n = t.shape[axis] // MP8_WORLD
        return t.narrow(axis, rank * n, n)

    def scales(w):
        if id(w) not in codes:
            codes[id(w)] = e8m0_codes(w["s"])
        return codes[id(w)]

    def fp8(name, w, axis=None):
        q, s = w["q"], scales(w)
        if axis is not None:
            q, s = shard(q, axis), shard(s, axis)
        put(f"{name}.weight", q)
        put(f"{name}.scale", s, "F8_E8M0")

    put("embed.weight", shard(tree["embed"]))
    put("head.weight", shard(tree["head"]))
    put("norm.weight", tree["norm"])
    for k in ("hc_head_fn", "hc_head_base", "hc_head_scale"):
        put(k, tree[k])
    E_loc = cfg.n_routed_experts // MP8_WORLD
    for li, lw in enumerate(tree["layers"]):
        p = f"layers.{li}"
        put(f"{p}.attn_norm.weight", lw["attn_norm"])
        put(f"{p}.ffn_norm.weight", lw["ffn_norm"])
        for k in ("hc_attn_fn", "hc_attn_base", "hc_attn_scale", "hc_ffn_fn", "hc_ffn_base",
                  "hc_ffn_scale"):
            put(f"{p}.{k}", lw[k])
        put(f"{p}.attn.attn_sink", shard(lw["attn_sink"]))
        put(f"{p}.attn.q_norm.weight", lw["q_norm"])
        put(f"{p}.attn.kv_norm.weight", lw["kv_norm"])
        fp8(f"{p}.attn.wq_a", lw["wq_a"])
        fp8(f"{p}.attn.wq_b", lw["wq_b"], axis=0)
        fp8(f"{p}.attn.wkv", lw["wkv"])
        put(f"{p}.attn.wo_a.weight", shard(lw["wo_a"]))
        fp8(f"{p}.attn.wo_b", lw["wo_b"], axis=1)
        put(f"{p}.ffn.gate.weight", lw["gate_weight"])
        if "gate_tid2eid" in lw:
            put(f"{p}.ffn.gate.tid2eid", lw["gate_tid2eid"])
        else:
            put(f"{p}.ffn.gate.bias", lw["gate_bias"])
        for k in ("w1", "w2", "w3"):
            fp8(f"{p}.ffn.shared_experts.{k}", lw[f"shared_{k}"])
        for le in range(E_loc):
            ge = rank * E_loc + le
            for k in ("w1", "w2", "w3"):
                w = lw[f"experts_{k}"]
                out_d, half = w["q"].shape[1:]
                put(f"{p}.ffn.experts.{ge}.{k}.weight", w["q"][ge], "F4", (out_d, 2 * half))
                put(f"{p}.ffn.experts.{ge}.{k}.scale", scales(w)[ge], "F8_E8M0")
        for key, prefix in (("comp", f"{p}.attn.compressor"),
                            ("idx_comp", f"{p}.attn.indexer.compressor")):
            if key in lw:
                put(f"{prefix}.ape", lw[key]["ape"])
                for k in ("wkv", "wgate", "norm"):
                    put(f"{prefix}.{k}.weight", lw[key][k])
        if "idx_wq_b" in lw:
            fp8(f"{p}.attn.indexer.wq_b", lw["idx_wq_b"], axis=0)
            put(f"{p}.attn.indexer.weights_proj.weight", shard(lw["idx_weights_proj"]))
    return out


def leaves_differing(got, want, path=""):
    """The paths where two trees differ in keys or in a leaf's bits."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return [path or "/"]
        return [p for k in want for p in leaves_differing(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return [path]
        return [p for i, (g, w) in enumerate(zip(got, want))
                for p in leaves_differing(g, w, f"{path}/{i}")]
    return [] if same_bits(got, want) else [path]


def rss_gb():
    """(peak, current) resident set of this process, GB."""
    import resource

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    with open("/proc/self/statm") as f:
        cur = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return peak / 1e9, cur / 1e9


def timed_load(label, fn, nbytes):
    """Run ``fn`` (a load onto the card) timed; log wall, GB/s of the files,
    RSS before and after and the device bytes it added. Returns (result,
    record)."""
    gc.collect()
    torch.cuda.synchronize()
    before_dev = torch.cuda.memory_allocated()
    rss0 = rss_gb()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rss1 = rss_gb()
    dev = torch.cuda.memory_allocated() - before_dev
    log(f"  {label}: {wall:.3f} s, {nbytes / wall / 1e9:.2f} GB/s of the files (warm page "
        f"cache); RSS peak {rss0[0]:.2f} -> {rss1[0]:.2f} GB, current {rss0[1]:.2f} -> "
        f"{rss1[1]:.2f} GB; {dev / 1e9:.3f} GB more on the card")
    return out, {"seconds": wall, "gb_per_s": nbytes / wall / 1e9, "page_cache": "warm",
                 "rss_peak_gb": [rss0[0], rss1[0]], "rss_gb": [rss0[1], rss1[1]],
                 "device_bytes": dev}


def timed_greedy(contract, handle, label, prompt, n):
    """One greedy request: (ids, record with TTFT, the JAX bench's steady
    TPOT from the third token and the gaps' p50)."""
    ch, t0 = run_request(contract, handle, prompt, n)
    toks, fin, times = drain(contract, ch)
    expect_finished(contract, label, toks, fin, n)
    k = min(2, len(times) - 2)
    gaps = [(b - a) * 1e3 for a, b in zip(times[k:], times[k + 1:])]
    return toks, {"ttft_ms": (times[0] - t0) * 1e3,
                  "steady_tpot_ms": (times[-1] - times[k]) * 1e3 / (len(times) - 1 - k),
                  "gap_p50_ms": statistics.median(gaps) if gaps else None}


def serve_mp8(contract, handle, prompts, kernels=None):
    """The main request twice (the second one's times are the warm ones:
    the first captures the block graphs at first use), then the short one,
    one after another on ``handle`` (launch counters and the executor's
    counts at 0 first); then shut it down. Returns (ids of the three, the
    warm main request's timing record, launches, prefills, decode
    steps)."""
    ex = handle._scheduler.executor
    for mod in (kernels or {}).values():
        mod.launches = 0
    ex.prefills = ex.decode_steps = 0
    (main_in, main_out), (short_in, short_out) = MP8_REQUESTS
    try:
        ids, timing = [], []
        for prompt, n in ((prompts[0], main_out), (prompts[0], main_out),
                          (prompts[1], short_out)):
            toks, rec = timed_greedy(contract, handle, f"{len(prompt)}/{n}", prompt, n)
            ids.append(toks)
            timing.append(rec)
        if ids[1] != ids[0]:
            raise SystemExit("[27] the repeated main request gave other ids")
        launches = {name: mod.launches for name, mod in (kernels or {}).items()}
        return ids, timing[1], launches, ex.prefills, ex.decode_steps
    finally:
        handle.shutdown()
        handle._thread.join(timeout=60)


def run_mp8(cfg, params, d):
    """Phases 27a-27b on [9]'s fp4 weights: write the checkpoint into ``d``
    (kept for 27c), load it through ``start_engine(path)`` bit for bit,
    serve from it against the in-memory engine, and through the CLI's
    ``build_engine``. Returns the record."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import dsv4 as d4
    from pegainfer_tpu_torch.models import dsv4_engine as d4e
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
    from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4

    t_phase = time.perf_counter()
    cfg2 = mp8_config(cfg)
    tree = mp8_tree(params)
    log(f"[27a] an mp8 checkpoint of [9]'s layers {MP8_LAYERS} ({cfg2.n_layers} layers, "
        f"compress ratios {list(cfg2.compress_ratios)}, {cfg2.n_hash_layers} hash layer) in the "
        "real dtypes (F8_E4M3, F8_E8M0 scales, packed F4 experts), written by the smoke's "
        "writer; card: " + card_line())
    codes = {}
    ranks = [mp8_rank_entries(cfg2, tree, r, codes) for r in range(MP8_WORLD)]
    need = sum(t.numel() * t.element_size() for es in ranks for _, _, _, t in es)
    free = shutil.disk_usage(d).free
    log(f"  {d}: {free / 1e9:.1f} GB free, the files need {need / 1e9:.2f} GB")
    if free < need * 1.05:
        raise SystemExit(f"[27a] {d} has {free / 1e9:.1f} GB free, the checkpoint needs "
                         f"{need / 1e9:.2f} GB")
    t = time.perf_counter()
    (Path(d) / "mp8").mkdir()
    (Path(d) / "config.json").write_text(json.dumps(mp8_config_json(cfg2)))
    nbytes = sum(write_raw_safetensors(str(Path(d) / "mp8" / f"model{r}-mp8.safetensors"), es)
                 for r, es in enumerate(ranks))
    write_s = time.perf_counter() - t
    n_tensors = sum(len(es) for es in ranks)
    del ranks, codes
    log(f"  wrote {n_tensors} tensors, {nbytes / 1e9:.3f} GB in {MP8_WORLD} rank files in "
        f"{write_s:.2f} s")
    if d4.DSv4Config.from_model_path(d) != cfg2:
        raise SystemExit("[27a] config.json does not read back as the cut config")

    opts = contract.EngineLoadOptions(max_batch_size=DSV4_SLOTS,
                                      max_model_len=DSV4_MAX_MODEL_LEN, seed=SEED)
    handle, load = timed_load("start_engine(path), resident", lambda: d4e.start_engine(
        d, opts, device="cuda"), nbytes)
    ex_params = handle._scheduler.executor.params
    load["params_bytes"] = d4.params_bytes(ex_params)
    bad = leaves_differing(ex_params, tree)
    log(f"  {len(list(tensors_of(ex_params)))} leaves against [9]'s "
        f"{len(list(tensors_of(tree)))}, key by key: bit for bit {not bad}; params_bytes "
        f"{load['params_bytes'] / 1e9:.3f} GB")
    if bad:
        handle.shutdown()
        raise SystemExit(f"[27a] the loaded leaves differ from [9]'s: {bad[:8]}")
    del ex_params

    log("[27b] serving from the path under the defaults (graphs, decode blocks): "
        f"{MP8_REQUESTS[0]} twice, then {MP8_REQUESTS[1]}, greedy, against an in-memory engine "
        "on [9]'s sliced tree")
    rng = np.random.default_rng(SEED + 28)
    prompts = [rng.integers(0, cfg2.vocab_size, n).tolist() for n, _ in MP8_REQUESTS]
    kernels = {"moe_fp4_gemv": k3, "fp8_gemv": k4, "moe_fp4_grouped": k5}
    disk, fp4_timing, launches, prefills, steps = serve_mp8(contract, handle, prompts, kernels)
    L = cfg2.n_layers
    check_launches(launches, {"moe_fp4_gemv": 3 * L * steps,
                              "fp8_gemv": fp8_per_decode_step(cfg2) * steps,
                              "moe_fp4_grouped": 3 * L * prefills},
                   f"{prefills} prefills, {steps} decode steps, {L} layers")
    del handle
    gc.collect()
    mem, _, _, _, _ = serve_mp8(contract, d4e.start_engine_from_params(
        cfg2, tree, opts, device="cuda"), prompts)
    log(f"  ids from the path equal the in-memory engine's: {disk == mem}; the second "
        f"{MP8_REQUESTS[0][0]}/{MP8_REQUESTS[0][1]} (warm): TTFT {fp4_timing['ttft_ms']:.3f} ms, "
        f"steady TPOT {fp4_timing['steady_tpot_ms']:.3f} ms (the JAX bench's), gaps p50 "
        f"{fp4_timing['gap_p50_ms']:.3f} ms")
    if disk != mem:
        raise SystemExit("[27b] the checkpoint engine's ids differ from the in-memory engine's")
    gc.collect()
    cli = run_mp8_cli(cfg2, d, prompts[1], disk[2])
    rec = {"layers": list(MP8_LAYERS), "bytes": nbytes, "tensors": n_tensors,
           "write_s": write_s, "load": load, "tokens_equal": True, "launches": launches,
           "prefills": prefills, "decode_steps": steps, "fp4": fp4_timing, "cli": cli,
           "ids": disk, "card": card_line()}
    gc.collect()
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  [27a]-[27b] took {rec['phase_s']:.1f} s")
    return rec


def run_mp8_cli(cfg, d, prompt, want):
    """[27b]'s CLI: ``build_engine(parse_args(["--model-path", d, ...]))``
    behind ``OpenAIApp`` + ``httpd`` with ``SimTokenizer`` (no transformers
    here); one blocking completion of ``prompt``, its ids against ``want``."""
    from pegainfer_tpu_torch.server import httpd
    from pegainfer_tpu_torch.server import main as server_main
    from pegainfer_tpu_torch.server.api import OpenAIApp
    from pegainfer_tpu_torch.server.tokenizer import SimTokenizer

    argv = ["--model-path", d, "--max-batch-size", str(DSV4_SLOTS), "--seed", str(SEED)]
    t = time.perf_counter()
    handle = server_main.build_engine(server_main.parse_args(argv), device="cuda")
    start_s = time.perf_counter() - t
    try:
        app = OpenAIApp(handle, SimTokenizer(vocab_size=cfg.vocab_size), "dsv4-mp8").build()
        server = httpd.serve(app, "127.0.0.1", 0, threads=64)
        try:
            status, _, body, wall = http_call(server.port, "POST", "/v1/completions", {
                "prompt": prompt, "max_tokens": len(want), "ignore_eos": True})
        finally:
            server.close()
    finally:
        handle.shutdown()
        handle._thread.join(timeout=60)
    ids = text_ids(body["choices"][0]["text"]) if status == 200 else None
    log(f"  the CLI's build_engine({' '.join(argv[:1])} ...) up in {start_s:.2f} s; "
        f"/v1/completions {len(prompt)}/{len(want)}: status {status}, ids equal [27b]'s: "
        f"{ids == want}; wall {wall * 1e3:.1f} ms")
    if ids != want:
        raise SystemExit(f"[27b] the CLI's engine answered {status} {body}")
    return {"engine_start_s": start_s, "status": status, "wall_ms": wall * 1e3,
            "tokens_equal": True}


def run_mp8_bf16(cfg, d, mp8):
    """Phase 27c, after [9]'s weights are freed: the resident tree from the
    path again, and the bf16 mode from the same files; the 1,024 prefill's
    logits against the resident ones under the resident run's routing;
    1024/64 served in bf16. Returns the record."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import dsv4 as d4
    from pegainfer_tpu_torch.models import dsv4_engine as d4e
    from pegainfer_tpu_torch.models import dsv4_weights as d4w
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
    from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4

    t_phase = time.perf_counter()
    cfg2 = mp8_config(cfg)
    log("[27c] the bf16 mode (quantize='bf16') from [27a]'s files, beside the resident tree "
        "loaded again; card: " + card_line())
    res, res_load = timed_load("load_params(resident=True)", lambda: d4w.load_params(
        cfg2, d, resident=True, device="cuda"), mp8["bytes"])
    opts = contract.EngineLoadOptions(max_batch_size=DSV4_SLOTS,
                                      max_model_len=DSV4_MAX_MODEL_LEN, seed=SEED,
                                      quantize="bf16")
    handle, load = timed_load("start_engine(path, quantize='bf16')", lambda: d4e.start_engine(
        d, opts, device="cuda"), mp8["bytes"])
    bf = handle._scheduler.executor.params
    load["params_bytes"], res_load["params_bytes"] = d4.params_bytes(bf), d4.params_bytes(res)
    ratio = load["params_bytes"] / res_load["params_bytes"]
    log(f"  params: bf16 {load['params_bytes'] / 1e9:.3f} GB against resident "
        f"{res_load['params_bytes'] / 1e9:.3f} GB ({ratio:.2f}x)")
    rng = np.random.default_rng(SEED + 28)
    prompts = [rng.integers(0, cfg2.vocab_size, n).tolist() for n, _ in MP8_REQUESTS]
    toks_t = torch.tensor(prompts[0], dtype=torch.int32, device="cuda")
    replay = RoutingReplay(d4)
    try:
        with torch.no_grad():
            replay.record()
            lr, _ = d4.prefill(cfg2, res, toks_t, last_only=True)
            replay.replay()
            lb, _ = d4.prefill(cfg2, bf, toks_t, last_only=True)
            torch.cuda.synchronize()
    finally:
        replay.restore()
    if not (bool(torch.isfinite(lb).all()) and lb.shape == (1, cfg2.vocab_size)):
        raise SystemExit("[27c] the bf16 prefill logits are not finite [1, V]")
    replay.report(f"{len(prompts[0])}-token prefill, bf16 routed as resident")
    share = check_logits(lb[0], lr[0], DSV4_LOGITS_RTOL,
                         "[27c] the bf16 mode's prefill logits disagree with the resident mode's")
    del res, lr, lb, bf
    kernels = {"moe_fp4_gemv": k3, "fp8_gemv": k4, "moe_fp4_grouped": k5}
    ids, timing, launches, prefills, steps = serve_mp8(contract, handle, prompts, kernels)
    same = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(y))
            for x, y in zip(ids[1:], mp8["ids"][1:])]
    log(f"  bf16 greedy ids agree with [27b]'s fp4 ids for the first {same} tokens of "
        f"{[n for _, n in MP8_REQUESTS]} (reported, not gated); launches {launches} "
        f"({prefills} prefills, {steps} decode steps)")
    if any(launches.values()):
        raise SystemExit("[27c] the bf16 mode launched a quantized kernel")
    fp4 = mp8["fp4"]
    log(f"  the second {MP8_REQUESTS[0][0]}/{MP8_REQUESTS[0][1]} (warm) at {cfg2.n_layers} layers: "
        "steady TPOT bf16 "
        f"{timing['steady_tpot_ms']:.3f} ms against fp4 {fp4['steady_tpot_ms']:.3f} ms; gaps p50 "
        f"{timing['gap_p50_ms']:.3f} against {fp4['gap_p50_ms']:.3f} ms; TTFT "
        f"{timing['ttft_ms']:.3f} against {fp4['ttft_ms']:.3f} ms")
    del handle
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"resident_load": res_load, "load": load, "logits_share_of_limit": share,
           "routing_flips": replay.flips, "ids_agree_tokens": same, "bf16": timing,
           "launches": launches, "phase_s": time.perf_counter() - t_phase, "card": card_line()}
    log(f"  [27c] took {rec['phase_s']:.1f} s")
    return rec


# ── phase 28: DeepSeek-V2-Lite at full width and depth ────────────────

# the published DeepSeek-V2-Lite config.json (deepseek-ai/DeepSeek-V2-Lite)
DSV2_CONFIG = dict(vocab_size=102400, hidden_size=2048, intermediate_size=10944,
                   moe_intermediate_size=1408, num_hidden_layers=27, first_k_dense_replace=1,
                   num_attention_heads=16, kv_lora_rank=512, qk_nope_head_dim=128,
                   qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=64,
                   n_shared_experts=2, num_experts_per_token=6, routed_scaling_factor=1.0,
                   norm_topk_prob=False, rms_norm_eps=1e-6, rope_theta=10000.0,
                   max_position_embeddings=163840, eos_token_id=100001, bos_token_id=100000)
DSV2_SLOTS = 2
DSV2_MAIN = (1024, 256)  # [28a]: graphed, twice (the second warm)
DSV2_EAGER_OUT = 32  # [28a]: 1024/32 at B 1 and B 2, graphed and eager
DSV2_CHECK_IDS = 64  # [28b]: the prompt and this many generated ids in one prefill
DSV2_MOE_ROWS = (1, 2, 16)  # [28c]: the decode form at B 1 and 2, the grouped form at T 16
# [28c]'s limits, each row to a share of its max |ref| (_moe_dense, f32):
# the gathered decode form forms the same exact f32 products of bf16 values
# (bf16 rows, an f32 activation split exactly into three bf16 parts) and
# only sums them in another order, as K6 against its plain version
DSV2_GATHERED_ROW_RTOL = 1e-5
# the grouped form also rounds the activation to bf16 before w2: each term
# moves by at most 2^-9 of itself, about 2^-9 of the row's size over
# random signs; 5x that
DSV2_GROUPED_ROW_RTOL = 1e-2
DSV2_CKPT_LAYERS = 2  # [28d]: the dense layer 0 and one MoE layer
DSV2_CKPT_REQUESTS = ((64, 16), (16, 4))  # [28d]; the second also over HTTP


def dsv2_config(v2, layers=None):
    cfg = dict(DSV2_CONFIG)
    if layers is not None:
        cfg["num_hidden_layers"] = layers
    return v2.DSv2LiteConfig(**cfg)


def all_kernels():
    """Every wrapper module of K1-K9 and the int8 linear kernel by its record
    name."""
    from pegainfer_tpu_torch.ops.cuda import (flash_prefill, fp4_chain, fp4_gemv, fp4_grouped,
                                              fp8_gemv, int8_chain, int8_gemv, int8_grouped,
                                              int8_linear, paged_decode)

    return {"paged_decode": paged_decode, "flash_prefill": flash_prefill,
            "moe_fp4_gemv": fp4_gemv, "fp8_gemv": fp8_gemv, "moe_fp4_grouped": fp4_grouped,
            "moe_int8_gemv": int8_gemv, "moe_int8_grouped": int8_grouped,
            "moe_int8_chain": int8_chain, "moe_fp4_chain": fp4_chain,
            "int8_linear": int8_linear}


def window_tpot(times, k=2, w=16):
    """The p50 over windows of ``w`` tokens of the time a token, from the
    (k + 1)-th token (a decode block delivers its tokens at once, so the
    gaps between single tokens are no step time)."""
    wins = [(times[i + w] - times[i]) * 1e3 / w for i in range(k, len(times) - w)]
    return statistics.median(wins) if wins else None


def run_dsv2lite():
    """Phase 28: DeepSeek-V2-Lite at the published config (27 layers, full
    width), random bf16 weights made on the card from the seed. Returns the
    record."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import dsv2lite as v2

    t_phase = time.perf_counter()
    card = card_line()
    cfg = dsv2_config(v2)
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("[28] TF32 is on: the f32 products would round their inputs")
    log(f"[28] DeepSeek-V2-Lite at its published config ({cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.n_routed_experts} experts top-{cfg.num_experts_per_token} + "
        f"{cfg.n_shared_experts} shared), random bf16 weights made on the card; card: {card}")
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    params = v2.init_random_device(cfg, torch.Generator("cuda").manual_seed(SEED + 28), "cuda")
    torch.cuda.synchronize()
    nbytes = v2.params_bytes(params)
    rec = {"card": card, "params_bytes": nbytes, "init_s": time.perf_counter() - t}
    log(f"  weights: {nbytes / 1e9:.3f} GB of params in {rec['init_s']:.2f} s "
        f"({(torch.cuda.memory_allocated() - before) / 1e9:.3f} GB allocated)")
    rng = np.random.default_rng(SEED + 28)
    prompt = rng.integers(0, cfg.vocab_size, DSV2_MAIN[0]).tolist()
    second = rng.integers(0, cfg.vocab_size, DSV2_MAIN[0]).tolist()
    kernels = all_kernels()
    rec["serving"], main_ids = dsv2_serve(v2, contract, cfg, params, prompt, second, kernels,
                                          card)
    gc.collect()
    rec["identity"] = dsv2_identity(v2, cfg, params, prompt, main_ids)
    rec["moe_forms"] = dsv2_moe_forms(v2, cfg, params)
    gc.collect()
    d = tempfile.mkdtemp(prefix="pegainfer-dsv2lite-")
    try:
        rec["checkpoint"] = dsv2_checkpoint(v2, contract, cfg, params, d, kernels)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  [28] took {rec['phase_s']:.1f} s ({card})")
    return rec


def dsv2_serve(v2, contract, cfg, params, prompt, second, kernels, card):
    """[28a]: the engine under the JAX defaults (graphed decode, blocks)
    serves 1024/256 twice (the second warm) and the pair 1024/32 x 2 at once
    (B 2); an eager engine (``enable_cuda_graph=False``) serves 1024/32 and
    the pair, whose ids must equal the graphed ones; no K1-K9 launch.
    Returns (the record, the main request's ids)."""
    n_in, n_out = DSV2_MAIN
    pair = [(prompt, DSV2_EAGER_OUT), (second, DSV2_EAGER_OUT)]
    log(f"[28a] serving under the JAX defaults (graphed decode, decode blocks, "
        f"{DSV2_SLOTS} slots): {n_in}/{n_out} twice, then {n_in}/{DSV2_EAGER_OUT} x 2 at once "
        f"(B 2); then an eager engine; card: {card}")
    runs = {}
    for mode, extra in (("graphed", {}), ("eager", EAGER)):
        for mod in kernels.values():
            mod.launches = 0
        alloc0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        opts = contract.EngineLoadOptions(max_batch_size=DSV2_SLOTS, seed=SEED, **extra)
        handle = v2.start_engine_from_params(cfg, params, opts, device="cuda")
        ex = handle._scheduler.executor
        state_bytes = sum(v.numel() * v.element_size() for v in ex.state.values())
        out = {}
        try:
            if mode == "graphed":
                main = []
                for i in range(2):
                    ch, t0 = run_request(contract, handle, prompt, n_out)
                    toks, fin, times = drain(contract, ch)
                    expect_finished(contract, f"{mode} {n_in}/{n_out} ({'cold' if i == 0 else 'warm'})",
                                    toks, fin, n_out)
                    k = min(2, len(times) - 2)
                    main.append((toks, {"ttft_ms": (times[0] - t0) * 1e3,
                                        "steady_tpot_ms": (times[-1] - times[k]) * 1e3
                                        / (len(times) - 1 - k),
                                        "tpot_p50_ms": window_tpot(times),
                                        "wall_s": times[-1] - t0}))
                if main[1][0] != main[0][0]:
                    raise SystemExit("[28a] the repeated main request gave other ids")
                out["main_ids"], out["cold"], out["warm"] = main[0][0], main[0][1], main[1][1]
                one = main[0][0][:DSV2_EAGER_OUT]
            else:
                one = greedy_tokens(contract, handle, prompt, DSV2_EAGER_OUT)
            t = time.perf_counter()
            chans = submit_together(contract, handle, pair)
            got = []
            for ch, n, m in chans:
                toks, fin, _ = drain(contract, ch)
                expect_finished(contract, f"{mode} {n}/{m} (B 2)", toks, fin, m)
                got.append(toks)
            out["pair_wall_s"] = time.perf_counter() - t
            out["one"], out["pair"] = one, got
            out["launches"] = {name: mod.launches for name, mod in kernels.items()}
            out["prefills"], out["decode_steps"] = ex.prefills, ex.decode_steps
            out["captures"] = ex.graph_captures
            out["capture_s"] = (sum(c[3] for c in ex._graphs.capture_log)
                                if ex._graphs is not None else 0.0)
            out["pool_bytes"] = ex._graphs.pool_bytes if ex._graphs is not None else 0
            out["state_bytes"] = state_bytes
            out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
            out["engine_allocated_bytes"] = torch.cuda.memory_allocated() - alloc0
        finally:
            handle.shutdown()
            handle._thread.join(timeout=60)
        del handle, ex
        gc.collect()
        torch.cuda.empty_cache()
        runs[mode] = out
        log(f"  {mode}: launches {out['launches']} (none may run); {out['prefills']} prefills, "
            f"{out['decode_steps']} decode steps, {out['captures']} graphs captured in "
            f"{out['capture_s']:.2f} s ({out['pool_bytes'] / 1e9:.3f} GB of pool); latent "
            f"state {state_bytes / 1e9:.3f} GB; peak allocated "
            f"{out['peak_allocated_bytes'] / 1e9:.3f} GB; card: {card}")
        if any(out["launches"].values()):
            raise SystemExit(f"[28a] a K1-K9 kernel ran on the DSv2-Lite path ({mode})")
    g, e = runs["graphed"], runs["eager"]
    same = g["one"] == e["one"] and g["pair"] == e["pair"]
    log(f"  graphed ids equal the eager ids, {n_in}/{DSV2_EAGER_OUT} at B 1 and the pair at B 2: "
        f"{same}")
    if not same:
        raise SystemExit("[28a] the graphed engine's ids differ from the eager engine's")
    w, c = g["warm"], g["cold"]
    log(f"  {n_in}/{n_out} graphed, warm: TTFT {w['ttft_ms']:.3f} ms, steady TPOT "
        f"{w['steady_tpot_ms']:.3f} ms (the JAX bench's), TPOT p50 over 16-token windows "
        f"{w['tpot_p50_ms']:.3f} ms; cold (first-use captures): TTFT {c['ttft_ms']:.3f} ms, "
        f"steady TPOT {c['steady_tpot_ms']:.3f} ms; the pair at B 2 in {g['pair_wall_s']:.3f} s "
        f"graphed, {e['pair_wall_s']:.3f} s eager; params {v2.params_bytes(params) / 1e9:.3f} GB; "
        f"card: {card}")
    main_ids = g.pop("main_ids")
    for r in runs.values():
        r.pop("one")
        r.pop("pair")
    return {"graphed": g, "eager": e, "ids_equal": True, "card": card}, main_ids


def dsv2_identity(v2, cfg, params, prompt, main_ids):
    """[28b]: one prefill with every row's logits over the prompt and the
    first DSV2_CHECK_IDS generated ids: each position's argmax must be the
    next generated id, unless that id's logit lies within rule 7's limit
    (LOGITS_RTOL x the row's max |logit|) of the row's max. The decode that
    made the ids ran the absorbed MLA over the latent cache and the
    gathered experts; this prefill materializes K/V and runs them
    grouped."""
    n = DSV2_CHECK_IDS
    log(f"[28b] the MLA identity at full width: prefill(return_all_logits=True) over "
        f"{len(prompt)} + {n} tokens against the decode's first {n} ids; card: {card_line()}")
    toks = torch.tensor(prompt + main_ids[:n - 1], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        _, every = v2.prefill(cfg, params, toks, return_all_logits=True)
        rows = every[len(prompt) - 1:]  # row i predicts generated id i
        want = torch.tensor(main_ids[:n], device="cuda")
        if not (bool(torch.isfinite(rows).all()) and rows.shape == (n, cfg.vocab_size)):
            raise SystemExit("[28b] the prefill logits are not finite [n, V]")
        top = rows.max(dim=-1).values
        behind = top - rows.gather(1, want[:, None].long())[:, 0]  # 0 where the id is the argmax
        limit = LOGITS_RTOL * rows.abs().max(dim=-1).values
        top2 = torch.topk(rows, 2).values
        gap = top2[:, 0] - top2[:, 1]
    differ = int((behind > 0).sum())
    worst = float((behind / limit).max())
    log(f"  {differ} of {n} positions have another argmax than the decode's id; the largest "
        f"lag of the decode's id behind the row's max is {worst:.3f} of the limit "
        f"({LOGITS_RTOL} x max |logit|, {float(limit.mean()):.4e} on average); top-2 gaps: "
        f"min {float(gap.min()):.4e}, median {float(gap.median()):.4e}")
    if worst > 1.0:
        raise SystemExit("[28b] a prefill row's argmax disagrees with the decode's id beyond "
                         "the limit")
    return {"positions": n, "argmax_differs": differ, "worst_share_of_limit": worst,
            "min_top2_gap": float(gap.min())}


def _nan_pool(nbytes):
    """Leave ``nbytes`` of NaN-filled memory in the caching allocator's
    free blocks, so that a form's outputs and scratch start as NaN."""
    junk = torch.full((nbytes // 4,), float("nan"), device="cuda")
    del junk


def dsv2_moe_forms(v2, cfg, params):
    """[28c]: one full-width MoE layer (the first) at the rows of decode (B
    1, 2: the gathered form) and of a short prefill (T 16: the grouped
    form), each row against ``_moe_dense`` (every expert in f32) to its
    limit, the allocator's free memory NaN-filled first. Returns the
    record."""
    log(f"[28c] one full-width MoE layer's routed forms against _moe_dense at T "
        f"{list(DSV2_MOE_ROWS)}; card: {card_line()}")
    mw = {k: v[0] for k, v in params["moe"].items()}
    gen = torch.Generator("cuda").manual_seed(SEED + 281)
    h = torch.randn((max(DSV2_MOE_ROWS), cfg.hidden_size), device="cuda",
                    generator=gen).to(torch.bfloat16)
    out = {}
    with torch.no_grad():
        for T in DSV2_MOE_ROWS:
            idx, wts = v2._route(cfg, mw["gate_w"], h[:T])
            ref = v2._moe_dense(cfg, mw, h[:T], idx, wts)
            form = "grouped" if T >= v2.PREFILL_MOE_TOKENS else "gathered"
            rtol = DSV2_GROUPED_ROW_RTOL if form == "grouped" else DSV2_GATHERED_ROW_RTOL
            _nan_pool(1 << 30)
            got = getattr(v2, f"_moe_{form}")(cfg, mw, h[:T], idx, wts)
            err = ((got - ref).abs().amax(dim=-1) / ref.abs().amax(dim=-1)).max().item()
            finite = bool(torch.isfinite(got).all())
            out[f"T{T}"] = {"form": form, "row_err": err, "rtol": rtol,
                            "experts": int(idx.unique().numel())}
            log(f"  T {T} ({form}, {out[f'T{T}']['experts']} distinct experts): worst row "
                f"{err:.3e} of its max |ref| (limit {rtol}); finite: {finite}")
            if not finite or err > rtol:
                raise SystemExit(f"[28c] the {form} form at T {T} disagrees with _moe_dense")
    return out


def dsv2_hf_state_dict(cfg, params, layers):
    """The first ``layers`` layers of the tree in HF names and layouts
    ([out, in] projections, expert rows as stored), on the card."""
    Ld = cfg.first_k_dense_replace
    a, dn, m = params["attn"], params["dense"], params["moe"]
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_ln"],
          "lm_head.weight": params["lm_head"].T}
    names = {"input_ln": "input_layernorm", "post_ln": "post_attention_layernorm",
             "wq": "self_attn.q_proj", "kv_a": "self_attn.kv_a_proj_with_mqa",
             "kv_a_norm": "self_attn.kv_a_layernorm", "kv_b": "self_attn.kv_b_proj",
             "wo": "self_attn.o_proj"}
    for i in range(layers):
        pre = f"model.layers.{i}."
        for key, hf in names.items():
            w = a[key][i]
            sd[pre + hf + ".weight"] = w.T if w.dim() == 2 else w
        if i < Ld:
            for key, hf in (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj")):
                sd[pre + f"mlp.{hf}.weight"] = dn[key][i].T
            continue
        j = i - Ld
        sd[pre + "mlp.gate.weight"] = m["gate_w"][j].T
        for key, hf in (("shared_gate", "gate_proj"), ("shared_up", "up_proj"),
                        ("shared_down", "down_proj")):
            sd[pre + f"mlp.shared_experts.{hf}.weight"] = m[key][j].T
        for key, hf in (("experts_w1", "gate_proj"), ("experts_w3", "up_proj"),
                        ("experts_w2", "down_proj")):
            for e in range(cfg.n_routed_experts):
                sd[pre + f"mlp.experts.{e}.{hf}.weight"] = m[key][j, e]
    return sd


def dsv2_config_json(cfg):
    c = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    c["num_experts_per_tok"] = c.pop("num_experts_per_token")
    return {**c, "model_type": "deepseek_v2", "architectures": ["DeepseekV2ForCausalLM"],
            "q_lora_rank": None, "scoring_func": "softmax", "topk_method": "greedy",
            "torch_dtype": "bfloat16"}


def dsv2_checkpoint(v2, contract, cfg, params, d, kernels):
    """[28d]: the dense layer 0 and the first MoE layer at full width as an
    HF checkpoint written by the smoke's writer into ``d``; loaded through
    ``start_engine(path)`` bit for bit; its ids against an in-memory
    engine's on the same tensors; then the CLI's ``build_engine`` behind
    ``OpenAIApp`` + ``httpd`` (``SimTokenizer``) answers the short request
    with the same ids. Returns the record."""
    from pegainfer_tpu_torch.server import httpd
    from pegainfer_tpu_torch.server import main as server_main
    from pegainfer_tpu_torch.server.api import OpenAIApp
    from pegainfer_tpu_torch.server.tokenizer import SimTokenizer

    L = DSV2_CKPT_LAYERS
    cfg2 = dsv2_config(v2, L)
    log(f"[28d] a {L}-layer cut at full width (the dense layer 0, one MoE layer) as an HF "
        f"checkpoint, through start_engine(path) and the CLI; card: {card_line()}")
    sd = dsv2_hf_state_dict(cfg, params, L)
    need = sum(t.numel() * t.element_size() for t in sd.values())
    free = shutil.disk_usage(d).free
    if free < need * 1.05:
        raise SystemExit(f"[28d] {d} has {free / 1e9:.1f} GB free, the checkpoint needs "
                         f"{need / 1e9:.2f} GB")
    t = time.perf_counter()
    (Path(d) / "config.json").write_text(json.dumps(dsv2_config_json(cfg2)))
    write_safetensors(str(Path(d) / "model.safetensors"), sd)
    write_s = time.perf_counter() - t
    nbytes = os.path.getsize(Path(d) / "model.safetensors")
    n_tensors = len(sd)
    log(f"  wrote {n_tensors} tensors, {nbytes / 1e9:.3f} GB in {write_s:.2f} s ({free / 1e9:.1f} "
        "GB were free)")
    del sd
    if v2.DSv2LiteConfig.from_model_path(d) != cfg2 or not v2.probe_model(d):
        raise SystemExit("[28d] config.json does not read back as the cut config")
    Ld = cfg.first_k_dense_replace
    cut = {"embed": params["embed"], "attn": {k: v[:L] for k, v in params["attn"].items()},
           "dense": params["dense"], "moe": {k: v[:L - Ld] for k, v in params["moe"].items()},
           "final_ln": params["final_ln"], "lm_head": params["lm_head"]}
    opts = contract.EngineLoadOptions(max_batch_size=DSV2_SLOTS, seed=SEED)
    handle, load = timed_load("start_engine(path)", lambda: v2.start_engine(d, opts, device="cuda"),
                              nbytes)
    loaded = handle._scheduler.executor.params
    bad = leaves_differing(loaded, cut)
    log(f"  the loaded tree against the cut, leaf by leaf: bit for bit {not bad}")
    if bad:
        handle.shutdown()
        raise SystemExit(f"[28d] the loaded leaves differ: {bad[:8]}")
    del loaded
    rng = np.random.default_rng(SEED + 282)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in DSV2_CKPT_REQUESTS]
    for mod in kernels.values():
        mod.launches = 0

    def serve(h):
        try:
            return [greedy_tokens(contract, h, p, m) for p, (_, m) in zip(prompts,
                                                                          DSV2_CKPT_REQUESTS)]
        finally:
            h.shutdown()
            h._thread.join(timeout=60)

    disk = serve(handle)
    mem = serve(v2.start_engine_from_params(cfg2, cut, opts, device="cuda"))
    log(f"  ids from the path equal the in-memory engine's: {disk == mem}")
    if disk != mem:
        raise SystemExit("[28d] the checkpoint engine's ids differ from the in-memory engine's")
    argv = ["--model-path", d, "--max-batch-size", str(DSV2_SLOTS), "--seed", str(SEED)]
    t = time.perf_counter()
    cli = server_main.build_engine(server_main.parse_args(argv), device="cuda")
    start_s = time.perf_counter() - t
    try:
        app = OpenAIApp(cli, SimTokenizer(vocab_size=cfg.vocab_size), "dsv2-lite").build()
        server = httpd.serve(app, "127.0.0.1", 0, threads=64)
        try:
            status, _, body, wall = http_call(server.port, "POST", "/v1/completions", {
                "prompt": prompts[1], "max_tokens": DSV2_CKPT_REQUESTS[1][1],
                "ignore_eos": True})
        finally:
            server.close()
    finally:
        cli.shutdown()
        cli._thread.join(timeout=60)
    ids = text_ids(body["choices"][0]["text"]) if status == 200 else None
    log(f"  the CLI's build_engine up in {start_s:.2f} s; /v1/completions "
        f"{DSV2_CKPT_REQUESTS[1][0]}/{DSV2_CKPT_REQUESTS[1][1]}: status {status}, ids equal the "
        f"path's: {ids == disk[1]}; wall {wall * 1e3:.1f} ms")
    if ids != disk[1]:
        raise SystemExit(f"[28d] the CLI's engine answered {status} {body}")
    launches = {name: mod.launches for name, mod in kernels.items()}
    if any(launches.values()):
        raise SystemExit(f"[28d] a K1-K9 kernel ran on the DSv2-Lite path: {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": L, "bytes": nbytes, "tensors": n_tensors, "write_s": write_s,
            "load": load, "tokens_equal": True, "cli": {"engine_start_s": start_s,
                                                        "status": status, "wall_ms": wall * 1e3}}



if __name__ == "__main__":
    sys.exit(main())
