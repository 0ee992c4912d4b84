"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU — sealed VGG-16
serving, the serving engine over VGG-16 and VGG-19, the c-GAN adversary
and Algorithm 1 with the partition they choose, SmolLM-135M: private
token generation, the LM forward, engine-served LM requests and token
streams, sampling, ``generate_origami`` and the token-recovery probe,
Qwen3-MoE-235B-A22B at full width: its MoE layer, the LM forward,
engine-served requests and ``generate_origami``, at full width and
depth Yi-9B and MiniCPM3-4B (Multi-head Latent Attention) through private
token generation and Qwen2.5-14B (QKV biases) through the LM forward, and
the recurrent Zamba2-1.2B and xLSTM-1.3B through the LM forward, open
generation and (Zamba2) the engine, and the cross-attention
Llama-3.2-Vision-11B and Whisper-small through the private LM forward,
the prompt pass and decode, and the training of SmolLM-135M, MiniCPM3-4B
and Zamba2-1.2B through the trainer, and SmolLM-135M through the
trainer on a device mesh — and hold every kernel of them
against its plain PyTorch version.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure is fatal and exits non-zero):

1. card and build — the card's name and power limit; nvcc builds the
   kernel library from ``src/repro_torch/kernels/csrc`` (one process per
   source, in parallel); each kernel's registers and stack and local
   (spill) bytes, from ``cuobjdump -res-usage``;
2. kernels — each of the six kernels (blind_encode, limb_matmul,
   limb_matmul_fused, limb_fold, blind, unblind) at the VGG-16 tier-1
   shapes of a batch of 4, bit-for-bit against its plain version on the
   card, with its time (CUDA events, median of 10 after warm-up) and its
   device time (``torch.profiler``, 10 calls back to back), the plain
   version's time, the card's bound for the same work and, for the
   matmuls, nine ``torch._int_mm`` calls of one limb pair as a library
   yardstick, timed with B row-major and column-major (the faster
   layout's sum is the library time); the fused kernel also bit-equal
   to its plain version for u drawn over all of int32 (the reference's
   epilogue wraps in int32); then, on lines of their own, the
   three field-product kernels at the SmolLM-135M shapes, bit-for-bit
   against their plain versions: limb_matmul (decode and prefill factors,
   fold material), limb_matmul_fused (the gate/up op in a token step and
   in the prompt pass, with the ``_int_mm`` yardstick at the prefill) and
   limb_fold (that op's check, [y | x] of 2112 digits, k = 2);
3. fused serving — a full-width VGG-16 (224x224, 1000 classes, random
   weights from a seed) behind ``PrivateInferenceServer`` with tier-1
   blinded and Freivalds-verified (full, k=2): sealed requests, one
   tampered, served twice (cold, then with the next session's factors
   prefetched) with the kernel launch counts read around exactly those
   calls; the logits must be bit-equal to the enclave recompute and within
   5% of the plain float forward;
4. where the time goes — a warm batch split into session factors, the
   blinded infer and its float tier-2;
5. unfused serving — the same requests behind ``impl="unfused"`` (blind,
   limb matmul and unblind kernels; checks in the blinded domain), cold
   then warm, with the launch counts read around exactly those calls;
6. dishonest device — every fault kind on both data paths under full
   verification: each check fails exactly where the injector corrupted;
7. recovery — a server behind a stale-replaying device: one device retry,
   one enclave recompute, logits bit-equal to the honest server's;
8. offload plane — a pool of two simulated slots on the card, slot 1
   dishonest, in "rows" and "shares" modes: bit-equal to the pool-less
   executor, the failed shards recovered, slot 1 quarantined, no dispatch
   crashed or timed out;
9. flash attention — the kernel against its plain version (float32
   matmuls, TF32 off) at the SmolLM-135M prefill shape (batch 4, 1024
   tokens, 9 query and 3 KV heads of 64, bf16, causal, 2e-2), the
   shapes the LM phases and the token probe give it, and a sweep
   (float32 at 2e-5, non-causal, MHA, ragged 6 and 1000 tokens); at head
   width 128 the Qwen3-MoE prefill (4 x 1024, 64 query and 4 KV heads),
   the MoE engine's buckets (2 x 32, 1 x 128) and a sweep (float32 2 x
   256 with 8/2 heads at 2e-5, non-causal, ragged 1000); Yi-9B's
   (32/4 heads of 128) and Qwen2.5-14B's (40/8, five query heads a KV
   head: one head a CTA) prompt passes at 4 x 1024 and 4 x 256; and
   MiniCPM3's MLA, q/k 96 against v 64 with 40 heads of one KV head each,
   at 4 x 1024, 4 x 256 and 2 x 32, and a sweep (float32 at 2e-5,
   non-causal, ragged 1000; the smoke widths 48 against 32), each with
   its time and device time, the plain version's time, one
   ``scaled_dot_product_attention`` call's (timed only) and the card's
   bound; then the backward kernel (``flash_attention_bwd``) against its
   plain version (the materialized float32 formula) on the same
   residuals at SmolLM-135M's training shape (8 x 1024, 9/3 heads of 64,
   bf16, causal) and a sweep (float32, non-causal, G 1, ragged 1000 and
   6, D 128 at G 8, MLA's (96, 64) at 2 x 1024 and at MiniCPM3-4B's
   training shape, 8 x 1024, float32 (48, 32), the VLM's cross
   attention: 1024 queries against 1601 keys, non-causal, D 128 at G 4):
   dq, dk and dv each within a relative Frobenius 8e-3 (bf16) / 1e-5
   (float32) and 2e-2 / 1e-5 of its largest magnitude, two launches
   bit-equal, the forward's lse within 1e-5 of the plain one and its
   output bit-equal with and without the lse; each with its time and
   device time, the plain version's, one ``scaled_dot_product_attention``
   backward's (timed only) and the card's bound (2 (3 D + 2 Dv)
   operations a pair);
10. private generation — full-width, full-depth SmolLM-135M (random bf16
   weights from a seed) generating 4 tokens for a batch of 4 1024-token
   prompts through ``private_generate`` under full(k=2) verification:
   private and trusted logits and tokens bit-equal, every op checked and
   passing, the exact launch counts of the flash and field kernels, one
   private token step within 0.15 of the open float step (the bound of
   the reference's tests/test_generate.py), the first new token's logits
   within 0.25 of the open float prefill, no failed ring refill, a
   bit-flipping device caught op by op; prefill and per-token decode
   times;
11. planned serving (run after the plane, before generation) — the
   engine's device stage without its queues, on the same VGG-16 weights:
   ``PartitionPlanner.plan`` picks the partition on the card (its
   leakage profile, choice, feasible set and modeled runtime printed);
   the executor warms every bucket of ``bucket_ladder(4)`` and both
   trace kinds through a ``CompileCache`` as CUDA graphs (exactly 6
   captures); 5 sealed batches of 4 go through
   ``prepare_sealed_batch``/``complete_prepared_batch`` with keys from a
   ``SessionPool(depth=4)`` under a ``Tracer``. Gates: no request-path
   capture and no fallback; each batch's replay bit-equal to an eager
   infer of the same session in logits, boundary, report and launch
   counts, and to the enclave recompute; no failed refill; a re-issued
   key raises ``SessionReuseError``; the serving spans present and no
   inner span on a replay; on an eager run each ``kernel.*`` span count
   equal to its launches; the Chrome trace written by ``dump_chrome``
   parses and holds no tensor; a two-slot plane with
   slot 1 flipping bits logs a ``shard_*`` event for slot 1 in its
   ``FlightRecorder``; mixed and verified-open plans, eager and
   replayed, bit-equal to the trusted boundary with every check
   passing. Printed, not gated: eager and replayed infer times, the
   factor copy into the graph, the first request with and without
   ``warm_aot``, the device-busy share and top device ops of one infer
   from ``torch.profiler``, and ``planner.calibrate``'s fit;
12. engine serving (after planned serving, before generation) — one
   ``ServingEngine`` (max_batch 4, max_wait 50 ms, warm-up on) with a
   ``Tracer`` serves full-width VGG-16 and VGG-19 (weight seeds 0 and
   1, tier-1 = layers 1-6, full(k=2)): 16 sealed requests interleaved,
   8 a model, one of each model's tampered, then one lone request in
   bucket 1. Gates: every future resolves; exactly the tampered requests
   fail, with ``mac_failed`` (any other failure, such as a kernel error
   the device stage caught, is fatal); every other response bit-equal
   to a ``PrivateInferenceServer.serve_batch`` of the same model over
   the same groups; completions interleave the models; 12 captures at
   registration, none on the request path, no fallback; the same
   traffic on one stage (``pipeline=False``) bit-identical; a restart
   without warm-up captures its one graph on the request path and
   answers the same. Printed: requests/s and ms a request, p50 and p95
   latency, time to first batch cold and warm, batches and padded
   slots, the profiler's critical path, pipeline against one stage, the
   restart's capture, the device-busy share and top device ops of the
   traffic (``torch.profiler``);
13. chaos drill — VGG-16 on the engine over a two-slot simulated pool
   on the card, ``LivenessConfig(cold_timeout_s=2.0)``, the launcher's
   default schedule (slot 0 crashes and slot 1 hangs in batches 1-2,
   the session refills fail in 7-8, the request MACs flip in 10), 12
   batches of 4. Gates: every future resolves; the model degrades in
   the device window and recovers; the crash and the hang are
   contained; both breakers open and close again; the refill errors
   equal the injected faults; exactly the seal window's requests fail;
   every served logit bit-equal to an honest pool-less server. Both
   phases close their engines and fail if a thread an engine started
   is still alive.

14. lm infer (after generation) — full-width, full-depth SmolLM-135M
   (random bf16 weights, seed 0; as in 15-18) at p = 3 under full(k=2):
   ``OrigamiExecutor.infer`` on 4 x 256 tokens. Gates: blinded logits
   bit-equal to the trusted recompute; the tier-1 boundary within 0.25
   of the "split" plan's float boundary; 21/21 ops checked; exactly 21
   blind_encode, 21 fused, 42 limb_matmul (u and ws), 21 fold and 30
   flash launches; a bit-flipping device caught op by op. Printed:
   blinded, trusted and open float times (one timed run each) and the
   device-busy share of one blinded infer;
15. lm engine — the reference's LM bucket case at full width: an LM in a
   ``ServingEngine`` (``input_key="tokens"``, ``input_dtype="int32"``,
   max_batch 2), two sealed requests of 32 tokens and one of 128. Gates:
   two batches; every response opens to (tokens, padded vocab),
   bit-equal to an eager infer of its padded batch; no engine thread
   outlives ``close()``;
16. generate engine — ``GenerateExecutor`` (prompt 128, 8 new tokens)
   in a warmed engine (max_batch 4): 9 CUDA-graph captures at
   registration (per bucket the trusted prompt pass and the slot-fed and
   trusted token steps), none on the request path, no fallback; 4 sealed
   prompts served as streams equal to ``private_generate(trusted=True)``
   on the same batch; a replayed token step bit-equal to the eager
   ``decode_once`` in logits, caches, report and launches. Printed: the
   slot-fed token step eager and replayed (one timed run each) and the
   device-busy share of each, the capture time and the graph memory;
17. sampling — ``private_generate`` at temperature 0.8 (4 x 128 prompt,
   8 new): private tokens equal the trusted ones; ``categorical`` on
   the card equals it on the CPU for 8 keys;
18. generate_origami — a 2 x 16 prompt and 4 new tokens: one telemetry
   count per runtime op (7 x 3 x 19), exactly that many blind_encode,
   fused and limb_matmul launches, no other; one tiered step within
   0.15 of the open float step;
19. adversary parity (after planned serving, before engine serving) —
   the reference's ``test_adversary_reconstructs_shallow_layer`` case
   (smoke VGG-16 with the reference's seed-0 weights from
   ``init_params_keyed``, layer 1, 60 steps, batch 8, n_eval 32, seed
   0) trained on the card and on the CPU. Gate: the SSIM within 0.05,
   the final G loss within 1.5 and the D loss within 0.6 (the tolerances
   of tests/test_torch_adversary.py). Printed: each device's SSIM,
   losses, ms a step (D+G) and ms of ``collect_features`` a step;
20. algorithm 1 — ``partition_search`` on the full-width VGG-16 of the
   serving phases (224x224x3, 1000 classes), threshold 0.35,
   verify_depth 2, batch 16, n_eval 64, over the spatial boundaries
   (layers 1-18: from a 1x1 fc map the c-GAN's decoder reaches 128, not
   224 pixels); the walk's layers train on one set of images, drawn
   once and kept on the card. One short run on layer 1 times a step,
   and each layer gets the largest step count of 5 or more that keeps
   the longest walk (every layer) within 40 s, else 5 (60 and 80 s
   before the dense phases of 26-29 joined the script's time, and a
   floor of 30 steps until the script's depth was cut to keep it within
   its time limit); the predicted walk time is printed beside the
   5-step floor's.
   Printed: the SSIM a constant gray image scores, and one line per
   evaluated layer (kind, SSIM beside the gray image's, G and D loss, ms
   a step and of ``collect_features``). Gates: every SSIM
   finite and in [-1, 1], every loss finite; the returned p and the
   order of the evaluated layers are what Algorithm 1 gives on the
   printed SSIMs, recomputed here. Then ``PartitionPlanner.plan(cfg,
   params, leakage=<those SSIMs>)`` (summary printed) and one batch of
   4 through an ``OrigamiExecutor`` under its plan with
   ``precompute=True`` and full(k=2). Gates: blinded logits bit-equal to
   the enclave recompute; every op checked and passing; blind_encode,
   limb_matmul_fused and limb_fold each launched once per blinded op of
   the plan, read around exactly that call, and no kernel off the fused
   path;
21. token probe (after generate_origami) — ``token_recovery_probe`` with
   the reference's defaults (100 steps, batch 8, 32 tokens, lr 1e-2,
   seed 0) on the boundary after blocks 1-3 of the full SmolLM-135M
   (random bf16 weights, seed 0, open forward): the accuracy and its
   time, a reading not gated on its value. Gate: flash_attention
   launched once a block at each boundary the probe draws (3 x 101),
   at shapes the flash phase checks (8 x 32 and 32 x 32);
22. moe layer (after the token probe, the SmolLM weights freed) — one
   full-width Qwen3-MoE layer (128 experts of 4096 x 1536, top-8, bf16,
   seed 0): ``sorted_grouped`` on 4 x 1024 tokens twice bit-equal with no
   value read back to the host (CUDA sync debug mode "error"); on 2 x 256
   tokens at capacity factor 16 (no drops) within 2e-2 x max of
   ``gshard``. Printed: the assignments dropped at 1.25, the layer's time
   (CUDA events) beside its bound;
23. moe infer — Qwen3-MoE-235B-A22B at every published width, 6 of its 94
   blocks (tier-1 = blocks 1-4, all 128 experts; random bf16 weights,
   seed 0, as in 24-25), ``OrigamiExecutor.infer`` on 4 x 1024 tokens
   under full(k=2). Gates: blinded logits bit-equal to the trusted
   recompute; 16/16 ops checked; exactly 16 blind_encode, 16 fused, 32
   limb_matmul, 16 fold and 6 flash launches; a bit-flipping device
   caught op by op; the block-1 router logits within 0.25 of the "split"
   plan's float forward's (the 8-bit tier-1 activations flip near-tied
   top-8 choices, and a flip moves its group's capacity drops: most rows
   route differently somewhere in tier-1, so this gate replaces a share of
   flips) and the tier-1 boundary within 0.25 of the float one on the
   rows routed alike in every tier-1 block; the trusted forward at 2 x 32
   captured as a CUDA graph through a ``CompileCache`` and replayed
   bit-equal to the eager one. Printed: the rows routed differently and
   where, blinded, trusted and open times, the device-busy share;
24. moe engine — Qwen3-MoE in a ``ServingEngine`` (``input_key="tokens"``,
   max_batch 2): two sealed 32-token requests and one of 128, two
   batches, each response bit-equal to an eager infer of its padded
   batch; no engine thread outlives ``close()``;
25. moe generate_origami — a 2 x 32 prompt and 4 new tokens: one
   telemetry count per runtime op (4 x 4 x 35), exactly that many
   blind_encode, fused and limb_matmul launches, no other;
   ``private_generate`` and ``attach_decode_plan`` raise ``ScanExclusion``
   with the reference's reason; one tiered step of the prompt's 64 tokens
   against the open float step: the block-1 router logits within 0.25,
   the logits within 0.15 on the rows routed alike in every block.
   Printed: ms a step, open ``generate``'s wall for the same prompt;
26. yi generate (after the MoE phases, their weights freed; each of 26-29
   makes its model's random bf16 weights from seed 0 at every published
   width and depth, prints the set-up time, and frees them after) —
   Yi-9B (48 layers, d 4096, 32/4 heads of 128, 8.83 B parameters)
   through ``private_generate`` on 4 x 1024-token prompts, 4 new tokens,
   tier-1 = blocks 1-4, full(k=2): the gates of phase 10 (28 blinded ops
   a pass, 48 flash launches a prompt pass), its breakdown, then
   ``warm_decode_aot`` through a ``CompileCache`` (3 captures) and a
   slot-fed token step replayed bit-equal to the eager ``decode_once``
   in logits, caches, report and launches. Printed: the prompt pass, ms
   a token step with and without the ring, eager and replayed, busy
   shares, peak memory;
27. qwen2.5 infer — Qwen2.5-14B (48 layers, d 5120, 40/8 heads of 128,
   14.77 B parameters) with its QKV biases drawn non-zero from the seed
   (the reference's init zeroes them): ``OrigamiExecutor.infer`` on 4 x
   256 tokens at p = 4 under full(k=2) with the gates of phase 14 (28
   ops, 48 flash launches);
28. mla generate — MiniCPM3-4B (62 layers, d 2560, 40 heads, MLA: q rank
   768, kv rank 256, q/k 64 + 32 rope, v 64; 4.26 B parameters) through
   ``private_generate`` as in 26, the absorbed decode: 32 blinded ops in
   the prompt pass, 28 a token step (``wkv_b`` is read in the enclave),
   62 flash launches a prompt pass and none in a token step; the cache
   is the latent (62, 4, 1028, 288) with no v (its bytes printed beside
   a GQA cache of 40 heads); the replayed slot-fed step bit-equal to the
   eager one; the absorbed attention's float32 einsums timed apart
   against the token step;
29. mla infer and generate_origami — MiniCPM3-4B: ``infer`` on 4 x 256
   (blinded == trusted, 32/32 checked, exact launches, flash 62, the
   boundary within 0.25 of the split plan's, a bit_flip drill) and
   ``generate_origami`` on a 2 x 16 prompt with 4 new tokens (7 x 4 x
   19 counts and exactly that many blind_encode, fused and limb_matmul
   launches; one tiered step within 0.15 of the open float step);
30. zamba2 (after phase 29, each of 30-31 making its model's
   random bf16 weights from seed 0 at every published width and depth
   and freeing them after) — Zamba2-1.2B (38 Mamba2 blocks of d 2048,
   64 heads of state 64, one shared attention block of 32/32 heads of 64
   after each complete group of 6; 1.15 B parameters):
   ``OrigamiExecutor.infer`` on 4 x 1024 tokens at p = 3 under full(k=2)
   (blinded == trusted in logits and boundary, 6/6 ops checked: the
   blocks' ``in_proj`` and ``out_proj``; exactly 6 blind_encode, fused
   and fold, 12 limb_matmul and 6 flash launches, all flash in tier-2; a
   bit_flip drill); the engine's sealed requests of 32, 32 and 128
   tokens, each bit-equal to an eager infer; then open ``generate`` on a
   4 x 128 prompt with 8 new tokens: the prompt pass replayed as one captured decode step
   (``RecurrentStep``) bit-equal to the eager pass over its first 16
   positions in logits and state, its last logits within 0.06 + 0.06 x
   |forward| of the teacher-forced forward's with float32 weights (the
   bound of the reference's tests/test_ssm.py; the bf16 gap printed), the
   first new token the prompt pass's greedy pick (the float32 gate turns
   the weights float32 in place, so it comes last). Printed: blinded,
   trusted and open ms (one timed run each), busy shares, the
   tier-1 boundary's distance from the float one (not gated: 8-bit
   activations of heavy-tailed Mamba2 outputs), peak memory, the prompt
   pass's ms a token eager and replayed;
31. xlstm — xLSTM-1.3B (6 groups of 7 mLSTM blocks, 4 heads of 1024, and
   one sLSTM block; 1.99 B parameters): ``infer`` as in 30 with 12/12
   ops checked (the mLSTM blocks' ``w_up``, gates and ``w_down``) and no
   flash launch; the sLSTM blocks' share of an open forward (CUDA events
   around each block); open ``generate`` as in 30;
32. vlm (after phase 31, each of 32-33 making its model's random bf16
   weights from seed 0 at every published width and depth, the VLM's
   cross-block gates, zero at init, drawn from U(0.25, 0.75), and
   freeing them after) — Llama-3.2-Vision-11B (8 groups of 4 self blocks
   and a gated cross block, d 4096, 32/8 heads of 128; 9.78 B
   parameters): ``OrigamiExecutor.infer`` on 4 x 1024 tokens and 4 x 1601
   float32 patches from N(0, 0.1^2) at p = 4 under full(k=2) (the gates
   of phase 30: blinded == trusted, 28/28 ops checked, exactly 28
   blind_encode, fused and fold, 56 limb_matmul and 40 flash launches: 32
   causal self attentions and 8 non-causal cross attentions over 1601
   keys in float32, ``sdpa`` promoting the bf16 queries); then
   ``prefill_vlm`` on the 4 x 1024 prompt and 8 greedy ``decode_step``
   tokens, each step's logits and the prompt pass's last against the
   teacher-forced forward over the same tokens, within 0.05 + 0.05 x
   |forward| (the bound of the reference's tests/test_attention.py): in
   bf16 against the forward fed the patches in bf16, as ``prefill_vlm``
   casts them (the cross attentions through the bf16 kernel on both
   sides, the steps at one query), and with float32 weights; the bf16
   run's gap to the forward over float32 patches (its cross attentions
   float32) printed. Printed: blinded, trusted and open ms, busy shares,
   the boundary's distance from the float one, peak memory, the prompt
   pass's ms and ms a token;
33. whisper — Whisper-small (12 encoder and 12 decoder blocks, d 768, 12
   heads of 64; 0.24 B parameters): ``infer`` on 4 x 448 tokens and 4 x
   1500 frames at p = 2 (12/12 ops checked, 36 flash launches: 12
   non-causal encoder, 12 causal decoder and 12 cross attentions over
   1500 frames); audio ``prefill`` on 4 x 64 tokens and 8 greedy
   ``decode_step`` tokens, with the readings and the bound of 32;
34. train (last) — SmolLM-135M at every width and depth (random bf16
   weights from the reference's keyed init, seed 0) through
   ``launch/train.py:train`` on the pipeline's batches of 8 x 1024
   tokens, ``TrainConfig(learning_rate=1e-3, warmup_steps=5,
   total_steps=30)``: (b) 10 steps, every loss finite and the last below
   the first by more than 0.2 (the reference test's margin), exactly 60
   flash (remat runs each block's forward twice) and 30
   flash_attention_bwd launches a step and no other kernel; each step's
   time and the peak memory printed; (c) one batch's gradients with the
   kernels against the plain attention (forward and backward) in float32
   weights with TF32 off, each leaf within a relative Frobenius 1e-4; in
   bf16 every backward call held against the plain backward on its own
   inputs (8e-3), two gradients bit-equal, the gap to the plain
   attention's gradient printed; (d) 4 steps straight against 2, an
   ``AsyncCheckpointer`` save and a resume to 4: parameters and
   optimizer state bit-equal; (e) one step at 2 microbatches: its loss
   within 5e-2 of the step at 1; after (b), one step under
   ``torch.profiler``: its device-busy share beside the median step time
   of (b), the flash backward's device ms and the top device ops, printed;
35. train families (after 34) — MiniCPM3-4B (MLA; bf16 AdamW moments,
   the reference's choice for very large models) and Zamba2-1.2B (Mamba2
   blocks, whose chunked scan's backward runs through autograd, and the
   shared attention block; float32 moments) at every width and depth, each
   through 34's (b) and (c) with 5 steps, and (c)'s gradients at 2 x 1024:
   the loss falling by more than 0.2, exactly 124 flash and 62
   flash_attention_bwd launches a step for MiniCPM3 (62 blocks under
   remat) and 6 and 6 for Zamba2 (its shared block after each of 6 groups,
   outside remat), and no other kernel; the keyed init's seconds and
   peak, the run's peak memory, the busy share and top device ops
   printed; float32 gradients within 1e-4 of the plain attention's, every
   bf16 backward call within 8e-3 of the plain backward, two bf16
   gradients bit-equal. The resume and microbatch checks are 34's alone.
36. train mesh (after 35) — SmolLM-135M at every width and depth through
   ``train(mesh=make_host_mesh(1, 1))``: the mesh starts a one-rank NCCL
   process group (never gloo on the card), destroyed at the phase's end;
   parameters, AdamW state and batches are DTensors laid out by the
   reference's train plan, and attention runs the flash kernels on each
   rank's local shards through ``local_map``. (a) 4 steps of 8 x 1024
   under 34's ``TrainConfig``, against the same 4 steps through
   ``train(device="cuda")``: losses, parameters and optimizer state
   bit-equal, exactly 60 flash and 30 flash_attention_bwd launches a step
   and no other kernel; each run's ms a step and one step's device-busy
   share printed side by side; (b) ``compressed_psum`` over the mesh's
   "data" group on NCCL of a (4096, 4096) float32 tensor from a numpy
   seed, bit-equal to ``compress_decompress`` of it, no kernel launched;
   (c) a 2-step mesh run saved by ``AsyncCheckpointer`` (the state of
   (a) at step 2), reloaded by the trainer's resume with ``load(...,
   shardings=)`` of the plan over ``remesh(plan_degraded_mesh(1))`` and
   resumed to step 4: losses, parameters and optimizer state bit-equal
   to (a)'s straight run.

The kernels phase also checks every field kernel and ``blind_encode`` at
the Qwen3-MoE projections (q 4096 x 8192, k/v 4096 x 512, o 8192 x 4096)
at the rows phases 23-25 give them (2, 64, 128, 4096), at the tier-1
projections of Yi-9B, Qwen2.5-14B (K up to 13,824) and MiniCPM3-4B (N
down to 288) at 4, 64, 1024 and 4096 rows (MiniCPM3 also 2), and at
Zamba2's (``in_proj`` N 8384, ``out_proj``; 64, 128 and 4096 rows) and
xLSTM's (``w_up``, the gates at N 4, ``w_down``; 4096 rows); the three
field-product kernels at N 4 and N 8384 are also timed on lines of their
own beside their plain versions, the bound and ``_int_mm``. Flash runs at
Zamba2's shapes (G 1 at D 64: 4 x 1024, 2 x 32, 1 x 128, float32). For
phases 32-33 the kernels phase checks the field kernels at
Llama-3.2-Vision's tier-1 projections (q/o 4096 x 4096, k/v 4096 x 1024,
gate/up 4096 x 14336, down 14336 x 4096) and Whisper's encoder's (768 x
768, 768 x 3072, 3072 x 768) at the rows of phases 32 and 33 (4096 and
6000), and the flash phase at their attention shapes: the VLM's causal
self attention (4 x 1024, 32/8 heads of 128, G 4), its cross attention
over 1601 patches in float32 (the forward) and bf16 (``prefill_vlm``) and
at one query (decode, bf16 and float32), Whisper's encoder (1500 x 1500,
non-causal), decoder (448 causal; the 64-token prompt) and cross
attention (448, 64 and one query against 1500 frames), each also within a
relative Frobenius error of the plain version's float32 result (8e-3
bf16, 1e-4 float32) that an unmasked last key tile exceeds: for each
non-causal ragged case the plain version over keys zero-padded to a
multiple of 64 is shown failing that bound. One query at G 8, D 128
(Yi's heads, 4 x 1 against 1024 keys) joins them: the bf16 calls at one
query take the split-KV decode route (``flash_attention_decode.cu``,
both passes timed as one call), and their lines print its split count.

Phases 3, 5-8, 10-18, 20, 21 and 23-36 each read the launch counts around
exactly the calls they drive and fail unless their path launched its
kernels and no other (22 launches none); only 34-36 launch the
backward.

Prints the findings, then a JSON line of the kernels, then as its last
line ``{"ok": true, "device": {...}}``.
"""
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.integrity import IntegrityPolicy  # noqa: E402
from repro_torch.core.prng import PRNGKey  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.kernels import build as KB  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.kernels.blind.blind import (blind,  # noqa: E402
                                             blind_encode, blind_encode_plain,
                                             blind_plain, unblind,
                                             unblind_plain)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    decode_splits, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_plain)
from repro_torch.kernels.limb_matmul import ops, ref  # noqa: E402
from repro_torch.kernels.limb_matmul.fold import (  # noqa: E402
    limb_fold_planes, limb_fold_planes_plain)
from repro_torch.kernels.limb_matmul.limb_matmul import (  # noqa: E402
    limb_matmul_planes, limb_matmul_planes_fused,
    limb_matmul_planes_fused_plain, limb_matmul_planes_plain)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.runtime.aot import bucket_ladder  # noqa: E402
from repro_torch.runtime.devices import DevicePool  # noqa: E402
from repro_torch.runtime.faults import (KINDS, DishonestDevice,  # noqa: E402
                                        FaultSpec)
from repro_torch.runtime.generate import (generate,  # noqa: E402
                                          private_generate)
from repro_torch.runtime.sessions import TokenSlotRing  # noqa: E402
from repro_torch.runtime.serving import (PrivateInferenceServer,  # noqa: E402
                                         Request)

BATCH = 4
SEED = 0
# H100 SXM published peaks (dense): int8, bf16 and TF32 tensor cores,
# float32 outside the tensor cores, HBM3 bandwidth
INT8_OPS_S = 1979e12
BF16_OPS_S = 989e12
TF32_OPS_S = 495e12
F32_OPS_S = 67e12
BYTES_S = 3.35e12
REPLACES = {
    "blind_encode": "src/repro/kernels/blind/blind.py:82",
    "limb_matmul": "src/repro/kernels/limb_matmul/limb_matmul.py:110",
    "limb_matmul_fused": "src/repro/kernels/limb_matmul/limb_matmul.py:133",
    "limb_fold": "src/repro/kernels/limb_matmul/fold.py:37",
    "blind": "src/repro/kernels/blind/blind.py:106",
    "unblind": "src/repro/kernels/blind/blind.py:113",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:76",
    # no TPU kernel: the reference's custom VJP of its attention core
    "flash_attention_bwd": "src/repro/models/attention.py:151",
}
SOURCES = {
    "blind_encode": "src/repro_torch/kernels/csrc/blind_encode.cu",
    "limb_matmul": "src/repro_torch/kernels/csrc/limb_matmul.cu",
    "limb_matmul_fused": "src/repro_torch/kernels/csrc/limb_matmul.cu",
    "limb_fold": "src/repro_torch/kernels/csrc/limb_fold.cu",
    "blind": "src/repro_torch/kernels/csrc/blind.cu",
    "unblind": "src/repro_torch/kernels/csrc/blind.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
}
# the kernels each path launches (and no other): the fused and unfused
# data paths, and the offload plane over the fused path (blind on the
# enclave, the slots' limb matmuls, the shard checks' folds; the unblind is
# fused into the enclave's float epilogue)
FUSED_PATH = ("blind_encode", "limb_matmul", "limb_matmul_fused", "limb_fold")
# private decode: the fused path plus the prefill attention; the trusted
# oracle multiplies its own operands (limb matmul) and attends the same
GENERATE_PATH = FUSED_PATH + ("flash_attention",)
TRUSTED_GENERATE_PATH = ("limb_matmul", "flash_attention")
UNFUSED_PATH = ("blind", "limb_matmul", "limb_fold", "unblind")
PLANE_PATH = ("blind", "limb_matmul", "limb_fold")
# the kernels whose launches the JSON line reads on the unfused path (the
# rest on the fused one)
READ_ON_UNFUSED = ("limb_matmul", "blind", "unblind")


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel="", reps=10, windows=3):
    """Device milliseconds a call of ``fn`` from ``torch.profiler`` over
    ``reps`` calls launched back to back: of the kernels whose name holds
    ``kernel``, or of every kernel when it is empty. A window in which the
    profiler saw no such kernel is taken again, up to ``windows`` times;
    then None (not measured)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for ev in prof.key_averages():
            if kernel in ev.key:
                t = getattr(ev, "device_time_total", None)
                us += ev.cuda_time_total if t is None else t
        if us > 0.0:
            return us / reps / 1e3
    return None


def timed(fn, kernel=""):
    """(median event ms a call, profiler device ms a call) of ``fn``: the
    timing of every kernel and library call on the kernels' lines."""
    return cuda_ms(fn), device_ms(fn, kernel)


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def check_launches(launches, path, where):
    """Fail unless the counts show every kernel of ``path`` launched and
    no other kernel launched."""
    for name in KB.KERNELS:
        if name in path:
            assert launches[name] > 0, f"kernel {name} was not launched " \
                f"on the {where}"
        else:
            assert launches[name] == 0, f"the {where} launched {name}"


def counted(fn):
    """(launch counts, milliseconds, result) of ``fn``: the counts read
    from 0 around exactly this call, the time on the host clock,
    synchronized."""
    torch.cuda.synchronize()
    KB.reset_launches()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return dict(KB.LAUNCHES), (time.perf_counter() - t) * 1e3, out


def tier1_shapes(cfg):
    """(layer, t, K, N) of each blinded conv of tier-1 at batch BATCH."""
    shapes = V.feature_shapes(cfg)
    out = []
    for i in range(cfg.origami.tier1_layers):
        kind, n = V.layer_kind(cfg, i)
        if kind == "conv":
            h, w, c = shapes[i]
            out.append((f"l{i}", BATCH * h * w, 9 * c, n))
    return out


def phase_card_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    KB.lib()
    print(f"build: kernel library ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {KB.build_seconds:.2f} s)")
    print("registers a thread, stack and local (spill) bytes of each kernel: "
          + "; ".join(f"{name} REG {r} STACK {s} LOCAL {loc}"
                      for name, r, s, loc in resource_usage()))
    return card


def resource_usage():
    """(kernel, registers, stack bytes, local bytes) of every kernel in the
    built library, from ``cuobjdump -res-usage``."""
    dump = subprocess.run([KB.cuda_tool("cuobjdump"), "-res-usage",
                           str(KB.build())], capture_output=True, text=True,
                          check=True).stdout
    rows, name = [], None
    for line in dump.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            name = line[len("Function "):].rstrip(":")
        elif name and line.startswith("REG:"):
            f = dict(kv.split(":", 1) for kv in line.split()
                     if kv.split(":", 1)[0] in ("REG", "STACK", "LOCAL"))
            rows.append((name, f["REG"], f["STACK"], f["LOCAL"]))
            name = None
    names = subprocess.run([KB.cuda_tool("cu++filt")],
                           input="\n".join(r[0] for r in rows),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return [(_kernel_name(n),) + r[1:] for n, r in zip(names, rows)]


def _kernel_name(demangled):
    """"void <unnamed>::kernel<(bool)1, 64>(int const*, ...)" -> the kernel
    and its template arguments, "kernel<(bool)1, 64>"."""
    depth = 0
    for i in range(len(demangled) - 1, -1, -1):   # the parameter list's "("
        depth += {")": 1, "(": -1}.get(demangled[i], 0)
        if depth == 0:
            break
    name = demangled[:i].removeprefix("void ")
    for anonymous in ("<unnamed>::", "(anonymous namespace)::"):
        name = name.replace(anonymous, "")
    return name


def phase_kernels(cfg, dev):
    """Each kernel against its plain version at the tier-1 shapes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    acc = {name: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                  "library_ms": None, "bytes": 0, "ops": 0,
                  "peak": INT8_OPS_S, "err": 0.0}
           for name in KB.KERNELS if not name.startswith("flash_attention")}
    for name in ("blind_encode", "blind", "unblind"):
        acc[name]["peak"] = F32_OPS_S
    lib_sums = {"row-major": 0.0, "column-major": 0.0}
    lib_device = {"row-major": 0.0, "column-major": 0.0}

    def dsum(total, ms):
        return None if total is None or ms is None else total + ms

    def add(name, ms, dms, plain_ms, nbytes, nops, err):
        a = acc[name]
        a["ms"] += ms
        a["device_ms"] = dsum(a["device_ms"], dms)
        a["plain_ms"] += plain_ms
        a["bytes"] += nbytes
        a["ops"] += nops
        a["err"] = max(a["err"], err)

    def compare(name, got, want):
        if not torch.equal(got, want):
            diff = (got.double() - want.double()).abs().max().item()
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {diff})")
        return 0.0

    for layer, M, K, N in tier1_shapes(cfg):
        Kp = ops.block_plan(M, K, N)[4]
        x = torch.randn((M, K), generator=gen, device=dev)
        r = torch.randint(0, ref.P, (M, K), generator=gen, device=dev,
                          dtype=torch.int32)
        w_q = ref.from_signed(torch.randint(-128, 128, (K, N), generator=gen,
                                            device=dev, dtype=torch.int32))
        inv = (1.0 / x.abs().max()).reshape(())
        scale = torch.tensor(3.1e-6, device=dev)
        wl = ops.encode_weight_planes(w_q)

        # blind_encode
        xl = blind_encode(x, r, inv, 8, Kp)
        err = compare("blind_encode", xl, blind_encode_plain(x, r, inv, 8, Kp))
        ms, dms = timed(lambda: blind_encode(x, r, inv, 8, Kp),
                        "blind_encode_kernel")
        pms = cuda_ms(lambda: blind_encode_plain(x, r, inv, 8, Kp), reps=5)
        add("blind_encode", ms, dms, pms, 8 * M * K + 3 * M * Kp + 4,
            2 * M * K, err)
        print(f"blind_encode {layer} ({M}x{K} -> 3x{M}x{Kp}): {ms:.3f} ms "
              f"(device {fmt_ms(dms)}), plain {pms:.3f} ms")

        # library yardstick: nine int8 GEMMs of one limb pair, with B
        # row-major as the planes lie and column-major ("TN", the layout
        # of cuBLASLt's int8 tensor-core kernels); the faster layout's sum
        # is library_ms
        a8, b8 = xl[0], wl[0]
        b8_col = b8.t().contiguous().t()
        lib_row, dev_row = timed(lambda: [torch._int_mm(a8, b8)
                                          for _ in range(9)])
        lib_col, dev_col = timed(lambda: [torch._int_mm(a8, b8_col)
                                          for _ in range(9)])
        lib_sums["row-major"] += lib_row
        lib_sums["column-major"] += lib_col
        lib_device["row-major"] = dsum(lib_device["row-major"], dev_row)
        lib_device["column-major"] = dsum(lib_device["column-major"],
                                          dev_col)
        mm_ops = 18 * M * Kp * N

        # limb_matmul (the u = r @ W_q product)
        xr = ops.field_planes(r, Kp)
        got = limb_matmul_planes(xr, wl)
        err = compare("limb_matmul", got, limb_matmul_planes_plain(xr, wl))
        u = got
        ms, dms = timed(lambda: limb_matmul_planes(xr, wl),
                        "limb_matmul_mma_kernel")
        pms = cuda_ms(lambda: limb_matmul_planes_plain(xr, wl), reps=5)
        add("limb_matmul", ms, dms, pms,
            3 * M * Kp + 3 * Kp * N + 4 * M * N, mm_ops, err)
        print(f"limb_matmul {layer} ({M}x{Kp}x{N}): {ms:.3f} ms (device "
              f"{fmt_ms(dms)}), plain {pms:.3f} ms, 9x _int_mm {lib_row:.3f} "
              f"ms (device {fmt_ms(dev_row)}) with B row-major, "
              f"{lib_col:.3f} ms (device {fmt_ms(dev_col)}) with B "
              f"column-major")

        # limb_matmul_fused
        got = limb_matmul_planes_fused(xl, wl, u, scale)
        want = limb_matmul_planes_fused_plain(xl, wl, u, scale)
        err = compare("limb_matmul_fused", got, want)
        if not torch.isfinite(got).all():
            raise AssertionError("limb_matmul_fused: non-finite output")
        ms, dms = timed(lambda: limb_matmul_planes_fused(xl, wl, u, scale),
                        "limb_matmul_fused_mma_kernel")
        pms = cuda_ms(lambda: limb_matmul_planes_fused_plain(xl, wl, u, scale),
                      reps=5)
        add("limb_matmul_fused", ms, dms, pms,
            3 * M * Kp + 3 * Kp * N + 8 * M * N + 4, mm_ops, err)
        # the epilogue's contract holds for any int32 u, not only [0, p)
        u_any = torch.randint(-(2 ** 31), 2 ** 31, (M, N), generator=gen,
                              device=dev, dtype=torch.int64).to(torch.int32)
        compare("limb_matmul_fused (u over int32)",
                limb_matmul_planes_fused(xl, wl, u_any, scale),
                limb_matmul_planes_fused_plain(xl, wl, u_any, scale))
        print(f"limb_matmul_fused {layer} ({M}x{Kp}x{N}): {ms:.3f} ms "
              f"(device {fmt_ms(dms)}), plain {pms:.3f} ms; bit-equal for u "
              f"in [0, p) and over int32")

        # limb_fold: [y | x] against a k=2 fold matrix
        yx = torch.cat([u, r], dim=1)
        s = torch.randint(0, ref.P, (N + K, 2), generator=gen, device=dev,
                          dtype=torch.int32)
        sl = ops.encode_weight_planes(s)
        fl = ops.field_planes(yx, sl.shape[1])
        got = limb_fold_planes(fl, sl)
        err = compare("limb_fold", got, limb_fold_planes_plain(fl, sl))
        ms, dms = timed(lambda: limb_fold_planes(fl, sl),
                        "limb_fold_mma_kernel")
        pms = cuda_ms(lambda: limb_fold_planes_plain(fl, sl), reps=5)
        Kf = sl.shape[1]
        add("limb_fold", ms, dms, pms, 3 * M * Kf + 3 * Kf * 2 + 4 * M * 2,
            18 * M * Kf * 2, err)
        print(f"limb_fold {layer} ({M}x{Kf}x2): {ms:.3f} ms (device "
              f"{fmt_ms(dms)}), plain {pms:.3f} ms")

        # blind: the unfused path's operand over its scale, and its pad
        xs = x * 3.0
        got = blind(xs, r, 8)
        err = compare("blind", got, blind_plain(xs, r, 8))
        ms, dms = timed(lambda: blind(xs, r, 8), "blind_kernel")
        pms = cuda_ms(lambda: blind_plain(xs, r, 8), reps=5)
        add("blind", ms, dms, pms, 12 * M * K, 2 * M * K, err)
        print(f"blind {layer} ({M}x{K}): {ms:.3f} ms (device {fmt_ms(dms)}), "
              f"plain {pms:.3f} ms")

        # unblind: a field result of the layer's width against its factor
        yb = torch.randint(0, ref.P, (M, N), generator=gen, device=dev,
                           dtype=torch.int32)
        got = unblind(yb, u, 15)
        err = compare("unblind", got, unblind_plain(yb, u, 15))
        if not torch.isfinite(got).all():
            raise AssertionError("unblind: non-finite output")
        ms, dms = timed(lambda: unblind(yb, u, 15), "unblind_kernel")
        pms = cuda_ms(lambda: unblind_plain(yb, u, 15), reps=5)
        add("unblind", ms, dms, pms, 12 * M * N, M * N, err)
        print(f"unblind {layer} ({M}x{N}): {ms:.3f} ms (device "
              f"{fmt_ms(dms)}), plain {pms:.3f} ms")
        del x, r, xl, xr, u, yx, fl, xs, yb, got
    layout = min(lib_sums, key=lib_sums.get)
    for name in ("limb_matmul", "limb_matmul_fused"):
        acc[name]["library_ms"] = lib_sums[layout]
    print(f"library yardstick, 9x _int_mm summed over the shapes: "
          f"{lib_sums['row-major']:.3f} ms (device "
          f"{fmt_ms(lib_device['row-major'])}) with B row-major, "
          f"{lib_sums['column-major']:.3f} ms (device "
          f"{fmt_ms(lib_device['column-major'])}) with B column-major; "
          f"library_ms takes {layout}")
    print("device time (torch.profiler) summed over the shapes: "
          + "; ".join(f"{name} {fmt_ms(a['device_ms'])}"
                      for name, a in acc.items()))
    phase_lm_limb_shapes(gen, dev)
    torch.cuda.empty_cache()
    return acc


# (label, M, K, N) of the SmolLM-135M tier-1 field products at batch 4:
# the widest decode factor u = r @ W_q (gate and up), the prefill factor of
# a 1024-token prompt, and the fold material ws = W_q @ s
LM_LIMB_SHAPES = (("decode factor", 4, 576, 1536),
                  ("prefill factor", 4096, 576, 1536),
                  ("fold material", 1536, 576, 2))
# (label, M, K, N) of the widest SmolLM-135M blinded op (gate and up) as
# the fused kernel serves it, in a token step and in the prompt pass
LM_FUSED_SHAPES = (("decode op", 4, 576, 1536),
                   ("prefill op", 4096, 576, 1536))
# (label, M, Kf, kf) of its check: [y | x] is K + N = 2112 digits wide,
# folded against k = 2 columns
LM_FOLD_SHAPES = (("decode check", 4, 2112, 2),
                  ("prefill check", 4096, 2112, 2))


# the SmolLM-135M tier-1 projections (label, d_in, d_out) and the row
# counts the LM serving phases give them: 1 and 2 (bucket-1 and bucket-2
# token steps, generate_origami), 4 (a batch-4 token step), 64 and 128
# (lm engine's buckets), 128, 256 and 512 (the 128-token prompt pass at
# buckets 1, 2 and 4), 1024 (lm infer's 4 x 256)
LM_PROJECTIONS = (("q/o", 576, 576), ("k/v", 576, 192),
                  ("gate/up", 576, 1536), ("down", 1536, 576))
LM_PATH_ROWS = (1, 2, 4, 64, 128, 256, 512, 1024)
# the Qwen3-MoE tier-1 projections and their row counts: 2 (a
# generate_origami token step), 64 (moe engine's 2 x 32 bucket, the
# captured trusted forward, generate_origami's batched step check), 128
# (the 1 x 128 bucket) and 4096 (moe infer's 4 x 1024)
MOE_PROJECTIONS = (("q", 4096, 8192), ("k/v", 4096, 512), ("o", 8192, 4096))
MOE_PATH_ROWS = (2, 64, 128, 4096)
# the tier-1 projections of Yi-9B, Qwen2.5-14B and MiniCPM3-4B and the row
# counts their phases give them: 4 (a batch-4 token step), 64 (a 2 x 32
# prompt), 1024 (qwen2.5 and mla infer's 4 x 256), 4096 (the 4 x 1024
# prompt passes of yi and mla generate); MiniCPM3 also 2 (its
# generate_origami steps). K = 13,824 (Qwen2.5's down) is the widest K of
# the port, N = 288 (MLA's wkv_a) a ragged tile
YI_PROJECTIONS = (("q/o", 4096, 4096), ("k/v", 4096, 512),
                  ("gate/up", 4096, 11008), ("down", 11008, 4096))
QWEN25_PROJECTIONS = (("q/o", 5120, 5120), ("k/v", 5120, 1024),
                      ("gate/up", 5120, 13824), ("down", 13824, 5120))
MLA_PROJECTIONS = (("wq_a", 2560, 768), ("wq_b", 768, 3840),
                   ("wkv_a", 2560, 288), ("wkv_b", 256, 5120),
                   ("wo", 2560, 2560), ("gate/up", 2560, 6400),
                   ("down", 6400, 2560))
DENSE_PATH_ROWS = (4, 64, 1024, 4096)
MLA_PATH_ROWS = (2,) + DENSE_PATH_ROWS
# the tier-1 projections of Zamba2-1.2B (a Mamba2 block's in_proj, N 8384,
# and out_proj) at 64 and 128 rows (zamba2 engine's 2 x 32 and 1 x 128
# buckets) and 4096 (zamba2 infer's 4 x 1024); of xLSTM-1.3B (an mLSTM
# block's w_up, its input and forget gates, N 4 with a bias, and w_down)
# at 4096 (xlstm infer)
ZAMBA2_PROJECTIONS = (("in_proj", 2048, 8384), ("out_proj", 4096, 2048))
ZAMBA2_PATH_ROWS = (64, 128, 4096)
XLSTM_PROJECTIONS = (("w_up", 2048, 8192), ("gates", 4096, 4),
                     ("w_down", 4096, 2048))
XLSTM_PATH_ROWS = (4096,)
# the tier-1 projections of Llama-3.2-Vision-11B (its first four self
# blocks) at 4096 rows (vlm infer's 4 x 1024) and of Whisper-small's
# encoder at 6000 (whisper infer's 4 x 1500 frames)
VLM_PROJECTIONS = (("q/o", 4096, 4096), ("k/v", 4096, 1024),
                   ("gate/up", 4096, 14336), ("down", 14336, 4096))
VLM_PATH_ROWS = (4096,)
WHISPER_PROJECTIONS = (("q/k/v/o", 768, 768), ("up", 768, 3072),
                       ("down", 3072, 768))
WHISPER_PATH_ROWS = (6000,)
# (label, M, K, N) of the new field shapes timed on lines of their own:
# the narrowest N any path gives the kernels (xLSTM's gates) and the
# widest (Zamba2's in_proj), at 4 x 1024 rows
SSM_FIELD_SHAPES = (("xlstm gate", 4096, 4096, 4),
                    ("zamba2 in_proj", 4096, 2048, 8384))


def _bound_ms(nbytes, nops):
    return max(nbytes / BYTES_S, nops / INT8_OPS_S) * 1e3


def phase_lm_limb_shapes(gen, dev):
    """The three field-product kernels at the SmolLM-135M shapes, each
    bit-for-bit against its plain version; timed on lines of their own
    (not in the VGG sums)."""
    def field(rows, cols):
        return torch.randint(0, ref.P, (rows, cols), generator=gen,
                             device=dev, dtype=torch.int32)

    def check(name, label, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {label}: kernel differs from its "
                                 f"plain version")

    for label, M, K, N in LM_LIMB_SHAPES:
        x, w = field(M, K), field(K, N)
        Kp = ops.block_plan(M, K, N)[4]
        xl, wl = ops.field_planes(x, Kp), ops.encode_weight_planes(w)
        check("limb_matmul", f"{label} ({M}x{Kp}x{N})",
              limb_matmul_planes(xl, wl), limb_matmul_planes_plain(xl, wl))
        ms, dms = timed(lambda: limb_matmul_planes(xl, wl),
                        "limb_matmul_mma_kernel")
        pms = cuda_ms(lambda: limb_matmul_planes_plain(xl, wl), reps=5)
        bound = _bound_ms(3 * M * Kp + 3 * Kp * N + 4 * M * N,
                          18 * M * Kp * N)
        print(f"limb_matmul smollm {label} ({M}x{Kp}x{N}): {ms:.4f} ms "
              f"(device {fmt_ms(dms)}), plain {pms:.4f} ms, bound "
              f"{bound:.4g} ms; bit-equal")

    scale = torch.tensor(3.1e-6, device=dev)
    for label, M, K, N in LM_FUSED_SHAPES:
        x, w, u = field(M, K), field(K, N), field(M, N)
        Kp = ops.block_plan(M, K, N)[4]
        xl, wl = ops.field_planes(x, Kp), ops.encode_weight_planes(w)
        check("limb_matmul_fused", f"{label} ({M}x{Kp}x{N})",
              limb_matmul_planes_fused(xl, wl, u, scale),
              limb_matmul_planes_fused_plain(xl, wl, u, scale))
        ms, dms = timed(lambda: limb_matmul_planes_fused(xl, wl, u, scale),
                        "limb_matmul_fused_mma_kernel")
        pms = cuda_ms(lambda: limb_matmul_planes_fused_plain(xl, wl, u,
                                                             scale), reps=5)
        bound = _bound_ms(3 * M * Kp + 3 * Kp * N + 8 * M * N + 4,
                          18 * M * Kp * N)
        lib = ""
        if M > 16:       # _int_mm takes more than 16 rows
            a8, b8_col = xl[0], wl[0].t().contiguous().t()
            lib_ms, lib_dms = timed(lambda: [torch._int_mm(a8, b8_col)
                                             for _ in range(9)])
            lib = (f", 9x _int_mm {lib_ms:.4f} ms (device "
                   f"{fmt_ms(lib_dms)}) with B column-major")
        print(f"limb_matmul_fused smollm {label} ({M}x{Kp}x{N}): {ms:.4f} "
              f"ms (device {fmt_ms(dms)}), plain {pms:.4f} ms{lib}, bound "
              f"{bound:.4g} ms; bit-equal")

    for label, M, Kf, kf in LM_FOLD_SHAPES:
        fl = ops.field_planes(field(M, Kf), Kf)
        sl = ops.encode_weight_planes(field(Kf, kf))
        check("limb_fold", f"{label} ({M}x{Kf}x{kf})",
              limb_fold_planes(fl, sl), limb_fold_planes_plain(fl, sl))
        ms, dms = timed(lambda: limb_fold_planes(fl, sl),
                        "limb_fold_mma_kernel")
        pms = cuda_ms(lambda: limb_fold_planes_plain(fl, sl), reps=5)
        bound = _bound_ms(3 * M * Kf + 3 * Kf * kf + 4 * M * kf,
                          18 * M * Kf * kf)
        print(f"limb_fold smollm {label} ({M}x{Kf}x{kf}): {ms:.4f} ms "
              f"(device {fmt_ms(dms)}), plain {pms:.4f} ms, bound "
              f"{bound:.4g} ms; bit-equal")
    phase_path_shapes(gen, dev, "lm", LM_PROJECTIONS, LM_PATH_ROWS)
    phase_path_shapes(gen, dev, "moe", MOE_PROJECTIONS, MOE_PATH_ROWS)
    phase_path_shapes(gen, dev, "yi", YI_PROJECTIONS, DENSE_PATH_ROWS)
    phase_path_shapes(gen, dev, "qwen2.5", QWEN25_PROJECTIONS,
                      DENSE_PATH_ROWS)
    phase_path_shapes(gen, dev, "mla", MLA_PROJECTIONS, MLA_PATH_ROWS)
    phase_path_shapes(gen, dev, "zamba2", ZAMBA2_PROJECTIONS,
                      ZAMBA2_PATH_ROWS)
    phase_path_shapes(gen, dev, "xlstm", XLSTM_PROJECTIONS, XLSTM_PATH_ROWS)
    phase_path_shapes(gen, dev, "vlm", VLM_PROJECTIONS, VLM_PATH_ROWS)
    phase_path_shapes(gen, dev, "whisper", WHISPER_PROJECTIONS,
                      WHISPER_PATH_ROWS)
    phase_ssm_field_shapes(gen, dev)


def _int_mm_ms(a8, b8):
    """(event ms, device ms) of nine ``torch._int_mm`` calls of one limb
    pair, B column-major; (None, None) where ``_int_mm`` does not take the
    shape (it needs N a multiple of 8)."""
    b8_col = b8.t().contiguous().t()
    try:
        torch._int_mm(a8, b8_col)
    except RuntimeError:
        return None, None
    return timed(lambda: [torch._int_mm(a8, b8_col) for _ in range(9)])


def phase_ssm_field_shapes(gen, dev):
    """The three field-product kernels at the SSM slice's new shapes
    (``SSM_FIELD_SHAPES``: N 4 and N 8384), bit-for-bit against their
    plain versions, timed beside the plain versions, the bound and the
    ``_int_mm`` yardstick."""
    def field(rows, cols):
        return torch.randint(0, ref.P, (rows, cols), generator=gen,
                             device=dev, dtype=torch.int32)

    def check(name, label, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {label}: kernel differs from its "
                                 f"plain version")

    def line(name, label, ms, dms, pms, bound, lib):
        lib_ms, lib_dms = lib
        lib_s = ("no _int_mm call takes N % 8 != 0" if lib_ms is None
                 else f"9x _int_mm {lib_ms:.4f} ms (device "
                      f"{fmt_ms(lib_dms)})")
        print(f"{name} {label}: {ms:.4f} ms (device {fmt_ms(dms)}), plain "
              f"{pms:.4f} ms, {lib_s}, bound {bound:.4g} ms; bit-equal")

    scale = torch.tensor(3.1e-6, device=dev)
    for label, M_, K, N in SSM_FIELD_SHAPES:
        x, w, u = field(M_, K), field(K, N), field(M_, N)
        Kp = ops.block_plan(M_, K, N)[4]
        xl, wl = ops.field_planes(x, Kp), ops.encode_weight_planes(w)
        lib = _int_mm_ms(xl[0], wl[0])
        shape = f"{label} ({M_}x{Kp}x{N})"
        check("limb_matmul", shape, limb_matmul_planes(xl, wl),
              limb_matmul_planes_plain(xl, wl))
        ms, dms = timed(lambda: limb_matmul_planes(xl, wl),
                        "limb_matmul_mma_kernel")
        pms = cuda_ms(lambda: limb_matmul_planes_plain(xl, wl), reps=5)
        line("limb_matmul", shape, ms, dms, pms,
             _bound_ms(3 * M_ * Kp + 3 * Kp * N + 4 * M_ * N,
                       18 * M_ * Kp * N), lib)
        check("limb_matmul_fused", shape,
              limb_matmul_planes_fused(xl, wl, u, scale),
              limb_matmul_planes_fused_plain(xl, wl, u, scale))
        ms, dms = timed(lambda: limb_matmul_planes_fused(xl, wl, u, scale),
                        "limb_matmul_fused_mma_kernel")
        pms = cuda_ms(lambda: limb_matmul_planes_fused_plain(xl, wl, u,
                                                             scale), reps=5)
        line("limb_matmul_fused", shape, ms, dms, pms,
             _bound_ms(3 * M_ * Kp + 3 * Kp * N + 8 * M_ * N + 4,
                       18 * M_ * Kp * N), lib)
        # the op's check: [y | x] of N + K digits folded against k = 2
        Kf = N + K
        sl = ops.encode_weight_planes(field(Kf, 2))
        fl = ops.field_planes(field(M_, Kf), sl.shape[1])
        fshape = f"{label} check ({M_}x{fl.shape[-1]}x2)"
        check("limb_fold", fshape, limb_fold_planes(fl, sl),
              limb_fold_planes_plain(fl, sl))
        ms, dms = timed(lambda: limb_fold_planes(fl, sl),
                        "limb_fold_mma_kernel")
        pms = cuda_ms(lambda: limb_fold_planes_plain(fl, sl), reps=5)
        Kfp = fl.shape[-1]
        line("limb_fold", fshape, ms, dms, pms,
             _bound_ms(3 * M_ * Kfp + 3 * Kfp * 2 + 4 * M_ * 2,
                       18 * M_ * Kfp * 2), (None, None))


def phase_path_shapes(gen, dev, tag, projections, path_rows):
    """Every field-product kernel and ``blind_encode`` at every shape the
    LM (``tag`` "lm", SmolLM-135M), MoE ("moe", Qwen3-MoE), Yi-9B ("yi"),
    Qwen2.5-14B ("qwen2.5") or MiniCPM3-4B ("mla") phases give it
    (``projections`` x ``path_rows``; the fold material
    ``W_q @ s`` once per projection), each bit-for-bit against its plain
    version; checked, not timed."""
    def field(rows, cols):
        return torch.randint(0, ref.P, (rows, cols), generator=gen,
                             device=dev, dtype=torch.int32)

    def check(name, shape, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} at the {tag} path shape {shape}: "
                                 f"kernel differs from its plain version")
        n_checked[name] = n_checked.get(name, 0) + 1

    n_checked = {}
    scale = torch.tensor(3.1e-6, device=dev)
    for label, K, N in projections:
        w = field(K, N)
        wl = ops.encode_weight_planes(w)
        Kp = wl.shape[1]
        sl = ops.encode_weight_planes(field(N, 2))
        wp = ops.field_planes(w, sl.shape[1])
        check("limb_matmul", (label, "ws", K, N, 2),
              limb_matmul_planes(wp, sl), limb_matmul_planes_plain(wp, sl))
        fold_s = ops.encode_weight_planes(field(K + N, 2))
        for M in path_rows:
            shape = (label, M, K, N)
            x = torch.randn((M, K), generator=gen, device=dev)
            r = field(M, K)
            inv = (1.0 / x.abs().max()).reshape(())
            xl = blind_encode(x, r, inv, 8, Kp)
            check("blind_encode", shape, xl,
                  blind_encode_plain(x, r, inv, 8, Kp))
            rl = ops.field_planes(r, Kp)
            check("limb_matmul", shape, limb_matmul_planes(rl, wl),
                  limb_matmul_planes_plain(rl, wl))
            u = field(M, N)
            check("limb_matmul_fused", shape,
                  limb_matmul_planes_fused(xl, wl, u, scale),
                  limb_matmul_planes_fused_plain(xl, wl, u, scale))
            fl = ops.field_planes(field(M, K + N), fold_s.shape[1])
            check("limb_fold", (label, M, K + N, 2),
                  limb_fold_planes(fl, fold_s),
                  limb_fold_planes_plain(fl, fold_s))
    print(f"{tag} path shapes: projections "
          f"{[(lb, K, N) for lb, K, N in projections]} at rows "
          f"{list(path_rows)}: bit-equal to the plain versions at "
          + ", ".join(f"{n} shapes of {name}"
                      for name, n in n_checked.items()))


def _request(cfg, rid, rng):
    img = (rng.normal(size=(cfg.image_size, cfg.image_size,
                            cfg.image_channels)) * 0.5).astype(np.float32)
    key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
    box = PrivateInferenceServer.client_seal(key, img, rid)
    return Request(rid=rid, box=box, shape=img.shape, session_key=key), key, img


def _timed(fn):
    """(milliseconds, result) of ``fn`` on the host clock, synchronized."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def _open_all(cfg, keys, responses):
    return np.stack([PrivateInferenceServer.client_open(
        k, r.box, (cfg.num_classes,)) for k, r in zip(keys, responses)])


def phase_serving(cfg, dev):
    t0 = time.perf_counter()
    params = V.init_params(cfg, SEED, device=dev)
    server = PrivateInferenceServer(cfg, params, mode="origami",
                                    max_batch=BATCH,
                                    integrity=IntegrityPolicy.full(k=2),
                                    device=dev)
    torch.cuda.synchronize()
    print(f"serving: vgg16 {cfg.image_size}x{cfg.image_size}, "
          f"{sum(v.numel() for l in params.values() for v in l.values())} "
          f"params, tier-1 = layers 1-{cfg.origami.tier1_layers} blinded, "
          f"set-up {time.perf_counter() - t0:.2f} s")
    print(f"attest: {server.attest()}")
    rng = np.random.default_rng(SEED)
    reqs, keys, imgs = zip(*[_request(cfg, rid, rng) for rid in range(BATCH)])
    bad_src, _, _ = _request(cfg, 99, rng)
    ct = bad_src.box.ciphertext.clone()
    ct.view(-1)[0] ^= 1
    bad = Request(99, bad_src.box._replace(ciphertext=ct), bad_src.shape,
                  bad_src.session_key)

    # the main path: launch counts read around exactly these calls
    torch.cuda.synchronize()
    KB.reset_launches()
    walls = []
    for _ in range(2):                       # cold, then warm (prefetched)
        t = time.perf_counter()
        responses = server.serve_batch(list(reqs))
        walls.append((time.perf_counter() - t, dict(server.last_phases)))
    bad_resp = server.serve_batch([bad])
    torch.cuda.synchronize()
    launches = dict(KB.LAUNCHES)
    tele = server.executor.telemetry_blinded

    assert all(r.ok for r in responses), [r.error for r in responses]
    assert not bad_resp[0].ok and bad_resp[0].error == "mac_failed", bad_resp
    logits = _open_all(cfg, keys, responses)
    assert logits.shape == (BATCH, cfg.num_classes)
    assert np.isfinite(logits).all()
    check_launches(launches, FUSED_PATH, "fused serving path")
    n_ops = len(tier1_shapes(cfg))           # blinded convs of tier-1
    assert tele.device_matmuls == tele.calls == n_ops, tele
    assert tele.enclave_matmuls == 0, tele
    assert tele.verify_ops == n_ops, tele

    batch = {"images": torch.from_numpy(np.stack(imgs))}
    res = server.executor.infer(batch, session_key=PRNGKey(SEED + 1))
    rep = res.integrity
    assert rep.n_ops == rep.n_checked == n_ops and rep.n_failed == 0, rep
    trusted = server.executor.infer(batch, trusted=True)
    if not np.array_equal(trusted.logits.cpu().numpy(), logits):
        raise AssertionError("served logits differ from the enclave "
                             "recompute")
    reference = server.executor.reference(batch).cpu().numpy()
    rel = float(np.abs(logits - reference).max() / np.abs(reference).max())
    assert rel < 0.05, rel
    print(f"serving: {BATCH} ok, tampered -> {bad_resp[0].error}; "
          f"checks {rep.n_checked}/{rep.n_ops} failed {rep.n_failed}; "
          f"device_matmuls {tele.device_matmuls} calls {tele.calls} "
          f"enclave_matmuls {tele.enclave_matmuls}; logits == enclave "
          f"recompute; rel err vs float forward {rel:.5f}")
    for label, (wall, ph) in zip(("cold", "warm"), walls):
        print(f"serve_batch {label}: {wall * 1e3:.1f} ms a batch of {BATCH}, "
              f"{wall * 1e3 / BATCH:.1f} ms a request; unseal "
              f"{ph['unseal'] * 1e3:.1f} ms, infer {ph['infer'] * 1e3:.1f} "
              f"ms, seal {ph['seal'] * 1e3:.1f} ms")
    print(f"launches on the serving path: {launches}")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return server, batch, launches, (reqs, keys, logits)


def phase_unfused_serving(cfg, params, batch, sealed, dev):
    """The unfused data path behind the server, launch counts read around
    exactly the two served batches."""
    reqs, keys, _ = sealed
    server = PrivateInferenceServer(cfg, params, mode="origami",
                                    max_batch=BATCH, impl="unfused",
                                    integrity=IntegrityPolicy.full(k=2),
                                    device=dev)
    torch.cuda.synchronize()
    KB.reset_launches()
    walls = []
    for _ in range(2):                       # cold, then warm (prefetched)
        t = time.perf_counter()
        responses = server.serve_batch(list(reqs))
        walls.append((time.perf_counter() - t, dict(server.last_phases)))
    torch.cuda.synchronize()
    launches = dict(KB.LAUNCHES)
    tele = server.executor.telemetry_blinded
    n_ops = len(tier1_shapes(cfg))
    assert all(r.ok and not r.flagged for r in responses), responses
    check_launches(launches, UNFUSED_PATH, "unfused serving path")
    assert tele.device_matmuls == tele.calls == n_ops, tele
    assert tele.verify_ops == n_ops, tele
    tot = server.integrity_totals
    assert tot.checks == 2 * n_ops and tot.failures == 0, tot
    logits = _open_all(cfg, keys, responses)
    assert np.isfinite(logits).all()
    trusted = server.executor.infer(batch, trusted=True)
    if not np.array_equal(trusted.logits.cpu().numpy(), logits):
        raise AssertionError("unfused: served logits differ from the "
                             "enclave recompute")
    reference = server.executor.reference(batch).cpu().numpy()
    rel = float(np.abs(logits - reference).max() / np.abs(reference).max())
    assert rel < 0.05, rel
    infer_ms, _ = _timed(lambda: server.executor.infer(
        batch, session_key=PRNGKey(SEED + 3)))
    print(f"unfused serving: {BATCH} ok, checks {tot.checks} failed "
          f"{tot.failures}; device_matmuls {tele.device_matmuls} calls "
          f"{tele.calls}; logits == enclave recompute; rel err vs float "
          f"forward {rel:.5f}")
    for label, (wall, ph) in zip(("cold", "warm"), walls):
        print(f"unfused serve_batch {label}: {wall * 1e3:.1f} ms a batch of "
              f"{BATCH}; unseal {ph['unseal'] * 1e3:.1f} ms, infer "
              f"{ph['infer'] * 1e3:.1f} ms, seal {ph['seal'] * 1e3:.1f} ms")
    print(f"unfused blinded infer (live factors, batch {BATCH}): "
          f"{infer_ms:.1f} ms")
    print(f"launches on the unfused serving path: {launches}")
    del server
    torch.cuda.empty_cache()
    return launches


def phase_fault_drills(cfg, params, batch, dev):
    """Every fault kind on both data paths under full verification: the
    checks fail exactly on the corrupted ops."""
    n_ops = len(tier1_shapes(cfg))
    for impl, path in (("fused", FUSED_PATH), ("unfused", UNFUSED_PATH)):
        ex = OrigamiExecutor(cfg, params, mode="origami", impl=impl,
                             precompute=True,
                             integrity=IntegrityPolicy.full(k=2), device=dev)
        line = []
        for i, kind in enumerate(KINDS):
            ex.fault = DishonestDevice(FaultSpec(kind))
            launches, _, res = counted(lambda: ex.infer(
                batch, session_key=PRNGKey(SEED + 10 + i)))
            check_launches(launches, path, f"{impl} {kind} fault drill")
            rep = res.integrity
            if not torch.equal(rep.failed, rep.corrupted):
                raise AssertionError(f"{impl}/{kind}: failed "
                                     f"{rep.failed.tolist()} != corrupted "
                                     f"{rep.corrupted.tolist()}")
            assert rep.n_ops == rep.n_checked == n_ops, (impl, kind, rep)
            want = 0 if kind == "adaptive" else n_ops
            assert rep.n_corrupted == rep.n_failed == want, (impl, kind, rep)
            line.append(f"{kind} {rep.n_corrupted}/{rep.n_failed}")
        print(f"fault drills ({impl}, corrupted/failed of {n_ops} ops): "
              + ", ".join(line) + f"; launches of the last drill {launches}")
        del ex
        torch.cuda.empty_cache()


def phase_recovery(cfg, params, sealed, dev):
    """A stale-replaying device behind the server: the batch is retried
    once on the device, then recomputed by the enclave, and opens to the
    honest server's logits."""
    reqs, keys, honest = sealed
    server = PrivateInferenceServer(
        cfg, params, mode="origami", max_batch=BATCH,
        integrity=IntegrityPolicy.full(k=2),
        fault=DishonestDevice(FaultSpec("stale")), device=dev)
    launches, wall_ms, responses = counted(
        lambda: server.serve_batch(list(reqs)))
    check_launches(launches, FUSED_PATH, "recovery path")
    tot = server.integrity_totals
    assert all(r.ok and r.flagged for r in responses), responses
    assert tot.retries == 1 and tot.recomputes == 1, tot
    assert tot.failures == tot.corrupted == 2 * len(tier1_shapes(cfg)), tot
    if not np.array_equal(_open_all(cfg, keys, responses), honest):
        raise AssertionError("recovered logits differ from the honest "
                             "server's")
    print(f"recovery: {BATCH} ok and flagged; checks {tot.checks} failed "
          f"{tot.failures} corrupted {tot.corrupted}; retries "
          f"{tot.retries}, recomputes {tot.recomputes}; logits == honest "
          f"server; batch {wall_ms:.1f} ms; launches {launches}")
    del server
    torch.cuda.empty_cache()


def phase_plane(cfg, params, batch, single, dev):
    """Two simulated slots on the card, slot 1 dishonest, in both shard
    modes; held bit-for-bit against the pool-less executor. Each session's
    factors are prefetched before its timed infer, on both sides."""
    keys = [PRNGKey(SEED + 20 + i) for i in range(3)]
    want, single_ms = [], []
    for k in keys:
        single.prepare_session(k)
        ms, res = _timed(lambda: single.infer(batch, session_key=k))
        want.append(res.logits.cpu().numpy())
        single_ms.append(ms)
    for shard in ("rows", "shares"):
        pool = DevicePool(2, faults={
            1: DishonestDevice(FaultSpec("bit_flip"))})
        ex = OrigamiExecutor(cfg, params, mode="origami", precompute=True,
                             integrity=IntegrityPolicy.full(k=2),
                             devices=pool, shard=shard, hedging=False,
                             device=dev)
        ex.build_cache(batch)
        total = None
        plane_ms, factor_ms = [], []
        launches = {name: 0 for name in KB.KERNELS}
        try:
            for k, w in zip(keys, want):
                factor_ms.append(_timed(lambda: ex.prepare_session(k))[0])
                counts, ms, res = counted(
                    lambda: ex.infer(batch, session_key=k))
                plane_ms.append(ms)
                for name, n in counts.items():
                    launches[name] += n
                if not np.array_equal(res.logits.cpu().numpy(), w):
                    raise AssertionError(f"plane ({shard}): logits differ "
                                         f"from the pool-less executor")
                assert res.integrity.ok, res.integrity
                if total is None:
                    total = res.sharding
                else:
                    total.add(res.sharding)
            bad, good = pool.slots[1], pool.slots[0]
            check_launches(launches, PLANE_PATH, f"offload plane ({shard})")
            # every dispatch came back from its slot's worker and was
            # checked: a kernel that failed on a worker thread would show
            # as a contained crash, recovered elsewhere
            assert total.crashes == total.timeouts == 0, total
            assert total.checks == total.dispatches > 0, total
            assert all(s.liveness_failures == 0 for s in pool.slots), \
                pool.snapshot()
            assert total.failures > 0, total
            if shard == "rows":
                assert total.retries > 0, total
            else:
                assert total.enclave_shards > 0 and total.retries == 0, total
            assert bad.quarantined and bad.quarantines == 1, bad.snapshot()
            assert good.available and good.verify_failures == 0
        finally:
            pool.close()
        print(f"plane ({shard}, 2 slots, slot 1 bit_flip): logits == "
              f"pool-less over {len(keys)} infers; ops {total.ops} "
              f"dispatches {total.dispatches} checks {total.checks} failures "
              f"{total.failures} retries {total.retries} enclave shards "
              f"{total.enclave_shards} probes {total.probes}; slot 1 "
              f"quarantined after {bad.verify_failures} failed checks; "
              f"ms an infer {[round(m, 1) for m in plane_ms]} vs pool-less "
              f"{[round(m, 1) for m in single_ms]} (factors prefetched, "
              f"{[round(m, 1) for m in factor_ms]} ms a session with the "
              f"shard folds); launches over the 3 infers {launches}")
        del ex
        torch.cuda.empty_cache()


PLANNED_BATCHES = 5
SERVING_SPANS = ("request", "unseal", "session.acquire", "infer", "verify",
                 "seal")
INNER_SPANS = ("plan.segment", "op.blinded", "op.trusted")
# kernel span -> the kernels its wrapper launches once a call
KERNEL_SPANS = {"kernel.fused_blind_matmul": ("blind_encode",
                                              "limb_matmul_fused"),
                "kernel.limb_matmul": ("limb_matmul",),
                "kernel.fold": ("limb_fold",)}


def _result_equal(a, b):
    """Logits, boundary and integrity report bit-equal."""
    return (torch.equal(a.logits, b.logits)
            and torch.equal(a.boundary, b.boundary)
            and all(torch.equal(getattr(a.integrity, f),
                                getattr(b.integrity, f))
                    for f in ("checked", "failed", "corrupted")))


def _busy_share(fn, top=6):
    """(device-busy share, top device ops) of one call of ``fn``: the union
    of the device activity intervals ``torch.profiler`` saw while the call
    ran, over the call's wall time on the host clock (the call
    synchronizes at its end; the card is idle when it starts), None when
    it saw none; and the ``top`` device ops (kernels and copies; every one
    when None) by device time, as (name, ms, count). The profile records
    the device's activity only: a host-side one of a call of ~10^4-10^5
    launches took seconds to record and read back."""
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    ops = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        t = ev.cuda_time_total if t is None else t
        if t > 0:
            ops.append((ev.key[:48], t / 1e3, ev.count))
    ops = sorted(ops, key=lambda o: -o[1])[:top]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, cur_lo, cur_hi = 0.0, None, None
    for a, b in spans:
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return (busy / wall_us if busy > 0 else None), ops


def _free():
    """Collect dropped executors (their CUDA graphs' private pools) and
    return the memory; print what the card still holds."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  device memory held: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved")


def _spread(ms):
    return (f"{statistics.median(ms):.2f} ms (median of {len(ms)}, range "
            f"{min(ms):.2f}-{max(ms):.2f})")


def _planned_readings(ex, batch, card):
    """Warm blinded infer eager and replayed (factors prefetched), the
    factor copy into the graph's buffers and the device-busy share of one
    of each, printed, not gated."""
    keys = [PRNGKey(SEED + 50 + i) for i in range(READING_REPS)]
    eager_ms, replay_ms = [], []
    for k in keys:
        ex.prepare_session(k)
        eager_ms.append(_timed(lambda: ex.infer(batch, k, jit=False))[0])
        ex.prepare_session(k)
        replay_ms.append(_timed(lambda: ex.infer(batch, k))[0])
    step = ex._executables[(False, ex.plan.digest, ex._shapes(batch))]
    factors = ex.cache.session_factors(keys[0])
    copy_ms = cuda_ms(lambda: step.load((batch, keys[0], factors)))
    nbytes = sum(v.numel() * v.element_size() for e in factors
                 for kk, v in e.items()
                 if kk in ("r", "u", "s", "ws") and v is not None)
    del factors
    busy, tops = [], []
    for jit in (False, True):
        ex.prepare_session(keys[0])
        share, ops = _busy_share(lambda: ex.infer(batch, keys[0], jit=jit))
        busy.append("not measured" if share is None else f"{share:.4f}")
        tops.append("; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in ops))
    print(f"planned serving readings on {card}, {ex.plan.summary()} "
          f"(batch {BATCH}, factors prefetched): warm blinded infer eager "
          f"{_spread(eager_ms)}, replayed {_spread(replay_ms)}; factor "
          f"copy into the graph {copy_ms:.3f} ms for "
          f"{nbytes / 2 ** 20:.1f} MiB; device-busy share eager {busy[0]}, "
          f"replayed {busy[1]}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    print(f"  top device ops, eager infer: {tops[0]}")
    print(f"  top device ops, replayed infer: {tops[1]}")


def phase_planned_serving(cfg, params, dev, card):
    """The engine's device stage without its queues: the partition planner
    picks the plan, the executor is warmed through a CompileCache (CUDA
    graphs of every bucket and trace kind), a SessionPool hands out the
    session keys and sealed batches are served under a Tracer; the
    profiler folds the trees and the planner re-prices from them."""
    from repro_torch.core import plan as PL
    from repro_torch.core import tracing
    from repro_torch.core.planner import PartitionPlanner
    from repro_torch.runtime.aot import CompileCache, bucket_ladder
    from repro_torch.runtime.observability import MetricsRegistry
    from repro_torch.runtime.profiling import (CriticalPathProfiler,
                                               FlightRecorder)
    from repro_torch.runtime.serving import (complete_prepared_batch,
                                             prepare_sealed_batch)
    from repro_torch.runtime.sessions import SessionPool, SessionReuseError
    tag = f"planned serving on {card}"
    policy = IntegrityPolicy.full(k=2)
    shape = (cfg.image_size, cfg.image_size, cfg.image_channels)
    t0 = time.perf_counter()
    planner = PartitionPlanner()
    pplan = planner.plan(cfg, params)
    plan_s = time.perf_counter() - t0
    print(f"{tag}: leakage profile "
          f"{ {p: round(v, 5) for p, v in pplan.leakage.items()} }; "
          f"{pplan.summary()}; feasible {pplan.feasible}; modeled runtime "
          f"of the chosen partition {pplan.runtime_s[pplan.partition]:.6f} s"
          f"; planned in {plan_s:.2f} s")
    plan = pplan.to_placement(cfg)

    # warm every (bucket, trace kind) through one CompileCache
    tracer = tracing.Tracer()
    registry = MetricsRegistry()
    cache = CompileCache(registry=registry)
    ex = OrigamiExecutor(cfg, params, plan=plan, precompute=True,
                         integrity=policy, device=dev)
    ex.attach_aot(cache)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tracing.activate(tracer):
        warm_ms, n_warm = _timed(lambda: ex.warm_aot(
            "images", shape, bucket_ladder(BATCH)))
    assert n_warm == 6 and cache.counters["compiles"] == 6, cache.stats()
    print(f"{tag}: warm_aot {n_warm} signatures in {warm_ms:.1f} "
          f"ms ({plan.summary()}); peak device memory after warming "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # serve sealed batches with pool keys under the tracer
    rng = np.random.default_rng(SEED + 7)
    pool = SessionPool(ex, depth=4)
    served = []                              # (key, batch, keys, responses)
    taken = []

    def acquire():
        taken.append(pool.acquire())
        return taken[-1]

    torch.cuda.synchronize()
    KB.reset_launches()
    t = time.perf_counter()
    for b in range(PLANNED_BATCHES):
        reqs, ckeys, _ = zip(*[_request(cfg, 1000 + b * BATCH + i, rng)
                               for i in range(BATCH)])
        with tracer.span("request", "request", model=cfg.name,
                         plan=ex.plan.digest, shape=[BATCH, *shape]):
            prep = prepare_sealed_batch(list(reqs), max_batch=BATCH)
            boxes, n_valid, _, integ = complete_prepared_batch(
                ex, prep, session_key=acquire)
        assert n_valid == BATCH and not integ.flagged, integ
        served.append((taken[-1], {"images": prep.x}, ckeys, boxes))
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t) * 1e3
    launches = dict(KB.LAUNCHES)
    check_launches(launches, FUSED_PATH, "planned serving path")
    stats = pool.stats()
    pool.close()
    assert stats["refill_errors"] == 0, stats
    pool._head = 0                           # a counter rollback
    try:
        pool.acquire()
        raise AssertionError("a re-issued session key was not refused")
    except SessionReuseError:
        pass
    aot = cache.stats()
    assert aot["request_compile_seconds"] == 0.0, aot
    assert aot["exec_fallbacks"] == 0 and aot["compiles"] == 6, aot

    # replay == eager == enclave recompute, launches credited == eager's
    for key, batch, ckeys, boxes in served:
        ex.prepare_session(key)
        eager_n, _, eager = counted(lambda: ex.infer(batch, key, jit=False))
        ex.prepare_session(key)
        replay_n, _, replay = counted(lambda: ex.infer(batch, key))
        if not _result_equal(replay, eager):
            raise AssertionError("planned serving: a replay differs from "
                                 "the eager infer")
        if replay_n != eager_n:
            raise AssertionError(f"replay launches {replay_n} != eager "
                                 f"{eager_n}")
        opened = np.stack([PrivateInferenceServer.client_open(
            k, bx, (cfg.num_classes,)) for k, bx in zip(ckeys, boxes)])
        if not np.array_equal(opened, eager.logits.cpu().numpy()):
            raise AssertionError("served logits differ from the eager infer")
    trusted = ex.infer(batch, trusted=True)
    if not torch.equal(trusted.logits, eager.logits):
        raise AssertionError("replayed logits differ from the enclave "
                             "recompute")

    # spans: the serving spans, none of the inner ones on a replay
    names = [sp.name for sp in tracer.spans()]
    missing = [n for n in SERVING_SPANS if n not in names]
    assert not missing, missing
    assert "compile.aot" in names, names
    inner = [n for n in names if n in INNER_SPANS]
    assert not inner, inner
    with tempfile.TemporaryDirectory(
            dir=Path(__file__).resolve().parent) as out:
        path = Path(out) / "planned_serving_trace.json"
        n_events = tracer.dump_chrome(path)
        doc = json.loads(path.read_text())
    assert len(doc["traceEvents"]) == n_events
    assert "tensor(" not in json.dumps(doc)
    # an eager run under kernel spans: one span per wrapper launch
    key = PRNGKey(SEED + 30)
    ex.prepare_session(key)
    ktracer = tracing.Tracer(kernel_spans=True)
    torch.cuda.synchronize()
    KB.reset_launches()
    with tracing.activate(ktracer):
        ex.infer(batch, key, jit=False)
        ex.infer(batch, trusted=True, jit=False)
    torch.cuda.synchronize()
    k_launches = dict(KB.LAUNCHES)
    k_names = [sp.name for sp in ktracer.spans()]
    for span, kernels in KERNEL_SPANS.items():
        for name in kernels:
            if k_names.count(span) != k_launches[name]:
                raise AssertionError(f"{span} spans {k_names.count(span)} "
                                     f"!= {name} launches "
                                     f"{k_launches[name]}")
    assert k_names.count("kernel.fused_blind_matmul") > 0, k_names
    print(f"{tag}: {PLANNED_BATCHES} sealed batches of {BATCH} in "
          f"{serve_ms:.1f} ms; replay == eager (logits, boundary, report) "
          f"== enclave recompute; replay launches == eager "
          f"{replay_n}; pool {stats}; reuse refused; aot {aot}; spans "
          f"{len(names)} ({n_events} chrome events), no inner span on a "
          f"replay; eager kernel spans == launches {k_launches}")

    # the plane (eager) with a flight recorder: slot 1 flips bits
    pool2 = DevicePool(2, faults={1: DishonestDevice(FaultSpec("bit_flip"))})
    try:
        ex2 = OrigamiExecutor(cfg, params, plan=plan, precompute=True,
                              integrity=policy, devices=pool2,
                              hedging=False, device=dev)
        ex2.attach_aot(cache)
        assert ex2.warm_aot("images", shape, (BATCH,)) == 0
        rec = FlightRecorder()
        ex2.plane.recorder = rec
        res2 = ex2.infer(batch, key)
        assert res2.integrity.ok, res2.integrity
        if not torch.equal(res2.logits, eager.logits):
            raise AssertionError("plane logits differ from the executor's")
        bad = pool2.slots[1].name
        hits = [ev for ev in rec.events if ev["kind"].startswith("shard_")
                and ev["attrs"].get("device") == bad]
        assert hits, list(rec.events)
        bundle = json.loads(json.dumps(rec.dump("manual", tracer=tracer,
                                                registry=registry)))
        assert bundle["events"], bundle
    finally:
        pool2.close()
    print(f"{tag}: plane (2 slots, slot 1 bit_flip) eager, "
          f"warm_aot 0; flight recorder {len(rec.events)} events, "
          f"{hits[0]['kind']} on {bad}; dump parses")
    del ex2
    _free()

    # mixed and verified-open plans at full width, eager and replayed
    mcache = CompileCache()
    for label, mplan in (("mixed", PL.make_mixed(cfg)),
                         ("vopen", PL.make_vopen(cfg))):
        exm = OrigamiExecutor(cfg, params, plan=mplan, precompute=True,
                              integrity=policy, device=dev)
        exm.attach_aot(mcache)
        k = PRNGKey(SEED + 40)
        exm.prepare_session(k)
        e = exm.infer(batch, k, jit=False)
        exm.prepare_session(k)
        r = exm.infer(batch, k)
        tr = exm.infer(batch, trusted=True)
        n_ops = len(mplan.cache_ops)
        for name, res in (("eager", e), ("replayed", r)):
            rep = res.integrity
            if not torch.equal(res.boundary, tr.boundary):
                raise AssertionError(f"{label} {name}: boundary differs "
                                     f"from the trusted recompute")
            assert rep.n_ops == rep.n_checked == n_ops, (label, name, rep)
            assert rep.n_failed == 0, (label, name, rep)
        if not _result_equal(r, e):
            raise AssertionError(f"{label}: replay differs from eager")
        print(f"{tag}: {mplan.summary()}: {n_ops} ops checked "
              f"and passing, eager and replayed; boundary == trusted "
              f"recompute; logits == trusted "
              f"{torch.equal(e.logits, tr.logits)}")
        del exm, e, r, tr, res
    del mcache
    _free()

    # readings (not gated): the planned executor and the config's origami
    # partition (tier-1 = layers 1-6, the plan of the serving phases)
    exo = OrigamiExecutor(cfg, params, mode="origami", precompute=True,
                          integrity=policy, device=dev)
    exo.attach_aot(CompileCache())
    exo.warm_aot("images", shape, (BATCH,))
    _planned_readings(ex, batch, card)
    _planned_readings(exo, batch, card)
    del exo
    _free()
    colds = {}
    key = PRNGKey(SEED + 60)
    for label, warm in (("without warm_aot", False),
                        ("after warm_aot", True)):
        exc = OrigamiExecutor(cfg, params, plan=plan, precompute=True,
                              integrity=policy, device=dev)
        exc.attach_aot(CompileCache())
        if warm:
            exc.warm_aot("images", shape, (BATCH,))
        exc.build_cache(batch)
        exc.prepare_session(key)
        colds[label] = _timed(lambda: exc.infer(batch, key))[0]
        del exc
        _free()
    print(f"{tag}: cold first request (batch {BATCH}, factors prefetched) "
          f"{', '.join(f'{k} {v:.1f} ms' for k, v in colds.items())}")

    profiler = CriticalPathProfiler()
    folded = profiler.ingest(tracer)
    fitted = planner.calibrate(profiler)
    replanned = planner.plan(cfg, leakage=pplan.leakage)
    crit = profiler.report()["critical_s"]
    print(f"{tag}: profiler folded {folded} request trees; "
          f"critical path over them (s): "
          f"{ {p: round(v, 4) for p, v in crit.items() if v} }; "
          f"calibrated {fitted}; re-planned {replanned.summary()}")
    return launches


# -- engine serving ------------------------------------------------------------

ENGINE_MODELS = (("vgg16", 0), ("vgg19", 1))     # (config, weight seed)
ENGINE_PER_MODEL = 8
ENGINE_TAMPER = {"vgg16": 5, "vgg19": 6}        # stream index tampered
OWNED_THREADS = ("offload-dev", "session-pool-refill",
                 "serving-engine-batcher", "serving-engine-device")
RESULT_S = 600.0                                 # per-future bound


def _owned_threads():
    return {t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(OWNED_THREADS)}


def _no_owned_threads_left(before, where):
    """Fail unless every thread the engines started since ``before`` has
    ended (a daemon still launching at interpreter exit can crash the
    process after the last line)."""
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        left = _owned_threads() - before
        if not left:
            return
        time.sleep(0.05)
    raise AssertionError(f"{where}: threads alive after close: "
                         f"{sorted(t.name for t in left)}")


def _engine_stream(cfg, rid0, n, rng, tamper=None):
    """``n`` sealed requests of ``cfg`` with rids from ``rid0``; the
    ``tamper``-th one's ciphertext has a bit flipped."""
    reqs, keys = [], []
    for i in range(n):
        req, key, _ = _request(cfg, rid0 + i, rng)
        if i == tamper:
            ct = req.box.ciphertext.clone()
            ct.view(-1)[0] ^= 1
            req = Request(req.rid, req.box._replace(ciphertext=ct),
                          req.shape, req.session_key)
        reqs.append(req)
        keys.append(key)
    return reqs, keys


def _serve_interleaved(engine, streams, lone):
    """Every model's stream submitted interleaved, then the lone vgg16
    request alone, flushed. ({(model, rid): response}, wall seconds of
    the interleaved requests, completion order)."""
    t = time.perf_counter()
    futures = [(m, engine.submit(m, streams[m][0][j]))
               for j in range(ENGINE_PER_MODEL) for m in streams]
    got = {(m, f.result(timeout=RESULT_S).rid): f.result(timeout=0)
           for m, f in futures}
    wall = time.perf_counter() - t
    fut = engine.submit("vgg16", lone)
    engine.flush()
    got[("vgg16", lone.rid)] = fut.result(timeout=RESULT_S)
    return got, wall, list(engine.completion_order)


def _check_responses(got, tampered, where):
    """Exactly the tampered requests fail, with mac_failed; any other
    failure (a kernel error caught by the device stage included) is
    fatal."""
    for (m, rid), resp in got.items():
        if (m, rid) in tampered:
            assert not resp.ok and resp.error == "mac_failed", \
                (where, m, rid, resp.error)
        elif not resp.ok:
            raise AssertionError(f"{where}: {m} rid {rid} failed: "
                                 f"{resp.error}")


def phase_engine_serving(dev, card):
    """Sealed VGG-16 and VGG-19 traffic through one ``ServingEngine``:
    interleaved, warmed (CUDA graphs of every kind and bucket), traced;
    held bit-for-bit against synchronous servers and against a serial
    (one-stage) rerun; then a restart without warm-up. Returns the
    VGG-16 parameters for the chaos drill."""
    from repro_torch.core import tracing
    from repro_torch.runtime.engine import EngineConfig, ServingEngine
    tag = f"engine serving on {card}"
    policy = IntegrityPolicy.full(k=2)
    before = _owned_threads()
    rng = np.random.default_rng(SEED + 17)
    cfgs, params, streams, tampered = {}, {}, {}, set()
    for i, (name, seed) in enumerate(ENGINE_MODELS):
        cfgs[name] = get_config(name)
        params[name] = V.init_params(cfgs[name], seed, device=dev)
        streams[name] = _engine_stream(cfgs[name], 2000 + 1000 * i,
                                       ENGINE_PER_MODEL, rng,
                                       ENGINE_TAMPER[name])
        tampered.add((name, streams[name][0][ENGINE_TAMPER[name]].rid))
    lone, lone_key, _ = _request(cfgs["vgg16"], 2900, rng)
    keys = {(m, r.rid): k for m, (rs, ks) in streams.items()
            for r, k in zip(rs, ks)}
    keys[("vgg16", lone.rid)] = lone_key

    tracer = tracing.Tracer()
    engine = ServingEngine(EngineConfig(max_batch=BATCH, max_wait_ms=50.0,
                                        aot_warm=True), tracer=tracer)
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        entries = {m: engine.register_model(m, cfgs[m], params[m],
                                            integrity=policy, device=dev)
                   for m in cfgs}
        torch.cuda.synchronize()
        register_s = time.perf_counter() - t
        aot = engine.aot.stats()
        n_sigs = 2 * len(bucket_ladder(BATCH)) * len(cfgs)
        assert aot["compiles"] == n_sigs, aot
        torch.cuda.synchronize()
        KB.reset_launches()
        got, wall, order = _serve_interleaved(engine, streams, lone)
        torch.cuda.synchronize()
        launches = dict(KB.LAUNCHES)
        snap = engine.snapshot()
    finally:
        engine.close()
    _check_responses(got, tampered, "engine")
    check_launches(launches, FUSED_PATH, "engine serving path")
    aot = snap["aot"]
    assert aot["request_compile_seconds"] == 0.0, aot
    assert aot["exec_fallbacks"] == 0 and aot["compiles"] == n_sigs, aot
    n_batches = 2 * ENGINE_PER_MODEL // BATCH + 1
    assert snap["batches"] == n_batches and snap["padded_slots"] == 2, snap
    assert snap["mac_failures"] == 2, snap
    assert snap["buckets"] == {BATCH: {"batches": n_batches - 1,
                                       "padded_slots": 2},
                               1: {"batches": 1}}, snap["buckets"]
    assert snap["integrity"]["verify_failures"] == 0, snap["integrity"]
    assert snap["refill_errors"] == 0, snap["sessions"]
    mixed = any(order[k][0] != order[k + 1][0]
                for k in range(len(order) - 1))
    assert mixed, order

    # every response == the port's synchronous server over the same
    # stream, in the same groups (an eager executor on the same weights)
    for m in cfgs:
        server = PrivateInferenceServer(cfgs[m], params[m], max_batch=BATCH,
                                        integrity=policy, device=dev)
        reqs = streams[m][0]
        groups = [reqs[i:i + BATCH] for i in range(0, len(reqs), BATCH)]
        if m == "vgg16":
            groups.append([lone])
        for group in groups:
            for w in server.serve_batch(group):
                g = got[(m, w.rid)]
                if w.ok != g.ok:
                    raise AssertionError(f"{m} rid {w.rid}: ok {g.ok} vs "
                                         f"the server's {w.ok}")
                if w.ok and not np.array_equal(
                        _open1(cfgs[m], keys[(m, w.rid)], g),
                        _open1(cfgs[m], keys[(m, w.rid)], w)):
                    raise AssertionError(f"{m} rid {w.rid}: engine logits "
                                         f"differ from serve_batch")
        del server
        _free()

    # the same traffic on one stage (pipeline=False) over the same
    # executors and their graphs: bit-identical responses
    serial = ServingEngine(EngineConfig(max_batch=BATCH, max_wait_ms=50.0,
                                        aot_warm=True, pipeline=False))
    try:
        for m, e in entries.items():
            serial.register_executor(m, e.executor)
        got2, wall2, _ = _serve_interleaved(serial, streams, lone)
        snap2 = serial.snapshot()
    finally:
        serial.close()
    assert snap2["aot"]["compiles"] == 0, snap2["aot"]
    for k, resp in got.items():
        r2 = got2[k]
        assert r2.ok == resp.ok, k
        if resp.ok and not (torch.equal(r2.box.ciphertext,
                                        resp.box.ciphertext)
                            and r2.box.mac == resp.box.mac):
            raise AssertionError(f"{k}: pipeline=False response differs")

    # where the card's time goes: the same traffic once more, over the
    # same executors, under torch.profiler (not timed against the above)
    profiled = ServingEngine(EngineConfig(max_batch=BATCH, max_wait_ms=50.0,
                                          aot_warm=True))
    try:
        for m, e in entries.items():
            profiled.register_executor(m, e.executor)
        share, tops = _busy_share(
            lambda: _serve_interleaved(profiled, streams, lone))
    finally:
        profiled.close()

    del engine, serial, profiled, entries
    _free()
    # a restart: no graph survives a process, so without warm-up the
    # first batch captures its bucket on the request path
    restart = ServingEngine(EngineConfig(max_batch=BATCH, max_wait_ms=50.0))
    try:
        restart.register_model("vgg16", cfgs["vgg16"], params["vgg16"],
                               integrity=policy, device=dev)
        first = streams["vgg16"][0][:BATCH]
        futs = [restart.submit("vgg16", r) for r in first]
        resps = [f.result(timeout=RESULT_S) for f in futs]
        snap3 = restart.snapshot()
    finally:
        restart.close()
    assert all(r.ok for r in resps), [r.error for r in resps]
    for r in resps:
        if not (torch.equal(r.box.ciphertext,
                            got[("vgg16", r.rid)].box.ciphertext)):
            raise AssertionError("restart: response differs")
    a3 = snap3["aot"]
    assert a3["compiles"] == 1 and a3["request_compile_seconds"] > 0, a3
    _no_owned_threads_left(before, "engine serving")

    n_req = 2 * ENGINE_PER_MODEL
    crit = snap["phases"]["critical_s"]
    c16 = cfgs["vgg16"]
    print(f"{tag}: vgg16 + vgg19 {c16.image_size}x{c16.image_size}, "
          f"tier-1 = layers 1-{c16.origami.tier1_layers}, "
          f"full(k=2), max_batch {BATCH}, max_wait 50 ms; registered with "
          f"warm-up ({aot['compiles']} CUDA-graph captures, "
          f"{aot['compile_seconds'] * 1e3:.1f} ms) in "
          f"{register_s * 1e3:.1f} ms")
    print(f"{tag}: {n_req} interleaved sealed requests in {wall * 1e3:.1f} "
          f"ms: {n_req / wall:.2f} requests/s, {wall * 1e3 / n_req:.1f} ms "
          f"a request; p50 {snap['p50_latency_s'] * 1e3:.1f} ms, p95 "
          f"{snap['p95_latency_s'] * 1e3:.1f} ms; time to first batch "
          f"cold {snap['ttfb_cold_s'] * 1e3:.1f} ms, warm "
          f"{snap['ttfb_warm_s'] * 1e3:.1f} ms; batches {snap['batches']}, "
          f"padded slots {snap['padded_slots']}, buckets {snap['buckets']}; "
          f"tampered -> mac_failed x{snap['mac_failures']}; checks "
          f"{snap['integrity']['verify_checks']} failed 0; completions "
          f"interleave the models; every response == serve_batch")
    print(f"{tag}: profiler critical path over {snap['phases']['requests']} "
          f"requests (s): { {p: round(v, 4) for p, v in crit.items() if v} }"
          f"; sessions {snap['sessions']}")
    print(f"{tag}: pipeline {wall * 1e3:.1f} ms against one stage "
          f"(pipeline=False) {wall2 * 1e3:.1f} ms for the same "
          f"{n_req} requests, bit-identical; restart without warm-up: the "
          f"first batch of {BATCH} captured its graph on the request path "
          f"in {a3['request_compile_seconds'] * 1e3:.1f} ms, time to first "
          f"batch cold {snap3['ttfb_cold_s'] * 1e3:.1f} ms, warm "
          f"{snap3['ttfb_warm_s'] * 1e3:.1f} ms; launches {launches}")
    print(f"{tag}: device-busy share of the interleaved run "
          f"{'not measured' if share is None else f'{share:.4f}'}; top "
          f"device ops: "
          + "; ".join(f"{n} {ms:.1f} ms x{c}" for n, ms, c in tops))
    vgg16 = params["vgg16"]
    del restart, params, got, got2
    _free()
    return vgg16


def _open1(cfg, key, resp):
    return PrivateInferenceServer.client_open(key, resp.box,
                                              (cfg.num_classes,))


def phase_chaos_drill(params, dev, card):
    """The engine's chaos drill at full width: VGG-16 over a two-slot
    simulated pool on the card under the default schedule (slot 0
    crashes and slot 1 hangs in batches 1-2, the session refills fail in
    7-8, the request MACs flip in 10), batches of 4 up to the horizon
    plus 1; held against an honest pool-less server."""
    from repro_torch.launch.serve import DEFAULT_CHAOS
    from repro_torch.parallel.offload_sharding import LivenessConfig
    from repro_torch.runtime.chaos import ChaosController, ChaosSchedule
    from repro_torch.runtime.devices import DeviceHealthConfig
    from repro_torch.runtime.engine import EngineConfig, ServingEngine
    tag = f"chaos drill on {card}"
    cfg = get_config("vgg16")
    policy = IntegrityPolicy.full(k=2)
    before = _owned_threads()
    schedule = ChaosSchedule.parse(DEFAULT_CHAOS)
    n_batches = schedule.horizon + 1
    seal_batches = {b for ev in schedule.events if ev.layer == "seal"
                    for b in range(ev.start, ev.stop + 1)}
    device_window = {b for ev in schedule.events if ev.layer == "device"
                     for b in range(ev.start, ev.stop + 1)}
    rng = np.random.default_rng(SEED + 18)
    reqs, keys = _engine_stream(cfg, 5000, BATCH * n_batches, rng)
    key_by_rid = {r.rid: k for r, k in zip(reqs, keys)}
    # the honest oracle first: the seal window flips request MACs in flight
    oracle = PrivateInferenceServer(cfg, params, max_batch=BATCH,
                                    integrity=policy, device=dev)
    want = {}
    for j in range(n_batches):
        for r in oracle.serve_batch(reqs[BATCH * j:BATCH * (j + 1)]):
            assert r.ok, r
            want[r.rid] = _open1(cfg, key_by_rid[r.rid], r)
    del oracle
    _free()

    pool = DevicePool(2, health=DeviceHealthConfig(breaker_after=2,
                                                   breaker_cooldown=2))
    chaos = ChaosController(schedule)
    engine = ServingEngine(EngineConfig(max_batch=BATCH, max_wait_ms=50.0))
    timeline = []
    try:
        engine.register_model("vgg16", cfg, params, integrity=policy,
                              devices=pool, shard="rows",
                              liveness=LivenessConfig(cold_timeout_s=2.0),
                              chaos=chaos, device=dev)
        torch.cuda.synchronize()
        KB.reset_launches()
        t = time.perf_counter()
        for j in range(n_batches):
            futs = [engine.submit("vgg16", r)
                    for r in reqs[BATCH * j:BATCH * (j + 1)]]
            resps = [f.result(timeout=RESULT_S) for f in futs]
            degraded = engine.snapshot()["models"]["vgg16"]["degraded"]
            timeline.append((j, resps, degraded))
            if any(ev.layer == "refill" and ev.active(j)
                   for ev in schedule.events):
                # the refill thread is asynchronous: give it a bounded
                # beat to reach the armed window
                deadline = time.monotonic() + 5.0
                while (chaos.refill_faults == 0
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(KB.LAUNCHES)
        snap = engine.snapshot()
    finally:
        engine.close()
    _no_owned_threads_left(before, "chaos drill")

    fails = []
    if chaos.batch != n_batches - 1:
        fails.append(f"the drill clock saw batch {chaos.batch}")
    for j, resps, _ in timeline:
        for resp in resps:
            if j in seal_batches:
                if resp.ok or resp.error != "mac_failed":
                    fails.append(f"batch {j} rid {resp.rid}: seal window "
                                 f"not rejected ({resp.error})")
            elif not resp.ok:
                fails.append(f"batch {j} rid {resp.rid} failed "
                             f"({resp.error})")
            elif not np.array_equal(_open1(cfg, key_by_rid[resp.rid], resp),
                                    want[resp.rid]):
                fails.append(f"batch {j} rid {resp.rid}: logits differ "
                             f"from the honest server")
    liv = snap["liveness"]
    if liv["degradations"] == 0 or not any(
            d for j, _, d in timeline if j in device_window):
        fails.append("the device window did not degrade the model")
    if liv["recoveries"] == 0 or timeline[-1][2]:
        fails.append("the model did not recover")
    if liv["shard_crashes"] == 0 or liv["shard_timeouts"] == 0:
        fails.append(f"no crash or no timeout contained: {liv}")
    slots = snap["devices"]["vgg16"]["pool"]["slots"]
    if not all(s["breaker_opens"] > 0 and s["available"] for s in slots):
        fails.append(f"breakers: {slots}")
    if not (chaos.refill_faults > 0
            and snap["refill_errors"] == chaos.refill_faults):
        fails.append(f"refill faults {chaos.refill_faults}, refill errors "
                     f"{snap['refill_errors']}")
    if chaos.seal_corruptions != BATCH * len(seal_batches):
        fails.append(f"seal corruptions {chaos.seal_corruptions}")
    if chaos.snapshot()["armed"]:
        fails.append(f"still armed: {chaos.snapshot()['armed']}")
    if fails:
        raise AssertionError("chaos drill: " + "; ".join(fails))
    check_launches(launches, PLANE_PATH, "chaos drill")
    marks = "".join("D" if d else ("X" if not all(r.ok for r in rs) else ".")
                    for _, rs, d in timeline)
    n_ok = sum(r.ok for _, rs, _ in timeline for r in rs)
    print(f"{tag}: schedule {schedule}, {n_batches} batches of {BATCH}, 2 "
          f"slots, breaker after 2, cold timeout 2 s; timeline [{marks}] "
          f"(.=ok D=degraded X=seal window); "
          + ", ".join(f"batch {b} {a} {lab}" for b, lab, a in chaos.log))
    print(f"{tag}: {n_ok}/{BATCH * n_batches} ok in {wall * 1e3:.1f} ms "
          f"({n_ok / wall:.2f} requests/s); liveness {liv}; refill errors "
          f"{snap['refill_errors']} == injected; seal corruptions "
          f"{chaos.seal_corruptions}; every served logit == the honest "
          f"pool-less server; slots "
          + "; ".join(f"{s['name']} opens {s['breaker_opens']} probes "
                      f"{s['breaker_probes']} closes {s['breaker_closes']} "
                      f"abandons {s['abandons']}" for s in slots)
          + f"; launches {launches}")
    _free()


def phase_breakdown(server, batch):
    """A warm batch split into its parts (host clock, synchronized)."""
    ex = server.executor
    cfg = ex.cfg

    key = PRNGKey(SEED + 2)
    factors_ms, _ = _timed(lambda: ex.prepare_session(key))
    infer_ms, res = _timed(lambda: ex.infer(batch, session_key=key))
    p = cfg.origami.tier1_layers
    with torch.no_grad():
        tier2_ms, _ = _timed(lambda: V.apply_layer_range(
            ex.params, res.boundary, cfg, p, len(cfg.cnn_layers)))
        plain_ms, _ = _timed(lambda: ex.reference(batch))
    print(f"breakdown (warm, batch {BATCH}): session factors "
          f"{factors_ms:.1f} ms; blinded infer {infer_ms:.1f} ms = tier-1 "
          f"{infer_ms - tier2_ms:.1f} ms + tier-2 {tier2_ms:.1f} ms; plain "
          f"float forward {plain_ms:.1f} ms")


# (label, B, S, H, KH, D, Dv, dtype, causal, tolerance): q and k D wide,
# v and the output Dv; the smollm prefill shape first, then the reference
# test's sweep
FLASH_CASES = (
    ("smollm prefill", 4, 1024, 9, 3, 64, 64, torch.bfloat16, True, 2e-2),
    # the LM serving phases' attention: the lm infer batch, the prompt
    # pass of generate engine and sampling (and its bucket-2 and bucket-1
    # captures), lm engine's 128-token bucket 1 and its 32-token bucket 2
    ("lm infer", 4, 256, 9, 3, 64, 64, torch.bfloat16, True, 2e-2),
    ("prompt 128", 4, 128, 9, 3, 64, 64, torch.bfloat16, True, 2e-2),
    ("prompt 128 bucket 2", 2, 128, 9, 3, 64, 64, torch.bfloat16, True,
     2e-2),
    ("prompt 128 bucket 1", 1, 128, 9, 3, 64, 64, torch.bfloat16, True,
     2e-2),
    ("lm engine bucket 2", 2, 32, 9, 3, 64, 64, torch.bfloat16, True, 2e-2),
    # token probe: its 100 training boundaries and its evaluation
    ("token probe train", 8, 32, 9, 3, 64, 64, torch.bfloat16, True, 2e-2),
    ("token probe eval", 32, 32, 9, 3, 64, 64, torch.bfloat16, True, 2e-2),
    ("float32", 4, 1024, 9, 3, 64, 64, torch.float32, True, 2e-5),
    ("non-causal", 4, 1024, 9, 3, 64, 64, torch.bfloat16, False, 2e-2),
    ("MHA", 4, 1024, 9, 9, 64, 64, torch.bfloat16, True, 2e-2),
    ("ragged 6", 4, 6, 9, 3, 64, 64, torch.bfloat16, True, 2e-2),
    ("ragged 1000", 4, 1000, 9, 3, 64, 64, torch.bfloat16, True, 2e-2),
    # head width 128, Qwen3-MoE's 64 query and 4 KV heads: moe infer's
    # prefill, moe engine's buckets (2 x 32, also the captured trusted
    # forward, and 1 x 128), and the sweep
    ("qwen prefill", 4, 1024, 64, 4, 128, 128, torch.bfloat16, True, 2e-2),
    ("moe engine bucket 2", 2, 32, 64, 4, 128, 128, torch.bfloat16, True,
     2e-2),
    ("moe engine bucket 1", 1, 128, 64, 4, 128, 128, torch.bfloat16, True,
     2e-2),
    ("float32 D 128", 2, 256, 8, 2, 128, 128, torch.float32, True, 2e-5),
    ("non-causal D 128", 4, 1024, 64, 4, 128, 128, torch.bfloat16, False,
     2e-2),
    ("ragged 1000 D 128", 4, 1000, 64, 4, 128, 128, torch.bfloat16, True,
     2e-2),
    # Yi-9B (32/4 heads of 128, G 8) and Qwen2.5-14B (40/8, G 5: one head
    # a CTA): the prompt passes of yi generate and the breakdown, the
    # captured trusted prompt pass, qwen2.5 infer
    ("yi prefill", 4, 1024, 32, 4, 128, 128, torch.bfloat16, True, 2e-2),
    ("yi 4 x 256", 4, 256, 32, 4, 128, 128, torch.bfloat16, True, 2e-2),
    ("qwen2.5 prefill", 4, 1024, 40, 8, 128, 128, torch.bfloat16, True,
     2e-2),
    ("qwen2.5 infer", 4, 256, 40, 8, 128, 128, torch.bfloat16, True, 2e-2),
    # MiniCPM3's MLA: q/k 96 (64 + 32 rope) against v 64, 40 heads of one
    # KV head each: mla generate's prompt pass, mla infer, a 2 x 32 prompt;
    # the sweep; and the smoke widths (48, 32)
    ("minicpm3 prefill", 4, 1024, 40, 40, 96, 64, torch.bfloat16, True,
     2e-2),
    ("minicpm3 4 x 256", 4, 256, 40, 40, 96, 64, torch.bfloat16, True, 2e-2),
    ("minicpm3 2 x 32", 2, 32, 40, 40, 96, 64, torch.bfloat16, True, 2e-2),
    ("float32 (96, 64)", 2, 256, 40, 40, 96, 64, torch.float32, True, 2e-5),
    ("non-causal (96, 64)", 4, 1024, 40, 40, 96, 64, torch.bfloat16, False,
     2e-2),
    ("ragged 1000 (96, 64)", 4, 1000, 40, 40, 96, 64, torch.bfloat16, True,
     2e-2),
    ("smoke MLA (48, 32)", 2, 128, 4, 4, 48, 32, torch.bfloat16, True, 2e-2),
    ("float32 (48, 32)", 2, 130, 4, 4, 48, 32, torch.float32, False, 2e-5),
    # Zamba2's shared attention block, 32 query heads over 32 KV heads of
    # 64 (G 1 at D 64): zamba2 infer's 4 x 1024, its engine's buckets (2 x
    # 32 and 1 x 128), and float32
    ("zamba2 prefill", 4, 1024, 32, 32, 64, 64, torch.bfloat16, True, 2e-2),
    ("zamba2 engine bucket 2", 2, 32, 32, 32, 64, 64, torch.bfloat16, True,
     2e-2),
    ("zamba2 engine bucket 1", 1, 128, 32, 32, 64, 64, torch.bfloat16, True,
     2e-2),
    ("float32 G 1 D 64", 2, 256, 32, 32, 64, 64, torch.float32, True, 2e-5),
)
# (label, B, Sq, Skv, H, KH, D, Dv, dtype, causal, tolerance): the
# cross-attention families. Llama-3.2-Vision (32/8 heads of 128, G 4): its
# causal self attention at 4 x 1024; its cross attention over 1601 patches
# in float32 (the forward's float32 patches promote the bf16 queries), in
# bf16 (``prefill_vlm``) and at one query (a decode step, in bf16 and in
# float32: the float32-weight decode gate's call); Whisper (12/12
# heads of 64): the encoder over 1500 frames, the decoder's causal self
# attention at 448 (the infer phase) and 64 (the prompt pass), its cross
# attention at 448, 64 and one query against 1500 frames; and one query at
# G 8, D 128 (Yi's 32/4 heads) against 1024 keys. The bf16 calls at one
# query take the split-KV decode route; their lines give its split count.
# Besides the max
# abs tolerance, each is held within ``CROSS_REL_TOL`` (relative Frobenius)
# of the plain version's float32 result
CROSS_FLASH_CASES = (
    ("vlm self prefill", 4, 1024, 1024, 32, 8, 128, 128, torch.bfloat16,
     True, 2e-2),
    ("vlm cross forward", 4, 1024, 1601, 32, 8, 128, 128, torch.float32,
     False, 2e-5),
    ("vlm cross prefill", 4, 1024, 1601, 32, 8, 128, 128, torch.bfloat16,
     False, 2e-2),
    ("vlm cross decode", 4, 1, 1601, 32, 8, 128, 128, torch.bfloat16, False,
     2e-2),
    ("vlm cross decode float32", 4, 1, 1601, 32, 8, 128, 128, torch.float32,
     False, 2e-5),
    ("whisper encoder", 4, 1500, 1500, 12, 12, 64, 64, torch.bfloat16, False,
     2e-2),
    ("whisper decoder self", 4, 448, 448, 12, 12, 64, 64, torch.bfloat16,
     True, 2e-2),
    ("whisper cross", 4, 448, 1500, 12, 12, 64, 64, torch.bfloat16, False,
     2e-2),
    ("whisper decode cross", 4, 1, 1500, 12, 12, 64, 64, torch.bfloat16,
     False, 2e-2),
    ("whisper prompt self", 4, 64, 64, 12, 12, 64, 64, torch.bfloat16, True,
     2e-2),
    ("whisper prompt cross", 4, 64, 1500, 12, 12, 64, 64, torch.bfloat16,
     False, 2e-2),
    ("G 8 decode", 4, 1, 1024, 32, 4, 128, 128, torch.bfloat16, False, 2e-2),
)
# An absolute 2e-2 is half a typical output over ~1500 keys (std ~sqrt(e /
# Skv) ~0.04 for scores of std 1), so a fault that scales every output by
# a few percent passes it. The relative bound catches one: bf16 rounds the
# probabilities and the output (~1e-3 each), while the last partial key
# tile's zero-filled keys left unmasked scale every output by ~1 / (1 +
# pad / Skv), 36 keys at 1500 and 63 at 1601. Each non-causal ragged case
# shows that fault (the plain version over keys zero-padded to a multiple
# of ``KEY_TILE``) failing the bound.
CROSS_REL_TOL = {torch.bfloat16: 8e-3, torch.float32: 1e-4}
KEY_TILE = 64
# (label, B, Sq, Skv, H, KH, D, Dv, dtype, causal, q in bf16 values): the
# backward kernel at SmolLM-135M's training shape (the train phase's 8 x
# 1024, 9/3 heads of 64), and a sweep: float32, non-causal, G 1, ragged 1000
# and 6, D 128 at G 8 (Yi's heads), MLA's (96, 64) and its smoke widths,
# MiniCPM3-4B's training shape (8 x 1024, 40/40 heads of (96, 64)), and
# the VLM's cross attention (1024 queries against 1601 patches, G 4 at D
# 128) in bf16 and in float32, its bf16 queries promoted against the float32
# patches (the call a VLM train step would make)
BWD_CASES = (
    ("smollm train", 8, 1024, 1024, 9, 3, 64, 64, torch.bfloat16, True,
     False),
    ("float32", 8, 1024, 1024, 9, 3, 64, 64, torch.float32, True, False),
    ("non-causal", 8, 1024, 1024, 9, 3, 64, 64, torch.bfloat16, False,
     False),
    ("G 1", 8, 1024, 1024, 9, 9, 64, 64, torch.bfloat16, True, False),
    ("ragged 1000", 8, 1000, 1000, 9, 3, 64, 64, torch.bfloat16, True,
     False),
    ("ragged 6", 8, 6, 6, 9, 3, 64, 64, torch.bfloat16, True, False),
    ("D 128 G 8", 2, 1024, 1024, 32, 4, 128, 128, torch.bfloat16, True,
     False),
    ("MLA (96, 64)", 2, 1024, 1024, 40, 40, 96, 64, torch.bfloat16, True,
     False),
    ("MLA train", 8, 1024, 1024, 40, 40, 96, 64, torch.bfloat16, True,
     False),
    ("float32 (48, 32)", 2, 130, 130, 4, 4, 48, 32, torch.float32, False,
     False),
    ("VLM cross", 1, 1024, 1601, 32, 8, 128, 128, torch.bfloat16, False,
     False),
    ("VLM cross float32", 1, 1024, 1601, 32, 8, 128, 128, torch.float32,
     False, True),
)
# bf16: each gradient is rounded to bf16 once (2^-9), and Drow comes from
# the bf16 output on both sides; float32: the two sum in other orders
BWD_REL_TOL = {torch.bfloat16: 8e-3, torch.float32: 1e-5}
BWD_ABS_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}   # x max |want|
LSE_TOL = 1e-5


def _rel_frobenius(got, exact):
    return ((got.float() - exact).norm() / exact.norm()).item()


def _unmasked_tail_rel(q, k, v, exact):
    """The relative Frobenius error, against ``exact``, of non-causal
    attention over k and v zero-padded to a multiple of ``KEY_TILE`` keys
    (what the kernel gives if it left its last key tile unmasked), or None
    where Skv fills its tiles."""
    pad = -k.shape[1] % KEY_TILE
    if not pad:
        return None
    kp, vp = (torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])],
                        dim=1) for t in (k, v))
    return _rel_frobenius(flash_attention_plain(q, kp, vp, causal=False),
                          exact)


def flash_bound(B, Sq, Skv, H, KH, D, Dv, dtype, causal, backward=False):
    """(bound ms, "bytes" | "operations", {form: ms}) of one attention call:
    q, k, v read once and the output written once against 3.35 TB/s; 2 (D +
    Dv) operations for every (query, key) pair the mask lets through (QK
    and PV; causal: query i sees keys 0..i) against the dense peak of the
    input type. ``backward``: q, k, v, the output, its gradient and the
    float32 lse read once, dq, dk and dv written once; 2 (3 D + 2 Dv)
    operations a pair (S = QK^T, dP = dO V^T, dV, dQ, dK).

    A float32 call can take either of two routes to the same result: the
    CUDA cores at 67 TFLOP/s, or the tensor cores with each operand in two
    tf32 parts, three products a multiply-add at TF32's 495 TFLOP/s (the
    kernels' 3xTF32). The least time the card could take is the smaller;
    the dict gives both (empty for bf16)."""
    size = torch.tensor([], dtype=dtype).element_size()
    q_rows, kv_rows = B * Sq * H, B * Skv * KH
    nbytes = size * (q_rows * (D + Dv) + kv_rows * (D + Dv))
    if backward:       # + dO, lse; + dq, dk, dv
        nbytes += size * q_rows * Dv + 4 * q_rows
        nbytes += size * (q_rows * D + kv_rows * (D + Dv))
    if causal:
        n = min(Sq, Skv)
        pairs = n * (n + 1) // 2 + (Sq - n) * Skv
    else:
        pairs = Sq * Skv
    ops = 2 * B * H * ((3 * D + 2 * Dv) if backward else (D + Dv)) * pairs
    forms = {}
    if dtype == torch.bfloat16:
        t_ops = ops / BF16_OPS_S * 1e3
    else:
        forms = {"CUDA cores": ops / F32_OPS_S * 1e3,
                 "3xTF32": 3 * ops / TF32_OPS_S * 1e3}
        t_ops = min(forms.values())
    t_bytes = nbytes / BYTES_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), forms


def phase_flash(dev):
    """The flash-attention forward cases, then the backward's
    (``_flash_bwd_cases``); returns the smollm prefill case's numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    main_case = _flash_fwd_cases(dev, gen)
    torch.cuda.empty_cache()
    main_case["bwd"] = _flash_bwd_cases(dev, gen)
    return main_case


def _flash_fwd_cases(dev, gen):
    """The forward kernel against its plain version (float32 matmuls with
    TF32 off) over ``FLASH_CASES`` and ``CROSS_FLASH_CASES``, two launches
    bit-equal, timed beside the plain version and one
    ``scaled_dot_product_attention`` call (a yardstick the port never
    calls); returns the first case's numbers and the largest error."""
    main_case, err_max = None, 0.0
    cases = [(c[0], c[1], c[2], c[2]) + c[3:] for c in FLASH_CASES]
    n_plain = len(cases)
    for i, (label, B, S, Skv, H, KH, D, Dv, dtype, causal, tol) in enumerate(
            cases + list(CROSS_FLASH_CASES)):
        q = torch.randn((B, S, H, D), generator=gen, device=dev, dtype=dtype)
        k = torch.randn((B, Skv, KH, D), generator=gen, device=dev,
                        dtype=dtype)
        v = torch.randn((B, Skv, KH, Dv), generator=gen, device=dev,
                        dtype=dtype)
        got = flash_attention_fwd(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"flash_attention {label}: max abs err "
                                 f"{err} against the plain version, "
                                 f"tolerance {tol}")
        rel_note = ""
        if i >= n_plain:
            exact = flash_attention_plain(q.float(), k.float(), v.float(),
                                          causal=causal)
            rel, rel_tol = _rel_frobenius(got, exact), CROSS_REL_TOL[dtype]
            tail = None if causal else _unmasked_tail_rel(q, k, v, exact)
            if not rel <= rel_tol:
                raise AssertionError(f"flash_attention {label}: relative "
                                     f"Frobenius err {rel} against the "
                                     f"plain float32 result, bound {rel_tol}")
            if tail is not None and not tail > rel_tol:
                raise AssertionError(f"flash_attention {label}: an unmasked "
                                     f"last key tile ({tail}) would pass the "
                                     f"bound {rel_tol}")
            rel_note = (f"; relative Frobenius err {rel:.3g} (bound "
                        f"{rel_tol:g}" + ("" if tail is None else
                                          f"; an unmasked last key tile "
                                          f"{tail:.3g}") + ")")
            del exact
        if not torch.equal(got, flash_attention_fwd(q, k, v, causal=causal)):
            raise AssertionError(f"flash_attention {label}: two launches "
                                 f"differ")
        err_max = max(err_max, err)
        ms, dms = timed(lambda: flash_attention_fwd(q, k, v, causal=causal),
                        "flash_fwd")
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v,
                                                         causal=causal))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_ms, sdpa_dms = timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        bound, by, forms = flash_bound(B, S, Skv, H, KH, D, Dv, dtype,
                                       causal)
        width = f"D {D}" if Dv == D else f"D {D}, Dv {Dv}"
        seq = f"S {S}" if Skv == S else f"Sq {S}, Skv {Skv}"
        routes = "".join(f"; {form} {t:.4f}" for form, t in forms.items())
        splits = decode_splits(B, S, Skv, H, KH, dtype)
        route = f"; decode route, {splits} splits" if splits else ""
        print(f"flash_attention {label} (B {B}, {seq}, H {H}, KH {KH}, "
              f"{width}, {str(dtype)[6:]}, "
              f"{'causal' if causal else 'non-causal'}{route}): {ms:.4f} ms "
              f"(device {fmt_ms(dms)}), plain {plain_ms:.4f} ms, sdpa "
              f"{sdpa_ms:.4f} ms (device {fmt_ms(sdpa_dms)}), bound "
              f"{bound:.4f} ms ({by}{routes}); max abs err {err:.3g} (tol "
              f"{tol}){rel_note}")
        if main_case is None:
            main_case = {"ms": ms, "plain_ms": plain_ms,
                         "library_ms": sdpa_ms, "bound_ms": bound,
                         "bound_by": by}
        del q, k, v, got, want, qt, kt, vt
    main_case["err"] = err_max
    return main_case


def _flash_bwd_cases(dev, gen):
    """The backward kernel against its plain version (the materialized
    float32 formula) on the same residuals (q, k, v, dO and the forward
    kernel's output and lse): each gradient within ``BWD_REL_TOL``
    (relative Frobenius) and ``BWD_ABS_TOL`` x its largest magnitude, two
    launches bit-equal; the forward's lse within ``LSE_TOL`` of the plain
    one and its output bit-equal with and without the lse. Timed beside
    the plain version and one ``scaled_dot_product_attention`` backward (a
    yardstick the port never calls); returns the training shape's
    numbers."""
    main_case, err_max = None, 0.0
    for label, B, S, Skv, H, KH, D, Dv, dtype, causal, q_bf16 in BWD_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                   for shape in ((B, S, H, D), (B, Skv, KH, D),
                                 (B, Skv, KH, Dv)))
        if q_bf16:
            q = q.to(torch.bfloat16).to(dtype)
        dout = torch.randn((B, S, H, Dv), generator=gen, device=dev,
                           dtype=dtype)
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True)
        if not torch.equal(out, flash_attention_fwd(q, k, v, causal=causal)):
            raise AssertionError(f"flash_attention {label}: the output "
                                 f"differs with the lse asked for")
        lse_err = (lse - flash_attention_plain(
            q, k, v, causal=causal, return_lse=True)[1]).abs().max().item()
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"flash_attention {label}: lse err "
                                 f"{lse_err} against the plain version, "
                                 f"tolerance {LSE_TOL}")
        got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        want = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal)
        torch.cuda.synchronize()
        rels, errs = [], []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            rel = _rel_frobenius(g, w.float())
            err = (g.float() - w.float()).abs().max().item()
            bound = BWD_ABS_TOL[dtype] * w.float().abs().max().item()
            if not (rel <= BWD_REL_TOL[dtype] and err <= bound):
                raise AssertionError(
                    f"flash_attention_bwd {label} {name}: relative Frobenius "
                    f"err {rel} (bound {BWD_REL_TOL[dtype]}), max abs err "
                    f"{err} (bound {bound}) against the plain version")
            rels.append(rel)
            errs.append(err)
        again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {label}: two launches "
                                 f"differ")
        del want, again
        err_max = max(err_max, max(errs))
        ms, dms = timed(lambda: flash_attention_bwd(q, k, v, out, lse, dout,
                                                    causal=causal),
                        "flash_bwd")
        plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, dout, causal=causal), reps=3)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                            enable_gqa=True)
        dot = dout.transpose(1, 2)
        sdpa_ms, sdpa_dms = timed(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True))
        bound, by, forms = flash_bound(B, S, Skv, H, KH, D, Dv, dtype,
                                       causal, backward=True)
        width = f"D {D}" if Dv == D else f"D {D}, Dv {Dv}"
        seq = f"S {S}" if Skv == S else f"Sq {S}, Skv {Skv}"
        routes = "".join(f"; {form} {t:.4f}" for form, t in forms.items())
        print(f"flash_attention_bwd {label} (B {B}, {seq}, H {H}, KH {KH}, "
              f"{width}, {str(dtype)[6:]}{', q in bf16 values' * q_bf16}, "
              f"{'causal' if causal else 'non-causal'}): {ms:.4f} ms (device "
              f"{fmt_ms(dms)}), plain {plain_ms:.4f} ms, sdpa backward "
              f"{sdpa_ms:.4f} ms (device {fmt_ms(sdpa_dms)}), bound "
              f"{bound:.4f} ms ({by}{routes}); relative Frobenius err dq/dk/dv "
              f"{'/'.join(f'{r:.3g}' for r in rels)} (bound "
              f"{BWD_REL_TOL[dtype]:g}), max abs err "
              f"{'/'.join(f'{e:.3g}' for e in errs)}; lse err {lse_err:.3g}")
        if main_case is None:
            main_case = {"ms": ms, "plain_ms": plain_ms,
                         "library_ms": sdpa_ms, "bound_ms": bound,
                         "bound_by": by}
        del q, k, v, dout, out, lse, got, qt, kt, vt, ot, dot
        torch.cuda.empty_cache()
    main_case["err"] = err_max
    return main_case


GEN_BATCH, PROMPT_LEN, NEW_TOKENS = 4, 1024, 4
# rel err bound of the first new token's logits (after the whole prompt,
# tier-1 blinded) against the open float prefill; readings beside the assert
PREFILL_REL_BOUND = 0.25
# readings, not gates: the timed runs behind each median of a forward's or
# a token step's time, the planned-serving keys; the breakdown's ring-fed
# token steps; how far past its captured position a replayed token step is
# held to the eager one
READING_REPS = 1
BREAKDOWN_STEPS = 3
STEP_PAST = 2


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / (b.abs().max() + 1e-9)).item()


def phase_generate(dev):
    """Full-width SmolLM-135M private generation; returns the launches of
    the main (private) run."""
    cfg = get_config("smollm_135m")
    t0 = time.perf_counter()
    params = M.init_params(cfg, SEED, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    print(f"generate: smollm-135m, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} params (bf16, seed {SEED}), tier-1 = "
          f"blocks 1-{cfg.origami.tier1_layers}, batch {GEN_BATCH}, prompt "
          f"{PROMPT_LEN}, {NEW_TOKENS} new tokens; set-up "
          f"{time.perf_counter() - t0:.2f} s")
    ex, prompt, launches, open_ms = _generate_gates(cfg, params, dev,
                                                    "generate", 7, 7)
    phase_generate_breakdown(cfg, ex, params, prompt, open_ms)
    del ex
    torch.cuda.empty_cache()
    return launches


def _generate_gates(cfg, params, dev, tag, prompt_ops, step_ops,
                    drill_new=None):
    """``private_generate`` of a dense LM at full width on GEN_BATCH x
    PROMPT_LEN prompts, NEW_TOKENS new, under full(k=2), with
    ``prompt_ops`` blinded ops a tier-1 block in the prompt pass and
    ``step_ops`` in a token step: private and trusted logits and tokens
    bit-equal, every op checked and passing, the exact launch counts, one
    private token step within 0.15 of the open float step, the first new
    token within PREFILL_REL_BOUND of the open float prefill, no failed
    ring refill, a bit-flipping device caught op by op over a stream of
    ``drill_new`` new tokens (NEW_TOKENS when None). Returns (the executor,
    the prompt, the private run's launches, the ms of an open ``generate``
    of 2 tokens)."""
    drill_new = drill_new or NEW_TOKENS
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (GEN_BATCH, PROMPT_LEN))).to(dev)
    policy = IntegrityPolicy.full(k=2)
    ex = OrigamiExecutor(cfg, params, "origami", integrity=policy,
                         device=dev)
    key = PRNGKey(SEED + 30)
    kw = dict(max_new_tokens=NEW_TOKENS, session_key=key)
    p = cfg.origami.tier1_layers
    n_prompt, n_step = prompt_ops * p, step_ops * p   # ops a tier-1 pass

    # the main path: counts from 0 around exactly this call
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    KB.reset_launches()
    t = time.perf_counter()
    priv = private_generate(params, prompt, cfg, executor=ex, **kw)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    launches = dict(KB.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    cache = ex.decode_cache(GEN_BATCH)
    steps = priv.decode_steps
    n_ops = n_prompt + n_step * steps            # prefill + token steps
    check_launches(launches, GENERATE_PATH, f"{tag} private path")
    # prefill: each op draws u = r @ W_q and ws = W_q @ s live; decode: the
    # ring's refill (and any miss) drew every slot it made, consumed or not
    want = {"flash_attention": cfg.num_layers,
            "blind_encode": n_ops,
            "limb_matmul_fused": n_ops,
            "limb_fold": n_ops,
            "limb_matmul": 2 * n_prompt + cache.factor_matmuls
            + cache.fold_matmuls}
    for name, n in want.items():
        assert launches[name] == n, (name, launches[name], n)
    rep = priv.integrity
    assert rep.n_ops == rep.n_checked == n_ops and rep.ok, rep
    assert priv.ring["consumed"] == steps == NEW_TOKENS - 1, priv.ring
    assert priv.ring["refill_errors"] == 0, priv.ring
    assert priv.telemetry.device_matmuls == n_step, priv.telemetry
    assert priv.tokens.shape == (GEN_BATCH, PROMPT_LEN + NEW_TOKENS)
    assert torch.isfinite(priv.logits.float()).all()

    t_launches, _, oracle = counted(lambda: private_generate(
        params, prompt, cfg, executor=ex, trusted=True, **kw))
    check_launches(t_launches, TRUSTED_GENERATE_PATH, f"trusted {tag}")
    assert t_launches["limb_matmul"] == n_ops, t_launches
    assert t_launches["flash_attention"] == cfg.num_layers, t_launches
    if not (torch.equal(priv.logits, oracle.logits)
            and torch.equal(priv.tokens, oracle.tokens)):
        raise AssertionError(f"{tag}: private logits or tokens differ from "
                             f"the trusted recompute")
    assert oracle.telemetry.device_matmuls == 0, oracle.telemetry
    assert oracle.telemetry.trusted_matmuls == n_step, oracle.telemetry
    assert oracle.integrity.n_ops == 0 and oracle.ring is None

    open_ms, opened = _timed(lambda: generate(params, prompt, cfg,
                                              max_new_tokens=2, device=dev))
    assert torch.equal(opened.tokens[:, :PROMPT_LEN], prompt)
    del opened
    with torch.no_grad():
        first_open, _ = M.prefill(params, {"tokens": prompt}, cfg)
    prefill_rel = _rel(priv.logits[:, 0], first_open[:, -1])
    # tier-1 quantizes each op with one scale over all B x S rows, so the
    # prompt pass drifts further from float than one token step, in the
    # reference as here (PERF.md holds the card's readings)
    assert prefill_rel < PREFILL_REL_BOUND, prefill_rel
    # the bound of the reference's tests/test_generate.py: one token step
    # from an empty cache, tier-1 blinded against the open float step
    token = prompt[:, :1]
    with torch.no_grad():
        open_step, _ = M.decode_step(params, token, M.init_caches(
            cfg, GEN_BATCH, 8, device=dev), 0, cfg)
    priv_step, _, _ = ex.decode_once(token, M.init_caches(
        cfg, GEN_BATCH, 8, device=dev), 0, PRNGKey(SEED + 32))
    rel = _rel(priv_step, open_step)
    assert rel < 0.15, rel
    print(f"{tag}: private == trusted (logits {tuple(priv.logits.shape)} "
          f"and tokens bit-equal); checks {rep.n_checked}/{rep.n_ops} failed "
          f"{rep.n_failed}; device matmuls a step "
          f"{priv.telemetry.device_matmuls} private, "
          f"{oracle.telemetry.device_matmuls} "
          f"trusted ({oracle.telemetry.trusted_matmuls} in the enclave); "
          f"ring {priv.ring}; rel err of one private token step vs the open "
          f"float step {rel:.5f} (bound 0.15); of the logits of the first "
          f"new token (the {PROMPT_LEN}-token prompt's last position) vs "
          f"the open float prefill {prefill_rel:.5f} (bound "
          f"{PREFILL_REL_BOUND})")
    print(f"{tag}: launches, private run: {launches}; trusted run: "
          f"{t_launches}; ring cache drew {cache.factor_matmuls} u and "
          f"{cache.fold_matmuls} ws matmuls")
    print(f"{tag}: private_generate wall {wall_ms:.1f} ms ({NEW_TOKENS} "
          f"tokens, batch {GEN_BATCH}); peak device memory {peak_gib:.2f} "
          f"GiB")
    del priv, oracle, first_open

    # a bit-flipping device: every check fails exactly where it corrupted
    bad = OrigamiExecutor(cfg, params, "origami", integrity=policy,
                          fault=DishonestDevice(FaultSpec("bit_flip")),
                          device=dev)
    f_launches, _, drill = counted(lambda: private_generate(
        params, prompt, cfg, executor=bad, **{**kw,
                                               "max_new_tokens": drill_new}))
    check_launches(f_launches, GENERATE_PATH, f"{tag} bit_flip drill")
    drep = drill.integrity
    if not torch.equal(drep.failed, drep.corrupted):
        raise AssertionError(f"{tag} bit_flip drill: failed != corrupted")
    assert drep.n_corrupted == drep.n_failed == \
        n_prompt + n_step * (drill_new - 1), drep
    print(f"{tag} bit_flip drill: corrupted {drep.n_corrupted}, failed "
          f"{drep.n_failed} of {drep.n_ops} ops, op by op")
    del bad, drill
    torch.cuda.empty_cache()
    return ex, prompt, launches, open_ms


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_generate_breakdown(cfg, ex, params, prompt, open_ms,
                             tag="breakdown"):
    """Where a warm private session's time goes (host clock,
    synchronized): the prefill alone, split into tier-2 and the rest; one
    token slot's factors drawn on the main thread; one token step fed a
    drawn slot with no refill thread running; then the token steps with
    the ring's refill thread drawing slots beside them, as in
    ``private_generate``."""
    key = PRNGKey(SEED + 31)
    total = PROMPT_LEN + NEW_TOKENS
    p = cfg.origami.tier1_layers
    cache = ex.decode_cache(GEN_BATCH)
    prefill_ms, (logits, caches, _) = _timed(
        lambda: ex.prefill_session(prompt, key, max_seq=total))
    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    slot_ms, slot = _timed(lambda: cache.session_factors(key, PROMPT_LEN))
    alone_ms, (logits, caches, _) = _timed(lambda: ex.decode_once(
        tok, caches, PROMPT_LEN, key, slot))
    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    ring = TokenSlotRing(cache, key, lo=PROMPT_LEN + 1)
    step_ms = []
    try:
        for t in range(PROMPT_LEN + 1, PROMPT_LEN + 1 + BREAKDOWN_STEPS):
            ms, (logits, caches, _) = _timed(lambda: ex.decode_once(
                tok, caches, t, key, ring.take(t)))
            tok = torch.argmax(logits[:, -1:].float(), dim=-1)
            step_ms.append(ms)
        stats = ring.stats()
    finally:
        ring.close()
    with torch.no_grad():
        x = M.embed_tokens(params, prompt, cfg)
        x, _ = M.prefill_range(params, x, cfg, 0, p)
        tier2_ms, _ = _timed(lambda: M.prefill_range(params, x, cfg, p,
                                                     cfg.num_layers))
        open_prefill_ms, _ = _timed(lambda: M.prefill(
            params, {"tokens": prompt}, cfg, max_seq=total))
        open_step_ms, _ = _timed(lambda: M.decode_step(
            params, tok, caches, total - 1, cfg))
    decode_ms = statistics.median(step_ms)
    print(f"{tag} (warm, batch {GEN_BATCH}): private prefill "
          f"{prefill_ms:.1f} ms = tier-2 {tier2_ms:.1f} ms + the rest "
          f"{prefill_ms - tier2_ms:.1f} ms (tier-1, embedding, head; open "
          f"float prefill {open_prefill_ms:.1f} ms); one token slot's "
          f"factors {slot_ms:.1f} ms; one private token step fed a drawn "
          f"slot, no refill running, {alone_ms:.1f} ms (open float step "
          f"{open_step_ms:.1f} ms); with the ring's refill thread "
          f"{decode_ms:.2f} ms a token (median of {len(step_ms)}; min "
          f"{min(step_ms):.2f}, max {max(step_ms):.2f}), "
          f"{GEN_BATCH * 1e3 / decode_ms:.1f} tokens/s over the batch; ring "
          f"{stats}; open generate of 2 tokens {open_ms:.1f} ms")


# -- the LM serving paths (SmolLM-135M at full width and depth) -------------

LM_P = 3                                         # tier-1 = blocks 1-3
LM_INFER_SHAPE = (4, 256)                        # (batch, tokens)
LM_ENGINE_SEQS = (32, 32, 128)                   # two buckets of max_batch 2
GEN_ENGINE_PROMPT, GEN_ENGINE_NEW = 128, 8
SAMPLE_T = 0.8
ORIGAMI_SHAPE, ORIGAMI_NEW = (2, 16), 4
# the LM forward launches GENERATE_PATH's kernels (per op it draws
# u = r @ W_q and ws = W_q @ s live, blinds, multiplies and folds);
# generate_origami verifies nothing and its decode attention is plain torch
ORIGAMI_PATH = ("blind_encode", "limb_matmul", "limb_matmul_fused")


def _lm_tokens(cfg, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape)).to("cuda")


def phase_lm_infer(cfg, params, dev, card):
    """The LM forward ``infer`` on a batch of 4 x 256 tokens at p = 3
    under full(k=2): blinded == trusted bit for bit, the tier-1 boundary
    against the "split" plan's float one, every op checked, exact launch
    counts, a bit-flipping device caught op by op; times and the
    device-busy share."""
    return _lm_infer_gates(cfg, params, dev, f"lm infer on {card}", LM_P,
                           7, LM_INFER_SHAPE, SEED + 40)


def _lm_infer_gates(cfg, params, dev, tag, p, block_ops, shape, seed,
                    flash=None, reps=READING_REPS,
                    boundary_bound=PREFILL_REL_BOUND,
                    busy=True, memory=None):
    """``OrigamiExecutor.infer`` of an LM on ``shape`` tokens at
    partition ``p`` under full(k=2), ``block_ops`` blinded ops a tier-1
    block and ``flash`` flash launches a forward (every block's, when
    None): the gates and readings of ``phase_lm_infer``, the times medians
    of ``reps``; the tier-1 boundary's distance from the float one gated
    at ``boundary_bound``, or printed only when it is None; the busy
    shares read from ``torch.profiler`` unless ``busy`` is false.
    ``memory``: the batch's other entries (a cross-attention model's
    frames or patches). Returns the blinded run's launches."""
    policy = IntegrityPolicy.full(k=2)
    ex = OrigamiExecutor(cfg, params, "origami", p, integrity=policy,
                         device=dev)
    batch = {"tokens": _lm_tokens(cfg, shape, seed), **(memory or {})}
    key = PRNGKey(seed + 1)
    n_ops = block_ops * p
    flash = cfg.num_layers if flash is None else flash
    path = GENERATE_PATH if flash else FUSED_PATH
    t_path = TRUSTED_GENERATE_PATH if flash else ("limb_matmul",)
    launches, _, res = counted(lambda: ex.infer(batch, key))
    check_launches(launches, path, f"{tag} path")
    want = {"blind_encode": n_ops, "limb_matmul_fused": n_ops,
            "limb_fold": n_ops, "limb_matmul": 2 * n_ops,
            "flash_attention": flash}
    for name, n in want.items():
        assert launches[name] == n, (name, launches[name], n)
    rep, tele = res.integrity, res.telemetry
    assert rep.n_ops == rep.n_checked == n_ops and rep.ok, rep
    assert tele.calls == tele.device_matmuls == tele.verify_ops == n_ops
    assert res.logits.shape == tuple(shape) + (cfg.padded_vocab,)
    assert torch.isfinite(res.logits.float()).all()
    t_launches, _, trusted = counted(lambda: ex.infer(batch, key,
                                                      trusted=True))
    check_launches(t_launches, t_path, f"trusted {tag}")
    assert t_launches["limb_matmul"] == n_ops, t_launches
    if not torch.equal(res.logits, trusted.logits):
        raise AssertionError(f"{tag}: blinded logits differ from the "
                             f"trusted recompute")
    if not torch.equal(res.boundary, trusted.boundary):
        raise AssertionError(f"{tag}: blinded tier-1 boundary differs from "
                             f"the trusted recompute's")
    del trusted
    split = OrigamiExecutor(cfg, params, "split", p, device=dev)
    float_boundary = split.infer(batch).boundary.float()
    boundary_rel = _rel(res.boundary, float_boundary)
    boundary_fro = ((res.boundary.float() - float_boundary).norm()
                    / float_boundary.norm()).item()
    del split, float_boundary
    if boundary_bound is not None:
        assert boundary_rel < boundary_bound, boundary_rel
    bad = OrigamiExecutor(cfg, params, "origami", p, integrity=policy,
                          fault=DishonestDevice(FaultSpec("bit_flip")),
                          device=dev)
    drep = bad.infer(batch, key).integrity
    if not torch.equal(drep.failed, drep.corrupted):
        raise AssertionError(f"{tag} bit_flip: failed != corrupted")
    assert drep.n_corrupted == drep.n_failed == n_ops, drep
    del bad
    # the gate runs above warmed each forward (the split plan's ran the
    # open one's compute)
    blinded_ms = cuda_ms(lambda: ex.infer(batch, key), reps=reps, warmup=0)
    trusted_ms = cuda_ms(lambda: ex.infer(batch, key, trusted=True),
                         reps=reps, warmup=0)
    open_ms = cuda_ms(lambda: ex.reference(batch), reps=reps, warmup=0)
    share, tops = open_share, open_tops = None, []
    if busy:
        share, tops = _busy_share(lambda: ex.infer(batch, key))
        open_share, open_tops = _busy_share(lambda: ex.reference(batch))
    print(f"{tag}: {cfg.name} {shape[0]}x{shape[1]} "
          f"tokens, tier-1 = blocks 1-{p}, full(k=2): blinded == trusted "
          f"(logits {tuple(res.logits.shape)} and boundary bit-equal); "
          f"checks {rep.n_checked}/{rep.n_ops}; tier-1 boundary rel err vs "
          f"the split plan's float boundary {boundary_rel:.5f} (bound "
          f"{boundary_bound or 'none, printed'}; relative Frobenius "
          f"{boundary_fro:.5f}); bit_flip caught {drep.n_failed}/"
          f"{drep.n_ops} op by op; launches {launches}; trusted "
          f"{t_launches}")
    print(f"{tag}: blinded infer {blinded_ms:.2f} ms, trusted "
          f"{trusted_ms:.2f} ms, open float forward {open_ms:.2f} ms "
          f"(median of {reps}); device-busy share of one blinded infer "
          f"{'not measured' if share is None else f'{share:.4f}'}; top "
          f"device ops: "
          + "; ".join(f"{n} {ms:.2f} ms x{c}" for n, ms, c in tops))
    print(f"{tag}: device-busy share of the open float forward "
          f"{'not measured' if open_share is None else f'{open_share:.4f}'}"
          f"; top device ops: "
          + "; ".join(f"{n} {ms:.2f} ms x{c}" for n, ms, c in open_tops))
    return launches


def _lm_request_sealed(cfg, rid, seq, rng):
    toks = rng.integers(0, cfg.vocab_size, size=(seq,)).astype(np.float32)
    key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
    box = PrivateInferenceServer.client_seal(key, toks, rid)
    return Request(rid=rid, box=box, shape=toks.shape, session_key=key), key


def phase_lm_engine(cfg, params, dev, card):
    """The reference's engine LM case at full width: an LM registered with
    ``input_key="tokens"``, ``input_dtype="int32"``, max_batch 2; two
    requests of 32 tokens and one of 128 in two buckets, each response
    bit-equal to an eager infer of its padded batch."""
    _serve_lm_engine("lm", cfg, params, LM_P, LM_ENGINE_SEQS, SEED + 42, dev,
                     card)


def _serve_lm_engine(name, cfg, params, partition, seq_lens, seed, dev,
                     card):
    """One LM in a ``ServingEngine`` (max_batch 2, ``input_key="tokens"``,
    full(k=2)) serving one sealed request a length of ``seq_lens``; the
    launches read around exactly the requests; every response opened and
    held bit for bit to an eager infer of its padded batch; no engine
    thread outlives ``close()``."""
    from repro_torch.runtime.engine import EngineConfig, ServingEngine
    tag = f"{name} engine on {card}"
    before = _owned_threads()
    rng = np.random.default_rng(seed)
    reqs = [_lm_request_sealed(cfg, 300 + i, s, rng)
            for i, s in enumerate(seq_lens)]
    engine = ServingEngine(EngineConfig(max_batch=2, max_wait_ms=150.0))
    try:
        entry = engine.register_model(
            name, cfg, params, input_key="tokens", input_dtype="int32",
            partition=partition, integrity=IntegrityPolicy.full(k=2),
            device=dev)
        torch.cuda.synchronize()
        KB.reset_launches()
        t = time.perf_counter()
        futs = [engine.submit(name, r) for r, _ in reqs]
        got = [f.result(timeout=RESULT_S) for f in futs]
        wall = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = dict(KB.LAUNCHES)
        snap = engine.snapshot()
    finally:
        engine.close()
    _no_owned_threads_left(before, f"{name} engine")
    assert all(r.ok for r in got), [r.error for r in got]
    check_launches(launches, GENERATE_PATH, f"{name} engine path")
    assert snap["batches"] == 2, snap["batches"]
    ex = entry.executor
    seqs = {}
    for (r, key), resp in zip(reqs, got):
        seqs.setdefault(r.shape[0], []).append((r, key, resp))
    for seq, group in seqs.items():
        toks = torch.stack([torch.from_numpy(
            PrivateInferenceServer.client_open(k, r.box, r.shape))
            for r, k, _ in group])
        pad = 2 if len(group) == 2 else 1
        toks = torch.cat([toks, torch.zeros((pad - len(group), seq))])
        want = ex.infer({"tokens": toks.to(torch.int32)}, PRNGKey(seed + 1),
                        jit=False).logits.float().cpu()
        for row, (r, k, resp) in enumerate(group):
            lg = PrivateInferenceServer.client_open(
                k, resp.box, (seq, cfg.padded_vocab))
            if not np.array_equal(lg, want[row].numpy()):
                raise AssertionError(f"{name} engine: response {r.rid} "
                                     f"differs from the eager infer")
    print(f"{tag}: {len(reqs)} sealed requests of {list(seq_lens)} "
          f"tokens in {wall * 1e3:.1f} ms, {snap['batches']} batches "
          f"(buckets {snap['buckets']}), each response (tokens, "
          f"{cfg.padded_vocab}) bit-equal to the eager infer of its padded "
          f"batch; launches {launches}")
    del ex, entry
    _free()


def _clone_caches(caches):
    from repro_torch.models.attention import KVCache
    return KVCache(caches.k.clone(),
                   None if caches.v is None else caches.v.clone())


def _step_readings(ex, cfg, prompt, key, new=GEN_ENGINE_NEW,
                   n_step=7 * LM_P):
    """The slot-fed token step at the prompt's batch, at a position past
    the one ``warm_decode_aot`` captured it at (the prompt's length, here
    ``STEP_PAST`` on), the slot drawn beforehand and no refill thread
    running: (position, eager ms, replayed ms, busy shares, top device
    ops, kernel ms, launches), eager then replayed where there are two;
    and the gate that a replay is bit-equal to the eager step in logits,
    caches, report (``n_step`` ops, all checked) and launches. ``new`` is
    the captured stream's new tokens."""
    S0 = prompt.shape[1]
    total = S0 + new
    pos = S0 + STEP_PAST
    cache = ex.decode_cache(prompt.shape[0])
    logits, caches, _ = ex.prefill_session(prompt, key, max_seq=total,
                                           jit=False)
    for p in range(S0, pos):        # eager steps up to the gated position
        tok = torch.argmax(logits[:, -1:].float(), dim=-1)
        logits, caches, _ = ex.decode_once(
            tok, caches, p, key, cache.session_factors(key, p), jit=False)
    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    slot = cache.session_factors(key, pos)

    def step(jit):
        return ex.decode_once(tok, _clone_caches(caches), pos, key, slot,
                              jit=jit)

    ne, _, a = counted(lambda: step(False))
    nr, _, b = counted(lambda: step(True))
    same_v = ((a[1].v is None and b[1].v is None)
              or torch.equal(a[1].v, b[1].v))
    same = (torch.equal(a[0], b[0]) and torch.equal(a[1].k, b[1].k)
            and same_v
            and all(torch.equal(getattr(a[2], f), getattr(b[2], f))
                    for f in ("checked", "failed", "corrupted")))
    if not same:
        raise AssertionError("a replayed token step differs from the eager "
                             "decode_once")
    assert ne == nr and a[2].n_checked == n_step and a[2].ok, (ne, nr)
    eager_ms, replay_ms = [], []
    for _ in range(READING_REPS):
        eager_ms.append(_timed(lambda: step(False))[0])
        replay_ms.append(_timed(lambda: step(True))[0])
    busy, tops = zip(*[_busy_share(lambda: step(jit)) for jit in
                       (False, True)])
    # the kernels' time alone (a CUDA-only profile: no host op is counted)
    kernel_ms = [device_ms(lambda: step(jit), reps=READING_REPS)
                 for jit in (False, True)]
    return pos, eager_ms, replay_ms, busy, tops, kernel_ms, ne


def phase_generate_engine(cfg, params, dev, card):
    """``GenerateExecutor`` (prompt 128, 16 new tokens) in a warmed engine
    (max_batch 4): every bucket's trusted prompt pass and both token
    steps captured at registration, none on the request path; 4 sealed
    prompts served as streams equal to the trusted oracle; a replayed
    token step bit-equal to the eager one; step times and busy shares."""
    from repro_torch.runtime.engine import EngineConfig, ServingEngine
    from repro_torch.runtime.generate import GenerateExecutor
    tag = f"generate engine on {card}"
    before = _owned_threads()
    rng = np.random.default_rng(SEED + 44)
    ex = GenerateExecutor(cfg, params, prompt_len=GEN_ENGINE_PROMPT,
                          max_new_tokens=GEN_ENGINE_NEW, partition=LM_P,
                          integrity=IntegrityPolicy.full(k=2), device=dev)
    assert ex.attested_digest == ex.dplan.digest != ex.plan.digest
    engine = ServingEngine(EngineConfig(max_batch=BATCH, max_wait_ms=50.0,
                                        aot_warm=True))
    try:
        _free()
        mem0 = torch.cuda.memory_reserved()
        reg_ms, _ = _timed(lambda: engine.register_executor(
            "smollm-gen", ex, input_key="tokens", input_dtype="int32"))
        graph_gib = (torch.cuda.memory_reserved() - mem0) / 2 ** 30
        a0 = engine.aot.stats()
        assert engine.attest("smollm-gen").plan_digest == ex.dplan.digest
        reqs = [_lm_request_sealed(cfg, 400 + i, GEN_ENGINE_PROMPT, rng)
                for i in range(BATCH)]
        torch.cuda.synchronize()
        KB.reset_launches()
        t = time.perf_counter()
        futs = [engine.submit("smollm-gen", r) for r, _ in reqs]
        got = [f.result(timeout=RESULT_S) for f in futs]
        wall = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = dict(KB.LAUNCHES)
        a1 = engine.aot.stats()
    finally:
        engine.close()
    _no_owned_threads_left(before, "generate engine")
    assert all(r.ok for r in got), [r.error for r in got]
    check_launches(launches, GENERATE_PATH, "generate engine path")
    n_buckets = len(bucket_ladder(BATCH))
    assert a0["compiles"] == 3 * n_buckets, a0
    assert a1["compiles"] == a0["compiles"], (a0, a1)
    assert a1["request_compile_seconds"] == 0.0, a1
    assert a1["exec_fallbacks"] == 0, a1
    total = GEN_ENGINE_PROMPT + GEN_ENGINE_NEW
    prompts = torch.stack([torch.from_numpy(PrivateInferenceServer.client_open(
        k, r.box, r.shape)) for r, k in reqs]).long().to(dev)
    streams = np.stack([PrivateInferenceServer.client_open(
        k, resp.box, (total,)) for (r, k), resp in zip(reqs, got)])
    # the oracle runs eagerly (jit=False): the served streams' replayed
    # token steps, 7 positions of one captured graph, are held against
    # eager steps, not against replays of the same capture
    oracle = private_generate(params, prompts, cfg,
                              max_new_tokens=GEN_ENGINE_NEW, trusted=True,
                              executor=ex, key=PRNGKey(0), jit=False)
    if not np.array_equal(streams, oracle.tokens.float().cpu().numpy()):
        raise AssertionError("generate engine: streams differ from the "
                             "eager trusted oracle")
    pos, eager_ms, replay_ms, busy, tops, kernel_ms, step_launches = (
        _step_readings(ex, cfg, prompts, PRNGKey(SEED + 45)))
    fmt = ["not measured" if b is None else f"{b:.4f}" for b in busy]
    print(f"{tag}: smollm-135m prompt {GEN_ENGINE_PROMPT}, "
          f"{GEN_ENGINE_NEW} new, tier-1 = blocks 1-{LM_P}, full(k=2), "
          f"max_batch {BATCH}: registered with warm-up in {reg_ms:.1f} ms "
          f"({a0['compiles']} CUDA-graph captures, "
          f"{a0['compile_seconds'] * 1e3:.1f} ms of capture; graph memory "
          f"{graph_gib:.2f} GiB reserved); {BATCH} sealed prompts served "
          f"in {wall * 1e3:.1f} ms as streams equal to the eager trusted "
          f"oracle; "
          f"no capture on the request path, no fallback; launches "
          f"{launches}")
    print(f"{tag}: slot-fed token step (batch {BATCH}, position {pos}, "
          f"captured at {GEN_ENGINE_PROMPT}; no refill running): eager "
          f"{_spread(eager_ms)}, replayed {_spread(replay_ms)}; replay "
          f"bit-equal to eager in logits, caches and report, "
          f"launches {step_launches}; device-busy share eager {fmt[0]}, "
          f"replayed {fmt[1]}; kernel time a step (profiler) eager "
          f"{fmt_ms(kernel_ms[0])}, replayed {fmt_ms(kernel_ms[1])}")
    for kind, ops in zip(("eager", "replayed"), tops):
        print(f"  top device ops, {kind} token step: "
              + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in ops))
    del ex, oracle
    _free()


def phase_sampling(cfg, params, dev, card):
    """``private_generate`` at temperature 0.8: private tokens equal the
    trusted ones; ``categorical`` on the card equals it on the CPU."""
    from repro_torch.core import prng
    tag = f"sampling on {card}"
    ex = OrigamiExecutor(cfg, params, "origami", LM_P,
                         integrity=IntegrityPolicy.full(k=2), device=dev)
    prompt = _lm_tokens(cfg, (GEN_BATCH, GEN_ENGINE_PROMPT), SEED + 46)
    kw = dict(max_new_tokens=GEN_ENGINE_NEW, temperature=SAMPLE_T,
              session_key=PRNGKey(SEED + 47), key=PRNGKey(SEED + 48))
    launches, ms, priv = counted(lambda: private_generate(
        params, prompt, cfg, executor=ex, **kw))
    check_launches(launches, GENERATE_PATH, "sampling path")
    oracle = private_generate(params, prompt, cfg, executor=ex, trusted=True,
                              **kw)
    if not torch.equal(priv.tokens, oracle.tokens):
        raise AssertionError("sampling: private tokens differ from the "
                             "trusted ones")
    assert priv.integrity.ok and priv.integrity.n_checked == \
        7 * LM_P * (1 + priv.decode_steps), priv.integrity
    logits = priv.logits[:, 0, :cfg.vocab_size].float()
    scaled = logits / torch.full_like(logits, SAMPLE_T)
    n_keys = 8
    for i in range(n_keys):
        k = prng.fold_in(PRNGKey(SEED + 49), i)
        on_card = prng.categorical(k, scaled)
        on_cpu = prng.categorical(k, scaled.cpu())
        if not torch.equal(on_card.cpu(), on_cpu):
            raise AssertionError("categorical on the card differs from the "
                                 "CPU")
    greedy = torch.argmax(logits, dim=-1)
    print(f"{tag}: private_generate {GEN_BATCH}x{GEN_ENGINE_PROMPT} prompt, "
          f"{GEN_ENGINE_NEW} new at temperature {SAMPLE_T} in {ms:.1f} ms: "
          f"private tokens == trusted; first sampled tokens "
          f"{priv.tokens[:, GEN_ENGINE_PROMPT].tolist()} (greedy "
          f"{greedy.tolist()}); categorical on the card == on the CPU for "
          f"{n_keys} keys; launches {launches}")
    del ex, priv, oracle


def phase_generate_origami(cfg, params, dev, card):
    """``generate_origami`` on a 2 x 32 prompt with 8 new tokens: one
    count per runtime op, exact launches; its first tiered step within
    0.15 of the open float step (the reference's bound)."""
    _generate_origami_gates(cfg, params, dev, f"generate_origami on {card}",
                            LM_P)


def _generate_origami_gates(cfg, params, dev, tag, p):
    """``generate_origami`` of a dense LM at partition ``p`` (7 blinded ops
    a tier-1 block in a token step): the gates and readings of
    ``phase_generate_origami``."""
    from repro_torch.core.blinding import BlindingSpec
    from repro_torch.core.slalom import SlalomContext
    from repro_torch.runtime.generate import (generate_origami,
                                              tiered_decode_step)
    prompt = _lm_tokens(cfg, ORIGAMI_SHAPE, SEED + 50)
    launches, ms, res = counted(lambda: generate_origami(
        params, prompt, cfg, max_new_tokens=ORIGAMI_NEW, partition=p,
        device=dev))
    check_launches(launches, ORIGAMI_PATH, f"{tag} path")
    steps = ORIGAMI_SHAPE[1] + ORIGAMI_NEW - 1
    n_ops = 7 * p * steps
    tele = res.telemetry
    assert tele.calls == tele.device_matmuls == tele.enclave_matmuls \
        == n_ops, tele
    for name in ORIGAMI_PATH:
        assert launches[name] == n_ops, (name, launches[name], n_ops)
    assert res.tokens.shape == (ORIGAMI_SHAPE[0], steps + 1)
    assert torch.equal(res.tokens[:, :ORIGAMI_SHAPE[1]], prompt)
    token = prompt[:, :1]
    with torch.no_grad():
        open_step, _ = M.decode_step(params, token, M.init_caches(
            cfg, ORIGAMI_SHAPE[0], 8, device=dev), 0, cfg)
        priv_step, _ = tiered_decode_step(
            params, token, M.init_caches(cfg, ORIGAMI_SHAPE[0], 8,
                                         device=dev),
            0, cfg, SlalomContext(PRNGKey(7), BlindingSpec()), p)
    rel = _rel(priv_step, open_step)
    assert rel < 0.15, rel
    print(f"{tag}: {ORIGAMI_SHAPE[0]}x{ORIGAMI_SHAPE[1]} prompt, "
          f"{ORIGAMI_NEW} new, tier-1 = blocks 1-{p}: {steps} tiered "
          f"steps in {ms:.1f} ms ({ms / steps:.2f} ms a step); telemetry "
          f"calls {tele.calls} == 7 x {p} x {steps}; rel err of the "
          f"first tiered step vs the open float step {rel:.5f} (bound "
          f"0.15); launches {launches}")



# -- the adversary: the c-GAN, Algorithm 1 and the token probe ----------------

# the reference's test_adversary_reconstructs_shallow_layer
# (tests/test_privacy.py)
ADV_PARITY = dict(layer=1, steps=60, batch=8, n_eval=32, seed=SEED)
# card against CPU: the tolerances of tests/test_torch_adversary.py (port
# against reference), a single batch's losses after 60 chaotic GAN steps
ADV_TOL = {"ssim": 0.05, "g_loss": 1.5, "d_loss": 0.6}
SEARCH = dict(threshold=0.35, verify_depth=2)
SEARCH_TRAIN = dict(batch=16, n_eval=64, seed=SEED)
# the walk's depth: a floor of steps a layer and a budget for the longest
# walk (cut from 60 steps and 80 s to keep the whole script near its time
# once phases 26-29 were added; the 18-layer walk took 104.7 s at 60)
SEARCH_MIN_STEPS = 5
WALK_BUDGET_S = 40.0
CALIBRATION_STEPS = 8
# the reference's defaults of token_recovery_probe
PROBE = dict(steps=100, batch=8, seq=32, lr=1e-2)


def phase_adversary_parity(dev, card):
    """The reference test's adversary (smoke VGG-16 with the reference's
    seed-0 weights from ``init_params_keyed``, layer 1, 60 steps, batch
    8, n_eval 32, seed 0) on the card and on the CPU: the SSIM and the
    final losses agree within the tests' tolerances, and a second run on
    the card gives the first's bit for bit."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import layers as L
    from repro_torch.privacy import reconstruct as R
    from repro_torch.privacy.data import make_batch
    from repro_torch.privacy.ssim import ssim
    tag = f"adversary parity on {card}"
    cfg = get_smoke("vgg16")
    params = L.init_params_keyed(PRNGKey(SEED), V.vgg_defs(cfg),
                                 torch.float32, "cpu")
    reps = []
    for label, d in (("card", dev), ("card again", dev),
                     ("CPU", torch.device("cpu"))):
        t = time.perf_counter()
        rep = R.train_adversary(params, cfg, device=d, **ADV_PARITY)
        wall = time.perf_counter() - t
        reps.append(rep)
        print(f"{tag}: on the {label} SSIM {rep.ssim:.5f}, final G loss "
              f"{rep.g_loss:.5f}, D loss {rep.d_loss:.5f}; {rep.step_ms:.3f} "
              f"ms a step (D+G), collect_features {rep.collect_ms:.3f} ms a "
              f"step, {wall:.2f} s for the run")
    again = [(getattr(reps[0], f), getattr(reps[1], f)) for f in ADV_TOL]
    if any(a != b for a, b in again):
        raise AssertionError(f"adversary parity: two card runs differ "
                             f"{again} ({list(ADV_TOL)})")
    for field, tol in ADV_TOL.items():
        a, b = getattr(reps[0], field), getattr(reps[2], field)
        if not (np.isfinite(a) and abs(a - b) <= tol):
            raise AssertionError(f"adversary parity: {field} {a} on the "
                                 f"card, {b} on the CPU (tolerance {tol})")
    floor = float(ssim(torch.from_numpy(make_batch(0, 8)),
                       torch.from_numpy(make_batch(500, 8))))
    print(f"{tag}: card == card again bit for bit, card == CPU within "
          f"{ADV_TOL}; the reference test's "
          f"noise floor {floor:.5f} (it asks SSIM > floor + 0.1)")


def _algorithm1(ssims, threshold, verify_depth, n):
    """(p, the layers in the order visited) of Algorithm 1 over measured
    SSIMs: the first layer below the threshold whose next
    ``verify_depth`` layers are below it too; when one of those rebounds,
    the walk goes on past the deepest that did."""
    visited = []
    layer = 1
    while layer <= n:
        if layer not in visited:
            visited.append(layer)
        if ssims[layer] >= threshold:
            layer += 1
            continue
        deeper = list(range(layer + 1, min(layer + verify_depth, n) + 1))
        visited += [m for m in deeper if m not in visited]
        rebound = [m for m in deeper if ssims[m] >= threshold]
        if not rebound:
            return layer, visited
        layer = max(rebound) + 1
    return n, visited


def phase_partition_search(cfg, params, dev, card):
    """Algorithm 1 on the full-width VGG-16 on the card, its SSIMs fed to
    the partition planner, and one batch served under the plan it picks."""
    from repro_torch.core.planner import PartitionPlanner
    from repro_torch.privacy import reconstruct as R
    from repro_torch.privacy.data import make_batch
    from repro_torch.privacy.ssim import ssim
    tag = f"algorithm 1 on {card}"
    t_phase = time.perf_counter()
    # the walk stops at the last spatial boundary: from a 1x1 fc map the
    # c-GAN's decoder doubles to 2^floor(log2(224)) = 128 pixels, not 224,
    # and its L1 term cannot be formed (the reference raises the same)
    shapes = V.feature_shapes(cfg)
    max_layer = max(l for l in range(1, len(cfg.cnn_layers))
                    if len(shapes[l]) == 3)
    # the step first: one short run on layer 1 (the widest boundary and
    # the costliest step) gives a step's cost (CUDA events) and, from its
    # wall, a run's fixed part; the budget allows for the longest walk,
    # every layer up to max_layer, each at layer 1's cost. The run draws
    # the images the walk then reuses, so its fixed part is an upper bound
    images = {}
    t = time.perf_counter()
    cal = R.train_adversary(params, cfg, 1, steps=CALIBRATION_STEPS,
                            device=dev, image_cache=images, **SEARCH_TRAIN)
    wall = time.perf_counter() - t
    per_step = (cal.step_ms + cal.collect_ms) / 1e3
    fixed = max(wall - CALIBRATION_STEPS * per_step, 0.0)

    def walk_s(n):
        return max_layer * (fixed + n * per_step)

    steps = max(SEARCH_MIN_STEPS,
                int((WALK_BUDGET_S / max_layer - fixed) / per_step))
    evals = torch.from_numpy(make_batch(10_000_000, SEARCH_TRAIN["n_eval"],
                                        cfg.image_size))
    gray = float(ssim(torch.full_like(evals, 0.5), evals))
    print(f"{tag}: calibration on layer 1 ({CALIBRATION_STEPS} steps, "
          f"batch {SEARCH_TRAIN['batch']}): {cal.step_ms:.2f} ms D+G and "
          f"{cal.collect_ms:.2f} ms collect_features a step on the card, "
          f"{fixed:.2f} s fixed a run ({wall:.2f} s wall); a walk over "
          f"layers 1-{max_layer} predicted at {walk_s(SEARCH_MIN_STEPS):.1f} "
          f"s at the {SEARCH_MIN_STEPS}-step floor; {steps} steps a layer "
          f"(the largest count of {SEARCH_MIN_STEPS} or more within "
          f"{WALK_BUDGET_S:.0f} s, or {SEARCH_MIN_STEPS}), predicted "
          f"{walk_s(steps):.1f} s; a constant gray image scores SSIM "
          f"{gray:.5f} against the held-out images")

    t = time.perf_counter()
    p, reports = R.partition_search(params, cfg, steps=steps, device=dev,
                                    max_layer=max_layer, image_cache=images,
                                    **SEARCH, **SEARCH_TRAIN)
    search_s = time.perf_counter() - t
    for r in reports:
        kind, width = V.layer_kind(cfg, r.layer - 1)
        print(f"{tag}: layer {r.layer} ({kind}{width or ''}) SSIM "
              f"{r.ssim:.5f} ({r.ssim - gray:+.5f} against the gray "
              f"image), G loss {r.g_loss:.5f}, D loss {r.d_loss:.5f}, "
              f"{r.step_ms:.3f} ms a step (D+G), collect_features "
              f"{r.collect_ms:.3f} ms")
        assert r.steps == steps, r
        if not (np.isfinite(r.ssim) and -1.0 <= r.ssim <= 1.0):
            raise AssertionError(f"layer {r.layer}: SSIM {r.ssim}")
        if not (np.isfinite(r.g_loss) and np.isfinite(r.d_loss)):
            raise AssertionError(f"layer {r.layer}: losses {r}")
    ssims = {r.layer: r.ssim for r in reports}
    want_p, visited = _algorithm1(ssims, SEARCH["threshold"],
                                  SEARCH["verify_depth"], max_layer)
    if (p, [r.layer for r in reports]) != (want_p, visited):
        raise AssertionError(f"partition_search gave p = {p} over "
                             f"{[r.layer for r in reports]}; Algorithm 1 "
                             f"gives {want_p} over {visited}")
    print(f"{tag}: searched p = {p} over {len(reports)} layers "
          f"({steps} steps each, batch {SEARCH_TRAIN['batch']}, n_eval "
          f"{SEARCH_TRAIN['n_eval']}) in {search_s:.1f} s (predicted "
          f"{walk_s(steps):.1f} s for every layer); Algorithm 1 recomputed "
          f"on these SSIMs gives the same")
    del images

    pplan = PartitionPlanner(privacy_floor=SEARCH["threshold"],
                             verify_depth=SEARCH["verify_depth"]).plan(
        cfg, params, leakage=ssims)
    plan = pplan.to_placement(cfg)
    n_ops = len(plan.cache_ops)
    print(f"{tag}: planner on the measured SSIMs: {pplan.summary()}; "
          f"feasible {pplan.feasible}; {plan.summary()}, {n_ops} blinded "
          f"ops")
    ex = OrigamiExecutor(cfg, params, plan=plan, precompute=True,
                         integrity=IntegrityPolicy.full(k=2), device=dev)
    rng = np.random.default_rng(SEED + 70)
    batch = {"images": torch.from_numpy(rng.random(
        (BATCH, cfg.image_size, cfg.image_size, cfg.image_channels),
        dtype=np.float32))}
    key = PRNGKey(SEED + 70)
    launches, ms, res = counted(lambda: ex.infer(batch, key))
    trusted = ex.infer(batch, trusted=True)
    if not torch.equal(res.logits, trusted.logits):
        raise AssertionError("searched plan: blinded logits differ from the "
                             "enclave recompute")
    rep = res.integrity
    assert rep.n_ops == rep.n_checked == n_ops and rep.n_failed == 0, rep
    check_launches(launches, FUSED_PATH, "searched plan's path")
    for name in ("blind_encode", "limb_matmul_fused", "limb_fold"):
        if launches[name] != n_ops:
            raise AssertionError(f"searched plan: {launches[name]} {name} "
                                 f"launches for {n_ops} blinded ops")
    print(f"{tag}: served a batch of {BATCH} under p = {pplan.partition} "
          f"in {ms:.1f} ms (cold: cache, factors and checks): logits == "
          f"enclave recompute, {rep.n_checked}/{rep.n_ops} checks passing; "
          f"launches {launches}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    del ex, res, trusted


def phase_token_probe(cfg, params, dev, card):
    """``token_recovery_probe`` with the reference's defaults on the
    boundary after tier-1 blocks 1-LM_P of the full SmolLM-135M (open
    forward): a reading, not gated on its value; gated on the probe's
    flash_attention launches, one a block at each boundary it draws."""
    from repro_torch.privacy import reconstruct as R

    def boundary(tokens):
        x = M.embed_tokens(params, tokens.long(), cfg)
        return M.apply_range(params, x, cfg, 0, LM_P)[0]

    launches, ms, acc = counted(lambda: R.token_recovery_probe(
        boundary, cfg.vocab_size, cfg.d_model, device=dev, **PROBE))
    assert np.isfinite(acc) and 0.0 <= acc <= 1.0, acc
    # one attention call a block, at each training step and the evaluation
    want = LM_P * (PROBE["steps"] + 1)
    if launches["flash_attention"] != want:
        raise AssertionError(f"token probe: {launches['flash_attention']} "
                             f"flash_attention launches, not {want}")
    print(f"token probe on {card}: top-1 token recovery {acc:.5f} from the "
          f"boundary after blocks 1-{LM_P} ({PROBE}, vocab "
          f"{cfg.vocab_size}; chance {1 / cfg.vocab_size:.6f}) in "
          f"{ms / 1e3:.2f} s; {want} flash_attention launches")


# -- the mixture-of-experts family: Qwen3-MoE-235B-A22B at full width -------

MOE_ARCH = "qwen3_moe_235b"
MOE_BLOCKS = 6                          # of 94: tier-1 (4) and 2 of tier-2
MOE_OPS = 4                             # blinded ops a tier-1 block: q k v o
MOE_INFER_SHAPE = (4, 1024)
MOE_CAPTURE_SHAPE = (2, 32)
MOE_ENGINE_SEQS = (32, 32, 128)         # two buckets of max_batch 2
MOE_ORIGAMI_SHAPE, MOE_ORIGAMI_NEW = (2, 32), 4
MOE_NO_DROP_SHAPE = (2, 256)            # sorted_grouped vs gshard at cf 16
MOE_NO_DROP_TOL = 2e-2
# a blinded op's 8-bit activations flip near-tied top-8 choices (the
# router's 8th and 9th logits lie ~0.04 apart, the quantization moves them
# by up to ~0.35), and a flip moves the capacity queues of its token group
# (the drops of the other tokens): on the card 41% of the 4 x 1024 token
# rows route differently in block 1 and 92% somewhere in blocks 1-4
# (PERF.md). So the gates that compare with a float path hold the block-1
# router logits, whose input only the attention sublayer's quantization
# moves, to PREFILL_REL_BOUND, and the outputs to their bounds on the rows
# routed alike in every block compared.


def _moe_config():
    """The published Qwen3-MoE-235B-A22B at every width, cut to
    ``MOE_BLOCKS`` blocks (the config's 4 tier-1 blocks and 2 of tier-2)."""
    return get_config(MOE_ARCH).replace(num_layers=MOE_BLOCKS)


class _Routes:
    """The router logits (tokens, E) and the experts (tokens, k) every
    ``moe._route`` call computes while the block is entered, in call order
    (a MoE forward routes once a block): the script wraps the module's
    function for the duration of one call; the package has no switch for
    it."""

    def __init__(self):
        from repro_torch.models import moe
        self.module, self.inner = moe, moe._route
        self.logits, self.experts = [], []

    def __call__(self, p, x, cfg):
        w, e, aux = self.inner(p, x, cfg)
        self.logits.append((x.to(torch.float32) @ p["router"]["w"])
                           .reshape(-1, cfg.moe.num_experts))
        self.experts.append(e.reshape(-1, e.shape[-1]))
        return w, e, aux

    def __enter__(self):
        self.module._route = self
        return self

    def __exit__(self, *exc):
        self.module._route = self.inner


def _route_agreement(a, b, blocks, where):
    """The first ``blocks`` routing calls of two paths (``_Routes``): (the
    rows whose top-k expert sets agree in every one of them, a bool
    tensor; how many rows first disagree in each block; the mean experts
    a row keeps in each block; the block-1 router logits' rel err of ``a``
    against ``b``). Fails unless that rel err is below
    ``PREFILL_REL_BOUND`` and some row routes alike everywhere."""
    agree, first, means = None, [], []
    for ea, eb in zip(a.experts[:blocks], b.experts[:blocks]):
        hits = (ea[:, :, None] == eb[:, None, :]).any(dim=-1).sum(dim=-1)
        same = hits == ea.shape[-1]
        before = agree if agree is not None else torch.ones_like(same)
        first.append(int((before & ~same).sum()))
        agree = before & same
        means.append(hits.float().mean().item())
    router_rel = _rel(a.logits[0], b.logits[0])
    if not router_rel < PREFILL_REL_BOUND:
        raise AssertionError(f"{where}: block-1 router logits rel err "
                             f"{router_rel} (bound {PREFILL_REL_BOUND})")
    if not agree.any():
        raise AssertionError(f"{where}: no row routes alike in every block")
    return agree, first, means, router_rel


def phase_moe_layer(dev, card):
    """One full-width MoE layer (128 experts, top-8, d 4096, bf16, seed 0):
    ``sorted_grouped`` deterministic on 4 x 1024 tokens with no value read
    back to the host (sync debug mode "error"), equal to ``gshard``
    within 2e-2 x max on 2 x 256 tokens at capacity factor 16 (no drops;
    the reference's test_sorted_equals_gshard_when_no_drops at full
    width); the dropped assignments at 1.25 and the layer's time beside
    its bound."""
    import dataclasses
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    tag = f"moe layer on {card}"
    cfg = _moe_config()
    m = cfg.moe
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    p = L.init_params(MOE.moe_defs(cfg), gen, device=dev,
                      dtype=torch.bfloat16)
    B, S = MOE_INFER_SHAPE
    x = torch.randn((B, S, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches, _, (y, aux) = counted(lambda: _no_sync(
        lambda: MOE.moe_forward(p, x, cfg)))
    assert all(n == 0 for n in launches.values()), launches
    y2, aux2 = MOE.moe_forward(p, x, cfg)
    if not (torch.equal(y, y2) and torch.equal(aux, aux2)):
        raise AssertionError("moe layer: two runs of sorted_grouped differ")
    assert y.shape == x.shape and torch.isfinite(y.float()).all()
    # assignments past their expert's capacity, group by group
    T = B * S
    G = MOE.token_groups(T)
    C = MOE._capacity(T // G, cfg)
    _, experts, _ = MOE._route(p, x.reshape(G, T // G, cfg.d_model), cfg)
    counts = torch.zeros((G, m.num_experts), dtype=torch.long, device=dev)
    counts.scatter_add_(1, experts.reshape(G, -1),
                        torch.ones_like(experts.reshape(G, -1)))
    dropped = int(torch.clamp(counts - C, min=0).sum())

    wide = cfg.replace(moe=dataclasses.replace(m, capacity_factor=16.0))
    dense = wide.replace(moe=dataclasses.replace(wide.moe, dispatch="gshard"))
    xs = x[:MOE_NO_DROP_SHAPE[0], :MOE_NO_DROP_SHAPE[1]]
    ys, _ = MOE.moe_forward(p, xs, wide)
    yg, _ = MOE.moe_forward(p, xs, dense)
    err = (ys.float() - yg.float()).abs().max().item()
    scale = yg.float().abs().max().item()
    if not err <= MOE_NO_DROP_TOL * scale:
        raise AssertionError(f"moe layer: sorted_grouped vs gshard max abs "
                             f"err {err} > {MOE_NO_DROP_TOL} x {scale}")
    del ys, yg
    ms = cuda_ms(lambda: MOE.moe_forward(p, x, cfg), reps=10, warmup=2)
    # bound: the experts' banks, the router and x in / y out once; the
    # capacity rows' three expert products at the bf16 peak and the float32
    # router at the CUDA cores' peak
    rows = m.num_experts * G * C
    nbytes = (3 * m.num_experts * cfg.d_model * m.d_ff_expert * 2
              + cfg.d_model * m.num_experts * 4 + 2 * T * cfg.d_model * 2)
    t_bytes = nbytes / BYTES_S * 1e3
    t_ops = (rows * 3 * 2 * cfg.d_model * m.d_ff_expert / BF16_OPS_S
             + 2 * T * cfg.d_model * m.num_experts / F32_OPS_S) * 1e3
    print(f"{tag}: {m.num_experts} experts of {cfg.d_model}x"
          f"{m.d_ff_expert}, top-{m.top_k}, bf16, seed {SEED} (set-up "
          f"{setup_s:.2f} s): sorted_grouped on {B}x{S} tokens in {G} "
          f"groups of capacity {C}: two runs bit-equal with no host sync; "
          f"{dropped} of {T * m.top_k} assignments dropped at capacity "
          f"factor {m.capacity_factor}; on {MOE_NO_DROP_SHAPE[0]}x"
          f"{MOE_NO_DROP_SHAPE[1]} tokens at capacity factor 16 "
          f"sorted_grouped vs gshard max abs err {err:.4g} (tol "
          f"{MOE_NO_DROP_TOL} x {scale:.4g}); layer {ms:.4f} ms (CUDA "
          f"events, median of 10), bound {max(t_bytes, t_ops):.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
          f"{nbytes / 1e9:.3f} GB in {t_bytes:.4f} ms, {rows} capacity rows "
          f"in {t_ops:.4f} ms)")
    del p, x, y, y2


def _no_sync(fn):
    """``fn()`` with the CUDA sync debug mode at "error": a call that
    reads a value back to the host raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def phase_moe_infer(cfg, params, dev, card):
    """The LM forward ``infer`` of Qwen3-MoE (6 blocks) on 4 x 1024 tokens
    at p = 4 under full(k=2): blinded == trusted bit for bit, 16/16 ops
    checked, exact launch counts, a bit-flipping device caught op by op,
    the tier-1 boundary against the "split" plan's float one on the rows
    whose routing agrees, the trusted forward at 2 x 32 captured as a CUDA
    graph and replayed bit-equal; times and the device-busy share."""
    from repro_torch.runtime.aot import CompileCache, GraphStep
    tag = f"moe infer on {card}"
    policy = IntegrityPolicy.full(k=2)
    p = cfg.origami.tier1_layers
    ex = OrigamiExecutor(cfg, params, "origami", p, integrity=policy,
                         device=dev)
    batch = {"tokens": _lm_tokens(cfg, MOE_INFER_SHAPE, SEED + 60)}
    key = PRNGKey(SEED + 61)
    n_ops = MOE_OPS * p
    with _Routes() as routes:
        launches, _, res = counted(lambda: ex.infer(batch, key))
    check_launches(launches, GENERATE_PATH, "moe infer path")
    want = {"blind_encode": n_ops, "limb_matmul_fused": n_ops,
            "limb_fold": n_ops, "limb_matmul": 2 * n_ops,
            "flash_attention": cfg.num_layers}
    for name, n in want.items():
        assert launches[name] == n, (name, launches[name], n)
    rep, tele = res.integrity, res.telemetry
    assert rep.n_ops == rep.n_checked == n_ops and rep.ok, rep
    assert tele.calls == tele.device_matmuls == tele.verify_ops == n_ops
    assert res.logits.shape == MOE_INFER_SHAPE + (cfg.padded_vocab,)
    assert torch.isfinite(res.logits.float()).all()
    t_launches, _, trusted = counted(lambda: ex.infer(batch, key,
                                                      trusted=True))
    check_launches(t_launches, TRUSTED_GENERATE_PATH, "trusted moe infer")
    assert t_launches["limb_matmul"] == n_ops, t_launches
    if not torch.equal(res.logits, trusted.logits):
        raise AssertionError("moe infer: blinded logits differ from the "
                             "trusted recompute")
    del trusted
    split = OrigamiExecutor(cfg, params, "split", p, device=dev)
    with _Routes() as split_routes:
        split_boundary = split.infer(batch).boundary
    agree, first, means, router_rel = _route_agreement(
        routes, split_routes, p, "moe infer routing")
    n_bad = int((~agree).sum())
    d = cfg.d_model
    boundary_rel = _rel(res.boundary.reshape(-1, d)[agree],
                        split_boundary.reshape(-1, d)[agree])
    assert boundary_rel < PREFILL_REL_BOUND, boundary_rel
    boundary_rel_all = _rel(res.boundary, split_boundary)
    del split, split_boundary
    bad = OrigamiExecutor(cfg, params, "origami", p, integrity=policy,
                          fault=DishonestDevice(FaultSpec("bit_flip")),
                          device=dev)
    drep = bad.infer(batch, key).integrity
    if not torch.equal(drep.failed, drep.corrupted):
        raise AssertionError("moe infer bit_flip: failed != corrupted")
    assert drep.n_corrupted == drep.n_failed == n_ops, drep
    del bad

    # the trusted forward as a CUDA graph: a MoE forward that read a value
    # back to the host could not be captured
    small = {"tokens": _lm_tokens(cfg, MOE_CAPTURE_SHAPE, SEED + 62)}
    cap = OrigamiExecutor(cfg, params, "origami", p, integrity=policy,
                          device=dev)
    eager = cap.infer(small, key, trusted=True).logits
    cache = CompileCache()
    cap.attach_aot(cache)
    cap_ms, first_replay = _timed(lambda: cap.infer(small, key,
                                                    trusted=True))
    replay = cap.infer(small, key, trusted=True)
    graphs = [e for e in cap._executables.values()
              if isinstance(e, GraphStep)]
    stats = cache.stats()
    assert len(graphs) == 1 and stats["compiles"] == 1, stats
    assert stats["exec_fallbacks"] == 0, stats
    if not (torch.equal(first_replay.logits, eager)
            and torch.equal(replay.logits, eager)):
        raise AssertionError("moe infer: the replayed trusted forward "
                             "differs from the eager one")
    reps = dict(reps=READING_REPS, warmup=0)   # the gates' runs warmed
    replay_ms = cuda_ms(lambda: cap.infer(small, key, trusted=True), **reps)
    small_ms = cuda_ms(lambda: cap.infer(small, key, trusted=True,
                                         jit=False), **reps)
    del cap, cache, graphs, first_replay, replay, eager
    _free()

    blinded_ms = cuda_ms(lambda: ex.infer(batch, key), **reps)
    trusted_ms = cuda_ms(lambda: ex.infer(batch, key, trusted=True), **reps)
    open_ms = cuda_ms(lambda: ex.reference(batch), **reps)
    share, tops = _busy_share(lambda: ex.infer(batch, key))
    B, S = MOE_INFER_SHAPE
    print(f"{tag}: {cfg.name} at full width, {cfg.num_layers} blocks, "
          f"{B}x{S} tokens, tier-1 = blocks 1-{p}, full(k=2): blinded == "
          f"trusted (logits {tuple(res.logits.shape)} bit-equal); checks "
          f"{rep.n_checked}/{rep.n_ops}; bit_flip caught {drep.n_failed}/"
          f"{drep.n_ops} op by op; tier-1 boundary rel err vs the split "
          f"plan's float boundary {boundary_rel:.5f} (bound "
          f"{PREFILL_REL_BOUND}) over the {int(agree.sum())} of "
          f"{agree.numel()} token rows routed alike, {boundary_rel_all:.5f} "
          f"over all; block-1 router logits rel err {router_rel:.5f} (bound "
          f"{PREFILL_REL_BOUND}); {n_bad} rows route differently in tier-1 "
          f"(first in blocks 1-{p}: {first}; experts kept of "
          f"{cfg.moe.top_k}, mean a block: {[round(x, 4) for x in means]}); "
          f"launches {launches}; trusted {t_launches}")
    print(f"{tag}: trusted forward at {MOE_CAPTURE_SHAPE[0]}x"
          f"{MOE_CAPTURE_SHAPE[1]} captured as a CUDA graph (first call "
          f"{cap_ms:.1f} ms with the capture), replays bit-equal to the "
          f"eager trusted infer: replayed {replay_ms:.2f} ms, eager "
          f"{small_ms:.2f} ms (median of {READING_REPS})")
    print(f"{tag}: blinded infer {blinded_ms:.2f} ms, trusted "
          f"{trusted_ms:.2f} ms, open float forward {open_ms:.2f} ms "
          f"(median of {READING_REPS}); device-busy share of one blinded "
          f"infer "
          f"{'not measured' if share is None else f'{share:.4f}'}; top "
          f"device ops: "
          + "; ".join(f"{n} {ms:.2f} ms x{c}" for n, ms, c in tops))
    del ex, res


def phase_moe_engine(cfg, params, dev, card):
    """Qwen3-MoE in a ``ServingEngine`` (``input_key="tokens"``, max_batch
    2): two sealed 32-token requests and one of 128 in two buckets, each
    response bit-equal to an eager infer of its padded batch."""
    _serve_lm_engine("moe", cfg, params, cfg.origami.tier1_layers,
                     MOE_ENGINE_SEQS, SEED + 64, dev, card)


def phase_moe_generate_origami(cfg, params, dev, card):
    """``generate_origami`` of Qwen3-MoE on a 2 x 32 prompt with 8 new
    tokens: one count per runtime op, exact launches; the decode-plan
    paths refuse MoE; one tiered step of the prompt's 64 tokens within
    0.15 of the open float step on the rows whose routing agrees."""
    from repro_torch.core import plan as PL
    from repro_torch.core.blinding import BlindingSpec
    from repro_torch.core.slalom import SlalomContext
    from repro_torch.runtime.generate import (generate_origami,
                                              tiered_decode_step)
    tag = f"moe generate_origami on {card}"
    p = cfg.origami.tier1_layers
    prompt = _lm_tokens(cfg, MOE_ORIGAMI_SHAPE, SEED + 66)
    launches, ms, res = counted(lambda: generate_origami(
        params, prompt, cfg, max_new_tokens=MOE_ORIGAMI_NEW, partition=p,
        device=dev))
    check_launches(launches, ORIGAMI_PATH, "moe generate_origami path")
    steps = MOE_ORIGAMI_SHAPE[1] + MOE_ORIGAMI_NEW - 1
    n_ops = MOE_OPS * p * steps
    tele = res.telemetry
    assert tele.calls == tele.device_matmuls == tele.enclave_matmuls \
        == n_ops, tele
    for name in ORIGAMI_PATH:
        assert launches[name] == n_ops, (name, launches[name], n_ops)
    assert res.tokens.shape == (MOE_ORIGAMI_SHAPE[0], steps + 1)
    assert torch.equal(res.tokens[:, :MOE_ORIGAMI_SHAPE[1]], prompt)

    reason = PL._DECODE_EXCLUSIONS["moe"]
    refusals = {
        "private_generate": lambda: private_generate(
            params, prompt, cfg, max_new_tokens=2, device=dev),
        "attach_decode_plan": lambda: OrigamiExecutor(
            cfg, params, "origami", p, device=dev).attach_decode_plan()}
    for name, call in refusals.items():
        try:
            call()
        except PL.ScanExclusion as e:
            assert reason in str(e), str(e)
        else:
            raise AssertionError(f"{name} ran a MoE model: no ScanExclusion")

    # one tiered step against the open float step: every prompt token at
    # position 0, a batch of 64 independent rows
    token = prompt.reshape(-1, 1)
    n = token.shape[0]
    with torch.no_grad():
        with _Routes() as open_routes:
            open_step, _ = M.decode_step(params, token, M.init_caches(
                cfg, n, 8, device=dev), 0, cfg)
        with _Routes() as priv_routes:
            priv_step, _ = tiered_decode_step(
                params, token, M.init_caches(cfg, n, 8, device=dev), 0, cfg,
                SlalomContext(PRNGKey(7), BlindingSpec()), p)
    agree, first, means, router_rel = _route_agreement(
        priv_routes, open_routes, cfg.num_layers,
        "moe generate_origami step routing")
    n_bad = int((~agree).sum())
    rel = _rel(priv_step[agree], open_step[agree])
    assert rel < 0.15, rel
    rel_all = _rel(priv_step, open_step)
    open_ms, opened = _timed(lambda: generate(
        params, prompt, cfg, max_new_tokens=MOE_ORIGAMI_NEW, device=dev))
    assert opened.tokens.shape == res.tokens.shape
    print(f"{tag}: {MOE_ORIGAMI_SHAPE[0]}x{MOE_ORIGAMI_SHAPE[1]} prompt, "
          f"{MOE_ORIGAMI_NEW} new, tier-1 = blocks 1-{p}: {steps} tiered "
          f"steps in {ms:.1f} ms ({ms / steps:.2f} ms a step); telemetry "
          f"calls {tele.calls} == {MOE_OPS} x {p} x {steps}; "
          f"private_generate and attach_decode_plan refuse MoE "
          f"(ScanExclusion); rel err of one tiered step vs the open float "
          f"step {rel:.5f} (bound 0.15) over the {int(agree.sum())} of {n} "
          f"rows routed alike, {rel_all:.5f} over all; block-1 router logits "
          f"rel err {router_rel:.5f} (bound {PREFILL_REL_BOUND}); {n_bad} "
          f"rows route differently (first in blocks 1-{cfg.num_layers}: "
          f"{first}; "
          f"experts kept of {cfg.moe.top_k}, mean a block: "
          f"{[round(x, 4) for x in means]}); "
          f"open generate of the same prompt {open_ms:.1f} ms; launches "
          f"{launches}")


# -- dense LMs at head width 128 and MiniCPM3's MLA at full width -----------

# new tokens of the bit_flip drills of phases 26 and 28: the prompt pass
# and one token step, both kinds of op (a 16-token drill took ~10 s)
DRILL_NEW = 2


def _load_model(arch, dev):
    """The published config at every width and depth and its random bf16
    weights (seed SEED, norms float32) on ``dev``; the set-up printed."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = M.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers at full width, "
          f"{sum(t.numel() for t in _leaves(params))} params (bf16, norms "
          f"float32, seed {SEED}) in "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, made in "
          f"{time.perf_counter() - t0:.2f} s")
    return cfg, params


def _replayed_step(cfg, ex, prompt, tag, step_ops):
    """``warm_decode_aot`` through a ``CompileCache`` (the trusted prompt
    pass and the slot-fed and trusted token steps: 3 captures), then the
    slot-fed token step's replay held bit-equal to the eager
    ``decode_once`` in logits, caches, report and launches; eager and
    replayed times and busy shares printed."""
    from repro_torch.runtime.aot import CompileCache
    cache = CompileCache()
    ex.attach_aot(cache)
    total = PROMPT_LEN + NEW_TOKENS
    warm_ms, n = _timed(lambda: ex.warm_decode_aot(GEN_BATCH, PROMPT_LEN,
                                                   total))
    assert n == 3 and cache.stats()["compiles"] == 3, cache.stats()
    pos, eager_ms, replay_ms, busy, tops, kernel_ms, launches = \
        _step_readings(ex, cfg, prompt, PRNGKey(SEED + 33), new=NEW_TOKENS,
                       n_step=step_ops * cfg.origami.tier1_layers)
    st = cache.stats()
    assert st["compiles"] == 3 and st["exec_fallbacks"] == 0, st
    fmt = ["not measured" if b is None else f"{b:.4f}" for b in busy]
    print(f"{tag}: warm_decode_aot {warm_ms:.1f} ms (3 CUDA-graph "
          f"captures); slot-fed token step (batch {GEN_BATCH}, position "
          f"{pos}, captured at {PROMPT_LEN}; no refill running): eager "
          f"{_spread(eager_ms)}, replayed {_spread(replay_ms)}; replay "
          f"bit-equal to eager in logits, caches and report, launches "
          f"{launches}; device-busy share eager {fmt[0]}, replayed "
          f"{fmt[1]}; kernel time a step (profiler) eager "
          f"{fmt_ms(kernel_ms[0])}, replayed {fmt_ms(kernel_ms[1])}")
    for kind, ops_ in zip(("eager", "replayed"), tops):
        print(f"  top device ops, {kind} token step: "
              + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in ops_))
    return eager_ms, replay_ms, kernel_ms


def phase_yi_generate(cfg, params, dev, card):
    """Yi-9B at every width and depth through ``private_generate`` (4 x
    1024 prompts, 16 new, p = 4, full(k=2)): the SmolLM generate phase's
    gates (28 ops a pass, 48 flash launches a prompt pass), the breakdown,
    and a replayed slot-fed token step bit-equal to the eager one."""
    tag = f"yi generate on {card}"
    ex, prompt, _, open_ms = _generate_gates(cfg, params, dev, tag, 7, 7,
                                             drill_new=DRILL_NEW)
    phase_generate_breakdown(cfg, ex, params, prompt, open_ms,
                             tag=f"{tag}: breakdown")
    _replayed_step(cfg, ex, prompt, tag, 7)
    del ex
    _free()


def phase_qwen25_infer(cfg, params, dev, card):
    """Qwen2.5-14B at every width and depth, its QKV biases drawn
    non-zero from the seed (the reference's init zeroes them), through
    ``OrigamiExecutor.infer`` on 4 x 256 tokens at p = 4: the lm infer
    phase's gates (28 ops checked, 48 flash launches)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 70)
    attn = params["blocks"]["attn"]
    for name in ("wq", "wk", "wv"):
        b = attn[name]["b"]
        b.copy_(0.5 * torch.randn(b.shape, generator=gen, device=dev))
    print(f"qwen2.5 infer: QKV biases drawn from N(0, 0.25): max |b| "
          + ", ".join(f"{n} {attn[n]['b'].abs().max().item():.4f}"
                      for n in ("wq", "wk", "wv")))
    _lm_infer_gates(cfg, params, dev, f"qwen2.5 infer on {card}",
                    cfg.origami.tier1_layers, 7, LM_INFER_SHAPE, SEED + 72)
    _free()


def phase_mla_generate(cfg, params, dev, card):
    """MiniCPM3-4B at every width and depth through ``private_generate``
    (4 x 1024 prompts, 16 new, p = 4, absorbed decode): the SmolLM
    generate phase's gates with 32 ops in the prompt pass and 28 a token
    step, 62 flash launches a prompt pass and none in a token step; the
    latent cache (62, 4, 1040, 288) with no v; a replayed slot-fed token
    step bit-equal to the eager one; the absorbed decode's float32
    einsums' share of a token step."""
    from repro_torch.models import attention as A
    tag = f"mla generate on {card}"
    m = cfg.mla
    ex, prompt, _, open_ms = _generate_gates(cfg, params, dev, tag, 8, 7,
                                             drill_new=DRILL_NEW)
    phase_generate_breakdown(cfg, ex, params, prompt, open_ms,
                             tag=f"{tag}: breakdown")
    eager_ms, replay_ms, kernel_ms = _replayed_step(cfg, ex, prompt, tag, 7)

    # the latent cache of a prompt pass (the captured trusted one), and one
    # eager slot-fed token step with the absorbed attention's calls kept
    total = PROMPT_LEN + NEW_TOKENS
    key = PRNGKey(SEED + 34)
    logits, caches, _ = ex.prefill_session(prompt, key, max_seq=total,
                                           trusted=True)
    width = m.kv_lora_rank + m.qk_rope_head_dim
    assert caches.v is None, "an MLA cache holds no v"
    assert tuple(caches.k.shape) == (cfg.num_layers, GEN_BATCH, total,
                                     width), caches.k.shape
    latent_bytes = caches.k.numel() * caches.k.element_size()
    gqa_bytes = (2 * cfg.num_layers * GEN_BATCH * total * cfg.num_heads
                 * cfg.resolved_head_dim * caches.k.element_size())
    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    slot = ex.decode_cache(GEN_BATCH).session_factors(key, PROMPT_LEN)
    inner, calls = A.mla_absorbed_attend, []

    def keep(*args):
        calls.append(args)
        return inner(*args)

    A.mla_absorbed_attend = keep
    try:
        step_ms, _ = _timed(lambda: ex.decode_once(
            tok, caches, PROMPT_LEN, key, slot, jit=False))
    finally:
        A.mla_absorbed_attend = inner
    assert len(calls) == cfg.num_layers, len(calls)
    att_ms = cuda_ms(lambda: [inner(*a) for a in calls], reps=READING_REPS)
    att_dev = device_ms(lambda: [inner(*a) for a in calls],
                        reps=READING_REPS)
    share = ("not measured" if att_dev is None or kernel_ms[1] is None
             else f"{att_dev / kernel_ms[1]:.4f}")
    print(f"{tag}: latent cache {tuple(caches.k.shape)} bf16, v None: "
          f"{latent_bytes} bytes against {gqa_bytes} for k and v of "
          f"{cfg.num_heads} heads of {cfg.resolved_head_dim} "
          f"({gqa_bytes / latent_bytes:.2f}x); the absorbed attention's "
          f"float32 einsums over the latent cache, {cfg.num_layers} calls a "
          f"token step: {att_ms:.3f} ms back to back (events; device "
          f"{fmt_ms(att_dev)}) against an eager slot-fed step of "
          f"{step_ms:.1f} ms and a replayed one's kernels "
          f"{fmt_ms(kernel_ms[1])}: {share} of the replayed step's device "
          f"time")
    del ex, caches, calls, slot
    _free()


def phase_mla_infer(cfg, params, dev, card):
    """MiniCPM3-4B: ``OrigamiExecutor.infer`` on 4 x 256 tokens at p = 4
    (32 ops checked, 62 flash launches) and ``generate_origami`` on a 2 x
    32 prompt with 8 new tokens (7 x 4 x 39 counts and launches)."""
    p = cfg.origami.tier1_layers
    _lm_infer_gates(cfg, params, dev, f"mla infer on {card}", p, 8,
                    LM_INFER_SHAPE, SEED + 80)
    _free()
    _generate_origami_gates(cfg, params, dev,
                            f"mla generate_origami on {card}", p)


# -- the SSM and hybrid families: Zamba2-1.2B and xLSTM-1.3B ----------------

SSM_INFER_SHAPE = (4, 1024)                 # (batch, tokens): 4 chunks of 256
SSM_GEN_SHAPE, SSM_GEN_NEW = (4, 128), 8    # the open generate prompt
SSM_ENGINE_SEQS = (32, 32, 128)             # two buckets of max_batch 2
SSM_REPS = 1                                # timed runs of each forward
# the prompt positions over which the replayed prompt pass is held bit for
# bit to the eager one (each eager step is ~70-95 ms of host time)
SSM_EAGER_PREFIX = 16
# the bound of tests/test_ssm.py: the decode logits within 0.06 + 0.06 x
# |forward| of the teacher-forced forward's
DECODE_BOUND = 0.06
# blinded ops a tier-1 block: Zamba2's in_proj and out_proj; xLSTM's mLSTM
# w_up, w_igate, w_fgate and w_down
ZAMBA2_OPS, XLSTM_OPS = 2, 4


def _peak(tag):
    print(f"{tag}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()


def _prompt_pass(cfg, params, prompt, dev, graphed):
    """(ms, the last position's logits (B, V) float32, the state) of
    ``prefill_recurrent`` on ``prompt``: eager, or through a
    ``RecurrentStep`` (one CUDA graph; its capture is not timed)."""
    from repro_torch.runtime.generate import RecurrentStep, prefill_recurrent
    B, S0 = prompt.shape
    with torch.no_grad():
        caches = M.init_caches(cfg, B, S0 + SSM_GEN_NEW, device=dev)
        step = (RecurrentStep(params, caches, cfg, B, dev) if graphed
                else None)
        ms, (logits, caches) = _timed(
            lambda: prefill_recurrent(params, prompt, caches, cfg, step))
    return ms, logits[:, 0].float(), caches


def _forward_gap(cfg, params, batch, got, bound, first=-1):
    """(the teacher-forced forward's ms on ``batch``, the largest |got -
    forward| over its positions ``first`` on (``got``: (B, n, V) float32),
    its margin to ``bound`` + ``bound`` x |forward|)."""
    with torch.no_grad():
        fwd_ms, full = _timed(lambda: M.forward(params, batch, cfg).logits)
    want = full[:, first:].float()
    del full
    err = (got - want).abs()
    margin = -(err - bound * (1 + want.abs())).max().item()
    return fwd_ms, err.max().item(), margin


def _state_leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _state_leaves(tree[k])]
    return [t for v in tree for t in _state_leaves(v)]


def _open_generate_gates(cfg, params, dev, tag, seed):
    """Open ``generate`` of a recurrent model on a 4 x 128 prompt. The
    prompt pass (``prefill_recurrent``) eager and replayed as one captured
    step (``RecurrentStep``, what ``generate`` runs) over the first
    ``SSM_EAGER_PREFIX`` positions: bit-equal in the last logits and in
    every state leaf. The replayed pass over the whole prompt against the
    teacher-forced ``forward`` at the last position, gated within
    ``DECODE_BOUND`` with the weights turned float32 (the recurrent and
    the chunked forms of one function) and printed for the bf16 model,
    whose rounding points differ between the two forms (a token's
    projections are one-row matmuls in the prompt pass) and whose
    heavy-tailed Mamba2 and mLSTM outputs turn one bf16 ulp into a step
    of up to 0.25. Then ``generate`` in bf16 with 8 new tokens: the
    prompt kept and the first new token the greedy pick of the prompt
    pass. The times printed. Leaves ``params`` float32."""
    prompt = _lm_tokens(cfg, SSM_GEN_SHAPE, seed)
    B, S0 = prompt.shape
    torch.cuda.reset_peak_memory_stats()
    head = prompt[:, :SSM_EAGER_PREFIX]
    eager_ms, eager, eager_state = _prompt_pass(cfg, params, head, dev,
                                                False)
    _, replayed, state = _prompt_pass(cfg, params, head, dev, True)
    if not torch.equal(replayed, eager):
        raise AssertionError(f"{tag}: the replayed prompt pass's logits "
                             f"differ from the eager pass's")
    for a, b in zip(_state_leaves(state), _state_leaves(eager_state)):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: the replayed prompt pass's state "
                                 f"differs from the eager pass's")
    n_state = sum(t.numel() * t.element_size()
                  for t in _state_leaves(state))
    del eager_state, state, replayed, eager
    replay_ms, got, _ = _prompt_pass(cfg, params, prompt, dev, True)
    fwd_ms, err, margin = _forward_gap(cfg, params, {"tokens": prompt},
                                       got[:, None], DECODE_BOUND)
    gen_ms, out = _timed(lambda: generate(params, prompt, cfg,
                                          max_new_tokens=SSM_GEN_NEW,
                                          device=dev))
    toks = out.tokens
    assert tuple(toks.shape) == (B, S0 + SSM_GEN_NEW), toks.shape
    assert torch.equal(toks[:, :S0], prompt)
    first = torch.argmax(got[:, :cfg.vocab_size], dim=-1)
    assert torch.equal(toks[:, S0], first), "first new token"
    assert 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size
    del out
    _peak(tag)
    f32 = cfg.replace(dtype="float32")
    _to_float32_in_place(params)
    _, got32, _ = _prompt_pass(f32, params, prompt, dev, True)
    _, err32, margin32 = _forward_gap(f32, params, {"tokens": prompt},
                                      got32[:, None], DECODE_BOUND)
    if margin32 < 0:
        raise AssertionError(f"{tag}: float32 prompt pass's last logits "
                             f"exceed the bound {DECODE_BOUND} + "
                             f"{DECODE_BOUND} x |forward| by {-margin32} "
                             f"(max abs err {err32})")
    step_ms = (gen_ms - replay_ms) / SSM_GEN_NEW
    print(f"{tag}: {cfg.name} {B}x{S0} prompt, {SSM_GEN_NEW} new tokens: "
          f"the prompt pass replayed as one captured step bit-equal to the "
          f"eager pass over its first {SSM_EAGER_PREFIX} positions (logits "
          f"and {n_state} bytes of state); its last logits against the "
          f"teacher-forced forward's, float32 weights: max abs err "
          f"{err32:.5f}, within {DECODE_BOUND} + {DECODE_BOUND} x |forward| "
          f"(margin {margin32:.5f}); bf16 (printed): max abs err {err:.5f}, "
          f"margin {margin:.5f}; prompt pass eager {eager_ms:.1f} ms for "
          f"{SSM_EAGER_PREFIX} positions ({eager_ms / SSM_EAGER_PREFIX:.2f} "
          f"ms a token), replayed {replay_ms:.1f} ms for {S0} "
          f"({replay_ms / S0:.2f} ms a token); "
          f"teacher-forced forward {fwd_ms:.1f} ms; generate {gen_ms:.1f} "
          f"ms (capture, replayed prompt pass and {SSM_GEN_NEW} new tokens; "
          f"~{step_ms:.2f} ms a new token past the replayed pass)")
    _free()


def _to_float32_in_place(tree):
    """Every leaf of a parameter tree replaced by its float32 copy, one at
    a time (the bf16 leaf is freed as its copy lands)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _to_float32_in_place(v)
        else:
            tree[k] = v.float()


def phase_zamba2(dev, card):
    """Zamba2-1.2B at every width and depth: ``infer`` on 4 x 1024 tokens at
    p = 3 (6 ops checked, 6 flash launches: the shared block after each
    complete group, all in tier-2), the engine's sealed requests of 32,
    32 and 128 tokens, then open ``generate`` (4 x 128 + 8), whose float32
    gate leaves the weights float32. The tier-1
    boundary's distance from the float one is printed, not gated: the
    8-bit activations of ``out_proj`` (out_norm(y) x silu(z), its absmax
    ~50 times its standard deviation) put ~6% into each block's output,
    the protocol's arithmetic, the same in the reference."""
    cfg, params = _load_model("zamba2_1_2b", dev)
    p = cfg.origami.tier1_layers
    torch.cuda.reset_peak_memory_stats()
    tag = f"zamba2 infer on {card}"
    _lm_infer_gates(cfg, params, dev, tag, p, ZAMBA2_OPS, SSM_INFER_SHAPE,
                    SEED + 90, flash=cfg.num_layers // cfg.hybrid_attn_every,
                    reps=SSM_REPS, boundary_bound=None)
    _peak(tag)
    _free()
    _serve_lm_engine("zamba2", cfg, params, p, SSM_ENGINE_SEQS, SEED + 94,
                     dev, card)
    _free()
    _open_generate_gates(cfg, params, dev, f"zamba2 generate on {card}",
                         SEED + 92)
    del params
    _free()


def _slstm_share(cfg, params, tag, seed):
    """The sLSTM blocks' CUDA-event time within one open forward on 4 x
    1024 tokens (each block a Python loop over the tokens)."""
    from repro_torch.models import ssm as S
    batch = {"tokens": _lm_tokens(cfg, SSM_INFER_SHAPE, seed)}
    inner, spans = S.slstm_forward, []

    def timed_slstm(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*a, **kw)
        end.record()
        spans.append((start, end))
        return out

    S.slstm_forward = timed_slstm
    try:
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: M.forward(params, batch, cfg), reps=1,
                             warmup=0)
    finally:
        S.slstm_forward = inner
    n_slstm = cfg.num_layers // cfg.ssm.slstm_every
    assert len(spans) == n_slstm, len(spans)
    sl_ms = sum(a.elapsed_time(b) for a, b in spans)
    print(f"{tag}: the {n_slstm} sLSTM blocks ({SSM_INFER_SHAPE[1]} "
          f"recurrent steps each) take {sl_ms:.1f} ms of an open forward's "
          f"{fwd_ms:.1f} ms ({sl_ms / fwd_ms:.4f})")


def phase_xlstm(dev, card):
    """xLSTM-1.3B at every width and depth: ``infer`` on 4 x 1024 tokens at
    p = 3 (12 ops checked, no flash launch), the sLSTM blocks' share of
    the open forward, and open ``generate`` (4 x 128 + 8). No busy share:
    a forward launches ~150k kernels (the six sLSTM blocks' token loops),
    and a profiler trace of one took minutes to read."""
    cfg, params = _load_model("xlstm_1_3b", dev)
    torch.cuda.reset_peak_memory_stats()
    tag = f"xlstm infer on {card}"
    _lm_infer_gates(cfg, params, dev, tag, cfg.origami.tier1_layers,
                    XLSTM_OPS, SSM_INFER_SHAPE, SEED + 96, flash=0,
                    reps=SSM_REPS, boundary_bound=None, busy=False)
    _peak(tag)
    _free()
    _slstm_share(cfg, params, tag, SEED + 96)
    _open_generate_gates(cfg, params, dev, f"xlstm generate on {card}",
                         SEED + 98)
    del params
    _free()


# -- the cross-attention families: Llama-3.2-Vision-11B and Whisper-small --

VLM_INFER_SHAPE = (4, 1024)             # (batch, tokens), 4 x 1601 patches
VLM_GEN_SHAPE, VLM_GEN_NEW = (4, 1024), 8
WHISPER_INFER_SHAPE = (4, 448)          # (batch, tokens), 4 x 1500 frames
WHISPER_GEN_SHAPE, WHISPER_GEN_NEW = (4, 64), 8
# blinded ops a tier-1 block: a VLM self block's q, k, v, o, gate, up and
# down; a Whisper encoder block's q, k, v, o, up and down
VLM_OPS, WHISPER_OPS = 7, 6
# the bound of the reference's tests/test_attention.py (the prompt pass,
# then decode, against the teacher-forced forward): 0.05 + 0.05 x |forward|
CROSS_DECODE_BOUND = 0.05
MEMORY_STD = 0.1                        # the reference's tests' N(0, 0.1^2)


class _FlashCalls:
    """Counts the attention calls ``models/attention.py`` hands the flash
    wrapper inside the block, by (causal, key length, dtype). ``check``:
    each call's output is also held against the plain version's float32
    result on the same inputs, the largest relative Frobenius error kept
    in ``rel`` by (causal, query length, key length, dtype). ``plain``:
    the plain version answers in place of the kernel."""

    def __init__(self, check=False, plain=False):
        self.check, self.plain = check, plain

    def __enter__(self):
        from repro_torch.models import attention as A
        self.module, self.inner = A, A.flash_attention_fwd
        self.calls, self.rel = {}, {}

        def spy(q, k, v, *, causal=True):
            key = (causal, k.shape[1], str(q.dtype)[6:])
            self.calls[key] = self.calls.get(key, 0) + 1
            if self.plain:
                return flash_attention_plain(q, k, v, causal=causal)
            out = self.inner(q, k, v, causal=causal)
            if self.check:
                exact = flash_attention_plain(q.float(), k.float(), v.float(),
                                              causal=causal)
                at = (causal, q.shape[1]) + key[1:]
                self.rel[at] = max(self.rel.get(at, 0.0),
                                   _rel_frobenius(out, exact))
            return out

        A.flash_attention_fwd = spy
        return self

    def __exit__(self, *exc):
        self.module.flash_attention_fwd = self.inner


def _memory(cfg, batch, seed, dev):
    """A cross-attention model's memory from N(0, 0.1^2) on ``dev``:
    {"frames": (batch, 1500, d)} or {"patches": (batch, 1601, d)},
    float32."""
    key, n = (("frames", cfg.encoder_seq_len) if cfg.family == "audio"
              else ("patches", cfg.vision_seq_len))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {key: torch.randn((batch, n, cfg.d_model), generator=gen,
                             device=dev) * MEMORY_STD}


def _cross_decode(cfg, params, prompt, memory, new):
    """The open prompt pass (``prefill`` or ``prefill_vlm``) and ``new``
    greedy ``decode_step`` tokens: (prompt pass ms, ms a token, the
    logits (B, new + 1, V) float32 of the prompt's last position and of
    every step, the tokens (B, S0 + new) they were fed)."""
    B, S0 = prompt.shape
    fill = M.prefill if cfg.family == "audio" else M.prefill_vlm
    with torch.no_grad():
        fill_ms, (logits, caches) = _timed(lambda: fill(
            params, {"tokens": prompt, **memory}, cfg, max_seq=S0 + new))
        got = [logits[:, 0].float()]
        toks = [prompt]
        nxt = torch.argmax(got[0][:, :cfg.vocab_size], dim=-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(S0, S0 + new):
            toks.append(nxt[:, None])
            logits, caches = M.decode_step(params, nxt[:, None], caches, t,
                                           cfg)
            got.append(logits[:, 0].float())
            nxt = torch.argmax(got[-1][:, :cfg.vocab_size], dim=-1)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / new
    return (fill_ms, step_ms, torch.stack(got, dim=1),
            torch.cat(toks, dim=1))


def _cross_generate_gates(cfg, params, dev, tag, shape, new, seed):
    """The open prompt pass and ``new`` greedy decode tokens
    (``_cross_decode``) against the teacher-forced forward over the same
    tokens at the prompt's last position and every step, at
    ``CROSS_DECODE_BOUND``: gated with the weights turned float32 in place
    (the caches stay bf16, as the reference's). With the bf16 weights the
    gap is printed three ways: against the forward fed the memory in bf16,
    as the prompt pass casts it (both sides attend it through the bf16
    kernel, the decode steps at one query); against the forward over the
    float32 memory (for the VLM, whose forward keeps its patches float32,
    the split between the float32 and bf16 cross attentions); and with
    every attention through the plain version on both sides (no kernel:
    what is left is the bf16 model's own rounding). The bf16 path is gated
    call by call: every attention of the prompt pass and the decode steps
    within ``CROSS_REL_TOL`` of the plain version on its own inputs. The
    times printed. Leaves ``params`` float32."""
    S0 = shape[1]
    prompt = _lm_tokens(cfg, shape, seed)
    memory = _memory(cfg, shape[0], seed + 1, dev)
    half = {k: t.to(torch.bfloat16) for k, t in memory.items()}

    def gap(c, mem, run):
        got, toks = run[2:]
        return _forward_gap(c, params, {"tokens": toks, **mem}, got,
                            CROSS_DECODE_BOUND, S0 - 1)

    run = _cross_decode(cfg, params, prompt, half, new)
    fill_ms, step_ms = run[:2]
    fwd_ms, err, margin = gap(cfg, half, run)
    _, err_s, margin_s = gap(cfg, memory, run)
    del run
    with _FlashCalls(check=True) as fc:
        _cross_decode(cfg, params, prompt, half, new)
    with _FlashCalls(plain=True):
        _, err_p, margin_p = gap(cfg, half, _cross_decode(cfg, params, prompt,
                                                          half, new))
    _free()
    _to_float32_in_place(params)
    f32 = cfg.replace(dtype="float32")
    run = _cross_decode(f32, params, prompt, memory, new)
    fill32, step32 = run[:2]
    _, err32, margin32 = gap(f32, memory, run)
    del run
    rel = {f"{'causal' if c else 'non-causal'} {sq}x{skv} {dt}": round(r, 6)
           for (c, sq, skv, dt), r in sorted(fc.rel.items())}
    print(f"{tag}: {cfg.name} open prompt pass on {shape[0]}x{S0} tokens "
          f"and {new} greedy decode_step tokens against the teacher-forced "
          f"forward at each position, bound {CROSS_DECODE_BOUND} + "
          f"{CROSS_DECODE_BOUND} x |forward|: float32 weights max abs err "
          f"{err32:.5f} (margin {margin32:.5f}); bf16 weights (printed) max "
          f"abs err {err:.5f} (margin {margin:.5f}) with the memory in bf16 "
          f"on both sides, {err_s:.5f} (margin {margin_s:.5f}) against the "
          f"forward over float32 memory, {err_p:.5f} (margin "
          f"{margin_p:.5f}) with every attention through the plain version "
          f"on both sides; each attention call of the bf16 prompt pass and "
          f"decode against the plain version on its inputs, the largest "
          f"relative Frobenius err by kind {rel}; bf16 prompt pass "
          f"{fill_ms:.1f} ms, {step_ms:.2f} ms a token, forward "
          f"{fwd_ms:.1f} ms; float32 prompt pass {fill32:.1f} ms, "
          f"{step32:.2f} ms a token")
    if margin32 < 0:
        raise AssertionError(f"{tag}: the float32 prompt pass and decode "
                             f"steps exceed {CROSS_DECODE_BOUND} + "
                             f"{CROSS_DECODE_BOUND} x |forward| by "
                             f"{-margin32} (max abs err {err32})")
    bad = {k: r for k, r in fc.rel.items()
           if not r <= CROSS_REL_TOL[getattr(torch, k[3])]}
    if bad or not any(sq == 1 for _, sq, _, _ in fc.rel):
        raise AssertionError(f"{tag}: attention calls of the bf16 prompt "
                             f"pass and decode off the plain version "
                             f"beyond {CROSS_REL_TOL}: {bad}, or no decode "
                             f"step attended ({sorted(fc.rel)})")
    _peak(tag)


def _cross_infer(cfg, params, dev, tag, block_ops, shape, seed, flash_want):
    """``_lm_infer_gates`` on ``shape`` tokens and the model's memory at
    the config's partition, with the attention calls counted by kind
    (``flash_want``: {(causal, key length, dtype): calls})."""
    p = cfg.origami.tier1_layers
    torch.cuda.reset_peak_memory_stats()
    with _FlashCalls() as fc:
        _lm_infer_gates(cfg, params, dev, tag, p, block_ops, shape, seed,
                        flash=sum(flash_want.values()), reps=SSM_REPS,
                        boundary_bound=None,
                        memory=_memory(cfg, shape[0], seed + 1, dev))
        calls = dict(fc.calls)
    # the gates' own runs (blinded, trusted, split, bit_flip, timings)
    # each attend the same; the first blinded run's share is one in n
    n_runs = sum(calls.values()) // sum(flash_want.values())
    assert all(c == n_runs * flash_want.get(k, 0)
               for k, c in calls.items()) and set(calls) == set(flash_want), \
        (calls, flash_want)
    print(f"{tag}: attention calls a forward by (causal, keys, dtype): "
          f"{ {k: c // n_runs for k, c in sorted(calls.items())} }")
    _peak(tag)
    _free()


def phase_vlm(dev, card):
    """Llama-3.2-Vision-11B at every width and depth: ``infer`` on 4 x 1024
    tokens and 4 x 1601 float32 patches at p = 4 (28 ops checked, 40
    flash launches: 32 causal bf16, 8 cross float32 over 1601 keys), then
    ``prefill_vlm`` and 16 decode tokens against the forward. The
    cross-block gates, zero at init (a block would add nothing), are
    drawn from U(0.25, 0.75)."""
    cfg, params = _load_model("llama3_2_vision_11b", dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 100)
    for name in ("attn_gate", "mlp_gate"):
        g = params["cross_groups"][name]
        g.copy_(torch.rand(g.shape, generator=gen, device=dev) * 0.5 + 0.25)
    groups = cfg.num_layers // cfg.cross_attn_every
    _cross_infer(cfg, params, dev, f"vlm infer on {card}", VLM_OPS,
                 VLM_INFER_SHAPE, SEED + 102,
                 {(True, VLM_INFER_SHAPE[1], "bfloat16"):
                      cfg.num_layers - groups,
                  (False, cfg.vision_seq_len, "float32"): groups})
    _cross_generate_gates(cfg, params, dev, f"vlm generate on {card}",
                          VLM_GEN_SHAPE, VLM_GEN_NEW, SEED + 104)
    del params
    _free()


def phase_whisper(dev, card):
    """Whisper-small at every width and depth: ``infer`` on 4 x 448 tokens
    and 4 x 1500 frames at p = 2 (12 ops checked, 36 flash launches: 12
    non-causal encoder, 12 causal decoder and 12 cross attentions), then
    the audio ``prefill`` on 4 x 64 tokens and 32 decode tokens against
    the forward."""
    cfg, params = _load_model("whisper_small", dev)
    L_, frames = cfg.num_layers, cfg.encoder_seq_len
    _cross_infer(cfg, params, dev, f"whisper infer on {card}", WHISPER_OPS,
                 WHISPER_INFER_SHAPE, SEED + 106,
                 {(False, frames, "bfloat16"): 2 * L_,
                  (True, WHISPER_INFER_SHAPE[1], "bfloat16"): L_})
    _cross_generate_gates(cfg, params, dev, f"whisper generate on {card}",
                          WHISPER_GEN_SHAPE, WHISPER_GEN_NEW, SEED + 108)
    del params
    _free()


TRAIN_ARCH = "smollm_135m"
TRAIN_SHAPE = (8, 1024)                 # (batch, tokens) of every train step
TRAIN_STEPS = 10
TRAIN_TCFG = dict(learning_rate=1e-3, warmup_steps=5, total_steps=30)
TRAIN_MARGIN = 0.2                      # the reference test's loss drop
RESUME_TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
RESUME_STEPS = (4, 2)                   # straight, and where the save is
GRAD_REL_TOL = 1e-4                     # float32, kernels vs plain
MICRO_LOSS_TOL = 5e-2                   # the reference test's bound
TRAIN_PATH = ("flash_attention", "flash_attention_bwd")
# the families trained after SmolLM, through the same gates but the resume
# and microbatch checks (family-agnostic; SmolLM's phase keeps them):
# (arch, its TrainConfig). At TRAIN_TCFG's 1e-3 both losses swung by
# several nats a step and ended above where they began; Zamba2-1.2B takes
# the reference CLI's rate, 3e-4, in that schedule; MiniCPM3-4B swung there
# too, and under the CLI's 10 warm-up steps, so it takes the reference's
# default TrainConfig() (3e-4 over 100 warm-up steps of 1000):
# scripts/torch_train_schedules.py prints the four curves of each. Its
# 4.26 B parameters take the reference's bf16 moments ("for very large
# models"): with float32 ones the update's old and new state (~95 GB) would
# not fit the card
FAMILY_TRAIN = (("minicpm3_4b", dict(moment_dtype="bfloat16")),
                ("zamba2_1_2b", dict(TRAIN_TCFG, learning_rate=3e-4)))
FAMILY_TRAIN_STEPS = 5
FAMILY_GRAD_SHAPE = (2, 1024)           # (batch, tokens) of their gradients


class _StepRecorder:
    """A ``StepWatchdog`` for ``train`` that also keeps each step's launch
    counts (read after the step's loss, which waits for its kernels), and
    the seconds and peak device memory of the trainer's keyed init."""

    def __init__(self):
        from repro_torch.runtime.straggler import StepWatchdog
        self.watchdog, self.launches = StepWatchdog(), []
        self.init_s = self.init_peak = None

    def __getattr__(self, name):
        return getattr(self.watchdog, name)

    def start_step(self):
        self._before = dict(KB.LAUNCHES)
        self.watchdog.start_step()

    def end_step(self):
        self.launches.append({k: KB.LAUNCHES[k] - self._before[k]
                              for k in KB.KERNELS})
        return self.watchdog.end_step()

    def timed(self, init):
        """``init`` (``init_train_state``), its seconds and peak kept."""
        def run(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = init(*args, **kw)
            torch.cuda.synchronize()
            self.init_s = time.perf_counter() - t
            self.init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            return out
        return run


def _train(cfg, tcfg, steps, dev, recorder=None, **kw):
    """``launch/train.py:train`` at ``TRAIN_SHAPE`` on ``dev``; with
    ``recorder`` its watchdog, which also times the keyed init."""
    from repro_torch.launch import train as TR
    made, init = TR.StepWatchdog, TR.init_train_state
    if recorder is not None:
        TR.StepWatchdog = lambda: recorder
        TR.init_train_state = recorder.timed(init)
    try:
        return TR.train(cfg, tcfg, batch=TRAIN_SHAPE[0], seq=TRAIN_SHAPE[1],
                        steps=steps, log_every=0, device=dev, **kw)
    finally:
        TR.StepWatchdog, TR.init_train_state = made, init


class _PlainAttention:
    """Inside the block, training attention runs the plain versions (the
    forward with its lse, the materialized backward) in the kernels'
    place."""

    def __enter__(self):
        from repro_torch.models import attention as A
        self.module = A
        self.saved = (A.flash_attention_fwd, A.flash_attention_bwd)
        A.flash_attention_fwd = flash_attention_plain
        A.flash_attention_bwd = flash_attention_bwd_plain
        return self

    def __exit__(self, *exc):
        (self.module.flash_attention_fwd,
         self.module.flash_attention_bwd) = self.saved


class _BwdCheck:
    """Holds every backward call inside the block against the plain
    backward on the same inputs: the largest relative Frobenius error of
    dq, dk and dv in ``rel``, the calls in ``calls``."""

    def __enter__(self):
        from repro_torch.models import attention as A
        self.module, self.inner = A, A.flash_attention_bwd
        self.rel, self.calls = 0.0, 0

        def spy(q, k, v, out, lse, dout, *, causal=True):
            got = self.inner(q, k, v, out, lse, dout, causal=causal)
            want = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                             causal=causal)
            self.calls += 1
            self.rel = max([self.rel] + [_rel_frobenius(g, w.float())
                                         for g, w in zip(got, want)])
            return got

        A.flash_attention_bwd = spy
        return self

    def __exit__(self, *exc):
        self.module.flash_attention_bwd = self.inner


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _leaf_gaps(a, b):
    """(the largest relative Frobenius gap of tree ``a`` from ``b`` over
    their leaves, its leaf's path)."""
    fb = dict(_named_leaves(b))
    gaps = {k: _rel_frobenius(t, fb[k].float()) for k, t in _named_leaves(a)}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _train_flash_launches(cfg):
    """(flash forward, flash backward) launches of one train step of
    ``cfg``, from the port's training forward (``models/model.py``): a
    block under remat runs its forward twice, once in the forward and once
    in the backward's recompute; Zamba2's shared attention block, after
    each complete group of ``hybrid_attn_every`` Mamba2 blocks, runs
    outside remat, as in the reference."""
    if cfg.family == "hybrid":
        n = cfg.num_layers // cfg.hybrid_attn_every
        return n, n
    assert cfg.family in ("dense", "moe"), cfg.family
    return (1 if cfg.remat == "none" else 2) * cfg.num_layers, cfg.num_layers


def _keyed_params(cfg, seed, dev):
    """The trainer's parameters (the reference's keyed init), without its
    moments."""
    from repro_torch.core import prng
    from repro_torch.models import layers as L
    return L.init_params_keyed(prng.PRNGKey(seed), M.model_defs(cfg),
                               M.torch_dtype(cfg.dtype), device=dev)


def _pipeline_batch(cfg, shape, seed, dev):
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, shape[1], shape[0],
                                    seed=seed))
    return {"tokens": torch.from_numpy(pipe.batch(0)["tokens"]).to(dev)}


def _train_gates(cfg, tcfg, steps, grad_shape, dev):
    """One family trained at every width and depth, from the reference's
    keyed init: (b) ``steps`` steps through ``launch/train.py:train`` on
    the pipeline's batches of ``TRAIN_SHAPE``, every loss finite and the
    last below the first by more than ``TRAIN_MARGIN``, exactly
    ``_train_flash_launches(cfg)`` flash forward and backward launches a
    step and no other kernel; the init's seconds and peak, each step's
    time and the peak memory printed; one more step under
    ``torch.profiler``: its device-busy share and top device ops; (c) one
    batch of ``grad_shape``: its gradients with the kernels against the
    plain attention's, in float32 weights with TF32 off, each leaf within
    ``GRAD_REL_TOL``; in bf16 every backward call within ``BWD_REL_TOL``
    of the plain backward on its own inputs and two gradients bit-equal.
    Returns ((b)'s launch counts, a batch of ``TRAIN_SHAPE``)."""
    from repro_torch.launch import steps as S
    torch.backends.cuda.matmul.allow_tf32 = False
    n_fwd, n_bwd = _train_flash_launches(cfg)
    tag = f"train {cfg.name}"

    # (b) training
    rec = _StepRecorder()
    launches, wall, (params, opt, losses) = counted(
        lambda: _train(cfg, tcfg, steps, dev, rec))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    check_launches(launches, TRAIN_PATH, f"{tag} phase")
    want = {"flash_attention": n_fwd, "flash_attention_bwd": n_bwd}
    for i, got in enumerate(rec.launches):
        for name in KB.KERNELS:
            if got[name] != want.get(name, 0):
                raise AssertionError(f"{tag} step {i + 1}: {got[name]} "
                                     f"{name} launches, expected "
                                     f"{want.get(name, 0)}")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    if not losses[-1] < losses[0] - TRAIN_MARGIN:
        raise AssertionError(f"{tag}: the loss fell from {losses[0]} to "
                             f"{losses[-1]}, not by {TRAIN_MARGIN}; losses "
                             f"{losses}")
    step_ms = [t * 1e3 for t in rec.watchdog.history]
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{tag} (every width and depth, {n_params} params, {cfg.dtype}, "
          f"{tcfg.moment_dtype} moments, seed {tcfg.seed}; batch "
          f"{TRAIN_SHAPE[0]} x {TRAIN_SHAPE[1]} tokens, {steps} steps, lr "
          f"{tcfg.learning_rate}): loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(margin {losses[0] - losses[-1] - TRAIN_MARGIN:.4f}); {n_fwd} "
          f"flash and {n_bwd} flash_bwd launches a step, no other kernel; "
          f"step {_spread(step_ms[1:])} after the first ({step_ms[0]:.2f} "
          f"ms), wall {wall:.1f} ms with the set-up; the keyed init "
          f"{rec.init_s:.2f} s, peak {rec.init_peak:.2f} GiB; peak device "
          f"memory {peak:.2f} GiB of the card's {card_gib:.2f}")
    print("  losses: " + " ".join(f"{x:.4f}" for x in losses))
    print("  step ms: " + " ".join(f"{x:.2f}" for x in step_ms))
    batch = _pipeline_batch(cfg, TRAIN_SHAPE, tcfg.seed, dev)
    step = S.make_train_step(cfg, tcfg)
    busy, ops = _busy_share(lambda: step(params, opt, batch), top=None)
    bwd = {part: sum(ms for n, ms, _ in ops if f"flash_bwd_{part}" in n)
           for part in ("rowdot", "dkdv", "dq")}
    print(f"{tag} step under torch.profiler: device-busy share "
          f"{'not measured' if busy is None else f'{busy:.4f}'} at "
          f"{statistics.median(step_ms[1:]):.2f} ms a step (the {steps}"
          f"-step run's median after the first); the flash backward's "
          f"kernels {sum(bwd.values()):.2f} ms of device time a step (Drow "
          f"{bwd['rowdot']:.2f}, dK/dV {bwd['dkdv']:.2f}, dQ "
          f"{bwd['dq']:.2f}); top device ops: "
          + "; ".join(f"{n} {ms:.2f} ms x{c}" for n, ms, c in ops[:8]))
    del params, opt, step
    _free()

    # (c) gradients: kernels against the plain attention
    grad_batch = _pipeline_batch(cfg, grad_shape, tcfg.seed, dev)
    shape = f"{grad_shape[0]} x {grad_shape[1]}"
    f32 = cfg.replace(dtype="float32")
    params32 = _keyed_params(f32, tcfg.seed, dev)
    g_kernel, ce_kernel = S.loss_grads(params32, grad_batch, f32)
    with _PlainAttention():
        g_plain, ce_plain = S.loss_grads(params32, grad_batch, f32)
    gap, leaf = _leaf_gaps(g_kernel, g_plain)
    if not gap <= GRAD_REL_TOL:
        raise AssertionError(f"{tag} float32 gradients: {leaf} lies {gap} "
                             f"(relative Frobenius) from the plain "
                             f"attention's, bound {GRAD_REL_TOL}")
    print(f"{tag} gradients at {shape}, float32 weights, TF32 off: every "
          f"leaf within {gap:.3g} (relative Frobenius, the largest at "
          f"{leaf}; bound {GRAD_REL_TOL:g}) of the plain attention's; ce "
          f"{float(ce_kernel):.6f} vs {float(ce_plain):.6f}")
    del g_kernel, g_plain
    # the keyed init in cfg's dtype: each leaf is (normal x scale) cast to
    # its dtype, so the float32 draw cast gives the same bits
    # (tests/test_torch_train_families.py) without drawing again
    dtype = M.torch_dtype(cfg.dtype)
    params16 = tree_map(lambda t, d: t.to(d.dtype or dtype), params32,
                        M.model_defs(cfg))
    del params32
    _free()
    again = S.loss_grads(params16, grad_batch, cfg)[0]
    with _BwdCheck() as chk:
        g16, _ = S.loss_grads(params16, grad_batch, cfg)
    repeat = all(torch.equal(a, b) for a, b in zip(_leaves(g16),
                                                   _leaves(again)))
    if chk.calls != n_bwd or not chk.rel <= BWD_REL_TOL[torch.bfloat16]:
        raise AssertionError(f"{tag} bf16: {chk.calls} backward calls "
                             f"(expected {n_bwd}), the largest {chk.rel} "
                             f"from the plain backward")
    if not repeat:
        diff = [k for (k, a), b in zip(_named_leaves(g16), _leaves(again))
                if not torch.equal(a, b)]
        raise AssertionError(f"{tag} bf16: two gradients of one batch "
                             f"differ at {diff}")
    del again
    with _PlainAttention():
        g16_plain, _ = S.loss_grads(params16, grad_batch, cfg)
    gap16, leaf16 = _leaf_gaps(g16, g16_plain)
    print(f"{tag} gradients at {shape}, bf16: each of the {chk.calls} "
          f"backward calls within {chk.rel:.3g} of the plain backward on its "
          f"inputs (bound {BWD_REL_TOL[torch.bfloat16]:g}); two gradients "
          f"bit-equal; the gap to the plain attention's gradient "
          f"{gap16:.3g} (largest at {leaf16}; not gated)")
    del params16, g16, g16_plain
    _free()
    return launches, batch


def phase_train(dev, card):
    """SmolLM-135M at every width and depth through ``_train_gates``:
    ``TRAIN_STEPS`` steps of ``TRAIN_TCFG``, the gradients at
    ``TRAIN_SHAPE``; then (d) 4 steps straight against 2, an
    ``AsyncCheckpointer`` save and a resume to 4, bit-equal; (e) one step
    at 2 microbatches against 1. Returns (b)'s launch counts."""
    import dataclasses
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(**TRAIN_TCFG)
    launches, batch = _train_gates(cfg, tcfg, TRAIN_STEPS, TRAIN_SHAPE, dev)
    # (d) resume
    rtcfg = TrainConfig(**RESUME_TCFG)
    straight, half = RESUME_STEPS
    with tempfile.TemporaryDirectory() as d:
        pa, oa, _ = _train(cfg, rtcfg, straight, dev)
        t0 = time.perf_counter()
        _train(cfg, rtcfg, half, dev, ckpt_dir=d, ckpt_every=half)
        first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        pb, ob, resumed = _train(cfg, rtcfg, straight, dev, ckpt_dir=d,
                                 ckpt_every=100)
        second_ms = (time.perf_counter() - t0) * 1e3
        on_disk = sum(f.stat().st_size for f in Path(d).rglob("*")
                      if f.is_file())
    same = (len(resumed) == straight - half
            and torch.equal(oa.step, ob.step)
            and all(torch.equal(a, b) for x, y in ((pa, pb), (oa.mu, ob.mu),
                                                   (oa.nu, ob.nu))
                    for a, b in zip(_leaves(x), _leaves(y))))
    if not same:
        raise AssertionError("train: the resumed run differs from the "
                             "straight one")
    print(f"train resume: {straight} steps straight == {half}, an "
          f"AsyncCheckpointer save and a resume to {straight} (parameters "
          f"and optimizer state bit-equal); the halves took {first_ms:.0f} "
          f"and {second_ms:.0f} ms with their saves, "
          f"{on_disk / 2 ** 30:.2f} GiB on disk")
    del pa, oa, pb, ob

    # (e) microbatches
    params, opt = TR.init_train_state(cfg, tcfg, dev)
    loss = {}
    for m in (1, 2):
        step = S.make_train_step(cfg, dataclasses.replace(tcfg,
                                                          microbatches=m))
        loss[m] = float(step(params, opt, batch)[2]["loss"])
    if not abs(loss[2] - loss[1]) < MICRO_LOSS_TOL:
        raise AssertionError(f"train: microbatches 2 loss {loss[2]} against "
                             f"{loss[1]}")
    print(f"train microbatches: loss at 2 {loss[2]:.6f} against 1 "
          f"{loss[1]:.6f} (bound {MICRO_LOSS_TOL})")
    del params, opt
    _free()
    return launches


def phase_train_families(dev, card):
    """``FAMILY_TRAIN``'s families at every width and depth through
    ``_train_gates``: ``FAMILY_TRAIN_STEPS`` steps of each family's
    ``TrainConfig``, the gradients at ``FAMILY_GRAD_SHAPE``. Returns
    {arch: (b)'s launch counts}."""
    from repro_torch.configs.base import TrainConfig
    out = {}
    for arch, kw in FAMILY_TRAIN:
        out[arch] = _train_gates(get_config(arch), TrainConfig(**kw),
                                 FAMILY_TRAIN_STEPS, FAMILY_GRAD_SHAPE,
                                 dev)[0]
    return out


MESH_TRAIN_STEPS = 4                    # (a)'s runs; (c) saves at half
PSUM_SHAPE = (4096, 4096)


def _same_state(a, b):
    """Whether two (params, AdamWState) pairs, DTensors or tensors, are
    bit-equal leaf for leaf (a 1 x 1 mesh's local shard is the whole
    leaf)."""
    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t
    (pa, oa), (pb, ob) = a, b
    pairs = [(oa.step, ob.step)] + [
        (x, y) for ta, tb in ((pa, pb), (oa.mu, ob.mu), (oa.nu, ob.nu))
        for x, y in zip(_leaves(ta), _leaves(tb))]
    return all(torch.equal(local(x), local(y)) for x, y in pairs)


def phase_train_mesh(dev, card):
    """SmolLM-135M trained through ``train(mesh=make_host_mesh(1, 1))`` on
    a one-rank NCCL group: (a) bit-equal to the mesh-less trainer with
    exact launch counts, ms a step and busy shares side by side; (b)
    ``compressed_psum`` over "data" bit-equal to ``compress_decompress``;
    (c) a sharded reload onto ``remesh(plan_degraded_mesh(1))`` resumed
    bit-equal. The group is destroyed at the end, pass or fail."""
    import torch.distributed as dist
    from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    from repro_torch.parallel import compression as GC
    from repro_torch.parallel.sharding import distribute, make_plan
    from repro_torch.runtime.elastic import plan_degraded_mesh, remesh
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(**TRAIN_TCFG)
    n_fwd, n_bwd = _train_flash_launches(cfg)
    steps, tag = MESH_TRAIN_STEPS, "train mesh"
    if dist.is_initialized():
        raise AssertionError(f"{tag}: a process group is already running")
    t_phase = time.perf_counter()
    try:
        # (a) the mesh-less run, then the same steps through the mesh
        plain = _StepRecorder()
        _, _, (p0, o0, l0) = counted(lambda: _train(cfg, tcfg, steps, dev,
                                                    plain))
        mesh = LM.make_host_mesh(1, 1)
        if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
            raise AssertionError(f"{tag}: the mesh runs {dist.get_backend()} "
                                 f"on {mesh.device_type}, not NCCL on cuda")
        rec = _StepRecorder()
        launches, wall, (p1, o1, l1) = counted(
            lambda: _train(cfg, tcfg, steps, dev, rec, mesh=mesh))
        check_launches(launches, TRAIN_PATH, f"{tag} phase")
        want = {"flash_attention": n_fwd, "flash_attention_bwd": n_bwd}
        for i, got in enumerate(rec.launches):
            for name in KB.KERNELS:
                if got[name] != want.get(name, 0):
                    raise AssertionError(f"{tag} step {i + 1}: {got[name]} "
                                         f"{name} launches, expected "
                                         f"{want.get(name, 0)}")
        if l1 != l0 or not _same_state((p0, o0), (p1, o1)):
            raise AssertionError(f"{tag}: the mesh run differs from the "
                                 f"mesh-less one; losses {l1} vs {l0}")
        kinds = sorted({str(t.placements) for t in _leaves(p1)})
        ms0 = [t * 1e3 for t in plain.watchdog.history]
        ms1 = [t * 1e3 for t in rec.watchdog.history]
        batch = _pipeline_batch(cfg, TRAIN_SHAPE, tcfg.seed, dev)
        step = S.make_train_step(cfg, tcfg)
        busy0, _ = _busy_share(lambda: step(p0, o0, batch))
        plan = make_plan(cfg, ShapeConfig("custom", "train", TRAIN_SHAPE[1],
                                          TRAIN_SHAPE[0]),
                         mesh, MeshConfig(), "train")
        dbatch = distribute(batch, plan.batch_shardings(cfg, "train"))

        def mesh_step():
            with TR._mesh_scope(plan, mesh):
                step(p1, o1, dbatch)
        busy1, top1 = _busy_share(mesh_step)

        def busy(b):
            return "not measured" if b is None else f"{b:.4f}"
        print(f"{tag} (every width and depth, bf16, {steps} steps of "
              f"{TRAIN_SHAPE[0]} x {TRAIN_SHAPE[1]}, lr "
              f"{tcfg.learning_rate}; a 1 x 1 mesh over a one-rank NCCL "
              f"group, parameter placements {kinds}): losses "
              + " ".join(f"{x:.4f}" for x in l1)
              + f" bit-equal to the mesh-less run's, parameters and AdamW "
              f"state bit-equal; {n_fwd} flash and {n_bwd} flash_bwd "
              f"launches a step, no other kernel; ms a step through the "
              f"mesh {_spread(ms1[1:])} (first {ms1[0]:.2f}) against "
              f"mesh-less {_spread(ms0[1:])} (first {ms0[0]:.2f}); one "
              f"step's device-busy share {busy(busy1)} through the mesh, "
              f"{busy(busy0)} mesh-less; wall {wall:.1f} ms with the "
              f"set-up; top device ops through the mesh: "
              + "; ".join(f"{n} {ms:.2f} ms x{c}" for n, ms, c in top1[:4]))
        del p0, o0, step
        _free()

        # (b) the int8 all-reduce over the mesh's "data" group
        x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
            PSUM_SHAPE, dtype=np.float32)).to(dev)
        launches, ms, got = counted(
            lambda: GC.compressed_psum(x, "data", mesh=mesh))
        check_launches(launches, (), f"{tag} compressed_psum")
        want_x = GC.compress_decompress(x)
        if not torch.equal(got, want_x):
            raise AssertionError(f"{tag}: compressed_psum differs from "
                                 f"compress_decompress by "
                                 f"{(got - want_x).abs().max().item()}")
        print(f"{tag} compressed_psum over \"data\" (NCCL, "
              f"{mesh['data'].size()} rank) of a {PSUM_SHAPE} float32 "
              f"tensor: bit-equal to compress_decompress; {ms:.2f} ms with "
              f"its first NCCL call")
        del x, got, want_x

        # (c) a save at half, a sharded reload onto a degraded mesh, resume
        half = steps // 2
        with tempfile.TemporaryDirectory() as d:
            _train(cfg, tcfg, half, dev, mesh=mesh, ckpt_dir=d,
                   ckpt_every=half)
            mesh2 = remesh(plan_degraded_mesh(1))
            t0 = time.perf_counter()
            p2, o2, l2 = _train(cfg, tcfg, steps, dev, mesh=mesh2,
                                ckpt_dir=d, ckpt_every=100)
            resume_ms = (time.perf_counter() - t0) * 1e3
        if l2 != l1[half:] or not _same_state((p1, o1), (p2, o2)):
            raise AssertionError(f"{tag}: the resumed run differs from the "
                                 f"straight one; losses {l2} vs {l1[half:]}")
        print(f"{tag} resume: {half} steps through the mesh, an "
              f"AsyncCheckpointer save, load(..., shardings=) of the plan "
              f"over remesh(plan_degraded_mesh(1)) {tuple(mesh2.shape)} "
              f"{mesh2.mesh_dim_names} and {steps - half} steps: losses, "
              f"parameters and AdamW state bit-equal to (a)'s straight run; "
              f"the resumed half {resume_ms:.0f} ms with its load and save; "
              f"the phase {time.perf_counter() - t_phase:.1f} s")
        del p1, o1, p2, o2
    finally:
        LM.end_local_group()
    _free()


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)

    def mark(what):
        print(f"[{time.perf_counter() - t_start:.1f} s] {what} done")

    dev = torch.device("cuda")
    card = phase_card_and_build()
    mark("build")
    cfg = get_config("vgg16")
    acc = phase_kernels(cfg, dev)
    mark("kernels")
    flash = phase_flash(dev)
    mark("flash")
    server, batch, fused_launches, sealed = phase_serving(cfg, dev)
    phase_breakdown(server, batch)
    params = server.executor.params
    unfused_launches = phase_unfused_serving(cfg, params, batch, sealed, dev)
    phase_fault_drills(cfg, params, batch, dev)
    phase_recovery(cfg, params, sealed, dev)
    phase_plane(cfg, params, batch, server.executor, dev)
    del server
    torch.cuda.empty_cache()
    mark("serving, unfused serving, fault drills, recovery, plane")
    phase_planned_serving(cfg, params, dev, card)
    _free()
    mark("planned serving")
    phase_adversary_parity(dev, card)
    phase_partition_search(cfg, params, dev, card)
    del params
    torch.cuda.empty_cache()
    mark("adversary parity, algorithm 1")
    vgg16 = phase_engine_serving(dev, card)
    phase_chaos_drill(vgg16, dev, card)
    del vgg16
    torch.cuda.empty_cache()
    mark("engine serving, chaos drill")
    gen_launches = phase_generate(dev)
    mark("generate")
    lm_cfg = get_config("smollm_135m")
    lm_params = M.init_params(lm_cfg, SEED, device=dev)
    phase_lm_infer(lm_cfg, lm_params, dev, card)
    phase_lm_engine(lm_cfg, lm_params, dev, card)
    phase_generate_engine(lm_cfg, lm_params, dev, card)
    phase_sampling(lm_cfg, lm_params, dev, card)
    phase_generate_origami(lm_cfg, lm_params, dev, card)
    phase_token_probe(lm_cfg, lm_params, dev, card)
    del lm_params
    _free()
    mark("the SmolLM serving phases and the token probe")
    phase_moe_layer(dev, card)
    _free()
    moe_cfg = _moe_config()
    t0 = time.perf_counter()
    moe_params = M.init_params(moe_cfg, SEED, device=dev)
    torch.cuda.synchronize()
    print(f"moe: {moe_cfg.name}, {moe_cfg.num_layers} of 94 blocks at full "
          f"width, {sum(t.numel() for t in _leaves(moe_params))} params "
          f"(bf16, router float32, seed {SEED}) in "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, made in "
          f"{time.perf_counter() - t0:.2f} s")
    phase_moe_infer(moe_cfg, moe_params, dev, card)
    _free()
    phase_moe_engine(moe_cfg, moe_params, dev, card)
    phase_moe_generate_origami(moe_cfg, moe_params, dev, card)
    del moe_params
    _free()
    mark("the MoE phases")
    yi_cfg, yi_params = _load_model("yi_9b", dev)
    phase_yi_generate(yi_cfg, yi_params, dev, card)
    del yi_params
    mark("yi generate")
    qwen_cfg, qwen_params = _load_model("qwen2_5_14b", dev)
    phase_qwen25_infer(qwen_cfg, qwen_params, dev, card)
    del qwen_params
    _free()
    mark("qwen2.5 infer")
    mla_cfg, mla_params = _load_model("minicpm3_4b", dev)
    phase_mla_generate(mla_cfg, mla_params, dev, card)
    mark("mla generate")
    phase_mla_infer(mla_cfg, mla_params, dev, card)
    del mla_params
    _free()
    mark("mla infer, mla generate_origami")
    phase_zamba2(dev, card)
    mark("zamba2 infer, zamba2 engine, zamba2 generate")
    phase_xlstm(dev, card)
    mark("xlstm infer, xlstm generate")
    phase_vlm(dev, card)
    mark("vlm infer, vlm generate")
    phase_whisper(dev, card)
    mark("whisper infer, whisper generate")
    train_launches = phase_train(dev, card)
    mark("train")
    phase_train_families(dev, card)
    mark("train " + ", ".join(arch for arch, _ in FAMILY_TRAIN))
    phase_train_mesh(dev, card)
    mark("train mesh")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    # each kernel's launches, read on the main path that uses it
    launches = {name: (unfused_launches if name in READ_ON_UNFUSED
                       else fused_launches)[name] for name in KB.KERNELS}
    launches["flash_attention"] = gen_launches["flash_attention"]
    launches["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
    kernels = []
    for name in KB.KERNELS:
        if name.startswith("flash_attention"):
            f = flash["bwd"] if name == "flash_attention_bwd" else flash
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": f["err"], "ms": f["ms"],
                "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
                "bound_by": f["bound_by"], "library_ms": f["library_ms"]})
            continue
        a = acc[name]
        t_bytes = a["bytes"] / BYTES_S * 1e3
        t_ops = a["ops"] / a["peak"] * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": a["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
