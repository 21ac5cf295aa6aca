#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero without the
final ``ok`` line:

  env       torch / CUDA versions, the card and its power limit
  build     nvcc builds of the CUDA kernels (sm_90a), seconds taken;
            registers and spills of the main-path kernels from the
            ``-Xptxas -v`` logs, and of every decode instantiation with
            bf16 K/V (the engines' storage; none may spill) and of every
            attention forward and backward instantiation: the wgmma ones
            at (64, 1), (64, 7), (80, 1), (112, 1), (128, 1), (128, 2),
            (128, 5), (128, 8) and (128, 16) may not spill, and no bf16
            CUDA-core one may exist at those head dims; the four wgmma
            libraries (attention and SSD scan) must hold HGMMA
            instructions in their SASS (``cuobjdump -sass``) and their
            kernels must not spill (the SSD ones at d_state 128 and 64,
            keyed ``<template arguments>``); the two fp32 attention
            libraries on the tensor cores (``flash_attention_tf32x3``,
            ``flash_attention_bwd_tf32x3``: 3xTF32 by mma.sync) must
            hold HMMA instructions, their forward, dK / dV and dQ
            kernels must exist at every built pair and not spill, and
            no fp32 instantiation may remain in the CUDA-core
            ``flash_attention`` / ``flash_attention_bwd``; the two fp32
            SSD libraries (``ssd_scan_tf32x3``, ``ssd_scan_bwd_tf32x3``)
            must hold HMMA instructions and their chunk-state, output,
            C B^T and three side kernels must exist at d_state 128 and 64
            and not spill (but for the side kernels, capped at 128
            registers for two CTAs an SM; their spills are in
            ``registers``)
  kernels   each kernel against its plain PyTorch version on the card at
            main-path shapes (decode: B=8, H=16, Hkv=8, d=128, bf16
            storage, each kernel under the reference's stacked contract
            and merged with its scores, the serving path's, at ring S 256,
            S 2048 and the paged pool; the same six rows at H 64, Hkv 4,
            qwen3-moe-235b-a22b's GQA group 16, keys ending ``_g16``, at
            H 40, Hkv 8 (qwen3-14b's group 5, ``_g5``), H 64, Hkv 8
            (deepseek-67b's group 8, ``_g8``) and H 36, Hkv 36, d 64
            (minicpm-2b's MHA at head dim 64, ``_d64``) and H 14, Hkv 2,
            d 64 (internvl2-1b's group 7, ``_g7``); the merged
            dense kernel at S 2048 and the merged paged one at H 32, Hkv
            32, d 112 (zamba2-7b's group 1 at head dim 112, ``_d112``;
            the paged row lies on no model's path); attention:
            the train shape in bf16 through the wgmma
            kernels, also S 1000 non-causal, and the tf32x3 kernels in
            fp32 at train_parity's B 2, S 500; forward and backward at
            the train pairs of the vlm, audio and wider dense families
            (``TRAIN_ROWS``), in bf16 through the wgmma kernels at their
            train_* phases' shapes (internvl2-1b B 4, 14 / 2 heads of 64,
            S 2048 causal; hubert-xlarge B 8, 16 / 16 of 80, S 1500
            bidirectional; minicpm-2b B 2, 36 / 36 of 64; qwen3-14b B 1,
            40 / 8 of 128; deepseek-67b B 1, 64 / 8 of 128; zamba2-7b's
            shared block B 2, 32 / 32 of 112, keys ending ``_d112``;
            qwen3-moe-235b-a22b B 2, 64 / 4 of 128, keys ending ``_g16``;
            S 2048 causal) and in fp32 through the tf32x3 kernels at
            their train_parity_* shapes (B 2, S 500; each fp32 row also
            gives its variant, its error against ``_fwd_tf32x3`` /
            ``_bwd_tf32x3``, the plain model of the 3xTF32 split, both
            bounds, SDPA's mean over ``ATTN_REPEATS`` calls with their
            min and max and SDPA's kernels' device time by the profiler
            (``library_device_ms``, beside the kernel's
            ``kernel_device_ms``), and the backward's bit-equality across
            two calls); the forward alone in fp32
            at vlm_audio_parity's shapes: ``flash_attention_vlm_fp32_100``
            (B 2, 14 / 2 of 64, S 100 causal) and
            ``flash_attention_audio_fp32_150_noncausal`` (B 2, 4 / 4 of
            80, S 150); ssd_scan: the wgmma kernels
            in bf16 at mamba2-780m's train shape B 4, L 2048, H 48, P 64,
            N 128, chunk 128, x / B / C as views of the conv output, and
            the tf32x3 kernels in fp32 at train_parity_ssm's B 2, L
            500; the same two at zamba2-7b's H 112, N 64, bf16 at B 2, L
            2048 and fp32 at B 2, L 500, keys ending ``_n64``:
            ``SSD_ROWS``), with its time, the plain version's time, the
            bound and, where one PyTorch call computes the same
            function, that call's time (for attention also SDPA's own
            error against the same plain versions; for both the
            kernel's TFLOP/s and its share of the bound; for the SSD scan
            the device time of each of its kernels, the FLOPs the
            kernels execute beside those the bound counts, each
            gradient's error, and the errors against ``_fwd_rounded`` /
            ``_bwd_rounded``, the plain model of the wgmma kernels' bf16
            roundings, or in fp32 against ``_fwd_tf32x3`` /
            ``_bwd_tf32x3``, the plain model of the 3xTF32 split, with
            both bounds, the device time as the mean of ``ATTN_REPEATS``
            calls with their min and max, the backward's bit-equality
            across two calls, and each result's norm-wise error against
            the float64 plain versions beside the fp32 plain versions',
            held within ``F64_RATIO`` times); and the sharded engines'
            site slices
            (``SITE_ROWS``): the merged dense kernel on a view of slots
            [128, 256) and [192, 256) of a 256-slot ring (kv heads 256
            rows apart) and the merged paged kernel on blocks [512, 1024)
            and [256, 512) of the pool with ``block_offset``, at
            qwen3-0.6b's heads and, on the kernels' wide path, at
            qwen3-moe-235b-a22b's (64 / 4 of 128, keys ending ``_g16``)
            and internvl2-1b's (14 / 2 of 64, ``_g7``); and flash_attention
            forward and backward on a train grid site's heads
            (``SITE_ATTN_ROWS``: qwen3-0.6b's 16 / 8 heads of 128 over 2
            and 4 model sites, 8 / 4 and 4 / 2, B 4, S 2048 causal, bf16
            through the wgmma kernels), with SDPA at the same heads
  pam_core  the paper's core library at qwen3-0.6b decode shapes (B 8,
            H 16, Hkv 8, d 128, seed 0): ``pam_decode_attention`` over
            three tiers, HBM 256 and DDR 1,792 tokens dense and SSD 6,144
            tokens paged at block 16 (bf16 K/V, 268 MB), an eighth of the
            DDR and SSD tokens participating; it must launch the merged
            dense kernel once a dense tier and the paged kernel once, and
            match the plain versions and one dense launch over the
            concatenated tiers; wrapper and device ms, the bound, SDPA's
            ms; then for row 0 (S 8,192) label channels, approximate
            scores and the top-S/8 selection with 32 pinned, and
            ``pam_attention_step`` dense and sparse (compression 8) on
            the card against its fp32 CPU run; the greedy bank-group
            assignment over 16 groups of a 10-step activation window
            (equal to the CPU's) against round-robin and contiguous, and
            the interleaved layout; and a 512-token migration plan from
            the SSD tier's dense view into an HBM staging pool, against a
            gather oracle and the moved bytes
  engine_paged_ring   full-width qwen3-0.6b (random weights, bf16) served
            in paged + hot-ring mode; each merged decode wrapper must be
            called n_layers x the host-run body steps, the stacked ones
            never
  engine_paged_ring_full   the same with retrieval sparsity off, so
            every token past the ring is read through
            flash_decode_paged_merged
  engine_dense_pam    the same model in dense PAM mode
            (flash_decode_merged through masked_decode_attention)
  engine_cluster   the same model on a modeled ``hbm:1,cxl:2`` fleet
            (ClusterSpec, the perf model's latency models, the balancer of
            scripts/cluster_smoke.py), all three engines on this card
            sharing one copy of the weights: 24 requests of 512-1024
            prompt tokens and 64 new, 8 pinned to cxl0, 16 routed at
            Poisson gaps of 2 ms of modeled time; asserts 64 tokens each,
            >= 1 balancer migration, the merged decode wrappers n_layers x
            the fleet's host-run body steps; prints wall seconds and
            tok/s, per device steps, tokens and migrations, export /
            crc32 / import wall ms, snapshot and live KV bytes, peak
            memory, and the modeled makespan and tok/s (``modeled_``:
            the perf model's PIM hardware, not the card)
  engine_chaos   the same fleet (with engine_cluster's balancer) under
            the mixed chaos trace ``stall:cxl0@25x6, kill:cxl1@40,
            corrupt@30*1, drop@45`` and the recovery watchdog at its
            defaults, beside the same stream fault-free in this call: 16
            requests of 512-1024 prompt tokens and 32 new, 4 pinned to
            cxl1 (the kill lands on running work), 12 routed at Poisson
            gaps of 2 ms; asserts complete, gapless streams, one kill
            detected, the recovery counts of a CPU dry run of the same
            schedule (scripts/chaos_dry_run.py: the modeled schedule does
            not depend on the weights), the merged decode wrappers
            n_layers x the fleet's host-run body steps; prints wall
            seconds, decode tok/s and goodput beside the fault-free run's,
            the modeled recovery latency, wall ms of each transfer part
            (export, crc32 seal, clone, crc32 check, import, whole
            transfers), the replayed tokens recomputed, peak memory and
            the dead engine's memory (its decode graphs released: none
            left)
  serve_frontend   the same model behind ``AsyncServer`` with
            ``SLOAdmission(SLOSpec(ttft 250 ms, tpot 50 ms))``: one engine
            (paged + ring, 256-token prefill chunks, batch 8) on the
            ``pam`` system's modeled clock with each engine token standing
            for 16 hardware tokens, an onoff trace of 32 requests (prompts
            128-1024, 16-64 new, seed 0) at 128 req/s on average (512 in
            the ON windows); asserts gapless streams and the shed /
            force-preempt / resume counts of the CPU dry run; prints
            host-wall TTFT (release to the shared queue -> first token) and
            TPOT p50 / p99 and the modeled scorecard
  engine_prefix_chunk_sampled   the same model served with the prefix
            cache, chunked prefill (256-token slices) and sampling
            (temperature 0.8, top-50, seed 7), sparsity off: eight requests
            share a 760-token system prompt, request 0 first, the seven
            others once its prompt is in the trie (each hit copy-on-writes
            the shared tail block); asserts 64 tokens each, 7 hits, >= 7
            copies, >= 4 chunked admissions, slices <= 256, the merged
            decode wrappers n_layers x body steps, a paged walk over blocks two
            or more rows map, every token inside its top-50; prints TTFT,
            the counters, the sampler's launches and device ms a step
  engine_sharded   the same model on the serving template with a pool of
            1,023 blocks, sharded over 1, 2 and 4 sites in turn (every
            site on this card: tensor-parallel weight views, the ring's
            slots and the pool's blocks split, the exact Alg. 1 merge
            across sites); each run with the launch counts reset just
            before it: the merged decode wrappers shard x n_layers x the
            host-run body steps, each merged decode kernel shard x
            n_layers times in a profiled replayed step, 64 tokens a
            request, one dispatch a device step; prints decode tok/s,
            step ms, kernel nodes, the cross-site merge's device ms, a
            site's parameter bytes, the modeled merge bytes, peak memory
            and the share of tokens equal to shard 1's
  engine_sharded_moe   the same at qwen3-moe-235b-a22b's full width,
            cut to 4 of 94 layers as engine_moe (the experts split on
            their ffn dim, a site's slice of the whole SwiGLU, one fp32
            sum across sites; the (128, 16) decode kernels on a site's
            ring view and pool slice); adds the (token, expert)
            assignments dropped at capacity at prefill and decode
  engine_sharded_vlm   the same for internvl2-1b at full depth (the
            (64, 7) decode kernels; its odd vocabulary of 151,655 splits
            the embedding on d, so the tied head is a row-parallel product
            whose per-site fp32 partial logits are summed)
  decode_graph   twin engines in this call, one replaying the decode
            dispatch's CUDA graphs and one running the eager in-place
            body, full-width qwen3-0.6b paged + ring, 8 requests of
            512-1024 prompt tokens and 64 new: greedy; sampled
            (temperature 0.8, top-50) with the prefix cache and 256-token
            chunks over the shared-prompt requests; greedy at micro_steps
            4 with an EOS token. Streams and every StepBufs field must be
            equal, and each merged decode wrapper must be called n_layers x
            the host-run body steps on the graph twin; also dense PAM (the
            merged dense kernel over S 2048) as a twin pair; one replayed
            step of each graph twin under torch.profiler must run each
            merged decode kernel n_layers times; prints graphs captured,
            capture ms, steady step ms and decode tok/s of both twins, the
            kernel nodes of a single-step graph, and the card; then the
            same twin pair for full-width qwen3-moe-235b-a22b (``engine_moe``'s
            model, 8 requests, 16 new): equal streams and StepBufs, the
            group-16 merged wrappers n_layers x the host-run body steps
  profile   torch.profiler over 4 steady paged + ring decode steps (every
            Alg. 2 phase's graph captured first, so the window holds
            replays only): graph launches and kernel nodes per step, the
            decode kernels the card ran (n_layers x 4 each), device time
            by kernel, kernels per step by class (matmul,
            gather / scatter and copy kernels apart), the device's idle
            share, the host events of ``HOST_SYNCS`` per dispatch, the
            steps' peak memory, and the calls of the pool gather and
            grouped QK^T that the union mass no longer needs
  profile_prefix_chunk_sampled   the same over 4 decode steps of the
            engine_prefix_chunk_sampled engine once all eight requests run
  engine_moe  qwen3-moe-235b-a22b at full width (d 4096, 64 q / 4 kv heads
            of 128: GQA group 16; 128 experts of d_expert 1536, top-8;
            vocab 151936; random weights from seed 0, bf16), its 94 layers
            cut to ``MOE_LAYERS`` = 4 (about 22 GB of weights), served
            paged + ring with the serving template (8 requests of 512-1024
            prompt tokens, 64 new, batch 8, max_len 2048, block 16, ring
            256, the PAM of engine_paged_ring), decode through the graphs,
            with the checks and readings of the wider dense family's
            engine phases below (one body); adds the share of (token,
            expert) assignments dropped at capacity at prefill and at
            decode, and the weight bytes a step reads (all, the top-k's,
            and the experts the dense-shape dispatch reads)
  moe_parity  reduced qwen3-moe (4 experts, top-2) in fp32, TF32 off: the
            engine on the card and on the CPU (weights made on the CPU and
            copied) give equal greedy streams, paged + ring, 6 requests
            through 4 slots, at GQA group 2 and at group 16 (32 q heads
            over 2 kv heads, the decode kernels' wide path at head dim 16)
  engine_qwen3_14b, engine_deepseek_67b, engine_minicpm_2b   the wider
            dense family at full width (random weights from seed 0,
            bf16), one model on the card at a time: qwen3-14b (40 layers,
            40 q / 8 kv heads of 128: GQA group 5, 29.5 GB), deepseek-67b
            (64 / 8 of 128: group 8; its 95 layers, 134.8 GB, cut to 20,
            about 31 GB) and minicpm-2b (40 layers, 36 / 36 heads of 64:
            MHA at head dim 64, 6.0 GB), each served paged + ring with the
            serving template, decode through the graphs; asserts 64
            tokens a request, each merged decode wrapper n_layers x the
            host-run body steps and the stacked ones never, and each
            merged decode kernel of the model's (head dim, group) n_layers
            times on the card in one profiled replayed step; prints decode
            tok/s, the steady step's wall ms, the replays' device span and
            idle share over the same steps, kernel nodes a step, peak
            memory, the weight bytes a step reads beside their time at the
            HBM rate, KV bytes a token, tier reads and pool blocks read a
            step
  engine_qwen3_14b_full_pool, ... (one a model)   the same model as
            engine_paged_ring_full: sparsity off, 8 requests, 16 new;
            asserts warm and cold tier reads and pool blocks read, so the
            model's paged decode kernel walks live blocks
  gqa_parity  the same family reduced in fp32, TF32 off (qwen3-14b with
            10 q / 2 kv heads: group 5; deepseek-67b with 16 / 2: group 8;
            minicpm-2b with 4 / 4 heads of 64; internvl2-1b with 14 / 2
            of 64: group 7): the engine on the card and on the CPU give
            equal greedy streams, paged + ring, as moe_parity
  engine_internvl2_1b, engine_internvl2_1b_full_pool   the vlm family
            (24 layers, d 896, 14 q / 2 kv heads of 64: GQA group 7, 0.99
            GB, tied embeddings; random weights from seed 0, bf16) in the
            wider dense family's loop and phases, served text-only as the
            reference's engine serves it (the (64, 7) decode kernels)
  vlm_forward   the same model through its patch prefix:
            ``forward(use_kernel=True)`` with 256 patches of 1024 before
            1792 tokens at B 4 (the (64, 7) causal wgmma attention
            forward once a layer) against ``use_kernel=False``; ``prefill(patches=)``
            at B 8 (256 patches + 512 tokens, max_len 2048) and 16
            greedy decode steps through ``flash_decode_merged`` against a
            twin decoded by the plain grouped attention; launches, ms,
            the attention kernel's device ms, peak memory
  encoder_hubert_xlarge   the audio family at full width and depth (48
            layers, 16 / 16 heads of 80, bidirectional, 2.52 GB, bf16):
            ``forward(use_kernel=True)`` under no_grad over B 8 x 1500
            frames, one warm-up and 5 timed (48 wgmma attention launches
            each),
            logits against ``use_kernel=False``; median ms, frames a
            second, the attention kernel's device ms and share, peak
            memory
  vlm_audio_parity   reduced internvl2-1b (4 / 2 heads of 16, and 14 /
            2 of 64) and hubert-xlarge (4 / 2 of 16, and 4 / 4 of 80) in
            fp32, TF32 off, card against CPU: the vlm forward with
            patches, prefill(patches=) and 4 decode steps; the audio
            forward
  engine_deepseek_v2_lite_16b   the MLA mixture-of-experts family at
            full width and full depth (27 layers, d 2048, 16 heads, latent
            rank 512 + rope key 64, 64 experts of 1408, top-6 + 2 shared,
            vocab 102400; random weights from seed 0, bf16, 32.4 GB),
            served on dense PAM (the only layout the reference serves MLA
            on) with the serving template, decode through the graphs;
            asserts 64 tokens a request, no decode wrapper called (the
            reference's latent attention is an einsum, no Pallas kernel),
            the latent attention n_layers x the host-run body steps, and
            no decode kernel on the card in one profiled replayed step;
            prints the engine phases' readings with the latent bytes a
            token and read a step, the weight bytes (all, and the experts
            the dispatch reads) beside their HBM time, the dropped
            assignments, and the device ms of one step's latent attention
            (27 calls captured as a graph) beside the dense-PAM GQA
            decode kernel at like KV bytes (16 q / 2 kv heads of 128)
  mla_parity  reduced deepseek-v2-lite-16b (4 heads, r 32, 4 experts
            top-2 + 1 shared) in fp32, TF32 off: the engine on the card
            and on the CPU give equal greedy streams on dense PAM, 6
            requests through 4 slots, one of them to max_len exactly, at
            micro_steps 1 and 4 (graphs); no decode wrapper called, the
            latent attention n_layers x the host-run body steps
  engine_zamba2_7b   the hybrid family at full width and full depth
            (zamba2-7b: 13 groups of 5 Mamba-2 layers, each followed by
            one shared attention + MLP block with its own KV cache site,
            then 3 Mamba-2 layers, 81 blocks; 32 q / 32 kv heads of 112,
            d 3584, vocab 32000; random weights from seed 0, bf16, 11.47
            GB), served on dense PAM (pools are refused, as in the
            reference) with the serving template, decode through the
            graphs; asserts 64 tokens a request, flash_decode_merged
            n_groups (13) x the host-run body steps and the paged and
            stacked wrappers never, and the (112, 1) merged kernel 13
            times on the card in one profiled replayed step; prints the
            engine phases' readings with the KV bytes a token (13 sites),
            the weight bytes a step (the shared block read at each of
            its 13 sites) and the recurrent state's bytes a sequence
            (fp32 state and bf16 conv ring, read and written every step)
  hybrid_parity  reduced zamba2-7b (2 groups of 1 Mamba-2 layer + a
            tail layer, 4 q / 2 kv heads of 16), and the same with 4 q /
            4 kv heads of 112, in fp32, TF32 off: the engine on the card
            and on the CPU give equal greedy streams on dense PAM, 6
            requests through 4 slots, one of them to max_len exactly, at
            micro_steps 1 and 4 (graphs); flash_decode_merged n_groups x
            the host-run body steps, the paged wrapper never
  train_internvl2_1b, train_hubert_xlarge, train_minicpm_2b,
  train_qwen3_14b, train_deepseek_67b   the vlm, audio and wider dense
            families trained at full width (random weights from seed 0,
            bf16) for 6 steps at the train CLI's schedule with peak lr
            1e-3 (``FAMILY_LR``), one model on
            the card at a time (``TRAIN_FAMILIES``): internvl2-1b (24
            layers) at B 4 x (256 patches from seed 0 + 1792 SyntheticLM
            tokens) and hubert-xlarge (48 layers) at B 8 x 1500 frames
            with frame targets in its 504 classes, both
            through ``build_train_step`` with the state donated, as the
            CLI's; minicpm-2b (40 layers) at B 2 x 2048, qwen3-14b cut to
            8 of 40 layers and deepseek-67b to 4 of 95 at B 1 x 2048,
            through ``launch.train.run`` (12 bytes a parameter and the
            largest leaf's update temporaries: the cuts keep the peak
            under about 70 GiB); both attention kernels
            n_layers x steps times, all wgmma, no other counted kernel,
            finite losses, the last three below the first; median step
            ms, positions a second, peak memory
  train_zamba2_7b   the hybrid family at full width (d_model 3584, 32
            heads of 112, Mamba-2 at 112 heads of 64, d_state 64), its
            depth cut from 13 to 5 groups (33 of 81 blocks: 28 Mamba-2
            layers, the shared block at 5 sites, ``_cut``), bf16, B 2 x
            2048 SyntheticLM tokens through ``launch.train.run``, 6 steps
            at ``FAMILY_LR``: ssd_scan and its backward 28 x 6 times,
            flash_attention and its backward 5 x 6 times, all wgmma, no
            other counted kernel; the loss falls; step ms, tokens / s,
            peak memory
  train_qwen3_moe_235b_a22b   the GQA mixture-of-experts family at
            full width (d_model 4096, 64 / 4 heads of 128, 128 experts
            top-8 of d_expert 1536, capacity 1.25), its depth cut from
            94 to 1 layer (3.73 B parameters with the untied embedding
            and head: a donated step holds about 54 GiB; two layers
            would be about 100 GB), bf16, B 2 x 2048 SyntheticLM tokens
            through ``launch.train.run``, 6 steps at ``FAMILY_LR``:
            flash_attention and its backward at (128, 16) 1 x 6 times,
            all wgmma, no other counted kernel; the loss falls; step ms,
            tokens / s, peak memory, each step's summed Switch aux loss
            and the assignments dropped at capacity
  train_deepseek_v2_lite_16b   the MLA mixture-of-experts family at
            full width (MLA at latent rank 512, 16 heads; 64 experts
            top-6 + 2 shared), its depth cut from 27 to 6 layers, bf16,
            B 1 x 2048, the same way; its attention is the plain chunked
            one of mla_train (the reference has no MLA kernel), so no
            counted kernel may launch
  profile_train_hubert_xlarge   profile_train over 2 steps of that
            phase's configuration (also the matmul share)
  train_parity_internvl2_1b, ... (one a model with a kernel on its
            path)   the same at full width and 2 layers (zamba2-7b: 2
            groups of 1 Mamba-2 layer and a tail of 1;
            qwen3-moe-235b-a22b: 1 layer) in fp32 (TF32 off), B 2 x 500
            positions: loss and gradients through the fp32 kernels
            (ssd_scan at (64, 64) and flash_attention at (112, 1) for
            the hybrid, at (128, 16) for the MoE, all tf32x3: every SSD
            and attention launch a tf32x3 one) vs the plain chunked
            attention and scan, as train_parity; the MoE also reports the
            expert ids the two paths route apart
  train     full-width qwen3-0.6b (random weights from seed 0, bf16)
            trained 10 steps on SyntheticLM batches of 4 x 2048 through
            the train CLI's step builder (attention through the
            flash_attention kernels, forward and backward); each of the
            two must launch n_layers x steps times, every launch a wgmma
            one, and the loss must fall
  profile_train   torch.profiler over 2 train steps: device time by
            kernel, the attention kernels' and the SSD kernels' shares,
            PyTorch's elementwise kernels' share (where gradient
            accumulation shows), the device's idle share
  train_parity    full-width qwen3-0.6b in fp32 (TF32 off), B 2, S 500:
            loss and gradients through the kernels (the tf32x3
            variant: every attention launch a tf32x3 one, no wgmma
            launch) vs through the plain chunked attention
  train_sharded   the dense family trained on (data, model) site grids
            on this card (``SHARD_TRAIN_GRIDS``): full-width, full-depth
            qwen3-0.6b, bf16, B 4 x 2048, ``use_kernel``, 6 steps through
            ``launch.train.run`` on the grids (1, 1), (1, 2), (2, 2) with
            ZeRO-1 moments, (2, 2) with FSDP weights and (1, 4) with
            ``activation_spec``; both attention kernels n_layers x (data
            replicas x model sites) x steps times (each site on its own
            8 / 4 or 4 / 2 heads), all wgmma; the losses within 2e-2
            (relative, bf16) of (1, 1)'s; prints the step ms (median of
            steps 2-6), the launches a step and the heads they ran at,
            a site's parameter bytes against the whole, peak memory; and
            one more steady step under ``torch.profiler``: device busy
            ms and idle share, kernel launches, the cross-site
            reductions' calls and the device ms of their kernels
  train_shard_parity   fp32, TF32 off: qwen3-0.6b at full width cut to 2
            layers, B 4 x 512: the grids (2, 2), (1, 4) and (2, 4)
            against one site, loss, every gradient leaf (relative L2
            error; the max-norm one reported) and the parameters after 3
            AdamW steps (lr 1e-3, eps 1e-3) within 1e-5, through the tf32x3 attention kernels at
            each site's heads; and the perf flags on a (1, 4) grid (sp_pin
            and remat_dots with the kernels, sp_attn, sp_pin and
            remat_dots on the plain attention) against one site without
            them, within the same bounds
  pipeline  GPipe (``distributed.pipeline``): full-width qwen3-0.6b's
            28 blocks as 4 stages of 7, 4 microbatches of 1 x 2048 through
            the (M + S - 1)-tick schedule, forward with the flash_attention
            kernel (28 x 4 launches), bf16: equal to the unpipelined
            forward of each microbatch; the error against the whole
            batch's forward and both times reported
  parity    full-width qwen3-0.6b in fp32: teacher-forced decode steps
            through the engine's kernel-backed attention vs attention
            built from plain tensor code, logits compared
  shard_parity   fp32, TF32 off: reduced qwen3-0.6b, qwen3-moe-235b-a22b
            and internvl2-1b at vocabulary 255 (the d-parallel embedding,
            the row-parallel tied head): engines at shard 2 and 4 give
            shard 1's greedy and sampled streams; one sharded decode
            attention call equals the unsharded one (out, mass) at the
            reduced shapes and at qwen3-0.6b's, qwen3-moe-235b-a22b's and
            internvl2-1b's heads
  prefix_chunk_parity   fp32, TF32 off: (a) the sampler's keys, bits and
            tokens on the card equal its CPU run's ((8, 151936) logits, 16
            (seed, rid, pos) triples); (b) greedy streams of the shared-
            prompt requests with the prefix cache and chunked prefill on
            equal those with both off; (c) sampled streams of requests 1
            and 6 run alone equal theirs in the batch (a difference fails
            the phase with the position and both top-2 margins)
  cluster_parity  fp32, TF32 off, ``hbm:1,cxl:1``: 8 requests of 16 new
            tokens, 6 pinned to cxl0; >= 1 migration, every stream equal
            to its stream on one unmigrated engine (a difference fails
            with the request, position and top-2 margins), and export ->
            import -> export bit-equal with the same crc32
  chaos_parity    fp32, TF32 off, sampled (temperature 1.0, seed 5) as
            the reference's scripts/chaos_smoke.py: two HBM engines, (a) 8
            requests of 16 new, the second engine killed at tick 6 (its
            requests replay on the first), (b) 6 requests, the second
            stalled 50x from its prefill with the first transfer corrupted
            (its requests drain through a retried transfer); every stream
            equal to a batch-8 twin's (a difference fails with the
            position and both top-2 margins) and gapless
  train_ssm full-width mamba2-780m (48 layers, random weights from seed 0,
            bf16) trained 10 steps on SyntheticLM batches of 4 x 2048
            through the train CLI's step builder at peak lr 1e-3 (the SSD
            scan through the ssd_scan kernels, forward and backward); each
            must launch n_layers x steps times, every launch a wgmma one,
            and the loss must fall
  profile_train_ssm   torch.profiler over 2 of those train steps
  train_parity_ssm    full-width mamba2-780m in fp32 (TF32 off), B 2,
            S 500: loss and gradients through the ssd_scan kernels (the
            tf32x3 variant: every launch a tf32x3 one, no wgmma launch)
            vs through the plain chunked scan
  engine_ssm  the same model served by the PAM engine (dense cache, greedy,
            PAM on): 8 requests of 512-1024 prompt tokens, each prefilled
            at its exact length, 64 new tokens through the recurrent state
  profile_ssm torch.profiler over 4 steady decode steps of that engine

Tolerances (each kernel against its plain version on the same inputs):
  flash_decode, flash_decode_paged and their merged entry points (fp32
      partials and scores from bf16 K/V): rtol 1e-4, atol 1e-3 (summation
      order, and the kernels' exp, ex2.approx, within 2^-21 relative)
  flash_attention forward and backward, bf16 operands (wgmma kernels):
      rtol 2e-2, atol 2e-2 on the bf16 outputs (both sides compute in fp32
      and round the outputs to bf16, so they may differ by one bf16 step,
      2^-8 relative; the kernels also round P and dS to bf16 as
      tensor-core operands, whose effect tests/test_torch_flash_attention_
      sm90.py bounds on the CPU); the forward's fp32 log-sum-exp at rtol
      1e-4, atol 1e-3; fp32 operands (tf32x3 kernels): the forward at
      rtol 1e-4, atol 1e-3, the backward at rtol / atol 1e-3 (sums over
      up to S products in another order, and the 3xTF32 split's 2^-22
      relative per operand, which tests/test_torch_flash_attention_
      tf32x3.py bounds on the CPU)
  ssd_scan forward and backward: bf16 operands at rtol / atol 2e-2 (one
      bf16 rounding of the outputs, and the wgmma kernels' bf16 operands,
      whose effect tests/test_torch_ssd_scan_sm90.py bounds on the CPU;
      the forward's fp32 states at the fp32 tolerance below); fp32 at
      rtol 1e-4, atol 1e-3 (the
      order of sums and of the in-chunk prefix sum of dt a, whose rounding
      moves each exp(s_t - s_u) by a few ulp of |s|); for gradients the
      atol is scaled by max(1, the leaf's largest entry)
  train_parity (both models): loss relative difference <= 1e-5, and per
      gradient leaf max |kernel - plain| / max |plain| <= 1e-3
  parity: max |dlogit| / max(1, max |logit|) <= 1e-3 (vlm_audio_parity
      too)
  shard_parity: the sharded attention's out and mass against the
      unsharded call at atol 1e-5, rtol 1e-5 (fp32: the same kernels over
      other partitions, sums in another order); streams exactly equal
  vlm_forward, encoder_hubert_xlarge (bf16, attention kernel against
      the plain attention through the whole model): max |dlogit| /
      max(1, max |logit|) <= 5e-2 (``BF16_MODEL_TOL``: each layer's
      attention output rounds to bf16 on both sides and may differ by
      one bf16 step, which the bf16 residual stream carries on)
  pam_core: the tier-list call (fp32 q, bf16 K/V) against its plain
      versions and one dense launch at the decode kernels' rtol 1e-4,
      atol 1e-3; pam_attention_step and the approximate scores on the
      card against the CPU at rtol / atol 1e-4 (fp32, TF32 off; sums over
      up to 8,192 tokens in another order); selections, assignments,
      plans and tags exactly

Bounds: bytes over 3.35 TB/s (HBM3), and operations over 67 TFLOP/s
(fp32, CUDA cores) for the decode kernels, 989 TFLOP/s (bf16 dense
tensor cores) for bf16 flash_attention and ssd_scan, whose bf16 work a
tensor-core kernel can do, and 3 x the FLOPs over 495 TFLOP/s (TF32
dense tensor cores, three TF32 products a product) for the fp32
attention and ssd_scan rows, with the fp32-FMA bound (the FLOPs over 67
TFLOP/s) beside it; NVIDIA's H100 SXM data sheet. The SSD rows count
the FLOPs the scan's function needs at the run's chunking
(``_ssd_work``): C B^T once per group and every masked product over its
causal half, in both dtypes.

Every engine on the card dispatches its decode steps as CUDA graphs
(``serving/engine.py``): a hook that runs inside the decode body (the
sampler, a kernel wrapper) must write into device tensors in place, as
``_Margins`` and the prefix phase's accumulators do, for the graph
replays to run it. A kernel wrapper counts its calls on the host, where
it launches its kernel or records it into a graph; a replay calls no
wrapper. So a serving phase holds each merged decode wrapper at n_layers
x the micro-steps whose body ran on the host (``decode_body_steps``:
each graph's eager dispatch and its recording), and the profile phases
and ``decode_graph`` count the decode kernels the card ran over replayed
steps with torch.profiler and hold them at n_layers x those steps.

Imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12              # H100 SXM TF32 dense tensor cores
BF16_FLOPS = 989e12              # H100 SXM bf16 dense tensor cores
KERNEL_TOL = dict(rtol=1e-4, atol=1e-3)
ATTN_BF16_TOL = dict(rtol=2e-2, atol=2e-2)
ATTN_FP32_BWD_TOL = dict(rtol=1e-3, atol=1e-3)
ATTN_REPEATS = 10                # timed calls a kernel-phase attention row
PARITY_TOL = 1e-3                # max |dlogit| / max(1, max |logit|)
TRAIN_LOSS_TOL = 1e-5            # relative loss difference
TRAIN_GRAD_TOL = 1e-3            # per leaf: max |diff| / max |plain|
TRAIN_STEPS, TRAIN_B, TRAIN_S = 10, 4, 2048
PARITY_B, PARITY_S = 2, 500      # the fp32 train_parity batch
SSM_ARCH = "mamba2-780m"
SSM_LR = 1e-3                    # peak lr of the mamba2-780m train phase
SSD_FP32_TOL = dict(rtol=1e-4, atol=1e-3)
PROFILE_ATTEMPTS = 5             # captures before falling back to events


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


# ---------------------------------------------------------------- timing
def _time_stats(fn, iters: int = 20,
                flush_bytes: int = 64 << 20) -> tuple[float, float, float]:
    """(mean, min, max) ms per call on the card: CUDA events around each
    of ``iters`` calls after 3 untimed ones, the 50 MB L2 flushed before
    each (the engine's 28 layers never find their KV in L2)."""
    import torch
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sum(times) / iters, min(times), max(times)


def _time_ms(fn, iters: int = 20, flush_bytes: int = 64 << 20) -> float:
    """Mean ms per call on the card (``_time_stats``)."""
    return _time_stats(fn, iters, flush_bytes)[0]


def _device_ms_by_kernel(fn, iters: int = 20,
                         flush_bytes: int = 64 << 20) -> dict:
    """Mean device time (ms) per call of each of the port's own CUDA
    kernels (symbols in namespace ``pam``) launched by ``fn``, by kernel
    name, from torch.profiler; L2 flushed before each call as in
    ``_time_ms``. The wrapper's argument preparation is not counted.
    A capture that holds none of them is taken again, up to
    ``PROFILE_ATTEMPTS`` times, and then the whole call is timed with
    CUDA events instead (key ``cuda_events_whole_call``)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    # now and then a capture comes back with none of the kernels'
    # events (seen on an H100); capture again
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                scratch.zero_()
                fn()
            torch.cuda.synchronize()
        out: dict = {}
        for ev in prof.key_averages():
            if "pam::" in ev.key:
                m = re.search(r"pam::(?:\w+::)*(\w+)", ev.key)
                name = m.group(1) if m else ev.key[:60]
                out[name] = (out.get(name, 0.0)
                             + ev.self_device_time_total / iters / 1e3)
        if sum(out.values()) > 0:
            return out
    # the profiler saw none of the port's kernels: the call's time by
    # CUDA events, under a name that says so
    return {"cuda_events_whole_call": _time_ms(fn, iters, flush_bytes)}


def _device_ms_all(fn, iters: int = 20,
                   flush_bytes: int = 64 << 20) -> float | None:
    """Mean device time (ms) a call of every CUDA kernel ``fn`` launches
    (a library call's own kernels, not only the port's), from
    torch.profiler, L2 flushed before each call as in ``_time_ms``: the
    capture of flush + call less a capture of the flush alone. None if
    no capture holds a kernel (``PROFILE_ATTEMPTS`` tries)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")

    def total(body) -> float:
        for _ in range(PROFILE_ATTEMPTS):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    body()
                torch.cuda.synchronize()
            ms = sum(ev.self_device_time_total
                     for ev in prof.key_averages()) / iters / 1e3
            if ms > 0:
                return ms
        return 0.0

    fn()
    torch.cuda.synchronize()
    both = total(lambda: (scratch.zero_(), fn()))
    flush = total(scratch.zero_)
    return both - flush if both > 0 and flush > 0 else None


def _device_ms(fn, iters: int = 20, flush_bytes: int = 64 << 20) -> float:
    """Mean device time (ms) per call of the port's own CUDA kernels
    launched by ``fn`` (the sum of ``_device_ms_by_kernel``)."""
    return sum(_device_ms_by_kernel(fn, iters, flush_bytes).values())


def _bound_ms(nbytes: float, flops: float,
              peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def _compare(got, ref, tol=KERNEL_TOL) -> tuple[float, bool]:
    import torch
    err, ok = 0.0, True
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        err = max(err, float((g - r).abs().max()))
        ok = ok and bool(torch.allclose(g, r, **tol))
    return err, ok


# ---------------------------------------------------------------- phases
def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else ""


def phase_env() -> dict:
    import torch
    return dict(torch=torch.__version__, cuda=torch.version.cuda,
                python=sys.version.split()[0],
                device=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(),
                nvidia_smi=_card())


SM90_LIBS = ("flash_attention_sm90", "flash_attention_bwd_sm90",
             "ssd_scan_sm90", "ssd_scan_bwd_sm90")
# the fp32 attention and SSD libraries on the tensor cores (3xTF32 by
# mma.sync)
TF32_LIBS = ("flash_attention_tf32x3", "flash_attention_bwd_tf32x3",
             "ssd_scan_tf32x3", "ssd_scan_bwd_tf32x3")
# the tf32x3 SSD kernels at both built d_states, keyed as phase_build
# reads them from the -Xptxas -v logs
SSD_TF32_KERNELS = {key for n in (128, 64) for key in (
    f"ssd_state_tf32x3_kernel<true, {n}>",
    f"ssd_state_tf32x3_kernel<false, {n}>", f"ssd_out_tf32x3_kernel<{n}>",
    f"ssd_cb_tf32x3_kernel<{n}>", f"ssd_bwd_t_tf32x3_kernel<{n}>",
    f"ssd_bwd_u_tf32x3_kernel<{n}>", f"ssd_bwd_db_tf32x3_kernel<{n}>")}
# the backward's side kernels run two CTAs an SM, their registers capped
# at 128 (csrc/ssd_scan_bwd_tf32x3.cu's kSideCtas): they may spill a
# little, at most SSD_TF32_SPILL_MAX bytes of stores and of loads each
# (112 at most when the cap was set), and build reports how much
SSD_TF32_CAPPED = {f"ssd_bwd_{k}_tf32x3_kernel<{n}>" for n in (128, 64)
                   for k in ("t", "u", "db")}
SSD_TF32_SPILL_MAX = 128
# the wgmma kernels of the SSD scan at both built d_states, keyed as
# phase_build reads them from the -Xptxas -v logs (template arguments in
# angle brackets)
SSD_WGMMA_KERNELS = {key for n in (128, 64) for key in (
    f"ssd90_chunk_state_kernel<true, {n}>",
    f"ssd90_chunk_state_kernel<false, {n}>", f"ssd90_out_kernel<{n}>",
    f"ssd90_bwd_t_kernel<{n}>", f"ssd90_bwd_u_kernel<{n}>")}


def _sass_count(name: str, op: str = "HGMMA") -> int:
    """Occurrences of ``op`` in the SASS of kernel library ``name``
    (``cuobjdump -sass``)."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(build._target(name))],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        raise RuntimeError(f"cuobjdump failed for {name}: {sass.stderr}")
    return sass.stdout.count(op)


def phase_build() -> dict:
    """Builds every kernel library, then reads each main-path kernel's
    registers and spills from its ``-Xptxas -v`` log and checks that the
    wgmma libraries' SASS holds tensor-core instructions (``HGMMA``) and
    that their kernels do not spill."""
    import re
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    per = build.build_all()
    regs = {}      # bf16: head dim 128 / group 2, and the SSD kernels
    for name in build.SOURCES:
        lines = build.build_log(name).splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and (
                    ("bfloat16" in line and "Li128E" in line
                     and "Li1E" not in line)
                    or ("sm90" in line and "Li2E" in line)
                    or "ssd90" in line
                    or ("ssd" in line and "tf32x3_kernel" in line)):
                kern = re.search(
                    r"\d+((?:flash_|ssd90_|ssd_)[a-z0-9_]*?_kernel)", line)
                key = kern.group(1) if kern else name
                targs = re.findall(r"L([bi])(\d+)E", line)
                if key.startswith("ssd") and targs:  # <bool, N>, <N>
                    key += "<" + ", ".join(
                        ("true" if v == "1" else "false") if t == "b" else v
                        for t, v in targs) + ">"
                info = []
                for x in lines[i + 1:]:
                    if "Compiling entry" in x:
                        break
                    if "Used" in x or "spill" in x:
                        info.append(x.split(":", 1)[-1].strip())
                regs[key] = "; ".join(info)
    decode = _decode_registers()
    spills = {k: v for k, v in decode.items()
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", v)}
    assert not spills, f"bf16-K/V decode kernels spill: {spills}"
    from repro_torch.kernels import flash_attention as fa
    attn = _attention_registers()
    main = [f"flash_attention_fwd_sm90_kernel<bf16, {d}, {rep}>"
            for d, rep in fa.BUILT if d in fa.WGMMA_FWD_DIMS]
    assert set(main) <= set(attn), sorted(attn)
    # bf16 at the wgmma head dims has no CUDA-core instantiation
    gone = [k for k in attn if k.startswith("flash_attention_fwd_kernel<bf16")
            and int(k.split(", ")[1]) in fa.WGMMA_FWD_DIMS]
    assert not gone, f"bf16 CUDA-core forwards at wgmma head dims: {gone}"
    spills = {k: attn[k] for k in main
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", attn[k])}
    assert not spills, f"bf16 attention forward kernels spill: {spills}"
    # the same for the backward: its wgmma dK / dV and dQ kernels at every
    # built pair of its head dims, none spilling, and no bf16 CUDA-core
    # backward at those head dims
    attn_bwd = _attention_registers(backward=True)
    main = [f"flash_attention_{k}_sm90_kernel<bf16, {d}, {rep}>"
            for d, rep in fa.BUILT_BWD if d in fa.WGMMA_BWD_DIMS
            for k in ("dkdv", "dq")]
    assert set(main) <= set(attn_bwd), sorted(attn_bwd)
    gone = [k for k in attn_bwd if "sm90" not in k and "<bf16" in k
            and int(k.split(", ")[1]) in fa.WGMMA_BWD_DIMS]
    assert not gone, f"bf16 CUDA-core backwards at wgmma head dims: {gone}"
    spills = {k: attn_bwd[k] for k in main if re.search(
        r"[1-9]\d* bytes spill (stores|loads)", attn_bwd[k])}
    assert not spills, f"bf16 attention backward kernels spill: {spills}"
    hgmma = {name: _sass_count(name) for name in SM90_LIBS}
    assert all(n > 0 for n in hgmma.values()), f"no HGMMA in {hgmma}"
    # fp32: the tf32x3 kernels at every built pair (HMMA in their SASS, no
    # spills), and no fp32 instantiation left in the CUDA-core libraries
    tf32 = {**attn, **attn_bwd}
    main = ([f"flash_attention_fwd_tf32x3_kernel<fp32, {d}, {rep}>"
             for d, rep in fa.BUILT]
            + [f"flash_attention_{k}_tf32x3_kernel<fp32, {d}, {rep}>"
               for d, rep in fa.BUILT_BWD for k in ("dkdv", "dq")])
    assert set(main) <= set(tf32), sorted(tf32)
    spills = {k: tf32[k] for k in main if re.search(
        r"[1-9]\d* bytes spill (stores|loads)", tf32[k])}
    assert not spills, f"tf32x3 attention kernels spill: {spills}"
    gone = [k for k in tf32 if "<fp32" in k and "tf32x3" not in k]
    assert not gone, f"fp32 CUDA-core attention kernels remain: {gone}"
    hmma = {name: _sass_count(name, "HMMA") for name in TF32_LIBS}
    assert all(n > 0 for n in hmma.values()), f"no HMMA in {hmma}"
    assert SSD_TF32_KERNELS <= set(regs), sorted(regs)
    spills = {k: regs[k] for k in SSD_TF32_KERNELS - SSD_TF32_CAPPED
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", regs[k])}
    assert not spills, f"tf32x3 SSD kernels spill: {spills}"
    spills = {k: regs[k] for k in SSD_TF32_CAPPED if any(
        int(n) > SSD_TF32_SPILL_MAX
        for n in re.findall(r"(\d+) bytes spill", regs[k]))}
    assert not spills, (
        f"capped tf32x3 SSD kernels spill over {SSD_TF32_SPILL_MAX} "
        f"bytes: {spills}")
    spills = {k: v for k, v in regs.items() if ("sm90" in k or "ssd90" in k)
              and re.search(r"[1-9]\d* bytes spill (stores|loads)", v)}
    assert not spills, f"wgmma kernels spill: {spills}"
    assert sum("sm90" in k for k in regs) == 3, sorted(regs)
    assert SSD_WGMMA_KERNELS <= set(regs), sorted(regs)
    return dict(build_s=time.perf_counter() - t0, per_library=per,
                libraries=sorted(build.SOURCES), registers=regs,
                decode_registers_bf16_kv=decode,
                attention_forward_registers=attn,
                attention_backward_registers=attn_bwd,
                hgmma_in_sass=hgmma, hmma_in_sass=hmma)


def _decode_registers() -> dict:
    """Registers, shared memory and spills from the ``-Xptxas -v`` logs of
    every decode kernel instantiated with bf16 K/V (the engines' storage),
    keyed ``kernel<q dtype, head dim, group, stacked|merged>``."""
    import re
    from repro_torch.kernels import build
    out = {}
    for name in ("flash_decode", "flash_decode_paged"):
        lines = build.build_log(name).splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"(flash_decode(?:_paged)?_kernel)I13__nv_bfloat16"
                          r"(f|S\d*_)Li(\d+)ELi(\d+)ELb([01])E", line)
            if "Compiling entry" not in line or m is None:
                continue
            kern, tq, d, rep, merged = m.groups()
            info = []
            for x in lines[i + 1:]:
                if "Compiling entry" in x:
                    break
                if "Used" in x or "spill" in x:
                    info.append(x.split(":", 1)[-1].strip())
            q = "fp32" if tq == "f" else "bf16"
            kind = "merged" if merged == "1" else "stacked"
            out[f"{kern}<{q}, {d}, {rep}, {kind}>"] = "; ".join(info)
    return out


def _attention_registers(backward: bool = False) -> dict:
    """Registers, shared memory and spills from the ``-Xptxas -v`` logs of
    every instantiation of the three ``flash_attention`` forwards (with
    ``backward``: of the three backwards' dK / dV and dQ kernels), keyed
    ``kernel<dtype, head dim, group>``: the CUDA-core kernels (bf16 at
    head dim 16), the wgmma kernels (bf16 at the built pairs of head dims
    64-128: the main paths', none may spill) and the tf32x3 kernels (fp32
    at every pair, run by the parity phases; none may spill)."""
    import re
    from repro_torch.kernels import build
    names = (r"(flash_attention_(?:dkdv|dq)_kernel)",
             r"(flash_attention_(?:dkdv|dq)_sm90_kernel)",
             r"(flash_attention_(?:dkdv|dq)_tf32x3_kernel)") if backward else (
             r"(flash_attention_fwd_kernel)",
             r"(flash_attention_fwd_sm90_kernel)",
             r"(flash_attention_fwd_tf32x3_kernel)")
    suffix = "_bwd" if backward else ""
    out = {}
    for lib, pattern in (
            (f"flash_attention{suffix}",
             names[0] + r"I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E"),
            (f"flash_attention{suffix}_sm90",
             names[1] + r"I()Li(\d+)ELi(\d+)E"),
            (f"flash_attention{suffix}_tf32x3",
             names[2] + r"I()Li(\d+)ELi(\d+)E")):
        lines = build.build_log(lib).splitlines()
        for i, line in enumerate(lines):
            m = re.search(pattern, line)
            if "Compiling entry" not in line or m is None:
                continue
            info = []
            for x in lines[i + 1:]:
                if "Compiling entry" in x:
                    break
                if "Used" in x or "spill" in x:
                    info.append(x.split(":", 1)[-1].strip())
            kern, dt, d, rep = m.groups()
            dt = "fp32" if dt == "f" or "tf32x3" in kern else "bf16"
            out[f"{kern}<{dt}, {d}, {rep}>"] = "; ".join(info)
    return out


def _dense_case(S, seed, dead_split, heads=(16, 8), d=128):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    (H, Hkv), B = heads, 8
    q = torch.randn((B, H, d), generator=g, device="cuda")
    k = torch.randn((B, Hkv, S, d), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, Hkv, S, d), generator=g, device="cuda").bfloat16()
    mask = torch.rand((B, S), generator=g, device="cuda") < 0.5
    if dead_split:
        mask[0, 512:1024] = False                 # one split of row 0
    lens = torch.randint(S // 4, S + 1, (B,), generator=g, device="cuda")
    lens[-1] = 0                                  # an all-dead row
    return q, k, v, mask, lens


def _sdpa_ms(q, k, v, mask, lens) -> float:
    """One PyTorch call computing the same attention (the yardstick
    ``library_ms``; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    S = k.shape[2]
    qq = q.bfloat16()[:, :, None]
    am = (mask & (torch.arange(S, device="cuda")[None] < lens[:, None]))
    am = am[:, None, None, :]
    return _time_ms(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=am, enable_gqa=True))


def _decode_row(name, call, plain, nbytes, flops, **case) -> dict:
    """One decode kernel row: the wrapper ``call`` against its plain
    version on the same inputs, times, and the bound of ``nbytes`` /
    ``flops``."""
    import torch
    got = call()
    ref = plain()
    torch.cuda.synchronize()
    err, ok = _compare(got, ref)
    del got, ref
    bound, by = _bound_ms(nbytes, flops)
    dev = _device_ms(call)
    return dict(case, name=name, ok=ok, max_abs_err=err, tol=KERNEL_TOL,
                ms=_time_ms(call), kernel_device_ms=dev,
                pct_of_bound=100.0 * bound / dev, plain_ms=_time_ms(plain),
                bound_ms=bound, bound_by=by, bytes=nbytes)


def kernel_flash_decode(S: int, merged: bool = False,
                        heads=(16, 8), d: int = 128) -> dict:
    """The dense kernel at B 8, (H, Hkv) ``heads`` (qwen3-0.6b's 16 / 8 by
    default), head dim ``d``, bf16 K/V: stacked over the reference's 512-token
    splits, or merged (``flash_decode_merged``: the split from
    ``split_len``, the merge in the kernel, and the scores, whose (B, H,
    S) fp32 write the bound counts)."""
    from repro_torch.kernels import flash_decode as fd
    q, k, v, mask, lens = _dense_case(S, seed=S, dead_split=S > 512,
                                      heads=heads, d=d)
    B, H, d = q.shape
    Hkv = k.shape[1]
    scale = 1.0 / d ** 0.5
    live = fd._dense_live(mask, S, lens, B, S, q.device)
    block_s = min(fd.DEFAULT_BLOCK_S, max(S, 8))
    n_live = int(live.sum())
    nbytes = n_live * Hkv * d * 2 * 2 + q.numel() * 4 + mask.numel() + B * 4
    if merged:
        split = fd.split_len(B, Hkv, S, fd._sm_count(q.device))
        nbytes += B * H * (d + 2) * 4 + B * H * S * 4     # o, m, l, scores
        row = _decode_row(
            "flash_decode_merged",
            lambda: fd.flash_decode_merged(q, k, v, mask, kv_lens=lens,
                                           scores=True),
            lambda: fd._merged_plain(*fd._flash_decode_plain(
                q, k, v, live, scale, block_s)),
            nbytes, n_live * H * d * 4, S=S, split=split,
            nsplit=-(-S // split), grid_blocks=-(-S // split) * Hkv * B)
    else:
        nsplit = -(-S // block_s)
        nbytes += B * H * nsplit * (d + 2) * 4
        row = _decode_row(
            "flash_decode",
            lambda: fd.flash_decode(q, k, v, mask, kv_lens=lens),
            lambda: fd._flash_decode_plain(q, k, v, live, scale,
                                           block_s)[:3],
            nbytes, n_live * H * d * 4, S=S, nsplit=nsplit,
            grid_blocks=nsplit * Hkv * B)
    return dict(row, live_tokens=n_live, H=H, Hkv=Hkv, d=d,
                library_ms=_sdpa_ms(q, k, v, mask, lens))


def _paged_case(heads=(16, 8), d=128):
    """The paged kernels' inputs: B 8, (H, Hkv) ``heads``, head dim ``d``,
    bs 16, nb 128 (a 2048-token window), bf16 pools of 1,024 blocks, a
    quarter of the first 100 table entries live, 60 % of their tokens
    participating."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(7)
    (H, Hkv), B, bs, nb, NB = heads, 8, 16, 128, 1024
    q = torch.randn((B, H, d), generator=g, device="cuda")
    kp = torch.randn((NB + 1, bs, Hkv, d), generator=g,
                     device="cuda").bfloat16()
    vp = torch.randn((NB + 1, bs, Hkv, d), generator=g,
                     device="cuda").bfloat16()
    table = torch.randperm(NB, generator=g, device="cuda")[:B * nb]
    table = table.reshape(B, nb).to(torch.int32)
    table[:, 100:] = NB                          # unmapped -> sentinel
    live_blk = torch.rand((B, nb), generator=g, device="cuda") < 0.25
    live_blk[:, 100:] = False
    mask = (torch.rand((B, nb * bs), generator=g, device="cuda") < 0.6)
    mask = mask & live_blk.repeat_interleave(bs, 1)
    return q, kp, vp, table, mask, live_blk


def kernel_flash_decode_paged(merged: bool = False, heads=(16, 8),
                              d: int = 128) -> dict:
    """The paged kernel on ``_paged_case``'s inputs: stacked (one partial
    per logical block, the reference's contract) or
    merged (``flash_decode_paged_merged``: runs from ``split_len``, the
    merge in the kernel, and the scores). No single PyTorch call computes
    paged attention, so ``library_ms`` is null."""
    from repro_torch.kernels import flash_decode as fd
    q, kp, vp, table, mask, live_blk = _paged_case(heads, d)
    B, H, d = q.shape
    bs, Hkv = kp.shape[1], kp.shape[2]
    nb = table.shape[1]
    scale = 1.0 / d ** 0.5
    n_live = int(mask.sum())
    nbytes = (n_live * Hkv * d * 2 * 2 + q.numel() * 4 + mask.numel()
              + table.numel() * 4 + live_blk.numel())
    case = dict(live_tokens=n_live, live_blocks=int(live_blk.sum()),
                library_ms=None, H=H, Hkv=Hkv, d=d)
    if merged:
        split = fd.split_len(B, Hkv, nb * bs, fd._sm_count(q.device),
                             block=bs)
        nbytes += B * H * (d + 2) * 4 + B * H * nb * bs * 4
        return _decode_row(
            "flash_decode_paged_merged",
            lambda: fd.flash_decode_paged_merged(
                q, kp, vp, table, mask, block_live=live_blk, scores=True),
            lambda: fd._merged_plain(*fd._flash_decode_paged_plain(
                q, kp, vp, table, live_blk, mask, None, scale)),
            nbytes, n_live * H * d * 4, split=split,
            runs=-(-nb // (split // bs)),
            grid_blocks=-(-nb // (split // bs)) * Hkv * B, **case)
    nbytes += B * H * nb * (d + 2) * 4           # the stacked partials
    return _decode_row(
        "flash_decode_paged",
        lambda: fd.flash_decode_paged(q, kp, vp, table, mask,
                                      block_live=live_blk),
        lambda: fd._flash_decode_paged_plain(q, kp, vp, table, live_blk,
                                             mask, None, scale)[:3],
        nbytes, n_live * H * d * 4, grid_blocks=nb * Hkv * B, **case)


# a sharded engine's site slices (a ring of 256 slots and a pool of 1,024
# blocks over 2 and 4 sites), at the heads of each sharded engine phase:
# tag -> (phase, (H, Hkv), head dim); the rows' keys end in the tag
SITE_RING = 256
SITE_HEADS = {"": ("engine_sharded", (16, 8), 128),
              "_g16": ("engine_sharded_moe", (64, 4), 128),
              "_g7": ("engine_sharded_vlm", (14, 2), 64)}
SITE_ROWS = {f"{key}{tag}": (kind, n, start, tag)
             for tag in SITE_HEADS
             for key, (kind, n, start) in {
                 "flash_decode_merged_site_w128": ("ring", 128, 128),
                 "flash_decode_merged_site_w64": ("ring", 64, 192),
                 "flash_decode_paged_merged_site_nb512": ("pool", 512, 512),
                 "flash_decode_paged_merged_site_nb256": ("pool", 256,
                                                          256)}.items()}


def kernel_flash_decode_site(w_loc: int, start: int, heads=(16, 8),
                             d: int = 128) -> dict:
    """The merged dense kernel on one site's slice of a hot ring, as the
    sharded engine calls it: slots ``[start, start + w_loc)`` of a B 8,
    (H, Hkv) ``heads`` of ``d``, 256-slot bf16 ring, a view whose kv
    heads lie 256 rows apart, the site's mask (half the slots),
    ``kv_len`` w_loc, with scores; against its plain version on the same
    view."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    q, k, v, mask, _ = _dense_case(SITE_RING, seed=start + w_loc,
                                   dead_split=False, heads=heads, d=d)
    B, H, d = q.shape
    Hkv = k.shape[1]
    ks, vs = k[:, :, start:start + w_loc], v[:, :, start:start + w_loc]
    m = mask[:, start:start + w_loc].contiguous()
    live = fd._dense_live(m, w_loc, None, B, w_loc, q.device)
    n_live = int(live.sum())
    nbytes = (n_live * Hkv * d * 2 * 2 + q.numel() * 4 + m.numel()
              + B * H * (d + 2) * 4 + B * H * w_loc * 4)
    split = fd.split_len(B, Hkv, w_loc, fd._sm_count(q.device))
    block_s = min(fd.DEFAULT_BLOCK_S, max(w_loc, 8))
    row = _decode_row(
        "flash_decode_merged",
        lambda: fd.flash_decode_merged(q, ks, vs, m, kv_len=w_loc,
                                       scores=True),
        lambda: fd._merged_plain(*fd._flash_decode_plain(
            q, ks, vs, live, 1.0 / d ** 0.5, block_s)),
        nbytes, n_live * H * d * 4, S=w_loc, start=start,
        view_rows_per_head=SITE_RING, split=split,
        nsplit=-(-w_loc // split))
    lens = torch.full((B,), w_loc, device="cuda")
    return dict(row, live_tokens=n_live, H=H, Hkv=Hkv, d=d,
                library_ms=_sdpa_ms(q, ks, vs, m, lens))


def kernel_flash_decode_paged_site(nb_loc: int, offset: int, heads=(16, 8),
                                   d: int = 128) -> dict:
    """The merged paged kernel on one site's slice of ``_paged_case``'s
    pool at (H, Hkv) ``heads`` of ``d``, as the sharded engine calls it:
    the view of physical blocks ``[offset, offset + nb_loc)``, the global
    block table with ``block_offset``, entries outside the slice dead;
    against its plain version. The bound counts the tokens of the site's
    own blocks."""
    from repro_torch.kernels import flash_decode as fd
    q, kp, vp, table, mask, live_blk = _paged_case(heads, d)
    B, H, d = q.shape
    bs, Hkv = kp.shape[1], kp.shape[2]
    nb = table.shape[1]
    kl, vl = kp[offset:offset + nb_loc], vp[offset:offset + nb_loc]
    inside = (table >= offset) & (table < offset + nb_loc)
    n_live = int((mask & inside.repeat_interleave(bs, 1)).sum())
    nbytes = (n_live * Hkv * d * 2 * 2 + q.numel() * 4 + mask.numel()
              + table.numel() * 4 + live_blk.numel()
              + B * H * (d + 2) * 4 + B * H * nb * bs * 4)
    split = fd.split_len(B, Hkv, nb * bs, fd._sm_count(q.device), block=bs)
    return _decode_row(
        "flash_decode_paged_merged",
        lambda: fd.flash_decode_paged_merged(
            q, kl, vl, table, mask, block_live=live_blk,
            block_offset=offset, scores=True),
        lambda: fd._merged_plain(*fd._flash_decode_paged_plain(
            q, kl, vl, table, live_blk, mask, offset, 1.0 / d ** 0.5)),
        nbytes, n_live * H * d * 4, block_offset=offset, nb_local=nb_loc,
        split=split, live_tokens=n_live,
        live_blocks=int((live_blk & inside).sum()), library_ms=None, H=H,
        Hkv=Hkv, d=d)


def _attn_case(S: int, causal: bool, seed: int, B: int = TRAIN_B,
               dtype: str = "bfloat16", heads=(16, 8), d: int = 128):
    """q, k, v, dO at (H, Hkv) ``heads`` and head dim ``d`` (the training
    path's 16 / 8 of 128 by default), batch ``B`` and sequence ``S``, in
    ``dtype``."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, Hkv = heads
    return [torch.randn(shape, generator=g, device="cuda").to(
                getattr(torch, dtype))
            for shape in ((B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d),
                          (B, H, S, d))]


def _attn_work(q, k, causal: bool) -> tuple[int, int]:
    """(live (query, key) pairs over all heads, head dim): a causal row
    attends qpos + 1 keys."""
    B, H, S, d = q.shape
    Sk = k.shape[2]
    pairs = S * (S + 1) // 2 if causal else S * Sk
    return B * H * pairs, d


def _attn_timed(fn, flops, bound) -> dict:
    dev = _device_ms(fn, iters=ATTN_REPEATS)
    ms, lo, hi = _time_stats(fn, iters=ATTN_REPEATS)
    return dict(ms=ms, ms_spread=[lo, hi], kernel_device_ms=dev,
                tflops=flops / (dev * 1e-3) / 1e12,
                pct_of_bound=100.0 * bound / dev)


def _attn_bounds(nbytes: float, flops: float, bf16: bool) -> dict:
    """The row's bound: bf16 FLOPs over the bf16 tensor-core peak; fp32
    (the tf32x3 kernels) 3 x the FLOPs (three TF32 products a product)
    over the TF32 peak, with the fp32-FMA bound (the FLOPs over the fp32
    peak, the bound of the CUDA-core kernels this route replaced) beside
    it."""
    if bf16:
        bound, by = _bound_ms(nbytes, flops, BF16_FLOPS)
        return dict(bound_ms=bound, bound_by=by)
    bound, by = _bound_ms(nbytes, 3 * flops, TF32_FLOPS)
    fma, fma_by = _bound_ms(nbytes, flops, FP32_FLOPS)
    return dict(bound_ms=bound, bound_by=by, bound_fp32_fma_ms=fma,
                bound_fp32_fma_by=fma_by)


def _library_stats(fn) -> dict:
    """SDPA's yardstick: mean ms over ``ATTN_REPEATS`` calls (CUDA events,
    L2 flushed) with their min and max."""
    ms, lo, hi = _time_stats(fn, iters=ATTN_REPEATS)
    return dict(library_ms=ms, library_ms_spread=[lo, hi],
                library_repeats=ATTN_REPEATS)


def _attn_fwd_row(q, k, v, causal: bool) -> tuple[dict, object, object]:
    """The forward kernel against its plain version on q, k, v (bf16
    through wgmma also against ``_fwd_rounded``, fp32 through tf32x3
    against ``_fwd_tf32x3``), its times, bounds and the SDPA yardstick
    with SDPA's own error against the same plain version. Returns (row,
    o, lse)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    scale = 1.0 / q.shape[-1] ** 0.5
    variant = fa._variant(q.dtype, q.shape[-1])
    bf16 = q.dtype == torch.bfloat16
    tol = ATTN_BF16_TOL if bf16 else KERNEL_TOL
    n0 = (fa.flash_attention.wgmma_launches,
          fa.flash_attention.tf32x3_launches)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ref_o, ref_lse = fa._fwd_plain(q, k, v, causal, scale)
    torch.cuda.synchronize()
    ran = (fa.flash_attention.wgmma_launches - n0[0],
           fa.flash_attention.tf32x3_launches - n0[1])
    assert ran == (int(variant == "wgmma"), int(variant == "tf32x3")), (
        variant, ran)
    err_o, ok_o = _compare([o], [ref_o], tol)
    err_l, ok_l = _compare([lse], [ref_lse])
    extra = {}
    if variant == "wgmma":
        rnd_o, _ = fa._fwd_rounded(q, k, v, causal, scale)
        extra["max_abs_err_vs_rounded"] = _compare([o], [rnd_o])[0]
        del rnd_o
    if variant == "tf32x3":
        extra["max_abs_err_vs_model"] = _compare(
            [o, lse], fa._fwd_tf32x3(q, k, v, causal, scale))[0]

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)
    with torch.no_grad():
        sdpa_err = _compare([sdpa()], [ref_o])[0]
        library = _library_stats(sdpa)
        if not bf16:    # SDPA's kernels' own device time, as the kernel's
            library["library_device_ms"] = _device_ms_all(
                sdpa, iters=ATTN_REPEATS)
    del ref_o, ref_lse
    pairs, d = _attn_work(q, k, causal)
    el = q.element_size()
    nbytes = (q.numel() * 2 + k.numel() * 2) * el + lse.numel() * 4
    flops = 4 * d * pairs
    bounds = _attn_bounds(nbytes, flops, bf16)
    row = dict(S=q.shape[2], causal=causal, B=q.shape[0], H=q.shape[1],
               Hkv=k.shape[1], d=d, dtype=str(q.dtype).split(".")[-1],
               variant=variant, live_pairs=pairs, name="flash_attention",
               ok=ok_o and ok_l, max_abs_err=max(err_o, err_l),
               max_abs_err_o=err_o, max_abs_err_lse=err_l, tol=tol,
               sdpa_max_abs_err=sdpa_err, **extra,
               **_attn_timed(lambda: fa.flash_attention_fwd(
                   q, k, v, causal=causal), flops, bounds["bound_ms"]),
               plain_ms=_time_ms(lambda: fa._fwd_plain(q, k, v, causal,
                                                       scale), iters=5),
               **bounds, bytes=nbytes, flops=flops, **library)
    if not bf16:
        row["pct_of_fp32_fma_bound"] = (
            100.0 * bounds["bound_fp32_fma_ms"] / row["kernel_device_ms"])
    return row, o, lse


def kernel_flash_attention(S: int, causal: bool, B: int = TRAIN_B,
                           dtype: str = "bfloat16", heads=(16, 8),
                           d: int = 128) -> dict:
    """Forward and backward kernels against their plain versions on the
    same inputs (the backward fed the kernel forward's o and lse), with
    their times, bounds and the SDPA yardstick, whose own error against
    the same plain versions is reported beside the kernels'. bf16 runs
    the wgmma kernels (also held to ``_fwd_rounded`` / ``_bwd_rounded``,
    the plain model of their bf16 roundings), fp32 the tf32x3 ones (their
    error against ``_fwd_tf32x3`` / ``_bwd_tf32x3``, the plain model of
    the 3xTF32 split, reported; two backward calls bit-equal).
    (H, Hkv) ``heads`` and head dim ``d``: qwen3-0.6b's by default."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    # qwen3-0.6b's rows keep the inputs of earlier runs
    seed = S if (heads, d) == ((16, 8), 128) else S + d + heads[0]
    q, k, v, do = _attn_case(S, causal, seed=seed, B=B, dtype=dtype,
                             heads=heads, d=d)
    scale = 1.0 / q.shape[-1] ** 0.5
    fwd, o, lse = _attn_fwd_row(q, k, v, causal)
    bf16 = q.dtype == torch.bfloat16
    bwd_tol = ATTN_BF16_TOL if bf16 else ATTN_FP32_BWD_TOL
    n0 = (fa.flash_attention_bwd.wgmma_launches,
          fa.flash_attention_bwd.tf32x3_launches)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    ref_g = fa._bwd_plain(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    variant = fa._variant(q.dtype, q.shape[-1], backward=True)
    ran = (fa.flash_attention_bwd.wgmma_launches - n0[0],
           fa.flash_attention_bwd.tf32x3_launches - n0[1])
    assert ran == (int(variant == "wgmma"), int(variant == "tf32x3")), (
        variant, ran)
    err_g, ok_g = _compare(grads, ref_g, bwd_tol)
    extra_b = {}
    if bf16:
        rnd_g = fa._bwd_rounded(q, k, v, o, lse, do, causal, scale)
        extra_b["max_abs_err_vs_rounded"] = _compare(grads, rnd_g)[0]
        del rnd_g
    else:
        extra_b["max_abs_err_vs_model"] = _compare(grads, fa._bwd_tf32x3(
            q, k, v, o, lse, do, causal, scale))[0]
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        extra_b["bit_equal_across_calls"] = all(
            bool(torch.equal(a, b)) for a, b in zip(grads, again))
        assert extra_b["bit_equal_across_calls"], "backward not deterministic"
        del again
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa_fb():
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal,
                                       enable_gqa=True).backward(do)

    so = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal,
                                        enable_gqa=True)
    sdpa_err_g = _compare(torch.autograd.grad(so, (qr, kr, vr), do),
                          ref_g)[0]
    del ref_g, so
    pairs, d = _attn_work(q, k, causal)
    el = q.element_size()
    bwd_bytes = ((q.numel() * 3 + k.numel() * 2) * el + lse.numel() * 4
                 + (q.numel() + k.numel() * 2) * el)
    bwd_flops = 10 * d * pairs
    bounds = _attn_bounds(bwd_bytes, bwd_flops, bf16)
    fb_ms, fb_lo, fb_hi = _time_stats(sdpa_fb, iters=ATTN_REPEATS)
    case = {f: fwd[f] for f in ("S", "causal", "B", "H", "Hkv", "d",
                                "dtype", "variant", "live_pairs")}
    bwd = dict(case, name="flash_attention_bwd", ok=ok_g,
               max_abs_err=err_g, tol=bwd_tol, sdpa_max_abs_err=sdpa_err_g,
               **extra_b,
               **_attn_timed(lambda: fa.flash_attention_bwd(
                   q, k, v, o, lse, do, causal=causal), bwd_flops,
                   bounds["bound_ms"]),
               plain_ms=_time_ms(lambda: fa._bwd_plain(
                   q, k, v, o, lse, do, causal, scale), iters=5),
               **bounds, bytes=bwd_bytes, flops=bwd_flops,
               library_ms=max(fb_ms - fwd["library_ms"], 0.0),
               library_ms_fwd_bwd_spread=[fb_lo, fb_hi],
               library_repeats=ATTN_REPEATS)
    if not bf16:
        bwd["pct_of_fp32_fma_bound"] = (
            100.0 * bounds["bound_fp32_fma_ms"] / bwd["kernel_device_ms"])
        fb_dev = _device_ms_all(sdpa_fb, iters=ATTN_REPEATS)
        bwd["library_device_ms"] = (
            fb_dev - fwd["library_device_ms"]
            if fb_dev is not None and fwd["library_device_ms"] is not None
            else None)
    return dict(fwd=fwd, bwd=bwd)


def kernel_flash_attention_fwd(S: int, causal: bool, B: int, heads,
                               d: int, dtype: str = "bfloat16") -> dict:
    """The forward alone at (H, Hkv) ``heads``, head dim ``d`` (the
    shapes of ``vlm_audio_parity``, which runs no backward): bf16 through
    the wgmma kernel, fp32 through the tf32x3 one."""
    q, k, v, _ = _attn_case(S, causal, seed=S + d, B=B, dtype=dtype,
                            heads=heads, d=d)
    return _attn_fwd_row(q, k, v, causal)[0]


def _ssd_case(dtype, seed: int = 0, B: int = TRAIN_B, L: int = TRAIN_S,
              H: int = 48, N: int = 128):
    """ssd_scan operands at a model's head shape (mamba2-780m's H 48, N
    128 by default; zamba2-7b's H 112, N 64), G 1, P 64, batch ``B`` and
    length ``L``: x, B and C as column views of one conv-output-like (B,
    L, H P + 2 N) tensor, as ssm_forward passes them; dt = softplus(N(0,
    1)), the model's initial decay rates a = -linspace(1, 16) and D = 1;
    and an output gradient."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    G, P = 1, 64
    xbc = (torch.randn((B, L, H * P + 2 * G * N), generator=g,
                       device="cuda") * 0.5).to(dtype)
    x = xbc[..., :H * P].reshape(B, L, H, P)
    b = xbc[..., H * P:H * P + G * N].reshape(B, L, G, N)
    c = xbc[..., H * P + G * N:].reshape(B, L, G, N)
    dt = F.softplus(torch.randn((B, L, H), generator=g, device="cuda"))
    a = -torch.linspace(1.0, 16.0, H, device="cuda")
    d = torch.ones(H, device="cuda")
    dy = torch.randn((B, L, H, P), generator=g, device="cuda").to(dtype)
    return (x, dt, a, b, c, d), dy


def _ssd_work(x, b, chunk: int) -> tuple[int, int]:
    """FLOPs the SSD scan's function needs at this run's chunking (the
    yardstick of the bound; the last chunk may be short), forward and
    backward. Per (batch, group, chunk) of q rows, C B^T once, over its
    causal half (q (q + 1) N); per (batch, head, chunk) the causal half
    of every masked q x q product, the forward's with x (q (q + 1) P) and
    the backward's g x^T, dx, dC and dB products (2 q (q + 1) (N + P)),
    and the state products: the forward's B^T (w x) and C h_in (4 q N P),
    the backward's C^T g, B dh, C h_in, g h_in^T and x dh^T (10 q N P)."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Q = min(chunk, L)
    tri = sum(q * (q + 1) for q in [Q] * (L // Q) + [L % Q])
    return (B * (G * tri * N + H * (tri * P + 4 * L * N * P)),
            B * (G * tri * N + H * (2 * tri * (N + P) + 10 * L * N * P)))


def _ssd_executed(x, b, chunk: int, hb: int) -> tuple[int, int]:
    """FLOPs the wgmma kernels execute (tiles of 128 rows): C B^T once per
    block of ``hb`` heads; per head the forward's B^T (w x), C h_in and M x
    twice each (hi / lo bf16 pairs), and the backward's C^T (exp(s) g), C
    h_in, g h_in^T, g x^T, Pb B (t-side), x g^T, Pb^T C, B dh, the dx
    product and (w x) dh^T (u-side), with C B^T on each side."""
    B, L, H, P = x.shape
    N = b.shape[3]
    Q = 128
    n = B * H * -(-L // min(chunk, max(L, 8)))
    qnp, qqp, qqn = Q * N * P, Q * Q * P, Q * Q * N
    return (n * (2 * qqn // hb + 4 * qnp + 4 * qnp + 4 * qqp),
            n * (4 * qqn // hb + 10 * qnp + 6 * qqp + 4 * qqn))


# the share of a 128-row chunk's (row, column) tiles of 16 x 8 that a
# tf32x3 kernel's causal products visit: warp w's 16 rows take 2 w + 2
# of the 16 column tiles (or 16 - 2 w), 72 of 128
TF32_CAUSAL = 72 / 128


def _ssd_executed_tf32x3(x, b, chunk: int, hb: int) -> tuple[int, int]:
    """FLOPs the tf32x3 kernels execute (tiles of 128 rows, three TF32
    products a product, the causal products over the tiles they visit):
    the forward's C B^T once per block of ``hb`` heads, and per head B^T
    (w x), C h_in and M x; the backward's causal C B^T once per group,
    and per head C^T (exp(s) g), g h_in^T, B dh and x dh^T, the causal
    g x^T, x g^T and (S'^T o E^T) g, and the causal Pb B and Pb^T C (the
    causal products over 32-row blocks visit the same tiles)."""
    B, L, H, P = x.shape
    N = b.shape[3]
    Q = 128
    n = B * H * -(-L // min(chunk, max(L, 8)))
    rep = H // b.shape[2]
    qnp, qqp, qqn = 2 * Q * N * P, 2 * Q * Q * P, 2 * Q * Q * N
    fwd = qqn * TF32_CAUSAL / hb + 2 * qnp + qqp * TF32_CAUSAL
    bwd = 4 * qnp + (3 * qqp + 2 * qqn + qqn / rep) * TF32_CAUSAL
    return int(3 * n * fwd), int(3 * n * bwd)


def _grad_compare(got, ref, tol) -> tuple[float, bool]:
    """Each gradient leaf at rtol, and atol scaled by max(1, its largest
    entry)."""
    import torch
    err, ok = 0.0, True
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        scale = max(1.0, float(r.abs().max()))
        err = max(err, float((g - r).abs().max()))
        ok = ok and bool(torch.allclose(g, r, rtol=tol["rtol"],
                                        atol=tol["atol"] * scale))
    return err, ok


SSD_GRADS = ("dx", "ddt", "da", "db", "dc", "dd")


def _ssd_variant(dtype, B: int, L: int, chunk: int, H: int = 48,
                 N: int = 128) -> dict:
    """One variant of the ssd_scan kernels against the plain versions (and
    the plain model of the variant: for bf16 the wgmma kernels'
    roundings, for fp32 the 3xTF32 split) on the same inputs, the
    backward fed the kernel forward's chunk-start states; the wgmma and
    tf32x3 launch counts of the calls (fp32: two backward calls must give
    equal bits, and every result's norm-wise error against the float64
    plain versions must be within ``ss.F64_RATIO`` times the fp32 plain
    versions', ``ss._f64_witness``: [error, plain error] a leaf); times
    (``ATTN_REPEATS`` calls: mean, min and max), the per-kernel device
    time of each pass, and the bounds (fp32: 3xTF32, the fp32-FMA bound
    beside it)."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    bf16 = dtype == torch.bfloat16
    tol = ATTN_BF16_TOL if bf16 else SSD_FP32_TOL
    ins, dy = _ssd_case(dtype, B=B, L=L, H=H, N=N)
    x, dt, a, b, c, d = ins
    variant = ss._variant(x.dtype, b.shape[3], x.shape[3])

    def counts():
        return (ss.ssd_scan.wgmma_launches, ss.ssd_scan_bwd.wgmma_launches,
                ss.ssd_scan.tf32x3_launches,
                ss.ssd_scan_bwd.tf32x3_launches)
    n0 = counts()
    y, st = ss.ssd_scan_fwd(*ins, chunk=chunk)
    grads = ss.ssd_scan_bwd(*ins, st, dy, chunk=chunk)
    torch.cuda.synchronize()
    ran = tuple(v - u for u, v in zip(n0, counts()))
    assert ran == ((1, 1, 0, 0) if variant == "wgmma" else (0, 0, 1, 1)), (
        variant, ran)
    ref_y, ref_st, _ = ss.ssd_chunked_states(*ins, chunk)
    err_y, ok_y = _compare([y], [ref_y], tol)
    err_s, ok_s = _grad_compare([st], [ref_st], SSD_FP32_TOL)
    del ref_y, ref_st
    ref_g = ss._bwd_plain(*ins, st, dy, chunk)
    err_g, ok_g = _grad_compare(grads, ref_g, tol)
    per_leaf = {n: _grad_compare([g], [r], tol)[0]
                for n, g, r in zip(SSD_GRADS, grads, ref_g)}
    del ref_g
    out = dict(variant=variant, dtype=str(dtype).split(".")[-1], B=B, L=L,
               ok_fwd=ok_y and ok_s, ok_bwd=ok_g, max_abs_err_y=err_y,
               max_abs_err_states=err_s, max_abs_err_grads=err_g,
               max_abs_err_per_grad=per_leaf, tol=tol)
    if bf16:
        rnd_y, rnd_st = ss._fwd_rounded(*ins, chunk)
        out["max_abs_err_y_vs_rounded"] = _compare([y], [rnd_y])[0]
        out["max_abs_err_states_vs_rounded"] = _compare([st], [rnd_st])[0]
        del rnd_y, rnd_st
        rnd_g = ss._bwd_rounded(*ins, st, dy, chunk)
        out["max_abs_err_per_grad_vs_rounded"] = {
            n: _compare([g], [r])[0]
            for n, g, r in zip(SSD_GRADS, grads, rnd_g)}
        del rnd_g
    else:
        mod_y, mod_st = ss._fwd_tf32x3(*ins, chunk)
        out["max_abs_err_y_vs_model"] = _compare([y], [mod_y])[0]
        out["max_abs_err_states_vs_model"] = _compare([st], [mod_st])[0]
        del mod_y, mod_st
        mod_g = ss._bwd_tf32x3(*ins, st, dy, chunk)
        out["max_abs_err_per_grad_vs_model"] = {
            n: _compare([g], [r])[0]
            for n, g, r in zip(SSD_GRADS, grads, mod_g)}
        del mod_g
        wit = ss._f64_witness(ins, dy, chunk, y, st, grads)
        out["f64_fwd"] = {n: wit[n] for n in ss.WITNESS_FWD}
        out["f64_bwd"] = {n: wit[n] for n in ss.WITNESS_BWD}
        out["ok_fwd"] = out["ok_fwd"] and ss._f64_within(wit,
                                                         ss.WITNESS_FWD)
        again = ss.ssd_scan_bwd(*ins, st, dy, chunk=chunk)
        out["bit_equal_across_calls"] = all(
            bool(torch.equal(u, v)) for u, v in zip(grads, again))
        out["ok_bwd"] = (out["ok_bwd"] and out["bit_equal_across_calls"]
                         and ss._f64_within(wit, ss.WITNESS_BWD))
        del again
    del grads

    def fwd():
        return ss.ssd_scan_fwd(*ins, chunk=chunk)

    def bwd():
        return ss.ssd_scan_bwd(*ins, st, dy, chunk=chunk)
    el = x.element_size()
    fwd_flops, bwd_flops = _ssd_work(x, b, chunk)
    io = (x.numel() * el + dt.numel() * 4 + 2 * b.numel() * el
          + 2 * a.numel() * 4)                   # x, dt, b, c, a, D
    # The forward's bound is y's own work: the chunk-start states it also
    # writes are the port's choice (the backward could recompute them) and
    # are reported apart. The backward's counts the states it reads; not
    # reading them would add their recompute (2QNP a chunk) and leave it
    # bound by operations all the same.
    fwd_bytes = io + x.numel() * el                          # + y
    state_bytes = st.numel() * 4
    bwd_bytes = (io + state_bytes + dy.numel() * el         # + states, dy
                 + io)                           # the six gradients
    rep = x.shape[2] // b.shape[2]
    if variant == "wgmma":
        ex = _ssd_executed(x, b, chunk, ss._head_block(rep))
    else:
        nc = -(-L // min(chunk, max(L, 8)))
        ex = _ssd_executed_tf32x3(x, b, chunk, ss._tf32x3_head_block(
            rep, B * nc * b.shape[2], ss._n_sm(x.device.index)))
    for tag, fn, flops, exe, nbytes in (
            ("fwd", fwd, fwd_flops, ex[0], fwd_bytes),
            ("bwd", bwd, bwd_flops, ex[1], bwd_bytes)):
        bounds = _attn_bounds(nbytes, flops, bf16)
        per = _device_ms_by_kernel(fn, iters=ATTN_REPEATS)
        dev = sum(per.values())
        ms, lo, hi = _time_stats(fn, iters=ATTN_REPEATS)
        out[tag] = dict(ms=ms, ms_spread=[lo, hi], kernel_device_ms=dev,
                        per_launch_ms=per, flops=flops, executed_flops=exe,
                        tflops=flops / (dev * 1e-3) / 1e12,
                        executed_tflops=exe / (dev * 1e-3) / 1e12,
                        pct_of_bound=100.0 * bounds["bound_ms"] / dev,
                        bytes=nbytes, repeats=ATTN_REPEATS, **bounds)
        if not bf16:
            out[tag]["pct_of_fp32_fma_bound"] = (
                100.0 * bounds["bound_fp32_fma_ms"] / dev)
    out["fwd"]["state_bytes"] = state_bytes
    out["fwd"]["state_write_bound_ms"] = state_bytes / HBM_BYTES_PER_S * 1e3
    out["fwd"]["plain_ms"] = _time_ms(
        lambda: ss.ssd_chunked_states(*ins, chunk), iters=3)
    out["bwd"]["plain_ms"] = _time_ms(
        lambda: ss._bwd_plain(*ins, st, dy, chunk), iters=3)
    return out


# the ssd_scan rows of the kernels phase: key suffix -> (dtype, B, L, H,
# N): mamba2-780m's train_ssm and train_parity_ssm shapes, and zamba2-7b's
# (112 heads, d_state 64) train_zamba2_7b and train_parity_zamba2_7b
# shapes (keys ending _n64)
SSD_ROWS = {"": ("bfloat16", TRAIN_B, TRAIN_S, 48, 128),
            "_fp32_500": ("float32", PARITY_B, PARITY_S, 48, 128),
            "_n64": ("bfloat16", 2, 2048, 112, 64),
            "_fp32_500_n64": ("float32", PARITY_B, PARITY_S, 112, 64)}


def kernel_ssd_scan() -> dict:
    """Both variants of the ssd_scan kernels at their main paths' shapes
    (``SSD_ROWS``): wgmma in bf16 at the train shapes, tf32x3 in fp32 at
    the train_parity_* ones; one row for each kernel."""
    import torch
    chunk = 128
    rows = {}
    for key, (dtype, B, L, H, N) in SSD_ROWS.items():
        r = _ssd_variant(getattr(torch, dtype), B, L, chunk, H, N)
        case = dict(B=B, L=L, H=H, P=64, G=1, N=N, chunk=chunk,
                    dtype=r["dtype"], variant=r["variant"],
                    x_bc=f"views of a (B, L, {H * 64 + 2 * N}) tensor")
        common = {k: r[k] for k in r if k.startswith("max_abs_err_per")}
        fwd_model = {}
        if "max_abs_err_y_vs_model" in r:
            fwd_model["max_abs_err_vs_model"] = max(
                r["max_abs_err_y_vs_model"], r["max_abs_err_states_vs_model"])
        if "f64_fwd" in r:
            fwd_model["f64_rel_err_and_plain"] = r["f64_fwd"]
        bwd_model = {k: r[k] for k in ("bit_equal_across_calls",) if k in r}
        if "f64_bwd" in r:
            bwd_model["f64_rel_err_and_plain"] = r["f64_bwd"]
        if "max_abs_err_per_grad_vs_model" in r:
            bwd_model["max_abs_err_vs_model"] = max(
                r["max_abs_err_per_grad_vs_model"].values())
        rows["ssd_scan" + key] = dict(
            case, name="ssd_scan", ok=r["ok_fwd"],
            max_abs_err=r["max_abs_err_y"],
            max_abs_err_states=r["max_abs_err_states"], tol=r["tol"],
            library_ms=None, **r["fwd"], **fwd_model,
            **{k: r[k] for k in ("max_abs_err_y_vs_rounded",
                                 "max_abs_err_states_vs_rounded",
                                 "max_abs_err_y_vs_model",
                                 "max_abs_err_states_vs_model") if k in r})
        rows["ssd_scan_bwd" + key] = dict(
            case, name="ssd_scan_bwd", ok=r["ok_bwd"],
            max_abs_err=r["max_abs_err_grads"], tol=r["tol"],
            library_ms=None, **r["bwd"], **common, **bwd_model)
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- paper core
PAM_TIERS = (256, 1792, 6144)    # tokens: HBM dense, DDR dense, SSD paged
PAM_BLOCK = 16
PAM_SPARSITY = dict(compression=8, label_channels=16, recency_window=32)
PAM_GROUPS = 16                  # §6.1 bank groups
PAM_MOVED, PAM_STAGING, PAM_FREE = 512, 1024, 600   # §6.2 migration
PAM_STEP_TOL = dict(rtol=1e-4, atol=1e-4)


def _pam_core_case(seed: int = 0):
    """qwen3-0.6b decode shapes (B 8, H 16, Hkv 8, d 128), fp32 q and
    bf16 K/V in three tiers of ``PAM_TIERS`` tokens: HBM and DDR dense,
    SSD a paged pool at block 16 behind a shuffled block table (row 7's
    SSD tier 4,096 tokens long, its last 128 entries on the sentinel).
    Participation as retrieval sparsity leaves it: every HBM token (the
    recency window), an eighth of the DDR and SSD tokens; an SSD block
    with no participating token is dead in ``block_live``."""
    import torch
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, Hkv, d, bs = 8, 16, 8, 128, PAM_BLOCK
    hot, warm, cold = PAM_TIERS
    nb = cold // bs
    NB = B * nb

    def kv(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    def sparse(n):
        return torch.rand((B, n), generator=g, device="cuda") < 1 / 8

    q = torch.randn((B, H, d), generator=g, device="cuda")
    tiers = [(kv(B, Hkv, hot, d), kv(B, Hkv, hot, d)),
             (kv(B, Hkv, warm, d), kv(B, Hkv, warm, d))]
    masks = [torch.ones((B, hot), dtype=torch.bool, device="cuda"),
             sparse(warm)]
    table = torch.randperm(NB, generator=g, device="cuda").reshape(B, nb)
    table = table.to(torch.int32)
    table[B - 1, 4096 // bs:] = NB               # unmapped -> sentinel
    pmask = sparse(cold)
    pmask[B - 1, 4096:] = False
    live = pmask.reshape(B, nb, bs).any(-1)
    tiers.append(ops.PagedTier(kv(NB + 1, bs, Hkv, d),
                               kv(NB + 1, bs, Hkv, d), table, live))
    masks.append(pmask)
    return q, tiers, masks


def _pam_decode_plain(q, tiers, masks):
    """``pam_decode_attention`` from the decode kernels' plain versions:
    each tier's partial, the same left-to-right merge."""
    from repro_torch.core import online_softmax as osm
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    B, _, d = q.shape
    scale = 1.0 / d ** 0.5
    acc = None
    for t, m in zip(tiers, masks):
        if isinstance(t, ops.PagedTier):
            stacked = fd._flash_decode_paged_plain(
                q, t.k_pool, t.v_pool, t.block_table, t.block_live, m, None,
                scale)
        else:
            S = t[0].shape[2]
            live = fd._dense_live(m, S, None, B, S, q.device)
            stacked = fd._flash_decode_plain(
                q, t[0], t[1], live, scale, min(fd.DEFAULT_BLOCK_S, S))
        part = osm.AttnPartial(*fd._merged_plain(*stacked)[:3])
        acc = part if acc is None else osm.merge_partials(acc, part)
    return osm.finalize(acc, out_dtype=q.dtype)


def _host_ms(fn, iters: int = 3) -> float:
    """Mean host wall ms of ``fn``, the card synchronized after each."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _pam_alg1(q, tiers, masks) -> tuple[dict, tuple]:
    """The tier-list call: its launches (counts reset just before it),
    its output against the plain versions and against one dense launch
    over the concatenated tiers, its times, bound and SDPA's time.
    Returns the record and the concatenated (K, V)."""
    import torch
    from repro_torch.core import online_softmax as osm
    from repro_torch.core.pam_interface import paged_gather_logical
    from repro_torch.kernels import ops
    B, H, d = q.shape
    Hkv = tiers[0][0].shape[1]
    call = lambda: ops.pam_decode_attention(q, tiers, masks)  # noqa: E731
    torch.cuda.synchronize()
    _reset_launches()                       # counts of this call only
    got = call()
    torch.cuda.synchronize()
    launches = _launches()
    want = {"flash_decode_merged": 2, "flash_decode_paged_merged": 1}
    _assert_decode_launches(launches, want)
    ref = _pam_decode_plain(q, tiers, masks)
    err, ok = _compare([got], [ref])
    paged = tiers[2]
    ck = torch.cat([tiers[0][0], tiers[1][0],
                    paged_gather_logical(paged.k_pool, paged.block_table)], 2)
    cv = torch.cat([tiers[0][1], tiers[1][1],
                    paged_gather_logical(paged.v_pool, paged.block_table)], 2)
    cmask = torch.cat(masks, 1)
    one = lambda: ops.decode_attention(q, ck, cv, cmask)  # noqa: E731
    err_one, ok_one = _compare([got], [one()])
    assert ok and ok_one, f"vs plain {err}, vs one launch {err_one}"
    S = ck.shape[2]
    n_live = int(cmask.sum())
    nbytes = (n_live * Hkv * d * 2 * 2 + q.numel() * 4 + cmask.numel()
              + paged.block_table.numel() * 4 + paged.block_live.numel()
              + B * H * d * 4)
    bound, by = _bound_ms(nbytes, n_live * H * d * 4)
    by_kernel = _device_ms_by_kernel(call)
    dev = sum(by_kernel.values())
    # the wrapper's ms by part: each tier's kernel wrapper, and the
    # merges and finalize over the three partials
    tier_calls = {
        "hbm": lambda: ops.decode_attention_partial(q, *tiers[0], masks[0]),
        "ddr": lambda: ops.decode_attention_partial(q, *tiers[1], masks[1]),
        "ssd": lambda: ops.paged_decode_attention_partial(
            q, paged.k_pool, paged.v_pool, paged.block_table, masks[2],
            block_live=paged.block_live)}
    parts = [f() for f in tier_calls.values()]
    part_ms = {name: _time_ms(f) for name, f in tier_calls.items()}
    part_ms["merge_finalize"] = _time_ms(lambda: osm.finalize(
        osm.merge_partials(osm.merge_partials(parts[0], parts[1]),
                           parts[2]), out_dtype=q.dtype))
    return dict(
        ok=ok, tol=KERNEL_TOL, max_abs_err=err,
        max_abs_err_one_launch=err_one, launches=launches,
        launches_expected=want, ms=_time_ms(call), ms_by_part=part_ms,
        kernel_device_ms=dev,
        device_ms_by_kernel=by_kernel,
        plain_ms=_time_ms(lambda: _pam_decode_plain(q, tiers, masks),
                          iters=5),
        bound_ms=bound, bound_by=by, bytes=nbytes,
        pct_of_bound=100.0 * bound / dev, one_launch_ms=_time_ms(one),
        one_launch_device_ms=_device_ms(one),
        library_ms=_sdpa_ms(q, ck, cv, cmask,
                            torch.full((B,), S, device="cuda")),
        live_tokens=n_live, tokens=B * S), (ck, cv)


def _pam_step(q, ck, cv) -> tuple[dict, dict]:
    """Retrieval sparsity and ``pam_attention_step`` for batch row 0 over
    the concatenated tiers (S 8,192, the tiers' tags), on the card and
    on the CPU in fp32 from the same inputs. Returns the record and the
    dense step's importance for the mapping and migration parts."""
    import torch
    from repro_torch.core import pam_attention as pa
    from repro_torch.core import sparsity as sp
    from repro_torch.core import tiers as tr
    hot, warm, cold = PAM_TIERS
    S = hot + warm + cold
    q0 = q[0].float()
    k0 = ck[0].permute(1, 0, 2).float().contiguous()     # (S, Hkv, d)
    v0 = cv[0].permute(1, 0, 2).float().contiguous()
    tier = torch.cat([torch.full((n,), t, dtype=torch.int32, device="cuda")
                      for n, t in zip(PAM_TIERS, (tr.HOT, tr.WARM,
                                                  tr.COLD))])
    valid = torch.ones(S, dtype=torch.bool, device="cuda")

    def cpu(*xs):
        return [x.cpu() for x in xs]

    r, c, w = (PAM_SPARSITY[k] for k in ("label_channels", "compression",
                                         "recency_window"))
    # Double-Sparsity label channels, approximate scores, and the top-S/8
    # with the 32 newest pinned (both sides select from the CPU's scores)
    label = sp.choose_label_channels(k0[:, 0], r)
    assert torch.equal(label.cpu(),
                       sp.choose_label_channels(*cpu(k0[:, 0]), r))
    k_label = k0[:, 0, label].contiguous()
    scores_cpu = sp.approx_scores(*cpu(q0, k_label, label))
    s_err, s_ok = _compare([sp.approx_scores(q0, k_label, label).cpu()],
                           [scores_cpu], PAM_STEP_TOL)
    assert s_ok, s_err
    sel = sp.select_topk(scores_cpu.cuda(), valid, S // c,
                         torch.tensor(S, device="cuda"), recency_window=w)
    sel_cpu = sp.select_topk(scores_cpu, valid.cpu(), S // c,
                             torch.tensor(S), recency_window=w)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(sel, sel_cpu))
    out = dict(sparsity=dict(PAM_SPARSITY, selected=int(sel[1].sum()),
                             pinned_selected=int(sel[1][-w:].sum()),
                             approx_scores_max_abs_err=s_err))
    # Alg. 1, dense over the recency prior (newest = the HBM tier, at the
    # front of the concatenation) and sparse with the selection as the
    # importance (1 for the S/8 selected, 0 else: ties everywhere)
    prior = tr.initial_placement(S, S, [hot, warm], device="cuda")
    dense = None
    for name, imp, cfg in (
            ("dense", prior.importance.flip(0),
             pa.PAMAttentionConfig(use_sparsity=False)),
            ("sparse", sel[1].float(),
             pa.PAMAttentionConfig(use_sparsity=True, compression=c))):
        args = (q0, k0, v0, tier, valid, imp)
        got = pa.pam_attention_step(*args, cfg)
        ref = pa.pam_attention_step(*cpu(*args), cfg)
        err, ok = _compare([x.cpu() for x in got], ref, PAM_STEP_TOL)
        part = got.step_scores > 0
        assert ok, f"pam_attention_step {name}: {err}"
        assert torch.equal(part.cpu(), ref.step_scores > 0), name
        if name == "sparse":
            assert torch.equal(part, sel[1]), "sparse step != selection"
        else:
            dense = got
        out[name] = dict(max_abs_err=err, participating=int(part.sum()),
                         ms=_time_ms(lambda: pa.pam_attention_step(*args,
                                                                   cfg),
                                     iters=5))
    return out, dict(importance=dense.new_importance, tier=tier, k0=k0)


def _pam_mapping(k0) -> dict:
    """§6.1: a 10-step activation window over the S tokens (the 32
    newest every step, an eighth of the rest at random), the greedy
    balanced assignment to 16 bank groups on the card (equal to the CPU
    run's) against round-robin and contiguous assignment, and the
    bank-interleaved layout of row 0's keys."""
    import torch
    from repro_torch.core import mapping as mp
    from repro_torch.core import pam_interface as pi
    S = k0.shape[0]
    G = PAM_GROUPS
    g = torch.Generator(device="cuda").manual_seed(1)
    window = torch.zeros((10, S), dtype=torch.uint8, device="cuda")
    pos = torch.arange(S, device="cuda")
    for step in range(10):
        act = (torch.rand(S, generator=g, device="cuda") < 1 / 8) | (
            pos >= S - PAM_SPARSITY["recency_window"])
        window = mp.update_activation_freq(window, act, step)
    freq = mp.windowed_frequency(window).float()
    valid = torch.ones(S, dtype=torch.bool, device="cuda")
    assign = mp.greedy_balanced_assign(freq, valid, G)
    assert torch.equal(assign.cpu(), mp.greedy_balanced_assign(
        freq.cpu(), valid.cpu(), G))
    rr = (pos % G).to(torch.int32)
    contiguous = (pos // (S // G)).to(torch.int32)
    imb = {name: float(mp.imbalance(freq, a, valid, G))
           for name, a in (("lpt", assign), ("round_robin", rr),
                           ("contiguous", contiguous))}
    loads = mp.group_loads(freq, assign, valid, G)
    assert imb["lpt"] <= min(imb["round_robin"], imb["contiguous"])
    assert float(loads.max()) <= float(loads.mean() + freq.max())
    cap = int(torch.bincount(assign.long(), minlength=G).max())
    inter, slot = pi.bank_interleave(k0, assign, G, cap)
    assert torch.equal(inter.reshape(G * cap, *k0.shape[1:])[slot], k0)
    return dict(tokens=S, groups=G, distinct_counts=int(freq.unique().numel()),
                imbalance=imb, group_cap=cap,
                assign_ms=_host_ms(lambda: mp.greedy_balanced_assign(
                    freq, valid, G)))


def _pam_migration(tiers, importance, tier) -> dict:
    """§6.2: the ``PAM_MOVED`` most important SSD tokens of row 0 (by the
    dense step's new importance) move from the SSD tier's dense view
    (``paged_to_dense``) into a bf16 HBM staging pool through
    ``make_migration_plan`` / ``apply_migration``: the plan equals the
    CPU's, the result a gather oracle's, and exactly the planned rows
    change; the tags follow through ``migrate_tier_tags``."""
    import torch
    from repro_torch.core import importance as im
    from repro_torch.core import pam_interface as pi
    from repro_torch.core import tiers as tr
    hot, warm, cold = PAM_TIERS
    paged = tiers[2]
    src = pi.paged_to_dense(paged.k_pool, paged.block_table[0], PAM_BLOCK)
    _, moved = im.topk_hot_set(importance[hot + warm:], PAM_MOVED)
    slots = torch.arange(cold, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    free = torch.randperm(PAM_STAGING, generator=g,
                          device="cuda")[:PAM_FREE]
    dst = torch.zeros((PAM_STAGING,) + src.shape[1:], dtype=src.dtype,
                      device="cuda")

    def run():
        plan = pi.make_migration_plan(moved, slots, free)
        return plan, pi.apply_migration(src, dst, plan, slots)

    plan, out = run()
    cplan = pi.make_migration_plan(moved.cpu(), slots.cpu(), free.cpu())
    assert all(torch.equal(a.cpu(), b) for a, b in zip(plan, cplan))
    assert int(plan.count) == PAM_MOVED
    oracle = dst.clone()
    oracle[free[:PAM_MOVED].long()] = src[torch.nonzero(moved)[:, 0]]
    changed = int((out != dst).flatten(1).any(1).sum())
    row_bytes = src[0].numel() * src.element_size()
    assert torch.equal(out, oracle) and changed == PAM_MOVED
    cold_tags = tier[hot + warm:]
    tags = pi.migrate_tier_tags(cold_tags, moved, tr.HOT)
    assert int((tags == tr.HOT).sum()) == PAM_MOVED
    return dict(moved=PAM_MOVED, free_slots=PAM_FREE,
                slot0_free=bool((free == 0).any()), oracle_equal=True,
                rows_changed=changed, moved_bytes=changed * row_bytes,
                ms=_host_ms(run))


def phase_pam_core() -> dict:
    """The paper's core library at full qwen3-0.6b decode shapes: the
    tier-list ``pam_decode_attention`` (the decode kernels' path here),
    retrieval sparsity and Alg. 1's ``pam_attention_step``, the §6.1
    bank-group mapping and the §6.2 migration plan."""
    q, tiers, masks = _pam_core_case()
    alg1, (ck, cv) = _pam_alg1(q, tiers, masks)
    step, dense = _pam_step(q, ck, cv)
    del ck, cv
    return dict(launches=alg1.pop("launches"),
                launches_expected=alg1.pop("launches_expected"),
                alg1=alg1, **step, mapping=_pam_mapping(dense["k0"]),
                migration=_pam_migration(tiers, dense["importance"],
                                         dense["tier"]),
                tiers=list(PAM_TIERS), block_size=PAM_BLOCK)


def _cut(cfg, depth):
    """``cfg`` at ``depth``: None keeps the published depth; an int is the
    layer count, or a hybrid's group count (its groups' Mamba-2 layers and
    its tail kept); a ``HybridConfig`` is a hybrid's whole layout. A
    hybrid's ``n_layers`` counts its blocks: each group's Mamba-2 layers
    and shared-block site, and the tail."""
    if depth is None:
        return cfg
    if cfg.hybrid is None:
        return dataclasses.replace(cfg, n_layers=depth)
    hb = depth if not isinstance(depth, int) else dataclasses.replace(
        cfg.hybrid, n_groups=depth)
    return dataclasses.replace(
        cfg, hybrid=hb,
        n_layers=hb.n_groups * (hb.mamba_per_group + 1) + hb.tail_mamba)


def _model(dtype: str, arch: str = "qwen3-0.6b", n_layers=None):
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import get_config
    cfg = _cut(dataclasses.replace(get_config(arch), dtype=dtype), n_layers)
    return cfg, tf.init_params(cfg, 0, device="cuda")


def _pam(max_len: int, **kw):
    from repro_torch.serving import PAMManagerConfig
    return PAMManagerConfig(max_tokens=max_len, hot_capacity=256,
                            warm_capacity=768, compression=8,
                            recency_window=32, schedule_interval=4, **kw)


def _engine(cfg, params, n_req: int, new: int, pam_kw=None, shard=1,
            **scfg_kw):
    """An engine (sharded over ``shard`` sites) with ``n_req`` requests of
    512-1024 prompt tokens (seeded numpy draws) submitted."""
    import numpy as np
    from repro_torch.serving import EngineSpec, Request, ServingConfig
    scfg = ServingConfig(pam=_pam(scfg_kw["max_len"], **(pam_kw or {})),
                         **scfg_kw)
    eng = EngineSpec(model=cfg, serving=scfg, shard=shard).build(
        params, device="cuda")
    rng = np.random.default_rng(0)
    for i in range(n_req):
        plen = int(rng.integers(512, 1025))
        eng.submit(Request(i, rng.integers(0, cfg.vocab, plen), new))
    return eng


def run_engine(cfg, params, *, n_req: int, new: int, pam_kw=None,
               **scfg_kw) -> dict:
    import torch
    eng = _engine(cfg, params, n_req, new, pam_kw, **scfg_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()                       # counts of this run only
    summ = eng.run()
    launches = _launches()
    lens = [len(eng.requests[i].outputs) for i in range(n_req)]
    assert lens == [new] * n_req, f"outputs per request {lens}"
    return dict(summary=summ, launches=launches,
                body_steps=eng.decode_body_steps,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)


DECODE_KERNELS = ("flash_decode_merged", "flash_decode_paged_merged",
                  "flash_decode", "flash_decode_paged")


def _assert_decode_launches(launches: dict, want: dict) -> None:
    """Each decode wrapper called as often as ``want`` says (the merged
    ones n_layers x the micro-steps whose body ran on the host, the
    stacked ones never)."""
    for name in DECODE_KERNELS:
        n, w = launches[name], want.get(name, 0)
        assert n == w, f"{name}: {n} launches, want {w}"


def phase_engine_paged(cfg, params) -> dict:
    r = run_engine(cfg, params, n_req=8, new=64, max_batch=8,
                   max_len=2048, block_size=16, hot_window=256)
    want = cfg.n_layers * r["body_steps"]
    _assert_decode_launches(r["launches"], dict.fromkeys(DECODE_KERNELS[:2],
                                                         want))
    return _engine_line(r, want)


def phase_engine_paged_full(cfg, params) -> dict:
    """Paged + ring with retrieval sparsity off: every token outside the
    256-slot ring is read from the pool, so ``flash_decode_paged`` walks
    live blocks on every step (with sparsity on, the working set stays
    inside the ring and the pool partial is all identity)."""
    r = run_engine(cfg, params, n_req=8, new=16, max_batch=8,
                   max_len=2048, block_size=16, hot_window=256,
                   pam_kw=dict(use_sparsity=False))
    s = r["summary"]
    want = cfg.n_layers * r["body_steps"]
    _assert_decode_launches(r["launches"], dict.fromkeys(DECODE_KERNELS[:2],
                                                         want))
    assert s["blocks_touched_per_step"] > 0, s
    assert s["tier_reads"][1] + s["tier_reads"][2] > 0, s["tier_reads"]
    return _engine_line(r, want)


PAGED_RING = dict(block_size=16, hot_window=256)
HOST_SYNCS = ("aten::_local_scalar_dense", "cudaStreamSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpyAsync")
GRAPH_LAUNCH = "cudaGraphLaunch"
# the CUDA kernels of the two merged decode wrappers, as torch.profiler
# names them (the stacked wrappers, never called by the engine, launch the
# same kernels)
DECODE_CUDA_KERNELS = ("pam::flash_decode_kernel",
                       "pam::flash_decode_paged_kernel")


def _device_decode_counts(events) -> dict:
    """Executions on the card of each decode CUDA kernel among
    torch.profiler's ``key_averages()`` events."""
    return {name: sum(ev.count for ev in events
                      if str(ev.device_type).endswith("CUDA")
                      and name in ev.key)
            for name in DECODE_CUDA_KERNELS}


def _assert_device_decode_counts(counts: dict, kernels, want: int) -> None:
    """Each decode kernel in ``kernels`` ran ``want`` times on the card,
    the others never."""
    for name in DECODE_CUDA_KERNELS:
        w = want if name in kernels else 0
        assert counts[name] == w, (f"{name}: ran {counts[name]} times on "
                                   f"the card, want {w}")


def _warm_graphs(eng, max_steps: int = 16) -> None:
    """Step ``eng`` until the single-step decode graph of every Alg. 2
    phase exists (a key's first dispatch runs eagerly and captures), so
    that a profiled window holds replays only. An engine of a tree
    without decode graphs (``scripts/profile_tree.py`` on a parent)
    takes three warm steps."""
    if not hasattr(eng, "_graphs"):
        for _ in range(3):
            eng.step()
        return
    pcfg = eng.pam_cfg
    phases = (pcfg.schedule_interval if pcfg is not None
              and pcfg.use_tiering else 1)
    want = {(1, p) for p in range(phases)}
    for _ in range(max_steps):
        if want <= set(eng._graphs):
            return
        eng.step()
    raise AssertionError(f"decode graphs {sorted(eng._graphs)} after "
                         f"{max_steps} steps, want {sorted(want)}")


def _steady_steps(eng, n: int = 4) -> tuple[list, float | None]:
    """``n`` steady steps of ``eng``, each synchronised: their walls (host
    clock, s) and the device span of their decode dispatches (CUDA events
    around each dispatch, s; None on a tree without decode graphs). One
    minus span over the walls' sum is the device's idle share of the
    window."""
    import torch
    dispatch, spans, walls = getattr(eng, "_dispatch", None), [], []
    if dispatch is not None:             # a tree with decode graphs

        def timed(key, bufs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            dispatch(key, bufs)
            ev[1].record()
            spans.append(ev)
        eng._dispatch = timed
    torch.cuda.synchronize()
    try:
        for _ in range(n):
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        if dispatch is not None:
            eng._dispatch = dispatch
    if not spans:
        return walls, None
    return walls, sum(a.elapsed_time(b) for a, b in spans) / 1e3


# kernel-name classes of the profile phase: the union-mass reconstruction
# of PR 11-16 showed as pool gathers, copies and grouped-score products
# (cuBLAS on the H100 names its batch-8 GEMV kernels ``nvjet_*``)
KERNEL_CLASSES = {"matmul": ("gemm", "gemv", "cutlass", "cublas", "nvjet"),
                  "gather_scatter": ("index", "gather", "scatter"),
                  "copy": ("copy", "Copy")}


def _count_calls(module, name: str, counts: dict):
    """Wrap ``module.name`` to count its calls in ``counts``; returns the
    original, for restoring."""
    orig = getattr(module, name)

    def counted(*a, **kw):
        counts[name] += 1
        return orig(*a, **kw)
    counts[name] = 0
    setattr(module, name, counted)
    return orig


def phase_profile(cfg, params, layout=PAGED_RING, eng=None,
                  decode_kernels=DECODE_CUDA_KERNELS) -> dict:
    """Where a decode step's time goes: torch.profiler over 4 steady
    decode steps (after 4 timed without it: their step ms, and the
    device time of their dispatches from CUDA events around each one
    against the same window's wall time) of an engine at
    batch 8 (the paged + ring main path, or
    ``layout={}`` for the dense cache, or a ready engine ``eng`` whose
    admissions are done): device time by kernel name, kernel
    launches per step by class (matmul, gather / scatter, copy), the
    device's busy share of the window's wall time, the peak device memory
    the steps allocate above what the engine holds, the decode wrappers'
    calls and the decode kernels the card ran (each of
    ``decode_kernels`` n_layers x 4 times, the others never), the calls
    of the union-mass reconstruction's pool gather
    (``paged_gather_logical``) and grouped QK^T (``ops._grouped_scores``),
    and the host events that wait on the device or copy (readbacks)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import pam_interface
    from repro_torch.kernels import ops
    if eng is None:
        eng = _engine(cfg, params, 8, 16, max_batch=8, max_len=2048,
                      **layout)
    _warm_graphs(eng)                    # admission, captures
    walls, dispatch_s = _steady_steps(eng)      # the same steps unprofiled
    plain_wall = sum(walls)
    dispatches = eng.decode_dispatches
    torch.cuda.synchronize()
    calls: dict = {}
    saved = [(m, n, _count_calls(m, n, calls)) for m, n in (
        (pam_interface, "paged_gather_logical"), (ops, "_grouped_scores"))]
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for m, n, orig in saved:
            setattr(m, n, orig)
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 2**30
    launches = {k: v for k, v in _launches().items() if k in DECODE_KERNELS}
    dispatches = eng.decode_dispatches - dispatches
    assert dispatches == 4, f"{dispatches} decode dispatches in 4 steps"
    rows = []                   # device-side events only (kernels, copies)
    syncs, graph_launches = {}, 0
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            rows.append((ev.self_device_time_total, ev.key, ev.count))
        elif ev.key in HOST_SYNCS:
            syncs[ev.key] = ev.count
        elif ev.key == GRAPH_LAUNCH:
            graph_launches = ev.count
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    on_device = _device_decode_counts(prof.key_averages())
    if rows:
        _assert_device_decode_counts(on_device, decode_kernels,
                                     cfg.n_layers * 4)
    else:
        return dict(steps=4, wall_s=wall, device_time="not measured",
                    decode_kernels_on_device="not measured",
                    graph_launches_per_step=graph_launches / 4)
    classes = {}
    for cls, keys in KERNEL_CLASSES.items():
        sel = [r for r in rows if any(k in r[1] for k in keys)]
        classes[cls] = dict(launches_per_step=sum(r[2] for r in sel) / 4,
                            device_ms_per_step=sum(r[0] for r in sel) / 4e3)
    kernels = sum(r[2] for r in rows
                  if not r[1].startswith(("Memcpy", "Memset")))
    return dict(steps=4, wall_s=wall, step_ms=wall / 4 * 1e3,
                unprofiled_step_ms=plain_wall / 4 * 1e3,
                unprofiled_dispatch_device_ms_per_step=(
                    "not measured" if dispatch_s is None
                    else dispatch_s / 4 * 1e3),
                unprofiled_device_idle_share=(
                    "not measured" if dispatch_s is None
                    else 1 - dispatch_s / plain_wall),
                host_sync_events=syncs,
                host_sync_events_per_dispatch={
                    k: v / dispatches for k, v in syncs.items()},
                graph_launches_per_step=graph_launches / 4,
                kernel_nodes_per_step=kernels / 4,
                graphs=sorted(getattr(eng, "_graphs", {})),
                device_busy_s=busy_s, device_idle_share=1 - busy_s / wall,
                kernel_launches=sum(r[2] for r in rows),
                launches_per_step=sum(r[2] for r in rows) / 4,
                kernel_classes=classes, decode_launches=launches,
                decode_kernels_on_device=on_device,
                union_mass_calls=calls, peak_step_mem_gb=peak_gb,
                top=[dict(name=k[:80], device_ms=us / 1e3, count=n,
                          us_per_launch=us / max(n, 1))
                     for us, k, n in rows[:12]],
                ported=[dict(name=k[:80], device_ms=us / 1e3, count=n,
                             us_per_launch=us / max(n, 1))
                        for us, k, n in rows if "pam::" in k])


# the prefix / chunk / sampled serving phase: one 760-token system prompt
# (47 full blocks of 16 and 8 tokens, so every hit copy-on-writes its
# tail block) shared by eight requests, each with its own novel tail
SYS_PROMPT = 760
TAILS = (48, 100, 200, 300, 400, 520, 640, 600)
PREFIX_CHUNK = dict(prefix_cache=True, prefill_chunk=256)
SAMPLED = dict(temperature=0.8, top_k=50, sample_seed=7)
SAMPLER_ROWS = 8                         # the engine's max_batch


def _inv_temperature(t: float) -> float:
    """The sampler's fp32 reciprocal of the temperature."""
    import numpy as np
    return float(np.float32(1.0) / np.float32(t))


def _shared_prompts(vocab: int):
    import numpy as np
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, SYS_PROMPT)
    return [np.concatenate([system, rng.integers(0, vocab, n)])
            .astype(np.int32) for n in TAILS]


def _prefix_engine(cfg, params, *, prefix_chunk=True, sampled=True):
    """The phase's engine: paged + ring at batch 8, max_len 2048, with
    retrieval sparsity off so that every token outside the ring (the
    shared system prompt included) is read through the pool."""
    from repro_torch.serving import ServingConfig, ServingEngine
    scfg = ServingConfig(
        max_batch=8, max_len=2048, **PAGED_RING,
        pam=_pam(2048, use_sparsity=False),
        **(PREFIX_CHUNK if prefix_chunk else {}),
        **(SAMPLED if sampled else {}))
    return ServingEngine(cfg, params, scfg, device=params["embed"].device)


def _serve_shared(eng, prompts, new: int, ids=None):
    """Request ``ids[0]`` first, the others once it runs (its prompt is
    then in the trie); returns (summary, TTFT seconds by request)."""
    from repro_torch.serving import Request
    ids = list(range(len(prompts))) if ids is None else ids
    submitted = {}
    eng.submit(Request(ids[0], prompts[ids[0]], new))
    submitted[ids[0]] = eng.clock
    while eng.requests[ids[0]].status not in ("running", "done"):
        eng.step()
    for i in ids[1:]:
        eng.submit(Request(i, prompts[i], new))
        submitted[i] = eng.clock
    summ = eng.run()
    return summ, {i: eng.requests[i].first_token_time - submitted[i]
                  for i in ids}


def _profile_calls(fn) -> tuple[int, float]:
    """(kernel launches, device ms) of one call of ``fn``, from
    torch.profiler (after a warm call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):   # see _device_ms_by_kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [ev for ev in prof.key_averages()
                if str(ev.device_type).endswith("CUDA")]
        if rows:
            break
    return (sum(ev.count for ev in rows),
            sum(ev.self_device_time_total for ev in rows) / 1e3)


def phase_engine_prefix_chunk_sampled(cfg, params) -> dict:
    """Full-width qwen3-0.6b served with the prefix cache, chunked prefill
    (256-token slices) and sampling (temperature 0.8, top-50, seed 7):
    eight requests share a 760-token system prompt; request 0 (808
    tokens) runs first, then the seven others hit its trie entries, each
    copy-on-writing the shared tail block; novel tails over 256 tokens
    admit in slices. During the run each step's pool table is checked
    for physical blocks that two or more rows map (the paged kernel
    walks them), and every sampled token for membership of its row's
    top-50 (a few device ops a step beside the engine's)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import sampling
    eng = _prefix_engine(cfg, params)
    scfg = eng.scfg
    prompts = _shared_prompts(cfg.vocab)
    # device accumulators the hooks update in place, so that captured
    # decode graphs update them at every replay: decode steps seen, steps
    # whose table maps a block from two or more rows, the most such
    # blocks in a step, tokens sampled outside their row's top-k
    acc = torch.zeros(4, dtype=torch.int64, device=params["embed"].device)
    calls = [0]
    orig_paged = ops.flash_decode_paged_merged

    def paged(q, k_pool, v_pool, table, *a, **kw):
        if calls[0] % cfg.n_layers == 0:          # one table a step
            nb_pool = k_pool.shape[0] - 1         # the sentinel excluded
            flat = table.long().flatten()
            cnt = torch.zeros(nb_pool + 1, dtype=torch.int64,
                              device=flat.device).scatter_add_(
                0, flat, torch.ones_like(flat))[:nb_pool]
            shared = torch.sum(cnt >= 2)
            acc[0] += 1
            acc[1] += (shared >= 1).long()
            acc[2] = torch.maximum(acc[2], shared)
        calls[0] += 1
        return orig_paged(q, k_pool, v_pool, table, *a, **kw)

    orig_sample = eng._sample
    inv_t = _inv_temperature(scfg.temperature)

    def sample(logits, rids, positions):
        tok = orig_sample(logits, rids, positions)
        lg = logits.float() * inv_t
        kth = torch.topk(lg, scfg.top_k, dim=-1).values[:, -1]
        acc[3] += torch.sum(lg.gather(1, tok.long()[:, None])[:, 0] < kth)
        return tok

    eng._sample = sample
    ops.flash_decode_paged_merged = paged
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()                       # counts of this run only
    try:
        s, ttft = _serve_shared(eng, prompts, 64)
    finally:
        ops.flash_decode_paged_merged = orig_paged
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    steps_seen, steps_shared, shared_max, outside = acc.tolist()
    lens = [len(eng.requests[i].outputs) for i in range(len(prompts))]
    assert lens == [64] * len(prompts), f"outputs per request {lens}"
    assert s["prefix_hits"] == 7 and s["cow_copies"] >= 7, s
    assert s["chunked_admissions"] >= 4, s
    assert s["max_chunk_slice_tokens"] <= 256, s
    assert s["novel_prefill_tokens"] == SYS_PROMPT + sum(TAILS), s
    steps = s["decode_device_steps"]
    want = cfg.n_layers * eng.decode_body_steps
    _assert_decode_launches(launches, dict.fromkeys(DECODE_KERNELS[:2],
                                                    want))
    assert steps_seen == steps and shared_max >= 1, acc.tolist()
    assert outside == 0, f"{outside} tokens outside their top-k"
    # the sampler alone at the engine's shapes: (8, vocab) logits
    dev = params["embed"].device
    g = torch.Generator(device=dev).manual_seed(1)
    logits = torch.randn((SAMPLER_ROWS, cfg.vocab), generator=g,
                         device=dev).to(params["embed"].dtype)
    rids = torch.arange(SAMPLER_ROWS, device=dev)
    pos = torch.full((SAMPLER_ROWS,), 1000, device=dev)

    def draw():
        return sampling.sample_tokens(logits, scfg.sample_seed, rids, pos,
                                      scfg.temperature, scfg.top_k)
    sampler_launches, sampler_dev_ms = _profile_calls(draw)
    ttfts = sorted(ttft.values())
    return dict(_engine_line(dict(summary=s, launches=launches,
                                  body_steps=eng.decode_body_steps,
                                  peak_mem_gb=peak_gb), want),
                **{k: s[k] for k in (
                    "prefix_hits", "cached_prefix_tokens",
                    "novel_prefill_tokens", "cow_copies", "trie_blocks",
                    "trie_evictions", "chunked_admissions", "chunk_slices",
                    "max_chunk_slice_tokens", "prefill_dispatches",
                    "admit_dispatches")},
                ttft_s=ttft, ttft_p50_s=ttfts[len(ttfts) // 2],
                ttft_max_s=ttfts[-1],
                shared_blocks_max=shared_max,
                steps_over_shared_blocks=steps_shared,
                paged_launches_over_shared_blocks=cfg.n_layers
                * steps_shared, graphs=len(eng._graphs),
                sampler_launches_per_step=sampler_launches,
                sampler_device_ms_per_step=sampler_dev_ms,
                sampler_ms=_time_ms(draw),
                sampler_shape=[SAMPLER_ROWS, cfg.vocab],
                sys_prompt=SYS_PROMPT, tails=list(TAILS),
                sparsity=False, **SAMPLED, **PREFIX_CHUNK)


def _recording(eng, eager: bool = False):
    """Record each decode dispatch of ``eng``: (key, host seconds, the
    StepBufs it read back); ``eager`` binds the eager body (the twin)."""
    eng.log = []
    if eager:
        eng._dispatch = eng._dispatch_eager
    decode, dispatch = eng._decode, eng._dispatch
    keys = []

    def keyed(key, bufs):
        keys.append(key)
        return dispatch(key, bufs)

    def recorded(k, active):
        t0 = time.perf_counter()
        out = decode(k, active)
        eng.log.append((keys[-1], time.perf_counter() - t0, out))
        return out
    eng._dispatch, eng._decode = keyed, recorded
    return eng


def _step_events(fn) -> dict:
    """One call of ``fn`` (a steady engine step, one graph replay) under
    torch.profiler, after a warm call: its kernel nodes, its copies and
    memsets, graph launches, device ms (all, by ``KERNEL_CLASSES``, and
    the eight longest kernels) and the decode kernels the card ran (by
    name, and by instantiation)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):   # see _device_ms_by_kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = prof.key_averages()
        dev = [ev for ev in evs if str(ev.device_type).endswith("CUDA")]
        if dev:
            break
    copies = [ev for ev in dev if ev.key.startswith(("Memcpy", "Memset"))]
    return dict(
        kernel_nodes=sum(ev.count for ev in dev) - sum(
            ev.count for ev in copies),
        copies=sum(ev.count for ev in copies),
        graph_launches=sum(ev.count for ev in evs
                           if ev.key == GRAPH_LAUNCH),
        device_ms=sum(ev.self_device_time_total for ev in dev) / 1e3,
        decode_kernels_on_device=_device_decode_counts(dev),
        device_ms_by_class={
            cls: sum(ev.self_device_time_total for ev in dev
                     if any(k in ev.key for k in keys)) / 1e3
            for cls, keys in KERNEL_CLASSES.items()},
        top=[dict(name=ev.key[:80], device_ms=ev.self_device_time_total / 1e3,
                  count=ev.count)
             for ev in sorted(dev, key=lambda e: -e.self_device_time_total)
             [:8]],
        decode_instantiations={ev.key: ev.count for ev in dev
                               if "pam::flash_decode" in ev.key})


def _twin_diff(g, e):
    """None, or the first dispatch and StepBufs field where the graph
    twin ``g`` and the eager twin ``e`` differ (streams included)."""
    import numpy as np
    if len(g.log) != len(e.log):
        return dict(dispatches=[len(g.log), len(e.log)])
    for n, ((kg, _, a), (ke, _, b)) in enumerate(zip(g.log, e.log)):
        if kg != ke:
            return dict(dispatch=n, keys=[kg, ke])
        for f in a:
            if not np.array_equal(a[f], b[f]):
                return dict(dispatch=n, field=f)
    for rid, rs in g.requests.items():
        if rs.outputs != e.requests[rid].outputs:
            return dict(stream=rid)
    return None


def _twin_line(g, e) -> dict:
    """Graphs, capture ms, steady step ms and decode tok/s of a twin
    pair: steady steps are the graph twin's dispatches of an already
    captured key, and every eager dispatch."""
    import numpy as np
    seen, steady = set(), []
    for key, sec, _ in g.log:
        if key in seen:
            steady.append(sec / key[0])
        seen.add(key)
    eager = [sec / key[0] for key, sec, _ in e.log]
    sg, se = g.summary(), e.summary()
    return dict(
        graphs_captured=len(g._graphs), keys=sorted(g._graphs),
        capture_ms_total=g.capture_seconds * 1e3,
        capture_ms_per_graph=g.capture_seconds * 1e3 / max(len(g._graphs),
                                                           1),
        dispatches=sg["decode_dispatches"],
        decode_device_steps=sg["decode_device_steps"],
        graph_step_ms_median=float(np.median(steady)) * 1e3,
        eager_step_ms_median=float(np.median(eager)) * 1e3,
        graph_decode_tok_s=sg["decode_tok_s"],
        eager_decode_tok_s=se["decode_tok_s"],
        graph_decode_time_s=sg["decode_time_s"],
        eager_decode_time_s=se["decode_time_s"])


def phase_decode_graph(cfg, params, moe=None) -> dict:
    """Twin engines in one call, one replaying decode graphs and one
    running the eager in-place body (bound by hand): full-width
    qwen3-0.6b, paged + ring, 8 requests of 512-1024 prompt tokens and 64
    new; (a) greedy, (b) dense PAM (engine_dense_pam's 4 requests of
    32 new), (c) sampled (temperature 0.8, top-50) with the prefix cache
    and 256-token chunks over the shared-prompt requests, (d) greedy at
    micro_steps 4 with an EOS token, and (e) with ``moe`` (its (cfg,
    params)) the full-width qwen3-moe pair of ``_moe_twins``. Streams and
    every StepBufs field
    must be equal; the merged decode wrappers are called n_layers x the
    host-run body steps on the graph twins of (a) and (b); one profiled
    steady step of each of those graph twins (a replay) runs each of its
    decode kernels n_layers times on the card and gives the kernel nodes
    of one single-step graph."""
    import torch
    out = dict(card=_card())
    runs = {}
    # (a) greedy
    g = _recording(_engine(cfg, params, 8, 64, max_batch=8, max_len=2048,
                           **PAGED_RING))
    torch.cuda.synchronize()
    _reset_launches()
    _warm_graphs(g)
    step_events = _step_events(g.step)
    g.run()
    launches = _launches()
    e = _recording(_engine(cfg, params, 8, 64, max_batch=8, max_len=2048,
                           **PAGED_RING), eager=True)
    e.run()
    body_steps = g.decode_body_steps
    _assert_decode_launches(launches, dict.fromkeys(
        DECODE_KERNELS[:2], cfg.n_layers * body_steps))
    _assert_device_decode_counts(step_events["decode_kernels_on_device"],
                                 DECODE_CUDA_KERNELS, cfg.n_layers)
    runs["greedy"] = dict(_twin_line(g, e), diff=_twin_diff(g, e))
    eos = g.requests[0].outputs[10]
    del g, e
    gc.collect()
    # (b) dense PAM (engine_dense_pam's requests): the merged dense
    # kernel over the whole 2048-token cache
    _reset_launches()
    g = _recording(_engine(cfg, params, 4, 32, max_batch=4, max_len=2048))
    _warm_graphs(g)
    dense_step = _step_events(g.step)
    g.run()
    dense_launches = _launches()
    e = _recording(_engine(cfg, params, 4, 32, max_batch=4, max_len=2048),
                   eager=True)
    e.run()
    dense_body_steps = g.decode_body_steps
    _assert_decode_launches(dense_launches, {
        "flash_decode_merged": cfg.n_layers * dense_body_steps})
    _assert_device_decode_counts(dense_step["decode_kernels_on_device"],
                                 DECODE_CUDA_KERNELS[:1], cfg.n_layers)
    runs["dense_pam"] = dict(_twin_line(g, e), diff=_twin_diff(g, e))
    del g, e
    gc.collect()
    # (c) sampled, prefix cache, chunked prefill
    prompts = _shared_prompts(cfg.vocab)
    pair = []
    for eager in (False, True):
        eng = _recording(_prefix_engine(cfg, params), eager)
        _serve_shared(eng, prompts, 64)
        pair.append(eng)
    runs["sampled_prefix_chunk"] = dict(_twin_line(*pair),
                                        diff=_twin_diff(*pair),
                                        prefix_hits=pair[0].prefix_hits)
    del pair
    gc.collect()
    # (d) micro_steps 4 with EOS
    pair = []
    for eager in (False, True):
        eng = _recording(_engine(cfg, params, 8, 64, max_batch=8,
                                 max_len=2048, micro_steps=4, eos_token=eos,
                                 **PAGED_RING), eager)
        eng.run()
        pair.append(eng)
    runs["micro4_eos"] = dict(_twin_line(*pair), diff=_twin_diff(*pair),
                              eos=eos, stopped_at_eos=sum(
                                  rs.outputs[-1] == eos
                                  for rs in pair[0].requests.values()))
    del pair
    gc.collect()
    if moe is not None:       # (e) the MoE family, group-16 kernels
        runs["moe_greedy"] = _moe_twins(*moe)
    out.update(runs, launches=launches, decode_body_steps=body_steps,
               launches_expected=cfg.n_layers * body_steps,
               dense_launches=dense_launches,
               dense_decode_body_steps=dense_body_steps,
               dense_launches_expected=cfg.n_layers * dense_body_steps,
               single_step_graph=step_events,
               dense_single_step_graph=dense_step)
    for name, r in runs.items():
        print(f"decode_graph {name}: {json.dumps(r)}", flush=True)
    bad = {n: r["diff"] for n, r in runs.items() if r["diff"] is not None}
    assert not bad, f"graph and eager twins differ: {bad}"
    assert runs["micro4_eos"]["stopped_at_eos"] >= 1, runs["micro4_eos"]
    assert runs["sampled_prefix_chunk"]["prefix_hits"] == 7, runs
    return out


def phase_profile_prefix_chunk_sampled(cfg, params) -> dict:
    """The profile phase over 4 decode steps of the prefix / chunk /
    sampled engine once all eight requests run (every admission done):
    a sampled step whose tables share the system prompt's blocks."""
    from repro_torch.serving import Request
    eng = _prefix_engine(cfg, params)
    prompts = _shared_prompts(cfg.vocab)
    eng.submit(Request(0, prompts[0], 64))
    while eng.requests[0].status != "running":
        eng.step()
    for i in range(1, len(prompts)):
        eng.submit(Request(i, prompts[i], 64))
    while eng.waiting or any(r.status == "prefilling"
                             for r in eng.requests.values()):
        eng.step()
    return dict(phase_profile(cfg, params, eng=eng),
                prefix_hits=eng.prefix_hits, cow_copies=eng.cow_copies)


MARGIN_RIDS = 64                         # request ids a margin table holds


class _Margins:
    """Top-2 margins by (rid, position), kept on the card: the sampler
    hook writes the first margin of each (rid, position) into a (rids,
    max_len + 1) table in place, so a captured decode dispatch records
    the write and every replay makes it. ``get((rid, position))`` reads
    one back (None where nothing was sampled)."""

    def __init__(self, max_len: int, device):
        import torch
        self.table = torch.full((MARGIN_RIDS, max_len + 1), float("nan"),
                                device=device)

    def record(self, rids, positions, margin) -> None:
        import torch
        R, P = self.table.shape
        r = rids.long().clamp(0, R - 1)
        p = positions.long().clamp(0, P - 1)
        cur = self.table[r, p]
        first = (rids < R) & (positions < P) & torch.isnan(cur)
        self.table[r, p] = torch.where(first, margin.float(), cur)

    def get(self, key):
        r, p = key
        R, P = self.table.shape
        if not (0 <= r < R and 0 <= p < P):
            return None
        v = float(self.table[r, p])
        return None if v != v else v


def _margins(eng, sampled: bool, rec: "_Margins | None" = None) -> _Margins:
    """Record, for every sampled (rid, position), the gap between the two
    largest values the draw takes its argmax over (the logits; sampled:
    the masked, scaled logits plus the row's Gumbel noise), into ``rec``
    (a new table when None; several engines may share one)."""
    import torch
    from repro_torch.serving import sampling as smp
    if rec is None:
        rec = _Margins(eng.scfg.max_len, eng.device)
    orig = eng._sample
    scfg = eng.scfg

    def sample(logits, rids, positions):
        tok = orig(logits, rids, positions)
        v = logits.float()
        if sampled:
            v = v * _inv_temperature(scfg.temperature)
            if scfg.top_k:
                kth = torch.topk(v, scfg.top_k, dim=-1).values[:, -1:]
                v = v.masked_fill(v < kth, float("-inf"))
            key = smp.fold_in(smp.fold_in(smp.prng_key(scfg.sample_seed),
                                          rids.long()), positions.long())
            v = v + smp.gumbel(key, v.shape[-1], v.device)
        top = torch.topk(v, 2, dim=-1).values
        rec.record(rids, positions, top[:, 0] - top[:, 1])
        return tok

    eng._sample = sample
    return rec


def _first_divergence(prompts, got: dict, want: dict, rec_got: dict,
                      rec_want: dict):
    """None, or where two streams first differ with both runs' top-2
    margins at that position."""
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        pos = len(prompts[rid]) + t
        return dict(rid=rid, token_index=t, position=pos, got=a[t],
                    want=b[t], margin_got=rec_got.get((rid, pos)),
                    margin_want=rec_want.get((rid, pos)))
    return None


def _sampler_parity(dev: str = "cuda") -> dict:
    """(a) The sampler on the card against the same function on the CPU
    (the version tier-1 pins to JAX): bits bit for bit and tokens, for
    (8, 151936) fp32 logits at 16 (seed, rid, pos) triples."""
    import torch
    from repro_torch.serving import sampling as smp
    V = 151936
    g = torch.Generator().manual_seed(3)
    logits = torch.randn((2, SAMPLER_ROWS, V), generator=g) * 3
    rids = torch.tensor([0, 1, 5, 77, 2**31 + 3, 2**32 - 1, 12, 9])
    pos = torch.tensor([808, 1000, 2047, 0, 3, 1500, 65535, 123])
    out = dict(triples=16, vocab=V, rows=[])
    for (seed, temp, top_k), lg in zip(((7, 0.8, 50), (123456789, 1.3, 0)),
                                       logits):
        key = smp.fold_in(smp.fold_in(smp.prng_key(seed), rids), pos)
        kc = smp.fold_in(smp.fold_in(smp.prng_key(seed), rids.to(dev)),
                         pos.to(dev))
        keys_equal = all(torch.equal(a, b.cpu()) for a, b in zip(key, kc))
        bits_cpu = smp.random_bits(key, V, "cpu")
        bits_gpu = smp.random_bits(kc, V, dev).cpu()
        g_cpu = smp.gumbel(key, V, "cpu")
        g_gpu = smp.gumbel(kc, V, dev).cpu()
        # one ulp of the inner log carried through the outer one, plus
        # one ulp of the outer: |diff| <= eps (1 + |g|) (as on the CPU
        # against XLA); reported as the largest share of that bound
        eps = torch.finfo(torch.float32).eps
        gumbel_share = float(((g_cpu - g_gpu).abs()
                              / (eps * (1 + g_cpu.abs()))).max())
        tok_cpu = smp.sample_tokens(lg, seed, rids, pos, temp, top_k)
        tok_gpu = smp.sample_tokens(lg.to(dev), seed, rids.to(dev),
                                    pos.to(dev), temp, top_k).cpu()
        row = dict(seed=seed, temperature=temp, top_k=top_k,
                   keys_equal=keys_equal,
                   bits_equal=bool(torch.equal(bits_cpu, bits_gpu)),
                   tokens_equal=bool(torch.equal(tok_cpu, tok_gpu)),
                   gumbel_diff_share_of_bound=gumbel_share)
        if not row["tokens_equal"]:
            v = lg * _inv_temperature(temp) + g_cpu
            top = torch.topk(v, 2, dim=-1).values
            row["margins"] = (top[:, 0] - top[:, 1]).tolist()
        out["rows"].append(row)
    return out


def phase_prefix_chunk_parity() -> dict:
    """Full-width qwen3-0.6b in fp32 (TF32 off): (a) the sampler on the
    card against its CPU run; (b) the twin property: greedy streams of
    the eight shared-prompt requests (16 new tokens) with the prefix
    cache and chunked prefill on equal those with both off; (c) a
    sampled stream run alone equals the same request's stream in the
    batch. A stream that differs fails the phase with the position and
    both runs' top-2 margins there."""
    import torch
    a = _sampler_parity()
    cfg, params = _model("float32")
    prompts = _shared_prompts(cfg.vocab)
    streams, recs = {}, {}
    for on in (True, False):
        eng = _prefix_engine(cfg, params, prefix_chunk=on, sampled=False)
        recs[on] = _margins(eng, sampled=False)
        summ, _ = _serve_shared(eng, prompts, 16)
        streams[on] = {i: eng.requests[i].outputs for i in range(8)}
        if on:
            twin_counts = {k: summ[k] for k in (
                "prefix_hits", "cow_copies", "chunked_admissions")}
        del eng
        torch.cuda.empty_cache()
    b = _first_divergence(prompts, streams[True], streams[False],
                          recs[True], recs[False])
    batch = _prefix_engine(cfg, params)
    rec_batch = _margins(batch, sampled=True)
    _serve_shared(batch, prompts, 16)
    together = {i: batch.requests[i].outputs for i in range(8)}
    del batch
    c, alone_ids = None, (1, 6)
    for rid in alone_ids:
        solo = _prefix_engine(cfg, params)
        rec_solo = _margins(solo, sampled=True)
        _serve_shared(solo, prompts, 16, ids=[rid])
        c = c or _first_divergence(prompts, {rid: solo.requests[rid].outputs},
                                   {rid: together[rid]}, rec_solo, rec_batch)
        del solo
    torch.cuda.empty_cache()
    out = dict(dtype="float32", tf32=False, sampler=a,
               twin_equal=b is None, twin_counts=twin_counts,
               alone_equal=c is None, alone_ids=list(alone_ids))
    bad_a = [r for r in a["rows"] if not (
        r["keys_equal"] and r["bits_equal"] and r["tokens_equal"])]
    assert not bad_a, f"sampler card vs CPU: {bad_a}"
    assert twin_counts["prefix_hits"] == 7, twin_counts
    assert b is None, f"twin streams differ: {b}"
    assert c is None, f"alone vs batch streams differ: {c}"
    return out


def phase_engine_dense(cfg, params) -> dict:
    r = run_engine(cfg, params, n_req=4, new=32, max_batch=4,
                   max_len=2048)
    want = cfg.n_layers * r["body_steps"]
    _assert_decode_launches(r["launches"], {"flash_decode_merged": want})
    return _engine_line(r, want)


CLUSTER_BALANCER = dict(rebalance_interval=2, hysteresis=1.1,
                        cooldown_ticks=4, min_remaining=2)


def _cluster(cfg, params, devices: str, chaos=None, device="cuda"):
    """A ``ClusterSpec`` fleet of modeled device classes on the card,
    engine_paged_ring's serving template (each class sets its batch and
    pool), the perf model's latency models and scripts/cluster_smoke.py's
    balancer; with ``chaos`` (a ``--chaos`` spec, "" for none) the
    recovery watchdog at ``RecoveryConfig()`` defaults too."""
    from repro_torch.cluster import (BalancerConfig, ClusterSpec,
                                     FaultInjector, KVBalancer,
                                     RecoveryConfig)
    from repro_torch.serving import ServingConfig
    spec = ClusterSpec.from_cli(devices, model=cfg, serving=ServingConfig(
        max_len=2048, pam=_pam(2048), **PAGED_RING),
        recovery=RecoveryConfig() if chaos is not None else None)
    return spec.build(params, device=device,
                      balancer=KVBalancer(BalancerConfig(**CLUSTER_BALANCER)),
                      faults=FaultInjector.from_spec(chaos) if chaos else None)


def _cluster_stream(vocab: int, n: int, pinned: int, new: int):
    """``pinned`` requests for cxl0 at arrival 0 (to load the slow device,
    as scripts/cluster_smoke.py does), the rest at Poisson gaps of mean
    2 ms of modeled time; prompts of 512-1024 tokens (seeded)."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    t, out = 0.0, []
    for i in range(n):
        if i >= pinned:
            t += float(rng.exponential(0.002))
        plen = int(rng.integers(512, 1025))
        out.append(Request(i, rng.integers(0, vocab, plen), new, arrival=t))
    return out[:pinned], out[pinned:]


class _MigrationClock:
    """Wall ms of every export (gather + host copy), crc32 seal, wire
    clone, receiver-side crc32 check (``verify``; ``commit`` checks once
    more), import (host-to-device copy + commit) and whole recovery
    transfer while installed, with the card synchronised around each;
    snapshot and live ``kv_bytes`` too."""

    def __init__(self):
        self.export_ms, self.seal_ms, self.import_ms = [], [], []
        self.clone_ms, self.verify_ms, self.transfer_ms = [], [], []
        self.snapshot_bytes, self.kv_bytes = [], []

    def __enter__(self):
        from repro_torch.cluster import migration, recovery
        from repro_torch.serving.engine import ServingEngine
        self._saved = [(ServingEngine, "export_request"),
                       (ServingEngine, "import_request"),
                       (migration.KVSnapshot, "seal")]
        extra = [(migration.KVSnapshot, "clone", self.clone_ms),
                 (migration.KVSnapshot, "verify", self.verify_ms),
                 (recovery.RecoveryManager, "transfer", self.transfer_ms)]
        self._saved += [(c, n) for c, n, _ in extra]
        self._orig = [getattr(c, n) for c, n in self._saved]
        exp, imp, seal = self._orig[:3]
        clock = self

        def timed(fn, sink):
            def run(*a, **kw):
                import torch
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                sink.append((time.perf_counter() - t0) * 1e3)
                return out
            return run

        def export(eng, rid):
            d = timed(exp, clock.export_ms)(eng, rid)
            clock.snapshot_bytes.append(d["k"].nbytes + d["v"].nbytes)
            L, Hkv, _, dh = d["k"].shape
            clock.kv_bytes.append(2 * L * Hkv * dh * d["length"]
                                  * d["k"].dtype.itemsize)
            return d

        ServingEngine.export_request = export
        ServingEngine.import_request = timed(imp, self.import_ms)
        migration.KVSnapshot.seal = timed(seal, self.seal_ms)
        for (c, n, sink), fn in zip(extra, self._orig[3:]):
            setattr(c, n, timed(fn, sink))
        return self

    def __exit__(self, *exc):
        for (c, n), fn in zip(self._saved, self._orig):
            setattr(c, n, fn)

    def line(self) -> dict:
        import numpy as np

        def stats(xs):
            return dict(n=len(xs), median=float(np.median(xs)) if xs else 0.0,
                        max=float(max(xs)) if xs else 0.0)
        return dict(export_ms=stats(self.export_ms),
                    seal_crc32_ms=stats(self.seal_ms),
                    import_ms=stats(self.import_ms),
                    snapshot_bytes=sorted(set(self.snapshot_bytes)),
                    kv_bytes=stats(self.kv_bytes),
                    clone_ms=stats(self.clone_ms),
                    verify_crc32_ms=stats(self.verify_ms),
                    transfer_ms=stats(self.transfer_ms))


def phase_engine_cluster(cfg, params) -> dict:
    """Full-width qwen3-0.6b (bf16) on a modeled ``hbm:1,cxl:2`` fleet, all
    three engines on this one card sharing one copy of the weights: 24
    requests of 64 new tokens, 8 pinned to cxl0, 16 routed; the balancer
    must move at least one. Modeled figures are the perf model's PIM
    hardware (``modeled_``), the rest the card's."""
    import torch
    from repro_torch import tree
    router = _cluster(cfg, params, "hbm:1,cxl:2")
    pinned, rest = _cluster_stream(cfg.vocab, 24, 8, 64)
    ptrs = [[x.data_ptr() for x in tree.leaves(d.engine.params)]
            for d in router.devices]
    assert all(p == ptrs[0] for p in ptrs), "engines hold weight copies"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with _MigrationClock() as mig:
        t0 = time.perf_counter()
        for r in pinned:
            router.submit_to(r, "cxl0")
        events = list(router.serve(rest))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _launches()
    s = router.summary()
    lens = {rid: len(rs.outputs) for rid, rs in router.finished.items()}
    assert s["finished"] == 24 and set(lens.values()) == {64}, lens
    assert s["balancer_migrations"] >= 1, s
    want = cfg.n_layers * sum(d.engine.decode_body_steps
                              for d in router.devices)
    _assert_decode_launches(launches, dict.fromkeys(DECODE_KERNELS[:2],
                                                    want))
    decode_tokens = 24 * 63
    decode_s = sum(d.engine.decode_time for d in router.devices)
    card = dict(wall_s=wall, wall_tok_s=24 * 64 / wall,
                decode_tok_s=decode_tokens / decode_s)
    lines = [("card", card)] + [
        (f"device {n}", {k: d[k] for k in ("class", "steps",
                                           "tokens_emitted", "migrations_in",
                                           "migrations_out")})
        for n, d in s["devices"].items()] + [
        ("migrations", dict(balancer=s["balancer_migrations"],
                            **mig.line())),
        ("memory", dict(peak_mem_gb=torch.cuda.max_memory_allocated()
                        / 2**30)),
        ("modeled (the perf model's PIM hardware, not the card)",
         dict(modeled_makespan_s=s["makespan_s"],
              modeled_tok_s=s["throughput_tok_s"]))]
    for what, vals in lines:
        print(f"engine_cluster {what}: {json.dumps(vals)}", flush=True)
    return dict(
        requests=24, new_tokens=64, events=len(events),
        wall_s=wall, wall_tok_s=24 * 64 / wall,
        decode_tok_s=decode_tokens / decode_s, decode_time_s=decode_s,
        devices={n: {k: d[k] for k in ("class", "steps", "tokens_emitted",
                                       "migrations_in", "migrations_out")}
                 for n, d in s["devices"].items()},
        balancer_migrations=s["balancer_migrations"],
        balancer_log=[{k: r[k] for k in ("rid", "src", "dst", "tokens",
                                         "tick")}
                      for r in router.balancer.log],
        migrations=mig.line(), launches=launches, launches_expected=want,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        modeled_makespan_s=s["makespan_s"],
        modeled_tok_s=s["throughput_tok_s"])


def phase_cluster_parity() -> dict:
    """Full-width qwen3-0.6b in fp32 (TF32 off) on ``hbm:1,cxl:1``: 8
    requests of 16 new tokens, 6 pinned to cxl0. Every stream equals its
    stream on one unmigrated engine (a difference fails with the request,
    the position and both runs' top-2 margins), at least one request
    moves, and export -> import -> export returns bit-equal K, V,
    importance and tier rows with the same crc32."""
    import numpy as np
    import torch
    from repro_torch.cluster import KVSnapshot
    from repro_torch.serving import Request, ServingConfig, ServingEngine
    cfg, params = _model("float32")
    router = _cluster(cfg, params, "hbm:1,cxl:1")
    recs = None
    for d in router.devices:
        recs = _margins(d.engine, sampled=False, rec=recs)
    pinned, rest = _cluster_stream(cfg.vocab, 8, 6, 16)
    for r in pinned:
        router.submit_to(r, "cxl0")
    list(router.serve(rest))
    s = router.summary()
    got = {rid: rs.outputs for rid, rs in router.finished.items()}
    moved = [(r["rid"], r["src"], r["dst"]) for r in router.balancer.log]
    del router
    twin = ServingEngine(cfg, params, ServingConfig(
        max_batch=8, max_len=2048, pam=_pam(2048), **PAGED_RING),
        device="cuda")
    rec_twin = _margins(twin, sampled=False)
    prompts = {}
    for r in pinned + rest:
        prompts[r.id] = r.prompt
        twin.submit(Request(r.id, r.prompt, r.max_new_tokens))
    twin.run()
    want = {rid: rs.outputs for rid, rs in twin.requests.items()}
    del twin
    diff = _first_divergence(prompts, got, want, recs, rec_twin)
    # export -> import -> export on two card engines, bit for bit
    engines = [ServingEngine(cfg, params, ServingConfig(
        max_batch=2, max_len=2048, pam=_pam(2048), block_size=16,
        hot_window=hw), name=f"e{hw}", device="cuda") for hw in (256, 0)]
    engines[0].submit(Request(0, pinned[0].prompt, 16))
    for _ in range(4):
        engines[0].step()
    first = KVSnapshot.export(engines[0], 0)
    first.commit(engines[1])
    back = KVSnapshot.export(engines[1], 0)
    rows_equal = {f: bool(np.array_equal(getattr(back, f),
                                         getattr(first, f)))
                  for f in ("k", "v", "importance", "tier", "last_hot")}
    del engines
    torch.cuda.empty_cache()
    out = dict(dtype="float32", tf32=False, devices="hbm:1,cxl:1",
               balancer_migrations=s["balancer_migrations"],
               moved=moved,
               streams_equal=diff is None, first_difference=diff,
               round_trip_rows_equal=rows_equal,
               crc32=[first.checksum, back.checksum],
               snapshot_bytes=int(first.k.nbytes + first.v.nbytes),
               kv_bytes=first.kv_bytes)
    assert s["finished"] == 8, s
    assert s["balancer_migrations"] >= 1, s
    assert diff is None, f"migrated streams differ from the twin: {diff}"
    assert all(rows_equal.values()), rows_equal
    assert first.checksum == back.checksum and back.verify()
    return out


# engine_chaos: the reference's mixed chaos trace
# (benchmarks/chaos_bench.py) plus a dropped transfer
CHAOS = "stall:cxl0@25x6, kill:cxl1@40, corrupt@30*1, drop@45"
CHAOS_N, CHAOS_PINNED, CHAOS_NEW = 16, 4, 32
CHAOS_COUNTS = ("kills_detected", "replays", "drains", "transfer_retries",
                "transfers_dropped", "corruptions_detected",
                "transfer_failures", "preemptions", "resumes", "abandoned")
# what a CPU dry run of the same schedule gives (reduced qwen3-0.6b, the
# same fleet, stream and trace; scripts/chaos_dry_run.py)
CHAOS_DRY_RUN = dict(kills_detected=1, replays=5, drains=0,
                     transfer_retries=2, transfers_dropped=1,
                     corruptions_detected=1, transfer_failures=0,
                     preemptions=0, resumes=1, abandoned=0)


def _serve_fleet(router, pinned, rest, pin: str) -> list:
    """``pinned`` requests on device ``pin`` at arrival 0, the rest routed;
    the stream's events."""
    for r in pinned:
        router.submit_to(r, pin)
    return list(router.serve(rest))


def _records(events) -> dict:
    """The client's view of an event stream: one ``StreamRecord`` a
    request."""
    from repro_torch.frontend.server import StreamRecord
    recs: dict = {}
    for e in events:
        rec = recs.setdefault(e.request_id, StreamRecord(
            rid=e.request_id, arrival=0.0, prompt_len=0, max_new=0))
        if e.rejected:
            rec.rejected = True
        else:
            rec.tokens.append(e.token)
            rec.times.append(e.time)
            rec.indices.append(e.index)
        rec.done = rec.done or e.done
    return recs


def _engine_bytes(eng) -> int:
    """Device bytes of an engine's cache (rings, pools) and PAM rows."""
    import torch
    ts = [t for t in list(eng.cache) + list(eng.pam_state or ())
          if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in ts)


QWEN_VOCAB = 151936                    # qwen3-0.6b's vocabulary


def _fit_vocab(reqs, vocab: int):
    """Prompts drawn for qwen3-0.6b's vocabulary folded into ``vocab`` (a
    dry run on the reduced model keeps the full model's draws, so its
    prompt lengths and arrivals)."""
    for r in reqs:
        r.prompt = r.prompt % vocab
    return reqs


def chaos_fleet_run(cfg, params, device: str = "cuda", chaos=CHAOS) -> dict:
    """engine_chaos's fleet and stream (``chaos`` "" for the fault-free
    run): the router, events, the streamed tokens each replay regenerated,
    and the host wall seconds."""
    from repro_torch.serving.engine import DONE
    router = _cluster(cfg, params, "hbm:1,cxl:2", chaos=chaos or None,
                      device=device)
    replayed: dict = {}
    if chaos:
        declare = router._declare_dead

        def declare_dead(dev):
            for rid, rs in dev.engine.requests.items():
                if rs.status != DONE:
                    replayed[rid] = (router._seen_tokens.get(rid, 0),
                                     len(rs.request.prompt))
            declare(dev)
        router._declare_dead = declare_dead
    pinned, rest = _cluster_stream(QWEN_VOCAB, CHAOS_N, CHAOS_PINNED,
                                   CHAOS_NEW)
    _fit_vocab(pinned + rest, cfg.vocab)
    t0 = time.perf_counter()
    events = _serve_fleet(router, pinned, rest, "cxl1")
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    return dict(router=router, events=events, replayed=replayed,
                wall=time.perf_counter() - t0)


def phase_engine_chaos(cfg, params) -> dict:
    """Full-width qwen3-0.6b (bf16) on engine_cluster's ``hbm:1,cxl:2``
    fleet under the mixed chaos trace (``CHAOS``) with the recovery
    watchdog at its defaults, beside the same stream fault-free in this
    call: 16 requests of 512-1024 prompt tokens and 32 new, 4 pinned to
    cxl1 (so the kill lands on running work). Every stream is complete and
    gapless, ``kills_detected`` is 1, the recovery counts equal a CPU dry
    run of the same schedule, and the merged decode wrappers are called
    n_layers x the fleet's host-run body steps."""
    import torch
    from repro_torch.frontend.loadgen import stream_integrity
    free = chaos_fleet_run(cfg, params, chaos="")
    fs = free["router"].summary()
    free_decode_s = sum(d.engine.decode_time for d in free["router"].devices)
    assert fs["finished"] == CHAOS_N, fs
    del free["router"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with _MigrationClock() as mig:
        run = chaos_fleet_run(cfg, params)
    launches = _launches()
    router = run["router"]
    s, ft = router.summary(), router.summary()["fault_tolerance"]
    recs = _records(run["events"])
    lost, dup = stream_integrity(recs.values())
    counts = {k: ft[k] for k in CHAOS_COUNTS}
    dead = router._by_name("cxl1")
    want = cfg.n_layers * sum(d.engine.decode_body_steps
                              for d in router.devices)
    decode_tokens = CHAOS_N * (CHAOS_NEW - 1)
    decode_s = sum(d.engine.decode_time for d in router.devices)
    delivered = sum(len(r.tokens) for r in recs.values())
    out = dict(
        requests=CHAOS_N, new_tokens=CHAOS_NEW, chaos=CHAOS,
        wall_s=run["wall"], fault_free_wall_s=free["wall"],
        decode_tok_s=decode_tokens / decode_s,
        fault_free_decode_tok_s=decode_tokens / free_decode_s,
        goodput_tok_s=delivered / run["wall"],
        fault_free_goodput_tok_s=CHAOS_N * CHAOS_NEW / free["wall"],
        goodput_vs_fault_free=(delivered / run["wall"])
        / (CHAOS_N * CHAOS_NEW / free["wall"]),
        lost_tokens=lost, dup_tokens=dup, recovery=counts,
        dry_run=CHAOS_DRY_RUN,
        modeled_recovery_latency_s=dict(
            mean=ft["recovery_latency_mean_s"],
            max=ft["recovery_latency_max_s"]),
        replayed_streamed_tokens=sum(v[0] for v in run["replayed"].values()),
        replayed_prompt_tokens=sum(v[1] for v in run["replayed"].values()),
        replayed_requests=sorted(run["replayed"]),
        devices={n: {k: d[k] for k in ("class", "state", "steps",
                                       "tokens_emitted", "migrations_in",
                                       "migrations_out")}
                 for n, d in s["devices"].items()},
        balancer_migrations=s["balancer_migrations"],
        transfers=mig.line(), launches=launches, launches_expected=want,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        dead_engine_gb=_engine_bytes(dead.engine) / 2**30,
        dead_engine_graphs=len(dead.engine._graphs),
        modeled_makespan_s=s["makespan_s"],
        fault_free_modeled_makespan_s=fs["makespan_s"])
    for what in ("recovery", "transfers", "devices"):
        print(f"engine_chaos {what}: {json.dumps(out[what])}", flush=True)
    assert s["finished"] == CHAOS_N and s["rejected"] == 0, s
    assert all(len(recs[i].tokens) == CHAOS_NEW and recs[i].done
               for i in range(CHAOS_N)), "a stream is short"
    assert (lost, dup) == (0, 0), (lost, dup)
    assert out["dead_engine_graphs"] == 0, out["dead_engine_graphs"]
    assert all(recs[rid].tokens == rs.outputs
               for rid, rs in router.finished.items())
    assert ft["kills_detected"] == 1, ft
    assert dead.state == "dead", dead.state
    assert counts == CHAOS_DRY_RUN, f"{counts} != dry run {CHAOS_DRY_RUN}"
    _assert_decode_launches(launches, dict.fromkeys(DECODE_KERNELS[:2],
                                                    want))
    return out


def _fleet_parity(cfg, params, chaos: str, n: int, serving: dict,
                  rec_kw: dict, reqs) -> dict:
    """Two HBM engines (no balancer) under ``chaos``, ``n`` requests
    pinned alternately; the router, its summary and the margins."""
    from repro_torch.cluster import ClusterSpec, FaultInjector, RecoveryConfig
    from repro_torch.serving import ServingConfig
    router = ClusterSpec.from_cli("hbm:2", model=cfg, serving=ServingConfig(
        max_len=2048, pam=_pam(2048), **PAGED_RING, **serving),
        recovery=RecoveryConfig(**rec_kw)).build(
            params, device="cuda", faults=FaultInjector.from_spec(chaos))
    recs = None
    for d in router.devices:
        recs = _margins(d.engine, sampled=True, rec=recs)
    for i, r in enumerate(reqs[:n]):
        router.submit_to(r, f"hbm{i % 2}")
    events = list(router.serve())
    return dict(router=router, summary=router.summary(), margins=recs,
                records=_records(events))


def phase_chaos_parity() -> dict:
    """Full-width qwen3-0.6b in fp32 (TF32 off), sampled at temperature
    1.0, seed 5, as the reference's scripts/chaos_smoke.py: (a) two HBM
    engines, 8 requests of 16 new tokens pinned 4 / 4, the second engine
    killed mid-decode (heartbeat timeout 10 ms): the lost requests replay
    on the survivor; (b) 6 requests pinned 3 / 3, the second engine
    stalled 50x from its first step (its prefill) with the first transfer
    corrupted: its running requests drain to the first, one through a
    retried transfer. Every stream equals the fault-free twin's (one
    engine of batch 8) and is gapless."""
    import torch
    from repro_torch.frontend.loadgen import stream_integrity
    from repro_torch.serving import Request, ServingConfig, ServingEngine
    cfg, params = _model("float32")
    sampled = dict(temperature=1.0, sample_seed=5)
    reqs, _ = _cluster_stream(cfg.vocab, 8, 8, 16)
    twin = ServingEngine(cfg, params, ServingConfig(
        max_batch=8, max_len=2048, pam=_pam(2048), **PAGED_RING, **sampled),
        device="cuda")
    rec_twin = _margins(twin, sampled=True)
    for r in reqs:
        twin.submit(Request(r.id, r.prompt, r.max_new_tokens))
    twin.run()
    want = {rid: rs.outputs for rid, rs in twin.requests.items()}
    del twin
    prompts = {r.id: r.prompt for r in reqs}
    out: dict = dict(dtype="float32", tf32=False, **sampled)
    for case, chaos, n, rec_kw in (
            ("kill", "kill:hbm1@6", 8, dict(heartbeat_timeout_s=0.01)),
            ("stall_corrupt", "stall:hbm1@1x50, corrupt@0*1", 6, {})):
        r = _fleet_parity(cfg, params, chaos, n, sampled, rec_kw, reqs)
        s = r["summary"]
        got = {rid: rs.outputs for rid, rs in r["router"].finished.items()}
        diff = _first_divergence(prompts, got,
                                 {k: want[k] for k in got}, r["margins"],
                                 rec_twin)
        lost_dup = stream_integrity(r["records"].values())
        out[case] = dict(
            chaos=chaos, requests=n, finished=s["finished"],
            states={k: d["state"] for k, d in s["devices"].items()},
            fault_tolerance={k: s["fault_tolerance"][k]
                             for k in CHAOS_COUNTS},
            streams_equal=diff is None, first_difference=diff,
            lost_dup=lost_dup)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    for case in ("kill", "stall_corrupt"):
        o = out[case]
        assert o["finished"] == o["requests"], o
        assert o["streams_equal"], f"{case}: {o['first_difference']}"
        assert o["lost_dup"] == (0, 0), o
    ft = out["kill"]["fault_tolerance"]
    assert ft["kills_detected"] == 1 and ft["replays"] >= 1, ft
    assert out["kill"]["states"]["hbm1"] == "dead", out["kill"]
    ft = out["stall_corrupt"]["fault_tolerance"]
    assert ft["corruptions_detected"] >= 1 and ft["drains"] >= 1, ft
    assert out["stall_corrupt"]["states"]["hbm1"] == "drained"
    return out


# serve_frontend: an onoff trace whose ON windows overload the batch of 8
SERVE_SLO = dict(ttft_s=0.25, tpot_s=0.05)
SERVE_RATE = 128.0                     # mean req/s; 512 req/s in ON windows
SERVE_CONTEXT_SCALE = 16             # hardware tokens an engine token models
SERVE_TRACE = dict(kind="onoff", n_requests=32, prompt_len=(128, 1024),
                   max_new=(16, 64), seed=0)
# the admission decisions a CPU dry run of the same trace gives
# (reduced qwen3-0.6b; scripts/chaos_dry_run.py)
SERVE_DRY_RUN = dict(shed=12, forced_preemptions=1, preemptions=1,
                     resumes=1)


def serve_frontend_run(cfg, params, device: str = "cuda") -> dict:
    """``AsyncServer`` with ``SLOAdmission`` over one engine (paged +
    ring, 256-token prefill chunks, the ``pam`` system's modeled clock)
    serving the onoff trace; host wall stamps of each request's release
    to the shared queue and of every token it streams."""
    import asyncio
    from repro_torch.frontend.admission import SLOAdmission, SLOSpec
    from repro_torch.frontend.loadgen import TraceConfig, make_trace
    from repro_torch.frontend.server import AsyncServer
    from repro_torch.perfmodel import (PAM_LLAMA_7B, make_latency_model,
                                       make_system)
    from repro_torch.serving import EngineSpec, ServingConfig
    eng = EngineSpec(model=cfg, serving=ServingConfig(
        max_batch=8, max_len=2048, pam=_pam(2048), prefill_chunk=256,
        **PAGED_RING)).build(params, device=device, latency_model=(
            make_latency_model(make_system("pam"), PAM_LLAMA_7B,
                               context_scale=SERVE_CONTEXT_SCALE)))
    adm = SLOAdmission(SLOSpec(**SERVE_SLO))
    srv = AsyncServer(eng, admission=adm)
    router = srv.router
    released: dict = {}
    stamps: dict = {}
    release, fanout = router._release_arrivals, srv._fanout

    def release_arrivals():
        before = {r.id for r in router.queue}
        release()
        now = time.perf_counter()
        for r in router.queue:
            if r.id not in before:
                released.setdefault(r.id, now)

    def fan_out():
        n0 = {rid: len(r.tokens) for rid, r in srv.records.items()}
        fanout()
        now = time.perf_counter()
        for rid, r in srv.records.items():
            stamps.setdefault(rid, []).extend(
                [now] * (len(r.tokens) - n0.get(rid, 0)))
    router._release_arrivals = release_arrivals
    srv._fanout = fan_out
    trace = _fit_vocab(make_trace(TraceConfig(
        rate_rps=SERVE_RATE, vocab=QWEN_VOCAB, **SERVE_TRACE)), cfg.vocab)
    t0 = time.perf_counter()
    records = asyncio.run(srv.serve_trace(trace))
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    return dict(server=srv, admission=adm, records=records,
                released=released, stamps=stamps,
                wall=time.perf_counter() - t0)


def _serve_counts(run) -> dict:
    ft = run["server"].router.summary()["fault_tolerance"]
    return dict(shed=run["admission"].shed,
                forced_preemptions=run["admission"].forced_preemptions,
                preemptions=ft["preemptions"], resumes=ft["resumes"])


def phase_serve_frontend(cfg, params) -> dict:
    """Full-width qwen3-0.6b (bf16) behind ``AsyncServer`` with
    ``SLOAdmission(SLOSpec(ttft 250 ms, tpot 50 ms))``: an onoff trace of
    32 requests (prompts 128-1024, 16-64 new, seed 0) whose ON windows
    overload the batch of 8. Streams are gapless, the shed / preempt /
    resume decisions equal a CPU dry run's, and the merged decode wrappers
    are called n_layers x the engine's host-run body steps. Host-wall
    TTFT (release to the shared queue -> first token) and TPOT
    percentiles; SLO attainment on the modeled clock."""
    import numpy as np
    import torch
    from repro_torch.frontend.loadgen import score
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    run = serve_frontend_run(cfg, params)
    launches = _launches()
    srv = run["server"]
    eng = srv.router.devices[0].engine
    sc = score(run["records"].values(), ttft_slo_s=SERVE_SLO["ttft_s"],
               tpot_slo_s=SERVE_SLO["tpot_s"])
    ttft, tpot = [], []
    for rid, st in run["stamps"].items():
        if not st or rid not in run["released"]:
            continue
        ttft.append(st[0] - run["released"][rid])
        if len(st) > 1:
            tpot.append(float(np.mean(np.diff(st))))

    def pct(xs):
        return dict(p50=float(np.percentile(xs, 50)),
                    p99=float(np.percentile(xs, 99)), n=len(xs)) \
            if xs else dict(n=0)
    counts = _serve_counts(run)
    want = cfg.n_layers * eng.decode_body_steps
    out = dict(
        trace=dict(SERVE_TRACE, rate_rps=SERVE_RATE), slo=SERVE_SLO,
        wall_s=run["wall"], host_wall_ttft_s=pct(ttft),
        host_wall_tpot_s=pct(tpot), modeled_score=sc, decisions=counts,
        dry_run=SERVE_DRY_RUN, launches=launches, launches_expected=want,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        chunk_slices=eng.summary().get("chunk_slices"))
    assert sc["lost_tokens"] == 0 and sc["dup_tokens"] == 0, sc
    assert sc["finished"] + sc["rejected"] == SERVE_TRACE["n_requests"], sc
    assert counts == SERVE_DRY_RUN, f"{counts} != dry run {SERVE_DRY_RUN}"
    _assert_decode_launches(launches, dict.fromkeys(DECODE_KERNELS[:2],
                                                    want))
    return out


def phase_engine_ssm(cfg, params) -> dict:
    """mamba2-780m served greedily with PAM on (dense cache: the reference
    refuses paged pools for SSM): 8 requests of 512-1024 prompt tokens,
    each prefilled at its exact length, 64 new tokens each through the
    recurrent state. Serving runs the plain chunked scan (prefill) and the
    one-token recurrence, as the reference does, so no kernel launches."""
    r = run_engine(cfg, params, n_req=8, new=64, max_batch=8, max_len=2048)
    s = r["summary"]
    assert s["finished"] == 8 and s["total_tokens"] == 8 * 64, s
    assert s["prefill_dispatches"] == 8, s   # eight exact lengths
    assert not any(r["launches"].values()), r["launches"]
    di, H = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.n_heads(cfg.d_model)
    state_bytes = (cfg.n_layers * 8 * H * cfg.ssm.d_state
                   * cfg.ssm.head_dim * 4)
    return dict(_engine_line(r, 0), arch=cfg.name,
                prefill_dispatches=s["prefill_dispatches"],
                recurrent_state_bytes=state_bytes, d_inner=di)


def _engine_line(r: dict, want: int) -> dict:
    s = r["summary"]
    keep = ("finished", "total_tokens", "steps", "decode_device_steps",
            "decode_time_s", "decode_tok_s", "wall_time_s",
            "p50_tpot_s", "p99_tpot_s", "tier_reads", "moved_tokens",
            "blocks_touched_per_step", "blocks_window_per_step",
            "pool_occupancy_peak", "hot_bytes_per_slot")
    return dict({k: s[k] for k in keep if k in s},
                decode_body_steps=r["body_steps"], launches=r["launches"],
                launches_expected=want, peak_mem_gb=r["peak_mem_gb"])


def _plain_paged_attn(hot_m, pgd_m, table, scale):
    """Decode attention of the paged + ring layout from plain tensor code
    (the reference's non-kernel formulation): grouped scores over the
    ring and over the pool's logical gather, merged exactly."""
    import torch
    from repro_torch.core import online_softmax as osm
    from repro_torch.core.pam_interface import paged_gather_logical
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import (ring_gather_mask,
                                                  ring_position_map)

    def d_fn(q, kc, vc, pk, pv, kv_lens):
        smax = hot_m.shape[1]
        live = torch.arange(smax, device=q.device)[None] < kv_lens[:, None]
        ring_pos, valid = ring_position_map(kv_lens, kc.shape[2])
        hot_ring = ring_gather_mask(hot_m & live, ring_pos, valid)
        part_h = ops._grouped_partial_from_scores(
            ops._grouped_scores(q, kc, scale), vc, hot_ring)
        part_p = ops._grouped_partial_from_scores(
            ops._grouped_scores(q, paged_gather_logical(pk, table), scale),
            paged_gather_logical(pv, table), pgd_m & live)
        out = osm.finalize(osm.merge_partials(part_h, part_p), q.dtype)
        return out, torch.zeros(q.shape[0], smax, device=q.device)

    return d_fn


def phase_parity() -> dict:
    import numpy as np
    import torch
    from repro_torch.core.tiers import clamp_hot_to_window
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (Request, ServingConfig, ServingEngine,
                                     pam_manager as pm)
    cfg, params = _model("float32")
    W, bs, smax = 256, 16, 1024
    # retrieval sparsity off: every token past the ring is a pool read,
    # so both partials of the merge carry work
    eng = ServingEngine(cfg, params, ServingConfig(
        max_batch=2, max_len=smax, block_size=bs, hot_window=W,
        pam=_pam(smax, use_sparsity=False)), device="cuda")
    rng = np.random.default_rng(1)
    for i, plen in enumerate((700, 333)):
        eng.submit(Request(i, rng.integers(0, cfg.vocab, plen), 16))
    eng.step()                             # admission + one decode step
    cache, st = eng.cache, eng.pam_state
    tokens = eng.tokens_dev.clone()
    scale = 1.0 / cfg.head_dim ** 0.5
    worst = 0.0
    for _ in range(3):                     # teacher-forced steps
        lengths = cache.lengths + 1
        part = pm.participation_mask(eng.pam_cfg, st.importance, lengths)
        tier = clamp_hot_to_window(st.tier, lengths, W)
        hot_m, pgd_m, live = pm.paged_participation_split(
            part, tier, lengths, bs, W)
        assert bool(live.any()), "no pool block read"
        table = torch.where(live, st.block_table,
                            torch.full_like(st.block_table, eng.sentinel))
        pos = cache.lengths
        dst = st.block_table[torch.arange(2, device="cuda"),
                             (pos // bs).long()]
        append = (dst.to(torch.int32), (pos % bs).to(torch.int32))
        outs = []
        for d_fn in (pm.make_paged_decode_attn(hot_m, pgd_m, table, live),
                     _plain_paged_attn(hot_m, pgd_m, table, scale)):
            c = tf.DecodeCache(*(t.clone() for t in cache))
            logits, c2, _ = tf.decode_step(cfg, params, tokens, c,
                                           decode_attn_fn=d_fn,
                                           paged_append=append)
            outs.append((logits, c2))
        (lk, ck), (lp, _) = outs
        assert lk.shape == (2, cfg.vocab) and bool(torch.isfinite(lk).all())
        rel = float((lk - lp).abs().max()) / max(1.0, float(lp.abs().max()))
        worst = max(worst, rel)
        assert rel <= PARITY_TOL, f"logits differ: {rel}"
        tokens = torch.argmax(lk, dim=-1).to(torch.int32)
        cache = ck
    return dict(steps=3, max_rel_logit_diff=worst, tol=PARITY_TOL,
                dtype="float32", tf32=False)


def _counted():
    """Every kernel wrapper that counts its launches, by name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd_scan as ss
    return {"flash_decode_merged": fd.flash_decode_merged,
            "flash_decode_paged_merged": fd.flash_decode_paged_merged,
            "flash_decode": fd.flash_decode,
            "flash_decode_paged": fd.flash_decode_paged,
            "flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "ssd_scan": ss.ssd_scan, "ssd_scan_bwd": ss.ssd_scan_bwd}


def _reset_launches() -> None:
    for fn in _counted().values():
        fn.launches = 0
    for fn in _wgmma_counted().values():
        fn.wgmma_launches = 0
    for fn in _tf32x3_counted().values():
        fn.tf32x3_launches = 0


def _launches() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


def _wgmma_counted():
    """The wrappers that also count their wgmma launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "ssd_scan": ss.ssd_scan, "ssd_scan_bwd": ss.ssd_scan_bwd}


def _wgmma_launches() -> dict:
    return {name: fn.wgmma_launches for name, fn in _wgmma_counted().items()}


def _tf32x3_counted():
    """The wrappers that also count their tf32x3 (fp32 tensor-core)
    launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "ssd_scan": ss.ssd_scan, "ssd_scan_bwd": ss.ssd_scan_bwd}


def _tf32x3_launches() -> dict:
    return {name: fn.tf32x3_launches
            for name, fn in _tf32x3_counted().items()}


# the attention kernels of a train path (``_train_launches`` counts
# every kernel each family launches)
ATTN_TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd")


def _train_model(arch: str = "qwen3-0.6b"):
    from repro_torch.launch import train as train_cli
    from repro_torch.models.config import get_config
    cfg = get_config(arch)
    if arch == SSM_ARCH:
        return cfg, train_cli.train_config(steps=TRAIN_STEPS, lr=SSM_LR)
    return cfg, train_cli.train_config(steps=TRAIN_STEPS)


def phase_train(arch: str = "qwen3-0.6b") -> dict:
    """A training main path: ``repro_torch.launch.train.run`` (the CLI's
    loop) at full width, bf16, batch 4 x 2048, 10 steps."""
    import math
    import statistics
    import torch
    from repro_torch.launch import train as train_cli
    cfg, tcfg = _train_model(arch)
    assert tcfg.use_kernel and not tcfg.remat
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    out = train_cli.run(cfg, tcfg, steps=TRAIN_STEPS, batch=TRAIN_B,
                        seq=TRAIN_S, device="cuda", log=lambda _: None)
    launches = _launches()
    wgmma = _wgmma_launches()
    losses = out["losses"]
    want = _train_launches(cfg, TRAIN_STEPS)
    assert all(math.isfinite(x) for x in losses), losses
    assert sum(losses[-3:]) / 3 < losses[0], losses
    assert launches == want, f"launches {launches}, want {want}"
    # bf16 at full width: every launch a wgmma one
    assert wgmma == {k: want[k] for k in wgmma}, f"wgmma {wgmma}, {want}"
    steady = out["step_s"][1:]
    step_ms = statistics.median(steady) * 1e3
    return dict(arch=arch, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                dtype=cfg.dtype, peak_lr=tcfg.adamw.lr(
                    torch.tensor(10, device="cuda")).item(),
                losses=losses, grad_norms=out["grad_norms"],
                first_step_ms=out["step_s"][0] * 1e3, step_ms=step_ms,
                tokens_per_s=TRAIN_B * TRAIN_S / (step_ms / 1e3),
                tokens_per_s_all_steps=out["tokens_per_s"],
                launches=launches, wgmma_launches=wgmma,
                launches_expected=want,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)


def phase_profile_train(arch: str = "qwen3-0.6b") -> dict:
    """Where a train step's time goes: torch.profiler over 2 steady steps
    of the train phase's configuration (after one warm step). The
    ``attention_*`` keys sum the flash_attention kernels, the ``ssd_*``
    keys the ssd_scan kernels and the ``elementwise_*`` keys PyTorch's
    elementwise kernels; ``*_device_ms`` and ``elementwise_launches`` are
    totals over the two steps. An arch of ``TRAIN_FAMILIES`` runs its
    train_* phase's configuration and batches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as train_cli
    from repro_torch.training.train_step import (build_train_step,
                                                 init_train_state)
    if arch in TRAIN_FAMILIES:
        n_layers, B, S = TRAIN_FAMILIES[arch]
        cfg = _family_cfg(arch, n_layers)
        tcfg = train_cli.train_config(steps=FAMILY_STEPS, lr=FAMILY_LR)
    else:
        (cfg, tcfg), B, S = _train_model(arch), TRAIN_B, TRAIN_S
    state = init_train_state(cfg, tcfg, 0, device="cuda")
    step_fn = build_train_step(cfg, tcfg, donate=True)    # as the CLI
    data = _FamilyData(cfg, B, S)
    state, m = step_fn(state, data.batch(0))
    float(m["loss"])
    batches = [data.batch(s) for s in (1, 2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, m = step_fn(state, b)
            float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del state
    rows = []
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    if not rows:
        return dict(steps=2, wall_s=wall, device_time="not measured")
    busy_s = sum(r[0] for r in rows) / 1e6

    def fmt(sel):
        return [dict(name=k[:80], device_ms=us / 1e3, count=n,
                     share=us / 1e6 / busy_s) for us, k, n in sel]
    attn = [r for r in rows if "pam::flash_attention" in r[1]]
    ssd = [r for r in rows if "pam::ssd" in r[1]]
    # PyTorch's elementwise kernels (fills, adds, casts, AdamW's
    # arithmetic): where gradient accumulation into the stacked leaves
    # would show
    elem = [r for r in rows if "elementwise_kernel" in r[1]]
    mm = [r for r in rows if any(t in r[1] for t in KERNEL_CLASSES["matmul"])]
    return dict(arch=arch, steps=2, wall_s=wall, step_ms=wall / 2 * 1e3,
                device_busy_s=busy_s, device_idle_share=1 - busy_s / wall,
                kernel_launches=sum(r[2] for r in rows),
                attention_device_ms=sum(r[0] for r in attn) / 1e3,
                attention_share=sum(r[0] for r in attn) / 1e6 / busy_s,
                ssd_device_ms=sum(r[0] for r in ssd) / 1e3,
                ssd_share=sum(r[0] for r in ssd) / 1e6 / busy_s,
                elementwise_device_ms=sum(r[0] for r in elem) / 1e3,
                elementwise_share=sum(r[0] for r in elem) / 1e6 / busy_s,
                elementwise_launches=sum(r[2] for r in elem),
                matmul_device_ms=sum(r[0] for r in mm) / 1e3,
                matmul_share=sum(r[0] for r in mm) / 1e6 / busy_s,
                top=fmt(rows[:12]),
                ported=fmt([r for r in rows if "pam::" in r[1]]))


def phase_train_parity(arch: str = "qwen3-0.6b",
                       n_layers: int | None = None) -> dict:
    """Full-width fp32 loss and gradients through the train path's kernels
    (flash_attention, or ssd_scan) against the plain chunked attention or
    chunked scan (TF32 off), at ``n_layers`` (None: full depth), B 2 x
    500 positions (``_FamilyData``, seed 1). An MoE model's two paths
    must route every (token, slot) to the same expert first."""
    from repro_torch import tree
    from repro_torch.training.train_step import TrainConfig, build_grad_fn
    cfg, params = _model("float32", arch, n_layers)
    b = _FamilyData(cfg, PARITY_B, PARITY_S - cfg.num_patches,
                    seed=1).batch(0)

    def grads(use_kernel):
        drops = _Drops() if cfg.moe is not None else None
        try:
            out = build_grad_fn(cfg, TrainConfig(use_kernel=use_kernel))(
                params, b)
        finally:
            if drops is not None:
                drops.close()
        return out, [] if drops is None else drops.ids
    _reset_launches()
    (lk, gk), ids_k = grads(True)
    launches = _launches()
    wgmma = _wgmma_launches()          # fp32: the tf32x3 attention kernels
    assert not any(wgmma.values()), f"fp32 ran wgmma kernels: {wgmma}"
    tf32x3 = _tf32x3_launches()
    assert tf32x3 == {n: launches[n] for n in tf32x3}, (tf32x3, launches)
    (lp, gp), ids_p = grads(False)
    moe = {} if cfg.moe is None else dict(expert_ids_routed_apart=sum(
        int((a != c).sum()) for a, c in zip(ids_k, ids_p)),
        expert_ids=sum(a.numel() for a in ids_k))
    # a flipped expert makes the gradients' comparison meaningless
    assert len(ids_k) == len(ids_p) and not moe.get(
        "expert_ids_routed_apart"), f"routing differs: {moe}"
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    worst, worst_leaf = 0.0, ""
    for (name, a), r in zip(tree.leaves_with_paths(gk), tree.leaves(gp)):
        if r.numel() == 0:           # a family's unused (empty) leaf
            continue
        scale = float(r.abs().max())
        rel = float((a - r).abs().max()) / scale if scale > 0 else 0.0
        if rel > worst:
            worst, worst_leaf = rel, name
    want = _train_launches(cfg, 1)
    assert launches == want, f"launches {launches}, want {want}"
    assert loss_rel <= TRAIN_LOSS_TOL, f"loss differs: {loss_rel}"
    assert worst <= TRAIN_GRAD_TOL, f"grads differ: {worst} at {worst_leaf}"
    return dict(arch=arch, n_layers=cfg.n_layers, B=PARITY_B, S=PARITY_S,
                dtype="float32", tf32=False,
                loss_kernel=float(lk), loss_plain=float(lp),
                loss_rel_diff=loss_rel, loss_tol=TRAIN_LOSS_TOL,
                max_grad_rel_diff=worst, worst_leaf=worst_leaf,
                grad_tol=TRAIN_GRAD_TOL, launches=launches,
                wgmma_launches=wgmma, tf32x3_launches=tf32x3, **moe)


# ------------------------------------------------- training on a site grid
# qwen3-0.6b at full width and depth on the train CLI's (data, model) site
# grids, every site on this card: (grid, run keywords)
SHARD_TRAIN_GRIDS = {
    "1x1": ((1, 1), {}),
    "1x2": ((1, 2), {}),
    "2x2": ((2, 2), {}),
    "2x2_fsdp": ((2, 2), {"fsdp": True}),
    "1x4_activation_spec": ((1, 4), {"activation_spec": (
        "data", "model", None)}),
}
SHARD_TRAIN_STEPS = 6              # the step ms: the median of steps 2-6
SHARD_LOSS_BAND = 2e-2             # bf16: |loss - loss (1, 1)| / loss (1, 1)
TRAIN_SHARD_PARITY = dict(B=4, S=512, n_layers=2, steps=3, lr=1e-3, eps=1e-3)
TRAIN_SHARD_TOL = 1e-5             # fp32 against one site (module docstring)
TRAIN_SHARD_GRIDS = ((2, 2), (1, 4), (2, 4))
# the site slices of flash_attention on train_sharded's path: qwen3-0.6b's
# 16 / 8 heads of 128 over 2 and 4 model sites (key, heads, grid)
SITE_ATTN_ROWS = {"flash_attention_site_8x4": ((8, 4), "1x2"),
                  "flash_attention_site_4x2": ((4, 2), "1x4_activation_spec")}
PIPELINE = dict(stages=4, microbatches=4, mb=1, S=2048)


class _SiteRanges:
    """Marks every cross-site reduction (``site_all_reduce`` /
    ``site_all_gather``, by whichever module calls it) as a
    ``torch.profiler`` range named ``NAME``, whose kernels the profiler
    then attributes to it."""

    NAME = "pam::site_reduction"

    def __init__(self):
        from repro_torch.distributed import pam_shard as ps
        from repro_torch.distributed import tensor_parallel as tp
        from repro_torch.models import attention as at
        from repro_torch.training import train_step as ts
        self._saved = []
        for mod in (ps, tp, at, ts):
            for name in ("site_all_reduce", "site_all_gather"):
                if hasattr(mod, name):
                    fn = getattr(mod, name)
                    self._saved.append((mod, name, fn))
                    setattr(mod, name, self._ranged(fn))

    def _ranged(self, fn):
        from torch.profiler import record_function

        def wrapper(*args, **kw):
            with record_function(self.NAME):
                return fn(*args, **kw)
        return wrapper

    def close(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


class _AttnShapes:
    """Records the (H, Hkv, d) of every flash_attention launch, forward
    and backward, on the card."""

    def __init__(self):
        from repro_torch.kernels import flash_attention as fa
        self._fa = fa
        self._fwd, self._bwd = fa._fwd_cuda, fa._bwd_cuda
        self.shapes = {"fwd": set(), "bwd": set()}

        def fwd(q, k, *a, **kw):
            self.shapes["fwd"].add((q.shape[1], k.shape[1], q.shape[-1]))
            return self._fwd(q, k, *a, **kw)

        def bwd(q, k, *a, **kw):
            self.shapes["bwd"].add((q.shape[1], k.shape[1], q.shape[-1]))
            return self._bwd(q, k, *a, **kw)
        fa._fwd_cuda, fa._bwd_cuda = fwd, bwd

    def close(self):
        self._fa._fwd_cuda, self._fa._bwd_cuda = self._fwd, self._bwd

    def line(self) -> dict:
        return {k: [dict(H=h, Hkv=kv, d=d, group=h // kv)
                    for h, kv, d in sorted(v)]
                for k, v in self.shapes.items()}


def _site_param_bytes(cfg, grid, fsdp: bool) -> dict:
    """Bytes of the parameters one site holds (its block of every leaf,
    ``param_specs``' split) and of the whole model."""
    import math
    from repro_torch.distributed import sharding as shd
    el = 2 if cfg.dtype == "bfloat16" else 4
    shapes = shd.param_shapes(cfg)
    site = whole = 0
    for path, spec in shd.param_specs(cfg, grid, fsdp=fsdp).items():
        whole += math.prod(shapes[path]) * el
        site += math.prod(shd.GridSharding(grid, spec).shard_shape(
            shapes[path])) * el
    return dict(site_param_bytes=site, param_bytes=whole,
                site_share=site / whole)


def _sites_per_layer(cfg, grid) -> int:
    """flash_attention launches a layer and step, each direction: one a
    data replica, times the model sites when the heads split whole."""
    from repro_torch.distributed import sharding as shd
    g = grid.shape["model"]
    dp = shd.batch_dp_spec(TRAIN_B, grid)
    reps = 1 if dp is None else grid.shape["data"]
    whole = cfg.n_heads % g == 0 and cfg.n_kv_heads % g == 0
    return reps * (g if whole else 1)


def _profile_grid_step(cfg, tcfg, grid, fsdp: bool) -> dict:
    """One steady train step on ``grid`` (after two warm ones) under
    ``torch.profiler``, the cross-site reductions marked
    (``_SiteRanges``): the kernels' device ms and launches, the wall ms
    (under the profiler) and the share of it the card was idle, and the
    reductions' calls and the device ms of the kernels they issued."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.train_step import (build_train_step,
                                                 init_train_state)
    state = init_train_state(cfg, tcfg, 0, device="cuda")
    step = build_train_step(cfg, tcfg, donate=True, grid=grid, fsdp=fsdp)
    data = _FamilyData(cfg, TRAIN_B, TRAIN_S)
    for s in range(2):
        state, m = step(state, data.batch(s))
        float(m["loss"])
    b = data.batch(2)
    ranges = _SiteRanges()
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step(state, b)
            float(m["loss"])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        ranges.close()
    del state
    kernels = [ev for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA")]
    busy = sum(ev.self_device_time_total for ev in kernels) / 1e3
    # the CPU-side ranges (the profiler adds a GPU-side span of each,
    # which would count the gaps between its kernels too)
    red = [ev for ev in prof.events() if ev.name == _SiteRanges.NAME
           and str(ev.device_type).endswith("CPU")]
    return dict(profiled_wall_ms=wall, device_busy_ms=busy,
                device_idle_share=1 - busy / wall,
                kernel_launches=sum(ev.count for ev in kernels),
                site_reductions=len(red),
                site_reduction_device_ms=sum(
                    ev.device_time_total for ev in red) / 1e3)


def phase_train_sharded() -> dict:
    """The dense family trained on site grids: full-width, full-depth
    qwen3-0.6b, bf16, B 4 x 2048 through ``launch.train.run`` (the CLI's
    loop and schedule, ``use_kernel``), ``SHARD_TRAIN_STEPS`` steps on
    each grid of ``SHARD_TRAIN_GRIDS`` (ZeRO-1 moments; one with FSDP
    weights, one with ``activation_spec``). For each: the step ms (the
    median of steps 2-6), the flash_attention launches a step and the
    heads they ran at, a site's parameter bytes, the peak GiB and the
    losses against (1, 1)'s in ``SHARD_LOSS_BAND``; then one more steady
    step profiled (``_profile_grid_step``): device busy ms and idle
    share, kernel launches, and the cross-site reductions' calls and
    device ms."""
    import math
    import statistics
    import torch
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_grid
    cfg, tcfg = _train_model()
    out, base = {}, None
    for key, (sizes, kw) in SHARD_TRAIN_GRIDS.items():
        grid = make_grid(sizes, device="cuda")
        fsdp = kw.get("fsdp", False)
        t = dataclasses.replace(tcfg, activation_spec=kw.get(
            "activation_spec"))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        shapes = _AttnShapes()
        _reset_launches()
        try:
            r = train_cli.run(cfg, t, steps=SHARD_TRAIN_STEPS, batch=TRAIN_B,
                              seq=TRAIN_S, device="cuda", grid=grid,
                              fsdp=fsdp, log=lambda _: None)
        finally:
            shapes.close()
        launches, wgmma = _launches(), _wgmma_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_layer = _sites_per_layer(cfg, grid)
        want = cfg.n_layers * per_layer * SHARD_TRAIN_STEPS
        for name in ATTN_TRAIN_KERNELS:
            assert launches[name] == want, (key, name, launches[name], want)
            assert wgmma[name] == want, (key, name, wgmma[name], want)
        losses = r["losses"]
        assert all(math.isfinite(x) for x in losses), (key, losses)
        if base is None:
            base = losses
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base))
        assert rel <= SHARD_LOSS_BAND, (key, rel, losses, base)
        step_ms = statistics.median(r["step_s"][1:]) * 1e3
        gc.collect()
        torch.cuda.empty_cache()
        out[key] = dict(
            grid=dict(grid.shape), fsdp=fsdp,
            activation_spec=kw.get("activation_spec"), step_ms=step_ms,
            first_step_ms=r["step_s"][0] * 1e3,
            tokens_per_s=TRAIN_B * TRAIN_S / (step_ms / 1e3),
            attention_launches_per_step={
                n: launches[n] // SHARD_TRAIN_STEPS
                for n in ATTN_TRAIN_KERNELS},
            attention_launches=launches, wgmma_launches=wgmma,
            attention_heads=shapes.line(),
            **_site_param_bytes(cfg, grid, fsdp), peak_mem_gb=peak,
            losses=losses, grad_norms=r["grad_norms"],
            max_rel_loss_vs_1x1=rel, loss_band=SHARD_LOSS_BAND,
            profiled_step=_profile_grid_step(cfg, t, grid, fsdp))
    return dict(arch=cfg.name, n_layers=cfg.n_layers, B=TRAIN_B, S=TRAIN_S,
                dtype=cfg.dtype, steps=SHARD_TRAIN_STEPS, grids=out)


def _rel_tree(got, ref) -> dict:
    """Per gradient leaf, the relative L2 error ||got - ref|| / ||ref||
    and the max-norm one max |got - ref| / max |ref|: the largest of each
    and its leaf."""
    from repro_torch import tree
    out = dict(l2=0.0, l2_leaf="", max=0.0, max_leaf="")
    for (name, a), r in zip(tree.leaves_with_paths(got), tree.leaves(ref)):
        if r.numel() == 0 or not float(r.abs().max()):
            continue
        for kind, rel in (
                ("l2", float((a - r).double().norm() / r.double().norm())),
                ("max", float((a - r).abs().max() / r.abs().max()))):
            if rel > out[kind]:
                out[kind], out[f"{kind}_leaf"] = rel, name
    return out


def phase_train_shard_parity() -> dict:
    """fp32, TF32 off: qwen3-0.6b at full width, 2 layers, B 4 x 512, the
    grids ``TRAIN_SHARD_GRIDS`` against one site: the loss (relative),
    every gradient leaf (relative L2 error; the max-norm error is
    reported beside it: a norm weight's gradient sums 2,048 positions
    with cancellation, so one entry can part by more) and the parameters
    after 3 AdamW steps (max |diff|; lr 1e-3, eps 1e-3: the update moves
    at most lr / eps times a gradient's difference) within
    ``TRAIN_SHARD_TOL``, through the tf32x3
    attention kernels at each site's heads; then the perf flags on a
    (1, 4) grid (sp_pin and remat_dots with the kernels; sp_attn, sp_pin
    and remat_dots on the plain attention) against one site with them
    off, within the same bounds."""
    import torch
    from repro_torch.launch.mesh import make_grid
    from repro_torch.models import perf_flags
    from repro_torch.training import optim
    from repro_torch.training.train_step import (TrainConfig, TrainState,
                                                 build_grad_fn,
                                                 build_train_step)
    p = TRAIN_SHARD_PARITY
    cfg, params = _model("float32", n_layers=p["n_layers"])
    b = _FamilyData(cfg, p["B"], p["S"], seed=2).batch(0)

    def run(grid, use_kernel=True, remat=False):
        tcfg = TrainConfig(adamw=optim.AdamWConfig(lr=p["lr"], eps=p["eps"]),
                           use_kernel=use_kernel, remat=remat)
        loss, grads = build_grad_fn(cfg, tcfg, grid=grid)(params, b)
        state = TrainState(params, optim.adamw_init(params), None)
        step = build_train_step(cfg, tcfg, grid=grid)
        for _ in range(p["steps"]):
            state, _ = step(state, b)
        return float(loss), grads, state.params

    def compare(got, ref) -> dict:
        from repro_torch import tree
        loss_rel = abs(got[0] - ref[0]) / abs(ref[0])
        grad = _rel_tree(got[1], ref[1])
        param_abs = max(float((a - r).abs().max()) for a, r in zip(
            tree.leaves(got[2]), tree.leaves(ref[2])) if r.numel())
        ok = max(loss_rel, grad["l2"], param_abs) <= TRAIN_SHARD_TOL
        assert ok, (loss_rel, grad, param_abs)
        return dict(loss=got[0], loss_rel_diff=loss_rel,
                    grad_rel_l2=grad["l2"], grad_rel_l2_leaf=grad["l2_leaf"],
                    grad_rel_max=grad["max"],
                    grad_rel_max_leaf=grad["max_leaf"],
                    max_param_abs_diff_3_steps=param_abs)

    out = {}
    _reset_launches()
    one = run(None)
    launches_one = _launches()["flash_attention"]
    assert _tf32x3_launches()["flash_attention"] == launches_one
    for sizes in TRAIN_SHARD_GRIDS:
        grid = make_grid(sizes, device="cuda")
        _reset_launches()
        got = run(grid)
        out["x".join(map(str, sizes))] = dict(
            compare(got, one), flash_attention_launches=_launches()[
                "flash_attention"])
    grid = make_grid((1, 4), device="cuda")
    for key, flags, use_kernel in (
            ("flags_kernel_1x4", ("sp_pin", "remat_dots"), True),
            ("flags_plain_1x4", ("sp_attn", "sp_pin", "remat_dots"), False)):
        ref = one if use_kernel else run(None, use_kernel=False)
        perf_flags.set_flags(*flags)
        try:
            got = run(grid, use_kernel=use_kernel, remat=True)
        finally:
            perf_flags.set_flags()
        out[key] = dict(compare(got, ref), flags=list(flags))
    return dict(arch=cfg.name, n_layers=cfg.n_layers, B=p["B"], S=p["S"],
                dtype="float32", tf32=False, steps=p["steps"], lr=p["lr"],
                eps=p["eps"], tol=TRAIN_SHARD_TOL,
                flash_attention_launches_one_site=launches_one, **out)


def phase_pipeline() -> dict:
    """GPipe on the card: full-width qwen3-0.6b's 28 blocks as 4 stages of
    7 (``distributed.pipeline``), M 4 microbatches of 1 x 2048 through
    the (M + S - 1)-tick schedule, forward with the flash_attention
    kernel, bf16; against the unpipelined forward of each microbatch
    (the same blocks in the same order: equal) and of the whole batch
    (other matmul shapes: reported); ms of each."""
    import torch
    from repro_torch.distributed.pipeline import (pipeline_apply,
                                                  stages_from_layers)
    from repro_torch.launch.mesh import make_grid
    from repro_torch.models import transformer as tf
    n_st, M = PIPELINE["stages"], PIPELINE["microbatches"]
    cfg, params = _model("bfloat16")
    g = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (M, PIPELINE["mb"], PIPELINE["S"]),
                         generator=g, device="cuda")
    xs = params["embed"][toks]                        # (M, mb, S, d)

    def blocks(layers, h):
        for lp in tf._layers({"layers": layers}):
            h = tf._dense_block(cfg, lp, h, True)
        return h
    stacked = stages_from_layers(params["layers"], n_st)
    run = pipeline_apply(make_grid((n_st,), ("stage",), device="cuda"),
                         blocks, n_st)
    with torch.no_grad():
        _reset_launches()
        got = run(stacked, xs)
        torch.cuda.synchronize()
        launches = _launches()["flash_attention"]
        want = torch.stack([blocks(params["layers"], x) for x in xs])
        whole = blocks(params["layers"], xs.reshape(
            (M * PIPELINE["mb"],) + tuple(xs.shape[2:]))).reshape(got.shape)
        err = float((got.float() - want.float()).abs().max())
        err_whole = float((got.float() - whole.float()).abs().max())
        pipe_ms = _time_ms(lambda: run(stacked, xs), iters=3, flush_bytes=0)
        seq_ms = _time_ms(lambda: [blocks(params["layers"], x) for x in xs],
                          iters=3, flush_bytes=0)
    assert launches == cfg.n_layers * M, launches
    assert err == 0.0, err
    assert torch.isfinite(got).all()
    return dict(arch=cfg.name, stages=n_st, layers_per_stage=cfg.n_layers
                // n_st, microbatches=M, mb=PIPELINE["mb"], S=PIPELINE["S"],
                ticks=M + n_st - 1, dtype=cfg.dtype,
                flash_attention_launches=launches,
                max_abs_err_vs_unpipelined=err,
                max_abs_err_vs_whole_batch=err_whole,
                scale=float(want.float().abs().max()),
                pipelined_ms=pipe_ms, unpipelined_ms=seq_ms)


MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_LAYERS = 4      # of 94: about 22 GB of bf16 weights on the 80 GB card


class _Drops:
    """Counts the MoE's (token, expert) assignments and those dropped at
    capacity, in device tensors written in place, so that a replayed
    decode graph adds to them too (``moe.route`` wrapped while the
    object is open). Serving (``batch``, the engine's slots): at prefill
    and at decode (a decode call routes all ``batch`` slots, idle ones
    included). Training (``batch`` None): one bucket, ``train``, and
    each MoE call's aux loss and expert ids (``moe.moe_forward``
    wrapped too), in ``aux`` and ``ids``."""

    def __init__(self, batch: int | None = None):
        import torch
        from repro_torch.models import moe as moe_mod
        self.mod, self.route, self.fwd = (moe_mod, moe_mod.route,
                                          moe_mod.moe_forward)
        keys = ("train",) if batch is None else ("prefill", "decode")
        self.acc = {k: torch.zeros(2, dtype=torch.int64, device="cuda")
                    for k in keys}
        self.aux, self.ids = [], []

        def counted(p, xf, cfg):
            r = self.route(p, xf, cfg)
            if batch is None:
                acc = self.acc["train"]
                self.ids.append(r.expert_ids)
            else:
                acc = self.acc["decode" if xf.shape[0] == batch
                               else "prefill"]
            acc[0].add_(r.keep.numel())
            acc[1].add_(torch.sum(~r.keep))
            return r
        moe_mod.route = counted
        if batch is None:
            def forward(p, x, cfg):
                y, aux = self.fwd(p, x, cfg)
                self.aux.append(aux.detach())
                return y, aux
            moe_mod.moe_forward = forward

    def close(self) -> dict:
        self.mod.route, self.mod.moe_forward = self.route, self.fwd
        out = {}
        for k, a in self.acc.items():
            n, dropped = (int(x) for x in a.cpu())
            out[k] = dict(assignments=n, dropped=dropped,
                          dropped_share=dropped / n if n else None)
        return out


def _moe_weights(cfg) -> dict:
    """Weight bytes (bf16) behind one decode step of the cut model: all
    of them, those a token's top-k experts use (``active_param_count``),
    and the expert matrices the dense-shape dispatch reads (the batched
    products take every expert's three matrices, whatever its capacity
    holds), each with its time at the HBM rate."""
    m = cfg.moe
    experts = cfg.n_layers * 3 * m.num_experts * cfg.d_model * m.d_expert
    out = dict(all=cfg.param_count() * 2, active=cfg.active_param_count() * 2,
               dispatch_experts=experts * 2)
    return {k: dict(bytes=v, hbm_ms=v / HBM_BYTES_PER_S * 1e3)
            for k, v in out.items()}


def phase_engine_moe(cfg, params, layout=PAGED_RING,
                     latent: bool = False) -> dict:
    """A mixture-of-experts model at full width through
    ``phase_engine_served`` on ``layout``: qwen3-moe-235b-a22b (d 4096,
    64 q / 4 kv heads of 128, 128 experts of 1536, top-8, vocab 151936),
    depth cut to ``MOE_LAYERS``, paged + ring; or deepseek-v2-lite-16b
    at full depth on dense PAM with the latent checks (``latent``). Adds
    the share of (token, expert) assignments dropped at capacity (some
    decode assignments must be routed) and the MoE's weight bytes a
    step."""
    drops = _Drops(8)
    try:
        out = phase_engine_served(cfg, params, _moe_weights(cfg), layout,
                                  latent)
    finally:
        dropped = drops.close()
    assert dropped["decode"]["assignments"] > 0, dropped
    return dict(out, experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                shared_experts=cfg.moe.num_shared, dropped=dropped)


def _moe_twins(cfg, params) -> dict:
    """decode_graph's MoE pair: graph and eager twins of the full-width
    qwen3-moe engine (``MOE_LAYERS`` layers, paged + ring, 8 requests of
    512-1024 prompt tokens, 16 new). Streams and every StepBufs field
    must be equal, and the merged decode wrappers are called n_layers x
    the graph twin's host-run body steps."""
    _reset_launches()
    g = _recording(_engine(cfg, params, 8, 16, max_batch=8, max_len=2048,
                           **PAGED_RING))
    g.run()
    launches = _launches()
    e = _recording(_engine(cfg, params, 8, 16, max_batch=8, max_len=2048,
                           **PAGED_RING), eager=True)
    e.run()
    want = cfg.n_layers * g.decode_body_steps
    _assert_decode_launches(launches, dict.fromkeys(DECODE_KERNELS[:2],
                                                    want))
    out = dict(_twin_line(g, e), diff=_twin_diff(g, e), arch=cfg.name,
               n_layers=cfg.n_layers, launches=launches,
               launches_expected=want)
    del g, e
    gc.collect()
    return out


def _moe_parity_cfg(group16: bool):
    """The reduced qwen3-moe (E 4, top-2, d 64, 4 q / 2 kv heads of 16,
    fp32), or the same with 32 q heads over 2 kv heads (group 16, the
    decode kernels' wide path at head dim 16)."""
    from repro_torch.models.config import get_config, reduced
    cfg = reduced(get_config(MOE_ARCH))
    if group16:
        cfg = dataclasses.replace(cfg, name=cfg.name + "-g16", n_heads=32)
    return cfg


PARITY_RING = dict(block_size=8, hot_window=32)


def _card_cpu_streams(cfg, layout=PARITY_RING, fill: bool = False,
                      micro_steps: int = 1) -> dict:
    """Greedy streams of ``cfg``'s engine on the card and on the CPU (seed-0
    weights made on the CPU and copied; fp32, TF32 off): ``layout``
    (default paged + ring, block 8, ring 32; ``{}`` dense PAM), 6
    requests of 20-60 prompt tokens through 4 slots, 24 new (with
    ``fill`` the last prompt is 104 tokens: prompt + new = max_len 128),
    ``micro_steps`` a dispatch. Returns the heads, whether the streams
    are equal, the first divergence (the position and both runs' top-2
    margins there), the tokens, the card's decode wrapper calls and its
    latent attention calls (an MLA model) beside its attention sites
    (``_attention_sites``) x its host-run body steps."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (PAMManagerConfig, Request,
                                     ServingConfig, ServingEngine)
    host = tf.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, int(n))
               for n in rng.integers(20, 61, 6)]
    if fill:
        prompts[-1] = rng.integers(0, cfg.vocab, 128 - 24)
    streams, recs, launches = {}, {}, None
    for dev in ("cuda", "cpu"):
        params = (host if dev == "cpu" else
                  tree.tree_map(lambda t: t.to(dev), host))
        eng = ServingEngine(cfg, params, ServingConfig(
            pam=PAMManagerConfig(max_tokens=128, hot_capacity=16,
                                 warm_capacity=16, compression=2,
                                 recency_window=4, schedule_interval=2),
            max_batch=4, max_len=128, micro_steps=micro_steps, **layout),
            device=dev)
        recs[dev] = _margins(eng, sampled=False)
        if dev == "cuda":
            _reset_launches()
            latent = _LatentCalls()
        try:
            for i, p in enumerate(prompts):
                eng.submit(Request(i, p, 24))
            eng.run()
        finally:
            if dev == "cuda":
                latent_calls = latent.close()
        if dev == "cuda":
            launches = _launches()
            body = eng.decode_body_steps
            dispatches = eng.decode_dispatches
        streams[dev] = {i: eng.requests[i].outputs for i in range(6)}
        del eng, params
    torch.cuda.empty_cache()
    div = _first_divergence(prompts, streams["cuda"], streams["cpu"],
                            recs["cuda"], recs["cpu"])
    return dict(heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.head_dim,
                streams_equal=div is None, divergence=div,
                tokens=sum(len(v) for v in streams["cuda"].values()),
                prompt_lens=[len(p) for p in prompts],
                micro_steps=micro_steps, decode_dispatches=dispatches,
                decode_body_steps=body, latent_calls=latent_calls,
                launches=launches,
                launches_expected=_attention_sites(cfg) * body)


def _assert_parity_line(key: str, line: dict) -> None:
    _assert_decode_launches(line["launches"], dict.fromkeys(
        DECODE_KERNELS[:2], line["launches_expected"]))
    assert line["divergence"] is None, (f"{key}: card and CPU streams "
                                        f"differ: {line['divergence']}")


def phase_moe_parity() -> dict:
    """The port's MoE engine on the card and on the CPU give equal greedy
    streams (``_card_cpu_streams``: reduced qwen3-moe in fp32, TF32 off,
    paged + ring, 6 requests through 4 slots, so idle slots at the end
    ride in the routing); once at the reduced GQA group 2 and once at
    group 16. A stream that differs fails the phase with the position
    and both runs' top-2 margins there."""
    out = dict(dtype="float32", tf32=False)
    for group16 in (False, True):
        key = "group16" if group16 else "group2"
        out[key] = _card_cpu_streams(_moe_parity_cfg(group16))
        _assert_parity_line(key, out[key])
    return out


MLA_ARCH = "deepseek-v2-lite-16b"
HYBRID_ARCH = "zamba2-7b"
D112 = "_d112"                  # tag of zamba2-7b's kernels-phase rows


class _LatentCalls:
    """Counts the host calls of the MLA latent attention that the
    engine's decode body builds (``pam_manager.make_masked_latent_attn``,
    wrapped while the object is open): n_layers a micro-step whose body
    runs on the host, eagerly or recorded into a graph; a replay makes
    none."""

    def __init__(self):
        from repro_torch.serving import pam_manager as pm
        self.pm, self.make, self.n = pm, pm.make_masked_latent_attn, 0

        def make(participate):
            fn = self.make(participate)

            def counted(*a, **kw):
                self.n += 1
                return fn(*a, **kw)
            return counted
        pm.make_masked_latent_attn = make

    def close(self) -> int:
        self.pm.make_masked_latent_attn = self.make
        return self.n


def phase_mla_parity() -> dict:
    """The port's MLA engine on the card and on the CPU give equal greedy
    streams (``_card_cpu_streams``: reduced deepseek-v2-lite-16b in fp32,
    TF32 off, dense PAM, 6 requests through 4 slots, one of them to
    max_len exactly), at micro_steps 1 and 4, decode through the graphs.
    No decode wrapper may be called, and the latent attention n_layers x
    the host-run body steps. A stream that differs fails the phase with
    the position and both runs' top-2 margins there."""
    from repro_torch.models.config import get_config, reduced
    cfg = reduced(get_config(MLA_ARCH))
    out = dict(dtype="float32", tf32=False, layout="dense_pam")
    for k in (1, 4):
        key = f"micro_steps_{k}"
        line = out[key] = _card_cpu_streams(cfg, {}, fill=True,
                                            micro_steps=k)
        _assert_decode_launches(line["launches"], {})
        assert line["latent_calls"] == line["launches_expected"] > 0, (
            f"{key}: latent attention called {line['latent_calls']} "
            f"times, want {line['launches_expected']}")
        assert line["divergence"] is None, (f"{key}: card and CPU streams "
                                            f"differ: {line['divergence']}")
    assert (out["micro_steps_4"]["decode_dispatches"]
            < out["micro_steps_1"]["decode_dispatches"]), out
    return out


def _attention_sites(cfg) -> int:
    """Attention calls a decode step makes: a hybrid model's n_groups
    shared-attention sites, else one a layer."""
    return cfg.hybrid.n_groups if cfg.hybrid is not None else cfg.n_layers


def _hybrid_parity_cfgs() -> dict:
    """Reduced zamba2-7b (4 q / 2 kv heads of 16) and the same with 4 q /
    4 kv heads of 112 (the (112, 1) decode kernels inside the engine)."""
    from repro_torch.models.config import get_config, reduced
    cfg = reduced(get_config(HYBRID_ARCH))
    return {"reduced": cfg,
            "d112": dataclasses.replace(cfg, name=cfg.name + "-d112",
                                        n_heads=4, n_kv_heads=4,
                                        d_head=112)}


def phase_hybrid_parity() -> dict:
    """The port's hybrid engine on the card and on the CPU give equal
    greedy streams (``_card_cpu_streams``: fp32, TF32 off, dense PAM, 6
    requests through 4 slots, one of them to max_len exactly) at
    ``_hybrid_parity_cfgs``' two widths and at micro_steps 1 and 4,
    decode through the graphs. flash_decode_merged is called n_groups x
    the host-run body steps and no other decode wrapper. A stream that
    differs fails the phase with the position and both runs' top-2
    margins there."""
    out = dict(dtype="float32", tf32=False, layout="dense_pam")
    for name, cfg in _hybrid_parity_cfgs().items():
        for k in (1, 4):
            key = f"{name}_micro_steps_{k}"
            line = out[key] = _card_cpu_streams(cfg, {}, fill=True,
                                                micro_steps=k)
            _assert_decode_launches(line["launches"], {
                "flash_decode_merged": line["launches_expected"]})
            assert line["launches_expected"] > 0, line
            assert line["divergence"] is None, (
                f"{key}: card and CPU streams differ: {line['divergence']}")
        assert (out[f"{name}_micro_steps_4"]["decode_dispatches"]
                < out[f"{name}_micro_steps_1"]["decode_dispatches"]), out
    return out


def phase_gqa_parity() -> dict:
    """The wider dense family's engine on the card and on the CPU give
    equal greedy streams (``_card_cpu_streams``: fp32, TF32 off, paged +
    ring, 6 requests through 4 slots) at each model's reduced variant in
    ``WIDE_DENSE``: groups 5, 8 and (head dim 64) 7 on the decode
    kernels' wide path, head dim 64 at group 1 on the narrow one. A stream that differs fails the phase with
    the position and both runs' top-2 margins there."""
    from repro_torch.models.config import get_config, reduced
    out = dict(dtype="float32", tf32=False)
    for arch, (_, _, heads) in WIDE_DENSE.items():
        cfg = dataclasses.replace(reduced(get_config(arch)), **heads)
        out[arch] = _card_cpu_streams(cfg)
        _assert_parity_line(arch, out[arch])
    return out


# the wider dense family at full width, by arch: the depth served on the
# card (None: the published depth), the tag of its kernels-phase rows,
# and the heads of its reduced gqa_parity variant (group 5, group 8, MHA
# at head dim 64, group 7 at head dim 64). deepseek-67b's 95 layers are
# 134.8 GB of bf16 weights, which no 80 GB card holds; a layer is 1.384 GB
# and the untied embedding and head 3.36 GB, so 20 layers are about 31.0
# GB. internvl2-1b (the vlm family) is served text-only, as the
# reference's engine serves it
WIDE_DENSE = {
    "qwen3-14b": (None, "_g5", dict(n_heads=10, n_kv_heads=2)),
    "deepseek-67b": (20, "_g8", dict(n_heads=16, n_kv_heads=2)),
    "minicpm-2b": (None, "_d64", dict(n_heads=4, n_kv_heads=4, d_head=64)),
    "internvl2-1b": (None, "_g7", dict(n_heads=14, n_kv_heads=2,
                                       d_head=64))}


VLM_ARCH = "internvl2-1b"
AUDIO_ARCH = "hubert-xlarge"
VLM_FORWARD = dict(B=4, text=1792, seq=2048)  # 256 patches + 1792 tokens
VLM_PREFILL = dict(B=8, text=512, max_len=2048, steps=16)
ENCODER = dict(B=8, frames=1500, iters=5)   # 30 s clips at 50 frames / s
ENCODER_PHASE = "encoder_hubert_xlarge"
# the kernels-phase rows of the fp32 flash_attention forward (the tf32x3
# kernel) at vlm_audio_parity's shapes
ATTN_FP32_ROWS = {VLM_ARCH: "flash_attention_vlm_fp32_100",
                  AUDIO_ARCH: "flash_attention_audio_fp32_150_noncausal"}
# the train_* phases of the vlm, audio and wider dense families, by arch:
# (depth on the card, None for the published depth; batch; text tokens
# (vlm, after its 256 patches), frames (audio) or tokens a row). The
# train step takes its state donated, as the train CLI's, so it holds
# bf16 parameters and gradients and fp32 moments, 12 bytes a parameter,
# plus the fp32 temporaries of the leaf it updates, 16 bytes an entry of
# the largest (an embedding or the untied head). The deep models are cut
# to fit one card: qwen3-14b to 8 of 40 layers (1.556 B parameters of
# embedding and head + 0.330 B a layer = 4.20 B: 50 GB + 12 GB for the
# head's update), deepseek-67b to 4 of 95 (1.678 B + 0.692 B a layer =
# 4.45 B: 53 GB + 13 GB). zamba2-7b's depth is its group count: 5 of 13
# groups of 5 Mamba-2 layers and the shared block, and its 3 tail layers
# (33 of 81 blocks: 28 Mamba-2 layers, the shared block at 5 sites;
# 2.62 B parameters: 29.3 GiB, + 19.5 GiB for the update of the stacked
# in_proj, 5 x 5 x 3584 x 14576 entries). scripts/train_step_memory.py
# measured a donated step at B 2 x 2048 peaking at 45.58 GiB at 4 groups
# and 54.37 at 5 (H100 80GB HBM3), so 5 groups keep more than 10 %
# headroom and 6 (about 63 GiB) were not tried. The mixture-of-experts
# families: qwen3-moe-235b-a22b cut to 1 of 94 layers (2.49 B parameters
# a layer, 2.42 B of them experts, + 1.24 B of untied embedding and head
# = 3.73 B: 45 GB + 13 GB for the update of the (1, 128, 4096, 1536)
# expert leaf; two layers would be about 100 GB), deepseek-v2-lite-16b
# (MLA) to 6 of 27 (0.585 B a layer + 0.42 B = 3.93 B: 47 GB + 18 GB for
# the (6, 64, 2048, 1408) expert leaf's update)
TRAIN_FAMILIES = {VLM_ARCH: (None, 4, 1792), AUDIO_ARCH: (None, 8, 1500),
                  "minicpm-2b": (None, 2, 2048), "qwen3-14b": (8, 1, 2048),
                  "deepseek-67b": (4, 1, 2048), HYBRID_ARCH: (5, 2, 2048),
                  MOE_ARCH: (1, 2, 2048), MLA_ARCH: (6, 1, 2048)}
# their peak lr: the train CLI's 1e-2 (right for the reduced models)
# made the losses of hubert-xlarge, qwen3-14b and deepseek-67b rise over
# 6 steps, with the plain attention as with the kernels; the mamba2-780m
# phase's 1e-3 trains all five
FAMILY_LR = 1e-3
FAMILY_STEPS = 6
FAMILY_PARITY_LAYERS = 2   # train_parity_*: full width, 2 layers, B 2 x 500


def _parity_depth(arch: str):
    """A train_parity_* phase's depth: ``FAMILY_PARITY_LAYERS`` layers, or
    for the hybrid 2 groups of 1 Mamba-2 layer and a tail of 1 (3 SSD
    scans, the shared block at 2 sites), or 1 layer of
    qwen3-moe-235b-a22b (fp32 parameters and gradients of a layer are
    about 20 GB, and the phase holds both paths' gradients)."""
    from repro_torch.models.config import HybridConfig
    if arch == HYBRID_ARCH:
        return HybridConfig(n_groups=2, mamba_per_group=1, tail_mamba=1)
    if arch == MOE_ARCH:
        return 1
    return FAMILY_PARITY_LAYERS
# the tag of each family's attention rows in the kernels phase, and
# whether its attention is causal (hubert-xlarge is a bidirectional
# encoder); deepseek-v2-lite-16b (MLA) has none: its attention is the
# plain chunked one of mla_train, as in the reference, and it has no
# train_parity_* phase (its two paths are one)
PROFILE_FAMILIES = (AUDIO_ARCH,)   # with a profile_train_* phase
TRAIN_ROWS = {VLM_ARCH: ("_d64_g7", True),
              AUDIO_ARCH: ("_d80_noncausal", False),
              "minicpm-2b": ("_d64", True), "qwen3-14b": ("_g5", True),
              "deepseek-67b": ("_g8", True), HYBRID_ARCH: (D112, True),
              MOE_ARCH: ("_g16", True)}
# bf16 logits through the attention kernels against the plain attention
# on the card, max |dlogit| / max(1, max |logit|): both round each
# layer's attention output to bf16 and may differ there by one bf16 step
# (2^-8 relative) where their fp32 sums round apart, and the bf16
# residual stream carries such steps through every later layer; 5e-2 is
# about 13 bf16 steps of the largest logit. A wrong kernel moves logits
# by their own size; the fp32 vlm_audio_parity phase holds the same
# paths to 1e-3
BF16_MODEL_TOL = 5e-2


def _rel_diff(got, ref) -> float:
    return (float((got.float() - ref.float()).abs().max())
            / max(1.0, float(ref.float().abs().max())))


def _logit_line(got, ref) -> dict:
    """bf16 logits of the kernel path against the plain path's."""
    return dict(max_rel_logit_diff=_rel_diff(got, ref),
                mean_abs_logit_diff=float((got.float() - ref.float())
                                          .abs().mean()),
                argmax_agreement=float((got.argmax(-1) == ref.argmax(-1))
                                       .float().mean()),
                tol=BF16_MODEL_TOL)


def _event_ms(fn, iters: int) -> list:
    """Wall ms of each of ``iters`` calls by CUDA events (no L2 flush:
    a forward's weights and activations far exceed it)."""
    import torch
    out = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def phase_vlm_forward(cfg, params) -> dict:
    """Full-width internvl2-1b (24 layers, bf16, random weights from seed
    0) through its patch prefix: ``forward(use_kernel=True)`` with 256
    patches of 1024 before 1792 tokens at B 4 (S 2048: the (64, 7)
    causal ``flash_attention`` forward once a layer) against
    ``use_kernel=False`` on the card; then ``prefill(patches=)`` at B 8
    (256 patches + 512 tokens, max_len 2048) and 16 greedy
    ``decode_step``s through ``flash_decode_merged`` (the engine's dense
    decode attention over every cached token: the (64, 7) merged kernel
    once a layer), each step's logits against a twin cache decoded by
    the plain grouped attention, teacher-forced. Launch counts from this
    main-path run; then ms (median of 3), device ms of the attention
    kernel a forward, peak memory."""
    import torch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tf
    from repro_torch.serving import pam_manager as pm
    dt = tf.torch_dtype(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    B, P, T = VLM_FORWARD["B"], cfg.num_patches, VLM_FORWARD["text"]
    assert P + T == VLM_FORWARD["seq"], (P, T)
    batch = dict(tokens=torch.randint(0, cfg.vocab, (B, T), generator=g,
                                      device="cuda"),
                 patches=torch.randn((B, P, cfg.frontend_dim), generator=g,
                                     device="cuda").to(dt))
    pb, pt, smax = VLM_PREFILL["B"], VLM_PREFILL["text"], \
        VLM_PREFILL["max_len"]
    ptoks = torch.randint(0, cfg.vocab, (pb, pt), generator=g,
                          device="cuda")
    ppatch = torch.randn((pb, P, cfg.frontend_dim), generator=g,
                         device="cuda").to(dt)
    part = torch.ones((pb, smax), dtype=torch.bool, device="cuda")
    kernel_attn = pm.make_masked_decode_attn(part)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with torch.no_grad():                       # the main path
        logits, _ = tf.forward(cfg, params, batch, use_kernel=True)
        lg, cache = tf.prefill(cfg, params, ptoks, smax, patches=ppatch)
        twin = tf.DecodeCache(*(t.clone() for t in cache))
        plain_l, worst = lg, 0.0
        for _ in range(VLM_PREFILL["steps"]):
            nxt = torch.argmax(lg, -1).to(torch.int32)
            lg, cache, _ = tf.decode_step(cfg, params, nxt, cache,
                                          decode_attn_fn=kernel_attn)
            plain_l, twin, _ = tf.decode_step(
                cfg, params, nxt, twin,
                decode_attn_fn=attn_mod.dense_decode_attn)
            worst = max(worst, _rel_diff(lg, plain_l))
    torch.cuda.synchronize()
    launches = _launches()
    wgmma = _wgmma_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    assert launches["flash_attention"] == cfg.n_layers, launches
    # bf16 at (64, 7): every forward launch is the wgmma kernel's
    assert wgmma["flash_attention"] == cfg.n_layers, wgmma
    _assert_decode_launches(launches, {
        "flash_decode_merged": cfg.n_layers * VLM_PREFILL["steps"]})
    assert tuple(logits.shape) == (B, T, cfg.vocab), logits.shape
    assert bool(torch.isfinite(logits).all()) and bool(
        torch.isfinite(lg).all())
    assert cache.lengths.tolist() == [P + pt + VLM_PREFILL["steps"]] * pb
    with torch.no_grad():
        plain, _ = tf.forward(cfg, params, batch, use_kernel=False)
        fwd_line = _logit_line(logits, plain)
        del plain, logits
        assert fwd_line["max_rel_logit_diff"] <= BF16_MODEL_TOL, fwd_line
        assert worst <= BF16_MODEL_TOL, f"decode logits differ: {worst}"

        def fwd():
            tf.forward(cfg, params, batch, use_kernel=True)

        def fwd_plain():
            tf.forward(cfg, params, batch, use_kernel=False)
        fwd_ms = sorted(_event_ms(fwd, 3))[1]
        plain_ms = sorted(_event_ms(fwd_plain, 3))[1]
        attn_ms = _device_ms_by_kernel(fwd, iters=3)
        prefill_ms = sorted(_event_ms(lambda: tf.prefill(
            cfg, params, ptoks, smax, patches=ppatch), 3))[1]
        c = tf.DecodeCache(*(t.clone() for t in cache))
        nxt = torch.argmax(lg, -1).to(torch.int32)
        step_ms = sorted(_event_ms(lambda: tf.decode_step(
            cfg, params, nxt, c, decode_attn_fn=kernel_attn), 3))[1]
    return dict(card=_card(), arch=cfg.name, n_layers=cfg.n_layers,
                heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.head_dim,
                forward=dict(B=B, patches=P, text=T, seq=P + T,
                             ms=fwd_ms, plain_attention_ms=plain_ms,
                             attention_device_ms=attn_ms,
                             tokens_per_s=B * (P + T) / (fwd_ms / 1e3),
                             **fwd_line),
                prefill=dict(B=pb, patches=P, text=pt, max_len=smax,
                             ms=prefill_ms),
                decode=dict(steps=VLM_PREFILL["steps"],
                            eager_step_ms=step_ms,
                            max_rel_logit_diff=worst, tol=BF16_MODEL_TOL,
                            lengths_after=P + pt + VLM_PREFILL["steps"]),
                launches=launches, wgmma_launches=wgmma, peak_mem_gb=peak_gb)


def phase_encoder(cfg, params) -> dict:
    """Full-width, full-depth hubert-xlarge (48 layers, 16 / 16 heads of
    80, bf16, random weights from seed 0): ``forward(use_kernel=True)``
    under ``no_grad`` over B 8 x 1500 frames (30 s clips at 50 frames a
    second; the bidirectional (80, 1) ``flash_attention`` forward once a
    layer). One warm-up forward, then 5 timed by CUDA events; launches
    counted over those 6 (48 each); logits against ``use_kernel=False``
    on the card; median ms, frames a second, the attention kernel's
    device ms a forward and its share, peak memory."""
    import statistics
    import torch
    from repro_torch.models import transformer as tf
    B, S = ENCODER["B"], ENCODER["frames"]
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = dict(frames=torch.randn((B, S, cfg.frontend_dim), generator=g,
                                    device="cuda").to(tf.torch_dtype(cfg)))

    def fwd():
        return tf.forward(cfg, params, batch, use_kernel=True)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with torch.no_grad():                       # the main path
        logits = fwd()
        ms = _event_ms(fwd, ENCODER["iters"])
    torch.cuda.synchronize()
    launches = _launches()
    wgmma = _wgmma_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    forwards = 1 + ENCODER["iters"]
    assert launches["flash_attention"] == cfg.n_layers * forwards, launches
    # bf16 at (80, 1): every forward launch is the wgmma kernel's
    assert wgmma["flash_attention"] == cfg.n_layers * forwards, wgmma
    _assert_decode_launches(launches, {})
    assert tuple(logits.shape) == (B, S, cfg.vocab), logits.shape
    assert bool(torch.isfinite(logits).all())
    with torch.no_grad():
        plain = tf.forward(cfg, params, batch, use_kernel=False)[0]
        line = _logit_line(logits, plain)
        assert line["max_rel_logit_diff"] <= BF16_MODEL_TOL, line
        plain_ms = sorted(_event_ms(lambda: tf.forward(
            cfg, params, batch, use_kernel=False), 3))[1]
        attn = _device_ms_by_kernel(fwd, iters=3)
    med = statistics.median(ms)
    return dict(card=_card(), arch=cfg.name, n_layers=cfg.n_layers,
                heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.head_dim,
                causal=cfg.causal, B=B, frames=S, forward_ms=ms,
                forward_ms_median=med, frames_per_s=B * S / (med / 1e3),
                plain_attention_forward_ms=plain_ms,
                attention_device_ms=attn,
                attention_share=sum(attn.values()) / med,
                forwards=forwards, launches=launches, wgmma_launches=wgmma,
                weights=_dense_weights(cfg), peak_mem_gb=peak_gb, **line)


def phase_vlm_audio_parity() -> dict:
    """Reduced internvl2-1b and hubert-xlarge in fp32, TF32 off, weights
    made on the CPU and copied: the card against the CPU (whose wrappers
    run the plain versions). vlm, at the reduced heads (4 q / 2 kv of 16)
    and at 14 / 2 of 64 (the (64, 7) builds): ``forward(use_kernel=True)``
    with patches, ``prefill(patches=)`` and 4 decode steps through
    ``flash_decode_merged`` (teacher-forced with the CPU's tokens);
    audio, at the reduced heads (4 / 2 of 16) and at 4 / 4 of 80 (the
    (80, 1) build): the bidirectional ``forward(use_kernel=True)``. Each
    within ``PARITY_TOL``; flash_attention n_layers a forward and
    flash_decode_merged n_layers a decode step."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import get_config, reduced
    from repro_torch.serving import pam_manager as pm
    out = dict(dtype="float32", tf32=False, tol=PARITY_TOL)
    cases = (("vlm", VLM_ARCH, {}),
             ("vlm_g7", VLM_ARCH, dict(n_heads=14, n_kv_heads=2, d_head=64)),
             ("audio", AUDIO_ARCH, {}),
             ("audio_d80", AUDIO_ARCH, dict(n_heads=4, n_kv_heads=4,
                                            d_head=80)))
    total = dict.fromkeys(("flash_attention", "flash_decode_merged"), 0)
    for key, arch, heads in cases:
        cfg = dataclasses.replace(reduced(get_config(arch)), **heads)
        host = tf.init_params(cfg, 0, device="cpu")
        dev = tree.tree_map(lambda t: t.to("cuda"), host)
        rng = np.random.default_rng(len(key))
        line, worst = {}, 0.0
        _reset_launches()
        if cfg.family == "audio":
            batch = {"frames": torch.from_numpy(rng.standard_normal(
                (2, 150, cfg.frontend_dim), np.float32))}
        else:
            batch = {"tokens": torch.from_numpy(
                         rng.integers(0, cfg.vocab, (2, 96))),
                     "patches": torch.from_numpy(rng.standard_normal(
                         (2, cfg.num_patches, cfg.frontend_dim),
                         np.float32))}
        with torch.no_grad():
            ref, _ = tf.forward(cfg, host, batch, use_kernel=True)
            got, _ = tf.forward(cfg, dev, {k: v.cuda() for k, v in
                                           batch.items()}, use_kernel=True)
            line["forward"] = _rel_diff(got.cpu(), ref)
            if cfg.family == "vlm":
                toks, patches = batch["tokens"], batch["patches"]
                lc, cc = tf.prefill(cfg, host, toks, 128, patches=patches)
                lg, cg = tf.prefill(cfg, dev, toks.cuda(), 128,
                                    patches=patches.cuda())
                line["prefill"] = _rel_diff(lg.cpu(), lc)
                part = torch.ones((2, 128), dtype=torch.bool)
                for _ in range(4):
                    nxt = torch.argmax(lc, -1).to(torch.int32)
                    lc, cc, _ = tf.decode_step(
                        cfg, host, nxt, cc,
                        decode_attn_fn=pm.make_masked_decode_attn(part))
                    lg, cg, _ = tf.decode_step(
                        cfg, dev, nxt.cuda(), cg,
                        decode_attn_fn=pm.make_masked_decode_attn(
                            part.cuda()))
                    worst = max(worst, _rel_diff(lg.cpu(), lc))
                line["decode_4_steps"] = worst
        launches = _launches()
        want = dict(flash_attention=cfg.n_layers,
                    flash_decode_merged=4 * cfg.n_layers
                    if cfg.family == "vlm" else 0)
        for name, n in want.items():
            assert launches[name] == n, (key, name, launches[name], n)
            total[name] += n
        # fp32: every attention launch a tf32x3 one
        tf32x3 = _tf32x3_launches()["flash_attention"]
        assert tf32x3 == cfg.n_layers, (key, tf32x3)
        bad = {k: v for k, v in line.items() if v > PARITY_TOL}
        assert not bad, f"{key}: card and CPU differ: {bad}"
        out[key] = dict(line, heads=[cfg.n_heads, cfg.n_kv_heads],
                        head_dim=cfg.head_dim, causal=cfg.causal,
                        launches={k: launches[k] for k in want},
                        tf32x3_launches=tf32x3)
        del host, dev
    out["launches"] = total
    return out


def _wide_heads(arch: str) -> tuple[int, int, int]:
    """(H, Hkv, d) of ``arch`` at full width: its kernels-phase rows' shape."""
    from repro_torch.models.config import get_config
    cfg = get_config(arch)
    return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim


def _attn_keys(arch: str, fp32: bool = False) -> tuple[str, str]:
    """The kernels-phase keys of ``arch``'s attention forward and backward
    rows: bf16 at its train_* phase's shape, or fp32 at its
    train_parity_* shape."""
    tag = TRAIN_ROWS[arch][0]
    shape = "fp32_500" if fp32 else "train"
    return (f"flash_attention_{shape}{tag}",
            f"flash_attention_bwd_{shape}{tag}")


def _train_phase(arch: str, parity: bool = False) -> str:
    return ("train_parity_" if parity else "train_") + arch.replace(
        "-", "_").replace(".", "_")


class _FamilyData:
    """Train batches of ``cfg``'s family on the card, ``S`` text tokens or
    frames a row, from ``seed``: SyntheticLM tokens and next-token labels;
    the vlm adds ``cfg.num_patches`` patches, drawn once and reused; the
    audio family draws ``S`` frames a row each step, with HuBERT-style
    frame targets in its 504 classes: each frame's class under a fixed
    random projection (drawn first), which the model can learn."""

    def __init__(self, cfg, B: int, S: int, seed: int = 0):
        import torch
        from repro_torch.data import SyntheticLM
        from repro_torch.models import transformer as tf
        self.cfg, self.B, self.S = cfg, B, S
        self.dev, self.dt = torch.device("cuda"), tf.torch_dtype(cfg)
        self.gen = torch.Generator(device="cuda").manual_seed(seed)
        self.lm = SyntheticLM(vocab=cfg.vocab, seq_len=S, batch=B,
                              seed=seed)
        if cfg.family == "audio":
            self.proj = torch.randn((cfg.frontend_dim, cfg.vocab),
                                    generator=self.gen, device=self.dev)
        if cfg.family == "vlm":
            self.patches = torch.randn(
                (B, cfg.num_patches, cfg.frontend_dim), generator=self.gen,
                device=self.dev).to(self.dt)

    def batch(self, step: int) -> dict:
        import torch
        from repro_torch.launch import train as train_cli
        if self.cfg.family == "audio":
            frames = torch.randn((self.B, self.S, self.cfg.frontend_dim),
                                 generator=self.gen, device=self.dev)
            return {"frames": frames.to(self.dt),
                    "labels": (frames @ self.proj).argmax(-1).to(
                        torch.int32)}
        out = train_cli.device_batch(self.lm, step, 1, self.dev)
        if self.cfg.family == "vlm":
            out["patches"] = self.patches
        return out


def _family_cfg(arch: str, n_layers, dtype: str = "bfloat16"):
    from repro_torch.models.config import get_config
    return _cut(dataclasses.replace(get_config(arch), dtype=dtype), n_layers)


def _train_launches(cfg, steps: int) -> dict:
    """The launches a train path of ``cfg`` makes in ``steps`` steps
    without remat, by counted wrapper: each attention site's forward and
    backward, each Mamba-2 layer's SSD scan and its backward; 0 for every
    other counted kernel, and for every kernel on the MLA family's path
    (its plain chunked attention)."""
    want = dict.fromkeys(_counted(), 0)
    if cfg.mla is not None:
        return want
    if cfg.family == "hybrid":
        hb = cfg.hybrid
        n_mamba = hb.n_groups * hb.mamba_per_group + hb.tail_mamba
        want.update(ssd_scan=n_mamba * steps, ssd_scan_bwd=n_mamba * steps,
                    flash_attention=hb.n_groups * steps,
                    flash_attention_bwd=hb.n_groups * steps)
    elif cfg.family == "ssm":
        want.update(ssd_scan=cfg.n_layers * steps,
                    ssd_scan_bwd=cfg.n_layers * steps)
    else:
        want.update(flash_attention=cfg.n_layers * steps,
                    flash_attention_bwd=cfg.n_layers * steps)
    return want


def phase_train_family(arch: str) -> dict:
    """A training main path of the vlm, audio, wider dense, hybrid or
    mixture-of-experts family at full width (``TRAIN_FAMILIES``: depth,
    batch, length), bf16, random weights from seed 0, ``FAMILY_STEPS``
    steps at the train CLI's schedule (``_family_steps``). Both attention
    kernels must launch n_layers x steps times, every launch a wgmma one,
    no other counted kernel (none at all on the MLA family's path); the
    losses must be finite and the last three below the first. Median
    step ms (steps 2 on), tokens or frames a second, peak memory; for
    the MoE families also each step's summed aux loss and the
    assignments dropped at capacity (``_Drops``)."""
    import math
    import statistics
    import torch
    from repro_torch.launch import train as train_cli
    n_layers, B, S = TRAIN_FAMILIES[arch]
    cfg = _family_cfg(arch, n_layers)
    tcfg = train_cli.train_config(steps=FAMILY_STEPS, lr=FAMILY_LR)
    assert tcfg.use_kernel and not tcfg.remat
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    drops = _Drops() if cfg.moe is not None else None
    try:
        out = _family_steps(cfg, tcfg, B, S)
    finally:
        routed = None if drops is None else drops.close()["train"]
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches = _launches()
    wgmma = _wgmma_launches()
    losses = out["losses"]
    want = _train_launches(cfg, FAMILY_STEPS)
    assert all(math.isfinite(x) for x in losses), losses
    assert sum(losses[-3:]) / 3 < losses[0], losses
    assert launches == want, f"launches {launches}, want {want}"
    # bf16 at full width: every launch a wgmma one
    assert wgmma == {k: want[k] for k in wgmma}, f"wgmma {wgmma}, {want}"
    step_ms = statistics.median(out["step_s"][1:]) * 1e3
    rows = B * (S + cfg.num_patches)
    moe = {}
    if routed is not None:      # one aux loss a layer and step
        aux, L = [float(a) for a in drops.aux], cfg.n_layers
        assert len(aux) == L * FAMILY_STEPS, (len(aux), L)
        moe = dict(experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                   shared=cfg.moe.num_shared, d_expert=cfg.moe.d_expert,
                   capacity=math.ceil(B * S * cfg.moe.top_k
                                      / cfg.moe.num_experts
                                      * cfg.moe.capacity_factor),
                   aux_losses=[sum(aux[i:i + L])
                               for i in range(0, len(aux), L)],
                   **routed)
        if cfg.mla is not None:
            moe["mla"] = dataclasses.asdict(cfg.mla)
    hybrid = {} if cfg.hybrid is None else dict(
        hybrid=dataclasses.asdict(cfg.hybrid),
        published_hybrid=dataclasses.asdict(_family_cfg(arch, None).hybrid),
        ssm=dict(d_state=cfg.ssm.d_state, head_dim=cfg.ssm.head_dim,
                 heads=cfg.ssm.n_heads(cfg.d_model), chunk=cfg.ssm.chunk))
    return dict(card=_card(), arch=arch, family=cfg.family,
                n_layers=cfg.n_layers, published_layers=_family_cfg(
                    arch, None).n_layers, **hybrid, peak_lr=FAMILY_LR,
                heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.head_dim,
                causal=cfg.causal, **moe, steps=FAMILY_STEPS, batch=B,
                seq=S + cfg.num_patches, text=S if cfg.family != "audio"
                else 0, dtype=cfg.dtype, params=cfg.param_count(),
                losses=losses, grad_norms=out["grad_norms"],
                first_step_ms=out["step_s"][0] * 1e3, step_ms=step_ms,
                positions_per_s=rows / (step_ms / 1e3),
                launches=launches, wgmma_launches=wgmma,
                launches_expected=want, peak_mem_gb=peak_gb)


def _family_steps(cfg, tcfg, B: int, S: int) -> dict:
    """``FAMILY_STEPS`` steps of ``cfg`` from seed 0 with the state
    donated: the dense and MoE models through ``launch.train.run``
    (SyntheticLM tokens), the vlm and audio models through the same
    ``build_train_step`` on ``_FamilyData``'s patch and frame batches
    (the CLI feeds tokens only, as the reference's). Losses, grad norms,
    step seconds."""
    from repro_torch.launch import train as train_cli
    from repro_torch.training.train_step import (build_train_step,
                                                 init_train_state)
    if cfg.family not in ("vlm", "audio"):
        return train_cli.run(cfg, tcfg, steps=FAMILY_STEPS, batch=B, seq=S,
                             device="cuda", log=lambda _: None)
    state = init_train_state(cfg, tcfg, 0, device="cuda")
    step_fn = build_train_step(cfg, tcfg, donate=True)   # as the CLI
    data = _FamilyData(cfg, B, S)
    out = dict(losses=[], grad_norms=[], step_s=[])
    for s in range(FAMILY_STEPS):
        b = data.batch(s)
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["step_s"].append(time.perf_counter() - t0)
    return out


def _dense_weights(cfg) -> dict:
    """bf16 weight bytes of the model and of what one decode step reads
    (every matrix but an untied input embedding, of which a step gathers
    a row a slot), each with its time at the HBM rate: the floor of a
    step at batch 8."""
    total = cfg.param_count() * 2
    read = total - (0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model * 2)
    return {k: dict(bytes=v, hbm_ms=v / HBM_BYTES_PER_S * 1e3)
            for k, v in (("all", total), ("read_per_step", read))}


def _merged_instantiations(step: dict, d: int, rep: int) -> dict:
    """Executions on the card, in a profiled step (``_step_events``), of
    each merged decode kernel instantiated for head dim ``d`` and group
    ``rep``."""
    import re
    pat = re.compile(rf"\b{d},\s*{rep},\s*true>")
    return {name: sum(n for key, n in step["decode_instantiations"].items()
                      if name in key and pat.search(key))
            for name in DECODE_CUDA_KERNELS}


def _kv_bytes_per_token(cfg) -> int:
    """Decode-cache bytes (bf16) a token holds over all layers: K and V
    of each kv head at each attention site (a hybrid model's n_groups),
    or an MLA model's latent and shared rope key."""
    if cfg.mla is not None:
        return cfg.n_layers * (cfg.mla.kv_lora_rank
                               + cfg.mla.qk_rope_head_dim) * 2
    return 2 * _attention_sites(cfg) * cfg.n_kv_heads * cfg.head_dim * 2


def _hybrid_weights(cfg) -> dict:
    """bf16 weight bytes of the hybrid model and of what one decode step
    reads: every matrix but the untied input embedding (a row a slot),
    with the shared attention + MLP block read once at each of its
    n_groups sites; and the shared block alone, once and at every site;
    each with its time at the HBM rate."""
    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    shared = (2 * d * hd + 2 * d * kvd + 3 * d * cfg.d_ff + 2 * d) * 2
    total = cfg.param_count() * 2
    sites = cfg.hybrid.n_groups
    read = (total - (0 if cfg.tie_embeddings else cfg.vocab * d * 2)
            + (sites - 1) * shared)
    return {k: dict(bytes=v, hbm_ms=v / HBM_BYTES_PER_S * 1e3)
            for k, v in (("all", total), ("read_per_step", read),
                         ("shared_block", shared),
                         ("shared_block_all_sites", sites * shared))}


def _recurrent_bytes(cfg, batch: int = 8) -> dict:
    """A hybrid model's recurrent decode state: the fp32 SSD state (H, N,
    P) and the bf16 conv ring (conv_kernel - 1, conv_dim) of every
    Mamba-2 layer, bytes a sequence, and the bytes a decode step at
    ``batch`` reads and writes (each once each way) beside their time at
    the HBM rate."""
    ssm, hb = cfg.ssm, cfg.hybrid
    layers = hb.n_groups * hb.mamba_per_group + hb.tail_mamba
    di = ssm.d_inner(cfg.d_model)
    H = ssm.n_heads(cfg.d_model)
    conv_dim = di + 2 * ssm.n_groups * ssm.d_state
    state = layers * H * ssm.d_state * ssm.head_dim * 4
    conv = layers * (ssm.conv_kernel - 1) * conv_dim * 2
    step = 2 * batch * (state + conv)
    return dict(mamba_layers=layers, state_bytes_per_seq=state,
                conv_bytes_per_seq=conv, batch=batch,
                read_write_bytes_per_step=step,
                read_write_hbm_ms=step / HBM_BYTES_PER_S * 1e3)


def _graph_device_ms(fn) -> dict:
    """``fn`` captured as one CUDA graph and replayed under torch.profiler
    (``_step_events``): its kernel nodes and device ms, kernels only, no
    launch gaps; CUDA events around a replay where the profiler saw no
    device event."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ev = _step_events(graph.replay)
    ms = ev["device_ms"] or _time_ms(graph.replay, flush_bytes=1)
    return dict(device_ms=ms, kernel_nodes=ev["kernel_nodes"],
                top=ev["top"][:4])


def _latent_attention_ms(eng) -> dict:
    """Device ms of one decode step's latent attention on ``eng``'s live
    state (a running MLA engine): the participation-masked latent
    attention of every layer over its latent cache (B 8, Smax 2048, r
    512 + rope 64, bf16), at the lengths and participation the next step
    reads, random queries; beside the dense-PAM GQA decode of as many
    layers at like KV bytes (16 q / 2 kv heads of 128, 1,024 B a token
    and layer against the latent's 1,152: ``masked_decode_attention``,
    the merged decode kernel over the dense cache), on the same lengths
    and participation. Each set is captured as one graph and replayed
    under the profiler."""
    import math
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import pam_manager as pm
    cfg, cache, st = eng.cfg, eng.cache, eng.pam_state
    m, B, smax = cfg.mla, cache.lengths.shape[0], eng.scfg.max_len
    gen = torch.Generator(device="cuda").manual_seed(0)
    lens = torch.clamp(cache.lengths + 1, max=smax)
    part = pm.participation_mask(eng.pam_cfg, st.importance, lens)
    l_fn = pm.make_masked_latent_attn(part)
    q_eff = torch.randn((B, cfg.n_heads, m.kv_lora_rank
                         + m.qk_rope_head_dim), generator=gen,
                        device="cuda").to(cache.ckv.dtype)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)

    def latent():
        for i in range(cfg.n_layers):
            l_fn(q_eff, cache.ckv[i], cache.krope[i], lens, scale=scale)
    H, Hkv, d = 16, 2, 128
    kv = [torch.randn((B, Hkv, smax, d), generator=gen, device="cuda")
          .to(torch.bfloat16) for _ in range(2)]
    q = torch.randn((B, H, d), generator=gen, device="cuda").to(
        torch.bfloat16)

    def gqa():
        for _ in range(cfg.n_layers):
            ops.masked_decode_attention(q, kv[0], kv[1], part, lens)
    live = int(torch.sum(part & (torch.arange(smax, device="cuda")[None]
                                 < lens[:, None])))
    token = (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    return dict(latent=_graph_device_ms(latent),
                gqa_like=dict(_graph_device_ms(gqa), heads=[H, Hkv],
                              head_dim=d, kv_bytes_per_token_layer=2 * Hkv
                              * d * 2),
                layers=cfg.n_layers, participating_tokens=live,
                kv_bytes_per_token_layer=token,
                latent_read_bytes=live * token * cfg.n_layers,
                latent_read_hbm_ms=live * token * cfg.n_layers
                / HBM_BYTES_PER_S * 1e3)


def phase_engine_served(cfg, params, weights=None, layout=PAGED_RING,
                        latent: bool = False) -> dict:
    """A full-width model on the card (bf16, random weights from seed 0,
    its depth maybe cut: the cut is listed in ``reduced``), served with
    the serving phases' template (8 requests of 512-1024 prompt tokens,
    64 new, batch 8, max_len 2048, ``_pam``'s PAM) on ``layout`` (paged
    + ring, block 16, ring 256; ``{}``: dense PAM), decode through the
    graphs. Asserts 64 tokens a request, each merged decode wrapper of
    the layout (dense PAM: flash_decode_merged only) attention sites x
    the host-run body steps (sites: ``_attention_sites``, n_layers but
    for a hybrid model's n_groups) and the others never, and each merged
    decode kernel of the layout at the model's (head dim, group) once a
    site on the card in one profiled replayed step; or, ``latent`` (an
    MLA model, whose latent attention is plain tensor code as in the
    reference), no decode wrapper called, no decode kernel on the card
    in that step, the latent attention n_layers x the host-run body
    steps, and its device ms a step (``_latent_attention_ms``). Prints
    decode tok/s, the steady step's wall
    ms (``_steady_steps``: 4 steps after every graph is captured), the
    replays' device span over those steps and the device's idle share
    (one minus span over wall, the same window), the profiled step's
    kernel nodes, peak memory, the weight bytes a step reads
    (``weights``, default ``_dense_weights``) beside their time at the
    HBM rate, KV bytes a token and read a step (the tier reads, tokens
    over the run, times a token's bytes, over the decode steps), and the
    pool blocks read a step; for a hybrid model also its attention sites
    and its recurrent state's bytes (``_recurrent_bytes``)."""
    import numpy as np
    import torch
    from repro_torch.models.config import get_config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    calls = _LatentCalls() if latent else None
    try:
        g = _engine(cfg, params, 8, 64, max_batch=8, max_len=2048,
                    **layout)
        t0 = time.perf_counter()
        _warm_graphs(g)                      # admission, captures
        warm_s = time.perf_counter() - t0
        walls, span_s = _steady_steps(g)
        step = _step_events(g.step)
        summ = g.run()
    finally:
        latent_calls = calls.close() if latent else None
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    lens = [len(rs.outputs) for rs in g.requests.values()]
    assert lens == [64] * 8, f"outputs per request {lens}"
    sites = _attention_sites(cfg)
    want = sites * g.decode_body_steps
    group = cfg.n_heads // cfg.n_kv_heads
    used = 2 if layout else 1          # dense PAM: the dense kernel only
    if latent:
        _assert_decode_launches(launches, {})
        assert latent_calls == want, (f"latent attention called "
                                      f"{latent_calls} times, want {want}")
        mine = step["decode_kernels_on_device"]
        _assert_device_decode_counts(mine, (), 0)
    else:
        _assert_decode_launches(launches, dict.fromkeys(
            DECODE_KERNELS[:used], want))
        mine = _merged_instantiations(step, cfg.head_dim, group)
        _assert_device_decode_counts(mine, DECODE_CUDA_KERNELS[:used],
                                     sites)
    published = get_config(cfg.name).n_layers
    kv_token = _kv_bytes_per_token(cfg)
    out = dict(card=_card(), arch=cfg.name, n_layers=cfg.n_layers,
               n_layers_published=published,
               reduced=([] if cfg.n_layers == published else
                        [f"n_layers {published} -> {cfg.n_layers}"]),
               d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
               head_dim=cfg.head_dim, group=group,
               decode_tok_s=summ["decode_tok_s"],
               decode_time_s=summ["decode_time_s"],
               p50_tpot_s=summ["p50_tpot_s"], p99_tpot_s=summ["p99_tpot_s"],
               steady_step_ms_median=float(np.median(walls)) * 1e3,
               steady_step_ms=[w * 1e3 for w in walls],
               replay_device_ms_per_step=span_s / len(walls) * 1e3,
               device_idle_share=1.0 - span_s / sum(walls),
               replayed_step=step, merged_kernels_on_device=mine,
               warm_s=warm_s, graphs=sorted(g._graphs),
               capture_ms_per_graph=g.capture_seconds * 1e3
               / max(len(g._graphs), 1),
               peak_mem_gb=peak_gb,
               weights=weights or _dense_weights(cfg),
               kv_bytes_per_token=kv_token,
               kv_read_bytes_per_step=sum(summ["tier_reads"]) * kv_token
               / summ["decode_device_steps"],
               tier_reads=summ["tier_reads"],
               decode_device_steps=summ["decode_device_steps"],
               blocks_touched_per_step=summ.get("blocks_touched_per_step"),
               blocks_window_per_step=summ.get("blocks_window_per_step"),
               launches=launches, decode_body_steps=g.decode_body_steps,
               launches_expected=want,
               layout="paged_ring" if layout else "dense_pam")
    if cfg.hybrid is not None:
        out.update(hybrid=dataclasses.asdict(cfg.hybrid),
                   attention_sites=sites, recurrent=_recurrent_bytes(cfg))
    if latent:
        out.update(mla=dataclasses.asdict(cfg.mla),
                   latent_attention_calls=latent_calls,
                   latent_attention_expected=want,
                   latent_attention=_latent_attention_ms(g))
    del g
    gc.collect()
    return out


SHARDS = (1, 2, 4)
SHARD_POOL = 1023     # pool blocks: NB + 1 = 1,024 splits over 2 and 4


def _merge_ms(cfg, g: int) -> dict:
    """Device ms of one cross-site merge (Alg. 1 over ``g`` sites'
    partials, ``pam_shard._merge_across_sites``) at the model's decode
    shape (B 8, fp32 (O, m, l)), replayed as a CUDA graph: a layer's
    call, and a step's (n_layers calls)."""
    import torch
    from repro_torch.core import online_softmax as osm
    from repro_torch.distributed import pam_shard as psh
    gen = torch.Generator(device="cuda").manual_seed(g)
    B, H, d = 8, cfg.n_heads, cfg.head_dim
    parts = [osm.AttnPartial(
        torch.randn((B, H, d), generator=gen, device="cuda"),
        torch.randn((B, H), generator=gen, device="cuda"),
        torch.rand((B, H), generator=gen, device="cuda") + 1.0)
        for _ in range(g)]
    r = _graph_device_ms(lambda: psh._merge_across_sites(parts))
    return dict(r, per_step_ms=r["device_ms"] * cfg.n_layers)


def phase_engine_sharded(cfg, params) -> dict:
    """The sharded engine on the card: a full-width model (bf16, random
    weights from seed 0: qwen3-0.6b, qwen3-moe-235b-a22b cut to
    ``MOE_LAYERS`` layers, internvl2-1b) on the serving template (8
    requests of 512-1024 prompt tokens, 64 new, batch 8, max_len 2048,
    block 16, ring 256) with a pool of 1,023 blocks, at shard 1, 2 and 4
    in turn, every site on this card. Each run is driven with the launch counts set to 0
    just before it and read just after: each merged decode wrapper must be
    called shard x n_layers x the host-run body steps, the stacked ones
    never, and in one profiled replayed step each merged decode kernel
    must run shard x n_layers times on the card. Asserts 64 tokens a
    request and one dispatch a device step. Prints decode tok/s, the
    steady step ms, the kernel nodes of a step, the cross-site merge's
    device ms (``_merge_ms``), a site's parameter bytes, the modeled
    merge bytes (``merge_collective_bytes``), peak memory, and the share
    of tokens equal to shard 1's stream with each request's first token
    apart (bf16: the row-parallel sums round apart, and a flipped token
    changes the rest of its stream). An MoE model adds the (token,
    expert) assignments dropped at capacity at prefill and at decode
    (``_Drops``; some decode assignments must be routed) and the weight
    bytes a step reads (``_moe_weights``: the sites split the experts'
    bytes)."""
    import numpy as np
    import torch
    from repro_torch.distributed import pam_shard as psh
    from repro_torch.models.config import get_config
    group = cfg.n_heads // cfg.n_kv_heads
    published = get_config(cfg.name).n_layers
    out, base = dict(
        card=_card(), arch=cfg.name, n_layers=cfg.n_layers,
        reduced=([] if cfg.n_layers == published else
                 [f"n_layers {published} -> {cfg.n_layers}"]),
        heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.head_dim,
        group=group, vocab=cfg.vocab,
        weights=_moe_weights(cfg) if cfg.moe else _dense_weights(cfg)), None
    for g in SHARDS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        drops = _Drops(8) if cfg.moe is not None else None
        try:
            eng = _engine(cfg, params, 8, 64, max_batch=8, max_len=2048,
                          pool_blocks=SHARD_POOL, shard=g, **PAGED_RING)
            _warm_graphs(eng)
            walls, span_s = _steady_steps(eng)
            step = _step_events(eng.step)
            summ = eng.run()
        finally:
            dropped = drops.close() if drops is not None else None
        launches = _launches()
        if dropped is not None:
            assert dropped["decode"]["assignments"] > 0, dropped
        streams = [eng.requests[i].outputs for i in range(8)]
        assert [len(t) for t in streams] == [64] * 8, "lost tokens"
        assert summ["decode_dispatches"] == summ["decode_device_steps"]
        want = g * cfg.n_layers * eng.decode_body_steps
        _assert_decode_launches(launches, dict.fromkeys(DECODE_KERNELS[:2],
                                                        want))
        mine = _merged_instantiations(step, cfg.head_dim, group)
        _assert_device_decode_counts(mine, DECODE_CUDA_KERNELS,
                                     g * cfg.n_layers)
        base = base or streams
        same = sum(int(a == b) for s, t in zip(streams, base)
                   for a, b in zip(s, t))
        # each request's first token apart from shard 1's (64: none)
        apart = [next((i for i, (a, b) in enumerate(zip(s, t)) if a != b),
                      64) for s, t in zip(streams, base)]
        merge, mass = psh.merge_collective_bytes(
            cfg.n_layers, cfg.n_heads, cfg.head_dim, 8, smax=2048)
        out[f"shard_{g}"] = dict(
            decode_tok_s=summ["decode_tok_s"],
            steady_step_ms_median=float(np.median(walls)) * 1e3,
            steady_step_ms=[w * 1e3 for w in walls],
            replay_device_ms_per_step=span_s / len(walls) * 1e3,
            device_idle_share=1.0 - span_s / sum(walls),
            kernel_nodes=step["kernel_nodes"],
            graph_launches=step["graph_launches"],
            decode_kernels_per_replayed_step=mine,
            merge=_merge_ms(cfg, g) if g > 1 else None,
            params_bytes_per_device=eng.params_bytes_per_device(),
            merge_collective_bytes=merge if g > 1 else 0,
            mass_collective_bytes=mass if g > 1 else 0,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
            tokens_equal_to_shard_1=same / (8 * 64),
            first_token_apart_from_shard_1=apart,
            launches=launches, launches_expected=want,
            decode_body_steps=eng.decode_body_steps,
            decode_device_steps=summ["decode_device_steps"],
            sites=summ.get("sites", [str(eng.device)]),
            capture_ms_per_graph=eng.capture_seconds * 1e3
            / max(len(eng._graphs), 1), dropped=dropped)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


SHARD_PARITY_TOL = dict(atol=1e-5, rtol=1e-5)


def _site_attention_inputs(seed: int, B=3, H=4, Hkv=2, d=16, W=16,
                           smax=64, bs=8, nb1=24) -> dict:
    """One layer's ring and pool with the engine's tier split, fp32 on the
    card: ragged lengths (row 1 wraps the ring, row 2 has no live token),
    the hot mask inside the window, dead table entries on the
    sentinel."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    nb = smax // bs
    lens = (np.array([45, 60, 0]) if B == 3
            else rng.integers(W // 2, smax + 1, B))
    lens[2] = 0
    lens = lens.astype(np.int32)
    pos = np.arange(smax)[None]
    live = (rng.random((B, smax)) < 0.6) & (pos < lens[:, None])
    hot = live & (pos >= lens[:, None] - W) & (rng.random((B, smax)) < 0.7)
    pgd = live & ~hot
    block_live = pgd.reshape(B, nb, bs).any(-1)
    table = np.stack([rng.permutation(nb1 - 1)[:nb] for _ in range(B)])
    table = np.where(block_live, table, nb1 - 1).astype(np.int32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = dict(q=f(B, H, d), kc=f(B, Hkv, W, d), vc=f(B, Hkv, W, d),
             pk=f(nb1, bs, Hkv, d), pv=f(nb1, bs, Hkv, d), lens=lens,
             hot=hot, pgd=pgd, block_live=block_live, table=table)
    return {k: torch.from_numpy(v).cuda() for k, v in x.items()}


def _shard_parity_cfgs() -> dict:
    """shard_parity's reduced models by tag: qwen3-0.6b, qwen3-moe (4
    experts of 32, top-2) and internvl2-1b at vocabulary 255 (an odd
    vocabulary, as its published 151,655: the d-parallel embedding and the
    row-parallel tied head)."""
    from repro_torch.models.config import get_config, reduced
    return {"qwen3_0_6b": reduced(get_config("qwen3-0.6b")),
            "moe": reduced(get_config(MOE_ARCH)),
            "vlm_vocab255": dataclasses.replace(
                reduced(get_config(VLM_ARCH)), vocab=255)}


# one layer's sharded attention against the unsharded call, by tag: the
# reduced shapes, and B 8 at each sharded engine's heads (ring 256, pool
# 1,024 blocks of 16, a 2048-token window)
SHARD_ATTENTION = {
    "reduced": {},
    **{name: dict(B=8, H=heads[0], Hkv=heads[1], d=d, W=256, smax=2048,
                  bs=16, nb1=1024)
       for name, (heads, d) in (("qwen3_0_6b_heads", ((16, 8), 128)),
                                ("qwen3_moe_heads", ((64, 4), 128)),
                                ("internvl2_1b_heads", ((14, 2), 64)))}}


def phase_shard_parity() -> dict:
    """fp32 (TF32 off) on the card: reduced engines (``_shard_parity_cfgs``:
    qwen3-0.6b, qwen3-moe, internvl2-1b at vocabulary 255) at shard 2 and
    4 against shard 1 on the reference's sharded-engine config (pool 23
    blocks, ring 16, 3 requests of 20 prompt tokens and 10 new): greedy
    and sampled (temperature 1.0) streams equal; the merged decode
    wrappers shard x n_layers x the host-run body steps. Then one sharded
    attention call (``make_sharded_paged_decode_attn``) against the
    unsharded one (``make_paged_decode_attn``) on the same seeded layer
    at each ``SHARD_ATTENTION`` shape (the reduced one, and qwen3-0.6b's,
    qwen3-moe-235b-a22b's and internvl2-1b's heads: the wide path at
    groups 16 and 7): ``out`` and ``mass`` within atol 1e-5, rtol
    1e-5."""
    import numpy as np
    import torch
    from repro_torch.distributed import pam_shard as psh
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (EngineSpec, PAMManagerConfig, Request,
                                     ServingConfig)
    from repro_torch.serving import pam_manager as pm
    pam = PAMManagerConfig(max_tokens=64, hot_capacity=8, warm_capacity=16,
                           compression=4, recency_window=4,
                           schedule_interval=2)
    out = {"card": _card()}
    for tag, cfg in _shard_parity_cfgs().items():
        params = tf.init_params(cfg, 0, device="cuda")
        for name, kw in (("greedy", {}),
                         ("sampled", dict(temperature=1.0, sample_seed=11))):
            scfg = ServingConfig(pam=pam, max_batch=2, max_len=64,
                                 block_size=8, pool_blocks=23,
                                 hot_window=16, **kw)
            streams = {}
            for g in SHARDS:
                _reset_launches()
                eng = EngineSpec(model=cfg, serving=scfg, shard=g).build(
                    params, device="cuda")
                rng = np.random.default_rng(7)
                for i in range(3):
                    eng.submit(Request(i + 1, rng.integers(1, cfg.vocab,
                                                           20), 10))
                eng.run()
                want = g * cfg.n_layers * eng.decode_body_steps
                _assert_decode_launches(_launches(), dict.fromkeys(
                    DECODE_KERNELS[:2], want))
                streams[g] = {r: s.outputs for r, s in eng.requests.items()}
                assert eng.decode_dispatches == eng.decode_device_steps
            for g in SHARDS[1:]:
                assert streams[g] == streams[1], (
                    f"{tag} {name} shard {g} diverged")
            out[f"{tag}_{name}"] = dict(
                arch=cfg.name, vocab=cfg.vocab,
                tokens=sum(len(t) for t in streams[1].values()),
                equal_at=list(SHARDS[1:]))
        del params
    for tag, shape in SHARD_ATTENTION.items():
        x = _site_attention_inputs(3, **shape)
        args = (x["q"], x["kc"], x["vc"], x["pk"], x["pv"], x["lens"])
        ref = pm.make_paged_decode_attn(x["hot"], x["pgd"], x["table"],
                                        x["block_live"])(*args)
        for g in SHARDS[1:]:
            _reset_launches()
            got = psh.make_sharded_paged_decode_attn(
                psh.decode_sites(g, "cuda"), x["hot"], x["pgd"], x["table"],
                x["block_live"])(*args)
            torch.cuda.synchronize()
            n = _launches()
            assert (n["flash_decode_merged"] == g
                    and n["flash_decode_paged_merged"] == g), n
            errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
            for a, b, key in zip(got, ref, ("out", "mass")):
                torch.testing.assert_close(a, b, **SHARD_PARITY_TOL,
                                           msg=f"{tag} shard {g} {key}")
            out[f"attention_{tag}_shard_{g}"] = dict(
                heads=[x["q"].shape[1], x["kc"].shape[1]],
                head_dim=x["q"].shape[2], max_abs_err_out=errs[0],
                max_abs_err_mass=errs[1])
    out.update(tol=SHARD_PARITY_TOL, dtype="float32", tf32=False)
    return out


def _decode_rows(tag: str = "", heads=(16, 8), d: int = 128) -> dict:
    """Both decode kernels, stacked and merged, at ring S 256, S 2048 and
    the paged pool, for (H, Hkv) ``heads`` and head dim ``d``; keys end
    in ``tag``."""
    return {f"flash_decode_ring{tag}": kernel_flash_decode(256, False, heads,
                                                           d),
            f"flash_decode_2048{tag}": kernel_flash_decode(2048, False,
                                                           heads, d),
            f"flash_decode_paged{tag}": kernel_flash_decode_paged(False,
                                                                  heads, d),
            f"flash_decode_merged_ring{tag}": kernel_flash_decode(256, True,
                                                                  heads, d),
            f"flash_decode_merged_2048{tag}": kernel_flash_decode(2048, True,
                                                                  heads, d),
            f"flash_decode_paged_merged{tag}": kernel_flash_decode_paged(
                True, heads, d)}


# qwen3-moe-235b-a22b's attention: 64 query heads over 4 kv heads (GQA
# group 16), the decode kernels' wide path; its kernels-phase rows end in
# ``_g16``
G16_HEADS = (64, 4)


def _engine_phase(arch: str) -> str:
    return "engine_" + arch.replace("-", "_").replace(".", "_")


def phase_kernels() -> dict:
    out = _decode_rows()
    out.update(_decode_rows("_g16", G16_HEADS))
    for arch, (_, tag, _) in WIDE_DENSE.items():
        H, Hkv, d = _wide_heads(arch)
        out.update(_decode_rows(tag, (H, Hkv), d))
    # zamba2-7b's attention (32 q / 32 kv heads of 112): the merged dense
    # kernel its engine runs, and the merged paged one (no path: the
    # hybrid refuses pools)
    H, Hkv, d = _wide_heads(HYBRID_ARCH)
    out[f"flash_decode_merged_2048{D112}"] = kernel_flash_decode(
        2048, True, (H, Hkv), d)
    out[f"flash_decode_paged_merged{D112}"] = kernel_flash_decode_paged(
        True, (H, Hkv), d)
    for S, causal in ((TRAIN_S, True), (1000, False)):
        r = kernel_flash_attention(S, causal)
        tag = "2048" if causal else "ragged_1000_noncausal"
        out[f"flash_attention_{tag}"] = r["fwd"]
        out[f"flash_attention_bwd_{tag}"] = r["bwd"]
    # the tf32x3 variant at its main path's shape (train_parity: fp32,
    # B 2, S 500, causal)
    r = kernel_flash_attention(PARITY_S, True, B=PARITY_B, dtype="float32")
    out["flash_attention_fp32_500"] = r["fwd"]
    out["flash_attention_bwd_fp32_500"] = r["bwd"]
    # the train pairs of the vlm, audio and wider dense families: bf16
    # forward and backward through the wgmma kernels at each train_*
    # phase's attention shape (internvl2-1b's (64, 7) causal at B 4 x
    # (256 patches + 1792 tokens), hubert-xlarge's (80, 1) bidirectional
    # at B 8 x 1500 frames: a ragged last tile; the wider dense models at
    # their phases' batch x 2048), and fp32 through the tf32x3 kernels
    # at their train_parity_* shape (B 2, S 500)
    for arch, (tag, causal) in TRAIN_ROWS.items():
        H, Hkv, d = _wide_heads(arch)
        _, B, S = TRAIN_FAMILIES[arch]
        S += _family_cfg(arch, None).num_patches      # the vlm's patches
        r = kernel_flash_attention(S, causal, B, "bfloat16", (H, Hkv), d)
        fwd_key, bwd_key = _attn_keys(arch)
        out[fwd_key], out[bwd_key] = r["fwd"], r["bwd"]
        r = kernel_flash_attention(PARITY_S, causal, PARITY_B, "float32",
                                   (H, Hkv), d)
        fwd_key, bwd_key = _attn_keys(arch, fp32=True)
        out[fwd_key], out[bwd_key] = r["fwd"], r["bwd"]
    # the forward alone in fp32 through the tf32x3 kernel at
    # vlm_audio_parity's shapes (B 2; 4 patches + 96 tokens at 14 / 2
    # heads of 64, 150 frames at 4 / 4 of 80)
    H, Hkv, d = _wide_heads(VLM_ARCH)
    out[ATTN_FP32_ROWS[VLM_ARCH]] = kernel_flash_attention_fwd(
        100, True, 2, (H, Hkv), d, "float32")
    H, Hkv, d = _wide_heads(AUDIO_ARCH)
    out[ATTN_FP32_ROWS[AUDIO_ARCH]] = kernel_flash_attention_fwd(
        150, False, 2, (4, 4), d, "float32")
    out.update(kernel_ssd_scan())
    # flash_attention on a train grid's site: qwen3-0.6b's heads over 2 and
    # 4 model sites (8 / 4 and 4 / 2 of 128), bf16 through the wgmma
    # kernels at the train shape
    for key, (heads, _) in SITE_ATTN_ROWS.items():
        r = kernel_flash_attention(TRAIN_S, True, TRAIN_B, "bfloat16", heads)
        out[key] = r["fwd"]
        out[key.replace("flash_attention_", "flash_attention_bwd_")] = r[
            "bwd"]
    # the sharded engines' site slices: the ring kernel on a view of 128
    # and 64 of 256 slots, the paged kernel on 512 and 256 of 1,024 blocks,
    # at each sharded engine's heads
    for key, (kind, n, start, tag) in SITE_ROWS.items():
        _, heads, d = SITE_HEADS[tag]
        out[key] = (kernel_flash_decode_site(n, start, heads, d)
                    if kind == "ring" else
                    kernel_flash_decode_paged_site(n, start, heads, d))
    return out


# the stacked (reference-contract) rows of the kernels phase, by the
# merged row that launches the same CUDA kernel on the serving path
STACKED_ROWS = {"flash_decode_merged_ring": "flash_decode_ring",
                "flash_decode_merged_2048": "flash_decode_2048",
                "flash_decode_paged_merged": "flash_decode_paged",
                "flash_decode_merged_ring_g16": "flash_decode_ring_g16",
                "flash_decode_merged_2048_g16": "flash_decode_2048_g16",
                "flash_decode_paged_merged_g16": "flash_decode_paged_g16",
                **{f"{merged}{tag}": f"{stacked}{tag}"
                   for _, tag, _ in WIDE_DENSE.values()
                   for merged, stacked in (
                       ("flash_decode_merged_ring", "flash_decode_ring"),
                       ("flash_decode_merged_2048", "flash_decode_2048"),
                       ("flash_decode_paged_merged", "flash_decode_paged"))}}


# ------------------------------------------------------------------ main
def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    failed: list[str] = []
    results: dict = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        try:
            res = fn(*args)
            results[name] = res
            emit(name, ok=True, seconds=time.perf_counter() - t0, **res)
            return res
        except Exception as exc:           # report the phase, go on
            failed.append(name)
            trace = traceback.format_exc()[-2000:]
            emit(name, ok=False, error=repr(exc), trace=trace)
            print(f"chip_smoke: phase {name} failed:\n{trace}",
                  file=sys.stderr)
            return None
        finally:
            # a phase's engines can sit in reference cycles (the margin
            # hooks); free their device memory before the next phase
            gc.collect()

    env = run("env", phase_env)
    run("build", phase_build)
    kernels = run("kernels", phase_kernels)
    if kernels is not None:
        bad = [k for k, v in kernels.items() if not v["ok"]]
        if bad:
            failed.append("kernels")
            emit("kernels", ok=False, error=f"outside tolerance: {bad}")
            for k in bad:
                print(f"chip_smoke: kernel {k} outside tolerance: max_abs_err"
                      f" {kernels[k]['max_abs_err']}, tol {kernels[k]['tol']}",
                      file=sys.stderr)
    run("pam_core", phase_pam_core)
    torch.cuda.empty_cache()
    model = None
    try:
        model = _model("bfloat16")
    except Exception as exc:
        failed.append("model")
        emit("model", ok=False, error=repr(exc))
    if model is not None:
        run("engine_paged_ring", phase_engine_paged, *model)
        run("engine_paged_ring_full", phase_engine_paged_full, *model)
        run("engine_dense_pam", phase_engine_dense, *model)
        run("engine_cluster", phase_engine_cluster, *model)
        run("engine_chaos", phase_engine_chaos, *model)
        run("serve_frontend", phase_serve_frontend, *model)
        run("engine_prefix_chunk_sampled",
            phase_engine_prefix_chunk_sampled, *model)
        run("engine_sharded", phase_engine_sharded, *model)
    moe = None
    try:            # qwen3-moe-235b-a22b at full width, MOE_LAYERS deep
        moe = _model("bfloat16", MOE_ARCH, MOE_LAYERS)
    except Exception as exc:
        failed.append("model_moe")
        emit("model_moe", ok=False, error=repr(exc))
    if model is not None:
        run("decode_graph", phase_decode_graph, *model, moe)
        run("profile", phase_profile, *model)
        run("profile_prefix_chunk_sampled",
            phase_profile_prefix_chunk_sampled, *model)
        del model
    if moe is not None:
        run("engine_moe", phase_engine_moe, *moe)
        run("engine_sharded_moe", phase_engine_sharded, *moe)
        del moe
    torch.cuda.empty_cache()
    run("moe_parity", phase_moe_parity)
    torch.cuda.empty_cache()
    for arch, (n_layers, _, _) in WIDE_DENSE.items():  # one model at once
        wide = None
        try:
            wide = _model("bfloat16", arch, n_layers)
        except Exception as exc:
            failed.append(f"model_{arch}")
            emit(f"model_{arch}", ok=False, error=repr(exc))
        if wide is not None:
            run(_engine_phase(arch), phase_engine_served, *wide)
            # sparsity off: the pool tiers are read, so the model's paged
            # kernel walks live blocks
            run(_engine_phase(arch) + "_full_pool", phase_engine_paged_full,
                *wide)
            if arch == VLM_ARCH:     # its patch prefix: forward, prefill
                run("vlm_forward", phase_vlm_forward, *wide)
                run("engine_sharded_vlm", phase_engine_sharded, *wide)
            del wide
        gc.collect()
        torch.cuda.empty_cache()
    run("gqa_parity", phase_gqa_parity)
    torch.cuda.empty_cache()
    audio = None
    try:            # hubert-xlarge at full width and depth
        audio = _model("bfloat16", AUDIO_ARCH)
    except Exception as exc:
        failed.append("model_audio")
        emit("model_audio", ok=False, error=repr(exc))
    if audio is not None:
        run(ENCODER_PHASE, phase_encoder, *audio)
        del audio
    gc.collect()
    torch.cuda.empty_cache()
    run("vlm_audio_parity", phase_vlm_audio_parity)
    torch.cuda.empty_cache()
    mla = None
    try:            # deepseek-v2-lite-16b at full width and depth
        mla = _model("bfloat16", MLA_ARCH)
    except Exception as exc:
        failed.append("model_mla")
        emit("model_mla", ok=False, error=repr(exc))
    if mla is not None:
        run(_engine_phase(MLA_ARCH), phase_engine_moe, *mla, {}, True)
        del mla
    gc.collect()
    torch.cuda.empty_cache()
    run("mla_parity", phase_mla_parity)
    torch.cuda.empty_cache()
    hybrid = None
    try:            # zamba2-7b at full width and depth
        hybrid = _model("bfloat16", HYBRID_ARCH)
    except Exception as exc:
        failed.append("model_hybrid")
        emit("model_hybrid", ok=False, error=repr(exc))
    if hybrid is not None:
        run(_engine_phase(HYBRID_ARCH), phase_engine_served, *hybrid,
            _hybrid_weights(hybrid[0]), {})
        del hybrid
    gc.collect()
    torch.cuda.empty_cache()
    run("hybrid_parity", phase_hybrid_parity)
    torch.cuda.empty_cache()
    for arch in TRAIN_FAMILIES:        # one model on the card at a time
        run(_train_phase(arch), phase_train_family, arch)
        torch.cuda.empty_cache()
        if arch in PROFILE_FAMILIES:
            run("profile_" + _train_phase(arch), phase_profile_train, arch)
            torch.cuda.empty_cache()
        if arch in TRAIN_ROWS:         # a kernel on its train path
            run(_train_phase(arch, parity=True), phase_train_parity, arch,
                _parity_depth(arch))
            torch.cuda.empty_cache()
    run("train", phase_train)
    torch.cuda.empty_cache()
    run("profile_train", phase_profile_train)
    torch.cuda.empty_cache()
    run("train_parity", phase_train_parity)
    torch.cuda.empty_cache()
    run("train_sharded", phase_train_sharded)
    torch.cuda.empty_cache()
    run("train_shard_parity", phase_train_shard_parity)
    torch.cuda.empty_cache()
    run("pipeline", phase_pipeline)
    torch.cuda.empty_cache()
    run("parity", phase_parity)
    torch.cuda.empty_cache()
    run("shard_parity", phase_shard_parity)
    torch.cuda.empty_cache()
    run("prefix_chunk_parity", phase_prefix_chunk_parity)
    torch.cuda.empty_cache()
    run("cluster_parity", phase_cluster_parity)
    torch.cuda.empty_cache()
    run("chaos_parity", phase_chaos_parity)
    torch.cuda.empty_cache()
    run("train_ssm", phase_train, SSM_ARCH)
    torch.cuda.empty_cache()
    run("profile_train_ssm", phase_profile_train, SSM_ARCH)
    torch.cuda.empty_cache()
    run("train_parity_ssm", phase_train_parity, SSM_ARCH)
    torch.cuda.empty_cache()
    ssm = None
    try:
        ssm = _model("bfloat16", SSM_ARCH)
    except Exception as exc:
        failed.append("model_ssm")
        emit("model_ssm", ok=False, error=repr(exc))
    if ssm is not None:
        run("engine_ssm", phase_engine_ssm, *ssm)
        run("profile_ssm", phase_profile, *ssm, {}, None, ())
        del ssm

    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    paged_run = results["engine_paged_ring"]["launches"]
    dense_run = results["engine_dense_pam"]["launches"]
    train_run = results["train"]["launches"]
    fp32_run = results["train_parity"]["launches"]
    ssm_run = results["train_ssm"]["launches"]
    ssm_fp32_run = results["train_parity_ssm"]["launches"]
    moe_run = results["engine_moe"]["launches"]
    rows = []

    def add_row(key, src, replaces, launches, name=None):
        k = kernels[key]
        tag = next((t for t in ("_g16", D112,
                                *(w[1] for w in WIDE_DENSE.values()))
                    if key.endswith(t)), "")
        row = dict(
            name=name or k["name"] + tag, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/{replaces}",
            launches=launches, max_abs_err=k["max_abs_err"],
            ms=k["ms"], kernel_device_ms=k["kernel_device_ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"])
        for extra in ("S", "split", "variant", "dtype", "tflops", "causal",
                      "pct_of_bound", "executed_tflops", "sdpa_max_abs_err",
                      "H", "Hkv", "d", "ms_spread", "library_ms_spread",
                      "library_ms_fwd_bwd_spread", "library_repeats",
                      "max_abs_err_vs_model", "bound_fp32_fma_ms",
                      "pct_of_fp32_fma_bound", "bit_equal_across_calls",
                      "library_device_ms", "f64_rel_err_and_plain"):
            if extra in k:
                row[extra] = k[extra]
        stacked = STACKED_ROWS.get(key)
        if stacked:             # the same CUDA kernel, reference contract
            row["stacked"] = {
                f: kernels[stacked][f] for f in (
                    "max_abs_err", "ms", "kernel_device_ms", "bound_ms",
                    "pct_of_bound")}
        rows.append(row)
        return row

    for key, src, replaces, launches in (
            ("flash_decode_merged_ring", "flash_decode.cu",
             "flash_decode.py:98", paged_run["flash_decode_merged"]),
            ("flash_decode_merged_2048", "flash_decode.cu",
             "flash_decode.py:98", dense_run["flash_decode_merged"]),
            ("flash_decode_paged_merged", "flash_decode_paged.cu",
             "flash_decode.py:202", paged_run["flash_decode_paged_merged"]),
            ("flash_attention_2048", "flash_attention_sm90.cu",
             "flash_attention.py:31", train_run["flash_attention"]),
            ("flash_attention_bwd_2048", "flash_attention_bwd_sm90.cu",
             "flash_attention.py:31", train_run["flash_attention_bwd"]),
            ("flash_attention_fp32_500", "flash_attention_tf32x3.cu",
             "flash_attention.py:31", fp32_run["flash_attention"]),
            ("flash_attention_bwd_fp32_500", "flash_attention_bwd_tf32x3.cu",
             "flash_attention.py:31", fp32_run["flash_attention_bwd"]),
            ("ssd_scan", "ssd_scan_sm90.cu", "ssd_scan.py:36",
             ssm_run["ssd_scan"]),
            ("ssd_scan_bwd", "ssd_scan_bwd_sm90.cu", "ssd_scan.py:36",
             ssm_run["ssd_scan_bwd"]),
            ("ssd_scan_fp32_500", "ssd_scan_tf32x3.cu", "ssd_scan.py:36",
             ssm_fp32_run["ssd_scan"]),
            ("ssd_scan_bwd_fp32_500", "ssd_scan_bwd_tf32x3.cu",
             "ssd_scan.py:36", ssm_fp32_run["ssd_scan_bwd"]),
            ("flash_decode_merged_ring_g16", "flash_decode.cu",
             "flash_decode.py:98", moe_run["flash_decode_merged"]),
            ("flash_decode_paged_merged_g16", "flash_decode_paged.cu",
             "flash_decode.py:202", moe_run["flash_decode_paged_merged"])):
        add_row(key, src, replaces, launches)
    rows[1]["launches_in"] = "engine_dense_pam"
    for row, name in ((rows[5], "flash_attention"),
                      (rows[6], "flash_attention_bwd")):
        row["tf32x3_launches"] = results["train_parity"][
            "tf32x3_launches"][name]
    for row, name in ((rows[9], "ssd_scan"), (rows[10], "ssd_scan_bwd")):
        row["tf32x3_launches"] = results["train_parity_ssm"][
            "tf32x3_launches"][name]
    dg = results["decode_graph"]
    rows[1]["launches_decode_graph"] = dg["dense_launches"][
        "flash_decode_merged"]
    # executions on the card, from torch.profiler: one replayed step of
    # decode_graph's graph twins, and the profile phase's 4 replayed steps
    rows[1]["device_launches_decode_graph_step"] = dg[
        "dense_single_step_graph"]["decode_kernels_on_device"][
        DECODE_CUDA_KERNELS[0]]
    for row, kern in ((rows[0], DECODE_CUDA_KERNELS[0]),
                      (rows[2], DECODE_CUDA_KERNELS[1])):
        row["device_launches_decode_graph_step"] = dg["single_step_graph"][
            "decode_kernels_on_device"][kern]
        on_device = results["profile"]["decode_kernels_on_device"]
        row["device_launches_profile"] = (
            on_device[kern] if isinstance(on_device, dict) else on_device)
    pam = results["pam_core"]["launches"]
    rows[0]["launches_pam_core"] = pam["flash_decode_merged"]
    rows[2]["launches_pam_core"] = pam["flash_decode_paged_merged"]
    pcs = results["engine_prefix_chunk_sampled"]["launches"]
    for row, name in ((rows[0], "flash_decode_merged"),
                      (rows[2], "flash_decode_paged_merged")):
        row["launches_engine_prefix_chunk_sampled"] = pcs[name]
        for phase in ("engine_cluster", "engine_chaos", "serve_frontend",
                      "decode_graph"):
            row[f"launches_{phase}"] = results[phase]["launches"][name]
    moe_step = results["engine_moe"]["replayed_step"]
    moe_twins = results["decode_graph"]["moe_greedy"]["launches"]
    for row, name, kern in ((rows[-2], "flash_decode_merged",
                             DECODE_CUDA_KERNELS[0]),
                            (rows[-1], "flash_decode_paged_merged",
                             DECODE_CUDA_KERNELS[1])):
        row["launches_in"] = "engine_moe"
        row["device_launches_engine_moe_step"] = moe_step[
            "decode_kernels_on_device"][kern]
        row["launches_decode_graph_moe"] = moe_twins[name]
        row["launches_moe_parity_group16"] = results["moe_parity"][
            "group16"]["launches"][name]
    # the wider dense family: launches from each model's engine phases, and
    # the card's executions in its profiled replayed step
    for arch, (_, tag, _) in WIDE_DENSE.items():
        wide = results[_engine_phase(arch)]
        full = results[_engine_phase(arch) + "_full_pool"]
        for key, src, replaces, name, kern in (
                (f"flash_decode_merged_ring{tag}", "flash_decode.cu",
                 "flash_decode.py:98", "flash_decode_merged",
                 DECODE_CUDA_KERNELS[0]),
                (f"flash_decode_paged_merged{tag}", "flash_decode_paged.cu",
                 "flash_decode.py:202", "flash_decode_paged_merged",
                 DECODE_CUDA_KERNELS[1])):
            row = add_row(key, src, replaces, wide["launches"][name])
            row["launches_in"] = _engine_phase(arch)
            row[f"device_launches_{_engine_phase(arch)}_step"] = wide[
                "merged_kernels_on_device"][kern]
            row[f"launches_{_engine_phase(arch)}_full_pool"] = full[
                "launches"][name]
            row["launches_gqa_parity"] = results["gqa_parity"][arch][
                "launches"][name]
    # the hybrid family: zamba2-7b's merged dense kernel from its engine
    # phase and hybrid_parity's head-dim-112 variant; the paged one lies
    # on no path (the hybrid refuses pools)
    hyb = results[_engine_phase(HYBRID_ARCH)]
    row = add_row(f"flash_decode_merged_2048{D112}", "flash_decode.cu",
                  "flash_decode.py:98",
                  hyb["launches"]["flash_decode_merged"])
    row["launches_in"] = _engine_phase(HYBRID_ARCH)
    row[f"device_launches_{_engine_phase(HYBRID_ARCH)}_step"] = hyb[
        "merged_kernels_on_device"][DECODE_CUDA_KERNELS[0]]
    row["launches_hybrid_parity_d112"] = sum(
        results["hybrid_parity"][f"d112_micro_steps_{k}"]["launches"][
            "flash_decode_merged"] for k in (1, 4))
    row = add_row(f"flash_decode_paged_merged{D112}", "flash_decode_paged.cu",
                  "flash_decode.py:202",
                  hyb["launches"]["flash_decode_paged_merged"])
    row["note"] = ("on no model's path: the hybrid family refuses paged "
                   "pools, as the reference does; built from the shared "
                   "(head dim, group) list and held to its plain version")
    # the train pairs of the vlm, audio and wider dense families: bf16
    # forward and backward (the wgmma kernels) with launches from each
    # train_* phase, fp32 (the tf32x3 kernels) from its train_parity_*
    # phase; internvl2-1b's and hubert-xlarge's forwards also run in
    # vlm_forward and the encoder phase, and in fp32 at vlm_audio_parity's
    # shapes
    vap = results["vlm_audio_parity"]
    for arch, (tag, _) in TRAIN_ROWS.items():
        train = results[_train_phase(arch)]
        parity = results[_train_phase(arch, parity=True)]
        for key, src, name in zip(_attn_keys(arch), (
                "flash_attention_sm90.cu", "flash_attention_bwd_sm90.cu"),
                ATTN_TRAIN_KERNELS):
            row = add_row(key, src, "flash_attention.py:31",
                          train["launches"][name], name=name + tag)
            row["launches_in"] = _train_phase(arch)
            row["wgmma_launches"] = train["wgmma_launches"][name]
            row["max_abs_err_vs_rounded"] = kernels[key][
                "max_abs_err_vs_rounded"]
        for key, src, name in zip(_attn_keys(arch, fp32=True), (
                "flash_attention_tf32x3.cu", "flash_attention_bwd_tf32x3.cu"),
                ATTN_TRAIN_KERNELS):
            row = add_row(key, src, "flash_attention.py:31",
                          parity["launches"][name],
                          name=name + tag + "_fp32_train")
            row["launches_in"] = _train_phase(arch, parity=True)
            row["tf32x3_launches"] = parity["tf32x3_launches"][name]
    # zamba2-7b's Mamba-2 layers: the SSD scan at d_state 64, bf16 (wgmma)
    # with launches from train_zamba2_7b, fp32 (tf32x3) from
    # train_parity_zamba2_7b
    for key, src in (("ssd_scan_n64", "ssd_scan_sm90.cu"),
                     ("ssd_scan_bwd_n64", "ssd_scan_bwd_sm90.cu"),
                     ("ssd_scan_fp32_500_n64", "ssd_scan_tf32x3.cu"),
                     ("ssd_scan_bwd_fp32_500_n64",
                      "ssd_scan_bwd_tf32x3.cu")):
        phase = _train_phase(HYBRID_ARCH, parity="fp32" in key)
        name = "ssd_scan_bwd" if "_bwd" in key else "ssd_scan"
        row = add_row(key, src, "ssd_scan.py:36",
                      results[phase]["launches"][name], name=key)
        row["launches_in"] = phase
        kind = "tf32x3_launches" if "fp32" in key else "wgmma_launches"
        row[kind] = results[phase][kind][name]
    for arch, phase, case in ((VLM_ARCH, "vlm_forward", "vlm_g7"),
                              (AUDIO_ARCH, ENCODER_PHASE, "audio_d80")):
        tag = TRAIN_ROWS[arch][0]
        row = next(r for r in rows if r["name"] == "flash_attention" + tag)
        row[f"launches_{phase}"] = results[phase]["launches"][
            "flash_attention"]
        row[f"wgmma_launches_{phase}"] = results[phase]["wgmma_launches"][
            "flash_attention"]
        row = add_row(ATTN_FP32_ROWS[arch], "flash_attention_tf32x3.cu",
                      "flash_attention.py:31",
                      vap[case]["launches"]["flash_attention"],
                      name="flash_attention" + tag + "_fp32")
        row["launches_in"] = "vlm_audio_parity"
        row["tf32x3_launches"] = vap[case]["tf32x3_launches"]
    # the sharded engines' site slices: launches from the sharded engine
    # phase of the row's heads, at the shard whose slice the row takes
    # (ring 128 / pool 512 of 2 sites, ring 64 / pool 256 of 4)
    for key, (kind, n, start, tag) in SITE_ROWS.items():
        phase = SITE_HEADS[tag][0]
        sharded = results[phase]
        g = (SITE_RING if kind == "ring" else SHARD_POOL + 1) // n
        name = DECODE_KERNELS[0 if kind == "ring" else 1]
        row = add_row(key, "flash_decode.cu" if kind == "ring"
                      else "flash_decode_paged.cu",
                      "flash_decode.py:98" if kind == "ring"
                      else "flash_decode.py:202",
                      sharded[f"shard_{g}"]["launches"][name], name=key)
        row.update(launches_in=f"{phase} shard {g}",
                   device_launches_engine_sharded_step=sharded[
                       f"shard_{g}"]["decode_kernels_per_replayed_step"][
                       DECODE_CUDA_KERNELS[0 if kind == "ring" else 1]],
                   **{f: kernels[key][f] for f in (
                       "start", "block_offset", "nb_local",
                       "view_rows_per_head") if f in kernels[key]})
    # flash_attention on a train grid's site slice of the heads: launches
    # from train_sharded's grid at those heads (1 x 2: 8 / 4, 1 x 4: 4 / 2),
    # and from the 2 x 2 grids (8 / 4 heads at B 2 a replica)
    grids = results["train_sharded"]["grids"]
    for key, (_, grid_key) in SITE_ATTN_ROWS.items():
        bwd_key = key.replace("flash_attention_", "flash_attention_bwd_")
        for k, src, name in ((key, "flash_attention_sm90.cu",
                              "flash_attention"),
                             (bwd_key, "flash_attention_bwd_sm90.cu",
                              "flash_attention_bwd")):
            row = add_row(k, src, "flash_attention.py:31",
                          grids[grid_key]["attention_launches"][name],
                          name=k)
            row["launches_in"] = f"train_sharded {grid_key}"
            row["wgmma_launches"] = grids[grid_key]["wgmma_launches"][name]
            if grid_key == "1x2":
                for other in ("2x2", "2x2_fsdp"):
                    row[f"launches_train_sharded_{other}"] = grids[other][
                        "attention_launches"][name]
    rows[3]["launches_pipeline"] = results["pipeline"][
        "flash_attention_launches"]
    for row in rows:
        if "_bwd" in row["name"]:
            row["note"] = (f"gradient of {row['name'].split('_bwd')[0]}; "
                           f"the TPU package has no backward kernel (JAX "
                           f"cannot differentiate the Pallas call)")
    print(env["nvidia_smi"])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
