#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one JSON line each:

1. env      the card (nvidia-smi name and power limit), torch and CUDA.
2. build    builds the five CUDA kernel libraries from ``src/repro_torch/
            kernels/csrc`` (the three kernels, and the bf16 instances of
            attention and decode in their own sources; one nvcc each, in
            parallel); seconds per library and the compiler's register /
            spill report.
3. kernel   each kernel against its plain PyTorch version on the card, at
            the main path's shapes and over an edge sweep (ragged M and
            Nq, GQA groups 1/3/12 and a folded 64, dead rows, g = 0
            columns, causal off, window, prefix; whole attention tiles
            invisible to a query tile, a window that drops early tiles,
            shuffled PRISM columns; decode columns off the 64-column
            pass, warps with no live column, groups of 40 and 128 heads;
            the decode kernel's two tick layouts at full width: a chunk's
            64·12 queries folded into the head axis over the whole cache
            rows at offsets 0, 64, 448 and staggered, and a packed tick
            of T = 72 (decode and prompt tokens, several per slot, dead
            entries) through the row map, exact and prism passes; each
            main-path layout again over a page pool of 4-column pages
            under a permuted page table, with unmapped tail pages and a
            state pool through a means-row map, every page and state row
            that nothing maps holding NaN; the row map with repeats,
            every entry equal, entries out of range (clamped), T = 1,
            7, 9, 13, 30, rep 1, 2 and 4; the decode kernel's tile
            route (a group of at least 4 query heads a KV head and no
            row map: the chunk layouts and the
            sweep's groups of 4 to 128 take it, each call checked to
            take the route the wrapper's rule names; every case
            without a row map also runs the other route) and its own
            cases: means with g = 0 in whole tiles at a group of 64, a
            row whose only live column ends a ragged local or means
            tile, groups of 4 (the threshold) and 3, 16 alone and over
            12 KV heads, rep 1 and 4; a poisoned page (one mapped page
            of the static decode, packed and chunk layouts NaN-filled):
            exactly the rows that read it come out non-finite, on the
            route the rule names and (without a row map) the other, and
            every other row matches the plain version; the degraded
            step's configurations (sequence shard 1 lost: its lane's
            exact columns dead; exact mode with the standby replica's
            means live on that lane only, prism mode with the lost
            shard's own means opened), dense and over the page pool,
            timed against their bound, the library call and the healthy
            decode layout;
            then head dim 128 (the Llama family; ``check_head_dim_128``):
            attention at Yi-6B's PRISM and Voltage shapes and GQA groups
            1, 3 and 8 over ragged Nq and M, the decode kernel at Yi's
            static decode (a group of 8, no row map: the tile route, the
            row route beside it), chunk and packed layouts, over the page
            pool, a poisoned page and a sweep of both routes, segment
            means and the augment at D 4096;
            then head dim 256 (Gemma 3 1B; ``check_head_dim_256``):
            attention at its global PRISM, global Voltage and local
            (windowed) shapes at a 2048-token prompt, GQA groups 1, 3
            and 4 over ragged Nq and M and a window that drops whole
            early tiles with halo columns at g = 0; the decode kernel at
            its global static layout (exact and prism) and its ring
            (``valid`` wrapped), both routes timed, and a sweep of both
            routes; segment means and the augment at D 1152; segment
            means and the fused PRISM augment in f32 and bf16 over
            ragged segments, L = 1 and L = N, D = 33 and 5, P = 1/2/4
            and a misaligned base); the largest error beside the stated
            tolerance and the largest share of it a kernel used
            (``tol_share``), and the times of kernel, plain version,
            library call and the bound (the attention and decode
            kernels' operations at the 3xTF32 tensor-core rate, segment
            means' at f32 FMA's); the chunk layout's library call both at its
            natural (B·P, Hq, C) shape and folded as the kernel sees it;
            both decode routes at the chunk layout and, for the
            crossover, at its cache rows with folded groups of 1, 2, 4,
            8, 16, 32, 40, 64 and 128 query heads a KV head.
            Then the attention kernel at head dim 32, the accuracy
            protocol's char-LM (``check_charlm_kernels``: 4 heads of 32,
            B 16 x 120 at CR 4 over P 2, 3 and 4 in prism, prism_nodup
            and voltage; duplicate runs prism's columns), each layout
            checked and timed, and the means kernel's two entries at
            its D 128 for every (P, CR) the protocol scores, timed at
            CR 4.
            Then the bf16, mixed-dtype and head-dim 16 / 32 cases
            (``check_bf16_kernels``): bf16 attention at head dims 16,
            32, 64, 80, 128 and 256 over the edge sweep, f32 at 16; the
            decode kernel over a bf16 cache at every head dim, on both
            routes, with and without means, dense, paged and through a
            row map; a bf16 query over an f32 cache at the engine's
            layouts (packed, its prism pass, the chunk call; dense and
            paged); f32 decode at 16 and 32.  bf16 holds to the
            reference's own tolerance (``TOL_BF16_KERNEL``) on draws
            whose outputs are O(1) (``peaked``: V of std 1, rows that
            see few columns), the rest to ``TOL``; each timed at a path's layout (GPT-2's, Yi-6B's,
            Gemma 7B's; bf16 bytes and the bf16 tensor-core rate in the
            bound; the library calls in bf16).
            Times are event pairs (``ms``, over a floor of about 5 us,
            ``floor_ms``) and, for the kernels, the profiler's kernel
            durations (``device_ms``).
4. path     GPT-2 small at full width and depth, random weights from
            torch.Generator seed 0, B = 8, prompt 512, 64 generated
            tokens, P = 4 sequence shards, CR 4, through
            ``repro_torch.launch.serve`` in both pairings: voltage prefill
            + exact decode (checked against the plain full forward), PRISM
            prefill + prism decode (checked against the same run with
            backend='plain').  Launch counters are zeroed just before the
            run and read just after; every kernel must have launched as
            often as the path requires (the decode kernel's tile route,
            counted apart as ``flash_decode_stats.mq``, 0 times).
   trace    after each pairing, torch.profiler over one prefill and 8
            decode steps: device busy time, idle share and time by
            kernel class.
5. path     the engine's tick programs at the same shape, each decode
            mode, the launch counters zeroed before each run:
            ``chunked``: chunked prefill of 64 tokens a call, row i
            admitted at call i // 2, the rewind, 63 greedy decode
            steps; its cache after the last chunk and its logits held
            to the monolithic Voltage prefill (exact: ``generate``;
            prism: the same rewind and prism decode steps); each chunk
            call's decode-kernel launches take the tile route (12 a
            call, 132 a run, ``flash_decode_stats.mq``), the decode
            steps the row route.
            ``packed``: every slot admitted at once, ticks of 72 tokens
            planned as ``FifoScheduler.plan_tick`` plans them, greedy
            through ``pack`` / ``merge`` (timed, launches counted; no
            tile route: a row map takes the row route); its logits held
            to the chunked path's at every step by a run teacher-forced
            on the chunked path's tokens.
   trace    per mode, torch.profiler over one chunk call and one packed
            tick with decode and prompt tokens.
6. path     the serving engine (``ServingEngine``) at the same shape: 8
            slots, prefill 512, cap 576, 16-token pages (36 a row, 288 in
            the pool), ticks of 72 tokens, chunks of 64; 16 requests from
            a seeded rng, prompts of 64-512 tokens, the even 8 beginning
            with one shared 256-token system prompt, 64 greedy tokens
            each, all submitted at t = 0.  In packed exact, packed prism
            and chunked exact, each on the paged cache and on the dense
            one: per request, while the tokens agree, logits within
            1e-4 of the dense run's largest |logit|, tokens equal where
            its top-2 gap is clear (at most 2 of 16 may part at a
            near-tie); exact mode's prefix cache must hit, and every page
            be free or held by a prefix entry; every decode-kernel launch
            of a paged run goes through the page table.  Wall time,
            tokens/s, time to first token and ms per tick on the host
            clock.
   trace    per mode, one mixed packed tick on the paged cache and the
            same tick on the dense cache.
7. path     the engine's host offload tier, preemption, faults and
            snapshots at the same shape, packed ticks, pool of 144 pages
            (half of phase 6's), ``offload=True``; the even 8 prompts at
            priority 0 at t = 0, the odd 8 at priority 1 after the
            engine's 20th step.  (a) ``pressure``, exact and prism: each
            request's tokens and logits held to phase 6's paged run of
            its mode under phase 6's rules; preemptions, restore hits
            and no restore miss required.  (c) ``snapshot``: (a)'s
            engine snapshotted after step 40 and restored into a fresh
            engine, run to the end: tokens equal to (a)'s.  (b)
            ``chaos``, exact: every fault kind but shard_loss at a fixed
            opportunity (a lost spill, a torn store read, a poisoned
            page, a stalled admission, a delayed tick): every request
            finished or failed, those finished held to (a)'s exact run,
            a quarantine and a restart required.  Every run drains
            leak-free (refcounts, pages, store).  Per run: wall time,
            tokens/s, TTFT, ms per tick, the preemption and recovery
            counters, and spill and restore times (host clock, the card
            synchronised around each; median ms and MB a request, MB/s
            over the bytes moved).
8. path     the rest of the serving engine at phase 6's widths and trace.
            (a) ``stream``: ``StreamingEngine`` (double-buffered, tick
            N+1 dispatched before tick N's tokens are home; inputs in one
            non-blocking copy from pinned memory, the (8, 4) result array
            the one copy home) in packed exact and prism, overlap on,
            then off: tokens equal to phase 6's
            synchronous paged run (a
            request may part only at a near-tie), every stream delivering
            its tokens; wall s, tokens/s, TTFT, ITL p50/p99 and
            ``host_overhead_fraction``; then a fresh run's window of 24
            loop iterations after 30 under torch.profiler, streamed and
            synchronous: device busy and idle share per tick; the card's
            sync debug mode must name no host synchronisation inside the
            streamed window.  (b) ``degraded``: a ``shard_loss`` fault on
            shard 1 at the engine's 60th tick, at most 8 degraded ticks,
            packed exact and prism;
            the lost shard's columns of the active slots' pages are
            NaN-filled when it is lost; the degraded ticks' logits must be
            finite, and every request's tokens and logits after the
            recovery are held to phase 6's paged run under its rules;
            capture ms and bytes, ms per degraded tick beside the healthy
            decode ticks, the recovery step and the refill time.  (c)
            ``padded``: the padded admission flush on the dense cache in
            both pairings, held to the same run with ``backend='plain'``;
            ``prism_flash_attention`` launches once a layer a flush,
            ``segment_means`` too in prism mode; ms per flush.  (d)
            ``gang``: gang admission in packed exact, held to phase 6's
            paged run, after the continuous engine (continuous, then
            gang); wall and tokens/s of each.
            Every run drains leak-free.
9. path     the Llama family: Yi-6B at full width (of 32 layers, d 4096,
            32 query heads over 4 KV heads of 128, SwiGLU d_ff 11008,
            RMSNorm, RoPE theta 5e6, untied head, vocab 64000), f32
            weights from torch.Generator seed 0 on the card, at the same
            shapes: phase 4's static pairings on its first 8 layers
            (``STATIC_DEPTH``), phase 5's chunked and packed paths in
            both modes and phase 6's engine in packed exact and packed
            prism on its first 3 (``TICK_DEPTH``), cut for the script's
            time limit, under the same checks and traces.
            The static and engine decode steps take the decode kernel's
            tile route (a group of 8, no row map), the packed ticks the
            row route; the launch counts are held per path.
10. path    Gemma 3 1B at full width on its first 12 of 26 layers
            (``STATIC_DEPTH``: two whole units of 5 sliding-window
            local layers of window 512 and 1 global; of 22 and 4), d
            1152, 4 query heads over 1 KV head of 256, qk-norm, GeGLU
            d_ff 6912, RoPE thetas 1e4 local and 1e6 global, sqrt(d)
            input scaling, tied head over 262144), f32 weights from
            torch.Generator seed 0 on the card, B = 8, prompt 2048 (each
            of the 4 shards holds a window), 64 generated, CR 4, through
            the static path in three pairings: voltage + exact (held to
            the plain full forward), PRISM + prism and voltage + prism
            (each held to the same run with backend='plain'), under phase
            4's checks and traces; every prefill launches the attention
            kernel once a layer (10 of them windowed), segment means
            once a global layer where it captures means, and every decode
            step the decode kernel's tile route once a layer.
11. path    Mixture-of-Experts: OLMoE-1B-7B at full width (of 16 MoE
            layers, d 2048, 16 heads of 128, qk-norm, 64 experts
            top-8 of SwiGLU d_ff 1024 at capacity factor 1.25, untied head
            over 50304), f32 weights from torch.Generator seed 0 on the
            card, at the main path's shapes: phase 4's static pairings
            on its first 4 layers (``STATIC_DEPTH``), then phase 5's
            chunked and packed paths in both modes and phase 6's engine
            runs (paged) on its first 3 (``TICK_DEPTH``, as phase 9).  Capacity counts per routing group
            (a prefill shard; a decode step's, chunk call's or packed
            tick's tokens), so every run is held to its backend='plain'
            twin: the counted and timed run records its routing (no
            launches), the twin, teacher-forced on its tokens, replays
            it; a token the twin would route otherwise must have a
            router margin under ROUTE_MARGIN in both runs (``replay_
            check``), and the logits compare under the path tolerance.
12. path    Gemma 7B at full width (of 28 layers, d 3072, 16 heads of
            256, GeGLU d_ff 24576, sqrt(d) input scaling, tied head over
            256000), the same paths under phases 4-6's references (the
            static path on its first 8 layers, ``STATIC_DEPTH``, the
            tick and engine paths on 3, ``TICK_DEPTH``).
            Before both, phase 3 checks and times the three kernels at
            their layouts (``check_family``): attention PRISM and
            Voltage, segment means and the augment at D 2048 and 3072,
            the decode kernel's static, chunk (a folded group of 64; at
            head dim 256 the split tile kernel), packed and paged layouts
            and a poisoned page.
13. path    the paper's encoders at full width and depth, f32 weights
            from torch.Generator seed 0 on the card, classifying through
            ``setup_encoder`` / ``runtime.serve.encode`` over P = 4
            sequence shards, attention non-causal, the class head on the
            CLS row: BERT-base (12 layers, d 768, 12 heads of 64, 2
            classes) on B 32 x 512 token ids in Voltage, PRISM at CR 4 (L
            32) and at CR 128 (L 1, the paper's headline setting);
            ViT-B/16 (1000 classes) on B 64 x 197 stub patch embeddings
            through ``frontend_proj``, split 49/49/49/50 by Alg. 1 (each
            shard padded to 50 rows), in Voltage and PRISM at CR 4 (L
            12).  Voltage is held to the plain full forward, PRISM to
            the same run with backend='plain', each within 1e-4 of the
            reference's largest |logit| with the classes equal where its
            top-2 gap is clear; the counters are zeroed before each run:
            attention once a layer, segment means once a PRISM layer (0
            in Voltage), the decode kernel never; then five more timed
            calls and a trace of one.  The phase runs in a child process
            of the script (``CHILD_ARG``, as phases 14 and 15 do): ~1,000
            s into one process the profiler dropped part of an encode
            window in every try.  Before both, phase 3 checks and
            times attention non-causal at every run's shapes and the
            augment at each PRISM layout, and sweeps the augment's
            uneven split (``check_encoder_kernels``).
14. path    PaliGemma 3B at full width on its first 9 of 18 layers
            (``STATIC_DEPTH``), d 2048, 8
            query heads over 1 KV head of 256, GeGLU d_ff 16384, sqrt(d)
            input scaling, tied head over 257216), f32 weights from
            torch.Generator seed 0 on the card, B 8, prompt 512 whose
            first 256 positions are a stub image (seeded embeddings
            through ``frontend_proj``, attended bidirectionally), 64
            generated, P 4, CR 4, through the static path in three
            pairings, under phase 10's checks: voltage + exact held to
            the plain full forward with the image; attention 9 a
            prefill, segment means 9 where a pairing captures means,
            the decode kernel's tile route 9 a step.  The tick
            programs and the engine take token prompts only and refuse
            it, as the reference's engine does.
15. path    Command-R 35B at full width (d 8192, 64 query heads over 8
            KV heads of 128, the parallel block, LayerNorm, SwiGLU d_ff
            22528, RoPE theta 8e6, tied head over 256000), f32 weights
            from torch.Generator seed 0 on the card: its first 4
            layers (``STATIC_DEPTH``; 40 are 121 GB) through phase 4's
            static pairings, its first 3 (``TICK_DEPTH``) through phase
            5's tick paths and phase 6's engine runs, under phases
            4-6's references.  Before both, phase 3 checks and times the
            three kernels at their layouts (``check_family``): attention
            at hd 256 with the image prefix, and with its end swept
            (``PREFIX_ENDS``: on a tile boundary, inside a 32-column
            tile, inside a shard and a means segment, two whole shards,
            past them), and at hd 128 over 8 groups of 8; segment means
            and the augment at D 2048 and 8192 (a misaligned base
            included); the decode kernel at PaliGemma's static layouts
            (a group of 8 at hd 256: the split tile route) and at
            Command-R's static, chunk, packed and paged ones and a
            poisoned page.
16. path    MusicGen-medium at full width (d 1536, 24 heads of 64,
            GELU d_ff 6144, LayerNorm, sinusoidal positions, untied head
            over 2048 codes), f32 weights from torch.Generator seed 0 on
            the card, its first 8 of 48 layers (``STATIC_DEPTH``), B 8,
            a prompt of 512 seeded frame embeddings (the EnCodec stub,
            through ``frontend_proj``), 64 codes generated, P 4, CR 4,
            through the static path in three pairings: voltage + exact
            held to the plain full forward over the frames' rows
            (``embed_inputs``) and the fed codes' rows (``embed_tokens``)
            under ``FullContext`` (``audio_rows``), the prism pairings
            to their backend='plain' twins; attention 16 a prefill,
            segment means 16 where a pairing captures means, the decode
            kernel's row route (a group of 1) 16 a step.  The tick
            programs and the engine take token prompts only and refuse
            it.  Phase 3 checks its layouts first (``check_family``):
            attention PRISM and Voltage at 24 heads of 64, segment means
            and the augment at D 1536, the decode kernel's static exact
            and prism layouts.
17. path    xLSTM 1.3B at full width on its first 12 of 48 layers
            (``STATIC_DEPTH``: one whole 8-layer unit of 7 mLSTM and 1
            sLSTM, then 4 mLSTM; at 48 the phase took 77 s, at 24 29.5
            s), d 2048, 4 heads, the
            mLSTM's of 1,024 with a state of (8, 4, 1024, 1025) f32 a
            layer, untied head over 50304, f32 weights from
            torch.Generator seed 0 on the card, at the main path's
            shapes, voltage + exact only (no layer reads the exchange or
            the means cache): the mLSTM hands its state across the 4
            shards in chunks of 128, the sLSTM scans the gathered
            sequence, each decode step updates the states in place.
            Held (``recurrent_check``) to a float64 witness: every
            cell's output at all 576 positions (prefill and decode rows,
            teacher-forced) to the cell's float64 full-sequence form on
            the same inputs, its prefill rows and its decode rows each
            within 4 times the plain f32 cell's own distance to that
            form; the logits to the float64 full forward over 576 tokens
            in chunks of 64 (``XLSTM_REF_CHUNK``) within the larger of
            1e-4 and 4 times the distance of two plain f32 forwards
            (chunks of 64 and 32) to it (the random-weight model
            amplifies f32 rounding with depth), and the tokens equal
            where its top-2 gap is clear; none of the three kernels
            launches.
18. path    Zamba2 2.7B at full width on its first 12 of 54 layers
            (``STATIC_DEPTH``: two whole 6-layer units, 10 Mamba2
            blocks, d_in 5120, 32 SSM heads of 160, d_state 64, conv 4,
            and at every 6th layer the one shared attention + MLP block,
            32 heads of 80 (MHA), GELU d_ff 10240, over 2 caches of its
            own; RMSNorm, RoPE, untied head over 32000), f32 weights from
            torch.Generator seed 0 on the card, at the main path's
            shapes, through the static path in three pairings: each
            Mamba2 conv takes the previous shard's last 3 rows
            (``prev_tail``), its state is handed across the 4 shards in
            chunks of 128, each decode step updates state and conv tail
            in place.  Voltage + exact is held by ``recurrent_check`` to
            the float64 witness, as xLSTM (two plain f32 forwards lie
            2.0e-3 apart at 54 layers: PERF.md §2), the prism pairings to
            their backend='plain' twins run again in float64
            (``plain_witness``: within the larger of 1e-4 and 4 times the
            f32 twin's distance to it); tokens equal where the witness's
            top-2 gap exceeds both ``TOKEN_GAP`` and twice the logits'
            own error.  Attention once a shared layer a prefill, segment
            means as often where a pairing augments or captures means,
            the decode kernel's row route (a group of 1) once a shared
            layer a step, none on the tile route.  Phase 3 checks its layouts first (``check_family``):
            attention PRISM and Voltage at 32 heads of 80, segment means
            and the augment at D 2560, the decode kernel's static exact
            and prism layouts on both routes.  Phases 9-12 run in one
            child process of the script, 13-17 in another, 18 in a third
            (``drive_apart``, ``CHILD_ARG``), with the bf16 phase after
            it.
bf16 path   the serving paths with bf16 weights (``drive_bf16``; init's
            dtype, seed 0, full width): GPT-2 small at full depth on the
            static path in both pairings and one engine run (packed,
            prism, paged; its cache f32, ``make_kv_cache``'s default, as
            the reference's engine makes it), Yi-6B and Gemma 7B on their first ``BF16_DEPTH``
            layers in both pairings.  Each run through the kernels is
            held, over its first ``BF16_REF_STEPS`` steps teacher-
            forced, to its bf16 plain twin and the f32 witness (the f32
            plain path on the same weights widened): E(kernels) <= 1.5 x
            E(plain) + 1e-3, E the largest |logits - witness| over the
            largest |witness|; tokens equal the plain twin's where its
            top-2 gap exceeds 2e-2 of its largest |logit|; the bf16
            instances' launches (``.bf16``, ``.kv_bf16``) as the path
            needs.  Prints prefill ms, decode ms a token and weight
            bytes beside the same call's f32 weights' (descriptive).
19. path    training and the accuracy path, in a fourth child process.
            (a) ``train``: GPT-2 small at full width and depth through
            ``repro_torch.launch.train``'s code (f32 weights from
            torch.Generator seed 0, B 8 x 512 of the reference's
            synthetic character corpus, P 4, CR 4, prism, lr 3e-4 with
            a warm-up of 3, remat on, 30 steps): step 0's loss and
            every gradient leaf held to the same step in float64 (the
            plain path, parameters cast on the card) within the
            reference runner's 2e-4 and 5e-3 of max(1e-6, the leaf's
            largest |grad|); a step whose context takes
            backend='auto' must raise (a kernel under autograd) before
            any launch; the 30 steps launch none of the three kernels
            and take the loss below 0.7 x the first; ms a step (CUDA
            events, median over steps 5-29), tokens/s, peak memory; a
            trace of one step; a checkpoint round trip in the
            reference's layout (bit-equal parameters, equal loss);
            ``score`` through the kernels within 1e-4 of
            backend='plain', attention and segment means once a layer.
            (b) ``train/charlm``: benchmarks/accuracy_vs_cr.py's
            protocol (``CharLM``: its char-LM, corpora and seeds; 400
            steps at lr 3e-3, the loss below 0.7 x the first; bits per
            character single, at CR 1 for P 2, 3, 4 within 5e-3 of
            single, CR 2, 4, 8 at P 2 and 3 with the trend reported,
            Table II's prism against prism_nodup at CR 4, and at P 3, CR
            8 before and after 150 steps of fine-tuning under
            SimulatedContext), every bpc scored under SimulatedContext
            and through the kernels (``score``), the two within 1e-4 of
            the largest |logit| and 1e-4 bits; one line per setting.
20. mesh    serving over a mesh of ranks, in a fifth child process: 4
            ranks, one process each, all on cuda:0 over the ``gloo``
            backend (NCCL refuses two ranks on one card), spawned by
            ``launch/mesh.py::spawn``; each rank runs
            ``launch.serve.mesh_rank`` (``setup``'s run: whole weights
            from torch.Generator seed 0, cut to its shards; the FSDP
            layers gathered as they are reached), every run at B 8, CR 4,
            cap prompt + 64.  (a) GPT-2 small at full width and depth on
            a (1, 4) mesh: prompt 512, P 4 (L 32), ``MESH_STEPS`` (3)
            decode steps, voltage + exact, prism + prism and voltage +
            prism; (b) the same on a (2, 2) mesh, 4 sequences a data
            rank, P 2, prism + prism; (c) Yi-6B at full width on its
            first 8 layers (``STATIC_DEPTH``) on a (1, 4) mesh with
            ``decode_tp``: attention TP over 32 heads, FFN TP over
            11,008, the vocab-parallel embedding and head over 64,000
            rows, prism prefill, exact decode.  Then at full width: (d)
            OLMoE-1B-7B's first 4 layers on (1, 4), prism + prism: 16 experts a
            rank, the dispatch and return an all_to_all pair over
            ``model``; (e) the same on (2, 2)
            with ``decode_tp``, prism + exact: expert-TP, each expert's
            d_ff of 1,024 over ``data``; (f) Gemma 3 1B's first 6 layers
            (5 local, 1 global) on (1, 4), prompt 2048 (512 a shard, one
            window), prism + prism: the ring halo, windowed launches,
            the ring decoded alike on every rank; (g) Zamba2 2.7B's
            first 6-layer unit (5 Mamba2, 1 shared), prism + prism: the
            conv halo, the state handoff, hd-80 attention; (h) xLSTM
            1.3B's first 8-layer unit (7 mLSTM, 1 sLSTM), voltage +
            exact: the state handoff, the sLSTM's gathered sequence; (i)
            PaliGemma 3B's first 4 layers (image prefix 256 across the
            shards) and MusicGen-medium's first 4 (512 frames), prism +
            prism.  Each run is teacher-forced on the folded one-process
            path's greedy tokens (``setup``'s run: the same weights and
            kernels, on the card; (c)'s and (e)'s without decode_tp) and
            held to its logits within 1e-4 of their largest |logit|,
            with the rank's own greedy tokens equal where the top-2 gap
            is clear.  A MoE rank routes its own tokens, so (e)'s fold
            runs each data rank's 4 sequences alone at P 2; each rank
            replays its fold's routing, a token's own top-k differing
            only under ``ROUTE_MARGIN`` (``replay_check``).  (g) and (h)
            sum in another f32 order than their folds, which depth
            amplifies: each is held to a float64 witness (the plain full
            forward for (h), the plain twin for (g)), within max(1e-4,
            ``F32_ORDER_FACTOR`` x the fold's distance to it).  On every
            rank: every weight and output on cuda:0; each kernel of the
            path launched (``LAUNCHES``, zeroed before each run; (h)
            launches none; their sums go to the kernels line under
            ``mesh/...``); the bytes the protocol fixes (``mesh_bytes``):
            a prefill's exchange, B_loc x
            ``comm_elements_per_device_per_layer`` x 4 a global layer
            and a local layer's one-hop halo of (B_loc, n_loc, D) from
            every rank but the last; a MoE layer's ``expert`` bytes,
            (M - 1) / M of the (E, cap, D) buffer each way, in prefill
            and in every step.  Prints each rank's bytes by class, prefill
            ms and decode ms a token (CUDA events on the rank's stream),
            marked as 4 gloo ranks on one card: not a multi-card time;
            then each rank's host-clock ms of one collective of a GPT-2
            decode step's (a layer's FSDP gather, a combine psum).  Runs
            (j) and (k), the engine and its robustness layers over the
            ranks, are set out at their constants; (l), the train step
            over the ranks (``make_train_step(..., mesh=)``), at
            ``MESH_TRAIN_SHAPES``: GPT-2's first 4 layers on (1, 4) and
            (2, 2), each rank held to the one-card step, its bytes a
            step by class equal to ``train_step_bytes``, ms a step and
            peak memory printed, and the (1, 4) run's checkpoint served
            through the three kernels.
   total    the script's seconds so far.
21. kernels one line listing every kernel with its numbers: ``ms`` is
            the kernel's time and ``max_abs_err`` its largest error
            against the plain version over phase 3, ``launches`` its
            launches over every path (``launches_by_path``); the
            flash_decode_stats row adds its chunk and packed layouts
            (``chunk_*``, ``packed_*``, ``packed_prism_*``), the chunk
            layout per route (``chunk_tile_*``, ``chunk_row_*``; the
            path's call, ``chunk_ms``, takes the tile route), the
            ``crossover`` table, the cases checked per route and the tile
            route's launches (``launches_mq``, ``launches_mq_by_path``),
            the poisoned-page cases (``poisoned``), the paged layouts
            (``paged_*``: kernel, plain, bound, the reference's gather
            plus the library call, the dense twin from this call), the
            degraded step's (``degraded_exact_*``, ``degraded_prism_*``,
            over the page pool, with the healthy layout's ``ms``) and
            the launches through a page table (``launches_paged``,
            ``launches_paged_by_path``); the segment_means row its bf16
            and fused-augment (``augment_*``) numbers; each row's ``yi``
            its numbers at Yi-6B's layouts (head dim 128, D 4096) and
            its launches on phase 9's paths; each row's ``gemma`` the
            same at Gemma 3 1B's layouts (head dim 256, D 1152) and its
            launches on phase 10's paths; ``olmoe``, ``gemma7b``,
            ``paligemma``, ``commandr``, ``musicgen`` and ``zamba2`` the
            same at phases 11, 12, 14, 15, 16 and 18's layouts and paths
            (Zamba2's at head dim 80 and D 2560); ``xlstm``
            its launches on phase 17's path (none); ``bert`` and
            ``vit`` at phase 13's (the decode kernel has none) with the
            launches there; ``charlm`` the attention kernel's and the
            means kernel's numbers at phase 3's char-LM layouts, and
            ``train`` each kernel's
            launches on phase 19's runs (none in the train steps);
            ``mesh`` each kernel's launches over phase 20's ranks.  Then
            a row for each new instance (``prism_flash_attention.bf16``,
            ``.hd16``, ``flash_decode_stats.bf16``, ``.mixed``,
            ``.hd16_32``) with its numbers at its main layout, every
            layout's (``by_layout``) and its launches on the paths.

Then the nvidia-smi line, and last the result line.  Any failed check
raises, and the script exits non-zero without printing a result; so it
does without a card, and outside the repository.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
from dataclasses import replace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM data-sheet peaks (dense, no sparsity) at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12                  # CUDA cores, f32 FMA
TF32_FLOP_PER_S = 495e12                # tensor cores, TF32
# f32-accurate products on the tensor cores take three TF32 products
# each (3xTF32), so the card's peak for them is a third of TF32's
F32_3XTF32_FLOP_PER_S = TF32_FLOP_PER_S / 3
BF16_FLOP_PER_S = 989e12                # tensor cores, bf16, dense

# main path: GPT-2 small, B = 8, prompt 512, 64 generated, P = 4, CR 4
ARCH, BATCH, PROMPT, GEN, SHARDS, CR = "gpt2-small", 8, 512, 64, 4, 4.0
# phase 9: the Llama family (RoPE, RMSNorm, SwiGLU, GQA 8:1, head dim
# 128, untied head) at full width, at the same shapes
LLAMA = "yi-6b"
# phase 10: Gemma 3 1B (sliding-window local layers 5:1 with global ones,
# qk-norm, GeGLU, MQA, head dim 256, tied head over 262144) at full width
# on its first 12 layers; its prompt is 2048, so that each shard holds a
# window of 512 (the reference's window prefill needs one a shard)
GEMMA, GEMMA_PROMPT = "gemma3-1b", 2048
# phase 11: Mixture-of-Experts, OLMoE-1B-7B (64 experts top-8, capacity
# factor 1.25, MHA at head dim 128); phase 12: Gemma 7B (MHA at head dim
# 256, GeGLU); both at full width and depth, at the main path's shapes
MOE, GEMMA7 = "olmoe-1b-7b", "gemma-7b"
# phase 14: PaliGemma 3B (a stub SigLIP image of 256 embeddings over the
# first prompt positions, attended bidirectionally; 8 query heads over 1
# KV head of 256) at full width on 9 layers on the static path (the tick
# programs and the engine take token prompts only); phase 15: Command-R
# 35B (the parallel block, d 8192, 64 query heads over 8 KV heads of
# 128) at full width, its static path on its first 4 layers
# (``STATIC_DEPTH``: 40 layers of f32 weights are 121 GB)
PALI, CMDR = "paligemma-3b", "command-r-35b"
# phase 16: MusicGen-medium (a stub EnCodec prompt of frame embeddings,
# sinusoidal positions, 24 heads of 64, an untied head over 2048 codes)
# at full width on the static path, on its first 8 of 48 layers
# (``STATIC_DEPTH``); phase 17: xLSTM 1.3B (42 mLSTM and 6 sLSTM blocks,
# no attention) at full width on its first 24 layers, voltage + exact
# only: no layer reads the exchange or the means cache
MUSICGEN, XLSTM = "musicgen-medium", "xlstm-1.3b"
# phase 18: Zamba2 2.7B (45 Mamba2 blocks and 9 shared attention + MLP
# layers over one weight set, 32 heads of 80, MHA) at full width on the
# static path in three pairings (``STATIC_DEPTH``)
ZAMBA = "zamba2-2.7b"
# the chunk of a recurrent model's plain full forward over prompt +
# generated tokens (xLSTM's, Zamba2's; 576 rows: a multiple of 64, not of
# the serving chunk of 128)
XLSTM_REF_CHUNK = 64
# xLSTM's limits (``recurrent_check``): the path, another f32 order of
# the same sums (chunks of 128 and a hand-off across 4 shards in the
# prefill, one step a token in decode), may lie at most this many times
# as far from the float64 witness as plain f32 does: each cell's prefill
# rows and decode rows as far as the plain f32 cell's (chunks of 64) on
# the same inputs, the logits as the farther of two plain f32 forwards
# (chunks of 64 and 32), the logits never held closer than PATH_REL_TOL
F32_ORDER_FACTOR = 4
# phase 3's families (``check_family``): arch -> (key in the kernels
# line and the phase-3 error keys, generator seed)
FAMILY_TAGS = {MOE: ("olmoe", 17), GEMMA7: ("gemma7b", 19),
               PALI: ("paligemma", 23), CMDR: ("commandr", 29),
               MUSICGEN: ("musicgen", 31), ZAMBA: ("zamba2", 37)}
# the static prefill / decode pairings: phase 4's two, and Gemma's third
PAIRINGS = (("voltage", "exact"), ("prism", "prism"))
GEMMA_PAIRINGS = PAIRINGS + (("voltage", "prism"),)

# kernel vs plain tolerances (|got - want| <= atol + rtol·|want|): both
# sides compute in f32 (the attention kernel's tensor-core products are
# 3xTF32, whose error stays at f32 FMA's level; single-pass TF32 would
# not fit); they differ only in summation order.  The reference's own
# kernel tests use the same.
TOL = {"prism_flash_attention": (2e-5, 2e-4),
       "segment_means": (1e-5, 1e-5),
       "flash_decode_stats": (1e-5, 1e-5)}
# bf16 segment means (both sides sum in f32 and round once to bf16): one
# bf16 rounding apart, 2^-7 of the value, beyond f32's sum-order error
TOL_BF16 = (1e-5, 2.0 ** -7)
# the bf16 attention and decode kernels against their plain versions:
# the reference's own bf16 tolerance (tests/test_kernels.py:53-65).  The
# plain versions round where the reference's plain path does (bf16
# logits, p in bf16 before P V, a bf16 output), the kernels accumulate
# in f32, so they part by bf16 roundings.  Decode holds l and m, and acc
# normalised by l (the output each shard contributes, which the
# reference's decode tests compare), since acc itself grows with the
# live columns a row sums; a bf16 query over an f32 cache is exact in f32
# and is held to TOL
TOL_BF16_KERNEL = (2e-2, 1e-2)
# the bf16 cases' draws (``peaked``): the f32 cases' 0.5 randn with q
# times BF16_Q_GAIN and V (and the means' V) times BF16_V_GAIN, so that
# outputs are O(1) (V of std 1), and the sweeps add rows that see few
# columns (decode: every 8th, so that each column is one of 9 a row
# sees; attention: the first 1-5, beside the window cases' 13-20): a
# column read wrong moves such a row's output by O(0.1-1), past atol.  The logits grow to std 0.5 and no
# further: the plain version's bf16 logits part from the kernel's f32
# ones by half a bf16 ulp of the row's max m, which scales every term of
# l alike; under m = 2 that is 2^-9 of l, beside l's rtol of 1e-2, but a
# gain of 4 puts m in [2, 8), where the ulp alone is 0.8-1.6% of l
BF16_Q_GAIN, BF16_V_GAIN = 2.0, 2.0
# end-to-end: max |logits - reference| / max |reference| over every step
PATH_REL_TOL = 1e-4
# greedy tokens must agree where the reference's top-2 gap exceeds this
# share of its largest |logit|
TOKEN_GAP = 1e-3
# MoE routing: a kernel run and its backend='plain' twin may route a
# token differently only where the token's router margin (the gap
# between its k-th and (k+1)-th router logits, f32) is under this in
# both runs; the twin replays the kernel run's decisions, so the logits
# compare under PATH_REL_TOL whatever a near-tie does
ROUTE_MARGIN = 1e-4

SOURCES = {
    "prism_flash_attention": (
        "src/repro_torch/kernels/csrc/prism_attention.cu",
        "src/repro/kernels/prism_attention.py:88"),
    "segment_means": (
        "src/repro_torch/kernels/csrc/segment_means.cu",
        "src/repro/kernels/segment_means.py:33"),
    "flash_decode_stats": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:178"),
}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of one call, with the 50 MB L2 flushed
    before each call (the main path finds its operands cold) and the
    card kept busy for about a millisecond after the flush, so that the
    host has enqueued the whole call before its start event is reached:
    the time is the card's, not the host's Python between launches."""

    AHEAD_CYCLES = 2_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
        self.flush_kernels = None           # names of the flush's kernels

    def __call__(self, fn, iters=25, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.AHEAD_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def device(self, fn, iters=25, warmup=3):
        """Median device time of one call from torch.profiler's kernel
        records: the summed durations of the call's kernels, each call
        after the same L2 flush.  It holds none of the latency between
        an event and the kernel beside it, which puts a floor of about
        5 us under every event-pair time (``floor_ms``) and dominates a
        kernel of a few microseconds."""
        for _ in range(warmup):
            fn()
        if self.flush_kernels is None:
            self.flush_kernels = {e.name for e in device_events(
                trace_device(self.torch, self.flush.zero_))}

        def calls():
            for _ in range(iters):
                self.flush.zero_()
                fn()

        def per_call(prof):
            """Kernel times of each call: those between two flushes."""
            runs, cur = [], None
            for e in device_events(prof):
                if e.name in self.flush_kernels:
                    cur = None
                    continue
                if cur is None:
                    cur = []
                    runs.append(cur)
                cur.append((e.time_range.end - e.time_range.start) / 1e3)
            return runs

        def complete(prof):
            runs = per_call(prof)
            return len(runs) == iters and len({len(r) for r in runs}) == 1
        runs = per_call(trace_device(self.torch, calls, complete))
        return statistics.median(sum(r) for r in runs)

    def floor(self):
        """Event-pair time of a one-element add: the harness's floor."""
        tiny = self.torch.zeros(1, device="cuda")
        return self(lambda: tiny.add_(1))


# the filler launches inside every trace, before and after the traced
# work (``torch.cuda._sleep``: ATen's spin_kernel), left out of every
# analysis.  The profiler drops the first device records of a trace,
# more of them the older the process: none 8 s after a process's first
# trace, 5 at 84 s (one a 15 s), about 35 of a path window eleven
# minutes in (PERF.md §6).  The count is raised to twice the most a
# trace lost plus 16 and doubled after each short trace, up to
# FILLERS_MAX, and kept for the rest of the process.
FILLER_KERNEL = "spin_kernel"
FILLER_CYCLES = 1000
FILLERS = {"n": 64}
FILLERS_MAX = 8192
# the host range around the traced work (a ``record_function``; a
# device-side copy of it is no kernel)
WINDOW_MARK = "chip_smoke.window"


def device_events(prof):
    """The device activities of a profile, in start order, without the
    fillers and the window's mark."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and FILLER_KERNEL not in e.name
                   and e.name != WINDOW_MARK),
                  key=lambda e: e.time_range.start)


def fillers_lost(prof, n):
    """How many of the ``n`` fillers launched before and after the traced
    work have no record in the profile: (before, after); None when the
    work left no device record to tell them apart."""
    from torch.autograd import DeviceType
    events = device_events(prof)
    if not events:
        return None
    first, last = events[0].time_range.start, events[-1].time_range.start
    spins = [e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and FILLER_KERNEL in e.name]
    return (n - sum(t < first for t in spins),
            n - sum(t > last for t in spins))


def trace_device(torch, fn, complete=None, tries=12, why=None):
    """torch.profiler over ``fn()``'s device activity, between
    ``FILLERS`` filler kernels before and as many after.  No host
    activity is recorded: nothing reads it, and parsing it took most of
    a trace's time (phase 18 on an H100: 15.0 and 18.3 s a pairing's two
    windows with it, 7.2 and 6.5 s without; PERF.md §6).  A trace that
    recorded no device activity, or that ``complete(prof)`` finds short
    of what ``fn`` launched, is taken again, up to ``tries`` times, after
    a pause that grows each time: the profiler's device tracing on the
    card now and then comes back empty or holding only part of a call,
    up to three traces in a row (six in a row once, for a one-second
    Yi-6B prefill).  The returned profile carries ``trace_info``: the
    tries taken, the fillers and how many of them were lost.  The error
    names each try's device record count and lost fillers and
    ``why(prof)`` of the last try."""
    import time
    from torch.profiler import ProfilerActivity, profile, record_function

    def fill(n):
        for _ in range(n):
            torch.cuda._sleep(FILLER_CYCLES)
        torch.cuda.synchronize()
    seen = []
    for i in range(tries):
        time.sleep(0.25 * i)
        torch.cuda.synchronize()
        n = FILLERS["n"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fill(n)
            with record_function(WINDOW_MARK):
                fn()
                torch.cuda.synchronize()
            fill(n)
        events = device_events(prof)
        lost = fillers_lost(prof, n)
        if lost is not None:
            FILLERS["n"] = min(max(n, 2 * max(lost) + 16), FILLERS_MAX)
        if events and (complete is None or complete(prof)):
            prof.trace_info = {"tries": i + 1, "fillers": n,
                               "fillers_lost": lost}
            return prof
        FILLERS["n"] = min(2 * FILLERS["n"], FILLERS_MAX)
        seen.append((len(events), lost))
    raise RuntimeError(f"the profiler recorded no or an incomplete device "
                       f"trace in {tries} tries (device records and lost "
                       f"fillers (before, after): {seen}"
                       f"{'' if why is None else '; ' + why(prof)})")


def trace_window(torch, fn):
    """``trace_device`` over a window of the serving path, complete when
    it holds a device record of every launch of the port's kernels that
    the window counted (``LAUNCHES``), kernel by kernel.  On failure the
    error gives both counts by kernel, the same count over the
    profiler's raw records (before torch parses them into events) and
    the kernels' names."""
    from repro_torch.kernels.dispatch import LAUNCHES
    counted = {}

    def run():
        n0 = {name: LAUNCHES[name] for name in TOL}
        fn()
        counted.update({name: LAUNCHES[name] - n0[name] for name in TOL})

    def by_kind(names):
        n = dict.fromkeys(TOL, 0)
        for name in names:
            kind = kernel_kind(name)
            if kind in n:
                n[kind] += 1
        return n

    def traced(prof):
        return by_kind(e.name for e in device_events(prof))

    def complete(prof):
        return traced(prof) == counted

    def why(prof):
        from torch.autograd import DeviceType
        raw = getattr(prof.profiler, "kineto_results", None)
        raw = None if raw is None else by_kind(
            e.name() for e in raw.events()
            if e.device_type() == DeviceType.CUDA)
        events = device_events(prof)
        names = sorted({e.name[:120] for e in events
                        if kernel_kind(e.name) in TOL})
        # each of the port's kernels' records: its index among the
        # window's device records and its start (ms after the first)
        t0 = events[0].time_range.start if events else 0
        at = {name: [(i, round((e.time_range.start - t0) / 1e3, 3))
                     for i, e in enumerate(events)
                     if kernel_kind(e.name) == name] for name in TOL}
        return (f"launched {counted}, traced {traced(prof)}, raw records "
                f"{raw}: {names}; of {len(events)} records, at {at}")
    return trace_device(torch, run, complete, why=why)


def bound_ms(n_bytes, flops, flop_per_s=F32_FLOP_PER_S):
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, flops / flop_per_s
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


class Checker:
    """Collects the largest kernel-vs-plain error per kernel and raises on
    the first comparison outside the stated tolerance."""

    def __init__(self, torch):
        self.torch = torch
        self.max_err = {name: 0.0 for name in TOL}
        # the largest |err| / (atol + rtol·|want|): how much of its
        # tolerance a kernel uses (1 fails)
        self.tol_share = {name: 0.0 for name in TOL}
        # the case that used the most of each key's tolerance
        self.worst = {}
        self.cases = {name: 0 for name in TOL}

    def close(self, name, got, want, case, mask=None, tol=None, key=None):
        """``key`` (default ``name``) files the error apart, with its own
        ``tol``, e.g. a kernel's bf16 cases."""
        torch = self.torch
        atol, rtol = TOL[name] if tol is None else tol
        key = name if key is None else key
        got, want = got.double(), want.double()
        if mask is not None:
            got, want = got[mask], want[mask]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} [{case}]: non-finite output")
        diff = (got - want).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        share = diff / (atol + rtol * want.abs())
        if (share > 1).any():
            raise AssertionError(f"{name} [{case}]: max |err| {err:.3e} "
                                 f"outside atol {atol} rtol {rtol}")
        self.max_err[key] = max(self.max_err.get(key, 0.0), err)
        if share.numel() and float(share.max()) > self.tol_share.get(key,
                                                                     0.0):
            self.tol_share[key] = float(share.max())
            self.worst[key] = case

    def stats(self, got, want, case, key=None, tol=None):
        """Decode stats: l and acc everywhere, m where the row is live;
        with ``tol`` (the bf16 cases) acc normalised by l, as
        ``TOL_BF16_KERNEL`` says."""
        m_g, l_g, a_g = got
        m_w, l_w, a_w = want
        if tol is not None:
            def norm(a, l):
                return a / l.clamp(min=1e-30)[:, :, 0, 0][:, None, :, None]
            a_g, a_w = norm(a_g, l_g), norm(a_w, l_w)
        kw = dict(key=key, tol=tol)
        self.close("flash_decode_stats", l_g, l_w, case + "/l", **kw)
        self.close("flash_decode_stats", a_g, a_w, case + "/acc", **kw)
        self.close("flash_decode_stats", m_g, m_w, case + "/m",
                   mask=l_w > 0, **kw)
        self.cases["flash_decode_stats"] += 1


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_inputs(torch, ctx_mode, seed=0, arch=ARCH, prompt=PROMPT,
                     kind="attn", batch=BATCH, cr=CR):
    """A path's prefill-attention inputs: q/k/v at ``arch``'s widths
    (GPT-2 small for the main path), ``batch`` sequences of ``prompt``
    tokens (an encoder's may split unevenly over the shards: Alg. 1),
    metadata from the port's own sharded context for a block of
    ``kind`` (``attn_local``: the window augment, in either mode)."""
    from repro_torch.configs import get_config
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models.transformer import attn_spec
    from repro_torch.sharding.context import ShardedPrismContext
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    L = int(prompt // (cr * SHARDS))
    ctx = ShardedPrismContext(PrismConfig(P=SHARDS, L=L, mode=ctx_mode),
                              n_shards=SHARDS, backend="plain", n=prompt)
    x = ctx.shard(torch.randn(batch, prompt, cfg.d_model, device="cuda",
                              generator=gen))
    _, akv = ctx.augment(x, attn_spec(cfg, kind))
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    m = akv.x_hat.shape[1]

    def rnd(*shape):
        return 0.5 * torch.randn(*shape, device="cuda", generator=gen)
    q = rnd(x.shape[0], x.shape[1], hq, hd)
    k = rnd(akv.x_hat.shape[0], m, hkv, hd)
    v = rnd(akv.x_hat.shape[0], m, hkv, hd)
    g = akv.g if akv.g is not None else torch.ones(m, device="cuda")
    return q, k, v, g, akv.col_lo, akv.col_hi, akv.row_pos


def attention_main(torch, timer, both, mode, arch=ARCH, tag="main",
                   prompt=PROMPT, kind="attn", args=None, causal=True,
                   prefix_len=0, flop_per_s=F32_3XTF32_FLOP_PER_S):
    """The prefill kernel at a path's shapes in one exchange (a block of
    ``kind``: a local one with its window; ``args``: inputs built by the
    caller, ``attention_inputs``' by default; ``causal`` False for an
    encoder; ``prefix_len`` a vlm's image prefix): checked by ``both``,
    then the kernel (event pair and profiler), its plain version, the
    entry point, the library call and the bound.  The bound counts the
    live pairs of the real query rows (a pad row of an uneven split,
    position -1, is discarded), its operations at ``flop_per_s`` (bf16
    inputs: ``BF16_FLOP_PER_S``); the library call takes q's dtype."""
    from repro_torch.configs import get_config
    from repro_torch.core.attention import log_repeats
    from repro_torch.core.masks import visibility
    from repro_torch.kernels.ops import prism_attention_op
    from repro_torch.kernels.prism_attention import (
        prism_attention_reference, prism_flash_attention)
    if args is None:
        args = attention_inputs(torch, mode, arch=arch, prompt=prompt,
                                kind=kind)
    window = get_config(arch).window if kind == "attn_local" else None
    both(args, f"{tag}/{mode}/{kind}", window=window, causal=causal,
         prefix_len=prefix_len)
    q, k, v, g, lo, hi, row = args
    p = row.shape[0] if row.dim() == 2 else 1
    lg = log_repeats(g).reshape(-1, k.shape[1]).expand(p, -1)
    vis = visibility(row, lo.reshape(-1, k.shape[1]).expand(p, -1),
                     hi.reshape(-1, k.shape[1]).expand(p, -1),
                     causal=causal, prefix_len=prefix_len,
                     window=window) & (
                         lg > -1e29)[:, None, :]
    real = (row.reshape(p, -1) >= 0)[:, :, None]
    pairs = int((vis & real).sum()) * (q.shape[0] // p) * q.shape[2]
    flops = 4 * q.shape[-1] * pairs          # QK^T and PV, 2 per FMA
    b_ms, b_by = bound_ms(nbytes(q, k, v, lg, lo, hi, row) +
                          nbytes(q), flops, flop_per_s)
    # the library yardstick: SDPA with log g and the mask folded into
    # a float mask, or with no mask where every column is visible and
    # g = 1 (an encoder's Voltage); K/V expanded to the query batch for
    # voltage, and to the query heads for GQA
    rep, grp = q.shape[0] // k.shape[0], q.shape[2] // k.shape[2]
    qs = q.transpose(1, 2).contiguous()
    ks, vs = (t.repeat_interleave(rep, 0).repeat_interleave(grp, 2)
              .transpose(1, 2).contiguous() for t in (k, v))
    if bool(vis.all()) and bool((lg == 0).all()):
        bias = None
    else:
        bias = torch.where(vis, lg[:, None, :], torch.full_like(
            lg[:, None, :], -1e30))
        bias = bias.repeat(q.shape[0] // p, 1, 1)[:, None].to(
            q.dtype).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the kernel and its plain version on the (P, M) / (P, Nq)
    # metadata the entry point hands them; the entry point's own
    # conversions (log g, int32, per-shard copies) are in op_ms
    i32 = torch.int32
    kargs = (q, k, v, lg.contiguous(),
             lo.reshape(-1, k.shape[1]).expand(p, -1).to(i32).contiguous(),
             hi.reshape(-1, k.shape[1]).expand(p, -1).to(i32).contiguous(),
             row.reshape(p, -1).to(i32).contiguous())
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    try:
        lib_ms = timer(lambda: sdpa(qs, ks, vs, attn_mask=bias))
        lib_note = None
    except RuntimeError as e:                 # no library call takes it
        lib_ms, lib_note = None, f"refused: {str(e).splitlines()[0][:200]}"
    return {
        "ms": timer(lambda: prism_flash_attention(*kargs, **kw)),
        "device_ms": timer.device(lambda: prism_flash_attention(
            *kargs, **kw)),
        "plain_ms": timer(lambda: prism_attention_reference(
            *kargs, **kw), iters=10),
        "op_ms": timer(lambda: prism_attention_op(*args, backend="kernel",
                                                  **kw)),
        "library_ms": lib_ms, "library_note": lib_note,
        "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
        "shape": {"q": list(q.shape), "k": list(k.shape),
                  "window": window, "causal": causal,
                  "prefix_len": prefix_len,
                  "library_mask": bias is not None}}


def attention_checker(chk, key=None, tol=None):
    """``both(args, case, **kw)``: the prefill kernel against its plain
    version through the entry point, the error filed under ``key``
    (default the kernel's name) with its ``tol`` (default ``TOL``'s)."""
    from repro_torch.kernels.ops import prism_attention_op
    name = "prism_flash_attention"

    def both(args, case, **kw):
        got = prism_attention_op(*args, backend="kernel", **kw)
        want = prism_attention_op(*args, backend="plain", **kw)
        if got.dtype != args[0].dtype:
            raise AssertionError(f"{name} [{case}]: out {got.dtype} for q "
                                 f"{args[0].dtype}")
        chk.close(name, got, want, case, key=key, tol=tol)
        chk.cases[name] += 1
    return both


def attention_groups(torch, both, gen, groups, hd, dtype=None):
    """Ragged Nq (100) and M (97) at each (hq, hkv) of ``groups``: rows
    that see nothing, g = 0 columns, causal off, window, prefix; q, k, v
    in ``dtype`` (default f32).  bf16: ``peaked`` draws, and three rows
    that see at most 1, 3 and 5 columns (causal)."""
    dtype = dtype or torch.float32
    for hq, hkv in groups:
        b, nq, m = 2, 100, 97
        q, k, v = (0.5 * torch.randn(*s, device="cuda", generator=gen)
                   for s in ((b, nq, hq, hd), (b, m, hkv, hd),
                             (b, m, hkv, hd)))
        g = torch.randint(0, 5, (m,), device="cuda", generator=gen).float()
        lo = torch.randint(0, 120, (m,), device="cuda", generator=gen)
        hi = lo + torch.randint(0, 4, (m,), device="cuda", generator=gen)
        row = torch.arange(nq, device="cuda") + 20
        row[:7] = -1                              # rows that see nothing
        if dtype == torch.bfloat16:
            q, k, v = peaked((q, k, v))
            row[7:10] = hi.sort().values[[0, 2, 4]]
        args = (q.to(dtype), k.to(dtype), v.to(dtype), g, lo, hi, row)
        for kw in (dict(causal=True), dict(causal=False),
                   dict(causal=True, window=16), dict(causal=True,
                                                      prefix_len=6),
                   dict(causal=False, window=24)):
            both(args, f"hq{hq}/hkv{hkv}/hd{hd}/{kw}", **kw)


def check_attention(torch, chk, timer):
    both = attention_checker(chk)
    # main-path shapes, both exchanges
    main = {mode: attention_main(torch, timer, both, mode)
            for mode in ("prism", "voltage")}

    # edge sweep: ragged Nq and M, GQA groups, dead rows,
    # g = 0 columns, causal off, window, prefix
    gen = torch.Generator(device="cuda").manual_seed(1)
    attention_groups(torch, both, gen, ((12, 12), (12, 4), (12, 1)), 64)

    # tile skipping: sorted positions over Nq = 130 / M = 200 and
    # Nq = 200 / M = 400 (neither a tile multiple), two shards with their
    # own rows, so whole column tiles are invisible to a query tile
    # (causal), or drop out below the window; a prefix makes late tiles
    # visible again
    for (nq, m, r0, hq, hkv, kws) in (
            (130, 200, 40, 12, 12, (dict(causal=True),
                                    dict(causal=True, prefix_len=150))),
            (200, 400, 200, 12, 4, (dict(causal=True, window=50),
                                    dict(causal=True, window=150,
                                         prefix_len=20),
                                    dict(causal=False, window=70)))):
        p = 2
        q = 0.5 * torch.randn(2 * p, nq, hq, 64, device="cuda", generator=gen)
        k = 0.5 * torch.randn(2, m, hkv, 64, device="cuda", generator=gen)
        v = 0.5 * torch.randn(2, m, hkv, 64, device="cuda", generator=gen)
        g = torch.randint(0, 3, (p, m), device="cuda", generator=gen).float()
        lo = torch.arange(m, device="cuda").expand(p, m).contiguous()
        hi = lo + (torch.arange(m, device="cuda") % 2)
        row = (torch.arange(nq, device="cuda")[None] + r0
               + 60 * torch.arange(p, device="cuda")[:, None])
        for kw in kws:
            both((q, k, v, g, lo, hi, row), f"skip/nq{nq}/m{m}/{kw}", **kw)

    # the PRISM layout with its columns shuffled: a tile's positions are
    # neither sorted nor contiguous
    q, k, v, g, lo, hi, row = attention_inputs(torch, "prism", seed=4)
    perm = torch.randperm(k.shape[1], device="cuda", generator=gen)
    both((q[:8], k[:8, perm], v[:8, perm], g[..., perm], lo[..., perm],
          hi[..., perm], row), "prism/shuffled")
    return main


def check_segment_means(torch, chk, timer, d=768, prompt=PROMPT, key=None):
    """Both entries of csrc/segment_means.cu, f32 and bf16, against their
    plain versions: the means alone, and the fused PRISM augment.  Also
    a base 4 bytes off 16-byte alignment, which takes the kernel's scalar
    path at a D of whole vectors.  ``d``: the path's width (GPT-2's 768
    with the full edge sweep; Yi-6B's 4096 and Gemma 3's 1152 at their
    paths' shapes and a ragged one); ``prompt`` the path's prompt length;
    errors filed under ``key`` (default the kernel's name)."""
    from repro_torch.kernels.segment_means import (prism_augment_op,
                                                   segment_means_op)
    name = "segment_means"
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(shape, dtype, misaligned=False):
        flat = torch.randn(math.prod(shape) + 1, device="cuda",
                           generator=gen).to(dtype)
        return (flat[1:] if misaligned else flat[:-1]).view(*shape)

    def both(op, x, case, **kw):
        tag = "" if x.dtype == torch.float32 else "/bf16"
        got = op(x, backend="kernel", **kw)
        want = op(x, backend="plain", **kw)
        if got.dtype != x.dtype or got.shape != want.shape:
            raise AssertionError(f"{name} [{case}{tag}]: {got.dtype} "
                                 f"{tuple(got.shape)}, want {x.dtype} "
                                 f"{tuple(want.shape)}")
        chk.close(name, got, want, case + tag, key=(key or name) + tag,
                  tol=None if not tag else TOL_BF16)
        chk.cases[name] += 1
        return got

    n_loc, L0 = prompt // SHARDS, int(prompt // (CR * SHARDS))
    main = (BATCH * SHARDS, n_loc, d, L0)
    means_cases = [main, (32, 100, d, 16)]
    # (B·P, n_loc, D, L, P): the main shape, ragged n_loc, L = 1,
    # L = n_loc, D = 33 and 5, P = 1, 2 and 4
    augment_cases = [main + (SHARDS,), (8, 100, d, 16, 4)]
    if d == 768:
        means_cases += [(3, 17, 33, 4), (2, 9, 64, 1), (1, 130, 5, 130),
                        (4, 128, 768, 7), (2, 130, 768, 1)]
        augment_cases += [(6, 130, 768, 1, 2), (4, 12, 768, 12, 4),
                          (6, 17, 33, 4, 2), (4, 9, 5, 3, 4),
                          (3, 64, 768, 8, 1), (2, 7, 5, 7, 1),
                          (8, 128, 64, 32, 2)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, d, L in means_cases:
            both(segment_means_op, rand((b, n, d), dtype),
                 f"means/b{b}/n{n}/d{d}/L{L}", L=L)
        for bp, n, d, L, p in augment_cases:
            x = rand((bp, n, d), dtype)
            got = both(prism_augment_op, x,
                       f"augment/bp{bp}/n{n}/d{d}/L{L}/P{p}", L=L,
                       n_shards=p)
            if not torch.equal(got[:, :n], x):
                raise AssertionError(f"{name} [augment/bp{bp}/n{n}]: the "
                                     "local rows are not copied exactly")
        b, n, d, L = main
        both(segment_means_op, rand((b, n, d), dtype, misaligned=True),
             "means/misaligned", L=L)
        both(prism_augment_op, rand((b, n, d), dtype, misaligned=True),
             "augment/misaligned", L=L, n_shards=SHARDS)

    # times at the main path's shape: the means alone (f32 and bf16),
    # then the fused augment against the chain it replaced; each as an
    # event pair (``*ms``) and from the profiler's kernel records
    # (``*device_ms``)
    b, n, d, L = main
    s = n // L
    x = rand((b, n, d), torch.float32)
    xb = x.to(torch.bfloat16)
    out = torch.empty(b, L, d, device="cuda")
    b_ms, b_by = bound_ms(nbytes(x, out), x.numel())
    bf_ms, _ = bound_ms(nbytes(xb, out.to(torch.bfloat16)), x.numel())
    x_hat = torch.empty(b, n + SHARDS * L, d, device="cuda")
    a_ms, a_by = bound_ms(nbytes(x, x_hat), x.numel())
    m = SHARDS * L

    def chain(z):          # the unfused augment after the means
        z_rep = z.reshape(b // SHARDS, m, d)[:, None].expand(
            -1, SHARDS, m, d).reshape(b, m, d)
        return torch.cat([x, z_rep], dim=1)
    calls = {
        "": lambda: segment_means_op(x, L=L, backend="kernel"),
        "plain_": lambda: segment_means_op(x, L=L, backend="plain"),
        "library_": lambda: x.view(b, L, s, d).mean(2),
        "bf16_": lambda: segment_means_op(xb, L=L, backend="kernel"),
        "augment_": lambda: prism_augment_op(x, L=L, n_shards=SHARDS,
                                             backend="kernel"),
        "augment_plain_": lambda: prism_augment_op(
            x, L=L, n_shards=SHARDS, backend="plain"),
        "augment_library_": lambda: chain(x.view(b, L, s, d).mean(2)),
        # the parent's route: the means kernel, then expand and cat
        "augment_unfused_": lambda: chain(
            segment_means_op(x, L=L, backend="kernel")),
    }
    times = {}
    for tag, fn in calls.items():
        times[tag + "ms"] = timer(fn)
        times[tag + "device_ms"] = timer.device(fn)
    return {**times, "bound_ms": b_ms, "bound_by": b_by,
            "bf16_bound_ms": bf_ms, "augment_bound_ms": a_ms,
            "augment_bound_by": a_by,
            "shape": {"x": [b, n, d], "L": L, "P": SHARDS}}


def decode_inputs(torch, mode, gen, arch=ARCH, prompt=PROMPT):
    """A path's decode-kernel inputs at the last decode step (position
    prompt + gen - 2), at ``arch``'s widths, with the layout's own valid
    mask and means bias; ``mode`` 'ring' is a sliding-window layer's ring
    (one shard of W slots, ``valid`` wrapped)."""
    from repro_torch.configs import get_config
    from repro_torch.core.attention import log_repeats
    from repro_torch.runtime import serve as S
    from repro_torch.sharding.context import means_columns
    cfg = get_config(arch)
    hp = S.ServeHParams(decode_mode="exact" if mode == "ring" else mode,
                        means_cr=CR)
    cap = prompt + GEN + (-(prompt + GEN)) % SHARDS
    lay = S.make_layout(SHARDS, cap, hp, prefill_len=prompt)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = torch.full((BATCH,), prompt + GEN - 2, device="cuda")
    if mode == "ring":
        _, valid = S.ring_cols(S.ring_width(cfg, lay), cfg.window, pos)
        valid = valid[:, 0]
    else:
        _, _, col_pos = S._decode_cols(lay, pos)
        valid = (col_pos[None] <= pos[:, None, None]).reshape(
            BATCH * SHARDS, -1)

    def rnd(*shape):
        return 0.5 * torch.randn(*shape, device="cuda", generator=gen)
    args = [rnd(BATCH, 1, hq, hd), rnd(valid.shape[0], valid.shape[1], hkv,
                                       hd),
            rnd(valid.shape[0], valid.shape[1], hkv, hd), valid.contiguous()]
    if mode == "prism":
        m = SHARDS * lay.L
        cols = means_columns(SHARDS, lay.n_loc0, lay.L, pos.device)
        gz = S.prism_gz(cols, cols.sizes, pos)
        args += [log_repeats(gz).reshape(BATCH * SHARDS, m).contiguous(),
                 rnd(BATCH, m, hkv, hd), rnd(BATCH, m, hkv, hd)]
    return args, hd ** -0.5


def degraded_inputs(torch, mode, gen):
    """The degraded step's decode-kernel inputs at the main path's shape,
    sequence shard 1 lost (``serve_step(lost=...)``): the lost lane's
    exact columns dead; exact mode: the standby replica's means (random
    K/V, counts 1..segment size, a quarter of them dead) live on the lost
    lane only (``serve.replica_gz``); prism mode: the cache's means with
    the lost shard's own gate opened (``serve.prism_gz`` with ``lost``).
    The engine's exact placement is round-robin, prism's aligned."""
    from repro_torch.core.attention import log_repeats
    from repro_torch.runtime import serve as S
    from repro_torch.sharding.context import means_columns
    args, scale = decode_inputs(torch, mode, gen)
    hp = S.ServeHParams(decode_mode=mode, means_cr=CR)
    cap = PROMPT + GEN + (-(PROMPT + GEN)) % SHARDS
    lay = S.make_layout(SHARDS, cap, hp, prefill_len=PROMPT,
                        placement="rr" if mode == "exact" else "aligned")
    lost = torch.zeros(SHARDS, device="cuda")
    lost[1] = 1.0
    pos = torch.full((BATCH,), PROMPT + GEN - 2, device="cuda")
    _, _, col_pos = S._decode_cols(lay, pos)
    valid = (col_pos[None] <= pos[:, None, None]) & (lost == 0)[None, :,
                                                                  None]
    args[3] = valid.reshape(BATCH * SHARDS, -1).contiguous()
    m = SHARDS * lay.L
    if mode == "exact":
        hkv, hd = args[1].shape[2:]
        size = PROMPT // SHARDS // lay.L
        counts = torch.randint(1, size + 1, (BATCH, m), device="cuda",
                               generator=gen).float()
        counts[torch.rand(BATCH, m, device="cuda", generator=gen) < 0.25] = 0
        gz = S.replica_gz(counts, lost)
        args += [log_repeats(gz).reshape(BATCH * SHARDS, m).contiguous(),
                 0.5 * torch.randn(BATCH, m, hkv, hd, device="cuda",
                                   generator=gen),
                 0.5 * torch.randn(BATCH, m, hkv, hd, device="cuda",
                                   generator=gen)]
    else:
        cols = means_columns(SHARDS, lay.n_loc0, lay.L, pos.device)
        gz = S.prism_gz(cols, cols.sizes, pos, lost)
        args[4] = log_repeats(gz).reshape(BATCH * SHARDS, m).contiguous()
    return args, scale


def decode_bound(torch, q, k, valid, log_gz=None, kz=None, rows=None,
                 maps=()):
    """(bound ms, what bounds it, bytes) of one decode-stats call: each
    live cache column read once, however many query rows read it (the
    packed layout's tokens of one slot share their row), each live means
    column once per means row, q / valid / log g / the row map once, the
    stats written once; operations 4·hd per live (query head, column)
    pair, at the rate the card computes f32-accurate products on its
    tensor cores (3xTF32; a bf16 cache's bytes at 2 a value and its
    products at the bf16 rate), as the attention kernel's bound counts
    them:
    the least time the card could take, whatever this kernel's route.
    ``maps`` (a page table, a means-row map) are read once."""
    b, bq = valid.shape[0], q.shape[0]
    rep, (hq, hd), hkv = b // bq, q.shape[2:], k.shape[2]
    sel = (torch.arange(bq, device=q.device) if rows is None
           else rows.long().clamp(0, k.shape[0] // rep - 1))
    shard_row = (sel[:, None] * rep + torch.arange(rep, device=q.device)
                 ).reshape(-1)
    kv_live = torch.zeros(k.shape[:2], device=q.device).index_add_(
        0, shard_row, valid.float()) > 0
    n_bytes = (nbytes(q, valid)
               + 2 * int(kv_live.sum()) * hkv * hd * k.element_size()
               + 4 * (2 * b * hq + b * hq * hd))
    pairs = int(valid.sum())
    if kz is not None:
        live_z = log_gz > -1e29                                  # (B, m)
        pairs += int(live_z.sum())
        z_live = torch.zeros(kz.shape[:2], device=q.device).index_add_(
            0, sel.repeat_interleave(rep), live_z.float()) > 0
        n_bytes += (nbytes(log_gz) + 2 * int(z_live.sum()) * hkv * hd
                    * kz.element_size())
    if rows is not None:
        n_bytes += nbytes(rows)
    n_bytes += nbytes(*maps)                 # a page table, a means-row map
    b_ms, b_by = bound_ms(n_bytes, 4 * hd * hq * pairs,
                          BF16_FLOP_PER_S if k.dtype == torch.bfloat16
                          else F32_3XTF32_FLOP_PER_S)
    return b_ms, b_by, n_bytes


def time_decode(torch, timer, args, scale, rows=None, pages=None,
                zrows=None):
    """Kernel, plain version, library call and bound of one decode-stats
    call.  The library call reads the rows the row map (and the page
    table, the means-row map) selects, gathered outside the timed call.
    A paged call's bound counts the live columns of mapped pages and the
    page table (and means-row map)."""
    from repro_torch.kernels.decode_attention import (decode_stats,
                                                      gather_pages,
                                                      gather_rows)
    q, k, v, valid = args[:4]
    rep = valid.shape[0] // q.shape[0]
    lib_args = list(args)
    if pages is not None:                  # the dense rows the pages hold
        k_d, mapped = gather_pages(k, pages, rep)
        v_d, _ = gather_pages(v, pages, rep)
        sel = (torch.arange(q.shape[0], device=q.device) if rows is None
               else rows.long().clamp(0, pages.shape[0] - 1))
        lib_args[1:4] = [k_d, v_d, valid & mapped[sel].repeat_interleave(
            rep, dim=0)]
        if zrows is not None:
            lib_args[5:7] = [t.index_select(0, zrows.long())
                             for t in args[5:7]]
    bound_args = list(lib_args)
    if rows is not None:
        k_g, v_g, kz_g, vz_g = gather_rows(rows, rep, *lib_args[1:3],
                                           *lib_args[5:7])
        lib_args[1:3] = [k_g, v_g]
        if kz_g is not None:
            lib_args[5:7] = [kz_g, vz_g]
    lib_ms, lib_err = decode_library(torch, timer, lib_args, scale)
    b_ms, b_by, n_bytes = decode_bound(
        torch, q, bound_args[1], bound_args[3], *bound_args[4:6], rows=rows,
        maps=[t for t in (pages, zrows) if t is not None])

    def call(backend):
        return lambda: decode_stats(*args, scale=scale, rows=rows,
                                    pages=pages, zrows=zrows,
                                    backend=backend)
    return {"ms": timer(call("kernel")),
            "device_ms": timer.device(call("kernel")),
            "plain_ms": timer(call("plain")),
            "library_ms": lib_ms, "library_check": lib_err,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "shape": {"q": list(q.shape), "k": list(k.shape),
                      "rows": None if rows is None else list(rows.shape)}}


def tick_layout_inputs(torch, gen, arch=ARCH):
    """The decode kernel's inputs on the two tick paths at ``arch``'s full
    width.

    chunk: the C = 64 chunk's queries folded into the head axis, q (B, 1,
    64·Hq, hd), the whole cache rows (B·P, cap_l, Hkv, hd), valid =
    col_pos < off, at the offsets of every row the same (0, 64, 448) and
    staggered as in the chunked path's 8th call.

    packed: a T = 72 tick of the main layout: 6 decode tokens (slots
    0-5), 40 prompt tokens of slot 6 from offset 448 and 20 of slot 7
    from offset 64 (several tokens per cache row), 6 dead entries; the
    exact pass (valid = col_pos < off) and the prism pass (valid =
    col_pos <= pos, the means columns of each token's slot)."""
    from repro_torch.configs import get_config
    from repro_torch.core.attention import log_repeats
    from repro_torch.runtime import serve as S
    from repro_torch.sharding.context import means_columns
    cfg = get_config(arch)
    hp = S.ServeHParams(decode_mode="prism", means_cr=CR)
    cap = PROMPT + GEN + (-(PROMPT + GEN)) % SHARDS
    lay = S.make_layout(SHARDS, cap, hp, prefill_len=PROMPT)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = "cuda"

    def rnd(*shape):
        return 0.5 * torch.randn(*shape, device=dev, generator=gen)
    k = rnd(BATCH * SHARDS, lay.cap_l, hkv, hd)
    v = rnd(BATCH * SHARDS, lay.cap_l, hkv, hd)
    _, _, col_pos = S._decode_cols(lay, torch.zeros(1, dtype=torch.long,
                                                    device=dev))
    chunk = {}
    q = rnd(BATCH, 1, CHUNK_LEN * hq, hd)
    for name, off in (("off0", [0] * BATCH), ("off64", [64] * BATCH),
                      ("off448", [448] * BATCH),
                      ("staggered", [448, 448, 384, 384, 320, 320, 256,
                                     256])):
        off = torch.as_tensor(off, device=dev)
        valid = (col_pos[None] < off[:, None, None]).reshape(
            BATCH * SHARDS, -1)
        chunk[name] = [q, k, v, valid.contiguous()]

    slot = [*range(6), *[6] * 40, *[7] * 20, *[-1] * 6]
    pos = [PROMPT + 20 + s for s in range(6)] + list(range(448, 488)) + \
        list(range(64, 84)) + [-1] * 6
    off = [PROMPT + 20 + s for s in range(6)] + [448] * 40 + [64] * 20 + \
        [-1] * 6
    slot, pos, off = (torch.as_tensor(a, device=dev)
                      for a in (slot, pos, off))
    alive = slot >= 0
    rows = slot.clamp(min=0).to(torch.int32)
    t = slot.shape[0]
    q = rnd(t, 1, hq, hd)
    valid = alive[:, None, None] & (col_pos[None] < off[:, None, None])
    valid_le = alive[:, None, None] & (col_pos[None] <= pos[:, None, None])
    cols = means_columns(SHARDS, lay.n_loc0, lay.L, dev)
    gz = S.prism_gz(cols, cols.sizes, torch.where(alive, pos, -1))
    m = SHARDS * lay.L
    packed = [q, k, v, valid.reshape(t * SHARDS, -1).contiguous()]
    packed_prism = [q, k, v, valid_le.reshape(t * SHARDS, -1).contiguous(),
                    log_repeats(gz).reshape(t * SHARDS, m).contiguous(),
                    rnd(BATCH, m, hkv, hd), rnd(BATCH, m, hkv, hd)]
    return chunk, packed, packed_prism, rows, hd ** -0.5


def decode_checker(torch, chk, by_route, key=None, tol=None):
    """``both(args, scale, case, rows=None, **paged)``: the decode kernel
    against its plain version, the error filed under ``key`` (default
    the kernel's name) with ``Checker.stats``' ``tol``, the cases counted
    per route in ``by_route``."""
    from repro_torch.kernels.decode_attention import (decode_route,
                                                      decode_stats,
                                                      launch_route)
    from repro_torch.kernels.dispatch import LAUNCHES

    def both(args, scale, case, rows=None, **paged):
        """The routed kernel against the plain version (the call must
        take the route the wrapper's rule names) and, without a row map,
        the other route on the same inputs.  ``paged``: a page table and
        means-row map, whose pool pages and state rows that no row maps
        hold NaN: the outputs of both must be finite."""
        n_mq = LAUNCHES["flash_decode_stats.mq"]
        got = decode_stats(*args, scale=scale, rows=rows, backend="kernel",
                           **paged)
        route = "tile" if LAUNCHES["flash_decode_stats.mq"] > n_mq else "row"
        want_route = decode_route(args[0].shape[2], args[1].shape[2],
                                  rows is None)
        if route != want_route:
            raise AssertionError(f"flash_decode_stats [{case}]: took the "
                                 f"{route} route, the rule says "
                                 f"{want_route}")
        want = decode_stats(*args, scale=scale, rows=rows, backend="plain",
                            **paged)
        if not all(bool(torch.isfinite(t).all()) for t in want):
            raise AssertionError(f"flash_decode_stats [{case}]: the plain "
                                 "version is not finite")
        chk.stats(got, want, f"{case}/{route}", key=key, tol=tol)
        by_route[route] += 1
        if rows is None:
            other = "row" if route == "tile" else "tile"
            chk.stats(launch_route(other, *args, scale=scale, **paged), want,
                      f"{case}/{other}", key=key, tol=tol)
            by_route[other] += 1
    return both


# phase 3's bf16, mixed-dtype and head-dim 16 / 32 cases (the reference's
# kernels take them: attention, then decode): the head dims
# the bf16 instances build; each timed at a path's layout (GPT-2's for
# hd 64 and, with their head dim, for 16, 32 and 80; Yi-6B's for 128,
# Gemma 7B's for 256)
BF16_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
# the columns of the decode sweeps (a multiple of PAGE_COLS, so that the
# paged twin holds every column)
BF16_SWEEP_COLS = 72


def peaked(args):
    """The bf16 cases' draws from the f32 cases' (0.5 randn): q (index 0)
    times ``BF16_Q_GAIN``, V and the means' V (indices 2 and 6) times
    ``BF16_V_GAIN``; the rest as they are."""
    gain = {0: BF16_Q_GAIN, 2: BF16_V_GAIN, 6: BF16_V_GAIN}
    return [t * gain[i] if i in gain else t for i, t in enumerate(args)]


def at_width(torch, gen, args, hd, dtype):
    """A layout's inputs with every floating 4-D tensor (q, k, v; kz, vz)
    drawn anew at head dim ``hd`` in ``dtype`` (bf16: ``peaked``), the
    rest (metadata, valid, log g) as they are."""
    args = [0.5 * torch.randn(*t.shape[:-1], hd, device="cuda",
                              generator=gen)
            if t.dim() == 4 and t.is_floating_point() else t for t in args]
    if dtype == torch.bfloat16:
        args = peaked(args)
    return [t.to(dtype) if t.dim() == 4 and t.is_floating_point() else t
            for t in args]


def as_dtypes(torch, args, q_dtype, kv_dtype):
    """Inputs with q in ``q_dtype`` and the other floating 4-D tensors
    (k, v; kz, vz) in ``kv_dtype``."""
    return [t.to(q_dtype) if i == 0 else
            t.to(kv_dtype) if t.dim() == 4 and t.is_floating_point() else t
            for i, t in enumerate(args)]


def check_bf16_kernels(torch, chk, timer):
    """The bf16 instances and the new head dims against their plain
    versions, then timed.

    Every bf16 case draws ``peaked`` inputs.  Attention: bf16 at every
    head dim of ``BF16_HEAD_DIMS`` over ``attention_groups``' edge sweep
    (ragged, GQA 1, 4, 8, dead rows, rows that see few columns, g = 0,
    causal off, window, prefix), errors under
    ``prism_flash_attention/bf16`` at ``TOL_BF16_KERNEL``; f32 at head dim
    16 under ``prism_flash_attention/hd16`` at ``TOL``.  Decode: a bf16
    cache at every head dim, on both routes (group 1 and 8), with and
    without means, rows that see every 8th column, dense, through a
    page pool whose unmapped pages hold
    NaN (``to_pages``) and through a row map, under
    ``flash_decode_stats/bf16``; a bf16 query over an f32 cache at the
    engine's layouts (the packed tick's two passes, the chunk call, the
    static decode; dense and paged) under ``flash_decode_stats/mixed`` at
    ``TOL``; f32 at head dims 16 and 32 under
    ``flash_decode_stats/hd16_32``.  -> {"attention": {layout: times},
    "decode": {layout: times}, "cases_by_route": ...}."""
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(43)
    att_bf16 = attention_checker(chk, key="prism_flash_attention/bf16",
                                 tol=TOL_BF16_KERNEL)
    att_hd16 = attention_checker(chk, key="prism_flash_attention/hd16")
    for hd in BF16_HEAD_DIMS:
        attention_groups(torch, att_bf16, gen, ((8, 8), (8, 2), (8, 1)), hd,
                         bf)
    attention_groups(torch, att_hd16, gen, ((8, 8), (8, 2), (8, 1)), 16)

    ta = {}
    for mode in ("prism", "voltage"):
        ta[f"hd64/{mode}"] = attention_main(
            torch, timer, att_bf16, mode, tag="bf16",
            args=as_dtypes(torch, peaked(attention_inputs(torch, mode)), bf,
                           bf),
            flop_per_s=BF16_FLOP_PER_S)
    for hd, arch in ((128, LLAMA), (256, GEMMA7)):
        ta[f"hd{hd}/prism"] = attention_main(
            torch, timer, att_bf16, "prism", arch=arch, tag=f"bf16/{arch}",
            args=as_dtypes(torch, peaked(attention_inputs(
                torch, "prism", arch=arch)), bf, bf),
            flop_per_s=BF16_FLOP_PER_S)
    base = attention_inputs(torch, "prism")
    for hd in (16, 32, 80):
        ta[f"hd{hd}/prism"] = attention_main(
            torch, timer, att_bf16, "prism", tag=f"bf16/hd{hd}",
            args=at_width(torch, gen, base, hd, bf),
            flop_per_s=BF16_FLOP_PER_S)
    ta["f32/hd16/prism"] = attention_main(
        torch, timer, att_hd16, "prism", tag="hd16",
        args=at_width(torch, gen, base, 16, f32))

    by_route = {"row": 0, "tile": 0}
    dec = {key: decode_checker(torch, chk, by_route, key=key, tol=tol)
           for key, tol in (("flash_decode_stats/bf16", TOL_BF16_KERNEL),
                            ("flash_decode_stats/mixed", None),
                            ("flash_decode_stats/hd16_32", None))}

    def every_layout(both, q_dtype, kv_dtype, rep):
        """``both`` on the inputs in (q_dtype, kv_dtype), dense (both
        routes), through a page pool (both routes) and through a row map
        that reverses the query rows (the row route)."""
        def run(args, scale, case):
            if kv_dtype == bf:
                args = peaked(args)
            args = as_dtypes(torch, args, q_dtype, kv_dtype)
            both(args, scale, case)
            pargs, pages, zrows = to_pages(torch, gen, args, rep,
                                           args[1].shape[1])
            both(pargs, scale, f"{case}/paged", pages=pages, zrows=zrows)
            rows = torch.arange(args[0].shape[0], device="cuda",
                                dtype=torch.int32).flip(0)
            both(args, scale, f"{case}/rows", rows=rows)
        return run
    for key, q_dtype, kv_dtype, dims in (
            ("flash_decode_stats/bf16", bf, bf, BF16_HEAD_DIMS),
            ("flash_decode_stats/hd16_32", f32, f32, (16, 32))):
        for hd in dims:
            for hq, hkv in ((4, 4), (16, 2)):     # groups 1 (row), 8 (tile)
                sweep_decode_case(
                    torch, every_layout(dec[key], q_dtype, kv_dtype, 4), gen,
                    hq, hkv, BF16_SWEEP_COLS, 4, 12, None, hd=hd,
                    few_live=True)
    chunk, packed, packed_prism, rows, scale = tick_layout_inputs(torch, gen)
    mixed = dec["flash_decode_stats/mixed"]
    for name, args, r in (("packed", packed, rows),
                          ("packed_prism", packed_prism, rows),
                          ("chunk", chunk["off448"], None)):
        args = as_dtypes(torch, args, bf, f32)
        mixed(args, scale, f"mixed/{name}", rows=r)
        rep = args[3].shape[0] // args[0].shape[0]
        pargs, pages, zrows = to_pages(torch, gen, args, rep,
                                       args[1].shape[1])
        mixed(pargs, scale, f"mixed/{name}/paged", rows=r, pages=pages,
              zrows=zrows)

    td = {}
    for mode in ("exact", "prism"):
        for hd, arch in ((64, ARCH), (128, LLAMA), (256, GEMMA7)):
            args, sc = decode_inputs(torch, mode, gen, arch=arch)
            args = as_dtypes(torch, peaked(args), bf, bf)
            dec["flash_decode_stats/bf16"](args, sc, f"bf16/{arch}/{mode}")
            td[f"hd{hd}/{mode}"] = time_decode(torch, timer, args, sc)
    base, _ = decode_inputs(torch, "prism", gen)
    for hd, dtype in ((16, bf), (32, bf), (80, bf), (16, f32), (32, f32)):
        args = at_width(torch, gen, base, hd, dtype)
        key = "bf16" if dtype == bf else "hd16_32"
        dec[f"flash_decode_stats/{key}"](args, hd ** -0.5,
                                         f"{key}/hd{hd}/prism")
        td[f"{'f32/' if dtype == f32 else ''}hd{hd}/prism"] = time_decode(
            torch, timer, args, hd ** -0.5)
    for name, args in (("packed", packed), ("packed_prism", packed_prism)):
        td[f"mixed/{name}"] = time_decode(
            torch, timer, as_dtypes(torch, args, bf, f32), scale, rows=rows)
    return {"attention": ta, "decode": td, "cases_by_route": by_route}


def instance_row(name, kernel, t, launches, chk, key, tol, by_layout):
    """The kernels line's row of one new instance: its times at its main
    layout ``t`` (ms, device_ms, plain_ms, bound, library), its launches
    on the paths, its largest error under ``key`` and every layout's
    times (``by_layout``)."""
    src, rep = SOURCES[kernel]
    pick = lambda t: {k: t[k] for k in TIME_KEYS + (  # noqa: E731
        "library_note", "shape") if k in t}
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": chk.max_err.get(key, 0.0),
            "tol": list(tol), "tol_share": chk.tol_share.get(key, 0.0),
            "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "by_layout": {k: pick(v) for k, v in by_layout.items()}}


def check_decode(torch, chk, timer):
    gen = torch.Generator(device="cuda").manual_seed(3)
    by_route = {"row": 0, "tile": 0}
    both = decode_checker(torch, chk, by_route)

    times, dec_args = {}, {}
    for mode in ("exact", "prism"):
        args, scale = decode_inputs(torch, mode, gen)
        both(args, scale, f"main/{mode}")
        times[mode] = time_decode(torch, timer, args, scale)
        dec_args[mode] = args

    # the tick paths' layouts: the chunk's folded queries over the whole
    # cache rows, the packed tokens through the row map
    chunk, packed, packed_prism, rows, scale = tick_layout_inputs(torch, gen)
    for name, args in chunk.items():
        both(args, scale, f"chunk/{name}")
    both(packed, scale, "packed/exact", rows=rows)
    both(packed_prism, scale, "packed/prism", rows=rows)
    times["chunk"] = time_decode(torch, timer, chunk["off448"], scale)
    t = times["chunk"]
    t["library_folded_ms"], t["library_folded_check"] = (
        t["library_ms"], t["library_check"])
    t["library_ms"], t["library_check"], t["library_bias"] = chunk_library(
        torch, timer, chunk["off448"], scale, CHUNK_LEN)
    t.update(time_routes(torch, timer, chunk["off448"], scale))
    times["crossover"] = crossover(torch, timer, chunk["off448"], scale, gen)
    times["packed"] = time_decode(torch, timer, packed, scale, rows=rows)
    times["packed_prism"] = time_decode(torch, timer, packed_prism, scale,
                                        rows=rows)
    # the same layouts over the page pool (the engine's paged cache)
    times["paged"] = check_paged(torch, chk, timer, both, gen, {
        "decode": (dec_args["exact"], None, None),
        "decode_prism": (dec_args["prism"], None, None),
        "packed": (packed, rows, "packed"),
        "packed_prism": (packed_prism, rows, "packed_prism"),
        "chunk": (chunk["off448"], None, "chunk")}, scale, times)
    # the degraded step's configurations over the page pool: exact with
    # the replica's means on the lost lane (its rows are the cache rows:
    # no means-row map), prism with the lost shard's own means opened
    times["degraded"] = {}
    for mode in ("exact", "prism"):
        args, _ = degraded_inputs(torch, mode, gen)
        both(args, scale, f"degraded/{mode}")
        pargs, pages, zrows = to_pages(torch, gen, args, SHARDS,
                                       args[1].shape[1])
        if mode == "exact":
            pargs[5:7], zrows = args[5:7], None
        both(pargs, scale, f"paged/degraded/{mode}", pages=pages,
             zrows=zrows)
        t = time_decode(torch, timer, pargs, scale, pages=pages,
                        zrows=zrows)
        t["healthy_ms"] = times["paged"][
            "decode" if mode == "exact" else "decode_prism"]["ms"]
        times["degraded"][mode] = t
    # one mapped page NaN-filled: exactly the rows that read it come out
    # non-finite, on each route (the engine's quarantine relies on it)
    times["poisoned"] = check_poisoned(torch, chk, gen, {
        "decode": (dec_args["exact"], None),
        "decode_prism": (dec_args["prism"], None),
        "packed": (packed, rows),
        "chunk": (chunk["off448"], None)}, scale)

    # edge sweep: GQA groups 1/3/12 and a folded 64, ragged M, all-dead
    # rows, g = 0 means columns, shards folded into the batch (rep > 1);
    # then M and the means count off the 64-column pass, rows whose
    # later passes and warps hold no live column, rows of many passes,
    # and groups of 40 and 128 heads (more than one block of 32 heads of
    # the row route); each case on both routes
    for hq, hkv, m_loc, rep, mz, max_pos in (
            (12, 12, 100, 1, 37, None), (12, 4, 33, 4, 37, None),
            (12, 1, 130, 2, 37, None), (64, 1, 70, 4, 37, None),
            (6, 3, 7, 1, 37, None), (8, 2, 65, 2, 37, None),
            (4, 4, 200, 3, 37, None),
            (12, 12, 300, 4, 100, None), (12, 4, 300, 2, 100, 20),
            (64, 1, 190, 2, 70, 60), (12, 1, 700, 2, 37, None),
            (24, 8, 450, 3, 129, 130), (40, 1, 90, 2, 37, 50),
            (128, 1, 70, 2, 37, None)):
        sweep_decode_case(torch, both, gen, hq, hkv, m_loc, rep, mz, max_pos)
    # the row map: repeats and out-of-range entries (clamped), every entry
    # equal, T = 1, T not a multiple of 4, rep 1 and 4
    for t, n_rows, rep, hq, hkv, kind in (
            (72, 8, 4, 12, 12, "repeats"), (7, 3, 1, 12, 12, "equal"),
            (1, 8, 4, 12, 12, "repeats"), (13, 5, 4, 12, 4, "clamped"),
            (30, 2, 2, 64, 1, "repeats"), (9, 4, 1, 12, 3, "equal")):
        sweep_rows_case(torch, both, gen, t, n_rows, rep, hq, hkv, kind)
    # the tile route's edges, on both routes: a group of 64 with means
    # whose g is 0 in whole tiles and scattered columns; a row whose only
    # live column is the last of a ragged local tile (M = 144, 4.5 tiles)
    # or of a ragged means tile (37 columns); groups of 4 (the rule's
    # threshold) and 3 (the row route's by the rule) over 12 KV heads, of
    # 16 alone and over 12 KV heads; rep 1 and 4
    for hq, hkv, m_loc, rep, mz, kind in (
            (64, 1, 144, 4, 128, "dead_means"), (128, 2, 144, 1, 64,
                                                 "dead_means"),
            (64, 1, 144, 4, 37, "last_local"), (64, 2, 144, 1, 37,
                                                "last_means"),
            (4 * 12, 12, 144, 4, 128, "random"), (3 * 12, 12, 144, 4, 37,
                                                  "random"),
            (16, 1, 144, 4, 37, "random"), (16 * 12, 12, 144, 4, 128,
                                            "random"),
            (40, 1, 100, 1, 37, "random"), (128, 1, 70, 4, 37, "random")):
        sweep_tile_case(torch, both, gen, hq, hkv, m_loc, rep, mz, kind)
    times["cases_by_route"] = by_route
    return times


def check_head_dim_128(torch, chk, timer):
    """Phase 3 at the Llama family's head dim of 128 (Yi-6B's widths):
    ``check_family``'s layouts at Yi's widths (a group of 8: its static
    decode takes the tile route), then GQA groups 1, 3 and 8 over ragged
    Nq and M, and a sweep of both decode routes (groups 1 to 128, ragged
    M and means, row maps, a 68 KB row-route block).  Errors are filed
    under ``<kernel>/hd128``."""
    out = check_family(torch, chk, timer, LLAMA, "hd128", 11)
    gen = torch.Generator(device="cuda").manual_seed(12)
    both = attention_checker(chk, key="prism_flash_attention/hd128")
    attention_groups(torch, both, gen, ((8, 8), (12, 4), (32, 4)), 128)
    both = decode_checker(torch, chk, out["decode"]["cases_by_route"],
                          key="flash_decode_stats/hd128")
    for hq, hkv, m_loc, rep, mz, max_pos in (
            (8, 8, 100, 1, 37, None), (12, 4, 33, 4, 37, None),
            (32, 4, 300, 2, 100, 20), (8, 1, 190, 2, 70, 60),
            (40, 1, 90, 2, 37, 50)):
        sweep_decode_case(torch, both, gen, hq, hkv, m_loc, rep, mz,
                          max_pos, hd=128)
    for t, n_rows, rep, hq, hkv, kind in (
            (72, 8, 4, 32, 4, "repeats"), (13, 5, 4, 32, 4, "clamped"),
            (9, 4, 1, 12, 3, "equal"), (30, 2, 2, 32, 1, "repeats")):
        sweep_rows_case(torch, both, gen, t, n_rows, rep, hq, hkv, kind,
                        hd=128)
    for hq, hkv, m_loc, rep, mz, kind in (
            (32, 4, 144, 4, 128, "dead_means"),
            (64, 1, 144, 4, 37, "last_local"),
            (32, 4, 144, 1, 37, "last_means"),
            (128, 1, 70, 4, 37, "random")):
        sweep_tile_case(torch, both, gen, hq, hkv, m_loc, rep, mz, kind,
                        hd=128)
    return out


def window_tiles_case(torch, both, gen, hd):
    """A window that drops whole early tiles: the window augment's
    per-shard metadata at 200 rows a shard and a window of 40 (one shard
    of halo, g = 0 before position 0; a query tile sees at most 103 of
    its 400 columns), 4 query heads over 1 KV head."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models.layers import AttnSpec
    from repro_torch.sharding.context import ShardedPrismContext
    ctx = ShardedPrismContext(PrismConfig(P=SHARDS, L=2, mode="voltage"),
                              n_shards=SHARDS, backend="plain")
    spec = AttnSpec(d_model=8, n_heads=4, n_kv_heads=1, head_dim=hd,
                    window=40)
    _, akv = ctx.augment(torch.zeros(2 * SHARDS, 200, 8, device="cuda"),
                         spec)
    m = akv.col_lo.shape[1]

    def rnd(*shape):
        return 0.5 * torch.randn(*shape, device="cuda", generator=gen)
    both((rnd(2 * SHARDS, 200, 4, hd), rnd(2 * SHARDS, m, 1, hd),
          rnd(2 * SHARDS, m, 1, hd), akv.g, akv.col_lo, akv.col_hi,
          akv.row_pos), f"window/tiles/hd{hd}", window=40)


def check_head_dim_256(torch, chk, timer):
    """Phase 3 at Gemma 3 1B's head dim of 256 and width of 1152: prefill
    attention at its global PRISM, global Voltage and local (windowed)
    shapes, GQA groups 1, 3 and 4 over ragged Nq and M, a window that
    drops whole early tiles with halo columns at g = 0; segment means and
    the augment at D 1152; the decode kernel at Gemma's global static
    layout (exact and prism) and its ring (``valid`` wrapped, the first
    slots the newest positions), each on both routes and timed, and a
    sweep of both routes (groups 3 to 32, ragged M and means, row maps).
    Errors are filed under ``<kernel>/hd256`` (``segment_means/d1152``)."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(13)
    both = attention_checker(chk, key="prism_flash_attention/hd256")
    kw = dict(arch=GEMMA, tag="gemma", prompt=GEMMA_PROMPT)
    out["attention"] = {
        "prism": attention_main(torch, timer, both, "prism", **kw),
        "voltage": attention_main(torch, timer, both, "voltage", **kw),
        "local": attention_main(torch, timer, both, "voltage",
                                kind="attn_local", **kw)}
    attention_groups(torch, both, gen, ((4, 4), (3, 1), (4, 1)), 256)
    window_tiles_case(torch, both, gen, 256)
    out["segment_means"] = check_segment_means(
        torch, chk, timer, d=1152, prompt=GEMMA_PROMPT,
        key="segment_means/d1152")

    by_route = {"row": 0, "tile": 0}
    both = decode_checker(torch, chk, by_route,
                          key="flash_decode_stats/hd256")
    times = {}
    for mode in ("exact", "prism", "ring"):
        args, scale = decode_inputs(torch, mode, gen, arch=GEMMA,
                                    prompt=GEMMA_PROMPT)
        both(args, scale, f"gemma/{mode}")
        times[mode] = time_decode(torch, timer, args, scale)
        times[mode].update(time_routes(torch, timer, args, scale))
    # groups 4 (Gemma), 3 (the row route's by the rule), 12 (the row
    # route's partials past 48 KB), 16 and 32 (133 KB of them); ragged M
    # and means, dead rows
    for hq, hkv, m_loc, rep, mz, max_pos in (
            (4, 1, 100, 4, 37, None), (3, 1, 33, 2, 37, None),
            (12, 1, 190, 2, 70, 60), (16, 2, 300, 1, 100, 20),
            (32, 1, 90, 2, 37, 50)):
        sweep_decode_case(torch, both, gen, hq, hkv, m_loc, rep, mz,
                          max_pos, hd=256)
    for t, n_rows, rep, hq, hkv, kind in (
            (13, 5, 4, 4, 1, "clamped"), (9, 4, 1, 12, 1, "equal")):
        sweep_rows_case(torch, both, gen, t, n_rows, rep, hq, hkv, kind,
                        hd=256)
    for hq, hkv, m_loc, rep, mz, kind in (
            (4, 1, 144, 4, 128, "dead_means"),
            (4, 1, 144, 4, 37, "last_local"),
            (16, 1, 144, 1, 37, "last_means"),
            (20, 1, 70, 4, 37, "random")):
        sweep_tile_case(torch, both, gen, hq, hkv, m_loc, rep, mz, kind,
                        hd=256)
    times["cases_by_route"] = by_route
    out["decode"] = times
    return out


def check_family(torch, chk, timer, arch, tag, seed):
    """Phase 3 at a family's own layouts (Yi-6B's, and phases 11, 12, 14,
    15, 16 and 18's: OLMoE's 16 heads of 128 and D 2048, Gemma 7B's 16
    heads of 256 and D 3072, PaliGemma's 8 query heads over 1 KV head of
    256 and D 2048, Command-R's 64 query heads over 8 of 128 and D 8192,
    MusicGen's 24 heads of 64 (group 1: the decode kernel's row route)
    and D 1536, Zamba2's 32 heads of 80 (group 1) and D 2560):
    prefill attention at its PRISM and Voltage shapes (a vlm's with its
    image prefix, then ``prefix_cases``); segment means and the augment
    at its width; the decode kernel at its static decode (exact and
    prism, no row map: the route the rule names, the other on the same
    inputs, both timed); where the family runs the tick programs (token
    prompts and position-addressed caches only: no frontend, no
    recurrent block), its chunk layout (the C = 64
    queries folded into the head axis: the tile route, at head dim 256
    ``decode_stats_mq_split_kernel``), its packed layouts through the row
    map, each again over the page pool, and a poisoned page.  Errors are
    filed under ``<kernel>/<tag>``."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.ticks import check_tick_kinds
    cfg = get_config(arch)
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    both = attention_checker(chk, key=f"prism_flash_attention/{tag}")
    out["attention"] = {mode: attention_main(torch, timer, both, mode,
                                             arch=arch, tag=tag,
                                             prefix_len=cfg.prefix_len)
                        for mode in ("prism", "voltage")}
    if cfg.prefix_len:
        prefix_cases(torch, both, arch, tag)
    out["segment_means"] = check_segment_means(
        torch, chk, timer, d=cfg.d_model, key=f"segment_means/{tag}")
    key = f"flash_decode_stats/{tag}"
    by_route = {"row": 0, "tile": 0}
    both = decode_checker(torch, chk, by_route, key=key)
    times, dec_args = {}, {}
    for mode in ("exact", "prism"):
        args, scale = decode_inputs(torch, mode, gen, arch=arch)
        both(args, scale, f"{tag}/{mode}")
        times[mode] = time_decode(torch, timer, args, scale)
        times[mode].update(time_routes(torch, timer, args, scale))
        dec_args[mode] = args
    times["cases_by_route"] = by_route
    out["decode"] = times
    try:
        check_tick_kinds(cfg, "the tick programs")
    except ValueError:   # a vlm's image, an audio prompt, Zamba2's blocks
        return out
    chunk, packed, packed_prism, rows, scale = tick_layout_inputs(
        torch, gen, arch=arch)
    for name in ("off0", "off448", "staggered"):
        both(chunk[name], scale, f"{tag}/chunk/{name}")
    both(packed, scale, f"{tag}/packed/exact", rows=rows)
    both(packed_prism, scale, f"{tag}/packed/prism", rows=rows)
    times["chunk"] = time_decode(torch, timer, chunk["off448"], scale)
    times["packed"] = time_decode(torch, timer, packed, scale, rows=rows)
    times["packed_prism"] = time_decode(torch, timer, packed_prism, scale,
                                        rows=rows)
    times["paged"] = check_paged(torch, chk, timer, both, gen, {
        "decode": (dec_args["exact"], None, None),
        "decode_prism": (dec_args["prism"], None, None),
        "chunk": (chunk["off448"], None, "chunk"),
        "packed": (packed, rows, "packed"),
        "packed_prism": (packed_prism, rows, "packed_prism")}, scale, times)
    times["poisoned"] = check_poisoned(torch, chk, gen, {
        "decode": (dec_args["exact"], None),
        "decode_prism": (dec_args["prism"], None),
        "packed": (packed, rows), "chunk": (chunk["off448"], None)},
        scale, key=key)
    return out


# where a vlm's image prefix ends, as placed against its path's layout
# (prompt 512 over 4 shards of 128 rows, PRISM means of 4 rows; the
# kernel's query tiles are 64 rows, its column tiles 32): on a tile
# boundary inside shard 0, inside a 32-column tile, inside shard 1, on
# the shard boundary after two whole shards (PaliGemma's 256), inside
# shard 2; each end but 64 and 256 inside a means segment
PREFIX_ENDS = (64, 50, 202, 256, 301)


def prefix_cases(torch, both, arch, tag):
    """The attention kernel at a vlm's PRISM and Voltage shapes with the
    image prefix ending at each of ``PREFIX_ENDS``: a column wholly
    inside the prefix is visible to every row (a tile past the query
    rows must not be skipped), a means column whose segment reaches past
    the prefix takes the causal rule."""
    for mode in ("prism", "voltage"):
        args = attention_inputs(torch, mode, seed=5, arch=arch)
        for end in PREFIX_ENDS:
            both(args, f"{tag}/{mode}/prefix{end}", causal=True,
                 prefix_len=end)


# phase 13's encoders: arch -> (key in the kernels line, batch, tokens,
# the runs' (exchange, CR)); P = SHARDS.  ViT's 197 tokens split
# 49/49/49/50 (Alg. 1), padded to 50 rows a shard
ENCODERS = {"bert-base": ("bert", 32, 512, (("voltage", CR), ("prism", CR),
                                            ("prism", 128.0))),
            "vit-b16": ("vit", 64, 197, (("voltage", CR), ("prism", CR)))}


def encoder_run_key(mode, cr):
    return mode if mode == "voltage" else f"{mode}-cr{cr:g}"


def check_encoder_kernels(torch, chk, timer):
    """Phase 3 at the encoders' layouts (phase 13's), ``check_family``'s
    sibling without the decode part (encoders do not decode): the
    prefill kernel non-causal at each run's shapes (BERT-base PRISM at
    CR 4 and 128, Voltage; ViT-B/16 PRISM and Voltage over the uneven
    split), the augment at each PRISM layout (ViT's means over 49 real
    rows of three shards and 50 of the last) and a ragged sweep of the
    uneven split.  Errors are filed under ``<kernel>/<key>``."""
    from repro_torch.configs import get_config
    out = {}
    for arch, (key, batch, n, runs) in ENCODERS.items():
        both = attention_checker(chk, key=f"prism_flash_attention/{key}")
        att = {}
        for mode, cr in runs:
            run = encoder_run_key(mode, cr)
            args = attention_inputs(torch, mode, arch=arch, prompt=n,
                                    batch=batch, cr=cr, seed=23)
            att[run] = attention_main(torch, timer, both, mode, arch=arch,
                                      tag=f"{key}/{run}", args=args,
                                      causal=False)
        means = {encoder_run_key(mode, cr): encoder_augment(
            torch, chk, timer, get_config(arch).d_model, batch, n,
            int(n // (cr * SHARDS)), key)
            for mode, cr in runs if mode == "prism"}
        out[key] = {"attention": att, "segment_means": means}
    encoder_augment_sweep(torch, chk)
    return out


def encoder_augment(torch, chk, timer, d, batch, n, L, key):
    """The augment at an encoder's PRISM layout: ``batch`` sequences of
    ``n`` tokens over the shards (the P - 1 first with n // P real rows,
    the last with the rest, each padded to the last's), checked against
    its plain version, then timed: kernel, plain, bound (x read once,
    x_hat written once) and, where the split is even, the library chain
    of a segment mean (``mean(2)``), expand and cat."""
    from repro_torch.kernels.segment_means import prism_augment_op
    name = "segment_means"
    s, r = divmod(n, SHARDS)
    gen = torch.Generator(device="cuda").manual_seed(29)
    x = torch.randn(batch * SHARDS, s + r, d, device="cuda", generator=gen)
    kw = dict(L=L, n_shards=SHARDS, n_real=s)
    got = prism_augment_op(x, backend="kernel", **kw)
    chk.close(name, got, prism_augment_op(x, backend="plain", **kw),
              f"{key}/augment/n{n}/L{L}", key=f"{name}/{key}")
    chk.cases[name] += 1
    if not torch.equal(got[:, :s + r], x):
        raise AssertionError(f"{name} [{key}]: the local rows are not "
                             "copied exactly")
    b_ms, b_by = bound_ms(nbytes(x, got), batch * n * d)
    out = {"ms": timer(lambda: prism_augment_op(x, backend="kernel", **kw)),
           "device_ms": timer.device(lambda: prism_augment_op(
               x, backend="kernel", **kw)),
           "plain_ms": timer(lambda: prism_augment_op(
               x, backend="plain", **kw), iters=10),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "shape": {"x": list(x.shape), "L": L, "P": SHARDS,
                     "n_real": s, "n": n}}
    if r == 0 and s % L == 0:
        m = SHARDS * L

        def chain():
            z = x.view(batch * SHARDS, L, s // L, d).mean(2)
            z = z.reshape(batch, m, d)[:, None].expand(
                -1, SHARDS, m, d).reshape(batch * SHARDS, m, d)
            return torch.cat([x, z], dim=1)
        out["library_ms"] = timer(chain)
        out["library_note"] = "mean(2) over a reshape, expand, cat"
    else:
        out["library_note"] = ("no PyTorch call takes the uneven split's "
                               "segments")
    return out


def encoder_augment_sweep(torch, chk):
    """The augment's uneven split over ragged cases, f32 and bf16: (B·P,
    n_loc, D, L, P, n_real) with L = 1 and L = n_real, D 33 and 5, P 1, 2
    and 4, pad rows of 1 to 5, and a base off 16-byte alignment."""
    from repro_torch.kernels.segment_means import prism_augment_op
    name = "segment_means"
    gen = torch.Generator(device="cuda").manual_seed(31)
    cases = [(8, 50, 768, 12, 4, 49), (8, 50, 768, 1, 4, 49),
             (8, 50, 768, 49, 4, 49), (6, 17, 33, 4, 2, 13),
             (4, 9, 5, 3, 4, 6), (3, 20, 768, 5, 1, 15),
             (4, 67, 768, 16, 2, 65), (8, 130, 64, 32, 4, 128)]
    for dtype in (torch.float32, torch.bfloat16):
        tag = "" if dtype == torch.float32 else "/bf16"
        for case in cases + [None]:
            bp, n, d, L, p, n_real = case or cases[0]
            flat = torch.randn(bp * n * d + 1, device="cuda",
                               generator=gen).to(dtype)
            x = (flat[1:] if case is None else flat[:-1]).view(bp, n, d)
            kw = dict(L=L, n_shards=p, n_real=n_real)
            got = prism_augment_op(x, backend="kernel", **kw)
            want = prism_augment_op(x, backend="plain", **kw)
            what = ("uneven/misaligned" if case is None else
                    f"uneven/bp{bp}/n{n}/d{d}/L{L}/P{p}/real{n_real}")
            chk.close(name, got, want, what + tag, key=name + tag,
                      tol=None if not tag else TOL_BF16)
            chk.cases[name] += 1
            if not torch.equal(got[:, :n], x):
                raise AssertionError(f"{name} [{what}{tag}]: the local "
                                     "rows are not copied exactly")


PAGE_COLS = 4                        # the engine's default page: 16 tokens
SPARE_PAGES = 32                     # pool pages that no row maps


def to_pages(torch, gen, args, rep, n_cols):
    """The decode inputs ``args`` over the first ``n_cols`` columns of
    their cache rows, laid out as the engine's paged cache holds them:
    the K/V rows in a pool of ``PAGE_COLS``-column pages under a page
    table that is a seeded permutation of the pool, with ``SPARE_PAGES``
    more pages and 0, 1 or 2 unmapped tail pages a row; the means rows in
    a state pool of two rows more than the cache rows, under a permuted
    means-row map.  Every pool page and state row that nothing maps is
    NaN.  Returns (paged args, pages, zrows or None)."""
    q, k, v, valid = args[:4]
    n_rows = k.shape[0] // rep
    ppr = n_cols // PAGE_COLS
    n_pages = n_rows * ppr + SPARE_PAGES
    dev = k.device
    perm = torch.randperm(n_pages, device=dev, generator=gen)
    pages = perm[:n_rows * ppr].view(n_rows, ppr).to(torch.int32)
    for r in range(n_rows):
        if r % 3:
            pages[r, ppr - r % 3:] = -1
    mapped = pages >= 0

    def pool(x):
        out = torch.full((n_pages, rep, PAGE_COLS, *x.shape[2:]),
                         float("nan"), device=dev, dtype=x.dtype)
        src = x[:, :n_cols].reshape(n_rows, rep, ppr, PAGE_COLS,
                                    *x.shape[2:]).transpose(1, 2)
        out[pages[mapped].long()] = src[mapped]
        return out.view(n_pages * rep, PAGE_COLS, *x.shape[2:])
    paged = [q, pool(k), pool(v), valid[:, :n_cols].contiguous()]
    zrows = None
    if len(args) > 4:
        log_gz, kz, vz = args[4:]
        n_state = n_rows + 2
        zrows = torch.randperm(n_state, device=dev, generator=gen)[
            :n_rows].to(torch.int32)

        def state(x):
            out = torch.full((n_state, *x.shape[1:]), float("nan"),
                             device=dev, dtype=x.dtype)
            out[zrows.long()] = x
            return out
        paged += [log_gz, state(kz), state(vz)]
    return paged, pages, zrows


def check_paged(torch, chk, timer, both, gen, layouts, scale, dense):
    """The decode kernel over the page pool at each of the main path's
    layouts (static decode exact and prism, the packed tick's two passes
    through the row map, the chunk layout at offset 448 over the rows'
    prefill pages): checked against the plain version on both routes
    where no row map is given, then timed beside the dense layout's
    time from this call (``dense_ms``)."""
    from repro_torch.kernels.decode_attention import (gather_pages,
                                                      gather_rows)
    out = {}
    n_loc0 = PROMPT // SHARDS
    for name, (args, rows, dense_key) in layouts.items():
        rep = args[3].shape[0] // args[0].shape[0]
        n_cols = n_loc0 if name == "chunk" else args[1].shape[1]
        pargs, pages, zrows = to_pages(torch, gen, args, rep, n_cols)
        both(pargs, scale, f"paged/{name}", rows=rows, pages=pages,
             zrows=zrows)
        t = time_decode(torch, timer, pargs, scale, rows=rows, pages=pages,
                        zrows=zrows)
        # the reference's route: every row's pages gathered into a copy
        # (``_gather_pages``), then the library call on the copy
        def gather():
            k_g, _ = gather_pages(pargs[1], pages, rep)
            v_g, _ = gather_pages(pargs[2], pages, rep)
            if rows is not None:
                k_g, v_g, _, _ = gather_rows(rows, rep, k_g, v_g)
            if zrows is not None:
                pargs[5].index_select(0, zrows.long())
                pargs[6].index_select(0, zrows.long())
        t["gather_ms"] = timer(gather)
        if name == "chunk":          # the library call at its natural layout
            k_d, mapped = gather_pages(pargs[1], pages, rep)
            v_d, _ = gather_pages(pargs[2], pages, rep)
            valid = pargs[3] & mapped.repeat_interleave(rep, dim=0)
            t["library_folded_ms"] = t["library_ms"]
            t["library_ms"], t["library_check"], _ = chunk_library(
                torch, timer, [pargs[0], k_d, v_d, valid], scale, CHUNK_LEN)
        t["library_ms"] = (None if t["library_ms"] is None
                           else t["gather_ms"] + t["library_ms"])
        key = dense_key or ("exact" if name == "decode" else "prism")
        t["dense_ms"] = dense[key]["ms"]
        t["dense_device_ms"] = dense[key]["device_ms"]
        t["pages"] = list(pages.shape)
        t["mapped_pages"] = int((pages >= 0).sum())
        out[name] = t
    return out


def check_poisoned(torch, chk, gen, layouts, scale, key=None):
    """The decode kernel over a page pool (``to_pages``) in which one
    mapped page, the first of the cache row that query row 0 reads,
    holds NaN in its K and V: the output rows that read a live column of
    it (every shard of that cache row, every token of it in the packed
    layout) must come out non-finite on the route the rule names and,
    without a row map, on the other route too; every other row must
    match the plain version on the pool without the poison.  The row
    route's max drops a NaN score (``fmaxf``), so the NaN gets through in
    ``exp(s - m)``; the tile route's must survive the TF32 split and the
    tensor-core products."""
    from repro_torch.kernels.decode_attention import (decode_route,
                                                      decode_stats,
                                                      launch_route)
    out = {}
    n_loc0 = PROMPT // SHARDS
    for name, (args, rows) in layouts.items():
        rep = args[3].shape[0] // args[0].shape[0]
        n_cols = n_loc0 if name == "chunk" else args[1].shape[1]
        pargs, pages, zrows = to_pages(torch, gen, args, rep, n_cols)
        want = decode_stats(*pargs, scale=scale, rows=rows, pages=pages,
                            zrows=zrows, backend="plain")
        n_rows = pages.shape[0]
        sel = (torch.arange(args[0].shape[0], device=pages.device)
               if rows is None else rows.long().clamp(0, n_rows - 1))
        page = int(pages[sel[0], 0])
        poisoned = list(pargs)
        for i in (1, 2):
            poisoned[i] = pargs[i].clone()
            poisoned[i][page * rep:(page + 1) * rep] = float("nan")
        expect = ((pages[sel, 0] == page).repeat_interleave(rep)
                  & pargs[3][:, :PAGE_COLS].any(dim=1))
        rule = decode_route(args[0].shape[2], args[1].shape[2],
                            rows is None)
        got = {rule: decode_stats(*poisoned, scale=scale, rows=rows,
                                  pages=pages, zrows=zrows,
                                  backend="kernel")}
        if rows is None:
            other = "row" if rule == "tile" else "tile"
            got[other] = launch_route(other, *poisoned, scale=scale,
                                      pages=pages, zrows=zrows)
        for route, stats in got.items():
            case = f"poisoned/{name}/{route}"
            b = expect.shape[0]
            bad = ~torch.stack([torch.isfinite(t.reshape(b, -1)).all(dim=1)
                                for t in stats]).all(dim=0)
            if not torch.equal(bad, expect):
                raise AssertionError(
                    f"flash_decode_stats [{case}]: non-finite rows "
                    f"{bad.nonzero().flatten().tolist()}, the rows that "
                    f"read page {page}: "
                    f"{expect.nonzero().flatten().tolist()}")
            keep = ~expect
            chk.stats(tuple(t[keep] for t in stats),
                      tuple(t[keep] for t in want), case, key=key)
        out[name] = {"page": page, "rows": int(expect.shape[0]),
                     "rows_nonfinite": int(expect.sum()),
                     "routes": sorted(got)}
    return out


def sweep_tile_case(torch, both, gen, hq, hkv, m_loc, rep, mz, kind,
                    hd=64):
    """One tile-route case over 3 query rows folded over ``rep`` shards,
    without and with means columns: ``dead_means`` (local columns to a
    random position, means g = 0 in the second 32-column tile and every
    third column, and in every means column of one row), ``last_local``
    / ``last_means`` (every row's only live column is the last local /
    means column, the end of a ragged tile), ``random`` (random
    positions and g, row 0 all dead)."""
    dev = "cuda"
    bq = 3
    b = bq * rep
    q = 0.5 * torch.randn(bq, 1, hq, hd, device=dev, generator=gen)
    k = 0.5 * torch.randn(b, m_loc, hkv, hd, device=dev, generator=gen)
    v = 0.5 * torch.randn(b, m_loc, hkv, hd, device=dev, generator=gen)
    cols = torch.arange(m_loc, device=dev)
    gz = torch.randint(1, 5, (b, mz), device=dev, generator=gen)
    if kind == "last_local":
        valid = (cols == m_loc - 1).expand(b, m_loc).contiguous()
        gz[:] = 0
    elif kind == "last_means":
        valid = torch.zeros(b, m_loc, dtype=torch.bool, device=dev)
        gz[:] = 0
        gz[:, -1] = 3
    else:
        pos = torch.randint(-1, m_loc, (b,), device=dev, generator=gen)
        pos[0] = -1                              # an all-dead row
        valid = cols[None] <= pos[:, None]
        gz[0] = 0
        if kind == "dead_means":
            gz[:, 32:64] = 0
            gz[:, ::3] = 0
            gz[1] = 0
    case = f"tile/{kind}/hq{hq}/hkv{hkv}/M{m_loc}/rep{rep}"
    args = [q, k, v, valid]
    both(args, hd ** -0.5, case)                 # last_means: all dead
    log_gz = torch.where(gz > 0, gz.float().log(),
                         torch.full_like(gz, -1e30, dtype=torch.float))
    kz = 0.5 * torch.randn(bq, mz, hkv, hd, device=dev, generator=gen)
    vz = 0.5 * torch.randn(bq, mz, hkv, hd, device=dev, generator=gen)
    args += [log_gz, kz, vz]
    both(args, hd ** -0.5, f"{case}/mz{mz}")


def time_routes(torch, timer, args, scale):
    """Event and profiler times of each route of the decode kernel on
    the same inputs (no row map)."""
    from repro_torch.kernels.decode_attention import launch_route
    out = {}
    for route in ("tile", "row"):
        def call():
            return launch_route(route, *args, scale=scale)
        out[f"{route}_ms"] = timer(call)
        out[f"{route}_device_ms"] = timer.device(call)
    return out


CROSSOVER_GROUPS = (1, 2, 4, 8, 16, 32, 40, 64, 128)


def crossover(torch, timer, chunk_args, scale, gen):
    """Both routes at the chunk layout's cache rows (offset 448) with a
    folded group of each of ``CROSSOVER_GROUPS`` query heads a KV head
    (a chunk of that many tokens): where the tile route starts to win,
    against the rule's threshold."""
    from repro_torch.kernels.decode_attention import (TILE_MIN_GROUP,
                                                      decode_route)
    _, k, v, valid = chunk_args
    bq, hkv, hd = chunk_args[0].shape[0], k.shape[2], k.shape[3]
    rows = []
    for grp in CROSSOVER_GROUPS:
        q = 0.5 * torch.randn(bq, 1, grp * hkv, hd, device="cuda",
                              generator=gen)
        args = [q, k, v, valid]
        b_ms, b_by, _ = decode_bound(torch, q, k, valid)
        rows.append({"group": grp, "rule": decode_route(grp * hkv, hkv,
                                                        True),
                     **time_routes(torch, timer, args, scale),
                     "bound_ms": b_ms, "bound_by": b_by})
    return {"threshold": TILE_MIN_GROUP, "offset": 448, "by_group": rows}


def sweep_rows_case(torch, both, gen, t, n_rows, rep, hq, hkv, kind,
                    m_loc=150, mz=40, hd=64):
    """One row-map case, without and with means columns: ``t`` query rows
    over ``n_rows`` cache rows of ``rep`` shards, per-output-row valid
    columns (some rows all dead), rows drawn with repeats, all equal, or
    with entries below and above the range (the kernel reads them
    clamped)."""
    dev = "cuda"
    q = 0.5 * torch.randn(t, 1, hq, hd, device=dev, generator=gen)
    k = 0.5 * torch.randn(n_rows * rep, m_loc, hkv, hd, device=dev,
                          generator=gen)
    v = 0.5 * torch.randn(n_rows * rep, m_loc, hkv, hd, device=dev,
                          generator=gen)
    rows = torch.randint(0, n_rows, (t,), device=dev, generator=gen)
    if kind == "equal":
        rows[:] = rows[0]
    elif kind == "clamped":
        rows[::3], rows[1::3] = -1, n_rows + 2
    rows = rows.to(torch.int32)
    pos = torch.randint(-1, m_loc, (t * rep,), device=dev, generator=gen)
    pos[0] = -1                                  # an all-dead row
    valid = torch.arange(m_loc, device=dev)[None] <= pos[:, None]
    case = f"rows/{kind}/T{t}/R{n_rows}/rep{rep}/hq{hq}/hkv{hkv}"
    both([q, k, v, valid], hd ** -0.5, case, rows=rows)
    gz = torch.randint(0, 5, (t * rep, mz), device=dev, generator=gen)
    log_gz = torch.where(gz > 0, gz.float().log(),
                         torch.full_like(gz, -1e30, dtype=torch.float))
    kz = 0.5 * torch.randn(n_rows, mz, hkv, hd, device=dev, generator=gen)
    vz = 0.5 * torch.randn(n_rows, mz, hkv, hd, device=dev, generator=gen)
    both([q, k, v, valid, log_gz, kz, vz], hd ** -0.5, f"{case}/mz{mz}",
         rows=rows)


def sweep_decode_case(torch, both, gen, hq, hkv, m_loc, rep, mz, max_pos,
                      hd=64, few_live=False):
    """One decode sweep case, without and with means columns: 3 query
    rows, each folded over ``rep`` shards; cache positions up to
    ``max_pos`` (default: the whole shard) with row 0 all dead;
    ``few_live``: rows 1-8 see every 8th column, from columns 0-7, so
    that every column is one of few a row sees."""
    bq = 3
    b = bq * rep
    top = m_loc if max_pos is None else max_pos
    q = 0.5 * torch.randn(bq, 1, hq, hd, device="cuda", generator=gen)
    k = 0.5 * torch.randn(b, m_loc, hkv, hd, device="cuda", generator=gen)
    v = 0.5 * torch.randn(b, m_loc, hkv, hd, device="cuda", generator=gen)
    pos = torch.randint(-1, top, (b,), device="cuda", generator=gen)
    pos[0] = -1                                  # an all-dead row
    cols = torch.arange(m_loc, device="cuda")
    valid = cols[None] <= pos[:, None]
    if few_live:
        valid[1:9] = cols[None] % 8 == torch.arange(8, device="cuda")[:, None]
    case = f"hq{hq}/hkv{hkv}/M{m_loc}/rep{rep}/top{top}"
    both([q, k, v, valid], hd ** -0.5, case)
    gz = torch.randint(0, 5, (b, mz), device="cuda", generator=gen)
    gz[0] = 0                                    # dead means too
    if max_pos is not None:
        gz[:, max_pos:] = 0                      # late means not visible
    log_gz = torch.where(gz > 0, gz.float().log(),
                         torch.full_like(gz, -1e30, dtype=torch.float))
    kz = 0.5 * torch.randn(bq, mz, hkv, hd, device="cuda", generator=gen)
    vz = 0.5 * torch.randn(bq, mz, hkv, hd, device="cuda", generator=gen)
    both([q, k, v, valid, log_gz, kz, vz], hd ** -0.5, f"{case}/mz{mz}")


def decode_library(torch, timer, args, scale):
    """The decode yardstick: one call of PyTorch's memory-efficient
    attention over the same columns (local K/V and the means
    concatenated, a float bias from ``valid`` / ``log_gz``), with its
    log-sum-exp, which determine (m, l, acc).  Inputs are laid out
    outside the timed call; the port never calls it.  Returns (ms, the
    largest |out - acc / l| over live rows) or (None, the op's error)."""
    from repro_torch.kernels.decode_attention import decode_stats
    q, k, v, valid = args[:4]
    b, bq = k.shape[0], q.shape[0]
    rep, hq, hkv = b // bq, q.shape[2], k.shape[2]
    bias = torch.where(valid, 0.0, -1e30)
    if len(args) > 4:
        log_gz, kz, vz = args[4:]
        k = torch.cat([k, kz.repeat_interleave(rep, 0)], dim=1)
        v = torch.cat([v, vz.repeat_interleave(rep, 0)], dim=1)
        bias = torch.cat([bias, log_gz], dim=1)
    # the call in the cache's dtype (a bf16 query over an f32 cache: f32)
    q, bias = q.to(k.dtype), bias.to(k.dtype)

    def heads(t):                                # (B, N, Hkv, hd) -> BHNd
        return t.repeat_interleave(hq // hkv, 2).transpose(1, 2).contiguous()
    qs = q.repeat_interleave(rep, 0).transpose(1, 2).contiguous()
    ks, vs = heads(k), heads(v)
    bias = bias[:, None, None, :].expand(b, hq, 1, -1).contiguous()
    op = torch.ops.aten._scaled_dot_product_efficient_attention
    try:
        out = op(qs, ks, vs, bias, True, 0.0, False, scale=scale)[0]
        ms = timer(lambda: op(qs, ks, vs, bias, True, 0.0, False,
                              scale=scale))
    except RuntimeError as e:
        return None, f"refused: {str(e).splitlines()[0][:200]}"
    _, l, acc = decode_stats(*args, scale=scale, backend="plain")
    live = (l[:, :, 0, 0] > 0)                              # (B, Hq)
    want = (acc[:, 0] / l[:, :, 0].clamp(min=1e-30))[live]
    return ms, float((out[:, :, 0][live] - want).abs().max())


# ---------------------------------------------------------------------------
# trace: where the device time goes
# ---------------------------------------------------------------------------

TRACED_STEPS = 8


def chunk_library(torch, timer, args, scale, c):
    """The chunk layout's yardstick at its natural shape: one call of
    PyTorch's memory-efficient attention with each (row, shard)'s C
    queries as its query axis, q (B·P, Hq, C, hd) over K/V (B·P, Hq,
    cap_l, hd), under a bias (B·P, 1, 1, cap_l) from ``valid`` broadcast
    over heads and queries (every query of a chunk sees the same prior
    columns), or materialised if the op refuses the broadcast.  The
    folded call (``decode_library``) reads K/V once per folded head.
    Returns (ms, the largest |out - acc / l| over live rows, the bias's
    form) or (None, the op's error, None)."""
    from repro_torch.kernels.decode_attention import decode_stats
    q, k, v, valid = args
    b, bq, hqc, hd = k.shape[0], q.shape[0], q.shape[2], q.shape[3]
    rep, hkv = b // bq, k.shape[2]
    grp = hqc // (c * hkv)
    hq = hkv * grp
    qs = (q.reshape(bq, hkv, c, grp, hd).transpose(2, 3)
          .reshape(bq, hq, c, hd).repeat_interleave(rep, 0).contiguous())
    ks, vs = (t.repeat_interleave(grp, 2).transpose(1, 2).contiguous()
              for t in (k, v))
    bias = torch.where(valid, 0.0, -1e30)[:, None, None, :].expand(
        b, hq, c, -1)
    op = torch.ops.aten._scaled_dot_product_efficient_attention
    refused = []
    for form, bb in (("broadcast", bias), ("materialised", bias.contiguous())):
        try:
            out = op(qs, ks, vs, bb, True, 0.0, False, scale=scale)[0]
        except RuntimeError as e:
            refused.append(f"{form}: {str(e).splitlines()[0][:200]}")
            continue
        ms = timer(lambda: op(qs, ks, vs, bb, True, 0.0, False, scale=scale))
        break
    else:
        return None, "refused: " + "; ".join(refused), None
    _, l, acc = decode_stats(*args, scale=scale, backend="plain")
    live = l[:, :, 0, 0] > 0                               # (B·P, C·Hq)
    want = acc[:, 0] / l[:, :, 0].clamp(min=1e-30)
    got = (out.reshape(b, hkv, grp, c, hd).transpose(2, 3)
           .reshape(b, hqc, hd))
    return ms, float((got[live] - want[live]).abs().max()), form


def kernel_kind(name: str) -> str:
    """Coarse class of a device kernel, by its name."""
    for kind, keys in (("prism_flash_attention", ("prism_attention",)),
                       ("flash_decode_stats", ("decode_stats",)),
                       ("segment_means", ("segment_means",)),
                       ("matmul", ("gemm", "gemv", "cutlass", "cublas")),
                       ("reduce", ("reduce",)),
                       ("index", ("index", "scatter", "gather")),
                       ("copy", ("copy", "cat")),
                       ("elementwise", ("elementwise",))):
        if any(k in name.lower() for k in keys):
            return kind
    return "other"


def device_breakdown(prof, n_steps: int) -> dict:
    """Device time of a profiled window: kernels' summed and merged
    (busy) time, the idle share of the span from the first kernel's
    start to the last one's end, and time by kernel class; all per
    step."""
    spans, by_kind = [], {}
    for e in device_events(prof):
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        kind = kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + (t1 - t0)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    spans.sort()
    busy, (cur0, cur1) = 0.0, spans[0]
    for t0, t1 in spans[1:]:
        if t0 > cur1:
            busy, cur0 = busy + cur1 - cur0, t0
        cur1 = max(cur1, t1)
    busy += cur1 - cur0
    span = spans[-1][1] - spans[0][0]
    ms = 1e-3 / n_steps                          # profiler times are in us
    return {"span_ms": span * ms, "busy_ms": busy * ms,
            "idle_share": 1.0 - busy / span, "kernels": len(spans) / n_steps,
            "by_kind_ms": {k: v * ms for k, v in sorted(
                by_kind.items(), key=lambda kv: -kv[1])},
            "trace": getattr(prof, "trace_info", None)}


def profile(torch, run) -> dict:
    """Trace one prefill and ``TRACED_STEPS`` greedy decode steps of an
    already warmed-up static-batch ``run`` with ``torch.profiler``;
    returns the device breakdown of each window (per step for decode).
    The profiler's own overhead stretches the spans; the kernel times are
    the card's."""
    from repro_torch.runtime.serve import prefill, serve_step
    first = run.prompts if run.prompts is not None else run.embeds
    b, n = first.shape[:2]
    state = {}

    def pre():
        state["out"] = prefill(run.cfg, run.params, run.prompts, run.prism,
                               run.lay, run.hp, run.embeds)

    def dec():
        logits, cache = state["out"]
        for i in range(TRACED_STEPS):
            pos = torch.full((b,), n + i, dtype=torch.long,
                             device=first.device)
            logits, cache = serve_step(run.cfg, run.params, cache,
                                       logits.argmax(dim=-1), pos, run.lay,
                                       run.hp)
    prof_pre = trace_window(torch, pre)
    prof_dec = trace_window(torch, dec)
    return {"prefill": device_breakdown(prof_pre, 1),
            "decode_per_token": device_breakdown(prof_dec, TRACED_STEPS)}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def rel_err(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp(min=1e-6))


def tokens_agree(torch, tokens, ref_logits, err=0.0):
    """tokens (B, gen) vs the argmax of ref_logits (gen, B, V) wherever
    the reference's top-2 gap is clear: over ``TOKEN_GAP`` of its largest
    |logit|, and over twice the logits' measured error ``err`` (the same
    share), which could flip a closer pair.  Under ``PATH_REL_TOL`` the
    second never binds; it does for a model held to a float64 witness
    whose plain f32 forwards lie further apart (Zamba2).  Returns
    (checked, total)."""
    top2 = ref_logits.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > max(TOKEN_GAP, 2 * err) * float(
        ref_logits.abs().max())
    want = ref_logits.argmax(-1)
    got = tokens.T
    if (got[clear] != want[clear]).any():
        raise AssertionError("greedy tokens differ where the reference's "
                             "top-2 gap is clear")
    return int(clear.sum()), clear.numel()


def replay_check(torch, rec, twin, what):
    """The routing rule of a MoE run: ``rec`` the kernel run's
    ``RoutingLog``, ``twin`` its backend='plain' twin's, which replayed
    ``rec`` and kept its own decisions beside.  Every token whose own
    top-k (as a set) differs from the replayed one must have a router
    margin under ROUTE_MARGIN in both runs, and the twin's own capacity
    drops may differ only in a group where such a token is.  Returns the
    decisions compared, the tokens that flipped, their largest margin,
    the smallest margin of any decision and the share of assignments
    dropped."""
    from repro_torch.models.moe import record_keep, record_margin
    if len(rec.calls) != len(twin.calls):
        raise AssertionError(f"{what}: {len(rec.calls)} routed calls, the "
                             f"plain twin made {len(twin.calls)}")

    def by_expert(idx, keep):
        """A token's (expert, kept) pairs in expert order: two runs may
        rank a token's own experts in another order."""
        order = idx.argsort(dim=-1)
        return (idx.gather(-1, order),
                keep.view(idx.shape).gather(-1, order))

    n, flips, flip_margin, least, kept, assigned = 0, 0, 0.0, math.inf, 0, 0
    for a, b in zip(rec.calls, twin.calls):
        if not torch.equal(a["idx"], b["idx"]):
            raise AssertionError(f"{what}: the twin did not replay")
        keep_a = record_keep(a)
        own, own_keep = by_expert(b["own_idx"], record_keep(b, own=True))
        used, keep = by_expert(b["idx"], keep_a)
        flip = (own != used).any(dim=-1)                         # (G, T)
        g = flip.shape[0]
        margin_a = record_margin(a)
        if bool(flip.any()):
            m = torch.maximum(margin_a, record_margin(b))[flip]
            flip_margin = max(flip_margin, float(m.max()))
            if flip_margin > ROUTE_MARGIN:
                raise AssertionError(
                    f"{what}: a token routed differently at a router "
                    f"margin of {flip_margin:.3e} > {ROUTE_MARGIN}")
            flips += int(flip.sum())
        moved = (own_keep != keep).view(g, -1).any(dim=1)
        if bool((moved & ~flip.any(dim=1)).any()):
            raise AssertionError(f"{what}: capacity dropped other entries "
                                 "in a group where no token flipped")
        n += flip.numel()
        least = min(least, float(margin_a.min()))
        kept += int(keep_a.sum())
        assigned += keep_a.numel()
    return {"decisions": n, "flipped": flips,
            "flipped_margin_max": flip_margin, "margin_min": least,
            "margin_bound": ROUTE_MARGIN,
            "dropped_share": 1.0 - kept / max(1, assigned)}


def check_launches(path, counts, need):
    for name, n in need.items():
        if counts.get(name, 0) != n:
            raise AssertionError(f"{path}: {name} launched "
                                 f"{counts.get(name, 0)} times, the path "
                                 f"needs {n}")


def static_tile(cfg) -> bool:
    """Whether one token a row (static decode, the engine's decode
    steps: no row map) takes the decode kernel's tile route: GPT-2's
    group of 1 does not, Yi-6B's group of 8 does."""
    from repro_torch.kernels.decode_attention import decode_route
    return decode_route(cfg.n_heads, cfg.n_kv_heads, True) == "tile"


def as_f64(tree):
    """A copy of a weight tree in float64."""
    if isinstance(tree, dict):
        return {k: as_f64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_f64(v) for v in tree]
    return tree.double()


# a recurrent layer's cell: its prefill and its decode step, by block kind
CELLS = {"mlstm": ("mlstm_apply", "mlstm_decode"),
         "slstm": ("slstm_apply", "slstm_decode"),
         "mamba": ("mamba2_apply", "mamba2_decode")}


def recurrent_check(torch, run, tokens, logits):
    """The exact static path of a model of recurrent blocks (xLSTM;
    Zamba2, whose Mamba2 blocks sit between shared attention layers):
    (err, limit, the float64 reference logits (gen, B, V), extras).

    A random-weight xLSTM or Zamba2 amplifies an f32 rounding difference
    with depth, so two plain f32 forwards that only group the chunks
    otherwise already differ by more than ``PATH_REL_TOL``.  The witness is the
    plain full forward in float64 over the prompt and every fed token
    (576 rows, chunks of ``XLSTM_REF_CHUNK``).  Gated: (1) every layer's
    cell output (the mLSTM or sLSTM, before the residual add) at every
    position, the prefill's rows and 64 decode steps teacher-forced on
    ``tokens`` in a second run whose cells are recorded, against the
    cell's float64 full-sequence form on the same inputs (an attention
    layer holds no cell and is checked end to end only): the prefill's
    rows and the decode steps' rows each within ``F32_ORDER_FACTOR``
    times the plain f32 cell's own distance there (some prefill rows of
    the plain f32 cell lie near 1e-4 of the largest output: the cell's
    conditioning, not the port's); (2) the counted run's logits against
    the float64 forward, within the larger of ``PATH_REL_TOL`` and
    ``F32_ORDER_FACTOR`` times the distance of the plain f32 forwards
    (chunks of 64 and 32) to it.  The caller holds the greedy tokens to
    the float64 forward where its top-2 gap is clear.  Errors are
    relative to the witness's largest |value|, per layer (all rows, the
    prefill's, the decode steps')."""
    from repro_torch.models import transformer as T
    from repro_torch.models.context import FullContext
    from repro_torch.runtime import serve as S
    cfg, params = run.cfg, run.params
    b, n = run.prompts.shape
    names = [name for pair in CELLS.values() for name in pair]
    cells = {name: getattr(T, name) for name in names}
    rec = [(i, kind, p) for i, (kind, p) in enumerate(zip(
        cfg.block_kinds, params["layers"])) if kind in CELLS]
    calls = []

    def recorded(fn):
        def cell(p, x, *a, **kw):
            out = fn(p, x, *a, **kw)
            calls.append((x, out[0] if isinstance(out, tuple) else out))
            return out
        return cell

    def full_cell(kind, p, x):
        kw = {"chunk": XLSTM_REF_CHUNK} if kind != "slstm" else {}
        if kind == "mamba":
            kw.update(d_state=cfg.ssm_state, expand=cfg.ssm_expand,
                      conv=cfg.ssm_conv)
        return cells[CELLS[kind][0]](p["cell"], x, heads=cfg.n_ssm_heads,
                                     ctx=FullContext(), **kw)
    with torch.no_grad():
        for name in names:
            setattr(T, name, recorded(cells[name]))
        try:                # positions 0 .. n + GEN - 1, every token fed
            S.generate(cfg, params, run.prompts, gen=GEN + 1,
                       prism=run.prism, lay=run.lay, hp=run.hp,
                       forced=tokens)
        finally:
            for name in names:
                setattr(T, name, cells[name])
        params64 = as_f64(params)
        layer_errs, plain_errs = [], []
        for r, (i, kind, p) in enumerate(rec):
            mine = calls[r::len(rec)]
            x, y = (torch.cat([mine[0][j].reshape(b, n, -1)]
                              + [c[j] for c in mine[1:]], dim=1)
                    for j in (0, 1))
            y64 = full_cell(kind, params64["layers"][i], x.double())
            scale = float(y64.abs().max())

            def parts(got):     # all rows, the prefill's, the decode's
                e = (got.double() - y64).abs().amax(dim=(0, 2)) / scale
                return [float(e.max()), float(e[:n].max()),
                        float(e[n:].max())]
            layer_errs.append(parts(y))
            plain_errs.append(parts(full_cell(kind, p, x)))
            del x, y, y64
        del calls
        bad = [(i, rows) for (i, _, _), mine, base in zip(rec, layer_errs,
                                                          plain_errs)
               for rows, e, e0 in (("prefill", mine[1], base[1]),
                                   ("decode", mine[2], base[2]))
               if e > F32_ORDER_FACTOR * e0]
        if bad:
            raise AssertionError(
                f"{cfg.name}: a cell's output is more than "
                f"{F32_ORDER_FACTOR} times as far from its float64 form as "
                f"the plain f32 cell's (layer, rows) {bad}; by layer (all, "
                f"prefill, decode rows), the path's {layer_errs}, the plain "
                f"f32 cell's {plain_errs}")
        seq = torch.cat([run.prompts, tokens], dim=1)

        def fwd(tree, chunk):
            return T.forward(cfg, tree, seq, start=n - 1, chunk=chunk)[
                :, :GEN].transpose(0, 1)                     # (gen, B, V)
        ref = fwd(params64, XLSTM_REF_CHUNK)
        del params64
        plain = [rel_err(fwd(params, c), ref)
                 for c in (XLSTM_REF_CHUNK, XLSTM_REF_CHUNK // 2)]
    limit = max(PATH_REL_TOL, F32_ORDER_FACTOR * max(plain))
    extra = {"layer_rel_err_max": max(e[0] for e in layer_errs),
             # by recurrent layer (``cell_layers``): all rows, the
             # prefill's, the decode steps'
             "cell_layers": [i for i, _, _ in rec],
             "layer_rel_err": layer_errs,
             "layer_plain_f32_rel_err": plain_errs,
             "plain_f32_rel_err": plain, "limit_factor": F32_ORDER_FACTOR,
             "positions": n + GEN}
    return rel_err(logits, ref), limit, ref, extra


def plain_witness(torch, plain, tokens, logits, plain_logits):
    """A prism pairing of a model of recurrent blocks (Zamba2): (err,
    limit, the witness's logits (gen, B, V), extras).  The kernel run and
    its backend='plain' twin ``plain`` (whose logits are
    ``plain_logits``) compute the same sums in two f32 orders, which a
    random-weight Zamba2 amplifies with depth past ``PATH_REL_TOL``
    (voltage + prism 1.5e-4 apart at 54 layers).  So, as
    ``recurrent_check`` holds the exact pairing, the witness is the twin
    run in float64 (its weights in float64; the plain versions keep
    float64 rows float64), teacher-forced on ``tokens``, and the run's
    logits lie within the larger of ``PATH_REL_TOL`` and
    ``F32_ORDER_FACTOR`` times the f32 twin's distance to it."""
    params = plain.params
    plain.params = as_f64(params)
    try:
        with torch.no_grad():
            _, ref, _ = plain.run(forced=tokens[:, :-1])
    finally:
        plain.params = params
    twin = rel_err(plain_logits, ref)
    limit = max(PATH_REL_TOL, F32_ORDER_FACTOR * twin)
    return rel_err(logits, ref), limit, ref, {
        "plain_f32_rel_err": twin, "limit_factor": F32_ORDER_FACTOR,
        "plain_twin_rel_err": rel_err(logits, plain_logits)}


def audio_rows(torch, run, codes):
    """An audio prompt's rows for the plain full forward: the frames
    through ``embed_inputs`` (positions 0 .. n - 1), then ``codes`` (B,
    t) through the decode step's ``embed_tokens`` at positions n, n + 1,
    ... (B, n + t, D)."""
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import embed_tokens
    n, t = run.embeds.shape[1], codes.shape[1]
    pos = torch.arange(n, n + t, device=codes.device).expand(
        codes.shape[0], t)
    return torch.cat([T.embed_inputs(run.cfg, run.params, embeds=run.embeds),
                      embed_tokens(run.cfg, run.params, codes, pos)], dim=1)


def drive_path(torch, params, arch=ARCH, prompt=PROMPT, pairings=PAIRINGS,
               cfg=None):
    """The static path in each (prefill, decode) pairing, keyed by the
    decode mode (by 'prefill+decode' for a pairing other than the mode's
    own): exact decode held to the plain full forward (a vlm's with its
    image; an audio model's over its frames and the codes fed after them,
    ``audio_rows``; xLSTM's in float64, ``recurrent_check``), prism
    decode to the same run with backend='plain'.  A model
    with MoE blocks holds every pairing to its backend='plain' twin
    under ``replay_check``: the counted run records its routing
    (``RoutingLog`` launches nothing).  ``cfg`` (default ``arch``'s)
    serves a config cut in depth, ``params`` its layers; the widths are
    checked against ``arch``'s full config."""
    import time
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.serve import setup
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import RoutingLog
    full = get_config(arch)
    arch_cfg = cfg or full
    n_layers = arch_cfg.n_layers
    n_local = arch_cfg.block_kinds.count("attn_local")
    # the layers with attention (xLSTM's recurrent blocks have none)
    n_attn = sum(k not in T.RECURRENT_KINDS for k in arch_cfg.block_kinds)
    recurrent = n_attn < n_layers
    moe = "moe" in arch_cfg.block_kinds
    width = ("d_model", "n_heads", "n_kv_heads", "hd", "d_ff", "vocab_size",
             "n_experts", "top_k", "expert_d_ff", "prefix_len",
             "n_ssm_heads", "ssm_expand", "frontend", "pos")
    got = [getattr(arch_cfg, f) for f in width]
    if got != [getattr(full, f) for f in width] or len(
            params["layers"]) != n_layers:                  # full width
        raise AssertionError(f"{arch}: {dict(zip(width, got))}, "
                             f"{len(params['layers'])} layers of weights "
                             f"for {n_layers}")

    def static(mode, prefill_mode, backend="auto"):
        run = setup(arch, batch=BATCH, prompt_len=prompt, gen=GEN,
                    seq_shards=SHARDS, decode_mode=mode, cr=CR,
                    device="cuda", params=params, backend=backend,
                    prefill=prefill_mode)
        run.cfg = arch_cfg
        return run
    results = {}
    for prefill_mode, mode in pairings:
        key = (mode if (prefill_mode, mode) in PAIRINGS
               else f"{prefill_mode}+{mode}")
        t0 = time.perf_counter()
        run = static(mode, prefill_mode)
        run.run()                                    # warm-up
        if moe:                 # the counted run records its routing
            hp = run.hp
            run.hp = replace(hp, routing=RoutingLog())
        torch.cuda.synchronize()
        LAUNCHES.clear()
        tokens, logits, times = run.run()
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        t_runs = time.perf_counter() - t0
        if moe:
            rec, run.hp = run.hp.routing, hp
        check_launches(f"{arch}/static/{key}", counts, {
            "prism_flash_attention": n_attn,
            "prism_flash_attention.window": n_local,
            # a prefill that captures means: once a global layer
            "segment_means": (n_attn - n_local) if mode == "prism"
            else 0,
            "flash_decode_stats": n_attn * (GEN - 1),
            "flash_decode_stats.mq": (n_attn * (GEN - 1)
                                      if static_tile(arch_cfg) else 0),
            "flash_decode_stats.paged": 0})
        vocab = run.cfg.vocab_size
        if tuple(logits.shape) != (GEN, BATCH, vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{key}: logits {tuple(logits.shape)} "
                                 "not finite or of the wrong shape")
        extra = {}
        if moe:
            plain = static(mode, prefill_mode, "plain")
            plain.hp = replace(plain.hp, routing=RoutingLog(replay=rec))
            _, ref, _ = plain.run(forced=tokens[:, :-1])
            extra["routing"] = replay_check(torch, rec, plain.hp.routing,
                                            f"{arch}/static/{key}")
            del rec
            ref_name = "backend='plain' run replaying the routing"
        elif mode == "exact" and recurrent:
            err, tol, ref, extra = recurrent_check(torch, run, tokens,
                                                   logits)
            ref_name = ("the float64 plain full forward; each cell against "
                        "its float64 form on the path's own inputs")
        elif mode == "exact":
            # teacher-forced: one causal forward over prompt + generated
            # tokens covers every step (the head over those steps only);
            # an audio prompt's frames, then the codes fed after them
            with torch.no_grad():
                if run.prompts is None:
                    fwd = T.forward_embedded(
                        run.cfg, params,
                        audio_rows(torch, run, tokens[:, :-1]),
                        start=prompt - 1)
                else:
                    seq = torch.cat([run.prompts, tokens[:, :-1]], dim=1)
                    fwd = T.forward(run.cfg, params, seq, embeds=run.embeds,
                                    start=prompt - 1)
            ref = fwd.transpose(0, 1)                         # (gen, B, V)
            del fwd
            ref_name = "plain full forward"
        else:
            plain = static(mode, prefill_mode, "plain")
            _, ref, _ = plain.run(forced=tokens[:, :-1])
            ref_name = "backend='plain' run"
            if recurrent:
                err, tol, ref, extra = plain_witness(torch, plain, tokens,
                                                     logits, ref)
                ref_name = "the backend='plain' twin in float64"
        if not recurrent:
            err, tol = rel_err(logits, ref), PATH_REL_TOL
        if err > tol:
            raise AssertionError(f"{key}: logits rel err {err:.3e} vs the "
                                 f"{ref_name} > {tol:.3e}")
        checked, total = tokens_agree(torch, tokens, ref, err)
        decode_s = times["decode_ms_per_token"] / 1e3
        results[key] = {
            "prefill_ms": times["prefill_ms"],
            "decode_ms_per_token": times["decode_ms_per_token"],
            "decode_tokens_per_s": BATCH / decode_s,
            "e2e_tokens_per_s": BATCH * GEN / (
                (times["prefill_ms"] + times["decode_ms_per_token"]
                 * (GEN - 1)) / 1e3),
            "clock": times["clock"], "launches": counts,
            "logits_rel_err": err, "reference": ref_name,
            "tol": tol, "tokens_checked": checked,
            "tokens_total": total,
            "token_gap": max(TOKEN_GAP, 2 * err),
            # host seconds: the warm-up and counted runs, the checks
            "seconds": {"runs": t_runs,
                        "check": time.perf_counter() - t0 - t_runs},
            **extra}
        emit("path", arch=arch, mode=mode, prefill=prefill_mode,
             batch=BATCH, prompt=prompt, gen=GEN, shards=SHARDS, cr=CR,
             layers=n_layers, prefix_len=arch_cfg.prefix_len,
             **results[key])
        # where the time goes: a torch.profiler trace of one prefill and
        # a few decode steps, after the counted run
        t0 = time.perf_counter()
        trace = profile(torch, run)
        emit("trace", arch=arch, mode=mode, exchange=prefill_mode,
             seconds=time.perf_counter() - t0, **trace)
        del logits, ref
    return results


# ---------------------------------------------------------------------------
# phase 5: the engine's tick programs, chunked prefill and packed ticks
# ---------------------------------------------------------------------------

CHUNK_LEN = 64                       # the engine's default chunk_len
TOKEN_BUDGET = BATCH + CHUNK_LEN     # its default token budget: 72
TICK_KEYS = ("tok", "src", "slot", "pos", "off", "pre")


def plan_chunks(prompts, chunk_len, join):
    """The chunked-prefill calls an engine makes for ``prompts`` (lists of
    token ids), row i admitted at call ``join[i]``: every admitted row
    with prompt left advances by up to ``chunk_len`` tokens at its own
    offset.  Returns one (tokens (B, C), off (B,), nreal (B,)) of numpy
    arrays per call; a row not prefilling has off = -1."""
    import numpy as np
    b = len(prompts)
    done = [0] * b
    calls = []
    while any(done[i] < len(p) for i, p in enumerate(prompts)):
        tokens = np.zeros((b, chunk_len), np.int64)
        off = np.full(b, -1, np.int64)
        nreal = np.zeros(b, np.int64)
        for i, p in enumerate(prompts):
            take = min(chunk_len, len(p) - done[i])
            if join[i] <= len(calls) and take > 0:
                tokens[i, :take] = p[done[i]:done[i] + take]
                off[i], nreal[i] = done[i], take
                done[i] += take
        calls.append((tokens, off, nreal))
    return calls


def plan_packed(prompts, gen, budget, forced=None):
    """The packed ticks ``FifoScheduler.plan_tick`` plans for ``prompts``,
    all admitted at the first tick, each generating ``gen`` tokens: every
    decoding slot's token first, then prompt tokens in slot order up to
    ``budget``, the dead tail padded (slot = -1).  A slot's first decode
    token re-feeds its last prompt token at ``off = pos = n - 1``; a later
    one is ``forced[slot][k - 1]`` if given, else the slot's sample of
    the tick before (``src`` = the slot, for ``merge``).  Returns one dict
    per tick: numpy arrays ``TICK_KEYS`` (budget,); ``n_dec``, its decode
    rows, which come first; ``lengths`` (B,), each slot's cached tokens
    after the tick; ``dslot`` and ``flat`` (B,), zero-padded: the slot
    and the (step·B + slot) of each decode row."""
    import numpy as np
    b = len(prompts)
    if budget < b:
        raise ValueError(f"token budget {budget} < {b} slots")
    done, n_dec = [0] * b, [0] * b
    ticks = []
    while any(n < gen for n in n_dec):
        t = {k: np.full(budget, -1, np.int64) for k in TICK_KEYS}
        t["tok"][:], t["pre"][:] = 0, 0
        t["dslot"], t["flat"] = np.zeros(b, np.int64), np.zeros(b, np.int64)
        i = 0
        for s, p in enumerate(prompts):
            if done[s] < len(p) or n_dec[s] >= gen:
                continue
            k = n_dec[s]
            t["slot"][i] = s
            t["pos"][i] = t["off"][i] = len(p) - 1 + k
            if k == 0:
                t["tok"][i] = p[-1]
            elif forced is not None:
                t["tok"][i] = forced[s][k - 1]
            else:
                t["src"][i] = s
            t["dslot"][i], t["flat"][i] = s, k * b + s
            n_dec[s] += 1
            i += 1
        t["n_dec"] = i
        for s, p in enumerate(prompts):
            take = min(budget - i, len(p) - done[s])
            if take <= 0:
                continue
            t["tok"][i:i + take] = p[done[s]:done[s] + take]
            t["slot"][i:i + take] = s
            t["pos"][i:i + take] = np.arange(done[s], done[s] + take)
            t["off"][i:i + take] = done[s]
            t["pre"][i:i + take] = 1
            done[s] += take
            i += take
        t["lengths"] = np.array([d + max(0, n - 1)
                                 for d, n in zip(done, n_dec)], np.int64)
        ticks.append(t)
    return ticks


class Clock:
    """Time marks on the card's stream (CUDA events) or, on the CPU, the
    host clock."""

    def __init__(self, torch, device):
        self.torch = torch
        self.on_card = torch.device(device).type == "cuda"
        self.kind = "cuda_events" if self.on_card else "host"
        self.marks = []

    def mark(self):
        if self.on_card:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            import time
            self.marks.append(time.perf_counter())

    def ms(self, i, j):
        """Milliseconds from mark i to mark j (synchronises the card)."""
        if self.on_card:
            self.torch.cuda.synchronize()
            return self.marks[i].elapsed_time(self.marks[j])
        return 1e3 * (self.marks[j] - self.marks[i])


def rewind_decode(cfg, params, cache, prompts, *, gen, lay, hp, device,
                  forced=None):
    """The rewind step (each row's last prompt token re-fed at
    ``pos = n - 1``), then ``gen - 1`` greedy (or ``forced`` (B, gen-1))
    ``serve_step``s on ``cache``.  Returns the logits (gen, B, V)."""
    import torch
    from repro_torch.runtime.serve import serve_step
    tok = torch.as_tensor([p[-1] for p in prompts], device=device)
    pos = torch.as_tensor([len(p) - 1 for p in prompts], device=device)
    out = []
    for k in range(gen):
        logits, cache = serve_step(cfg, params, cache, tok, pos + k, lay, hp)
        out.append(logits)
        if k + 1 < gen:
            tok = logits.argmax(dim=-1) if forced is None else forced[:, k]
    return torch.stack(out)


def run_chunked(cfg, params, prompts, *, gen, lay, hp, chunk_len, join,
                device, forced=None):
    """Chunked prefill of ``prompts`` (lists of token ids) into an empty
    cache, row i admitted at call ``join[i]``, then ``rewind_decode``.
    Returns (tokens (B, gen), logits (gen, B, V), a copy of the cache
    after the last chunk, info: prefill_ms (the first chunk call to the
    end of the last), decode_ms_per_token, the number of chunk calls)."""
    import numpy as np
    import torch
    from repro_torch.runtime.serve import init_cache
    from repro_torch.runtime.ticks import chunk_prefill_step
    calls = plan_chunks(prompts, chunk_len, join)
    toks, offs, nreals = (torch.as_tensor(np.stack(a), device=device)
                          for a in zip(*calls))
    cache = init_cache(cfg, lay, len(prompts), hp, device)
    clock = Clock(torch, device)
    clock.mark()
    for i in range(len(calls)):
        chunk_prefill_step(cfg, params, cache, toks[i], offs[i], nreals[i],
                           lay, hp)
    clock.mark()
    snap = [{k: t.clone() for k, t in c.items()} for c in cache]
    clock.mark()
    logits = rewind_decode(cfg, params, cache, prompts, gen=gen, lay=lay,
                           hp=hp, device=device, forced=forced)
    clock.mark()
    info = {"prefill_ms": clock.ms(0, 1),
            "decode_ms_per_token": clock.ms(2, 3) / gen,
            "calls": len(calls), "clock": clock.kind}
    return logits.argmax(dim=-1).T, logits, snap, info


def run_packed(cfg, params, prompts, *, gen, lay, hp, budget, device,
               forced=None):
    """Every prompt admitted at once and served by packed ticks
    (``plan_packed``) until each has ``gen`` tokens, sampled on the card
    by ``pack`` and fed back by ``merge``.  Returns (tokens (B, gen),
    logits (gen, B, V), the cache, info: prefill_ms (the first tick to the
    end of the last with a prompt token), decode_ms_per_tick over the
    ticks after it, the tick count, a mixed tick's index)."""
    import numpy as np
    import torch
    from repro_torch.runtime.serve import init_cache
    from repro_torch.runtime.ticks import merge, pack, packed_step
    ticks = plan_packed(prompts, gen, budget, forced)
    b, v_size = len(prompts), cfg.vocab_size
    head = min(b, budget)

    def stack(key):
        return torch.as_tensor(np.stack([t[key] for t in ticks]),
                               device=device)
    tok, src, slot, pos, off, pre = (stack(k) for k in TICK_KEYS)
    lengths, dslot, flat = stack("lengths"), stack("dslot"), stack("flat")
    is_dec = (pre[:, :head] == 0) & (slot[:, :head] >= 0)
    logits_out = torch.zeros(gen * b, v_size, device=device)
    tok_out = torch.zeros(gen * b, dtype=torch.long, device=device)
    fin_out = torch.zeros(gen * b, dtype=torch.int32, device=device)
    prev = torch.zeros(b, 4, dtype=torch.int32, device=device)
    cache = init_cache(cfg, lay, b, hp, device)
    clock = Clock(torch, device)
    clock.mark()
    for i, t in enumerate(ticks):
        tokens = merge(tok[i], src[i], prev)
        logits, cache = packed_step(cfg, params, cache, tokens, slot[i],
                                    pos[i], off[i], pre[i], lay, hp)
        prev = pack(logits, slot[i, :head], is_dec[i], lengths[i])
        n = t["n_dec"]
        if n:
            rows = flat[i, :n]
            logits_out.index_copy_(0, rows, logits[:n])
            tok_out.index_copy_(0, rows, prev[dslot[i, :n], 0].long())
            fin_out.index_copy_(0, rows, prev[dslot[i, :n], 3])
        clock.mark()
    if not bool((fin_out == 1).all()):
        raise AssertionError("pack flagged a row with a non-finite logit")
    last_pre = max(i for i, t in enumerate(ticks) if t["pre"].any())
    n_after = len(ticks) - 1 - last_pre
    mixed = [i for i, t in enumerate(ticks)
             if t["pre"].any() and t["n_dec"] > 0]
    info = {"prefill_ms": clock.ms(0, last_pre + 1),
            "decode_ms_per_tick": (clock.ms(last_pre + 1, len(ticks))
                                   / max(1, n_after)),
            "total_ms": clock.ms(0, len(ticks)), "ticks": len(ticks),
            "decode_only_ticks": n_after, "clock": clock.kind,
            "mixed_tick": mixed[0] if mixed else None}
    return (tok_out.view(gen, b).T, logits_out.view(gen, b, v_size), cache,
            info)


def profile_ticks(torch, cfg, params, prompts, lay, hp, join):
    """torch.profiler over one chunk call (every row admitted, at its own
    offset) and one mixed packed tick (decode and prompt tokens), each
    on a fresh cache after one untraced call."""
    import numpy as np
    from repro_torch.runtime.serve import init_cache
    from repro_torch.runtime.ticks import chunk_prefill_step, packed_step
    calls = plan_chunks(prompts, CHUNK_LEN, join)
    i = max(join)                               # the first with every row
    args = [torch.as_tensor(a, device="cuda") for a in calls[i]]
    ticks = plan_packed(prompts, GEN, TOKEN_BUDGET)
    t = ticks[[j for j, t in enumerate(ticks)
               if t["pre"].any() and t["n_dec"] > 0][0]]
    targs = [torch.as_tensor(t[k], device="cuda") for k in TICK_KEYS]
    tok, _, slot, pos, off, pre = targs
    out = {}
    for name, fn in (
            ("chunk_call", lambda c: chunk_prefill_step(
                cfg, params, c, *args, lay, hp)),
            ("packed_tick", lambda c: packed_step(
                cfg, params, c, tok, slot, pos, off, pre, lay, hp))):
        cache = init_cache(cfg, lay, len(prompts), hp, "cuda")
        fn(cache)
        out[name] = device_breakdown(trace_window(torch, lambda: fn(cache)),
                                     1)
    out["chunk_call"]["offsets"] = calls[i][1].tolist()
    out["packed_tick"]["tokens"] = {"decode": int(t["n_dec"]),
                                    "prompt": int(np.sum(t["pre"]))}
    return out


def drive_ticks(torch, params, arch=ARCH, cfg=None):
    """Phase 5: the chunked and packed paths in both decode modes, at the
    main path's shape (a model with MoE blocks through ``moe_ticks``);
    returns the launches of each path.  ``cfg`` (default ``arch``'s)
    serves a config cut in depth, ``params`` its layers."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.serve import setup
    from repro_torch.runtime.serve import (ServeHParams, generate,
                                           make_layout, prefill)
    run = setup(arch, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                seq_shards=SHARDS, cr=CR, device="cuda", params=params)
    cfg, prompts_t = cfg or run.cfg, run.prompts
    prompts = prompts_t.tolist()
    join = [i // 2 for i in range(BATCH)]       # staggered admission
    voltage = PrismConfig(P=SHARDS, cr=CR, mode="voltage")
    launches = {}
    for mode in ("exact", "prism"):
        hp = ServeHParams(decode_mode=mode, means_cr=CR)
        lay = make_layout(SHARDS, run.lay.cap, hp, prefill_len=PROMPT)
        kw = dict(gen=GEN, lay=lay, hp=hp, device="cuda")
        if "moe" in cfg.block_kinds:
            launches.update(moe_ticks(torch, cfg, params, prompts, join,
                                      mode, kw))
            continue

        # chunked prefill, the rewind, greedy decode
        run_chunked(cfg, params, prompts, chunk_len=CHUNK_LEN, join=join,
                    **kw)                                        # warm-up
        torch.cuda.synchronize()
        LAUNCHES.clear()
        tokens, logits, snap, info = run_chunked(
            cfg, params, prompts, chunk_len=CHUNK_LEN, join=join, **kw)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        check_launches(f"{arch}/chunked/{mode}", counts,
                       tick_launches(cfg, "chunked", mode, info["calls"]))
        launches[f"chunked/{mode}"] = counts
        _, ref_cache = prefill(cfg, params, prompts_t, voltage, lay, hp)
        leaf_err = {k: max(rel_err(a[k], b[k])
                           for a, b in zip(snap, ref_cache))
                    for k in ref_cache[0]}
        if max(leaf_err.values()) > PATH_REL_TOL or set(snap[0]) != set(
                ref_cache[0]):
            raise AssertionError(f"chunked/{mode}: cache leaves {leaf_err} "
                                 f"vs the monolithic prefill > "
                                 f"{PATH_REL_TOL}")
        if mode == "exact":
            _, ref, _ = generate(cfg, params, prompts_t, gen=GEN,
                                 prism=voltage, lay=lay, hp=hp,
                                 forced=tokens[:, :-1])
            ref_name = "monolithic Voltage prefill, exact decode"
        else:
            ref = rewind_decode(cfg, params, ref_cache, prompts,
                                forced=tokens[:, :-1], **kw)
            ref_name = "monolithic Voltage prefill, rewind, prism decode"
        del snap, ref_cache
        err = rel_err(logits, ref)
        if tuple(logits.shape) != (GEN, BATCH, cfg.vocab_size) or not (
                err <= PATH_REL_TOL):
            raise AssertionError(f"chunked/{mode}: logits rel err {err:.3e} "
                                 f"vs the {ref_name} > {PATH_REL_TOL}")
        checked, total = tokens_agree(torch, tokens, ref)
        del ref
        emit("path", arch=arch, path="chunked", mode=mode, batch=BATCH,
             prompt=PROMPT, layers=cfg.n_layers,
             gen=GEN, shards=SHARDS, cr=CR, chunk_len=CHUNK_LEN, join=join,
             **info, launches=counts, leaf_rel_err=leaf_err,
             logits_rel_err=err, reference=ref_name, tol=PATH_REL_TOL,
             tokens_checked=checked, tokens_total=total)

        # packed ticks, teacher-forced on the chunked path's tokens, so
        # every step's logits compare (and the timed run's warm-up)
        f_tokens, f_logits, _, _ = run_packed(
            cfg, params, prompts, budget=TOKEN_BUDGET,
            forced=tokens[:, :-1].tolist(), **kw)
        err = rel_err(f_logits, logits)
        if tuple(f_logits.shape) != tuple(logits.shape) or not bool(
                torch.isfinite(f_logits).all()) or not err <= PATH_REL_TOL:
            raise AssertionError(f"packed/{mode}: logits rel err {err:.3e} "
                                 f"vs the chunked path > {PATH_REL_TOL}")
        checked, total = tokens_agree(torch, f_tokens, logits)
        del f_logits
        # then greedy through pack / merge, timed and counted
        torch.cuda.synchronize()
        LAUNCHES.clear()
        p_tokens, _, _, p_info = run_packed(
            cfg, params, prompts, budget=TOKEN_BUDGET, **kw)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        check_launches(f"{arch}/packed/{mode}", counts,
                       tick_launches(cfg, "packed", mode, p_info["ticks"]))
        launches[f"packed/{mode}"] = counts
        emit("path", arch=arch, path="packed", mode=mode, batch=BATCH,
             prompt=PROMPT, layers=cfg.n_layers,
             gen=GEN, shards=SHARDS, cr=CR, token_budget=TOKEN_BUDGET,
             **p_info, launches=counts, logits_rel_err=err,
             reference=f"the chunked path ({mode}), teacher-forced",
             tol=PATH_REL_TOL, tokens_checked=checked, tokens_total=total,
             greedy_tokens_equal=bool((p_tokens == tokens).all()))
        del logits
        tr = profile_ticks(torch, cfg, params, prompts, lay, hp, join)
        emit("trace", arch=arch, path="chunked", mode=mode,
             chunk_call=tr["chunk_call"])
        emit("trace", arch=arch, path="packed", mode=mode,
             packed_tick=tr["packed_tick"])
    return launches


def tick_launches(cfg, path, mode, calls_or_ticks):
    """The decode-kernel launches a chunked run (its chunk calls, the
    rewind and decode steps) or a packed run (its ticks; two a layer in
    prism mode) needs, and no other kernel.  The chunk calls take the
    tile route, the rewind and decode steps where static decode does
    (Yi-6B); packed ticks (a row map) the row route."""
    n_layers = cfg.n_layers
    if path == "chunked":
        return {"flash_decode_stats": n_layers * (calls_or_ticks + GEN),
                "flash_decode_stats.mq": n_layers * (
                    calls_or_ticks + (GEN if static_tile(cfg) else 0)),
                "flash_decode_stats.paged": 0,
                "prism_flash_attention": 0, "segment_means": 0}
    per_tick = n_layers * (2 if mode == "prism" else 1)
    return {"flash_decode_stats": per_tick * calls_or_ticks,
            "flash_decode_stats.mq": 0, "flash_decode_stats.paged": 0,
            "prism_flash_attention": 0, "segment_means": 0}


def moe_ticks(torch, cfg, params, prompts, join, mode, kw):
    """Phase 5's chunked and packed paths for a model with MoE blocks, in
    one decode mode.  A chunk call or packed tick routes its tokens as
    one group, so neither path can be held to the monolithic prefill
    (whose groups are the shards) or to the other: each run is held to
    its own backend='plain' twin under ``replay_check``, the cache after
    the last chunk leaf by leaf.  Per path: the counted and timed run,
    recording its routing (the chunked path after a warm-up), then the
    twin teacher-forced on its tokens.  Returns the launches of each
    path."""
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models.moe import RoutingLog
    arch, hp = cfg.name, kw["hp"]
    launches = {}
    for path in ("chunked", "packed"):
        what = f"{arch}/{path}/{mode}"

        def go(hp, forced=None):
            k = dict(kw, hp=hp)
            if path == "chunked":
                return run_chunked(cfg, params, prompts, chunk_len=CHUNK_LEN,
                                   join=join, forced=forced, **k)
            t, lg, _, info = run_packed(
                cfg, params, prompts, budget=TOKEN_BUDGET,
                forced=None if forced is None else forced.tolist(), **k)
            return t, lg, None, info
        if path == "chunked":
            go(hp)                                              # warm-up
        rec = RoutingLog()
        torch.cuda.synchronize()
        LAUNCHES.clear()
        tokens, logits, snap, info = go(replace(hp, routing=rec))
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        check_launches(what, counts, tick_launches(
            cfg, path, mode, info["calls" if path == "chunked"
                                   else "ticks"]))
        launches[f"{path}/{mode}"] = counts
        twin = RoutingLog(replay=rec)
        _, ref, p_snap, _ = go(replace(hp, backend="plain", routing=twin),
                               forced=tokens[:, :-1])
        routing = replay_check(torch, rec, twin, what)
        del rec, twin
        leaf_err = {}
        if path == "chunked":
            leaf_err = {k: max(rel_err(a[k], b[k])
                               for a, b in zip(snap, p_snap))
                        for k in snap[0]}
            if max(leaf_err.values()) > PATH_REL_TOL:
                raise AssertionError(f"{what}: cache leaves {leaf_err} vs "
                                     f"the plain twin > {PATH_REL_TOL}")
        err = rel_err(logits, ref)
        if tuple(logits.shape) != (GEN, BATCH, cfg.vocab_size) or not (
                err <= PATH_REL_TOL):
            raise AssertionError(f"{what}: logits rel err {err:.3e} vs the "
                                 f"plain twin > {PATH_REL_TOL}")
        checked, total = tokens_agree(torch, tokens, ref)
        emit("path", arch=arch, path=path, mode=mode, batch=BATCH,
             prompt=PROMPT, layers=cfg.n_layers, gen=GEN, shards=SHARDS, cr=CR,
             chunk_len=CHUNK_LEN, join=join, token_budget=TOKEN_BUDGET,
             **info, launches=counts, leaf_rel_err=leaf_err,
             logits_rel_err=err,
             reference="backend='plain' twin replaying the routing",
             tol=PATH_REL_TOL, tokens_checked=checked, tokens_total=total,
             routing=routing)
        del logits, ref, snap, p_snap
    tr = profile_ticks(torch, cfg, params, prompts, kw["lay"], hp, join)
    emit("trace", arch=arch, path="chunked", mode=mode,
         chunk_call=tr["chunk_call"])
    emit("trace", arch=arch, path="packed", mode=mode,
         packed_tick=tr["packed_tick"])
    return launches


# ---------------------------------------------------------------------------
# phase 6: the serving engine on the paged cache
# ---------------------------------------------------------------------------

# the engine at full width: 8 slots, prefill 512, cap 576 (36 pages of 16
# tokens a row, 288 in the pool), ticks of 72 tokens, chunks of 64
ENGINE = dict(n_slots=BATCH, prefill_len=PROMPT, max_cache=PROMPT + GEN,
              chunk_len=CHUNK_LEN, token_budget=TOKEN_BUDGET)
ENGINE_REQUESTS, SYSTEM_PROMPT = 16, 256
# (prefill mode, decode mode) of the paged runs, each checked against the
# same trace on the dense cache
ENGINE_RUNS = (("packed", "exact"), ("packed", "prism"), ("chunked", "exact"))
# the most requests whose tokens may part at a near-tie (a top-2 gap
# within TOKEN_GAP) before the check fails
ENGINE_MAX_DIVERGED = 2


def engine_trace(vocab):
    """16 prompts from a seeded rng: lengths in [64, 512]; the even ones
    begin with one shared 256-token system prompt (their lengths in
    [272, 512], so each has a page of its own past it)."""
    import numpy as np
    rng = np.random.default_rng(0)
    system = rng.integers(1, vocab, size=SYSTEM_PROMPT).tolist()
    prompts = []
    for i in range(ENGINE_REQUESTS):
        if i % 2 == 0:
            n = int(rng.integers(SYSTEM_PROMPT + 16, PROMPT + 1))
            prompts.append(system + rng.integers(
                1, vocab, size=n - SYSTEM_PROMPT).tolist())
        else:
            n = int(rng.integers(PROMPT // 8, PROMPT + 1))
            prompts.append(rng.integers(1, vocab, size=n).tolist())
    return prompts


def run_engine(torch, cfg, params, prefill, mode, paged, prompts,
               forced=None, gen=GEN, **hp_over):
    """The trace through ``ServingEngine``: every request submitted at
    t = 0 (8 take the slots, the rest admit as slots free up), ``gen``
    greedy tokens each (64).  The engine's tick callables are wrapped here to keep
    each decode row's logits by request (and, with ``forced``, to
    teacher-force each request's tokens).  ``hp_over``: fields of the
    run's ``ServeHParams`` (a plain twin's backend, a ``RoutingLog``).
    Launch counters are zeroed just before ``run`` and read just after.
    Returns (engine, tokens, logits by request, launches, wall s)."""
    import time
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    eng = ServingEngine(cfg, params, EngineConfig(
        hp=ServeHParams(decode_mode=mode, means_cr=CR, **hp_over),
        paged=paged, prefill_mode=prefill, **ENGINE), n_seq=SHARDS)
    log = keep_logits(eng, forced)
    for prompt in prompts:
        eng.submit(prompt, max_new_tokens=gen)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, out, log, dict(LAUNCHES), wall


def keep_logits(eng, forced=None):
    """Wrap the engine's tick callables to keep each decode row's logits
    by request: {rid: [logits row, ...]} in the order sampled (a
    request that starts again keeps its earlier rows before the new
    ones).  ``forced`` {rid: tokens}: the engine samples request rid's
    k-th token as ``forced[rid][k]`` (its logit raised above the row's
    largest in a copy the engine sees), the log keeps the real row."""
    log = {}
    packed, decode = eng._packed, eng._decode

    def keep(logits, slots):
        seen = logits.clone() if forced is not None else logits
        for j, s in slots:
            rid = eng._sched.active[s].req.rid
            log.setdefault(rid, []).append(logits[j])
            if forced is not None:
                tok = forced[rid][len(log[rid]) - 1]
                seen[j, tok] = logits[j].max() + 1.0
        return seen

    def packed_tick(tok, slot, pos, off, pre):
        return keep(packed(tok, slot, pos, off, pre),
                    [(j, int(slot[j])) for j in range(len(slot))
                     if slot[j] >= 0 and pre[j] == 0])

    def decode_step(tok, pos):
        return keep(decode(tok, pos),
                    [(s, s) for s in range(len(pos)) if pos[s] >= 0])
    eng._packed, eng._decode = packed_tick, decode_step
    return log


def engine_launches(eng, paged, n_layers, since=None):
    """The decode-kernel launches a run needs: one a layer per decode
    step and chunk call, per packed tick too (two in prism mode: the
    owner view over the means), every one through the page table when
    paged; the tile route on chunk calls, and on decode steps where
    static decode takes it (Yi-6B); no other kernel.
    ``since``: the stats a restored engine started from."""
    s = eng.stats
    ticks = [s.decode_steps, s.packed_ticks, s.prefill_chunks]
    if since is not None:
        ticks = [a - b for a, b in zip(ticks, (
            since.decode_steps, since.packed_ticks, since.prefill_chunks))]
    decode_steps, packed_ticks, chunks = ticks
    per_tick = 2 if eng.config.hp.decode_mode == "prism" else 1
    n = n_layers * (decode_steps + per_tick * packed_ticks + chunks)
    tile = chunks + (decode_steps if static_tile(eng.cfg) else 0)
    return {"flash_decode_stats": n,
            "flash_decode_stats.paged": n if paged else 0,
            "flash_decode_stats.mq": n_layers * tile,
            "prism_flash_attention": 0, "segment_means": 0}


def compare_engine(torch, out_p, log_p, out_d, log_d, what="engine"):
    """A run against its reference run, request by request: while a
    request's tokens agree, its logits within PATH_REL_TOL of the
    reference's largest |logit|; tokens equal wherever the reference's
    top-2 gap exceeds TOKEN_GAP of it.  A request that parts at a
    near-tie is compared no further; more than ENGINE_MAX_DIVERGED of
    them fail."""
    top = max(float(torch.stack(v).abs().max()) for v in log_d.values())
    if sorted(out_p) != sorted(out_d):
        raise AssertionError(f"{what}: the runs finished other requests")
    diverged, checked, worst = [], 0, 0.0
    for rid in sorted(out_d):
        lp, ld = torch.stack(log_p[rid]), torch.stack(log_d[rid])
        if lp.shape != ld.shape or len(out_p[rid]) != GEN or not bool(
                torch.isfinite(lp).all()):
            raise AssertionError(f"{what}: request {rid}: logits "
                                 f"{tuple(lp.shape)} vs {tuple(ld.shape)}")
        err = (lp - ld).abs().amax(dim=-1).cpu().tolist()
        top2 = ld.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().tolist()
        for k in range(GEN):
            if err[k] > PATH_REL_TOL * top:
                raise AssertionError(f"{what}: request {rid} step {k}: "
                                     f"logits err {err[k]:.3e} > "
                                     f"{PATH_REL_TOL} x {top:.3f}")
            worst = max(worst, err[k] / top)
            checked += 1
            if out_p[rid][k] != out_d[rid][k]:
                if gap[k] > TOKEN_GAP * top:
                    raise AssertionError(f"{what}: request {rid} step {k}: "
                                         "tokens differ at a clear top-2 "
                                         "gap")
                diverged.append(rid)
                break
    if len(diverged) > ENGINE_MAX_DIVERGED:
        raise AssertionError(f"{what}: {len(diverged)} requests parted at "
                             f"near-ties (at most {ENGINE_MAX_DIVERGED})")
    return {"logits_rel_err": worst, "steps_checked": checked,
            "diverged_at_near_tie": diverged,
            "tokens_equal": sum(out_p[r] == out_d[r] for r in out_d)}


def moe_engine_runs(torch, cfg, params, prefill, mode, prompts):
    """Phase 6's runs of one (prefill, decode) mode for a model with MoE
    blocks, both on the paged cache.  A tick routes its tokens as one
    group, and exact mode's prefix hits change which tokens a tick
    holds, so the dense cache's run is no reference.  The counted and
    timed run records its routing; the backend='plain' twin, teacher-
    forced on its tokens, replays it (``replay_check``): the run is held
    to the twin's logits, and its tokens to the twin's own greedy choice
    where the gap is clear.  Returns ({True: the run, False: the twin},
    the comparison, the reference's name)."""
    from repro_torch.models.moe import RoutingLog
    what = f"{cfg.name}/engine/{prefill}/{mode}"
    rec = RoutingLog()
    eng, out, log, counts, wall = run_engine(
        torch, cfg, params, prefill, mode, True, prompts, routing=rec)
    check_launches(f"{what}/paged", counts,
                   engine_launches(eng, True, cfg.n_layers))
    twin = RoutingLog(replay=rec)
    t_eng, _, t_log, t_counts, t_wall = run_engine(
        torch, cfg, params, prefill, mode, True, prompts, forced=out,
        backend="plain", routing=twin)
    own = {rid: [int(row.argmax()) for row in rows]
           for rid, rows in t_log.items()}
    cmp = compare_engine(torch, out, log, own, t_log, what=what)
    cmp["routing"] = replay_check(torch, rec, twin, what)
    return ({True: (eng, out, log, counts, wall),
             False: (t_eng, own, t_log, t_counts, t_wall)}, cmp,
            "the backend='plain' twin on the paged cache, teacher-forced "
            "on the run and replaying its routing")


def engine_record(eng, out, wall):
    """What a run gives its users, on the host clock: wall time, tokens
    a second, time to the first token and ms per tick."""
    import numpy as np
    s = eng.stats.summary()
    lat = list(eng.stats.step_latency)
    n = sum(len(v) for v in out.values())
    return {"wall_s": wall, "tokens": n, "tokens_per_s": n / wall,
            "ttft_p50_s": s["ttft_p50_s"], "ttft_p90_s": s["ttft_p90_s"],
            "ms_per_tick": 1e3 * float(np.mean(lat)),
            "ms_per_tick_p50": s["step_ms_p50"],
            "ticks": len(lat), "packed_ticks": s["packed_ticks"],
            "decode_steps": s["decode_steps"],
            "prefill_chunks": s["prefill_chunks"],
            "prefill_tokens": s["prefill_tokens"],
            "prefix_hits": s["prefix_hits"],
            "prefix_tokens_saved": s["prefix_tokens_saved"],
            "out_of_pages": s["out_of_pages"], "clock": "host"}


def profile_paged_tick(torch, cfg, params, mode, prompts):
    """torch.profiler over one mixed packed tick (decode and prompt
    tokens) on the paged cache, every slot's pages a seeded permutation
    of the pool, and over the same tick on the dense cache; each on a
    fresh cache after one untraced call."""
    import numpy as np
    from repro_torch.runtime.paging import make_paged_layout
    from repro_torch.runtime.serve import (ServeHParams, init_cache,
                                           make_layout, paged_placement)
    from repro_torch.runtime.ticks import packed_step
    hp = ServeHParams(decode_mode=mode, means_cr=CR)
    ticks = plan_packed(prompts, GEN, TOKEN_BUDGET)
    t = ticks[[j for j, t in enumerate(ticks)
               if t["pre"].any() and t["n_dec"] > 0][0]]
    targs = [torch.as_tensor(t[k], device="cuda") for k in
             ("tok", "slot", "pos", "off", "pre")]
    out = {}
    for paged in (True, False):
        base = make_layout(SHARDS, PROMPT + GEN, hp, prefill_len=PROMPT)
        paging = (make_paged_layout(base, page_tokens=PAGE_COLS * SHARDS,
                                    n_pages=None, n_slots=BATCH)
                  if paged else None)
        lay = make_layout(SHARDS, PROMPT + GEN, hp, prefill_len=PROMPT,
                          placement=paged_placement(hp, paging))
        maps = ()
        if paged:
            perm = np.random.default_rng(0).permutation(paging.n_pages)
            maps = (torch.as_tensor(perm.reshape(BATCH, -1), device="cuda",
                                    dtype=torch.int32),
                    torch.arange(BATCH, device="cuda", dtype=torch.int32))
        cache = init_cache(cfg, lay, BATCH, hp, "cuda", paging)

        def tick():
            packed_step(cfg, params, cache, *targs, lay, hp, *maps)
        tick()
        key = "paged" if paged else "dense"
        out[key] = device_breakdown(trace_window(torch, tick), 1)
    out["tokens"] = {"decode": int(t["n_dec"]),
                     "prompt": int(np.sum(t["pre"]))}
    return out


def drive_engine(torch, params, arch=ARCH, runs=ENGINE_RUNS, cfg=None):
    """Phase 6: the trace through the paged engine in each of ``runs``,
    each checked against the dense cache's run (a model with MoE blocks:
    against its backend='plain' twin, ``moe_engine_runs``); exact mode's
    prefix cache must hit and account for every page.  Returns the launches of
    each paged run, and each packed paged run's tokens and logits by
    decode mode (phases 7 and 8's reference).  ``cfg`` (default
    ``arch``'s) serves a config cut in depth, ``params`` its layers."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config(arch)
    prompts = engine_trace(cfg.vocab_size)
    card = nvidia_smi()
    moe = "moe" in cfg.block_kinds
    launches, kept = {}, {}
    for prefill, mode in runs:
        if moe:
            runs, cmp, ref_name = moe_engine_runs(torch, cfg, params,
                                                  prefill, mode, prompts)
        else:
            runs = {}
            for paged in (True, False):
                eng, out, log, counts, wall = run_engine(
                    torch, cfg, params, prefill, mode, paged, prompts)
                check_launches(f"{arch}/engine/{prefill}/{mode}/"
                               f"{'paged' if paged else 'dense'}", counts,
                               engine_launches(eng, paged, cfg.n_layers))
                runs[paged] = (eng, out, log, counts, wall)
            ref_name = "the same trace on the dense cache (paged=False)"
        eng, out, log, counts, wall = runs[True]
        d_eng, d_out, d_log, d_counts, d_wall = runs[False]
        if len(d_out) != ENGINE_REQUESTS:
            raise AssertionError(f"engine/{prefill}/{mode}: {len(d_out)} "
                                 "requests finished")
        if not moe:
            cmp = compare_engine(torch, out, log, d_out, d_log)
        kv = eng.kv_cache
        kv.check()
        registered = ({p for e in kv.prefix.entries.values()
                       for p in e.pages} if kv.prefix is not None else set())
        if kv.table.free_pages + len(registered) != kv.paging.n_pages or (
                kv.slot_pages):
            raise AssertionError(f"engine/{prefill}/{mode}: pages not "
                                 f"accounted for: {kv.stats()}")
        if mode == "exact" and eng.stats.prefix_hits == 0:
            raise AssertionError(f"engine/{prefill}/{mode}: no prefix hit")
        launches[f"engine/{prefill}/{mode}"] = counts
        if prefill == "packed":
            kept[mode] = (out, log)
        emit("path", arch=arch, path="engine", prefill=prefill, mode=mode,
             card=card, layers=cfg.n_layers, **ENGINE,
             shards=SHARDS, cr=CR, requests=ENGINE_REQUESTS, gen=GEN,
             system_prompt=SYSTEM_PROMPT, pages=kv.stats(),
             registered_pages=len(registered),
             paged=engine_record(eng, out, wall),
             **{"plain_twin" if moe else "dense": engine_record(
                 d_eng, d_out, d_wall)},
             launches=counts, dense_launches=d_counts,
             reference=ref_name, tol=PATH_REL_TOL, token_gap=TOKEN_GAP,
             **cmp)
        del runs, log, out, d_log, d_out
    for mode in ("exact", "prism"):
        emit("trace", arch=arch, path="engine", mode=mode, card=card,
             packed_tick=profile_paged_tick(torch, cfg, params, mode,
                                            prompts[:BATCH]))
    return launches, kept


# ---------------------------------------------------------------------------
# phase 7: the engine's host offload tier, preemption, faults, snapshots
# ---------------------------------------------------------------------------

# phase 6's engine on half its pool (4 rows of 36 pages) with the host
# offload tier: the even prompts at priority 0 at t = 0, the odd ones at
# priority 1 after the engine's 20th step; a snapshot after its 40th
ROBUST = dict(ENGINE, n_pages=144, offload=True)
ROBUST_JOIN, ROBUST_SNAPSHOT = 20, 40
# the chaos run: each kind (but shard_loss, phase 8b's) at a fixed
# opportunity, so that every one fires: the first spill lost, the second
# store read torn (retried), the first decode tick's page poisoned, the
# fourth admission stalled, the sixth tick delayed
ROBUST_FAULTS = dict(store_put_loss=(0,), store_get_loss=(1,),
                     page_poison=(0,), admission_stall=(3,),
                     tick_delay=(5,))


def time_moves(torch, eng):
    """Wrap the engine cache's ``spill`` and ``restore`` to time each on
    the host clock, the card synchronised on both sides (a spill's copy
    is synchronous; a restore's host-to-device copy is not, and is timed
    to its end).  Returns {"spill": [(s, bytes)], "restore": [...]}: the
    bytes are the pages' K/V and the state row moved."""
    import time
    from repro_torch.runtime.paging import KV_LEAVES, STATE_LEAVES
    kv = eng.kv_cache
    page_b = sum(c[k][0].nbytes for c in kv.storage for k in KV_LEAVES)
    state_b = sum(c[k][0].nbytes for c in kv.storage for k in STATE_LEAVES
                  if k in c)
    rec = {"spill": [], "restore": []}
    spill, restore = kv.spill, kv.restore

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def spill_t(key, slot, store, *, tokens=0):
        n, dt = timed(spill, key, slot, store, tokens=tokens)
        rec["spill"].append((dt, n * page_b + state_b))
        return n

    def restore_t(key, slot, store, **kw):
        ok, dt = timed(restore, key, slot, store, **kw)
        if ok:
            rec["restore"].append((dt, len(kv.slot_pages[slot]) * page_b
                                   + state_b))
        return ok
    kv.spill, kv.restore = spill_t, restore_t
    return rec


def moves_record(rec):
    """Per kind: count, median ms and MB a request, MB/s over all the
    bytes moved."""
    import numpy as np
    out = {}
    for kind, xs in rec.items():
        if not xs:
            out[kind] = {"n": 0}
            continue
        t, b = np.array(xs).T
        out[kind] = {"n": len(xs), "ms_p50": 1e3 * float(np.median(t)),
                     "ms_max": 1e3 * float(t.max()),
                     "MB_p50": float(np.median(b)) / 1e6,
                     "MB_per_s": float(b.sum() / t.sum()) / 1e6}
    return out


def robust_engine(cfg, params, mode, faults=None):
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    return ServingEngine(cfg, params, EngineConfig(
        hp=ServeHParams(decode_mode=mode, means_cr=CR),
        prefill_mode="packed", faults=faults, **ROBUST), n_seq=SHARDS)


def run_robust(torch, cfg, params, mode, prompts, faults=None,
               snapshot=False):
    """The priority-pressure trace through a fresh engine, step by step:
    the even prompts at priority 0 first, the odd ones at priority 1
    after step ``ROBUST_JOIN``, a snapshot after step ``ROBUST_SNAPSHOT``
    (its time left out of the wall time).  Launch counters are zeroed
    just before the first step and read just after the last.  Returns
    the engine, tokens and logits by prompt index, the prompt index of
    each rid, launches, wall s, spill/restore times, the snapshot and
    its seconds."""
    import time
    from repro_torch.kernels.dispatch import LAUNCHES
    eng = robust_engine(cfg, params, mode, faults)
    log, moves = keep_logits(eng), time_moves(torch, eng)
    index = {}
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    for i in range(0, ENGINE_REQUESTS, 2):
        index[eng.submit(prompts[i], max_new_tokens=GEN)] = i
    steps, snap, snap_s = 0, None, 0.0
    while steps <= ROBUST_JOIN or eng._sched.has_work:
        if steps == ROBUST_JOIN:
            for i in range(1, ENGINE_REQUESTS, 2):
                index[eng.submit(prompts[i], max_new_tokens=GEN,
                                 priority=1)] = i
        if snapshot and steps == ROBUST_SNAPSHOT:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            snap = eng.snapshot()
            snap_s = time.perf_counter() - ts
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - snap_s
    counts = dict(LAUNCHES)
    out = {index[r]: v for r, v in eng.results().items()}
    # a request that started again keeps only its last GEN rows
    log = {index[r]: v[-GEN:] for r, v in log.items()
           if r in eng.results()}
    return eng, out, log, index, counts, wall, moves, snap, snap_s


def check_drained(eng, what):
    """Leak-free after the drain: the refcounts hold, no slot holds
    pages, every page is free or held by a prefix entry, the store (if
    any) is empty."""
    kv = eng.kv_cache
    kv.check()
    held = ({p for e in kv.prefix.entries.values() for p in e.pages}
            if kv.prefix is not None else set())
    if (kv.slot_pages or kv.slot_state
            or kv.table.free_pages + len(held) != kv.paging.n_pages):
        raise AssertionError(f"{what}: pages not accounted for: "
                             f"{kv.stats()}")
    store = eng.kv_store
    if store is not None and (len(store) or store.bytes_used):
        raise AssertionError(f"{what}: store not empty: {store.stats()}")
    return len(held)


def robust_record(eng, out, wall, moves):
    s = eng.stats.summary()
    return {**engine_record(eng, out, wall),
            **{k: s[k] for k in ("preemptions", "spilled_pages",
                                 "restore_hits", "restore_misses",
                                 "quarantined", "restarts",
                                 "failed_requests", "faults_by_kind",
                                 "store_get_retries")},
            "spill": moves["spill"], "restore": moves["restore"]}


def drive_robust(torch, params, phase6):
    """Phase 7: (a) priority pressure on half the pool in packed exact and
    packed prism, each request's tokens and logits held to phase 6's
    paged run of its mode; (b) the chaos run in packed exact, every
    request that did not fail held to (a)'s exact run; (c) (a)'s
    snapshot after step 40 restored into a fresh engine and run to the
    end, token-equal to (a).  Every run drains leak-free.  Returns the
    launches of each run."""
    import time
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    cfg = get_config(ARCH)
    prompts = engine_trace(cfg.vocab_size)
    card = nvidia_smi()
    launches, pressure = {}, {}
    for mode in ("exact", "prism"):
        path = f"robust/pressure/{mode}"
        eng, out, log, index, counts, wall, moves, snap, snap_s = \
            run_robust(torch, cfg, params, mode, prompts, snapshot=True)
        check_launches(path, counts, engine_launches(eng, True,
                                                     cfg.n_layers))
        s = eng.stats
        if s.preemptions < 1 or s.restore_hits < 1 or s.restore_misses:
            raise AssertionError(f"{path}: preemptions {s.preemptions}, "
                                 f"restore hits {s.restore_hits}, misses "
                                 f"{s.restore_misses}")
        if len(out) != ENGINE_REQUESTS:
            raise AssertionError(f"{path}: {len(out)} requests finished")
        registered = check_drained(eng, path)
        cmp = compare_engine(torch, out, log, *phase6[mode], what=path)
        launches[path] = counts
        pressure[mode] = (out, log)
        emit("path", path="robust", run="pressure", mode=mode, card=card,
             **ROBUST, join_step=ROBUST_JOIN, shards=SHARDS, cr=CR,
             requests=ENGINE_REQUESTS, gen=GEN,
             record=robust_record(eng, out, wall, moves_record(moves)),
             pages=eng.kv_cache.stats(), registered_pages=registered,
             launches=counts, snapshot_s=snap_s,
             reference="phase 6's paged run of the same mode",
             tol=PATH_REL_TOL, token_gap=TOKEN_GAP, **cmp)
        # (c) the snapshot taken after step ROBUST_SNAPSHOT of this run
        path = f"robust/snapshot/{mode}"
        eng2 = robust_engine(cfg, params, mode)
        moves2 = time_moves(torch, eng2)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        eng2.restore(snap)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        res = eng2.run()
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        counts2 = dict(LAUNCHES)
        check_launches(path, counts2, engine_launches(
            eng2, True, cfg.n_layers, since=snap.stats))
        out2 = {index[r]: v for r, v in res.items()}
        if out2 != out:
            diff = sorted(i for i in out if out2.get(i) != out[i])
            raise AssertionError(f"{path}: the restored engine's tokens "
                                 f"differ from the run's, requests {diff}")
        check_drained(eng2, path)
        launches[path] = counts2
        emit("path", path="robust", run="snapshot", mode=mode, card=card,
             snapshot_step=ROBUST_SNAPSHOT, snapshot_s=snap_s,
             restore_s=restore_s, live_slots=len(snap.active),
             spilled_at_cut=len(snap.store_entries),
             record=robust_record(eng2, out2, wall2, moves_record(moves2)),
             stats_note="stats carry over from the snapshot; wall_s is "
                        "the restore and the run after it",
             launches=counts2, tokens_equal=len(out2))
        del eng, eng2, snap, log

    # (b) chaos, packed exact
    path = "robust/chaos/exact"
    plan = FaultPlan(seed=0, **{k: FaultSpec(at=v)
                                for k, v in ROBUST_FAULTS.items()})
    eng, out, log, index, counts, wall, moves, _, _ = run_robust(
        torch, cfg, params, "exact", prompts, faults=plan)
    check_launches(path, counts, engine_launches(eng, True, cfg.n_layers))
    s = eng.stats
    failed = {index[r]: why for r, why in eng.failed().items()}
    if set(out) | set(failed) != set(range(ENGINE_REQUESTS)):
        raise AssertionError(f"{path}: requests lost: {sorted(out)} "
                             f"finished, {failed} failed")
    unfired = [k for k in ROBUST_FAULTS if not s.faults_by_kind.get(k)]
    if unfired or s.quarantined < 1 or s.restarts < 1:
        raise AssertionError(f"{path}: faults {s.faults_by_kind}, "
                             f"quarantined {s.quarantined}, restarts "
                             f"{s.restarts}")
    check_drained(eng, path)
    ref_out, ref_log = pressure["exact"]
    cmp = compare_engine(torch, out, log, {i: ref_out[i] for i in out},
                         {i: ref_log[i] for i in out}, what=path)
    launches[path] = counts
    emit("path", path="robust", run="chaos", mode="exact", card=card,
         faults={k: list(v) for k, v in ROBUST_FAULTS.items()},
         record=robust_record(eng, out, wall, moves_record(moves)),
         failed=failed, launches=counts,
         reference="(a)'s exact run", tol=PATH_REL_TOL,
         token_gap=TOKEN_GAP, **cmp)
    return launches


# ---------------------------------------------------------------------------
# phase 8: streaming, the degraded mesh, padded and gang admission
# ---------------------------------------------------------------------------

# (a) the streaming loop's traced windows: loop iterations before the
# window and in it
STREAM_SKIP, STREAM_WINDOW = 30, 24
# (b) sequence shard 1 lost at the engine's 60th and 150th ticks with
# work (every slot decoding then), each time up to 8 ticks served
# through the standby replicas (the engine's default is 2; 8 give a
# degraded tick's time more samples; two windows tell a slow window of
# the host from a slow degraded tick)
SHARD_LOSS_AT, SHARD_LOST, DEGRADED_GRACE = (60, 150), 1, 8
# what the lost shard's columns hold once it is lost: NaN, which the hand
# kernel never loads (a dead column), so any read of them would show
LOST_FILL = float("nan")


def engine_config(mode, **over):
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig
    backend = over.pop("backend", "auto")
    return EngineConfig(hp=ServeHParams(decode_mode=mode, means_cr=CR,
                                        backend=backend),
                        **{**ENGINE, "prefill_mode": "packed", **over})


def compare_tokens(out, ref_out, ref_log, what):
    """Tokens against a reference run's, request by request: a request
    may part from it only where the reference's top-2 gap is within
    TOKEN_GAP of its largest |logit| (at most ENGINE_MAX_DIVERGED)."""
    import torch
    if sorted(out) != sorted(ref_out):
        raise AssertionError(f"{what}: the runs finished other requests")
    top = max(float(torch.stack(v).abs().max()) for v in ref_log.values())
    diverged = []
    for rid in sorted(ref_out):
        if out[rid] == ref_out[rid]:
            continue
        k = next(i for i, (a, b) in enumerate(zip(out[rid], ref_out[rid]))
                 if a != b)
        top2 = ref_log[rid][k].topk(2).values
        if float(top2[0] - top2[1]) > TOKEN_GAP * top:
            raise AssertionError(f"{what}: request {rid} step {k}: tokens "
                                 "differ at a clear top-2 gap")
        diverged.append(rid)
    if len(diverged) > ENGINE_MAX_DIVERGED:
        raise AssertionError(f"{what}: {len(diverged)} requests parted at "
                             f"near-ties (at most {ENGINE_MAX_DIVERGED})")
    return {"tokens_equal": len(ref_out) - len(diverged),
            "diverged_at_near_tie": diverged}


def stream_record(eng, seng, out, wall):
    import numpy as np
    s = eng.stats.summary()
    itl = [dt for ds in seng.itl_samples().values() for dt in ds]
    return {**engine_record(eng, out, wall),
            "itl_p50_s": float(np.percentile(itl, 50)),
            "itl_p99_s": float(np.percentile(itl, 99)),
            "host_overhead_fraction": s["host_overhead_fraction"],
            "tokens_streamed": s["tokens_streamed"],
            "overlap": seng.overlap, "depth": seng.depth}


def stream_window(torch, cfg, params, mode, overlap, prompts):
    """A fresh streamed run: ``STREAM_SKIP`` loop iterations untraced,
    then torch.profiler over the next ``STREAM_WINDOW`` (with the card's
    sync debug mode on, its warnings kept), per tick dispatched."""
    import warnings
    from repro_torch.serving import ServingEngine, StreamingEngine
    eng = ServingEngine(cfg, params, engine_config(mode), n_seq=SHARDS)
    seng = StreamingEngine(eng, overlap=overlap)
    for p in prompts:
        seng.submit_stream(p, max_new_tokens=GEN)
    for _ in range(STREAM_SKIP):
        seng.step()
    st = eng.stats
    n0 = st.packed_ticks + st.decode_steps
    syncs = []

    def window():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(STREAM_WINDOW):
                    seng.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # where each synchronising operation was called from (the mode's
        # own notice that it is a prototype aside)
        syncs.extend(f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
                     for w in caught if "prototype" not in str(w.message))
    prof = trace_window(torch, window)
    ticks = st.packed_ticks + st.decode_steps - n0
    out = device_breakdown(prof, max(1, ticks))
    out.update(ticks=ticks, syncs=len(syncs), sync_sites=sorted(set(syncs)))
    seng.drain()
    return out


def drive_streaming(torch, cfg, params, prompts, phase6, card):
    """(a): the trace through ``StreamingEngine`` in packed exact and prism,
    overlap on, then off (two turns: the script's time limit; host time
    moves between runs, PERF.md §4); tokens held to phase 6's synchronous
    paged run; then
    a profiled window of each.  On the overlapped path no host
    synchronisation may happen inside a window but the reconcile's event
    wait (the card's sync debug mode names any other); returns the
    launches of each run and the sites of any such synchronisation."""
    import time
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.serving import ServingEngine, StreamingEngine
    launches, syncs = {}, {}
    for mode in ("exact", "prism"):
        windows = {}
        for turn, overlap in enumerate((True, False)):
            tag = "overlap" if overlap else "sync"
            path = f"stream/{mode}/{tag}/{1 + turn // 2}"
            eng = ServingEngine(cfg, params, engine_config(mode),
                                n_seq=SHARDS)
            seng = StreamingEngine(eng, overlap=overlap)
            streams = dict(seng.submit_stream(p, max_new_tokens=GEN)
                           for p in prompts)
            torch.cuda.synchronize()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            out = seng.run_sync()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(LAUNCHES)
            check_launches(path, counts, engine_launches(eng, True,
                                                         cfg.n_layers))
            if any(s.drain() != out[r] or s.finished != "length"
                   for r, s in streams.items()):
                raise AssertionError(f"{path}: a stream did not deliver "
                                     "its request's tokens")
            cmp = compare_tokens(out, *phase6[mode], path)
            check_drained(eng, path)
            launches[path] = counts
            if tag not in windows:
                windows[tag] = stream_window(torch, cfg, params, mode,
                                             overlap, prompts)
                if overlap and windows[tag]["syncs"]:
                    syncs[path] = windows[tag]["sync_sites"]
            emit("path", path="stream", mode=mode, overlap=overlap,
                 turn=turn, card=card, **ENGINE, requests=ENGINE_REQUESTS,
                 gen=GEN,
                 record=stream_record(eng, seng, out, wall),
                 launches=counts, reference="phase 6's paged run of the "
                 "same mode (synchronous engine)", **cmp)
        emit("trace", path="stream", mode=mode, card=card,
             window_iterations=STREAM_WINDOW, after=STREAM_SKIP,
             streamed=windows["overlap"], synchronous=windows["sync"])
    return launches, syncs


def drive_shard_loss(torch, cfg, params, prompts, phase6, card):
    """(b): ``shard_loss`` on shard 1 at the engine's 60th and 150th ticks
    with work, each window at most ``DEGRADED_GRACE`` degraded ticks,
    packed exact and prism.  When the shard is lost the active slots'
    K/V columns on it are filled with NaN, so that any read of them
    shows; the degraded ticks' logits must be finite, the recovery's
    scrub clears the NaN, and every request's tokens and logits after the
    recoveries are held to phase 6's paged run under its rules.  The
    degraded step runs under the card's sync debug mode: its only host
    synchronisations may be the engine's input copies.  Captures (ms,
    bytes), ms per degraded tick against the 8 healthy decode ticks
    nearest each window, the recovery step and the time until every
    restarted request decodes again, on the host clock with the card
    synchronised."""
    import time
    import warnings
    import numpy as np
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    from repro_torch.serving import ServingEngine
    launches = {}
    for mode in ("exact", "prism"):
        path = f"degraded/{mode}"
        plan = FaultPlan(shard_loss=FaultSpec(at=SHARD_LOSS_AT,
                                              shard=SHARD_LOST))
        eng = ServingEngine(cfg, params, engine_config(
            mode, faults=plan, degraded_grace=DEGRADED_GRACE), n_seq=SHARDS)
        log = keep_logits(eng)
        kv, rep = eng.kv_cache, eng._replica
        caps, lost_at, finite, fill_s = [], [], [], [0.0]
        sync_sites = set()
        capture, lose, degraded = (rep.capture, eng._lose_shard,
                                   eng._decode_degraded)

        def timed_capture(kv_, st, tick_no=0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            capture(kv_, st, tick_no)
            torch.cuda.synchronize()
            caps.append((time.perf_counter() - t0,
                         rep._slots[st.slot].nbytes))

        def lose_and_poison(shard):
            lose(shard)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pages = sorted({p for s in eng._sched.active
                            for p in kv.slot_pages[s]})
            idx = torch.as_tensor(pages, device=eng.device)
            for c in kv.storage:
                for name in ("k", "v"):
                    c[name][idx, shard] = LOST_FILL
            torch.cuda.synchronize()
            fill_s[0] = time.perf_counter() - t0
            lost_at.append({"pages": len(pages),
                            "slots": len(eng._sched.active),
                            "decoding": len(eng._sched.decoding())})

        def checked_degraded(tok, pos):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    logits = degraded(tok, pos)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            sync_sites.update(
                f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
                for w in caught if "prototype" not in str(w.message))
            finite.append(bool(torch.isfinite(logits[torch.as_tensor(
                pos >= 0, device=logits.device)]).all()))
            return logits
        rep.capture, eng._lose_shard = timed_capture, lose_and_poison
        eng._decode_degraded = checked_degraded
        index = {eng.submit(p, max_new_tokens=GEN): i
                 for i, p in enumerate(prompts)}
        torch.cuda.synchronize()
        LAUNCHES.clear()
        steps, restarted, refill_s = [], None, []
        t_start = time.perf_counter()
        while eng._sched.has_work:
            n_caps, fill_s[0] = len(caps), 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kind = eng.step()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            # a tick's own time: without the replica's captures after it
            # and this script's NaN fill at the loss
            steps.append((kind, t1 - t0 - fill_s[0]
                          - sum(c[0] for c in caps[n_caps:])))
            if kind == "recovered":
                restarted, t_rec = set(eng._sched.active), t0
            if restarted is not None and not any(
                    st.prefilling for s, st in eng._sched.active.items()
                    if s in restarted):
                refill_s.append(t1 - t_rec)
                restarted = None
        wall = time.perf_counter() - t_start
        counts = dict(LAUNCHES)
        s = eng.stats
        kinds = [k for k, _ in steps]
        # each window: its run of degraded ticks (it closes early once
        # nothing can decode)
        windows = []
        for i, k in enumerate(kinds):
            if k == "degraded":
                if not windows or windows[-1][-1] != i - 1:
                    windows.append([])
                windows[-1].append(i)
        n_loss = len(SHARD_LOSS_AT)
        if (s.shard_lost != n_loss or kinds.count("recovered") != n_loss
                or len(windows) != n_loss
                or not all(1 <= len(w) <= DEGRADED_GRACE for w in windows)
                or kinds.count("degraded") != s.degraded_ticks
                or not finite or not all(finite)):
            raise AssertionError(f"{path}: shard_lost {s.shard_lost}, "
                                 f"windows {windows}, finite {finite}")
        stray = sorted(x for x in sync_sites
                       if not x.startswith("src/repro_torch/serving/"
                                           "engine.py"))
        if stray:
            raise AssertionError(f"{path}: the degraded step synchronised "
                                 f"the host at {stray}")
        need = engine_launches(eng, True, cfg.n_layers)
        for name in ("flash_decode_stats", "flash_decode_stats.paged"):
            need[name] += cfg.n_layers * s.degraded_ticks
        check_launches(path, counts, need)
        out = {index[r]: v for r, v in eng.results().items()}
        log = {index[r]: v[-GEN:] for r, v in log.items()
               if r in eng.results()}
        cmp = compare_engine(torch, out, log, *phase6[mode], what=path)
        check_drained(eng, path)
        launches[path] = counts
        tick_ms = [1e3 * dt for _, dt in steps]
        decode_at = [i for i, k in enumerate(kinds) if k == "decode"]
        per_window = []
        for w in windows:
            near = sorted(decode_at, key=lambda i: abs(i - w[0]))[:8]
            per_window.append({
                "at_tick": w[0], "degraded_tick_ms": [tick_ms[i] for i in w],
                "degraded_ms_p50": float(np.median([tick_ms[i] for i in w])),
                "nearest_decode_ms_p50": float(np.median(
                    [tick_ms[i] for i in near])),
                "recover_step_ms": tick_ms[w[-1] + 1]})
        cap_t, cap_b = (np.array([c[i] for c in caps]) for i in (0, 1))
        emit("path", path="degraded", mode=mode, card=card, **ENGINE,
             requests=ENGINE_REQUESTS, gen=GEN, lost_shard=SHARD_LOST,
             lost_at_ticks=list(SHARD_LOSS_AT), at_loss=lost_at,
             record=engine_record(eng, out, wall),
             counters={k: getattr(s, k) for k in (
                 "shard_lost", "degraded_ticks", "restarts",
                 "failed_requests")},
             captures={"n": len(caps), "refreshes": rep.refreshes,
                       "ms_p50": 1e3 * float(np.median(cap_t)),
                       "ms_max": 1e3 * float(cap_t.max()),
                       "bytes_p50": int(np.median(cap_b)),
                       "clock": "host, card synchronised"},
             tick_ms_note="host clock, card synchronised; without the "
                          "captures after a tick and the NaN fill",
             windows=per_window,
             healthy_decode_tick_ms_p50=float(np.median(
                 [tick_ms[i] for i in decode_at])),
             packed_tick_ms_p50=float(np.median(
                 [t for t, k in zip(tick_ms, kinds) if k == "packed"])),
             refill_s=refill_s, degraded_sync_sites=sorted(sync_sites),
             degraded_logits_finite=all(finite), launches=counts,
             reference="phase 6's paged run of the same mode",
             tol=PATH_REL_TOL, token_gap=TOKEN_GAP, **cmp)
        del eng, log
    return launches


def drive_padded(torch, cfg, params, prompts, card):
    """(c): the padded admission flush in both pairings on the dense
    cache (Voltage prefill + exact decode, PRISM prefill + prism decode),
    each held to the same run with ``backend='plain'``; every flush
    launches ``prism_flash_attention`` once a layer and, in prism mode,
    ``segment_means`` (the fused augment) once a layer."""
    import time
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.serving import ServingEngine
    launches = {}
    for mode in ("exact", "prism"):
        path = f"padded/{mode}"
        runs, flush_ms = {}, []
        for backend in ("auto", "plain"):
            eng = ServingEngine(cfg, params, engine_config(
                mode, prefill_mode="padded", backend=backend), n_seq=SHARDS)
            log = keep_logits(eng)
            if backend == "auto":
                flush = eng._padded_flush

                def timed_flush(flush=flush):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    kind = flush()
                    torch.cuda.synchronize()
                    flush_ms.append(1e3 * (time.perf_counter() - t0))
                    return kind
                eng._padded_flush = timed_flush
            for p in prompts:
                eng.submit(p, max_new_tokens=GEN)
            torch.cuda.synchronize()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            out = eng.run()
            torch.cuda.synchronize()
            runs[backend] = (eng, out, log, dict(LAUNCHES),
                             time.perf_counter() - t0)
        eng, out, log, counts, wall = runs["auto"]
        s, n = eng.stats, cfg.n_layers
        check_launches(path, counts, {
            "prism_flash_attention": n * s.prefills,
            "segment_means": n * s.prefills if mode == "prism" else 0,
            "flash_decode_stats": n * s.decode_steps,
            "flash_decode_stats.paged": 0, "flash_decode_stats.mq": 0})
        if eng.kv_cache.paged or len(out) != ENGINE_REQUESTS:
            raise AssertionError(f"{path}: {len(out)} requests on a "
                                 f"{'paged' if eng.kv_cache.paged else 'dense'}"
                                 " cache")
        _, p_out, p_log, p_counts, p_wall = runs["plain"]
        if any(p_counts.get(k, 0) for k in TOL):
            raise AssertionError(f"{path}: the plain run launched kernels")
        cmp = compare_engine(torch, out, log, p_out, p_log, what=path)
        launches[path] = counts
        emit("path", path="padded", mode=mode, card=card, **ENGINE,
             requests=ENGINE_REQUESTS, gen=GEN, flushes=s.prefills,
             flush_ms=flush_ms,
             record=engine_record(eng, out, wall),
             plain=engine_record(runs["plain"][0], p_out, p_wall),
             launches=counts, reference="the same run with backend='plain'",
             tol=PATH_REL_TOL, token_gap=TOKEN_GAP, **cmp)
        del runs, log, p_log
    return launches


def drive_gang(torch, cfg, params, prompts, phase6, card):
    """(d): gang admission (static batching) in packed exact, 8 requests
    into the empty pool, the next 8 once all of them finished, after the
    continuous engine (continuous, then gang: two turns, the script's time
    limit; host time moves between runs); every run's tokens and logits
    held to
    phase 6's continuous paged run; wall time and tokens/s of each."""
    import time
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.serving import ServingEngine
    launches = {}
    for turn, gang in enumerate((False, True)):
        path = f"{'gang' if gang else 'continuous'}/exact/{1 + turn // 2}"
        eng = ServingEngine(cfg, params, engine_config("exact", gang=gang),
                            n_seq=SHARDS)
        log = keep_logits(eng)
        for p in prompts:
            eng.submit(p, max_new_tokens=GEN)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        check_launches(path, counts, engine_launches(eng, True,
                                                     cfg.n_layers))
        cmp = compare_engine(torch, out, log, *phase6["exact"], what=path)
        check_drained(eng, path)
        launches[path] = counts
        emit("path", path="gang", mode="exact", gang=gang, turn=turn,
             card=card, **ENGINE, requests=ENGINE_REQUESTS, gen=GEN,
             record=engine_record(eng, out, wall), launches=counts,
             reference="phase 6's paged run (continuous admission)",
             tol=PATH_REL_TOL, token_gap=TOKEN_GAP, **cmp)
        del eng, log
    return launches


def drive_phase8(torch, params, phase6):
    """Phase 8: (a) streaming, (b) the degraded mesh, (c) padded
    admission, (d) gang admission, at phase 6's widths and trace.
    Returns the launches of each run."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    prompts = engine_trace(cfg.vocab_size)
    card = nvidia_smi()
    launches, syncs = drive_streaming(torch, cfg, params, prompts, phase6,
                                      card)
    launches.update(drive_shard_loss(torch, cfg, params, prompts, phase6,
                                     card))
    launches.update(drive_padded(torch, cfg, params, prompts, card))
    launches.update(drive_gang(torch, cfg, params, prompts, phase6, card))
    if syncs:
        raise AssertionError(f"the streamed windows synchronised the host "
                             f"at: {syncs}")
    return launches


# ---------------------------------------------------------------------------
# phases 9-12 and 14-17: the families after GPT-2
# ---------------------------------------------------------------------------

TIME_KEYS = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")


# the engine runs of phase 9: packed exact and packed prism
LLAMA_ENGINE_RUNS = (("packed", "exact"), ("packed", "prism"))
# phases 9, 11, 12 and 15's tick and engine paths serve the first
# TICK_DEPTH layers of Yi-6B (of 32), OLMoE-1B-7B (of 16), Gemma 7B (of
# 28) and Command-R (of 40); widths full.  At 8 the whole script with phase 19
# took 1,289 s of its 1,200 s limit on a slow host (PERF.md §4); at 4,
# with phase 20's run (k), 1,095.8 s on an H100 (phases 9, 11, 12, 15
# 54.0, 84.8, 60.7, 68.4 s; PERF.md §4), 15.8 s over its 1,080 s target;
# at 2 they took 42.2, 44.9, 44.3, 46.2 s, 91 s less.  3 takes about
# half that, the overrun's size with room for the host's spread
TICK_DEPTH = 3
# the static paths served on their first layers only, all widths full:
# Command-R's 40 layers of f32 weights are 121 GB; Yi-6B, Gemma 7B and
# Zamba2 (whole 6-layer units) are cut so that phase 18 fits the
# script's time (1,214.9 s on an H100 at 16, 14 and 54 layers), Command-R
# and OLMoE so that phases 16 and 17 do (8), then 8 -> 4 so that phase
# 20's runs (d)-(i) do, MusicGen 16 -> 8 after them (``MESH_STEPS``),
# then Gemma 3 26 -> 12 and PaliGemma 18 -> 9 (the script took 1,172.6
# s of its 1,200 on the slowest host seen), xLSTM under its phase's 45 s
# rule (PERF.md §4); every other static path runs at full depth
STATIC_DEPTH = {LLAMA: 8, GEMMA7: 8, CMDR: 4, MOE: 4, MUSICGEN: 8,
                XLSTM: 12, ZAMBA: 12, GEMMA: 12, PALI: 9}


def cut_depth(cfg, params):
    """``cfg`` and ``params`` cut to their first ``TICK_DEPTH`` layers."""
    n = TICK_DEPTH
    return (replace(cfg, n_layers=n, blocks=cfg.block_kinds[:n]),
            {**params, "layers": params["layers"][:n]})


def gemma_row(name, t_256, chk):
    """A kernel's numbers at Gemma 3 1B's layouts (phase 3's head-dim-256
    part, D 1152 for segment means): per layout the kernel's times, its
    plain version's, the bound and the library call's (None where no
    PyTorch call takes the layout, with the op's refusal); the largest
    error there and its share of the tolerance."""
    pick = lambda t: {k: t[k] for k in TIME_KEYS + (  # noqa: E731
        "library_note",) if k in t}
    if name == "prism_flash_attention":
        out = {tag: pick(t) for tag, t in t_256["attention"].items()}
        key = name + "/hd256"
    elif name == "segment_means":
        t = t_256["segment_means"]
        out = {"means": pick(t),
               "augment": {k: t["augment_" + k] for k in TIME_KEYS
                           if "augment_" + k in t},
               "bf16_ms": t["bf16_ms"], "bf16_device_ms": t["bf16_device_ms"],
               "shape": t["shape"]}
        key = name + "/d1152"
    else:
        d = t_256["decode"]
        out = {tag: pick(d[tag]) for tag in ("exact", "prism", "ring")}
        for tag in ("exact", "prism", "ring"):     # both routes
            out[tag].update({k: d[tag][k] for k in (
                "tile_ms", "tile_device_ms", "row_ms", "row_device_ms",
                "library_check")})
        out["cases_by_route"] = d["cases_by_route"]
        key = name + "/hd256"
    out["max_abs_err"] = chk.max_err.get(key, 0.0)
    out["tol_share"] = chk.tol_share.get(key, 0.0)
    return out


def state_bytes(cfg) -> int:
    """The f32 decode states of a model's recurrent layers at the path's
    batch (xLSTM: 134 MB an mLSTM layer; Zamba2: 10.5 MB a Mamba2 layer
    and its conv tail)."""
    from repro_torch.runtime import serve as S
    hp = S.ServeHParams()
    lay = S.make_layout(SHARDS, PROMPT + GEN, hp, prefill_len=PROMPT)
    return sum(4 * math.prod(shape)
               for k in cfg.block_kinds if k in CELLS
               for shape in S.layer_cache_shape(cfg, lay, BATCH, hp,
                                                kind=k).values())


def drive_static(torch, arch, prompt=PROMPT, pairings=GEMMA_PAIRINGS):
    """A family the reference serves on the static path alone, at full
    width through ``pairings`` (by default three) at B 8, ``prompt``, 64
    generated, P 4, CR 4, f32 weights from torch.Generator seed 0 on the
    card, at full depth or on its first ``STATIC_DEPTH`` layers (only
    those built): phase 10, Gemma 3 1B (26 layers, 22 sliding-window
    local and 4 global, d 1152, 4 query heads over 1 KV head of 256,
    qk-norm, GeGLU d_ff 6912, sqrt(d) input scaling, two RoPE thetas,
    tied head over 262144; prompt 2048), whose ring caches the tick
    programs and the engine refuse; phase 14, PaliGemma 3B (18 layers, d
    2048, 8 query heads over 1 KV head of 256, GeGLU d_ff 16384, tied
    head over 257216, a stub image of 256 embeddings over the first
    prompt positions, attended bidirectionally), whose image they cannot
    take; phase 16, MusicGen-medium (48 layers, d 1536, 24 heads of 64,
    GELU d_ff 6144, LayerNorm, sinusoidal positions, untied head over
    2048 codes, a prompt of seeded frame embeddings through
    ``frontend_proj``), whose frames they cannot take; phase 17, xLSTM
    1.3B (42 mLSTM and 6 sLSTM blocks, d 2048, 4 heads, the mLSTM's of
    1,024, untied head over 50304; voltage + exact alone), whose
    recurrent states they do not address; phase 18, Zamba2 2.7B (of 54
    layers, 45 Mamba2 blocks, d 2560, and 9 layers of one shared
    attention + MLP block, 32 heads of 80, untied head over 32000), the
    same.  Returns
    the launches of each path, keyed ``<arch>/static/...``."""
    import time
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = full
    if arch in STATIC_DEPTH:
        n = STATIC_DEPTH[arch]
        cfg = replace(cfg, n_layers=n, blocks=cfg.block_kinds[:n])
    params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                    "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    kinds = cfg.block_kinds
    recurrent = {}
    if set(kinds) & set(CELLS):
        recurrent = dict(
            mlstm_layers=kinds.count("mlstm"),
            slstm_layers=kinds.count("slstm"),
            mamba_layers=kinds.count("mamba"),
            shared_attn_layers=kinds.count("shared_attn"),
            ssm_heads=cfg.n_ssm_heads, ssm_expand=cfg.ssm_expand,
            ssm_state=cfg.ssm_state, ssm_chunk=128,
            reference_chunk=XLSTM_REF_CHUNK, state_bytes=state_bytes(cfg))
        if "shared" in params:
            recurrent["shared_params"] = sum(
                t.numel() for t in _leaves(params["shared"]))
    emit("model", arch=arch, params=n_params, weight_bytes=4 * n_params,
         layers=cfg.n_layers, layers_of=full.n_layers,
         local_layers=kinds.count("attn_local"), window=cfg.window,
         prefix_len=cfg.prefix_len, frontend=cfg.frontend, pos=cfg.pos,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.hd, d_ff=cfg.d_ff, vocab=cfg.vocab_size, prompt=prompt,
         decode_route_static=("tile" if static_tile(cfg) else "row"),
         **recurrent)
    by_path = {f"{arch}/static/{key}": r["launches"]
               for key, r in drive_path(torch, params, arch, prompt,
                                        pairings, cfg=cfg).items()}
    emit("phase", name=arch, seconds=time.perf_counter() - t0)
    return by_path


# ---------------------------------------------------------------------------
# phases 9, 11, 12 and 15: the families served on every path
# ---------------------------------------------------------------------------

def family_row(name, t, chk, tag):
    """A kernel's numbers at a later family's layouts (``check_family``):
    per layout the kernel's times, its plain version's, the bound and
    the library call's; the largest error there and its share of the
    tolerance."""
    pick = lambda t: {k: t[k] for k in TIME_KEYS + (  # noqa: E731
        "library_note", "library_check") if k in t}
    if name == "prism_flash_attention":
        out = {mode: pick(tm) for mode, tm in t["attention"].items()}
    elif name == "segment_means":
        tm = t["segment_means"]
        out = {"means": pick(tm),
               "augment": {k: tm["augment_" + k] for k in TIME_KEYS
                           if "augment_" + k in tm},
               "bf16_ms": tm["bf16_ms"],
               "bf16_device_ms": tm["bf16_device_ms"], "shape": tm["shape"]}
    else:
        d = t["decode"]
        # a vlm's family has its static layouts alone (no tick path)
        out = {tag_: pick(d[tag_]) for tag_ in ("exact", "prism", "chunk",
                                                "packed", "packed_prism")
               if tag_ in d}
        for mode in ("exact", "prism"):            # both routes
            out[mode].update({k: d[mode][k] for k in (
                "tile_ms", "tile_device_ms", "row_ms", "row_device_ms")})
        if "paged" in d:
            out["paged"] = {k: pick(v) for k, v in d["paged"].items()}
            out["poisoned"] = d["poisoned"]
        out["cases_by_route"] = d["cases_by_route"]
    out["max_abs_err"] = chk.max_err.get(f"{name}/{tag}", 0.0)
    out["tol_share"] = chk.tol_share.get(f"{name}/{tag}", 0.0)
    return out


def drive_family(torch, arch, engine_runs=ENGINE_RUNS):
    """Phase 9 (Yi-6B: 32 layers, d 4096, 32 query heads over 4 KV heads
    of 128, SwiGLU, RMSNorm, RoPE, untied head), 11 (OLMoE-1B-7B: 16
    layers of MoE blocks, d 2048, 16 heads of 128, 64 experts top-8 of
    d_ff 1024 at capacity factor 1.25, qk-norm, SwiGLU, untied head over
    50304), 12 (Gemma 7B: 28 layers, d 3072, 16 heads of 256, GeGLU d_ff
    24576, sqrt(d) input scaling, tied head over 256000) or 15
    (Command-R 35B: 40 layers, d 8192, 64 query heads over 8 KV heads of
    128, the parallel block, LayerNorm, SwiGLU d_ff 22528, RoPE theta
    8e6, tied head over 256000): f32 weights from torch.Generator seed 0
    on the card, through phase 4's static pairings at full depth or on
    the first ``STATIC_DEPTH`` layers (only those built), then phase 5's
    tick paths and phase 6's ``engine_runs`` on the first ``TICK_DEPTH``
    layers, at their shapes (B 8, prompt 512, 64 generated, P 4, CR 4).
    OLMoE's runs are each held to their backend='plain' twin under the
    routing rule (``replay_check``), the others to phase 4-6's
    references.  Returns the launches of each path, keyed
    ``<arch>/...``."""
    import time
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    cfg = get_config(arch)
    if arch in STATIC_DEPTH:
        n = STATIC_DEPTH[arch]
        cfg = replace(cfg, n_layers=n, blocks=cfg.block_kinds[:n])
    params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                    "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    moe = {}
    if "moe" in cfg.block_kinds:
        experts = [p["moe"]["experts"] for p in params["layers"]]
        expert_bytes = 4 * sum(t.numel() for t in _leaves(experts))
        moe = dict(experts=cfg.n_experts, top_k=cfg.top_k,
                   expert_d_ff=cfg.expert_d_ff,
                   capacity_factor=cfg.capacity_factor,
                   expert_bytes_per_step=expert_bytes)
    emit("model", arch=arch, params=n_params, weight_bytes=4 * n_params,
         layers=cfg.n_layers, layers_of=get_config(arch).n_layers,
         tick_layers=TICK_DEPTH, d_model=cfg.d_model, heads=cfg.n_heads,
         kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, parallel_block=cfg.parallel_block, **moe,
         decode_route_static=("tile" if static_tile(cfg) else "row"))
    by_path = {f"{arch}/static/{mode}": r["launches"]
               for mode, r in drive_path(torch, params, arch,
                                         cfg=cfg).items()}
    cut, params = cut_depth(cfg, params)
    by_path.update({f"{arch}/{k}": v for k, v in
                    drive_ticks(torch, params, arch, cut).items()})
    launches, _ = drive_engine(torch, params, arch, engine_runs, cut)
    by_path.update({f"{arch}/{k}": v for k, v in launches.items()})
    emit("phase", name=arch, seconds=time.perf_counter() - t0)
    return by_path


# ---------------------------------------------------------------------------
# phase 13: the paper's encoders, BERT-base and ViT-B/16
# ---------------------------------------------------------------------------

# the timed encode calls after the counted one (CUDA events each)
ENCODE_REPEATS = 5


def classes_agree(torch, logits, ref):
    """The argmax classes of logits (B, C) against the reference's,
    wherever its top-2 gap is clear; returns (checked, total)."""
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TOKEN_GAP * float(ref.abs().max())
    if (logits.argmax(-1)[clear] != ref.argmax(-1)[clear]).any():
        raise AssertionError("classes differ where the reference's top-2 "
                             "gap is clear")
    return int(clear.sum()), clear.numel()


def drive_encoders(torch):
    """Phase 13: BERT-base (B 32 x 512 token ids) and ViT-B/16 (B 64 x
    197 stub patch embeddings, split 49/49/49/50) at full width and
    depth, f32 weights from torch.Generator seed 0 on the card, through
    ``repro_torch.launch.serve.setup_encoder`` (``runtime.serve.encode``)
    over P = 4 shards, in each of ``ENCODERS``' runs: Voltage held to the
    plain full forward, PRISM to the same run with backend='plain'; the
    launch counters zeroed just before the counted run and read just
    after (attention once a layer, segment means once a PRISM layer,
    the decode kernel never); then the time of ``ENCODE_REPEATS`` more
    calls and a trace of one.  Returns the launches of each run, keyed
    ``<arch>/encode/<run>``."""
    import time
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.serve import setup_encoder
    from repro_torch.models import transformer as T
    by_path = {}
    for arch, (key, batch, n, runs) in ENCODERS.items():
        t0 = time.perf_counter()
        cfg = get_config(arch)
        params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
        n_params = sum(t.numel() for t in _leaves(params))
        s, r = divmod(n, SHARDS)
        emit("model", arch=arch, params=n_params, weight_bytes=4 * n_params,
             layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
             head_dim=cfg.hd, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
             classes=cfg.num_classes, frontend=cfg.frontend, batch=batch,
             tokens=n, split=[s] * (SHARDS - 1) + [s + r])
        for mode, cr in runs:
            name = encoder_run_key(mode, cr)
            run = setup_encoder(arch, batch=batch, n=n, seq_shards=SHARDS,
                                prefill=mode, cr=cr, device="cuda",
                                params=params)
            if [run.cfg.n_layers, run.cfg.d_model, run.cfg.n_heads] != [
                    cfg.n_layers, cfg.d_model, cfg.n_heads]:  # full size
                raise AssertionError(f"{arch}: not at full size")
            run.run()                                        # warm-up
            torch.cuda.synchronize()
            LAUNCHES.clear()
            classes, logits, times = run.run()
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            path = f"{arch}/encode/{name}"
            check_launches(path, counts, {
                "prism_flash_attention": cfg.n_layers,
                "prism_flash_attention.window": 0,
                "segment_means": cfg.n_layers if mode == "prism" else 0,
                "flash_decode_stats": 0})
            if tuple(logits.shape) != (batch, cfg.num_classes) or not bool(
                    torch.isfinite(logits).all()):
                raise AssertionError(f"{path}: logits {tuple(logits.shape)}"
                                     " not finite or of the wrong shape")
            x = {"tokens": run.tokens} if run.tokens is not None else {
                "embeds": run.embeds}
            if mode == "voltage":
                with torch.no_grad():
                    ref = T.forward(cfg, params, **x)
                ref_name = "plain full forward"
            else:
                plain = setup_encoder(arch, batch=batch, n=n,
                                      seq_shards=SHARDS, prefill=mode, cr=cr,
                                      device="cuda", params=params,
                                      backend="plain")
                ref = plain.run()[1]
                ref_name = "backend='plain' run"
            err = rel_err(logits, ref)
            if err > PATH_REL_TOL:
                raise AssertionError(f"{path}: logits rel err {err:.3e} vs "
                                     f"the {ref_name} > {PATH_REL_TOL}")
            checked, total = classes_agree(torch, logits, ref)
            repeats = [run.run()[2]["encode_ms"]
                       for _ in range(ENCODE_REPEATS)]
            L = run.prism.landmarks(n) if mode == "prism" else None
            emit("path", arch=arch, mode="encode", exchange=mode, cr=cr,
                 L=L, batch=batch, tokens=n, shards=SHARDS,
                 encode_ms=times["encode_ms"], encode_ms_repeats=repeats,
                 encode_ms_median=statistics.median(repeats),
                 sequences_per_s=batch / (statistics.median(repeats) / 1e3),
                 clock=times["clock"], launches=counts,
                 logits_rel_err=err, reference=ref_name, tol=PATH_REL_TOL,
                 classes_checked=checked, classes_total=total,
                 classes_head=classes[:8].tolist())
            emit("trace", arch=arch, mode="encode", exchange=mode, cr=cr,
                 encode=device_breakdown(trace_window(torch, run.run), 1))
            by_path[path] = counts
            del logits, ref
        del params
        torch.cuda.empty_cache()
        emit("phase", name=arch, seconds=time.perf_counter() - t0)
    return by_path


# ---------------------------------------------------------------------------
# phase 19: training and the accuracy path
# ---------------------------------------------------------------------------

# (a) GPT-2 small at full width and depth: the launcher's steps at the
# main path's B 8 x 512 over P 4, CR 4, prism, lr 3e-4 (warm-up 3)
TRAIN_STEPS, TRAIN_LR = 30, 3e-4
# steps 5.. of the run are timed (the first ones allocate and warm up)
TRAIN_TIMED_FROM = 5
# step 0 against the same step in float64 (the plain path, parameters and
# inputs cast on the card): the reference runner's limits
# (tests/shard_equiv_runner.py): the loss absolutely, each gradient leaf
# over max(1e-6, its largest |grad|)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 2e-4, 5e-3
# the rule benchmarks/accuracy_vs_cr.py holds its own training to
TRAIN_FALL = 0.7
# (b) the accuracy protocol of benchmarks/accuracy_vs_cr.py: its char-LM
# (4 layers, d 128, 4 heads of 32), SEQ 120 (a multiple of P 2, 3, 4),
# BATCH 16, 400 steps at lr 3e-3, 8 held-out batches; CR 1 within 5e-3 of
# the single-device bpc; the CR trend monotonic within 2e-2; 150 steps of
# fine-tuning at P 3, CR 8, lr 1e-3
CHAR_SEQ, CHAR_BATCH = 120, 16
CHAR_STEPS, CHAR_LR, CHAR_FT_STEPS, CHAR_FT_LR = 400, 3e-3, 150, 1e-3
CR1_TOL, TREND_SLACK = 5e-3, 2e-2
# where set, the directory phase 19 saves the trained char-LM to (the
# reference's checkpoint layout, before fine-tuning), for the reference's
# own protocol to score on the CPU: ``python tests/test_torch_train.py
# --table2 DIR``
CHARLM_KEEP_ENV = "CHIP_SMOKE_CHARLM_DIR"
# a bpc scored through the kernels (``score``) against the same under
# SimulatedContext: the logits within PATH_REL_TOL of the largest
# |logit|, the bpc within this many bits
BPC_TOL = 1e-4


def char_lm_config():
    """The accuracy protocol's char-LM (benchmarks/accuracy_vs_cr.py)."""
    from repro_torch.data.pipeline import CharTokenizer
    from repro_torch.models.config import ModelConfig
    return ModelConfig(
        name="char-lm", arch_type="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
        vocab_size=CharTokenizer().vocab, mlp_kind="gelu",
        norm_kind="rmsnorm", pos="rope", tie_embeddings=True)


class CharLM:
    """The harness of benchmarks/accuracy_vs_cr.py on the port: its
    corpora, seeds and char-LM, trained under FullContext (or a
    SimulatedContext to fine-tune) with AdamW (weight decay 0.01, clip
    1.0, a constant lr); bits per character on its 8 held-out batches,
    teacher-forced, under the port's SimulatedContext (``bpc``, the
    reference's protocol) or through ``score`` over sequence shards
    (``bpc_scored``).  ``seq``, ``batch`` and the corpora's lengths shrink
    for the CPU tests."""

    def __init__(self, torch, device, *, seq=CHAR_SEQ, batch=CHAR_BATCH,
                 train_chars=200_000, held_chars=20_000, n_eval=8):
        from repro_torch.data.pipeline import (CharTokenizer, lm_batches,
                                               synthetic_text)
        from repro_torch.models import transformer as T
        from repro_torch.optim import adamw_init
        self.torch, self.device = torch, device
        tok = CharTokenizer()
        self.train_it = lm_batches(tok.encode(synthetic_text(train_chars, 1)),
                                   batch=batch, seq=seq, seed=0)
        held = lm_batches(tok.encode(synthetic_text(held_chars, 2)),
                          batch=batch, seq=seq, seed=9)
        self.eval_batches = [tuple(torch.as_tensor(a, device=device).long()
                                   for a in next(held))
                             for _ in range(n_eval)]
        self.cfg = char_lm_config()
        self.params = T.init(self.cfg, torch.Generator(
            device=device).manual_seed(0), device)
        self.opt = adamw_init(self.params)

    def logits(self, params, x, prism=None):
        from repro_torch.models import transformer as T
        from repro_torch.models.context import SimulatedContext
        ctx = SimulatedContext(prism) if prism is not None else None
        return T.forward(self.cfg, params, x, ctx=ctx, chunk=8)

    def train(self, steps, prism=None, lr=CHAR_LR):
        """-> (first loss, last loss, the losses)."""
        from repro_torch.optim import adamw_update, clip_by_global_norm
        from repro_torch.optim.adamw import tree_leaves, tree_unflatten
        from repro_torch.runtime.losses import softmax_xent
        torch = self.torch
        losses = []
        for _ in range(steps):
            x, y = (torch.as_tensor(a, device=self.device).long()
                    for a in next(self.train_it))
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(self.params)]
            p = tree_unflatten(self.params, leaves)
            loss = softmax_xent(self.logits(p, x, prism), y)
            grads = tree_unflatten(self.params,
                                   torch.autograd.grad(loss, leaves))
            grads, _ = clip_by_global_norm(grads, 1.0)
            self.params, self.opt = adamw_update(
                self.params, grads, self.opt, lr=lr, weight_decay=0.01)
            losses.append(loss.detach())
        losses = [float(v) for v in losses]
        return losses[0], losses[-1], losses

    def bpc(self, prism=None):
        """-> (bpc, the logits of every held-out batch) under the port's
        SimulatedContext (FullContext without ``prism``)."""
        from repro_torch.runtime.losses import softmax_xent
        with self.torch.no_grad():
            logits = [self.logits(self.params, x, prism)
                      for x, _ in self.eval_batches]
        nll = sum(float(softmax_xent(lg, y))
                  for lg, (_, y) in zip(logits, self.eval_batches))
        return nll / len(logits) / math.log(2), logits

    def bpc_scored(self, prism=None, backend="auto"):
        """-> (bpc, logits) through ``score`` over ``prism.P`` shards (one
        shard, 'single', without ``prism``)."""
        from repro_torch.core.protocol import PrismConfig
        from repro_torch.runtime.losses import softmax_xent
        from repro_torch.runtime.serve import ServeHParams, score
        prism = prism or PrismConfig(P=1, mode="single")
        hp = ServeHParams(backend=backend)
        logits = [score(self.cfg, self.params, x, prism=prism,
                        n_shards=prism.P, hp=hp)
                  for x, _ in self.eval_batches]
        nll = sum(float(softmax_xent(lg, y))
                  for lg, (_, y) in zip(logits, self.eval_batches))
        return nll / len(logits) / math.log(2), logits


def tree_err(got, want):
    """The largest gradient error over the leaves of two trees, each leaf's
    over max(1e-6, its largest |want|) (the reference runner's rule),
    and the leaf it is at."""
    from repro_torch.checkpoint.io import flatten
    worst, at = 0.0, None
    g, w = flatten(got), flatten(want)
    for key in w:
        a, b = g[key].astype("float64"), w[key].astype("float64")
        err = float(abs(a - b).max() / max(1e-6, float(abs(b).max())))
        if err > worst:
            worst, at = err, key
    return worst, at


def train_gpt2(torch, card):
    """(a): GPT-2 small at full width and depth through the launcher's
    code (``setup``, ``corpus_batches``, its step): step 0 held to
    float64, 30 steps timed and traced, the loss falling, no kernel
    launched, a kernel run under autograd refused; a checkpoint round
    trip; ``score`` through the kernels held to its plain version.
    Returns the launches of each run."""
    import tempfile
    import time
    from repro_torch.checkpoint.io import (latest_step, restore_checkpoint,
                                           save_checkpoint)
    from repro_torch.convert import from_jax_numpy, to_jax_numpy
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch import train as TL
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.runtime.losses import softmax_xent
    from repro_torch.runtime.serve import ServeHParams, score
    from repro_torch.runtime.train import loss_and_grads, to_batch
    from repro_torch.sharding.context import ShardedPrismContext
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    run = TL.setup(ARCH, seq_shards=SHARDS, mode="prism", cr=CR,
                   lr=TRAIN_LR, steps=TRAIN_STEPS, device=dev, seed=0)
    cfg = run.cfg
    # the launcher's first batch, drawn again below by its own iterator
    x0, y0 = next(TL.corpus_batches(BATCH, PROMPT))
    batch0 = to_batch({"tokens": x0, "labels": y0}, dev)
    ctx = ShardedPrismContext(run.prism, n_shards=SHARDS, backend="plain")
    nll, _, grads = loss_and_grads(cfg, run.params, batch0, ctx, run.hp)
    p64 = tree_map(lambda t: t.double(), run.params)
    nll64, _, grads64 = loss_and_grads(cfg, p64, batch0, ctx, run.hp)
    loss_err = abs(float(nll) - float(nll64))
    grad_err, grad_at = tree_err(grads, grads64)
    if loss_err > TRAIN_LOSS_TOL or grad_err > TRAIN_GRAD_TOL:
        raise AssertionError(
            f"train/gpt2: step 0 against float64: loss {loss_err:.3e} "
            f"(limit {TRAIN_LOSS_TOL}), gradient {grad_err:.3e} at "
            f"{grad_at} (limit {TRAIN_GRAD_TOL})")
    del p64, grads64, grads
    torch.cuda.empty_cache()

    # a kernel under autograd: the context's backend='auto' must raise
    auto = ShardedPrismContext(run.prism, n_shards=SHARDS, backend="auto")
    LAUNCHES.clear()
    try:
        loss_and_grads(cfg, run.params, batch0, auto, run.hp)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        refused = str(e).splitlines()[0]
    else:
        raise AssertionError("train/gpt2: a train step with "
                             "backend='auto' ran on the card")
    if sum(LAUNCHES.values()):
        raise AssertionError(f"train/gpt2: the refused step launched "
                             f"{dict(LAUNCHES)}")

    # the launcher's steps, the first on the batch held to float64
    events, inner = [], run.step

    def timed(params, opt, batch):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = inner(params, opt, batch)
        e.record()
        events.append((s, e))
        return out
    run.step = timed
    lines = []
    batches = TL.corpus_batches(BATCH, PROMPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    w0 = time.perf_counter()
    hist = TL.train(run, batches, TRAIN_STEPS, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    step_counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    run.step = inner
    for ln in lines:
        print(ln, flush=True)
    if any(step_counts.get(name, 0) for name in TOL):
        raise AssertionError(f"train/gpt2: the train steps launched "
                             f"{step_counts}")
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(v) for v in losses) or not (
            losses[-1] < TRAIN_FALL * losses[0]):
        raise AssertionError(f"train/gpt2: the loss went {losses[0]:.4f} "
                             f"-> {losses[-1]:.4f} (must fall below "
                             f"{TRAIN_FALL} x the first)")
    step_ms = [s.elapsed_time(e) for s, e in events]
    ms = statistics.median(step_ms[TRAIN_TIMED_FROM:])
    x, y = next(batches)
    trace = device_breakdown(trace_window(torch, lambda: run.step(
        run.params, run.opt, {"tokens": x, "labels": y})), 1)
    emit("path", path="train", arch=ARCH, card=card, batch=BATCH,
         seq=PROMPT, shards=SHARDS, cr=CR, mode="prism", steps=TRAIN_STEPS,
         lr=TRAIN_LR, warmup=run.hp.warmup, remat=run.hp.remat,
         ms_per_step=ms, step_ms=step_ms,
         tokens_per_s=BATCH * PROMPT / (ms / 1e3), wall_s=wall,
         peak_memory_bytes=peak, loss_first=losses[0], loss_last=losses[-1],
         losses=losses, gnorm=[h["gnorm"] for h in hist],
         lr_by_step=[h["lr"] for h in hist],
         f64={"loss_err": loss_err, "loss_tol": TRAIN_LOSS_TOL,
              "grad_err": grad_err, "grad_at": grad_at,
              "grad_tol": TRAIN_GRAD_TOL},
         refused_under_autograd=refused, launches=step_counts)
    emit("trace", path="train", arch=ARCH, card=card, step=trace)

    # a checkpoint round trip in the reference's layout
    ref = ServeHParams(backend="plain")
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, TRAIN_STEPS, to_jax_numpy(cfg, run.params))
        tree = restore_checkpoint(d, latest_step(d),
                                  to_jax_numpy(cfg, run.params))
    back = from_jax_numpy(cfg, tree, device=dev)
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(run.params))):
        raise AssertionError("train/gpt2: the restored parameters differ")
    xs, ys = (torch.as_tensor(a, device=dev).long() for a in next(batches))
    with torch.no_grad():
        kw = dict(prism=run.prism, n_shards=SHARDS)
        LAUNCHES.clear()
        got = score(cfg, run.params, xs, hp=ServeHParams(), **kw)
        score_counts = dict(LAUNCHES)
        want = score(cfg, run.params, xs, hp=ref, **kw)
        restored = score(cfg, back, xs, hp=ref, **kw)
    check_launches("train/gpt2/score", score_counts,
                   {"prism_flash_attention": cfg.n_layers,
                    "segment_means": cfg.n_layers,
                    "flash_decode_stats": 0})
    err = rel_err(got, want)
    loss_k, loss_p = (float(softmax_xent(t, ys)) for t in (got, want))
    if err > PATH_REL_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"train/gpt2/score: logits {err:.3e} from "
                             f"backend='plain' (limit {PATH_REL_TOL})")
    if float(softmax_xent(restored, ys)) != loss_p:
        raise AssertionError("train/gpt2: the restored parameters score "
                             "another loss")
    emit("path", path="train/score", arch=ARCH, card=card, batch=BATCH,
         seq=PROMPT, rel_err=err, tol=PATH_REL_TOL, loss_kernels=loss_k,
         loss_plain=loss_p, checkpoint="bit-equal, loss equal",
         launches=score_counts, seconds=time.perf_counter() - t0)
    del run, back, got, want, restored
    torch.cuda.empty_cache()
    return {"train/gpt2/steps": step_counts,
            "train/gpt2/score": score_counts}


def char_setting(torch, h, card, name, prism, launches, need_means):
    """One bpc of the protocol, scored twice: under SimulatedContext and
    through the kernels (``score``); held to each other, one ``path``
    line; returns the SimulatedContext bpc."""
    from repro_torch.kernels.dispatch import LAUNCHES
    bpc, sim = h.bpc(prism)
    LAUNCHES.clear()
    with torch.no_grad():
        bpc_k, kern = h.bpc_scored(prism)
    counts = dict(LAUNCHES)
    n = len(h.eval_batches) * h.cfg.n_layers
    check_launches(f"train/charlm/{name}", counts, {
        "prism_flash_attention": n,
        "segment_means": n if need_means else 0, "flash_decode_stats": 0})
    err = max(rel_err(a, b) for a, b in zip(kern, sim))
    if err > PATH_REL_TOL or abs(bpc_k - bpc) > BPC_TOL:
        raise AssertionError(
            f"train/charlm/{name}: score through the kernels {err:.3e} "
            f"from SimulatedContext (limit {PATH_REL_TOL}), bpc {bpc_k:.6f} "
            f"against {bpc:.6f} (limit {BPC_TOL})")
    launches[f"train/charlm/{name}"] = counts
    emit("path", path="train/charlm", setting=name, card=card,
         mode=None if prism is None else prism.mode,
         P=1 if prism is None else prism.P,
         cr=None if prism is None else prism.cr,
         L=None if prism is None else prism.landmarks(CHAR_SEQ),
         bpc=bpc, bpc_scored=bpc_k, bpc_diff=bpc_k - bpc, rel_err=err,
         tol=PATH_REL_TOL, bpc_tol=BPC_TOL, launches=counts)
    return bpc


def train_char_lm(torch, card):
    """(b): benchmarks/accuracy_vs_cr.py's protocol on the card.  Returns
    the launches of each scored setting."""
    import time
    from repro_torch.core.protocol import PrismConfig
    t0 = time.perf_counter()
    h = CharLM(torch, torch.device("cuda"))
    first, last, _ = h.train(CHAR_STEPS)
    if not last < TRAIN_FALL * first:
        raise AssertionError(f"train/charlm: the char-LM failed to train "
                             f"({first:.4f} -> {last:.4f})")
    emit("path", path="train/charlm", setting="train", card=card,
         steps=CHAR_STEPS, lr=CHAR_LR, loss_first=first, loss_last=last,
         seconds=time.perf_counter() - t0)
    if os.environ.get(CHARLM_KEEP_ENV):
        from repro_torch.checkpoint.io import save_checkpoint
        from repro_torch.convert import to_jax_numpy
        save_checkpoint(os.environ[CHARLM_KEEP_ENV], CHAR_STEPS,
                        to_jax_numpy(h.cfg, h.params))
    launches = {}
    base = char_setting(torch, h, card, "single", None, launches, False)
    cr1 = {}
    for p in (2, 3, 4):
        cr1[p] = char_setting(torch, h, card, f"P{p}-CR1",
                              PrismConfig(P=p, L=CHAR_SEQ // p), launches,
                              True)
        if abs(cr1[p] - base) > CR1_TOL:
            raise AssertionError(f"train/charlm: P {p} at CR 1 gives bpc "
                                 f"{cr1[p]:.5f}, single {base:.5f}")
    trend_ok, sweep = True, {}
    for p in (2, 3):
        prev = base
        for cr in (2, 4, 8):
            b = char_setting(torch, h, card, f"P{p}-CR{cr}",
                             PrismConfig(P=p, cr=float(cr)), launches, True)
            sweep[f"P{p}-CR{cr}"] = b
            trend_ok &= b >= prev - TREND_SLACK
            prev = b
    table2 = {}
    for p in (2, 3):
        nodup = char_setting(torch, h, card, f"P{p}-CR4-nodup",
                             PrismConfig(P=p, cr=4.0, mode="prism_nodup"),
                             launches, True)
        table2[f"P{p}-CR4"] = {"duplicated": sweep[f"P{p}-CR4"],
                               "nodup": nodup,
                               "dup_better": sweep[f"P{p}-CR4"] <= nodup}
    hard = PrismConfig(P=3, cr=8.0)
    before = sweep["P3-CR8"]
    ft_first, ft_last, _ = h.train(CHAR_FT_STEPS, prism=hard, lr=CHAR_FT_LR)
    after = char_setting(torch, h, card, "P3-CR8-finetuned", hard, launches,
                         True)
    emit("path", path="train/charlm", setting="summary", card=card,
         bpc_single=base, cr1=cr1, sweep=sweep,
         monotonic_degradation=trend_ok, trend_slack=TREND_SLACK,
         table2=table2, finetune={"before": before, "after": after,
                                  "recovered": after < before,
                                  "loss_first": ft_first,
                                  "loss_last": ft_last},
         seconds=time.perf_counter() - t0)
    return launches


def drive_train(torch):
    """Phase 19: training and the accuracy path, (a) GPT-2 small, (b) the
    char-LM protocol."""
    import time
    t0 = time.perf_counter()
    card = nvidia_smi()
    launches = train_gpt2(torch, card)
    launches.update(train_char_lm(torch, card))
    emit("phase", name="train", seconds=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------------------
# phase 20: serving over a mesh of ranks
# ---------------------------------------------------------------------------

# (name, arch, mesh shape, decode steps, pairings, decode_tp, depth,
# prompt): (a)-(c) GPT-2 and Yi-6B (attention blocks); (d) OLMoE's
# expert all_to_all pair, 16 experts a rank; (e) expert-TP over data;
# (f) Gemma 3's ring halo (its first 6 layers: 5 local, 1 global; 512
# rows a shard, one window); (g) Zamba2's conv halo and state handoff
# (one 6-layer unit: 5 Mamba2, 1 shared); (h) xLSTM's state handoff and
# sLSTM gather (one 8-layer unit: 7 mLSTM, 1 sLSTM); (i) PaliGemma's
# image prefix across the shards and MusicGen's frame prompt.  (d)-(i)
# decode ``MESH_STEPS``: 8 put the whole script at 1,034.7 s of its
# 1,200 (target 1,080) on an H100 whose host was not the slowest seen
# (PERF.md §4), so they take 4, then MusicGen's static path 8 layers.
# With run (j) the script took 1,157.4 s (PERF.md §4), so (a) decoded 8
# steps (16 before), (b) and (c) ``MESH_STEPS`` (8 before).  With run
# (k), (a) decodes ``MESH_STEPS`` too: at 8 its three pairings took
# 4.2-4.5 s of decode a rank on an H100, and with this cut and (k)'s
# trace cut to 4 requests the script still took 1,095.8 s, over its
# 1,080 s target (PERF.md §4).  With run (l), the train step over the
# ranks, the script's estimate on the slowest host seen was 1,091 s, so
# 4 -> 3: one decode step of (a)-(i) took 11.8 s of rank time (PERF.md
# §4)
MESH_STEPS = 3
MESH_RUNS = (
    ("gpt2-1x4", ARCH, (1, 4), MESH_STEPS, GEMMA_PAIRINGS, False, None,
     PROMPT),
    ("gpt2-2x2", ARCH, (2, 2), MESH_STEPS, (("prism", "prism"),), False,
     None, PROMPT),
    ("yi-tp-1x4", LLAMA, (1, 4), MESH_STEPS, (("prism", "exact"),), True,
     STATIC_DEPTH[LLAMA], PROMPT),
    ("olmoe-1x4", MOE, (1, 4), MESH_STEPS, (("prism", "prism"),), False,
     4, PROMPT),
    ("olmoe-tp-2x2", MOE, (2, 2), MESH_STEPS, (("prism", "exact"),), True,
     4, PROMPT),
    ("gemma3-1x4", GEMMA, (1, 4), MESH_STEPS, (("prism", "prism"),),
     False, 6, GEMMA_PROMPT),
    ("zamba2-1x4", ZAMBA, (1, 4), MESH_STEPS, (("prism", "prism"),),
     False, 6, PROMPT),
    ("xlstm-1x4", XLSTM, (1, 4), MESH_STEPS, (("voltage", "exact"),),
     False, 8, PROMPT),
    ("paligemma-1x4", PALI, (1, 4), MESH_STEPS, (("prism", "prism"),),
     False, 4, PROMPT),
    ("musicgen-1x4", MUSICGEN, (1, 4), MESH_STEPS, (("prism", "prism"),),
     False, 4, PROMPT),
)
MESH_NOTE = ("4 gloo ranks on one card (cuda:0), collectives through the "
             "host: not a multi-card time")
# each run's kernels: prefill attention and the decode kernel always,
# segment means where the pairing gathers means; a model of recurrent
# blocks alone (xLSTM) launches none
MESH_KERNELS = ("prism_flash_attention", "flash_decode_stats")
# f32 elements a rank holds of the collectives a GPT-2 decode step makes
# on each of its 12 layers over the (1, 4) mesh: the layer's FSDP gather
# (7,077,888 weights over 4 ranks) and a combine psum (B 8 x 12 x 64)
MESH_COLLECTIVES = {"gather_layer": 7_077_888 // 4,
                    "psum_small": BATCH * 12 * 64}


# run (j): the serving engine over the ranks, GPT-2 small at full width
# on its first 4 layers: 6 requests of 64-192 prompt tokens, 3 of them
# (``MESH_ENGINE_SHARED``) behind one 64-token system prompt, 8 new
# tokens each, 4 slots, 16-token pages, a token budget of 64, a clock
# that stands still; (1, 4) packed exact with the prefix cache, (1, 4)
# packed prism, (2, 2) chunked exact on the dense cache, each held to the
# folded one-process engine at its sequence shards.  The trace had 8
# requests; the script then took 1,157.4 s of its 1,200 (PERF.md §4).
# Run (k) shares the model and the trace, so that both take one depth:
# 6 layers before run (k) (run (j)'s engines 6.38 / 8.25 / 9.28 s on an
# H100, PERF.md §6), 4 since
MESH_ENGINE_DEPTH = 4
MESH_ENGINE = dict(n_slots=4, prefill_len=256, max_cache=272,
                   token_budget=64, page_tokens=16)
MESH_ENGINE_REQUESTS, MESH_ENGINE_NEW, MESH_ENGINE_SYSTEM = 6, 8, 64
MESH_ENGINE_SHARED = (0, 4, 5)
MESH_ENGINE_RUNS = (((1, 4), "packed", "exact", True),
                    ((1, 4), "packed", "prism", True),
                    ((2, 2), "chunked", "exact", False))
# the most requests whose tokens may part from the fold's, each at a
# step where the fold's top-2 gap is under TOKEN_GAP of its |logit|
MESH_ENGINE_MAX_PARTED = 1
# the schedule's stats a rank must share with the fold
MESH_ENGINE_SCHEDULE = ("prefix_hits", "prefix_tokens_saved", "packed_ticks",
                        "prefill_chunks", "prefill_tokens", "out_of_pages",
                        "decode_steps")


def mesh_engine_key(shape, prefill, mode, paged):
    return (f"engine-{shape[0]}x{shape[1]}/{prefill}-{mode}-"
            f"{'paged' if paged else 'dense'}")


def mesh_engine_trace(vocab, n=None):
    """Run (j)'s prompts from a seeded rng, 64-192 tokens; the requests
    ``MESH_ENGINE_SHARED`` begin with one shared 64-token system prompt
    (a page of their own past it).  ``n``: the first n of them (default
    ``MESH_ENGINE_REQUESTS``)."""
    import numpy as np
    rng = np.random.default_rng(1)
    system = rng.integers(1, vocab, size=MESH_ENGINE_SYSTEM).tolist()
    prompts = []
    for i in range(MESH_ENGINE_REQUESTS if n is None else n):
        n = int(rng.integers(MESH_ENGINE_SYSTEM, 3 * MESH_ENGINE_SYSTEM + 1))
        if i in MESH_ENGINE_SHARED:
            n = max(n, MESH_ENGINE_SYSTEM + 16)
            prompts.append(system + rng.integers(
                1, vocab, size=n - MESH_ENGINE_SYSTEM).tolist())
        else:
            prompts.append(rng.integers(1, vocab, size=n).tolist())
    return prompts


def mesh_engine_model(torch):
    """GPT-2 small at full width on its first ``MESH_ENGINE_DEPTH``
    layers, seeded weights on the card: (config, weights)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(ARCH)
    cfg = replace(cfg, n_layers=MESH_ENGINE_DEPTH,
                  blocks=cfg.block_kinds[:MESH_ENGINE_DEPTH])
    return cfg, T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                       "cuda")


def mesh_engine(cfg, params, prefill, mode, paged, n_seq=None):
    """Run (j)'s engine: ``params`` a rank's ``MeshParams``, or the whole
    weights folded into one process over ``n_seq`` shards."""
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    config = EngineConfig(hp=ServeHParams(decode_mode=mode, means_cr=CR),
                          prefill_mode=prefill, paged=paged, **MESH_ENGINE)
    kw = {} if n_seq is None else {"n_seq": n_seq}
    return ServingEngine(cfg, params, config, clock=lambda: 0.0, **kw)


def mesh_engine_fold(torch, shape, prefill, mode, paged):
    """The folded engine of run (j) at the mesh's sequence shards, on the
    card: its tokens by request, each decode row's top-2 gap and largest
    |logit| by request, its schedule."""
    from repro_torch.runtime.serve import seq_shards
    cfg, params = mesh_engine_model(torch)
    eng = mesh_engine(cfg, params, prefill, mode, paged, seq_shards(
        dict(zip(("data", "model"), shape)), MESH_ENGINE["n_slots"]))
    log = keep_logits(eng)
    for prompt in mesh_engine_trace(cfg.vocab_size):
        eng.submit(prompt, max_new_tokens=MESH_ENGINE_NEW)
    out = eng.run()
    rows = {}
    for rid, kept in log.items():
        top2 = torch.stack(kept).topk(2, dim=-1).values
        rows[rid] = {"gap": (top2[:, 0] - top2[:, 1]).cpu().tolist(),
                     "top": torch.stack(kept).abs().amax(-1).cpu().tolist()}
    return {"tokens": out, "rows": rows,
            "schedule": {k: eng.stats.summary()[k]
                         for k in MESH_ENGINE_SCHEDULE},
            "pages": eng.kv_cache.stats()}


def tick_gather_bytes(mp, cfg) -> int:
    """The ``param_gather`` bytes a rank sends in one tick of the engine:
    every layer's FSDP gather (``rules.gather_tree``: over ``data``, then
    an ``fsdp2d`` leaf's over ``model``) and the learned position table's,
    from the rules and the rank's leaves."""
    from repro_torch.models.transformer import layer_blocks
    from repro_torch.sharding.rules import tree_paths
    n_d, n_m = mp.mesh.size(("data",)), mp.mesh.size(("model",))
    trees = [(p, r) for (_, p), (_, r) in zip(
        layer_blocks(cfg, mp.params), layer_blocks(cfg, mp.rules))]
    if cfg.pos == "learned":
        trees.append((mp.params["pos_embed"], mp.rules["pos_embed"]))
    total = 0
    for local, rules in trees:
        rule = dict(tree_paths(rules))
        for path, t in tree_paths(local):
            g = rule[path].gather_dim
            if g is None:
                continue
            b = t.numel() * t.element_size()
            total += (n_d - 1) * b
            if isinstance(g, tuple):
                total += (n_m - 1) * n_d * b
    return total


def mesh_engine_rank(torch, meshes, shape, prefill, mode, paged):
    """One rank of one engine run of (j): its tokens, schedule, launches
    (counters zeroed just before ``run``, read just after) and the ones
    its ticks need (``engine_launches``), its meter, the param_gather
    bytes a tick, wall time and ticks."""
    import time
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.runtime.serve import mesh_params
    m = meshes[shape]
    cfg, params = mesh_engine_model(torch)
    mp = mesh_params(cfg, params, m)
    del params
    eng = mesh_engine(cfg, mp, prefill, mode, paged)
    for prompt in mesh_engine_trace(cfg.vocab_size):
        eng.submit(prompt, max_new_tokens=MESH_ENGINE_NEW)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    m.meter.reset()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    s = eng.stats.summary()
    ticks = s["decode_steps"] + s["packed_ticks"] + s["prefill_chunks"]
    devices = {str(t.device) for c in eng.kv_cache.storage
               for t in c.values()}
    return {"tokens": out, "launches": launches,
            "need": engine_launches(eng, paged, cfg.n_layers),
            "schedule": {k: s[k] for k in MESH_ENGINE_SCHEDULE},
            "pages": eng.kv_cache.stats(), "meter": m.meter.snapshot(),
            "gather_per_tick": tick_gather_bytes(mp, cfg), "ticks": ticks,
            "wall_s": wall, "ms_per_tick": 1e3 * wall / ticks,
            "devices": sorted(devices | {str(m.device)}),
            "coords": m.coords, "n_seq": eng.layout.n_seq}


def parted(tokens, fold):
    """The requests whose tokens part from the fold's -> {rid: (step, the
    fold's top-2 gap there / its largest |logit|)}."""
    out = {}
    for rid, want in fold["tokens"].items():
        got = tokens[rid]
        k = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if k is None and len(got) == len(want):
            continue
        k = min(len(got), len(want)) if k is None else k
        row = fold["rows"][rid]
        out[rid] = (k, row["gap"][k] / row["top"][k]
                    if k < len(row["gap"]) else None)
    return out


def check_mesh_engine(key, runs, fold, shape, prefill, mode, paged, card):
    """Run (j)'s ranks against each other and the fold: every rank's
    tokens equal, the fold's but where a request parts at a near-tie (at
    most ``MESH_ENGINE_MAX_PARTED``), the fold's schedule and pages; on
    every rank the launches its ticks need, tensors on cuda:0 and
    ``param_gather`` exactly ticks x one tick's gathers.  Emits the path
    line; returns the launches summed over the ranks."""
    first = runs[0]
    for rank, run in enumerate(runs):
        if run["tokens"] != first["tokens"]:
            raise AssertionError(f"{key} rank {rank}: tokens differ from "
                                 "rank 0's")
        if run["devices"] != ["cuda:0"]:
            raise AssertionError(f"{key} rank {rank}: tensors on "
                                 f"{run['devices']}")
        if run["schedule"] != fold["schedule"] or (
                run["pages"] != fold["pages"]):
            raise AssertionError(f"{key} rank {rank}: schedule "
                                 f"{run['schedule']}, pages {run['pages']}; "
                                 f"the fold's {fold['schedule']}, "
                                 f"{fold['pages']}")
        check_launches(f"{key} rank {rank}", run["launches"], run["need"])
        gathered = run["meter"]["sent"]["param_gather"]
        if gathered != run["ticks"] * run["gather_per_tick"]:
            raise AssertionError(f"{key} rank {rank}: param_gather "
                                 f"{gathered} bytes over {run['ticks']} "
                                 f"ticks of {run['gather_per_tick']}")
    if len(first["tokens"]) != MESH_ENGINE_REQUESTS or any(
            len(t) != MESH_ENGINE_NEW for t in first["tokens"].values()):
        raise AssertionError(f"{key}: requests unfinished")
    apart = parted(first["tokens"], fold)
    for rid, (step, gap) in apart.items():
        if gap is None or gap >= TOKEN_GAP:
            raise AssertionError(f"{key}: request {rid} parts from the fold "
                                 f"at step {step}, its top-2 gap {gap}")
    if len(apart) > MESH_ENGINE_MAX_PARTED:
        raise AssertionError(f"{key}: {len(apart)} requests part from the "
                             "fold")
    if mode == "exact" and paged and first["schedule"]["prefix_hits"] == 0:
        raise AssertionError(f"{key}: no prefix hit")
    emit("path", name=f"mesh/{key}", arch=ARCH, mesh=list(shape),
         layers=MESH_ENGINE_DEPTH, prefill=prefill, mode=mode, paged=paged,
         **MESH_ENGINE, requests=MESH_ENGINE_REQUESTS,
         new_tokens=MESH_ENGINE_NEW, system_prompt=MESH_ENGINE_SYSTEM,
         n_seq=first["n_seq"], parted_at_near_tie=apart,
         schedule=first["schedule"], pages=first["pages"],
         ticks=first["ticks"], gather_per_tick=first["gather_per_tick"],
         wall_s=[r["wall_s"] for r in runs],
         ms_per_tick=[r["ms_per_tick"] for r in runs],
         launches=[r["launches"] for r in runs],
         sent=[r["meter"]["sent"] for r in runs], clock="host",
         note=MESH_NOTE, nvidia_smi=card)
    return {k: sum(r["launches"].get(k, 0) for r in runs)
            for k in set().union(*(r["launches"] for r in runs))}


# run (k): the engine's robustness layers over the ranks, on run (j)'s
# model and engine and the first ``MESH_ROBUST_REQUESTS`` of its trace,
# each run held to the folded engine driven the same way: (name, mesh
# shape, decode mode, drive).  "robust": the host
# offload tier on, every fault kind but shard_loss at a fixed opportunity
# (``ROBUST_FAULTS``), every request preempted by hand once it has a
# token, a snapshot cut after ``MESH_ROBUST_SNAPSHOT`` steps and restored
# into a fresh engine on the same ranks; "loss": shard
# ``MESH_SHARD_LOST`` lost at the ``MESH_SHARD_LOSS_AT``-th opportunity,
# its rank's pages of the live slots filled with NaN; "stream": the
# streaming loop, overlap on; "padded": the padded flush on the dense
# cache (the static prefill over the ranks: attention and, in prism, the
# segment means once a layer a flush); "gang": gang admission
MESH_ROBUST_RUNS = (("offload-exact", (1, 4), "exact", "robust"),
                    ("offload-prism", (1, 4), "prism", "robust"),
                    ("shard-loss-exact", (1, 4), "exact", "loss"),
                    ("shard-loss-prism", (1, 4), "prism", "loss"),
                    ("stream-prism", (1, 4), "prism", "stream"),
                    ("padded-prism", (2, 2), "prism", "padded"),
                    ("gang-exact", (1, 4), "exact", "gang"))
MESH_ROBUST_SNAPSHOT = 10
MESH_SHARD_LOSS_AT, MESH_SHARD_LOST = 10, 1
# the first 4 of run (j)'s 6 requests: at 6 run (k) took 52.3 s of phase
# 20 (its ranks 49.5 s, its folds 2.8 s) on an H100 (PERF.md §4), over
# its 45 s
MESH_ROBUST_REQUESTS = 4
# the counters a rank of run (k) must share with its fold
MESH_ROBUST_COUNTERS = MESH_ENGINE_SCHEDULE + (
    "prefills", "preemptions", "spilled_pages", "restore_hits",
    "restore_misses", "restarts", "quarantined", "failed_requests",
    "faults_injected", "faults_by_kind", "shard_lost", "degraded_ticks")


def mesh_robust_engine(cfg, params, mode, drive, n_seq=None):
    """Run (k)'s engine for ``drive``: ``params`` a rank's ``MeshParams``,
    or the whole weights folded into one process over ``n_seq``
    shards."""
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    from repro_torch.runtime.serve import ServeHParams
    from repro_torch.serving import EngineConfig, ServingEngine
    over = {"padded": dict(prefill_mode="padded"), "gang": dict(gang=True),
            "robust": dict(offload=True, faults=FaultPlan(seed=0, **{
                k: FaultSpec(at=v) for k, v in ROBUST_FAULTS.items()})),
            "loss": dict(faults=FaultPlan(shard_loss=FaultSpec(
                at=(MESH_SHARD_LOSS_AT,), shard=MESH_SHARD_LOST)))}
    config = EngineConfig(hp=ServeHParams(decode_mode=mode, means_cr=CR),
                          **MESH_ENGINE, **over.get(drive, {}))
    kw = {} if n_seq is None else {"n_seq": n_seq}
    return ServingEngine(cfg, params, config, clock=lambda: 0.0, **kw)


def mesh_robust_drive(make, drive, vocab, on_engine):
    """Run (k)'s trace through the engine ``make()`` builds (each engine
    handed to ``on_engine`` first): under "stream" the streaming loop;
    under "robust" step by step, every request preempted once it has a
    token, the cut after ``MESH_ROBUST_SNAPSHOT`` steps restored into a
    fresh engine that runs on.  Returns (the last engine, its results)."""
    from repro_torch.serving import StreamingEngine
    eng = make()
    on_engine(eng)
    prompts = mesh_engine_trace(vocab, MESH_ROBUST_REQUESTS)
    if drive == "stream":
        seng = StreamingEngine(eng, overlap=True)
        for p in prompts:
            seng.submit_stream(p, max_new_tokens=MESH_ENGINE_NEW)
        return eng, seng.run_sync()
    for p in prompts:
        eng.submit(p, max_new_tokens=MESH_ENGINE_NEW)
    if drive != "robust":
        return eng, eng.run()
    hit, steps = set(), 0
    while eng._sched.has_work:
        eng.step()
        steps += 1
        for st in list(eng._sched.active.values()):
            rid = st.req.rid
            if (rid not in hit and not st.prefilling and st.generated
                    and not st.finished()):
                eng.preempt(rid)
                hit.add(rid)
        if steps == MESH_ROBUST_SNAPSHOT:
            snap = eng.snapshot()
            eng = make()
            on_engine(eng)
            eng.restore(snap)
    return eng, eng.results()


def robust_launches(eng, drive, n_layers):
    """The launches a run of (k) needs of a rank (or the fold): the
    decode kernel's of its ticks (``engine_launches``), one more a layer
    a degraded tick; the padded flush's attention once a layer a flush,
    its segment means too in prism mode, one dense decode launch a layer
    a step."""
    s = eng.stats
    if drive == "padded":
        n = n_layers * s.prefills
        return {"prism_flash_attention": n,
                "segment_means": (n if eng.config.hp.decode_mode == "prism"
                                  else 0),
                "flash_decode_stats": n_layers * s.decode_steps,
                "flash_decode_stats.paged": 0, "flash_decode_stats.mq": 0}
    need = engine_launches(eng, True, n_layers)
    for name in ("flash_decode_stats", "flash_decode_stats.paged"):
        need[name] += n_layers * s.degraded_ticks
    return need


def robust_counters(eng):
    s = eng.stats.summary()
    return {k: s[k] for k in MESH_ROBUST_COUNTERS}


def keep_degraded(torch, eng):
    """Wrap the engine's degraded step to keep, on the host, what it
    served: each degraded tick's logits rows by (request, position,
    token fed), and in exact mode the first assembled standby's kz/vz
    columns of the lost shard and every column's counts -> the dict they
    go to.  The recovery prefills every request again and throws those
    ticks' tokens away, so only these show the degraded arithmetic."""
    import numpy as np
    kept = {"ticks": [], "standby": None}
    degraded = eng._decode_degraded

    def served(tok, pos):
        logits = degraded(tok, pos)
        rows = logits.cpu().numpy()
        kept["ticks"].append({
            (eng._sched.active[int(s)].req.rid, int(pos[s]), int(tok[s])):
            rows[s] for s in np.flatnonzero(pos >= 0)})
        rep = eng._replica._assembled
        if kept["standby"] is None and rep is not None:
            L, shard = eng.layout.L, min(eng._lost)
            cols = slice(shard * L, (shard + 1) * L)
            kept["standby"] = {
                k: torch.stack([d[k][:, cols] for d in rep]).cpu().numpy()
                for k in ("kz", "vz")}
            kept["standby"]["gz"] = torch.stack(
                [d["gz"] for d in rep]).cpu().numpy()
        return logits
    eng._decode_degraded = served
    return kept


def check_served(what, got, want, apart, lost):
    """A rank's degraded ticks (``keep_degraded``) against the fold's:
    as many ticks; every row of the first one whose request does not
    part from the fold (``apart``) among the fold's, and wherever the
    keys meet the rows within ``PATH_REL_TOL`` of the fold's largest
    |logit|; on the lost rank (``lost``; exact mode) the standby's
    columns of the lost shard, back from its ring neighbour, within
    segment_means' ``TOL`` of the fold's cut, the counts equal ->
    (rows compared, their largest |error|, the standby's)."""
    import numpy as np
    first = {k for k in got["ticks"][0] if k[0] not in apart} \
        if got["ticks"] else set()
    if (len(got["ticks"]) != len(want["ticks"]) or not first
            or not first <= set(want["ticks"][0])):
        raise AssertionError(f"{what}: degraded rows "
                             f"{[sorted(t) for t in got['ticks']]}; the "
                             f"fold's {[sorted(t) for t in want['ticks']]}")
    n, err, top = 0, 0.0, 0.0
    for g, w in zip(got["ticks"], want["ticks"]):
        for k in set(g) & set(w):
            n += 1
            err = max(err, float(np.abs(g[k] - w[k]).max()))
            top = max(top, float(np.abs(w[k]).max()))
    if not err <= PATH_REL_TOL * top:
        raise AssertionError(f"{what}: degraded rows {err} from the fold's, "
                             f"its largest |logit| {top}")
    if not lost or want["standby"] is None:
        return n, err, None
    g, w = got["standby"], want["standby"]
    if g is None:
        raise AssertionError(f"{what}: the lost rank served no standby")
    atol, rtol = TOL["segment_means"]
    std = max(float(np.abs(g[k] - w[k]).max()) for k in ("kz", "vz"))
    if (not np.array_equal(g["gz"], w["gz"]) or not (w["gz"] > 0).any()
            or any(not np.allclose(g[k], w[k], atol=atol, rtol=rtol)
                   for k in ("kz", "vz"))):
        raise AssertionError(f"{what}: the lost shard's standby {std} from "
                             "the fold's cut")
    return n, err, std


def mesh_robust_fold(torch, shape, mode, drive):
    """The folded engine of a run of (k) at the mesh's sequence shards,
    driven alike, on the card: its tokens, the last ``MESH_ENGINE_NEW``
    decode rows of each request (top-2 gap and largest |logit|; a
    streamed run's from the synchronous fold, whose tokens are the
    loop's), its counters; its launches and leaks checked."""
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.runtime.serve import seq_shards
    cfg, params = mesh_engine_model(torch)
    n_seq = seq_shards(dict(zip(("data", "model"), shape)),
                       MESH_ENGINE["n_slots"])

    def make():
        return mesh_robust_engine(cfg, params, mode, drive, n_seq)
    logs, served = [], []

    def on_engine(e):
        logs.append(keep_logits(e))
        if drive == "loss":
            served.append(keep_degraded(torch, e))
    before = dict(LAUNCHES)
    eng, out = mesh_robust_drive(make, drive, cfg.vocab_size, on_engine)
    what = f"mesh/robust fold {shape} {mode} {drive}"
    check_launches(what, {k: n - before.get(k, 0)
                          for k, n in LAUNCHES.items()},
                   robust_launches(eng, drive, cfg.n_layers))
    if eng.kv_cache.paged:
        check_drained(eng, what)
    if drive == "stream":
        sync = make()
        logs = [keep_logits(sync)]
        for p in mesh_engine_trace(cfg.vocab_size, MESH_ROBUST_REQUESTS):
            sync.submit(p, max_new_tokens=MESH_ENGINE_NEW)
        if sync.run() != out:
            raise AssertionError(f"mesh/robust fold {drive}: the streamed "
                                 "tokens differ from the synchronous ones")
    kept = {}
    for log in logs:
        for rid, rows in log.items():
            kept.setdefault(rid, []).extend(rows)
    rows = {}
    for rid, kept_rows in kept.items():
        last = torch.stack(kept_rows[-MESH_ENGINE_NEW:])
        top2 = last.topk(2, dim=-1).values
        rows[rid] = {"gap": (top2[:, 0] - top2[:, 1]).cpu().tolist(),
                     "top": last.abs().amax(-1).cpu().tolist()}
    return {"tokens": out, "rows": rows, "counters": robust_counters(eng),
            "failed": eng.failed(), "served": served[0] if served else None}


def mesh_robust_rank(torch, meshes, shape, mode, drive):
    """One rank of a run of (k): its tokens, digest of host decisions,
    counters, launches (zeroed just before the drive, read just after)
    and the ones its ticks need, its meter, the param_gather bytes a
    tick, the replica's counters, wall time and ticks; under "loss" the
    lost rank fills its pages of the live slots with NaN at the loss,
    every degraded tick's logits must be finite, and what the degraded
    ticks served is kept (``keep_degraded``)."""
    import time
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.runtime.serve import mesh_params
    m = meshes[shape]
    cfg, params = mesh_engine_model(torch)
    mp = mesh_params(cfg, params, m)
    del params
    finite, filled, engines, served = [], [], [], []

    def on_engine(eng):
        engines.append(eng)
        if drive != "loss":
            return
        lose, degraded, kv = eng._lose_shard, eng._decode_degraded, \
            eng.kv_cache

        def lose_and_fill(shard):
            lose(shard)
            if m.coords["model"] == shard:
                pages = sorted({p for s in eng._sched.active
                                for p in kv.slot_pages[s]})
                idx = torch.as_tensor(pages, device=m.device)
                for c in kv.storage:
                    for name in ("k", "v"):
                        c[name][idx] = LOST_FILL
                filled.append(len(pages))

        def checked(tok, pos):
            logits = degraded(tok, pos)
            live = torch.as_tensor(pos >= 0, device=logits.device)
            finite.append(bool(torch.isfinite(logits[live]).all()))
            return logits
        eng._lose_shard, eng._decode_degraded = lose_and_fill, checked
        served.append(keep_degraded(torch, eng))
    torch.cuda.synchronize()
    LAUNCHES.clear()
    m.meter.reset()
    t0 = time.perf_counter()
    eng, out = mesh_robust_drive(
        lambda: mesh_robust_engine(cfg, mp, mode, drive), drive,
        cfg.vocab_size, on_engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    s = eng.stats
    ticks = (s.decode_steps + s.packed_ticks + s.prefill_chunks
             + s.degraded_ticks + s.prefills)
    leak = None
    try:
        if eng.kv_cache.paged:
            check_drained(eng, "rank")
        elif sorted(eng._sched.free_slots) != list(range(eng.n_slots)):
            raise AssertionError(f"slots {eng._sched.free_slots}")
    except AssertionError as e:
        leak = str(e)
    devices = {str(t.device) for c in eng.kv_cache.storage
               for t in c.values()}
    return {"tokens": out, "trail": eng.trail, "failed": eng.failed(),
            "counters": robust_counters(eng), "launches": launches,
            "need": robust_launches(eng, drive, cfg.n_layers),
            "meter": m.meter.snapshot(),
            "gather_per_tick": tick_gather_bytes(mp, cfg), "ticks": ticks,
            "replica": (engines[0]._replica.stats()
                        if engines[0]._replica is not None else None),
            "L": eng.layout.L, "finite": finite, "filled": filled,
            "served": served[0] if served else None,
            "leak": leak, "engines": len(engines), "wall_s": wall,
            "ms_per_tick": 1e3 * wall / max(1, ticks),
            "devices": sorted(devices | {str(m.device)}),
            "coords": m.coords, "n_seq": eng.layout.n_seq}


def check_mesh_robust(name, runs, fold, shape, mode, drive, card):
    """A run of (k)'s ranks against each other and the fold: every
    rank's digest of host decisions, then tokens, equal; the fold's
    tokens but where a request parts at a near-tie (at most
    ``MESH_ENGINE_MAX_PARTED``), its counters and failures; on every
    rank the launches its ticks need, tensors on cuda:0, nothing leaked,
    ``param_gather`` exactly ticks x one tick's, the ``replica`` bytes
    exact (exact mode: each capture the rank's L columns of K and V of
    every layer to its ring neighbour, the lost shard's host its copy of
    every live slot back once; prism: none), the degraded ticks' logits
    finite and held to the fold's, the lost rank's standby columns to
    the fold's cut (``check_served``).  Emits the path line; returns the launches summed over the
    ranks."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    key = f"mesh/robust-{name}"
    first = runs[0]
    for rank, run in enumerate(runs):
        if run["trail"] != first["trail"]:
            raise AssertionError(f"{key} rank {rank}: host decisions differ "
                                 "from rank 0's")
        if run["tokens"] != first["tokens"]:
            raise AssertionError(f"{key} rank {rank}: tokens differ from "
                                 "rank 0's")
        if run["devices"] != ["cuda:0"] or run["leak"]:
            raise AssertionError(f"{key} rank {rank}: tensors on "
                                 f"{run['devices']}, leak {run['leak']}")
        if run["counters"] != fold["counters"] or (
                run["failed"] != fold["failed"]):
            raise AssertionError(f"{key} rank {rank}: counters "
                                 f"{run['counters']} {run['failed']}; the "
                                 f"fold's {fold['counters']} "
                                 f"{fold['failed']}")
        check_launches(f"{key} rank {rank}", run["launches"], run["need"])
        if not run["launches"].get("flash_decode_stats"):
            raise AssertionError(f"{key} rank {rank}: no decode launch")
        gathered = run["meter"]["sent"]["param_gather"]
        if gathered != run["ticks"] * run["gather_per_tick"]:
            raise AssertionError(f"{key} rank {rank}: param_gather "
                                 f"{gathered} bytes over {run['ticks']} "
                                 f"ticks of {run['gather_per_tick']}")
        want = 0
        if drive == "loss" and mode == "exact":
            rep = run["replica"]
            col = (MESH_ENGINE_DEPTH * 2 * run["L"] * cfg.n_kv_heads
                   * cfg.hd * 4)
            host = (MESH_SHARD_LOST + 1) % run["n_seq"]
            want = col * (rep["captures"] + (
                rep["returned"] if run["coords"]["model"] == host else 0))
            if (run["coords"]["model"] == host) != (rep["returned"] > 0):
                raise AssertionError(f"{key} rank {rank}: returned "
                                     f"{rep['returned']} standbys")
        if run["meter"]["sent"]["replica"] != want:
            raise AssertionError(f"{key} rank {rank}: replica bytes "
                                 f"{run['meter']['sent']['replica']}, "
                                 f"reckoned {want}")
        if drive == "loss" and (not run["finite"] or not all(run["finite"])
                                or bool(run["filled"]) != (
                                    run["coords"]["model"]
                                    == MESH_SHARD_LOST)):
            raise AssertionError(f"{key} rank {rank}: degraded logits "
                                 f"finite {run['finite']}, NaN-filled "
                                 f"pages {run['filled']}")
    c = fold["counters"]
    if drive == "robust":
        unfired = [k for k in ROBUST_FAULTS if not c["faults_by_kind"].get(k)
                   and not (k == "page_poison" and mode == "prism")]
        if unfired or first["engines"] != 2 or c["preemptions"] < 1:
            raise AssertionError(f"{key}: faults {c['faults_by_kind']}, "
                                 f"{first['engines']} engines, "
                                 f"{c['preemptions']} preemptions")
    if drive == "loss" and (c["shard_lost"] != 1 or c["degraded_ticks"] < 1):
        raise AssertionError(f"{key}: shard_lost {c['shard_lost']}, "
                             f"degraded ticks {c['degraded_ticks']}")
    done = set(first["tokens"]) | set(first["failed"])
    if len(done) != MESH_ROBUST_REQUESTS:
        raise AssertionError(f"{key}: requests unaccounted for")
    apart = parted(first["tokens"], fold)
    for rid, (step, gap) in apart.items():
        if gap is None or gap >= TOKEN_GAP:
            raise AssertionError(f"{key}: request {rid} parts from the fold "
                                 f"at step {step}, its top-2 gap {gap}")
    if len(apart) > MESH_ENGINE_MAX_PARTED:
        raise AssertionError(f"{key}: {len(apart)} requests part from the "
                             "fold")
    served = [check_served(f"{key} rank {rank}", run["served"],
                           fold["served"], apart,
                           run["coords"]["model"] == MESH_SHARD_LOST)
              for rank, run in enumerate(runs)] if drive == "loss" else None
    emit("path", path=key, arch=ARCH, mesh=list(shape), mode=mode,
         drive=drive, layers=MESH_ENGINE_DEPTH, **MESH_ENGINE,
         requests=MESH_ROBUST_REQUESTS, new_tokens=MESH_ENGINE_NEW,
         n_seq=first["n_seq"], parted_at_near_tie=apart,
         counters=first["counters"], failed=first["failed"],
         ticks=first["ticks"], gather_per_tick=first["gather_per_tick"],
         replica=[r["replica"] for r in runs],
         degraded_served=served, degraded_served_note=(
             "per rank: (degraded rows held to the fold's, their largest "
             "|error|, the lost shard's standby columns' largest |error| "
             "on its rank)"),
         wall_s=[r["wall_s"] for r in runs],
         ms_per_tick=[r["ms_per_tick"] for r in runs],
         launches=[r["launches"] for r in runs],
         sent=[r["meter"]["sent"] for r in runs], clock="host",
         note=MESH_NOTE, nvidia_smi=card)
    return {k: sum(r["launches"].get(k, 0) for r in runs)
            for k in set().union(*(r["launches"] for r in runs))}


def time_collectives(torch, mesh, iters=10):
    """Host-clock ms of one collective over the mesh's ``model`` group at
    ``MESH_COLLECTIVES``' sizes: the median of ``iters`` calls after two,
    the card synchronised around each (every rank calls in turn)."""
    import time
    from repro_torch.sharding import comm
    grp = mesh.group("model")
    x = {k: torch.randn(n, device=mesh.device)
         for k, n in MESH_COLLECTIVES.items()}
    calls = {"gather_layer": lambda: comm.all_gather(
                 x["gather_layer"], grp, "param_gather"),
             "psum_small": lambda: comm.psum(x["psum_small"], grp,
                                             "combine")}
    out = {}
    for name, fn in calls.items():
        times = []
        for _ in range(iters + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        out[name + "_ms"] = statistics.median(times[2:])
    return out


def mesh_fold(torch, arch, shape, steps, pairing, depth, prompt):
    """The folded one-process path of a mesh run on the card (``setup``'s
    run, as ``mesh_rank``'s): the same weights, prompts, shapes, layout P
    and kernels -> {"tokens" (B, gen), "logits" (gen, B, V)} on the host.
    A MoE model's routing groups are a rank's tokens, so its fold runs
    each data rank's batch rows alone (the whole batch on a (1, P) mesh,
    whose P shards are the ranks' groups) and records their routing
    ("routing": one list of calls a data rank) for the ranks to replay.
    A model of recurrent blocks sums its rows in another f32 order than a
    rank, which depth amplifies: its fold adds a float64 witness
    ("witness"; the exact pairing's is the plain full forward, another's
    the same run with backend='plain', teacher-forced on the fold's
    tokens) and the fold's distance to it ("fold_err")."""
    import torch.nn.functional as F
    from repro_torch.launch.serve import setup
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import RoutingLog
    from repro_torch.runtime.serve import layout_axes, seq_shards
    axes = dict(zip(("data", "model"), shape))
    run = setup(arch, batch=BATCH, prompt_len=prompt, gen=steps + 1,
                seq_shards=seq_shards(axes, BATCH), decode_mode=pairing[1],
                prefill=pairing[0], cr=CR, cap=prompt + GEN, n_layers=depth)
    if "moe" not in run.cfg.block_kinds:
        tokens, logits, _ = run.run()
        out = {"tokens": tokens, "logits": logits}
    else:
        groups = shape[0] if layout_axes(axes, BATCH)[0] else 1
        parts, out = [], {"routing": []}
        for rows in torch.arange(BATCH, device=run.prompts.device).chunk(
                groups):
            log = RoutingLog()
            parts.append(replace(run, prompts=run.prompts[rows],
                                 hp=replace(run.hp, routing=log)).run())
            out["routing"].append([{"idx": c["idx"].cpu(),
                                    "logits": c["logits"].cpu(),
                                    "cap": c["cap"]} for c in log.calls])
        out["tokens"] = torch.cat([t for t, _, _ in parts])
        out["logits"] = torch.cat([g for _, g, _ in parts], dim=1)
    if set(run.cfg.block_kinds) & set(CELLS):
        params64 = as_f64(run.params)
        with torch.no_grad():
            if pairing == ("voltage", "exact"):
                # the exact path's witness is the full forward (an sLSTM
                # decode step keeps f32) in chunks of XLSTM_REF_CHUNK, as
                # ``recurrent_check``'s, over prompt and fed tokens padded
                # to a whole chunk (the causal rows before the pad do not
                # see it)
                seq = torch.cat([run.prompts, out["tokens"][:, :-1]], dim=1)
                seq = F.pad(seq, (0, -seq.shape[1] % XLSTM_REF_CHUNK))
                n = run.prompts.shape[1]
                ref = T.forward(run.cfg, params64, seq, start=n - 1,
                                chunk=XLSTM_REF_CHUNK)[:, :steps + 1]
                ref = ref.transpose(0, 1)
            else:
                _, ref, _ = replace(run, params=params64, hp=replace(
                    run.hp, backend="plain")).run(
                        forced=out["tokens"][:, :-1])
        out["witness"] = ref.cpu()
        out["fold_err"] = rel_err(out["logits"], ref)
        del params64
    return {k: v.cpu() if hasattr(v, "cpu") else v for k, v in out.items()}


def replay_log(torch, calls, index, device):
    """A rank's replay of its data rank's fold routing ``calls``: a
    prefill call's groups are the fold's P shards, of which the rank
    routes the one at its sequence ``index``; a decode step's one group
    is the rank's whole batch."""
    from repro_torch.models.moe import RoutingLog
    log = RoutingLog()
    for c in calls:
        pick = (slice(index, index + 1) if c["idx"].shape[0] > 1
                else slice(None))
        log.calls.append({"idx": c["idx"][pick].to(device),
                          "logits": c["logits"][pick].to(device),
                          "cap": c["cap"]})
    return log


def mesh_rank_run(mesh, runs, fold_path, engine_runs=MESH_ENGINE_RUNS,
                  robust_runs=MESH_ROBUST_RUNS, train_path=None,
                  ckpt_dir=None):
    """One rank of phase 20: every run through ``mesh_rank``, the (2, 2)
    runs on one mesh of the same ranks, each teacher-forced on the fold's
    tokens and held to its logits (a MoE run replaying the fold's
    routing, ``replay_check``; a recurrent model's to the float64
    witness) -> per run its error and limit, tokens checked, launches,
    meter, times and where its tensors live; then run (j)'s engine runs
    (``mesh_engine_rank``), run (k)'s (``mesh_robust_rank``) and run
    (l)'s train steps (``mesh_train_rank``, its folds in
    ``train_path``, the (1, 4) checkpoint written to ``ckpt_dir``)."""
    import torch
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.serve import mesh_rank
    from repro_torch.models.moe import RoutingLog
    from repro_torch.runtime.serve import batch_rows, layout_axes
    from repro_torch.sharding.rules import tree_paths
    folds = torch.load(fold_path, weights_only=False)
    meshes = {mesh.shape: mesh}
    out = {}
    for name, arch, shape, steps, pairings, tp, depth, prompt in runs:
        if shape not in meshes:
            meshes[shape] = Mesh(shape, backend=mesh.backend, device="cuda")
        m = meshes[shape]
        ba, seq_axes = layout_axes(m, BATCH)
        for pairing in pairings:
            key = f"{name}/{pairing[0]}-{pairing[1]}"
            fold = folds[key]
            routing = replay = None
            if "routing" in fold:
                replay = replay_log(
                    torch, fold["routing"][m.group(ba).index if ba else 0],
                    m.group(seq_axes).index, m.device)
                routing = RoutingLog(replay=replay)
            torch.cuda.synchronize()
            LAUNCHES.clear()
            r = mesh_rank(m, arch, batch=BATCH, prompt_len=prompt,
                          gen=steps + 1, decode_mode=pairing[1],
                          prefill=pairing[0], cr=CR, decode_tp=tp,
                          n_layers=depth, cap=prompt + GEN,
                          forced=fold["tokens"][:, :-1].cuda(),
                          routing=routing)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            lay = r["lay"]
            got = r["logits"].cpu()

            def rows(logits):
                return batch_rows(logits.transpose(0, 1), lay,
                                  m).transpose(0, 1)
            want = rows(fold["logits"])
            res = {"fold_rel_err": rel_err(got, want), "limit": PATH_REL_TOL}
            if "witness" in fold:
                want = rows(fold["witness"])
                res.update(witness_rel_err=rel_err(got, want),
                           fold_witness_rel_err=fold["fold_err"],
                           limit=max(PATH_REL_TOL,
                                     F32_ORDER_FACTOR * fold["fold_err"]))
            res["rel_err"] = rel_err(got, want)
            res["tokens_checked"] = tokens_agree(
                torch, got.argmax(-1).T, want,
                res["rel_err"] if "witness" in fold else 0.0)
            if replay is not None:
                res["routing"] = replay_check(torch, replay, routing, key)
            places = {str(t.device) for tree in (r["mp"], r["dp"])
                      if tree is not None
                      for _, t in tree_paths(tree.params)}
            places |= {str(r["logits"].device), str(r["tokens"].device),
                       str(m.device)}
            res.update(launches=launches, meter=r["meter"],
                       times=r["times"], devices=sorted(places),
                       coords=m.coords, b_loc=got.shape[1],
                       n_seq=lay.n_seq, L=lay.L)
            out[key] = res
            del r, routing, replay
            torch.cuda.empty_cache()
    for shape, prefill, mode, paged in engine_runs:
        if shape not in meshes:
            meshes[shape] = Mesh(shape, backend=mesh.backend, device="cuda")
        out[mesh_engine_key(shape, prefill, mode, paged)] = mesh_engine_rank(
            torch, meshes, shape, prefill, mode, paged)
        torch.cuda.empty_cache()
    for name, shape, mode, drive in robust_runs:
        if shape not in meshes:
            meshes[shape] = Mesh(shape, backend=mesh.backend, device="cuda")
        out[f"robust-{name}"] = mesh_robust_rank(torch, meshes, shape, mode,
                                                 drive)
        torch.cuda.empty_cache()
    if train_path is not None:
        train_folds = torch.load(train_path, weights_only=False)
        for shape in MESH_TRAIN_SHAPES:
            if shape not in meshes:
                meshes[shape] = Mesh(shape, backend=mesh.backend,
                                     device="cuda")
            out[mesh_train_key(shape)] = mesh_train_rank(
                torch, meshes[shape], shape, train_folds[shape],
                ckpt_dir if shape == (1, 4) else None)
            torch.cuda.empty_cache()
        del train_folds
    out["collectives"] = time_collectives(torch, mesh)
    return out


def mesh_bytes(cfg, run, shape, pairing, tp, prompt, steps):
    """The bytes by class a rank of a run on a mesh of ``shape`` (batch
    over data, sequence over model) must send, exactly, where the
    protocol fixes them: {class: (after prefill, in all or None)}, or
    None.  The prefill's ``exchange``: a global attention layer's B_loc
    x ``comm_elements_per_device_per_layer`` x 4 (a Voltage prefill for
    prism decode gathers the means too); a local layer's ring halo, one
    hop of the rank's (B_loc, n_loc, D) f32 rows, sent by every rank but
    the last (Gemma 3).  A MoE layer's ``expert`` all_to_all pair: (M -
    1) / M of the (E, cap, D) f32 buffer each way over the M ranks of
    ``model``, at the capacity of the rank's B_loc·n_loc prefill tokens
    and of a step's B_loc; with expert-TP a step also gathers the
    received slots over ``data`` and psums their partials there."""
    from repro_torch.core.protocol import (
        PrismConfig, comm_elements_per_device_per_layer)
    from repro_torch.models.moe import capacity
    if not set(cfg.block_kinds) <= {"attn", "attn_local", "moe"}:
        return None
    p, b, d = run["n_seq"], run["b_loc"], cfg.d_model
    elems = comm_elements_per_device_per_layer(
        prompt, d, PrismConfig(P=p, cr=CR, mode=pairing[0]))
    if pairing == ("voltage", "prism"):              # the means captured
        elems += (p - 1) * run["L"] * d
    n_local = cfg.block_kinds.count("attn_local")
    last = run["coords"]["model"] == p - 1
    halo = 0 if last else b * (prompt // p) * d * 4
    out = {"exchange": ((cfg.n_layers - n_local) * b * elems * 4
                        + n_local * halo, None)}
    if "moe" in cfg.block_kinds:
        data, m, e = shape[0], shape[1], cfg.n_experts

        def buf(tokens):
            return e * capacity(tokens, cfg.top_k, e,
                                cfg.capacity_factor) * d * 4
        pre = cfg.n_layers * 2 * (m - 1) * buf(b * prompt // p) // m
        step = 2 * (m - 1) * buf(b) // m
        if tp:
            step += 3 * (data - 1) * buf(b)
        out["expert"] = (pre, pre + steps * cfg.n_layers * step)
    return out


# run (l): the train step over the ranks, GPT-2 small at full width on its
# first ``MESH_ENGINE_DEPTH`` layers (run (j)'s, for the time limit): B 8 x
# 512 from the synthetic corpus (the launcher's batches), prism at CR 4,
# ``MESH_TRAIN_STEPS`` steps with the reference launcher's
# hyper-parameters (lr 3e-4, warm-up 1 step, the cosine over 3), on (1,
# 4) (P 4) and on (2, 2) (P 2, 4 sequences a data rank).  Each rank is
# held to its fold, the one-card ``make_train_step`` at the same P over
# the whole batch from the same weights: each step's loss within
# ``MESH_TRAIN_LOSS_TOL`` of it (relative), gnorm within
# ``MESH_TRAIN_GNORM_TOL``; the first step's gradient (m / 0.1, gathered
# whole) and m and v after the last step within ``MESH_TRAIN_TREE_TOL``
# of each leaf's largest |value| (updated parameters are not compared
# elementwise: where a gradient is near 0, f32 noise can flip the sign of
# Adam's first update).  Its bytes a step by class must equal
# ``train_step_bytes``.  The (1, 4) run's checkpoint is then served on
# one card (``launch.serve.setup(..., checkpoint=)``), prism prefill and
# prism decode for ``MESH_TRAIN_GEN`` tokens through the three kernels,
# held to the ``backend="plain"`` path within ``PATH_REL_TOL``
MESH_TRAIN_SHAPES = ((1, 4), (2, 2))
MESH_TRAIN_STEPS = 3
MESH_TRAIN_LR = 3e-4
MESH_TRAIN_LOSS_TOL = 1e-5
MESH_TRAIN_GNORM_TOL = 1e-4
MESH_TRAIN_TREE_TOL = 1e-4
MESH_TRAIN_GEN = 8
# the classes a train step's bytes are predicted in
MESH_TRAIN_CLASSES = ("param_gather", "grad", "exchange", "tp")


def mesh_train_key(shape) -> str:
    return f"train-{shape[0]}x{shape[1]}"


def mesh_train_setup(shape, **kw):
    """``launch.train.setup``'s run of (l) at ``shape``: one card (the
    fold, at P = the model size) or a rank (``mesh=``)."""
    from repro_torch.launch import train as TL
    return TL.setup(ARCH, seq_shards=shape[1], mode="prism", cr=CR,
                    lr=MESH_TRAIN_LR, steps=MESH_TRAIN_STEPS, seed=0,
                    n_layers=MESH_ENGINE_DEPTH, **kw)


def train_step_bytes(cfg, params, shape, batch, seq, prism, hp) -> dict:
    """The bytes a rank of a (data, model) mesh of ``shape`` sends in one
    train step, by class, exactly, from the rules: for an attention-only
    decoder with a tied table and learned or rotary positions.  Per
    layer, the FSDP gather of its leaves (``gather_tree``: one gather
    over ``data`` of the leaves it cuts, one over ``model`` of the
    ``fsdp2d`` ones), twice under remat (``param_gather``), and its
    reduce-scatter in the backward (``grad``); the exchange's gather of
    the means (PRISM) or rows (Voltage), twice under remat, and its
    reduce-scatter (``grad``).  A vocab-sharded table: the token ids'
    gather (int64) and the lookup's psum_scatter (``tp``), whose
    backward gathers (``grad``); each loss chunk's activation and label
    gathers and its three psums (``tp``; the activations' reduce-scatter
    and two psums in the backward, ``grad``).  The metrics' psum of two
    f32 (``tp``), ``GradReduce``'s psum of each axis set's leaves and the
    clip's norm psum (``grad``), and after AdamW each axis's gather of
    the slices its m/v cut further (``param_gather``).  A gather of s
    bytes over n ranks sends (n - 1)·s, a psum 2·(n - 1)·s / n, a
    reduce-scatter of s (n - 1)·s / n."""
    import math
    from repro_torch.models.transformer import layer_blocks
    from repro_torch.sharding.rules import (GradReduce, opt_state_specs,
                                            param_specs, tree_paths)
    if set(cfg.block_kinds) != {"attn"} or not cfg.tie_embeddings \
            or cfg.pos not in ("learned", "rope"):
        raise ValueError(f"{cfg.name}: train_step_bytes counts tied "
                         "attention decoders only")
    axes = dict(zip(("data", "model"), shape))
    data, model = shape
    world = data * model
    rules = param_specs(params, axes, cfg.vocab_size)
    b, n, d = batch // data, seq // model, cfg.d_model
    out = dict.fromkeys(MESH_TRAIN_CLASSES, 0)

    def gather(ranks, nbytes):
        return (ranks - 1) * nbytes

    def psum(ranks, nbytes):
        return 2 * (ranks - 1) * nbytes // ranks

    def local(t, rule):
        return t.numel() // math.prod(axes[a] for a in rule.spec if a)

    def tree_gather(p, r):
        rs, ps = dict(tree_paths(r)), dict(tree_paths(p))
        s_data = sum(local(ps[k], rs[k]) for k in rs
                     if rs[k].gather_dim is not None)
        s_model = sum(local(ps[k], rs[k]) * data for k in rs
                      if isinstance(rs[k].gather_dim, tuple))
        return gather(data, 4 * s_data) + gather(model, 4 * s_model)
    remat = 2 if hp.remat else 1
    exchange = gather(model, 4 * b * d * (
        prism.with_(P=model).landmarks(seq) if prism.mode == "prism"
        else n))
    for (_, p), (_, r) in zip(layer_blocks(cfg, params),
                              layer_blocks(cfg, rules)):
        g = tree_gather(p, r)
        out["param_gather"] += remat * g
        out["grad"] += g + exchange
        out["exchange"] += remat * exchange
    if cfg.pos == "learned":
        g = tree_gather(params["pos_embed"], rules["pos_embed"])
        out["param_gather"] += g
        out["grad"] += g
    if rules["embed"]["table"].kind == "vocab":
        out["tp"] += gather(model, 8 * b * n) + gather(model, 4 * b * n * d)
        out["grad"] += gather(model, 4 * b * n * d)
        chunks = min(hp.loss_chunks, n)
        while n % chunks:
            chunks -= 1
        c = n // chunks
        out["tp"] += chunks * (gather(model, 4 * b * c * d)
                               + gather(model, 8 * b * c)
                               + 3 * psum(model, 4 * b * model * c))
        out["grad"] += chunks * (gather(model, 4 * b * c * d)
                                 + 2 * psum(model, 4 * b * model * c))
    out["tp"] += psum(world, 8)
    red = dict(tree_paths(GradReduce.axes(rules, axes)))
    sizes = {path: local(t, r) for (path, t), (_, r) in zip(
        tree_paths(params), tree_paths(rules))}
    for key in set(red.values()):
        if key:
            out["grad"] += psum(math.prod(axes[a] for a in key), 4 * sum(
                s for path, s in sizes.items() if red[path] == key))
    out["grad"] += psum(world, 4)
    specs = dict(tree_paths(opt_state_specs(rules, params, axes,
                                            cfg.scan_split)))
    rule_of = dict(tree_paths(rules))
    for ax in axes:
        # a leaf's m/v cut over ``ax`` where its parameter is not
        cut = [path for path, s in specs.items()
               if ax in s and ax not in rule_of[path].spec]
        out["param_gather"] += gather(axes[ax], 4 * sum(
            sizes[path] // axes[ax] for path in cut))
    return out


def mesh_train_fold(torch, shape):
    """The fold of (l) at ``shape``: the one-card step at P = the model
    size over the whole batch, on the card -> its metrics a step, the
    first step's gradient (m / 0.1) and m and v after the last step, on
    the host, and the bytes a rank must send a step
    (``train_step_bytes``)."""
    from repro_torch.launch import train as TL
    from repro_torch.optim.adamw import tree_map
    run = mesh_train_setup(shape, device="cuda")
    want = train_step_bytes(run.cfg, run.params, shape, BATCH, PROMPT,
                            run.prism, run.hp)
    batches = TL.corpus_batches(BATCH, PROMPT)
    out = {"hist": [], "bytes": want}
    for i in range(MESH_TRAIN_STEPS):
        x, y = next(batches)
        run.params, run.opt, m = run.step(run.params, run.opt,
                                          {"tokens": x, "labels": y})
        out["hist"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grad"] = tree_map(lambda t: (t / 0.1).cpu(), run.opt["m"])
    out["m"] = tree_map(lambda t: t.cpu(), run.opt["m"])
    out["v"] = tree_map(lambda t: t.cpu(), run.opt["v"])
    return out


def tree_rel(got, want):
    """The largest error over the leaves of two port trees, each leaf's
    over max(1e-6, its largest |want|), and the leaf it is at; ``got``
    on the card, ``want`` on the host."""
    from repro_torch.sharding.rules import tree_paths
    w = dict(tree_paths(want))
    worst, at = 0.0, None
    for path, t in tree_paths(got):
        ref = w[path].to(t.device)
        err = float((t - ref).abs().max()) / max(1e-6, float(
            ref.abs().max()))
        if err > worst:
            worst, at = err, path
    return worst, at


def mesh_train_rank(torch, mesh, shape, fold, ckpt_dir):
    """One rank of (l) at ``shape``: ``launch.train.setup``'s run on the
    rank's block, ``MESH_TRAIN_STEPS`` steps of the launcher's batches,
    each timed (CUDA events, the card synchronised) and metered; the
    first step's gradient and the last step's m and v gathered whole and
    held to the fold's; the (1, 4) run's checkpoint saved (rank 0
    writes) -> metrics, bytes and ms a step, peak memory, errors, where
    the tensors live, the launches, and the whole parameters' leaf sums
    after the last step."""
    import time
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch import train as TL
    from repro_torch.optim.adamw import tree_map
    from repro_torch.runtime.train import gather_train_state
    from repro_torch.sharding.rules import tree_paths
    t0 = time.perf_counter()
    run = mesh_train_setup(shape, mesh=mesh)
    layout = run.step.layout
    batches = TL.corpus_batches(BATCH, PROMPT)
    out = {"hist": [], "sent": [], "ms": [], "coords": mesh.coords}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(mesh.device)
    LAUNCHES.clear()
    for i in range(MESH_TRAIN_STEPS):
        x, y = next(batches)
        mesh.meter.reset()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        run.params, run.opt, m = run.step(run.params, run.opt,
                                          {"tokens": x, "labels": y})
        ev[1].record()
        torch.cuda.synchronize()
        out["ms"].append(ev[0].elapsed_time(ev[1]))
        out["sent"].append({k: mesh.meter.sent[k]
                            for k in MESH_TRAIN_CLASSES})
        out["hist"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            _, whole = gather_train_state(layout, run.params, run.opt)
            out["grad_err"] = tree_rel(tree_map(lambda t: t / 0.1,
                                                whole["m"]), fold["grad"])
            del whole
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    out["launches"] = dict(LAUNCHES)
    params, opt = gather_train_state(layout, run.params, run.opt)
    out["m_err"] = tree_rel(opt["m"], fold["m"])
    out["v_err"] = tree_rel(opt["v"], fold["v"])
    out["sums"] = {k: float(t.double().sum()) for k, t in tree_paths(params)}
    out["devices"] = sorted({str(t.device) for tree in (run.params,
                             run.opt["m"], run.opt["v"])
                             for _, t in tree_paths(tree)})
    if ckpt_dir is not None:
        TL.save(run, ckpt_dir, MESH_TRAIN_STEPS)
    out["wall_s"] = time.perf_counter() - t0
    return out


def check_mesh_train(shape, runs, fold, card):
    """(l)'s checks on every rank of ``shape`` (see its constants) and its
    ``path`` line: bytes and ms a step, peak memory a rank."""
    key = mesh_train_key(shape)
    for rank, r in enumerate(runs):
        if r["devices"] != ["cuda:0"]:
            raise AssertionError(f"mesh/{key} rank {rank}: tensors on "
                                 f"{r['devices']}")
        if any(r["launches"].values()):
            raise AssertionError(f"mesh/{key} rank {rank}: launched "
                                 f"{r['launches']}, the step holds no "
                                 "kernel")
        for i, (h, f) in enumerate(zip(r["hist"], fold["hist"])):
            if h != runs[0]["hist"][i]:
                raise AssertionError(f"mesh/{key} step {i}: rank {rank}'s "
                                     f"metrics {h} differ from rank 0's")
            loss = abs(h["loss"] / f["loss"] - 1)
            gnorm = abs(h["gnorm"] / f["gnorm"] - 1)
            if loss > MESH_TRAIN_LOSS_TOL or gnorm > MESH_TRAIN_GNORM_TOL \
                    or h["lr"] != f["lr"] or h["moe_aux"] != 0.0:
                raise AssertionError(
                    f"mesh/{key} rank {rank} step {i}: {h} against the "
                    f"fold's {f} (loss {loss:.3e}, gnorm {gnorm:.3e})")
            if r["sent"][i] != fold["bytes"]:
                raise AssertionError(f"mesh/{key} rank {rank} step {i}: "
                                     f"bytes {r['sent'][i]}, the rules' "
                                     f"{fold['bytes']}")
        for name in ("grad_err", "m_err", "v_err"):
            if r[name][0] > MESH_TRAIN_TREE_TOL:
                raise AssertionError(
                    f"mesh/{key} rank {rank}: {name} {r[name][0]:.3e} at "
                    f"{r[name][1]} (limit {MESH_TRAIN_TREE_TOL})")
    emit("path", name=f"mesh/{key}", arch=ARCH, mesh=list(shape),
         layers=MESH_ENGINE_DEPTH, batch=BATCH, seq=PROMPT, cr=CR,
         mode="prism", steps=MESH_TRAIN_STEPS, lr=MESH_TRAIN_LR,
         loss=[h["loss"] for h in runs[0]["hist"]],
         fold_loss=[f["loss"] for f in fold["hist"]],
         gnorm=[h["gnorm"] for h in runs[0]["hist"]],
         fold_gnorm=[f["gnorm"] for f in fold["hist"]],
         grad_err=[r["grad_err"][0] for r in runs],
         m_err=[r["m_err"][0] for r in runs],
         v_err=[r["v_err"][0] for r in runs], tol=MESH_TRAIN_TREE_TOL,
         bytes_per_step=[r["sent"] for r in runs],
         predicted_bytes=fold["bytes"], ms_per_step=[r["ms"] for r in runs],
         peak_memory_bytes=[r["peak_memory_bytes"] for r in runs],
         wall_s=[r["wall_s"] for r in runs], clock="cuda_events",
         launches=[r["launches"] for r in runs], note=MESH_NOTE,
         nvidia_smi=card)


def serve_trained(torch, ckpt_dir, sums, card):
    """(l)'s last step: the (1, 4) run's checkpoint served on one card
    (``setup(..., checkpoint=)``), its parameters equal to the ranks'
    (each leaf's sum), prism prefill and prism decode through the three
    kernels, held to the ``backend="plain"`` path teacher-forced on its
    tokens.  Returns the launches."""
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.serve import setup
    from repro_torch.sharding.rules import tree_paths
    run = setup(ARCH, batch=BATCH, prompt_len=PROMPT, gen=MESH_TRAIN_GEN,
                seq_shards=SHARDS, decode_mode="prism", prefill="prism",
                cr=CR, n_layers=MESH_ENGINE_DEPTH, checkpoint=ckpt_dir)
    got = {k: float(t.double().sum()) for k, t in tree_paths(run.params)}
    if got != sums:
        raise AssertionError("mesh/train-serve: the restored parameters "
                             "differ from the ranks' trained ones")
    torch.cuda.synchronize()
    LAUNCHES.clear()
    tokens, logits, times = run.run()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    _, want, _ = replace(run, hp=replace(run.hp, backend="plain")).run(
        forced=tokens[:, :-1])
    err = rel_err(logits, want)
    missing = [k for k in TOL if not counts.get(k)]
    if missing or err > PATH_REL_TOL or not torch.isfinite(logits).all():
        raise AssertionError(f"mesh/train-serve: logits {err:.3e} from "
                             f"backend='plain' (limit {PATH_REL_TOL}); "
                             f"{missing} never launched")
    emit("path", name="mesh/train-serve", arch=ARCH,
         layers=MESH_ENGINE_DEPTH, batch=BATCH, prompt=PROMPT,
         gen=MESH_TRAIN_GEN, shards=SHARDS, pairing="prism-prism",
         checkpoint_step=MESH_TRAIN_STEPS, rel_err=err, limit=PATH_REL_TOL,
         prefill_ms=times["prefill_ms"],
         decode_ms_per_token=times["decode_ms_per_token"],
         clock=times["clock"], launches=counts, nvidia_smi=card)
    return counts


def drive_mesh(torch):
    """Phase 20: the mesh runs against their folds (see the module
    docstring).  Returns the launches of each run, summed over the
    ranks, keyed ``mesh/<run>/<pairing>``."""
    import tempfile
    import time
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import MESH_TIMEOUT, spawn
    t0 = time.perf_counter()
    card = nvidia_smi()
    folds, by_path = {}, {}
    for name, arch, shape, steps, pairings, tp, depth, prompt in MESH_RUNS:
        for pairing in pairings:
            folds[f"{name}/{pairing[0]}-{pairing[1]}"] = mesh_fold(
                torch, arch, shape, steps, pairing, depth, prompt)
            torch.cuda.empty_cache()
    engine_folds = {}
    for shape, prefill, mode, paged in MESH_ENGINE_RUNS:
        engine_folds[mesh_engine_key(shape, prefill, mode, paged)] = (
            mesh_engine_fold(torch, shape, prefill, mode, paged))
        torch.cuda.empty_cache()
    t_robust = time.perf_counter()
    robust_folds = {}
    for name, shape, mode, drive in MESH_ROBUST_RUNS:
        robust_folds[name] = mesh_robust_fold(torch, shape, mode, drive)
        torch.cuda.empty_cache()
    t_robust = time.perf_counter() - t_robust
    t_train = time.perf_counter()
    train_folds = {}
    for shape in MESH_TRAIN_SHAPES:
        train_folds[shape] = mesh_train_fold(torch, shape)
        torch.cuda.empty_cache()
    t_train = time.perf_counter() - t_train
    t_fold = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        fold_path = os.path.join(tmp, "folds.pt")
        torch.save(folds, fold_path)
        train_path = os.path.join(tmp, "train_folds.pt")
        torch.save(train_folds, train_path)
        ckpt_dir = os.path.join(tmp, "ckpt")
        t1 = time.perf_counter()
        ranks = spawn(mesh_rank_run, 1, 4, backend="gloo", device="cuda",
                      timeout=MESH_TIMEOUT,
                      args=(MESH_RUNS, fold_path, MESH_ENGINE_RUNS,
                            MESH_ROBUST_RUNS, train_path, ckpt_dir))
        t_ranks = time.perf_counter() - t1
        for shape in MESH_TRAIN_SHAPES:
            check_mesh_train(shape, [r[mesh_train_key(shape)]
                                     for r in ranks],
                             train_folds[shape], card)
            by_path[f"mesh/{mesh_train_key(shape)}"] = {}
        del train_folds
        t_serve = time.perf_counter()
        by_path["mesh/train-serve"] = serve_trained(
            torch, ckpt_dir, ranks[0][mesh_train_key((1, 4))]["sums"], card)
        t_serve = time.perf_counter() - t_serve
    for name, arch, shape, steps, pairings, tp, depth, prompt in MESH_RUNS:
        cfg = get_config(arch)
        if depth:
            cfg = replace(cfg, n_layers=depth,
                          blocks=cfg.block_kinds[:depth])
        for pairing in pairings:
            key = f"{name}/{pairing[0]}-{pairing[1]}"
            runs = [r[key] for r in ranks]
            need = () if set(cfg.block_kinds) <= set(CELLS) else (
                MESH_KERNELS + (("segment_means",) if "prism" in pairing
                                else ()))
            sent = []
            for rank, run in enumerate(runs):
                if run["devices"] != ["cuda:0"]:
                    raise AssertionError(f"{key} rank {rank}: tensors on "
                                         f"{run['devices']}")
                if run["rel_err"] > run["limit"]:
                    ref = "witness" if "witness_rel_err" in run else "fold"
                    raise AssertionError(
                        f"{key} rank {rank}: logits {run['rel_err']} from "
                        f"the {ref}, limit {run['limit']}")
                missing = [k for k in need if not run["launches"].get(k)]
                if missing:
                    raise AssertionError(f"{key} rank {rank}: {missing} "
                                         "never launched")
                if not need and any(run["launches"].values()):
                    raise AssertionError(f"{key} rank {rank}: launched "
                                         f"{run['launches']}, the path "
                                         "holds no kernel")
                want = mesh_bytes(cfg, run, shape, pairing, tp, prompt,
                                  steps)
                after = run["times"]["sent_after_prefill"]
                for cls, (pre, total) in (want or {}).items():
                    if after[cls] != pre or (
                            total is not None
                            and run["meter"]["sent"][cls] != total):
                        raise AssertionError(
                            f"{key} rank {rank}: {cls} bytes "
                            f"{after[cls]} after prefill, "
                            f"{run['meter']['sent'][cls]} in all; the "
                            f"protocol's {pre}, {total}")
                sent.append(after)
            by_path[f"mesh/{key}"] = {
                k: sum(r["launches"].get(k, 0) for r in runs)
                for k in set().union(*(r["launches"] for r in runs))}
            extra = {k: [r[k] for r in runs] for k in (
                "fold_rel_err", "witness_rel_err", "fold_witness_rel_err",
                "routing") if k in runs[0]}
            emit("path", name=f"mesh/{key}", arch=arch, mesh=list(shape),
                 decode_tp=tp, layers=cfg.n_layers, batch=BATCH,
                 prompt=prompt, cap=prompt + GEN, steps=steps,
                 n_seq=runs[0]["n_seq"],
                 rel_err=max(r["rel_err"] for r in runs),
                 limit=runs[0]["limit"],
                 tokens_checked=[r["tokens_checked"] for r in runs],
                 launches=[r["launches"] for r in runs],
                 exchange_bytes=[s["exchange"] for s in sent],
                 sent_after_prefill=sent,
                 sent=[r["meter"]["sent"] for r in runs],
                 prefill_ms=[r["times"]["prefill_ms"] for r in runs],
                 decode_ms_per_token=[r["times"]["decode_ms_per_token"]
                                      for r in runs],
                 clock=runs[0]["times"]["clock"], note=MESH_NOTE,
                 nvidia_smi=card, **extra)
    for shape, prefill, mode, paged in MESH_ENGINE_RUNS:
        key = mesh_engine_key(shape, prefill, mode, paged)
        by_path[f"mesh/{key}"] = check_mesh_engine(
            key, [r[key] for r in ranks], engine_folds[key], shape,
            prefill, mode, paged, card)
    for name, shape, mode, drive in MESH_ROBUST_RUNS:
        by_path[f"mesh/robust-{name}"] = check_mesh_robust(
            name, [r[f"robust-{name}"] for r in ranks], robust_folds[name],
            shape, mode, drive, card)
    robust_wall = sum(max(r[f"robust-{name}"]["wall_s"] for r in ranks)
                      for name, _, _, _ in MESH_ROBUST_RUNS)
    train_wall = sum(max(r[mesh_train_key(shape)]["wall_s"] for r in ranks)
                     for shape in MESH_TRAIN_SHAPES)
    emit("phase", name="mesh", seconds=time.perf_counter() - t0,
         fold_seconds=t_fold, ranks_seconds=t_ranks,
         robust_fold_seconds=t_robust, robust_rank_seconds=robust_wall,
         train_fold_seconds=t_train, train_rank_seconds=train_wall,
         train_serve_seconds=t_serve,
         backend="gloo",
         ranks=4, device="cuda:0", collectives=MESH_COLLECTIVES,
         collective_ms=[r["collectives"] for r in ranks], note=MESH_NOTE)
    return by_path


# the argument that makes this script run its late phases, named after
# it (keys of ``child_phases``), in a process of its own (``drive_apart``)
# ---------------------------------------------------------------------------
# the bf16 phase (run apart): the serving paths with bf16 weights
# ---------------------------------------------------------------------------

# the cells: GPT-2 small at full depth (static in both pairings, then one
# engine run), Yi-6B (GQA 8, head dim 128: the tile route) and Gemma 7B
# (head dim 256) on their first BF16_DEPTH layers, static in both
# pairings; all at full width, weights from init(..., dtype=
# torch.bfloat16), seed 0.  BF16_DEPTH and BF16_REF_STEPS are the time
# budget's cuts, in order: with Yi-6B and Gemma 7B at their STATIC_DEPTH
# (8) and the plain and witness runs at GEN - 1 steps the script took
# 1,124.7 s of its 1,200 on one H100 host (850.7 s on another)
BF16_DEPTH = 4
BF16_CELLS = ((ARCH, None), (LLAMA, BF16_DEPTH), (GEMMA7, BF16_DEPTH))
BF16_ENGINE = ("packed", "prism", True)          # prefill, mode, paged
# E(run) = max |logits - witness| / max |witness|, the witness the f32
# plain path on the same bf16 weights widened (exact): a run through the
# kernels may lie at most E_FACTOR x the bf16 plain path's E + E_FLOOR
# from it, teacher-forced on the kernel run's tokens
BF16_E_FACTOR, BF16_E_FLOOR = 1.5, 1e-3
# tokens equal the bf16 plain path's where its top-2 gap exceeds this
# share of its largest |logit| (the reference's bf16 tolerance)
BF16_TOKEN_GAP = 2e-2
# the teacher-forced steps of the plain and witness runs (the kernel run
# takes GEN - 1)
BF16_REF_STEPS = 16


def bf16_agree(torch, tokens, logits, ref, wit, what):
    """The bf16 rule on one run: E(kernels) <= BF16_E_FACTOR x E(plain) +
    BF16_E_FLOOR against the witness, over the steps the references
    took, and the greedy tokens the plain run's where its gap is clear.
    ``tokens`` (B, steps), ``logits``, ``ref``, ``wit`` (steps, B, V).
    Returns the record."""
    n = ref.shape[0]
    e_k, e_p = rel_err(logits[:n], wit), rel_err(ref, wit)
    if e_k > BF16_E_FACTOR * e_p + BF16_E_FLOOR:
        raise AssertionError(f"{what}: E(kernels) {e_k:.3e} > "
                             f"{BF16_E_FACTOR} x E(plain) {e_p:.3e} + "
                             f"{BF16_E_FLOOR}")
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > BF16_TOKEN_GAP * float(
        ref.abs().max())
    if (tokens[:, :n].T[clear] != ref.argmax(-1)[clear]).any():
        raise AssertionError(f"{what}: greedy tokens differ where the bf16 "
                             "plain path's top-2 gap is clear")
    return {"e_kernels": e_k, "e_plain": e_p, "steps_checked": n,
            "tokens_checked": int(clear.sum()), "tokens_total": clear.numel(),
            "e_factor": BF16_E_FACTOR, "e_floor": BF16_E_FLOOR,
            "token_gap": BF16_TOKEN_GAP}


def weight_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def bf16_static(torch, arch, cfg, params, wit_params, pairing):
    """One static pairing with bf16 weights: a warm-up, the counted run
    through the kernels (every attention and decode launch of the bf16
    instances: ``.bf16``), its bf16 plain twin and the f32 witness
    teacher-forced on its tokens (``bf16_agree``), then the same call's
    f32 weights through the kernels for the times beside it.  Returns
    (record, launches)."""
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.serve import setup
    prefill_mode, mode = pairing
    n_attn = cfg.n_layers

    def static(weights, backend, gen=GEN):
        run = setup(arch, batch=BATCH, prompt_len=PROMPT, gen=gen,
                    seq_shards=SHARDS, decode_mode=mode, cr=CR,
                    device="cuda", params=weights, backend=backend,
                    prefill=prefill_mode)
        run.cfg = cfg
        return run
    run = static(params, "auto")
    run.run()                                             # warm-up
    torch.cuda.synchronize()
    LAUNCHES.clear()
    tokens, logits, times = run.run()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    steps = n_attn * (GEN - 1)
    check_launches(f"bf16/{arch}/static/{mode}", counts, {
        "prism_flash_attention": n_attn,
        "prism_flash_attention.bf16": n_attn,
        "segment_means": n_attn if mode == "prism" else 0,
        "flash_decode_stats": steps, "flash_decode_stats.bf16": steps,
        "flash_decode_stats.kv_bf16": steps})
    forced = tokens[:, :BF16_REF_STEPS]
    _, ref, _ = static(params, "plain", BF16_REF_STEPS + 1).run(forced)
    _, wit, _ = static(wit_params, "plain", BF16_REF_STEPS + 1).run(forced)
    rec = bf16_agree(torch, tokens, logits, ref, wit,
                     f"bf16/{arch}/static/{prefill_mode}+{mode}")
    del ref, wit
    _, _, t32 = static(wit_params, "auto").run()
    return {**rec, "prefill_ms": times["prefill_ms"],
            "decode_ms_per_token": times["decode_ms_per_token"],
            "f32_prefill_ms": t32["prefill_ms"],
            "f32_decode_ms_per_token": t32["decode_ms_per_token"],
            "launches": counts}, counts


def bf16_engine(torch, cfg, params, wit_params):
    """GPT-2 small's engine run with bf16 weights (``BF16_ENGINE``): its
    cache f32, as the reference's engine makes it; the decode kernel's
    launches take the bf16 query of layer 0 (``.bf16``) over the f32
    cache (no ``.kv_bf16``); its bf16 plain twin and the f32 witness
    teacher-forced on its tokens (``keep_logits``) for each request's
    first ``BF16_REF_STEPS`` + 1 tokens, held by ``bf16_agree`` over
    every request's rows."""
    prefill, mode, paged = BF16_ENGINE
    prompts = engine_trace(cfg.vocab_size)
    eng, out, log, counts, wall = run_engine(torch, cfg, params, prefill,
                                             mode, paged, prompts)
    dtypes = {str(t.dtype) for c in eng.kv_cache.storage for t in c.values()}
    if dtypes != {"torch.float32"}:
        raise AssertionError(f"bf16/engine: cache leaves {dtypes}, the "
                             "reference's engine makes f32")
    if not counts.get("flash_decode_stats.bf16") or counts.get(
            "flash_decode_stats.kv_bf16"):
        raise AssertionError(f"bf16/engine: launches {counts}")
    if len(out) != ENGINE_REQUESTS:
        raise AssertionError(f"bf16/engine: {len(out)} requests finished")
    rids = sorted(out)
    ref = dict(forced=out, gen=BF16_REF_STEPS + 1, backend="plain")
    _, _, p_log, _, _ = run_engine(torch, cfg, params, prefill, mode, paged,
                                   prompts, **ref)
    _, _, w_log, _, _ = run_engine(torch, cfg, wit_params, prefill, mode,
                                   paged, prompts, **ref)

    def rows(lg):                     # (GEN, requests, V), request-major
        return torch.stack([torch.stack(lg[r]) for r in rids], dim=1)
    tokens = torch.tensor([out[r] for r in rids], device="cuda")
    rec = bf16_agree(torch, tokens, rows(log), rows(p_log), rows(w_log),
                     "bf16/engine")
    return {**rec, **engine_record(eng, out, wall), "launches": counts,
            "cache_dtypes": sorted(dtypes)}, counts


def drive_bf16(torch):
    """The bf16 phase: ``BF16_CELLS`` on the static path in both
    pairings, then GPT-2's ``BF16_ENGINE`` run, each held to its bf16
    plain twin and the f32 witness by ``bf16_agree``.  Emits each run's
    prefill ms and decode ms a token beside the same call's f32 weights',
    and the weight bytes of both; returns the launches by path
    (``bf16/...``)."""
    import time
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import tree_map
    card = nvidia_smi()
    by_path = {}
    for arch, depth in BF16_CELLS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if depth is not None:
            cfg = replace(cfg, n_layers=depth, blocks=cfg.block_kinds[:depth])
        params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda", dtype=torch.bfloat16)
        wit = tree_map(lambda t: t.float(), params)
        for pairing in PAIRINGS:
            rec, counts = bf16_static(torch, arch, cfg, params, wit, pairing)
            by_path[f"bf16/{arch}/static/{pairing[1]}"] = counts
            emit("path", arch=arch, path="bf16", prefill=pairing[0],
                 mode=pairing[1], card=card, layers=cfg.n_layers,
                 batch=BATCH, prompt=PROMPT, gen=GEN, shards=SHARDS, cr=CR,
                 weight_bytes=weight_bytes(params),
                 f32_weight_bytes=weight_bytes(wit), **rec)
        if arch == ARCH:
            rec, counts = bf16_engine(torch, cfg, params, wit)
            by_path[f"bf16/{arch}/engine/{BF16_ENGINE[0]}/"
                    f"{BF16_ENGINE[1]}"] = counts
            emit("path", arch=arch, path="bf16/engine", card=card,
                 prefill=BF16_ENGINE[0], mode=BF16_ENGINE[1],
                 paged=BF16_ENGINE[2], layers=cfg.n_layers, **ENGINE,
                 requests=ENGINE_REQUESTS, gen=GEN, **rec)
        del params, wit
        torch.cuda.empty_cache()
        emit("phase", name=f"bf16/{arch}", seconds=time.perf_counter() - t0)
    return by_path


CHILD_ARG = "--phase-child"


def drive_apart(phases):
    """Late phases in one child process of this script (``CHILD_ARG``),
    its lines passed on and its last one, the launches of each run,
    returned.  Late in this long process the profiler dropped part of a
    window's device records in every try (phase 13: about 65 of an
    encode window's 724, one attention launch; the same window was whole
    in a fresh process, PERF.md §6), and the fillers that absorb those
    losses grow with the process's age: in one run on an H100 with
    phases 9-12 in the script's process they reached ``FILLERS_MAX`` a
    trace there, against at most 1,184 with those phases in a child.
    That run was slow from its first phase on, so it does not show how
    much time the child saves (PERF.md §4)."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        CHILD_ARG, *phases], capture_output=True,
                       text=True, timeout=900)
    sys.stderr.write(r.stderr[-20000:])
    lines = r.stdout.splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if r.returncode != 0 or not lines:
        print("\n".join(lines[-1:]), flush=True)
        raise RuntimeError(f"the process of {phases} exited "
                           f"{r.returncode}")
    return json.loads(lines[-1])["launches"]


def child_phases():
    """The phases ``drive_apart`` runs, by name: 9, Yi-6B; 10, Gemma 3
    1B on the static path; 11, OLMoE-1B-7B; 12, Gemma 7B; 13, the
    encoders; 14, PaliGemma 3B on the static path; 15, Command-R 35B;
    16, MusicGen-medium on the static path; 17, xLSTM 1.3B on the static
    path, voltage + exact; 18, Zamba2 2.7B on the static path; 19,
    training and the accuracy path; 20, serving over a mesh of ranks;
    bf16, the serving paths with bf16 weights (``drive_bf16``)."""
    return {LLAMA: lambda torch: drive_family(torch, LLAMA,
                                              LLAMA_ENGINE_RUNS),
            GEMMA: lambda torch: drive_static(torch, GEMMA, GEMMA_PROMPT),
            MOE: lambda torch: drive_family(torch, MOE),
            GEMMA7: lambda torch: drive_family(torch, GEMMA7),
            "encoders": drive_encoders,
            PALI: lambda torch: drive_static(torch, PALI),
            CMDR: lambda torch: drive_family(torch, CMDR),
            MUSICGEN: lambda torch: drive_static(torch, MUSICGEN),
            XLSTM: lambda torch: drive_static(torch, XLSTM,
                                              pairings=PAIRINGS[:1]),
            ZAMBA: lambda torch: drive_static(torch, ZAMBA),
            "train": drive_train,
            "mesh": drive_mesh,
            "bf16": drive_bf16}


def phase_child(torch, phases) -> int:
    """``phases`` in turn (``CHILD_ARG``), each model's weights freed
    before the next: the last line is the launches of each run."""
    from repro_torch.device import resolve_device
    resolve_device("cuda")                      # full-f32 matmuls, no TF32
    by_path = {}
    for phase in phases:
        torch.cuda.empty_cache()
        by_path.update(child_phases()[phase](torch))
    print(json.dumps({"launches": by_path}), flush=True)
    return 0


# phase 3 at the accuracy protocol's layouts: its char-LM's attention
# (4 heads of 32) over B 16 x 120 at CR 4, P 2, 3, 4, in the modes its
# scoring runs (duplicate runs prism's columns: ``ShardedPrismContext``);
# its segment means and fused augment (D 128) at every (P, CR) it scores
CHAR_MODES = ("prism", "prism_nodup", "voltage")
CHAR_SETTINGS = ((2, (1, 2, 4, 8)), (3, (1, 2, 4, 8)), (4, (1, 4)))


def check_charlm_kernels(torch, chk, timer):
    """The prefill kernel at head dim 32 (``attention_main``'s numbers),
    errors filed under ``prism_flash_attention/hd32``; the means kernel's
    two entries at D 128 (``charlm_means``), under ``segment_means/
    charlm``.  -> {"attention": {"P{p}/{mode}": times}, "segment_means":
    {"P{p}/CR4": times}}."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.models.transformer import attn_spec
    from repro_torch.sharding.context import ShardedPrismContext
    cfg = char_lm_config()
    both = attention_checker(chk, key="prism_flash_attention/hd32")
    gen = torch.Generator(device="cuda").manual_seed(41)
    out = {}
    for p in (2, 3, 4):
        for mode in CHAR_MODES:
            ctx = ShardedPrismContext(PrismConfig(P=p, cr=4.0, mode=mode),
                                      n_shards=p, backend="plain")
            x = ctx.shard(torch.randn(CHAR_BATCH, CHAR_SEQ, cfg.d_model,
                                      device="cuda", generator=gen))
            _, akv = ctx.augment(x, attn_spec(cfg))
            m = akv.x_hat.shape[1]

            def rnd(*shape):
                return 0.5 * torch.randn(*shape, device="cuda",
                                         generator=gen)
            q = rnd(x.shape[0], x.shape[1], cfg.n_heads, cfg.hd)
            k = rnd(akv.x_hat.shape[0], m, cfg.n_kv_heads, cfg.hd)
            v = rnd(akv.x_hat.shape[0], m, cfg.n_kv_heads, cfg.hd)
            g = akv.g if akv.g is not None else torch.ones(m, device="cuda")
            out[f"P{p}/{mode}"] = attention_main(
                torch, timer, both, mode, tag=f"charlm/P{p}",
                args=(q, k, v, g, akv.col_lo, akv.col_hi, akv.row_pos))
    return {"attention": out,
            "segment_means": charlm_means(torch, chk, timer, gen)}


def charlm_means(torch, chk, timer, gen):
    """Both entries of csrc/segment_means.cu at the char-LM's rows, x
    (B·P, 120 / P, 128): the means and the fused augment against their
    plain versions at every (P, CR) the protocol scores (L from
    ``PrismConfig.landmarks``: 120 / P at CR 1); timed at CR 4.  The
    library yardstick is ``mean(2)`` (and the expand-and-cat chain after
    it) where the segments are even, else none."""
    from repro_torch.core.protocol import PrismConfig
    from repro_torch.kernels.segment_means import (prism_augment_op,
                                                   segment_means_op)
    name, key = "segment_means", "segment_means/charlm"
    d = char_lm_config().d_model
    out = {}
    for p, crs in CHAR_SETTINGS:
        n_loc = CHAR_SEQ // p
        x = torch.randn(CHAR_BATCH * p, n_loc, d, device="cuda",
                        generator=gen)
        for cr in crs:
            L = PrismConfig(P=p, cr=float(cr)).landmarks(CHAR_SEQ)
            calls = {
                "": lambda: segment_means_op(x, L=L, backend="kernel"),
                "plain_": lambda: segment_means_op(x, L=L, backend="plain"),
                "augment_": lambda: prism_augment_op(
                    x, L=L, n_shards=p, backend="kernel"),
                "augment_plain_": lambda: prism_augment_op(
                    x, L=L, n_shards=p, backend="plain")}
            for tag in ("", "augment_"):
                case = f"charlm/P{p}/CR{cr}/L{L}/{tag or 'means_'}"
                chk.close(name, calls[tag](), calls[tag + "plain_"](),
                          case, key=key)
                chk.cases[name] += 1
            if cr != 4:
                continue
            b = x.shape[0]
            if n_loc % L == 0:
                s = n_loc // L

                def chain():
                    z = x.view(b, L, s, d).mean(2).reshape(b // p, p * L, d)
                    z = z[:, None].expand(-1, p, -1, -1).reshape(b, p * L, d)
                    return torch.cat([x, z], dim=1)
                calls["library_"] = lambda: x.view(b, L, s, d).mean(2)
                calls["augment_library_"] = chain
            t = {}
            for tag, fn in calls.items():
                t[tag + "ms"] = timer(fn)
                if "plain" not in tag and "library" not in tag:
                    t[tag + "device_ms"] = timer.device(fn)
            t.setdefault("library_ms", None)
            t.setdefault("augment_library_ms", None)
            t["bound_ms"], t["bound_by"] = bound_ms(
                nbytes(x) + b * L * d * 4, x.numel())
            t["augment_bound_ms"], t["augment_bound_by"] = bound_ms(
                nbytes(x) + b * (n_loc + p * L) * d * 4, x.numel())
            t["shape"] = {"x": list(x.shape), "L": L, "P": p}
            out[f"P{p}/CR{cr}"] = t
    return out


def charlm_row(name, t, chk):
    """A kernel's numbers at the char-LM's layouts (phase 3): the
    attention kernel's per head-dim-32 layout, or the means kernel's per
    P at CR 4; the largest error over every checked case and its share
    of the tolerance."""
    pick = lambda t: {k: t[k] for k in TIME_KEYS + (  # noqa: E731
        "library_note", "shape") if k in t}
    if name == "prism_flash_attention":
        out = {layout: pick(tm) for layout, tm in t["attention"].items()}
        key = name + "/hd32"
    elif name == "segment_means":
        out = {layout: dict(tm) for layout, tm in t["segment_means"].items()}
        key = name + "/charlm"
    else:
        return {"note": "the char-LM's scoring does not decode"}
    out["max_abs_err"] = chk.max_err.get(key, 0.0)
    out["tol_share"] = chk.tol_share.get(key, 0.0)
    return out


def encoder_row(name, t, chk, key):
    """A kernel's numbers at an encoder's layouts (``check_encoder_
    kernels``): per run the kernel's times, its plain version's, the
    bound and the library call's; the largest error there and its share
    of the tolerance.  The decode kernel has no encoder layout."""
    pick = lambda t: {k: t[k] for k in TIME_KEYS + (  # noqa: E731
        "library_note", "shape") if k in t}
    if name == "prism_flash_attention":
        out = {run: pick(tm) for run, tm in t["attention"].items()}
    elif name == "segment_means":
        out = {run: pick(tm) for run, tm in t["segment_means"].items()}
    else:
        return {"note": "encoders do not decode"}
    out["max_abs_err"] = chk.max_err.get(f"{name}/{key}", 0.0)
    out["tol_share"] = chk.tol_share.get(f"{name}/{key}", 0.0)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import time
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == [CHILD_ARG]:
        return phase_child(torch, sys.argv[2:])
    from repro_torch.kernels import build
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.configs import get_config

    smi = nvidia_smi()
    dev = resolve_device("cuda")                # full-f32 matmuls, no TF32
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    secs = build.build()
    ptxas = {name: [ln.strip() for ln in build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
             for name in build.LIBS}
    emit("build", seconds=secs, ptxas=ptxas)

    timer = Timer(torch)
    chk = Checker(torch)
    # the hd-32 layouts first: their dozen small cases each take a device
    # trace, which costs more as the process ages (PERF.md §4)
    t_char = check_charlm_kernels(torch, chk, timer)
    t_attn = check_attention(torch, chk, timer)
    t_means = check_segment_means(torch, chk, timer)
    t_dec = check_decode(torch, chk, timer)
    t_128 = check_head_dim_128(torch, chk, timer)
    t_256 = check_head_dim_256(torch, chk, timer)
    t_fam = {arch: check_family(torch, chk, timer, arch, tag, seed)
             for arch, (tag, seed) in FAMILY_TAGS.items()}
    t_enc = check_encoder_kernels(torch, chk, timer)
    t_bf16 = check_bf16_kernels(torch, chk, timer)
    emit("kernel", max_abs_err=chk.max_err, tol_share=chk.tol_share,
         worst_case=chk.worst, tol=TOL, cases=chk.cases,
         floor_ms=timer.floor(), attention=t_attn, segment_means=t_means,
         decode=t_dec, hd128=t_128, hd256=t_256,
         **{tag: t_fam[arch] for arch, (tag, _) in FAMILY_TAGS.items()},
         encoders=t_enc, charlm=t_char, bf16=t_bf16)

    t_phase = [t_start]

    def phase_done(name):
        """The seconds since the previous phase ended."""
        t_phase.append(time.perf_counter())
        emit("phase", name=name, seconds=t_phase[-1] - t_phase[-2])
    phase_done("kernel")
    params = T.init(get_config(ARCH),
                    torch.Generator(device=dev).manual_seed(0), dev)
    by_path = {f"static/{mode}": r["launches"]
               for mode, r in drive_path(torch, params).items()}
    phase_done("static")
    by_path.update(drive_ticks(torch, params))
    phase_done("ticks")
    engine_launches_by_path, engine_runs = drive_engine(torch, params)
    by_path.update(engine_launches_by_path)
    phase_done("engine")
    by_path.update(drive_robust(torch, params, engine_runs))
    phase_done("robust")
    by_path.update(drive_phase8(torch, params, engine_runs))
    phase_done("phase8")
    del params, engine_runs                     # GPT-2's weights and runs
    torch.cuda.empty_cache()           # the children need the card's memory
    by_path.update(drive_apart((LLAMA, GEMMA, MOE, GEMMA7)))  # phases 9-12
    by_path.update(drive_apart(("encoders", PALI, CMDR, MUSICGEN,
                                XLSTM)))                      # phases 13-17
    # phase 18, then the bf16 phase
    by_path.update(drive_apart((ZAMBA, "bf16")))
    by_path.update(drive_apart(("train",)))                   # phase 19
    by_path.update(drive_apart(("mesh",)))                    # phase 20

    main_t = {"prism_flash_attention": t_attn["prism"],
              "segment_means": t_means,
              "flash_decode_stats": t_dec["prism"]}
    extra = {"prism_flash_attention": ("voltage", t_attn["voltage"]),
             "flash_decode_stats": ("exact", t_dec["exact"])}
    rows = []
    llama = [path for path in by_path if path.startswith(LLAMA + "/")]
    gemma = [path for path in by_path if path.startswith(GEMMA + "/")]
    # every error key of a kernel: its main one, its bf16 and head-dim
    # cases
    keys = {name: [k for k in chk.max_err
                   if k == name or k.startswith(name + "/")]
            for name in TOL}
    for name in TOL:
        src, rep = SOURCES[name]
        t = main_t[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": rep,
               "launches": sum(c.get(name, 0) for c in by_path.values()),
               "launches_by_path": {path: c.get(name, 0)
                                    for path, c in by_path.items()},
               "max_abs_err": max(chk.max_err[k] for k in keys[name]
                                  if not k.endswith("/bf16")),
               "tol": list(TOL[name]),
               "tol_share": max(chk.tol_share[k] for k in keys[name]
                                if not k.endswith("/bf16")),
               "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if name in extra:
            tag, te = extra[name]
            row.update({f"{tag}_ms": te["ms"],
                        f"{tag}_plain_ms": te["plain_ms"],
                        f"{tag}_bound_ms": te["bound_ms"],
                        f"{tag}_library_ms": te["library_ms"]})
        if name == "flash_decode_stats":   # the tick paths' layouts
            for tag in ("chunk", "packed", "packed_prism"):
                row.update({f"{tag}_{k}": t_dec[tag][k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")})
            # the chunk layout per route (the path's call takes the tile
            # route), and both routes over the folded group sizes
            row.update({f"chunk_{k}": t_dec["chunk"][k] for k in (
                "tile_ms", "tile_device_ms", "row_ms", "row_device_ms",
                "library_folded_ms")})
            # the degraded step's configurations over the page pool
            for tag, td in t_dec["degraded"].items():
                row.update({f"degraded_{tag}_{k}": td[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "healthy_ms")})
            row["crossover"] = t_dec["crossover"]
            row["poisoned"] = t_dec["poisoned"]
            row["cases_by_route"] = t_dec["cases_by_route"]
            mq = name + ".mq"
            row["launches_mq"] = sum(c.get(mq, 0) for c in by_path.values())
            row["launches_mq_by_path"] = {path: c.get(mq, 0)
                                          for path, c in by_path.items()}
            # the page pool (the engine's paged cache): each layout, its
            # dense twin's time from this call, and the paged launches
            for tag, tp in t_dec["paged"].items():
                row.update({f"paged_{tag}_{k}": tp[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "gather_ms", "dense_ms",
                    "dense_device_ms")})
            pg = name + ".paged"
            row["launches_paged"] = sum(c.get(pg, 0)
                                        for c in by_path.values())
            row["launches_paged_by_path"] = {path: c.get(pg, 0)
                                             for path, c in by_path.items()}
        if name == "segment_means":        # bf16 and the fused augment
            row.update({k: v for k, v in t.items() if k != "shape"})
            row.update({"bf16_max_abs_err": chk.max_err[name + "/bf16"],
                        "bf16_tol": list(TOL_BF16)})
        else:
            row["device_ms"] = t["device_ms"]
        # the Llama family's layouts (Yi-6B: head dim 128, D 4096), with
        # their launches on phase 9's paths
        row["yi"] = family_row(name, t_128, chk, "hd128")
        row["yi"]["launches"] = sum(by_path[p].get(name, 0) for p in llama)
        if name == "flash_decode_stats":
            row["yi"]["launches_mq"] = sum(
                by_path[p].get(name + ".mq", 0) for p in llama)
            row["yi"]["launches_paged"] = sum(
                by_path[p].get(name + ".paged", 0) for p in llama)
        # Gemma 3 1B's layouts (head dim 256, D 1152), with their launches
        # on phase 10's paths
        row["gemma"] = gemma_row(name, t_256, chk)
        row["gemma"]["launches"] = sum(by_path[p].get(name, 0)
                                       for p in gemma)
        row["gemma"]["launches_by_path"] = {p: by_path[p].get(name, 0)
                                            for p in gemma}
        if name == "flash_decode_stats":
            row["gemma"]["launches_mq"] = sum(
                by_path[p].get(name + ".mq", 0) for p in gemma)
        if name == "prism_flash_attention":
            row["gemma"]["launches_window"] = sum(
                by_path[p].get(name + ".window", 0) for p in gemma)
        # OLMoE-1B-7B's, Gemma 7B's, PaliGemma's, Command-R's, MusicGen's
        # and Zamba2's layouts, with their launches on phases 11, 12, 14,
        # 15, 16 and 18's paths
        for arch, (tag, _) in FAMILY_TAGS.items():
            paths = [p for p in by_path if p.startswith(arch + "/")]
            row[tag] = family_row(name, t_fam[arch], chk, tag)
            row[tag]["launches"] = sum(by_path[p].get(name, 0)
                                       for p in paths)
            row[tag]["launches_by_path"] = {p: by_path[p].get(name, 0)
                                            for p in paths}
            if name == "flash_decode_stats":
                for sub in ("mq", "paged"):
                    row[tag]["launches_" + sub] = sum(
                        by_path[p].get(f"{name}.{sub}", 0) for p in paths)
        # xLSTM's path has no attention layer: no launch of any kernel
        paths = [p for p in by_path if p.startswith(XLSTM + "/")]
        row["xlstm"] = {"launches": sum(by_path[p].get(name, 0)
                                        for p in paths),
                        "launches_by_path": {p: by_path[p].get(name, 0)
                                             for p in paths}}
        # the encoders' layouts, with their launches on phase 13's paths
        for arch, (key, *_) in ENCODERS.items():
            paths = [p for p in by_path if p.startswith(arch + "/")]
            row[key] = encoder_row(name, t_enc[key], chk, key)
            row[key]["launches"] = sum(by_path[p].get(name, 0)
                                       for p in paths)
            row[key]["launches_by_path"] = {p: by_path[p].get(name, 0)
                                            for p in paths}
        # the char-LM's layouts (head dim 32), and the launches on phase
        # 19's runs: none in GPT-2's train steps, the scoring's
        paths = [p for p in by_path if p.startswith("train/")]
        row["charlm"] = charlm_row(name, t_char, chk)
        row["train"] = {"launches": sum(by_path[p].get(name, 0)
                                        for p in paths),
                        "launches_by_path": {p: by_path[p].get(name, 0)
                                             for p in paths}}
        # phase 20's runs over a mesh of 4 ranks, summed over the ranks
        paths = [p for p in by_path if p.startswith("mesh/")]
        row["mesh"] = {"launches": sum(by_path[p].get(name, 0)
                                       for p in paths),
                       "launches_by_path": {p: by_path[p].get(name, 0)
                                            for p in paths}}
        rows.append(row)
    # the bf16, mixed-dtype and head-dim 16 / 32 instances, each at its
    # main layout with every layout's times; the launches on the paths
    # (``.bf16``: a bf16 query or cache; ``.kv_bf16``: a bf16 cache)
    def total(key):
        return sum(c.get(key, 0) for c in by_path.values())
    ta, td = t_bf16["attention"], t_bf16["decode"]
    tol_dec = TOL["flash_decode_stats"]
    rows += [
        instance_row("prism_flash_attention.bf16", "prism_flash_attention",
                     ta["hd64/prism"], total("prism_flash_attention.bf16"),
                     chk, "prism_flash_attention/bf16", TOL_BF16_KERNEL,
                     {k: v for k, v in ta.items() if not k.startswith("f32")}),
        instance_row("prism_flash_attention.hd16", "prism_flash_attention",
                     ta["f32/hd16/prism"], 0, chk,
                     "prism_flash_attention/hd16",
                     TOL["prism_flash_attention"],
                     {"f32/hd16/prism": ta["f32/hd16/prism"]}),
        instance_row("flash_decode_stats.bf16", "flash_decode_stats",
                     td["hd64/exact"], total("flash_decode_stats.kv_bf16"),
                     chk, "flash_decode_stats/bf16", TOL_BF16_KERNEL,
                     {k: v for k, v in td.items() if k.startswith("hd")}),
        instance_row("flash_decode_stats.mixed", "flash_decode_stats",
                     td["mixed/packed"], total("flash_decode_stats.bf16")
                     - total("flash_decode_stats.kv_bf16"), chk,
                     "flash_decode_stats/mixed", tol_dec,
                     {k: v for k, v in td.items() if k.startswith("mixed")}),
        instance_row("flash_decode_stats.hd16_32", "flash_decode_stats",
                     td["f32/hd16/prism"], 0, chk,
                     "flash_decode_stats/hd16_32", tol_dec,
                     {k: v for k, v in td.items() if k.startswith("f32")})]
    rows[-1]["cases_by_route"] = t_bf16["cases_by_route"]
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
