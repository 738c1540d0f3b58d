#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (it builds the port's CUDA kernels from
``src/repro_torch/csrc`` into ``build/repro_torch``); without a card it
exits non-zero and prints no result. Phases, each raising on failure:

1. device and build: the card's name and power limit, every kernel built;
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (granite-3-8b: K=8, G=4, hd=128, page 16, tables
   with sentinels past each row's pages, rows at pos -1 whose output must
   be exact zeros, one 8,192-token row over a 512-column table and a
   window whose edge cuts a split; the bf16 attention kernel one launch per
   call; the int8 attention kernel, one launch per call too, on the same
   cases over int8 pools drawn over [-127, 127] with f32 scales; SGMV din
   4096, dout 4096/1024, rank 8, one launch per call, including the inputs
   ``sgmv_pallas`` accepts (ids in range or negative), those the JAX op
   takes by padding (T no multiple of block_t, fewer ids than blocks, the
   default block_t of 128), a block_t-256 prefill with a short last block,
   and ranks 16 and 12, dead rows exact +0.0; phase 13's shapes:
   deepseek-moe-16b's paged attention at K=16, G=1 (bf16 and int8 pools,
   a row at pos -1) and SGMV at din 2048, the router's dout 64 at decode
   and over a compacted prefill's flattened tokens, q/v at dout 2048;
   phase 15's: jamba-v0.1-52b's router LoRA at din 4096, dout 16, at
   decode and over a per-client prefill's 2 rows of a 256-token prompt;
   phase 17's: rwkv6-7b's channel-mix LoRA, cm_k at din 4096, dout 14336
   and cm_v at din 14336, dout 4096, at decode (8 rows) and over a
   per-client prefill's 4 rows of a 256-token prompt; phase 18's:
   whisper-small's paged attention at K=12, G=1, hd=64 (rows at pos -1),
   its dense slab [8, 512, 12, 64] (an idle row) and SGMV at din = dout =
   768 at decode and over an encoder's 2 x 1,500-frame and a decoder's 2 x
   64-token prefill blocks),
   fp32 at atol = rtol
   = 1e-5 (TF32 off) and bf16 at 2e-2 against the plain version run in
   fp32 on the same bf16 inputs; dense decode attention (split-KV and a
   combine) at granite's K=8, G=4, hd=128 over phase 9's layer slab
   [8, 512, 8, 128] at its decode positions (15 past phase 4's prompts),
   with and without a window, over T=4096 (one row at pos -1, whose output must be
   exact zeros; one case with a window), a prime T, T=32,768 in one row
   (128 splits) and a window whose edge cuts a split; flash attention at
   granite's H=32, K=8 (S=T=2048 causal, and non-causal cross
   S=512/T=2048), gemma2-27b's H=32, K=16 with its 4096 window at
   S=T=8192, and S > T with rows that see no key (exact zeros), each case
   in bf16 on the tensor-core entry point and in fp32 on the SIMT one, and
   stablelm-12b's hd 160 (causal, and cross non-causal) in both dtypes on
   the SIMT one, and whisper-small's hd 64 (1,500 frames, non-causal; a
   448-token causal decoder), hd 96, 256, 80 and 112 (a last partial
   column chunk of 32, 16 and 48) on the SIMT entry in both dtypes (each
   launch's entry checked by its counter); paged decode
   (bf16 and int8) also at page_block 64, 256 and 512, fewer pages per
   split; the ragged linear, rows
   past the live count exact +0.0, each launch's entry point checked by
   its counter: bf16 on the tensor cores at din 4096 / dout 12800 with a
   bias (n_live 1001 of 1024, and 700 of 2048 counted on the card), at
   4096 / 4096 with 1030 of 2048 live (each of the kernel's three tile
   widths runs), at edges no tile divides (1000 x 4104 x 1000, 999 live),
   at n_live 0, and
   on a column view of a granite ``up`` weight at offset 1024; bf16 on the
   SIMT kernel at 1000 x 4100 x 1001 and on the view at offset 4; every
   fp32 case on the SIMT kernel;
3. model wiring: granite-3-8b at full width, 2 layers, bf16 and int8
   caches, one compacted prefill and one decode step with the kernels and
   under ``blocks.plain_kernels()``, logits compared at 2e-2; the kernel
   pass runs under ``torch.cuda.set_sync_debug_mode("error")``, so neither
   step may make the host wait for the device (as far as that mode, a
   PyTorch prototype, detects syncs); then phase 9's dense layout (2
   layers, 4 clients x 2 slots, max_seq 512): a per-client prefill into
   each client's first slot and one masked decode tick over the 8 slot
   rows, with the kernels (the dense kernel 2 launches per layer, SGMV 2
   per layer per call) and under ``plain_kernels()``, logits at 2e-2;
4. serving at full size: granite-3-8b, 40 layers, bf16 random weights, 4
   LoRA clients, 8 staggered requests, greedy, with the kernels' launch
   counts checked per tick; then an 8-row decode tick timed unprofiled
   and traced once with torch.profiler (device activity only): device
   busy share, kernels per tick (no more than before the attention and
   SGMV kernels were split across blocks), top kernels by device time,
   the SGMV and attention kernels' device time per tick beside their aims;
4b. the same 8 requests over int8 KV pages (``kv_quant=True``) behind a
   ``PlacementRouter`` whose one slot holds 4 of the requests' int8
   charges but not all 8, so admission queues on the card: 40 int8
   attention launches and no bf16 ones per decode tick, the same first
   token per request as phase 4, the router's ledger conserved and empty
   after the drain; the same 8-row tick profile, beside phase 4's;
5. timings at the phase-4, 4b and 6 shapes: kernel (L2-cold and L2-warm,
   and the device time with the host's enqueue hidden behind a spin
   kernel, beside its aim for the int8 attention kernel and SGMV at decode
   and prefill), plain version, a library
   yardstick and the memory/compute bound (the dense decode kernel first
   held against its plain version on the timed inputs at 2e-2, its error
   in the kernel line's maximum); each granite-shape
   ragged-linear and bf16 flash launch must take the tensor cores; flash's
   and SDPA's max errors against the plain version;
6. the slice without a serving path: the port's public kernel ops and
   the §3.7 packed base executor. A ``BaseExecutor`` over phase 4's own
   granite-3-8b weights (40 layers x 7 projections, held as views) runs
   every (layer, projection) for 4 clients' bf16 segments of 37, 200, 64
   and 700 tokens (budget 1024), then of 1,030 tokens (budget 2048, past
   the live count 7 of 16 row tiles are dead): exactly one ragged-linear
   launch per call, on the tensor cores, every output held against
   ``frozen_dense`` at 2e-2, the pass timed between synchronisations; each
   pass runs again traced by torch.profiler (device activity only) for
   its device time in the ragged-linear kernels; then
   ``kernels.decode_attn`` on a dense [8, 4096, 8, 128] bf16 cache (two
   launches: split and combine) and ``kernels.flash_attn`` on
   [1, 4096, 32, 128] causal (one, on the tensor cores), held against
   their plain versions;
7. fine-tuning on the card, whose path runs none of the kernels (the
   JAX training forward reaches no Pallas kernel): 7a granite-3-8b's
   width, 2 layers, fp32, the compact multi-job step over 4 jobs of 2 x
   256 tokens against each job's ``make_baseline_train_step`` (losses at
   1e-4; adapters and AdamW moments at rtol 1e-4 with an atol of 1e-3 of
   each leaf's largest magnitude, at most 1e-4), then a padding row and a
   NaN-poisoned row that must commit nothing while the other rows equal
   the unpoisoned call bit for bit, and ``frozen_dense``'s dx against
   autograd with the weight its only saved tensor; 7b a ``FinetuneEngine``
   over phase 4's 40-layer base, 5 LoRA jobs (rank 8, q and v, 3 steps)
   behind a router whose slot makes the fifth wait: finite losses, the
   ledger conserved and empty, job 0's losses against its solo run at
   atol 2e-3 and its adapter's update (final minus initial) within 0.25
   of the solo run's in relative norm, tick
   times on the host clock and one tick traced (device activity only);
   7c the peak memory beyond the base of one step at 1 and 4 jobs, §3.6
   path and torch-like baseline (printed); 7d a ``SymbiosisEngine``
   serving phase 4's requests beside 4 jobs on the same base tensors:
   every greedy stream equal to phase 4's, every job's losses to 7b's,
   the launch counts to phase 4's (tick by tick);
8. mixed-method banks and shared-prefix pages on phase 4's base tensors
   (bf16 pools, page_block 16, max_seq 512): banks LoRA r8 (q, v), IA3
   (k, v, down) and prefix (16 tokens), 2 clients each, behind a router
   whose slot holds the bank charges and the requests' pages; each client
   sends its own 232-token template + 40, + 1, + 24 and + another 1
   tokens, 3 ticks apart, 16 new tokens greedy; a LoRA r16 (q, k, v, o)
   bank is admitted at tick 4 (its clients send template + 40 and + 1)
   and retired after the drain. ``debug=True`` audits conservation every
   tick; after the drain every refcount is 0, every page back in its
   owner's free list and the router ledger empty once the banks are
   released. The prefix hits, pages shared, copies on write and computed
   prompt tokens equal the counts the JAX engine gives for the same
   schedule (pinned from ``tests/test_torch_prefix_cache.py``); every
   published page equals its copy at publish when its last reference
   drops, and every copy-on-write page its source on the copied tokens;
   SGMV launches per decode tick or prefill batch equal the count derived
   from the registry (3 per layer, 9 once the r16 bank joins), paged
   attention one per layer, int8 none. The workload again with the IA3
   scales x 1.5: every other bank's stream and pool page bit for bit.
   Then, at granite's width with 2 layers, a suffix prefill over 14
   shared pages against the full prefill (fp32 at 1e-5, TF32 off; bf16
   at 2e-2) and an 8-row mixed decode step against each bank's
   single-method step (its rows bit for bit). Printed: the workload with
   ``prefix_cache=False`` (streams equal to the shared run's, and where
   one differs, the step and its top-2 logit gap), hit and miss prefill
   batch times, and an 8-row mixed decode tick profiled as phase 4's;
9. the dense KV layout and the masked bank-wide step on phase 4's base
   tensors and bank (4 LoRA clients x 2 slots, ``max_seq`` 512, phase 4's
   8 requests), launch counts checked tick by tick: 9a ``page_block=0``
   under each policy, the dense decode kernel 2 x 40 launches per decode
   tick (split and combine), paged attention none, SGMV 80 per decode
   tick and per per-client prefill; every request's stream equal bit for
   bit to it served alone by a fresh dense engine (a request that a
   ragged per-client prefill carried at a larger bucket than its own: to
   that ragged batch served alone, its own solo run printed); the streams
   printed against phase 4's; 9b ``compact_decode=False`` on phase 4's
   pages, 40 paged launches per decode tick, streams printed against
   phase 4's, and one all-active 8-row masked step against the compacted
   step on copies of the same caches, logits and pools bit for bit; 9c
   int8 dense caches, finite, no attention kernel (plain torch, as JAX);
   9d an 8-row dense tick and a masked paged tick with 2 of 8 slots
   active profiled as phase 4's, printed beside it. Phase 5 times the
   dense kernel at phase 9's slab too ([8, 512, 8, 128], positions 15
   past phase 4's prompts): the kernel line's timing, its launches phase
   9a's;
10. every PEFT method fine-tunes on phase 4's base tensors, and tenants'
   state survives a crash. 10a at granite's width, 2 layers, fp32: the
   compact step over an IA3 bank (k, v, down) and a prefix bank (16
   tokens, q, v), 4 rows each, every row against its solo step (7a's
   tolerance), a padding and a NaN row committing nothing, bit for bit;
   per method ``make_multi_client_train_step`` against the compact step at
   the same hyperparameters (7a's tolerance; bit for bit printed) and
   ``make_mixed_step`` against its train and decode halves run apart, bit
   for bit, every launch count set to 0 just before it and read just
   after (the dense decode kernel 2 per layer, SGMV 2 per layer for LoRA,
   nothing else), and its decode half's logits and caches against the
   decode step under ``plain_kernels()`` at 1e-5 (8 rows, T 64, fp32: the
   kernels at the shape this path gives them; no launch in that pass);
   10b a ``FinetuneEngine(debug=True)`` at full size with 2 LoRA r8, 2 IA3
   and 2 prefix jobs of 2 x 256 tokens, 3 steps each: every job's losses
   and adapter update against its solo run (7b's tolerances), tick times, one
   tick per bank timed and traced, and the peak memory beyond the base of
   one step at 1 job per method beside ``job_hbm_bytes``' charge
   (printed); 10c the engine killed after 2 ticks and resumed by a fresh
   engine from ``engine_state()`` through a CRC-framed blob (a newer copy
   with a flipped byte skipped): every job's losses, adapter and AdamW
   state bit for bit the uninterrupted run's; an IA3 job poisoned to NaN
   at its third batch quarantined with its last clean state in
   ``quarantine_dir``, restored bit for bit; 10d a ``SymbiosisEngine``
   serving phase 4's 8 requests beside the six jobs: every stream and
   launch count phase 4's, every job's losses, adapter and AdamW state
   10b's bit for bit;
11. tenants' faults stay contained and crashes lose nothing, on phase 4's
   base and bank (``debug=True`` audits every tick). 11a serves phase 4's
   8 requests and one late request per client, first over the clean bank,
   then with client 3's LoRA B rows on one layer NaN (a copy), admission
   attempts 1 and 4 failing (``AllocHook``), client 0's first prompt
   delivered by a stream that errors once and client 3's last by one
   that runs dry: the hook fires twice, the stream is fetched twice,
   client 3 ends quarantined holding no slot and its later submit is
   refused, the pools and prefix refs are whole after the drain, the
   launch counts are checked tick by tick in each run, and every
   survivor's stream equals the clean run's bit for bit where both runs
   carried it at the same shapes and, always, a fault-free replay at the
   faulted run's shapes (each differing stream printed with its first
   step, top-2 logit gap and shapes); 11b phase 4's engine killed after 3
   ticks and resumed from an ``engine_state`` blob by a fresh engine: the
   streams bit for bit phase 4's and the launches before plus after the
   kill phase 4's, then the same over int8 pages behind phase 4b's router
   (a fresh router re-charged, empty after the drain); blob bytes, save
   and load seconds printed; 11c a ``SymbiosisEngine`` of the 8 requests
   and 2 LoRA jobs checkpointed after 4 ticks, a newer corrupt copy
   skipped by ``restore``: streams, losses, adapters and AdamW states bit
   for bit the uninterrupted service's; 11d the fine-tuning charge
   (``job_charge_bytes``) beside the peaks of 7c and 10b, none below;
12. tick-level telemetry (``repro_torch.obs``) on both engines and the
   chaos sweep, on phase 4's base and bank. 12a phase 4's 8 requests in
   four unsynchronised runs in turns (off, on, on, off), every tick under
   ``torch.cuda.set_sync_debug_mode("warn")``: every stream and the
   launches tick by tick equal to phase 4's, the synchronising calls per
   tick (the warnings counted) equal in all four, 8 admit and 8 retire
   events, the built steps and buckets equal; the median service tick
   without admission, a decode tick's host time by span, telemetry's host
   microseconds per span, decode row and event, each span's and each
   client's latency percentiles; then off and on over int8 pages behind
   phase 4b's router (against 4b) and on the dense layout (against 9a):
   streams, launches per tick and syncs per tick; 12b ``telemetry.jsonl``
   and ``metrics.prom`` accepted by ``python -m repro_torch.obs --check``;
   12c a two-tick profiler capture on a fresh engine: ``capture_start`` /
   ``capture_stop`` and a Chrome trace holding every serving span and the
   paged attention and SGMV kernels; 12d a ``FinetuneEngine`` of 2 LoRA
   jobs with telemetry against one without, bit for bit, and a
   ``SymbiosisEngine`` with one shared ``Obs`` beside phase 4's requests
   (streams phase 4's, losses the engine's alone, the merged feed in
   sequence order); 12e how far a job's bits depend on its bucket on the
   card (``faults.chaos.bank_rows_drift``: LoRA, IA3 and prefix jobs at the
   chaos config alone and at every position of buckets of 2, 4 and 8
   rows; printed, within ``P12_DRIFT_TOL``), then the chaos sweep
   (``faults.chaos.run_sweep``) on the card: at least 30 faults of 4
   kinds, the injected counts per scenario its CPU run's (where it is
   ``ok``), serving and symbiotic scenarios without error, the
   fine-tuning scenario's only errors bitwise drift within
   ``P12_DRIFT_TOL``, the paged kernel and SGMV launched;
13. the MoE and VLM families on the serving path, after phase 4's granite
   is freed. 13a deepseek-moe-16b at full width and depth (28 layers,
   layer 0 dense, 64 routed experts top-6 + 2 shared, drop-free), bf16
   random weights, 4 LoRA r8 tenants on q, v and the router, pages of 16,
   phase 4's 8 requests: per tick 28 paged attention and 83 SGMV launches
   (q and v on 28 layers, the router on 27 MoE layers) per decode tick and
   83 per prefill batch; every stream bit for bit equal to it served alone
   by a fresh engine (or, when a compacted prefill carried several, to
   that batch served alone); the run's peak memory beyond base, bank and
   caches; a 2-layer compacted prefill + decode with the kernels (no host
   sync) and under ``plain_kernels()``, logits at 2e-2; the requests over
   int8 pages and over the dense layout (launches tick by tick, streams
   printed against the bf16 pages'). 13b an 8-row decode tick timed and
   traced (kernels per tick, device-busy share), the routed experts of a
   tick (27 layers x 3 bmm over 8-row capacity buffers) against their
   byte bound, the 8 prompts' compacted prefill in one batch (time, peak
   memory), and the paged kernel at G=1 over 13a's pool and SGMV at the
   router's shape timed beside their plain versions, a library call and
   their bounds. 13c llava-next-mistral-7b at full width and depth (the
   image frontend stubbed): a client prefill of a 2,880-token image
   prefix + 64 text tokens and 8 decode steps with the kernels (finite,
   launches, positions), the same at 2 layers against ``plain_kernels()``
   at 2e-2, then phase 4's 8 text requests through the engine (its text
   backbone, as JAX's engine serves a VLM), launches tick by tick;
14. the MoE and VLM families fine-tune, on phase 13's bases (14a, 14b,
   14c, 14e on deepseek before it is freed, 14d on llava). 14a deepseek's
   width, 2 layers (dense, then MoE), fp32: a 2-row LoRA (q, v, router)
   and a 2-row IA3 bank's merged step, drop-free and at
   ``capacity_factor=1.25``, each row against its one-row run (losses,
   grads, per-row aux and dropped pairs printed; the drift within
   ``P12_DRIFT_TOL``); 14b a ``FinetuneEngine`` of 4 LoRA jobs (q, v,
   router; 2 x 256 tokens) at full size behind a router that holds a
   fifth back: the 4-row tick on the host clock (median of 5), one tick
   traced (device busy, kernels, the expert ``bmm`` share), peak memory
   beyond base and bank at 1 and 4 jobs under ``job_charge_bytes``, and
   1 job with the MoE body not recomputed, for the record; 14c a
   ``SymbiosisEngine`` of 13a's requests beside 2 jobs: streams bit for
   bit 13a's, 28 paged and 83 SGMV launches per decode tick checked tick
   by tick, each job bit for bit its ``FinetuneEngine`` run alone; then
   ``make_mixed_step`` at 2 layers (the dense kernel 2 per layer, its
   decode against ``plain_kernels()`` at 2e-2); 14d llava-next-mistral-7b
   at full size: 2 jobs of 1 x (2,880 image + 256 text) positions with
   ``remat``, 3 ticks, losses finite and falling, peak under the charge;
   14e a deepseek ``FinetuneEngine`` killed after a tick resumes from its
   blob bit for bit (blob bytes, save and load ms);
15. the hybrid family on the serving path, after phase 13's bases are
   freed: jamba-v0.1-52b at full width (d_model 4096, 32 heads / 8 KV,
   ED 8192, d_state 16, d_conv 4, 16 experts top-2 on the odd sublayers,
   vocab 65,536), cut to 2 of its 4 periods (16 of 32 layers: 2
   attention, 14 Mamba, 8 MoE, 6 dense MLP sublayers, ~26 B params, ~52
   GB bf16; its full depth, ~103 GB, fits no single card; two periods is
   the least depth whose page tables carry a group offset), random bf16
   weights, 4 LoRA r8 tenants on q, v and the router (one leaf per
   group). 15a pages of 16, ``max_seq`` 1024: phase 4's 8 requests and a
   512-token one (two 256-token scan chunks), per-request prefills at
   the true length; launches checked tick by tick (2 paged attention and
   12 ``sgmv`` per decode tick, 12 ``sgmv`` per prefill); every stream bit
   for bit its run alone on a fresh engine; a 300-token prompt refused
   with the reference's chunk error; the same requests with one slot per
   client (slot reuse), every stream its run alone. 15b the dense layout:
   the same, 4 dense-decode launches (split and combine on 2 sublayers)
   per tick. 15c a per-client prefill per client and a compacted decode
   of the 4 rows, with the kernels (no host sync) and under
   ``plain_kernels()``: at 16 layers bf16 the logits held at
   ``P15_PAIR_TOL`` (4 bf16 ulps of the largest logits), with their gap
   printed in ulps, and its two controls: (a) the same pair with the SGMV
   op alone on its plain version (printed), (b) after the bf16 base is
   freed, the 16 layers in fp32 on a jamba narrowed to d_model 1024 held
   at 1e-5; one period (8 layers) bf16 held at 2e-2, and one period (~53
   GB) fp32 at 1e-5 with TF32 off. 15d the caches' bytes on both layouts,
   built by ``init_client_caches`` and by an engine: the allocator's bytes
   held and requested over the construction and again after
   ``gc.collect`` and ``empty_cache``, the requested bytes equal to the
   tree, the tree to the router's charge per slot plus ``pos`` and
   ``block_tbl``, and what is held beyond the tree equal to the slack of
   the leaves' own allocator blocks (``memory_snapshot``), at most 1 MiB
   a leaf; 15a's peak beyond base, bank and caches, an 8-row decode tick
   timed and traced as phase 4's, a 256-token prefill beside the
   selective scan alone at its shapes (the scan's share), and ``sgmv`` at
   the router's shape (din 4096, dout 16, fp32, 8 rows) timed beside its
   plain version, a gather + ``bmm`` and its bound, as phase 13b times
   deepseek's;
16. the hybrid family fine-tunes on phase 15's base (no new kernel:
   JAX's training path reaches none; the serving side's two run in
   16c): 16a, on 15c's fp32 one-period base, a 2-row LoRA (q, v, router)
   and a 2-row IA3 (k, v, down) bank of 1 x 256 tokens, one compact
   train step each against each row's one-row run (losses and updated
   states within ``P12_DRIFT_TOL``); 16b a ``FinetuneEngine`` of 4 LoRA
   jobs of 1 x 256 tokens behind a router that holds a fifth back: tick
   ms on the host clock, one tick traced (device busy, kernels, the
   expert ``bmm`` share; the selective scan's share from its time alone
   at the tick's shapes, forward and forward + backward), the peak beyond
   base and bank at 1 and 4 jobs held below ``job_charge_bytes``, and at
   1 job with the scan's blocks not checkpointed (printed); 16c a
   ``SymbiosisEngine`` serving phase 15a's 8 requests beside 2 jobs:
   paged attention 2 and ``sgmv`` 12 per decode tick and 12 per prefill,
   tick by tick, every stream bit for bit 15a's, the jobs bit for bit
   their ``FinetuneEngine`` run alone; 16d a 2-job engine killed after 1
   of 3 ticks resumes from its blob bit for bit;
17. the RWKV family serves and fine-tunes, after phase 15's bases are
   freed: rwkv6-7b at full width and full depth (32 layers, 64 heads of
   64, d_ff 14336, vocab 65,536; 7.53 B params, ~15 GB bf16), random
   weights, 8 LoRA r8 tenants on q (as r), v and cm_k. Its path runs one
   kernel, ``sgmv`` (the wkv6 recurrence is plain PyTorch, as JAX's is
   plain ``lax.scan``). 17a a per-client prefill per client (64-256
   tokens) and a masked decode tick of the dense bank with the kernels (no
   host sync) and under ``plain_kernels()``, at 2 and 32 layers, bf16 and
   fp32 (TF32 off), the gaps printed in bf16 ulps of the logits: each pair
   held at twice its control (c), the same pair with ``sgmv`` on a plain
   version that sums din in two halves (another exact order), plus 4 bf16
   ulps of its largest logit (fp32: 1e-5); the 2-layer fp32 pair also at
   1e-5; at 32 layers bf16 control (a), ``sgmv`` alone on its plain
   version, bit for bit (the model amplifies a rounding difference with
   depth, JAX's as much). 17b 8 clients x 4 slots, 16 requests of 64, 128
   and 256 tokens, 32 new tokens each, the second wave taking freed slots:
   ``sgmv`` 96 launches per decode tick and per per-request prefill,
   checked tick by tick; every stream bit for bit its run alone on a fresh
   engine, the requests in a reused slot named; a 300-token prompt refused
   with the reference's chunk error; an 8-row decode tick timed and
   traced; the 128- and 256-token prefills beside the recurrence alone at
   their shapes; the state's bytes on the card against the router's charge
   per slot (34,078,720 B). 17c at 2 layers fp32, a 2-row LoRA and IA3 (k,
   v) bank's compact step against each row's one-row run (losses within
   ``P12_DRIFT_TOL``, states within 16x the drift of that one-row run with
   every base weight nudged one fp32 ulp); at full depth a
   ``FinetuneEngine`` of 4 LoRA jobs of 1 x 256 tokens behind a router
   that holds a fifth back (tick ms, one tick traced, the recurrence's
   share from its time alone, peaks at 1 and 4 jobs below
   ``job_charge_bytes``); a ``SymbiosisEngine`` serving 17b's first 8
   requests beside 2 jobs (streams 17b's, jobs their runs alone, bit for
   bit); a 2-job engine killed after 1 of 3 ticks resumed bit for bit. 17d
   ``sgmv`` at the channel mix's shapes timed beside its plain version, a
   gather + ``bmm`` and its bound;
18. the encoder-decoder family on the serving steps and in fine-tuning,
   after phase 17's base is freed: whisper-small at full width and depth
   (12 encoder + 12 decoder layers, d_model 768, 12 heads of 64, MHA, d_ff
   3072, 1,500 stub frames a row, vocab 51,865; 304.3 M params, ~0.6 GB
   bf16), random weights, 4 LoRA r8 tenants on q and v x 2 slots. JAX's
   serving engine passes no frames, so no engine admission serves it (the
   port refuses it, a stated departure): the per-client prefill here is
   the model's prefill of a client's 2 slot rows with their frames, every
   row's LoRA through SGMV, and the decode steps are the bank steps. Its
   path runs three kernels: the paged decode kernel (K 12, G 1, hd 64),
   the dense one and ``sgmv`` (din = dout = 768); the encoder's attention
   and cross-attention are plain PyTorch, as JAX's are plain einsums. 18a
   the per-client prefills and one 8-row decode tick on pages (the
   compacted step) and on dense rows (the masked step), with the kernels
   (no host sync) and under ``plain_kernels()``, launches checked: at 1 +
   1 layers bf16 at 2e-2 and fp32 at 1e-5; at 12 + 12 layers bf16 and fp32
   each gap held at ``P18_CONTROL`` x control (c)'s (the same pair with
   ``sgmv`` on ``sgmv_plain_split``) plus 4 bf16 ulps of the largest logit
   (bf16) or 1e-5 (fp32). 18b 8 decoder prompts of 4-64 tokens, each with
   its own frames, prefilled per client on pages (48 ``sgmv`` launches a
   client, nothing else), then compacted decode ticks until every row has
   its 6-16 new tokens (12 paged and 24 ``sgmv`` launches per tick, checked
   tick by tick); every client's streams bit for bit its rows decoded
   alone, the masked step bit for bit the compacted one, every cache
   tensor keeping its ``data_ptr``; the dense layout's streams (the dense
   kernel, 24 launches a tick) printed against the pages';
   ``make_multi_client_prefill`` with frames [4, 2, 1500, 768] over the
   dense bank and a multi-client decode tick, launches checked; an 8-row
   tick timed and traced; the tick's gather of the rows' cross caches
   (bytes and ms); the caches' allocator bytes per slot against the
   router's charge (55,296,000 + 36,864 x 128 B). 18c a ``FinetuneEngine``
   of 4 LoRA jobs of 2 x 128 decoder tokens (1,500 frames a row) behind a
   router sized by ``job_charge_bytes`` that holds a fifth back: tick ms,
   one tick traced, the encoder's share (its time alone at the tick's
   shapes), peaks at 1 and 4 jobs under the charge; 2-row IA3 and prefix
   banks at 1 + 1 layers fp32 against one-row runs (17c's rule). 18d a
   2-job engine killed after 1 of 3 ticks resumes bit for bit. 18e the
   paged kernel over 18b's pool, the dense kernel at [8, 512, 12, 64] and
   ``sgmv`` at decode and at an encoder and a decoder prefill's blocks,
   each timed beside its plain version, a library call and its bound.
19. activation privacy (§3.8) and the hot-path contracts
   (``repro_torch.analysis``) on phase 4's granite-3-8b base and bank,
   run after phase 12 (no new kernel: the private product is an add, the
   base product and a subtraction; the passes are host code). 19a client
   0's LoRA r8 (q, v) through ``make_client_ctx(privacy_noise=...)`` over
   ``attach_privacy``'s tree, 2 noise variants at scale 3.0 on q and v
   from a ``torch.Generator``: the ``_priv`` bytes per client against
   40 x 2 x (4,096 + 1,024) x 2 B, ``noise_effect``'s precompute ms, a
   [2, 128] forward's ms plain and private in turns, and the bf16 logits'
   gap private against plain held at ``P19_CONTROL`` x the plain bf16
   logits' gap from fp32 plus 4 bf16 ulps; a paged prefill of phase 4's
   first prompt and 16 greedy decode steps through the private context
   (40 paged launches a step, nothing else), held the same way against
   the plain run fed its tokens; at 2 layers fp32, private against plain
   at JAX's 2e-3. 19b phase 4's 8 requests, an ``admit_bank`` of one more
   LoRA client with one request and ``retire_bank`` under
   ``tracecount.guard`` with telemetry: 0 violations, every compile's
   (family, key) in ``trace_domain()``, ``jit_compiles_total`` equal to
   the guard's count, streams and launches per tick phase 4's; the
   compile events and the host us of one ``dispatch`` (a decode tick's).
   19c ``runner.run_all`` over ``all_targets()`` on the card (tiny
   configs, the kernels), then at full width with the kernels: client
   isolation on the compacted decode step (8 rows, 4 clients, victim 0),
   row isolation on phase 7a's 2-layer compact train step, and the
   in-place and frozen-base checks across one decode and one train step.

The second-to-last line is the JSON kernel summary, the last
``{"ok": true, "device": {...}}``. Weights are random, drawn from seeds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint import (load_engine_state,  # noqa: E402
                                    restore_job_state, save_engine_state)
from repro_torch.common.hardware import H100  # noqa: E402
from repro_torch.common.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.config import (AdapterConfig, FinetuneConfig,  # noqa: E402
                                ServeConfig, TrainConfig)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import adapters, symbiosis  # noqa: E402
from repro_torch.core.base_executor import BaseExecutor, _bucket  # noqa: E402
from repro_torch.core.frozen_linear import frozen_dense  # noqa: E402
from repro_torch.core.engine_spec import BankSpec, EngineSpec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.core.virtlayer import (attach_privacy,  # noqa: E402
                                        make_bank_ctx, make_client_ctx,
                                        make_compact_ctx)
from repro_torch.core import privacy  # noqa: E402
from repro_torch.analysis import (aliasing, runner, taint,  # noqa: E402
                                  tracecount)
from repro_torch.data import SyntheticLMDataset, frontend_stub  # noqa: E402
from repro_torch.models import blocks, get_model  # noqa: E402
from repro_torch.models import hybrid as hybrid_lib  # noqa: E402
from repro_torch.models import mamba as mamba_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import rwkv as rwkv_lib  # noqa: E402
from repro_torch.optim import AdamWState, adamw_init  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.router import PlacementRouter, Slot  # noqa: E402
from repro_torch.faults import chaos  # noqa: E402
from repro_torch.faults.plan import (AllocHook,  # noqa: E402
                                     FaultyRequestStream, corrupt_flip)
from repro_torch.obs import Obs, write_files  # noqa: E402
from repro_torch.training import (FinetuneEngine, FinetuneJob,  # noqa: E402
                                  SymbiosisEngine, job_activation_bytes,
                                  job_charge_bytes, job_hbm_bytes,
                                  make_job_stream)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
SENTINEL = 1 << 30
DEV = "cuda"
# the kernel modules (the packages re-export ops functions of the same name)
da = importlib.import_module("repro_torch.kernels.decode_attn.decode_attn")
sg = importlib.import_module("repro_torch.kernels.sgmv.sgmv")
fa = importlib.import_module("repro_torch.kernels.flash_attn.flash_attn")
rl = importlib.import_module("repro_torch.kernels.ragged_linear.ragged_linear")
KERNELS = {   # name: (launch wrapper, source, the TPU kernel it replaces)
    "paged_decode_attn": (da.paged_decode_attn_cuda, da.SOURCE, da.REPLACES),
    "paged_decode_attn_quant": (da.paged_decode_attn_quant_cuda,
                                da.QUANT_SOURCE, da.QUANT_REPLACES),
    "sgmv": (sg.sgmv_cuda, sg.SOURCE, sg.REPLACES),
    "decode_attn": (da.decode_attn_cuda, da.SOURCE, da.DENSE_REPLACES),
    "flash_attn": (fa.flash_attn_cuda, fa.SOURCE, fa.REPLACES),
    "ragged_linear": (rl.ragged_linear_cuda, rl.SOURCE, rl.REPLACES),
}


def reset_counts():
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
    for counts in (rl.ragged_linear_cuda.by_entry, fa.flash_attn_cuda.by_entry):
        for entry in counts:
            counts[entry] = 0


def read_counts():
    return {name: w.launches for name, (w, _, _) in KERNELS.items()}


def launch_count(name):
    return KERNELS[name][0].launches


# what the serving runs of ``drive`` and ``p9_serve`` launched, tick by tick,
# and the streams ``p9_serve`` served, by label (phase 12 compares its runs
# with telemetry against them)
TICK_LAUNCHES = {}
SERVED = {}


def log(msg):
    print(msg, flush=True)


def compare(what, got, want, tol):
    """Max |got - want|; raises unless |got - want| <= atol + rtol*|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                             f"{tol}, max abs err {float(err.max()):.3e}")
    return float(err.max())


def gen(seed):
    return torch.Generator(device=DEV).manual_seed(seed)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(B, K, G, hd, blk, nb, seed, pos=None, dtype=torch.float32):
    g = gen(seed)
    P = B * nb + 7
    q = torch.randn((B, K, G, hd), generator=g, device=DEV)
    pk = torch.randn((P, blk, K, hd), generator=g, device=DEV)
    pv = torch.randn((P, blk, K, hd), generator=g, device=DEV)
    tbl = torch.randperm(P, generator=g, device=DEV)[:B * nb].reshape(B, nb)
    if pos is None:
        pos = torch.randint(0, nb * blk, (B,), generator=g, device=DEV)
    else:
        pos = torch.tensor(pos, device=DEV)
    cols = torch.arange(nb, device=DEV)[None, :]
    tbl = torch.where(cols > (pos // blk)[:, None], SENTINEL + 3 * P, tbl)
    return (q.to(dtype), pk.to(dtype), pv.to(dtype), tbl.to(torch.int32),
            pos.to(torch.int32))


PAGED_CASES = {   # (B, K, G, hd, blk, nb, window, pos)
    "granite_pos0_page_edges": (16, 8, 4, 128, 16, 32, 0,
                                [0, 15, 16, 31, 32, 47, 48, 100, 127, 128,
                                 200, 255, 256, 300, 400, 511]),
    "granite_one_row": (1, 8, 4, 128, 16, 32, 0, [271]),
    "granite_uneven_rows": (5, 8, 4, 128, 16, 32, 0, None),
    "granite_window": (8, 8, 4, 128, 16, 32, 100, None),
    "g1_hd64": (6, 8, 1, 64, 16, 32, 0, None),
    "granite_pos_minus_one": (4, 8, 4, 128, 16, 32, 0, [-1, 40, -1, 300]),
    # one 8,192-token row over a 512-column table: many splits to merge
    "granite_one_row_8192": (1, 8, 4, 128, 16, 512, 0, [8191]),
    # pages longer than the tuned splits: the wrapper takes fewer pages per
    # split (one page of 512 tokens is one split)
    "granite_page_block_64": (4, 8, 4, 128, 64, 8, 0, [0, 63, 64, 511]),
    "granite_page_block_256": (3, 8, 4, 128, 256, 3, 40, [255, 256, 767]),
    "granite_page_block_512": (2, 8, 4, 128, 512, 2, 0, [511, 1000]),
    # window edges 7 and 39 tokens into a split of any power-of-two pages
    "granite_window_cuts_a_split": (3, 8, 4, 128, 16, 32, 70,
                                    [300, 108, 511]),
    # deepseek-moe-16b (phase 13): MHA, K=16, G=1 (a quarter of a block's
    # query heads live), at phase 13's decode positions and a row at -1
    "deepseek_g1_8rows": (8, 16, 1, 128, 16, 32, 0,
                          [79, 100, 159, 200, 255, 271, 64, 511]),
    "deepseek_g1_pos_minus_one": (5, 16, 1, 128, 16, 32, 0,
                                  [-1, 15, 16, 300, -1]),
    # whisper-small (phase 18): MHA, K=12, G=1, hd 64 over 18b's tables
    # (max_seq 128 in pages of 16), 15 past its 8 prompts, and rows at -1
    "whisper_k12_g1_hd64": (8, 12, 1, 64, 16, 8, 0,
                            [19, 79, 32, 55, 24, 48, 67, 40]),
    "whisper_pos_minus_one": (4, 12, 1, 64, 16, 8, 0, [-1, 3, 100, -1]),
}


def zeros_at_pos_minus_one(what, got, pos):
    """Rows at pos -1 attend nothing: exact +0.0."""
    dead = got[pos < 0]
    if dead.any() or torch.signbit(dead).any():
        raise AssertionError(f"{what}: a row at pos -1 is not exact zeros")


def check_paged(errs):
    for i, (name, (B, K, G, hd, blk, nb, window, pos)) in enumerate(
            PAGED_CASES.items()):
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            q, pk, pv, tbl, p = paged_case(B, K, G, hd, blk, nb, 100 + i, pos,
                                           dtype)
            before = launch_count("paged_decode_attn")
            got = da.paged_decode_attn_cuda(q, pk, pv, tbl, p, window=window)
            if launch_count("paged_decode_attn") != before + 1:
                raise AssertionError(f"paged_decode_attn {name}: not one "
                                     "launch")
            want = da.paged_decode_attn_plain(q.float(), pk.float(), pv.float(),
                                              tbl, p, window=window)
            torch.cuda.synchronize()
            e = compare(f"paged_decode_attn {name} {dtype}", got, want, tol)
            zeros_at_pos_minus_one(f"paged_decode_attn {name}", got, p)
            errs.append(e)
            log(f"[phase 2] paged_decode_attn {name:24s} {str(dtype):15s} "
                f"max_abs_err={e:.3e}")


def check_paged_quant(errs):
    """The int8 kernel on the same cases: int8 pools over the full
    [-127, 127] range, f32 per-head scales, q in fp32 and in bf16."""
    for i, (name, (B, K, G, hd, blk, nb, window, pos)) in enumerate(
            PAGED_CASES.items()):
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            q, _, _, tbl, p = paged_case(B, K, G, hd, blk, nb, 300 + i, pos,
                                         dtype)
            g = gen(400 + i)
            P = B * nb + 7
            pk, pv = (torch.randint(-127, 128, (P, blk, K, hd), generator=g,
                                    device=DEV, dtype=torch.int8)
                      for _ in range(2))
            ks, vs = (torch.rand((P, blk, K, 1), generator=g, device=DEV)
                      * 0.025 + 0.005 for _ in range(2))
            before = launch_count("paged_decode_attn_quant")
            got = da.paged_decode_attn_quant_cuda(q, pk, ks, pv, vs, tbl, p,
                                                  window=window)
            if launch_count("paged_decode_attn_quant") != before + 1:
                raise AssertionError(f"paged_decode_attn_quant {name}: not "
                                     "one launch")
            want = da.paged_decode_attn_quant_plain(q.float(), pk, ks, pv, vs,
                                                    tbl, p, window=window)
            torch.cuda.synchronize()
            e = compare(f"paged_decode_attn_quant {name} {dtype}", got, want,
                        tol)
            zeros_at_pos_minus_one(f"paged_decode_attn_quant {name}", got, p)
            if got.dtype != q.dtype:
                raise AssertionError(f"int8 attention returned {got.dtype} "
                                     f"for q in {q.dtype}")
            errs.append(e)
            log(f"[phase 2] paged_decode_attn_quant {name:24s} "
                f"{str(dtype):15s} max_abs_err={e:.3e}")


SGMV_CASES = {    # (T, block_t, dout, rank, ids[, din]), din 4096 if absent
    "decode_1row_q": (1, 1, 4096, 8, [2]),
    "decode_5rows_v": (5, 1, 1024, 8, [0, -1, 3, 9, 1]),
    "decode_16rows_q": (16, 1, 4096, 8, [0, 1, 2, 3, -1, 5, 1, 1, 0, 2, 3, 3,
                                         7, -1, 2, 0]),
    "decode_16rows_v": (16, 1, 1024, 8, [3, 2, 1, 0, 0, -1, 4, 1, 2, 2, 3, 1,
                                         0, 0, -1, 3]),
    "prefill_S128_q": (384, 128, 4096, 8, [1, -1, 9]),
    "prefill_S256_v": (512, 256, 1024, 8, [3, 0]),
    # what sgmv_pallas (unclamped index_map) accepts: ids in range or dead
    "pallas_ids_decode_8rows_q": (8, 1, 4096, 8, [0, 3, -1, 2, 1, -1, 3, 0]),
    "pallas_ids_prefill_S64_v": (256, 64, 1024, 8, [2, -1, 0, 3]),
    # what the JAX op takes by padding: T no multiple of block_t, fewer ids
    # than blocks (the rest dead), the default block_t of 128
    "t100_block32_last_short": (100, 32, 4096, 8, [1, 2, -1, 0]),
    "t64_block16_2_of_4_ids": (64, 16, 1024, 8, [3, 1]),
    "t300_default_block_1_id": (300, 128, 4096, 8, [2]),
    # the prefill shape in blocks of 256, the last one short
    "prefill_block256_short_last": (1000, 256, 4096, 8, [0, 1, 2, 3]),
    # rank 16 (the fast path's other rank) and 12 (the generic path)
    "rank16_decode_q": (8, 1, 4096, 16, [0, 1, 2, 3, 3, 2, -1, 0]),
    "rank16_prefill_v": (300, 128, 1024, 16, [1, 0, 2]),
    "rank12_decode_v": (5, 1, 1024, 12, [3, -1, 0, 1, 1]),
    "rank12_prefill_q": (200, 64, 4096, 12, [2, 0, -1, 1]),
    # deepseek-moe-16b (phase 13): d 2048; the router's LoRA (dout 64, its
    # input the fp32 hidden state) at decode and over a compacted prefill's
    # flattened [rows * S, d] tokens, one S-token block per row; q and v
    # (dout 2048) at decode
    "deepseek_router_decode": (8, 1, 64, 8, [0, 1, 2, 3, -1, 1, 2, 0], 2048),
    "deepseek_router_prefill": (1024, 256, 64, 8, [2, 0, -1, 3], 2048),
    "deepseek_qv_decode": (8, 1, 2048, 8, [3, 2, 1, 0, 0, -1, 2, 1], 2048),
    # jamba-v0.1-52b (phase 15): d 4096; the router's LoRA (dout 16, its
    # input the fp32 hidden state) at decode and over a per-client
    # prefill's 2 slot rows of a 256-token prompt, one block per row
    "jamba_router_decode": (8, 1, 16, 8, [0, 1, 2, 3, -1, 1, 2, 0]),
    "jamba_router_prefill": (512, 256, 16, 8, [2, 2]),
    # rwkv6-7b (phase 17): d 4096, d_ff 14336; the channel mix's LoRA on
    # cm_k (4096 -> 14336) and cm_v (14336 -> 4096) at decode (8 rows) and
    # over a per-client prefill's 4 slot rows of a 256-token prompt, one
    # block per row
    "rwkv_cm_k_decode": (8, 1, 14336, 8, [0, 1, 2, 3, -1, 1, 2, 0]),
    "rwkv_cm_k_prefill": (1024, 256, 14336, 8, [3, 3, 3, 3]),
    "rwkv_cm_v_decode": (8, 1, 4096, 8, [3, 2, 1, 0, 0, -1, 2, 1], 14336),
    "rwkv_cm_v_prefill": (1024, 256, 4096, 8, [1, 1, 1, 1], 14336),
    # whisper-small (phase 18): d 768, q and v (768 -> 768) at decode (8
    # rows, one dead), over a per-client prefill's 2 slot rows of 1,500
    # encoder frames (one 1,500-token block a row) and of a 64-token
    # decoder prompt
    "whisper_qv_decode": (8, 1, 768, 8, [0, 0, 1, -1, 2, 2, 3, 3], 768),
    "whisper_encoder_prefill": (3000, 1500, 768, 8, [2, 2], 768),
    "whisper_decoder_prefill": (128, 64, 768, 8, [1, 1], 768),
}


def check_sgmv(errs):
    n = 4
    for i, (name, (T, bt, dout, r, ids, *din)) in enumerate(
            SGMV_CASES.items()):
        din = din[0] if din else 4096
        g = gen(200 + i)
        x = torch.randn((T, din), generator=g, device=DEV)
        bank_a = torch.randn((n, 3, din, r), generator=g, device=DEV) / din ** 0.5
        bank_b = torch.randn((n, 3, r, dout), generator=g, device=DEV) * 0.05
        ids_t = torch.tensor(ids, dtype=torch.int32, device=DEV)
        live = torch.zeros(T, dtype=torch.bool, device=DEV)
        for b, a in enumerate(ids):
            live[b * bt:(b + 1) * bt] = a >= 0
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            # layer-major views of a [C, L, ...] bank: a strided client axis,
            # as the serving path passes it
            xd = x.to(dtype)
            Ad = bank_a.to(dtype).transpose(0, 1)[1]
            Bd = bank_b.to(dtype).transpose(0, 1)[1]
            before = launch_count("sgmv")
            got = sg.sgmv_cuda(xd, Ad, Bd, ids_t, block_t=bt, scale=2.0)
            if launch_count("sgmv") != before + 1:
                raise AssertionError(f"sgmv {name}: not one launch")
            want = sg.sgmv_plain(xd.float(), Ad.float(), Bd.float(), ids_t,
                                 block_t=bt, scale=2.0)
            torch.cuda.synchronize()
            e = compare(f"sgmv {name} {dtype}", got, want, tol)
            dead = got[~live]
            if dead.any() or torch.signbit(dead).any():
                raise AssertionError(f"sgmv {name}: dead rows not exact +0.0")
            errs.append(e)
            log(f"[phase 2] sgmv {name:30s} {str(dtype):15s} max_abs_err={e:.3e}")


def plain_call(op, *args, **kw):
    """The public op's plain version on the card, with the op's own
    blocks."""
    with kernels.plain_kernels():
        return op(*args, **kw)


def plain_op(op, *args, **kw):
    """``plain_call`` in fp32 on the same inputs (bf16 ones widened
    exactly): the reference a kernel is held against."""
    return plain_call(op, *[a.float() if torch.is_tensor(a)
                            and a.is_floating_point() else a for a in args],
                      **kw)


GRANITE, DEEPSEEK, WHISPER = "granite-3-8b", "deepseek-moe-16b", \
    "whisper-small"
DENSE_CASES = {   # (B, T, window, pos, arch whose K, G, hd the case takes)
    # phase 9's layer slab (4 clients x 2 slots, max_seq 512) at its decode
    # positions (None: ``slab_positions``), and a window cutting the rows
    "phase9_slab_T512": (8, 512, 0, None, GRANITE),
    "phase9_slab_T512_window": (8, 512, 100, None, GRANITE),
    "granite_T4096": (4, 4096, 0, [-1, 0, 2047, 4095], GRANITE),
    "granite_T4096_window": (4, 4096, 1000, [100, 1500, 4095, 999], GRANITE),
    "granite_T4093_prime": (2, 4093, 0, [4092, 77], GRANITE),
    "granite_B1_T32768_many_splits": (1, 32768, 0, [32767], GRANITE),
    "granite_window_cuts_a_split": (2, 4096, 300, [700, 4095], GRANITE),
    # 13a's dense run: deepseek-moe-16b's slab (K 16, G 1), at its decode
    # positions and with its first row idle (position -1)
    "deepseek_slab_T512": (8, 512, 0, None, DEEPSEEK),
    "deepseek_slab_T512_idle_row": (8, 512, 0, "idle", DEEPSEEK),
    # whisper-small's slab [8, 512, 12, 64] (K 12, G 1, hd 64) at 18b's
    # decode positions, and with its first row idle
    "whisper_slab_T512": (8, 512, 0, [19, 79, 32, 55, 24, 48, 67, 40],
                          WHISPER),
    "whisper_slab_T512_idle_row": (8, 512, 0,
                                   [-1, 79, 32, 55, 24, 48, 67, 40], WHISPER),
}


def slab_positions(arch=GRANITE):
    """The dense slab's decode positions (phase 9, 13a): 15 past each of
    phase 4's 8 prompts for ``arch``."""
    return [r.prompt.shape[1] + 15
            for r in make_requests(get_config(arch), 4)]


def check_dense(errs):
    for i, (name, (B, T, window, pos, arch)) in enumerate(
            DENSE_CASES.items()):
        cfg = get_config(arch)
        K, G, hd = cfg.n_kv_heads, cfg.q_per_kv, cfg.hd
        g = gen(500 + i)
        q = torch.randn((B, K, G, hd), generator=g, device=DEV)
        k = torch.randn((B, T, K, hd), generator=g, device=DEV)
        v = torch.randn((B, T, K, hd), generator=g, device=DEV)
        if pos in (None, "idle"):
            slab = slab_positions(arch)
            pos = [-1] + slab[1:] if pos == "idle" else slab
        p = torch.tensor(pos, dtype=torch.int32, device=DEV)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            got = da.decode_attn_cuda(qd, kd, vd, p, window=window)
            want = plain_op(kernels.decode_attn, qd, kd, vd, p, window=window)
            torch.cuda.synchronize()
            e = compare(f"decode_attn {name} {dtype}", got, want, tol)
            zeros_at_pos_minus_one(f"decode_attn {name}", got, p)
            errs.append(e)
            log(f"[phase 2] decode_attn {name:24s} K={K} G={G} hd={hd} "
                f"{str(dtype):15s} max_abs_err={e:.3e}")


FLASH_CASES = {   # (B, S, T, H, K, causal, window, hd)
    "granite_causal_2048": (1, 2048, 2048, 32, 8, True, 0, 128),
    "granite_cross_512x2048": (1, 512, 2048, 32, 8, False, 0, 128),
    "gemma2_window_8192": (1, 8192, 8192, 32, 16, True, 4096, 128),
    "s_above_t_no_key_rows": (2, 300, 200, 8, 2, True, 50, 128),
    # stablelm-12b: 32 / 8 heads of 160 (the SIMT entry in both dtypes)
    "stablelm_hd160_causal_1024": (1, 1024, 1024, 32, 8, True, 0, 160),
    "stablelm_hd160_cross_100x300": (2, 100, 300, 32, 8, False, 0, 160),
    # whisper-small: 12 heads of 64, 1,500 encoder frames (non-causal) and
    # a 448-token causal decoder; and hd 96 and 256 (the SIMT entry)
    "whisper_hd64_encoder_1500": (1, 1500, 1500, 12, 12, False, 0, 64),
    "whisper_hd64_causal_448": (2, 448, 448, 12, 12, True, 0, 64),
    "hd96_window_512": (1, 512, 512, 16, 4, True, 100, 96),
    "hd256_causal_1024": (1, 1024, 1024, 16, 8, True, 0, 256),
    # a last partial 64-column chunk of 16 and of 48 columns (hd 160 and
    # 96 leave 32): the SIMT kernel's column guard at every remainder
    "hd80_causal_512": (1, 512, 512, 16, 4, True, 0, 80),
    "hd112_cross_100x300": (2, 100, 300, 8, 8, False, 0, 112),
}


def check_flash(errs):
    """Every case in fp32 on the SIMT entry point and in bf16 on the
    tensor-core one at hd 128, on the SIMT one at every other head dim
    (each launch's entry asserted by its counter)."""
    for i, (name, (B, S, T, H, K, causal, window, hd)) in enumerate(
            FLASH_CASES.items()):
        g = gen(600 + i)
        q = torch.randn((B, S, H, hd), generator=g, device=DEV)
        k = torch.randn((B, T, K, hd), generator=g, device=DEV)
        v = torch.randn((B, T, K, hd), generator=g, device=DEV)
        bf16_entry = fa.WGMMA if hd == fa.HEAD_DIM else fa.SIMT
        for dtype, tol, entry in ((torch.float32, F32_TOL, fa.SIMT),
                                  (torch.bfloat16, BF16_TOL, bf16_entry)):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            before = dict(fa.flash_attn_cuda.by_entry)
            got = fa.flash_attn_cuda(qd, kd, vd, causal=causal, window=window)
            took = [e for e, c in fa.flash_attn_cuda.by_entry.items()
                    if c != before[e]]
            if took != [entry]:
                raise AssertionError(f"flash_attn {name} {dtype}: took "
                                     f"{took}, not {entry}")
            # non-causal: one kv block, since the op's blocks must divide T
            want = plain_op(kernels.flash_attn, qd, kd, vd, causal=causal,
                            window=window, **({} if causal else
                                              {"block_kv": T}))
            torch.cuda.synchronize()
            e = compare(f"flash_attn {name} {dtype}", got, want, tol)
            blind = got[:, T + window - 1:] if causal and window else got[:, :0]
            if blind.any() or torch.signbit(blind).any():
                raise AssertionError(f"flash_attn {name}: rows that see no "
                                     "key are not exact zeros")
            errs.append(e)
            log(f"[phase 2] flash_attn {name:28s} hd {hd} {str(dtype):15s} "
                f"{entry:5s} max_abs_err={e:.3e}")
            del got, want


RAGGED_CASES = {  # (budget, din, dout, n_live, live count on the card,
    #                bf16 entry point; fp32 always takes the SIMT one). The
    #                tensor-core cases cover its three tile widths: 256 (up),
    #                128 (o at 1,030 of 2,048), 64 (the last two)
    "granite_up_1001_of_1024": (1024, 4096, 12800, 1001, False, rl.WGMMA),
    "granite_up_700_of_2048": (2048, 4096, 12800, 700, True, rl.WGMMA),
    "granite_o_1030_of_2048": (2048, 4096, 4096, 1030, False, rl.WGMMA),
    "tc_no_tile_divides": (1000, 4104, 1000, 999, True, rl.WGMMA),
    "n_live_0": (256, 4096, 4096, 0, True, rl.WGMMA),
    "simt_no_tile_divides": (1000, 4100, 1001, 999, True, rl.SIMT),
}
UP_VIEW = (1024, 4096, 1001)  # budget, view columns, n_live: a column view
#                               of granite's up [4096, 12800] at offset 1024


def check_ragged_case(name, x, w, b, n, n_live, want_entry, errs):
    """One launch against the plain version in fp32 on the same inputs;
    the entry point it took (by its counter) must be ``want_entry``."""
    before = dict(rl.ragged_linear_cuda.by_entry)
    got = rl.ragged_linear_cuda(x, w, b, n_live)
    took = [e for e, c in rl.ragged_linear_cuda.by_entry.items()
            if c != before[e]]
    if took != [want_entry]:
        raise AssertionError(f"ragged_linear {name} {x.dtype}: took {took}, "
                             f"not {want_entry}")
    want = plain_op(kernels.ragged_linear, x, w, b, n_live)
    torch.cuda.synchronize()
    tol = F32_TOL if x.dtype == torch.float32 else BF16_TOL
    e = compare(f"ragged_linear {name} {x.dtype}", got, want, tol)
    tail = got[n:]
    if tail.any() or torch.signbit(tail).any():
        raise AssertionError(f"ragged_linear {name}: rows past n_live are "
                             "not exact +0.0")
    errs.append(e)
    log(f"[phase 2] ragged_linear {name:24s} {str(x.dtype):15s} "
        f"{want_entry:5s} max_abs_err={e:.3e}")


def check_ragged(errs):
    for i, (name, (budget, din, dout, n, on_card, entry)) in enumerate(
            RAGGED_CASES.items()):
        g = gen(700 + i)
        x = torch.randn((budget, din), generator=g, device=DEV)
        w = (torch.rand((din, dout), generator=g, device=DEV) * 2 - 1) \
            / din ** 0.5
        b = torch.randn((dout,), generator=g, device=DEV) * 0.1
        n_live = torch.tensor(n, dtype=torch.int32, device=DEV) if on_card \
            else n
        for dtype in (torch.float32, torch.bfloat16):
            check_ragged_case(name, *(t.to(dtype) for t in (x, w, b)), n,
                              n_live, entry if dtype == torch.bfloat16
                              else rl.SIMT, errs)
    budget, cols, n = UP_VIEW
    g = gen(750)
    up = ((torch.rand((4096, 12800), generator=g, device=DEV) * 2 - 1) / 64) \
        .to(torch.bfloat16)
    x = torch.randn((budget, 4096), generator=g, device=DEV)
    for off, entry in ((1024, rl.WGMMA), (4, rl.SIMT)):
        w = up[:, off:off + cols]
        check_ragged_case(f"up_view_at_{off}", x.to(torch.bfloat16), w, None,
                          n, n, entry, errs)


# ---------------------------------------------------------------------------
# phases 3 and 4: the model and the serving engine through the kernels
# ---------------------------------------------------------------------------

LORA = AdapterConfig(method="lora", rank=8, alpha=16.0, targets=("q", "v"))


def make_system(cfg, n_clients, seed, acfg=LORA):
    """bf16 base and LoRA bank (``acfg``) from a seeded generator on the
    card; the bank's B matrices (zero at init) are drawn too, so every
    client's adapter differs and the SGMV routing matters."""
    g = gen(seed)
    base, bank = symbiosis.init_system(cfg, acfg, n_clients, g, device=DEV,
                                       adapter_dtype=torch.bfloat16)
    for leaf in _adapter_leaves(bank):
        leaf["B"].copy_(torch.randn(leaf["B"].shape, generator=g, device=DEV)
                        * 0.05)
    return base, bank


def _adapter_leaves(bank):
    """The per-path leaves of every container of a bank (``layers`` /
    ``groups``, or an encoder-decoder's ``enc_layers`` then
    ``dec_layers``), in order; prefix tensors are not per-path dicts."""
    return [leaf for container in bank.values()
            for leaf in container.values() if isinstance(leaf, dict)]


@contextlib.contextmanager
def no_host_sync():
    """Raise on any operation that makes the host wait for the device."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def model_wiring(quant, arch=GRANITE, acfg=LORA, label="phase 3"):
    """Full-width ``arch`` (granite-3-8b), 2 layers: compacted prefill +
    decode with the kernels and under plain_kernels(), over bf16 or
    (``quant``) int8 caches, LoRA ``acfg``; logits must agree at bf16
    tolerance. The kernel pass must not sync the host (a CUDA graph could
    capture it)."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    C, max_b, max_seq, blk = 4, 2, 512, 16
    scfg = ServeConfig(n_clients=C, max_seq=max_seq, page_block=blk,
                       kv_quant=quant)
    base, bank = make_system(cfg, C, seed=1, acfg=acfg)
    nb, P = max_seq // blk, max_b * (max_seq // blk)
    rng = np.random.default_rng(3)
    lengths = rng.integers(64, 257, C).astype(np.int32)
    toks = np.zeros((C, 256), np.int32)
    tbl = np.full((C, max_b, nb), SENTINEL, np.int32)
    for c, L in enumerate(lengths):
        toks[c, :L] = rng.integers(0, cfg.vocab, L)
        tbl[c, 0, :L // blk + 1] = c * P + np.arange(L // blk + 1)
    rows = [torch.tensor(a, device=DEV) for a in
            (np.arange(C, dtype=np.int32), np.zeros(C, np.int32),
             np.ones(C, bool))]
    prefill = symbiosis.make_compact_prefill(cfg, acfg, scfg)
    decode = symbiosis.make_compact_decode_step(cfg, acfg, scfg)
    out, nxt = [], None
    for plain in (False, True):
        caches = symbiosis.init_client_caches(cfg, C, max_b, max_seq,
                                              page_block=blk, pool_pages=P,
                                              quant=quant, device=DEV)
        caches["block_tbl"] = torch.tensor(tbl, device=DEV)
        prompts = (torch.tensor(toks, device=DEV),
                   torch.tensor(lengths, device=DEV),
                   torch.zeros(C, dtype=torch.int32, device=DEV))
        with blocks.plain_kernels() if plain else no_host_sync():
            lg1, _, caches = prefill(base, bank, caches, *prompts, *rows)
            if nxt is None:
                nxt = lg1.argmax(-1).to(torch.int32)
            lg2, _, caches = decode(base, bank, caches, nxt, *rows)
        out.append((lg1, lg2))
    torch.cuda.synchronize()
    e1 = compare("model prefill logits", out[0][0], out[1][0], BF16_TOL)
    e2 = compare("model decode logits", out[0][1], out[1][1], BF16_TOL)
    log(f"[{label}] {arch} width, 2 layers, "
        f"{'int8' if quant else 'bf16'} caches: prefill logits max_abs_err="
        f"{e1:.3e}, decode logits max_abs_err={e2:.3e} (kernels vs plain); "
        "no host sync in the kernel pass")


def dense_wiring(arch=GRANITE, acfg=LORA, label="phase 3"):
    """Full-width ``arch`` (granite-3-8b), 2 layers, phase 9's dense layout
    (4 clients x 2 slots, max_seq 512), LoRA ``acfg``: a per-client prefill
    into each client's first slot, then one masked decode tick over the 8
    slot rows with the first slots active, with the kernels and under
    plain_kernels(). Logits must agree at bf16 tolerance; the kernel pass
    must launch the dense kernel 2 per layer in the tick and SGMV
    ``p13_sgmv_per_call`` times per call (2 per layer for q and v), the
    plain pass nothing."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    C, max_b, max_seq, L = 4, 2, 512, cfg.n_layers
    per_call = p13_sgmv_per_call(cfg, acfg)
    scfg = ServeConfig(n_clients=C, max_seq=max_seq, page_block=0)
    base, bank = make_system(cfg, C, seed=1, acfg=acfg)
    rng = np.random.default_rng(5)
    lengths = rng.integers(64, 257, C).astype(np.int32)
    toks = np.zeros((C, max_b, 256), np.int32)
    for c, n in enumerate(lengths):
        toks[c, 0, :n] = rng.integers(0, cfg.vocab, n)
    slot_mask = torch.tensor([True, False], device=DEV)
    active = torch.zeros((C, max_b), dtype=torch.bool, device=DEV)
    active[:, 0] = True
    prefill = symbiosis.make_client_prefill(cfg, acfg, scfg)
    decode = symbiosis.make_masked_decode_step(cfg, acfg, scfg)
    out, nxt = [], None
    for plain in (False, True):
        caches = symbiosis.init_client_caches(cfg, C, max_b, max_seq,
                                              device=DEV)
        torch.cuda.synchronize()
        reset_counts()
        with blocks.plain_kernels() if plain else contextlib.nullcontext():
            lg1 = []
            for c, n in enumerate(lengths):
                lg, caches = prefill(
                    base, bank, caches, c, c, torch.tensor(toks[c],
                                                           device=DEV),
                    torch.tensor([n, 0], dtype=torch.int32, device=DEV),
                    slot_mask)
                lg1.append(lg[0])
            lg1 = torch.stack(lg1)
            if nxt is None:
                nxt = torch.zeros((C, max_b), dtype=torch.int32, device=DEV)
                nxt[:, 0] = lg1.argmax(-1)
            lg2, caches = decode(base, bank, caches, nxt, active)
        torch.cuda.synchronize()
        want = {n: 0 for n in KERNELS}
        if not plain:
            want.update(decode_attn=2 * L, sgmv=per_call * (C + 1))
        if read_counts() != want:
            raise AssertionError(f"[{label}] dense tick launches "
                                 f"{read_counts()}, want {want}")
        out.append((lg1, lg2[:, 0]))
    e1 = compare("dense prefill logits", out[0][0], out[1][0], BF16_TOL)
    e2 = compare("dense decode logits", out[0][1], out[1][1], BF16_TOL)
    log(f"[{label}] {arch} width, 2 layers, dense caches [L, C, B, T, K, "
        f"hd] = {list(caches['layers']['k'].shape)}: per-client prefill "
        f"logits max_abs_err={e1:.3e}, masked decode logits (4 of 8 slots "
        f"active) max_abs_err={e2:.3e} (kernels vs plain; decode_attn "
        f"{2 * L}, sgmv {per_call * (C + 1)} launches in the kernel pass)")


def _timed(fn, bucket):
    def run(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        bucket.append(time.perf_counter() - t)
        return out
    return run


def make_requests(cfg, C):
    """The 8 staggered one-row requests of phases 4 and 4b: prompts of
    64-256 tokens, 16 new tokens each, one arrival per tick."""
    rng = np.random.default_rng(4)
    return [Request(client_id=i % C, max_new_tokens=16, arrive_tick=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        (1, int(rng.integers(64, 257))))
                    .astype(np.int32)) for i in range(8)]


def serve_spec(cfg, quant):
    C = 4
    scfg = ServeConfig(n_clients=C, max_seq=512, page_block=16,
                       policy="opportunistic", kv_quant=quant)
    return EngineSpec(cfg=cfg, banks=(BankSpec("tenants", LORA, C),),
                      serve=scfg, max_batch_per_client=2)


def drive(eng, reqs, label, attn_name, idle_name, sgmv_per_call=None,
          groups=None):
    """Serve ``reqs`` to completion with every launch count set to 0 just
    before and read just after; per tick, the attention kernel
    ``attn_name`` must launch once per layer and decode tick, ``idle_name``
    never, and SGMV ``sgmv_per_call`` times (default twice per layer: q
    and v) per decode tick or prefill batch. ``groups``, a list, collects
    the requests each compacted prefill carried. Returns the counts and
    the timings."""
    L = eng.cfg.n_layers
    sgmv_per_call = 2 * L if sgmv_per_call is None else sgmv_per_call
    attn, idle, sgmv = (KERNELS[n][0] for n in (attn_name, idle_name, "sgmv"))
    for r in reqs:
        eng.submit(r)
    pre_t, dec_t, tick_t, step_t = [], [], [], []
    eng._prefill_step = _timed(eng._prefill_step, pre_t)
    eng._decode_step = _timed(eng._decode_step, dec_t)
    if groups is not None:
        compact = eng._prefill_compact

        def record(newly):
            groups.append([req for req, _ in newly])
            return compact(newly)
        eng._prefill_compact = record
    torch.cuda.synchronize()
    reset_counts()
    per_tick = TICK_LAUNCHES[label] = []
    t0 = time.perf_counter()
    more = True
    while more:
        before = (attn.launches, idle.launches, sgmv.launches,
                  eng.stats["ticks"], eng.stats["compact_prefill_batches"])
        torch.cuda.synchronize()
        t_tick = time.perf_counter()
        more = eng.service_tick()
        torch.cuda.synchronize()
        t_tick = time.perf_counter() - t_tick
        d_at, d_idle, d_sg, d_tick, d_pre = (
            a - b for a, b in zip((attn.launches, idle.launches,
                                   sgmv.launches, eng.stats["ticks"],
                                   eng.stats["compact_prefill_batches"]),
                                  before))
        per_tick.append((d_at, d_idle, d_sg))
        if d_at != L * d_tick or d_idle \
                or d_sg != sgmv_per_call * (d_tick + d_pre):
            raise AssertionError(
                f"[{label}] tick {eng._tick}: {d_at} {attn_name}, "
                f"{d_idle} {idle_name} and {d_sg} SGMV launches for "
                f"{d_tick} decode ticks and {d_pre} prefills")
        if d_tick and not d_pre:
            tick_t.append(t_tick)
            step_t.append(dec_t[-1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    done = eng.drain_done()
    if len(done) != len(reqs) or eng.stats["quarantined_requests"]:
        raise AssertionError(f"[{label}] {len(done)} of {len(reqs)} requests "
                             f"finished, {eng.stats['quarantined_requests']} "
                             "with non-finite logits")
    for r in done:
        g = r.generated
        if r.status != "ok" or g.shape != (1, 16) or g.min() < 0 \
                or g.max() >= eng.cfg.vocab:
            raise AssertionError(f"[{label}] request of client {r.client_id}:"
                                 f" status {r.status}, tokens {g}")
    if not (launches[attn_name] and launches["sgmv"]):
        raise AssertionError(f"[{label}] a kernel never launched on the "
                             f"path: {launches}")
    st = eng.stats
    log(f"[{label}] served {len(done)} requests ({st['prefill_tokens']} "
        f"prompt + {st['decode_tokens'] + len(done)} generated tokens) in "
        f"{wall:.3f} s; {st['ticks']} decode ticks, "
        f"{st['compact_prefill_batches']} prefill batches, peak in flight "
        f"{st['peak_inflight']}, launches {launches}")
    log(f"[{label}] prefill {st['prefill_tokens'] / sum(pre_t):.1f} tokens/s "
        f"({sum(pre_t) * 1e3:.2f} ms over {len(pre_t)} batches); decode "
        f"{st['decode_tokens'] / sum(dec_t):.1f} tokens/s; decode-step ms "
        f"{statistics.median(dec_t) * 1e3:.3f} (median), "
        f"{statistics.mean(dec_t) * 1e3:.3f} (mean) over {len(dec_t)} steps")
    log(f"[{label}] {len(tick_t)} ticks without admission: decode-step ms "
        f"{statistics.median(step_t) * 1e3:.3f}, service-tick ms "
        f"{statistics.median(tick_t) * 1e3:.3f} (medians; the tick adds the "
        f"logits' copy to the host, sampling and retirement)")
    log(f"[{label}] launches per decode tick: {attn_name} "
        f"{launches[attn_name] / st['ticks']:g}; "
        f"sgmv per decode tick or prefill batch "
        f"{launches['sgmv'] / (st['ticks'] + st['compact_prefill_batches']):g}"
        f" (checked tick by tick)")
    return launches, dict(step_ms=statistics.median(step_t) * 1e3,
                          tick_ms=statistics.median(tick_t) * 1e3)


def warm_up(spec, base, bank):
    """First cuBLAS/allocator use (and, for int8, the quantizer's first
    launches) stays out of the timed runs."""
    warm = ServingEngine(spec, base, [bank], device=DEV)
    warm.submit(Request(0, np.arange(64, dtype=np.int32)[None], 2))
    warm.run()


def serve_full():
    """granite-3-8b at full depth and width behind the port's engine."""
    cfg = get_config("granite-3-8b")
    C, L = 4, cfg.n_layers
    spec = serve_spec(cfg, quant=False)
    t0 = time.perf_counter()
    base, bank = make_system(cfg, C, seed=2)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(base))
    log(f"[phase 4] {cfg.name}: {L} layers, {n_params / 1e9:.2f} B params "
        f"bf16 initialised in {time.perf_counter() - t0:.1f} s")
    warm_up(spec, base, bank)
    eng = ServingEngine(spec, base, [bank], device=DEV)
    reqs = make_requests(cfg, C)
    launches, times = drive(eng, reqs, "phase 4", "paged_decode_attn",
                            "paged_decode_attn_quant")
    times.update(profile_tick(cfg, base, [bank], spec, "phase 4"))
    first = [int(r.generated[0, 0]) for r in reqs]
    lengths = [r.prompt.shape[1] for r in reqs]
    streams = [r.generated.copy() for r in reqs]
    return (launches, cfg, eng.caches, base, bank, lengths, first, times,
            streams)


def quant_charges(cfg, spec, reqs):
    """The requests' int8 page charges, smallest first."""
    return sorted(kvcache.cache_bytes(cfg, r.prompt.shape[1]
                                      + r.max_new_tokens, 1, quant=True,
                                      page_block=spec.serve.page_block)
                  for r in reqs)


def quant_router(cfg, spec, reqs):
    """Phase 4b's router: one slot holding the 4 largest of the requests'
    int8 charges, not all 8."""
    return PlacementRouter(cfg, [Slot(0, free_hbm=sum(
        quant_charges(cfg, spec, reqs)[-4:]))])


def serve_quant(cfg, base, bank, first, times4):
    """Phase 4b: the same requests over int8 pages, admitted by a router
    whose one slot holds the 4 largest of the requests' int8 charges, not
    all 8."""
    C = 4
    spec = serve_spec(cfg, quant=True)
    warm_up(spec, base, bank)
    reqs = make_requests(cfg, C)
    blk = spec.serve.page_block
    charges = quant_charges(cfg, spec, reqs)
    router = quant_router(cfg, spec, reqs)
    eng = ServingEngine(spec, base, [bank], device=DEV, router=router)
    log(f"[phase 4b] kv=paged(block={blk})+int8: "
        f"{kvcache.make_cache_spec(cfg, quant=True).bytes_per_token} B per "
        f"token against {kvcache.make_cache_spec(cfg).bytes_per_token} in "
        f"bf16; router slot {sum(charges[-4:])} B, requests charge "
        f"{charges[0]}..{charges[-1]} B ({sum(charges)} B in all)")
    admitted = {}
    try_admit = eng._try_admit

    def record_admission(req):
        slots = try_admit(req)
        if slots is not None:
            admitted[id(req)] = eng._tick
        return slots
    eng._try_admit = record_admission
    launches, times = drive(eng, reqs, "phase 4b", "paged_decode_attn_quant",
                            "paged_decode_attn")
    waits = [admitted[id(r)] - r.arrive_tick for r in reqs]
    if eng.stats["peak_inflight"] >= len(reqs) or not any(waits):
        raise AssertionError(f"[phase 4b] the router never queued: peak in "
                             f"flight {eng.stats['peak_inflight']}, waits "
                             f"{waits}")
    got = [int(r.generated[0, 0]) for r in reqs]
    if got != first:
        raise AssertionError(f"[phase 4b] first tokens {got} differ from "
                             f"phase 4's {first}: prefill logits must not "
                             "depend on the cache format")
    errs = router.conservation_errors()
    used = router.utilization()
    if errs or used["committed_bytes"] or used["placements"]:
        raise AssertionError(f"[phase 4b] router after the drain: {errs}, "
                             f"{used}")
    log(f"[phase 4b] ticks each request waited for the router: {waits}; "
        f"first tokens equal phase 4's; router ledger conserved and empty "
        f"after the drain")
    times.update(profile_tick(cfg, base, [bank], spec, "phase 4b"))
    log("[phase 4b] beside phase 4 (bf16 -> int8): " + ", ".join(
        f"{k} {times4[k]:.3f} -> {times[k]:.3f}" for k in times
        if k in times4))
    return (launches, eng.caches, [r.prompt.shape[1] for r in reqs],
            [r.generated.copy() for r in reqs])


# Kernels per traced 8-row decode tick before the attention kernels were
# split across blocks and SGMV across dout tiles, as this script counted
# them on the H100 (phase 4b's count differs by one from run to run): every
# kernel stays one launch per call, so the count must not rise.
KERNELS_PER_TICK_BEFORE = {"phase 4": 3469, "phase 4b": 4589}
# traced device time per 8-row decode tick that the SGMV launches (80) and
# the attention launches (40) aim to stay under, ms
TICK_AIMS_MS = {"sgmv": 1.0, "split_kernel": 1.0}


def device_profile(prof):
    """(busy ms, kernels, {name: (count, us)}) of a trace's device events."""
    kern = sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in kern:
        s, t = e.time_range.start, e.time_range.end
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
        n, d = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, d + e.time_range.elapsed_us())
    return busy / 1e3, len(kern), by_name


def profile_tick(cfg, base, banks, spec, label, n_req=8, prompt_len=192,
                 **engine_kw):
    """A decode tick of ``n_req`` one-row requests (8: every slot of phase
    4's bank) of ``prompt_len`` tokens over ``banks``' clients in turn: its
    median over 5
    unprofiled ticks on the host clock, then one tick traced by
    torch.profiler with device activity only.
    The device's busy share is the union of the traced kernel intervals
    over the unprofiled median tick (and over the traced tick's own host
    time, which tracing lengthens). Also the kernel count and the kernels
    that take the most device time. ``engine_kw`` goes to the engine."""
    eng = ServingEngine(spec, base, banks, device=DEV, **engine_kw)
    rng = np.random.default_rng(5)
    for i in range(n_req):
        eng.submit(Request(i % eng.n_clients, rng.integers(
            0, cfg.vocab, (1, prompt_len)).astype(np.int32), 16))
    eng.service_tick()               # admission, prefill, first decode tick
    eng.service_tick()
    ticks = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.service_tick()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t0)
    tick_us = statistics.median(ticks) * 1e6
    with traced() as prof:
        t0 = time.perf_counter()
        eng.service_tick()
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t0) * 1e6
    busy_ms, n_kern, by_name = device_profile(prof)
    busy = busy_ms * 1e3
    out = {"tick8_ms": tick_us / 1e3}
    what = f"decode tick ({n_req} of 8 slots active)"
    if not n_kern:
        log(f"[{label}] {what}: {tick_us / 1e3:.3f} ms median "
            "unprofiled; profiler saw no device events: device busy share "
            "not measured")
        return out
    before = KERNELS_PER_TICK_BEFORE.get(label)
    log(f"[{label}] {what}: {tick_us / 1e3:.3f} ms median "
        f"unprofiled, {traced_us / 1e3:.3f} ms traced; device busy "
        f"{busy / 1e3:.3f} ms = {100 * busy / tick_us:.1f}% of the "
        f"unprofiled tick ({100 * busy / traced_us:.1f}% of the traced "
        f"one); {n_kern} kernels" + (
            "" if before is None else f" (at most {before}: every kernel one "
            "launch per call)"))
    if before is not None and n_kern > before:
        raise AssertionError(f"[{label}] {n_kern} kernels per decode tick,"
                             f" more than {before}")
    for name, (n, d) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"[{label}]   {d / 1e3:8.3f} ms  {n:5d}x  {name[:90]}")
    for key, aim in TICK_AIMS_MS.items():   # the attention is split_kernel
        n = sum(c for name, (c, _) in by_name.items() if key in name)
        d = sum(t for name, (_, t) in by_name.items() if key in name) / 1e3
        log(f"[{label}] {key}: {n} launches, {d:.3f} ms of device time per "
            f"tick, aim <= {aim} ms: {'met' if d <= aim else 'missed'}")
        out[f"{key}_tick_ms"] = d
    n = sum(c for name, (c, _) in by_name.items() if "dense_combine" in name)
    if n:    # the dense layout's attention: split_kernel + dense_combine
        d = sum(t for name, (_, t) in by_name.items()
                if "dense_combine" in name) / 1e3
        log(f"[{label}] dense_combine: {n} launches, {d:.3f} ms; the dense "
            f"decode kernel (split + combine) "
            f"{out['split_kernel_tick_ms'] + d:.3f} ms of device time per "
            "tick")
        out["dense_attn_tick_ms"] = out["split_kernel_tick_ms"] + d
    out.update(busy_ms=busy / 1e3, busy_pct=100 * busy / tick_us,
               kernels_per_tick=float(n_kern))
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


# ---------------------------------------------------------------------------
# phase 5: timings at the serving path's shapes
# ---------------------------------------------------------------------------

_L2_FLUSH = []


def time_ms(fn, n=30, warmup=3, l2_cold=True):
    """Median device time of one call (CUDA events around each call). With
    ``l2_cold`` a 256 MB write before each call (outside the events) evicts
    the card's 50 MB L2, so the call reads its inputs from HBM, as on the
    serving path, where a layer's weights pass through L2 between two
    calls of a kernel."""
    if l2_cold and not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(64 << 20, dtype=torch.int32, device=DEV))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if l2_cold:
            _L2_FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n=20):
    """Median device time of one L2-cold call of ``fn`` (one kernel launch)
    over ``n`` calls, with the host's enqueue hidden. The events of
    ``time_ms`` also count the device's wait for the host to enqueue the
    launch, which the 256 MB flush hides only while the wrapper's host time
    is shorter than the flush (and L2-warm, with no flush, never): a kernel
    of tens of us reads slower there than it runs. Here a spin kernel
    (``torch.cuda._sleep``) holds the stream while the host enqueues all
    ``n`` rounds of (flush, start event, call, end event), so each pair of
    events brackets work that was queued before the device reached it. If
    the spin was over before the last round was enqueued, the rounds run
    again behind a spin four times as long."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(64 << 20, dtype=torch.int32, device=DEV))
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 25                   # ~17 ms at the H100's 1.98 GHz
    for _ in range(4):
        spun = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        spun.record()
        rounds = []
        for _ in range(n):
            _L2_FLUSH[0].zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            rounds.append((start, end))
        ahead = not spun.query()
        torch.cuda.synchronize()
        if ahead:
            return statistics.median(s.elapsed_time(e) for s, e in rounds)
        cycles *= 4
    raise AssertionError(f"[phase 5] the host took longer to enqueue {n} "
                         f"calls than a spin of {cycles // 4} cycles")


@contextlib.contextmanager
def traced(idle_s=0.05):
    """torch.profiler (device activity only) over the block, the device
    idle for ``idle_s`` before and after it. The profiler keeps a device
    event only if it falls inside the trace's window on the host's clock,
    so a skew between the two clocks would drop the kernels at the
    window's edges."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(idle_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(idle_s)


def bound(nbytes, flops):
    """The least time for the work: bytes over the H100's HBM rate, or its
    operations over the dense bf16 tensor-core peak, whichever is larger
    (every attention and SGMV case here is bound by bytes by a wide margin;
    the bf16 ragged linear, on ``wgmma``, by operations)."""
    b_ms = nbytes / H100.hbm_bandwidth * 1e3
    f_ms = flops / H100.peak_flops_bf16 * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def attn_rows(cfg, caches, lengths):
    """8 decode rows (the bucket of phases 4 and 4b) over an engine's own
    layer-fused pools, pages drawn from the first layer's range: q in bf16,
    positions 15 past each request's prompt, sentinel past the last page.
    Returns (q, pools {leaf: [L*P, blk, K, hd|1]}, tbl, pos)."""
    L, Pl, blk, K, hd = caches["layers"]["k"].shape
    pools = {n: t.view((L * Pl,) + t.shape[2:])
             for n, t in caches["layers"].items()}
    B, G, nb = 8, cfg.q_per_kv, caches["block_tbl"].shape[-1]
    g = gen(7)
    q = torch.randn((B, K, G, hd), generator=g, device=DEV).to(torch.bfloat16)
    pos = torch.tensor([n + 15 for n in lengths[:B]], dtype=torch.int32,
                       device=DEV)
    tbl = torch.randperm(Pl, generator=g, device=DEV)[:B * nb].reshape(B, nb)
    cols = torch.arange(nb, device=DEV)[None, :]
    tbl = torch.where(cols > (pos // blk)[:, None], SENTINEL, tbl) \
        .to(torch.int32)
    return q, pools, tbl, pos


def sdpa_over_pages(q, k, v, tbl, pos, dequant=None):
    """The library yardstick: gather the table's pages into dense K/V
    (with ``dequant`` = (k_scale, v_scale) pools, dequantize them to q's
    dtype), then one ``scaled_dot_product_attention``."""
    B, K, G, hd = q.shape
    P, blk = k.shape[:2]
    nb = tbl.shape[1]
    pages = tbl.long().clamp(0, P - 1)
    k, v = k[pages], v[pages]
    if dequant is not None:
        k = (k.to(q.dtype) * dequant[0][pages]).to(q.dtype)
        v = (v.to(q.dtype) * dequant[1][pages]).to(q.dtype)
    k = k.reshape(B, nb * blk, K, hd).transpose(1, 2)
    v = v.reshape(B, nb * blk, K, hd).transpose(1, 2)
    t = torch.arange(nb * blk, device=DEV)
    mask = (t[None, :] <= pos[:, None])[:, None, None, :]
    qh = q.reshape(B, K * G, 1, hd)
    # the builtin has no inspectable signature; its docstring names the flag
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        out = F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                             enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(
            qh, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1),
            attn_mask=mask)
    return out.reshape(B, K, G, hd)


def time_attention(label, kernel, plain, library, q, tbl, pos, pool_bytes,
                   phase="phase 5"):
    """Kernel L2-cold and L2-warm, its device time with the host's enqueue
    hidden (``device_ms``), plain version and library yardstick, and
    the byte bound: ``pool_bytes`` (the live tokens' pool bytes), plus q
    and out in bf16, the table and the positions. Returns the JSON fields,
    the yardstick's time as ``library_ms``."""
    got = kernel()
    lib_err = float((got.float() - library().float()).abs().max())
    ms = time_ms(kernel)
    warm_ms = time_ms(kernel, l2_cold=False)
    dev_ms = device_ms(kernel)
    plain_ms = time_ms(plain, n=20)
    lib_ms = time_ms(library)
    B, K, G, hd = q.shape
    tokens = int((pos.long() + 1).sum())
    nbytes = (2 * q.numel() * 2 + pool_bytes(tokens) + tbl.numel() * 4
              + pos.numel() * 4)
    bound_ms, by = bound(nbytes, 4 * tokens * K * G * hd)
    log(f"[{phase}] {label} B={B} K={K} G={G} hd={hd}, {tokens} live "
        f"tokens, L2-cold: kernel {ms:.4f} ms (L2-warm {warm_ms:.4f}; device "
        f"time, enqueue hidden, {dev_ms:.4f}{aim_note(label, dev_ms)}), "
        f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms (differs by "
        f"{lib_err:.2e}), bound {bound_ms:.4f} ms ({by}, {nbytes} B)")
    return dict(ms=ms, ms_l2_warm=warm_ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms)


def time_decode_attn(cfg, caches, lengths):
    """The bf16 kernel over phase 4's pool; the yardstick is page gather +
    SDPA."""
    q, pools, tbl, pos = attn_rows(cfg, caches, lengths)
    pk, pv = pools["k"], pools["v"]
    _, blk, K, hd = pk.shape
    log(f"[phase 5] paged_decode_attn over phase 4's pool: "
        f"{pk.shape[0]} pages of {blk} tokens; library = page gather + SDPA")
    return time_attention(
        "paged_decode_attn",
        lambda: da.paged_decode_attn_cuda(q, pk, pv, tbl, pos),
        lambda: da.paged_decode_attn_plain(q, pk, pv, tbl, pos),
        lambda: sdpa_over_pages(q, pk, pv, tbl, pos), q, tbl, pos,
        lambda tokens: 2 * tokens * K * hd * 2)


def time_decode_attn_quant(cfg, caches, lengths):
    """The int8 kernel over phase 4b's pool. No single PyTorch call computes
    attention over int8 pages with per-head scales; the yardstick is three:
    page gather, dequantize to bf16, SDPA."""
    q, pools, tbl, pos = attn_rows(cfg, caches, lengths)
    pk, pks, pv, pvs = (pools[n] for n in ("k", "k_s", "v", "v_s"))
    _, blk, K, hd = pk.shape
    log(f"[phase 5] paged_decode_attn_quant over phase 4b's int8 pool: "
        f"{pk.shape[0]} pages of {blk} tokens; no single PyTorch call "
        "computes this function (library_ms is null): the yardstick below is "
        "three calls, page gather, dequantize to bf16, SDPA")
    out = time_attention(
        "paged_decode_attn_quant",
        lambda: da.paged_decode_attn_quant_cuda(q, pk, pks, pv, pvs, tbl, pos),
        lambda: da.paged_decode_attn_quant_plain(q, pk, pks, pv, pvs, tbl,
                                                 pos),
        lambda: sdpa_over_pages(q, pk, pv, tbl, pos, dequant=(pks, pvs)),
        q, tbl, pos, lambda tokens: 2 * tokens * K * (hd + 4))
    # no one call: library_ms is null, the three calls' time has its own key
    out["gather_dequant_sdpa_ms"] = out.pop("library_ms")
    out["library_ms"] = None
    return out


# device time (enqueue hidden) each redesigned kernel aims to stay under
# at phase 5's shapes, ms
DEVICE_AIMS_MS = {"paged_decode_attn_quant": 0.020, "sgmv decode": 0.010,
                  "sgmv prefill": 0.020}


def aim_note(label, dev_ms):
    aim = DEVICE_AIMS_MS.get(label)
    if aim is None:
        return ""
    return f", aim <= {aim} ms: {'met' if dev_ms <= aim else 'missed'}"


def time_sgmv(bank):
    """LoRA deltas of one layer at the serving path's shapes: decode (8
    rows, block_t=1) for the q and v projections and compacted prefill (4
    rows of 256 tokens) for q. Returns the q decode fields, with the
    others' under ``decode_v`` and ``prefill``."""
    results = {}
    for label, path, rows, bt in (("decode", "q", 8, 1),
                                  ("decode_v", "v", 8, 1),
                                  ("prefill", "q", 4, 256)):
        A = bank["layers"][path]["A"].transpose(0, 1)[0]   # [C, din, r] view
        Bw = bank["layers"][path]["B"].transpose(0, 1)[0]
        n, din, r = A.shape
        dout = Bw.shape[-1]
        g = gen(8)
        x = torch.randn((rows * bt, din), generator=g, device=DEV) \
            .to(torch.bfloat16)
        ids = torch.arange(rows, device=DEV, dtype=torch.int32) % n
        scale = LORA.alpha / LORA.rank

        def library():
            safe = ids.long().clamp(0, n - 1).repeat_interleave(bt)
            h = torch.bmm(x[:, None, :], A[safe])
            y = torch.bmm(h, Bw[safe])[:, 0] * scale
            live = (ids >= 0).repeat_interleave(bt)[:, None]
            return torch.where(live, y, torch.zeros_like(y))

        got = sg.sgmv_cuda(x, A, Bw, ids, block_t=bt, scale=scale)
        # the yardstick rounds h to bf16 between its two products, the
        # kernel keeps it in fp32: the difference is reported, not held
        lib_err = float((got.float() - library().float()).abs().max())

        def kernel():
            return sg.sgmv_cuda(x, A, Bw, ids, block_t=bt, scale=scale)
        ms = time_ms(kernel)
        warm_ms = time_ms(kernel, l2_cold=False)
        dev_ms = device_ms(kernel)
        plain_ms = time_ms(lambda: sg.sgmv_plain(x, A, Bw, ids, block_t=bt,
                                                 scale=scale), n=20)
        lib_ms = time_ms(library)
        T = rows * bt
        n_used = len(set(ids.tolist()))
        nbytes = (T * din * 2 + n_used * (din * r + r * dout) * 2
                  + ids.numel() * 4 + T * dout * 2)
        bound_ms, by = bound(nbytes, 2 * T * r * (din + dout))
        log(f"[phase 5] sgmv {label} T={T} block_t={bt} din={din} r={r} "
            f"dout={dout}, L2-cold: kernel {ms:.4f} ms (L2-warm "
            f"{warm_ms:.4f}; device time, enqueue hidden, {dev_ms:.4f}"
            f"{aim_note('sgmv ' + label, dev_ms)}), plain {plain_ms:.4f} ms, "
            f"gather+bmm {lib_ms:.4f} ms (differs by {lib_err:.2e}), bound "
            f"{bound_ms:.4f} ms ({by})")
        results[label] = dict(ms=ms, ms_l2_warm=warm_ms, device_ms=dev_ms,
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=by, library_ms=lib_ms)
    out = results.pop("decode")
    out.update(results)
    return out


DENSE_SHAPE = (8, 4096, 8, 4, 128)     # phase 6's dense cache: B, T, K, G, hd
FLASH_SHAPE = (1, 4096, 32, 8, 128)    # phase 6's prefill: B, S=T, H, K, hd


def dense_inputs(seed):
    """bf16 q [B, K, G, hd] and a dense cache [B, T, K, hd], positions
    spread evenly over [0, T - 1]."""
    B, T, K, G, hd = DENSE_SHAPE
    g = gen(seed)
    q = torch.randn((B, K, G, hd), generator=g, device=DEV).to(torch.bfloat16)
    k = torch.randn((B, T, K, hd), generator=g, device=DEV).to(torch.bfloat16)
    v = torch.randn((B, T, K, hd), generator=g, device=DEV).to(torch.bfloat16)
    pos = torch.linspace(0, T - 1, B, device=DEV).round().to(torch.int32)
    return q, k, v, pos


def flash_inputs(seed, S=None, K=None):
    B, S0, H, K0, hd = FLASH_SHAPE
    S, K = S or S0, K or K0
    g = gen(seed)
    return tuple(torch.randn((B, S, n, hd), generator=g, device=DEV)
                 .to(torch.bfloat16) for n in (H, K, K))


def sdpa_gqa(q, k, v, **kw):
    """One ``scaled_dot_product_attention`` over [B, heads, len, hd] views,
    the KV heads shared by groups of query heads."""
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    G = q.shape[1] // k.shape[1]
    return F.scaled_dot_product_attention(
        q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1), **kw)


def timing_fields(label, kernel, plain, library, nbytes, flops, shape,
                  rows=None, phase="phase 5"):
    """Kernel L2-cold and L2-warm, its device time with the host's enqueue
    hidden (``device_ms``), plain version, one library call (L2-cold, and
    its device time the same way), and the bound; the library call's
    difference from the kernel (over the first ``rows`` rows, where given)
    is reported."""
    lib_err = float((kernel()[:rows].float() - library()[:rows].float())
                    .abs().max())
    ms = time_ms(kernel)
    warm_ms = time_ms(kernel, l2_cold=False)
    dev_ms = device_ms(kernel, n=10)
    plain_ms = time_ms(plain, n=10, warmup=1)
    lib_ms = time_ms(library)
    lib_dev_ms = device_ms(library, n=10)
    bound_ms, by = bound(nbytes, flops)
    log(f"[{phase}] {label} {shape}, L2-cold: kernel {ms:.4f} ms (L2-warm "
        f"{warm_ms:.4f}; device time, enqueue hidden, {dev_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms (device {lib_dev_ms:.4f};"
        f" differs by {lib_err:.2e}), bound {bound_ms:.4f} ms ({by}, {nbytes}"
        f" B, {flops:.4g} flops)")
    return dict(ms=ms, ms_l2_warm=warm_ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms, library_device_ms=lib_dev_ms)


def serving_dense_inputs(lengths, seed):
    """bf16 q [8, K, G, hd] and a dense cache [8, 512, K, hd] at granite's
    K=8, G=4, hd=128 (phase 9's layer slab: 4 clients x 2 slots, max_seq
    512), positions 15 past each of phase 4's 8 prompts, as ``attn_rows``
    places them."""
    B, T, K, G, hd = 8, 512, 8, 4, 128
    g = gen(seed)
    q = torch.randn((B, K, G, hd), generator=g, device=DEV).to(torch.bfloat16)
    k = torch.randn((B, T, K, hd), generator=g, device=DEV).to(torch.bfloat16)
    v = torch.randn((B, T, K, hd), generator=g, device=DEV).to(torch.bfloat16)
    pos = torch.tensor([n + 15 for n in lengths[:B]], dtype=torch.int32,
                       device=DEV)
    return q, k, v, pos


def time_dense_decode(q, k, v, pos, label, errs, phase="phase 5"):
    """Dense decode over q [B, K, G, hd] and a cache [B, T, K, hd], first
    held against its plain version on the same inputs (bf16 tolerance; the
    error appended to ``errs``); library: SDPA with a position mask and
    GQA."""
    B, K, G, hd = q.shape
    T = k.shape[1]
    e = compare(f"[{phase}] {label} against plain",
                da.decode_attn_cuda(q, k, v, pos),
                plain_op(kernels.decode_attn, q, k, v, pos), BF16_TOL)
    errs.append(e)
    log(f"[{phase}] {label}: kernel against plain max_abs_err={e:.3e} "
        f"({BF16_TOL})")
    mask = (torch.arange(T, device=DEV)[None, :] <= pos[:, None].long())
    mask = mask[:, None, None, :]

    def library():
        out = sdpa_gqa(q.reshape(B, K * G, 1, hd), k.transpose(1, 2),
                       v.transpose(1, 2), attn_mask=mask)
        return out.reshape(B, K, G, hd)
    tokens = int((pos.long() + 1).sum())
    nbytes = 2 * q.numel() * 2 + 2 * tokens * K * hd * 2 + pos.numel() * 4
    return timing_fields(
        label, lambda: da.decode_attn_cuda(q, k, v, pos),
        lambda: plain_call(kernels.decode_attn, q, k, v, pos), library,
        nbytes, 4 * tokens * K * G * hd,
        f"q {list(q.shape)} cache {list(k.shape)}, {tokens} live tokens",
        phase=phase)


def visible_pairs(S, T, window):
    """(query, key) pairs a causal mask with this window lets through."""
    i = torch.arange(S, dtype=torch.float64)
    n = torch.clamp(i + 1, max=T)
    if window:
        n = torch.clamp(n, max=window)
    return int(n.sum())


def time_flash(S=None, K=None, window=0):
    """Causal flash attention on the tensor-core entry point; library: SDPA
    ``is_causal`` (with a window, an explicit mask). The kernel's and
    SDPA's max errors against the plain version in fp32 are logged side by
    side."""
    q, k, v = flash_inputs(11, S, K)
    B, S, H, hd = q.shape
    K = k.shape[2]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if window:
        t = torch.arange(S, device=DEV)
        mask = (t[:, None] >= t[None, :]) & (t[:, None] - t[None, :] < window)
        kw = dict(attn_mask=mask)
    else:
        kw = dict(is_causal=True)

    def library():
        return sdpa_gqa(qh, kh, vh, **kw).transpose(1, 2)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())   # q, k, v, out
    flops = 4 * B * H * hd * visible_pairs(S, S, window)
    before = dict(fa.flash_attn_cuda.by_entry)
    want = plain_op(kernels.flash_attn, q, k, v, window=window)
    err = (fa.flash_attn_cuda(q, k, v, window=window).float() - want).abs()
    lib_err = (library().float() - want).abs()
    del want
    out = timing_fields(
        "flash_attn", lambda: fa.flash_attn_cuda(q, k, v, window=window),
        lambda: plain_call(kernels.flash_attn, q, k, v, window=window),
        library, nbytes, flops,
        f"q [{B},{S},{H},{hd}] k/v [{B},{S},{K},{hd}] causal window {window}")
    took = {e: c - before[e] for e, c in fa.flash_attn_cuda.by_entry.items()}
    if took[fa.SIMT] or not took[fa.WGMMA]:
        raise AssertionError(f"[phase 5] flash_attn bf16 took the entry "
                             f"points {took}")
    log(f"[phase 5] flash_attn [{B},{S},{H},{hd}] window {window}: every "
        f"launch on the tensor cores ({took[fa.WGMMA]}); device time, enqueue "
        f"hidden, {out['device_ms']:.4f} ms; "
        f"{flops / out['ms'] / 1e9:.1f} TFLOP/s, {out['ms'] / out['library_ms']:.2f}x "
        f"SDPA; max (mean) abs err against the plain version in fp32: "
        f"kernel {float(err.max()):.3e} ({float(err.mean()):.3e}), SDPA "
        f"{float(lib_err.max()):.3e} ({float(lib_err.mean()):.3e})")
    return out


def time_ragged(w, n_live, budget):
    """One packed projection over phase 4's weight ``w`` (no bias, as
    granite's). Library: ``torch.addmm`` over the whole buffer, which
    computes every row and does not zero those past the live count."""
    g = gen(12)
    din, dout = w.shape
    x = torch.randn((budget, din), generator=g, device=DEV).to(w.dtype)
    b = torch.zeros((dout,), dtype=w.dtype, device=DEV)
    nbytes = 2 * (n_live * din + din * dout + budget * dout)
    before = dict(rl.ragged_linear_cuda.by_entry)
    out = timing_fields(
        "ragged_linear", lambda: rl.ragged_linear_cuda(x, w, None, n_live),
        lambda: plain_call(kernels.ragged_linear, x, w, None, n_live),
        lambda: torch.addmm(b, x, w), nbytes, 2 * n_live * din * dout,
        f"buf [{budget},{din}] @ w [{din},{dout}], n_live {n_live}",
        rows=n_live)
    took = {e: c - before[e] for e, c in rl.ragged_linear_cuda.by_entry.items()}
    if took[rl.SIMT] or not took[rl.WGMMA]:
        raise AssertionError(f"[phase 5] ragged_linear at a granite shape "
                             f"took the entry points {took}")
    log(f"[phase 5] ragged_linear {budget}x{din}x{dout}: every launch on the "
        f"tensor cores ({took[rl.WGMMA]}); {out['ms'] / out['library_ms']:.2f}x "
        f"addmm, {2 * n_live * din * dout / out['ms'] / 1e9:.1f} TFLOP/s")
    return out


# ---------------------------------------------------------------------------
# phase 6: the public kernel ops and the packed base executor
# ---------------------------------------------------------------------------

PROJECTIONS = (("q", "attn", "wq"), ("k", "attn", "wk"), ("v", "attn", "wv"),
               ("o", "attn", "wo"), ("gate", "mlp", "gate"),
               ("up", "mlp", "up"), ("down", "mlp", "down"))
SEGMENTS = ((37, 200, 64, 700), (37, 200, 64, 729))   # 1,001 and 1,030 tokens


def ragged_device_ms(fn):
    """Run ``fn`` once traced by torch.profiler (device activity only):
    (device ms in the ragged-linear kernels, their count, all device ms,
    traced wall s between synchronisations, the other kernels' (ms, count,
    name) by device time)."""
    with traced() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = [e for e in kern if "ragged_linear" in e.name]
    others = {}
    for e in kern:
        if "ragged_linear" not in e.name:
            ms, n = others.get(e.name, (0.0, 0))
            others[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(((ms, n, name) for name, (ms, n) in others.items()),
                 reverse=True)
    return (sum(e.time_range.elapsed_us() for e in mine) / 1e3, len(mine),
            sum(e.time_range.elapsed_us() for e in kern) / 1e3, wall, top)


def base_executor_path(cfg, base):
    """Every (layer, projection) of ``base`` through one ``BaseExecutor``,
    for each segment set: a pass timed between synchronisations, every
    call one launch on the tensor-core entry point and every output held
    against ``frozen_dense``; then the same pass again, traced, for the
    device time in the ragged-linear kernels."""
    weights = {(i, path): (layer[grp][name], None)
               for i, layer in enumerate(base["layers"])
               for path, grp, name in PROJECTIONS}
    ex = BaseExecutor(weights, device=DEV)
    if any(ex.weights[key][0] is not w for key, (w, _) in weights.items()):
        raise AssertionError("[phase 6] the executor copied a weight")
    g = gen(13)
    by_entry = rl.ragged_linear_cuda.by_entry
    for lens in SEGMENTS:
        segs = {din: [torch.randn((n, din), generator=g, device=DEV)
                      .to(torch.bfloat16) for n in lens]
                for din in {w.shape[0] for w, _ in weights.values()}}
        worst, wall = 0.0, 0.0
        for key, (w, _) in weights.items():
            before = dict(by_entry)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = ex.run_layer(*key, segs[w.shape[0]])
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            took = {e: c - before[e] for e, c in by_entry.items()}
            if took != {rl.WGMMA: 1, rl.SIMT: 0}:
                raise AssertionError(f"[phase 6] {key}: ragged-linear "
                                     f"launches {took}, not one on the "
                                     "tensor cores")
            for s, o in zip(segs[w.shape[0]], outs):
                worst = max(worst, compare(f"[phase 6] {key}", o,
                                           frozen_dense(s, w), BF16_TOL))
        total = sum(lens)
        budget = _bucket(total)
        flops = 2 * total * sum(w.numel() for w, _ in weights.values())
        log(f"[phase 6] base executor, {cfg.name}: {len(weights)} packed "
            f"projections ({cfg.n_layers} layers x {len(PROJECTIONS)}), "
            f"segments {list(lens)} = {total} tokens in budget {budget} "
            f"({-(-total // 128)} of {budget // 128} row tiles live): "
            f"{wall:.3f} s synchronised, {total * len(weights) / wall:.0f} "
            f"token-projections/s, {flops / wall / 1e12:.2f} TFLOP/s; max "
            f"abs err against frozen_dense {worst:.3e} (bf16, {BF16_TOL}); "
            "every launch on the tensor cores")

        def again():
            for key, (w, _) in weights.items():
                ex.run_layer(*key, segs[w.shape[0]])
        dev_ms, n, all_ms, traced, top = ragged_device_ms(again)
        if n != len(weights):
            raise AssertionError(f"[phase 6] traced pass: {n} ragged-linear "
                                 f"kernels, not {len(weights)}")
        log(f"[phase 6]   traced again: {dev_ms:.3f} ms of device time in "
            f"{n} ragged-linear kernels ({flops / dev_ms / 1e9:.1f} TFLOP/s) "
            f"and {all_ms:.3f} ms in all kernels, against {wall * 1e3:.3f} "
            f"ms synchronised unprofiled ({traced * 1e3:.3f} ms traced): the "
            f"host holds {100 * (1 - all_ms / (wall * 1e3)):.1f}% of the "
            "unprofiled pass; the other kernels by device time:")
        for ms, count, name in top[:4]:
            log(f"[phase 6]     {ms:8.3f} ms  {count:5d}x  {name[:90]}")
    if ex.stats["calls"] != 2 * len(SEGMENTS) * len(weights):
        raise AssertionError(f"[phase 6] executor stats {ex.stats}")
    log(f"[phase 6] executor stats {ex.stats}")


def public_ops():
    """``kernels.decode_attn`` (dense: two launches, split and combine) and
    ``kernels.flash_attn`` (one) at phase 6's shapes, against their plain
    versions."""
    q, k, v, pos = dense_inputs(14)
    cache = list(k.shape)
    before = launch_count("decode_attn")
    got = kernels.decode_attn(q, k, v, pos)
    if launch_count("decode_attn") != before + 2:
        raise AssertionError("[phase 6] kernels.decode_attn did not launch "
                             "the dense split and combine kernels once each")
    e1 = compare("[phase 6] decode_attn", got,
                 plain_op(kernels.decode_attn, q, k, v, pos), BF16_TOL)
    q, k, v = flash_inputs(15)
    before = fa.flash_attn_cuda.by_entry[fa.WGMMA]
    got = kernels.flash_attn(q, k, v)
    if fa.flash_attn_cuda.by_entry[fa.WGMMA] != before + 1:
        raise AssertionError("[phase 6] kernels.flash_attn did not launch "
                             "the tensor-core flash kernel once")
    e2 = compare("[phase 6] flash_attn", got,
                 plain_op(kernels.flash_attn, q, k, v), BF16_TOL)
    log(f"[phase 6] kernels.decode_attn dense {cache} bf16, pos "
        f"{pos.tolist()}: max abs err {e1:.3e}; kernels.flash_attn "
        f"{list(q.shape)} causal: max abs err {e2:.3e} (against the plain "
        "versions)")


def time_unserved(base, lengths, dense_errs):
    """Phase 5 for the dense decode kernel at phase 9's serving shape (the
    kernel line's timing) and at phase 6's, and for the kernels of phase 6
    at its shapes, a granite projection of phase 4's own weights for the
    ragged linear; and two logged extras, gemma2-27b's windowed prefill and
    the ragged linear's dead-tile skip."""
    B, S, H, K, hd = FLASH_SHAPE
    up = base["layers"][0]["mlp"]["up"]
    out = {"decode_attn": time_dense_decode(
        *serving_dense_inputs(lengths, 16), "decode_attn (phase 9 slab)",
        dense_errs),
        "flash_attn": time_flash(),
        "ragged_linear": time_ragged(up, sum(SEGMENTS[0]), 1024)}
    time_dense_decode(*dense_inputs(10), "decode_attn (phase 6)", dense_errs)
    time_flash(S=2 * S, K=2 * K, window=S)   # gemma2-27b: K=16, window 4096
    skip = time_ragged(up, sum(SEGMENTS[1]), 2048)["ms"]
    full = time_ragged(up, 2048, 2048)["ms"]
    log(f"[phase 5] ragged_linear dead-tile skip at budget 2048: "
        f"{skip:.4f} ms with {sum(SEGMENTS[1])} live rows against "
        f"{full:.4f} ms with all 2048 live (L2-cold)")
    return out


PATH6 = ("decode_attn", "flash_attn", "ragged_linear")


def phase6(cfg, base):
    """The base executor and the public ops with every launch count set to
    0 just before and read just after; returns phase 6's counts of its
    kernels after checking them: one ragged linear per (pass, layer,
    projection), two passes (timed, traced) per segment set, all on the
    tensor cores; two dense decode launches (split, combine), one flash,
    nothing else."""
    reset_counts()
    base_executor_path(cfg, base)
    public_ops()
    torch.cuda.synchronize()
    counts = read_counts()
    want = {n: 0 for n in KERNELS}
    want.update(decode_attn=2, flash_attn=1, ragged_linear=2 * len(SEGMENTS)
                * cfg.n_layers * len(PROJECTIONS))
    entries = dict(rl.ragged_linear_cuda.by_entry)
    flash = dict(fa.flash_attn_cuda.by_entry)
    if counts != want or entries[rl.SIMT] or flash[fa.SIMT]:
        raise AssertionError(f"[phase 6] launches {counts} ({entries}, "
                             f"flash {flash}), expected {want}, none on a "
                             "SIMT entry")
    log(f"[phase 6] launches {counts} (as expected; ragged_linear by entry "
        f"point {entries}, flash_attn {flash})")
    return {n: counts[n] for n in PATH6}


# ---------------------------------------------------------------------------
# phase 7: fine-tuning on the card
# ---------------------------------------------------------------------------

F32_STEP_TOL = dict(atol=1e-4, rtol=1e-4)
# 7b: job 0 in the bank against its solo run, bf16 (reading on the H100:
# 3.9e-4 on losses of ~11 that move ~1e-2 a step)
LOSS_7B_TOL = dict(atol=2e-3, rtol=0.0)
# its adapter's update (final minus initial) against the solo run's, in
# relative norm: a missing or doubled update reads 1; Adam's first steps
# move each weight by ~lr * sign(grad), so a weight whose grad is within
# bf16 rounding of zero may step the other way in one of the two runs
UPDATE_7B_REL = 0.25
# kernel-name fragments of cuBLAS's matrix products on the H100
GEMM_NAMES = ("nvjet", "gemm", "xmma", "cutlass")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 256, 3


def state_tol(want):
    """7a's tolerance for one adapter or AdamW leaf: rtol 1e-4 and an atol
    of 1e-3 of the leaf's largest magnitude, at most 1e-4, so a second
    moment of ~1e-6 is held to its own scale."""
    return dict(atol=min(1e-4, 1e-3 * float(want.abs().max())), rtol=1e-4)


def tree_clone(tree):
    return tree_map(lambda x: x.clone(), tree)


def random_lora(cfg, n, seed, acfg=LORA):
    """``n`` LoRA trees of ``acfg`` stacked on a leading axis, fp32, A and
    B drawn (a fresh adapter's B is zero, which would leave the B grads
    alone)."""
    g = gen(seed)
    bank = adapters.init_client_bank(cfg, acfg, n, g, device=DEV)
    for leaf in _adapter_leaves(bank):
        leaf["B"].copy_(torch.randn(leaf["B"].shape, generator=g, device=DEV)
                        * 0.02)
    return bank


def train_batches(cfg, n_rows, seed):
    """One step's batch for ``n_rows`` jobs, [R, B, S], from the synthetic
    pipeline."""
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=TRAIN_S,
                            n_clients=n_rows, batch_per_client=TRAIN_B,
                            seed=seed, device=DEV)
    return ds.batch(0)


def step7a_hyper(R):
    return {"step": torch.tensor([0, 3, 1, 7][:R], dtype=torch.int32,
                                 device=DEV),
            "lr": torch.tensor([1e-3, 3e-4, 2e-3, 5e-4][:R], device=DEV),
            "warmup": torch.tensor([2.0, 0.0, 1.0, 3.0][:R], device=DEV),
            "total": torch.tensor([10.0, 8.0, 6.0, 20.0][:R], device=DEV),
            "wd": torch.tensor([0.0, 0.1, 0.0, 0.01][:R], device=DEV),
            "gnorm": torch.tensor([1.0, float("inf"), 0.5, 2.0][:R],
                                  device=DEV)}


def compact_rows_check(cfg, base, acfg, bank, batch_seed, label):
    """The compact step for 4 rows of ``bank`` (8 slots, fp32) against
    each row's ``make_baseline_train_step``; then a call with a padding row
    and a NaN-poisoned row, against the same call unpoisoned."""
    R, cap = 4, 8
    slots = torch.tensor([5, 2, 7, 0], dtype=torch.int32, device=DEV)
    opt = AdamWState(step=torch.arange(cap, dtype=torch.int32, device=DEV),
                     m=tree_map(lambda x: torch.randn_like(x) * 1e-3, bank),
                     v=tree_map(lambda x: torch.rand_like(x) * 1e-6, bank))
    batch = train_batches(cfg, R, batch_seed)
    hyper = step7a_hyper(R)
    step = symbiosis.make_compact_train_step(cfg, acfg, remat=False)
    start = (tree_clone(bank), tree_clone(opt))
    t0 = time.perf_counter()
    new_bank, new_opt, m = step(base, tree_clone(bank), tree_clone(opt),
                                batch, slots, torch.ones(R, dtype=torch.bool,
                                                         device=DEV), hyper)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    if not m["finite"].all():
        raise AssertionError(f"{label} non-finite rows {m['finite']}")
    worst = 0.0
    for i in range(R):
        s = int(slots[i])
        tcfg = TrainConfig(lr=float(hyper["lr"][i]),
                           warmup_steps=int(hyper["warmup"][i]),
                           total_steps=int(hyper["total"][i]),
                           weight_decay=float(hyper["wd"][i]),
                           max_grad_norm=(0.0 if torch.isinf(hyper["gnorm"][i])
                                          else float(hyper["gnorm"][i])),
                           remat=False)
        solo = symbiosis.make_baseline_train_step(cfg, acfg, tcfg)
        a, o, sm = solo(base, tree_map(lambda x: x[s].clone(), start[0]),
                        tree_map(lambda x: x[s].clone(), start[1]),
                        {k: v[i] for k, v in batch.items()},
                        int(hyper["step"][i]))
        worst = max(worst, compare(f"{label} row {i} loss", m["loss"][i],
                                   sm["loss"], F32_STEP_TOL))
        for name, x, y in (("adapter", new_bank, a), ("m", new_opt.m, o.m),
                           ("v", new_opt.v, o.v)):
            for xl, yl in zip(tree_leaves(x), tree_leaves(y)):
                worst = max(worst, compare(f"{label} row {i} {name}",
                                           xl[s], yl, state_tol(yl)))
    log(f"{label} {cfg.name} width, 2 layers, fp32, {acfg.method} "
        f"{acfg.targets}: compact step over {R} rows x {TRAIN_B} x "
        f"{TRAIN_S} tokens ({t_step * 1e3:.1f} ms, first call) against each "
        f"row's make_baseline_train_step: losses "
        f"{[round(float(x), 4) for x in m['loss']]}, max abs err {worst:.3e}"
        f" (losses {F32_STEP_TOL}; states rtol 1e-4, atol 1e-3 x max|leaf| "
        f"up to 1e-4)")

    mask = torch.tensor([True, True, True, False], device=DEV)
    clean = dict(batch, mask=torch.ones(batch["labels"].shape, device=DEV))
    poisoned = dict(clean, mask=clean["mask"].clone())
    poisoned["mask"][1] = float("nan")                  # the row at slot 2
    outs = []
    for b in (clean, poisoned):
        st = step(base, tree_clone(start[0]), tree_clone(start[1]), b, slots,
                  mask, hyper)
        outs.append(st)
    if not outs[0][2]["finite"].all() or bool(outs[1][2]["finite"][1]) \
            or not outs[1][2]["finite"][[0, 2]].all():
        raise AssertionError(f"{label} probes {outs[0][2]['finite']} / "
                             f"{outs[1][2]['finite']}")
    for full, ref, before in zip(tree_leaves(outs[1][:2]),
                                 tree_leaves(outs[0][:2]),
                                 tree_leaves(start)):
        for s in (2, 0, 1, 3, 4, 6):       # poisoned, padding, outside
            if not torch.equal(full[s], before[s]):
                raise AssertionError(f"{label} slot {s} changed")
        for s in (5, 7):                   # survivors
            if not torch.equal(full[s], ref[s]):
                raise AssertionError(f"{label} survivor slot {s} differs "
                                     "from the unpoisoned run")
    log(f"{label} {acfg.method}: a padding row and a NaN-poisoned row "
        "committed nothing (their slots and the slots outside the call bit "
        "for bit); the other rows equal the unpoisoned call bit for bit")


def f32_granite(n_layers=2):
    return dataclasses.replace(get_config("granite-3-8b"), n_layers=n_layers,
                               dtype="float32", param_dtype="float32")


def check_step_on_card():
    """7a: granite-3-8b's width, 2 layers, fp32 (TF32 off): the compact
    step's rows against their solo steps, a padding and a NaN row
    (``compact_rows_check``); then ``frozen_dense``'s dx and residuals."""
    cfg = f32_granite()
    base = get_model(cfg).init_params(gen(70), DEV)
    bank = tree_map(lambda x: x.repeat((2,) + (1,) * (x.ndim - 1)),
                    random_lora(cfg, 4, 71))
    compact_rows_check(cfg, base, LORA, bank, 72, "[phase 7a]")

    g = gen(73)
    x = torch.randn((TRAIN_B * TRAIN_S, cfg.d_model), generator=g,
                    device=DEV, requires_grad=True)
    w = base["layers"][0]["mlp"]["up"]
    gy = torch.randn((x.shape[0], w.shape[1]), generator=g, device=DEV)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = frozen_dense(x, w)
    (dx,) = torch.autograd.grad(y, [x], gy)
    x2 = x.detach().requires_grad_(True)
    (dx_ref,) = torch.autograd.grad(x2 @ w, [x2], gy)
    e = compare("[phase 7a] frozen_dense dx", dx, dx_ref, F32_TOL)
    if saved != [tuple(w.shape)]:
        raise AssertionError(f"[phase 7a] frozen_dense saved {saved}")
    log(f"[phase 7a] frozen_dense [{x.shape[0]}, {w.shape[0]}] @ "
        f"{list(w.shape)}: dx max abs err {e:.3e} against autograd through "
        f"x @ w ({F32_TOL}); saved for the backward: {saved} (the weight "
        "only)")
    del base, bank
    torch.cuda.empty_cache()


def train_jobs(cfg, n, steps=TRAIN_STEPS, first_seed=0, acfg=LORA,
               batch=TRAIN_B, lr=1e-3, warmup=1):
    """``n`` jobs of ``acfg`` over ``batch`` x ``TRAIN_S`` tokens (a VLM's
    after its image prefix)."""
    return [FinetuneJob(acfg=acfg, batch_size=batch, seq_len=TRAIN_S,
                        steps=steps, lr=lr, warmup_steps=warmup,
                        seed=first_seed + i, name=f"job-{first_seed + i}",
                        data=make_job_stream(cfg, batch, TRAIN_S,
                                             seed=first_seed + i, device=DEV))
            for i in range(n)]


def solo_run(cfg, base, job):
    """The job alone through ``make_baseline_train_step`` (its method, the
    torch-like baseline) from the adapter the engine initialises for its
    seed: its losses, the initial adapter and the final one."""
    tcfg = TrainConfig(lr=job.lr, weight_decay=job.weight_decay,
                       warmup_steps=job.warmup_steps,
                       total_steps=job.schedule_total,
                       max_grad_norm=job.max_grad_norm, remat=False)
    step = symbiosis.make_baseline_train_step(cfg, job.acfg, tcfg)
    gen_ = torch.Generator(device=DEV).manual_seed(job.seed)
    a = adapters.init_adapter(cfg, job.acfg, gen_, device=DEV)
    first = tree_clone(a)
    o = adamw_init(a)
    stream = make_job_stream(cfg, TRAIN_B, TRAIN_S, seed=job.seed, device=DEV)
    out = []
    for t in range(job.steps):
        a, o, m = step(base, a, o, stream.batch(t), t)
        out.append(float(m["loss"]))
    return out, first, a


def update_rel_diff(got, want, first):
    """|| (got - first) - (want - first) || / || want - first || over every
    leaf: how far one run's optimizer updates are from another's (a
    missing update reads 1)."""
    num = den = 0.0
    for g, w, f in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(first)):
        num += float(((g.float() - w.float()) ** 2).sum())
        den += float(((w.float() - f.float()) ** 2).sum())
    return (num / den) ** 0.5


def timed_ticks(eng):
    """Drive ``eng`` to the end; host-clock seconds of each train tick
    (synchronised)."""
    ticks = []
    more = True
    while more:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = eng.train_tick()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t0)
    return ticks


def serve_train(cfg, base):
    """7b: the service at full size behind a router whose slot holds 4
    jobs' charges, not 5; returns the 4 jobs' losses and tick times."""
    jobs = train_jobs(cfg, 5)
    charge = job_charge_bytes(cfg, jobs[0])
    router = PlacementRouter(cfg, [Slot(0, free_hbm=4.5 * charge)])
    eng = FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()), base,
                         device=DEV, router=router)
    admitted = {}
    try_admit = eng._try_admit

    def record(job):
        ok = try_admit(job)
        if ok:
            admitted[job.name] = eng.stats["train_ticks"]
        return ok
    eng._try_admit = record
    for j in jobs:
        eng.submit(j)
    ticks = timed_ticks(eng)
    if len(eng.finished) != 5 or any(j.status != "finished" for j in jobs):
        raise AssertionError(f"[phase 7b] statuses {[j.status for j in jobs]}")
    losses = [j.losses for j in jobs]
    if not all(len(x) == TRAIN_STEPS and np.isfinite(x).all()
               for x in losses):
        raise AssertionError(f"[phase 7b] losses {losses}")
    if admitted["job-4"] < TRAIN_STEPS or eng.stats["peak_jobs"] != 4:
        raise AssertionError(f"[phase 7b] the router never held job 4 back: "
                             f"admitted at {admitted}, peak "
                             f"{eng.stats['peak_jobs']}")
    used = router.utilization()
    if router.conservation_errors() or used["committed_bytes"] \
            or used["placements"]:
        raise AssertionError(f"[phase 7b] router after the drain: "
                             f"{router.conservation_errors()}, {used}")
    solo, first, solo_adapter = solo_run(cfg, base, jobs[0])
    e = compare("[phase 7b] job 0 losses against its solo run",
                torch.tensor(losses[0]), torch.tensor(solo), LOSS_7B_TOL)
    upd = update_rel_diff(jobs[0].result.adapter, solo_adapter, first)
    if not upd <= UPDATE_7B_REL:
        raise AssertionError(f"[phase 7b] job 0's adapter update is {upd:.3e}"
                             f" (relative norm) from its solo run's, limit "
                             f"{UPDATE_7B_REL}")
    st = eng.stats
    tokens = TRAIN_B * TRAIN_S
    steady = ticks[1:TRAIN_STEPS]            # 4 rows, after the first tick
    log(f"[phase 7b] {cfg.name}: {cfg.n_layers} layers bf16, 5 LoRA jobs "
        f"(rank {LORA.rank}, q and v, {TRAIN_B} x {TRAIN_S} tokens, "
        f"{TRAIN_STEPS} steps each), router slot {4.5 * charge:.0f} B for "
        f"job charges of {charge} B: job 4 admitted at tick "
        f"{admitted['job-4']} (the others at 0); {st['train_ticks']} train "
        f"ticks, {st['train_steps']} steps, {st['train_tokens']} tokens, "
        f"stats {st}; router ledger conserved and empty after the drain")
    log(f"[phase 7b] losses {[[round(x, 4) for x in l] for l in losses]}; "
        f"job 0 against its solo make_baseline_train_step: {solo} (max abs "
        f"err {e:.3e}, {LOSS_7B_TOL}); its adapter's update against the "
        f"solo run's: {upd:.3e} relative norm (limit {UPDATE_7B_REL})")
    log(f"[phase 7b] tick ms (host clock, synchronised): "
        f"{[round(t * 1e3, 3) for t in ticks]}; 4-row ticks after the "
        f"first: {4 * tokens} tokens per tick, "
        f"{statistics.median(steady) * 1e3:.3f} ms median, "
        f"{4 * tokens / statistics.median(steady):.0f} tokens/s")
    return losses[:4], ticks


def profile_train_tick(cfg, base):
    """One 4-row train tick traced by torch.profiler (device activity only)
    after three unprofiled ones: device busy time, kernels per tick and the
    top kernels by device time."""
    eng = FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()), base,
                         device=DEV)
    for j in train_jobs(cfg, 4, steps=6, first_seed=10):
        eng.submit(j)
    eng.train_tick()
    ticks = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.train_tick()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t0)
    tick_ms = statistics.median(ticks) * 1e3
    with traced() as prof:
        t0 = time.perf_counter()
        eng.train_tick()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, n_kern, by_name = device_profile(prof)
    if not n_kern:
        log(f"[phase 7b] train tick (4 rows): {tick_ms:.3f} ms median "
            "unprofiled; the profiler saw no device events: device busy "
            "not measured")
        return
    gemm = [(n, d) for name, (n, d) in by_name.items()
            if any(k in name for k in GEMM_NAMES)]
    gemm_ms = sum(d for _, d in gemm) / 1e3
    log(f"[phase 7b] train tick (4 rows x {TRAIN_B * TRAIN_S} tokens): "
        f"{tick_ms:.3f} ms median of 3 unprofiled, {traced_ms:.3f} ms traced;"
        f" device busy {busy_ms:.3f} ms = {100 * busy_ms / tick_ms:.1f}% of "
        f"the unprofiled tick; {n_kern} kernels per tick, "
        f"{sum(n for n, _ in gemm)} of them matrix products taking "
        f"{gemm_ms:.3f} ms ({100 * gemm_ms / busy_ms:.1f}% of the busy time); "
        "top kernels:")
    for name, (n, d) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"[phase 7b]   {d / 1e3:8.3f} ms  {n:5d}x  {name[:90]}")


def train_memory(cfg, base):
    """7c: peak device memory beyond what is resident (base, bank) for one
    bank step at 1 and 4 jobs, with the §3.6 path and the torch-like
    baseline, at FinetuneConfig's remat. Printed, not asserted."""
    remat = FinetuneConfig().remat
    out = {}
    for mo in (True, False):
        step = symbiosis.make_compact_train_step(cfg, LORA, remat=remat,
                                                 memory_optimized=mo)
        for R in (1, 4):
            bank = random_lora(cfg, R, 74)
            opt = AdamWState(step=torch.zeros(R, dtype=torch.int32,
                                              device=DEV),
                             m=tree_map(torch.zeros_like, bank),
                             v=tree_map(torch.zeros_like, bank))
            batch = train_batches(cfg, R, 75)
            hyper = step7a_hyper(R)
            args = (torch.arange(R, dtype=torch.int32, device=DEV),
                    torch.ones(R, dtype=torch.bool, device=DEV))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            step(base, bank, opt, batch, *args, hyper)
            torch.cuda.synchronize()
            out[(mo, R)] = (torch.cuda.max_memory_allocated() - before) / 2**30
            del bank, opt, batch
    torch.cuda.empty_cache()
    log(f"[phase 7c] peak device memory beyond the resident base and bank, "
        f"one bank step ({cfg.n_layers} layers bf16, {TRAIN_B} x {TRAIN_S} "
        f"tokens per job, remat={remat}), GiB: " + "; ".join(
            f"{'§3.6' if mo else 'baseline'} {R} job{'s' if R > 1 else ''} "
            f"{gib:.3f}" for (mo, R), gib in out.items()))
    for R in (1, 4):
        log(f"[phase 7c] {R} job(s): the baseline holds "
            f"{out[(False, R)] - out[(True, R)]:.3f} GiB more than §3.6")
    log(f"[phase 7c] from 1 to 4 jobs: §3.6 grows "
        f"{out[(True, 4)] / out[(True, 1)]:.2f}x, the baseline "
        f"{out[(False, 4)] / out[(False, 1)]:.2f}x")
    return out


def serve_and_train(cfg, base, bank, streams4, launches4, times4, losses7b,
                    ticks7b):
    """7d: one SymbiosisEngine over the same base object: phase 4's 8
    requests beside 7b's first 4 jobs, every launch count set to 0 just
    before and read just after."""
    spec = dataclasses.replace(serve_spec(cfg, quant=False),
                               finetune=FinetuneConfig())
    sym = SymbiosisEngine.from_spec(spec, base, serving_banks=[bank],
                                    device=DEV)
    if sym.serving.base is not base or sym.finetune.base is not base:
        raise AssertionError("[phase 7d] an engine holds another base")
    reqs = make_requests(cfg, 4)
    jobs = train_jobs(cfg, 4)
    for item in reqs + jobs:
        sym.submit(item)
    L = cfg.n_layers
    serving = sym.serving
    attn, sgmv = KERNELS["paged_decode_attn"][0], KERNELS["sgmv"][0]
    tick_t, serve_t, train_t = [], [], []
    serving.service_tick = _timed(serving.service_tick, serve_t)
    sym.finetune.train_tick = _timed(sym.finetune.train_tick, train_t)
    prefill_t = []
    serving._prefill_step = _timed(serving._prefill_step, prefill_t)
    torch.cuda.synchronize()
    reset_counts()
    more = True
    while more:
        before = (attn.launches, sgmv.launches, serving.stats["ticks"],
                  serving.stats["compact_prefill_batches"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = sym.tick()
        torch.cuda.synchronize()
        tick_t.append(time.perf_counter() - t0)
        d_at, d_sg, d_tick, d_pre = (a - b for a, b in zip(
            (attn.launches, sgmv.launches, serving.stats["ticks"],
             serving.stats["compact_prefill_batches"]), before))
        if d_at != L * d_tick or d_sg != 2 * L * (d_tick + d_pre):
            raise AssertionError(f"[phase 7d] a tick launched {d_at} "
                                 f"attention and {d_sg} SGMV kernels for "
                                 f"{d_tick} decode ticks, {d_pre} prefills")
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != launches4:
        raise AssertionError(f"[phase 7d] launches {counts}, phase 4's "
                             f"serving path launched {launches4}")
    done_r, done_j = serving.drain_done(), sym.finetune.finished
    if len(done_r) != 8 or len(done_j) != 4:
        raise AssertionError(f"[phase 7d] {len(done_r)} requests and "
                             f"{len(done_j)} jobs finished")
    for i, r in enumerate(reqs):
        if not np.array_equal(r.generated, streams4[i]):
            raise AssertionError(f"[phase 7d] request {i}'s greedy stream "
                                 "differs from phase 4's")
    worst = 0.0
    for j, want_l in zip(jobs, losses7b):
        got, ref = np.array(j.losses), np.array(want_l)
        rel = np.abs(got - ref) / np.abs(ref)
        if got.shape != ref.shape or not (rel <= 1e-3).all():
            raise AssertionError(f"[phase 7d] {j.name} losses {got} against "
                                 f"7b's {ref}")
        worst = max(worst, float(rel.max()))
    st = sym.stats
    log(f"[phase 7d] SymbiosisEngine over phase 4's base object: 8 requests "
        f"beside 4 jobs in {st['ticks']} ticks ({st['decode_ticks']} serving,"
        f" {st['train_ticks']} train); every greedy stream equals phase 4's "
        f"exactly; job losses equal 7b's (max relative difference "
        f"{worst:.2e}, limit 1e-3); launches {counts}, the serving path's of "
        f"phase 4 (checked tick by tick)")
    ms = lambda ts: [round(t * 1e3, 3) for t in ts]
    n_pre = serving.stats["compact_prefill_batches"]
    log(f"[phase 7d] tick ms (host clock, synchronised; each a serving tick, "
        f"the first {TRAIN_STEPS} then a train tick, the first {n_pre} with "
        f"an admission's prefill): {ms(tick_t)}; of which serving "
        f"{ms(serve_t)}, training {ms(train_t)}, prefill steps "
        f"{ms(prefill_t)}")
    log(f"[phase 7d] medians beside the engines alone: train tick after the "
        f"first {statistics.median(train_t[1:]) * 1e3:.3f} ms (7b "
        f"{statistics.median(ticks7b[1:TRAIN_STEPS]) * 1e3:.3f}); serving "
        f"tick without admission "
        f"{statistics.median(serve_t[n_pre:]) * 1e3:.3f} ms (phase 4 "
        f"{times4['tick_ms']:.3f}); prefill step "
        f"{statistics.median(prefill_t) * 1e3:.3f} ms")


def phase7(cfg, base, bank, streams4, launches4, times4):
    """Fine-tuning on the card: 7a the step at full width, 7b the service
    at full size, 7c memory, 7d serving and training on one base."""
    check_step_on_card()
    losses7b, ticks7b = serve_train(cfg, base)
    profile_train_tick(cfg, base)
    peaks = train_memory(cfg, base)
    serve_and_train(cfg, base, bank, streams4, launches4, times4, losses7b,
                    ticks7b)
    return peaks


# ---------------------------------------------------------------------------
# phase 8: mixed-method banks and shared-prefix pages
# ---------------------------------------------------------------------------

# the serving schedule: each client of the first banks sends, P8_EVERY
# ticks apart, its own 232-token template followed by 40 tokens, 1, 24 and
# another 1 (the two single tokens differ); the bank admitted at tick
# P8_ADMIT sends template + 40 and template + 1 from tick P8_LATE_FIRST.
# Every request takes 16 new tokens, greedy; 4 slots per client.
P8_TEMPLATE, P8_EVERY, P8_NEW, P8_MAX_B, P8_BLK = 232, 3, 16, 4, 16
P8_TAILS, P8_LATE_TAILS = (40, 1, 24, 1), (40, 1)
P8_ADMIT, P8_LATE_FIRST = 4, 5
# the schedule's prefix counts, from the same schedule run through the JAX
# engine at tiny width on the CPU (tests/test_torch_prefix_cache.py::
# test_phase8_schedule_matches_reference); they depend only on prompt
# lengths, token equality, page_block, slots and arrivals
P8_PINNED = {"prefix_hits": 20, "pages_shared": 280, "cow_copies": 6,
             "prefill_tokens": 6974, "prefill_tokens_computed": 2446}


def phase8_work(vocab, clients, tails, first_tick, seed):
    """Phase 8's requests (dicts of ``Request`` fields) for ``clients``:
    per client a template of P8_TEMPLATE tokens and one request per entry
    of ``tails``, that many tokens after the template, P8_EVERY ticks
    apart from ``first_tick``. Single-token tails take the client's two
    distinct tokens in turn, so the first and the second differ."""
    rng = np.random.default_rng(seed)
    work = []
    for c in clients:
        tpl = rng.integers(0, vocab, P8_TEMPLATE)
        one = int(rng.integers(0, vocab))
        ones = iter((one, (one + 1) % vocab))
        for i, n in enumerate(tails):
            tail = ([next(ones)] if n == 1
                    else list(rng.integers(0, vocab, n)))
            work.append(dict(client_id=c, max_new_tokens=P8_NEW,
                             arrive_tick=first_tick + P8_EVERY * i,
                             prompt=np.concatenate([tpl, tail])
                             .astype(np.int32)[None, :]))
    return work


P8_ACFGS = (AdapterConfig(method="lora", rank=8, alpha=16.0,
                           targets=("q", "v")),
            AdapterConfig(method="ia3", targets=("k", "v", "down")),
            AdapterConfig(method="prefix", targets=("q", "v"), n_prefix=16))
P8_LATE_ACFG = AdapterConfig(method="lora", rank=16, alpha=32.0,
                             targets=("q", "k", "v", "o"))


def p8_bank(cfg, acfg, n, seed, dtype=torch.bfloat16):
    """A bank of ``n`` clients, every adapter non-trivial: LoRA B drawn
    (zero at init), IA3 scales 1 + 0.2 * normal, prefix K/V normal."""
    g = gen(seed)
    bank = adapters.init_client_bank(cfg, acfg, n, g, dtype=dtype,
                                     device=DEV)
    for path, leaf in bank["layers"].items():
        if acfg.method == "lora":
            leaf["B"].copy_(torch.randn(leaf["B"].shape, generator=g,
                                        device=DEV) * 0.05)
        elif acfg.method == "ia3":
            leaf["scale"].copy_(1 + 0.2 * torch.randn(
                leaf["scale"].shape, generator=g, device=DEV))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=DEV))
    return bank


def sgmv_per_layer(cfg, bank_cfgs):
    """SGMV launches per layer of a compacted step, from the registry: one
    per LoRA bank and targeted projection, and, for every prefix bank, one
    per LoRA bank targeting q or o (the prefix branch's own q and o go
    through the linear hooks)."""
    lora = [a for a in bank_cfgs if a.method == "lora"]
    n_prefix = sum(a.method == "prefix" for a in bank_cfgs)
    return (sum(len(adapters.resolve_targets(cfg, a)) for a in lora)
            + n_prefix * sum(("q" in a.targets) + ("o" in a.targets)
                             for a in lora))


def p8_spec(cfg, acfgs):
    scfg = ServeConfig(n_clients=2 * len(acfgs), max_seq=512,
                       page_block=P8_BLK, policy="opportunistic")
    return EngineSpec(cfg=cfg, banks=tuple(
        BankSpec(f"{a.method}{m}", a, 2) for m, a in enumerate(acfgs)),
        serve=scfg, max_batch_per_client=P8_MAX_B)


def p8_serve(cfg, base, banks, late_bank, *, prefix_cache=None, label,
             watch=False):
    """Phase 8's workload on one engine behind a router (debug=True: the
    conservation audit after every tick), the late bank admitted at tick
    P8_ADMIT and retired after the drain. Checks the SGMV and attention
    launches of every tick against the registry. With ``watch``, also
    holds every published page against its copy at its last deref and
    every copy-on-write destination against its source. Returns the
    requests, the engine, per-request top-2 logit gaps per step, the
    prefill calls' (ext, rows, suffix tokens, ms) and the decode steps'
    ms."""
    L = cfg.n_layers
    work = phase8_work(cfg.vocab, range(6), P8_TAILS, 0, seed=0)
    late = phase8_work(cfg.vocab, (6, 7), P8_LATE_TAILS, P8_LATE_FIRST,
                       seed=1)
    charges = [adapters.adapter_bytes(cfg, a)[1] * 2
               for a in P8_ACFGS + (P8_LATE_ACFG,)]
    pages = [kvcache.cache_bytes(cfg, w["prompt"].shape[1] + P8_NEW, 1,
                                 page_block=P8_BLK) for w in work + late]
    router = PlacementRouter(cfg, [Slot(0, free_hbm=sum(charges)
                                        + sum(pages))])
    eng = ServingEngine(p8_spec(cfg, P8_ACFGS), base, banks, device=DEV,
                        router=router, debug=True, prefix_cache=prefix_cache)
    reqs = [Request(**w) for w in work]
    for r in reqs:
        eng.submit(r)
    gaps = {}
    sample = eng._sample

    def record_gap(logits, req):
        top = np.sort(logits, axis=-1)[:, -2:]
        gaps.setdefault(id(req), []).append(float((top[:, 1]
                                                   - top[:, 0]).min()))
        return sample(logits, req)
    eng._sample = record_gap
    pre, dec_t = [], []
    prefill = eng._prefill_step

    def timed_prefill(ext, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(ext, *args)
        torch.cuda.synchronize()
        mask = args[-1]
        pre.append((ext, int(mask.sum()), int(args[4][mask].sum()),
                    (time.perf_counter() - t0) * 1e3))
        if watch:
            check_cow()
        return out
    eng._prefill_step = timed_prefill
    published, cow, checked = {}, [], [0, 0]
    if watch:
        index = eng._prefix_index
        publish, deref, lookup = index.publish, index.deref, index.lookup
        tails = {}

        def page_of(p):
            return [t[:, p].clone() for t in eng.caches["layers"].values()]

        def watch_publish(*a):
            took = publish(*a)
            for p in took:
                published[p] = page_of(p)
            return took

        def watch_deref(p):
            last = deref(p)
            if last:
                now = page_of(p)
                if not all(torch.equal(x, y) for x, y in
                           zip(published.pop(p), now)):
                    raise AssertionError(f"[{label}] shared page {p} changed "
                                         "between its publish and its last "
                                         "deref")
                checked[0] += 1
            return last

        def watch_lookup(*a):
            hit = lookup(*a)
            if hit.tail_page is not None:
                tails[hit.tail_page] = hit.tail_tokens
            return hit
        index.publish, index.deref = watch_publish, watch_deref
        index.lookup = watch_lookup
        page_copy = eng._page_copy

        def watch_copy(caches, src, dst):
            # the engine passes page ids as one-element index tensors
            s, d = int(src), int(dst)
            cow.append((s, d, tails[s]))
            return page_copy(caches, src, dst)
        eng._page_copy = watch_copy

    def check_cow():
        while cow:
            src, dst, n = cow.pop()
            for t in eng.caches["layers"].values():
                if not torch.equal(t[:, dst, :n], t[:, src, :n]):
                    raise AssertionError(f"[{label}] copy-on-write page {dst}"
                                         f" differs from its source {src} on "
                                         f"the {n} copied tokens")
            checked[1] += 1

    attn, idle, sg = (KERNELS[n][0] for n in (
        "paged_decode_attn", "paged_decode_attn_quant", "sgmv"))
    adm, late_reqs = None, []
    per_tick = {}
    torch.cuda.synchronize()
    reset_counts()
    more = True
    while more:
        if eng._tick == P8_ADMIT and adm is None:
            adm = eng.admit_bank(P8_LATE_ACFG, late_bank)
            late_reqs = [Request(**w) for w in late]
            for r in late_reqs:
                eng.submit(r)
        decode = eng._decode_step
        eng._decode_step = _timed(decode, dec_t)
        per_layer = sgmv_per_layer(cfg, eng.bank_cfgs)
        before = (attn.launches, idle.launches, sg.launches,
                  eng.stats["ticks"], eng.stats["compact_prefill_batches"])
        more = eng.service_tick()
        eng._decode_step = decode
        d_at, d_idle, d_sg, d_tick, d_pre = (
            a - b for a, b in zip((attn.launches, idle.launches, sg.launches,
                                   eng.stats["ticks"],
                                   eng.stats["compact_prefill_batches"]),
                                  before))
        if d_at != L * d_tick or d_idle or \
                d_sg != per_layer * L * (d_tick + d_pre):
            raise AssertionError(
                f"[{label}] tick {eng._tick}: {d_at} paged attention, "
                f"{d_idle} int8 and {d_sg} SGMV launches for {d_tick} decode "
                f"ticks and {d_pre} prefills ({per_layer} SGMV per layer)")
        if d_tick:
            per_tick[len(eng.bank_cfgs)] = (d_sg // (d_tick + d_pre), d_at)
    torch.cuda.synchronize()
    reqs += late_reqs
    done = eng.drain_done()
    if len(done) != len(reqs) or any(r.status != "ok" for r in reqs):
        raise AssertionError(f"[{label}] {len(done)} of {len(reqs)} finished,"
                             f" statuses {[r.status for r in reqs]}")
    for r in reqs:
        g = r.generated
        if g.shape != (1, P8_NEW) or g.min() < 0 or g.max() >= cfg.vocab:
            raise AssertionError(f"[{label}] client {r.client_id}: {g}")
    P = eng._pool_pages
    if eng._prefix_index.page_refs() or eng._slot_shared or any(
            sorted(f) != list(range(c * P, (c + 1) * P))
            for c, f in enumerate(eng._free_pages)):
        raise AssertionError(f"[{label}] after the drain: refs "
                             f"{eng._prefix_index.page_refs()}, pages not "
                             "all back in their owners' free lists")
    banks_held = router.utilization()
    eng.retire_bank(adm)
    eng.release_banks()
    used = router.utilization()
    if router.conservation_errors() or used["placements"] \
            or used["committed_bytes"] or banks_held["placements"] != 4:
        raise AssertionError(f"[{label}] router after the drain: "
                             f"{router.conservation_errors()}, {banks_held}"
                             f" with the banks, {used} after their release")
    if watch and (published or checked[1] != eng.stats["cow_copies"]):
        raise AssertionError(f"[{label}] {len(published)} published pages "
                             f"never released, {checked[1]} copy-on-write "
                             "pages checked")
    return dict(reqs=reqs, eng=eng, gaps=[gaps[id(r)] for r in reqs],
                pre=pre, dec_t=dec_t, per_tick=per_tick, checked=checked)


def p8_mixed_rows(cfg2, base2, banks2):
    """One 8-row mixed decode step at granite's width (2 layers, bf16),
    then each bank's single-method step over the same rows with the other
    banks' rows masked out and pointed at this bank's client 0, every step
    from a copy of the same caches: each bank's rows equal bit for bit."""
    C, max_b, max_seq = 6, 2, 512
    scfg = ServeConfig(n_clients=C, max_seq=max_seq, page_block=P8_BLK)
    nb, P = max_seq // P8_BLK, max_b * (max_seq // P8_BLK)
    rng = np.random.default_rng(8)
    rows = [(c, 0) for c in range(C)] + [(0, 1), (4, 1)]
    lengths = rng.integers(40, 250, len(rows)).astype(np.int32)
    toks = np.zeros((8, 256), np.int32)
    tbl = np.full((C, max_b, nb), SENTINEL, np.int32)
    nxt = [c * P for c in range(C)]
    for r, ((c, s), n) in enumerate(zip(rows, lengths)):
        toks[r, :n] = rng.integers(0, cfg2.vocab, n)
        need = n // P8_BLK + 1
        tbl[c, s, :need] = np.arange(nxt[c], nxt[c] + need)
        nxt[c] += need
    clients = np.array([c for c, _ in rows], np.int32)
    t = {k: torch.tensor(v, device=DEV) for k, v in dict(
        toks=toks, lens=lengths, clients=clients,
        slots=np.array([s for _, s in rows], np.int32),
        methods=clients // 2, locals_=clients % 2,
        mask=np.ones(8, bool)).items()}
    caches = symbiosis.init_client_caches(cfg2, C, max_b, max_seq,
                                          page_block=P8_BLK, pool_pages=P,
                                          device=DEV)
    caches["block_tbl"] = torch.tensor(tbl, device=DEV)
    lg, _, caches = symbiosis.make_compact_prefill(cfg2, P8_ACFGS, scfg)(
        base2, banks2, caches, t["toks"], t["lens"],
        torch.zeros_like(t["lens"]), t["clients"], t["slots"], t["methods"],
        t["locals_"], t["mask"])
    nxt_tok = lg.argmax(-1).to(torch.int32)

    def fresh():
        return {"layers": {k: v.clone() for k, v in caches["layers"].items()},
                "pos": caches["pos"].clone(), "block_tbl": caches["block_tbl"]}

    reset_counts()
    mixed, _, _ = symbiosis.make_compact_decode_step(cfg2, P8_ACFGS, scfg)(
        base2, banks2, fresh(), nxt_tok, t["clients"], t["slots"],
        t["methods"], t["locals_"], t["mask"])
    mixed_launches = read_counts()
    for m, acfg in enumerate(P8_ACFGS):
        own = t["methods"] == m
        # bank m over every GLOBAL client (the ids the caches are keyed
        # by): its clients hold their adapters, the others its client 0
        ids = torch.tensor([c % 2 if c // 2 == m else 0 for c in range(C)],
                           device=DEV)
        single_bank = tree_map(lambda x: x[ids], banks2[m])
        single, _, _ = symbiosis.make_compact_decode_step(cfg2, acfg, scfg)(
            base2, single_bank, fresh(), nxt_tok, t["clients"], t["slots"],
            own)
        if not torch.equal(single[own], mixed[own]):
            d = (single[own].float() - mixed[own].float()).abs().max()
            raise AssertionError(f"[phase 8] {acfg.method} rows of the mixed "
                                 f"step differ from its single-method step "
                                 f"(max abs {float(d):.3e})")
    log(f"[phase 8] mixed rows: one 8-row decode step over LoRA r8 (q, v), "
        f"IA3 and prefix banks at {cfg2.name} width, 2 layers, bf16: every "
        f"bank's rows equal its single-method step's bit for bit (launches "
        f"of the mixed step {mixed_launches})")


def p8_suffix_prefill(dtype, tol):
    """At granite's width, 2 layers, over LoRA, IA3 and prefix banks: client
    0 of each bank publishes template + 40 tokens from slot 0; slot 1's
    template + 24 then prefills only its 32-token suffix over the 14 shared
    pages (``starts`` 224, ``ext_blocks`` 16), against the full prefill of
    the same prompts into fresh caches. Logits and the K/V written at the
    suffix positions agree at ``tol``; both paths run the kernels. Returns
    the 2-layer config, base and banks."""
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    cfg2 = dataclasses.replace(get_config("granite-3-8b"), n_layers=2,
                               dtype=name, param_dtype=name)
    base2 = get_model(cfg2).init_params(gen(41), DEV)
    banks2 = [p8_bank(cfg2, a, 2, 42 + m, dtype) for m, a in
              enumerate(P8_ACFGS)]
    C, max_b, max_seq = 6, 2, 512
    scfg = ServeConfig(n_clients=C, max_seq=max_seq, page_block=P8_BLK)
    nb, P = max_seq // P8_BLK, max_b * (max_seq // P8_BLK)
    work = phase8_work(cfg2.vocab, (0, 2, 4), (40, 24), 0, seed=5)
    pub, con = work[0::2], work[1::2]
    n_shared = P8_TEMPLATE // P8_BLK                 # 14 full pages
    start = n_shared * P8_BLK
    clients = torch.tensor([0, 2, 4, 0], dtype=torch.int32, device=DEV)
    methods, locals_ = clients // 2, clients % 2
    mask = torch.tensor([True, True, True, False], device=DEV)

    def step(caches, prompts, slot, starts, ext):
        S = max(p.shape[1] for p in prompts) - int(starts.max())
        toks = np.zeros((4, S), np.int32)
        lens = np.zeros(4, np.int32)
        for r, (p, s0) in enumerate(zip(prompts, starts.tolist())):
            toks[r, :p.shape[1] - s0] = p[0, s0:]
            lens[r] = p.shape[1] - s0
        slots = torch.full((4,), slot, dtype=torch.int32, device=DEV)
        fn = symbiosis.make_compact_prefill(cfg2, P8_ACFGS, scfg,
                                            ext_blocks=ext)
        return fn(base2, banks2, caches, torch.tensor(toks, device=DEV),
                  torch.tensor(lens, device=DEV), starts.to(DEV), clients,
                  slots, methods, locals_, mask)

    def fresh(tbl):
        c = symbiosis.init_client_caches(cfg2, C, max_b, max_seq,
                                         page_block=P8_BLK, pool_pages=P,
                                         device=DEV)
        c["block_tbl"] = torch.tensor(tbl, device=DEV)
        return c

    tbl = np.full((C, max_b, nb), SENTINEL, np.int32)
    for c in (0, 2, 4):
        tbl[c, 0, :18] = c * P + np.arange(18)               # publisher
        tbl[c, 1, :n_shared] = tbl[c, 0, :n_shared]          # shared pages
        tbl[c, 1, n_shared:16] = c * P + 18 + np.arange(16 - n_shared)
    zeros = torch.zeros(4, dtype=torch.int32)
    shared = fresh(tbl)
    step(shared, [w["prompt"] for w in pub], 0, zeros, 0)
    reset_counts()
    lg_s, _, shared = step(shared, [w["prompt"] for w in con], 1,
                           torch.tensor([start] * 3 + [0], dtype=torch.int32),
                           16)
    if not launch_count("sgmv"):
        raise AssertionError("[phase 8] the suffix prefill launched no SGMV")
    full = fresh(tbl)
    lg_f, _, full = step(full, [w["prompt"] for w in con], 1, zeros, 0)
    torch.cuda.synchronize()
    e = compare(f"[phase 8] suffix prefill logits ({name})", lg_s[:3],
                lg_f[:3], tol)
    own = torch.tensor(tbl[[0, 2, 4], 1, n_shared:16].ravel(), device=DEV)
    ekv = max(compare(f"[phase 8] suffix K/V ({name}, {n})", t[:, own],
                      full["layers"][n][:, own], tol)
              for n, t in shared["layers"].items())
    log(f"[phase 8] suffix prefill over {n_shared} shared pages (start "
        f"{start}, ext_blocks 16, 32 suffix tokens per row) against the "
        f"full prefill, {cfg2.name} width, 2 layers, {name}, LoRA + IA3 + "
        f"prefix rows: logits max_abs_err={e:.3e}, suffix K/V "
        f"max_abs_err={ekv:.3e} ({tol})")
    return cfg2, base2, banks2


def first_diff(a, b):
    """The first step at which two [1, n] streams differ, or None."""
    d = np.nonzero(a[0] != b[0])[0]
    return int(d[0]) if len(d) else None


def phase8(cfg, base, times4):
    """Mixed-method banks and shared-prefix pages at full size on phase 4's
    base tensors, then the step-level checks at granite's width."""
    L = cfg.n_layers
    banks = [p8_bank(cfg, a, 2, 80 + m) for m, a in enumerate(P8_ACFGS)]
    late_bank = p8_bank(cfg, P8_LATE_ACFG, 2, 84)
    t0 = time.perf_counter()
    run = p8_serve(cfg, base, banks, late_bank, label="phase 8", watch=True)
    wall = time.perf_counter() - t0
    eng, reqs = run["eng"], run["reqs"]
    st = eng.stats
    got = {k: st[k] for k in P8_PINNED}
    if got != P8_PINNED or not all(st[k] for k in P8_PINNED):
        raise AssertionError(f"[phase 8] prefix counts {got}, pinned "
                             f"{P8_PINNED}")
    log(f"[phase 8] {cfg.name}: {L} layers bf16, banks LoRA r8 (q, v), IA3 "
        f"(k, v, down), prefix ({P8_ACFGS[2].n_prefix} tokens), 2 clients "
        f"each, then LoRA r16 (q, k, v, o) admitted at tick {P8_ADMIT} and "
        f"retired after the drain; {len(reqs)} requests served in "
        f"{wall:.3f} s, {st['ticks']} decode ticks, "
        f"{st['compact_prefill_batches']} prefill batches, peak in flight "
        f"{st['peak_inflight']}; conservation audited every tick; refcounts "
        "0, every page back with its owner and the router ledger empty "
        "after the drain and the banks' release")
    log(f"[phase 8] prefix hits {st['prefix_hits']}, pages shared "
        f"{st['pages_shared']}, copies on write {st['cow_copies']}, prompt "
        f"tokens {st['prefill_tokens']} of which computed "
        f"{st['prefill_tokens_computed']} (as pinned from the JAX engine's "
        f"run of the same schedule); {run['checked'][0]} published pages "
        f"unchanged at their last deref, {run['checked'][1]} copied pages "
        "equal their sources on the copied tokens")
    for n, (sg_tick, at_tick) in sorted(run["per_tick"].items()):
        log(f"[phase 8] with {n} banks: sgmv {sg_tick} per decode tick or "
            f"prefill batch ({sgmv_per_layer(cfg, (P8_ACFGS + (P8_LATE_ACFG,))[:n])}"
            f" per layer, from the registry; phase 4: {2 * L}), paged "
            f"attention {at_tick} per decode tick (phase 4: {L}), int8 "
            "attention 0 (checked tick by tick)")
    pre = run["pre"]
    log("[phase 8] prefill batches (ext_blocks, rows, computed tokens, ms): "
        + ", ".join(f"({e}, {r}, {n}, {ms:.3f})" for e, r, n, ms in pre))
    miss = [ms for e, _, _, ms in pre if e == 0]
    hit = [ms for e, _, _, ms in pre if e > 0]
    log(f"[phase 8] a miss batch's prefill {miss[0]:.3f} ms (6 rows of 272 "
        f"tokens) against a hit batch's {hit[0]:.3f} ms (6 rows of 9 suffix"
        f" tokens over 14 shared pages); decode-step ms median "
        f"{statistics.median(run['dec_t']) * 1e3:.3f}")
    P = eng._pool_pages
    keep = [c for c in range(eng.n_clients) if eng._method_of[c] != 1]
    pools = {n: torch.cat([t[:, c * P:(c + 1) * P] for c in keep], dim=1)
             for n, t in eng.caches["layers"].items()}
    streams = [r.generated.copy() for r in reqs]
    del run, eng
    # the same workload with the IA3 bank's scales x 1.5: every other
    # bank's stream and page bit for bit as before
    banks_b = list(banks)
    banks_b[1] = tree_map(lambda x: x * 1.5, banks[1])
    run2 = p8_serve(cfg, base, banks_b, late_bank, label="phase 8 isolation")
    eng2 = run2["eng"]
    ia3 = [i for i, r in enumerate(run2["reqs"]) if eng2._method_of[
        r.client_id] == 1]
    for i, r in enumerate(run2["reqs"]):
        if i not in ia3 and not np.array_equal(r.generated, streams[i]):
            raise AssertionError(f"[phase 8] request {i} (client "
                                 f"{r.client_id}) changed with the IA3 "
                                 "bank's scales")
    for n, t in eng2.caches["layers"].items():
        now = torch.cat([t[:, c * P:(c + 1) * P] for c in keep], dim=1)
        if not torch.equal(now, pools[n]):
            raise AssertionError(f"[phase 8] pool {n}: pages of the other "
                                 "banks' clients changed with the IA3 "
                                 "bank's scales")
    moved = sum(not np.array_equal(run2["reqs"][i].generated, streams[i])
                for i in ia3)
    log(f"[phase 8] isolation: with the IA3 bank's scales x 1.5, all "
        f"{len(streams) - len(ia3)} streams of the other banks' clients and "
        f"their {len(keep) * P} pool pages equal the first run's bit for "
        f"bit ({moved} of the {len(ia3)} IA3 streams moved)")
    del run2, eng2, pools
    run3 = p8_serve(cfg, base, banks, late_bank, prefix_cache=False,
                    label="phase 8 unshared")
    same = 0
    for i, r in enumerate(run3["reqs"]):
        d = first_diff(r.generated, streams[i])
        if d is None:
            same += 1
        else:
            log(f"[phase 8]   unshared request {i} (client {r.client_id}) "
                f"first differs at step {d}, where its top-2 logit gap was "
                f"{run3['gaps'][i][d]:.4f}")
    log(f"[phase 8] prefix_cache=False: {same} of {len(streams)} streams "
        f"equal the shared run's (printed, not gated: base products of other"
        f" row counts round otherwise in bf16); its prefill batches "
        f"(ext_blocks, rows, tokens, ms): " + ", ".join(
            f"({e}, {r}, {n}, {ms:.3f})" for e, r, n, ms in run3["pre"]))
    del run3
    torch.cuda.empty_cache()
    p8_suffix_prefill(torch.float32, F32_TOL)
    cfg2, base2, banks2 = p8_suffix_prefill(torch.bfloat16, BF16_TOL)
    p8_mixed_rows(cfg2, base2, banks2)
    del base2, banks2
    torch.cuda.empty_cache()
    times = profile_tick(cfg, base, banks, p8_spec(cfg, P8_ACFGS),
                         "phase 8")
    log("[phase 8] mixed 8-row tick beside phase 4's: " + ", ".join(
        f"{k} {times4[k]:.3f} -> {times[k]:.3f}" for k in times
        if k in times4))


# ---------------------------------------------------------------------------
# phase 9: the dense KV layout and the masked bank-wide step
# ---------------------------------------------------------------------------

P9_POLICIES = ("opportunistic", "nolockstep", "lockstep")
# per layer and tick: the kernels each run must launch (decode tick) and
# SGMV per decode tick or prefill call; every other counted kernel 0
P9_ATTN = {"9a": {"decode_attn": 2}, "9b": {"paged_decode_attn": 1},
           "9c": {}}


def p9_spec(cfg, page_block, quant=False, policy="opportunistic"):
    """Phase 4's spec on another layout or policy."""
    spec = serve_spec(cfg, quant)
    return dataclasses.replace(spec, serve=dataclasses.replace(
        spec.serve, page_block=page_block, policy=policy))


def p9_serve(cfg, base, bank, spec, label, attn, sgmv_per_call=None,
             **engine_kw):
    """Serve phase 4's requests on ``spec`` with the launch
    counts checked tick by tick: per decode tick each ``attn`` kernel its
    count per layer, SGMV ``sgmv_per_call`` times (default twice per
    layer) per decode tick or prefill call, every other counted kernel 0. Records each request's top-2
    logit gap per step and the requests each ragged per-client prefill
    carried. Returns (requests, engine, gaps, ragged groups, launches,
    decode-step ms)."""
    L = cfg.n_layers
    eng = ServingEngine(spec, base, [bank], device=DEV, **engine_kw)
    reqs = make_requests(cfg, 4)
    for r in reqs:
        eng.submit(r)
    gaps, groups, dec_t = {}, [], []
    sample, ragged = eng._sample, eng._prefill_ragged

    def record_gap(logits, req):
        top = np.sort(logits, axis=-1)[:, -2:]
        gaps.setdefault(id(req), []).append(float((top[:, 1]
                                                   - top[:, 0]).min()))
        return sample(logits, req)

    def record_group(c, items):
        groups.append([id(r) for r, _ in items])
        return ragged(c, items)
    eng._sample, eng._prefill_ragged = record_gap, record_group
    eng._decode_step = _timed(eng._decode_step, dec_t)
    torch.cuda.synchronize()
    reset_counts()
    per_tick = TICK_LAUNCHES[label] = []
    more = True
    while more:
        before = (read_counts(), eng.stats["ticks"], eng.stats["prefill_calls"])
        more = eng.service_tick()
        now = read_counts()
        d = {n: now[n] - before[0][n] for n in now}
        per_tick.append(d)
        d_tick = eng.stats["ticks"] - before[1]
        d_pre = eng.stats["prefill_calls"] - before[2]
        want = {n: attn.get(n, 0) * L * d_tick for n in d}
        want["sgmv"] = (2 * L if sgmv_per_call is None else sgmv_per_call) \
            * (d_tick + d_pre)
        if d != want:
            raise AssertionError(
                f"[{label}] tick {eng._tick}: launches {d} for {d_tick} "
                f"decode ticks and {d_pre} prefill calls; want {want}")
    torch.cuda.synchronize()
    launches = read_counts()
    done = eng.drain_done()
    if len(done) != len(reqs) or eng.stats["quarantined_requests"] \
            or not all(r.status == "ok" and np.isfinite(gaps[id(r)]).all()
                       for r in reqs):
        raise AssertionError(f"[{label}] {len(done)} of {len(reqs)} requests "
                             f"finished, {eng.stats['quarantined_requests']} "
                             "quarantined or with non-finite logits")
    for r in reqs:
        g = r.generated
        if g.min() < 0 or g.max() >= cfg.vocab:
            raise AssertionError(f"[{label}] tokens out of range: {g}")
    SERVED[label] = [r.generated.copy() for r in reqs]
    return reqs, eng, gaps, groups, launches, dec_t


def p9_vs(label, reqs, gaps, streams, what):
    """Print each stream against ``streams`` (first differing step and the
    top-2 logit gap there in this run); returns how many are equal."""
    same = 0
    for i, r in enumerate(reqs):
        d = first_diff(r.generated, streams[i])
        if d is None:
            same += 1
        else:
            log(f"[{label}]   request {i} (client {r.client_id}) first "
                f"differs from {what} at step {d}, where its top-2 logit gap "
                f"was {gaps[id(r)][d]:.4f}")
    log(f"[{label}] {same} of {len(reqs)} streams equal {what}")
    return same


def p9_alone(cfg, base, bank, spec, reqs):
    """The streams of ``reqs`` served together (all arriving at tick 0) by a
    fresh engine of ``spec``: one request alone, or the requests of one
    ragged per-client prefill, at that prefill's shapes."""
    eng = ServingEngine(spec, base, [bank], device=DEV)
    mine = [Request(client_id=r.client_id, prompt=r.prompt.copy(),
                    max_new_tokens=r.max_new_tokens) for r in reqs]
    for r in mine:
        eng.submit(r)
    eng.run()
    return [r.generated for r in mine]


def p9_dense(cfg, base, bank, streams4):
    """9a: the dense layout under every policy, tick-checked; each request's
    stream bit for bit equal to it served alone by a fresh dense engine
    (a request that a ragged per-client prefill carried at another bucket
    than its own: to its ragged batch served alone, the same shapes, and
    printed against its own solo run). Returns the first run's launches
    and its decode-step ms."""
    solo = {}
    first = None
    for policy in P9_POLICIES:
        spec = p9_spec(cfg, 0, policy=policy)
        t0 = time.perf_counter()
        reqs, eng, gaps, groups, launches, dec_t = p9_serve(
            cfg, base, bank, spec, f"phase 9a {policy}", P9_ATTN["9a"])
        wall = time.perf_counter() - t0
        st = eng.stats
        log(f"[phase 9a] {policy}: kv=dense [L, C, B, T, K, hd] = "
            f"{list(eng.caches['layers']['k'].shape)}; {len(reqs)} requests "
            f"in {wall:.3f} s, {st['ticks']} decode ticks (masked, 8 rows), "
            f"{st['prefill_calls']} per-client prefills of which "
            f"{st['ragged_prefill_batches']} ragged, launches {launches} "
            f"(checked tick by tick: decode_attn 2 x {cfg.n_layers} per "
            f"decode tick, paged 0, sgmv {2 * cfg.n_layers} per decode tick "
            "and per prefill call); decode-step ms "
            f"{statistics.median(dec_t) * 1e3:.3f} (median)")
        spec0 = p9_spec(cfg, 0)
        by_id = {id(r): r for r in reqs}
        in_group = {}
        for g in groups:
            rs = [by_id[i] for i in g]
            pad = eng._bucket(max(r.prompt.shape[1] for r in rs))
            if any(eng._bucket(r.prompt.shape[1]) != pad for r in rs):
                for r, got in zip(rs, p9_alone(cfg, base, bank, spec0, rs)):
                    in_group[id(r)] = got
        for i, r in enumerate(reqs):
            if i not in solo:
                solo[i] = p9_alone(cfg, base, bank, spec0, [r])[0]
            want = in_group.get(id(r), solo[i])
            if not np.array_equal(r.generated, want):
                raise AssertionError(
                    f"[phase 9a] {policy}: request {i}'s stream differs from "
                    f"it served alone ({'its ragged batch' if id(r) in in_group else 'solo'}) "
                    f"at step {first_diff(r.generated, want)}")
        log(f"[phase 9a] {policy}: every stream equals its run alone on a "
            f"fresh dense engine, bit for bit ({len(in_group)} of them, "
            "carried by a ragged prefill at a larger bucket, against that "
            "ragged batch alone)")
        if in_group:
            p9_vs(f"phase 9a {policy}", [r for r in reqs if id(r) in in_group],
                  gaps, [solo[i] for i, r in enumerate(reqs)
                         if id(r) in in_group], "its own solo run")
        if first is None:
            first = (launches, dec_t)
            p9_vs("phase 9a", reqs, gaps, streams4, "phase 4's (paged) stream")
        del eng
    return first


def p9_steps_equal(cfg, base, bank):
    """9b's step check: every slot of phase 4's bank active, the masked step
    and the compacted step over the 8 rows in (client, slot) order, on
    copies of the same caches: logits and pools bit for bit."""
    spec = p9_spec(cfg, 16)
    eng = ServingEngine(spec, base, [bank], device=DEV)
    rng = np.random.default_rng(6)
    for i in range(8):
        eng.submit(Request(i % 4, rng.integers(0, cfg.vocab, (1, 160))
                           .astype(np.int32), 16))
    eng.service_tick()
    eng._sync_tbl()
    if not eng._active_mask.all():
        raise AssertionError("[phase 9b] not every slot is active")
    other = tree_map(torch.clone, eng.caches)
    masked = symbiosis.make_masked_decode_step(cfg, LORA, spec.serve)
    C, B = eng._active_mask.shape
    tok = torch.tensor(eng._last_tok, device=DEV)
    lm, caches = masked(base, bank, eng.caches, tok,
                        torch.ones((C, B), dtype=torch.bool, device=DEV))
    before = launch_count("paged_decode_attn")
    rows = (torch.arange(C, device=DEV).repeat_interleave(B).to(torch.int32),
            torch.arange(B, device=DEV).repeat(C).to(torch.int32))
    lc, _, other = eng._decode_step(base, bank, other, tok.reshape(-1),
                                    *rows, torch.ones(C * B, dtype=torch.bool,
                                                      device=DEV))
    torch.cuda.synchronize()
    if launch_count("paged_decode_attn") != before + cfg.n_layers:
        raise AssertionError("[phase 9b] the compacted step did not launch "
                             "the paged kernel once per layer")
    if not torch.equal(lm.reshape(C * B, -1), lc):
        raise AssertionError("[phase 9b] masked and compacted logits differ")
    for n in caches["layers"]:
        if not torch.equal(caches["layers"][n], other["layers"][n]):
            raise AssertionError(f"[phase 9b] pool {n} differs")
    if not torch.equal(caches["pos"], other["pos"]):
        raise AssertionError("[phase 9b] positions differ")
    log(f"[phase 9b] all-active 8-row step: masked and compacted, on copies "
        f"of the same caches, equal bit for bit (logits {list(lc.shape)}, "
        f"every pool leaf and pos)")


def phase9(cfg, base, bank, streams4, times4):
    """The dense layout, the masked paged ablation and int8 dense caches on
    phase 4's base tensors and bank; then the profiled ticks. Returns the
    dense kernel's launches on its main-path run (9a, opportunistic)."""
    L = cfg.n_layers
    warm_up(p9_spec(cfg, 0), base, bank)
    launches, dec_t = p9_dense(cfg, base, bank, streams4)
    torch.cuda.empty_cache()

    spec = p9_spec(cfg, 16)
    reqs, eng, gaps, _, l9b, dec_b = p9_serve(
        cfg, base, bank, spec, "phase 9b", P9_ATTN["9b"],
        compact_decode=False)
    log(f"[phase 9b] compact_decode=False on phase 4's pages: "
        f"{eng.stats['ticks']} masked decode ticks, launches {l9b} "
        f"(paged {L} per decode tick, checked tick by tick); decode-step ms "
        f"{statistics.median(dec_b) * 1e3:.3f} (median; 9a dense "
        f"{statistics.median(dec_t) * 1e3:.3f})")
    p9_vs("phase 9b", reqs, gaps, streams4, "phase 4's stream")
    del eng
    p9_steps_equal(cfg, base, bank)
    torch.cuda.empty_cache()

    spec = p9_spec(cfg, 0, quant=True)
    warm_up(spec, base, bank)
    reqs, eng, gaps, _, l9c, _ = p9_serve(cfg, base, bank, spec, "phase 9c",
                                          P9_ATTN["9c"])
    log(f"[phase 9c] kv=dense+int8: finite, launches {l9c} (no attention "
        f"kernel: plain torch, as JAX; checked tick by tick)")
    p9_vs("phase 9c", reqs, gaps, streams4, "phase 4's stream")
    del eng
    torch.cuda.empty_cache()

    t9 = profile_tick(cfg, base, [bank], p9_spec(cfg, 0), "phase 9d dense")
    log("[phase 9d] dense 8-row tick beside phase 4's: " + ", ".join(
        f"{k} {times4[k]:.3f} -> {t9[k]:.3f}" for k in t9 if k in times4))
    t9 = profile_tick(cfg, base, [bank], p9_spec(cfg, 16),
                      "phase 9d masked", n_req=2, compact_decode=False)
    log("[phase 9d] masked paged tick (2 of 8 slots) beside phase 4's "
        "(8 of 8, compacted): " + ", ".join(
            f"{k} {times4[k]:.3f} -> {t9[k]:.3f}" for k in t9 if k in times4))
    return launches["decode_attn"]


# ---------------------------------------------------------------------------
# phase 10: every PEFT method fine-tunes on the shared base; crash recovery
# ---------------------------------------------------------------------------

P10_ACFGS = {"lora": LORA,
             "ia3": AdapterConfig(method="ia3", targets=("k", "v", "down")),
             "prefix": AdapterConfig(method="prefix", targets=("q", "v"),
                                     n_prefix=16)}
P10_METHODS = ("lora", "lora", "ia3", "ia3", "prefix", "prefix")
# the multi-client and mixed steps' one schedule, at a step past warmup
P10_TCFG = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=10,
                       max_grad_norm=1.0, weight_decay=0.01, remat=False)
P10_STEP = 3


def random_bank(cfg, acfg, n, seed):
    """``n`` fp32 adapters of ``acfg`` stacked: LoRA B drawn, IA3 scales
    around 1, prefix K/V as initialised (drawn)."""
    if acfg.method == "lora":
        return random_lora(cfg, n, seed)
    g = gen(seed)
    bank = adapters.init_client_bank(cfg, acfg, n, g, device=DEV)
    for leaf in _adapter_leaves(bank):
        leaf["scale"].add_(torch.randn(leaf["scale"].shape, generator=g,
                                       device=DEV) * 0.1)
    return bank


def p10_opt(bank, step):
    n = tree_leaves(bank)[0].shape[0]
    return AdamWState(step=torch.full((n,), step, dtype=torch.int32,
                                      device=DEV),
                      m=tree_map(lambda x: torch.randn_like(x) * 1e-3, bank),
                      v=tree_map(lambda x: torch.rand_like(x) * 1e-6, bank))


def max_diff(a, b):
    """Largest |a - b| over matching leaves (0.0: bit for bit, when every
    leaf is also ``torch.equal``)."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def trees_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def p10_multi_vs_compact(cfg, base, acfg, bank):
    """``make_multi_client_train_step`` over 4 clients against the compact
    step over the same 4 rows with every row at the same hyperparameters:
    losses at 7a's tolerance, states at ``state_tol``; bit for bit
    printed."""
    opt = p10_opt(bank, P10_STEP)
    batch = train_batches(cfg, 4, 102)
    multi = symbiosis.make_multi_client_train_step(cfg, acfg, P10_TCFG)
    b1, o1, m1 = multi(base, tree_clone(bank), tree_clone(opt), batch,
                       P10_STEP)
    every = lambda v: torch.full((4,), v, dtype=torch.float32, device=DEV)
    hyper = {"step": torch.full((4,), P10_STEP, dtype=torch.int32,
                                device=DEV),
             "lr": every(P10_TCFG.lr), "warmup": every(P10_TCFG.warmup_steps),
             "total": every(P10_TCFG.total_steps),
             "wd": every(P10_TCFG.weight_decay),
             "gnorm": every(P10_TCFG.max_grad_norm)}
    compact = symbiosis.make_compact_train_step(cfg, acfg, remat=False)
    b2, o2, m2 = compact(base, tree_clone(bank), tree_clone(opt), batch,
                         torch.arange(4, dtype=torch.int32, device=DEV),
                         torch.ones(4, dtype=torch.bool, device=DEV), hyper)
    worst = compare(f"[phase 10a] {acfg.method} multi-client losses",
                    m1["loss"], m2["loss"], F32_STEP_TOL)
    for x, y in zip(tree_leaves((b1, o1.m, o1.v)),
                    tree_leaves((b2, o2.m, o2.v))):
        worst = max(worst, compare(f"[phase 10a] {acfg.method} multi-client "
                                   "state", x, y, state_tol(y)))
    log(f"[phase 10a] {acfg.method}: make_multi_client_train_step (4 clients,"
        f" step {P10_STEP}, lr {P10_TCFG.lr}, clip {P10_TCFG.max_grad_norm}, "
        f"wd {P10_TCFG.weight_decay}) against the compact step at the same "
        f"hyperparameters: max abs err {worst:.3e}; bit for bit: "
        f"{trees_equal((b1, o1, m1['loss']), (b2, o2, m2['loss']))}")


def p10_mixed(cfg, base, acfg, bank):
    """``make_mixed_step`` (4 clients train, then a dense 4-client x 2-slot
    bank decodes one token after a 16-token prefill) against its two
    halves run apart, bit for bit; every launch count set to 0 just before
    the mixed step and read just after: the dense decode kernel 2 per
    layer, SGMV 2 per layer for LoRA on q and v, nothing else. The decode
    half's kernels are held against their plain versions at this shape
    (8 rows, T 64, a row's whole cache one partial split, fp32): the
    decode step under ``plain_kernels()`` on copies of the same caches and
    tokens, logits and caches at ``F32_TOL``, no launch in that pass."""
    L = cfg.n_layers
    scfg = ServeConfig(n_clients=4, max_seq=64)
    inf = random_bank(cfg, acfg, 4, 103)
    caches = symbiosis.init_client_caches(cfg, 4, 2, 64, device=DEV)
    toks = torch.randint(0, cfg.vocab, (4, 2, 16), generator=gen(104),
                         device=DEV, dtype=torch.int32)
    logits, caches = symbiosis.make_multi_client_prefill(cfg, acfg, scfg)(
        base, inf, caches, {"tokens": toks})
    tok = logits.argmax(-1).to(torch.int32)
    opt = p10_opt(bank, P10_STEP)
    batch = train_batches(cfg, 4, 105)
    apart_caches, plain_caches = tree_clone(caches), tree_clone(caches)
    mixed = symbiosis.make_mixed_step(cfg, acfg, P10_TCFG, scfg)
    torch.cuda.synchronize()
    reset_counts()
    out = mixed(base, tree_clone(bank), tree_clone(opt), batch, inf, caches,
                tok, P10_STEP)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {name: 0 for name in KERNELS}
    want["decode_attn"] = 2 * L
    want["sgmv"] = 2 * L if acfg.method == "lora" else 0
    if counts != want:
        raise AssertionError(f"[phase 10a] {acfg.method} mixed step launched "
                             f"{counts}, expected {want}")
    b, o, m = symbiosis.make_multi_client_train_step(cfg, acfg, P10_TCFG)(
        base, tree_clone(bank), tree_clone(opt), batch, P10_STEP)
    lg, c = symbiosis.make_multi_client_decode_step(cfg, acfg, scfg)(
        base, inf, apart_caches, tok)
    if not trees_equal((out[0], out[1], out[2], out[3], out[4]["loss"],
                        out[4]["gnorm"]),
                       (b, o, c, lg, m["loss"], m["gnorm"])):
        raise AssertionError(f"[phase 10a] {acfg.method} mixed step differs "
                             "from its halves run apart (max abs "
                             f"{max_diff(out[:4], (b, o, c, lg)):.3e})")
    if not torch.isfinite(out[3]).all():
        raise AssertionError(f"[phase 10a] {acfg.method} mixed logits")
    torch.cuda.synchronize()
    reset_counts()
    with blocks.plain_kernels():
        plg, pc = symbiosis.make_multi_client_decode_step(cfg, acfg, scfg)(
            base, inf, plain_caches, tok)
    torch.cuda.synchronize()
    if any(read_counts().values()):
        raise AssertionError(f"[phase 10a] {acfg.method} plain decode pass "
                             f"launched {read_counts()}")
    err = compare(f"[phase 10a] {acfg.method} mixed decode logits against "
                  "plain", out[3], plg, F32_TOL)
    for x, y in zip(tree_leaves(out[2]), tree_leaves(pc)):
        err = max(err, compare(f"[phase 10a] {acfg.method} mixed decode "
                               "caches against plain", x, y, F32_TOL))
    log(f"[phase 10a] {acfg.method}: make_mixed_step (4 clients train, 4 x 2 "
        f"slots decode, dense, max_seq 64) equals its halves run apart bit "
        f"for bit (bank, AdamW state, caches, logits, losses, gnorms); "
        f"launches {counts}; its decode logits and caches against the decode "
        f"step under plain_kernels() (no launch): max abs err {err:.3e} "
        f"({F32_TOL})")


def phase10a():
    """10a: granite's width, 2 layers, fp32: the compact step over an IA3
    and a prefix bank against solo steps, padding and NaN rows; the
    multi-client step against the compact step; the mixed step against
    its halves, per method."""
    cfg = f32_granite()
    base = get_model(cfg).init_params(gen(100), DEV)
    for m in ("ia3", "prefix"):
        acfg = P10_ACFGS[m]
        bank = tree_map(lambda x: x.repeat((2,) + (1,) * (x.ndim - 1)),
                        random_bank(cfg, acfg, 4, 101))
        compact_rows_check(cfg, base, acfg, bank, 106, "[phase 10a]")
    for m in ("lora", "ia3", "prefix"):
        bank = random_bank(cfg, P10_ACFGS[m], 4, 107)
        p10_multi_vs_compact(cfg, base, P10_ACFGS[m], bank)
        p10_mixed(cfg, base, P10_ACFGS[m], bank)
    del base
    torch.cuda.empty_cache()


def p10_jobs(cfg, steps=TRAIN_STEPS, first_seed=0, data=None):
    """Two LoRA r8 (q, v), two IA3 (k, v, down) and two prefix (16 tokens)
    jobs of 2 x 256 tokens; ``data(job_index, stream)`` may wrap a
    stream."""
    jobs = []
    for i, m in enumerate(P10_METHODS):
        seed = first_seed + i
        stream = make_job_stream(cfg, TRAIN_B, TRAIN_S, seed=seed, device=DEV)
        jobs.append(FinetuneJob(
            acfg=P10_ACFGS[m], batch_size=TRAIN_B, seq_len=TRAIN_S,
            steps=steps, lr=1e-3, warmup_steps=1, seed=seed,
            name=f"{m}-{seed}",
            data=stream if data is None else data(i, stream)))
    return jobs


def p10_engine(cfg, base, **kw):
    return FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()),
                          base, device=DEV, debug=True, **kw)


def p10_bank_ticks(cfg, base):
    """One tick per bank (2 rows each): the host-clock ms of two
    synchronised calls and one traced call's device busy time and
    kernels."""
    eng = p10_engine(cfg, base)
    for j in p10_jobs(cfg, steps=4, first_seed=20):
        eng.submit(j)
    eng.train_tick()                              # admits, first use
    for key, bank in eng._banks.items():
        host = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._bank_tick(bank)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        with traced() as prof:
            eng._bank_tick(bank)
        busy, n, by_name = device_profile(prof)
        gemm = sum(c for name, (c, _) in by_name.items()
                   if any(k in name for k in GEMM_NAMES))
        busy_txt = (f"device busy {busy:.3f} ms "
                    f"({100 * busy / statistics.median(host):.1f}% of the "
                    f"host-clock tick), {n} kernels ({gemm} matrix products)"
                    if n else "device busy not measured (no device events "
                    "traced)")
        log(f"[phase 10b] {key.acfg.method} bank tick (2 rows x {TRAIN_B} x "
            f"{TRAIN_S} tokens): host ms {[round(x, 3) for x in host]}; "
            f"{busy_txt}")


def p10_memory(cfg, base):
    """Peak device memory beyond the resident base and bank of one bank
    step at 1 job per method (§3.6 path, FinetuneConfig's remat), beside
    the job's ``job_hbm_bytes`` charge; returns the peaks (GiB) by
    method."""
    remat = FinetuneConfig().remat
    out, peaks = [], {}
    for i, m in enumerate(("lora", "ia3", "prefix")):
        acfg = P10_ACFGS[m]
        step = symbiosis.make_compact_train_step(cfg, acfg, remat=remat)
        bank = random_bank(cfg, acfg, 1, 110 + i)
        opt = p10_opt(bank, 0)
        batch = train_batches(cfg, 1, 111)
        args = (torch.zeros(1, dtype=torch.int32, device=DEV),
                torch.ones(1, dtype=torch.bool, device=DEV))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step(base, bank, opt, batch, *args, step7a_hyper(1))
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        peaks[m] = peak
        charge = job_hbm_bytes(cfg, p10_jobs(cfg)[2 * i], remat=remat)
        out.append(f"{m} {peak:.3f} GiB (charge {charge / 2**30:.3f} GiB, "
                   f"{peak * 2**30 / charge:.1f}x)")
        del bank, opt, batch
    torch.cuda.empty_cache()
    log(f"[phase 10b] peak device memory beyond the resident base and bank, "
        f"one bank step at 1 job ({cfg.n_layers} layers bf16, {TRAIN_B} x "
        f"{TRAIN_S} tokens, remat={remat}), beside job_hbm_bytes: "
        + "; ".join(out))
    return peaks


def p10_results(jobs):
    return {j.name: (j.losses, j.result.adapter, j.result.opt) for j in jobs}


def phase10b(cfg, base):
    """10b: a FinetuneEngine(debug=True) over phase 4's base with the six
    jobs: every job's losses against its solo run; returns the results
    (the uninterrupted run of 10c) and the tick times."""
    jobs = p10_jobs(cfg)
    eng = p10_engine(cfg, base)
    for j in jobs:
        eng.submit(j)
    ticks = timed_ticks(eng)
    if any(j.status != "finished" or len(j.losses) != TRAIN_STEPS
           or not np.isfinite(j.losses).all() for j in jobs):
        raise AssertionError(f"[phase 10b] {[(j.status, j.losses) for j in jobs]}")
    if len(eng._banks) != 3 or eng.stats["peak_jobs"] != 6:
        raise AssertionError(f"[phase 10b] banks {len(eng._banks)}, stats "
                             f"{eng.stats}")
    worst, upd = 0.0, []
    for j in jobs:
        solo, first, solo_adapter = solo_run(cfg, base, j)
        worst = max(worst, compare(f"[phase 10b] {j.name} losses against its "
                                   "solo run", torch.tensor(j.losses),
                                   torch.tensor(solo), LOSS_7B_TOL))
        upd.append(round(update_rel_diff(j.result.adapter, solo_adapter,
                                         first), 4))
        if not upd[-1] <= UPDATE_7B_REL:
            raise AssertionError(f"[phase 10b] {j.name}'s adapter update is "
                                 f"{upd[-1]:.3e} (relative norm) from its "
                                 f"solo run's, limit {UPDATE_7B_REL}")
    tokens = 6 * TRAIN_B * TRAIN_S
    log(f"[phase 10b] {cfg.name}: {cfg.n_layers} layers bf16, FinetuneEngine"
        f"(debug=True) with 2 LoRA r8 (q, v), 2 IA3 (k, v, down) and 2 "
        f"prefix (16 tokens) jobs of {TRAIN_B} x {TRAIN_S} tokens, "
        f"{TRAIN_STEPS} steps each, 3 banks; stats {eng.stats}")
    log(f"[phase 10b] losses {[[round(x, 4) for x in j.losses] for j in jobs]}"
        f"; against each job's solo make_baseline_train_step: max abs err "
        f"{worst:.3e} ({LOSS_7B_TOL}); adapter updates against the solo "
        f"runs' (relative norm): {upd} (limit {UPDATE_7B_REL})")
    log(f"[phase 10b] tick ms (host clock, synchronised; 3 banks of 2 rows "
        f"each, {tokens} tokens per tick): "
        f"{[round(t * 1e3, 3) for t in ticks]}; after the first "
        f"{statistics.median(ticks[1:]) * 1e3:.3f} ms median, "
        f"{tokens / statistics.median(ticks[1:]):.0f} tokens/s")
    p10_bank_ticks(cfg, base)
    peaks = p10_memory(cfg, base)
    return p10_results(jobs), ticks, peaks


class NanAt:
    """A job stream whose batch at step ``at`` carries a NaN loss mask
    (every other batch a mask of ones)."""

    def __init__(self, inner, at):
        self.inner, self.at = inner, at

    def batch(self, step):
        b = dict(self.inner.batch(step))
        b["mask"] = torch.full(b["labels"].shape,
                               float("nan") if step == self.at else 1.0,
                               device=b["labels"].device)
        return b


def flip_payload_byte(path):
    """XOR the last byte of an engine blob (inside its pickle payload)."""
    with open(path, "r+b") as f:
        f.seek(-1, 2)
        b = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([b[0] ^ 0xFF]))


def phase10c(cfg, base, ref):
    """10c: the engine killed after 2 ticks and resumed by a fresh engine
    from the newest valid blob (a corrupted newer copy skipped) ends every
    job bit for bit as the uninterrupted run ``ref``; a NaN-poisoned job's
    quarantine checkpoint restores its last clean state bit for bit."""
    with tempfile.TemporaryDirectory() as d:
        eng = p10_engine(cfg, base)
        for j in p10_jobs(cfg):
            eng.submit(j)
        eng.train_tick()
        save_engine_state(d, eng.engine_state())
        eng.train_tick()
        t0 = time.perf_counter()
        path = save_engine_state(d, eng.engine_state())
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        newest = os.path.join(d, "engine_00000002.ckpt")
        shutil.copy(path, newest)
        flip_payload_byte(newest)
        del eng                                          # the crash
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        seq, state = load_engine_state(d)
        fresh = p10_engine(cfg, base)
        fresh.load_engine_state(state)
        t_load = time.perf_counter() - t0
        if seq != 1:
            raise AssertionError(f"[phase 10c] restored blob {seq}, wanted 1 "
                                 "(the corrupted blob 2 must be skipped)")
        got = p10_results(fresh.run())
    if sorted(got) != sorted(ref):
        raise AssertionError(f"[phase 10c] jobs {sorted(got)} against "
                             f"{sorted(ref)}")
    diffs = {name: max_diff((got[name][1], got[name][2]),
                            (ref[name][1], ref[name][2]))
             for name in ref}
    same = {name: got[name][0] == ref[name][0]
            and trees_equal((got[name][1], got[name][2]),
                            (ref[name][1], ref[name][2])) for name in ref}
    if not all(same.values()):
        worst = max(diffs, key=diffs.get)
        raise AssertionError(f"[phase 10c] resumed jobs differ from the "
                             f"uninterrupted run: {same}; largest state "
                             f"difference {diffs[worst]:.3e} ({worst}); "
                             f"losses {[(got[n][0], ref[n][0]) for n in ref]}")
    log(f"[phase 10c] engine_state after 2 of {TRAIN_STEPS} ticks: blob of "
        f"{size} B written in {t_save * 1e3:.1f} ms; a copy with one payload "
        f"byte flipped as the newest blob was skipped (restored seq {seq}); "
        f"a fresh engine loaded it in {t_load * 1e3:.1f} ms and ran to the "
        f"end: all 6 jobs' losses, adapters and AdamW states equal the "
        f"uninterrupted run's (10b) bit for bit")

    with tempfile.TemporaryDirectory() as d:
        jobs = p10_jobs(cfg, steps=3, first_seed=30,
                        data=lambda i, s: NanAt(s, 2 if i == 2 else -1))
        jobs = [jobs[2], jobs[4]]                    # an IA3 and a prefix job
        eng = p10_engine(cfg, base, quarantine_dir=d)
        for j in jobs:
            eng.submit(j)
        eng.run()
        bad, ok = jobs
        if (bad.status, ok.status) != ("quarantined", "finished") \
                or bad.result.step != 2:
            raise AssertionError(f"[phase 10c] statuses {bad.status} / "
                                 f"{ok.status}, step {bad.result.step}")
        like = tree_map(torch.zeros_like, bad.result.adapter)
        ad, opt = restore_job_state(d, 2, like, adamw_init(like),
                                    name=bad.name, device=DEV)
        if not trees_equal((ad, opt), (bad.result.adapter, bad.result.opt)):
            raise AssertionError("[phase 10c] the quarantine checkpoint "
                                 "differs from the job's last clean state")
    log(f"[phase 10c] {bad.name}, its third batch poisoned to NaN: "
        f"quarantined after 2 clean steps, its checkpoint in quarantine_dir "
        f"restores that state bit for bit (restore_job_state); {ok.name} "
        f"beside it finished")


def phase10d(cfg, base, bank, streams4, launches4, ref):
    """10d: a SymbiosisEngine serving phase 4's 8 requests beside 10b's six
    jobs on the same base object: every greedy stream equal to phase 4's,
    the launch counts phase 4's, each job's losses, final adapter and
    AdamW state 10b's bit for bit (interleaving changes when a bank tick
    runs, not its program or its inputs)."""
    spec = dataclasses.replace(serve_spec(cfg, quant=False),
                               finetune=FinetuneConfig())
    sym = SymbiosisEngine.from_spec(spec, base, serving_banks=[bank],
                                    device=DEV)
    sym.finetune.debug = True
    reqs = make_requests(cfg, 4)
    jobs = p10_jobs(cfg)
    for item in reqs + jobs:
        sym.submit(item)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    while sym.tick():
        pass
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    counts = read_counts()
    if counts != launches4:
        raise AssertionError(f"[phase 10d] launches {counts}, phase 4's "
                             f"serving path launched {launches4}")
    for i, r in enumerate(reqs):
        if not np.array_equal(r.generated, streams4[i]):
            raise AssertionError(f"[phase 10d] request {i}'s greedy stream "
                                 "differs from phase 4's")
    for j in jobs:
        want = ref[j.name]
        if j.status != "finished" or j.losses != want[0] \
                or not trees_equal((j.result.adapter, j.result.opt), want[1:]):
            raise AssertionError(
                f"[phase 10d] {j.name} {j.status} losses {j.losses} against "
                f"10b's {want[0]}; largest state difference "
                f"{max_diff((j.result.adapter, j.result.opt), want[1:]):.3e}")
    st = sym.stats
    log(f"[phase 10d] SymbiosisEngine over phase 4's base object: 8 requests "
        f"beside 6 LoRA / IA3 / prefix jobs in {st['ticks']} ticks "
        f"({st['decode_ticks']} serving, {st['train_ticks']} train, "
        f"{t_all:.2f} s): every greedy stream equals phase 4's exactly; "
        f"launches {counts}, phase 4's; every job's losses, final adapter and "
        f"AdamW state equal 10b's bit for bit")


def phase10(cfg, base, bank, streams4, launches4):
    """Every PEFT method fine-tunes on the shared base, and tenants' state
    survives a crash: 10a the steps at full width, 10b the engine at full
    size, 10c recovery, 10d beside serving."""
    t = time.perf_counter()
    phase10a()
    log(f"[phase 10a] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    ref, _, peaks = phase10b(cfg, base)
    log(f"[phase 10b] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    phase10c(cfg, base, ref)
    log(f"[phase 10c] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    phase10d(cfg, base, bank, streams4, launches4, ref)
    log(f"[phase 10d] done ({time.perf_counter() - t:.1f} s)")
    torch.cuda.empty_cache()
    return peaks


# ---------------------------------------------------------------------------
# phase 11: tenants' faults stay contained; the serving engine and the
# service survive a crash
# ---------------------------------------------------------------------------

P11_LATE = 6            # the late requests arrive 6 ticks after phase 4's last
P11_NAN_LAYER = 5       # client 3's LoRA B rows on this layer are NaN
P11_HOOK = (1, 4)       # the admission attempts AllocHook fails


def p11_requests(cfg):
    """Phase 4's 8 requests, then one more per client P11_LATE ticks after
    the last of them (64-256 prompt tokens, 16 new, greedy)."""
    reqs = make_requests(cfg, 4)
    rng = np.random.default_rng(11)
    t = reqs[-1].arrive_tick + P11_LATE
    return reqs + [Request(client_id=c, max_new_tokens=16, arrive_tick=t,
                           prompt=rng.integers(
                               0, cfg.vocab, (1, int(rng.integers(64, 257))))
                           .astype(np.int32)) for c in range(4)]


def p11_serve(eng, reqs, label):
    """Serve ``reqs`` with every launch count set to 0 just before and
    checked tick by tick: per decode tick the paged attention kernel once
    per layer, SGMV twice per layer per decode tick or prefill batch, no
    other kernel. Records for each request the shape of every step that
    produced one of its tokens (``("prefill", rows bucket, padded length,
    shared-prefix width)`` or ``("decode", rows bucket)``), the top-2 logit
    gap there, and the tick each request was admitted. Returns (launches,
    shapes, gaps, admitted)."""
    L = eng.cfg.n_layers
    shapes, gaps, admitted, cur = {}, {}, {}, {}
    prefill, decode, sample = eng._prefill_step, eng._decode_step, eng._sample
    try_admit = eng._try_admit

    def prefill_step(ext, *args):
        cur["shape"] = ("prefill", int(args[3].shape[0]),
                        int(args[3].shape[1]), ext)
        return prefill(ext, *args)

    def decode_step(*args):
        cur["shape"] = ("decode", int(args[3].shape[0]))
        return decode(*args)

    def record(logits, req):
        top = np.sort(logits, axis=-1)[:, -2:]
        gaps.setdefault(id(req), []).append(float((top[:, 1]
                                                   - top[:, 0]).min()))
        shapes.setdefault(id(req), []).append(cur["shape"])
        return sample(logits, req)

    def admit(req):
        slots = try_admit(req)
        if slots is not None:
            admitted[id(req)] = eng._tick
        return slots
    eng._prefill_step, eng._decode_step = prefill_step, decode_step
    eng._sample, eng._try_admit = record, admit
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    reset_counts()
    more = True
    while more:
        before = (read_counts(), eng.stats["ticks"],
                  eng.stats["compact_prefill_batches"])
        more = eng.service_tick()
        now = read_counts()
        d = {n: now[n] - before[0][n] for n in now}
        d_tick = eng.stats["ticks"] - before[1]
        d_pre = eng.stats["compact_prefill_batches"] - before[2]
        want = {n: 0 for n in now}
        want["paged_decode_attn"] = L * d_tick
        want["sgmv"] = 2 * L * (d_tick + d_pre)
        if d != want:
            raise AssertionError(
                f"[{label}] tick {eng._tick}: launches {d} for {d_tick} "
                f"decode ticks and {d_pre} prefill batches; want {want}")
    torch.cuda.synchronize()
    if len(eng.drain_done()) != len(reqs):
        raise AssertionError(f"[{label}] not every request came back")
    return read_counts(), shapes, gaps, admitted


def p11_pools_whole(eng, label):
    """After the drain every page is free again, nothing is reserved or
    held, and the prefix index holds no reference."""
    P = eng._pool_pages
    bad = [c for c in range(eng.n_clients)
           if sorted(eng._free_pages[c]) != list(range(c * P, (c + 1) * P))]
    if bad or any(eng._reserved) or eng._slot_pages or eng._slot_shared \
            or eng._prefix_index.page_refs() or eng._resv_of:
        raise AssertionError(f"[{label}] after the drain: clients {bad} "
                             f"miss pages, reserved {eng._reserved}, "
                             f"refs {eng._prefix_index.page_refs()}")


def p11_containment(cfg, base, bank, spec):
    """11a: phase 4's requests and one late request per client, served
    over the clean bank, then with client 3's LoRA B rows on one layer NaN
    (a copy), admission attempts 1 and 4 failing (``AllocHook``), client
    0's first prompt delivered by a stream that errors once and client 3's
    last by one that runs dry. Client 3 must end quarantined with nothing
    held; every survivor's stream must equal the clean run's bit for bit
    where both runs carried it at the same shapes, and in every case equal
    a fault-free replay at the faulted run's shapes (the survivors
    admitted at the ticks the faults moved them to, client 3's two
    prefilled requests as one-token requests over the clean bank)."""
    clean = ServingEngine(spec, base, [bank], device=DEV, debug=True)
    creqs = p11_requests(cfg)
    l_clean, s_clean, g_clean, _ = p11_serve(clean, creqs,
                                             "phase 11a clean")
    bad = tree_map(torch.clone, bank)
    bad["layers"]["q"]["B"][3, min(P11_NAN_LAYER, cfg.n_layers - 1)] = \
        float("nan")
    hook = AllocHook(P11_HOOK)
    eng = ServingEngine(spec, base, [bad], device=DEV, debug=True,
                        fault_hook=hook)
    reqs = p11_requests(cfg)
    for i, sched in ((0, {0: "stream_error"}), (11, {0: "stream_end"})):
        reqs[i].prompt_stream = FaultyRequestStream(reqs[i].prompt, sched)
        reqs[i].prompt = None
    t0 = time.perf_counter()
    l_fault, s_fault, g_fault, admitted = p11_serve(eng, reqs,
                                                    "phase 11a faulted")
    wall = time.perf_counter() - t0
    if hook.fired != 2 or reqs[0].prompt_stream.calls != 2:
        raise AssertionError(f"[phase 11a] the hook fired {hook.fired} "
                             f"times, the stream was fetched "
                             f"{reqs[0].prompt_stream.calls} times")
    mine = [r for r in reqs if r.client_id == 3]
    if 3 not in eng._quarantined_clients or any(
            r.status not in ("quarantined", "rejected") for r in mine):
        raise AssertionError(f"[phase 11a] client 3: "
                             f"{[r.status for r in mine]}, quarantined "
                             f"{sorted(eng._quarantined_clients)}")
    try:
        eng.submit(Request(client_id=3, prompt=creqs[3].prompt.copy()))
    except ValueError:
        pass
    else:
        raise AssertionError("[phase 11a] a quarantined client's submit "
                             "was accepted")
    if any(o is not None for o in eng._slot_owner[3]):
        raise AssertionError("[phase 11a] client 3 still holds slots")
    p11_pools_whole(clean, "phase 11a clean")
    p11_pools_whole(eng, "phase 11a faulted")
    for i, r in enumerate(reqs):
        log(f"[phase 11a]   request {i} (client {r.client_id}): "
            f"{r.status}, admitted at tick {admitted.get(id(r))}, faults "
            f"{r.fault_history}")
    log("[phase 11a] health records: " + "; ".join(
        f"client {c}: {rec.state.value}, {rec.total_faults} fault(s), "
        f"history {rec.history}"
        for c, rec in sorted(eng._client_health.items())))
    # the fault-free replay at the faulted run's shapes
    order = sorted((admitted[id(r)], i) for i, r in enumerate(reqs)
                   if id(r) in admitted)
    replay = ServingEngine(spec, base, [bank], device=DEV, debug=True)
    rreqs = {}
    for t, i in order:
        r = reqs[i]
        rreqs[i] = Request(client_id=r.client_id, prompt=r.prompt.copy(),
                           arrive_tick=t, max_new_tokens=(
                               1 if r.client_id == 3 else r.max_new_tokens))
    l_rep, s_rep, _, a_rep = p11_serve(replay, [rreqs[i] for _, i in order],
                                       "phase 11a replay")
    same_clean = 0
    for i, r in enumerate(reqs):
        if r.client_id == 3:
            continue
        if r.status != "ok":
            raise AssertionError(f"[phase 11a] survivor {i}: {r.status}")
        shape_f, shape_c = s_fault[id(r)], s_clean[id(creqs[i])]
        if s_rep[id(rreqs[i])] != shape_f or a_rep[id(rreqs[i])] != \
                admitted[id(r)]:
            raise AssertionError(f"[phase 11a] the replay carried request {i}"
                                 " at other shapes or ticks than the "
                                 "faulted run")
        d = first_diff(r.generated, creqs[i].generated)
        if d is None:
            same_clean += 1
        else:
            log(f"[phase 11a]   request {i} (client {r.client_id}) first "
                f"differs from the clean run at step {d}: top-2 gap "
                f"{g_fault[id(r)][d]:.4f} (clean {g_clean[id(creqs[i])][d]:.4f}"
                f"), shapes faulted {shape_f[:d + 1][-2:]} clean "
                f"{shape_c[:d + 1][-2:]}")
            if shape_f[:d + 1] == shape_c[:d + 1]:
                raise AssertionError(
                    f"[phase 11a] request {i}'s stream differs from the "
                    f"clean run's at step {d} at the same shapes: a fault "
                    "reached a survivor")
        if not np.array_equal(r.generated, rreqs[i].generated):
            raise AssertionError(
                f"[phase 11a] request {i}'s stream differs from the "
                f"fault-free replay at step "
                f"{first_diff(r.generated, rreqs[i].generated)}")
    st = eng.stats
    log(f"[phase 11a] faulted run ({wall:.2f} s): {st['faults']} faults, "
        f"{st['quarantined_requests']} requests quarantined, "
        f"{st['rejected_requests']} rejected, clients quarantined "
        f"{sorted(eng._quarantined_clients)}; hook fired {hook.fired}x, the "
        f"erroring stream fetched {reqs[0].prompt_stream.calls}x; launches "
        f"{l_fault} over {st['ticks']} decode ticks and "
        f"{st['compact_prefill_batches']} prefill batches (clean "
        f"{l_clean}, replay {l_rep}), checked tick by tick: "
        f"{l_fault['paged_decode_attn'] / st['ticks']:g} paged attention "
        "launches per decode tick")
    log(f"[phase 11a] survivors: {same_clean} of 9 streams equal the clean "
        f"run's bit for bit, 9 of 9 the fault-free replay's at the faulted "
        "run's shapes; pools and prefix refs whole after the drain in both "
        "runs; a submit for client 3 refused")


def p11_kill(cfg, base, bank, spec, want_streams, want_launches, label,
             router_bytes=None):
    """11b: serve phase 4's requests for 3 ticks, snapshot the engine
    (``engine_state``) into a blob, drop it, and resume the blob in a
    fresh engine (and a fresh router, which the restore re-charges): the
    streams must equal ``want_streams`` and the launches before the kill
    plus those after it ``want_launches``, bit for bit and exactly.
    Returns the blob's bytes and the save and load seconds."""
    def engine():
        router = (PlacementRouter(cfg, [Slot(0, free_hbm=router_bytes)])
                  if router_bytes else None)
        return ServingEngine(spec, base, [bank], device=DEV, router=router)
    eng = engine()
    reqs = make_requests(cfg, 4)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(3):
        eng.service_tick()
    torch.cuda.synchronize()
    before = read_counts()
    if not (eng.n_inflight and eng._waiting):
        raise AssertionError(f"[{label}] nothing in flight at the kill")
    if eng._share_prefix and not any(eng._slot_shared.values()):
        raise AssertionError(f"[{label}] no published page held at the kill")
    held = sum(len(v) for v in eng._slot_shared.values())
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = save_engine_state(d, eng.engine_state())
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        del eng                                          # the crash
        torch.cuda.empty_cache()
        fresh = engine()
        ptr = fresh.caches["layers"]["k"].data_ptr()
        t0 = time.perf_counter()
        _, state = load_engine_state(d)
        fresh.load_engine_state(state)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    if fresh.caches["layers"]["k"].data_ptr() != ptr:
        raise AssertionError(f"[{label}] the restore moved the pool")
    reset_counts()
    done = fresh.run()
    torch.cuda.synchronize()
    after = read_counts()
    total = {n: before[n] + after[n] for n in before}
    if total != want_launches:
        raise AssertionError(f"[{label}] launches {before} before the kill "
                             f"and {after} after it; the uninterrupted run "
                             f"launched {want_launches}")
    by_prompt = {r.prompt.tobytes(): r for r in done}
    if len(done) != len(reqs):
        raise AssertionError(f"[{label}] {len(done)} requests came back")
    for i, r in enumerate(reqs):
        got = by_prompt[r.prompt.tobytes()]
        if got.status != "ok" or not np.array_equal(got.generated,
                                                    want_streams[i]):
            raise AssertionError(
                f"[{label}] request {i} after the restore: {got.status}, "
                f"first differs at step "
                f"{first_diff(got.generated, want_streams[i])}")
    if fresh.router is not None and (fresh.router._committed
                                     or fresh.router.conservation_errors()):
        raise AssertionError(f"[{label}] the fresh router after the drain: "
                             f"{fresh.router.utilization()}")
    p11_pools_whole(fresh, label)
    log(f"[{label}] killed after 3 ticks ({len(state['inflight'])} in "
        f"flight, {len(state['waiting'])} waiting, {held} published pages "
        f"held): blob of {size} B saved in {t_save:.3f} s, loaded into a "
        f"fresh engine in {t_load:.3f} s; every stream equals the "
        f"uninterrupted run's bit for bit, launches {before} + {after} = "
        f"its {want_launches}"
        + ("; the fresh router re-charged and empty after the drain"
           if fresh.router is not None else ""))
    return size, t_save, t_load


def p11_service(cfg, base, bank, streams4, launches4):
    """11c: a SymbiosisEngine of phase 4's requests and 2 LoRA jobs (2 x
    256 tokens, 3 steps), checkpointed after 4 ticks; a newer copy of the
    blob with one byte flipped; ``restore`` into fresh engines must skip
    it and end bit for bit as the uninterrupted service: every stream,
    every job's losses, adapter and AdamW state; the launches of the
    uninterrupted service, and those before plus after the kill, phase
    4's."""
    spec = dataclasses.replace(serve_spec(cfg, quant=False),
                               finetune=FinetuneConfig())

    def build():
        sym = SymbiosisEngine.from_spec(spec, base, serving_banks=[bank],
                                        device=DEV)
        reqs, jobs = make_requests(cfg, 4), train_jobs(cfg, 2,
                                                       first_seed=40)
        for item in reqs + jobs:
            sym.submit(item)
        return sym, reqs, jobs
    ref, ref_reqs, ref_jobs = build()
    torch.cuda.synchronize()
    reset_counts()
    ref.run()
    torch.cuda.synchronize()
    if read_counts() != launches4:
        raise AssertionError(f"[phase 11c] the uninterrupted service "
                             f"launched {read_counts()}, phase 4 "
                             f"{launches4}")
    for i, r in enumerate(ref_reqs):
        if not np.array_equal(r.generated, streams4[i]):
            raise AssertionError(f"[phase 11c] uninterrupted request {i} "
                                 "differs from phase 4's")
    sym, _, _ = build()
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(4):
        sym.tick()
    torch.cuda.synchronize()
    before = read_counts()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        seq = sym.checkpoint(d)
        t_save = time.perf_counter() - t0
        path = os.path.join(d, f"engine_{seq:08d}.ckpt")
        size = os.path.getsize(path)
        newer = os.path.join(d, f"engine_{seq + 1:08d}.ckpt")
        shutil.copy(path, newer)
        corrupt_flip(newer, seed=11)
        del sym                                          # the crash
        torch.cuda.empty_cache()
        fresh = SymbiosisEngine.from_spec(spec, base, serving_banks=[bank],
                                          device=DEV)
        t0 = time.perf_counter()
        got_seq = fresh.restore(d)
        t_load = time.perf_counter() - t0
    if got_seq != seq:
        raise AssertionError(f"[phase 11c] restored blob {got_seq}, wanted "
                             f"{seq} (the corrupt blob {seq + 1} is newer)")
    reset_counts()
    reqs, jobs = fresh.run()
    torch.cuda.synchronize()
    after = read_counts()
    if {n: before[n] + after[n] for n in before} != launches4:
        raise AssertionError(f"[phase 11c] launches {before} before the kill"
                             f" and {after} after it; phase 4 {launches4}")
    want = {r.prompt.tobytes(): r.generated for r in ref_reqs}
    if len(reqs) != len(ref_reqs) or any(
            not np.array_equal(r.generated, want[r.prompt.tobytes()])
            for r in reqs):
        raise AssertionError("[phase 11c] a stream differs from the "
                             "uninterrupted service's")
    by_name = {j.name: j for j in jobs}
    for rj in ref_jobs:
        j = by_name[rj.name]
        if j.losses != rj.losses or not trees_equal(
                (j.result.adapter, j.result.opt),
                (rj.result.adapter, rj.result.opt)):
            raise AssertionError(
                f"[phase 11c] {j.name}: losses {j.losses} against "
                f"{rj.losses}; largest state difference "
                f"{max_diff((j.result.adapter, j.result.opt), (rj.result.adapter, rj.result.opt)):.3e}")
    log(f"[phase 11c] SymbiosisEngine (8 requests, 2 LoRA jobs) "
        f"checkpointed after 4 ticks: blob of {size} B in {t_save:.3f} s; "
        f"the newer copy with a flipped byte skipped, blob {seq} restored "
        f"into fresh engines in {t_load:.3f} s; every stream, and both "
        f"jobs' losses, adapters and AdamW states equal the uninterrupted "
        f"service's bit for bit; launches {before} + {after}, phase 4's")


def p11_charge(cfg, peaks7, peaks10):
    """11d: the fine-tuning charge (JAX's ``job_hbm_bytes`` plus the port's
    ``job_activation_bytes`` and ``job_working_bytes``) beside the peaks
    measured in 7c (1 and 4
    LoRA jobs, §3.6 and the torch-like baseline) and 10b (1 job per
    method): no charge may fall below its peak."""
    jobs = {m: p10_jobs(cfg)[2 * i] for i, m in
            enumerate(("lora", "ia3", "prefix"))}
    rows = []
    for (mo, R), peak in peaks7.items():
        rows.append((f"7c {'§3.6' if mo else 'baseline'} LoRA x{R}", peak,
                     R * job_charge_bytes(cfg, train_jobs(cfg, 1)[0],
                                          memory_optimized=mo) / 2**30))
    for m, peak in peaks10.items():
        rows.append((f"10b {m} x1", peak,
                     job_charge_bytes(cfg, jobs[m]) / 2**30))
    log("[phase 11d] charge against peak beyond the base (GiB): " + "; ".join(
        f"{name} {charge:.3f} / {peak:.3f} ({charge / peak:.2f}x)"
        for name, peak, charge in rows))
    low = [name for name, peak, charge in rows if charge < peak]
    if low:
        raise AssertionError(f"[phase 11d] charges below their peak: {low}")


def phase11(cfg, base, bank, streams4, launches4, streams4b, launches4b,
            peaks7, peaks10):
    """Faults stay contained and crashes lose nothing: 11a containment,
    11b the serving engine killed and restored (bf16 pages, then int8
    behind a router), 11c the service, 11d the fine-tuning charge."""
    spec = serve_spec(cfg, quant=False)
    t = time.perf_counter()
    p11_containment(cfg, base, bank, spec)
    log(f"[phase 11a] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    p11_kill(cfg, base, bank, spec, streams4, launches4, "phase 11b")
    qspec = serve_spec(cfg, quant=True)
    charges = sorted(kvcache.cache_bytes(
        cfg, r.prompt.shape[1] + r.max_new_tokens, 1, quant=True,
        page_block=qspec.serve.page_block) for r in make_requests(cfg, 4))
    p11_kill(cfg, base, bank, qspec, streams4b, launches4b,
             "phase 11b int8", router_bytes=sum(charges[-4:]))
    log(f"[phase 11b] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    p11_service(cfg, base, bank, streams4, launches4)
    log(f"[phase 11c] done ({time.perf_counter() - t:.1f} s)")
    p11_charge(cfg, peaks7, peaks10)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 12: tick-level telemetry on both engines; the chaos sweep
# ---------------------------------------------------------------------------

P12_SPANS = ("admit", "prefill", "prefill_compact_gather", "compact_gather",
             "jit_dispatch", "device_sync", "scatter", "health_audit")
P12_TRAIN_SPANS = ("admit", "compact_gather", "train_step", "device_sync",
                   "scatter")
# device kernels a captured serving window must hold (the paged attention
# split and SGMV)
P12_TRACE_KERNELS = ("split_kernel", "sgmv")
P12_LATENCIES = ("serve_queue_wait_seconds", "serve_ttft_seconds",
                 "serve_intertoken_seconds", "serve_e2e_seconds")


def span_totals(obs):
    """(calls, seconds) of every span phase so far."""
    out = {}
    for (kind, name, labels), h in obs.metrics._data.items():
        if kind == "histogram" and name == "span_seconds":
            out[dict(labels)["phase"]] = (h.n, h.total)
    return out


def p12_run(cfg, base, bank, spec, obs, *, router=None):
    """Phase 4's 8 requests on ``spec`` to the end, unsynchronised, every
    tick under ``torch.cuda.set_sync_debug_mode("warn")``. Per tick: each
    counted kernel's launches and the synchronising calls (counted from the
    warnings). Per decode tick without an admission: its seconds on the
    host's clock (its logits copy is its one wait for the device) and, with
    telemetry, each span's calls and seconds. Returns (requests, engine,
    launches per tick, syncs per tick, tick seconds, span totals over those
    ticks)."""
    eng = ServingEngine(spec, base, [bank], device=DEV, router=router,
                        obs=obs)
    reqs = make_requests(cfg, 4)
    for r in reqs:
        eng.submit(r)
    launches, syncs, ticks, spans = [], [], [], {}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            more = True
            while more:
                n0, c0 = len(got), read_counts()
                before = (eng.stats["ticks"], eng.stats["prefill_calls"])
                s0 = span_totals(obs) if obs is not None else {}
                t0 = time.perf_counter()
                more = eng.service_tick()
                dt = time.perf_counter() - t0
                c1 = read_counts()
                launches.append({k: c1[k] - c0[k] for k in c1})
                syncs.append(sum("synchroniz" in str(w.message)
                                 for w in got[n0:]))
                if (eng.stats["ticks"], eng.stats["prefill_calls"]) == \
                        (before[0] + 1, before[1]):
                    ticks.append(dt)
                    for k, (n, t) in (span_totals(obs) if obs is not None
                                      else {}).items():
                        n_, t_ = s0.get(k, (0, 0.0))
                        a, b = spans.get(k, (0, 0.0))
                        spans[k] = (a + n - n_, b + t - t_)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    done = eng.drain_done()
    if len(done) != len(reqs) or any(r.status != "ok" for r in reqs):
        raise AssertionError(f"[phase 12a] {len(done)} of {len(reqs)} "
                             "requests finished ok")
    return reqs, eng, launches, syncs, ticks, spans


def same_launches(label, launches, ref, names=None):
    """``launches`` (per tick, by kernel) against ``TICK_LAUNCHES[ref]``:
    ``drive`` records (attention, idle attention, SGMV) tuples, named by
    ``names``; ``p9_serve`` every counted kernel."""
    got = [tuple(d[n] for n in names) if names else d for d in launches]
    if got != TICK_LAUNCHES[ref]:
        raise AssertionError(f"[{label}] launches per tick {got} differ from "
                             f"{ref}'s {TICK_LAUNCHES[ref]}")


def same_streams(label, reqs, want, what):
    for i, r in enumerate(reqs):
        if not np.array_equal(r.generated, want[i]):
            raise AssertionError(f"[{label}] request {i}'s stream differs "
                                 f"from {what} at step "
                                 f"{first_diff(r.generated, want[i])}")


def hist_line(h, scale=1e3, unit="ms"):
    """A log-2 histogram as 'n, mean, p50 <=, p99 <=' (its percentiles are
    bucket upper edges: within 2x)."""
    return (f"n {h.n}, mean {h.mean * scale:.3f} {unit}, p50 <= "
            f"{h.percentile(50) * scale:.3f}, p99 <= "
            f"{h.percentile(99) * scale:.3f}")


def p12_report(label, obs):
    """Print every span phase, the tick and each client's latencies."""
    for name in P12_SPANS:
        h = obs.metrics.histogram("span_seconds", phase=name)
        log(f"[{label}]   span {name:24s} {hist_line(h)}")
    log(f"[{label}]   tick_seconds             "
        f"{hist_line(obs.metrics.histogram('tick_seconds', engine='serving'))}")
    for c in range(4):
        log(f"[{label}]   client {c}: " + "; ".join(
            f"{m[6:-8]} {hist_line(obs.metrics.histogram(m, client=c))}"
            for m in P12_LATENCIES))


def p12_host_cost(n=5000):
    """Host microseconds of telemetry's pieces on this host: a span (its
    ``record_function`` range and histogram), a decode row's updates
    (counter, inter-token histogram, timestamp) and an event."""
    obs, out = Obs(), {}
    sp = obs.span("x")
    t0 = time.perf_counter()
    for _ in range(n):
        with sp:
            pass
    out["span"] = (time.perf_counter() - t0) / n * 1e6
    last = {}
    t0 = time.perf_counter()
    for i in range(n):
        obs.metrics.counter("serve_decode_tokens_total", client=i % 4).inc(1)
        obs.metrics.histogram("serve_intertoken_seconds",
                              client=i % 4).observe(1e-2)
        last[i % 8] = 1.0
    out["row"] = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for i in range(n):
        obs.event("admit", engine="serving", tick=i, tenant=i % 4, rows=1,
                  prompt_tokens=64)
    out["event"] = (time.perf_counter() - t0) / n * 1e6
    return out


def p12_serving(cfg, base, bank, streams4, streams4b):
    """12a / 12b / 12c."""
    spec = serve_spec(cfg, quant=False)
    paged = ("paged_decode_attn", "paged_decode_attn_quant", "sgmv")
    # four runs in turns (off, on, on, off): streams and launches per tick
    # against phase 4, synchronising calls per tick on against off, the
    # median tick, and a decode tick's host time by span
    med, syncs, spans_on, obs_on, engs = [], [], [], [], {}
    for on in (False, True, True, False):
        o = Obs() if on else None
        rq, e, launches, sy, ticks, spans = p12_run(cfg, base, bank, spec, o)
        same_streams("phase 12a", rq, streams4, "phase 4's")
        same_launches("phase 12a", launches, "phase 4", paged)
        med.append(statistics.median(ticks) * 1e3)
        syncs.append(sy)
        engs[on] = e
        if on:
            spans_on.append((spans, len(ticks)))
            obs_on.append(o)
    if any(sy != syncs[0] for sy in syncs):
        raise AssertionError(f"[phase 12a] synchronising calls per tick, "
                             f"off / on / on / off: {syncs}")
    obs = obs_on[0]
    # the steps' compile events (one per new call signature, from
    # ``analysis.tracecount.dispatch``) beside the requests' events
    compiles = [e for e in obs.events.peek() if e.kind == "compile"]
    ev = [e for e in obs.events.peek() if e.kind != "compile"]
    kinds = {e.kind for e in ev}
    if kinds != {"admit", "retire"} or len(ev) != 16 or not compiles:
        raise AssertionError(f"[phase 12a] events {sorted(kinds)} x "
                             f"{len(ev)} and {len(compiles)} compiles, want "
                             "8 admit, 8 retire and the steps' compiles")
    for k in ("_prefill_steps", "_client_prefills"):
        if set(getattr(engs[True], k)) != set(getattr(engs[False], k)):
            raise AssertionError(f"[phase 12a] {k} differs with telemetry")
    if engs[True]._buckets != engs[False]._buckets:
        raise AssertionError("[phase 12a] buckets differ with telemetry")
    log(f"[phase 12a] off / on / on / off: every stream phase 4's bit for "
        f"bit and the launches phase 4's tick by tick "
        f"({len(TICK_LAUNCHES['phase 4'])} ticks); synchronising calls per "
        f"tick (sync debug mode 'warn') equal in all four: {syncs[0]}; "
        f"{len(ev)} events (8 admit, 8 retire) and {len(compiles)} compile "
        "events; built steps and buckets equal with and without telemetry")
    log(f"[phase 12a] service tick without admission, median ms over "
        f"{len(ticks)} ticks (unprofiled, sync debug mode 'warn', in turns "
        f"off / on / on / off): {med[0]:.3f} / {med[1]:.3f} / {med[2]:.3f} / "
        f"{med[3]:.3f}")
    for i, (spans, n) in enumerate(spans_on):
        tot = sum(t for _, t in spans.values())
        log(f"[phase 12a] on-run {i + 1}: a decode tick's host time by span "
            f"(ms per tick over {n} ticks; calls per tick): " + ", ".join(
                f"{k} {spans[k][1] / n * 1e3:.3f} ({spans[k][0] / n:g})"
                for k in P12_SPANS if k in spans)
            + f"; spans {tot / n * 1e3:.3f} of the median tick "
            f"{med[1 + i]:.3f}")
    cost = p12_host_cost()
    spans, n = spans_on[0]
    per_tick = (sum(c for c, _ in spans.values()) / n * cost["span"]
                + 8 * cost["row"])
    log(f"[phase 12a] telemetry's host cost on this host: span "
        f"{cost['span']:.2f} us, decode row's updates {cost['row']:.2f} us, "
        f"event {cost['event']:.2f} us; a decode tick of 8 rows "
        f"({sum(c for c, _ in spans.values()) / n:g} spans) "
        f"{per_tick:.1f} us")
    p12_report("phase 12a on-run 1", obs)

    # int8 pages behind phase 4b's router, and the dense layout: off, on
    qspec, dspec = serve_spec(cfg, quant=True), p9_spec(cfg, 0)
    for label, sp, ref, names, want in (
            ("int8", qspec, "phase 4b",
             ("paged_decode_attn_quant", "paged_decode_attn", "sgmv"),
             streams4b),
            ("dense", dspec, "phase 9a opportunistic", None,
             SERVED["phase 9a opportunistic"])):
        sy = {}
        for on in (False, True):
            router = (quant_router(cfg, sp, make_requests(cfg, 4))
                      if sp is qspec else None)
            rq, e, launches, sy[on], _, _ = p12_run(
                cfg, base, bank, sp, Obs() if on else None, router=router)
            same_streams(f"phase 12a {label}", rq, want, f"{ref}'s")
            same_launches(f"phase 12a {label}", launches, ref, names)
            if router is not None:
                used = router.utilization()
                if used["placements"] or (on and e._obs.metrics.gauge(
                        "router_committed_bytes").value
                        != used["committed_bytes"]):
                    raise AssertionError(f"[phase 12a] int8 router after the "
                                         f"drain: {used}")
        if sy[True] != sy[False]:
            raise AssertionError(f"[phase 12a] {label}: synchronising calls "
                                 f"per tick {sy[True]} with telemetry, "
                                 f"{sy[False]} without")
        log(f"[phase 12a] {label}: off and on, launches equal {ref}'s tick by "
            f"tick ({len(TICK_LAUNCHES[ref])} ticks), streams bit for bit; "
            f"synchronising calls per tick equal: {sy[True]}")

    # 12b: export and validate
    out = tempfile.mkdtemp(prefix="p12_obs_")
    files = write_files(obs, out)
    chk = subprocess.run([sys.executable, "-m", "repro_torch.obs", "--check",
                          *files], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(
                             Path(__file__).resolve().parent / "src")))
    if chk.returncode:
        raise AssertionError(f"[phase 12b] --check: {chk.stderr}")
    log(f"[phase 12b] telemetry.jsonl ({os.path.getsize(files[0])} B) and "
        f"metrics.prom ({os.path.getsize(files[1])} B) from 12a: "
        f"{chk.stdout.strip()}")

    # 12c: a profiler capture of two ticks on a fresh engine
    cap = Obs()
    eng = ServingEngine(spec, base, [bank], device=DEV, obs=cap, debug=True)
    for r in make_requests(cfg, 4):
        eng.submit(r)
    cap.request_capture(os.path.join(out, "capture"), ticks=2)
    t0 = time.perf_counter()
    for _ in range(2):
        eng.service_tick()
    dt = time.perf_counter() - t0
    kinds = [e.kind for e in cap.events.peek()]
    if "capture_start" not in kinds or "capture_stop" not in kinds \
            or not cap.capture_path:
        raise AssertionError(f"[phase 12c] capture events {kinds}")
    trace = json.load(open(cap.capture_path))["traceEvents"]
    names = {e.get("name", "") for e in trace}
    missing = [p for p in P12_SPANS if f"repro_torch.obs/{p}" not in names]
    kern = {k: sum(1 for e in trace if e.get("cat") == "kernel"
                   and k in e.get("name", "")) for k in P12_TRACE_KERNELS}
    if missing or not all(kern.values()):
        raise AssertionError(f"[phase 12c] the trace lacks spans {missing} "
                             f"or kernels {kern}")
    log(f"[phase 12c] capture of 2 ticks ({dt:.3f} s with the profiler): "
        f"capture_start, capture_stop, {cap.capture_path} "
        f"({os.path.getsize(cap.capture_path)} B) holds every serving span "
        f"and the kernels {kern}")
    shutil.rmtree(out, ignore_errors=True)


def p12_training(cfg, base, bank, streams4):
    """12d: a FinetuneEngine with and without telemetry, bit for bit; a
    SymbiosisEngine with one shared Obs beside phase 4's requests."""
    runs = []
    for obs in (None, Obs()):
        eng = FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()),
                             base, device=DEV, obs=obs)
        jobs = train_jobs(cfg, 2)
        for j in jobs:
            eng.submit(j)
        eng.run()
        runs.append((eng, jobs, obs))
    (off, a, _), (on, b, obs) = runs
    for x, y in zip(a, b):
        if x.losses != y.losses or not trees_equal(
                (x.result.adapter, x.result.opt),
                (y.result.adapter, y.result.opt)):
            raise AssertionError(f"[phase 12d] {x.name} differs with "
                                 "telemetry")
    if on.stats != off.stats:
        raise AssertionError("[phase 12d] stats differ with telemetry")
    ticks = on.stats["train_ticks"]
    log(f"[phase 12d] FinetuneEngine, 2 LoRA jobs x {TRAIN_STEPS} steps: "
        f"losses, adapters and AdamW states with telemetry equal without, "
        f"bit for bit; per train tick (host ms): " + ", ".join(
            f"{p} {obs.metrics.histogram('span_seconds', phase=p).total / ticks * 1e3:.3f}"
            for p in P12_TRAIN_SPANS) + "; tick " + hist_line(
            obs.metrics.histogram("tick_seconds", engine="finetune")))
    spec = dataclasses.replace(serve_spec(cfg, quant=False),
                               finetune=FinetuneConfig())
    shared = Obs()
    sym = SymbiosisEngine.from_spec(spec, base, serving_banks=[bank],
                                    device=DEV, obs=shared)
    reqs, jobs = make_requests(cfg, 4), train_jobs(cfg, 2)
    for item in reqs + jobs:
        sym.submit(item)
    sym.run()
    same_streams("phase 12d", reqs, streams4, "phase 4's")
    for x, y in zip(jobs, b):
        if x.losses != y.losses:
            raise AssertionError(f"[phase 12d] {x.name}'s losses beside "
                                 "serving differ from the engine alone")
    ev = sym.drain_events()
    seqs = [e.seq for e in ev]
    by = {(e.engine, e.kind) for e in ev}
    if seqs != sorted(seqs) or not {("serving", "admit"), ("serving", "retire"),
                                    ("finetune", "admit"),
                                    ("finetune", "retire")} <= by \
            or sym.drain_events():
        raise AssertionError(f"[phase 12d] merged feed {sorted(by)}")
    log(f"[phase 12d] SymbiosisEngine with one shared Obs: streams phase 4's, "
        f"losses the engine's alone, bit for bit; the merged feed: {len(ev)} "
        f"events in sequence order, " + ", ".join(
            f"{eng_} {sum(e.engine == eng_ for e in ev)}"
            for eng_ in ("serving", "finetune")))


# How far a fine-tuning job may drift from its run in other buckets (the
# card's merged train step is not bank-size invariant: ROADMAP Queue 3):
# rounding, at the scale the CPU tests hold the port's training to JAX's
# (losses atol = rtol = 1e-5 at ~4.9; states 1e-3 of a leaf's largest
# magnitude, ``assert_state_close``'s atol scale).
P12_DRIFT_TOL = {"loss": 1e-4, "state": 1e-3}
P12_DRIFT_ERRORS = ("losses diverged from clean run", "adapter not bitwise "
                    "clean", "optimizer state not bitwise clean",
                    "committed prefix diverged")


def within_drift(loss, state):
    return loss <= P12_DRIFT_TOL["loss"] and state <= P12_DRIFT_TOL["state"]


def p12_bank_invariance():
    """How far a job's bits depend on its bucket on the card (the stated
    departure): at the chaos config, LoRA, IA3 and prefix jobs over 2
    compact train steps alone against every position of buckets of 2, 4
    and 8 rows (a padding and a NaN row beside it). Prints where bits
    differ and by how much; raises beyond ``P12_DRIFT_TOL``."""
    tiny = chaos._tiny_cfg()
    for label, acfg in (
            ("LoRA r4", chaos._lora()),
            ("IA3", AdapterConfig(method="ia3", targets=("k", "v", "down"))),
            ("prefix", AdapterConfig(method="prefix", targets=("q", "v"),
                                     n_prefix=4))):
        drift = chaos.bank_rows_drift(tiny, acfg, 16, device=DEV)
        loss = max((d[0] for d in drift.values()), default=0.0)
        state = max((d[1] for d in drift.values()), default=0.0)
        log(f"[phase 12e] compact train step, chaos config, {label}, 2 steps:"
            f" a job alone against buckets of 2 / 4 / 8 at every position: "
            + (f"{len(drift)} of 14 placements differ, {sorted(drift)}; "
               f"largest drift: losses {loss:.3e}, state {state:.3e} (of a "
               f"leaf's largest magnitude)" if drift else "bit for bit"))
        if not within_drift(loss, state):
            raise AssertionError(f"[phase 12e] {label}: bucket drift beyond "
                                 f"{P12_DRIFT_TOL}: {drift}")


def p12_chaos():
    """12e: the chaos sweep on the card against its run on the CPU. The
    serving and symbiotic scenarios hold bit for bit; the fine-tuning
    scenario's faulted jobs train in other buckets than the clean run's, so
    on the card its only bitwise errors may be drift, within
    ``P12_DRIFT_TOL``."""
    t0 = time.perf_counter()
    cpu = chaos.run_sweep(seed=0, device="cpu")
    t_cpu = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    card = chaos.run_sweep(seed=0, device=DEV)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    counts = read_counts()
    ft = card["scenarios"][0]
    drift = [e for e in ft["errors"] if e.endswith(P12_DRIFT_ERRORS)]
    other = [e for e in card["errors"] if e not in drift]
    if other or card["total_injected"] < 30 or len(card["kinds"]) < 4 \
            or not within_drift(ft["loss_drift"], ft["state_drift"]):
        raise AssertionError(f"[phase 12e] sweep: {card['errors']}, "
                             f"{card['total_injected']} faults, kinds "
                             f"{card['kinds']}, fine-tuning drift "
                             f"{ft['loss_drift']} / {ft['state_drift']}")
    got = [r["injected"] for r in card["scenarios"]]
    want = [r["injected"] for r in cpu["scenarios"]]
    if got != want or not cpu["ok"] or cpu["scenarios"][0]["loss_drift"] \
            or cpu["scenarios"][0]["state_drift"]:
        raise AssertionError(f"[phase 12e] injected {got} on the card, "
                             f"{want} on the CPU (ok {cpu['ok']})")
    if not (counts["paged_decode_attn"] and counts["sgmv"]):
        raise AssertionError(f"[phase 12e] launches {counts}")
    log(f"[phase 12e] chaos sweep on the card: "
        f"{card['total_injected']} faults of {len(card['kinds'])} kinds "
        f"{card['kinds']}, injected per scenario {got} as on the CPU (where "
        f"it is ok, bit for bit); serving and symbiotic contained bit for "
        f"bit; fine-tuning contained, its bitwise departures {drift or 'none'}"
        f" with largest drift losses {ft['loss_drift']:.3e}, state "
        f"{ft['state_drift']:.3e} (limits {P12_DRIFT_TOL}); {t_card:.1f} s "
        f"(CPU {t_cpu:.1f} s); launches {counts}")


def phase12(cfg, base, bank, streams4, streams4b):
    t = time.perf_counter()
    p12_serving(cfg, base, bank, streams4, streams4b)
    log(f"[phase 12a-c] done ({time.perf_counter() - t:.1f} s)")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    p12_training(cfg, base, bank, streams4)
    log(f"[phase 12d] done ({time.perf_counter() - t:.1f} s)")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    p12_bank_invariance()
    p12_chaos()
    log(f"[phase 12e] done ({time.perf_counter() - t:.1f} s)")


# ---------------------------------------------------------------------------
# phase 13: the MoE and VLM families on the serving path
# ---------------------------------------------------------------------------

P13_LORA = AdapterConfig(method="lora", rank=8, alpha=16.0,
                         targets=("q", "v", "router"))
P13_TEXT = 64            # 13c's text prompt after the image prefix
P13_DECODE = 8           # 13c's decode steps
P13_WITNESS = 2          # 13c's decode steps at 32 layers, kernels vs plain


def p13_sgmv_per_call(cfg, acfg):
    """SGMV launches per decode tick or prefill call: one per layer for
    each targeted attention projection and, with ``router``, one per MoE
    layer (the layers from ``first_dense_layers`` on)."""
    attn = sum(t in ("q", "k", "v", "o") for t in acfg.targets)
    n_moe = (cfg.n_layers - cfg.first_dense_layers
             if cfg.n_experts and cfg.is_moe_layer(cfg.first_dense_layers)
             else 0)
    return attn * cfg.n_layers + ("router" in acfg.targets) * n_moe


def p13_spec(cfg, page_block=16, quant=False, acfg=P13_LORA):
    """Phase 4's serving spec (4 clients x 2 slots, max_seq 512) for
    ``cfg`` with the LoRA bank ``acfg``."""
    spec = serve_spec(cfg, quant)
    return dataclasses.replace(
        spec, banks=(BankSpec("tenants", acfg, 4),),
        serve=dataclasses.replace(spec.serve, page_block=page_block))


def p13_served(eng, reqs, label, attn, idle, per_call, groups=None):
    """``drive`` with the peak device memory the run adds beyond what was
    allocated before it (base, bank, the engine's caches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    launches, times = drive(eng, reqs, label, attn, idle,
                            sgmv_per_call=per_call, groups=groups)
    times["peak_gb"] = (torch.cuda.max_memory_allocated() - before) / 1e9
    log(f"[{label}] peak memory beyond base, bank and caches "
        f"({before / 1e9:.2f} GB): {times['peak_gb']:.3f} GB")
    return launches, times


def p13_alone(cfg, base, bank, spec, reqs, groups, label):
    """Phase 9's rule on the compacted path: every stream bit for bit equal
    to it served alone by a fresh engine of ``spec``, or, for a request
    whose compacted prefill carried others (expert buffers of that batch's
    size), to that batch served alone; a group's requests are also
    printed against their own solo runs."""
    in_group = {}
    for g in groups:
        if len(g) > 1:
            for r, got in zip(g, p9_alone(cfg, base, bank, spec, g)):
                in_group[id(r)] = got
    solo = [p9_alone(cfg, base, bank, spec, [r])[0] for r in reqs]
    for i, r in enumerate(reqs):
        want = in_group.get(id(r), solo[i])
        d = first_diff(r.generated, want)
        if d is not None:
            raise AssertionError(
                f"[{label}] request {i}'s stream differs from it served "
                f"alone ({'its prefill batch' if id(r) in in_group else 'solo'})"
                f" at step {d}")
        if id(r) in in_group and first_diff(r.generated, solo[i]) is not None:
            log(f"[{label}]   request {i} differs from its own solo run at "
                f"step {first_diff(r.generated, solo[i])} (its prefill "
                "batch's expert buffers are larger)")
    log(f"[{label}] every stream equals its run alone on a fresh engine, "
        f"bit for bit ({len(in_group)} of them against the prefill batch "
        f"that carried them; prefill batches {[len(g) for g in groups]})")


def p13_vs(label, reqs, streams, what):
    same = sum(first_diff(r.generated, s) is None
               for r, s in zip(reqs, streams))
    firsts = [first_diff(r.generated, s) for r, s in zip(reqs, streams)]
    log(f"[{label}] {same} of {len(reqs)} streams equal {what} (first "
        f"differing step per request: {firsts})")


def phase13a(cfg, base, bank):
    """deepseek-moe-16b behind the engine: pages (tick-checked launches,
    streams against runs alone), 2-layer wiring on pages and on the dense
    layout, int8 pages, dense."""
    L, per_call = cfg.n_layers, p13_sgmv_per_call(cfg, P13_LORA)
    spec = p13_spec(cfg)
    warm_up(spec, base, bank)
    eng = ServingEngine(spec, base, [bank], device=DEV)
    reqs = make_requests(cfg, 4)
    groups = []
    launches, times = p13_served(eng, reqs, "phase 13a", "paged_decode_attn",
                                 "paged_decode_attn_quant", per_call, groups)
    log(f"[phase 13a] launches checked tick by tick: paged_decode_attn {L} "
        f"and sgmv {per_call} (q and v on {L} layers, the router on "
        f"{per_call - 2 * L} MoE layers) per decode tick, sgmv {per_call} "
        "per prefill batch")
    streams = [r.generated.copy() for r in reqs]
    lengths = [r.prompt.shape[1] for r in reqs]
    caches = eng.caches
    del eng
    p13_alone(cfg, base, bank, spec, reqs, groups, "phase 13a")
    torch.cuda.empty_cache()

    model_wiring(False, arch=DEEPSEEK, acfg=P13_LORA, label="phase 13a")
    dense_wiring(arch=DEEPSEEK, acfg=P13_LORA, label="phase 13a")
    torch.cuda.empty_cache()

    spec_q = p13_spec(cfg, quant=True)
    warm_up(spec_q, base, bank)
    eng = ServingEngine(spec_q, base, [bank], device=DEV)
    reqs_q = make_requests(cfg, 4)
    p13_served(eng, reqs_q, "phase 13a int8", "paged_decode_attn_quant",
               "paged_decode_attn", per_call)
    p13_vs("phase 13a int8", reqs_q, streams, "the bf16 pages' stream")
    del eng
    torch.cuda.empty_cache()

    spec_d = p13_spec(cfg, page_block=0)
    warm_up(spec_d, base, bank)
    reqs_d, eng, _, _, l_d, dec_d = p9_serve(
        cfg, base, bank, spec_d, "phase 13a dense", {"decode_attn": 2},
        sgmv_per_call=per_call)
    log(f"[phase 13a dense] kv=dense [L, C, B, T, K, hd] = "
        f"{list(eng.caches['layers']['k'].shape)}: {eng.stats['ticks']} "
        f"masked decode ticks, launches {l_d} (checked tick by tick: "
        f"decode_attn 2 x {L} per decode tick, sgmv {per_call} per decode "
        f"tick and per prefill call); decode-step ms "
        f"{statistics.median(dec_d) * 1e3:.3f} (median)")
    p13_vs("phase 13a dense", reqs_d, streams, "the bf16 pages' stream")
    del eng
    torch.cuda.empty_cache()
    return launches, times, caches, lengths, streams


def p13_router_sgmv(bank, layer, label="phase 13b"):
    """The router's LoRA delta at decode: 8 fp32 rows (the hidden state
    the router reads), one MoE layer's (a hybrid's: one group's) A [C,
    din, 8] / B [C, 8, E] in fp32 (the bank's bf16 cast, as
    ``apply_adapter_rows`` casts them), block_t 1; deepseek's din 2048 and
    E 64, jamba's 4096 and 16."""
    leaf = next(iter(bank.values()))["router"]        # layers / groups
    A = leaf["A"].transpose(0, 1)[layer].float()
    Bw = leaf["B"].transpose(0, 1)[layer].float()
    n, din, r = A.shape
    dout = Bw.shape[-1]
    x = torch.randn((8, din), generator=gen(16), device=DEV)
    ids = torch.arange(8, device=DEV, dtype=torch.int32) % n
    scale = P13_LORA.alpha / P13_LORA.rank

    def kernel():
        return sg.sgmv_cuda(x, A, Bw, ids, block_t=1, scale=scale)

    def library():
        h = torch.bmm(x[:, None, :], A[ids.long()])
        return torch.bmm(h, Bw[ids.long()])[:, 0] * scale

    err = compare("sgmv router shape (kernel vs plain)", kernel(),
                  sg.sgmv_plain(x, A, Bw, ids, block_t=1, scale=scale),
                  F32_TOL)
    lib_err = float((kernel() - library()).abs().max())
    ms, warm_ms, dev_ms = (time_ms(kernel), time_ms(kernel, l2_cold=False),
                           device_ms(kernel))
    plain_ms = time_ms(lambda: sg.sgmv_plain(x, A, Bw, ids, block_t=1,
                                             scale=scale), n=20)
    lib_ms = time_ms(library)
    nbytes = 8 * din * 4 + n * (din * r + r * dout) * 4 + 8 * 4 + 8 * dout * 4
    bound_ms, by = bound(nbytes, 2 * 8 * r * (din + dout))
    log(f"[{label}] sgmv router T=8 block_t=1 din={din} r={r} dout={dout} "
        f"fp32 (max_abs_err {err:.3e} vs plain), L2-cold: kernel {ms:.4f} ms "
        f"(L2-warm {warm_ms:.4f}; device time, enqueue hidden, "
        f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, gather+bmm {lib_ms:.4f} ms "
        f"(differs by {lib_err:.2e}), bound {bound_ms:.4f} ms ({by}, "
        f"{nbytes} B)")


def phase13b(cfg, base, bank, caches, lengths, times_a):
    """One 8-row decode tick timed and traced; the expert products against
    their byte bound; the compacted prefill of phase 4's 8 prompts in one
    batch, its time and peak memory; the two new kernel shapes timed."""
    spec = p13_spec(cfg)
    t13 = profile_tick(cfg, base, [bank], spec, "phase 13b")
    moe_layers = [p["moe"] for p in base["layers"] if "moe" in p]
    E, d = cfg.n_experts, cfg.d_model
    xe = torch.randn((E, 8, d), generator=gen(17), device=DEV) \
        .to(getattr(torch, cfg.dtype))

    def experts():
        for p in moe_layers:
            moe_lib._expert_ffn(p, xe, blocks.DEFAULT_LIN, "")
    ms = time_ms(experts, n=10)
    wbytes = sum(t.numel() * t.element_size() for p in moe_layers
                 for t in p["experts"].values())
    bound_ms = wbytes / H100.hbm_bandwidth * 1e3
    log(f"[phase 13b] routed experts of one decode tick (drop-free: every "
        f"expert runs on a capacity buffer of 8 rows), {len(moe_layers)} MoE "
        f"layers x 3 bmm: {ms:.3f} ms device time (CUDA events, L2-cold) "
        f"against the byte bound {bound_ms:.3f} ms ({wbytes / 1e9:.2f} GB of "
        f"expert weights at {H100.hbm_bandwidth / 1e12:.2f} TB/s): "
        f"{100 * bound_ms / ms:.1f}% of the rate; the tick "
        f"{t13['tick8_ms']:.3f} ms")

    eng = ServingEngine(spec, base, [bank], device=DEV)
    reqs = make_requests(cfg, 4)
    pre_t = []
    eng._prefill_step = _timed(eng._prefill_step, pre_t)
    for r in reqs:
        r.arrive_tick = 0
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    eng.service_tick()
    peak = (torch.cuda.max_memory_allocated() - before) / 1e9
    st = eng.stats
    if st["compact_prefill_batches"] != 1 or st["compact_prefill_rows"] != 8:
        raise AssertionError(f"[phase 13b] the 8 prompts took "
                             f"{st['compact_prefill_batches']} prefill batches")
    S_pad = eng._bucket(max(lengths))
    log(f"[phase 13b] compacted prefill of phase 4's 8 prompts in one batch "
        f"({sum(lengths)} prompt tokens, 8 rows x {S_pad} = {8 * S_pad} with "
        f"padding; expert buffers of {8 * S_pad} rows each): "
        f"{pre_t[0] * 1e3:.2f} ms, peak memory beyond base, bank and caches "
        f"{peak:.3f} GB (13a's staggered prefills: "
        f"{times_a['peak_gb']:.3f} GB)")
    del eng
    torch.cuda.empty_cache()

    q, pools, tbl, pos = attn_rows(cfg, caches, lengths)
    pk, pv = pools["k"], pools["v"]
    _, blk, K, hd = pk.shape
    got = da.paged_decode_attn_cuda(q, pk, pv, tbl, pos)
    err = compare("paged_decode_attn G=1 (kernel vs plain)", got,
                  da.paged_decode_attn_plain(q.float(), pk.float(),
                                             pv.float(), tbl, pos), BF16_TOL)
    log(f"[phase 13b] paged_decode_attn at G=1 over 13a's pool "
        f"({pk.shape[0]} pages): max_abs_err {err:.3e} vs plain")
    time_attention(
        "paged_decode_attn G=1",
        lambda: da.paged_decode_attn_cuda(q, pk, pv, tbl, pos),
        lambda: da.paged_decode_attn_plain(q, pk, pv, tbl, pos),
        lambda: sdpa_over_pages(q, pk, pv, tbl, pos), q, tbl, pos,
        lambda tokens: 2 * tokens * K * hd * 2, phase="phase 13b")
    p13_router_sgmv(bank, cfg.first_dense_layers)


def p13_image_run(cfg, base, bank, plain, feed=None, steps=P13_DECODE):
    """A client prefill of a ``frontend_stub`` image prefix and a text
    prompt, then ``steps`` greedy decode steps (``feed``: the tokens to
    decode instead), with the kernels (no host sync; launches checked) or
    under ``plain_kernels()``. Returns (logits [steps + 1, 1, V], fed
    tokens)."""
    L, Ti = cfg.n_layers, cfg.n_frontend_tokens
    img = frontend_stub(cfg, 1, 1, generator=gen(14), device=DEV)[
        "img_embed"][0]                                  # [1, Ti, d]
    rng = np.random.default_rng(15)
    text = torch.tensor(rng.integers(0, cfg.vocab, (1, P13_TEXT)),
                        dtype=torch.int32, device=DEV)
    lengths = torch.tensor([P13_TEXT], dtype=torch.int32, device=DEV)
    rows = torch.tensor([1], dtype=torch.int32, device=DEV)   # client 1
    ctx = make_compact_ctx(cfg, LORA, rows)
    adapter = adapters.compact_adapter_bank(bank, rows)
    model = get_model(cfg)
    cache = model.init_cache(1, Ti + P13_TEXT + steps + 8,
                             page_block=16, device=DEV)
    fed = [] if feed is None else [torch.tensor([t], dtype=torch.int32,
                                                device=DEV) for t in feed]
    torch.cuda.synchronize()
    reset_counts()
    lgs = []
    with blocks.plain_kernels() if plain else no_host_sync():
        lg, cache = model.prefill(base, {"tokens": text, "img_embed": img},
                                  cache, ctx, adapter, lengths=lengths)
        lgs.append(lg)
        for step in range(steps):
            if feed is None:
                fed.append(lg.argmax(-1).to(torch.int32))
            lg, cache = model.decode_step(base, cache, fed[step], ctx,
                                          adapter)
            lgs.append(lg)
    torch.cuda.synchronize()
    want = {n: 0 for n in KERNELS}
    if not plain:
        want.update(paged_decode_attn=L * steps, sgmv=2 * L * (steps + 1))
    if read_counts() != want:
        raise AssertionError(f"[phase 13c] launches {read_counts()}, want "
                             f"{want}")
    out = torch.stack(lgs)
    if int(cache["pos"][0]) != Ti + P13_TEXT + steps \
            or not torch.isfinite(out).all():
        raise AssertionError(f"[phase 13c] pos {cache['pos']}, or "
                             "non-finite logits")
    return out, [int(t[0]) for t in fed]


def bf16_ulps(got, want):
    """|got - want| in units of the bf16 spacing at max(|got|, |want|)
    (8 significant bits: 2^(e - 8) for a magnitude in [2^(e-1), 2^e))."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    return (got - want).abs() / torch.ldexp(torch.ones_like(got), e - 8)


def p13_image_prefill(cfg, base, bank):
    """The image-prefix client prefill and decode at full depth, with the
    kernels (finite, positions, launches) and under ``plain_kernels()``
    (fed the kernel pass's tokens; ``P13_WITNESS`` decode steps, as the
    plain paged attention steps page by page). In bf16 the two passes'
    roundings drift apart past the bf16 tolerance over 32 layers: their
    gap is printed in bf16 ulps of the logits, and the same pair in fp32
    must agree at 1e-5 (the witness that the gap is rounding, not a
    kernel error). Then at full width and 2 layers in bf16 at bf16
    tolerance, as phase 3 compares granite."""
    L, Ti, n = cfg.n_layers, cfg.n_frontend_tokens, P13_WITNESS
    full, toks = p13_image_run(cfg, base, bank, plain=False)
    log(f"[phase 13c] {cfg.name}, {L} layers: client prefill of a {Ti}-token "
        f"image prefix + {P13_TEXT} text tokens, then {P13_DECODE} decode "
        f"steps (pos {Ti + P13_TEXT + P13_DECODE}): finite, tokens {toks}; "
        f"paged {L} and sgmv {2 * L} launches per step, no host sync")
    full = full[:n + 1]
    plain, _ = p13_image_run(cfg, base, bank, plain=True, feed=toks, steps=n)
    gap, ulps = (full.float() - plain.float()).abs(), bf16_ulps(full, plain)
    at = int(gap.argmax())
    log(f"[phase 13c] {L} layers bf16, prefill + {n} steps, kernels vs "
        f"plain: logits max_abs_err {float(gap.max()):.3e} at a logit of "
        f"{float(plain.flatten()[at]):.3f} ({float(ulps.flatten()[at]):.0f} "
        f"bf16 ulps there); at most "
        f"{float(ulps.max()):.0f} ulps, {float((ulps > 1).float().mean()):.2e}"
        f" of logits more than 1 ulp apart; |logits| <= "
        f"{float(plain.float().abs().max()):.2f}")
    del full, plain, gap, ulps
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    base32 = tree_map(lambda t: t.float(), base)
    bank32 = tree_map(lambda t: t.float(), bank)
    got, toks32 = p13_image_run(cfg32, base32, bank32, plain=False, steps=n)
    want, _ = p13_image_run(cfg32, base32, bank32, plain=True, feed=toks32,
                            steps=n)
    e = compare(f"llava image-prefix prefill + decode logits ({L} layers, "
                "fp32)", got, want, F32_TOL)
    log(f"[phase 13c] {L} layers fp32, prefill + {n} steps, kernels vs "
        f"plain: logits max_abs_err {e:.3e} at {F32_TOL}")
    del base32, bank32, got, want
    torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    base2 = dict(base, layers=base["layers"][:2])
    bank2 = tree_map(lambda t: t[:, :2], bank)
    got, toks2 = p13_image_run(cfg2, base2, bank2, plain=False)
    want, _ = p13_image_run(cfg2, base2, bank2, plain=True, feed=toks2)
    e = compare("llava image-prefix prefill + decode logits (2 layers)", got,
                want, BF16_TOL)
    log(f"[phase 13c] the same at 2 layers: logits max_abs_err {e:.3e} "
        "(kernels vs plain)")


def phase13c():
    """llava-next-mistral-7b at full width and depth: the image-prefix
    client prefill, then the engine on phase 4's 8 text requests (its text
    backbone, as JAX's engine serves a VLM)."""
    cfg = get_config("llava-next-mistral-7b")
    t0 = time.perf_counter()
    base, bank = make_system(cfg, 4, seed=13)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(base))
    log(f"[phase 13c] {cfg.name}: {cfg.n_layers} layers, "
        f"{n_params / 1e9:.2f} B params bf16 initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    p13_image_prefill(cfg, base, bank)
    torch.cuda.empty_cache()
    spec = p13_spec(cfg, acfg=LORA)
    warm_up(spec, base, bank)
    eng = ServingEngine(spec, base, [bank], device=DEV)
    p13_served(eng, make_requests(cfg, 4), "phase 13c", "paged_decode_attn",
               "paged_decode_attn_quant", 2 * cfg.n_layers)
    del eng, bank
    free_device()
    t = time.perf_counter()
    phase14d(cfg, base)
    log(f"[phase 14d] done ({time.perf_counter() - t:.1f} s)")


# ---------------------------------------------------------------------------
# phase 14: the MoE and VLM families fine-tune on the shared base
# ---------------------------------------------------------------------------

P14_STEPS = 7            # 14b: 4 jobs, a warm tick, 5 timed, 1 traced
P14_LLAVA_LR = 1e-3      # 14d: 3 steps on one batch, no warmup


class FixedBatch:
    """A job stream that hands out its first batch at every step, so each
    step's loss reads what the steps before it learned, on the same
    tokens (a random base learns little from 3 new batches: the loss
    then moves by less than it varies from batch to batch)."""

    def __init__(self, stream):
        self.b = stream.batch(0)

    def batch(self, step):
        return self.b


@contextlib.contextmanager
def moe_dropped():
    """Records each ``moe._slot_positions`` call's dropped (token, slot)
    pairs per group of rows, as a list of lists."""
    out = []
    orig = moe_lib._slot_positions

    def record(idx, E, cap, rows=1):
        pos, keep = orig(idx, E, cap, rows)
        out.append((~keep).reshape(rows, -1).sum(1).tolist())
        return pos, keep
    moe_lib._slot_positions = record
    try:
        yield out
    finally:
        moe_lib._slot_positions = orig


@contextlib.contextmanager
def moe_body_kept():
    """The MoE body run without its recompute (a training call saves the
    dispatch buffers and expert hiddens, as before this slice): the step
    copied outside the package, for the record."""
    orig = moe_lib.moe_forward

    def body(params, cfg, x, lin, *, path_prefix="", capacity_factor=None,
             dispatch="scatter", with_aux=True, rows=1):
        return moe_lib._body(params, cfg, x, lin, path_prefix,
                             capacity_factor, dispatch, with_aux, rows)
    moe_lib.moe_forward = body
    try:
        yield
    finally:
        moe_lib.moe_forward = orig


def p14_rows(cfg2, base2, acfg, bank, cf, label):
    """14a: a 2-row bank's merged step against each row's one-row run
    (the same program at R = 1): losses, grads, aux and dropped pairs per
    row; the drift within ``P12_DRIFT_TOL``."""
    batch = train_batches(cfg2, 2, 140)
    merged = symbiosis._make_rows_grad_fn(
        cfg2, acfg, remat=False, memory_optimized=True, microbatch=0,
        moe_dispatch="scatter", capacity_factor=cf)
    solo = symbiosis.make_row_grad_fn(cfg2, acfg, remat=False,
                                      capacity_factor=cf)
    with moe_dropped() as drops:
        losses, grads = merged(bank, base2, batch)
    model = get_model(cfg2)
    with torch.no_grad():
        _, aux = model.forward(
            base2, {k: v.flatten(0, 1) for k, v in batch.items()},
            make_bank_ctx(cfg2, acfg, 2),
            adapters.compact_adapter_bank(bank, per_row=TRAIN_B),
            remat=False, with_aux=True, capacity_factor=cf, rows=2)
    loss_d = state_d = 0.0
    solo_aux, solo_drops = [], []
    for r in range(2):
        one = tree_map(lambda t: t[r], bank)
        b1 = {k: v[r] for k, v in batch.items()}
        with moe_dropped() as d1:
            l1, g1 = solo(one, base2, b1)
        solo_drops.append(d1[0][0])
        with torch.no_grad():
            solo_aux.append(float(model.forward(
                base2, b1, make_client_ctx(cfg2, acfg), one, remat=False,
                with_aux=True, capacity_factor=cf)[1]))
        loss_d = max(loss_d, abs(float(losses[r]) - float(l1)))
        for a, c in zip(tree_leaves(grads), tree_leaves(g1)):
            scale = float(c.abs().max()) or 1.0
            state_d = max(state_d, float((a[r] - c).abs().max()) / scale)
    drift = "bit for bit" if loss_d == state_d == 0.0 else \
        f"drift: losses {loss_d:.3e}, grads {state_d:.3e} of a leaf's max"
    log(f"[phase 14a] {label} capacity_factor={cf}: losses "
        f"{[round(float(x), 5) for x in losses]}, per-row aux "
        f"{[round(float(x), 5) for x in aux]} (alone "
        f"{[round(x, 5) for x in solo_aux]}), dropped (token, slot) pairs "
        f"per row in the MoE layer {drops[0]} (alone {solo_drops}); each row "
        f"against its one-row run: {drift}")
    if not within_drift(loss_d, state_d) or not torch.isfinite(losses).all():
        raise AssertionError(f"[phase 14a] {label} cf={cf}: rows drift "
                             f"{loss_d:.3e} / {state_d:.3e} beyond "
                             f"{P12_DRIFT_TOL}")
    if cf is None and any(drops[0]):
        raise AssertionError(f"[phase 14a] drop-free step dropped {drops}")


def phase14a(cfg, base):
    """14a: deepseek's width, 2 layers (dense, then MoE), fp32: a 2-row
    LoRA (q, v, router) and a 2-row IA3 bank, drop-free and at 1.25."""
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                               param_dtype="float32")
    base2 = tree_map(lambda t: t.float(), dict(base,
                                               layers=base["layers"][:2]))
    banks = {"LoRA r8 q/v/router": (P13_LORA,
                                    random_lora(cfg2, 2, 141, P13_LORA)),
             "IA3 k/v/down": (P10_ACFGS["ia3"],
                              random_bank(cfg2, P10_ACFGS["ia3"], 2, 142))}
    for label, (acfg, bank) in banks.items():
        for cf in (None, 1.25):
            p14_rows(cfg2, base2, acfg, bank, cf, label)
    del base2, banks
    torch.cuda.empty_cache()


def p14_expert_share(prof, E):
    """Device ms of the traced tick's expert products (``aten::bmm`` over
    [E, ...] operands: forward, recompute and dx), or None when the
    profiler attributes no device time to operators."""
    total = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        shapes = e.input_shapes or []
        if e.key == "aten::bmm" and shapes and shapes[0] \
                and shapes[0][0] == E:
            total += getattr(e, "device_time_total", 0.0)
    return total / 1e3 if total else None


def p14_memory(cfg, base, job):
    """Peak device memory beyond base and bank of one bank step at 1 and
    4 jobs, against ``job_charge_bytes``; then 1 job with the MoE body not
    recomputed (``moe_body_kept``)."""
    charge = job_charge_bytes(cfg, job)
    step = symbiosis.make_compact_train_step(cfg, P13_LORA, remat=False)

    def peak(R):
        bank = random_lora(cfg, R, 143, P13_LORA)
        opt = AdamWState(step=torch.zeros(R, dtype=torch.int32, device=DEV),
                         m=tree_map(torch.zeros_like, bank),
                         v=tree_map(torch.zeros_like, bank))
        batch = train_batches(cfg, R, 144)
        args = (torch.arange(R, dtype=torch.int32, device=DEV),
                torch.ones(R, dtype=torch.bool, device=DEV), step7a_hyper(R))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step(base, bank, opt, batch, *args)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - before

    peaks = {R: peak(R) for R in (1, 4)}
    with moe_body_kept():
        kept = peak(1)
    torch.cuda.empty_cache()
    log(f"[phase 14b] peak device memory beyond base and bank, one bank "
        f"step (drop-free, remat off), GB: 1 job {peaks[1] / 1e9:.3f}, 4 jobs "
        f"{peaks[4] / 1e9:.3f}; charge per job {charge / 1e9:.3f} "
        f"(job_hbm_bytes {job_hbm_bytes(cfg, job) / 1e9:.3f}); 1 job with the "
        f"MoE body kept, not recomputed: {kept / 1e9:.3f} "
        f"(+{(kept - peaks[1]) / 1e9:.3f})")
    for R, p in peaks.items():
        if p > R * charge:
            raise AssertionError(f"[phase 14b] {R} job(s) peak at {p} B, "
                                 f"above the charge {R * charge} B")


def phase14b(cfg, base):
    """14b: a FinetuneEngine of 4 deepseek LoRA jobs (q, v, router; 2 x 256
    tokens) at full size behind a router that holds the fifth back: the
    tick on the host clock, one tick traced, memory against the charge."""
    jobs = (train_jobs(cfg, 4, P14_STEPS, acfg=P13_LORA)
            + train_jobs(cfg, 1, 2, first_seed=4, acfg=P13_LORA))
    charge = job_charge_bytes(cfg, jobs[0])
    router = PlacementRouter(cfg, [Slot(0, free_hbm=4.5 * charge)])
    eng = FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()), base,
                         device=DEV, router=router)
    for j in jobs:
        eng.submit(j)
    ticks, traced_tick = [], None
    for t in range(P14_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.train_tick()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t0)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        time.sleep(0.05)
        t0 = time.perf_counter()
        eng.train_tick()
        torch.cuda.synchronize()
        traced_tick = (time.perf_counter() - t0) * 1e3
        time.sleep(0.05)
    if eng.stats["peak_jobs"] != 4 or jobs[4].status != "queued":
        raise AssertionError(f"[phase 14b] peak {eng.stats['peak_jobs']}, "
                             f"job 4 {jobs[4].status}")
    eng.run()
    if any(j.status != "finished" for j in jobs) or not all(
            np.isfinite(j.losses).all() for j in jobs):
        raise AssertionError(f"[phase 14b] {[j.status for j in jobs]} "
                             f"{[j.losses for j in jobs]}")
    used = router.utilization()
    if router.conservation_errors() or used["committed_bytes"]:
        raise AssertionError(f"[phase 14b] router after the drain: {used}")
    tokens = 4 * TRAIN_B * TRAIN_S
    med = statistics.median(ticks[1:6])
    log(f"[phase 14b] {cfg.name}: 5 LoRA r8 jobs (q, v, router; {TRAIN_B} x "
        f"{TRAIN_S} tokens), router slot {4.5 * charge:.0f} B for charges of "
        f"{charge} B: 4 rows for {P14_STEPS} ticks, job 4 after; stats "
        f"{eng.stats}; losses {[[round(x, 4) for x in j.losses] for j in jobs]}")
    log(f"[phase 14b] 4-row train tick (host clock, synchronised): "
        f"{[round(t * 1e3, 3) for t in ticks]} ms; median of 5 after the "
        f"first {med * 1e3:.3f} ms, {tokens / med:.0f} tokens/s")
    busy_ms, n_kern, by_name = device_profile(prof)
    if n_kern:
        gemm = sum(d for name, (n, d) in by_name.items()
                   if any(k in name for k in GEMM_NAMES)) / 1e3
        expert = p14_expert_share(prof, cfg.n_experts)
        log(f"[phase 14b] one traced 4-row tick: {traced_tick:.3f} ms on the "
            f"host clock (CPU and device traced), device busy {busy_ms:.3f} "
            f"ms = {100 * busy_ms / (med * 1e3):.1f}% of the unprofiled "
            f"median; {n_kern} kernels; matrix products {gemm:.3f} ms; expert "
            f"bmm (forward, recompute, dx) "
            + (f"{expert:.3f} ms = {100 * expert / busy_ms:.1f}% of the busy "
               "time" if expert is not None else "not measured") +
            "; top kernels:")
        for name, (n, d) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:8]:
            log(f"[phase 14b]   {d / 1e3:8.3f} ms  {n:5d}x  {name[:90]}")
    else:
        log("[phase 14b] the profiler saw no device events: device busy not "
            "measured")
    del eng, prof
    gc.collect()
    p14_memory(cfg, base, jobs[0])


def p14_mixed(cfg, base, bank):
    """14c: ``make_mixed_step`` at 2 layers bf16 (2 clients train at the
    default capacity 1.25, a dense 4 x 2-slot bank decodes one token):
    every launch count 0 just before, read just after (the dense kernel 2
    per layer, SGMV per targeted layer); the decode half against the
    decode step under ``plain_kernels()`` at 2e-2."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    base2 = dict(base, layers=base["layers"][:2])
    inf = tree_map(lambda t: t[:, :2], bank)
    scfg = ServeConfig(n_clients=4, max_seq=64)
    caches = symbiosis.init_client_caches(cfg2, 4, 2, 64, device=DEV)
    toks = torch.randint(0, cfg.vocab, (4, 2, 16), generator=gen(145),
                         device=DEV, dtype=torch.int32)
    logits, caches = symbiosis.make_multi_client_prefill(cfg2, P13_LORA,
                                                         scfg)(
        base2, inf, caches, {"tokens": toks})
    tok = logits.argmax(-1).to(torch.int32)
    ft = random_lora(cfg2, 2, 146, P13_LORA)
    opt = p10_opt(ft, P10_STEP)
    plain_caches = tree_clone(caches)
    mixed = symbiosis.make_mixed_step(cfg2, P13_LORA, P10_TCFG, scfg)
    torch.cuda.synchronize()
    reset_counts()
    out = mixed(base2, ft, opt, train_batches(cfg2, 2, 147), inf, caches, tok,
                P10_STEP)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {n: 0 for n in KERNELS}
    want.update(decode_attn=2 * 2, sgmv=p13_sgmv_per_call(cfg2, P13_LORA))
    if counts != want or not torch.isfinite(out[4]["loss"]).all():
        raise AssertionError(f"[phase 14c] mixed step launched {counts}, "
                             f"want {want}; losses {out[4]['loss']}")
    reset_counts()
    with blocks.plain_kernels():
        plg, _ = symbiosis.make_multi_client_decode_step(cfg2, P13_LORA,
                                                         scfg)(
            base2, inf, plain_caches, tok)
    torch.cuda.synchronize()
    if any(read_counts().values()):
        raise AssertionError(f"[phase 14c] plain pass launched "
                             f"{read_counts()}")
    err = compare("[phase 14c] mixed decode logits against plain", out[3],
                  plg, BF16_TOL)
    log(f"[phase 14c] make_mixed_step, {cfg.name} 2 layers bf16 (2 clients "
        f"train at capacity_factor 1.25, losses "
        f"{[round(float(x), 4) for x in out[4]['loss']]}; 4 x 2 slots decode "
        f"dense): launches {counts}; decode logits against plain_kernels(): "
        f"max abs err {err:.3e} ({BF16_TOL})")


def phase14c(cfg, base, bank, streams13):
    """14c: a SymbiosisEngine of 13a's requests (4 LoRA tenants on bf16
    pages) beside 2 deepseek jobs: streams bit for bit 13a's, launches
    checked tick by tick, the jobs bit for bit their FinetuneEngine run in
    the same bucket; then the mixed step."""
    L, per_call = cfg.n_layers, p13_sgmv_per_call(cfg, P13_LORA)
    spec = dataclasses.replace(p13_spec(cfg), finetune=FinetuneConfig())
    sym = SymbiosisEngine.from_spec(spec, base, serving_banks=[bank],
                                    device=DEV)
    reqs = make_requests(cfg, 4)
    jobs = train_jobs(cfg, 2, 3, first_seed=20, acfg=P13_LORA)
    for item in reqs + jobs:
        sym.submit(item)
    serving = sym.serving
    attn, sgmv = KERNELS["paged_decode_attn"][0], KERNELS["sgmv"][0]
    torch.cuda.synchronize()
    reset_counts()
    more, per_tick = True, []
    while more:
        before = (attn.launches, sgmv.launches, serving.stats["ticks"],
                  serving.stats["compact_prefill_batches"])
        more = sym.tick()
        d_at, d_sg, d_tick, d_pre = (a - b for a, b in zip(
            (attn.launches, sgmv.launches, serving.stats["ticks"],
             serving.stats["compact_prefill_batches"]), before))
        per_tick.append((d_at, d_sg))
        if d_at != L * d_tick or d_sg != per_call * (d_tick + d_pre):
            raise AssertionError(f"[phase 14c] a tick launched {d_at} paged "
                                 f"and {d_sg} SGMV kernels for {d_tick} "
                                 f"decode ticks, {d_pre} prefills")
    torch.cuda.synchronize()
    counts = read_counts()
    for i, r in enumerate(reqs):
        if first_diff(r.generated, streams13[i]) is not None:
            raise AssertionError(f"[phase 14c] request {i}'s stream differs "
                                 "from 13a's")
    alone = FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()),
                           base, device=DEV)
    solo = train_jobs(cfg, 2, 3, first_seed=20, acfg=P13_LORA)
    for j in solo:
        alone.submit(j)
    alone.run()
    for a, b in zip(jobs, solo):
        if a.losses != b.losses or not trees_equal(
                (a.result.adapter, a.result.opt),
                (b.result.adapter, b.result.opt)):
            raise AssertionError(f"[phase 14c] {a.name} differs from its "
                                 "FinetuneEngine run alone")
    st = sym.stats
    log(f"[phase 14c] SymbiosisEngine over 13a's base: 8 requests (4 LoRA "
        f"tenants on q, v, router, bf16 pages) beside 2 LoRA jobs in "
        f"{st['ticks']} ticks ({st['decode_ticks']} serving, "
        f"{st['train_ticks']} train): every stream equals 13a's bit for bit; "
        f"paged {L} and sgmv {per_call} per decode tick and {per_call} per "
        f"prefill, checked tick by tick (launches {counts}); the jobs' "
        f"losses, adapters and AdamW states equal their FinetuneEngine run "
        f"alone (the same 2-row bucket) bit for bit: "
        f"{[[round(x, 4) for x in j.losses] for j in jobs]}")
    del sym, alone
    gc.collect()
    p14_mixed(cfg, base, bank)


def phase14e(cfg, base):
    """14e: a deepseek FinetuneEngine of 2 jobs killed after a tick and
    resumed by a fresh engine from its blob ends bit for bit as the
    uninterrupted run."""
    spec = EngineSpec(cfg=cfg, finetune=FinetuneConfig())
    ref = FinetuneEngine(spec, base, device=DEV)
    ref_jobs = train_jobs(cfg, 2, 3, first_seed=30, acfg=P13_LORA)
    for j in ref_jobs:
        ref.submit(j)
    ref.run()
    with tempfile.TemporaryDirectory() as d:
        eng = FinetuneEngine(spec, base, device=DEV)
        for j in train_jobs(cfg, 2, 3, first_seed=30, acfg=P13_LORA):
            eng.submit(j)
        eng.train_tick()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_engine_state(d, eng.engine_state())
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        del eng                                          # the crash
        t0 = time.perf_counter()
        _, state = load_engine_state(d)
        fresh = FinetuneEngine(spec, base, device=DEV)
        fresh.load_engine_state(state)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        done = {j.name: j for j in fresh.run()}
    for want in ref_jobs:
        got = done[want.name]
        if got.losses != want.losses or not trees_equal(
                (got.result.adapter, got.result.opt),
                (want.result.adapter, want.result.opt)):
            raise AssertionError(f"[phase 14e] {want.name} resumed differs "
                                 f"from the uninterrupted run")
    log(f"[phase 14e] {cfg.name} FinetuneEngine of 2 LoRA jobs (q, v, "
        f"router) killed after 1 of 3 ticks: blob of {size} B written in "
        f"{t_save * 1e3:.1f} ms, loaded by a fresh engine in "
        f"{t_load * 1e3:.1f} ms; both jobs' losses, adapters and AdamW "
        f"states equal the uninterrupted run bit for bit")


def phase14d(cfg, base):
    """14d: llava-next-mistral-7b at full width and depth: 2 LoRA jobs of
    1 x 256 text tokens after the 2,880-token image prefix, remat, 3
    ticks on each job's first batch; losses finite and falling, peak
    memory against the charge."""
    jobs = train_jobs(cfg, 2, 3, first_seed=40, batch=1, lr=P14_LLAVA_LR,
                      warmup=0)
    for j in jobs:
        j.data = FixedBatch(j.data)
    fcfg = FinetuneConfig(remat=True)
    eng = FinetuneEngine(EngineSpec(cfg=cfg, finetune=fcfg), base,
                         device=DEV)
    for j in jobs:
        eng.submit(j)
    charge = job_charge_bytes(cfg, jobs[0], remat=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ticks = timed_ticks(eng)
    peak = torch.cuda.max_memory_allocated() - before
    losses = [j.losses for j in jobs]
    log(f"[phase 14d] {cfg.name}: 2 LoRA r8 jobs (q, v), 1 x "
        f"({cfg.n_frontend_tokens} image + {TRAIN_S} text) positions, "
        f"remat, lr {P14_LLAVA_LR}, each on its first batch: losses "
        f"{[[round(x, 5) for x in l] for l in losses]}; tick ms "
        f"{[round(t * 1e3, 1) for t in ticks]}; peak beyond base "
        f"{peak / 1e9:.3f} GB against a charge of {2 * charge / 1e9:.3f} GB "
        f"for the 2 jobs ({charge / 1e9:.3f} each)")
    if any(j.status != "finished" for j in jobs) or not all(
            np.isfinite(x).all() and x[2] < x[1] < x[0] for x in losses):
        raise AssertionError(f"[phase 14d] {[j.status for j in jobs]}, "
                             f"losses {losses}: not finite and falling")
    if peak > 2 * charge:
        raise AssertionError(f"[phase 14d] peak {peak} B above the charge "
                             f"{2 * charge} B")


def free_device(label="phase 13"):
    """Collect the engines' reference cycles (an engine whose steps were
    wrapped for timing refers to itself), which hold base tensors until
    the cyclic collector runs, then give the cached blocks back."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{label}] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")


def phase13():
    """The MoE and VLM families on the serving path: deepseek-moe-16b at
    full width and depth (13a, 13b), then llava-next-mistral-7b (13c); and
    their fine-tuning on the same bases (phase 14: 14a, 14b, 14c, 14e on
    deepseek before it is freed, 14d on llava)."""
    cfg = get_config("deepseek-moe-16b")
    t0 = time.perf_counter()
    base, bank = make_system(cfg, 4, seed=12, acfg=P13_LORA)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(base))
    log(f"[phase 13a] {cfg.name}: {cfg.n_layers} layers (layer 0 dense, "
        f"{cfg.n_experts} routed experts top-{cfg.top_k} + "
        f"{cfg.n_shared_experts} shared after it), "
        f"{n_params / 1e9:.2f} B params bf16 initialised in "
        f"{time.perf_counter() - t0:.1f} s; LoRA r8 on q, v and the router")
    t = time.perf_counter()
    launches, times, caches, lengths, streams = phase13a(cfg, base, bank)
    log(f"[phase 13a] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    phase13b(cfg, base, bank, caches, lengths, times)
    log(f"[phase 13b] done ({time.perf_counter() - t:.1f} s)")
    del caches
    free_device()
    for name, run in (("14a", lambda: phase14a(cfg, base)),
                      ("14b", lambda: phase14b(cfg, base)),
                      ("14c", lambda: phase14c(cfg, base, bank, streams)),
                      ("14e", lambda: phase14e(cfg, base))):
        t = time.perf_counter()
        run()
        free_device()
        log(f"[phase {name}] done ({time.perf_counter() - t:.1f} s)")
    del base, bank
    free_device()
    t = time.perf_counter()
    phase13c()
    log(f"[phase 13c] done ({time.perf_counter() - t:.1f} s)")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 15: the hybrid family on the serving path
# ---------------------------------------------------------------------------

P15_LORA = AdapterConfig(method="lora", rank=8, alpha=16.0,
                         targets=("q", "v", "router"))
P15_GROUPS = 2           # of jamba-v0.1-52b's 4 periods: 16 of its 32 layers
P15_MAX_SEQ = 1024
P15_LONG = 512           # 15a's ninth request: two 256-token scan chunks
P15_REFUSED = 300        # a prompt length JAX's chunk contract refuses
# 15c's 16-layer bf16 pair, kernels against plain: 4 bf16 ulps of logits
# in [2, 4) (2^-6 each; every |logit| here is below 3). Its controls: with
# the SGMV op alone on its plain version the prefill's logits are bit for
# bit and the decode's 1 ulp apart (the paged kernel's sums), so the gap
# is the two kernels' fp32 sums in another order, rounded to bf16 and
# carried through 16 layers; in fp32 (a narrower jamba, the same 16
# layers) the pair holds at 1e-5, so the kernels compute the same
# function. The pair read 2.4 / 2.1 ulps (3.711e-02 / 3.320e-02); a wrong
# row, page or adapter moves logits by tenths.
P15_PAIR_TOL = dict(atol=4 * 2.0 ** -6, rtol=0.0)


def p15_config(groups=P15_GROUPS, dtype="bfloat16"):
    """jamba-v0.1-52b at full width, cut to ``groups`` of its 8-layer
    periods (the least depth with two groups' page-table offsets is 2)."""
    cfg = get_config("jamba-v0.1-52b")
    return dataclasses.replace(cfg, n_layers=groups * cfg.attn_every,
                               dtype=dtype, param_dtype=dtype)


def p15_narrow():
    """Phase 15c's control (b): jamba at phase 15's depth and layer
    pattern (2 periods: 14 Mamba, 2 attention, 8 MoE sublayers of 16
    experts top-2) in fp32, narrowed to d_model 1024 (8 heads of 128, 2
    K/V heads: jamba's GQA group of 4), d_ff 3584."""
    return dataclasses.replace(p15_config(dtype="float32"), d_model=1024,
                               n_heads=8, n_kv_heads=2, d_ff=3584)


def p15_counts(cfg, acfg=P15_LORA):
    """(attention sublayers, SGMV launches per decode tick or prefill call):
    one attention sublayer per group; the LoRA on its q and v and on the
    router of each MoE sublayer (one group leaf reaches them all)."""
    G = cfg.n_layers // cfg.attn_every
    n_moe = sum(hybrid_lib.sub_is_moe(cfg, j) for j in range(cfg.attn_every))
    attn = sum(t in ("q", "k", "v", "o") for t in acfg.targets)
    return G, G * (attn + ("router" in acfg.targets) * n_moe)


def p15_spec(cfg, page_block=16, max_b=2):
    """Phase 4's serving spec (4 clients, opportunistic) over ``max_b``
    slots per client, ``max_seq`` 1024, LoRA ``P15_LORA``."""
    scfg = ServeConfig(n_clients=4, max_seq=P15_MAX_SEQ, page_block=page_block,
                       policy="opportunistic")
    return EngineSpec(cfg=cfg, banks=(BankSpec("tenants", P15_LORA, 4),),
                      serve=scfg, max_batch_per_client=max_b)


def p15_requests(cfg):
    """Phase 4's 8 staggered requests and a ninth of ``P15_LONG`` tokens
    for client 0 at tick 7 (it waits for one of client 0's slots)."""
    reqs = make_requests(cfg, 4)
    rng = np.random.default_rng(15)
    reqs.append(Request(client_id=0, max_new_tokens=16, arrive_tick=7,
                        prompt=rng.integers(0, cfg.vocab, (1, P15_LONG))
                        .astype(np.int32)))
    return reqs


def p15_serve(cfg, base, bank, spec, label, attn_name, reqs):
    """Serve ``reqs`` with every launch count set to 0 just before and read
    just after, checked tick by tick: per decode tick ``attn_name`` once
    (paged) or twice (dense: split and combine) per attention sublayer,
    SGMV ``p15_counts`` times per decode tick and per prefill call (one
    per request: the hybrid prefills unpadded), every other kernel never.
    Returns (engine, launches, decode-step s, prefill s, peak bytes the run
    added beyond base, bank and caches)."""
    G, per_call = p15_counts(cfg)
    attn_per = {"paged_decode_attn": 1, "decode_attn": 2}[attn_name]
    eng = ServingEngine(spec, base, [bank], device=DEV)
    for r in reqs:
        eng.submit(r)
    dec_t, pre_t = [], []
    eng._decode_step = _timed(eng._decode_step, dec_t)
    eng._client_prefill = _timed(eng._client_prefill, pre_t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_counts()
    per_tick = TICK_LAUNCHES[label] = []
    more = True
    while more:
        before = (read_counts(), eng.stats["ticks"], eng.stats["prefill_calls"])
        more = eng.service_tick()
        now = read_counts()
        d = {n: now[n] - before[0][n] for n in now}
        per_tick.append(d)
        d_tick = eng.stats["ticks"] - before[1]
        d_pre = eng.stats["prefill_calls"] - before[2]
        want = {n: 0 for n in d}
        want[attn_name] = attn_per * G * d_tick
        want["sgmv"] = per_call * (d_tick + d_pre)
        if d != want:
            raise AssertionError(
                f"[{label}] tick {eng._tick}: launches {d} for {d_tick} "
                f"decode ticks and {d_pre} prefill calls; want {want}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - mem0
    launches = read_counts()
    done = eng.drain_done()
    if len(done) != len(reqs) or eng.stats["quarantined_requests"]:
        raise AssertionError(f"[{label}] {len(done)} of {len(reqs)} requests "
                             f"finished, {eng.stats['quarantined_requests']} "
                             "quarantined")
    for r in reqs:
        g = r.generated
        if r.status != "ok" or g.shape != (1, 16) or g.min() < 0 \
                or g.max() >= cfg.vocab:
            raise AssertionError(f"[{label}] client {r.client_id}: status "
                                 f"{r.status}, tokens {g}")
    st = eng.stats
    log(f"[{label}] served {len(done)} requests ({st['prefill_tokens']} "
        f"prompt + {st['decode_tokens'] + len(done)} generated tokens): "
        f"{st['ticks']} decode ticks, {st['prefill_calls']} per-request "
        f"prefills, launches {launches} (checked tick by tick: {attn_name} "
        f"{attn_per * G} and sgmv {per_call} per decode tick, sgmv "
        f"{per_call} per prefill); decode-step ms "
        f"{statistics.median(dec_t) * 1e3:.3f} (median of {len(dec_t)}), "
        f"prefill ms {statistics.median(pre_t) * 1e3:.3f} (median of "
        f"{len(pre_t)}); peak beyond base, bank and caches "
        f"{peak / 1e9:.3f} GB")
    return eng, launches, dec_t, pre_t, peak


def p15_alone(cfg, base, bank, spec, reqs, label,
              note=f", the {P15_LONG}-token one included"):
    """Every stream bit for bit equal to it served alone by a fresh engine
    of ``spec``."""
    for i, r in enumerate(reqs):
        d = first_diff(r.generated, p9_alone(cfg, base, bank, spec, [r])[0])
        if d is not None:
            raise AssertionError(f"[{label}] request {i}'s stream differs "
                                 f"from it served alone at step {d}")
    log(f"[{label}] every stream ({len(reqs)}{note}) equals its run alone "
        "on a fresh engine, bit for bit")


def p15_refused(cfg, base, bank, spec, n=P15_REFUSED, chunk=256,
                label="phase 15a"):
    """A prompt of ``n`` tokens (no multiple of the scan's ``chunk``) is
    refused at its prefill with JAX's message."""
    eng = ServingEngine(spec, base, [bank], device=DEV)
    eng.submit(Request(0, np.zeros((1, n), np.int32), 4))
    want = f"seq {n} % chunk {chunk} != 0"
    try:
        eng.service_tick()
    except ValueError as e:
        if want not in str(e):
            raise
        log(f"[{label}] a {n}-token prompt refused: {e}")
        return
    raise AssertionError(f"[{label}] a {n}-token prompt was served")


def phase15a(cfg, base, bank):
    """Pages: 8 + 1 requests (streams against runs alone), the refused
    length, and one slot per client (slot reuse)."""
    spec = p15_spec(cfg)
    warm_up(spec, base, bank)
    reqs = p15_requests(cfg)
    eng, launches, dec_t, _, peak = p15_serve(
        cfg, base, bank, spec, "phase 15a", "paged_decode_attn", reqs)
    del eng
    p15_alone(cfg, base, bank, spec, reqs, "phase 15a")
    p15_refused(cfg, base, bank, spec)
    spec1 = p15_spec(cfg, max_b=1)
    reqs1 = p15_requests(cfg)
    eng, _, _, _, _ = p15_serve(cfg, base, bank, spec1, "phase 15a reuse",
                                "paged_decode_attn", reqs1)
    del eng
    p15_alone(cfg, base, bank, spec1, reqs1, "phase 15a reuse")
    p13_vs("phase 15a reuse", reqs1, [r.generated for r in reqs],
           "the 2-slot run's stream")
    return [r.generated.copy() for r in reqs], launches, dec_t, peak


def phase15b(cfg, base, bank, streams):
    """The dense layout: the same requests, streams against runs alone."""
    spec = p15_spec(cfg, page_block=0)
    warm_up(spec, base, bank)
    reqs = p15_requests(cfg)
    eng, _, _, _, _ = p15_serve(cfg, base, bank, spec, "phase 15b",
                                "decode_attn", reqs)
    attn = f"sub{cfg.attn_every - 1}"
    shapes = {n: list(t.shape) for n, t in eng.caches["groups"][attn].items()}
    shapes.update({n: list(t.shape) for n, t in
                   eng.caches["groups"]["sub0"].items()})
    log(f"[phase 15b] kv=dense, bank caches {shapes} (attention sublayer "
        f"{attn}: [G, C, B, T, K, hd]; Mamba sublayer sub0: [G, C, B, ...])")
    del eng
    p15_alone(cfg, base, bank, spec, reqs, "phase 15b")
    p13_vs("phase 15b", reqs, streams, "the pages' stream")


def sgmv_plain_split(x, A, B, block_adapter, *, block_t, scale=1.0):
    """``sgmv_plain`` with its sum over din in another order: the two
    halves of din each through both fp32 products, added in fp32 (phase
    17a's control (c): an equally exact SGMV, rounded otherwise)."""
    m = x.shape[1] // 2
    halves = [sg.sgmv_plain(x[:, sl].float(), A[:, sl], B, block_adapter,
                            block_t=block_t, scale=scale)
              for sl in (slice(0, m), slice(m, None))]
    return (halves[0] + halves[1]).to(x.dtype)


@contextlib.contextmanager
def sgmv_plain_only(split=False):
    """Route the SGMV op alone to its plain version (with ``split``,
    ``sgmv_plain_split``): every other kernel still launches (phase 15c's
    and 17a's controls of the SGMV kernel's sums)."""
    ops = importlib.import_module("repro_torch.kernels.sgmv.ops")
    orig = ops.launches_kernel, ops.sgmv_plain
    ops.launches_kernel = lambda t: False
    if split:
        ops.sgmv_plain = sgmv_plain_split
    try:
        yield
    finally:
        ops.launches_kernel, ops.sgmv_plain = orig


def p15_wiring(cfg, base, bank, tol, label, sgmv_plain=False):
    """A per-client prefill of one prompt per client (64-256 tokens, slot
    0; slot 1 a dummy of length 0) into a paged bank, then one compacted
    decode of the 4 rows, with the kernels (no host sync; with
    ``sgmv_plain`` the SGMV op alone on its plain version) and under
    ``plain_kernels()``: launches (paged attention once per attention
    sublayer in the decode, SGMV ``p15_counts`` per call; none plain) and
    logits at ``tol``, or, with ``tol`` None, their gap only printed, in
    bf16 ulps too. Returns the two max errors."""
    C, max_b, max_seq, blk = 4, 2, 512, 16
    G, per_call = p15_counts(cfg)
    scfg = ServeConfig(n_clients=C, max_seq=max_seq, page_block=blk)
    rng = np.random.default_rng(3)
    lengths = [int(n) for n in rng.integers(64, 257, C)]
    toks = [torch.tensor(np.stack([rng.integers(0, cfg.vocab, n),
                                   np.zeros(n, np.int64)]),
                         dtype=torch.int32, device=DEV) for n in lengths]
    lens = [torch.tensor([n, 0], dtype=torch.int32, device=DEV)
            for n in lengths]
    mask = torch.tensor([True, False], device=DEV)
    rows = [torch.tensor(a, device=DEV) for a in
            (np.arange(C, dtype=np.int32), np.zeros(C, np.int32),
             np.ones(C, bool))]
    prefill = symbiosis.make_client_prefill(cfg, P15_LORA, scfg)
    decode = symbiosis.make_compact_decode_step(cfg, P15_LORA, scfg)
    out, nxt = [], None
    for plain in (False, True):
        caches = symbiosis.init_client_caches(cfg, C, max_b, max_seq,
                                              page_block=blk, device=DEV)
        P = max_b * (max_seq // blk)
        caches["block_tbl"] += (torch.arange(C, dtype=torch.int32,
                                             device=DEV) * P)[:, None, None]
        torch.cuda.synchronize()
        reset_counts()
        with blocks.plain_kernels() if plain else (
                sgmv_plain_only() if sgmv_plain else no_host_sync()):
            lg1 = []
            for c in range(C):
                lg, caches = prefill(base, bank, caches, c, c, toks[c],
                                     lens[c], mask)
                lg1.append(lg[0])
            lg1 = torch.stack(lg1)
            if nxt is None:
                nxt = lg1.argmax(-1).to(torch.int32)
            lg2, _, caches = decode(base, bank, caches, nxt, *rows)
        torch.cuda.synchronize()
        want = {n: 0 for n in KERNELS}
        if not plain:
            want.update(paged_decode_attn=G,
                        sgmv=0 if sgmv_plain else per_call * (C + 1))
        if read_counts() != want:
            raise AssertionError(f"[{label}] launches {read_counts()}, want "
                                 f"{want}")
        out.append((lg1, lg2))
    gaps = []
    for what, (got, want) in (("prefill", (out[0][0], out[1][0])),
                              ("decode", (out[0][1], out[1][1]))):
        gap, ulps = (got.float() - want.float()).abs(), bf16_ulps(got, want)
        at = int(gap.argmax())
        gaps.append(float(gap.max()))
        if cfg.dtype == "bfloat16":
            log(f"[{label}] {cfg.n_layers} layers {cfg.dtype} {what} logits, "
                f"kernels vs plain: max_abs_err {gaps[-1]:.3e} at a logit of "
                f"{float(want.flatten()[at]):.3f} "
                f"({float(ulps.flatten()[at]):.0f} bf16 ulps there); at most "
                f"{float(ulps.max()):.0f} ulps, "
                f"{float((ulps > 1).float().mean()):.2e} of logits more than "
                f"1 ulp apart; |logits| <= "
                f"{float(want.float().abs().max()):.2f}")
        if tol is not None:
            compare(f"[{label}] {cfg.n_layers} layers {cfg.dtype} {what} "
                    "logits", got, want, tol)
    log(f"[{label}] {cfg.n_layers} layers {cfg.dtype} d_model "
        f"{cfg.d_model}: per-client prefill "
        f"(prompts {lengths}) logits max_abs_err={gaps[0]:.3e}, compacted "
        f"decode logits max_abs_err={gaps[1]:.3e}, kernels"
        f"{' (sgmv plain)' if sgmv_plain else ''} vs plain"
        f"{'' if tol is None else f' at {tol}'}; paged_decode_attn {G} and "
        f"sgmv {0 if sgmv_plain else per_call * (C + 1)} launches in the "
        f"kernel pass{'' if sgmv_plain else ', no host sync'}")
    return gaps


def p15_scan_share(cfg, base, bank):
    """A 256-token prompt's per-client prefill on the host clock (the
    second of two, the first warming), beside the selective scan alone at
    that prefill's shapes (2 slot rows x 256 steps x ED 8192 x N 16, CUDA
    events, L2-cold) times the Mamba sublayers: the scan's share."""
    spec = p15_spec(cfg)
    eng = ServingEngine(spec, base, [bank], device=DEV)
    pre_t = []
    eng._client_prefill = _timed(eng._client_prefill, pre_t)
    rng = np.random.default_rng(16)
    for _ in range(2):
        eng.submit(Request(1, rng.integers(0, cfg.vocab, (1, 256))
                           .astype(np.int32), 1))
        eng.run()
    del eng
    ed, N = cfg.mamba_expand * cfg.d_model, cfg.d_state
    g = gen(17)
    act = getattr(torch, cfg.dtype)
    x = torch.randn((2, 256, ed), generator=g, device=DEV).to(act)
    dt = F.softplus(torch.randn((2, 256, ed), generator=g, device=DEV) - 2)
    Bc, Cc = (torch.randn((2, 256, N), generator=g, device=DEV).to(act)
              for _ in range(2))
    p = base["groups"][0]["sub0"]["mamba"]
    A = -torch.exp(p["A_log"])
    h0 = torch.zeros((2, ed, N), device=DEV)
    scan_ms = time_ms(lambda: mamba_lib.selective_scan(
        x, dt, Bc, Cc, A, p["D"], h0), n=10)
    n_mamba = sum(not hybrid_lib.sub_is_attn(cfg, j)
                  for j in range(cfg.attn_every)) * (cfg.n_layers
                                                     // cfg.attn_every)
    pre_ms = pre_t[-1] * 1e3
    log(f"[phase 15d] a 256-token prompt's per-client prefill (2 slot rows): "
        f"{pre_ms:.2f} ms on the host clock; the selective scan alone at its "
        f"shapes {scan_ms:.3f} ms x {n_mamba} Mamba sublayers = "
        f"{n_mamba * scan_ms:.2f} ms, {100 * n_mamba * scan_ms / pre_ms:.1f}% "
        "of the prefill")
    return pre_ms, scan_ms


def _alloc_bytes():
    """(allocated, requested) bytes of the caching allocator now: what its
    blocks hold, and what the tensors in them asked for (None where this
    PyTorch keeps no requested count)."""
    st = torch.cuda.memory_stats()
    return (st["allocated_bytes.all.current"],
            st.get("requested_bytes.all.current"))


def _block_slack(tensors):
    """Sum over the allocator blocks that hold ``tensors`` of the block's
    size less the bytes its tensor requested (``memory_snapshot``), or
    None where the snapshot does not say."""
    ptrs = {t.untyped_storage().data_ptr() for t in tensors}
    slack, found = 0, 0
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated" and addr in ptrs:
                if "requested_size" not in blk:
                    return None
                slack += blk["size"] - blk["requested_size"]
                found += 1
            addr += blk["size"]
    return slack if found == len(ptrs) else None


def p15_cache_held(make, label, phase="phase 15d"):
    """Allocator bytes held (allocated) and asked for (requested) beside
    the tree's ``nbytes``, over ``make()``'s construction and again after
    ``gc.collect()`` and ``empty_cache()``; the surplus of held over the
    tree attributed to the blocks holding the leaves. Returns (the object
    made, its cache tree's leaves, held bytes)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a0, r0 = _alloc_bytes()
    made = make()
    torch.cuda.synchronize()
    a1, r1 = _alloc_bytes()
    peak = torch.cuda.max_memory_allocated() - a0
    gc.collect()
    torch.cuda.empty_cache()
    a2, r2 = _alloc_bytes()
    caches = made.caches if isinstance(made, ServingEngine) else made
    leaves = tree_leaves(caches)
    tree = sum(t.nbytes for t in leaves)
    slack = _block_slack(leaves)
    req = "not measured" if r0 is None else f"{r1 - r0:,} / {r2 - r0:,}"
    log(f"[{phase}] {label}: {len(leaves)} leaves of {tree:,} B; "
        f"allocator held {a1 - a0:,} B after construction, {a2 - a0:,} B "
        f"after gc.collect + empty_cache (peak {peak:,} B), requested "
        f"{req} B; held beyond the tree {a2 - a0 - tree:,} B, the leaves' "
        f"blocks beyond their requests "
        f"{'not measured' if slack is None else f'{slack:,}'} B")
    if r0 is not None and not r1 - r0 == r2 - r0 == tree:
        raise AssertionError(f"[{phase}] {label}: {r1 - r0} / {r2 - r0} "
                             f"B requested, the tree is {tree} B")
    if a1 != a2 or (slack is not None and a2 - a0 - tree != slack):
        raise AssertionError(f"[{phase}] {label}: the surplus "
                             f"{a2 - a0 - tree} B is not the leaves' "
                             f"blocks' {slack} B (held {a1 - a0} then "
                             f"{a2 - a0})")
    if not 0 <= a2 - a0 - tree <= len(leaves) * P15_SPLIT_SLACK:
        raise AssertionError(f"[{phase}] {label}: {a2 - a0 - tree} B "
                             f"beyond the tree, past {len(leaves)} x "
                             f"{P15_SPLIT_SLACK} B")
    return made, leaves, a2 - a0


# the caching allocator keeps a large free block whole when what is left
# after a request would be at most 1 MiB, and counts it whole as allocated
P15_SPLIT_SLACK = 1 << 20


def p15_charges(cfg, base, bank):
    """What the caches take on the card beside the router's charge for a
    request that holds one slot for ``max_seq`` tokens (the Mamba state
    and a full row of K/V), on both layouts: ``init_client_caches`` alone
    and a ``ServingEngine``'s construction (``p15_cache_held``). The tree
    is the charge per slot plus ``pos`` and ``block_tbl``, which the
    charge leaves out; the bytes requested are the tree exactly; what the
    allocator holds beyond it is its blocks' slack, at most 1 MiB per
    leaf."""
    for page_block in (16, 0):
        spec = p15_spec(cfg, page_block=page_block)
        layout = "paged" if page_block else "dense"
        slots = 4 * spec.max_batch_per_client
        charge = kvcache.cache_bytes(cfg, P15_MAX_SEQ, 1,
                                     page_block=page_block)
        spec_c = kvcache.make_cache_spec(cfg)
        for what, make in (
                ("init_client_caches", lambda: symbiosis.init_client_caches(
                    cfg, 4, spec.max_batch_per_client, P15_MAX_SEQ,
                    page_block=page_block, device=DEV)),
                ("ServingEngine", lambda: ServingEngine(spec, base, [bank],
                                                        device=DEV))):
            made, leaves, held = p15_cache_held(make, f"{layout} {what}")
            caches = made.caches if what == "ServingEngine" else made
            small = sum(caches[k].nbytes for k in ("pos", "block_tbl")
                        if k in caches)
            tree = sum(t.nbytes for t in leaves)
            log(f"[phase 15d] {layout} {what}: {held / slots:,.0f} B per slot "
                f"held; the router charges {charge:,} B for a slot of "
                f"{P15_MAX_SEQ} tokens ({spec_c.fixed_bytes:,} B of Mamba "
                f"state + {spec_c.bytes_per_token:,} B of K/V per token); "
                f"tree = {slots} charges + {small:,} B of pos and block_tbl")
            if tree != slots * charge + small:
                raise AssertionError(f"[phase 15d] {layout} {what}: tree "
                                     f"{tree} B, {slots} charges of {charge}"
                                     f" B and {small} B")
            del made, caches, leaves
        gc.collect()
        torch.cuda.empty_cache()


def phase15():
    """The hybrid family on the serving path: jamba-v0.1-52b at full width,
    2 of its 4 periods (16 of 32 layers: 2 attention, 14 Mamba, 8 MoE
    sublayers, 6 dense MLPs; about 26 B params, 52 GB in bf16, where its
    full depth, about 103 GB, fits no 80 GB card), 4 LoRA r8 tenants on q,
    v and the router. 15a pages, 15b the dense layout, 15c kernels against
    plain (bf16 at 16 layers held at ``P15_PAIR_TOL`` beside its SGMV
    control, at one period held at 2e-2; then, the bf16 base freed, fp32
    at 16 narrow layers and at one period held at 1e-5), 15d readings;
    phase 16 (16b-d) on the bf16 base, 16a on the fp32 one."""
    cfg = p15_config()
    t0 = time.perf_counter()
    base, bank = make_system(cfg, 4, seed=15, acfg=P15_LORA)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(base))
    log(f"[phase 15a] {cfg.name}: {cfg.n_layers} of 32 layers "
        f"({cfg.n_layers // cfg.attn_every} periods; d_model {cfg.d_model}, "
        f"ED {cfg.mamba_expand * cfg.d_model}, d_state {cfg.d_state}, "
        f"{cfg.n_experts} experts top-{cfg.top_k}), {n_params / 1e9:.2f} B "
        f"params bf16 ({torch.cuda.memory_allocated() / 1e9:.1f} GB) "
        f"initialised in {time.perf_counter() - t0:.1f} s; LoRA r8 on q, v "
        "and the router")
    t = time.perf_counter()
    streams, launches, dec_t, peak = phase15a(cfg, base, bank)
    log(f"[phase 15a] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    phase15b(cfg, base, bank, streams)
    log(f"[phase 15b] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    p15_wiring(cfg, base, bank, P15_PAIR_TOL, "phase 15c")
    p15_wiring(cfg, base, bank, None, "phase 15c control (a)",
               sgmv_plain=True)
    p15_wiring(p15_config(groups=1), dict(base, groups=base["groups"][:1]),
               tree_map(lambda x: x[:, :1], bank), BF16_TOL, "phase 15c")
    log(f"[phase 15c] bf16 done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    p15_charges(cfg, base, bank)
    log(f"[phase 15d] peak beyond base, bank and caches in 15a's run: "
        f"{peak / 1e9:.3f} GB")
    profile_tick(cfg, base, [bank], p15_spec(cfg), "phase 15d")
    p15_scan_share(cfg, base, bank)
    p13_router_sgmv(bank, 0, label="phase 15d")
    log(f"[phase 15d] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    phase16(cfg, base, bank, streams[:8])
    log(f"[phase 16] bf16 done ({time.perf_counter() - t:.1f} s)")
    del base, bank
    free_device("phase 15")
    t = time.perf_counter()
    cfgn = p15_narrow()
    basen, bankn = make_system(cfgn, 4, seed=15, acfg=P15_LORA)
    bankn = tree_map(lambda x: x.float(), bankn)
    p15_wiring(cfgn, basen, bankn, F32_TOL, "phase 15c control (b)")
    del basen, bankn
    free_device("phase 15")
    cfg32 = p15_config(groups=1, dtype="float32")
    base32, bank32 = make_system(cfg32, 4, seed=15, acfg=P15_LORA)
    bank32 = tree_map(lambda x: x.float(), bank32)
    p15_wiring(cfg32, base32, bank32, F32_TOL, "phase 15c")
    del bank32
    torch.cuda.empty_cache()
    log(f"[phase 15c] fp32 done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    phase16a(cfg32, base32)
    del base32
    free_device("phase 16")
    log(f"[phase 16a] done ({time.perf_counter() - t:.1f} s)")


# ---------------------------------------------------------------------------
# phase 16: the hybrid family fine-tunes on the shared base
# ---------------------------------------------------------------------------

P16_IA3 = AdapterConfig(method="ia3", targets=("k", "v", "down"))
P16_SEQ = 256            # one sequence of one scan chunk per job
P16_STEPS = 6            # 16b: 4 jobs, a warm tick, 4 timed, 1 traced


def p16_jobs(cfg, n, steps, first_seed, acfg=P15_LORA, name="jamba"):
    """``n`` jobs of ``acfg`` over 1 x ``P16_SEQ`` tokens."""
    return [FinetuneJob(acfg=acfg, batch_size=1, seq_len=P16_SEQ,
                        steps=steps, lr=1e-3, warmup_steps=1,
                        seed=first_seed + i, name=f"{name}-{first_seed + i}",
                        data=make_job_stream(cfg, 1, P16_SEQ,
                                             seed=first_seed + i, device=DEV))
            for i in range(n)]


def p16_batches(cfg, n_rows, seed, seq=P16_SEQ, batch=1):
    """One step's batch for ``n_rows`` jobs, [R, ``batch``, ``seq``] (an
    encoder-decoder's with its stub frames [R, batch, Te, d])."""
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq,
                            n_clients=n_rows, batch_per_client=batch,
                            seed=seed, device=DEV)
    out = ds.batch(0)
    if cfg.arch == "encdec":
        out.update(frontend_stub(cfg, n_rows, batch, generator=gen(seed),
                                 device=DEV))
    return out


def p16_rows(cfg, base, acfg, bank, label):
    """16a: one compact train step over a 2-row bank against each row's
    one-row bucket (the solo program) from the same state: losses, and
    the updated adapters and AdamW moments (each leaf's gap over its own
    largest magnitude), within ``P12_DRIFT_TOL``."""
    step = symbiosis.make_compact_train_step(cfg, acfg, remat=False)
    batch = p16_batches(cfg, 2, 162)
    opt = p10_opt(bank, P10_STEP)
    hyper = step7a_hyper(2)
    mask = torch.ones(2, dtype=torch.bool, device=DEV)
    slots = torch.arange(2, dtype=torch.int32, device=DEV)
    b2, o2, m2 = step(base, tree_clone(bank), tree_clone(opt), batch, slots,
                      mask, hyper)
    loss_d = state_d = 0.0
    for r in range(2):
        b1, o1, m1 = step(base, tree_clone(bank), tree_clone(opt),
                          {k: v[r:r + 1] for k, v in batch.items()},
                          slots[r:r + 1], mask[:1],
                          {k: v[r:r + 1] for k, v in hyper.items()})
        loss_d = max(loss_d, abs(float(m2["loss"][r]) - float(m1["loss"][0])))
        for a, c in zip(tree_leaves((b2, o2.m, o2.v)),
                        tree_leaves((b1, o1.m, o1.v))):
            scale = float(c[r].abs().max()) or 1.0
            state_d = max(state_d, float((a[r] - c[r]).abs().max()) / scale)
    drift = "bit for bit" if loss_d == state_d == 0.0 else \
        f"drift: losses {loss_d:.3e}, states {state_d:.3e} of a leaf's max"
    log(f"[phase 16a] {label}: 2-row step losses "
        f"{[round(float(x), 5) for x in m2['loss']]}; each row against its "
        f"one-row run: {drift}")
    if not within_drift(loss_d, state_d) or not m2["finite"].all():
        raise AssertionError(f"[phase 16a] {label}: rows drift {loss_d:.3e}"
                             f" / {state_d:.3e} beyond {P12_DRIFT_TOL}")


def phase16a(cfg, base):
    """16a: jamba's width, 1 period, fp32 (phase 15c's base): a 2-row LoRA
    (q, v, router) and a 2-row IA3 (k, v, down) bank of 1 x 256 tokens."""
    for label, acfg, bank in (
            ("LoRA r8 q/v/router", P15_LORA,
             random_lora(cfg, 2, 160, P15_LORA)),
            ("IA3 k/v/down", P16_IA3, random_bank(cfg, P16_IA3, 2, 161))):
        p16_rows(cfg, base, acfg, bank, label)
        del bank
        torch.cuda.empty_cache()


def p16_recorded_mamba(cfg, acfg):
    """Mamba sublayers whose input requires grad in a job's step (every one
    after the first sublayer an adapter of ``acfg`` reaches: the others
    run their scan unrecorded)."""
    t = set(acfg.targets)

    def reached(j):
        if hybrid_lib.sub_is_attn(cfg, j) and t & {"q", "k", "v", "o"}:
            return True
        if hybrid_lib.sub_is_moe(cfg, j):
            return "router" in t
        return bool(t & {"gate", "up", "down"})

    first = min(j for j in range(cfg.attn_every) if reached(j))
    n = sum(not hybrid_lib.sub_is_attn(cfg, j) for j in range(cfg.attn_every))
    G = cfg.n_layers // cfg.attn_every
    return G * n - sum(not hybrid_lib.sub_is_attn(cfg, j)
                       for j in range(first + 1))


def p16_scan_ms(cfg, base, rows):
    """Device ms of one Mamba sublayer's selective scan at a ``rows``-job
    train step's shapes ([rows, 256, ED, N]): unrecorded (forward only),
    and forward plus backward (its checkpointed blocks recomputed)."""
    ed, N = cfg.mamba_expand * cfg.d_model, cfg.d_state
    g = gen(163)
    act = getattr(torch, cfg.dtype)
    x = torch.randn((rows, P16_SEQ, ed), generator=g, device=DEV).to(act)
    dt = F.softplus(torch.randn((rows, P16_SEQ, ed), generator=g,
                                device=DEV) - 2)
    Bc, Cc = (torch.randn((rows, P16_SEQ, N), generator=g, device=DEV)
              .to(act) for _ in range(2))
    p = base["groups"][0]["sub0"]["mamba"]
    A = -torch.exp(p["A_log"])
    h0 = torch.zeros((rows, ed, N), device=DEV)
    fwd = time_ms(lambda: mamba_lib.selective_scan(x, dt, Bc, Cc, A, p["D"],
                                                   h0), n=5)
    ins = [t.detach().requires_grad_(True) for t in (x, dt, Bc, Cc)]

    def fwd_bwd():
        with torch.enable_grad():
            y, _ = mamba_lib.selective_scan(*ins, A, p["D"], h0)
            torch.autograd.grad(y.sum(), ins)
    return fwd, time_ms(fwd_bwd, n=5)


def p16_memory(cfg, base, job, phase="phase 16b",
               unchecked=mamba_lib._scan_block_saved):
    """Peak device memory beyond base and bank of one bank step at 1 and 4
    jobs (1 x 256 tokens each, remat off, drop-free), against
    ``job_charge_bytes``; then, given the recurrence's checkpointed block
    function ``unchecked``, 1 job with those blocks not checkpointed (their
    temporaries kept for the backward)."""
    charge = job_charge_bytes(cfg, job)
    step = symbiosis.make_compact_train_step(cfg, job.acfg, remat=False)

    def peak(R):
        bank = random_lora(cfg, R, 164, job.acfg)
        opt = AdamWState(step=torch.zeros(R, dtype=torch.int32, device=DEV),
                         m=tree_map(torch.zeros_like, bank),
                         v=tree_map(torch.zeros_like, bank))
        batch = p16_batches(cfg, R, 165)
        args = (torch.arange(R, dtype=torch.int32, device=DEV),
                torch.ones(R, dtype=torch.bool, device=DEV), step7a_hyper(R))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step(base, bank, opt, batch, *args)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - before

    peaks = {R: peak(R) for R in (1, 4)}
    kept = "not run"
    if unchecked is not None:
        orig = torch.utils.checkpoint.checkpoint
        try:  # the scan's blocks alone run unchecked: other checkpoints stay
            torch.utils.checkpoint.checkpoint = lambda fn, *a, **kw: (
                fn(*a) if fn is unchecked else orig(fn, *a, **kw))
            kept = peak(1)
            kept = f"{kept / 1e9:.3f} (+{(kept - peaks[1]) / 1e9:.3f})"
        except torch.cuda.OutOfMemoryError:
            kept = "out of memory"
        finally:
            torch.utils.checkpoint.checkpoint = orig
    torch.cuda.empty_cache()
    log(f"[{phase}] peak device memory beyond base and bank, one bank "
        f"step (1 x {P16_SEQ} tokens a job, drop-free, remat off), GB: 1 job "
        f"{peaks[1] / 1e9:.3f}, 4 jobs {peaks[4] / 1e9:.3f}; charge per job "
        f"{charge / 1e9:.3f} (job_hbm_bytes {job_hbm_bytes(cfg, job) / 1e9:.3f}"
        f"); 1 job with the scan's blocks not checkpointed: {kept}")
    for R, p in peaks.items():
        if p > R * charge:
            raise AssertionError(f"[{phase}] {R} job(s) peak at {p} B, "
                                 f"above the charge {R * charge} B")
    return peaks


def phase16b(cfg, base):
    """16b: a FinetuneEngine of 4 jamba LoRA jobs (q, v, router; 1 x 256
    tokens) behind a router that holds the fifth back: the tick on the
    host clock, one tick traced (busy share, kernels, the expert products'
    share), the selective scan's share from its time alone, memory against
    the charge."""
    jobs = (p16_jobs(cfg, 4, P16_STEPS, 50) + p16_jobs(cfg, 1, 2, 54))
    charge = job_charge_bytes(cfg, jobs[0])
    router = PlacementRouter(cfg, [Slot(0, free_hbm=4.5 * charge)])
    eng = FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()), base,
                         device=DEV, router=router)
    for j in jobs:
        eng.submit(j)
    ticks = []
    for _ in range(P16_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.train_tick()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t0)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        time.sleep(0.05)
        t0 = time.perf_counter()
        eng.train_tick()
        torch.cuda.synchronize()
        traced_tick = (time.perf_counter() - t0) * 1e3
        time.sleep(0.05)
    if eng.stats["peak_jobs"] != 4 or jobs[4].status != "queued":
        raise AssertionError(f"[phase 16b] peak {eng.stats['peak_jobs']}, "
                             f"job 4 {jobs[4].status}")
    eng.run()
    if any(j.status != "finished" for j in jobs) or not all(
            np.isfinite(j.losses).all() for j in jobs):
        raise AssertionError(f"[phase 16b] {[j.status for j in jobs]} "
                             f"{[j.losses for j in jobs]}")
    used = router.utilization()
    if router.conservation_errors() or used["committed_bytes"]:
        raise AssertionError(f"[phase 16b] router after the drain: {used}")
    med = statistics.median(ticks[1:])
    log(f"[phase 16b] {cfg.name} ({cfg.n_layers} layers): 5 LoRA r8 jobs (q, "
        f"v, router; 1 x {P16_SEQ} tokens), router slot {4.5 * charge:.0f} B "
        f"for charges of {charge} B: 4 rows for {P16_STEPS} ticks, job 4 "
        f"after; stats {eng.stats}; losses "
        f"{[[round(x, 4) for x in j.losses] for j in jobs]}")
    log(f"[phase 16b] 4-row train tick (host clock, synchronised): "
        f"{[round(t * 1e3, 3) for t in ticks]} ms; median of "
        f"{len(ticks) - 1} after the first {med * 1e3:.3f} ms, "
        f"{4 * P16_SEQ / med:.0f} tokens/s")
    busy_ms, n_kern, by_name = device_profile(prof)
    fwd, fwd_bwd = p16_scan_ms(cfg, base, 4)
    n_rec = p16_recorded_mamba(cfg, P15_LORA)
    n_mamba = sum(not hybrid_lib.sub_is_attn(cfg, j)
                  for j in range(cfg.attn_every)) * (cfg.n_layers
                                                     // cfg.attn_every)
    scan = n_rec * fwd_bwd + (n_mamba - n_rec) * fwd
    log(f"[phase 16b] the selective scan alone at the tick's shapes (4 x "
        f"{P16_SEQ} steps, CUDA events, L2-cold): {fwd:.3f} ms forward, "
        f"{fwd_bwd:.3f} ms forward + backward (blocks recomputed); "
        f"{n_rec} of {n_mamba} Mamba sublayers record (the others' inputs "
        f"need no grad): {scan:.2f} ms a tick")
    if n_kern:
        expert = p14_expert_share(prof, cfg.n_experts)
        log(f"[phase 16b] one traced 4-row tick: {traced_tick:.3f} ms on the "
            f"host clock (CPU and device traced), device busy {busy_ms:.3f} "
            f"ms = {100 * busy_ms / (med * 1e3):.1f}% of the unprofiled "
            f"median; {n_kern} kernels; the scan {scan:.2f} ms = "
            f"{100 * scan / busy_ms:.1f}% of the busy time; expert bmm "
            f"(forward, recompute, dx) "
            + (f"{expert:.3f} ms = {100 * expert / busy_ms:.1f}%" if expert
               is not None else "not measured") + "; top kernels:")
        for name, (n, d) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:8]:
            log(f"[phase 16b]   {d / 1e3:8.3f} ms  {n:5d}x  {name[:90]}")
    else:
        log("[phase 16b] the profiler saw no device events: device busy not "
            "measured")
    del eng, prof
    gc.collect()
    return p16_memory(cfg, base, jobs[0])


def phase16c(cfg, base, bank, streams):
    """16c: a SymbiosisEngine serving phase 15a's 8 requests (pages) beside
    2 jamba jobs on the same base: launches checked tick by tick (paged
    attention once per attention sublayer and SGMV ``p15_counts`` per
    decode tick, SGMV per per-request prefill), every stream bit for bit
    15a's (each its run alone), the jobs bit for bit their
    FinetuneEngine run alone."""
    G, per_call = p15_counts(cfg)
    spec = dataclasses.replace(p15_spec(cfg), finetune=FinetuneConfig())
    sym = SymbiosisEngine.from_spec(spec, base, serving_banks=[bank],
                                    device=DEV)
    reqs = make_requests(cfg, 4)
    jobs = p16_jobs(cfg, 2, 3, 60)
    for item in reqs + jobs:
        sym.submit(item)
    serving = sym.serving
    attn, sgmv = KERNELS["paged_decode_attn"][0], KERNELS["sgmv"][0]
    torch.cuda.synchronize()
    reset_counts()
    more, serve_ticks = True, 0
    while more:
        before = (attn.launches, sgmv.launches, serving.stats["ticks"],
                  serving.stats["prefill_calls"])
        more = sym.tick()
        d_at, d_sg, d_tick, d_pre = (a - b for a, b in zip(
            (attn.launches, sgmv.launches, serving.stats["ticks"],
             serving.stats["prefill_calls"]), before))
        serve_ticks += d_tick
        if d_at != G * d_tick or d_sg != per_call * (d_tick + d_pre):
            raise AssertionError(f"[phase 16c] a tick launched {d_at} paged "
                                 f"and {d_sg} SGMV kernels for {d_tick} "
                                 f"decode ticks, {d_pre} prefills")
    torch.cuda.synchronize()
    counts = read_counts()
    for i, r in enumerate(reqs):
        if first_diff(r.generated, streams[i]) is not None:
            raise AssertionError(f"[phase 16c] request {i}'s stream differs "
                                 "from 15a's")
    alone = FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()),
                           base, device=DEV)
    solo = p16_jobs(cfg, 2, 3, 60)
    for j in solo:
        alone.submit(j)
    alone.run()
    for a, b in zip(jobs, solo):
        if a.losses != b.losses or not trees_equal(
                (a.result.adapter, a.result.opt),
                (b.result.adapter, b.result.opt)):
            raise AssertionError(f"[phase 16c] {a.name} differs from its "
                                 "FinetuneEngine run alone")
    st = sym.stats
    log(f"[phase 16c] SymbiosisEngine over phase 15's base: 8 requests (4 "
        f"LoRA tenants on q, v, router, bf16 pages) beside 2 LoRA jobs in "
        f"{st['ticks']} ticks ({st['decode_ticks']} serving, "
        f"{st['train_ticks']} train): every stream equals 15a's bit for bit;"
        f" paged {G} and sgmv {per_call} per decode tick and {per_call} per "
        f"prefill, checked on each of the {serve_ticks} decode ticks "
        f"(launches {counts}); the jobs' losses, adapters and AdamW states "
        f"equal their FinetuneEngine run alone bit for bit: "
        f"{[[round(x, 4) for x in j.losses] for j in jobs]}")
    del sym, alone
    gc.collect()


def phase16d(cfg, base, jobs=None, phase="phase 16d",
             what="LoRA jobs (q, v, router)"):
    """16d: a jamba FinetuneEngine of 2 jobs killed after 1 of 3 ticks and
    resumed by a fresh engine from its blob ends bit for bit as the
    uninterrupted run (``jobs()`` makes them; 17c's are RWKV's)."""
    jobs = jobs or (lambda: p16_jobs(cfg, 2, 3, 70))
    spec = EngineSpec(cfg=cfg, finetune=FinetuneConfig())
    ref = FinetuneEngine(spec, base, device=DEV)
    ref_jobs = jobs()
    for j in ref_jobs:
        ref.submit(j)
    ref.run()
    with tempfile.TemporaryDirectory() as d:
        eng = FinetuneEngine(spec, base, device=DEV)
        for j in jobs():
            eng.submit(j)
        eng.train_tick()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_engine_state(d, eng.engine_state())
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        del eng                                          # the crash
        t0 = time.perf_counter()
        _, state = load_engine_state(d)
        fresh = FinetuneEngine(spec, base, device=DEV)
        fresh.load_engine_state(state)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        done = {j.name: j for j in fresh.run()}
    for want in ref_jobs:
        got = done[want.name]
        if got.losses != want.losses or not trees_equal(
                (got.result.adapter, got.result.opt),
                (want.result.adapter, want.result.opt)):
            raise AssertionError(f"[{phase}] {want.name} resumed differs "
                                 f"from the uninterrupted run")
    keys = sorted(state["active"][0]["init_adapter"])
    log(f"[{phase}] {cfg.name} FinetuneEngine of 2 {what} "
        f"killed after 1 of 3 ticks: blob of {size} B written in "
        f"{t_save * 1e3:.1f} ms, loaded by a fresh engine in "
        f"{t_load * 1e3:.1f} ms; adapter trees under {keys}; both jobs' "
        f"losses, adapters and AdamW states equal the uninterrupted run bit "
        f"for bit")
    del ref, fresh
    gc.collect()


def phase16(cfg, base, bank, streams):
    """16b, 16c and 16d on phase 15's bf16 base (16a runs on phase 15c's
    fp32 one)."""
    for name, run in (("16b", lambda: phase16b(cfg, base)),
                      ("16c", lambda: phase16c(cfg, base, bank, streams)),
                      ("16d", lambda: phase16d(cfg, base))):
        t = time.perf_counter()
        run()
        free_device("phase 16")
        log(f"[phase {name}] done ({time.perf_counter() - t:.1f} s)")


# ---------------------------------------------------------------------------
# phase 17: the RWKV family serves and fine-tunes on the shared base
# ---------------------------------------------------------------------------

P17_LORA = AdapterConfig(method="lora", rank=8, alpha=16.0,
                         targets=("q", "v", "cm_k"))
P17_CLIENTS, P17_SLOTS = 8, 4
P17_NEW = 32             # new tokens per request
P17_LENGTHS = (64, 128, 256)
P17_MAX_SEQ = 512        # the engine's bound on prompt + new tokens
P17_REFUSED = 300        # no multiple of the recurrence's 128-step chunk
P17_STEPS = 5            # 17c: 4 jobs, a warm tick, 3 timed, 1 traced
# 17a: a pair of kernels against plain is held at P17_CONTROL times the gap
# of control (c), the same pair with the SGMV op on ``sgmv_plain_split``
# (another exact fp32 sum order), plus 4 bf16 ulps of the largest logit
# (bf16) or 1e-5 (fp32). rwkv6-7b amplifies a rounding difference with
# depth: in bf16 at 32 layers both pairs decorrelate to ~2 (my dev calls
# 2-3, PR 27: kernel 1.953 / 1.877, control (c) 1.891 / 1.883; at 2
# layers both 2.344e-02), in fp32 at 32 layers 6.1e-03 / 5.3e-03 against
# 5.0e-03 / 5.9e-03, while control (a), the SGMV op alone on its plain
# version, is bit for bit: the gap is the SGMV kernel's sum order, which
# the model carries as it carries any other.
P17_CONTROL = 2.0
# 17c: a row's state drift from its one-row run is held at P17_NUDGE times
# the drift of that one-row run with every base weight moved by one fp32
# ulp (or P12_DRIFT_TOL's, whichever is larger): my dev calls 3b-3c, PR 27,
# read 2.0e-03 / 3.3e-03 (LoRA / IA3) beside nudges of 6.1e-04 / 3.7e-04
# on the sensitive row
P17_NUDGE = 16.0


def p17_config(n_layers=32, dtype="bfloat16"):
    """rwkv6-7b at full width, ``n_layers`` of its 32 layers."""
    cfg = get_config("rwkv6-7b")
    return dataclasses.replace(cfg, n_layers=n_layers, dtype=dtype,
                               param_dtype=dtype)


def p17_per_call(cfg, acfg=P17_LORA):
    """SGMV launches per decode tick and per per-client prefill: one per
    LoRA target (q as r, v, cm_k) per layer; RWKV has no other kernel."""
    return len(adapters.resolve_targets(cfg, acfg)) * cfg.n_layers


def p17_spec(cfg, max_b=P17_SLOTS, finetune=None):
    """8 LoRA tenants x ``max_b`` slots, opportunistic, the dense layout
    (RWKV has no pages)."""
    scfg = ServeConfig(n_clients=P17_CLIENTS, max_seq=P17_MAX_SEQ,
                       policy="opportunistic")
    return EngineSpec(cfg=cfg, banks=(BankSpec("tenants", P17_LORA,
                                               P17_CLIENTS),),
                      serve=scfg, max_batch_per_client=max_b,
                      finetune=finetune)


def p17_requests(cfg, n=16):
    """``n`` one-row requests of 64, 128 and 256 tokens in turn, 32 new
    tokens each: one per client at ticks 0-7, then one per client again
    at ticks 36-43, after each client's first has finished, so the second
    wave takes freed slots."""
    rng = np.random.default_rng(17)
    return [Request(client_id=i % P17_CLIENTS, max_new_tokens=P17_NEW,
                    arrive_tick=i if i < P17_CLIENTS else 28 + i,
                    prompt=rng.integers(0, cfg.vocab,
                                        (1, P17_LENGTHS[i % 3]))
                    .astype(np.int32)) for i in range(n)]


def p17_serve(cfg, base, bank, spec, reqs, label):
    """Serve ``reqs`` with every launch count set to 0 just before and read
    just after, checked tick by tick: SGMV ``p17_per_call`` times per decode
    tick and per per-request prefill, every other kernel never. Returns
    (engine, launches, decode-step s, prefill s by prompt length, the
    (client, slot) each request held)."""
    per_call = p17_per_call(cfg)
    eng = ServingEngine(spec, base, [bank], device=DEV)
    for r in reqs:
        eng.submit(r)
    dec_t, pre_t, held = [], {}, {}
    eng._decode_step = _timed(eng._decode_step, dec_t)
    prefill = eng._client_prefill

    def timed_prefill(m, *args):           # args[5]: the [max_b, S] tokens
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = prefill(m, *args)
        torch.cuda.synchronize()
        pre_t.setdefault(args[5].shape[1], []).append(time.perf_counter() - t)
        return out

    eng._client_prefill = timed_prefill
    torch.cuda.synchronize()
    reset_counts()
    more = True
    while more:
        before = (read_counts(), eng.stats["ticks"],
                  eng.stats["prefill_calls"])
        more = eng.service_tick()
        now = read_counts()
        d = {n: now[n] - before[0][n] for n in now}
        want = {n: 0 for n in d}
        want["sgmv"] = per_call * (eng.stats["ticks"] - before[1]
                                   + eng.stats["prefill_calls"] - before[2])
        if d != want:
            raise AssertionError(f"[{label}] tick {eng._tick}: launches {d},"
                                 f" want {want}")
        for i, r in enumerate(reqs):
            slots = eng._slots_of.get(id(r))
            if slots is not None:
                held.setdefault(i, (r.client_id, tuple(slots)))
    torch.cuda.synchronize()
    launches = read_counts()
    done = eng.drain_done()
    for r in reqs:
        g = r.generated
        if r.status != "ok" or g.shape != (1, P17_NEW) or g.min() < 0 \
                or g.max() >= cfg.vocab:
            raise AssertionError(f"[{label}] client {r.client_id}: status "
                                 f"{r.status}, tokens {g}")
    if len(done) != len(reqs):
        raise AssertionError(f"[{label}] {len(done)} of {len(reqs)} done")
    st = eng.stats
    log(f"[{label}] served {len(done)} requests ({st['prefill_tokens']} "
        f"prompt + {st['decode_tokens'] + len(done)} generated tokens): "
        f"{st['ticks']} decode ticks, {st['prefill_calls']} per-request "
        f"prefills, launches {launches} (checked tick by tick: sgmv "
        f"{per_call} per decode tick and per prefill); decode-step ms "
        f"{statistics.median(dec_t) * 1e3:.3f} (median of {len(dec_t)}); "
        f"prefill ms by prompt length " + ", ".join(
            f"{n}: {statistics.median(t) * 1e3:.2f} (median of {len(t)})"
            for n, t in sorted(pre_t.items())))
    return eng, launches, dec_t, pre_t, held


def p17_reused(held, label):
    """The requests that took a (client, slot) an earlier one held."""
    seen, reused = set(), []
    for i in sorted(held):
        c, slots = held[i]
        if any((c, s) in seen for s in slots):
            reused.append(i)
        seen.update((c, s) for s in slots)
    log(f"[{label}] requests {reused} took a slot an earlier request of "
        "their client held (its state zeroed at admission)")
    if not reused:
        raise AssertionError(f"[{label}] no slot was reused")
    return reused


def p17_wiring(cfg, base, bank, tol, label, control=None):
    """A per-client prefill of one prompt per client (64-256 tokens, slot
    0; slot 1 a dummy of length 0) into a dense bank, then one masked
    decode tick of the 8 slot rows (the admitted 4 active), with the
    kernels (no host sync) and under ``plain_kernels()``: SGMV
    ``p17_per_call`` launches per call (none plain), logits at ``tol`` or,
    with ``tol`` None, their gap printed in bf16 ulps. ``control`` runs the
    first pass with the SGMV op on its plain version instead ("plain") or
    on ``sgmv_plain_split`` ("split"). Returns the two max errors."""
    sgmv_plain = control is not None
    C, max_b = 4, 2
    per_call = p17_per_call(cfg)
    scfg = ServeConfig(n_clients=C, max_seq=P17_MAX_SEQ)
    lengths = [64, 256, 100, 128]
    rng = np.random.default_rng(3)
    toks = [torch.tensor(np.stack([rng.integers(0, cfg.vocab, n),
                                   np.zeros(n, np.int64)]),
                         dtype=torch.int32, device=DEV) for n in lengths]
    lens = [torch.tensor([n, 0], dtype=torch.int32, device=DEV)
            for n in lengths]
    mask = torch.tensor([True, False], device=DEV)
    active = torch.tensor([[True, False]] * C, device=DEV)
    prefill = symbiosis.make_client_prefill(cfg, P17_LORA, scfg)
    decode = symbiosis.make_masked_decode_step(cfg, P17_LORA, scfg)
    out, nxt = [], None
    for plain in (False, True):
        caches = symbiosis.init_client_caches(cfg, C, max_b, P17_MAX_SEQ,
                                              device=DEV)
        torch.cuda.synchronize()
        reset_counts()
        with blocks.plain_kernels() if plain else (
                sgmv_plain_only(split=control == "split") if sgmv_plain
                else no_host_sync()):
            lg1 = []
            for c in range(C):
                lg, caches = prefill(base, bank, caches, c, c, toks[c],
                                     lens[c], mask)
                lg1.append(lg[0])
            lg1 = torch.stack(lg1)
            if nxt is None:
                nxt = torch.stack([lg1.argmax(-1).to(torch.int32),
                                   torch.zeros(C, dtype=torch.int32,
                                               device=DEV)], dim=1)
            lg2, caches = decode(base, bank, caches, nxt, active)
        torch.cuda.synchronize()
        want = {n: 0 for n in KERNELS}
        if not (plain or sgmv_plain):
            want["sgmv"] = per_call * (C + 1)
        if read_counts() != want:
            raise AssertionError(f"[{label}] launches {read_counts()}, want "
                                 f"{want}")
        out.append((lg1, lg2[:, 0]))
    gaps = []
    for what, (got, want) in (("prefill", (out[0][0], out[1][0])),
                              ("decode", (out[0][1], out[1][1]))):
        gap, ulps = (got.float() - want.float()).abs(), bf16_ulps(got, want)
        at = int(gap.argmax())
        gaps.append(float(gap.max()))
        if cfg.dtype == "bfloat16":
            log(f"[{label}] {cfg.n_layers} layers {cfg.dtype} {what} logits, "
                f"kernels{f' (sgmv {control})' if sgmv_plain else ''} vs "
                "plain: "
                f"max_abs_err {gaps[-1]:.3e} at a logit of "
                f"{float(want.flatten()[at]):.3f} "
                f"({float(ulps.flatten()[at]):.0f} bf16 ulps there); at most "
                f"{float(ulps.max()):.1f} ulps, "
                f"{float((ulps > 1).float().mean()):.2e} of logits more than "
                f"1 ulp apart; |logits| <= "
                f"{float(want.float().abs().max()):.2f}")
        if tol is not None:
            compare(f"[{label}] {cfg.n_layers} layers {cfg.dtype} {what} "
                    "logits", got, want, tol)
    log(f"[{label}] {cfg.n_layers} layers {cfg.dtype}: per-client prefill "
        f"(prompts {lengths}) logits max_abs_err={gaps[0]:.3e}, masked "
        f"decode logits max_abs_err={gaps[1]:.3e}, kernels"
        f"{f' (sgmv {control})' if sgmv_plain else ''} vs plain"
        f"{'' if tol is None else f' at {tol}'}; sgmv "
        f"{0 if sgmv_plain else per_call * (C + 1)} launches in the kernel "
        f"pass{'' if sgmv_plain else ', no host sync'}")
    return gaps, max(float(t.float().abs().max()) for t in out[1])


def p17_pair(cfg, base, bank, label, tol=None, plain_control=False):
    """17a's pair, kernels against plain (``p17_wiring``), beside control
    (c) and, with ``plain_control``, control (a) (held bit for bit): each
    gap held at ``P17_CONTROL`` x control (c)'s plus 4 bf16 ulps of the
    largest logit (bf16) or 1e-5 (fp32), and at ``tol`` when given."""
    gaps, top = p17_wiring(cfg, base, bank, tol, label)
    if plain_control:
        same, _ = p17_wiring(cfg, base, bank, None, f"{label} control (a)",
                             control="plain")
        if any(same):
            raise AssertionError(f"[{label}] control (a): {same}, not bit "
                                 "for bit")
    ctl, _ = p17_wiring(cfg, base, bank, None, f"{label} control (c)",
                        control="split")
    floor = 4 * 2.0 ** (int(np.frexp(top)[1]) - 8) \
        if cfg.dtype == "bfloat16" else F32_TOL["atol"]
    bound = [P17_CONTROL * c + floor for c in ctl]
    log(f"[{label}] {cfg.n_layers} layers {cfg.dtype}: kernel gaps {gaps} "
        f"against control (c)'s {ctl}; held at {P17_CONTROL} x control (c) "
        f"+ {floor:.3e} = {[round(b, 6) for b in bound]}")
    if any(g > b for g, b in zip(gaps, bound)):
        raise AssertionError(f"[{label}] gaps {gaps} past {bound}")


def p17_rows(cfg, base, acfg, bank, label, phase="phase 17c"):
    """17c: one compact train step over a 2-row bank against each row's
    one-row run from the same state (losses within ``P12_DRIFT_TOL``; the
    updated adapters and AdamW moments, each leaf's gap over its own
    largest magnitude), beside each one-row run against itself with every
    base weight moved by one fp32 ulp in a random direction (the step's
    own conditioning): the state drift held at ``P17_NUDGE`` x the nudge's,
    or ``P12_DRIFT_TOL``'s, whichever is larger."""
    step = symbiosis.make_compact_train_step(cfg, acfg, remat=False)
    batch = p16_batches(cfg, 2, 162)
    opt = p10_opt(bank, P10_STEP)
    hyper = step7a_hyper(2)
    mask = torch.ones(2, dtype=torch.bool, device=DEV)
    slots = torch.arange(2, dtype=torch.int32, device=DEV)

    def run(b, r=None):
        if r is None:
            return step(b, tree_clone(bank), tree_clone(opt), batch, slots,
                        mask, hyper)
        return step(b, tree_clone(bank), tree_clone(opt),
                    {k: v[r:r + 1] for k, v in batch.items()}, slots[r:r + 1],
                    mask[:1], {k: v[r:r + 1] for k, v in hyper.items()})

    def drift(x, y, r):
        d = 0.0
        for a, c in zip(tree_leaves((x[0], x[1].m, x[1].v)),
                        tree_leaves((y[0], y[1].m, y[1].v))):
            scale = float(c[r].abs().max()) or 1.0
            d = max(d, float((a[r] - c[r]).abs().max()) / scale)
        return abs(float(x[2]["loss"][r if x[2]["loss"].numel() > 1 else 0])
                   - float(y[2]["loss"][0])), d

    g = gen(175)

    def nudge(w):
        up = torch.rand(w.shape, generator=g, device=DEV) < 0.5
        return torch.where(up, torch.nextafter(w, torch.full_like(w, np.inf)),
                           torch.nextafter(w, torch.full_like(w, -np.inf)))

    two = run(base)
    nudged_base = tree_map(nudge, base)
    rows = []
    for r in range(2):
        one = run(base, r)
        rows.append((drift(two, one, r), drift(run(nudged_base, r), one, r)))
    del nudged_base
    log(f"[{phase}] {label}: 2-row step losses "
        f"{[round(float(x), 5) for x in two[2]['loss']]}; each row against "
        f"its one-row run (loss, state of a leaf's max): "
        f"{[(f'{a:.3e}', f'{b:.3e}') for (a, b), _ in rows]}; the one-row "
        f"run with the base nudged one ulp: "
        f"{[(f'{a:.3e}', f'{b:.3e}') for _, (a, b) in rows]}")
    for (loss_d, state_d), (_, nudge_d) in rows:
        bound = max(P12_DRIFT_TOL["state"], P17_NUDGE * nudge_d)
        if loss_d > P12_DRIFT_TOL["loss"] or state_d > bound:
            raise AssertionError(
                f"[{phase}] {label}: drift {loss_d:.3e} / {state_d:.3e} "
                f"past {P12_DRIFT_TOL['loss']} / {bound:.3e}")
    if not two[2]["finite"].all():
        raise AssertionError(f"[{phase}] {label}: a row is not finite")


def p17_sgmv_times(cfg, label="phase 17d"):
    """SGMV at the channel mix's shapes, 8 bf16 rank-8 adapters (the
    serving path's dtype): cm_k (d 4096 -> d_ff 14336) and cm_v (14336 ->
    4096), at decode (8 rows, block_t 1) and over a per-client prefill's 4
    slot rows of 256 tokens (block_t 256), each held against its plain
    version at 2e-2 and timed beside it, a gather + ``bmm`` and its bound.
    Returns {case: (ms, plain ms, bound ms, by, library ms)}."""
    scale = P17_LORA.alpha / P17_LORA.rank
    n, r = P17_CLIENTS, P17_LORA.rank
    out = {}
    for name, (T, bt, ids) in (("decode", (8, 1, [0, 1, 2, 3, 4, 5, 6, 7])),
                               ("prefill", (1024, 256, [3, 3, 3, 3]))):
        for path, (din, dout) in (("cm_k", (cfg.d_model, cfg.d_ff)),
                                  ("cm_v", (cfg.d_ff, cfg.d_model))):
            g = gen(171)
            A = (torch.randn((n, din, r), generator=g, device=DEV)
                 / din ** 0.5).to(torch.bfloat16)
            Bw = (torch.randn((n, r, dout), generator=g, device=DEV)
                  * 0.05).to(torch.bfloat16)
            x = torch.randn((T, din), generator=g, device=DEV) \
                .to(torch.bfloat16)
            ids_t = torch.tensor(ids, dtype=torch.int32, device=DEV)

            def kernel():
                return sg.sgmv_cuda(x, A, Bw, ids_t, block_t=bt, scale=scale)

            row = ids_t.long().repeat_interleave(bt)

            def library():
                h = torch.bmm(x[:, None, :], A[row])
                return torch.bmm(h, Bw[row])[:, 0] * scale

            err = compare(f"sgmv {path} {name} (kernel vs plain)", kernel(),
                          sg.sgmv_plain(x.float(), A.float(), Bw.float(),
                                        ids_t, block_t=bt, scale=scale),
                          BF16_TOL)
            ms, dev_ms = time_ms(kernel), device_ms(kernel)
            plain_ms = time_ms(lambda: sg.sgmv_plain(
                x, A, Bw, ids_t, block_t=bt, scale=scale), n=10)
            lib_ms = time_ms(library, n=10)
            nb = len(set(ids))
            nbytes = 2 * (T * din + nb * r * (din + dout) + T * dout) \
                + 4 * len(ids)
            b_ms, by = bound(nbytes, 2 * T * r * (din + dout))
            out[f"{path}_{name}"] = (ms, plain_ms, b_ms, by, lib_ms)
            log(f"[{label}] sgmv {path} {name} T={T} block_t={bt} din={din} "
                f"r={r} dout={dout} bf16 (max_abs_err {err:.3e} vs plain): "
                f"kernel {ms:.4f} ms L2-cold (device time, enqueue hidden, "
                f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, gather+bmm "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}, {nbytes} B)")
    return out


def p17_scan_ms(cfg, rows, S, backward=False):
    """Device ms of one layer's wkv6 recurrence at ``rows`` x ``S`` tokens
    of rwkv6-7b's heads (bf16 r, k, v; fp32 w, bonus and state), CUDA
    events, L2-cold; with ``backward``, forward plus backward through the
    checkpointed blocks."""
    H, hd = cfg.d_model // cfg.hd, cfg.hd
    g = gen(172)
    act = getattr(torch, cfg.dtype)
    r, k, v = (torch.randn((rows, S, H, hd), generator=g, device=DEV)
               .to(act) for _ in range(3))
    w = torch.rand((rows, S, H, hd), generator=g, device=DEV) * 0.5 + 0.5
    bonus = torch.randn((H, hd), generator=g, device=DEV) * 0.1
    st = torch.zeros((rows, H, hd, hd), device=DEV)
    if not backward:
        return time_ms(lambda: rwkv_lib.wkv6_scan(r, k, v, w, bonus, st),
                       n=5)
    ins = [t.detach().requires_grad_(True) for t in (r, k, v, w)]

    def fwd_bwd():
        with torch.enable_grad():
            out, _ = rwkv_lib.wkv6_scan(*ins, bonus, st)
            torch.autograd.grad(out.sum(), ins)
    return time_ms(fwd_bwd, n=5)


def p17_prefill_share(cfg, pre_t):
    """Each prompt length's per-client prefill (17b's median, host clock)
    beside the recurrence alone at its shapes (the client's 4 slot rows)
    times the layers."""
    out = {}
    for S in (128, 256):
        pre_ms = statistics.median(pre_t[S]) * 1e3
        scan = p17_scan_ms(cfg, P17_SLOTS, S)
        out[S] = (pre_ms, scan)
        log(f"[phase 17b] a {S}-token prompt's per-client prefill "
            f"({P17_SLOTS} slot rows): {pre_ms:.2f} ms on the host clock; the "
            f"wkv6 recurrence alone at its shapes {scan:.3f} ms x "
            f"{cfg.n_layers} layers = {cfg.n_layers * scan:.2f} ms, "
            f"{100 * cfg.n_layers * scan / pre_ms:.1f}% of the prefill")
    return out


def p17_state_bytes(cfg, base, bank):
    """The state's bytes on the card, built by ``init_client_caches`` and
    by an engine (``p15_cache_held``), per slot beside the router's charge
    for a slot (``cache_bytes``: the fixed state, no bytes per token)."""
    spec = p17_spec(cfg)
    slots = P17_CLIENTS * P17_SLOTS
    charge = kvcache.cache_bytes(cfg, P17_MAX_SEQ, 1)
    for what, make in (
            ("init_client_caches", lambda: symbiosis.init_client_caches(
                cfg, P17_CLIENTS, P17_SLOTS, P17_MAX_SEQ, device=DEV)),
            ("ServingEngine", lambda: ServingEngine(spec, base, [bank],
                                                    device=DEV))):
        made, leaves, held = p15_cache_held(make, what, phase="phase 17b")
        caches = made.caches if what == "ServingEngine" else made
        tree = sum(t.nbytes for t in leaves)
        log(f"[phase 17b] {what}: {held / slots:,.0f} B per slot held; the "
            f"router charges {charge:,} B a slot (predicted 34,078,720); "
            f"tree = {slots} charges + {caches['pos'].nbytes} B of pos")
        if tree != slots * charge + caches["pos"].nbytes:
            raise AssertionError(f"[phase 17b] {what}: tree {tree} B, "
                                 f"{slots} charges of {charge} B")
        del made, caches, leaves
        gc.collect()
        torch.cuda.empty_cache()


def phase17b(cfg, base, bank):
    """17b: 16 requests over 8 clients x 4 slots (slots reused), launches
    tick by tick, every stream bit for bit its run alone, a 300-token
    prompt refused; the tick, the prefills and the state's bytes."""
    spec = p17_spec(cfg)
    warm_up(spec, base, bank)
    reqs = p17_requests(cfg)
    eng, launches, dec_t, pre_t, held = p17_serve(cfg, base, bank, spec,
                                                  reqs, "phase 17b")
    del eng
    reused = p17_reused(held, "phase 17b")
    p15_alone(cfg, base, bank, spec, reqs, "phase 17b",
              note=f"; those in a reused slot, {reused}, included")
    p15_refused(cfg, base, bank, spec, n=P17_REFUSED, chunk=128,
                label="phase 17b")
    times = profile_tick(cfg, base, [bank], spec, "phase 17b",
                         prompt_len=64)
    shares = p17_prefill_share(cfg, pre_t)
    p17_state_bytes(cfg, base, bank)
    return [r.generated.copy() for r in reqs], launches, dec_t, times, shares


def phase17c_engine(cfg, base):
    """17c: a FinetuneEngine of 4 rwkv LoRA jobs (q, v, cm_k; 1 x 256
    tokens) behind a router that holds the fifth back: the tick on the
    host clock, one tick traced (busy share, kernels, the recurrence's
    share from its time alone), memory against the charge."""
    jobs = (p16_jobs(cfg, 4, P17_STEPS, 80, P17_LORA, "rwkv")
            + p16_jobs(cfg, 1, 2, 84, P17_LORA, "rwkv"))
    charge = job_charge_bytes(cfg, jobs[0])
    router = PlacementRouter(cfg, [Slot(0, free_hbm=4.5 * charge)])
    eng = FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()), base,
                         device=DEV, router=router)
    for j in jobs:
        eng.submit(j)
    ticks = []
    for _ in range(P17_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.train_tick()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t0)
    with traced() as prof:
        t0 = time.perf_counter()
        eng.train_tick()
        torch.cuda.synchronize()
        traced_tick = (time.perf_counter() - t0) * 1e3
    if eng.stats["peak_jobs"] != 4 or jobs[4].status != "queued":
        raise AssertionError(f"[phase 17c] peak {eng.stats['peak_jobs']}, "
                             f"job 4 {jobs[4].status}")
    eng.run()
    if any(j.status != "finished" for j in jobs) or not all(
            np.isfinite(j.losses).all() for j in jobs):
        raise AssertionError(f"[phase 17c] {[j.status for j in jobs]} "
                             f"{[j.losses for j in jobs]}")
    used = router.utilization()
    if router.conservation_errors() or used["committed_bytes"]:
        raise AssertionError(f"[phase 17c] router after the drain: {used}")
    med = statistics.median(ticks[1:])
    log(f"[phase 17c] {cfg.name} ({cfg.n_layers} layers): 5 LoRA r8 jobs (q, "
        f"v, cm_k; 1 x {P16_SEQ} tokens), router slot {4.5 * charge:.0f} B "
        f"for charges of {charge} B: 4 rows for {P17_STEPS} ticks, job 4 "
        f"after; stats {eng.stats}; losses "
        f"{[[round(x, 4) for x in j.losses] for j in jobs]}")
    log(f"[phase 17c] 4-row train tick (host clock, synchronised): "
        f"{[round(t * 1e3, 3) for t in ticks]} ms; median of "
        f"{len(ticks) - 1} after the first {med * 1e3:.3f} ms, "
        f"{4 * P16_SEQ / med:.0f} tokens/s")
    busy_ms, n_kern, by_name = device_profile(prof)
    fwd_bwd = p17_scan_ms(cfg, 4, P16_SEQ, backward=True)
    # the first layer's recurrence records too: its r path carries the LoRA
    scan = cfg.n_layers * fwd_bwd
    log(f"[phase 17c] the wkv6 recurrence alone at the tick's shapes (4 x "
        f"{P16_SEQ} steps, CUDA events, L2-cold): {fwd_bwd:.3f} ms forward +"
        f" backward (blocks recomputed) x {cfg.n_layers} layers = "
        f"{scan:.2f} ms a tick")
    if n_kern:
        log(f"[phase 17c] one traced 4-row tick: {traced_tick:.3f} ms on the "
            f"host clock, device busy {busy_ms:.3f} ms = "
            f"{100 * busy_ms / (med * 1e3):.1f}% of the unprofiled median; "
            f"{n_kern} kernels; the recurrence {scan:.2f} ms = "
            f"{100 * scan / busy_ms:.1f}% of the busy time; top kernels:")
        for name, (n, d) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:8]:
            log(f"[phase 17c]   {d / 1e3:8.3f} ms  {n:5d}x  {name[:90]}")
    else:
        log("[phase 17c] the profiler saw no device events: device busy not "
            "measured")
    del eng, prof
    gc.collect()
    return p16_memory(cfg, base, jobs[0], phase="phase 17c", unchecked=None)


def phase17c_symbiosis(cfg, base, bank, streams):
    """17c: a SymbiosisEngine serving 17b's first 8 requests beside 2 rwkv
    jobs on the same base: SGMV launches checked tick by tick, every
    stream bit for bit 17b's (each its run alone), the jobs bit for bit
    their FinetuneEngine run alone."""
    per_call = p17_per_call(cfg)
    spec = p17_spec(cfg, finetune=FinetuneConfig())
    sym = SymbiosisEngine.from_spec(spec, base, serving_banks=[bank],
                                    device=DEV)
    reqs = p17_requests(cfg, 8)
    jobs = p16_jobs(cfg, 2, 3, 90, P17_LORA, "rwkv")
    for item in reqs + jobs:
        sym.submit(item)
    serving = sym.serving
    torch.cuda.synchronize()
    reset_counts()
    more, serve_ticks = True, 0
    while more:
        before = (read_counts(), serving.stats["ticks"],
                  serving.stats["prefill_calls"])
        more = sym.tick()
        now = read_counts()
        d_tick = serving.stats["ticks"] - before[1]
        d_pre = serving.stats["prefill_calls"] - before[2]
        serve_ticks += d_tick
        want = {n: 0 for n in now}
        want["sgmv"] = per_call * (d_tick + d_pre)
        if {n: now[n] - before[0][n] for n in now} != want:
            raise AssertionError(f"[phase 17c] a tick launched "
                                 f"{now} - {before[0]}, want {want}")
    torch.cuda.synchronize()
    for i, r in enumerate(reqs):
        if first_diff(r.generated, streams[i]) is not None:
            raise AssertionError(f"[phase 17c] request {i}'s stream differs "
                                 "from 17b's")
    alone = FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()),
                           base, device=DEV)
    solo = p16_jobs(cfg, 2, 3, 90, P17_LORA, "rwkv")
    for j in solo:
        alone.submit(j)
    alone.run()
    for a, b in zip(jobs, solo):
        if a.losses != b.losses or not trees_equal(
                (a.result.adapter, a.result.opt),
                (b.result.adapter, b.result.opt)):
            raise AssertionError(f"[phase 17c] {a.name} differs from its "
                                 "FinetuneEngine run alone")
    st = sym.stats
    log(f"[phase 17c] SymbiosisEngine: 17b's first 8 requests (8 LoRA "
        f"tenants on q, v, cm_k) beside 2 LoRA jobs in {st['ticks']} ticks "
        f"({st['decode_ticks']} serving, {st['train_ticks']} train): every "
        f"stream equals 17b's bit for bit; sgmv {per_call} per decode tick "
        f"and per prefill, checked on each of the {serve_ticks} decode ticks;"
        f" the jobs' losses, adapters and AdamW states equal their "
        f"FinetuneEngine run alone bit for bit: "
        f"{[[round(x, 4) for x in j.losses] for j in jobs]}")
    del sym, alone
    gc.collect()


def phase17():
    """The RWKV family serves and fine-tunes: rwkv6-7b at full width and
    full depth (32 layers, 7.53 B params, ~15 GB bf16), 8 LoRA r8 tenants
    on q (r), v and cm_k. 17a kernels against plain at 2 and 32 layers,
    bf16 then fp32, each beside its controls; 17b serving; 17c
    fine-tuning (full depth, then 2-layer fp32 rows); 17d the new SGMV
    shapes timed."""
    cfg = p17_config()
    t0 = time.perf_counter()
    base, bank = make_system(cfg, P17_CLIENTS, seed=17, acfg=P17_LORA)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(base))
    log(f"[phase 17] {cfg.name}: {cfg.n_layers} layers (d_model "
        f"{cfg.d_model}, {cfg.d_model // cfg.hd} heads of {cfg.hd}, d_ff "
        f"{cfg.d_ff}), {n_params / 1e9:.3f} B params bf16 "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) initialised in "
        f"{time.perf_counter() - t0:.1f} s; LoRA r8 on q (r), v and cm_k")
    t = time.perf_counter()
    p17_pair(p17_config(n_layers=2), dict(base, layers=base["layers"][:2]),
             tree_map(lambda x: x[:, :2], bank), "phase 17a")
    p17_pair(cfg, base, bank, "phase 17a", plain_control=True)
    log(f"[phase 17a] bf16 done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    streams, launches, dec_t, times, shares = phase17b(cfg, base, bank)
    log(f"[phase 17b] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    peaks = phase17c_engine(cfg, base)
    free_device("phase 17")
    phase17c_symbiosis(cfg, base, bank, streams[:8])
    free_device("phase 17")
    phase16d(cfg, base, jobs=lambda: p16_jobs(cfg, 2, 3, 95, P17_LORA,
                                              "rwkv"),
             phase="phase 17c", what="LoRA jobs (q, v, cm_k)")
    log(f"[phase 17c] full depth done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    sgmv_times = p17_sgmv_times(cfg)
    log(f"[phase 17d] done ({time.perf_counter() - t:.1f} s)")
    del base, bank
    free_device("phase 17")
    t = time.perf_counter()
    cfg32 = p17_config(dtype="float32")
    base32, bank32 = make_system(cfg32, 4, seed=17, acfg=P17_LORA)
    bank32 = tree_map(lambda x: x.float(), bank32)
    p17_pair(cfg32, base32, bank32, "phase 17a")
    two32 = p17_config(n_layers=2, dtype="float32")
    base2 = dict(base32, layers=base32["layers"][:2])
    p17_pair(two32, base2, tree_map(lambda x: x[:, :2], bank32), "phase 17a",
             tol=F32_TOL)
    del bank32
    for label, acfg, b in (
            ("LoRA r8 q/v/cm_k", P17_LORA, random_lora(two32, 2, 173,
                                                        P17_LORA)),
            ("IA3 k/v", P16_IA3, random_bank(two32, P16_IA3, 2, 174))):
        p17_rows(two32, base2, acfg, b, label)
    del base32, base2
    free_device("phase 17")
    log(f"[phase 17a/c] fp32 done ({time.perf_counter() - t:.1f} s)")
    return launches, sgmv_times, peaks, dec_t, times, shares


# ---------------------------------------------------------------------------
# phase 18: the encoder-decoder family (whisper-small) on the serving steps
# and in fine-tuning
# ---------------------------------------------------------------------------

P18_LORA = AdapterConfig(method="lora", rank=8, alpha=16.0,
                         targets=("q", "v"))
P18_CLIENTS, P18_SLOTS = 4, 2
# the 8 decoder prompts (client c's slot s is row 2c + s), 4-64 tokens, and
# each row's new tokens: rows finish at different lengths
P18_LENGTHS = (4, 64, 17, 40, 9, 33, 52, 25)
P18_NEW = (6, 16, 9, 12, 7, 14, 11, 8)
P18_MAX_SEQ, P18_BLK = 128, 16
P18_TRAIN_S = 128        # 18c: 2 x 128 decoder tokens a job, 1,500 frames a row
P18_STEPS = 4            # 18c: 4 jobs, a warm tick, 2 timed, 1 traced
# 18a: a 24-layer pair of kernels against plain is held at P18_CONTROL times
# the gap of control (c), the same pair with the SGMV op on
# ``sgmv_plain_split`` (another exact fp32 sum order), plus 4 bf16 ulps of
# the largest logit (bf16) or 1e-5 (fp32), as 17a holds rwkv6-7b's
P18_CONTROL = 2.0


def p18_config(n_layers=12, n_enc_layers=12, dtype="bfloat16"):
    """whisper-small at full width (d_model 768, 12 heads of 64, MHA, d_ff
    3072, 1,500 frames, vocab 51,865), ``n_enc_layers`` + ``n_layers`` of
    its 12 + 12 layers."""
    cfg = get_config("whisper-small")
    return dataclasses.replace(cfg, n_layers=n_layers,
                               n_enc_layers=n_enc_layers, dtype=dtype,
                               param_dtype=dtype)


def p18_per_call(cfg, prefill=False):
    """SGMV launches of a decode tick (q and v on every decoder layer) or of
    a prefill (the encoder's layers too)."""
    n = cfg.n_layers + (cfg.n_enc_layers if prefill else 0)
    return len(adapters.resolve_targets(cfg, P18_LORA)) * n


def p18_prompts(cfg, seed=18):
    """Each client's 2 decoder prompts, right-padded ([2, S_c] tokens, [2]
    lengths), and every slot's stub frames [C, 2, Te, d]."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(P18_CLIENTS):
        n = P18_LENGTHS[2 * c:2 * c + 2]
        toks = np.zeros((P18_SLOTS, max(n)), np.int32)
        for s, L in enumerate(n):
            toks[s, :L] = rng.integers(0, cfg.vocab, L)
        out.append((torch.tensor(toks, device=DEV),
                    torch.tensor(n, dtype=torch.int32, device=DEV)))
    frames = frontend_stub(cfg, P18_CLIENTS, P18_SLOTS, generator=gen(seed),
                           device=DEV)["frames"]
    return out, frames


def p18_scfg(paged):
    return ServeConfig(n_clients=P18_CLIENTS, max_seq=P18_MAX_SEQ,
                       page_block=P18_BLK if paged else 0)


def p18_prefill(cfg, base, bank, prompts, frames, paged):
    """Each client's 2 slot rows through the model's prefill with their
    frames on a one-client cache (pages of 16, or dense rows), every row
    its client's LoRA through SGMV (one block per row: the encoder's 1,500
    frames, the decoder's padded prompt), as the port's per-client prefill
    runs them; the caches stacked into the bank. JAX's engine passes no
    frames, so no engine admission serves enc-dec (a stated refusal):
    this is the per-client prefill of ``make_client_prefill`` with the
    frames the model needs. Returns (logits [8, V], bank caches)."""
    model = get_model(cfg)
    kw = {"page_block": P18_BLK} if paged else {}
    logits, per = [], []
    for c, (toks, lens) in enumerate(prompts):
        rows = torch.full((P18_SLOTS,), c, dtype=torch.int32, device=DEV)
        cache = model.init_cache(P18_SLOTS, P18_MAX_SEQ, device=DEV, **kw)
        lg, cache = model.prefill(
            base, {"tokens": toks, "frames": frames[c]}, cache,
            make_compact_ctx(cfg, P18_LORA, rows),
            adapters.compact_adapter_bank(bank, rows), lengths=lens)
        logits.append(lg)
        per.append(cache)
    return torch.cat(logits), symbiosis.stack_client_caches(
        cfg, P18_MAX_SEQ, per, **kw)


def p18_rows():
    """Every (client, slot) row in (client, slot) order."""
    clients = torch.arange(P18_CLIENTS, dtype=torch.int32, device=DEV) \
        .repeat_interleave(P18_SLOTS)
    slots = torch.arange(P18_SLOTS, dtype=torch.int32, device=DEV) \
        .repeat(P18_CLIENTS)
    return clients, slots


def p18_wiring(cfg, base, bank, tol, label, control=None):
    """18a: the per-client prefill of every client (``p18_prefill``) and one
    decode tick of the 8 rows, on pages (the compacted step: the paged
    kernel) and on dense rows (the masked step: the dense kernel), with the
    kernels (no host sync) and under ``plain_kernels()``: the launches of
    each pass checked, logits held at ``tol`` or, with ``tol`` None, their
    gap printed in bf16 ulps. ``control="split"`` runs the first pass with
    the SGMV op on ``sgmv_plain_split``. Returns the max gaps [prefill,
    paged decode, dense decode] and the largest plain logit."""
    prompts, frames = p18_prompts(cfg)
    clients, slots = p18_rows()
    live = torch.ones(P18_CLIENTS * P18_SLOTS, dtype=torch.bool, device=DEV)
    act = live.reshape(P18_CLIENTS, P18_SLOTS)
    steps = {True: symbiosis.make_compact_decode_step(cfg, P18_LORA,
                                                      p18_scfg(True)),
             False: symbiosis.make_masked_decode_step(cfg, P18_LORA,
                                                      p18_scfg(False))}
    n_pre = p18_per_call(cfg, prefill=True) * P18_CLIENTS
    out, nxt = {}, None
    for plain in (False, True):
        for paged in (True, False):
            torch.cuda.synchronize()
            reset_counts()
            with blocks.plain_kernels() if plain else (
                    sgmv_plain_only(split=True) if control else
                    no_host_sync()):
                lg1, caches = p18_prefill(cfg, base, bank, prompts, frames,
                                          paged)
                if nxt is None:
                    nxt = lg1.argmax(-1).to(torch.int32)
                if paged:
                    lg2, _, caches = steps[True](base, bank, caches, nxt,
                                                 clients, slots, live)
                else:
                    lg2, caches = steps[False](
                        base, bank, caches,
                        nxt.reshape(P18_CLIENTS, P18_SLOTS), act)
                    lg2 = lg2.reshape(P18_CLIENTS * P18_SLOTS, -1)
            torch.cuda.synchronize()
            want = {n: 0 for n in KERNELS}
            if not plain:
                want["paged_decode_attn" if paged else "decode_attn"] = \
                    cfg.n_layers * (1 if paged else 2)
                if not control:
                    want["sgmv"] = n_pre + p18_per_call(cfg)
            if read_counts() != want:
                raise AssertionError(f"[{label}] launches {read_counts()}, "
                                     f"want {want}")
            out[plain, paged] = (lg1, lg2)
            del caches
    gaps = []
    for what, got, want in (
            ("prefill", out[False, True][0], out[True, True][0]),
            ("paged decode", out[False, True][1], out[True, True][1]),
            ("dense decode", out[False, False][1], out[True, False][1])):
        gap, ulps = (got.float() - want.float()).abs(), bf16_ulps(got, want)
        gaps.append(float(gap.max()))
        if cfg.dtype == "bfloat16":
            log(f"[{label}] {cfg.n_enc_layers}+{cfg.n_layers} layers "
                f"{cfg.dtype} {what} logits, kernels"
                f"{' (sgmv split)' if control else ''} vs plain: max_abs_err "
                f"{gaps[-1]:.3e}, at most {float(ulps.max()):.1f} bf16 ulps; "
                f"|logits| <= {float(want.float().abs().max()):.2f}")
        if tol is not None:
            compare(f"[{label}] {cfg.n_enc_layers}+{cfg.n_layers} layers "
                    f"{cfg.dtype} {what} logits", got, want, tol)
    for paged in (True, False):
        if not torch.equal(out[False, paged][0], out[False, True][0]):
            raise AssertionError(f"[{label}] the prefill logits differ "
                                 "between the layouts")
    log(f"[{label}] {cfg.n_enc_layers}+{cfg.n_layers} layers {cfg.dtype}: "
        f"per-client prefill (prompts {list(P18_LENGTHS)}, 1,500 frames a "
        f"row) max_abs_err={gaps[0]:.3e}; 8-row decode tick on pages "
        f"{gaps[1]:.3e}, on dense rows {gaps[2]:.3e}; kernels"
        f"{' (sgmv split)' if control else ''} vs plain"
        f"{'' if tol is None else f' at {tol}'}")
    top = max(float(t.float().abs().max()) for k, ts in out.items() if k[0]
              for t in ts)
    return gaps, top


def p18_pair(cfg, base, bank, label, tol=None):
    """18a's pair, kernels against plain, at ``tol``; at full depth (``tol``
    None) beside control (c), each gap held at ``P18_CONTROL`` x control
    (c)'s plus 4 bf16 ulps of the largest logit (bf16) or 1e-5 (fp32)."""
    gaps, top = p18_wiring(cfg, base, bank, tol, label)
    if tol is not None:
        return
    ctl, _ = p18_wiring(cfg, base, bank, None, f"{label} control (c)",
                        control="split")
    floor = 4 * 2.0 ** (int(np.frexp(top)[1]) - 8) \
        if cfg.dtype == "bfloat16" else F32_TOL["atol"]
    bound_ = [P18_CONTROL * c + floor for c in ctl]
    log(f"[{label}] {cfg.n_enc_layers}+{cfg.n_layers} layers {cfg.dtype}: "
        f"kernel gaps {gaps} against control (c)'s {ctl}; held at "
        f"{P18_CONTROL} x control (c) + {floor:.3e} = "
        f"{[round(b, 6) for b in bound_]}")
    if any(g > b for g, b in zip(gaps, bound_)):
        raise AssertionError(f"[{label}] gaps {gaps} past {bound_}")


def p18_decode(cfg, base, bank, caches, first, paged, live_of, label,
               check=True):
    """Decode the 8 rows from their prefill's greedy ``first`` tokens until
    each has its ``P18_NEW`` tokens: on pages the compacted step over all 8
    rows, finished rows and rows ``live_of`` leaves out masked; on dense
    rows the masked step. Every tick's launches are checked (the paged
    kernel 1 or the dense kernel 2 per decoder layer, SGMV q and v per
    decoder layer). Returns (streams [8][n], decode ms per tick)."""
    clients, slots = p18_rows()
    step = (symbiosis.make_compact_decode_step if paged else
            symbiosis.make_masked_decode_step)(cfg, P18_LORA,
                                               p18_scfg(paged))
    n = P18_CLIENTS * P18_SLOTS
    streams = [[int(first[i])] for i in range(n)]
    tok, times = first.to(torch.int32), []
    attn = "paged_decode_attn" if paged else "decode_attn"
    want = {k: 0 for k in KERNELS}
    want.update({attn: cfg.n_layers * (1 if paged else 2),
                 "sgmv": p18_per_call(cfg)})
    while True:
        live = [live_of(i) and len(streams[i]) < P18_NEW[i] for i in range(n)]
        if not any(live):
            break
        mask = torch.tensor(live, device=DEV)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        if paged:
            lg, _, caches = step(base, bank, caches, tok, clients, slots,
                                 mask)
        else:
            lg, caches = step(base, bank, caches,
                              tok.reshape(P18_CLIENTS, P18_SLOTS),
                              mask.reshape(P18_CLIENTS, P18_SLOTS))
            lg = lg.reshape(n, -1)
        tok = lg.argmax(-1).to(torch.int32)
        host = tok.cpu()
        times.append(time.perf_counter() - t0)
        if check and read_counts() != want:
            raise AssertionError(f"[{label}] a decode tick launched "
                                 f"{read_counts()}, want {want}")
        for i in range(n):
            if live[i]:
                streams[i].append(int(host[i]))
    return streams, times


def p18_gather_ms(cfg, caches):
    """The compacted decode's gather of 8 rows' per-slot leaves (the cross
    caches, ``symbiosis._gather_rows``): device ms (CUDA events, L2-cold)
    and the bytes it moves (each row's cross K and V read and written)."""
    clients, slots = p18_rows()
    axes = symbiosis.cache_slot_axes(cfg, P18_MAX_SEQ, page_block=P18_BLK)
    ms = time_ms(lambda: symbiosis._gather_rows(caches, axes, clients,
                                                slots), n=10)
    nbytes = 2 * sum(caches["layers"][n].nbytes for n in ("cross_k",
                                                            "cross_v"))
    return ms, nbytes


def phase18b(cfg, base, bank):
    """18b: the 8 prompts with their own frames prefilled per client on
    pages, compacted decode ticks until every row has its new tokens (12
    paged and 24 SGMV launches per tick, 48 SGMV per client prefill); every
    client's streams bit for bit its rows decoded alone (the other rows
    masked out: the same 8-row batch), the masked step bit for bit the
    compacted one; the dense layout's streams (the dense kernel) printed
    against the pages'; ``make_multi_client_prefill`` with frames over the
    dense bank; a traced tick, the cross-cache gather, and the caches'
    bytes against the router's charge per slot. Returns (streams, times,
    the kernels' timing fields at whisper's shapes)."""
    prompts, frames = p18_prompts(cfg)
    n = P18_CLIENTS * P18_SLOTS
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    lg, caches = p18_prefill(cfg, base, bank, prompts, frames, True)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    want = {k: 0 for k in KERNELS}
    want["sgmv"] = p18_per_call(cfg, prefill=True) * P18_CLIENTS
    if read_counts() != want:
        raise AssertionError(f"[phase 18b] the prefills launched "
                             f"{read_counts()}, want {want}")
    first = lg.argmax(-1)
    fresh = tree_clone(caches)
    ptrs = [t.data_ptr() for t in tree_leaves(caches)]
    streams, dec_t = p18_decode(cfg, base, bank, caches, first, True,
                                lambda i: True, "phase 18b")
    if [t.data_ptr() for t in tree_leaves(caches)] != ptrs:
        raise AssertionError("[phase 18b] a cache tensor moved")
    for c in range(P18_CLIENTS):
        alone, _ = p18_decode(cfg, base, bank, tree_clone(fresh), first,
                              True, lambda i, c=c: i // P18_SLOTS == c,
                              "phase 18b")
        for s in range(P18_SLOTS):
            i = c * P18_SLOTS + s
            if alone[i] != streams[i]:
                raise AssertionError(f"[phase 18b] row {i}'s stream differs "
                                     "from its client decoded alone")
    # the masked step is the compacted one over every row: bit for bit
    clients, slots = p18_rows()
    live = torch.tensor([i % 3 != 1 for i in range(n)], device=DEV)
    a, b = tree_clone(fresh), tree_clone(fresh)
    lm, a = symbiosis.make_masked_decode_step(cfg, P18_LORA, p18_scfg(True))(
        base, bank, a, first.to(torch.int32).reshape(P18_CLIENTS, P18_SLOTS),
        live.reshape(P18_CLIENTS, P18_SLOTS))
    lc, _, b = symbiosis.make_compact_decode_step(cfg, P18_LORA,
                                                  p18_scfg(True))(
        base, bank, b, first.to(torch.int32), clients, slots, live)
    if not (torch.equal(lm.reshape(n, -1)[live], lc[live])
            and trees_equal(a, b)):
        raise AssertionError("[phase 18b] the masked step differs from the "
                             "compacted one")
    log(f"[phase 18b] {cfg.name}: 4 LoRA r8 tenants (q, v) x 2 slots, 8 "
        f"decoder prompts of {list(P18_LENGTHS)} tokens, each with its own "
        f"1,500 stub frames: per-client prefills {pre_s * 1e3:.1f} ms "
        f"(sgmv {want['sgmv']} launches, nothing else), then "
        f"{len(dec_t)} compacted decode ticks on pages of {P18_BLK} (rows "
        f"finish after {list(P18_NEW)} tokens; paged_decode_attn "
        f"{cfg.n_layers} and sgmv {p18_per_call(cfg)} launches per tick, "
        f"checked tick by tick); median tick "
        f"{statistics.median(dec_t) * 1e3:.3f} ms (host clock); every "
        f"client's streams equal its rows decoded alone, bit for bit; the "
        f"masked step equals the compacted one (logits and caches) bit for "
        f"bit; every cache tensor kept its data_ptr")
    del a, b
    # the dense layout: the same prefills on dense rows, the dense kernel
    lg_d, dense = p18_prefill(cfg, base, bank, prompts, frames, False)
    if not torch.equal(lg_d, lg):
        raise AssertionError("[phase 18b] dense prefill logits differ")
    dstreams, _ = p18_decode(cfg, base, bank, dense, first, False,
                             lambda i: True, "phase 18b dense")
    same = sum(x == y for s, t in zip(streams, dstreams)
               for x, y in zip(s, t))
    total = sum(len(s) for s in streams)
    diverge = [next((k for k, (x, y) in enumerate(zip(s, t)) if x != y),
                    None) for s, t in zip(streams, dstreams)]
    log(f"[phase 18b] the dense layout (the dense kernel, decode_attn "
        f"{2 * cfg.n_layers} and sgmv {p18_per_call(cfg)} launches per tick,"
        f" checked): {same} of {total} greedy tokens equal the pages'; the "
        f"first step each row differs: {diverge}")
    # the bank-wide prefill with frames over the dense bank (JAX's
    # make_multi_client_prefill): every row's first 4 tokens
    mc = symbiosis.init_client_caches(cfg, P18_CLIENTS, P18_SLOTS,
                                      P18_MAX_SEQ, device=DEV)
    toks4 = torch.stack([t[:, :4] for t, _ in prompts])
    torch.cuda.synchronize()
    reset_counts()
    lg4, mc = symbiosis.make_multi_client_prefill(cfg, P18_LORA,
                                                  p18_scfg(False))(
        base, bank, mc, {"tokens": toks4, "frames": frames})
    lg5, mc = symbiosis.make_multi_client_decode_step(cfg, P18_LORA,
                                                      p18_scfg(False))(
        base, bank, mc, lg4.argmax(-1).to(torch.int32))
    torch.cuda.synchronize()
    want = {k: 0 for k in KERNELS}
    want.update(sgmv=p18_per_call(cfg, prefill=True) + p18_per_call(cfg),
                decode_attn=2 * cfg.n_layers)
    if read_counts() != want or not (torch.isfinite(lg4).all()
                                     and torch.isfinite(lg5).all()):
        raise AssertionError(f"[phase 18b] multi-client prefill + decode: "
                             f"{read_counts()}, want {want}")
    log(f"[phase 18b] make_multi_client_prefill over the dense bank's 8 "
        f"rows (4-token prompts, frames [4, 2, 1500, 768]) and one "
        f"multi-client decode tick: {read_counts()}")
    del dense, mc
    # a traced tick (8 live rows) and the cross caches' gather
    a = tree_clone(fresh)
    step = symbiosis.make_compact_decode_step(cfg, P18_LORA, p18_scfg(True))
    all_live = torch.ones(n, dtype=torch.bool, device=DEV)
    tok = first.to(torch.int32)
    ticks = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(base, bank, a, tok, clients, slots, all_live)
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t0)
    med = statistics.median(ticks)
    with traced() as prof:
        step(base, bank, a, tok, clients, slots, all_live)
        torch.cuda.synchronize()
    busy_ms, n_kern, by_name = device_profile(prof)
    g_ms, g_bytes = p18_gather_ms(cfg, fresh)
    out = {"tick8_ms": med * 1e3, "gather_ms": g_ms, "gather_bytes": g_bytes}
    if n_kern:
        out.update(busy_ms=busy_ms, kernels=n_kern)
        log(f"[phase 18b] an 8-row compacted decode tick: {med * 1e3:.3f} ms "
            f"median of 5 (host clock), device busy {busy_ms:.3f} ms = "
            f"{100 * busy_ms / (med * 1e3):.1f}%; {n_kern} kernels; top:")
        for name, (k, d) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:8]:
            log(f"[phase 18b]   {d / 1e3:8.3f} ms  {k:5d}x  {name[:90]}")
    else:
        log(f"[phase 18b] an 8-row compacted decode tick: {med * 1e3:.3f} ms "
            "median; the profiler saw no device events: busy share not "
            "measured")
    log(f"[phase 18b] the tick's gather of the 8 rows' cross caches "
        f"(read only: gathered, never written back): {g_bytes:,} B moved "
        f"(read and written) in {g_ms:.3f} ms (CUDA events, L2-cold) = "
        f"{100 * g_ms / (med * 1e3):.1f}% of the tick; bound "
        f"{bound(g_bytes, 0)[0]:.3f} ms")
    fields = p18_kernel_times(cfg, fresh)
    del a, fresh, caches
    # the caches' bytes against the router's charge per slot
    charge = kvcache.cache_bytes(cfg, P18_MAX_SEQ, 1, page_block=P18_BLK)
    a = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    row = cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2 * a    # K + V a token
    made, leaves, held = p15_cache_held(
        lambda: symbiosis.init_client_caches(
            cfg, P18_CLIENTS, P18_SLOTS, P18_MAX_SEQ, page_block=P18_BLK,
            device=DEV), "init_client_caches (pages)", phase="phase 18b")
    tree = sum(t.nbytes for t in leaves)
    extra = made["pos"].nbytes + made["block_tbl"].nbytes
    log(f"[phase 18b] {held / n:,.0f} B held per slot; the router charges "
        f"{charge:,} B a slot = {cfg.n_frontend_tokens * row:,} (the cross "
        f"caches; predicted 55,296,000 at full size) + {row:,} (predicted "
        f"36,864) x {P18_MAX_SEQ} tokens; tree = {n} charges + {extra} B of "
        f"pos and block_tbl")
    if charge != (cfg.n_frontend_tokens + P18_MAX_SEQ) * row \
            or tree != n * charge + extra:
        raise AssertionError(f"[phase 18b] tree {tree} B, {n} charges of "
                             f"{charge} B")
    del made, leaves
    return streams, dec_t, out, fields


def p18_kernel_times(cfg, caches):
    """The three kernels at whisper's shapes, each held against its plain
    version and timed beside it, a library call and its bound: the paged
    kernel over 18b's pool (8 rows, K 12, G 1, hd 64), the dense kernel at
    [8, 512, 12, 64], and SGMV at din = dout = 768, rank 8 (decode, and an
    encoder and a decoder prefill's blocks)."""
    out = {}
    q, pools, tbl, pos = attn_rows(cfg, {
        "layers": {n: caches["layers"][n] for n in ("k", "v")},
        "block_tbl": caches["block_tbl"]}, P18_LENGTHS)
    pk, pv = pools["k"], pools["v"]
    B, K, _, hd = q.shape
    g = gen(181)
    compare("[phase 18e] paged_decode_attn whisper (kernel vs plain)",
            da.paged_decode_attn_cuda(q, pk, pv, tbl, pos),
            da.paged_decode_attn_plain(q.float(), pk.float(), pv.float(),
                                       tbl, pos), BF16_TOL)
    out["paged_decode_attn"] = time_attention(
        "paged_decode_attn whisper", lambda: da.paged_decode_attn_cuda(
            q, pk, pv, tbl, pos),
        lambda: da.paged_decode_attn_plain(q, pk, pv, tbl, pos),
        lambda: sdpa_over_pages(q, pk, pv, tbl, pos), q, tbl, pos,
        lambda tokens: 2 * tokens * K * hd * 2, phase="phase 18e")
    T = 512
    k = torch.randn((B, T, K, hd), generator=g, device=DEV).to(torch.bfloat16)
    v = torch.randn((B, T, K, hd), generator=g, device=DEV).to(torch.bfloat16)
    out["decode_attn"] = time_dense_decode(q, k, v, pos,
                                           "decode_attn whisper slab", [],
                                           phase="phase 18e")
    scale = P18_LORA.alpha / P18_LORA.rank
    r, d = P18_LORA.rank, cfg.d_model
    for name, (T, bt, ids) in (
            ("decode", (8, 1, [0, 0, 1, 1, 2, 2, 3, 3])),
            ("encoder prefill", (2 * cfg.n_frontend_tokens,
                                 cfg.n_frontend_tokens, [2, 2])),
            ("decoder prefill", (2 * 64, 64, [1, 1]))):
        A = (torch.randn((P18_CLIENTS, d, r), generator=g, device=DEV)
             / d ** 0.5).to(torch.bfloat16)
        Bw = (torch.randn((P18_CLIENTS, r, d), generator=g, device=DEV)
              * 0.05).to(torch.bfloat16)
        x = torch.randn((T, d), generator=g, device=DEV).to(torch.bfloat16)
        ids_t = torch.tensor(ids, dtype=torch.int32, device=DEV)
        row = ids_t.long().repeat_interleave(bt)

        def kernel():
            return sg.sgmv_cuda(x, A, Bw, ids_t, block_t=bt, scale=scale)

        def library():
            h = torch.bmm(x[:, None, :], A[row])
            return torch.bmm(h, Bw[row])[:, 0] * scale

        err = compare(f"[phase 18e] sgmv {name} (kernel vs plain)", kernel(),
                      sg.sgmv_plain(x.float(), A.float(), Bw.float(), ids_t,
                                    block_t=bt, scale=scale), BF16_TOL)
        nbytes = 2 * (T * d + len(set(ids)) * r * 2 * d + T * d) \
            + 4 * len(ids)
        out[f"sgmv {name}"] = timing_fields(
            f"sgmv whisper {name} T={T} block_t={bt} din=dout={d} r={r} "
            f"(max_abs_err {err:.3e} vs plain)", kernel,
            lambda: sg.sgmv_plain(x, A, Bw, ids_t, block_t=bt, scale=scale),
            library, nbytes, 4 * T * r * d, f"[{T}, {d}]", phase="phase 18e")
    return out


def p18_jobs(cfg, n, steps, first_seed, acfg=P18_LORA):
    """``n`` jobs of ``acfg`` over 2 x ``P18_TRAIN_S`` decoder tokens, each
    row with its 1,500 stub frames."""
    return [FinetuneJob(acfg=acfg, batch_size=2, seq_len=P18_TRAIN_S,
                        steps=steps, lr=1e-3, warmup_steps=1,
                        seed=first_seed + i,
                        name=f"whisper-{first_seed + i}",
                        data=make_job_stream(cfg, 2, P18_TRAIN_S,
                                             seed=first_seed + i, device=DEV))
            for i in range(n)]


def p18_encoder_ms(cfg, base, rows):
    """Device ms of the encoder alone over ``rows`` x 1,500 frames with a
    LoRA on q and v requiring grad: forward, and forward plus backward
    (every layer recomputed), CUDA events, L2-cold."""
    from repro_torch.models import encdec
    frames = frontend_stub(cfg, 1, rows, generator=gen(183),
                           device=DEV)["frames"][0]
    ad = tree_map(lambda t: t[0].detach().requires_grad_(True),
                  random_lora(cfg, 1, 184, P18_LORA))
    ctx = make_client_ctx(cfg, P18_LORA)
    leaves = tree_leaves(ad["enc_layers"])

    def fwd():
        with torch.no_grad():
            encdec.encode(cfg, base, frames, ctx, ad)

    def fwd_bwd():
        with torch.enable_grad():
            out = encdec.encode(cfg, base, frames, ctx, ad)
            torch.autograd.grad(out.float().sum(), leaves)
    return time_ms(fwd, n=3), time_ms(fwd_bwd, n=3)


def p18_memory(cfg, base, job):
    """Peak device memory beyond base and bank of one bank step at 1 and 4
    jobs (2 x 128 tokens and 1,500 frames a row, remat off), each under
    ``job_charge_bytes``."""
    charge = job_charge_bytes(cfg, job)
    step = symbiosis.make_compact_train_step(cfg, job.acfg, remat=False)

    def peak(R):
        bank = random_lora(cfg, R, 185, job.acfg)
        opt = AdamWState(step=torch.zeros(R, dtype=torch.int32, device=DEV),
                         m=tree_map(torch.zeros_like, bank),
                         v=tree_map(torch.zeros_like, bank))
        batch = p16_batches(cfg, R, 186, seq=P18_TRAIN_S, batch=2)
        args = (torch.arange(R, dtype=torch.int32, device=DEV),
                torch.ones(R, dtype=torch.bool, device=DEV), step7a_hyper(R))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step(base, bank, opt, batch, *args)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - before

    peaks = {R: peak(R) for R in (1, 4)}
    torch.cuda.empty_cache()
    log(f"[phase 18c] peak device memory beyond base and bank, one bank "
        f"step (2 x {P18_TRAIN_S} tokens and 2 x 1,500 frames a job, remat "
        f"off), GB: 1 job {peaks[1] / 1e9:.3f}, 4 jobs {peaks[4] / 1e9:.3f}; "
        f"charge per job {charge / 1e9:.3f} (job_hbm_bytes "
        f"{job_hbm_bytes(cfg, job) / 1e9:.3f}, activations "
        f"{job_activation_bytes(cfg, job) / 1e9:.3f})")
    for R, p in peaks.items():
        if p > R * charge:
            raise AssertionError(f"[phase 18c] {R} job(s) peak at {p} B, "
                                 f"above the charge {R * charge} B")
    return peaks


def phase18c(cfg, base):
    """18c: a FinetuneEngine of 4 LoRA jobs (q, v; 2 x 128 tokens, 1,500
    frames a row) behind a router sized by ``job_charge_bytes`` that holds
    a fifth back: tick times, one tick traced, the encoder's share of it,
    the peaks at 1 and 4 jobs under the charge."""
    jobs = p18_jobs(cfg, 4, P18_STEPS, 80) + p18_jobs(cfg, 1, 2, 84)
    charge = job_charge_bytes(cfg, jobs[0])
    router = PlacementRouter(cfg, [Slot(0, free_hbm=4.5 * charge)])
    eng = FinetuneEngine(EngineSpec(cfg=cfg, finetune=FinetuneConfig()), base,
                         device=DEV, router=router)
    for j in jobs:
        eng.submit(j)
    ticks = []
    for _ in range(P18_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.train_tick()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t0)
    with traced() as prof:
        eng.train_tick()
        torch.cuda.synchronize()
    if eng.stats["peak_jobs"] != 4 or jobs[4].status != "queued":
        raise AssertionError(f"[phase 18c] peak {eng.stats['peak_jobs']}, "
                             f"job 4 {jobs[4].status}")
    eng.run()
    if any(j.status != "finished" for j in jobs) or not all(
            np.isfinite(j.losses).all() for j in jobs):
        raise AssertionError(f"[phase 18c] {[j.status for j in jobs]} "
                             f"{[j.losses for j in jobs]}")
    used = router.utilization()
    if router.conservation_errors() or used["committed_bytes"]:
        raise AssertionError(f"[phase 18c] router after the drain: {used}")
    med = statistics.median(ticks[1:])
    log(f"[phase 18c] {cfg.name}: 5 LoRA r8 jobs (q, v; 2 x {P18_TRAIN_S} "
        f"tokens, 1,500 frames a row), router slot {4.5 * charge:.0f} B for "
        f"charges of {charge} B: 4 rows for {P18_STEPS} ticks, job 4 after; "
        f"stats {eng.stats}; losses "
        f"{[[round(x, 4) for x in j.losses] for j in jobs]}")
    log(f"[phase 18c] 4-row train tick (host clock, synchronised): "
        f"{[round(t * 1e3, 3) for t in ticks]} ms; median of "
        f"{len(ticks) - 1} after the first {med * 1e3:.3f} ms, "
        f"{8 * P18_TRAIN_S / med:.0f} decoder tokens/s")
    busy_ms, n_kern, by_name = device_profile(prof)
    enc_f, enc_fb = p18_encoder_ms(cfg, base, 8)
    log(f"[phase 18c] the encoder alone at the tick's shapes (8 rows x "
        f"1,500 frames, 12 layers, CUDA events, L2-cold): forward "
        f"{enc_f:.2f} ms, forward + backward (layers recomputed) "
        f"{enc_fb:.2f} ms = {100 * enc_fb / (med * 1e3):.1f}% of the "
        f"unprofiled tick")
    if n_kern:
        log(f"[phase 18c] one traced 4-row tick: device busy {busy_ms:.3f} "
            f"ms = {100 * busy_ms / (med * 1e3):.1f}% of the unprofiled "
            f"median; {n_kern} kernels; top kernels:")
        for name, (k, d) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:8]:
            log(f"[phase 18c]   {d / 1e3:8.3f} ms  {k:5d}x  {name[:90]}")
    else:
        log("[phase 18c] the profiler saw no device events: device busy not "
            "measured")
    del eng, prof
    gc.collect()
    peaks = p18_memory(cfg, base, jobs[0])
    return {"tick_ms": med * 1e3, "encoder_fwd_ms": enc_f,
            "encoder_fwd_bwd_ms": enc_fb, "busy_ms": busy_ms,
            "kernels": n_kern, "peaks": peaks, "charge": charge}


def phase18():
    """The encoder-decoder family on the serving steps and in fine-tuning:
    whisper-small at full width and depth (12 + 12 layers, d 768, 1,500
    stub frames, vocab 51,865; 304.3 M params, ~0.6 GB bf16), 4 LoRA r8
    tenants on q and v. 18a kernels against plain at 1 + 1 layers (bf16
    and fp32) and 12 + 12 (bf16 and fp32, beside control (c)); 18b serving;
    18c fine-tuning, then 2-row IA3 and prefix banks at 1 + 1 layers fp32;
    18d a killed engine resumed; 18e the kernels at whisper's shapes."""
    cfg = p18_config()
    t0 = time.perf_counter()
    base, bank = make_system(cfg, P18_CLIENTS, seed=18, acfg=P18_LORA)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(base))
    log(f"[phase 18] {cfg.name}: {cfg.n_enc_layers} encoder + "
        f"{cfg.n_layers} decoder layers (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
        f"{cfg.n_frontend_tokens} frames, vocab {cfg.vocab}), "
        f"{n_params / 1e6:.1f} M params bf16 initialised in "
        f"{time.perf_counter() - t0:.1f} s; LoRA r8 on q and v")
    t = time.perf_counter()
    two = p18_config(1, 1)
    base2 = dict(base, enc_layers=base["enc_layers"][:1],
                 dec_layers=base["dec_layers"][:1])
    bank2 = {k: tree_map(lambda x: x[:, :1], v) for k, v in bank.items()}
    p18_pair(two, base2, bank2, "phase 18a", tol=BF16_TOL)
    p18_pair(cfg, base, bank, "phase 18a")
    log(f"[phase 18a] bf16 done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    streams, dec_t, tick, fields = phase18b(cfg, base, bank)
    free_device("phase 18")
    log(f"[phase 18b/e] done ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    train = phase18c(cfg, base)
    free_device("phase 18")
    phase16d(cfg, base, jobs=lambda: p18_jobs(cfg, 2, 3, 95),
             phase="phase 18d", what="LoRA jobs (q, v)")
    log(f"[phase 18c/d] full depth done ({time.perf_counter() - t:.1f} s)")
    del base, bank, base2, bank2
    free_device("phase 18")
    t = time.perf_counter()
    cfg32 = p18_config(dtype="float32")
    base32, bank32 = make_system(cfg32, P18_CLIENTS, seed=18, acfg=P18_LORA)
    bank32 = tree_map(lambda x: x.float(), bank32)
    p18_pair(cfg32, base32, bank32, "phase 18a")
    two32 = p18_config(1, 1, dtype="float32")
    base2 = dict(base32, enc_layers=base32["enc_layers"][:1],
                 dec_layers=base32["dec_layers"][:1])
    p18_pair(two32, base2, {k: tree_map(lambda x: x[:, :1], v)
                            for k, v in bank32.items()}, "phase 18a",
             tol=F32_TOL)
    del bank32
    for label, acfg in (("IA3 k/v/down", P16_IA3),
                        ("prefix (16 tokens)", P10_ACFGS["prefix"])):
        p17_rows(two32, base2, acfg, random_bank(two32, acfg, 2, 187), label,
                 phase="phase 18c")
    del base32, base2
    free_device("phase 18")
    log(f"[phase 18a/c] fp32 done ({time.perf_counter() - t:.1f} s)")
    return fields, tick, train


# ---------------------------------------------------------------------------
# phase 19: activation privacy (§3.8) and the hot-path contracts
# ---------------------------------------------------------------------------

P19_SCALE, P19_VARIANTS, P19_VARIANT = 3.0, 2, 1   # bench_privacy's noise
P19_SHAPE = (2, 128)     # 19a's forward: [batch, tokens]
P19_DECODE = 16          # 19a's greedy decode steps after a paged prefill
# 19a: in bf16 at 40 layers the private forward's cancellation rounds. The
# gap of the private bf16 logits from the plain bf16 logits is held at
# P19_CONTROL times the control, the plain bf16 logits' gap from the same
# path run in fp32 (the rounding of the whole bf16 path at this depth),
# plus 4 bf16 ulps of the largest logit. The noise (scale 3, against
# unit-RMS normed activations) makes the q and v products' noisy input,
# noisy output and noise effect each ~3x the plain values, so their bf16
# roundings add ~sqrt(1 + 3 x 3^2) = 5.3 plain roundings on 2 of 7
# products a layer; the CPU rehearsal (3 layers, d 256, bf16) read 5.0x
# and 6.4x the control. 8x is the margin, stated before the first run on
# the card.
P19_CONTROL = 8.0
P19_F32_TOL = dict(atol=2e-3, rtol=2e-3)    # JAX's tests/test_privacy.py:65


def p19_forward(cfg, base, adapter, tokens, noise=None):
    """The model's forward with client 0's adapter, through the private
    context when ``noise`` is given (variant ``P19_VARIANT``)."""
    ctx = make_client_ctx(cfg, LORA, privacy_noise=noise,
                          privacy_variant=P19_VARIANT)
    with torch.inference_mode():
        return get_model(cfg).forward(base, {"tokens": tokens}, ctx, adapter)


def p19_decode(cfg, base, adapter, prompt, noise=None, feed=None):
    """A paged prefill of ``prompt`` and ``P19_DECODE`` greedy decode steps
    (``feed``: the tokens to decode instead), the private context when
    ``noise`` is given. One client: its LoRA is the context's ``bmm`` pair,
    so each decode step launches the paged attention kernel once per layer
    and nothing else. Returns (logits [steps + 1, 1, V], fed tokens)."""
    L, model = cfg.n_layers, get_model(cfg)
    ctx = make_client_ctx(cfg, LORA, privacy_noise=noise,
                          privacy_variant=P19_VARIANT)
    cache = model.init_cache(1, prompt.shape[1] + P19_DECODE + 8,
                             page_block=16, device=DEV)
    fed = [] if feed is None else [torch.tensor([t], dtype=torch.int32,
                                                device=DEV) for t in feed]
    torch.cuda.synchronize()
    reset_counts()
    with torch.inference_mode():
        lg, cache = model.prefill(base, {"tokens": torch.tensor(
            prompt, dtype=torch.int32, device=DEV)}, cache, ctx, adapter)
        lgs = [lg]
        for step in range(P19_DECODE):
            if feed is None:
                fed.append(lg.argmax(-1).to(torch.int32))
            lg, cache = model.decode_step(base, cache, fed[step], ctx,
                                          adapter)
            lgs.append(lg)
    torch.cuda.synchronize()
    want = {n: 0 for n in KERNELS}
    want["paged_decode_attn"] = L * P19_DECODE
    if read_counts() != want:
        raise AssertionError(f"[phase 19a] launches {read_counts()}, want "
                             f"{want}")
    out = torch.stack(lgs)
    if not torch.isfinite(out).all():
        raise AssertionError("[phase 19a] non-finite logits")
    return out, [int(t[0]) for t in fed]


def p19_bound(what, private, plain, control):
    """The private bf16 logits against the plain bf16 ones, held at
    ``P19_CONTROL`` x the plain ones' gap from fp32 ``control`` plus 4 bf16
    ulps of the largest logit; returns the gap and its bound."""
    gap = float((private.float() - plain.float()).abs().max())
    ctl = float((plain.float() - control.float()).abs().max())
    big = float(plain.float().abs().max())
    ulp = float(torch.ldexp(torch.tensor(1.0),
                            torch.frexp(torch.tensor(big))[1] - 8))
    bound = P19_CONTROL * ctl + 4 * ulp
    if not (torch.isfinite(private).all() and gap <= bound):
        raise AssertionError(f"[phase 19a] {what}: private vs plain bf16 gap "
                             f"{gap:.4e} past {P19_CONTROL} x control "
                             f"{ctl:.4e} + 4 ulps ({4 * ulp:.4e}) = "
                             f"{bound:.4e}")
    log(f"[phase 19a] {what}: private vs plain logits max_abs_err {gap:.4e} "
        f"({gap / ulp:.1f} bf16 ulps of the largest logit {big:.3f}); control "
        f"(plain bf16 vs fp32) {ctl:.4e}; bound {P19_CONTROL} x control + 4 "
        f"ulps = {bound:.4e}: held")
    return gap, bound


def p19_privacy(cfg, base, bank):
    """19a: client 0's LoRA r8 (q, v) through the §3.8 protocol at full
    width: 2 noise variants at scale 3.0 on q and v."""
    L, d = cfg.n_layers, cfg.d_model
    adapter = tree_map(lambda x: x[0], bank)
    dims = {"q": (d, cfg.hp * cfg.hd), "v": (d, cfg.n_kv_heads * cfg.hd)}
    noise = privacy.make_noise(gen(190), dims, P19_VARIANTS, P19_SCALE)
    pre_ms = time_ms(lambda: attach_privacy(adapter, cfg, base, noise), n=10,
                     l2_cold=False)
    priv_ad = attach_privacy(adapter, cfg, base, noise)
    entries = priv_ad["layers"]["_priv"]
    nbytes = sum(t.numel() * t.element_size() for e in entries
                 for t in e.values())
    want_bytes = (L * P19_VARIANTS * sum(o for _, o in dims.values())
                  * base["layers"][0]["attn"]["wq"].element_size())
    if len(entries) != L or nbytes != want_bytes:
        raise AssertionError(f"[phase 19a] _priv: {len(entries)} layers, "
                             f"{nbytes} B, predicted {want_bytes} B")
    rng = np.random.default_rng(190)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, P19_SHAPE),
                          dtype=torch.int32, device=DEV)
    plain = p19_forward(cfg, base, adapter, tokens)
    priv = p19_forward(cfg, base, priv_ad, tokens, noise)
    ms = [time_ms(lambda: p19_forward(cfg, base, *a), n=10, l2_cold=False)
          for a in ((adapter, tokens), (priv_ad, tokens, noise),
                    (priv_ad, tokens, noise), (adapter, tokens))]
    log(f"[phase 19a] {cfg.name}, {L} layers bf16, client 0's LoRA r8 (q, "
        f"v), {P19_VARIANTS} noise variants at scale {P19_SCALE} on q and v: "
        f"noise_effect precompute {pre_ms:.3f} ms; _priv {nbytes:,} B per "
        f"client (predicted {want_bytes:,}); forward {list(P19_SHAPE)} ms "
        f"plain / private / private / plain {ms[0]:.3f} / {ms[1]:.3f} / "
        f"{ms[2]:.3f} / {ms[3]:.3f} (overhead "
        f"{((ms[1] + ms[2]) / (ms[0] + ms[3]) - 1) * 100:.1f}%)")
    prompt = make_requests(cfg, 4)[0].prompt
    priv_lg, toks = p19_decode(cfg, base, priv_ad, prompt, noise)
    alone, toks_plain = p19_decode(cfg, base, adapter, prompt)
    plain_lg, _ = p19_decode(cfg, base, adapter, prompt, feed=toks)
    same = next((i for i, (a, b) in enumerate(zip(toks, toks_plain))
                 if a != b), len(toks))
    log(f"[phase 19a] a paged prefill of phase 4's first prompt "
        f"({prompt.shape[1]} tokens) and {P19_DECODE} greedy decode steps "
        f"through the private context: paged attention {L} launches a step, "
        f"nothing else; the greedy stream equals the plain run's for "
        f"{same} of {P19_DECODE} tokens")
    del alone
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    base32 = tree_map(lambda t: t.float(), base)
    ad32 = tree_map(lambda t: t.float(), adapter)
    p19_bound(f"forward {list(P19_SHAPE)}", priv, plain,
              p19_forward(cfg32, base32, ad32, tokens))
    ctl_lg, _ = p19_decode(cfg32, base32, ad32, prompt, feed=toks)
    p19_bound(f"prefill + {P19_DECODE} decode steps (fed the private run's "
              "tokens)", priv_lg, plain_lg, ctl_lg)
    del base32, ad32, priv, plain, priv_lg, plain_lg, ctl_lg
    torch.cuda.empty_cache()

    cfg2 = f32_granite(2)
    base2 = get_model(cfg2).init_params(gen(191), DEV)
    ad2 = tree_map(lambda x: x[0], random_lora(cfg2, 1, 192))
    noise2 = privacy.make_noise(gen(193), dims, P19_VARIANTS, P19_SCALE)
    e = compare("[phase 19a] fp32 2 layers private vs plain",
                p19_forward(cfg2, base2, attach_privacy(ad2, cfg2, base2,
                                                        noise2), tokens,
                            noise2),
                p19_forward(cfg2, base2, ad2, tokens), P19_F32_TOL)
    log(f"[phase 19a] {cfg.name} width, 2 layers, fp32 (TF32 off): private "
        f"vs plain logits max_abs_err {e:.3e} at {P19_F32_TOL} (JAX's bound)")
    del base2
    torch.cuda.empty_cache()


def p19_dispatch_cost(eng, n=2000):
    """Host microseconds of one ``tracecount.dispatch`` of an 8-row
    compacted decode's arguments (base, bank, caches and the row tensors)
    to a step that does nothing, under a guard, beyond the plain call
    (one dispatch per decode tick; attached telemetry computes the same
    signature)."""
    nb = 8
    args = (eng.base, eng._bank_arg(), eng.caches, *eng._on_device(
        np.zeros(nb, np.int32), np.zeros(nb, np.int32),
        np.zeros(nb, np.int32), np.ones(nb, bool)))

    def noop(*a):
        return None

    t0 = time.perf_counter()
    for _ in range(n):
        noop(*args)
    plain = (time.perf_counter() - t0) / n * 1e6
    with tracecount.guard("phase 19b cost"):
        tracecount.dispatch(eng, "compact_decode", nb, noop, *args)
        t0 = time.perf_counter()
        for _ in range(n):
            tracecount.dispatch(eng, "compact_decode", nb, noop, *args)
        cost = (time.perf_counter() - t0) / n * 1e6 - plain
    return cost, len(tree_leaves(args))


def p19_guard(cfg, base, bank, streams4):
    """19b: phase 4's 8 requests under ``tracecount.guard`` with telemetry,
    then an ``admit_bank`` of one more LoRA client with one request, then
    ``retire_bank``."""
    spec = serve_spec(cfg, quant=False)
    paged = ("paged_decode_attn", "paged_decode_attn_quant", "sgmv")
    obs = Obs()
    with tracecount.guard("phase 19b") as g:
        reqs, eng, launches, _, ticks, _ = p12_run(cfg, base, bank, spec, obs)
        same_streams("phase 19b", reqs, streams4, "phase 4's")
        same_launches("phase 19b", launches, "phase 4", paged)
        adm = eng.admit_bank(LORA, random_lora(cfg, 1, 194))
        rng = np.random.default_rng(194)
        late = Request(client_id=adm.client_ids[0], max_new_tokens=16,
                       prompt=rng.integers(0, cfg.vocab, (1, 100))
                       .astype(np.int32))
        eng.submit(late)
        eng.run()
        eng.retire_bank(adm)
    torch.cuda.synchronize()
    res = g.result()
    if late.status != "ok" or late.generated.shape != (1, 16):
        raise AssertionError(f"[phase 19b] the admitted bank's request: "
                             f"{late.status}")
    if not res.ok:
        raise AssertionError("[phase 19b] guard violations: " + "; ".join(
            v.message for v in res.violations))
    domain = eng.trace_domain()
    outside = [(f, k) for (_, _, f, k) in g._compiled
               if domain.check(f, k) != tracecount.OK]
    events = [e for e in obs.events.peek()
              if e.kind in ("compile", "recompile")]
    counted = sum(r["value"] for r in obs.metrics.samples()
                  if r["metric"] == "jit_compiles_total")
    if outside or any(e.kind != "compile" for e in events) \
            or counted != res.checked["compiles"] or eng._trace_epoch != 1:
        raise AssertionError(f"[phase 19b] outside the domain {outside}; "
                             f"events {[e.kind for e in events]}; "
                             f"jit_compiles_total {counted} against the "
                             f"guard's {res.checked['compiles']}; epoch "
                             f"{eng._trace_epoch}")
    log(f"[phase 19b] phase 4's 8 requests, an admit_bank of 1 LoRA client "
        f"with 1 request, retire_bank, under tracecount.guard with "
        f"telemetry: 0 violations; {res.checked['calls']} step calls, "
        f"{res.checked['compiles']} compiles (= jit_compiles_total), each "
        f"(family, key) in trace_domain(); every stream phase 4's bit for "
        f"bit and the launches phase 4's tick by tick; median service tick "
        f"without admission {statistics.median(ticks) * 1e3:.3f} ms")
    log("[phase 19b] compile events (family key, epoch by bank_growth): "
        + ", ".join(f"{dict(e.data)['family']} {dict(e.data)['key']}"
                    for e in events))
    cost, n_leaves = p19_dispatch_cost(eng)
    log(f"[phase 19b] dispatch's host cost on this host under a guard, over "
        f"an 8-row compacted decode's {n_leaves} argument leaves (one "
        f"dispatch per decode tick), beyond the plain call: {cost:.1f} us")


def p19_contracts(cfg, base, bank):
    """19c: ``runner.run_all`` over ``all_targets()`` on the card, then the
    isolation, in-place and frozen-base checks at full width."""
    t0 = time.perf_counter()
    results = runner.run_all(device=DEV)
    bad = [(r.pass_name, r.target, [v.message for v in r.violations])
           for r in results if not r.ok]
    if bad:
        raise AssertionError(f"[phase 19c] run_all: {bad}")
    log(f"[phase 19c] repro_torch.analysis run_all on the card: "
        f"{len(results)} pass runs over {len({r.target for r in results})} "
        f"targets "
        f"(dense, hybrid, RWKV, enc-dec serving; dense, MoE, hybrid, RWKV, "
        f"enc-dec training), all ok ({time.perf_counter() - t0:.1f} s)")

    C, B, max_seq, blk = 4, 2, 512, 16
    scfg = ServeConfig(n_clients=C, max_seq=max_seq, page_block=blk)
    kw = symbiosis.serve_cache_kwargs(cfg, scfg)
    caches = symbiosis.init_client_caches(cfg, C, B, max_seq, device=DEV,
                                          **kw)
    n_blocks = max_seq // blk
    P = B * n_blocks
    caches["block_tbl"] = (torch.arange(C * B * n_blocks, dtype=torch.int32,
                                        device=DEV)
                           .reshape(C, B, n_blocks))  # client c: [c*P, ...)
    step = symbiosis.make_compact_decode_step(cfg, LORA, scfg)
    clients = torch.arange(C, dtype=torch.int32, device=DEV) \
        .repeat_interleave(B)
    slots = torch.arange(B, dtype=torch.int32, device=DEV).repeat(C)
    toks = torch.tensor(np.random.default_rng(195).integers(
        0, cfg.vocab, C * B), dtype=torch.int32, device=DEV)
    extra = (toks, clients, slots, torch.ones(C * B, dtype=torch.bool,
                                              device=DEV))
    reset_counts()
    iso = taint.check_client_isolation(
        lambda *a: (lambda o: (o[0], o[-1]))(step(*a)), base, bank, caches,
        extra, clients=clients.tolist(), victim=0, pool_pages=P,
        page_axes=symbiosis.cache_page_axes(cfg, max_seq, **kw),
        slot_axes=dict(symbiosis.cache_slot_axes(cfg, max_seq, **kw),
                       block_tbl=0), target="granite compact decode")
    args = (base, bank, caches) + extra
    checks = [iso,
              aliasing.check_in_place(step, args, state={2: 2},
                                      target="granite compact decode"),
              taint.check_frozen_base(step, args, update_argnums=(2,),
                                      target="granite compact decode")]
    n = read_counts()
    if n["paged_decode_attn"] != 4 * cfg.n_layers or \
            n["sgmv"] != 4 * 2 * cfg.n_layers:
        raise AssertionError(f"[phase 19c] the decode checks launched {n}")

    cfg2 = f32_granite()
    base2 = get_model(cfg2).init_params(gen(196), DEV)
    cap, R = 8, 4
    bank2 = random_lora(cfg2, cap, 197)
    opt2 = AdamWState(step=torch.arange(cap, dtype=torch.int32, device=DEV),
                      m=tree_map(lambda x: torch.randn_like(x) * 1e-3, bank2),
                      v=tree_map(lambda x: torch.rand_like(x) * 1e-6, bank2))
    targs = (base2, bank2, opt2, train_batches(cfg2, R, 198),
             torch.tensor([5, 2, 7, 0], dtype=torch.int32, device=DEV),
             torch.ones(R, dtype=torch.bool, device=DEV), step7a_hyper(R))
    tstep = symbiosis.make_compact_train_step(cfg2, LORA, remat=False)
    checks += [
        taint.check_row_isolation(tstep, targs, perturb_row=1,
                                  victim_slot=2, perturb_argnums=(3, 6),
                                  target="granite 2-layer compact train"),
        aliasing.check_in_place(tstep, targs, state={1: 0, 2: 1},
                                target="granite 2-layer compact train"),
        taint.check_frozen_base(tstep, targs, update_argnums=(1, 2),
                                target="granite 2-layer compact train")]
    bad = [(r.pass_name, r.target, [v.message for v in r.violations])
           for r in checks if not r.ok]
    if bad:
        raise AssertionError(f"[phase 19c] full width: {bad}")
    log("[phase 19c] full width, with the kernels: " + "; ".join(
        f"{r.pass_name} @ {r.target} ok "
        f"({', '.join(f'{k}={v}' for k, v in r.checked.items())})"
        for r in checks))
    del base2, bank2, opt2, targs, caches
    torch.cuda.empty_cache()


def phase19(cfg, base, bank, streams4):
    """Activation privacy (19a), the bucket guard (19b) and the contracts
    (19c), on phase 4's base and bank."""
    for label, fn, args in (("19a", p19_privacy, (cfg, base, bank)),
                            ("19b", p19_guard, (cfg, base, bank, streams4)),
                            ("19c", p19_contracts, (cfg, base, bank))):
        t = time.perf_counter()
        fn(*args)
        log(f"[phase {label}] done ({time.perf_counter() - t:.1f} s)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    log(f"[phase 1] torch {torch.__version__} CUDA {torch.version.cuda} on "
        f"{kind}")
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 comparisons
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    reports = _build.build(sorted({Path(src).stem
                                   for _, src, _ in KERNELS.values()}))
    for name, rep in reports.items():
        entry = ""                    # the mangled instantiation reported on
        for line in rep.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "registers" in line or "spill" in line:
                log(f"[phase 1] {name} {entry}: {line.strip()}")
    log(f"[phase 1] built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    errs = {name: [] for name in KERNELS}
    check_paged(errs["paged_decode_attn"])
    check_paged_quant(errs["paged_decode_attn_quant"])
    check_sgmv(errs["sgmv"])
    check_dense(errs["decode_attn"])
    check_flash(errs["flash_attn"])
    check_ragged(errs["ragged_linear"])
    torch.cuda.empty_cache()
    log(f"[phase 2] kernels agree with their plain versions "
        f"({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    model_wiring(quant=False)
    model_wiring(quant=True)
    dense_wiring()
    torch.cuda.empty_cache()
    log(f"[phase 3] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    (launches, cfg, caches, base, bank, lengths, first, times4,
     streams4) = serve_full()
    log(f"[phase 4] done ({time.perf_counter() - t:.1f} s)")
    launches4 = dict(launches)
    t = time.perf_counter()
    launches_q, caches_q, lengths_q, streams4b = serve_quant(
        cfg, base, bank, first, times4)
    launches["paged_decode_attn_quant"] = launches_q["paged_decode_attn_quant"]
    log(f"[phase 4b] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    timings = {"paged_decode_attn": time_decode_attn(cfg, caches, lengths),
               "paged_decode_attn_quant": time_decode_attn_quant(
                   cfg, caches_q, lengths_q),
               "sgmv": time_sgmv(bank)}
    del caches, caches_q
    torch.cuda.empty_cache()
    timings.update(time_unserved(base, lengths, errs["decode_attn"]))
    log(f"[phase 5] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    launches.update(phase6(cfg, base))
    log(f"[phase 6] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    peaks7 = phase7(cfg, base, bank, streams4, launches4, times4)
    log(f"[phase 7] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    phase8(cfg, base, times4)
    log(f"[phase 8] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    launches["decode_attn"] = phase9(cfg, base, bank, streams4, times4)
    log(f"[phase 9] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    peaks10 = phase10(cfg, base, bank, streams4, launches4)
    log(f"[phase 10] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    phase11(cfg, base, bank, streams4, launches4, streams4b, launches_q,
            peaks7, peaks10)
    log(f"[phase 11] done ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    phase12(cfg, base, bank, streams4, streams4b)
    log(f"[phase 12] done ({time.perf_counter() - t:.1f} s)")
    free_device("phase 12")

    t = time.perf_counter()
    phase19(cfg, base, bank, streams4)
    log(f"[phase 19] done ({time.perf_counter() - t:.1f} s)")
    del base, bank
    free_device()

    t = time.perf_counter()
    phase13()
    log(f"[phase 13] done ({time.perf_counter() - t:.1f} s)")
    free_device()

    t = time.perf_counter()
    phase15()
    log(f"[phase 15] done ({time.perf_counter() - t:.1f} s)")
    free_device("phase 15")

    t = time.perf_counter()
    phase17()
    log(f"[phase 17] done ({time.perf_counter() - t:.1f} s)")
    free_device("phase 17")

    t = time.perf_counter()
    phase18()
    log(f"[phase 18] done ({time.perf_counter() - t:.1f} s); total "
        f"{time.perf_counter() - t_start:.1f} s")

    # launches: phase 4's counts, phase 4b's for the int8 kernel, phase 9a's
    # for the dense decode kernel (its serving path) and phase 6's for the
    # kernels no serving path runs (each the path that runs the kernel,
    # counted from 0 over that path alone)
    summary = [dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches[name], max_abs_err=max(errs[name]),
                    **timings[name])
               for name, (_, src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
