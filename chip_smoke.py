#!/usr/bin/env python3
"""On-card smoke run of the torch port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit, and the card's instruction rate per class (SMs x the
   class's results per clock per SM x the maximum SM clock that
   ``nvidia-smi`` reports) that the kernels' bounds use;
2. build: compiles ``csrc/occur.cu``, ``sketch.cu``, ``bitops.cu``,
   ``bernoulli.cu``, ``membership.cu``, ``flashattn.cu``, ``queue.cu``,
   ``greedy.cu``, ``celf.cu``, ``lt.cu`` and ``refill.cu`` with nvcc for
   sm_90a, one nvcc per source, started together, and prints each
   ``-Xptxas -v`` report; the three Occur kernels, the twelve of
   ``greedy.cu`` (:data:`GREEDY_KERNELS`), the six of ``celf.cu``, the two
   of ``membership.cu``, ``lt_walk``, ``queue_bfs``'s six forms and
   ``refill_bfs``'s three must not spill (the last two with their
   registers on ``queue_ptxas:``/``refill_ptxas:``); beside them the
   stamped copies of ``greedy_sketch`` and ``celf_select``
   (``examples/sketch_stamps.cu``, ``celf_stamps.cu``), whose phase
   splits phases 4, 8 and 14 print;
3. kernels: both Occur kernels against their plain versions on random
   int32 words of shape (131072, 2372) (bit 31 set in half the words, a
   ~50% row mask); the union popcount at (75880, 512) and (75880, 4) and
   the scatter-OR of 2^24 pairs (~10% of rows out of range, duplicates)
   into (75880, 512); exact equality, then timed (:func:`timing`: CUDA
   events over back-to-back calls, the kernel's own device time from
   torch.profiler, and the host's enqueue time a call; the union popcount
   at (75880, 4) runs the row-per-thread design), and ``greedy_sketch`` at
   k = 50 on both random sketches against its plain version, exact.  The
   dense path's kernels on random data at its shapes (``pack_bits`` at
   (512, 75904), ``bitset_or``/``bitset_andnot``/``frontier_update``/
   ``popcount_words`` at (512, 2372), ``bernoulli_edges`` at 512 seeds x
   607,012 edges) and at ragged ones (W odd and off the 16-byte
   alignment, E not a multiple of the block or of 4: the trials' byte
   stores), exact.  The queue
   sampler's kernel (``ops.queue_bfs``, which draws the row seeds and
   roots in the launch) against its plain version ``ref.queue_round_ref``
   (``row_seeds``, ``draw_roots``, then ``queue_bfs_ref``) on the card at
   the exact path's first round (B = 512, ``round_seed(0, 0)``) at qcap =
   n, 64 and 8, byte for byte in queue rows, lengths, overflow flags,
   per-lane steps and roots; a lane must overflow iff its RR set at qcap =
   n is longer (some do at 8);
4. approximate solve (the second slice's path): ``IMMSolver(g,
   engine="queue", batch=512, seed=0).solve(IMProblem(k=50, eps=0.5,
   mode="approximate", max_theta=8192))`` with the auto sketch size on the
   epinions-like stand-in (``barabasi_albert(75879, 4, seed=0)`` with WC
   weights): stage times, θ, sketch size and bytes, peak memory and the
   launch counts: ``greedy_sketch`` once a selection, ``sketch_fold_rows``
   once a fold (each append), ``queue_bfs`` > 0, no ``sketch_scatter_or``,
   no ``popcount_words`` and no ``sketch_union_popcount``; no pool buffer;
   one selection must make exactly one host sync (:func:`count_syncs`),
   and one append of the first round's batch to a scratch store one
   ``sketch_fold_rows`` launch and one host sync; the forward-MC spread of
   its seeds must lie in ``[0.9 lo, 1.1 hi]`` of its ``spread_bounds``.
   ``max_theta`` keeps the run finite: at this size the auto sketch (128
   buckets) saturates, and the Alg. 2 loop, reading the saturated
   estimate, would otherwise sample towards λ* (PERF.md §4).  Then the
   same solve with the parent's fold (:func:`parent_sketch_append`: a host
   read of three reductions, the batch's flat pairs built by PyTorch and
   one ``sketch_scatter_or`` launch) and with this one, in turns (parent,
   kernel, kernel, parent), each with its stage times and launches; every
   solve must give the same θ, LB, rounds, RR sets, elements, seeds,
   gains, float32 bytes of frac, spread_bounds, certificate and sketch
   words.  The selections alone in turns on the final sketch against the
   selection loop before ``greedy_sketch`` (:func:`parent_sketch_select`),
   and ``greedy_sketch``'s record there (:func:`sketch_greedy_record`: byte
   for byte against the plain version ``ref.greedy_sketch_ref`` on the
   card, timed beside it, with the bound, the bytes of its k sweeps, the
   form of its rows and the barrier floor, the same grid running its k + 1
   grid barriers alone) and its phase split in SM clocks
   (``greedy_sketch_stamps:``), and the fold's at the first round's batch
   (:func:`fold_record`:
   words and counts against ``ref.sketch_fold_rows_ref``, with the bound
   and, on a ``fold_hub_probe:`` line, its device time on that batch and on
   one of uniform node ids);
5. exact solve (the first slice's path), ``IMMSolver(g, engine="queue",
   batch=512, selection="bitset", seed=0).solve(IMProblem(k=50,
   eps=0.5))``, with wall time per stage, peak memory and the launch
   counts of the Occur kernels and ``queue_bfs``, which must be > 0; θ,
   RR sets, pool elements and sampling steps must be :data:`EXACT_POOL`.
   Then the solve's first sampling round again (:func:`profile_round`):
   its host syncs (torch.cuda's sync debug mode), bare, and under
   torch.profiler for its device operations, named, and the device's idle
   share, with the longest lane's edges and block-wide compactions; and
   the queue kernel's record at that round (:func:`queue_record`), with
   the card's bound and the longest lane's one-SM bound;
6. parity: ``flat`` selection on the final pool equals the ``bitset``
   result (seeds, gains, frac), ``greedy_flat`` equals its plain version
   ``ref.greedy_flat_ref`` on that pool byte for byte, and both Occur
   kernels equal their plain versions on the final bit matrix;
7. forward MC: the RIS spread estimate is within 10% of a 256-simulation
   forward Monte-Carlo spread of the seeds;
8. exact-regime identity: the phase-5 pool folded into a sketch store with
   ``sketch_k = row_capacity()`` (``sketch_packed_from_flat`` +
   ``SketchRRStore.from_state``, no second sampling); ``select_seeds_sketch``
   must give the ``bitset`` seeds, gains and frac exactly.  The same pool
   folded at smaller sketch sizes must keep the certified lower bound
   ``lo_rows`` at or below the rows its seeds truly cover.  At each size
   (W = 512, 4, 32, 128 words a row) ``greedy_sketch``'s record, on a
   ``greedy_sketch_probes:`` line, and its phase split on a
   ``greedy_sketch_probe_stamps:`` line;
9. dense solve (the third slice's path): ``IMMSolver(g, engine="dense",
   batch=512, selection="bitset", seed=0).solve(IMProblem(k=50, eps=0.5))``
   with stage times, levels per round, peak memory and launch counts
   (``bernoulli_edges`` and both Occur kernels > 0).  The dense engine
   keeps the queue sampler's per-row contract, so its result must equal
   phase 5's exactly: θ, LB, rounds, RR sets, pool elements, seeds, gains
   and the float32 bytes of frac.  Then one round under torch.profiler;
10. packed sampler: ``sample_rrsets_dense_packed(reverse(g), batch=512,
   seed32=round_seed(0, 0), base_seed=0)`` with levels, mean RR size,
   wall time, peak memory and launch counts (``pack_bits``,
   ``popcount_words``, ``bernoulli_edges`` and ``occur_from_bitset`` > 0,
   ``frontier_update`` once a level, ``bitset_andnot`` and ``bitset_or``
   never); its Occur and sizes must equal the plain versions on its words,
   and its first 16 lanes must equal a CPU run of ``_sample_dense_packed``
   from the same 16 roots, bit for bit; where a ``bitset_or`` call's host
   time goes (:func:`wrapper_split_us`, on the ``packed_sampler:`` line).
   The six dense kernels are then held against their plain versions and
   timed on this run's inputs, ``frontier_update`` beside the PyTorch calls
   of the same function and the pair of kernels it replaced;
11. padded selection: the phase-5 pool as RR lists, ``build_padded_store``
   and ``select_seeds_padded(store, 50)`` on the card, three times (the
   first loads the kernel), which must give the phase-6 ``bitset`` seeds,
   gains and float32 bytes of frac, with one ``padded_greedy`` launch and
   no ``membership_rows`` launch each, and the parent's loop
   (:func:`parent_padded_select`, a ``membership_rows`` launch a step) in
   every field; the two in turns.  ``padded_greedy`` is then held
   against its plain loop (exactly), must make no host sync and one
   device operation a call, and is timed with its bound and its barrier
   floor (:func:`padded_greedy_record`); the standalone membership scan is
   held against its plain version (exactly) and timed at the path's shape
   and at (131,072 x 512), rows drawn from the pool (its size law, u a
   seed), and at ragged shapes (lengths 0 and L, L off 128, u = n);
12. flash attention: first the SASS of the built ``flashattn`` library
   (``cuobjdump -sass``) and its ``-Xptxas -v`` report: exactly the
   kernels that ``kernels/flashattn.py::design`` routes to, HGMMA and
   UTMALDG in every bfloat16/float16 one at D = 64, 128, 256, no spill
   store in any (``flash_sass_check``; the counts on a ``flash_sass:``
   line).  Then five shapes at full width of three of the repo's LM
   configs (``src/repro/configs/lm.py``): olmo-1b (B=2, S=2048, H=16,
   D=128, bfloat16, causal), qwen2-0.5b (B=1, S=4096, its 2 KV heads
   repeated to H=14, D=64, float32, not causal), gemma3-12b (B=1, S=1024,
   H=16, D=256, bfloat16, causal), qwen2-0.5b in its own bfloat16, causal,
   and olmo-1b in float16, causal, and four shapes past the one-pass
   kernels' D = 256 (B=1, S=1024, H=8, D=320 and 512, float32 not causal
   and bfloat16 causal: the column-split kernel); each one
   ``ops.flash_attention`` call,
   held against ``flash_attention_ref`` on the card (atol 2e-5, rtol 1e-4
   in float32; 2e-2 in bfloat16; 2e-3 in float16) and timed beside
   ``scaled_dot_product_attention`` on the same tensors, with its design,
   bound, share of the bound and factor against SDPA;
13. default-options exact solve (the main path): ``IMMSolver(g,
   engine="queue", batch=512, seed=0).solve(IMProblem(k=50, eps=0.5))``,
   whose ``selection="auto"`` takes ``flat`` on this pool, with wall time
   per stage, peak memory and launch counts: ``greedy_flat`` once a greedy
   (3), no ``popcount_words`` and no Occur kernel.  It must equal phase 5
   exactly (θ, LB, rounds, RR sets, pool elements, seeds, gains, the
   float32 bytes of frac), and one ``store.select(50, method="flat")`` on
   its final pool must make no host sync (:func:`count_syncs`).  Then
   ``greedy_flat``'s record at that pool and, on a ``greedy_flat_eps_low:``
   line, at the pool of an eps = 0.25 solve (:func:`greedy_record`: byte
   for byte against the plain version, one device operation a call under
   torch.profiler, timed beside the plain version, with the bound, the
   working set and the barrier floor, the same grid running its k + 3
   grid barriers alone);
14. CELF (the slice of ``select_seeds_celf``): the phase-5 solve with
   ``selection="celf"`` at ``sketch_k`` 1,024 and 16,384, and with
   ``early_exit=True`` at 16,384 (:data:`CELF_SOLVES`), each with stage
   times (the fold within the append as ``stage_s.fold``), launch counts
   (``celf_select`` once a selection, the exact store's fold
   ``sketch_fold_rows`` once an append, ``sketch_union_popcount`` and
   ``popcount_words`` only from the early exit's gate, ``celf_eval``,
   ``celf_apply`` and ``sketch_scatter_or`` never), the early exit's skips
   and history, and on its
   final pool one selection's exact evaluations, eval calls and host syncs
   (:func:`count_syncs`: exactly one).  Each must equal phase 5 exactly:
   θ, LB, rounds, RR sets, pool elements, seeds, gains, the float32 bytes
   of frac.  On a host copy of each final pool (:func:`check_celf_on_host`)
   the incremental sketch (the ``sketch_fold_rows`` fold) must equal the
   plain fold word for word, and the selection's seeds, gains, frac and
   ``stats_out`` those of ``ref.celf_select_ref``.  Then the records of
   ``celf_select`` (:func:`celf_select_record`: against its plain version
   on the card exactly, timed beside it, with the bound of this run's
   batches, its form (:func:`celf.select_layout`; on the top-list path its
   grid barriers must be :func:`celf.list_barriers`) and the barrier
   floor) and, at both sizes, its phase split in SM clocks on a
   ``celf_select_stamps:`` line; ``celf_eval``, ``celf_apply`` and
   ``sketch_union_popcount`` at this pool (:func:`celf_records`: against
   the plain versions exactly, timed beside them, with the bound; the sweep
   and its ``popcount_words`` base at the same cover exactly, on a
   ``celf_sweep_check:`` line), on ``celf_kernels_1024:`` and
   ``celf_kernels_16384:`` lines, since no selection here launches them;
15. variants (:func:`variants_phase`), on the stand-in with weights v mod
   7, candidates v mod 3 == 0 and costs 1 + (v mod 5): the weighted solve
   (k = 50) on the queue engine, whose pool holds no root of weight 0,
   whose roots' classes pass a χ² test against the weights (p > 1e-3), and
   whose RIS spread lies within 10% of a 256-run weighted forward
   Monte-Carlo spread, and on the dense engine, equal in every field
   (``variant_weighted:``); the candidate solve (k = 50) and the budgeted
   solve (budget 100) with ``flat`` (one ``greedy_flat_variant`` a
   selection), ``bitset`` (the Occur kernels) and ``celf`` (``celf_eval``,
   ``celf_apply`` and the sweep), equal in every field, inside the
   candidates and the budget (``variant_candidates:``,
   ``variant_budgeted:``); the approximate solve with the candidates (as
   phase 4), one masked ``greedy_sketch`` a selection
   (``variant_approximate_candidates:``).  Then the records of
   ``queue_bfs`` with the weighted solve's alias table at its first round,
   ``greedy_flat_variant`` at the final pools of the budgeted and
   candidate ``flat`` solves and the masked ``greedy_sketch`` at the
   approximate solve's final sketch, each against its plain version on the
   card exactly; and the records of ``celf_eval``, ``celf_apply`` and
   ``sketch_union_popcount`` (:func:`celf_records`) at the budgeted
   ``celf`` solve's pool and 1,024-bucket sketch, Covered after its first
   10 seeds and the padded batch of 32 its next eval call passes
   (:func:`celf_variant_batch`);
16. LT and row-weighted (:func:`lt_phase`): ``lt_walk`` byte for byte
   against its plain version at the LT path's first round (B = 512, qcap
   = n), uniform and with phase 15's alias table (``lt_walk_check:``);
   the LT solve (k = 50) with ``flat``, ``bitset`` and ``celf``, equal in
   every field, one ``lt_walk`` a round and no ``queue_bfs``, its RIS
   spread within 10% of a 256-run forward LT Monte Carlo (``lt_solve:``);
   the LT approximate solve, its forward LT spread inside ``[0.9 lo, 1.1
   hi]`` (``lt_approximate:``); the row-weighted solve (weights v mod 7)
   on a queue-engine instance with uniform roots, with ``flat`` (one
   weighted ``greedy_flat_variant`` a selection), ``bitset`` (a torch
   loop) and ``celf`` (the weighted ``celf_eval``/``celf_apply``), equal
   in every field, its spread within 10% of a 256-run weighted forward IC
   Monte Carlo and of phase 15's alias-root estimate
   (``row_weighted_solve:``).  Then the records of ``lt_walk`` (its bytes
   bound, the longest lane's chain of dependent loads from a replay of
   every draw, :func:`lt_bound`, and the same walks at qcap = 64) and of
   the weighted ``greedy_flat_variant``, ``celf_eval`` and ``celf_apply``
   at the row-weighted solves' final pools, each exact against its plain
   version on the card.
17. the multigraph dedup, the refill engine and MRIM (:func:`dedup_phase`,
   :func:`refill_phase`, :func:`mrim_phase`): the stand-in's edge list
   with every third edge repeated at its own weight, reversed
   (destination-sorted rows, ``segmented``) and with each row shuffled
   (``sort``): one sampler round of each through ``sample_rrsets_queue``,
   ``queue_bfs[dedup]`` byte for byte against its plain version in both
   modes, ``sort`` on the sorted rows equal to ``segmented``
   (``dedup_check:``); ``refill_bfs`` at the first round (256 lanes,
   out_cap 1,024) equal to its plain version and to ``queue_bfs``'s lanes
   0-511 row for row, steps included, the plain loop's lock-step count
   equal to ``refill_schedule_steps`` (``refill_check:``), the engine's
   round one launch and one host read, and ``IMMSolver(g,
   engine="refill", batch=512)`` on phase 5's problem equal to phase 5 in
   every field (``refill_solve:``); MRIM, ``IMProblem(k=10, t_rounds=5,
   eps=0.5)`` with ``flat``, ``bitset`` and ``celf`` equal in every field,
   one ``queue_bfs`` a round, its RIS spread within 10% of a 256-run
   T-round forward Monte Carlo (``mrim_solve:``), and ``queue_bfs[tiled]``
   at 2,560 lanes byte for byte, the T lanes of a sample on one root
   (``tiled_check:``); the records of ``queue_bfs[dedup]``,
   ``refill_bfs`` and ``queue_bfs[tiled]``;
18. the stacked selection and serving's batch executor
   (:func:`stacked_phase`): ``greedy_stacked`` on phase 5's pool at R = 1,
   3 (one padding row) and 8 requests that mix plain k = 50 and 10, phase
   15's candidates, its costs with budget 100 and a group quota of 2 (three
   groups), and at R = 16 plain requests, byte for byte against its plain
   version ``ref.greedy_stacked_ref`` and every row against its solo
   ``greedy_flat``/``greedy_flat_variant`` launch, each batch timed beside
   its rows as solo launches (``stacked_checks:``); then at phase 5's θ
   (7,101) a batch of nine problems (plain k = 50, 10, 25, 5, the
   candidates at k = 50 and 10, the costs at budget 100 and 50, and a
   top-1 rider): ``solve_stacked`` of the eight stackable ones equal to
   their solo ``solve_problem`` in every field, one ``greedy_stacked``
   launch; ``execute_batch`` (the rider on the Occur fast path, the eight
   stacked: one ``greedy_stacked``, no solo greedy) equal to
   ``execute_batch(stacked=False)`` in every field, ``stats_out`` one
   batch of eight; the eight selections stacked and solo in turns
   (``stacked_solve:``); ``greedy_stacked``'s record at that batch;
19. durability and streaming (:func:`durability_phase`), on the stand-in
   with ``sketch_k=1024`` on the exact store: the plain solve (equal to
   phase 5); a ``checkpoint_every=5`` solve that crashes at its twelfth
   sample, restored into a fresh solver and finished, and restored in a
   new Python process (``subprocess``, the cached kernel build), each
   equal to the plain solve in every field (``ckpt:`` with the
   ``save_pool``/``restore_pool`` seconds and the checkpoint's bytes);
   ``FaultInjector(rate=0.1, seed=0)`` at every site, equal in every
   field but the pool bytes a ``grow`` fallback may change (``faults:``);
   ``evict_earliest_rounds(5)``, ``evict_to_bytes`` (half the pool's
   bytes) and ``evict_rows_containing`` (the delta's affected nodes) on
   the card, each equal to the same eviction on the CPU from the same
   ``state()``, the first rebuild's ``sketch_scatter_or`` byte for byte
   against its plain version, and the compaction that drops nothing
   equal to the incremental fold's words (``eviction:``); ``deadline_s=0``
   on the sketch pool (K ``sketch_union_popcount`` and ``popcount_words``
   sweeps, equal to the CPU run of the same checkpoint) and on phase 5's
   pool without a sketch, each with K seeds and its forward Monte Carlo
   inside ``[0.9 lo, 1.1 hi]`` (``degraded:``); and a delta of 1,000
   removals and 1,000 additions (p = 0.1) from ``default_rng(0)``:
   ``resolve_incremental`` against a cold solve on the post-delta graph,
   both RIS estimates within 10% of a 256-simulation forward Monte Carlo,
   the round cursor never rewound (``streaming:``).
20. the serving front (:func:`serving_phase`) on the stand-in, through
   ``repro_torch.serve``: ``build_service`` with ``max_batch=16``,
   ``batch_window_s=0.002`` and phase 5's solver options on the card, the
   port's ``IMNetServer`` on ``127.0.0.1:0`` and its ``IMClient``.  Phase
   18's nine problems at θ = 7,101 and one ε-driven ``IMProblem(k=50,
   eps=0.5)``, sent at once, each equal to ``result_state`` of a cold
   solve on the card in every field but ``stats.variant`` (a result's
   stats are its solver's live stats, shared by a batch's results in both
   packages); launch counts reset just before and read just after:
   ``queue_bfs``, ``greedy_stacked`` and ``greedy_flat`` launched;
   ``/statsz``: two or three micro-batches, at least one stacked, the
   top-1 fast path counted; the resend cached with the same bits; 404,
   400 and a zero deadline's 504 (or a degraded 200); a drain (``/readyz``
   503, a solve refused typed, ``shutdown()`` spilling every entry)
   (``serving_gate:``).  A burst of 16 past ``queue_cap=4`` shed with 429
   (``serving_shed:``); a budget of 1.5x the first entry's pool bytes that
   spills it when a second key arrives, the next request on it rehydrated
   with no ``queue_bfs`` launch and equal to the cold solve
   (``serving_spill:``, the checkpoint bytes, spill and rehydrate
   seconds); the nine under ``FaultInjector(rate=0.1, seed=0)`` with the
   first ``executor`` crossing failing: only served or typed outcomes, the
   served ones equal to the gate's (``serving_chaos:``); an ``IMCluster``
   of two workers on the card: twelve θ-pinned keys at once, each pool on
   one worker, the answers the cold solves', then ``add_worker``: the
   moved keys adopted warm (``handoffs_in``, no entry built anew) and
   answering with the same bits (``serving_cluster:``); the ``serving:``
   line with the phase's seconds, the gate's latency p50/p99 (submit to
   response), occupancy, cache hits, sheds, spill and rehydrate, chaos
   retries, handoffs and the card's ``nvidia-smi`` name and power limit.
21. the sharded pool and its selection protocol (:func:`sharded_phase`),
   on the stand-in with phase 5's options: (a) a one-rank NCCL group in
   this process, ``IMMSolver(mesh=...)`` with ``fused``, ``bitset`` and
   ``celf``, each equal to phase 5 in seeds, gains, ``frac``, θ and
   spread; launch counts reset just before the ``fused`` solve and read
   just after: ``occur_flat`` and ``shard_flat_step`` launched,
   ``greedy_flat`` not; the ``occur_flat`` and ``shard_flat_step`` records
   at its pool (each against its plain version, max abs err 0; the step
   over the selection's K steps); (b) two gloo ranks on the one card
   (:func:`sharded_rank`, spawned by ``torch.multiprocessing``), the same
   three solves on CUDA tensors (a gloo build that refuses CUDA tensors
   fails the phase with its message), each equal to phase 5;
   (c) the two ranks with ``engine="queue_sharded"`` at 256 lanes each,
   equal to phase 5 (a batch of 512).  Each solve's stage seconds,
   per-rank pool bytes, launches and collectives (the solve's and one
   selection's) go on the ``sharded:`` line.

The last lines are the ``{"kernels": [...]}`` record (the Occur kernels at
the exact path's final bit matrix, masked on the first seed's rows as the
greedy passes them, a bool mask; the sketch kernels at the approximate
path's sketch, the fold at its first round's batch, the dense kernels at
the packed sampler's inputs, the padded greedy (with its barrier floor)
and the membership scan at the padded store, flash attention at
olmo-1b's shape,
the queue sampler at the exact path's first round with the work it
examined (:func:`queue_bound`) and its one-SM bound
(:func:`one_sm_bound`), the greedy at the default solve's final pool
with its barrier floor (:func:`greedy_record`), the sketch greedy at the
approximate solve's final sketch (:func:`sketch_greedy_record`),
``celf_select`` at the CELF solve's pool and its 1,024-bucket sketch
(:func:`celf_select_record`), ``celf_eval``, ``celf_apply`` and
``sketch_union_popcount`` at the budgeted CELF variant's (phase 15); the
phase-15 records (named ``queue_bfs[weighted]``,
``greedy_flat_variant[costs]``, ``greedy_flat_variant[candidates]`` and
``greedy_sketch[candidates]``: a kernel on the operands of a path of its
own); ``greedy_stacked`` at phase 18's batch, with the same rows' time as
solo launches (``solo_launches_ms``) and its barrier floor;
``sketch_scatter_or`` at phase 19's first eviction rebuild (its record at
the approximate path's first round goes on a
``sketch_scatter_or_approximate:`` line); ``occur_flat`` (beside
``torch.bincount``) and ``shard_flat_step`` (the mean of a selection's
steps) at phase 21's one-rank pool;
the union popcount's record at the approximate sketch goes on a
``sketch_union_popcount_approximate:`` line); launches from each path's
run (``bitset_or``, ``bitset_andnot`` and ``membership_rows``: 0, no
path launches them; the kernels of :data:`SHARED_PATH_KERNELS` the sum
over phase 5's solve, the packed sampler, the early exit's gate, phase
15's two CELF variant solves, MRIM's and phase 19's evictions, degraded
answer and incremental solve, each path's count under
``launches_from``); each with
``ms``, ``device_ms``,
``device_other_ms`` and ``enqueue_us`` from :func:`timing`;
``bernoulli_edges`` with its trial's instructions by class as the built
loop has them and as the float-compare loop did the work, and the smaller
of the two bounds (:func:`trial_bound`); and
``bitset_or``/``bitset_andnot`` with ``torch.bitwise_or``'s times on the
same words, ``frontier_update`` with its yardsticks), the ``nvidia-smi``
line and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import asyncio
import ctypes
import functools
import hashlib
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def _examples_module(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


STAMPS = _examples_module("torch_selection_stamps")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.core import coverage as cov  # noqa: E402
from repro_torch.core import dense  # noqa: E402
from repro_torch.core import forward  # noqa: E402
from repro_torch.core import lt as lt_mod  # noqa: E402
from repro_torch.core import roots  # noqa: E402
from repro_torch.core import rrset  # noqa: E402
from repro_torch.core import sketch as sketch_mod  # noqa: E402
from repro_torch.core import stream  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.core.engine import make_engine  # noqa: E402
from repro_torch.core.imm import IMMSolver  # noqa: E402
from repro_torch.core.packing import to_int32_bits  # noqa: E402
from repro_torch.core.problem import IMProblem  # noqa: E402
from repro_torch.core.rrset import EC_DEFAULT, round_seed  # noqa: E402
from repro_torch.ft.failures import (FaultInjector, FaultPolicy,  # noqa: E402
                                     InjectedFailure)
from repro_torch.graph import csr, generators, weights  # noqa: E402
from repro_torch.kernels import _build, bitset, ops, ref  # noqa: E402
from repro_torch.kernels import celf as celf_mod  # noqa: E402
from repro_torch.kernels import flashattn as flash  # noqa: E402
from repro_torch.kernels import greedy  # noqa: E402
from repro_torch.kernels import membership  # noqa: E402
from repro_torch.kernels.bernoulli import counter_uniform_u32  # noqa: E402
from repro_torch.kernels.sketch import (canonical_row_ids,  # noqa: E402
                                        frontier_pairs)
from repro_torch.kernels.queue import SEGMENT_EDGES  # noqa: E402
from repro_torch.launch.im_solve import free_port  # noqa: E402
from repro_torch.launch.mesh import make_sample_mesh  # noqa: E402
from repro_torch.serve import (ERROR_STATUS, IMClient,  # noqa: E402
                               IMCluster, IMNetServer, ServeConfig,
                               build_service, execute_batch)
from repro_torch.serve.net import result_state  # noqa: E402

# H100 SXM HBM rate (NVIDIA's data sheet), and the results per clock per
# SM of each class of instruction on Hopper (compute capability 9.0), from
# the arithmetic-instruction throughput table of the CUDA C++ Programming
# Guide: the integer ALU (logic, shifts, adds, compares, selects), integer
# multiply-add on the FMA pipe, float32 arithmetic and compares, and the
# conversions and popcount.  "dispatch" is the four warp schedulers' 4 x 32
# instructions of any class.  (The 67 TFLOP/s float32 figure counts an FMA
# as two operations on 128 lanes; it is no integer rate.)  "tensor16" is
# the dense bfloat16/float16 tensor-core rate in flops (989 TFLOP/s = 132
# SMs x 4,096 x 1,830 MHz); its few warpgroup instructions are not counted
# against the dispatch rate.
HBM_BYTES_S = 3.35e12
# the H100's L2 cache (50 MB): bytes a kernel reads again may come from it
L2_BYTES = 50 * 2 ** 20
PER_SM_CLOCK = {"alu": 64, "imad": 64, "fp32": 128, "xu": 16, "dispatch": 128,
                "tensor16": 4096}
NOT_DISPATCHED = ("tensor16",)
SASS_CLASS = {
    **dict.fromkeys(("LOP3", "LOP", "SHF", "SHL", "SHR", "IADD3", "ISETP",
                     "SEL", "LEA", "IMNMX", "PRMT", "MOV", "IABS"), "alu"),
    **dict.fromkeys(("IMAD", "IMUL"), "imad"),
    **dict.fromkeys(("FMUL", "FADD", "FFMA", "FSETP", "FMNMX", "FSEL"),
                    "fp32"),
    **dict.fromkeys(("I2F", "I2FP", "F2I", "F2F", "POPC", "FLO", "BREV"),
                    "xu"),
}
SASS_LOADS = ("LDG", "LDC", "LD", "LDS", "LDL", "ULDC", "S2R", "S2UR")
# the edge trial's work as a one-trial-a-thread loop with the float compare
# compiled it (tests/test_torch_chip_bounds.py::BERNOULLI_SASS): the hash's
# shifts and xors and the select on the ALU, the counter multiply-add and
# 4 hash multiplies, the scale and the compare, the conversion.  The
# record's bound is the smaller of this count's and the built kernel's own
# (:func:`trial_bound`).
TRIAL_WORK_OPS = {"alu": 14, "imad": 5, "fp32": 2, "xu": 1}
# the redesigned trial loop's word-store instantiation (csrc/bernoulli.cu)
BERNOULLI_LOOP = "bernoulli_kernelILb1E"
SYNTH_SHAPE = (131072, 2372)
N_NODES, BA_R, K, EPS, BATCH = 75879, 4, 50, 0.5, 512
MC_SIMS, MC_TOL = 256, 0.10
APPROX_MAX_THETA = 8192
SKETCH_ROWS, SKETCH_WORDS, SCATTER_PAIRS = N_NODES + 1, 512, 1 << 24
PROBE_SKETCH_K = (128, 1024, 4096)
# kernels that -Xptxas -v reports in csrc/greedy.cu (greedy_flat's two
# forms, greedy_flat_variant's two and its weighted form's two, the barrier
# floor, greedy_stacked, greedy_sketch's four forms) and csrc/celf.cu
# (celf_eval, celf_apply, celf_select's four forms)
GREEDY_KERNELS, CELF_KERNELS = 12, 6
# the stamped copies of greedy_sketch and celf_select (examples/), built
# beside the port's sources; their libraries once built
STAMPED_SOURCES = {"sketch": "sketch_stamps", "celf": "celf_stamps"}
STAMPED: dict = {}
SOURCES = ("occur", "sketch", "bitops", "bernoulli", "membership",
           "flashattn", "queue", "greedy", "celf", "lt", "refill", "shard")
# phase 14: the phase-5 solve with CELF, (selection, sketch_k, early_exit)
CELF_SOLVES = (("celf", 1024, False), ("celf", 16384, False),
               ("celf", 16384, True))
# phase 13: the default-options exact solve's greedy also at the pool of an
# eps = 0.25 solve, the bottom of benchmarks/fig6_eps_sweep.py:22
EPS_LOW = 0.25
CPU_LANES = 16
LIBRARY_NOTE = {
    "occur_from_bitset": "no single PyTorch call computes a bit-column "
                         "histogram",
    "occur_from_bitset_masked": "no single PyTorch call computes a "
                                "bit-column histogram",
    "sketch_scatter_or": "torch has no scatter with an OR reduction",
    "sketch_union_popcount": "torch has no popcount op",
    "pack_bits": "torch has no bit pack",
    "bitset_andnot": "a & ~b is two PyTorch calls",
    "popcount_words": "torch has no popcount op",
    "bernoulli_edges": "the counter hash is many PyTorch calls",
    "membership_rows": "eq, mask and any are three PyTorch calls",
    "queue_bfs": "no single PyTorch call runs a BFS",
    "greedy_flat": "no single PyTorch call runs a greedy",
    "greedy_flat_variant": "no single PyTorch call runs a greedy",
    "greedy_sketch": "no single PyTorch call runs a greedy",
    "celf_eval": "no single PyTorch call counts a node's uncovered rows "
                 "for each of a batch of nodes",
    "celf_apply": "no single PyTorch call ORs the rows that hold a node "
                  "into a bitset",
    "celf_select": "no single PyTorch call runs a lazy greedy",
    "frontier_update": "a & ~v and v |= a are three PyTorch calls (timed "
                       "beside it as the yardstick)",
    "sketch_fold_rows": "torch has no scatter with an OR reduction",
    "padded_greedy": "no single PyTorch call runs a greedy",
    "lt_walk": "no single PyTorch call runs a walk",
    "refill_bfs": "no single PyTorch call runs a BFS",
    "greedy_stacked": "no single PyTorch call runs a greedy",
    "shard_flat_step": "no single PyTorch call marks a node's uncovered "
                       "rows and counts their elements by node",
}
SOURCE_OF = {"occur_from_bitset": "occur", "occur_from_bitset_masked": "occur",
             "sketch_scatter_or": "sketch", "sketch_union_popcount": "sketch",
             "pack_bits": "bitops", "bitset_or": "bitops",
             "bitset_andnot": "bitops", "popcount_words": "bitops",
             "bernoulli_edges": "bernoulli", "membership_rows": "membership",
             "flash_attention": "flashattn", "queue_bfs": "queue",
             "greedy_flat": "greedy", "greedy_flat_variant": "greedy",
             "greedy_sketch": "greedy",
             "celf_eval": "celf", "celf_apply": "celf",
             "celf_select": "celf", "frontier_update": "bitops",
             "sketch_fold_rows": "sketch", "padded_greedy": "membership",
             "lt_walk": "lt", "refill_bfs": "refill",
             "greedy_stacked": "greedy", "occur_flat": "shard",
             "shard_flat_step": "shard"}
# each record's kernel as the profiler names it (a regular expression that
# matches the demangled or the mangled name)
DEVICE_KERNEL = {
    "occur_from_bitset": r"occur_kernel",
    "occur_from_bitset_masked": r"occur_masked_kernel",
    "sketch_scatter_or": r"scatter_or_kernel",
    "sketch_union_popcount": r"union_popcount_(row_)?kernel",
    "pack_bits": r"pack_bits_kernel",
    "bitset_or": r"bitset_binary_kernel",
    "bitset_andnot": r"bitset_binary_kernel",
    "popcount_words": r"(?<!union_)popcount_kernel",
    "bernoulli_edges": r"bernoulli_kernel",
    "membership_rows": r"membership_kernel",
    "flash_attention": r"flash_(wgmma|simt_split|simt)_kernel",
    "queue_bfs": r"queue_bfs_kernel",
    "greedy_flat": r"greedy_flat_kernel(<(true|false), false>|ILb[01]ELb0E)",
    "greedy_flat_variant": r"greedy_flat_kernel(<(true|false), true>|"
                           r"ILb[01]ELb1E)",
    "greedy_sketch": r"greedy_sketch_kernel",
    "celf_eval": r"celf_eval_kernel",
    "celf_apply": r"celf_apply_kernel",
    "celf_select": r"celf_select_kernel",
    "frontier_update": r"frontier_update_kernel",
    "sketch_fold_rows": r"fold_rows_kernel",
    "padded_greedy": r"padded_greedy_kernel",
    "greedy_flat_variant[weighted]": r"greedy_flat_weighted_kernel",
    "lt_walk": r"lt_walk_kernel",
    "refill_bfs": r"refill_bfs_kernel",
    "greedy_stacked": r"greedy_stacked_kernel",
    "occur_flat": r"occur_flat_kernel",
    "shard_flat_step": r"shard_flat_step_kernel",
}
KERNELS = {
    "occur_from_bitset": "src/repro/kernels/bitset.py:167",
    "occur_from_bitset_masked": "src/repro/kernels/bitset.py:133",
    "sketch_scatter_or": "src/repro/kernels/sketch.py:101",
    "sketch_union_popcount": "src/repro/kernels/sketch.py:53",
    "pack_bits": "src/repro/kernels/bitset.py:37",
    "bitset_or": "src/repro/kernels/bitset.py:77",
    "bitset_andnot": "src/repro/kernels/bitset.py:82",
    "popcount_words": "src/repro/kernels/bitset.py:102",
    "bernoulli_edges": "src/repro/kernels/bernoulli.py:53",
    "membership_rows": "src/repro/kernels/membership.py:36",
    "flash_attention": "src/repro/kernels/flashattn.py:62",
    # no Pallas kernel: the reference's round is a jitted lax.while_loop
    "queue_bfs": "src/repro/core/rrset.py:230",
    # no Pallas kernel: the reference's fused scan is a jitted lax.scan
    "greedy_flat": "src/repro/core/coverage.py:1359",
    # no Pallas kernel: the reference's variant scan is a jitted lax.scan
    "greedy_flat_variant": "src/repro/core/coverage.py:1552",
    # no Pallas kernel of its own: the reference's greedy is a host loop
    # of sweeps (each the Pallas sketch_union_popcount)
    "greedy_sketch": "src/repro/core/coverage.py:2223",
    # no Pallas kernel: the reference's CELF evaluations are jitted XLA
    "celf_eval": "src/repro/core/coverage.py:1451",
    "celf_apply": "src/repro/core/coverage.py:1482",
    # no Pallas kernel: the reference's CELF is a host loop of those two
    "celf_select": "src/repro/core/coverage.py:2093",
    # the dense level's bitset_andnot (bitset.py:82) and bitset_or (:77),
    # as the reference's level calls them
    "frontier_update": "src/repro/core/dense.py:156",
    # the scatter-OR on its path: the reference's fold of a batch builds
    # the pairs in XLA, then scatters them with that Pallas kernel
    "sketch_fold_rows": "src/repro/kernels/sketch.py:101",
    # the membership scan on its path: the reference's padded greedy
    # (coverage.py:2510) scans with that Pallas kernel once a seed
    "padded_greedy": "src/repro/kernels/membership.py:36",
    # no Pallas kernel: the reference's LT walk is a jitted lax.while_loop
    "lt_walk": "src/repro/core/lt.py:54",
    # no Pallas kernel: the weighted variant scan and the weighted CELF
    # programs are jitted XLA
    "greedy_flat_variant[weighted]": "src/repro/core/coverage.py:1500",
    "celf_eval[weighted]": "src/repro/core/coverage.py:1783",
    "celf_apply[weighted]": "src/repro/core/coverage.py:1810",
    # no Pallas kernel: the reference's persistent lanes are a jitted
    # lax.while_loop
    "refill_bfs": "src/repro/core/rrset.py:356",
    # the queue round's chunk dedup (the reference's _first_occurrence,
    # inside the same while_loop) and MRIM's tiled roots (_mrim_round)
    "queue_bfs[dedup]": "src/repro/core/rrset.py:104",
    "queue_bfs[tiled]": "src/repro/core/engine.py:429",
    # no Pallas kernel: serving's stacked selection is a jitted lax.scan
    # (vmapped over the requests) inside shard_map
    "greedy_stacked": "src/repro/core/coverage.py:1643",
    # no Pallas kernel: the sharded fused scan's Occur scatter-add and its
    # step are XLA inside shard_map
    "occur_flat": "src/repro/core/coverage.py:1374",
    "shard_flat_step": "src/repro/core/coverage.py:1379",
}
# phase 3: the queue kernel at the exact path's first round, also at qcap
# 64 (above its longest RR set, 21) and 8, where lanes overflow
QUEUE_QCAPS = (64, 8)
# phase 5's pool and step count, the same in every run on the card (PERF.md
# §5): the counter hash makes the RR sets a function of the seed alone
EXACT_POOL = {"theta": 7101, "n_rr": 8704, "pool_elements": 35538,
              "sampling_steps": 28350}
# phase 11: the membership scan at a larger shape
BIG_MEMBERSHIP = (131072, 512)
# phase 12: (config at src/repro/configs/lm.py:line, B, S, H, D, dtype,
# causal); the first is the kernel's record in the final line
FLASH_SHAPES = (
    ("olmo-1b (lm.py:22)", 2, 2048, 16, 128, torch.bfloat16, True),
    ("qwen2-0.5b (lm.py:14)", 1, 4096, 14, 64, torch.float32, False),
    ("gemma3-12b (lm.py:30)", 1, 1024, 16, 256, torch.bfloat16, True),
    ("qwen2-0.5b (lm.py:14)", 1, 4096, 14, 64, torch.bfloat16, True),
    ("olmo-1b (lm.py:22)", 2, 2048, 16, 128, torch.float16, True),
    ("D = 320 (split)", 1, 1024, 8, 320, torch.float32, False),
    ("D = 320 (split)", 1, 1024, 8, 320, torch.bfloat16, True),
    ("D = 512 (split)", 1, 1024, 8, 512, torch.float32, False),
    ("D = 512 (split)", 1, 1024, 8, 512, torch.bfloat16, True),
)
FLASH_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2),
             torch.float16: (2e-3, 2e-3)}
# a flash kernel's mangled template type -> its dtype (flash_sass_check)
FLASH_SASS_DTYPE = {"f": torch.float32, "13__nv_bfloat16": torch.bfloat16,
                    "6__half": torch.float16}


def say(tag: str, obj) -> None:
    print(f"{tag}: {json.dumps(obj)}", flush=True)


def nvidia_smi(query: str = "name,power.limit", units: bool = True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[0]


@functools.cache
def card_rates() -> dict:
    """The card's peak rates, read once: HBM bytes/s, and instructions/s of
    each class = SMs x PER_SM_CLOCK x the maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm", units=False))
    return {"sms": sms, "clocks_max_sm_mhz": mhz, "hbm_bytes_s": HBM_BYTES_S,
            "per_sm_clock": PER_SM_CLOCK,
            "ops_s": {k: sms * v * mhz * 1e6 for k, v in PER_SM_CLOCK.items()}}


def _sass_regs(text: str, pair: bool = False, count: int = 1) -> set:
    """Registers and predicates named in one SASS operand; ``R4.64`` (or
    ``pair``) names R4 and R5, and ``count`` names that many from each
    register (a 16-byte store's value R4 names R4 to R7)."""
    regs = set()
    for kind, num, wide in re.findall(r"\b(UR|R|UP|P)(\d+)(\.64)?\b", text):
        regs.add(f"{kind}{num}")
        extra = max(count, 2 if (wide or pair) else 1)
        if kind in ("R", "UR"):
            regs |= {f"{kind}{int(num) + i}" for i in range(1, extra)}
    return regs


def store_bytes(op: str) -> int:
    """Bytes a global store writes (``STG.E.U8`` 1, ``STG.E.U16`` 2,
    ``STG.E`` 4, ``STG.E.64`` 8, ``STG.E.128`` 16), 0 for any other op."""
    parts = op.split(".")
    if parts[0] != "STG":
        return 0
    for part, n in (("U8", 1), ("S8", 1), ("U16", 2), ("S16", 2), ("64", 8),
                    ("128", 16)):
        if part in parts:
            return n
    return 4


def sass_ops_per_store(sass: str, kernel: str) -> dict:
    """Instructions by class per trial in the loop of ``kernel`` (the first
    function whose name holds it), read from ``cuobjdump -sass`` output: the
    backward slice of each stored value through the loop body, cut at
    loads (the inputs), so address and loop arithmetic are not counted.  A
    trial is one output byte: a store of 1, 4, 8 or 16 bytes stands for
    that many trials, and the loop is the one that stores the most bytes.
    Raises on an instruction in the slice that SASS_CLASS does not class,
    and when no loop stores."""
    fn = next(f for f in sass.split("Function : ")[1:]
              if kernel in f.splitlines()[0])
    code = [(int(a, 16), g, op, [x.strip() for x in args.split(",")])
            for a, g, op, args in re.findall(
                r"/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                r"\s*([^;]*);", fn)]
    loops = [(int(args[0], 16), at) for at, _, op, args in code
             if op.startswith("BRA") and args[0].startswith("0x")
             and int(args[0], 16) < at]
    bodies = [[c for c in code if lo <= c[0] <= hi] for lo, hi in loops]
    body = max(bodies, key=lambda b: sum(store_bytes(c[2]) for c in b),
               default=[])
    need, counts, trials = set(), dict.fromkeys(PER_SM_CLOCK, 0), 0
    for _, guard, op, args in reversed(body):
        base = op.split(".")[0]
        nbytes = store_bytes(op)
        if nbytes:
            trials += nbytes
            need |= _sass_regs(args[-1], count=max(1, nbytes // 4))
            continue
        defs = _sass_regs(args[0], pair=".WIDE" in op or ".64" in op)
        srcs = args[1:]
        if srcs and re.fullmatch(r"U?P\d", srcs[0]):     # a carry out
            defs.add(srcs.pop(0))
        if base in ("STG", "BRA", "EXIT") or not defs & need:
            continue
        need -= defs
        if base in SASS_LOADS:
            continue
        if base not in SASS_CLASS:
            raise ValueError(f"SASS instruction {op} has no class")
        counts[SASS_CLASS[base]] += 1
        need |= _sass_regs(guard or "")
        for arg in srcs:
            need |= _sass_regs(arg, pair=".WIDE" in op and arg is srcs[-1])
    if not trials:
        raise ValueError(f"no global store in a loop of {kernel}")
    return {k: v / trials for k, v in counts.items() if v}


def cuobjdump_sass(lib: Path) -> str:
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def _flash_instance(name: str):
    """(design, dtype, D, causal) of a flash kernel's mangled name (D is
    the output columns a block for "simt_split"), or None for any other
    function."""
    m = re.search(r"flash_(wgmma|simt_split|simt)_kernelI"
                  r"(f|13__nv_bfloat16|6__half)Li(\d+)ELb([01])E", name)
    if m is None:
        return None
    return (m[1], FLASH_SASS_DTYPE[m[2]], int(m[3]), m[4] == "1")


def flash_sass_check(sass: str, ptxas: str) -> dict:
    """Raise unless ``csrc/flashattn.cu`` built exactly the kernels that
    ``design`` routes to (three dtypes x (five head dims and the column
    split) x causal or not), every "wgmma" one holds HGMMA and UTMALDG in
    its SASS, and ptxas reports no spill store for any of them.  Returns
    the counts by kernel."""
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        inst = _flash_instance(fn.splitlines()[0])
        if inst is None:
            continue
        kind, dtype, d, causal = inst
        key = f"{kind}/{str(dtype).removeprefix('torch.')}/{d}/" + \
            ("causal" if causal else "full")
        counts[key] = {op: len(re.findall(rf"\b{op}\b", fn))
                       for op in ("HGMMA", "UTMALDG", "FFMA", "LDS")}
        # the split kernel's D is its slice width; it runs past D = 256
        route_d = (flash.MAX_SINGLE_PASS + flash.SPLIT_CHUNK
                   if kind == "simt_split" else d)
        if flash.design(dtype, route_d) != kind or (
                kind == "simt_split" and d != flash.SPLIT_COLUMNS):
            raise AssertionError(f"{key} built, but design() routes "
                                 f"{dtype} at D = {route_d} to "
                                 f"{flash.design(dtype, route_d)}")
        if kind == "wgmma" and not (counts[key]["HGMMA"]
                                    and counts[key]["UTMALDG"]):
            raise AssertionError(f"{key} has no HGMMA or no UTMALDG: "
                                 f"{counts[key]}")
    want = 3 * (len(flash.HEAD_DIMS) + 1) * 2
    if len(counts) != want:
        raise AssertionError(f"{len(counts)} flash kernels in the SASS, "
                             f"not {want}: {sorted(counts)}")
    spills = {name: n for name, n in ptxas_spills(ptxas, "flash_").items()
              if _flash_instance(name) is not None}
    if len(spills) != want:
        raise AssertionError(f"ptxas reports {len(spills)} flash kernels, "
                             f"not {want}")
    spilled = {k: v for k, v in spills.items() if v}
    if spilled:
        raise AssertionError(f"flash kernels spill: {spilled}")
    return counts


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernel: str | None = None,
              attempts: int = 3) -> dict:
    """Device time of one launch from torch.profiler's ``key_averages()``
    over ``iters`` calls (after one warm-up), each call one launch of the
    kernel: ``device_ms`` is the mean duration of the device entries whose
    name matches the regular expression ``kernel`` (every device entry
    when None), over the launches that the trace holds
    (``device_records``: a trace on this card may drop some of them, or
    all, so an empty trace is taken again, up to ``attempts`` traces);
    ``device_other_ms`` is the rest a call (memsets, copies).  When no
    trace holds any, each call is timed alone between two events queued
    behind a spin kernel, which hides the host's issue time but adds the
    events' own few microseconds (``device_ms_source``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        own = other = 0.0
        records, names = 0, []
        for avg in prof.key_averages():
            if avg.device_type != DeviceType.CUDA or not avg.device_time_total:
                continue
            if kernel is None or re.search(kernel, avg.key):
                own += avg.device_time_total
                records += avg.count
                names.append(avg.key[:120])
            else:
                other += avg.device_time_total
        if records:
            break
    out = {"device_other_ms": other / iters / 1e3, "device_records": records,
           "device_traces": attempt, "device_kernels": names}
    if not records:
        return {"device_ms": queued_call_ms(fn, iters),
                "device_ms_source": "events behind a spin kernel", **out}
    return {"device_ms": own / records / 1e3, "device_ms_source": "profiler",
            **out}


def queued_call_ms(fn, iters: int) -> float:
    """Mean milliseconds between two events around one call that waits in
    the stream behind a spin kernel of about 1 ms, so that the events
    bracket its device work and not the host's issue time."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def enqueue_us(fn, calls: int) -> float:
    """Host microseconds per call over ``calls`` calls with no sync inside
    (after one warm-up and a sync): the host's cost of issuing the call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def timing(name: str, fn, iters: int) -> dict:
    """A kernel call's times: event-timed ``ms`` over back-to-back calls,
    the profiler's ``device_ms`` of its own kernel, and ``enqueue_us``."""
    return {"ms": cuda_ms(fn, iters),
            **device_ms(fn, iters, DEVICE_KERNEL.get(
                name, DEVICE_KERNEL[base_name(name)])),
            "enqueue_us": enqueue_us(fn, iters)}


def ptxas_spills(ptxas: str, kernel: str) -> dict:
    """Spill-store bytes by function, from an ``-Xptxas -v`` report, for
    the functions whose mangled name holds ``kernel``."""
    return {name: int(stores) for name, stores in re.findall(
        r"Function properties for (\S+)\s+\d+ bytes stack frame, "
        r"(\d+) bytes spill stores", ptxas) if kernel in name}


def ptxas_registers(ptxas: str, kernel: str) -> dict:
    """Registers by function, from an ``-Xptxas -v`` report, for the
    functions whose mangled name holds ``kernel``."""
    return {name: int(regs) for name, regs in re.findall(
        r"Function properties for (\S+)\s+.*?Used (\d+) registers", ptxas,
        re.S) if kernel in name}


def _bound(nbytes: float, ops: dict) -> dict:
    """The least time for the work: the larger of its bytes over the HBM
    rate and its operations, ``ops`` counted by class, each class at its own
    rate and all of them at the dispatch rate; both sides are kept."""
    rates = card_rates()["ops_s"]
    per = {k: n / rates[k] * 1e3 for k, n in ops.items()}
    per["dispatch"] = sum(n for k, n in ops.items()
                          if k not in NOT_DISPATCHED) / rates["dispatch"] * 1e3
    pipe = max(per, key=per.get)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, per[pipe]
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
            "bound_ops_class": pipe}


def bound_ms(rows_read: int, rows: int, cols: int, masked: bool):
    """Least time for the histogram: read the selected rows once (plus the
    mask), write W*32 int32.  Operations: a bit-sliced positional popcount,
    one full adder (two LOP3s over 32 columns) per word read into bit-plane
    counters, then 32 counts x log2(rows) planes read out per word column."""
    nbytes = rows_read * cols * 4 + cols * 32 * 4 + (rows * 4 if masked else 0)
    return _bound(nbytes, {"alu": 2 * rows_read * cols
                           + 32 * cols * max(rows_read, 1).bit_length()})


def union_bound_ms(rows: int, cols: int):
    """Read (R, W) words and cov once, write R int32; per word an OR and an
    add on the ALU and a popcount."""
    return _bound(rows * cols * 4 + cols * 4 + rows * 4,
                  {"alu": 2 * rows * cols, "xu": rows * cols})


def scatter_bound_ms(words, v, b):
    """Read 8 bytes per pair; read and write one 32-byte sector per distinct
    sector of words that this run's in-range pairs touch; one OR per pair."""
    r, w = words.shape
    keep = (v >= 0) & (v < r)
    word = v[keep].to(torch.int64) * w + (b[keep].to(torch.int64) >> 5)
    sectors = int(torch.unique(word >> 3).numel())
    return _bound(8 * v.numel() + 2 * 32 * sectors, {"alu": v.numel()})


def prefix_sectors(lengths, row_len: int) -> tuple[int, int]:
    """The 32-byte sectors that hold the rows' valid prefixes of an (R, L)
    int32 matrix (row r starts at byte 4*r*L), and the valid lanes."""
    lens = lengths.to(torch.int64).clamp(0, row_len)
    start = torch.arange(lens.numel(), dtype=torch.int64,
                         device=lens.device) * (4 * row_len)
    first, last = start // 32, (start + 4 * lens - 1) // 32
    return (int(torch.where(lens > 0, last - first + 1, 0).sum()),
            int(lens.sum()))


def membership_bound_ms(lengths, row_len: int):
    """Read the 32-byte sectors that hold each row's valid prefix, the
    lengths and u, write R bools; one compare per valid element."""
    sectors, lanes = prefix_sectors(lengths, row_len)
    return _bound(32 * sectors + 4 * lengths.numel() + 4 + lengths.numel(),
                  {"alu": lanes})


def padded_greedy_bound(lengths, row_len: int, k: int) -> dict:
    """The padded greedy's least time: the valid prefixes' sectors and the
    lengths read once, the 2k + 1 outputs written once; each step's
    membership scan a compare a valid lane (k of them a lane)."""
    sectors, lanes = prefix_sectors(lengths, row_len)
    return dict(_bound(32 * sectors + 4 * lengths.numel() + 4 * (2 * k + 1),
                       {"alu": k * lanes}),
                prefix_sectors=sectors, valid_lanes=lanes)


def fold_bound_ms(words, nodes, lens, row_base: int, *, k: int,
                  mode: str) -> dict:
    """The batch fold's least time: the lengths (4 bytes a row) and the
    valid lanes (4 bytes each) read once, one 32-byte sector read and
    written per distinct sector of words that this batch's in-range lanes
    touch (as :func:`scatter_bound_ms` counts), the two counts written; one
    OR a valid lane."""
    r, w = words.shape
    clamped = lens.to(torch.int64).clamp(0, nodes.shape[1])
    v, b = frontier_pairs(nodes, clamped, canonical_row_ids(lens, row_base),
                          n_rows=r, k=k, mode=mode)
    keep = (v >= 0) & (v < r)
    word = v[keep].to(torch.int64) * w + (b[keep].to(torch.int64) >> 5)
    sectors = int(torch.unique(word >> 3).numel())
    lanes = int(clamped.sum())
    return dict(_bound(4 * lens.numel() + 4 * lanes + 2 * 32 * sectors + 16,
                       {"alu": lanes}),
                valid_lanes=lanes, word_sectors=sectors)


def flash_work(b: int, s: int, h: int, d: int, causal: bool) -> dict:
    """Flops (4*B*H*D*P: QK^T and P.V, two each per multiply-add) and
    exponentials (B*H*P) of attention over P = S*S query-key pairs, or
    S*(S+1)/2 when causal."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return {"pairs": pairs, "flops": 4 * b * h * d * pairs,
            "exps": b * h * pairs}


def flash_bound_ms(b, s, h, d, dtype, causal):
    """Read q, k, v and write the output once (4*B*S*H*D*itemsize bytes);
    the flops at the bfloat16/float16 tensor-core rate (what a Hopper
    kernel within the tolerance uses) or, in float32, as FMAs at the
    float32 rate (TF32 would miss 2e-5); the exponentials at the
    conversion unit's 16 a clock."""
    work = flash_work(b, s, h, d, causal)
    itemsize = torch.empty(0, dtype=dtype).element_size()
    arith = ({"fp32": work["flops"] // 2} if dtype == torch.float32
             else {"tensor16": work["flops"]})
    return _bound(4 * b * s * h * d * itemsize, {**arith, "xu": work["exps"]})


def kernel_records(words, mask, launches=None, iters=20, plain_iters=3):
    """Check both kernels against the plain versions on (words, mask)
    exactly (the mask also in the other of bool and int32), then time
    kernel and plain version."""
    rows, cols = words.shape
    got = ops.occur_from_bitset(words)
    want = ref.occur_from_bitset_ref(words)
    gotm = ops.occur_from_bitset_masked(words, mask)
    wantm = ref.occur_from_bitset_masked_ref(words, mask)
    other = mask.to(torch.int32 if mask.dtype == torch.bool else torch.bool)
    goto = ops.occur_from_bitset_masked(words, other)
    torch.cuda.synchronize()
    errs = [float((got - want).abs().max()), float((gotm - wantm).abs().max())]
    if errs != [0.0, 0.0] or not (torch.equal(got, want)
                                  and torch.equal(gotm, wantm)
                                  and torch.equal(goto, wantm)):
        raise AssertionError(f"kernel != plain version at {tuple(words.shape)}:"
                             f" max abs err {errs}")
    n_sel = int(mask.count_nonzero())
    calls = {
        "occur_from_bitset": (lambda: ops.occur_from_bitset(words),
                              lambda: ref.occur_from_bitset_ref(words), rows,
                              False),
        "occur_from_bitset_masked": (
            lambda: ops.occur_from_bitset_masked(words, mask),
            lambda: ref.occur_from_bitset_masked_ref(words, mask), n_sel,
            True),
    }
    out = []
    for (name, (kern, plain, rows_read, masked)), err in zip(calls.items(),
                                                             errs):
        out.append(record(name, launches, err, timing(name, kern, iters),
                          cuda_ms(plain, plain_iters),
                          bound_ms(rows_read, rows, cols, masked),
                          shape=[rows, cols],
                          mask_rows=n_sel if masked else None,
                          mask_dtype=str(mask.dtype).removeprefix("torch.")
                          if masked else None,
                          nonzero_words=int(words.count_nonzero())))
    return out


def base_name(name: str) -> str:
    """The kernel of a record: ``queue_bfs[weighted]`` is ``queue_bfs``'s
    kernel on the operands of a path of its own (a form with a kernel or
    a reference of its own has its own entry in :data:`DEVICE_KERNEL` or
    :data:`KERNELS`)."""
    return name.split("[")[0]


def record(name, launches, err, times, plain_ms, bound, library_ms=None,
           **extra):
    """One kernel's record; ``times`` is :func:`timing`'s."""
    base = base_name(name)
    rec = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/kernels/csrc/{SOURCE_OF[base]}.cu",
           "replaces": KERNELS.get(name, KERNELS[base]),
           "launches": None if launches is None else launches[name],
           "max_abs_err": err, **times, "plain_ms": plain_ms, **bound,
           "library_ms": library_ms}
    if library_ms is None:
        rec["library_null_because"] = LIBRARY_NOTE[base]
    return dict(rec, **extra)


def max_abs_err(got, want) -> float:
    return float((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0.0


def sketch_records(words, cov_words, v, b, launches=None, iters=20,
                   plain_iters=3):
    """Check both sketch kernels against the plain versions exactly (the
    scatter-OR on copies of ``words``, since it works in place), then time
    kernel and plain version."""
    got = ops.sketch_scatter_or(words.clone(), v, b)
    want = ref.sketch_scatter_or_ref(words.clone(), v, b)
    pop = ops.sketch_union_popcount(words, cov_words)
    pop_want = ref.sketch_union_popcount_ref(words, cov_words)
    torch.cuda.synchronize()
    errs = {"sketch_scatter_or": max_abs_err(got, want),
            "sketch_union_popcount": max_abs_err(pop, pop_want)}
    if any(errs.values()) or not (torch.equal(got, want)
                                  and torch.equal(pop, pop_want)):
        raise AssertionError(f"sketch kernel != plain version at "
                             f"{tuple(words.shape)}, E={v.numel()}: {errs}")
    rows, cols = words.shape
    scratch = words.clone()     # OR is idempotent: repeated folds time alike
    return [
        record("sketch_scatter_or", launches, errs["sketch_scatter_or"],
               timing("sketch_scatter_or",
                      lambda: ops.sketch_scatter_or(scratch, v, b), iters),
               cuda_ms(lambda: ref.sketch_scatter_or_ref(scratch, v, b),
                       plain_iters), scatter_bound_ms(words, v, b),
               shape=[rows, cols], pairs=v.numel()),
        record("sketch_union_popcount", launches,
               errs["sketch_union_popcount"],
               timing("sketch_union_popcount",
                      lambda: ops.sketch_union_popcount(words, cov_words),
                      iters),
               cuda_ms(lambda: ref.sketch_union_popcount_ref(words,
                                                             cov_words),
                       plain_iters), union_bound_ms(rows, cols),
               shape=[rows, cols]),
    ]


def fold_record(words, nodes, lens, *, k: int, mode: str, launches=None,
                iters=50, plain_iters=10) -> dict:
    """The batch fold against its plain version on the card on copies of
    ``words`` (words and counts exactly), timed beside it on a scratch copy
    (OR is idempotent: repeated folds time alike), with the bound.  Then
    the hub probe: the kernel's device time on this batch and on one of the
    same shape and row stride whose valid lanes hold uniform node ids, on
    a ``fold_hub_probe:`` line."""
    dev = words.device
    base = 0
    want, got = words.clone(), words.clone()
    want_counts = torch.zeros(2, dtype=torch.int64, device=dev)
    counts = torch.full((2,), -1, dtype=torch.int64, device=dev)
    ref.sketch_fold_rows_ref(want, nodes, lens, base, k=k, mode=mode,
                             counts=want_counts)
    ops.sketch_fold_rows(got, nodes, lens, base, k=k, mode=mode,
                         counts=counts)
    torch.cuda.synchronize()
    err = max(max_abs_err(got, want), max_abs_err(counts, want_counts))
    if err or not (torch.equal(got, want)
                   and torch.equal(counts, want_counts)):
        raise AssertionError(f"sketch_fold_rows != plain version at "
                             f"{tuple(nodes.shape)}: max abs err {err}")
    scratch, plain_scratch = words.clone(), words.clone()

    def kern(b_nodes=nodes):
        return ops.sketch_fold_rows(scratch, b_nodes, lens, base, k=k,
                                    mode=mode, counts=counts)

    rec = record(
        "sketch_fold_rows", launches, err,
        timing("sketch_fold_rows", kern, iters),
        cuda_ms(lambda: ref.sketch_fold_rows_ref(
            plain_scratch, nodes, lens, base, k=k, mode=mode, counts=counts),
            plain_iters),
        fold_bound_ms(words, nodes, lens, base, k=k, mode=mode),
        shape=list(words.shape), batch=list(nodes.shape),
        row_stride=nodes.stride(0), sketch_k=k, sketch_mode=mode,
        counts=want_counts.tolist())
    gen = torch.Generator(device=dev).manual_seed(5)
    uniform = torch.randint(0, words.shape[0] - 1,
                            (nodes.shape[0], nodes.stride(0)), device=dev,
                            generator=gen, dtype=torch.int32)[:, :nodes.shape[1]]
    lane = torch.arange(nodes.shape[1], device=dev)[None, :]
    valid = lane < lens.to(torch.int64)[:, None]
    hub_lanes = torch.bincount(nodes[valid].to(torch.int64),
                               minlength=words.shape[0])
    kernel = DEVICE_KERNEL["sketch_fold_rows"]
    say("fold_hub_probe", {
        "batch": list(nodes.shape), "valid_lanes": int(valid.sum()),
        "busiest_node_lanes": int(hub_lanes.max()),
        "busiest_node": int(hub_lanes.argmax()),
        "device_ms": device_ms(kern, iters, kernel)["device_ms"],
        "uniform_device_ms": device_ms(lambda: kern(uniform), iters,
                                       kernel)["device_ms"],
        "uniform_word_sectors": fold_bound_ms(
            words, uniform, lens, base, k=k, mode=mode)["word_sectors"],
        "word_sectors": rec["word_sectors"]})
    return rec


def frontier_both(fn, a, visited):
    """``fn(a, v)`` (``frontier_update`` or its plain version) on a copy
    ``v`` of ``visited``, stacked with ``v`` after it: both outputs."""
    v = visited.clone()
    return torch.stack([fn(a, v), v])


def dense_calls(bits, a, b, w, seeds) -> dict:
    """name -> (kernel call, plain call) of the six dense-path kernels
    (``frontier_update`` with ``b`` the new words and ``a`` visited)."""
    return {
        "pack_bits": (lambda: ops.pack_bits(bits),
                      lambda: ref.pack_bits_ref(bits)),
        "bitset_or": (lambda: ops.bitset_or(a, b),
                      lambda: ref.bitset_or_ref(a, b)),
        "bitset_andnot": (lambda: ops.bitset_andnot(a, b),
                          lambda: ref.bitset_andnot_ref(a, b)),
        "popcount_words": (lambda: ops.popcount_words(a),
                           lambda: ref.popcount_words_ref(a)),
        "frontier_update": (
            lambda: frontier_both(ops.frontier_update, b, a),
            lambda: frontier_both(ref.frontier_update_ref, b, a)),
        "bernoulli_edges": (lambda: ops.bernoulli_edges(w, seeds),
                            lambda: ref.bernoulli_edges_ref(w, seeds)),
    }


def check_dense_kernels(bits, a, b, w, seeds) -> dict:
    """Each dense-path kernel against its plain version on the same
    inputs; raises unless every one is exact.  Returns max abs errors."""
    errs = {}
    for name, (kern, plain) in dense_calls(bits, a, b, w, seeds).items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        errs[name] = max_abs_err(got, want)
        if errs[name] != 0 or not torch.equal(got, want):
            raise AssertionError(f"{name} != plain version at "
                                 f"{tuple(bits.shape)}, {tuple(a.shape)}, "
                                 f"{tuple(seeds.shape)} x {w.numel()}: "
                                 f"max abs err {errs[name]}")
    return errs


def trial_bound(w, seeds, trial_ops: dict) -> dict:
    """The edge trials' least time: read the weights and seeds once, write
    one byte a trial; operations counted per trial twice, by the built
    kernel's own loop (``trial_ops``, from its SASS) and as the
    float-compare loop did the work (:data:`TRIAL_WORK_OPS`).  The bound is the smaller, so a
    leaner loop cannot read above 100% and a loop that adds packing work
    cannot raise the bound; both are kept."""
    trials = seeds.numel() * w.numel()
    nbytes = 4 * w.numel() + 8 * seeds.numel() + trials
    own = _bound(nbytes, {k: v * trials for k, v in trial_ops.items()})
    work = _bound(nbytes, {k: v * trials for k, v in TRIAL_WORK_OPS.items()})
    least = min((own, work), key=lambda b: b["bound_ms"])
    return {**least, "bound_from": "own" if least is own else "work",
            "trial_ops_own": trial_ops, "bound_own_ms": own["bound_ms"],
            "trial_ops_work": TRIAL_WORK_OPS,
            "bound_work_ms": work["bound_ms"]}


def dense_bounds(bits, a, w, seeds, trial_ops: dict) -> dict:
    """Least times: pack_bits reads B*n bytes and writes B*n/8 (one ALU
    operation per byte read); the pair ops read two words and write one
    (one LOP3 each); frontier_update reads two words and writes two (two
    LOP3s); popcount reads and writes one word (one POPC); the trials as
    :func:`trial_bound`.  The bytes are at the HBM rate, so the time with
    a cold L2 (:func:`cold_device_ms`) stands against them: warm, words
    that fit the L2 come from it and may beat the bound."""
    nb, nw = bits.numel(), a.numel()
    return {"pack_bits": _bound(nb + nb // 8, {"alu": nb}),
            "bitset_or": _bound(12 * nw, {"alu": nw}),
            "bitset_andnot": _bound(12 * nw, {"alu": nw}),
            "popcount_words": _bound(8 * nw, {"xu": nw}),
            "frontier_update": _bound(16 * nw, {"alu": 2 * nw}),
            "bernoulli_edges": trial_bound(w, seeds, trial_ops)}


def cold_device_ms(fn, iters: int, kernel: str) -> dict:
    """:func:`device_ms` of ``kernel`` in ``fn`` as a caller with a cold L2
    finds it: before each call a reduction reads twice the L2's bytes of a
    spare tensor, which evicts what the last call left there.  Beside a
    bound at the HBM rate this is the time that it holds; warm, the inputs
    come from L2 and may beat it."""
    spare = torch.ones(2 * L2_BYTES // 4, dtype=torch.int32, device="cuda")

    def call():
        spare.sum()
        return fn()

    got = device_ms(call, iters, kernel)
    return {"cold_device_ms": got["device_ms"],
            "cold_device_ms_source": got["device_ms_source"]}


def timed_calls(fn, iters, ops_a_call: int) -> dict:
    """A yardstick's times: ``ms`` by events a call, the profiler's mean
    device time of each of its ``ops_a_call`` device operations, and the
    host's ``enqueue_us`` a call."""
    dm = device_ms(fn, iters)
    return {"ms": cuda_ms(fn, iters), "device_ms_per_op": dm["device_ms"],
            "device_ops_a_call": ops_a_call,
            "enqueue_us": enqueue_us(fn, iters)}


def dense_records(bits, a, b, w, seeds, launches, iters=20, plain_iters=3):
    """Check the six dense-path kernels exactly, then time kernel (warm,
    and its device time with a cold L2: :func:`cold_device_ms`), plain
    version and, for bitset_or, the one PyTorch call (torch.bitwise_or),
    whose times also stand beside bitset_andnot as a yardstick; beside
    frontier_update (``b`` the new words, ``a`` visited, on a scratch copy
    of ``a``: a repeated update moves the same bytes) the PyTorch calls of
    the same function (``b & ~v`` and ``v |= b``) and the pair of kernels
    it replaces (``bitset_andnot``, then ``bitset_or`` into a new
    tensor)."""
    errs = check_dense_kernels(bits, a, b, w, seeds)
    trial_ops = sass_ops_per_store(
        cuobjdump_sass(_build.build("bernoulli")), BERNOULLI_LOOP)
    say("bernoulli_sass_ops_per_trial", {"own": trial_ops,
                                          "work": TRIAL_WORK_OPS})
    bounds = dense_bounds(bits, a, w, seeds, trial_ops)
    shapes = {"pack_bits": list(bits.shape), "bitset_or": list(a.shape),
              "bitset_andnot": list(a.shape), "popcount_words": list(a.shape),
              "frontier_update": list(a.shape),
              "bernoulli_edges": [seeds.numel(), w.numel()]}
    visited = a.clone()

    def torch_frontier():
        new = torch.bitwise_and(b, torch.bitwise_not(visited))
        visited.bitwise_or_(b)
        return new

    def torch_or():
        return torch.bitwise_or(a, b)

    out = []
    for name, (kern, plain) in dense_calls(bits, a, b, w, seeds).items():
        extra = {}
        if name in ("bitset_or", "bitset_andnot"):
            lib = {"ms": cuda_ms(torch_or, iters),
                   **device_ms(torch_or, iters),
                   "enqueue_us": enqueue_us(torch_or, iters)}
            key = "library" if name == "bitset_or" else "yardstick_bitwise_or"
            extra = {f"{key}_{k}": v for k, v in lib.items()}
        if name == "bitset_or":
            # the host's parts of a call: the output's allocation, and the
            # entry point alone (ctypes, the launch) on a spare output
            spare = torch.empty_like(a)
            dev = a.get_device()
            extra["host_parts_us"] = {
                "empty_like": enqueue_us(lambda: torch.empty_like(a), iters),
                "entry_point": enqueue_us(lambda: bitset._BINARY[name](
                    a.data_ptr(), b.data_ptr(), a.numel(), spare.data_ptr(),
                    dev, _build.raw_stream(dev)), iters)}
        if name == "frontier_update":
            plain_visited = a.clone()
            kern = lambda: ops.frontier_update(b, visited)  # noqa: E731
            plain = lambda: ref.frontier_update_ref(  # noqa: E731
                b, plain_visited)
            extra = {"yardstick_torch": timed_calls(torch_frontier, iters, 3),
                     "pair_andnot_or": timed_calls(lambda: ops.bitset_or(
                         a, ops.bitset_andnot(b, a)), iters, 2),
                     "replaces_also": "src/repro/kernels/bitset.py:82, :77"}
        times = timing(name, kern, iters)
        extra.update(cold_device_ms(kern, iters, DEVICE_KERNEL[name]))
        out.append(record(name, launches, errs[name], times,
                          cuda_ms(plain, plain_iters), bounds[name],
                          library_ms=extra.pop("library_ms", None),
                          shape=shapes[name], **extra))
    return out


def plant_edge_weights(w: torch.Tensor) -> torch.Tensor:
    """``w`` with the edges of the trials' range planted every 97th entry
    (0, -0.0, 1.0, 1 + ulp, 1 - ulp, 2, +-inf, NaN, the smallest denormal,
    -1, and u(h) at the rounding boundary of 2^32 - 128): the integer
    threshold must decide them as the float compare does."""
    special = torch.tensor(
        [0.0, -0.0, 1.0, 1.0 + 2 ** -23, 1.0 - 2 ** -24, 2.0, math.inf,
         -math.inf, math.nan, 2 ** -149, -1.0,
         float(np.float32(2 ** 32 - 256) * np.float32(2 ** -32))],
        dtype=torch.float32, device=w.device)
    w = w.clone()
    idx = torch.arange(0, w.numel(), 97, device=w.device)
    w[idx] = special[torch.arange(idx.numel(), device=w.device)
                     % special.numel()]
    return w


def ragged_dense_checks(gen) -> dict:
    """The dense kernels at ragged shapes: W odd (flat words not a multiple
    of 4) and a word slice off the 16-byte alignment, bits starting one
    byte past it, E not a multiple of the block, exact."""
    dev = gen.device
    a, b = random_words((8, 2373), gen), random_words((8, 2373), gen)
    raw = torch.rand(7 * 2373 * 32 + 1, device=dev, generator=gen) < 0.5
    bits = raw[1:].view(7, 2373 * 32)
    w = plant_edge_weights(torch.rand(1000003, device=dev, generator=gen))
    seeds = torch.randint(0, 1 << 32, (3,), device=dev, generator=gen)
    return check_dense_kernels(bits, a[1:], b[1:], w, seeds)


def random_words(shape, gen) -> torch.Tensor:
    """Random int32 words; bit 31 is set in about half of them."""
    words = to_int32_bits(torch.randint(0, 1 << 32, shape, dtype=torch.int64,
                                        device=gen.device, generator=gen))
    if not bool((words < 0).any()):
        raise AssertionError("random words lack bit 31")
    return words


def random_pairs(rows: int, cols: int, pairs: int, gen):
    """(v, bucket) int32 pairs: ~10% of v out of range (half below 0, half
    past R), a quarter of the pairs duplicates of others."""
    dev = gen.device
    v = torch.randint(0, rows, (pairs,), device=dev, generator=gen)
    b = torch.randint(0, cols * 32, (pairs,), device=dev, generator=gen)
    u = torch.rand(pairs, device=dev, generator=gen)
    v = torch.where(u < 0.05, -1 - v, torch.where(u < 0.10, rows + v, v))
    dup = torch.randint(0, pairs, (pairs // 4,), device=dev, generator=gen)
    v[-dup.numel():], b[-dup.numel():] = v[dup], b[dup]
    return v.to(torch.int32), b.to(torch.int32)


def lane_work(g_rev, nodes, lengths) -> dict:
    """What a queue round's lanes examined: every node of a lane's queue is
    dequeued once and its reverse row walked.  Per (lane, position): the
    node and its degree (0 past the lane's length); per lane: the edges
    examined and the kernel's block-wide compactions, a row's
    ``max(1, ceil(deg / SEGMENT_EDGES))``, which make the lane's chain of
    dependent steps."""
    lens = lengths.to(torch.int64)
    width = max(int(lens.max()), 1)
    nodes = nodes[:, :width].to(torch.int64)
    valid = torch.arange(width, device=nodes.device)[None, :] < lens[:, None]
    offs = g_rev.offsets.to(torch.int64)
    deg = torch.where(valid, offs[nodes + 1] - offs[nodes], 0)
    return {"nodes": nodes, "valid": valid, "deg": deg,
            "edges": deg.sum(dim=1),
            "segments": torch.where(valid, ((deg + SEGMENT_EDGES - 1)
                                            // SEGMENT_EDGES).clamp(min=1),
                                    0).sum(dim=1)}


def count_syncs(fn):
    """``fn()`` under torch.cuda's sync debug mode, which warns at every
    call that makes the host wait for the card: (result, the calls'
    ``file:line`` sites)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]


def traced_device_ops(fn, kernel: str | None,
                      calls: int = 1) -> tuple[list, int]:
    """The device operations of ``calls`` calls of ``fn()`` under
    torch.profiler, and the traces taken.  A trace on this card drops the
    first device records of a session (a call's only kernel, when the call
    comes first), so the traced calls follow a warm-up call in the same
    trace, and only the device operations that start inside their
    ``record_function`` span count; a trace that holds no record of
    ``kernel`` (a regular expression; None: any) is taken again, up to
    three."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for traces in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            with record_function("profiled call"):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        start = min(e.time_range.start for e in events
                    if e.name == "profiled call")
        # the span itself also shows on the device's timeline: not an op
        dev_ops = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.start >= start
                   and e.name != "profiled call"]
        if kernel is None or any(re.search(kernel, e.name) for e in dev_ops):
            break
    return dev_ops, traces


def profile_round(engine, seed32: int) -> dict:
    """One sampling round: its host syncs counted (:func:`count_syncs`),
    then timed bare, then the same round (same seed, same work) under
    torch.profiler (:func:`traced_device_ops`): the device's busy time over
    the bare round's wall time gives the device's idle share while
    sampling.  The device operations are named (``device_op_names``: count
    by name), so a fill or a copy beside the kernels shows.  A queue round
    also reports its longest lane's edges and compactions, a dense round
    its figures a level."""
    torch.cuda.synchronize()
    _, sync_sites = count_syncs(lambda: engine.sample(seed32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = engine.sample(seed32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernel = DEVICE_KERNEL["queue_bfs"] if engine.name == "queue" else None
    dev_ops, traces = traced_device_ops(lambda: engine.sample(seed32), kernel)
    busy = sum(e.time_range.elapsed_us() for e in dev_ops) / 1e6
    names: dict[str, int] = {}
    for e in dev_ops:
        names[e.name[:80]] = names.get(e.name[:80], 0) + 1
    out = {"steps": batch.steps, "wall_s": wall, "device_ops": len(dev_ops),
           "device_op_names": names, "traces": traces,
           "host_syncs": len(sync_sites), "host_sync_sites": sync_sites,
           "device_busy_s": busy if dev_ops else "not measured",
           "device_idle_share": 1 - busy / wall if dev_ops
           else "not measured"}
    if engine.name == "queue":
        work = lane_work(engine.g_rev, batch.nodes, batch.lengths)
        out.update(longest_lane_edges=int(work["edges"].max()),
                   longest_lane_segments=int(work["segments"].max()))
    else:
        out.update(ms_per_level=wall / batch.steps * 1e3,
                   device_ops_per_level=len(dev_ops) / batch.steps)
    return out


class StageClock:
    """Host wall time of a method, between two torch.cuda.synchronize()."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def wrap(self, obj, method: str, label: str) -> None:
        fn = getattr(obj, method)
        self.seconds[label] = 0.0
        self.calls[label] = 0

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[label] += time.perf_counter() - t0
            self.calls[label] += 1
            return out

        setattr(obj, method, timed)


def parent_sketch_select(store, k: int, info_out: dict | None = None):
    """The parent's sketch selection, kept as the before figure: a host
    loop whose every step launches ``sketch_union_popcount`` and
    ``popcount_words`` (``core/sketch.py::union_gains``), masks the picked
    nodes, takes the argmax and reads ``(u, score[u])`` back; the
    certificate is the store's own (``coverage.sketch_certificate``)."""
    n, sk = store.n_nodes, store.words
    dev = sk.device
    cov_words = torch.zeros(sk.shape[1], dtype=torch.int32, device=dev)
    picked = torch.zeros(n, dtype=torch.bool, device=dev)
    seeds, gains = [], []
    for _ in range(k):
        deltas = sketch_mod.union_gains(sk, cov_words)[:n]
        score = torch.where(picked, -1, deltas)
        u = torch.argmax(score)
        u_host, best = (int(x) for x in torch.stack([u, score[u]]).cpu())
        if best < 0:
            break
        seeds.append(u_host)
        gains.append(best)
        picked[u] = True
        cov_words = sketch_mod.union_row(cov_words, sk, u)
    frac = cov.sketch_certificate(store, int(sum(gains)), info_out)
    pad = k - len(seeds)
    return cov.CoverageResult(
        seeds=torch.tensor(seeds + [n] * pad, dtype=torch.int32, device=dev),
        gains=torch.tensor(gains + [0] * pad, dtype=torch.int32, device=dev),
        frac=torch.tensor(frac, dtype=torch.float32, device=dev))


def parent_sketch_append(store, batch) -> None:
    """The parent's fold of a batch, kept as the before figure: a host read
    of three torch reductions (the batch's lanes and rows and the store's
    flag), then the batch's flat (node, bucket) pairs
    (``kernels.sketch.frontier_pairs`` under ``canonical_row_ids``, about a
    dozen PyTorch operations with a copy of the strided batch) through the
    ``sketch_scatter_or`` kernel with the store's flag."""
    nodes, lens = batch.nodes, batch.lengths
    clamped = lens.to(torch.int64).clamp(0, nodes.shape[1])
    elems, rows, bad = (int(x) for x in torch.stack(
        [clamped.sum(), (clamped > 0).sum(),
         store.fold_error[0].to(torch.int64)]).cpu())
    store.check_folds(bad)
    v, b = frontier_pairs(nodes, lens, canonical_row_ids(lens, store.n_rr),
                          n_rows=store.words.shape[0], k=store.sketch_k,
                          mode=store.sketch_mode)
    ops.sketch_scatter_or(store.words, v, b, store.fold_error)
    store._t += elems
    store._nrr += rows


def sketch_greedy_bound(n: int, cols: int, k: int, steps: int) -> dict:
    """The sketch greedy's least time.  Bytes: the n node rows read once
    (4 bytes a word) and the 2k + 1 outputs written once.  Operations, for
    the steps this run took: an OR and an add on the ALU and a popcount a
    word of every row, and a compare a row.  Also the bytes of the sweeps
    the design makes (``sweep_bytes_ms``: the n rows read once a step, at
    the HBM rate, though a sketch under 50 MB stays in L2)."""
    words = n * cols
    bound = _bound(4 * words + 4 * (2 * k + 1),
                   {"alu": steps * (2 * words + n), "xu": steps * words})
    sweep = 4 * words * steps
    return dict(bound, sweep_bytes=sweep,
                sweep_bytes_ms=sweep / HBM_BYTES_S * 1e3,
                sketch_fits_l2=4 * words <= L2_BYTES)


def check_greedy_sketch(words) -> dict:
    """greedy_sketch at k = K on random sketch words against its plain
    version, byte for byte (its first launch, so the solves that follow
    find it loaded)."""
    n = words.shape[0] - 1
    got = ops.greedy_sketch(words, n=n, k=K)
    want = ref.greedy_sketch_ref(words, n=n, k=K)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"greedy_sketch != plain version on random "
                             f"words {tuple(words.shape)}")
    return {"shape": list(words.shape), "k": K, "steps": int(got[2]),
            "gains_sum": int(got[1].sum()), "equal": True}


def sketch_greedy_record(words, n: int, launches=None, iters=20,
                         plain_iters=1, **extra) -> dict:
    """greedy_sketch on ``words`` against its plain version on the card
    (seeds, gains and steps byte for byte), then timed beside it, with the
    bound, the grid, the form of its rows (``greedy.sketch_layout``) and
    the barrier floor: the same grid running the launch's grid barriers
    (:func:`greedy.sketch_barriers`: one, then one a step run) alone."""
    got = ops.greedy_sketch(words, n=n, k=K)
    want = ref.greedy_sketch_ref(words, n=n, k=K)
    torch.cuda.synchronize()
    err = max(max_abs_err(x, y) for x, y in zip(got, want))
    if err or not all(x.dtype == y.dtype and torch.equal(x, y)
                      for x, y in zip(got, want)):
        raise AssertionError(f"greedy_sketch != plain version at "
                             f"{tuple(words.shape)}: max abs err {err}")
    dev = words.device
    steps = int(got[2])
    barriers = greedy.sketch_barriers(steps, K)
    times = timing("greedy_sketch",
                   lambda: ops.greedy_sketch(words, n=n, k=K), iters)
    plain_ms = cuda_ms(lambda: ref.greedy_sketch_ref(words, n=n, k=K),
                       plain_iters)
    floor_ms = cuda_ms(lambda: greedy.grid_barriers(barriers, dev), iters)
    blocks, shared_words = greedy.sketch_grid(dev)
    lay = greedy.sketch_layout(words.shape[1], words.data_ptr() % 16 == 0,
                               n=n, blocks=blocks, shared_words=shared_words)
    return record("greedy_sketch", launches, err, times, plain_ms,
                  sketch_greedy_bound(n, words.shape[1], K, steps),
                  barrier_floor_ms=floor_ms, grid_barriers=barriers,
                  grid_blocks=blocks, threads=greedy.THREADS,
                  barrier_grid_blocks=greedy.grid_blocks(dev),
                  form=lay.form, rows_a_thread=lay.rows, lanes=lay.lanes,
                  vector_loads=lay.vector, shape=list(words.shape), n=n, k=K,
                  steps=steps, gains_sum=int(got[1].sum()), **extra)


def stamped_split(kind: str, *args) -> dict:
    """The phase split in SM clocks of the stamped copy of greedy_sketch
    (``kind`` "sketch": words, n) or celf_select ("celf": store) at this
    path's shapes (``examples/torch_selection_stamps.py``)."""
    if kind == "sketch":
        return STAMPS.sketch_split(STAMPED["sketch"], *args)
    return STAMPS.celf_split(STAMPED["celf"], *args)


def approximate_solve(g, parent: bool = False) -> dict:
    """One approximate solve with the auto sketch size, its stages timed,
    launches counted from just before it to just after; ``parent`` swaps
    the store's fold for :func:`parent_sketch_append`."""
    problem = IMProblem(k=K, eps=EPS, mode="approximate",
                        max_theta=APPROX_MAX_THETA)
    solver = IMMSolver(g, engine="queue", batch=BATCH, seed=0,
                       device=g.device)
    solver.prepare(problem)
    store = solver.store
    if parent:
        store.append_batch = functools.partial(parent_sketch_append, store)
    clock = StageClock()
    clock.wrap(solver.engine, "sample", "sampling")
    clock.wrap(store, "append_batch", "fold")
    clock.wrap(store, "select", "selection")
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = solver.solve(problem)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    return {"res": res, "solver": solver, "solve_s": solve_s,
            "certificate": dict(solver._sketch_info),
            "stage_s": dict(clock.seconds), "stage_calls": dict(clock.calls),
            "launches": launches, "base_mem": base_mem,
            "peak": torch.cuda.max_memory_allocated()}


def approx_fields(run: dict) -> dict:
    """What two approximate solves (:func:`approximate_solve`'s) must
    share."""
    res, store = run["res"], run["solver"].store
    st = res.stats
    return {"theta": st.theta, "lb": st.lb, "lb_iters": st.lb_iters,
            "rounds": st.rounds, "n_rr": store.n_rr,
            "elements": store.n_elems, "seeds": [int(x) for x in res.seeds],
            "gains": [int(x) for x in res.gains],
            "frac_f32": np.float32(res.frac).tobytes().hex(),
            "spread_bounds": list(res.spread_bounds),
            "certificate": run["certificate"],
            "sketch_sha": hashlib.sha256(
                store.words.cpu().numpy().tobytes()).hexdigest()[:16]}


def turns_ms(calls: dict, reps: int = 3) -> dict:
    """Host milliseconds a call (between two synchronize()), in turns: the
    first, the second, the second, the first, each ``reps`` calls."""
    (a, fa), (b, fb) = calls.items()
    out = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name].append((time.perf_counter() - t0) / reps * 1e3)
    return out


def approximate_phase(g):
    """The approximate solve with the auto sketch size: stage times, launch
    counts (one sketch_fold_rows a fold and no sketch_scatter_or, one
    greedy_sketch a selection, no popcount), one host sync a selection and
    one launch and one host sync an append, certificate and its forward-MC
    check; then the parent's fold (:func:`parent_sketch_append`) against
    this one, whole solves in turns, every field equal, and the parent's
    selection loop against this one on the final sketch, in turns.
    Returns the records of the sketch kernels, of the fold at the path's
    first batch and of greedy_sketch at this path's shapes."""
    run = approximate_solve(g)
    res, solver, launches = run["res"], run["solver"], run["launches"]
    store = solver.store
    st = res.stats
    info = run["certificate"]
    store.select(K)
    torch.cuda.synchronize()
    _, sync_sites = count_syncs(lambda: store.select(K, info_out={}))
    # one append on a scratch store: one launch and one host read
    batch = solver.engine.sample(round_seed(0, 0))
    scratch = cov.SketchRRStore(store.n_nodes, sketch_k=store.sketch_k,
                                sketch_mode=store.sketch_mode,
                                device=g.device)
    torch.cuda.synchronize()
    before = ops.launch_counts()
    _, append_syncs = count_syncs(lambda: scratch.append_batch(batch))
    append_launches = {name: n - before[name]
                       for name, n in ops.launch_counts().items()
                       if n != before[name]}
    t0 = time.perf_counter()
    mc = forward.ic_spread(g, res.seeds, n_sims=MC_SIMS, seed=1)
    mc_s = time.perf_counter() - t0
    lo, hi = res.spread_bounds
    calls = run["stage_calls"]
    say("approximate_solve", {
        "n": g.n_nodes, "k": K, "eps": EPS, "batch": BATCH,
        "max_theta": APPROX_MAX_THETA, "theta": st.theta, "lb": st.lb,
        "lb_iters": st.lb_iters, "rounds": st.rounds, "n_rr": store.n_rr,
        "elements": store.n_elems, "sketch_k": store.sketch_k,
        "sketch_words_shape": list(store.words.shape),
        "sketch_bytes": store.sketch_bytes(),
        "per_device_pool_bytes": store.per_device_pool_bytes(),
        "solve_s": run["solve_s"], "stage_s": run["stage_s"],
        "stage_calls": calls,
        "fold_s_a_call": run["stage_s"]["fold"] / max(calls["fold"], 1),
        "max_memory_allocated": run["peak"],
        "memory_before_solve": run["base_mem"], "launches": launches,
        "select_host_syncs": len(sync_sites),
        "select_host_sync_sites": sync_sites,
        "append_host_syncs": len(append_syncs),
        "append_host_sync_sites": append_syncs,
        "append_launches": append_launches,
        "spread": res.spread, "spread_bounds": [lo, hi], "frac": res.frac,
        "certificate": info, "seeds": res.seeds.tolist()[:10],
        "n_seeds": len(res.seeds), "mc_spread": mc, "mc_sims": MC_SIMS,
        "mc_s": mc_s, "history": st.history,
    })
    selections = calls["selection"]
    if launches["greedy_sketch"] != selections or selections == 0 \
            or launches["popcount_words"] \
            or launches["sketch_union_popcount"] \
            or launches["sketch_fold_rows"] != calls["fold"] \
            or calls["fold"] == 0 or launches["sketch_scatter_or"] \
            or launches["queue_bfs"] == 0:
        raise AssertionError(f"approximate path: {selections} selections, "
                             f"{calls['fold']} folds, launches {launches}")
    if len(sync_sites) != 1:
        raise AssertionError(f"a sketch selection made {len(sync_sites)} "
                             f"host syncs: {sync_sites}")
    if len(append_syncs) != 1 or append_launches != {"sketch_fold_rows": 1}:
        raise AssertionError(f"an append made {len(append_syncs)} host syncs "
                             f"({append_syncs}) and the launches "
                             f"{append_launches}")
    if store.per_device_pool_bytes() != 0 or hasattr(store, "flat"):
        raise AssertionError("the approximate path allocated a pool")
    if len(set(res.seeds.tolist())) != K or not math.isfinite(res.spread) \
            or not lo <= res.spread <= hi:
        raise AssertionError(f"bad approximate result: seeds {res.seeds}, "
                             f"spread {res.spread}, bounds {(lo, hi)}")
    if not 0.9 * lo <= mc <= 1.1 * hi:
        raise AssertionError(f"forward MC {mc} outside [0.9 lo, 1.1 hi] = "
                             f"[{0.9 * lo}, {1.1 * hi}]")
    # the parent's fold and this one, whole solves in turns
    want = approx_fields(run)
    solves = []
    for parent in (True, False, False, True):
        other = approximate_solve(g, parent=parent)
        got = other["launches"]
        folds = other["stage_calls"]["fold"]
        launched = (got["sketch_scatter_or"], got["sketch_fold_rows"])
        solves.append({"fold": "parent pairs" if parent
                       else "sketch_fold_rows", "solve_s": other["solve_s"],
                       "stage_s": other["stage_s"],
                       "stage_calls": other["stage_calls"],
                       "launches": {k: v for k, v in got.items() if v},
                       "launches_as_expected": launched == (
                           (folds, 0) if parent else (0, folds)),
                       "equal": approx_fields(other) == want})
        del other
    select_ms = turns_ms({
        "parent loop": lambda: parent_sketch_select(store, K),
        "greedy_sketch": lambda: store.select(K)})
    say("approximate_turns", {"solves": solves, "select_ms": select_ms})
    if not all(t["equal"] and t["launches_as_expected"] for t in solves):
        raise AssertionError("the parent's fold and sketch_fold_rows give "
                             "different solves or launches")
    # the sketch kernels at this path's shapes: the final sketch, the
    # seeds' union, and the pairs of the solve's first round
    words = store.words
    cov_words = torch.zeros(words.shape[1], dtype=torch.int32, device=g.device)
    for u in res.seeds.tolist():
        cov_words = sketch_mod.union_row(cov_words, words, u)
    v, b = frontier_pairs(batch.nodes, batch.lengths,
                          canonical_row_ids(batch.lengths, 0),
                          n_rows=words.shape[0], k=store.sketch_k,
                          mode=store.sketch_mode)
    records = sketch_records(words, cov_words, v, b, launches=launches)
    for rec in records:
        if rec["name"] == "sketch_union_popcount":
            rec["launches_note"] = ("no path launches it: greedy_sketch runs "
                                    "the approximate greedy")
        else:
            rec["launches_note"] = ("no path launches it: sketch_fold_rows "
                                    "folds the batches")
    fold = fold_record(words, batch.nodes, batch.lengths, k=store.sketch_k,
                       mode=store.sketch_mode, launches=launches)
    say("greedy_sketch_stamps", stamped_split("sketch", words, store.n_nodes))
    return records + [fold, sketch_greedy_record(words, store.n_nodes,
                                                 launches, plain_iters=3)]


def exact_regime_phase(store, bit) -> None:
    """Fold the exact pool into sketches; at sketch_k = row_capacity the
    sketch greedy must equal the bitset greedy, and at every size the
    certified lower bound must not exceed the rows the seeds cover and
    greedy_sketch must equal its plain version (its record at each
    width)."""
    n, t = store.n_nodes, store.n_elems
    flat, ids, valid = store.flat[:t], store.ids[:t], store.valid[:t]
    m = store.bitset_matrix()
    probes, greedy_recs = {}, []
    for sketch_k in dict.fromkeys((store.row_capacity(),) + PROBE_SKETCH_K):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        words = sketch_mod.sketch_packed_from_flat(
            flat, ids, valid, n_rows=n + 1, k=sketch_k, mode="mod")
        sk_store = cov.SketchRRStore.from_state(
            {"sk_words": words, "t_loc": [t], "nrr_loc": [store.n_rr]},
            {"n_nodes": n, "sketch_k": sketch_k, "sketch_mode": "mod"},
            device=words.device)
        info = {}
        res = cov.select_seeds_sketch(sk_store, K, info_out=info)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        greedy_recs.append(sketch_greedy_record(words, n, sketch_k=sketch_k))
        say("greedy_sketch_probe_stamps", dict(
            stamped_split("sketch", words, n), sketch_k=sketch_k))
        seeds = res.seeds.to(torch.int64)
        hit = ((m[:, seeds >> 5] >> (seeds & 31)) & 1).any(dim=1)
        true_rows = int(hit.sum())
        probes[sketch_k] = dict(info, true_rows=true_rows, seconds=secs,
                                hi_covers_true=info["hi_rows"] >= true_rows,
                                words_shape=list(words.shape))
        if info["lo_rows"] > true_rows:
            raise AssertionError(f"sketch_k={sketch_k}: certified lower bound "
                                 f"{info['lo_rows']} > true {true_rows}")
        if sketch_k == store.row_capacity():
            same = (torch.equal(res.seeds, bit.seeds)
                    and torch.equal(res.gains, bit.gains)
                    and res.frac.cpu().numpy().tobytes()
                    == bit.frac.cpu().numpy().tobytes())
            probes[sketch_k]["equals_bitset"] = same
            if not (same and info["exact_regime"]):
                say("exact_regime", probes)
                raise AssertionError("exact-regime sketch selection differs "
                                     "from the bitset selection")
        del words, sk_store
    say("exact_regime", probes)
    say("greedy_sketch_probes", greedy_recs)


def dense_solve_phase(g, queue_res, queue_store) -> None:
    """The exact solve with engine="dense": stage times, levels per round,
    peak memory and launches; it must equal the queue solve exactly."""
    dev = g.device
    solver = IMMSolver(g, engine="dense", batch=BATCH, selection="bitset",
                       seed=0, device=dev)
    clock = StageClock()
    clock.wrap(solver.engine, "sample", "sampling")
    clock.wrap(solver.store, "append_batch", "append")
    clock.wrap(solver.store, "bitset_matrix", "bitset_build")
    clock.wrap(solver.store, "select", "select_total")
    levels = []
    timed_sample = solver.engine.sample

    def sample(seed32):
        batch = timed_sample(seed32)
        levels.append(batch.steps)
        return batch

    solver.engine.sample = sample
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = solver.solve(IMProblem(k=K, eps=EPS))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st, qst, store = res.stats, queue_res.stats, solver.store
    sec = dict(clock.seconds)
    sec["selection"] = sec.pop("select_total") - sec["bitset_build"]
    same = {
        "theta": st.theta == qst.theta, "lb": st.lb == qst.lb,
        "lb_iters": st.lb_iters == qst.lb_iters,
        "rounds": st.rounds == qst.rounds,
        "n_rr": store.n_rr == queue_store.n_rr,
        "pool_elements": store.n_elems == queue_store.n_elems,
        "seeds": bool(np.array_equal(res.seeds, queue_res.seeds)),
        "gains": bool(np.array_equal(res.gains, queue_res.gains)),
        "frac_f32_bytes": np.float32(res.frac).tobytes()
        == np.float32(queue_res.frac).tobytes(),
    }
    say("dense_solve", {
        "theta": st.theta, "lb": st.lb, "lb_iters": st.lb_iters,
        "rounds": st.rounds, "n_rr": store.n_rr,
        "pool_elements": store.n_elems, "levels_per_round": levels,
        "sampling_levels": st.sampling_steps, "solve_s": solve_s,
        "stage_s": sec, "stage_calls": dict(clock.calls),
        "sampler_share": sec["sampling"] / solve_s,
        "max_memory_allocated": peak, "memory_before_solve": base_mem,
        "launches": launches, "spread": res.spread, "frac": res.frac,
        "equals_queue_solve": same, "seeds": res.seeds.tolist()[:10],
    })
    for name in ("bernoulli_edges", "occur_from_bitset",
                 "occur_from_bitset_masked"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the dense path")
    if not all(same.values()):
        raise AssertionError(f"dense solve differs from the queue solve: "
                             f"{same}")
    say("dense_round", profile_round(
        make_engine("dense", csr.reverse(g), batch=BATCH), round_seed(0, 0)))


def wrapper_split_us(a, b, iters: int = 200) -> dict:
    """Where the host's time of a ``bitset_or`` call goes, by enqueue
    microseconds a call of each part alone: the whole wrapper, its input
    check (``bitset._card``), the output's ``empty_like``, the raw stream
    handle, the ctypes call of the entry point with no words (it returns
    before the guard), the ctypes call of a probe with the same arguments
    that runs the guard alone (``bitops_guard``), the entry point with the
    words (ctypes, guard and launch); ``guard`` and ``launch`` are the
    differences; and ``torch.bitwise_or`` beside it."""
    dev = a.get_device()
    spare = torch.empty_like(a)
    entry = bitset._BINARY["bitset_or"]
    probe = _build.Kernel("bitops", "bitops_guard", entry.argtypes)
    stream = _build.raw_stream(dev)
    args = (a.data_ptr(), b.data_ptr())
    out = {
        "wrapper": enqueue_us(lambda: ops.bitset_or(a, b), iters),
        "card_checks": enqueue_us(lambda: bitset._card(a, b, "bitset_or"),
                                  iters),
        "empty_like": enqueue_us(lambda: torch.empty_like(a), iters),
        "raw_stream": enqueue_us(lambda: _build.raw_stream(dev), iters),
        "ctypes_call": enqueue_us(lambda: entry(*args, 0, spare.data_ptr(),
                                                dev, stream), iters),
        "ctypes_guard": enqueue_us(lambda: probe(*args, a.numel(),
                                                spare.data_ptr(), dev,
                                                stream), iters),
        "entry_point": enqueue_us(lambda: entry(*args, a.numel(),
                                                spare.data_ptr(), dev,
                                                stream), iters),
        "torch_bitwise_or": enqueue_us(lambda: torch.bitwise_or(a, b), iters),
    }
    out["guard"] = out["ctypes_guard"] - out["ctypes_call"]
    out["launch"] = out["entry_point"] - out["ctypes_guard"]
    return out


def packed_phase(g) -> list:
    """The packed sampler at full width: launches, Occur and sizes against
    the plain versions, the first lanes against a CPU run from the same
    roots, a ``bitset_or`` call's host time by part; returns the six dense
    kernels' records on this run's inputs."""
    dev = g.device
    g_rev = csr.reverse(g)                  # uncoalesced, as the reference
    seed32 = round_seed(0, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ps = dense.sample_rrsets_dense_packed(g_rev, BATCH, seed32, base_seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    occur_ok = torch.equal(ps.occur, ref.occur_from_bitset_ref(ps.words))
    sizes_ok = torch.equal(ps.sizes, ref.popcount_words_ref(ps.words).sum(
        dim=1, dtype=torch.int32))
    t0 = time.perf_counter()
    cpu = dense._sample_dense_packed(g_rev.to("cpu"), ps.roots[:CPU_LANES].cpu(),
                                     0)
    cpu_s = time.perf_counter() - t0
    lanes_ok = (torch.equal(ps.words[:CPU_LANES].cpu(), cpu.words)
                and torch.equal(ps.sizes[:CPU_LANES].cpu(), cpu.sizes)
                and torch.equal(ref.occur_from_bitset_ref(
                    ps.words[:CPU_LANES]).cpu(), cpu.occur))
    say("packed_sampler", {
        "batch": BATCH, "n": g_rev.n_nodes, "m": g_rev.n_edges,
        "words_shape": list(ps.words.shape), "levels": ps.levels,
        "mean_rr_size": float(ps.sizes.double().mean()),
        "max_rr_size": int(ps.sizes.max()), "wall_s": wall,
        "max_memory_allocated": peak, "launches": launches,
        "occur_equals_plain": occur_ok, "sizes_equal_plain": sizes_ok,
        "cpu_lanes": CPU_LANES, "cpu_levels": cpu.levels, "cpu_s": cpu_s,
        "cpu_lanes_equal": lanes_ok,
        "bitset_or_host_us": wrapper_split_us(ps.words, ps.words.clone()),
    })
    for name in ("pack_bits", "frontier_update", "popcount_words",
                 "bernoulli_edges", "occur_from_bitset"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched by the packed "
                                 "sampler")
    if launches["frontier_update"] != ps.levels or \
            launches["bitset_or"] or launches["bitset_andnot"]:
        raise AssertionError(f"{ps.levels} levels launched frontier_update "
                             f"{launches['frontier_update']} times, the "
                             f"pair {launches['bitset_andnot']} and "
                             f"{launches['bitset_or']}")
    if not (occur_ok and sizes_ok and lanes_ok):
        raise AssertionError("packed sampler disagrees with its plain "
                             "versions or with the CPU run")
    # the kernels on this run's inputs: the visited membership as bits, the
    # visited words against the roots' words, the level-0 trial seeds
    lane = torch.arange(BATCH, dtype=torch.int64, device=dev)
    root_bits = torch.zeros(BATCH, ps.words.shape[1] * 32, dtype=torch.bool,
                            device=dev)
    root_bits[lane, ps.roots.to(torch.int64)] = True
    return dense_records(dense._unpack_bits(ps.words), ps.words,
                         ref.pack_bits_ref(root_bits), g_rev.weights,
                         lane * dense._LANE_MUL, launches, iters=200)


def queue_call(fn, g_rev, seed32: int, qcap: int):
    return lambda: fn(g_rev.offsets, g_rev.indices, g_rev.weights, seed32,
                      BATCH, qcap=qcap, ec=EC_DEFAULT)


def check_queue_kernel(g_rev) -> dict:
    """The queue kernel against its plain version on the card at the
    exact path's first round (B = 512, ``round_seed(0, 0)``), at qcap = n
    and at :data:`QUEUE_QCAPS`: byte for byte in the queue rows, lengths,
    overflow flags, per-lane steps and roots.  A lane must overflow iff its
    RR set at qcap = n is longer than qcap, and some must at the last
    qcap."""
    seed32 = round_seed(0, 0)
    out, full_lengths = {}, None
    for qcap in (g_rev.n_nodes,) + QUEUE_QCAPS:
        got = queue_call(ops.queue_bfs, g_rev, seed32, qcap)()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = queue_call(ref.queue_round_ref, g_rev, seed32, qcap)()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        errs = [max_abs_err(x, y) for x, y in zip(got, want)]
        same = len(got) == len(want) == 5 and all(
            x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
            for x, y in zip(got, want))
        lanes_over = int(got[2].sum())
        if full_lengths is None:
            full_lengths = got[1]
        out[f"qcap_{qcap}"] = {
            "max_abs_err": max(errs), "equal": same,
            "overflowed_lanes": lanes_over, "longest": int(got[1].max()),
            "steps": int(got[3].max()), "elements": int(got[1].sum()),
            "plain_s": plain_s}
        if not same or any(errs):
            raise AssertionError(f"queue_bfs != plain version at qcap "
                                 f"{qcap}: max abs errs {errs}")
        if not torch.equal(got[2], full_lengths > qcap):
            raise AssertionError(f"{lanes_over} lanes overflowed at qcap "
                                 f"{qcap}, not those with longer sets")
    if lanes_over == 0:
        raise AssertionError(f"no lane overflowed at qcap {qcap}")
    return out


def queue_bound(g_rev, queue, lengths) -> tuple:
    """The round's least time.  Bytes: each reverse row the round walks is
    read once however many lanes walk it (lanes re-read shared rows, the
    hubs' above all, from L2): its destinations and weights (8 bytes an
    edge) and its two offsets (8); the queue rows are written once in
    full, their zeros included (4 bytes a cell: the kernel writes them);
    each lane writes its root, length, flag and steps (17 bytes).  Left
    out: the visited words (the kernel's own scratch, in shared memory or
    L2).  Operations: one trial an examined edge, counted as
    :data:`TRIAL_WORK_OPS`, each class at its own rate.  Also returns the
    work: edges examined, the distinct rows walked and their edges, nodes
    dequeued, and the longest lane's edges and block-wide compactions,
    which make its chain of dependent steps."""
    work = lane_work(g_rev, queue, lengths)
    examined, dequeued = int(work["edges"].sum()), int(lengths.sum())
    rows = torch.unique(work["nodes"][work["valid"]])
    offs = g_rev.offsets.to(torch.int64)
    row_edges = int((offs[rows + 1] - offs[rows]).sum())
    nbytes = 8 * row_edges + 8 * rows.numel() + 4 * queue.numel() \
        + 17 * queue.shape[0]
    bound = _bound(nbytes, {k: v * examined
                            for k, v in TRIAL_WORK_OPS.items()})
    return bound, {"examined_edges": examined,
                   "distinct_rows": rows.numel(),
                   "distinct_row_edges": row_edges,
                   "dequeued_nodes": dequeued,
                   "longest_lane_edges": int(work["edges"].max()),
                   "longest_lane_segments": int(work["segments"].max())}


def one_sm_bound(trials: int) -> dict:
    """The least time for ``trials`` edge trials on one SM: each class of
    :data:`TRIAL_WORK_OPS` at one SM's rate (PER_SM_CLOCK at the maximum
    SM clock), and all of them at its dispatch rate.  A block runs a lane
    on one SM, so a round takes at least its longest lane's."""
    mhz = card_rates()["clocks_max_sm_mhz"]
    per = {k: trials * v / PER_SM_CLOCK[k] / mhz / 1e3
           for k, v in TRIAL_WORK_OPS.items()}
    per["dispatch"] = trials * sum(TRIAL_WORK_OPS.values()) \
        / PER_SM_CLOCK["dispatch"] / mhz / 1e3
    pipe = max(per, key=per.get)
    return {"one_sm_bound_ms": per[pipe], "one_sm_bound_class": pipe}


def queue_record(g_rev, launches, err, iters=20, plain_iters=1) -> dict:
    """The queue kernel's record at the exact path's first round (qcap =
    n): timed beside its plain version, with the card's bound, the longest
    lane's one-SM bound beside it, and the work."""
    seed32, qcap = round_seed(0, 0), g_rev.n_nodes
    kern = queue_call(ops.queue_bfs, g_rev, seed32, qcap)
    times = timing("queue_bfs", kern, iters)
    plain_ms = cuda_ms(queue_call(ref.queue_round_ref, g_rev, seed32, qcap),
                       plain_iters)
    queue, lengths = kern()[:2]
    bound, work = queue_bound(g_rev, queue, lengths)
    return record("queue_bfs", launches, err, times, plain_ms, bound,
                  **one_sm_bound(work["longest_lane_edges"]),
                  shape=[BATCH, qcap], ec=EC_DEFAULT, **work)


def membership_record(rows, lengths, u, launches=None, iters=50,
                      plain_iters=10):
    """The membership kernel against its plain version on the same inputs
    (u as the card tensor the greedy passes, and as an int), exactly; then
    timed beside the plain version."""
    want = ref.membership_rows_ref(rows, lengths, u)
    for arg in (u, int(u)):
        got = ops.membership_rows(rows, lengths, arg)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"membership_rows != plain version at "
                                 f"{tuple(rows.shape)}, u={int(u)}: max abs "
                                 f"err {err}")
    r, l = rows.shape
    u_int = int(u)
    return record(
        "membership_rows", launches, err,
        timing("membership_rows",
               lambda: ops.membership_rows(rows, lengths, u), iters),
        cuda_ms(lambda: ref.membership_rows_ref(rows, lengths, u),
                plain_iters),
        membership_bound_ms(lengths, l), shape=[r, l],
        valid_elements=int(lengths.to(torch.int64).clamp(0, l).sum()),
        padded_bytes=r * l * 4, hits=int(want.sum()),
        enqueue_us_int_u=enqueue_us(
            lambda: ops.membership_rows(rows, lengths, u_int), iters))


def ragged_membership_checks(gen, n: int) -> dict:
    """The membership kernel at ragged shapes: R off every block, L off
    128, lengths 0, L and past L, u = n (the padding value), exact."""
    dev = gen.device
    out = {}
    for r, l in ((1, 1), (7, 3), (257, 130)):
        rows = torch.randint(0, 8, (r, l), device=dev, generator=gen,
                             dtype=torch.int32)
        lens = torch.randint(0, l + 1, (r,), device=dev, generator=gen,
                             dtype=torch.int32)
        lens[0] = l
        if r > 2:
            lens[1], lens[2] = 0, l + 5
        lane = torch.arange(l, device=dev)[None, :]
        rows = torch.where(lane < lens[:, None], rows, n)
        for u in (0, 7, n):
            got = ops.membership_rows(rows, lens, u)
            want = ref.membership_rows_ref(rows, lens, u)
            if not torch.equal(got, want):
                raise AssertionError(f"membership_rows != plain version at "
                                     f"({r}, {l}), u={u}")
        out[f"{r}x{l}"] = 0
    return out


def pool_args(store) -> tuple:
    """The store's live pool and greedy_flat's keywords at k = K."""
    t = store.n_elems
    return (store.flat[:t], store.ids[:t], store.valid[:t]), dict(
        n=store.n_nodes, num_rows=store.row_capacity(), k=K)


def greedy_bound(flat, ids, valid, seeds, *, n, num_rows, k, blocks,
                 shared) -> dict:
    """The greedy's least time.  Bytes: the pool read once (flat and ids 4
    bytes an element, valid 1) and the seeds and gains written once.
    Operations: one compare an Occur entry a step (the argmax) and one
    decrement a valid element of each row the seeds cover, on the ALU.
    Also the working set, what the kernel's design moves through L2 and
    memory (``working_bytes_ms``).  The prologue: count zeroed, its
    atomics (one a counted element) and two reads; cursor written and its
    atomics; row_start written and its binary searches' reads of ids;
    flat, valid and ids read and nodes written and read (17 bytes an
    element); the m counted elements' entries written (12 bytes) with the
    row starts they copy (8).  The exchanges: each block writes a
    16-byte record a step and reads every block's.  The covers: each
    block, in each of the k - 1 covers (the last step walks no row), reads
    each of u's entries (12 bytes) and the node of each element of the
    rows it newly covers (4 bytes), from L2; Occur and Covered are in
    shared memory (``shared``), else each argmax also reads a block's
    slice of Occur.  And the work's counts."""
    t = flat.shape[0]
    f = flat.to(torch.int64)
    counted = valid & (f < n)
    m = int(counted.sum())
    occur0 = torch.zeros(n + 1, dtype=torch.int64,
                         device=flat.device).index_add_(
        0, torch.where(counted, f, n), counted.to(torch.int64))[:n]

    def covered_by(some):
        hit = torch.isin(f, some.to(torch.int64)) & counted
        rows_hit = torch.zeros(num_rows, dtype=torch.bool, device=flat.device)
        rows_hit[ids[hit].to(torch.int64)] = True
        return rows_hit[ids.to(torch.int64)]

    covered_elems = int((covered_by(seeds) & valid).sum())
    walked_rows = int(occur0[seeds[:-1].to(torch.int64)].sum())
    walked_elems = int(covered_by(seeds[:-1]).sum())
    bound = _bound(9 * t + 8 * k, {"alu": k * n + covered_elems})
    searches = (num_rows + 1) * max(1, math.ceil(math.log2(t + 1)))
    prologue = 12 * n + 4 * m + 4 * n + 4 * m + 4 * (num_rows + 1) \
        + 4 * searches + 17 * t + 20 * m
    exchanges = 16 * k * blocks * (blocks + 1)
    covers = blocks * (12 * walked_rows + 4 * walked_elems)
    if not shared:
        covers += 4 * n * k
    working = prologue + exchanges + covers
    return dict(bound, working_bytes=working,
                working_bytes_ms=working / HBM_BYTES_S * 1e3,
                working_prologue_bytes=prologue,
                working_exchange_bytes=exchanges,
                working_cover_bytes=covers, seed_rows_walked=walked_rows,
                elements_walked_a_block=walked_elems,
                decremented_elements=covered_elems)


def greedy_record(store, launches, iters=20, plain_iters=3) -> dict:
    """greedy_flat on the store's pool against its plain version on the
    card (seeds and gains byte for byte), the device operations of 10 calls
    (:func:`traced_device_ops`: the kernel alone, at most once a call; it
    builds the pool's index itself), then timed beside the plain version,
    with the
    bound, the working set, the grid, where the blocks' state lives, and
    the barrier floor: the same grid running its k + 3 grid barriers
    alone."""
    args, kw = pool_args(store)
    got = ops.greedy_flat(*args, **kw)
    want = ref.greedy_flat_ref(*args, **kw)
    torch.cuda.synchronize()
    err = max(max_abs_err(x, y) for x, y in zip(got, want))
    if err or not all(x.dtype == y.dtype and torch.equal(x, y)
                      for x, y in zip(got, want)):
        raise AssertionError(f"greedy_flat != plain version at {store.n_rr} "
                             f"rows: max abs err {err}")
    dev = store.flat.device
    kernel, calls = DEVICE_KERNEL["greedy_flat"], 10
    dev_ops, traces = traced_device_ops(lambda: ops.greedy_flat(*args, **kw),
                                        kernel, calls)
    names = sorted({e.name[:80] for e in dev_ops})
    # the trace may drop a record, never add one
    if not 1 <= len(dev_ops) <= calls or len(names) != 1 \
            or not re.search(kernel, names[0]):
        raise AssertionError(f"{calls} greedy_flat calls made the device "
                             f"operations {names} ({len(dev_ops)} in all, "
                             f"{traces} traces)")
    times = timing("greedy_flat", lambda: ops.greedy_flat(*args, **kw), iters)
    plain_ms = cuda_ms(lambda: ref.greedy_flat_ref(*args, **kw), plain_iters)
    floor_ms = cuda_ms(lambda: greedy.grid_barriers(K + 3, dev), iters)
    blocks, shared_bytes = greedy.flat_grid(dev)
    lay = greedy.flat_layout(kw["n"], kw["num_rows"], blocks, shared_bytes)
    return record("greedy_flat", launches, err, times, plain_ms,
                  greedy_bound(*args, got[0], **kw, blocks=blocks,
                               shared=lay.shared),
                  barrier_floor_ms=floor_ms, grid_barriers=K + 3,
                  device_op_names=names, device_ops_traced=len(dev_ops),
                  calls_traced=calls, device_op_traces=traces,
                  grid_blocks=blocks, threads=greedy.THREADS,
                  state="shared memory" if lay.shared else "scratch",
                  slice_nodes=lay.slots, covered_words=lay.cov_words,
                  shared_bytes_limit=shared_bytes, n=kw["n"], k=K,
                  n_rr=store.n_rr, pool_elements=store.n_elems,
                  num_rows=kw["num_rows"], gains_sum=int(got[1].sum()))


def default_solve_phase(g, queue_res, queue_store) -> list:
    """The exact solve with the default options (``selection="auto"``,
    which takes ``flat`` on this pool): stage times, peak memory and
    launches (greedy_flat once a greedy, no popcount_words, no Occur
    kernel); it must equal the phase-5 ``bitset`` solve exactly.  One
    ``flat`` selection on its final pool must make no host sync.  Returns
    greedy_flat's record at this pool, and prints it at the pool of an
    eps = EPS_LOW solve."""
    dev = g.device
    solver = IMMSolver(g, engine="queue", batch=BATCH, seed=0, device=dev)
    clock = StageClock()
    clock.wrap(solver.engine, "sample", "sampling")
    clock.wrap(solver.store, "append_batch", "append")
    clock.wrap(solver.store, "bitset_matrix", "bitset_build")
    clock.wrap(solver.store, "select", "selection")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = solver.solve(IMProblem(k=K, eps=EPS))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st, qst, store = res.stats, queue_res.stats, solver.store
    n_words = (store.n_nodes + 31) // 32
    same = {
        "theta": st.theta == qst.theta, "lb": st.lb == qst.lb,
        "lb_iters": st.lb_iters == qst.lb_iters,
        "rounds": st.rounds == qst.rounds,
        "n_rr": store.n_rr == queue_store.n_rr,
        "pool_elements": store.n_elems == queue_store.n_elems,
        "seeds": bool(np.array_equal(res.seeds, queue_res.seeds)),
        "gains": bool(np.array_equal(res.gains, queue_res.gains)),
        "frac_f32_bytes": np.float32(res.frac).tobytes()
        == np.float32(queue_res.frac).tobytes(),
    }
    calls, greedies = dict(clock.calls), clock.calls["selection"]
    store.select(K, method="flat")
    torch.cuda.synchronize()
    _, sync_sites = count_syncs(lambda: store.select(K, method="flat"))
    torch.cuda.synchronize()
    say("default_solve", {
        "selection": st.selection, "auto_takes": "bitset"
        if store.row_capacity() * n_words <= store.capacity else "flat",
        "theta": st.theta, "lb": st.lb, "lb_iters": st.lb_iters,
        "rounds": st.rounds, "n_rr": store.n_rr,
        "pool_elements": store.n_elems, "pool_capacity": store.capacity,
        "solve_s": solve_s, "stage_s": dict(clock.seconds),
        "stage_calls": calls, "max_memory_allocated": peak,
        "launches": launches, "spread": res.spread, "frac": res.frac,
        "equals_bitset_solve": same, "select_host_syncs": len(sync_sites),
        "select_host_sync_sites": sync_sites,
        "seeds": res.seeds.tolist()[:10]})
    if not all(same.values()):
        raise AssertionError(f"default solve differs from the bitset "
                             f"solve: {same}")
    if launches["greedy_flat"] != greedies or greedies != 3 \
            or launches["popcount_words"] or launches["occur_from_bitset"] \
            or launches["queue_bfs"] == 0 or calls["bitset_build"]:
        raise AssertionError(f"default solve: {greedies} greedies, launches "
                             f"{launches}, {calls['bitset_build']} bit-matrix "
                             f"builds")
    if sync_sites:
        raise AssertionError(f"a flat selection synced the host: "
                             f"{sync_sites}")
    rec = greedy_record(store, launches)
    # the same greedy at the pool of the sweep's smallest eps
    low = IMMSolver(g, engine="queue", batch=BATCH, seed=0, device=dev)
    t0 = time.perf_counter()
    low_res = low.solve(IMProblem(k=K, eps=EPS_LOW))
    torch.cuda.synchronize()
    say("greedy_flat_eps_low", dict(
        greedy_record(low.store, None), eps=EPS_LOW,
        theta=low_res.stats.theta, solve_s=time.perf_counter() - t0))
    return [rec]


def celf_bytes(flat, ids, valid, num_rows: int, nodes, apply: bool) -> int:
    """Bytes of CELF's exact evaluation of the candidates ``nodes``, or of
    the commit of the one seed in ``nodes``, at least: the node id of every
    element of the pool's live extent read once (4 bytes an element); only
    for the elements that hold one of ``nodes``, their valid byte, the row
    id of each valid one (4 bytes) and the distinct Covered words of those
    rows below ``num_rows``, read once (and written once by the commit);
    the candidates read and their counts written (the commit: its gain).
    Scratch bitmaps are a kernel's own choice and not counted."""
    t = flat.shape[0]
    hit = torch.isin(flat, nodes.to(flat.dtype))
    live = hit & valid
    rows = ids[live].to(torch.int64)
    rows = rows[(rows >= 0) & (rows < num_rows)]
    words = int(torch.unique(rows >> 5).numel())
    return (4 * t + int(hit.sum()) + 4 * int(live.sum())
            + (8 * words + 4 if apply else 4 * words + 8 * nodes.numel()))


def celf_bound(flat, ids, valid, cov_words, nodes, apply: bool) -> dict:
    """:func:`celf_bytes` over the HBM rate, or one compare an element on
    the ALU."""
    return _bound(celf_bytes(flat, ids, valid, 32 * cov_words.shape[0],
                             nodes, apply), {"alu": flat.shape[0]})


def from_memory(nbytes: int, reads: int) -> int:
    """The bytes of ``reads`` (>= 1) reads of the same ``nbytes`` that
    must come from memory at least: all of the first read, and of each
    later one what the L2 (:data:`L2_BYTES`) cannot have kept."""
    return nbytes + (reads - 1) * max(0, nbytes - L2_BYTES)


def celf_select_bound(flat, ids, valid, num_rows: int, batches, seeds,
                      sketch, n: int) -> dict:
    """The least time of one CELF selection for this run's work.  Bytes:
    each input read once, and read again only as far as it exceeds the L2
    (:func:`from_memory`): the node ids (4 an element) read by Occur, each
    eval call (``batches``, as the plain version evaluated them) and each
    commit; the valid bytes; the row ids of the valid elements that hold a
    candidate or a seed; the n sketch rows, read by each seed's sweep; the
    seeds and gains written.  Operations: a compare an element for Occur,
    an eval call and a commit on the ALU, and an OR, an add and a popcount
    a sketch word a seed.  Also what the design moves, from L2 or memory:
    ``working_bytes``, each eval call's and commit's bytes as
    :func:`celf_bytes` counts them, and ``sweep_bytes``, the sketch rows
    once a seed."""
    t, dev, k = flat.shape[0], flat.device, len(seeds)
    nodes = torch.cat([torch.from_numpy(c).to(dev, torch.int64)
                       for c in batches]
                      + [torch.tensor(seeds, dtype=torch.int64, device=dev)])
    live = int((torch.isin(flat.to(torch.int64), nodes) & valid).sum())
    nbytes = from_memory(4 * t, 1 + len(batches) + k) + t + 4 * live + 8 * k
    alu, xu = (1 + len(batches) + k) * t, 0
    working = sum(celf_bytes(flat, ids, valid, num_rows,
                             torch.from_numpy(c).to(dev), False)
                  for c in batches) + sum(
        celf_bytes(flat, ids, valid, num_rows,
                   torch.tensor([u], device=dev), True) for u in seeds)
    sweep = sketch_bytes = 0
    if sketch is not None:
        w = sketch.shape[1]
        sketch_bytes = 4 * n * w
        nbytes += from_memory(sketch_bytes, k)
        sweep = k * sketch_bytes
        alu += k * 2 * n * w
        xu += k * n * w
    return {**_bound(nbytes, {"alu": alu, "xu": xu}), "bound_bytes": nbytes,
            "bound_batches": len(batches), "working_bytes": working,
            "working_bytes_ms": working / HBM_BYTES_S * 1e3,
            "sweep_bytes": sweep, "sweep_bytes_ms": sweep / HBM_BYTES_S * 1e3,
            "sketch_fits_l2": sketch_bytes <= L2_BYTES}


def celf_select_record(store, launches, iters=50) -> dict:
    """celf_select on the store's final pool and sketch at the default
    batch (32 candidates): against its plain version on the card (seeds,
    gains and stats byte for byte; the plain version also gives each eval
    call's candidates, which the bound counts), timed beside it, with
    :func:`celf_select_bound` and the barrier floor: the same grid
    (``greedy_flat``'s, a block of 512 on each SM) running as many grid
    barriers as the launch ran, alone."""
    t, n = store.n_elems, store.n_nodes
    pool = (store.flat[:t], store.ids[:t], store.valid[:t])
    sketch, dev = store.sketch_words(), pool[0].device
    kw = dict(n=n, num_rows=store.row_capacity(), k=K, c=32)
    got = celf_mod.celf_select(*pool, sketch=sketch, **kw)
    batches = []
    want = ref.celf_select_ref(*pool, sketch=sketch, calls_out=batches, **kw)
    torch.cuda.synchronize()
    err = max(max_abs_err(x, y) for x, y in zip(got[:3], want))
    if err or not all(x.dtype == y.dtype and torch.equal(x, y)
                      for x, y in zip(got[:3], want)):
        raise AssertionError(f"celf_select != plain version at sketch_k "
                             f"{store.sketch_k}: max abs err {err}")
    barriers = int(got[3])
    times = timing("celf_select",
                   lambda: ops.celf_select(*pool, sketch=sketch, **kw), iters)
    plain_ms = cuda_ms(lambda: ref.celf_select_ref(*pool, sketch=sketch,
                                                   **kw), 1)
    floor_ms = cuda_ms(lambda: greedy.grid_barriers(barriers, dev), iters)
    blocks, shared_words = celf_mod.select_grid(dev)
    if blocks != greedy.grid_blocks(dev):
        raise AssertionError(f"celf_select's grid of {blocks} blocks is not "
                             f"greedy_flat's: no barrier floor")
    evals, calls = want[2].tolist()
    lay = celf_mod.select_layout(n, kw["num_rows"], kw["c"], sketch.shape[1],
                                 blocks, shared_words, t)
    if lay.list and barriers != celf_mod.list_barriers(K, calls):
        raise AssertionError(f"celf_select ran {barriers} grid barriers, the "
                             f"top-list path "
                             f"{celf_mod.list_barriers(K, calls)}")
    return record("celf_select", launches, err, times, plain_ms,
                  celf_select_bound(*pool, kw["num_rows"], batches,
                                    want[0].tolist(), sketch, n),
                  barrier_floor_ms=floor_ms, grid_barriers=barriers,
                  layout=lay._asdict(),
                  exact_evals=evals, eval_calls=calls, candidates=kw["c"],
                  grid_blocks=blocks, shared_words_limit=shared_words,
                  sketch_k=store.sketch_k, sketch_words=sketch.shape[1], n=n,
                  k=K, pool_elements=t, num_rows=kw["num_rows"],
                  gains_sum=int(got[1].sum()))


def celf_variant_batch(store, spec, step: int):
    """The CELF variant (``select_seeds_celf(spec=...)``) on the store's
    pool once more, its ``celf_eval`` calls watched: the first call of step
    ``step`` (after ``step`` commits), the padded batch of ``c`` = 32 ids
    (-1 past the batch's nodes) it passes and the Covered words it sees."""
    seen, commits = [], [0]
    eval_fn, apply_fn = ops.celf_eval, ops.celf_apply

    def celf_eval(flat, ids, valid, cov_words, cands, **kw):
        if commits[0] == step and not seen:
            seen.append((cov_words.clone(), cands.clone()))
        return eval_fn(flat, ids, valid, cov_words, cands, **kw)

    def celf_apply(*args, **kw):
        commits[0] += 1
        return apply_fn(*args, **kw)

    ops.celf_eval, ops.celf_apply = celf_eval, celf_apply
    try:
        cov.select_seeds_celf(store, 0, spec=spec)
    finally:
        ops.celf_eval, ops.celf_apply = eval_fn, apply_fn
    if not seen:
        raise AssertionError(f"the CELF variant made no eval call at step "
                             f"{step}")
    return seen[0]


def celf_records(store, seeds, launches, iters=50, plain_iters=3,
                 spec=None) -> list:
    """The CELF kernels and the sweep at this path's shapes: the solve's
    final pool, Covered after its first 10 seeds, the sweep's 32 candidates
    there (the sketch's top Δocc keys, as ``select_seeds_celf`` picks them;
    with a variant ``spec`` the padded batch its first eval call of that
    step passes, :func:`celf_variant_batch`, whose Covered words must be
    the same) and the commit of the 11th seed.  Each against its plain
    version exactly, then timed beside it, with its bound; the sweep at
    that cover (``union_gains``, ``popcount_words`` on the (1, W) cover
    included) against its plain version exactly too.  Returns the records
    of ``celf_eval``, ``celf_apply`` and ``sketch_union_popcount`` (the
    store's sketch)."""
    t = store.n_elems
    pool = (store.flat[:t], store.ids[:t], store.valid[:t])
    dev = pool[0].device
    n = store.n_nodes
    words = store.sketch_words()
    cov_words = torch.zeros(store.row_capacity() // 32, dtype=torch.int32,
                            device=dev)
    cov_sk = torch.zeros(words.shape[1], dtype=torch.int32, device=dev)
    first = min(10, len(seeds) - 1)
    for u in seeds[:first]:
        ref.celf_apply_ref(*pool, cov_words, u)
        cov_sk = sketch_mod.union_row(cov_sk, words, u)
    if spec is None:
        deltas = sketch_mod.union_gains(words, cov_sk)[:n]
        key = deltas.to(torch.int64) * (n + 1) - torch.arange(n, device=dev)
        cands = torch.topk(key, 32).indices.to(torch.int32)
    else:
        seen_cov, cands = celf_variant_batch(store, spec, first)
        if not torch.equal(seen_cov, cov_words):
            raise AssertionError("the CELF variant's Covered words after "
                                 f"{first} seeds differ from the commits'")
    u = int(seeds[first])
    got = ops.celf_eval(*pool, cov_words, cands)
    want = ref.celf_eval_ref(*pool, cov_words, cands)
    mine, plain = cov_words.clone(), cov_words.clone()
    gain = ops.celf_apply(*pool, mine, u)
    want_gain = ref.celf_apply_ref(*pool, plain, u)
    pop = ops.sketch_union_popcount(words, cov_sk)
    pop_want = ref.sketch_union_popcount_ref(words, cov_sk)
    # the sweep's base term and the whole sweep, against the plain versions
    # on a host copy (a CPU tensor takes them)
    base = ops.popcount_words(cov_sk.reshape(1, -1))
    base_want = ref.popcount_words_ref(cov_sk.reshape(1, -1))
    sweep = sketch_mod.union_gains(words, cov_sk)
    sweep_want = sketch_mod.union_gains(words.cpu(), cov_sk.cpu())
    torch.cuda.synchronize()
    errs = {"celf_eval": max_abs_err(got, want),
            "celf_apply": float(max(abs(int(gain) - int(want_gain)),
                                    max_abs_err(mine, plain))),
            "sketch_union_popcount": max_abs_err(pop, pop_want),
            "popcount_words": max_abs_err(base, base_want),
            "union_gains": max_abs_err(sweep.cpu(), sweep_want)}
    if any(errs.values()) or not (torch.equal(got, want)
                                  and torch.equal(mine, plain)
                                  and torch.equal(pop, pop_want)
                                  and torch.equal(base, base_want)
                                  and torch.equal(sweep.cpu(), sweep_want)):
        raise AssertionError(f"CELF kernels != plain versions: {errs}")
    say("celf_sweep_check", {"sketch_k": store.sketch_k, "cover_bits":
                             int(base.sum()), "max_abs_err": errs})
    scratch = cov_words.clone()       # a repeated commit does the same work
    rows, cols = words.shape
    shapes = dict(pool_elements=t, num_rows=store.row_capacity(),
                  covered_words=cov_words.shape[0], n=n)
    return [
        record("celf_eval", launches, errs["celf_eval"],
               timing("celf_eval",
                      lambda: ops.celf_eval(*pool, cov_words, cands), iters),
               cuda_ms(lambda: ref.celf_eval_ref(*pool, cov_words, cands),
                       plain_iters),
               celf_bound(*pool, cov_words, cands, False),
               candidates=int((cands >= 0).sum()), batch=cands.numel(),
               gains_sum=int(got.sum()), **shapes),
        record("celf_apply", launches, errs["celf_apply"],
               timing("celf_apply",
                      lambda: ops.celf_apply(*pool, scratch, u), iters),
               cuda_ms(lambda: ref.celf_apply_ref(*pool, plain, u),
                       plain_iters),
               celf_bound(*pool, cov_words,
                          torch.tensor([u], device=dev), True),
               seed=u, gain=int(gain), **shapes),
        record("sketch_union_popcount", launches,
               errs["sketch_union_popcount"],
               timing("sketch_union_popcount",
                      lambda: ops.sketch_union_popcount(words, cov_sk),
                      iters),
               cuda_ms(lambda: ref.sketch_union_popcount_ref(words, cov_sk),
                       plain_iters), union_bound_ms(rows, cols),
               shape=[rows, cols], sketch_k=store.sketch_k),
    ]


def host_copy(store):
    """A CPU ``DeviceRRStore`` of the same sketch size and bucketing that
    holds ``store``'s pool, appended as one padded batch of its rows: its
    incremental sketch is the plain fold (``sketch_fold_rows_ref``) of the
    same rows under the same row ids, and its selection runs the plain
    versions of every kernel."""
    t = store.n_elems
    flat, ids = store.flat[:t].cpu(), store.ids[:t].cpu().to(torch.int64)
    if not bool(store.valid[:t].all()):
        raise AssertionError("the pool's live extent holds invalid elements")
    lens = torch.bincount(ids, minlength=store.n_rr)
    start = torch.cumsum(lens, 0) - lens
    nodes = torch.full((store.n_rr, max(int(lens.max()), 1)), store.n_nodes,
                       dtype=torch.int32)
    nodes[ids, torch.arange(t) - start[ids]] = flat
    copy = cov.DeviceRRStore(store.n_nodes, sketch_k=store.sketch_k,
                             sketch_mode=store.sketch_mode, device="cpu")
    copy.append_batch((nodes, lens))
    if not (torch.equal(copy.flat[:t], flat)
            and torch.equal(copy.ids[:t].to(torch.int64), ids)
            and copy.n_rr == store.n_rr):
        raise AssertionError("the host copy's pool differs from the card's")
    return copy


def check_celf_on_host(store, card: cov.CoverageResult, card_stats: dict
                       ) -> dict:
    """Hold the card's CELF path against the plain versions on a host copy
    of its pool (:func:`host_copy`): the incremental sketch word for word
    (the ``sketch_fold_rows`` fold of every append), and one selection's
    seeds, gains, frac and ``stats_out`` (its exact evaluations and eval
    calls depend on the sketch) against ``select_seeds_celf`` on the copy,
    whose CPU tensors take ``ref.celf_select_ref``.  Raises on any
    difference; returns what was compared and the seconds the host
    took."""
    t0 = time.perf_counter()
    copy = host_copy(store)
    sketch_same = torch.equal(store.sketch_words().cpu(), copy.sketch_words())
    stats = {}
    res = cov.select_seeds_celf(copy, card.seeds.numel(), stats_out=stats)
    same = {
        "sketch_words": sketch_same,
        "seeds": torch.equal(card.seeds.cpu(), res.seeds),
        "gains": torch.equal(card.gains.cpu(), res.gains),
        "frac_f32_bytes": card.frac.cpu().numpy().tobytes()
        == res.frac.numpy().tobytes(),
        "stats_out": card_stats == stats,
    }
    out = {"equal": same, "host_stats": stats,
           "host_s": time.perf_counter() - t0}
    if not all(same.values()):
        raise AssertionError(f"CELF on the card != the plain versions on a "
                             f"host copy: {out}, card stats {card_stats}")
    return out


def celf_phase(g, queue_res, queue_store) -> tuple:
    """The phase-5 solve with ``selection="celf"`` at each of
    :data:`CELF_SOLVES`: stage times (the fold inside each append on its
    own, ``stage_s.fold``), launches (``celf_select`` once a selection, the
    exact store's fold ``sketch_fold_rows`` once an append, and
    ``sketch_union_popcount`` and ``popcount_words`` only from the early
    exit's gate; ``celf_eval``, ``celf_apply`` and ``sketch_scatter_or``
    never), the early exit's
    skips, and, on the final pool, one selection's exact evaluations and
    host syncs (:func:`count_syncs`: exactly one).  Each must equal phase 5
    in θ, LB, rounds, RR sets, pool elements, seeds, gains and the float32
    bytes of frac, and its sketch and that selection must equal the plain
    versions' on a host copy of the pool (:func:`check_celf_on_host`).
    Returns the record of :func:`celf_select_record` at sketch_k 1,024 and
    the early exit's launches, and prints the :func:`celf_records` (the
    kernels no selection here launches, held to their plain versions at
    this pool) on ``celf_kernels_1024:`` and ``celf_kernels_16384:``
    lines."""
    dev = g.device
    qst = queue_res.stats
    out, gate_launches = [], None
    for selection, sketch_k, early in CELF_SOLVES:
        problem = IMProblem(k=K, eps=EPS, early_exit=early)
        solver = IMMSolver(g, engine="queue", batch=BATCH,
                           selection=selection, sketch_k=sketch_k, seed=0,
                           device=dev)
        solver.prepare(problem)
        clock = StageClock()
        clock.wrap(solver.engine, "sample", "sampling")
        clock.wrap(solver.store, "append_batch", "append")
        clock.wrap(solver.store, "fold_batch", "fold")
        clock.wrap(solver.store, "select", "selection")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = solver.solve(problem)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        st, store = res.stats, solver.store
        same = {
            "theta": st.theta == qst.theta, "lb": st.lb == qst.lb,
            "rounds": st.rounds == qst.rounds,
            "n_rr": store.n_rr == queue_store.n_rr,
            "pool_elements": store.n_elems == queue_store.n_elems,
            "seeds": bool(np.array_equal(res.seeds, queue_res.seeds)),
            "gains": bool(np.array_equal(res.gains, queue_res.gains)),
            "frac_f32_bytes": np.float32(res.frac).tobytes()
            == np.float32(queue_res.frac).tobytes(),
        }
        calls, stage_s = dict(clock.calls), dict(clock.seconds)
        stats = {}
        final = cov.select_seeds_celf(store, K, stats_out=stats)
        host_check = check_celf_on_host(store, final, stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, sync_sites = count_syncs(lambda: store.select(K, method="celf"))
        torch.cuda.synchronize()
        select_s = time.perf_counter() - t0
        say("celf_solve", {
            "selection": selection, "sketch_k": store.sketch_k,
            "early_exit": early, "sketch_bytes": store.sketch_bytes(),
            "theta": st.theta, "lb": st.lb, "lb_iters": st.lb_iters,
            "rounds": st.rounds, "n_rr": store.n_rr,
            "pool_elements": store.n_elems, "solve_s": solve_s,
            "stage_s": stage_s, "stage_calls": calls,
            "early_exit_skips": st.early_exit_skips, "history": st.history,
            "max_memory_allocated": peak, "launches": launches,
            "final_selection": stats, "final_selection_s": select_s,
            "host_check": host_check,
            "select_host_syncs": len(sync_sites),
            "select_host_sync_sites": sorted(set(sync_sites)),
            "equals_phase5_solve": same, "seeds": res.seeds.tolist()[:10]})
        if not all(same.values()):
            raise AssertionError(f"celf solve at sketch_k {sketch_k}, "
                                 f"early_exit {early} differs from phase 5: "
                                 f"{same}")
        gate = ("sketch_union_popcount", "popcount_words")
        for name in ("celf_select", "sketch_fold_rows", "queue_bfs") + (
                gate if early else ()):
            if launches[name] == 0:
                raise AssertionError(f"{name} was not launched on the CELF "
                                     f"path: {launches}")
        if launches["sketch_fold_rows"] != calls["fold"] or \
                calls["fold"] != calls["append"]:
            raise AssertionError(f"{calls['append']} appends made "
                                 f"{calls['fold']} folds and "
                                 f"{launches['sketch_fold_rows']} "
                                 f"sketch_fold_rows launches")
        off_path = [name for name in ("celf_eval", "celf_apply",
                                      "sketch_scatter_or") + (
            () if early else gate) if launches[name]]
        if off_path or launches["celf_select"] != calls["selection"]:
            raise AssertionError(f"{calls['selection']} selections made "
                                 f"{launches['celf_select']} celf_select "
                                 f"launches; off the path: {off_path}")
        if len(sync_sites) != 1:
            raise AssertionError(f"a celf selection made {len(sync_sites)} "
                                 f"host syncs: {sync_sites}")
        if early:
            gate_launches = launches
            if st.early_exit_skips == 0:
                say("celf_early_exit_note", "no LB iteration was skipped")
        elif sketch_k == 1024:
            out = [celf_select_record(store, launches)]
            say("celf_kernels_1024", celf_records(store, res.seeds.tolist(),
                                                  None))
        else:
            say("celf_kernels_16384", [celf_select_record(store, launches)]
                + celf_records(store, res.seeds.tolist(), None))
        if not early:
            say("celf_select_stamps", stamped_split("celf", store))
        del solver, store
        torch.cuda.empty_cache()
    return out, gate_launches


def parent_padded_select(store, k: int) -> cov.CoverageResult:
    """The parent's padded selection, kept as the before figure: a host
    loop whose every step takes an argmax, launches ``membership_rows``
    with the seed left on the card, and updates Occur and Covered with
    PyTorch's scatter-adds over the valid lanes."""
    rows, lengths, n = store.rows, store.lengths, store.n_nodes
    r, l = rows.shape
    dev = rows.device
    valid = (torch.arange(l, device=dev)[None, :] < lengths[:, None])
    elem_row, lane = torch.nonzero(valid, as_tuple=True)
    elem_node = rows[elem_row, lane].to(torch.int64)
    occur = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
        0, elem_node, torch.ones_like(elem_node, dtype=torch.int32))[:n]
    covered = torch.zeros(r, dtype=torch.bool, device=dev)
    seeds, gains = [], []
    for _ in range(k):
        u = torch.argmax(occur)
        hit = ops.membership_rows(rows, lengths, u)
        newly = hit & ~covered
        dec = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
            0, elem_node, newly[elem_row].to(torch.int32))
        occur = occur - dec[:n]
        covered = covered | hit
        seeds.append(u)
        gains.append(newly.sum(dtype=torch.int32))
    gains = torch.stack(gains).to(torch.int32)
    n_rr = int((lengths > 0).sum())
    return cov.CoverageResult(
        seeds=torch.stack(seeds).to(torch.int32), gains=gains,
        frac=gains.sum().to(torch.float32) / torch.full(
            (), max(n_rr, 1), dtype=torch.float32, device=dev))


def padded_greedy_record(rows, lengths, n: int, launches=None, iters=20,
                         plain_iters=1) -> dict:
    """padded_greedy on the padded store against its plain loop on the card
    (seeds and gains exactly), its host syncs (none) and device
    operations (:func:`traced_device_ops`: the kernel alone, at most once a
    call), then timed beside the plain loop, with the bound and the
    barrier floor: ``greedy_flat``'s grid, the same as this kernel's,
    running its 2k + 1 grid barriers alone."""
    got = ops.padded_greedy(rows, lengths, n=n, k=K)
    want = ref.padded_greedy_ref(rows, lengths, n=n, k=K)
    torch.cuda.synchronize()
    err = max(max_abs_err(x, y) for x, y in zip(got, want))
    if err or not all(x.dtype == y.dtype and torch.equal(x, y)
                      for x, y in zip(got, want)):
        raise AssertionError(f"padded_greedy != plain version at "
                             f"{tuple(rows.shape)}: max abs err {err}")

    def kern():
        return ops.padded_greedy(rows, lengths, n=n, k=K)

    _, syncs = count_syncs(kern)
    kernel, calls = DEVICE_KERNEL["padded_greedy"], 10
    dev_ops, traces = traced_device_ops(kern, kernel, calls)
    names = sorted({e.name[:80] for e in dev_ops})
    if syncs or not 1 <= len(dev_ops) <= calls or len(names) != 1 \
            or not re.search(kernel, names[0]):
        raise AssertionError(f"a padded_greedy call made the host syncs "
                             f"{syncs} and {calls} calls the device "
                             f"operations {names} ({len(dev_ops)} in all)")
    dev = rows.device
    blocks = membership.greedy_grid(dev)
    if blocks != greedy.grid_blocks(dev):
        raise AssertionError(f"padded_greedy's grid of {blocks} blocks is "
                             f"not greedy_flat's")
    barriers = membership.grid_barriers(K)
    times = timing("padded_greedy", kern, iters)
    plain_ms = cuda_ms(lambda: ref.padded_greedy_ref(rows, lengths, n=n,
                                                     k=K), plain_iters)
    floor_ms = cuda_ms(lambda: greedy.grid_barriers(barriers, dev), iters)
    r, l = rows.shape
    return record("padded_greedy", launches, err, times, plain_ms,
                  padded_greedy_bound(lengths, l, K),
                  barrier_floor_ms=floor_ms, grid_barriers=barriers,
                  grid_blocks=blocks, threads=greedy.THREADS,
                  host_syncs=len(syncs), device_op_names=names,
                  device_ops_traced=len(dev_ops), calls_traced=calls,
                  device_op_traces=traces, shape=[r, l], n=n, k=K,
                  gains_sum=int(got[1].sum()))


def padded_phase(store, bit) -> list:
    """The phase-5 pool as a padded store; its greedy must give the bitset
    selection exactly in one padded_greedy launch, with no membership_rows
    launch.  Returns the records of padded_greedy and of the standalone
    membership scan at the path's shape."""
    dev = store.flat.device
    n, t = store.n_nodes, store.n_elems
    flat = store.flat[:t].cpu().numpy()
    ids = store.ids[:t].cpu().numpy()
    if np.any(np.diff(ids) < 0):
        raise AssertionError("pool elements are not in row order")
    counts = np.bincount(ids, minlength=store.n_rr)
    lists = [a.tolist() for a in np.split(flat, np.cumsum(counts)[:-1])]
    t0 = time.perf_counter()
    padded = cov.build_padded_store(lists, n, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    select_s = []
    for _ in range(3):      # the first call loads the kernel
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = cov.select_seeds_padded(padded, K)
        torch.cuda.synchronize()
        select_s.append(time.perf_counter() - t0)
        launches = ops.launch_counts()
        if launches["padded_greedy"] != 1 or launches["membership_rows"]:
            raise AssertionError(f"a padded selection launched "
                                 f"{launches['padded_greedy']} padded_greedy"
                                 f" and {launches['membership_rows']} "
                                 f"membership_rows")
    rows, lengths = padded.rows, padded.lengths
    r, l = rows.shape
    parent = parent_padded_select(padded, K)
    same = {"seeds": torch.equal(res.seeds, bit.seeds),
            "gains": torch.equal(res.gains, bit.gains),
            "frac_f32_bytes": res.frac.cpu().numpy().tobytes()
            == bit.frac.cpu().numpy().tobytes(),
            "parent_loop": all(torch.equal(x, y)
                               for x, y in zip(parent, res))}
    select_ms = turns_ms({
        "parent loop": lambda: parent_padded_select(padded, K),
        "padded_greedy": lambda: cov.select_seeds_padded(padded, K)})
    say("padded_selection", {
        "rows": r, "row_len": l, "n_rr": store.n_rr,
        "padded_bytes": r * l * 4, "valid_elements": int(lengths.sum()),
        "max_rr_size": int(counts.max()), "build_s": build_s,
        "select_s": select_s[-1], "first_select_s": select_s[0],
        "select_s_each": select_s, "launches": launches,
        "select_ms_turns": select_ms, "equals_bitset": same,
        "seeds": res.seeds.tolist()[:10]})
    if not all(same.values()):
        raise AssertionError(f"padded selection differs from the bitset "
                             f"selection or the parent's loop: {same}")
    greedy_rec = padded_greedy_record(rows, lengths, n, launches)
    u = bit.seeds[:1]
    path = membership_record(rows, lengths, u, launches)
    path["launches_note"] = ("no path launches it: padded_greedy runs the "
                             "padded greedy")
    # a larger store: rows drawn from this pool (its size law), u a seed
    gen = torch.Generator(device=dev).manual_seed(3)
    big_r, big_l = BIG_MEMBERSHIP
    fits = torch.nonzero((lengths > 0) & (lengths <= big_l))[:, 0]
    pick = fits[torch.randint(0, fits.numel(), (big_r,), device=dev,
                              generator=gen)]
    big = torch.full((big_r, big_l), n, dtype=torch.int32, device=dev)
    w = min(l, big_l)
    big[:, :w] = rows[pick, :w]
    say("membership_at_scale", membership_record(big, lengths[pick], u))
    say("membership_ragged", ragged_membership_checks(gen, n))
    return [greedy_rec, path]


def flash_phase(dev) -> list:
    """Flash attention at full width: the SASS check of the built kernels
    (:func:`flash_sass_check`), then one entry-point call per shape (the
    counts must show one launch each), each held against the plain
    version, then timed beside it and beside SDPA.  Returns the record at
    the first shape."""
    say("flash_sass", flash_sass_check(
        cuobjdump_sass(_build.build("flashattn")),
        _build.PTXAS_REPORT["flashattn"]))
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's
    torch.backends.cudnn.allow_tf32 = False         # products in float32
    gen = torch.Generator(device=dev).manual_seed(4)
    inputs = [tuple(torch.randn(b, s, h, d, device=dev, generator=gen).to(dt)
                    for _ in range(3))
              for _, b, s, h, d, dt, _ in FLASH_SHAPES]
    ops.reset_launch_counts()
    outs = [ops.flash_attention(q, k, v, causal=shape[-1])
            for shape, (q, k, v) in zip(FLASH_SHAPES, inputs)]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches["flash_attention"] != len(FLASH_SHAPES):
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, not "
                             f"{len(FLASH_SHAPES)}")
    per_call = {"flash_attention": launches["flash_attention"]
                // len(FLASH_SHAPES)}
    recs = []
    for shape, (q, k, v), got in zip(FLASH_SHAPES, inputs, outs):
        name, b, s, h, d, dtype, causal = shape
        times = timing("flash_attention",
                       lambda: ops.flash_attention(q, k, v, causal=causal), 10)
        want = ref.flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        atol, rtol = FLASH_TOL[dtype]
        if not (got.dtype == dtype and got.shape == q.shape
                and bool(torch.isfinite(got).all())
                and torch.allclose(got.float(), want.float(), atol=atol,
                                   rtol=rtol)):
            raise AssertionError(f"flash_attention != plain version at "
                                 f"{name}: max abs err {err}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = functools.partial(
            torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
            is_causal=causal)
        ms = times["ms"]
        bound = flash_bound_ms(b, s, h, d, dtype, causal)
        sdpa_ms = cuda_ms(sdpa, 10)
        recs.append(record(
            "flash_attention", per_call, err, times,
            cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal), 3),
            bound, library_ms=sdpa_ms, config=name,
            design=flash.design(dtype, d), shape=[b, s, h, d],
            dtype=str(dtype).removeprefix("torch."), causal=causal,
            atol=atol, rtol=rtol, share_of_bound=bound["bound_ms"] / ms,
            sdpa_factor=ms / sdpa_ms, **flash_work(b, s, h, d, causal)))
        del want
    say("flash_attention", recs)
    return recs[:1]


# phase 15: the problem variants on the stand-in
VARIANT_BUDGET = 100.0
VARIANT_SELECTIONS = ("flat", "bitset", "celf")
# kernels that more than one path launches: their records count each
# path's launches (``launches_from``)
SHARED_PATH_KERNELS = ("celf_eval", "celf_apply", "sketch_union_popcount",
                       "popcount_words", "sketch_scatter_or")
VARIANT_CELF_SKETCH_K = 1024
CHI2_P_MIN = 1e-3


def variant_inputs(n: int) -> dict:
    """Phase 15's operands over the stand-in's n nodes: weights v mod 7
    (a seventh of the nodes never draws a root), the candidates v with v
    mod 3 == 0, and costs 1 + (v mod 5)."""
    v = np.arange(n)
    return {"weights": (v % 7).astype(np.float32),
            "candidates": v[v % 3 == 0],
            "costs": (1 + v % 5).astype(np.float32)}


def variant_solve(g, problem, *, engine="queue", selection="auto",
                  keep_roots=False, model=None) -> dict:
    """One solve of ``problem`` on the stand-in: its stages timed, launches
    counted from just before it to just after; with ``keep_roots`` every
    batch's roots kept on the card.  ``engine`` is a name (batch 512, and
    ``model``) or an instance."""
    opts = {"batch": BATCH, "model": model} if isinstance(engine, str) \
        else {}
    solver = IMMSolver(g, engine=engine, selection=selection,
                       sketch_k=VARIANT_CELF_SKETCH_K if selection == "celf"
                       else None, seed=0, device=g.device, **opts)
    solver.prepare(problem)
    kept = []
    if keep_roots:
        inner = solver.engine.sample

        def sample(seed32):
            batch = inner(seed32)
            kept.append(batch.roots)
            return batch

        solver.engine.sample = sample
    clock = StageClock()
    clock.wrap(solver.engine, "sample", "sampling")
    clock.wrap(solver.store, "append_batch", "append")
    clock.wrap(solver.store, "select", "selection")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = solver.solve(problem)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    return {"res": res, "solver": solver, "solve_s": solve_s,
            "stage_s": dict(clock.seconds), "stage_calls": dict(clock.calls),
            "launches": launches,
            "peak": torch.cuda.max_memory_allocated(),
            "roots": torch.cat(kept) if kept else None}


def solve_fields(run: dict) -> dict:
    """What two solves of one problem (:func:`variant_solve`'s) must
    share (a weighted solve's gains are floats)."""
    res, store = run["res"], run["solver"].store
    st = res.stats
    return {"theta": st.theta, "lb": st.lb, "lb_iters": st.lb_iters,
            "rounds": st.rounds, "n_rr": store.n_rr,
            "elements": store.n_elems, "seeds": [int(x) for x in res.seeds],
            "gains": [x.item() for x in res.gains],
            "frac_f32": np.float32(res.frac).tobytes().hex(),
            "spread": res.spread, "cost": res.cost,
            "variant": st.variant, "budget_spent": st.budget_spent}


def run_line(run: dict) -> dict:
    """A solve's line: its fields (the first ten seeds), stage times and
    the kernels it launched."""
    f = solve_fields(run)
    return dict(f, seeds=f["seeds"][:10], gains=f["gains"][:10],
                n_seeds=len(f["seeds"]), solve_s=run["solve_s"],
                stage_s=run["stage_s"], stage_calls=run["stage_calls"],
                max_memory_allocated=run["peak"],
                launches={k: v for k, v in run["launches"].items() if v})


def variant_kwargs(store, spec) -> dict:
    """greedy_flat_variant's keywords for the store's pool and ``spec``:
    the operands ``select_variant`` passes."""
    cand, costs, budget = cov._spec_operands(store, spec)
    return dict(n=store.n_nodes, num_rows=store.row_capacity(),
                k=spec.k_steps, cand=cand, costs=costs, budget=float(budget),
                n_group=spec.n_group, n_groups=spec.n_groups,
                group_quota=spec.group_quota)


def greedy_variant_bound(flat, ids, valid, seeds, *, n, num_rows, k,
                         use_costs, blocks, shared) -> dict:
    """The variant greedy's least time, as :func:`greedy_bound` counts the
    plain one, over the ``steps`` it runs (the picks, and below k the step
    that found none): bytes also read each node's candidate byte (and its
    cost, 4 bytes) once and write spent.  Operations, per step and node:
    one test of its blocked bit (the candidate mask, the picks and the
    spent groups folded into one bit) and one compare of its key on the
    ALU, and with costs one float32 compare of its cost with the budget
    left; plus a decrement a valid element of each covered row.  With
    costs a score changes only where Occur does, so its conversion (XU)
    and divide (float32) are counted for the n first scores and the
    decremented elements.  The working set is :func:`greedy_bound`'s over
    the picks, with 24-byte records a block a step run."""
    live = seeds[seeds < n]
    steps = min(k, live.numel() + 1)
    base = greedy_bound(flat, ids, valid, live, n=n, num_rows=num_rows,
                        k=max(live.numel(), 1), blocks=blocks, shared=shared)
    exchanges = 24 * steps * blocks * (blocks + 1)
    working = base["working_bytes"] - base["working_exchange_bytes"] \
        + exchanges
    base.update(working_bytes=working,
                working_bytes_ms=working / HBM_BYTES_S * 1e3,
                working_exchange_bytes=exchanges)
    t = flat.shape[0]
    nbytes = 9 * t + 8 * k + 4 + n * (5 if use_costs else 1)
    dec = base["decremented_elements"]
    ops_ = {"alu": 2 * steps * n + dec}
    if use_costs:
        ops_.update(fp32=steps * n + n + dec, xu=n + dec)
    return dict(base, **_bound(nbytes, ops_), steps_run=steps,
                picks=int(live.numel()))


def greedy_variant_record(name, store, spec, launches, iters=20,
                          plain_iters=2) -> dict:
    """greedy_flat_variant on the store's pool and ``spec`` against its
    plain version on the card (seeds, gains and the float32 bytes of
    spent), then timed beside it, with the bound and the barrier floor:
    the same grid running the launch's grid barriers (three in the
    prologue and one a step run) alone."""
    args, _ = pool_args(store)
    kw = variant_kwargs(store, spec)
    got = ops.greedy_flat_variant(*args, **kw)
    want = ref.greedy_flat_variant_ref(*args, **kw)
    torch.cuda.synchronize()
    err = max(max_abs_err(x.view(torch.int32) if x.dtype == torch.float32
                          else x, y.view(torch.int32)
                          if y.dtype == torch.float32 else y)
              for x, y in zip(got, want))
    if err or not all(x.dtype == y.dtype and torch.equal(x, y)
                      for x, y in zip(got, want)):
        raise AssertionError(f"greedy_flat_variant != plain version at "
                             f"{store.n_rr} rows ({name}): max abs err {err}")
    dev = store.flat.device
    times = timing("greedy_flat_variant",
                   lambda: ops.greedy_flat_variant(*args, **kw), iters)
    plain_ms = cuda_ms(lambda: ref.greedy_flat_variant_ref(*args, **kw),
                       plain_iters)
    blocks, shared_bytes = greedy.flat_grid(dev)
    lay = greedy.flat_layout(kw["n"], kw["num_rows"], blocks, shared_bytes,
                             kw["n_group"], kw["n_groups"])
    bound = greedy_variant_bound(*args, got[0], n=kw["n"],
                                 num_rows=kw["num_rows"], k=kw["k"],
                                 use_costs=kw["costs"] is not None,
                                 blocks=blocks, shared=lay.shared)
    barriers = 3 + bound["steps_run"]
    floor_ms = cuda_ms(lambda: greedy.grid_barriers(barriers, dev), iters)
    return record(name, launches, err, times, plain_ms, bound,
                  barrier_floor_ms=floor_ms, grid_barriers=barriers,
                  grid_blocks=blocks, threads=greedy.THREADS,
                  state="shared memory" if lay.shared else "scratch",
                  slice_nodes=lay.slots, covered_words=lay.cov_words,
                  n=kw["n"], k=kw["k"], n_rr=store.n_rr,
                  pool_elements=store.n_elems, num_rows=kw["num_rows"],
                  gains_sum=int(got[1].sum()), spent=float(got[2]),
                  budget=kw["budget"] if kw["costs"] is not None else None)


def weighted_queue_record(g_rev, table, launches, iters=20,
                          plain_iters=1) -> dict:
    """The queue kernel with the weighted solve's alias table at its first
    round (B = 512, qcap = n): byte for byte against the plain version
    with the table, then timed beside it, with :func:`queue_bound`'s bound
    plus the table's reads (8 bytes a lane) and the one-SM bound."""
    seed32, qcap = round_seed(0, 0), g_rev.n_nodes
    args = (g_rev.offsets, g_rev.indices, g_rev.weights, seed32, BATCH)

    def kern():
        return ops.queue_bfs(*args, qcap=qcap, ec=EC_DEFAULT, table=table)

    got = kern()
    want = ref.queue_round_ref(*args, qcap=qcap, ec=EC_DEFAULT, table=table)
    torch.cuda.synchronize()
    err = max(max_abs_err(x, y) for x, y in zip(got, want))
    if err or not all(x.dtype == y.dtype and torch.equal(x, y)
                      for x, y in zip(got, want)):
        raise AssertionError(f"queue_bfs with a table != plain version: max "
                             f"abs err {err}")
    times = timing("queue_bfs", kern, iters)
    plain_ms = cuda_ms(lambda: ref.queue_round_ref(
        *args, qcap=qcap, ec=EC_DEFAULT, table=table), plain_iters)
    bound, work = queue_bound(g_rev, got[0], got[1])
    bound = dict(bound, **_bound(
        bound["bound_bytes_ms"] * HBM_BYTES_S / 1e3 + 8 * BATCH,
        {k: v * work["examined_edges"] for k, v in TRIAL_WORK_OPS.items()}))
    return record("queue_bfs[weighted]", launches, err, times, plain_ms,
                  bound, **one_sm_bound(work["longest_lane_edges"]),
                  shape=[BATCH, qcap], ec=EC_DEFAULT, **work)


def masked_sketch_bound(n: int, cols: int, k: int, steps: int,
                        candidates: int) -> dict:
    """The masked sketch greedy's least time: only a candidate can be
    picked, and the cover is the OR of picked rows, so the work is
    :func:`sketch_greedy_bound`'s over the ``candidates`` rows alone (read
    once; an OR, an add and a popcount a word and a compare a row a step),
    plus the mask's n bytes read once.  The sweeps are the design's, over
    all n rows."""
    words = candidates * cols
    return dict(sketch_greedy_bound(n, cols, k, steps), **_bound(
        4 * words + 4 * (2 * k + 1) + n,
        {"alu": steps * (2 * words + candidates), "xu": steps * words}),
        bound_rows=candidates)


def masked_sketch_record(words, n: int, cand, launches, iters=20,
                         plain_iters=1) -> dict:
    """greedy_sketch with the candidate mask on ``words`` against its plain
    version on the card (seeds, gains, steps), then timed beside it, with
    :func:`masked_sketch_bound` and the barrier floor."""
    got = ops.greedy_sketch(words, n=n, k=K, cand=cand)
    want = ref.greedy_sketch_ref(words, n=n, k=K, cand=cand)
    torch.cuda.synchronize()
    err = max(max_abs_err(x, y) for x, y in zip(got, want))
    if err or not all(x.dtype == y.dtype and torch.equal(x, y)
                      for x, y in zip(got, want)):
        raise AssertionError(f"masked greedy_sketch != plain version at "
                             f"{tuple(words.shape)}: max abs err {err}")
    dev = words.device
    steps = int(got[2])
    barriers = greedy.sketch_barriers(steps, K)
    times = timing("greedy_sketch",
                   lambda: ops.greedy_sketch(words, n=n, k=K, cand=cand),
                   iters)
    plain_ms = cuda_ms(lambda: ref.greedy_sketch_ref(words, n=n, k=K,
                                                     cand=cand), plain_iters)
    floor_ms = cuda_ms(lambda: greedy.grid_barriers(barriers, dev), iters)
    cols = words.shape[1]
    bound = masked_sketch_bound(n, cols, K, steps, int(cand.sum()))
    blocks, shared_words = greedy.sketch_grid(dev)
    lay = greedy.sketch_layout(cols, words.data_ptr() % 16 == 0, n=n,
                               blocks=blocks, shared_words=shared_words)
    return record("greedy_sketch[candidates]", launches, err, times,
                  plain_ms, bound, barrier_floor_ms=floor_ms,
                  grid_barriers=barriers, grid_blocks=blocks,
                  form=lay.form, rows_a_thread=lay.rows, lanes=lay.lanes,
                  shape=list(words.shape), n=n, k=K, steps=steps,
                  candidates=int(cand.sum()), gains_sum=int(got[1].sum()))


def variants_phase(g) -> tuple:
    """The problem variants on the stand-in (:func:`variant_inputs`), each
    solve at batch 512 and eps 0.5 with its launches counted from just
    before it to just after:

    * weighted, k = 50, on the queue and the dense engine: no root of the
      pool has weight 0, the roots' classes v mod 7 follow the weights (a
      χ² test, p > :data:`CHI2_P_MIN`), the RIS spread lies within
      :data:`MC_TOL` of a weighted forward Monte-Carlo spread, and the two
      engines' solves are equal in every field;
    * candidates, k = 50, and budgeted (budget :data:`VARIANT_BUDGET`),
      each with ``flat``, ``bitset`` and ``celf``: equal in every field,
      the seeds inside the candidates, the cost within the budget; ``flat``
      one ``greedy_flat_variant`` a selection, ``celf`` the CELF kernels;
    * approximate with the candidates (``max_theta`` as phase 4): one
      masked ``greedy_sketch`` a selection, the seeds inside the set.

    Returns the records of ``queue_bfs`` with the table,
    ``greedy_flat_variant`` with and without costs, the masked
    ``greedy_sketch`` and (:func:`celf_records`, ``spec`` given) the CELF
    kernels and the sweep at the budgeted CELF solve's pool, cover and
    padded batch, and the CELF variant solves' launches by path."""
    from scipy import stats
    dev = g.device
    n = g.n_nodes
    inp = variant_inputs(n)
    w, cand = inp["weights"], inp["candidates"]
    # weighted roots
    prob = IMProblem(k=K, eps=EPS, node_weights=w)
    runs = {"queue": variant_solve(g, prob, keep_roots=True),
            "dense": variant_solve(g, prob, engine="dense")}
    q = runs["queue"]
    roots = q["roots"].to(torch.int64)
    w_dev = torch.from_numpy(w).to(dev)
    zero_roots = int((w_dev[roots] == 0).sum())
    counts = torch.bincount(roots % 7, minlength=7).cpu().numpy()
    class_w = np.array([w[np.arange(n) % 7 == c].sum(dtype=np.float64)
                        for c in range(7)])
    expect = class_w[1:] / class_w.sum() * counts.sum()
    p_value = float(stats.chisquare(counts[1:], expect).pvalue)
    t0 = time.perf_counter()
    mc = forward.ic_spread(g, q["res"].seeds, n_sims=MC_SIMS, seed=0,
                           node_weights=w)
    mc_s = time.perf_counter() - t0
    rel = abs(q["res"].spread - mc) / mc
    same = solve_fields(runs["queue"]) == solve_fields(runs["dense"])
    say("variant_weighted", {
        "queue": run_line(runs["queue"]), "dense": run_line(runs["dense"]),
        "weight_sum": float(w.sum(dtype=np.float64)),
        "pool_roots": int(roots.numel()), "zero_weight_roots": zero_roots,
        "class_counts": counts.tolist(),
        "class_expected": [0.0] + expect.tolist(), "chi2_p": p_value,
        "mc_spread": mc, "mc_sims": MC_SIMS, "mc_s": mc_s, "rel_err": rel,
        "tol": MC_TOL, "dense_equals_queue": same})
    if zero_roots or counts[0] or p_value <= CHI2_P_MIN:
        raise AssertionError(f"weighted roots: {zero_roots} of weight 0, "
                             f"class counts {counts}, chi2 p {p_value}")
    if not rel < MC_TOL:
        raise AssertionError(f"weighted RIS {q['res'].spread} vs MC {mc}: "
                             f"{rel:.3f} >= {MC_TOL}")
    if not same:
        raise AssertionError(f"weighted dense solve != queue solve: "
                             f"{solve_fields(runs['dense'])} vs "
                             f"{solve_fields(runs['queue'])}")
    for run in runs.values():
        if run["res"].spread > float(w.sum(dtype=np.float64)):
            raise AssertionError("weighted spread above the weights' sum")
    if q["launches"]["queue_bfs"] != q["res"].stats.rounds:
        raise AssertionError(f"{q['res'].stats.rounds} weighted rounds made "
                             f"{q['launches']['queue_bfs']} queue launches")
    records = [weighted_queue_record(
        q["solver"].engine.g_rev, q["solver"].engine.table,
        {"queue_bfs[weighted]": q["launches"]["queue_bfs"]})]
    # candidates and the budget, on each selection
    celf_launches, celf_recs = {}, []
    problems = {"candidates": IMProblem(k=K, eps=EPS, candidates=cand),
                "budgeted": IMProblem(eps=EPS, costs=inp["costs"],
                                      budget=VARIANT_BUDGET)}
    for label, problem in problems.items():
        runs = {sel: variant_solve(g, problem, selection=sel)
                for sel in VARIANT_SELECTIONS}
        fields = {sel: solve_fields(run) for sel, run in runs.items()}
        first = fields["flat"]
        seeds = np.asarray(first["seeds"])
        say(f"variant_{label}", {sel: run_line(run)
                                 for sel, run in runs.items()})
        if any(f != first for f in fields.values()):
            raise AssertionError(f"{label} solves differ: {fields}")
        if label == "candidates" and not (np.isin(seeds, cand).all()
                                          and len(seeds) == K):
            raise AssertionError(f"candidate solve picked {seeds}")
        if label == "budgeted" and not (
                0 < first["cost"] <= VARIANT_BUDGET
                and first["cost"] == float(np.float32(
                    inp["costs"][seeds].sum()))):
            raise AssertionError(f"budgeted solve: cost {first['cost']}")
        flat, bit, celf = (runs[s]["launches"] for s in VARIANT_SELECTIONS)
        sel_calls = runs["flat"]["stage_calls"]["selection"]
        if flat["greedy_flat_variant"] != sel_calls or flat["greedy_flat"] \
                or not (bit["occur_from_bitset"]
                        and bit["occur_from_bitset_masked"]) \
                or bit["greedy_flat_variant"] or celf["celf_select"] \
                or not all(celf[k] for k in ("celf_eval", "celf_apply",
                                             "sketch_union_popcount")):
            raise AssertionError(f"{label} launches: flat {flat}, bitset "
                                 f"{bit}, celf {celf}")
        celf_launches[f"phase 15's {label} CELF solve"] = celf
        spec = runs["flat"]["solver"]._selection_spec(problem.resolve(n))
        if label == "budgeted":
            celf_recs = celf_records(runs["celf"]["solver"].store,
                                     [int(x) for x in runs["celf"]["res"]
                                      .seeds], None, spec=spec)
        store = runs["flat"]["solver"].store
        name = ("greedy_flat_variant[costs]" if label == "budgeted"
                else "greedy_flat_variant[candidates]")
        records.append(greedy_variant_record(
            name, store, spec, {name: flat["greedy_flat_variant"]}))
        del runs, store
        torch.cuda.empty_cache()
    # approximate with the candidates
    aprob = IMProblem(k=K, eps=EPS, mode="approximate",
                      max_theta=APPROX_MAX_THETA, candidates=cand)
    a = variant_solve(g, aprob)
    a_seeds = np.asarray(a["res"].seeds)
    say("variant_approximate_candidates", dict(
        run_line(a), spread_bounds=list(a["res"].spread_bounds),
        sketch_k=a["solver"].store.sketch_k))
    calls = a["stage_calls"]["selection"]
    if a["launches"]["greedy_sketch"] != calls or calls == 0 \
            or not np.isin(a_seeds, cand).all() or len(a_seeds) != K:
        raise AssertionError(f"approximate candidate solve: {calls} "
                             f"selections, launches {a['launches']}, seeds "
                             f"{a_seeds}")
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[torch.from_numpy(cand).to(dev)] = True
    records.append(masked_sketch_record(
        a["solver"].store.words, n, mask,
        {"greedy_sketch[candidates]": a["launches"]["greedy_sketch"]}))
    return records + celf_recs, celf_launches, q["res"].spread


# phase 16: the LT model and the row-weighted estimator on the stand-in
LT_SELECTIONS = ("flat", "bitset", "celf")
# the LT walk's probe: above the stand-in's longest walk, so the same walks
# without the rows' zeros
LT_PROBE_QCAP = 64


def search_rounds(rowcum: np.ndarray, s: int, e: int, u: np.float32):
    """``csrc/lt.cu``'s 32-way search of the row ``[s, e)`` for draw
    ``u``, replayed: (its load rounds, the edge it takes or -1 to stop)."""
    lo, hi, rounds = s, e, 0
    lane = np.arange(1, 33, dtype=np.int64)
    while hi > lo:
        length = hi - lo
        rounds += 1
        probes = (np.arange(lo, hi) if length <= 32
                  else lo + ((lane * length) >> 5) - 1)
        above = np.flatnonzero(rowcum[probes] > u)
        if above.size == 0:
            return rounds, -1
        f = int(above[0])
        if length <= 32:
            return rounds, int(probes[f])
        lo, hi = (int(probes[f - 1]) + 1 if f else lo), int(probes[f]) + 1
    return rounds, -1


def lt_work(g_rev, rowcum, walk, lengths, steps, seed32: int) -> dict:
    """The LT round's work, lane by lane from its output: each draw t of
    lane b at node ``walk[b, t]`` (its draw ``float32(hash(row seed, t))
    * 2^-32``) loads the row's two offsets, makes the search's load rounds
    (:func:`search_rounds`, which must end at the walk's next node) and,
    where it takes an edge, loads its index.  A lane's chain of dependent
    global loads is the sum of those a draw; the round's is its longest
    lane's."""
    offs = g_rev.offsets.cpu().numpy().astype(np.int64)
    idx = g_rev.indices.cpu().numpy()
    rc = rowcum.cpu().numpy()
    walk, lengths = walk.cpu().numpy(), lengths.cpu().numpy()
    steps = steps.cpu().numpy()
    seeds = counter_uniform_u32(seed32, torch.arange(len(lengths))).numpy()
    chains, rounds_total, taken = [], 0, 0
    for b, (ln, d) in enumerate(zip(lengths.tolist(), steps.tolist())):
        u = (counter_uniform_u32(int(seeds[b]), torch.arange(d)).numpy()
             .astype(np.float32) * np.float32(2.0 ** -32))
        chain = 0
        for t in range(d):
            cur = int(walk[b, t])
            rounds, j = search_rounds(rc, int(offs[cur]), int(offs[cur + 1]),
                                      u[t])
            if t + 1 < ln and (j < 0 or idx[j] != walk[b, t + 1]):
                raise AssertionError(f"lane {b} draw {t}: the search took "
                                     f"edge {j}, the walk {walk[b, t + 1]}")
            chain += 1 + rounds + (j >= 0)
            rounds_total += rounds
            taken += j >= 0
        chains.append(chain)
    chains = np.asarray(chains)
    return {"chain_loads": int(chains.max()),
            "chain_lane": int(chains.argmax()),
            "mean_chain_loads": float(chains.mean()),
            "draws": int(steps.sum()), "search_rounds": rounds_total,
            "edges_taken": taken, "longest_walk": int(lengths.max()),
            "mean_walk": float(lengths.mean())}


def lt_bound(g_rev, rowcum, walk, lengths, steps, seed32: int) -> tuple:
    """The LT round's least time.  Bytes: the walk rows written in full,
    their zeros included (4 bytes a cell), and each lane's root, length,
    flag and draws (17 bytes); read, at least, a draw's two offsets (8
    bytes) and one cumulative weight (4), and an index (4) an edge taken.
    Operations: a draw's hash and conversion, counted as
    :data:`TRIAL_WORK_OPS`.  The walk is a chain of dependent loads, so
    :func:`lt_work`'s longest chain is the other side of its time."""
    work = lt_work(g_rev, rowcum, walk, lengths, steps, seed32)
    nbytes = 4 * walk.numel() + 17 * walk.shape[0] + 12 * work["draws"] \
        + 4 * work["edges_taken"]
    return _bound(nbytes, {k: v * work["draws"]
                           for k, v in TRIAL_WORK_OPS.items()}), work


def lt_walk_checks(g_rev, rowcum, table) -> dict:
    """``lt_walk`` at the LT path's first round (B = 512, qcap = n) byte
    for byte against its plain version, with uniform roots and with phase
    15's alias table (weights v mod 7)."""
    args = (g_rev.offsets, g_rev.indices, rowcum, round_seed(0, 0), BATCH)
    out = {}
    for label, tab in (("uniform", None), ("alias", table)):
        got = ops.lt_walk(*args, qcap=g_rev.n_nodes, table=tab)
        want = ref.lt_round_ref(*args, qcap=g_rev.n_nodes, table=tab)
        torch.cuda.synchronize()
        err = max(max_abs_err(x, y) for x, y in zip(got, want))
        if err or not all(x.dtype == y.dtype and torch.equal(x, y)
                          for x, y in zip(got, want)):
            raise AssertionError(f"lt_walk ({label} roots) != plain "
                                 f"version: max abs err {err}")
        out[label] = {"max_abs_err": err, "longest_walk": int(got[1].max()),
                      "mean_walk": float(got[1].float().mean()),
                      "overflowed": int(got[2].sum())}
    return out


def lt_record(g_rev, rowcum, launches, iters=20, plain_iters=1) -> dict:
    """``lt_walk`` at the LT path's first round, timed beside its plain
    version, with :func:`lt_bound` and the longest chain's time a load;
    and the same round at qcap = :data:`LT_PROBE_QCAP` (the same walks,
    the rows' zeros gone), where the chain alone sets the time."""
    seed32, qcap = round_seed(0, 0), g_rev.n_nodes
    args = (g_rev.offsets, g_rev.indices, rowcum, seed32, BATCH)

    def kern():
        return ops.lt_walk(*args, qcap=qcap)

    walk, lengths, _, steps, _ = kern()
    short = ops.lt_walk(*args, qcap=LT_PROBE_QCAP)
    if not torch.equal(short[1], lengths) or short[2].any():
        raise AssertionError(f"lt_walk at qcap {LT_PROBE_QCAP} walked "
                             "otherwise")
    probe = timing("lt_walk", lambda: ops.lt_walk(*args, qcap=LT_PROBE_QCAP),
                   iters)
    times = timing("lt_walk", kern, iters)
    plain_ms = cuda_ms(lambda: ref.lt_round_ref(*args, qcap=qcap),
                       plain_iters)
    bound, work = lt_bound(g_rev, rowcum, walk, lengths, steps, seed32)
    return record("lt_walk", launches, 0.0, times, plain_ms, bound,
                  shape=[BATCH, qcap], ns_per_chain_load=times["device_ms"]
                  * 1e6 / work["chain_loads"],
                  qcap_probe={"qcap": LT_PROBE_QCAP, **probe,
                              "ns_per_chain_load": probe["device_ms"] * 1e6
                              / work["chain_loads"]}, **work)


def weighted_variant_record(store, spec, launches, iters=20,
                            plain_iters=2) -> dict:
    """The weighted ``greedy_flat_variant`` on the row-weighted solve's
    final pool against its plain version on the card (seeds, the float32
    bytes of gains and spent), timed beside it, with
    :func:`greedy_variant_bound`'s count plus the element weights (4
    bytes an element) read once and a float add an element and a float
    decrement a decremented element, and the barrier floor."""
    args, _ = pool_args(store)
    kw = dict(variant_kwargs(store, spec), ew=store.ew[:store.n_elems])
    got = ops.greedy_flat_variant(*args, **kw)
    want = ref.greedy_flat_variant_ref(*args, **kw)
    torch.cuda.synchronize()
    as_int = [x.view(torch.int32) if x.dtype == torch.float32 else x
              for x in (*got, *want)]
    err = max(max_abs_err(x, y) for x, y in zip(as_int[:3], as_int[3:]))
    if err or not all(x.dtype == y.dtype and torch.equal(x, y)
                      for x, y in zip(got, want)):
        raise AssertionError(f"weighted greedy_flat_variant != plain version "
                             f"at {store.n_rr} rows: max abs err {err}")
    dev = store.flat.device
    name = "greedy_flat_variant[weighted]"
    times = timing(name, lambda: ops.greedy_flat_variant(*args, **kw), iters)
    plain_ms = cuda_ms(lambda: ref.greedy_flat_variant_ref(*args, **kw),
                       plain_iters)
    blocks, shared_bytes = greedy.flat_grid(dev)
    lay = greedy.flat_layout(kw["n"], kw["num_rows"], blocks, shared_bytes,
                             kw["n_group"], kw["n_groups"])
    bound = greedy_variant_bound(*args, got[0], n=kw["n"],
                                 num_rows=kw["num_rows"], k=kw["k"],
                                 use_costs=False, blocks=blocks,
                                 shared=lay.shared)
    t, dec = store.n_elems, bound["decremented_elements"]
    bound.update(_bound(
        bound["bound_bytes_ms"] * HBM_BYTES_S / 1e3 + 4 * t,
        {"alu": 2 * bound["steps_run"] * kw["n"] + dec, "fp32": t + dec}))
    barriers = 3 + bound["steps_run"]
    floor_ms = cuda_ms(lambda: greedy.grid_barriers(barriers, dev), iters)
    return record(name, launches, err, times, plain_ms, bound,
                  barrier_floor_ms=floor_ms, grid_barriers=barriers,
                  grid_blocks=blocks, threads=greedy.THREADS,
                  state="shared memory" if lay.shared else "scratch",
                  n=kw["n"], k=kw["k"], n_rr=store.n_rr, pool_elements=t,
                  num_rows=kw["num_rows"],
                  gains_sum=float(got[1].sum(dtype=torch.float64)),
                  wsum=float(store.wsum))


def weighted_celf_records(store, seeds, spec, launches, iters=50,
                          plain_iters=3) -> list:
    """The weighted ``celf_eval`` and ``celf_apply`` at the row-weighted
    CELF solve's pool: Covered after its first 10 seeds, the padded batch
    of the variant's first eval call of that step
    (:func:`celf_variant_batch`) and the commit of the 11th seed, each
    against its plain version bit for bit (the float32 sums as int32
    bits), then timed beside it, with :func:`celf_bytes` plus the weight
    (4 bytes) of each row read."""
    t = store.n_elems
    pool = (store.flat[:t], store.ids[:t], store.valid[:t])
    dev = pool[0].device
    num_rows = store.row_capacity()
    roww = cov.row_weights(store.ids[:t], store.valid[:t], store.ew[:t],
                           num_rows)
    cov_words = torch.zeros(num_rows // 32, dtype=torch.int32, device=dev)
    first = min(10, len(seeds) - 1)
    for u in seeds[:first]:
        ref.celf_apply_ref(*pool, cov_words, u, roww)
    seen_cov, cands = celf_variant_batch(store, spec, first)
    if not torch.equal(seen_cov, cov_words):
        raise AssertionError("the weighted CELF variant's Covered words "
                             f"after {first} seeds differ from the commits'")
    u = int(seeds[first])
    got = ops.celf_eval(*pool, cov_words, cands, roww=roww)
    want = ref.celf_eval_ref(*pool, cov_words, cands, roww)
    mine, plain = cov_words.clone(), cov_words.clone()
    gain = ops.celf_apply(*pool, mine, u, roww=roww)
    want_gain = ref.celf_apply_ref(*pool, plain, u, roww)
    torch.cuda.synchronize()
    errs = {"celf_eval[weighted]": max_abs_err(got.view(torch.int32),
                                               want.view(torch.int32)),
            "celf_apply[weighted]": float(max(
                abs(int(gain.view(torch.int32)) -
                    int(want_gain.view(torch.int32))),
                max_abs_err(mine, plain)))}
    if any(errs.values()) or got.dtype != torch.float32 \
            or not torch.equal(mine, plain):
        raise AssertionError(f"weighted CELF kernels != plain versions: "
                             f"{errs}")
    scratch = cov_words.clone()

    def bound(nodes, apply):
        live = torch.isin(pool[0], nodes.to(torch.int32)) & pool[2]
        return _bound(celf_bytes(*pool, num_rows, nodes, apply)
                      + 4 * int(live.sum()), {"alu": t})

    shapes = dict(pool_elements=t, num_rows=num_rows,
                  covered_words=cov_words.shape[0], n=store.n_nodes)
    return [
        record("celf_eval[weighted]", launches, errs["celf_eval[weighted]"],
               timing("celf_eval[weighted]", lambda: ops.celf_eval(
                   *pool, cov_words, cands, roww=roww), iters),
               cuda_ms(lambda: ref.celf_eval_ref(*pool, cov_words, cands,
                                                 roww), plain_iters),
               bound(cands, False), candidates=int((cands >= 0).sum()),
               batch=cands.numel(), gains_sum=float(got.sum()), **shapes),
        record("celf_apply[weighted]", launches,
               errs["celf_apply[weighted]"],
               timing("celf_apply[weighted]", lambda: ops.celf_apply(
                   *pool, scratch, u, roww=roww), iters),
               cuda_ms(lambda: ref.celf_apply_ref(*pool, plain, u, roww),
                       plain_iters),
               bound(torch.tensor([u], device=dev), True), seed=u,
               gain=float(gain), **shapes),
    ]


def lt_phase(g, weighted_spread: float) -> list:
    """The LT model and the row-weighted estimator on the stand-in, each
    solve at batch 512, k = 50 and eps 0.5 with its launches counted from
    just before it to just after:

    * ``lt_walk`` at the LT path's first round byte for byte against its
      plain version, uniform and with phase 15's alias table;
    * LT solves with ``flat``, ``bitset`` and ``celf``, equal in every
      field, one ``lt_walk`` a round and no ``queue_bfs``, whose RIS
      spread lies within :data:`MC_TOL` of forward LT Monte Carlo
      (``forward.lt_spread``, :data:`MC_SIMS` runs);
    * the LT approximate solve (``max_theta`` as phase 4), whose forward
      LT spread lies in ``[0.9 lo, 1.1 hi]`` of its ``spread_bounds``;
    * a row-weighted solve (weights v mod 7) on a ``make_engine("queue",
      reverse(g), batch=512)`` instance with ``flat``, ``bitset`` and
      ``celf``, equal in every field, through the weighted kernels, whose
      spread lies within :data:`MC_TOL` of weighted forward IC Monte
      Carlo and of phase 15's alias-root weighted estimate
      ``weighted_spread``.

    Returns the records of ``lt_walk`` and of the weighted forms of
    ``greedy_flat_variant``, ``celf_eval`` and ``celf_apply``."""
    n = g.n_nodes
    w = variant_inputs(n)["weights"]
    g_rev = csr.reverse(g)                  # the LT engine's graph
    rowcum = lt_mod.row_cumweights(g_rev)
    table = roots.build_alias_table(w, device=g.device)
    say("lt_walk_check", lt_walk_checks(g_rev, rowcum, table))
    # LT solves
    prob = IMProblem(k=K, eps=EPS)
    runs = {sel: variant_solve(g, prob, selection=sel, model="lt")
            for sel in LT_SELECTIONS}
    fields = {sel: solve_fields(run) for sel, run in runs.items()}
    res = runs["flat"]["res"]
    t0 = time.perf_counter()
    mc = forward.lt_spread(g, res.seeds, n_sims=MC_SIMS, seed=0)
    mc_s = time.perf_counter() - t0
    rel = abs(res.spread - mc) / mc
    say("lt_solve", {**{sel: run_line(run) for sel, run in runs.items()},
                     "mc_spread": mc, "mc_sims": MC_SIMS, "mc_s": mc_s,
                     "rel_err": rel, "tol": MC_TOL})
    if any(f != fields["flat"] for f in fields.values()):
        raise AssertionError(f"LT solves differ: {fields}")
    if not rel < MC_TOL:
        raise AssertionError(f"LT RIS {res.spread} vs forward LT MC {mc}: "
                             f"{rel:.3f} >= {MC_TOL}")
    for sel, run in runs.items():
        got, rounds = run["launches"], run["res"].stats.rounds
        calls = run["stage_calls"]["selection"]
        own = {"flat": got["greedy_flat"] == calls,
               "bitset": got["occur_from_bitset"] > 0
               and got["occur_from_bitset_masked"] > 0,
               "celf": got["celf_select"] == calls
               and got["sketch_fold_rows"] > 0}[sel]
        if got["lt_walk"] != rounds or got["queue_bfs"] or not own:
            raise AssertionError(f"LT {sel} solve: {rounds} rounds, "
                                 f"launches {got}")
    lt_launches = {"lt_walk": runs["flat"]["launches"]["lt_walk"]}
    records = [lt_record(g_rev, rowcum, lt_launches)]
    del runs
    # the LT approximate solve
    a = variant_solve(g, IMProblem(k=K, eps=EPS, mode="approximate",
                                   max_theta=APPROX_MAX_THETA), model="lt")
    lo, hi = a["res"].spread_bounds
    mc_a = forward.lt_spread(g, a["res"].seeds, n_sims=MC_SIMS, seed=0)
    say("lt_approximate", dict(run_line(a), spread_bounds=[lo, hi],
                               mc_spread=mc_a,
                               sketch_k=a["solver"].store.sketch_k))
    got, calls = a["launches"], a["stage_calls"]
    if not 0.9 * lo <= mc_a <= 1.1 * hi or got["lt_walk"] != \
            a["res"].stats.rounds or got["greedy_sketch"] != \
            calls["selection"] or got["sketch_fold_rows"] != calls["append"]:
        raise AssertionError(f"LT approximate solve: MC {mc_a}, bounds "
                             f"{(lo, hi)}, launches {got}, calls {calls}")
    del a
    torch.cuda.empty_cache()
    # the row-weighted estimator on an engine instance
    wprob = IMProblem(k=K, eps=EPS, node_weights=w)
    runs = {sel: variant_solve(g, wprob, selection=sel, engine=make_engine(
        "queue", g_rev, batch=BATCH)) for sel in LT_SELECTIONS}
    fields = {sel: solve_fields(run) for sel, run in runs.items()}
    res = runs["flat"]["res"]
    t0 = time.perf_counter()
    mc = forward.ic_spread(g, res.seeds, n_sims=MC_SIMS, seed=0,
                           node_weights=w)
    mc_s = time.perf_counter() - t0
    rel, rel_alias = (abs(res.spread - x) / x for x in (mc, weighted_spread))
    say("row_weighted_solve", {
        **{sel: run_line(run) for sel, run in runs.items()},
        "wsum": float(runs["flat"]["solver"].store.wsum),
        "weight_sum": float(w.sum(dtype=np.float64)), "mc_spread": mc,
        "mc_s": mc_s, "rel_err": rel, "alias_root_spread": weighted_spread,
        "rel_err_alias": rel_alias, "tol": MC_TOL})
    if any(f != fields["flat"] for f in fields.values()):
        raise AssertionError(f"row-weighted solves differ: {fields}")
    if not (rel < MC_TOL and rel_alias < MC_TOL):
        raise AssertionError(f"row-weighted RIS {res.spread}: MC {mc}, "
                             f"alias roots {weighted_spread}")
    flat, bit, celf = (runs[s]["launches"] for s in LT_SELECTIONS)
    weighted = ("greedy_flat_variant[weighted]", "celf_eval[weighted]",
                "celf_apply[weighted]")
    if not all(r["solver"]._row_weight_mode for r in runs.values()) \
            or flat["greedy_flat_variant[weighted]"] != \
            runs["flat"]["stage_calls"]["selection"] \
            or flat["greedy_flat_variant"] or any(bit[k] for k in weighted) \
            or not (celf["celf_eval[weighted]"]
                    and celf["celf_apply[weighted]"]) \
            or celf["celf_eval"] or celf["celf_apply"]:
        raise AssertionError(f"row-weighted launches: flat {flat}, bitset "
                             f"{bit}, celf {celf}")
    spec = runs["flat"]["solver"]._selection_spec(wprob.resolve(n))
    records.append(weighted_variant_record(
        runs["flat"]["solver"].store, spec,
        {"greedy_flat_variant[weighted]":
         flat["greedy_flat_variant[weighted]"]}))
    records += weighted_celf_records(
        runs["celf"]["solver"].store,
        [int(x) for x in runs["celf"]["res"].seeds], spec,
        {k: celf[k] for k in weighted[1:]})
    return records


# phase 17: the multigraph dedup, the refill engine and MRIM on the stand-in
# MRIM's rounds and seeds a round, as benchmarks/table3_mrim.py:12 sets them
MRIM_T, MRIM_K = 5, 10
MRIM_SELECTIONS = ("flat", "bitset", "celf")
DEDUP_SHUFFLE_SEED = 17


def same_round(got, want) -> bool:
    """Two kernels' outputs equal tensor for tensor, dtype and shape too."""
    return len(got) == len(want) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(got, want))


def dedup_graphs(g) -> tuple:
    """The stand-in's edge list with every third edge repeated at its own
    weight, reversed: (rows sorted by destination, the ``segmented`` form;
    the same rows with each row's edges in a seeded random order, the
    ``sort`` form)."""
    src, dst, w = csr.to_edges(g)
    rep = np.arange(src.size) % 3 == 0
    src, dst, w = (np.concatenate([x, x[rep]]) for x in (src, dst, w))
    sorted_rev = csr.reverse(csr.from_edges(src, dst, g.n_nodes, weights=w,
                                            device=g.device))
    offs, idx, wr = sorted_rev.numpy()
    row_of = np.repeat(np.arange(g.n_nodes), np.diff(offs.astype(np.int64)))
    rng = np.random.default_rng(DEDUP_SHUFFLE_SEED)
    order = np.lexsort((rng.random(idx.size), row_of))
    shuffled = csr.CSRGraph(sorted_rev.offsets,
                            torch.from_numpy(idx[order]).to(g.device),
                            torch.from_numpy(wr[order]).to(g.device))
    return sorted_rev, shuffled


def plain_call(fn):
    """``fn()`` once, on the host clock between two synchronizations: (its
    result, milliseconds).  A plain version takes seconds, so it is timed
    once, with no warm-up."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def dedup_phase(g) -> list:
    """Phase 17.1: the queue sampler on the stand-in's multigraph (every
    third edge twice).  The sampler detects ``segmented`` on the sorted rows
    and ``sort`` on the shuffled ones; one round of each, and of ``sort``
    on the sorted rows, through ``sample_rrsets_queue`` with the launches
    counted; then ``queue_bfs[dedup]`` byte for byte against its plain
    version at the first round in both modes, ``sort`` on the sorted rows
    equal to ``segmented`` there, and the record (``segmented``; the
    ``sort`` form's times beside it)."""
    sorted_rev, shuffled_rev = dedup_graphs(g)
    modes = (rrset.detect_dedup_mode(sorted_rev),
             rrset.detect_dedup_mode(shuffled_rev))
    if modes != ("segmented", "sort"):
        raise AssertionError(f"dedup modes {modes}, not segmented and sort")
    seed32, n = round_seed(0, 0), g.n_nodes
    cases = {"segmented": (sorted_rev, "segmented"),
             "sort": (shuffled_rev, "sort"),
             "sort_on_sorted": (sorted_rev, "sort")}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    samples = {name: rrset.sample_rrsets_queue(
        gr, BATCH, seed32, dedup=None if name != "sort_on_sorted" else mode)
        for name, (gr, mode) in cases.items()}
    torch.cuda.synchronize()
    launches = ops.launch_counts()["queue_bfs"]

    def call(gr, mode):
        return lambda: ops.queue_bfs(gr.offsets, gr.indices, gr.weights,
                                     seed32, BATCH, qcap=n, ec=EC_DEFAULT,
                                     dedup=mode)

    checks, rounds, errs = {}, {}, []
    for name, (gr, mode) in cases.items():
        got = call(gr, mode)()
        if name == "sort_on_sorted":
            # held to the segmented round, which its plain version holds
            want, plain_ms = rounds["segmented"], None
        else:
            want, plain_ms = plain_call(lambda: ref.queue_round_ref(
                gr.offsets, gr.indices, gr.weights, seed32, BATCH, qcap=n,
                ec=EC_DEFAULT, dedup=mode))
        err = max(max_abs_err(x, y) for x, y in zip(got, want))
        errs.append(err)
        checks[name] = {"equal": same_round(got, want), "max_abs_err": err,
                        "plain_ms": plain_ms, "longest": int(got[1].max()),
                        "elements": int(got[1].sum()),
                        "steps": int(got[3].max()),
                        "sampler_equal": torch.equal(
                            samples[name].lengths, got[1])}
        if err or not checks[name]["equal"] or \
                not checks[name]["sampler_equal"]:
            raise AssertionError(f"queue_bfs[dedup] {name} != plain "
                                 f"version: {checks[name]}")
        rounds[name] = got
    seg_is_sort = checks["sort_on_sorted"]["equal"]
    say("dedup_check", {"edges": sorted_rev.n_edges, "modes": modes,
                        "segmented_equals_sort": seg_is_sort,
                        "launches": launches, **checks})
    if not seg_is_sort:
        raise AssertionError("segmented and sort differ on the sorted rows")
    times = timing("queue_bfs[dedup]", call(sorted_rev, "segmented"), 20)
    sort_times = timing("queue_bfs[dedup]", call(shuffled_rev, "sort"), 20)
    queue, lengths = rounds["segmented"][:2]
    bound, work = queue_bound(sorted_rev, queue, lengths)
    return [record("queue_bfs[dedup]", {"queue_bfs[dedup]": launches},
                   max(errs), times, checks["segmented"]["plain_ms"], bound,
                   **one_sm_bound(work["longest_lane_edges"]),
                   shape=[BATCH, n], ec=EC_DEFAULT, mode="segmented",
                   edges=sorted_rev.n_edges,
                   sort_ms=sort_times["ms"],
                   sort_device_ms=sort_times.get("device_ms"),
                   sort_plain_ms=checks["sort"]["plain_ms"],
                   plain_timing="host clock, one call", **work)]


def refill_rows_on_host(out) -> dict:
    """A refill round's emitted rows by row id: {row: (nodes, steps)}."""
    flat, lengths, n_done, _, rows, row_steps = (x.cpu().numpy()
                                                 for x in out[:6])
    got = {}
    for lane in range(flat.shape[0]):
        off = 0
        for j in range(int(n_done[lane])):
            ln = int(lengths[lane, j])
            got[int(rows[lane, j])] = (flat[lane, off:off + ln].tolist(),
                                       int(row_steps[lane, j]))
            off += ln
    return got


def refill_bound(g_rev, queue, lengths, lanes: int, out_cap: int,
                 sets: int) -> tuple:
    """The refill round's least time: the queue round's work at batch =
    quota (the same rows: :func:`queue_bound`'s distinct CSR rows and
    trials), with the flat rows (4 bytes a cell, written in full) and the
    slots (16 bytes: length, row id, steps) in place of the queue rows,
    and each lane's count and flag."""
    bound, work = queue_bound(g_rev, queue, lengths)
    nbytes = 8 * work["distinct_row_edges"] + 8 * work["distinct_rows"] \
        + 4 * lanes * out_cap + 16 * lanes * sets + 5 * lanes + 4
    return _bound(nbytes, {k: v * work["examined_edges"]
                           for k, v in TRIAL_WORK_OPS.items()}), work


def refill_phase(g, queue_res, queue_store) -> list:
    """Phase 17.2: the refill engine at batch 512 (256 lanes, out_cap
    1,024).  ``refill_bfs`` at the first round against its plain version
    and against ``queue_bfs``'s lanes 0-511, row for row, steps too; the
    engine's round (one launch, one host read); then ``IMMSolver(g,
    engine="refill", batch=512)`` on phase 5's problem, equal to phase 5
    in θ, LB, rounds, RR sets, pool elements, seeds, gains and frac."""
    n = g.n_nodes
    eng = make_engine("refill", csr.reverse(g), batch=BATCH)
    gr, seed32 = eng.g_rev, round_seed(0, 0)
    sets = rrset.default_sets_per_lane(BATCH, eng.lanes)
    kw = dict(quota=BATCH, out_cap=eng.out_cap, max_sets=sets, ec=EC_DEFAULT)
    args = (gr.offsets, gr.indices, gr.weights, seed32, eng.lanes)
    got = ops.refill_bfs(*args, **kw)
    want, plain_ms = plain_call(lambda: ref.refill_round_ref(*args, **kw))
    queue, lengths, _, steps, _ = ops.queue_bfs(
        gr.offsets, gr.indices, gr.weights, seed32, BATCH, qcap=n,
        ec=EC_DEFAULT)
    got_rows, want_rows = refill_rows_on_host(got), refill_rows_on_host(want)
    q_len, q_steps = lengths.cpu().tolist(), steps.cpu().tolist()
    queue_rows = {r: (queue[r, :q_len[r]].cpu().tolist(), q_steps[r])
                  for r in range(BATCH)}
    sched = rrset.refill_schedule_steps(
        [got_rows[r][1] for r in sorted(got_rows)], eng.lanes, sets)
    check = {"rows": len(got_rows), "equal_plain": got_rows == want_rows,
             "equal_queue_lanes": got_rows == queue_rows,
             "overflowed": int(got[3].sum()),
             "plain_overflowed": int(want[3].sum()),
             "plain_loop_steps": want[6], "schedule_steps": sched,
             "queue_round_steps": max(q_steps), "plain_ms": plain_ms,
             "lanes": eng.lanes, "out_cap": eng.out_cap, "slots": sets,
             "sets_per_lane": np.bincount(got[2].cpu().numpy()).tolist()}
    say("refill_check", check)
    if not (check["equal_plain"] and check["equal_queue_lanes"]
            and sched == want[6] and not check["overflowed"]):
        raise AssertionError(f"refill_bfs != plain version or queue lanes: "
                             f"{check}")
    eng.sample(seed32)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    _, syncs = count_syncs(lambda: eng.sample(seed32))
    round_launches = ops.launch_counts()
    run = variant_solve(g, IMProblem(k=K, eps=EPS), engine="refill",
                        selection="bitset")
    st, qst = run["res"].stats, queue_res.stats
    fields = {"theta": st.theta, "lb": st.lb, "lb_iters": st.lb_iters,
              "rounds": st.rounds, "n_rr": run["solver"].store.n_rr,
              "elements": run["solver"].store.n_elems,
              "seeds": run["res"].seeds.tolist(),
              "gains": run["res"].gains.tolist(),
              "frac": np.float32(run["res"].frac).tobytes().hex()}
    phase5 = {"theta": qst.theta, "lb": qst.lb, "lb_iters": qst.lb_iters,
              "rounds": qst.rounds, "n_rr": queue_store.n_rr,
              "elements": queue_store.n_elems,
              "seeds": queue_res.seeds.tolist(),
              "gains": queue_res.gains.tolist(),
              "frac": np.float32(queue_res.frac).tobytes().hex()}
    same = fields == phase5
    say("refill_solve", dict(
        run_line(run), equals_phase5_solve=same,
        overflow_fraction=st.overflow_fraction,
        sampling_steps=st.sampling_steps,
        queue_sampling_steps=qst.sampling_steps,
        round_host_syncs=len(syncs), round_sync_sites=syncs,
        round_launches={k: v for k, v in round_launches.items() if v}))
    if not same or len(syncs) != 1 or round_launches["refill_bfs"] != 1:
        raise AssertionError(f"refill solve differs from phase 5 or its "
                             f"round is not one launch and one host read: "
                             f"{fields} vs {phase5}, syncs {syncs}")
    if run["launches"]["refill_bfs"] != st.rounds or \
            run["launches"]["queue_bfs"]:
        raise AssertionError(f"refill solve launches {run['launches']}")
    times = timing("refill_bfs", lambda: ops.refill_bfs(*args, **kw), 20)
    bound, work = refill_bound(gr, queue, lengths, eng.lanes, eng.out_cap,
                               sets)
    return [record("refill_bfs", run["launches"], 0.0, times, plain_ms,
                   bound, **one_sm_bound(work["longest_lane_edges"]),
                   shape=[eng.lanes, eng.out_cap], quota=BATCH, slots=sets,
                   ec=EC_DEFAULT, plain_timing="host clock, one call",
                   overflow_fraction=st.overflow_fraction, **work)]


def ic_active(g, seeds, n_sims: int, gen) -> torch.Tensor:
    """(n_sims, n) bool active sets of forward IC runs from ``seeds`` on
    the forward CSR ``g``, drawing from ``gen`` (``forward.ic_sizes``'s
    loop)."""
    dev, n = g.device, g.n_nodes
    deg = (g.offsets[1:] - g.offsets[:-1]).to(torch.int64)
    edge_src = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    edge_dst = g.indices.to(torch.int64)
    active = torch.zeros(n_sims, n, dtype=torch.bool, device=dev)
    active[:, torch.as_tensor(seeds, device=dev).to(torch.int64)] = True
    frontier = active.clone()
    while bool(frontier.any()):
        u = torch.rand((n_sims, g.n_edges), generator=gen, device=dev)
        live = (frontier[:, edge_src] & (u < g.weights)).to(torch.int32)
        hit = torch.zeros(n_sims, n, dtype=torch.int32,
                          device=dev).index_add_(1, edge_dst, live)
        frontier = (hit > 0) & ~active
        active |= frontier
    return active


def mrim_forward_spread(g, seeds_per_round, n_sims: int, seed: int) -> float:
    """MRIM's objective by forward Monte Carlo: per simulation, the nodes
    that T independent IC cascades reach, one from each round's seeds."""
    gen = torch.Generator(device=g.device).manual_seed(int(seed))
    union = torch.zeros(n_sims, g.n_nodes, dtype=torch.bool, device=g.device)
    for seeds in seeds_per_round:
        union |= ic_active(g, seeds, n_sims, gen)
    return float(union.sum(dim=1).to(torch.float64).mean())


def mrim_phase(g) -> tuple:
    """Phase 17.3: ``IMProblem(k=10, t_rounds=5, eps=0.5)`` solved with
    ``flat``, ``bitset`` and ``celf``, equal in every field, one
    ``queue_bfs[tiled]`` a round; its RIS estimate within :data:`MC_TOL`
    of a 256-simulation T-round forward Monte Carlo; then
    ``queue_bfs[tiled]`` at B·T = 2,560 lanes byte for byte against its
    plain version at the first round, the T lanes of a sample on one
    root, and its record.  Returns the records and the CELF solve's
    launches (a path of the shared CELF kernels)."""
    problem = IMProblem(k=MRIM_K, t_rounds=MRIM_T, eps=EPS)
    runs = {sel: variant_solve(g, problem, selection=sel)
            for sel in MRIM_SELECTIONS}
    fields = {sel: solve_fields(run) for sel, run in runs.items()}
    same = all(f == fields["flat"] for f in fields.values())
    res = runs["flat"]["res"]
    per_round = res.seeds_per_round()
    t0 = time.perf_counter()
    mc = mrim_forward_spread(g, per_round, MC_SIMS, seed=0)
    mc_s = time.perf_counter() - t0
    rel = abs(res.spread - mc) / mc
    store = runs["bitset"]["solver"].store
    m = store.bitset_matrix()
    say("mrim_solve", {
        "k": MRIM_K, "t_rounds": MRIM_T, "eps": EPS, "batch": BATCH,
        "lanes_a_round": BATCH * MRIM_T, "item_space": store.n_nodes,
        "selections_equal": same, "seeds_per_round": per_round,
        "ris_spread": res.spread, "mc_spread": mc, "mc_sims": MC_SIMS,
        "mc_s": mc_s, "rel_err": rel, "tol": MC_TOL,
        "pool_bytes": store.per_device_pool_bytes(),
        "bit_matrix_shape": list(m.shape),
        "bit_matrix_bytes": m.numel() * m.element_size(),
        **{sel: run_line(run) for sel, run in runs.items()}})
    del m
    if not same:
        raise AssertionError(f"MRIM selections differ: {fields}")
    if len(per_round) != MRIM_T or any(len(s) != MRIM_K for s in per_round):
        raise AssertionError(f"MRIM seeds a round {per_round}")
    for sel, run in runs.items():
        if run["launches"]["queue_bfs"] != run["res"].stats.rounds:
            raise AssertionError(f"MRIM {sel}: {run['launches']}")
    if not rel < MC_TOL:
        raise AssertionError(f"MRIM RIS {res.spread} vs MC {mc}: "
                             f"{rel:.3f} >= {MC_TOL}")
    gr, seed32, n = csr.coalesce_ic(csr.reverse(g)), round_seed(0, 0), \
        g.n_nodes
    lanes = BATCH * MRIM_T

    def kern():
        return ops.queue_bfs(gr.offsets, gr.indices, gr.weights, seed32,
                             lanes, qcap=n, ec=EC_DEFAULT, root_tile=MRIM_T)

    got = kern()
    want, plain_ms = plain_call(lambda: ref.queue_round_ref(
        gr.offsets, gr.indices, gr.weights, seed32, lanes, qcap=n,
        ec=EC_DEFAULT, root_tile=MRIM_T))
    err = max(max_abs_err(x, y) for x, y in zip(got, want))
    roots_shared = bool((got[4].reshape(BATCH, MRIM_T)
                         == got[4][::MRIM_T, None]).all())
    say("tiled_check", {"equal": same_round(got, want), "max_abs_err": err,
                        "roots_shared": roots_shared, "plain_ms": plain_ms,
                        "longest": int(got[1].max()),
                        "elements": int(got[1].sum())})
    if err or not same_round(got, want) or not roots_shared:
        raise AssertionError("queue_bfs[tiled] != plain version")
    times = timing("queue_bfs[tiled]", kern, 20)
    bound, work = queue_bound(gr, got[0], got[1])
    rec = record("queue_bfs[tiled]",
                 {"queue_bfs[tiled]": runs["flat"]["launches"]["queue_bfs"]},
                 err, times, plain_ms, bound,
                 **one_sm_bound(work["longest_lane_edges"]),
                 shape=[lanes, n], root_tile=MRIM_T, ec=EC_DEFAULT,
                 plain_timing="host clock, one call", **work)
    return [rec], {"phase 17's MRIM celf solve": runs["celf"]["launches"]}


# phase 18: the stacked kernel's batches on phase 5's pool, (rows, mix)
STACKED_BATCHES = ((1, "mixed"), (3, "mixed"), (8, "mixed"), (16, "plain"))


def stacked_geometry(n: int) -> dict:
    """Phase 18's group geometry, the batch's: three groups of ceil(n / 3)
    ids (a plain row ignores it; a variant row's quota binds only when it
    is below its k_steps)."""
    return {"n_group": -(-n // 3), "n_groups": 3}


def stacked_requests(n: int, rows: int, mix: str) -> list:
    """``rows`` requests over the stand-in's n nodes: ``"plain"`` rows take
    k = 50 and 10 in turn; ``"mixed"`` rows cycle through plain k = 50,
    plain k = 10, phase 15's candidates (k = 50), its costs with budget
    100 (k_steps 100) and a group quota of 2 (k = 10)."""
    vi = variant_inputs(n)
    cand = np.zeros(n, bool)
    cand[vi["candidates"]] = True
    kinds = [cov.StackedRequest(k_steps=K), cov.StackedRequest(k_steps=10)]
    if mix == "mixed":
        kinds += [cov.StackedRequest(k_steps=K, plain=False, cand=cand),
                  cov.StackedRequest(k_steps=int(VARIANT_BUDGET), plain=False,
                                     costs=vi["costs"],
                                     budget=VARIANT_BUDGET),
                  cov.StackedRequest(k_steps=10, plain=False, quota=2)]
    return [kinds[i % len(kinds)] for i in range(rows)]


def solo_row_calls(args, kw) -> list:
    """One call a request row (padding rows none): the row's solo kernel,
    ``ops.greedy_flat`` for a plain row, ``ops.greedy_flat_variant`` for a
    variant row, on the row's operands; each returns (seeds, gains,
    spent)."""
    calls = []
    base = dict(n=kw["n"], num_rows=kw["num_rows"])
    for r in range(kw["ks"].shape[0]):
        k = int(kw["ks"][r])
        if not k:
            continue
        if bool(kw["plain"][r]):
            calls.append((r, k, functools.partial(
                lambda k: (*ops.greedy_flat(*args, **base, k=k), None), k)))
            continue
        vkw = dict(base, k=k, cand=kw["cand"][r].contiguous(),
                   costs=kw["costs"][r].contiguous()
                   if bool(kw["use_costs"][r]) else None,
                   budget=float(kw["budget"][r]), n_group=kw["n_group"],
                   n_groups=kw["n_groups"], group_quota=int(kw["quota"][r]))
        calls.append((r, k, functools.partial(
            lambda vkw: ops.greedy_flat_variant(*args, **vkw), vkw)))
    return calls


def solo_launches_ms(args, kw, iters: int) -> tuple:
    """The rows of a greedy_stacked call as solo launches
    (:func:`solo_row_calls`), timed as one call: (ms, launches)."""
    calls = [c for _, _, c in solo_row_calls(args, kw)]

    def solo():
        for c in calls:
            c()

    return cuda_ms(solo, iters), len(calls)


def check_stacked(args, kw, got) -> dict:
    """``got`` (greedy_stacked's outputs) against the plain version on the
    card and every row against its solo kernel: seeds, gains and the
    float32 bytes of spent, exactly.  Raises on any difference."""
    want = ref.greedy_stacked_ref(*args, **kw)
    as_int = [x.view(torch.int32) if x.dtype == torch.float32 else x
              for x in got]
    err = max(max_abs_err(x, y.view(torch.int32)
                          if y.dtype == torch.float32 else y)
              for x, y in zip(as_int, want))
    if err or not all(x.dtype == y.dtype and torch.equal(x, y)
                      for x, y in zip(got, want)):
        raise AssertionError(f"greedy_stacked != plain version at "
                             f"{kw['ks'].shape[0]} rows: max abs err {err}")
    n = kw["n"]
    for r, k, call in solo_row_calls(args, kw):
        s, g, sp = call()
        same = torch.equal(got[0][r, :k], s) and \
            torch.equal(got[1][r, :k], g) and \
            bool((got[0][r, k:] == n).all()) and \
            not bool(got[1][r, k:].any()) and \
            (sp is None and float(got[2][r]) == 0.0 or sp is not None and
             got[2][r].view(torch.int32).item()
             == sp.view(torch.int32).item())
        if not same:
            raise AssertionError(f"greedy_stacked's row {r} != its solo "
                                 f"kernel")
    return {"max_abs_err": err, "rows": int(kw["ks"].shape[0]),
            "k_max": kw["k_max"], "solo_rows_equal": True}


def stacked_steps(seeds, kw) -> list:
    """The steps each row of a greedy_stacked launch runs: a plain row its
    k, a variant row its picks and, below its k, the step that found no
    node."""
    n, out = kw["n"], []
    for r in range(kw["ks"].shape[0]):
        k = int(kw["ks"][r])
        picks = int((seeds[r, :k] < n).sum())
        out.append(k if bool(kw["plain"][r]) else min(k, picks + 1))
    return out


def stacked_bound(flat, ids, valid, seeds, kw, *, blocks) -> dict:
    """greedy_stacked's least time, the sum of its rows' work: bytes are
    the pool read once (9 bytes an element), each variant row's candidate
    bytes (and its costs, 4 bytes a node, with a budget), the 17 bytes of
    each row's scalars, and the seeds, gains and spent written once;
    operations, row by row, :func:`greedy_bound`'s (a compare a node a
    step and a decrement a valid element of the rows its seeds cover) for
    a plain row, :func:`greedy_variant_bound`'s (a blocked bit and a key a
    node a step; with costs a float compare a node a step and a conversion
    and a divide for the n first scores and the decremented elements) for
    a variant row, over the steps each row runs (:func:`stacked_steps`).
    The grid barriers: three in the prologue and two a step run."""
    n, rows, k_max = kw["n"], kw["ks"].shape[0], kw["k_max"]
    steps = stacked_steps(seeds, kw)
    ops_ = {"alu": 0, "fp32": 0, "xu": 0}
    nbytes = 9 * flat.shape[0] + 17 * rows + 8 * rows * k_max + 4 * rows
    dec_all = 0
    for r in range(rows):
        k = int(kw["ks"][r])
        if not k:
            continue
        live = seeds[r, :k][seeds[r, :k] < n]
        dec = greedy_bound(flat, ids, valid, live, n=n,
                           num_rows=kw["num_rows"], k=max(live.numel(), 1),
                           blocks=blocks, shared=False)["decremented_elements"]
        dec_all += dec
        if bool(kw["plain"][r]):
            ops_["alu"] += steps[r] * n + dec
            continue
        use_costs = bool(kw["use_costs"][r])
        nbytes += n * (5 if use_costs else 1)
        ops_["alu"] += 2 * steps[r] * n + dec
        if use_costs:
            ops_["fp32"] += steps[r] * n + n + dec
            ops_["xu"] += n + dec
    return dict(_bound(nbytes, {k: v for k, v in ops_.items() if v}),
                steps_run=steps, steps_taken=max(steps),
                grid_barriers=2 + 2 * max(steps),
                decremented_elements=dec_all)


def stacked_record(store, reqs, geometry, launches, iters=20,
                   plain_iters=2) -> dict:
    """greedy_stacked on the store's pool, ``reqs`` and the batch's
    ``geometry`` against its plain version and each row's solo kernel on
    the card, then timed beside the plain version and beside the same rows
    as R solo launches (``solo_launches_ms``: a ``greedy_flat`` or
    ``greedy_flat_variant`` a row), with the bound and the barrier floor
    (the same grid running the launch's barriers alone)."""
    args, _ = pool_args(store)
    kw = cov.stacked_operands(store, reqs, **geometry)
    got = ops.greedy_stacked(*args, **kw)
    check = check_stacked(args, kw, got)
    dev = store.flat.device
    times = timing("greedy_stacked", lambda: ops.greedy_stacked(*args, **kw),
                   iters)
    plain_ms = cuda_ms(lambda: ref.greedy_stacked_ref(*args, **kw),
                       plain_iters)
    solo_ms, solo_launches = solo_launches_ms(args, kw, iters)
    blocks, _ = greedy.stacked_grid(dev)
    bound = stacked_bound(*args, got[0], kw, blocks=blocks)
    floor_ms = cuda_ms(lambda: greedy.grid_barriers(bound["grid_barriers"],
                                                    dev), iters)
    return record("greedy_stacked", launches, check["max_abs_err"], times,
                  plain_ms, bound, barrier_floor_ms=floor_ms,
                  solo_launches_ms=solo_ms, solo_launches=solo_launches,
                  rows=check["rows"], requests=len(reqs),
                  k_max=kw["k_max"], grid_blocks=blocks,
                  threads=greedy.THREADS,
                  scratch_bytes=greedy.stacked_scratch_bytes(
                      kw["n"], kw["num_rows"], args[0].shape[0],
                      check["rows"], blocks, kw["n_group"], kw["n_groups"]),
                  shared_bytes=greedy.stacked_shared_bytes(check["rows"],
                                                           blocks),
                  n=kw["n"], n_rr=store.n_rr, pool_elements=store.n_elems,
                  num_rows=kw["num_rows"],
                  gains_sum=int(got[1].sum()))


def stacked_problems(n: int, theta: int) -> list:
    """Phase 18's batch at the fixed θ: plain k = 50, 10, 25 and 5, phase
    15's candidates at k = 50 and 10, its costs at budget 100 and 50, and
    a top-1 request that the Occur fast path answers."""
    vi = variant_inputs(n)
    return [IMProblem(k=K, theta=theta), IMProblem(k=10, theta=theta),
            IMProblem(k=25, theta=theta), IMProblem(k=5, theta=theta),
            IMProblem(k=K, theta=theta, candidates=vi["candidates"]),
            IMProblem(k=10, theta=theta, candidates=vi["candidates"]),
            IMProblem(budget=VARIANT_BUDGET, costs=vi["costs"],
                      theta=theta),
            IMProblem(budget=VARIANT_BUDGET / 2, costs=vi["costs"],
                      theta=theta),
            IMProblem(k=1, theta=theta)]


def result_fields(res) -> dict:
    """What a stacked result must share with its solo solve."""
    return {"seeds": [int(x) for x in res.seeds],
            "gains": [int(x) for x in res.gains],
            "frac_f32": np.float32(res.frac).tobytes().hex(),
            "spread": res.spread, "cost": res.cost,
            "n_nodes": res.n_nodes, "bounds": res.spread_bounds}


def stacked_phase(g, queue_store) -> list:
    """Phase 18: ``greedy_stacked`` byte for byte against its plain version
    and each row's solo kernel on phase 5's pool (:data:`STACKED_BATCHES`,
    with each batch's time beside its rows as solo launches); then the
    serving path on the stand-in at phase 5's θ: ``solve_stacked`` of the
    eight stackable problems of :func:`stacked_problems` equal to their
    solo ``solve_problem`` in every field, one ``greedy_stacked`` launch
    and no solo greedy; ``execute_batch`` with ``stacked=True`` (counts
    reset just before it and read just after: one ``greedy_stacked``, no
    ``greedy_flat``/``greedy_flat_variant``) equal to ``stacked=False`` in
    every field, its ``stats_out`` one batch of eight; the stacked and the
    solo selections of the batch in turns on the sampled pool.  Returns
    ``greedy_stacked``'s record at that batch."""
    dev = g.device
    t18 = time.perf_counter()
    args, _ = pool_args(queue_store)
    n = queue_store.n_nodes
    checks = []
    for rows, mix in STACKED_BATCHES:
        reqs = stacked_requests(n, rows, mix)
        kw = cov.stacked_operands(queue_store, reqs, **stacked_geometry(n))
        got = ops.greedy_stacked(*args, **kw)
        solo_ms, solo_launches = solo_launches_ms(args, kw, 10)
        line = dict(check_stacked(args, kw, got), mix=mix,
                    requests=len(reqs),
                    ms=cuda_ms(lambda: ops.greedy_stacked(*args, **kw), 10),
                    solo_launches_ms=solo_ms, solo_launches=solo_launches,
                    steps_run=stacked_steps(got[0], kw))
        checks.append(line)
    say("stacked_checks", checks)

    theta = EXACT_POOL["theta"]
    probs = stacked_problems(n, theta)
    stackable = probs[:-1]
    solo_solver = IMMSolver(g, engine="queue", batch=BATCH, seed=0,
                            device=dev)
    want = [result_fields(solo_solver.solve_problem(p)) for p in stackable]
    stk = IMMSolver(g, engine="queue", batch=BATCH, seed=0, device=dev)
    stk.sample_until(theta)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = [result_fields(r) for r in stk.solve_stacked(stackable)]
    solve_launches = ops.launch_counts()
    mismatch = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
    if mismatch or solve_launches["greedy_stacked"] != 1 \
            or solve_launches["greedy_flat"] \
            or solve_launches["greedy_flat_variant"]:
        raise AssertionError(f"solve_stacked: rows {mismatch} differ from "
                             f"their solo solves, launches "
                             f"{ {k: v for k, v in solve_launches.items() if v} }")
    # the fixed θ samples whole rounds up to θ (phase 5's LB loop sampled
    # on to 8,704 rows)
    pool = {"theta": stk.stats.theta, "n_rr": stk.store.n_rr,
            "pool_elements": stk.store.n_elems}
    if pool["n_rr"] != -(-theta // BATCH) * BATCH:
        raise AssertionError(f"stacked pool {pool}: not θ's whole rounds")

    solo_batch = IMMSolver(g, engine="queue", batch=BATCH, seed=0, device=dev)
    res_solo = execute_batch(solo_batch, probs, stacked=False)
    batch_solver = IMMSolver(g, engine="queue", batch=BATCH, seed=0,
                             device=dev)
    stats: dict = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res_stacked = execute_batch(batch_solver, probs, stats_out=stats)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    same = [result_fields(a) == result_fields(b)
            for a, b in zip(res_solo, res_stacked)]
    if not all(same) or stats != {"stacked_batches": 1,
                                  "stacked_requests": len(stackable)}:
        raise AssertionError(f"execute_batch: stacked equals solo {same}, "
                             f"stats_out {stats}")
    if launches["greedy_stacked"] != 1 or launches["greedy_flat"] \
            or launches["greedy_flat_variant"]:
        raise AssertionError(f"execute_batch launched "
                             f"{ {k: v for k, v in launches.items() if v} }")

    # the batch's selections on the sampled pool: stacked against solo
    def stacked_sel():
        stk.solve_stacked(stackable)

    def solo_sel():
        for p in stackable:
            solo_solver.solve_problem(p)

    sel_ms = turns_ms({"solo": solo_sel, "stacked": stacked_sel}, reps=2)
    say("stacked_solve", {
        "theta": theta, **pool, "problems": len(probs),
        "stacked_requests": len(stackable),
        "solve_stacked_equals_solo": True, "execute_batch_equals_solo": True,
        "stats_out": stats, "solve_stacked_launches":
            {k: v for k, v in solve_launches.items() if v},
        "execute_batch_launches": {k: v for k, v in launches.items() if v},
        "execute_batch_s": batch_s, "selection_ms_in_turns": sel_ms,
        "seeds": [r.seeds.tolist()[:5] for r in res_stacked],
        "costs": [r.cost for r in res_stacked]})
    reqs, geometry = stk.stacked_requests([stk.prepare(p)
                                           for p in stackable])
    rec = stacked_record(stk.store, reqs, geometry, launches)
    say("phase18", {"seconds": time.perf_counter() - t18})
    return [rec]


# phase 19: durability and streaming on the stand-in
DURABLE_SKETCH_K = 1024
CKPT_EVERY = 5
CRASH_AT_SAMPLE = 12       # past the checkpoint at round 10
CHAOS_RATE = 0.1
EVICT_ROUNDS = 5
DELTA_EDGES, DELTA_P = 1000, 0.1
STREAM_MC_SIMS = 256
RESTORE_CODE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
dev = torch.device({dev!r})
solver = cs.IMMSolver(cs.stand_in_graph(dev), **cs.durable_options(dev))
step = solver.restore_pool({ckpt!r})
res = solver.solve(cs.IMProblem(k=cs.K, eps=cs.EPS))
print(json.dumps({{"step": step, "fields": cs.full_fields(res),
                   "launches": {{k: v for k, v in
                                 cs.ops.launch_counts().items() if v}}}}))
"""


def stand_in_graph(dev):
    """The epinions-like stand-in: BA(75,879, 4) with WC weights."""
    src, dst = generators.barabasi_albert(N_NODES, BA_R, seed=0)
    return weights.wc_weights(csr.from_edges(src, dst, N_NODES, device=dev))


def durable_options(dev) -> dict:
    """Phase 19's solver options: phase 5's, with the exact store's
    sketch."""
    return dict(engine="queue", batch=BATCH, seed=0,
                sketch_k=DURABLE_SKETCH_K, device=dev)


def full_fields(res) -> dict:
    """Every field of a result, its stats included, as JSON values."""
    return json.loads(json.dumps({**result_fields(res),
                                  "degraded": res.degraded,
                                  "stats": asdict(res.stats)}))


def states_equal(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def stream_deltas(g):
    """The streaming delta from ``default_rng(0)``: DELTA_EDGES removals
    drawn uniformly from the graph's edges, and DELTA_EDGES additions at
    uniform pairs u != v with p = DELTA_P."""
    rng = np.random.default_rng(0)
    src, dst, _ = csr.to_edges(g)
    n = g.n_nodes
    rm = rng.choice(src.shape[0], DELTA_EDGES, replace=False)
    a_s = rng.integers(0, n, DELTA_EDGES)
    a_d = (a_s + rng.integers(1, n, DELTA_EDGES)) % n
    return ((a_s, a_d, np.full(DELTA_EDGES, DELTA_P, np.float32)),
            (src[rm], dst[rm]))


def live_launches() -> dict:
    return {k: v for k, v in ops.launch_counts().items() if v}


def checkpoint_phase(g, want: dict, tmp: Path) -> Path:
    """19.2: a ``checkpoint_every=5`` solve that crashes at its twelfth
    sample, restored into a fresh solver and finished, and restored in a
    new process: each equal to the plain solve in every field.  Returns
    the directory of a checkpoint of the plain solve's final pool, which
    the timing of ``save_pool`` wrote."""
    dev = g.device
    mid = tmp / "mid"
    pol = FaultPolicy(injector=FaultInjector(
        fail_at={"sample": {CRASH_AT_SAMPLE}}), max_retries=0,
        sleep=lambda s: None)
    crashed = IMMSolver(g, fault_policy=pol, checkpoint_dir=str(mid),
                        checkpoint_every=CKPT_EVERY, **durable_options(dev))
    try:
        crashed.solve(IMProblem(k=K, eps=EPS))
    except InjectedFailure:
        pass
    else:
        raise AssertionError("the injected crash did not fire")
    crash_round = crashed.stats.rounds
    del crashed
    step = ckpt_mod.latest_step(str(mid))
    resumed = IMMSolver(g, **durable_options(dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed.restore_pool(str(mid))
    torch.cuda.synchronize()
    restore_mid_s = time.perf_counter() - t0
    got = full_fields(resumed.solve(IMProblem(k=K, eps=EPS)))
    if got != want:
        raise AssertionError(f"the restored solve differs from the plain "
                             f"one: {got} vs {want}")
    # save and restore the whole final pool, timed
    final = tmp / "final"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = Path(resumed.save_pool(str(final)))
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in path.iterdir())
    again = IMMSolver(g, **durable_options(dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again.restore_pool(str(final))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if not states_equal(again.store.state(), resumed.store.state()) \
            or again.store.flat.device.type != dev.type:
        raise AssertionError("save/restore changed the pool or its device")
    # the same mid-stream checkpoint in a new Python process
    t0 = time.perf_counter()
    sub = subprocess.run(
        [sys.executable, "-c", RESTORE_CODE.format(
            root=str(ROOT), ckpt=str(mid), dev=dev.type)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    sub_s = time.perf_counter() - t0
    if sub.returncode:
        raise AssertionError(f"the restore in a new process failed: "
                             f"{sub.stderr[-3000:]}")
    out = json.loads(sub.stdout.strip().splitlines()[-1])
    if out["fields"] != want or out["step"] != step:
        raise AssertionError(f"the restore in a new process differs: {out}")
    say("ckpt", {"checkpoint_every": CKPT_EVERY,
                 "crash_at_sample": CRASH_AT_SAMPLE,
                 "crash_round": crash_round, "restored_step": step,
                 "restore_mid_s": restore_mid_s,
                 "resumed_equals_plain": True,
                 "new_process_equals_plain": True,
                 "new_process_s": sub_s,
                 "new_process_launches": out["launches"],
                 "final_step": int(path.name[5:]), "save_pool_s": save_s,
                 "restore_pool_s": restore_s, "checkpoint_bytes": nbytes,
                 "pool_bytes": again.pool_bytes()})
    return final


def fault_phase(g, want: dict) -> None:
    """19.3: chaos at every site, rate 0.1, no sleeps: equal to the plain
    solve in every field but the pool bytes, which a ``grow`` fault's
    fallback to the exact footprint may change."""
    pol = FaultPolicy(injector=FaultInjector(rate=CHAOS_RATE, seed=0),
                      sleep=lambda s: None)
    t0 = time.perf_counter()
    res = IMMSolver(g, fault_policy=pol,
                    **durable_options(g.device)).solve(IMProblem(k=K, eps=EPS))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = full_fields(res)
    bytes_ = (got["stats"].pop("per_device_pool_bytes"),
              dict(want["stats"]).pop("per_device_pool_bytes"))
    if got != dict(want, stats={k: v for k, v in want["stats"].items()
                                if k != "per_device_pool_bytes"}):
        raise AssertionError(f"a solve with injected faults differs: {got}")
    by_site: dict = {}
    for site, _ in pol.injector.fired_log:
        by_site[site] = by_site.get(site, 0) + 1
    say("faults", {"rate": CHAOS_RATE, "fires": pol.injector.fires,
                   "fires_by_site": by_site,
                   "crossings": pol.injector.counts,
                   "retries": pol.retries, "gave_up": pol.gave_up,
                   "oom_recoveries": pol.oom_recoveries,
                   "pool_bytes_faulty_vs_plain": list(bytes_),
                   "equals_plain": True, "solve_s": secs})
    if pol.retries != pol.injector.fires or pol.gave_up:
        raise AssertionError(f"chaos: {pol.retries} retries for "
                             f"{pol.injector.fires} fires")


def scatter_record(words, v, b, launches=None, iters=20, plain_iters=3):
    """``sketch_scatter_or`` at a rebuild's pairs into zeroed words, byte
    for byte against its plain version; its record."""
    got = ops.sketch_scatter_or(torch.zeros_like(words), v, b)
    want = ref.sketch_scatter_or_ref(torch.zeros_like(words), v, b)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err or not torch.equal(got, want) or not torch.equal(got, words):
        raise AssertionError(f"the rebuild's sketch_scatter_or != its plain "
                             f"version or the rebuilt words: {err}")
    scratch = torch.zeros_like(words)
    rows, cols = words.shape
    return record("sketch_scatter_or", launches, err,
                  timing("sketch_scatter_or",
                         lambda: ops.sketch_scatter_or(scratch, v, b), iters),
                  cuda_ms(lambda: ref.sketch_scatter_or_ref(scratch, v, b),
                          plain_iters), scatter_bound_ms(words, v, b),
                  shape=[rows, cols], pairs=v.numel(),
                  path="phase 19's first eviction rebuild")


def eviction_phase(store, aff) -> tuple:
    """19.4: the three evictions on a card copy of the plain solve's pool,
    each equal (stats and ``state()``) to the same eviction on a CPU copy;
    the first rebuild's ``sketch_scatter_or`` against its plain version;
    the compaction that drops nothing equal to the incremental fold.
    Returns the scatter's record and the launches of the evictions."""
    state, cfg = store.state(), store.config()
    card = cov.DeviceRRStore.from_state(state, cfg, device=store.device)
    host = cov.DeviceRRStore.from_state(state, cfg, device="cpu")
    evictions = (
        ("evict_earliest_rounds",
         lambda st, _: st.evict_earliest_rounds(EVICT_ROUNDS)),
        ("evict_to_bytes", lambda st, half: st.evict_to_bytes(half)),
        ("evict_rows_containing",
         lambda st, _: st.evict_rows_containing(aff)))
    steps, states, first = [], [], None
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for name, fn in evictions:
        half = card.per_device_pool_bytes() // 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = fn(card, half)
        torch.cuda.synchronize()
        steps.append({"eviction": name, **stats, "bound": half,
                      "seconds": time.perf_counter() - t0,
                      "n_rounds": card.n_rounds})
        states.append(card.state())
        if first is None:
            t = card.n_elems
            first = (card.sketch_words().clone(), card.flat[:t].clone(),
                     card.ids[:t].clone())
    evict_launches = ops.launch_counts()
    # the same evictions on the CPU, from the same state
    for (name, fn), step, want in zip(evictions, steps, states):
        got = fn(host, step["bound"])
        if any(step[k] != v for k, v in got.items()) \
                or not states_equal(host.state(), want):
            raise AssertionError(f"{name} on the card != on the CPU: "
                                 f"{step} vs {got}")
    # the compaction that drops nothing: evict_to_bytes's rewrite when
    # the pool has append headroom, else the same rewrite called alone
    comp = cov.DeviceRRStore.from_state(state, cfg, device=store.device)
    tight = comp.capacity == cov._ceil_pow2(max(comp.n_elems, 1))
    ops.reset_launch_counts()
    if tight:
        st = comp._rewrite(*comp._live(), comp.n_rr)
    else:
        st = comp.evict_to_bytes(comp.per_device_pool_bytes() - 1)
    comp_launches = live_launches()
    if st["rows_dropped"] or not torch.equal(comp.sketch_words(),
                                             store.sketch_words()):
        raise AssertionError(f"the compaction changed the fold: {st}")
    words, v, ids = first
    rec = scatter_record(words, v, sketch_mod.bucket_of(
        ids, store.sketch_k, store.sketch_mode))
    say("eviction", {"pool_rows": store.n_rr, "pool_elements": store.n_elems,
                     "pool_capacity": store.capacity, "steps": steps,
                     "equals_cpu": True, "launches": {
                         k: v for k, v in evict_launches.items() if v},
                     "compaction": {**st, "via": "_rewrite" if tight
                                    else "evict_to_bytes",
                                    "equals_fold": True,
                                    "launches": comp_launches}})
    if evict_launches["sketch_scatter_or"] != 3:
        raise AssertionError(f"three rebuilds launched "
                             f"{evict_launches['sketch_scatter_or']} "
                             "sketch_scatter_or")
    return rec, {k: v + comp_launches.get(k, 0)
                 for k, v in evict_launches.items()}


def degraded_phase(g, solver, plain_solver, final: Path) -> dict:
    """19.5: ``deadline_s=0`` on the sketch pool (K sweeps, equal to the CPU
    run of the same checkpoint) and on phase 5's pool without a sketch;
    K distinct seeds each, the spread inside its bounds and the forward
    Monte Carlo inside [0.9 lo, 1.1 hi].  Returns the sketch run's
    launches."""
    out, launches = {}, None
    host = IMMSolver(g.to("cpu"), **durable_options("cpu"))
    host.restore_pool(str(final))
    for name, s in (("sketch", solver), ("no_sketch", plain_solver)):
        p = IMProblem(k=K, theta=s.stats.theta)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = s.solve_problem(p, deadline_s=0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = live_launches()
        lo, hi = res.spread_bounds
        t0 = time.perf_counter()
        mc = forward.ic_spread(g, res.seeds, n_sims=MC_SIMS, seed=4)
        out[name] = {"seeds": res.seeds.tolist()[:10], "n_seeds":
                     len(res.seeds), "spread": res.spread, "bounds": [lo, hi],
                     "frac": res.frac, "mc_spread": mc, "mc_sims": MC_SIMS,
                     "mc_s": time.perf_counter() - t0, "seconds": secs,
                     "launches": got}
        if not res.degraded or len(set(res.seeds.tolist())) != K \
                or not lo <= res.spread <= hi \
                or not 0.9 * lo <= mc <= 1.1 * hi:
            raise AssertionError(f"degraded {name}: {out[name]}")
        if name == "sketch":
            launches = got
            want = host.solve_problem(p, deadline_s=0)
            if full_fields(res) != full_fields(want):
                raise AssertionError("the degraded sweeps on the card != the "
                                     "CPU run of the same checkpoint")
            out[name]["equals_cpu"] = True
            if got.get("sketch_union_popcount") != K \
                    or got.get("popcount_words") != K:
                raise AssertionError(f"degraded sketch launches {got}")
        elif got.get("sketch_union_popcount") or got.get("popcount_words"):
            raise AssertionError(f"degraded without a sketch launched {got}")
    say("degraded", out)
    return launches


def covered_spread(store, seeds) -> float:
    """n times the share of the store's rows that hold one of ``seeds``:
    the RIS estimate of ``seeds`` on that pool."""
    t = store.n_elems
    hit = torch.isin(store.flat[:t], torch.as_tensor(
        np.asarray(seeds), dtype=torch.int32, device=store.flat.device))
    rows = torch.unique(store.ids[:t][hit]).numel()
    return store.n_nodes * rows / store.n_rr


def streaming_phase(g, solver) -> dict:
    """19.6: ``resolve_incremental`` of the stand-in's delta on the plain
    solve's pool against a cold solve on the post-delta graph, with a
    256-simulation forward Monte Carlo of both seed sets on the new graph.

    The cold estimate must lie within MC_TOL of its Monte Carlo.  The
    incremental pool is the reference's mixture (DESIGN.md §9.5): the kept
    rows are exact samples conditioned on avoiding the affected nodes, so
    its estimate may sit below the true spread by up to n·β·P(touch) (β
    the kept rows' share of the final pool, P(touch) the share of the
    old pool that the delta dropped), the total-variation allowance the
    reference documents; it must lie inside that allowance plus MC_TOL,
    and its seeds, scored on the unbiased cold pool as the reference's
    streaming check scores them, within MC_TOL of their Monte Carlo.  The
    round cursor must move on by the top-up's rounds.  Returns the
    incremental solve's launches."""
    deltas = stream_deltas(g)
    cursor0 = solver._cursor
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    inc = solver.resolve_incremental(IMProblem(k=K, eps=EPS), deltas)
    torch.cuda.synchronize()
    inc_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    info = dict(solver.last_incremental)
    new_g = solver.g
    t0 = time.perf_counter()
    cold_solver = IMMSolver(new_g, **durable_options(g.device))
    torch.cuda.synchronize()
    cold_setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = cold_solver.solve(IMProblem(k=K, eps=EPS))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    mc = {name: forward.ic_spread(new_g, r.seeds, n_sims=STREAM_MC_SIMS,
                                  seed=5)
          for name, r in (("incremental", inc), ("cold", cold))}
    rel = {name: abs(r.spread - mc[name]) / mc[name]
           for name, r in (("incremental", inc), ("cold", cold))}
    rescored = covered_spread(cold_solver.store, inc.seeds)
    rescored_rel = abs(rescored - mc["incremental"]) / mc["incremental"]
    beta = info["rows_kept"] / solver.store.n_rr
    touch = info["rows_dropped"] / max(info["n_rr_before"], 1)
    allowance = g.n_nodes * beta * touch
    inc_ok = abs(inc.spread - mc["incremental"]) <= \
        allowance + MC_TOL * mc["incremental"]
    top_up = solver._cursor - cursor0
    say("streaming", {
        **info, "edges_before": g.n_edges, "edges_after": new_g.n_edges,
        "resolve_incremental_s": inc_s, "cold_setup_s": cold_setup_s,
        "cold_solve_s": cold_s, "incremental_rounds": inc.stats.rounds,
        "cold_rounds": cold.stats.rounds, "cursor_before": cursor0,
        "cursor_after": solver._cursor, "incremental_theta":
            inc.stats.theta, "cold_theta": cold.stats.theta,
        "incremental_n_rr": solver.store.n_rr,
        "incremental_spread": inc.spread, "cold_spread": cold.spread,
        "mc_spread": mc, "mc_sims": STREAM_MC_SIMS, "rel_err": rel,
        "within_mc_tol": {k: v < MC_TOL for k, v in rel.items()},
        "kept_share_beta": beta, "touch_share": touch,
        "tv_allowance_spread": allowance,
        "incremental_inside_allowance": inc_ok,
        "incremental_seeds_on_cold_pool": rescored,
        "incremental_seeds_on_cold_pool_rel_err": rescored_rel,
        "launches": {k: v for k, v in launches.items() if v},
        "seeds_incremental": inc.seeds.tolist()[:10],
        "seeds_cold": cold.seeds.tolist()[:10]})
    if not info["reused"] or top_up != inc.stats.rounds or not inc_ok \
            or rel["cold"] >= MC_TOL or rescored_rel >= MC_TOL \
            or len(set(inc.seeds.tolist())) != K:
        raise AssertionError(f"streaming: {info}, top-up {top_up} rounds of "
                             f"{inc.stats.rounds}, rel err {rel}, on the "
                             f"cold pool {rescored_rel}, allowance "
                             f"{allowance}")
    return launches


def durability_phase(g, queue_res, plain_solver) -> tuple:
    """Phase 19 (see the module docstring).  Returns the record of
    ``sketch_scatter_or`` at the first eviction's rebuild and the launches
    of the eviction, degraded and incremental paths."""
    dev = g.device
    t19 = time.perf_counter()
    solver = IMMSolver(g, **durable_options(dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(IMProblem(k=K, eps=EPS))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    want = full_fields(res)
    if want["seeds"] != [int(x) for x in queue_res.seeds] \
            or want["frac_f32"] != np.float32(queue_res.frac).tobytes().hex():
        raise AssertionError("the sketch_k=1024 solve differs from phase 5")
    say("durable_plain", {"solve_s": plain_s, "rounds": res.stats.rounds,
                          "n_rr": solver.store.n_rr,
                          "pool_capacity": solver.store.capacity,
                          "sketch_k": DURABLE_SKETCH_K})
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        final = checkpoint_phase(g, want, Path(tmp))
        fault_phase(g, want)
        aff = stream.affected_nodes(stream.make_deltas(*stream_deltas(g)))
        rec, evict_launches = eviction_phase(solver.store, aff)
        degraded_launches = degraded_phase(g, solver, plain_solver, final)
    inc_launches = streaming_phase(g, solver)
    say("phase19", {"seconds": time.perf_counter() - t19})
    return [rec], {"phase 19's evictions (3) and compaction":
                   evict_launches,
                   "phase 19's degraded answer (sketch pool)":
                   degraded_launches,
                   "phase 19's incremental solve": inc_launches}


# phase 20: the serving front on the stand-in
SERVE_WINDOW_S = 0.002
SERVE_MAX_BATCH = 16
SERVE_QUEUE_CAP = 4
SERVE_BURST = 16
SERVE_BURST_THETA = 4         # the burst's θ, in phase 5's θ: a new pool
SERVE_SPILL_BUDGET = 1.5      # the budget, in the first entry's pool bytes
SERVE_CLUSTER_KEYS = 12
SERVE_CHAOS_RATE = 0.1


def serve_options() -> dict:
    """The service's solver options: phase 5's, on the card."""
    return {"batch": BATCH, "seed": 0, "device": "cuda"}


def wire_state(res_state: dict) -> dict:
    """A ``result_state`` without ``stats.variant``: a result's stats are
    its solver's live stats, so the results of one batch share the
    variant of the batch's last request (in both packages)."""
    out = dict(res_state, stats=dict(res_state["stats"]))
    out["stats"].pop("variant")
    return out


async def serve_gate(g, probs, want, spill: Path) -> dict:
    """20.1-20.3 and 20.6: the gate's concurrent requests over HTTP, the
    resend from the cache, the typed errors, the shed burst and the
    drain."""
    svc = build_service({"graph": g}, ServeConfig(
        max_batch=SERVE_MAX_BATCH, batch_window_s=SERVE_WINDOW_S,
        solver_opts=serve_options(), spill_dir=str(spill)))
    server = IMNetServer(svc, port=0)
    await server.start()
    c = IMClient("127.0.0.1", server.port)
    lat: list = []

    async def timed(p):
        t0 = time.perf_counter()
        doc = await c.solve("graph", p)
        lat.append(time.perf_counter() - t0)
        return doc

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    docs = await asyncio.gather(*(timed(p) for p in probs))
    gate_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = live_launches()
    bad = [i for i, (d, w) in enumerate(zip(docs, want))
           if wire_state(d["result"]) != wire_state(w)]
    if bad or any(d["degraded"] for d in docs):
        raise AssertionError(f"serving: answers {bad} differ from the cold "
                             f"solves on the card")
    for name in ("queue_bfs", "greedy_stacked", "greedy_flat"):
        if not launches.get(name):
            raise AssertionError(f"serving: {name} was not launched under "
                                 f"the service: {launches}")
    st = (await c.stats())["serve"]
    # the fixed-θ requests share one key: one or two micro-batches, and
    # the ε-driven request a batch of its own
    if not (st["served"] == len(probs) and 2 <= st["batches"] <= 3
            and st["stacked_batches"] >= 1 and st["occur_fastpath"] >= 1
            and st["stacked_requests"] >= 2):
        raise AssertionError(f"serving: statsz {st}")
    again = await asyncio.gather(*(c.solve("graph", p) for p in probs))
    if not all(d["cached"] for d in again) or \
            [d["result"] for d in again] != [d["result"] for d in docs]:
        raise AssertionError("serving: the resend did not come back cached "
                             "with the same bits")

    # 20.2 the typed errors
    errors = {}
    status, doc = await c.solve_raw("nope", probs[0])
    errors["unknown_graph"] = [status, doc["error"]["code"]]
    bad_p = IMProblem(k=K, theta=probs[0].theta,
                      candidates=np.array([g.n_nodes + 5]))
    status, doc = await c.solve_raw("graph", bad_p)
    errors["out_of_range"] = [status, doc["error"]["code"]]
    status, doc = await c.solve_raw("graph", IMProblem(
        k=7, theta=probs[0].theta), deadline_s=0.0)
    errors["zero_deadline"] = [status, doc["error"]["code"] if status != 200
                               else "degraded" if doc["degraded"] else
                               "served"]
    if errors["unknown_graph"] != [404, "unknown_graph"] or \
            errors["out_of_range"] != [400, "invalid_problem"] or \
            errors["zero_deadline"] not in ([504, "deadline_expired"],
                                            [200, "degraded"]):
        raise AssertionError(f"serving: errors {errors}")

    # 20.6 the drain: readyz turns 503, solves are refused typed, then
    # shutdown() flushes and spills
    server.draining = True
    ready = (await c.readyz())[0]
    status, doc = await c.solve_raw("graph", probs[0])
    server.draining = False
    if ready != 503 or (status, doc["error"]["code"]) != (503, "draining"):
        raise AssertionError(f"serving: drain gave readyz {ready}, solve "
                             f"{status}")
    entries = len(svc.registry.entries)
    await server.shutdown()
    reg = svc.registry.snapshot()
    if reg.spills != entries or svc.registry.entries:
        raise AssertionError(f"serving: shutdown spilled {reg.spills} of "
                             f"{entries} entries")
    return {"gate_s": gate_s, "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99)), "latency_s": lat,
            "launches": launches, "batches": st["batches"],
            "occupancy_mean": st["batch_occupancy_mean"],
            "occupancy_max": st["batch_occupancy_max"],
            "stacked_batches": st["stacked_batches"],
            "stacked_requests": st["stacked_requests"],
            "occur_fastpath": st["occur_fastpath"],
            "cache_hits_on_resend": svc.cache.snapshot().hits,
            "errors": errors, "drain_spills": reg.spills}


async def serve_shed(g, theta: int) -> dict:
    """20.2: a burst of distinct requests past ``queue_cap`` is shed with
    429, every other answer served.  The burst's θ needs a new pool, so the
    first batch samples while the rest arrive."""
    svc = build_service({"graph": g}, ServeConfig(
        max_batch=SERVE_MAX_BATCH, batch_window_s=SERVE_WINDOW_S,
        queue_cap=SERVE_QUEUE_CAP, solver_opts=serve_options()))
    server = IMNetServer(svc, port=0)
    await server.start()
    try:
        c = IMClient("127.0.0.1", server.port)
        got = await asyncio.gather(*(
            c.solve_raw("graph", IMProblem(k=k + 1,
                                          theta=SERVE_BURST_THETA * theta))
            for k in range(SERVE_BURST)))
    finally:
        await server.shutdown(spill=False)
    codes = sorted({s for s, _ in got})
    shed = sum(s == 429 for s, _ in got)
    if not shed or set(codes) - {200, 429} or svc.shed != shed:
        raise AssertionError(f"serving: burst statuses {codes}, shed {shed}")
    return {"burst": SERVE_BURST, "queue_cap": SERVE_QUEUE_CAP,
            "shed": shed, "served": sum(s == 200 for s, _ in got)}


async def serve_spill(g, probs, want, spill: Path) -> dict:
    """20.4: a budget of 1.5x the first entry's pool bytes evicts it into
    ``spill_dir`` when a second key arrives; the next request on the first
    key (another k, so no cache hit) rehydrates with no sampling and
    answers bit-identically."""
    svc = build_service({"graph": g}, ServeConfig(
        max_batch=SERVE_MAX_BATCH, solver_opts=serve_options(),
        spill_dir=str(spill)))
    reg = svc.registry
    clock = StageClock()
    clock.wrap(reg, "evict", "spill")
    clock.wrap(reg, "get", "get")
    async with svc:
        first = await svc.submit("graph", probs[0])
        pool_bytes = reg.bytes_in_use()
        reg.memory_budget_bytes = int(SERVE_SPILL_BUDGET * pool_bytes)
        await svc.submit("graph", IMProblem(k=K, theta=2 * probs[0].theta))
        spilled = reg.snapshot()
        spill_s = clock.seconds["spill"]
        ckpt_bytes = sum(f.stat().st_size for f in spill.rglob("*")
                         if f.is_file())
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        get_s = clock.seconds["get"]
        again = await svc.submit("graph", probs[3])
        torch.cuda.synchronize()
        launches = live_launches()
        after = reg.snapshot()
        # the rehydrating get, and the eviction of the second key it forced
        rehydrate_s = clock.seconds["get"] - get_s
    if spilled.spills != 1 or after.rehydrations != 1 \
            or launches.get("queue_bfs") or launches.get("bernoulli_edges"):
        raise AssertionError(f"serving: spill {spilled}, rehydrate {after}, "
                             f"launches {launches}")
    if wire_state(result_state(again.result)) != wire_state(want[3]) or \
            wire_state(result_state(first.result)) != wire_state(want[0]):
        raise AssertionError("serving: the rehydrated entry's answer "
                             "differs from the cold solve")
    return {"pool_bytes": pool_bytes, "budget": reg.memory_budget_bytes,
            "checkpoint_bytes": ckpt_bytes, "spill_s": spill_s,
            "rehydrate_get_s": rehydrate_s,
            "rehydrate_launches": launches,
            "spills": after.spills, "rehydrations": after.rehydrations}


async def serve_chaos(g, probs, want) -> dict:
    """20.5: the gate's fixed-θ requests under ``FaultInjector(rate=0.1)``
    at all five sites, the first ``executor`` crossing failing for sure
    (the batch dies, its entry is quarantined and each request reruns
    alone): every request resolves to a served, degraded or typed outcome,
    and every served exact answer is the gate's."""
    pol = FaultPolicy(injector=FaultInjector(
        rate=SERVE_CHAOS_RATE, seed=0, fail_at={"executor": {1}}))
    svc = build_service({"graph": g}, ServeConfig(
        max_batch=SERVE_MAX_BATCH, batch_window_s=SERVE_WINDOW_S,
        solver_opts={**serve_options(), "fault_policy": pol}))
    server = IMNetServer(svc, port=0)
    await server.start()
    try:
        c = IMClient("127.0.0.1", server.port)
        got = await asyncio.gather(*(c.solve_raw("graph", p)
                                     for p in probs))
    finally:
        await server.shutdown(spill=False)
    codes = {cls.code: status for cls, status in ERROR_STATUS.items()}
    outcomes = []
    for (status, doc), w in zip(got, want):
        if status == 200:
            if doc["degraded"]:
                outcomes.append("degraded")
                continue
            if wire_state(doc["result"]) != wire_state(w):
                raise AssertionError("serving: a chaos answer differs from "
                                     "the gate's")
            outcomes.append("served")
        elif codes.get(doc["error"]["code"]) == status:
            outcomes.append(doc["error"]["code"])
        else:
            raise AssertionError(f"serving: untyped chaos outcome {status} "
                                 f"{doc}")
    st = svc.stats()
    return {"rate": SERVE_CHAOS_RATE, "fires": pol.injector.fires,
            "fired_sites": sorted({s for s, _ in pol.injector.fired_log}),
            "solver_retries": pol.retries, "quarantines": st.quarantines,
            "isolated_retries": st.isolated_retries, "outcomes": outcomes}


async def serve_cluster(g, theta: int) -> dict:
    """20.7: two workers on the one card.  Twelve θ-pinned keys, sent at
    once (both workers' requests in flight together), each pool on exactly
    one worker and every answer the cold solve's; after ``add_worker`` the
    moved keys are adopted warm and answer bit-identically."""
    dev = g.device
    thetas = [theta + i for i in range(SERVE_CLUSTER_KEYS)]
    probs = [IMProblem(k=10, theta=t) for t in thetas]
    want = [result_state(IMMSolver(g, engine="queue", batch=BATCH, seed=0,
                                   device=dev).solve_problem(p))
            for p in probs]
    cl = IMCluster({"graph": g}, ServeConfig(
        max_batch=8, solver_opts=serve_options()), workers=2)
    await cl.start()
    spans = []

    async def timed(p):
        t0 = time.perf_counter()
        r = await cl.submit("graph", p)
        spans.append((cl.ring.owner(cl.route_key("graph", p)), t0,
                      time.perf_counter()))
        return r
    try:
        t0 = time.perf_counter()
        got = await asyncio.gather(*(timed(p) for p in probs))
        first_s = time.perf_counter() - t0
        regs = [w.service.registry for w in cl._workers.values()]
        keys = [set(r.entries) for r in regs]
        if sum(map(len, keys)) != len(set().union(*keys)) \
                or len(set().union(*keys)) != len(thetas) \
                or not all(keys):
            raise AssertionError(f"cluster: pools per worker "
                                 f"{[len(k) for k in keys]}")
        overlap = any(a[0] != b[0] and a[1] < b[2] and b[1] < a[2]
                      for a in spans for b in spans)
        if not overlap:
            raise AssertionError("cluster: the two workers' requests never "
                                 "overlapped")
        wid = cl.add_worker()
        moved = cl.handoffs
        new_reg = cl._workers[wid].service.registry
        again = await asyncio.gather(*(
            cl.submit("graph", IMProblem(k=10, theta=t)) for t in thetas))
        snap = new_reg.snapshot()
    finally:
        await cl.stop()
    states = [wire_state(result_state(r.result)) for r in got]
    states2 = [wire_state(result_state(r.result)) for r in again]
    if states != [wire_state(w) for w in want] or states2 != states:
        raise AssertionError("cluster: answers differ from the cold solves")
    if not moved or snap.handoffs_in != moved or snap.created != moved:
        raise AssertionError(f"cluster: handoffs {moved}, new worker {snap}")
    return {"keys": len(thetas), "workers": 2, "first_round_s": first_s,
            "pools_per_worker": [len(k) for k in keys],
            "in_flight_together": overlap, "handoffs": moved,
            "adopted_warm": snap.handoffs_in}


def serving_phase(g) -> dict:
    """Phase 20 (see the module docstring).  Returns the gate's launches."""
    dev = g.device
    t20 = time.perf_counter()
    theta = EXACT_POOL["theta"]
    probs = stacked_problems(g.n_nodes, theta) + [IMProblem(k=K, eps=EPS)]
    t0 = time.perf_counter()
    want = [result_state(IMMSolver(g, engine="queue", batch=BATCH, seed=0,
                                   device=dev).solve_problem(p))
            for p in probs]
    cold_s = time.perf_counter() - t0
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        gate = asyncio.run(serve_gate(g, probs, want, Path(tmp) / "gate"))
        spill = asyncio.run(serve_spill(g, probs[:-1], want,
                                        Path(tmp) / "spill"))
    shed = asyncio.run(serve_shed(g, theta))
    chaos = asyncio.run(serve_chaos(g, probs[:-1], want[:-1]))
    cluster = asyncio.run(serve_cluster(g, theta))
    seconds = time.perf_counter() - t20
    smi = nvidia_smi()
    say("serving", {
        "seconds": seconds, "cold_solves_s": cold_s,
        "latency_p50_s": gate["latency_p50_s"],
        "latency_p99_s": gate["latency_p99_s"],
        "occupancy_mean": gate["occupancy_mean"],
        "occupancy_max": gate["occupancy_max"],
        "cache_hits": gate["cache_hits_on_resend"], "sheds": shed["shed"],
        "spill_s": spill["spill_s"],
        "rehydrate_s": spill["rehydrate_get_s"],
        "checkpoint_bytes": spill["checkpoint_bytes"],
        "chaos_retries": chaos["solver_retries"],
        "handoffs": cluster["handoffs"], "card": smi})
    say("serving_gate", gate)
    say("serving_shed", shed)
    say("serving_spill", spill)
    say("serving_chaos", chaos)
    say("serving_cluster", cluster)
    say("phase20", {"seconds": seconds})
    return gate["launches"]


# phase 21: the selections of the sharded solves, the ranks of (b) and (c)
# and their lanes a rank (phase 5's batch split between them)
SHARDED_SELECTIONS = ("fused", "bitset", "celf")
SHARDED_RANKS = 2
SHARDED_BATCH = BATCH // SHARDED_RANKS
SHARDED_TIMEOUT_S = 300
SHARDED_METHOD = {"fused": "flat", "bitset": "bitset", "celf": "celf"}


def sharded_fields(res) -> dict:
    """What a sharded solve must share with phase 5's."""
    st = res.stats
    return {"seeds": [int(x) for x in res.seeds],
            "gains": [int(x) for x in res.gains],
            "frac_f32": np.float32(res.frac).tobytes().hex(),
            "theta": st.theta, "spread": res.spread,
            "n_rr": st.n_rr_sampled, "rounds": st.rounds}


def sharded_solves(g, mesh, engine: str, batch: int) -> tuple:
    """Phase 5's problem on ``mesh`` with each of
    :data:`SHARDED_SELECTIONS`: each solve's fields, stage seconds,
    launches (reset just before the solve, read just after), per-rank pool
    bytes and collectives, then one more selection on its pool for the
    collectives of one selection.  -> (the runs by selection, the stores
    by selection)."""
    runs, stores = {}, {}
    for sel in SHARDED_SELECTIONS:
        solver = IMMSolver(g, engine=engine, batch=batch, seed=0,
                           selection=sel, mesh=mesh)
        clock = StageClock()
        clock.wrap(solver.engine, "sample_sharded"
                   if engine == "queue_sharded" else "sample", "sampling")
        clock.wrap(solver.store, "append_batch", "append")
        clock.wrap(solver.store, "select", "selection")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        before = mesh.collectives
        t0 = time.perf_counter()
        res = solver.solve(IMProblem(k=K, eps=EPS))
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches = live_launches()
        solve_coll = mesh.collectives - before
        before = mesh.collectives
        solver.store.select(K, method=SHARDED_METHOD[sel])
        runs[sel] = {"fields": sharded_fields(res), "solve_s": solve_s,
                     "stage_s": dict(clock.seconds),
                     "stage_calls": dict(clock.calls),
                     "launches": launches, "collectives_solve": solve_coll,
                     "collectives_a_selection": mesh.collectives - before,
                     "per_rank_pool_bytes": res.stats.per_device_pool_bytes,
                     "pool_sharding": res.stats.pool_sharding,
                     "rank_rows": int(solver.store._nrr),
                     "rank_elements": int(solver.store._t)}
        stores[sel] = solver.store
    return runs, stores


def sharded_rank(rank: int, size: int, init: str, out_dir: str) -> None:
    """One of phase 21's gloo ranks on the one card: the two-rank solves
    with the ``queue`` engine (b) and with ``queue_sharded`` at
    :data:`SHARDED_BATCH` lanes a rank (c), written to
    ``out_dir/rank<rank>.json``.  A first ``all_reduce`` of a CUDA tensor
    checks that this gloo build takes CUDA tensors; where it refuses them,
    the rank fails the phase with gloo's message."""
    from datetime import timedelta
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size,
                            timeout=timedelta(seconds=SHARDED_TIMEOUT_S))
    try:
        try:
            dist.all_reduce(torch.ones(1, device=dev))
        except RuntimeError as err:
            raise RuntimeError("gloo refuses an all_reduce of a CUDA "
                               f"tensor on this build: {err}") from err
        mesh = make_sample_mesh(device=dev)
        g = stand_in_graph(dev)
        two, _ = sharded_solves(g, mesh, "queue", BATCH)
        blocks, _ = sharded_solves(g, mesh, "queue_sharded", SHARDED_BATCH)
        out = {"gloo_takes_cuda_tensors": True,
               "two_ranks": two, "queue_sharded": blocks}
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def shard_step_bound(t: int, n: int, steps: int, new_elems: int) -> dict:
    """The least time of a ``shard_flat_step`` on average over a
    selection's ``steps`` steps: the shard's node ids read once a step, the
    row id, valid byte and node id of each element of the new rows once,
    and the (n + 1) decrement written once a step."""
    return _bound((steps * (4 * t + 4 * (n + 1)) + 9 * new_elems) / steps,
                  {})


def shard_records(store, launches, iters=20, plain_iters=3) -> list:
    """``occur_flat`` and ``shard_flat_step`` at the one-rank solve's pool
    against their plain versions on the card (max abs err 0: the Occur;
    every step's decrement and Covered words over the selection's K steps,
    each seed the argmax of the plain Occur), then timed: ``occur_flat``
    beside ``torch.bincount`` (the same function on the live extent, where
    every element is valid and below n); the step as the mean of the K
    steps from empty Covered words."""
    t, n = store._t, store.n_nodes
    flat, ids, valid = store.flat[:t], store.ids[:t], store.valid[:t]
    got = ops.occur_flat(flat, valid, n=n)
    want = ref.occur_flat_ref(flat, valid, n=n)
    lib = torch.bincount(flat, minlength=n)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err or not torch.equal(got, want) or not bool(valid.all()) \
            or not torch.equal(lib.to(torch.int32), want):
        raise AssertionError(f"occur_flat != plain version (err {err}) or "
                             "bincount")
    occur_rec = record(
        "occur_flat", launches, err,
        timing("occur_flat", lambda: ops.occur_flat(flat, valid, n=n),
               iters),
        cuda_ms(lambda: ref.occur_flat_ref(flat, valid, n=n), plain_iters),
        _bound(5 * t + 4 * n, {}),
        library_ms=cuda_ms(lambda: torch.bincount(flat, minlength=n), iters),
        library_call="torch.bincount(flat, minlength=n)", n=n,
        pool_elements=t)
    rows = store.row_capacity()
    cov_k = torch.zeros(rows // 32, dtype=torch.int32, device=flat.device)
    cov_p = cov_k.clone()
    occur, us, err, new_elems = want.clone(), [], 0.0, 0
    for _ in range(K):
        u = torch.argmax(occur).view(1)
        dk = ops.shard_flat_step(flat, ids, valid, cov_k, u, n=n)
        dp = ref.shard_flat_step_ref(flat, ids, valid, cov_p, u, n=n)
        err = max(err, max_abs_err(dk, dp), max_abs_err(cov_k, cov_p))
        occur -= dp[:n]
        new_elems += int(dp[:n].sum())
        us.append(u)
    if err:
        raise AssertionError(f"shard_flat_step != plain version: max abs "
                             f"err {err}")

    def steps(fn):
        cov_k.zero_()
        for u in us:
            fn(flat, ids, valid, cov_k, u, n=n)

    times = {"ms": cuda_ms(lambda: steps(ops.shard_flat_step), iters) / K,
             **device_ms(lambda: steps(ops.shard_flat_step), iters,
                         DEVICE_KERNEL["shard_flat_step"]),
             "enqueue_us": enqueue_us(lambda: steps(ops.shard_flat_step),
                                      iters) / K}
    plain_ms = cuda_ms(lambda: steps(ref.shard_flat_step_ref),
                       plain_iters) / K
    step_rec = record("shard_flat_step", launches, err, times, plain_ms,
                      shard_step_bound(t, n, K, new_elems), steps=K,
                      new_row_elements=new_elems, n=n, pool_elements=t,
                      num_rows=rows)
    return [occur_rec, step_rec]


def sharded_phase(g, queue_res) -> tuple:
    """Phase 21 (see the module docstring): -> (the two kernels' records,
    the one-rank CELF solve's launches)."""
    t21 = time.perf_counter()
    dev = g.offsets.device
    want = sharded_fields(queue_res)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_sample_mesh(device=dev)
        one, stores = sharded_solves(g, mesh, "queue", BATCH)
    finally:
        dist.destroy_process_group()
    flat_launches = one["fused"]["launches"]
    for name in ("occur_flat", "shard_flat_step"):
        if not flat_launches.get(name):
            raise AssertionError(f"{name} was not launched on the sharded "
                                 f"flat path: {flat_launches}")
    if flat_launches.get("greedy_flat"):
        raise AssertionError("the sharded flat path launched greedy_flat")
    recs = shard_records(stores["fused"], flat_launches)
    del stores
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(sharded_rank, nprocs=SHARDED_RANKS,
                 args=(SHARDED_RANKS, f"file://{tmp}/rdzv", tmp))
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(SHARDED_RANKS)]
    spawn_s = time.perf_counter() - t0
    solves = {"one_rank_nccl": one}
    for kind in ("two_ranks", "queue_sharded"):
        for r in range(SHARDED_RANKS):
            solves[f"{kind}_rank{r}"] = ranks[r][kind]
    checks = {f"{label}:{sel}": run["fields"] == want
              for label, runs in solves.items() for sel, run in runs.items()}

    def lean(runs):
        return {sel: {k: v for k, v in run.items() if k != "fields"}
                for sel, run in runs.items()}

    say("sharded", {
        "seconds": time.perf_counter() - t21, "spawn_s": spawn_s,
        "equal_to_phase5": checks, "card": nvidia_smi(),
        "gloo_takes_cuda_tensors": ranks[0]["gloo_takes_cuda_tensors"],
        "phase5": dict(want, seeds=want["seeds"][:10],
                       gains=want["gains"][:10]),
        "one_rank_nccl": lean(one),
        "two_ranks": [lean(r["two_ranks"]) for r in ranks],
        "queue_sharded": [lean(r["queue_sharded"]) for r in ranks]})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"sharded solves differ from phase 5: {bad}")
    return recs, one["celf"]["launches"]


def main() -> int:
    t_start = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    say("torch", {"torch": torch.__version__, "cuda": torch.version.cuda,
                  "device": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count()})
    say("card_rates", card_rates())

    # 2. build: one nvcc per source, all started together, with the
    # stamped copies of the two selection kernels
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + len(STAMPED_SOURCES)) as pool:
        stamped = pool.map(STAMPS.build_one, STAMPED_SOURCES.values())
        libs = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
        STAMPED.update((key, ctypes.CDLL(str(lib)))
                       for key, lib in zip(STAMPED_SOURCES, stamped))
    say("build", {"libraries": {k: str(v.relative_to(ROOT))
                                for k, v in libs.items()},
                  "seconds": time.perf_counter() - t0})
    for name in SOURCES:
        print(_build.PTXAS_REPORT.get(name, f"({name}: cached build, no "
                                            "ptxas report)"), flush=True)
    occur_spills = ptxas_spills(_build.PTXAS_REPORT["occur"], "occur_")
    say("occur_ptxas", occur_spills)
    if len(occur_spills) != 3 or any(occur_spills.values()):
        raise AssertionError(f"occur.cu: want 3 kernels without spills, "
                             f"ptxas reports {occur_spills}")
    greedy_spills = ptxas_spills(_build.PTXAS_REPORT["greedy"], "greedy_cu")
    say("greedy_ptxas", greedy_spills)
    if len(greedy_spills) != GREEDY_KERNELS or any(greedy_spills.values()):
        raise AssertionError(f"greedy.cu: want {GREEDY_KERNELS} kernels "
                             f"without spills, ptxas reports {greedy_spills}")
    celf_spills = ptxas_spills(_build.PTXAS_REPORT["celf"], "celf_")
    say("celf_ptxas", celf_spills)
    if len(celf_spills) != CELF_KERNELS or any(celf_spills.values()):
        raise AssertionError(f"celf.cu: want {CELF_KERNELS} kernels without "
                             f"spills, ptxas reports {celf_spills}")
    membership_spills = ptxas_spills(_build.PTXAS_REPORT["membership"],
                                     "membership_cu")
    say("membership_ptxas", membership_spills)
    if len(membership_spills) != 2 or any(membership_spills.values()):
        raise AssertionError(f"membership.cu: want 2 kernels without "
                             f"spills, ptxas reports {membership_spills}")
    shard_spills = {**ptxas_spills(_build.PTXAS_REPORT["shard"],
                                   "occur_flat_kernel"),
                    **ptxas_spills(_build.PTXAS_REPORT["shard"],
                                   "shard_flat_step_kernel")}
    say("shard_ptxas", shard_spills)
    if len(shard_spills) != 2 or any(shard_spills.values()):
        raise AssertionError(f"shard.cu: want 2 kernels without spills, "
                             f"ptxas reports {shard_spills}")
    lt_spills = ptxas_spills(_build.PTXAS_REPORT["lt"], "lt_walk_kernel")
    say("lt_ptxas", lt_spills)
    if len(lt_spills) != 1 or any(lt_spills.values()):
        raise AssertionError(f"lt.cu: want lt_walk_kernel without spills, "
                             f"ptxas reports {lt_spills}")
    # queue_bfs's six forms (dedup x tiled) and refill_bfs's three
    for src, kernel, count in (("queue", "queue_bfs_kernel", 6),
                               ("refill", "refill_bfs_kernel", 3)):
        report = _build.PTXAS_REPORT[src]
        spills = ptxas_spills(report, kernel)
        say(f"{src}_ptxas", {"spills": spills,
                             "registers": ptxas_registers(report, kernel)})
        if len(spills) != count or any(spills.values()):
            raise AssertionError(f"{src}.cu: want {count} kernels without "
                                 f"spills, ptxas reports {spills}")

    # 3. kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    words = random_words(SYNTH_SHAPE, gen)
    mask = (torch.rand(SYNTH_SHAPE[0], device=dev, generator=gen)
            < 0.5).to(torch.int32)
    say("kernels", kernel_records(words, mask))
    del words, mask
    at_scale, greedy_checks = [], []
    for cols in (SKETCH_WORDS, 4):
        words = random_words((SKETCH_ROWS, cols), gen)
        cov_words = random_words((64, cols), gen)[0]
        v, b = random_pairs(SKETCH_ROWS, cols,
                            SCATTER_PAIRS if cols == SKETCH_WORDS else 1 << 16,
                            gen)
        at_scale += sketch_records(words, cov_words, v, b)
        greedy_checks.append(check_greedy_sketch(words))
    say("sketch_kernels_at_scale", at_scale)
    say("greedy_sketch_random", greedy_checks)
    del words, cov_words, v, b
    # the dense path's kernels at its shapes (random data), and ragged
    g = stand_in_graph(dev)
    n_pad = ((N_NODES + 31) // 32) * 32
    say("dense_kernels_at_path_shapes", check_dense_kernels(
        torch.rand(BATCH, n_pad, device=dev, generator=gen) < 0.5,
        random_words((BATCH, n_pad // 32), gen),
        random_words((BATCH, n_pad // 32), gen),
        plant_edge_weights(torch.rand(g.n_edges, device=dev, generator=gen)),
        torch.randint(0, 1 << 32, (BATCH,), device=dev, generator=gen)))
    say("dense_kernels_ragged", ragged_dense_checks(gen))
    # the queue sampler's kernel at the exact path's first round
    g_rev = csr.coalesce_ic(csr.reverse(g))
    queue_check = check_queue_kernel(g_rev)
    say("queue_kernel", queue_check)
    torch.cuda.empty_cache()

    # 4. the approximate (pool-free) solve: the second slice's path
    approx_records = approximate_phase(g)

    # 5. the exact path: one plain IC solve with the bitset selection
    t0 = time.perf_counter()
    solver = IMMSolver(g, engine="queue", batch=BATCH, selection="bitset",
                       seed=0, device=dev)
    setup_s = time.perf_counter() - t0
    clock = StageClock()
    clock.wrap(solver.engine, "sample", "sampling")
    clock.wrap(solver.store, "append_batch", "append")
    clock.wrap(solver.store, "bitset_matrix", "bitset_build")
    clock.wrap(solver.store, "select", "select_total")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = solver.solve(IMProblem(k=K, eps=EPS))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    st = res.stats
    store = solver.store
    sec = dict(clock.seconds)
    sec["selection"] = sec.pop("select_total") - sec["bitset_build"]
    calls = dict(clock.calls)
    m = store.bitset_matrix()
    say("solve", {
        "n": g.n_nodes, "m": g.n_edges, "k": K, "eps": EPS, "batch": BATCH,
        "theta": st.theta, "lb": st.lb, "lb_iters": st.lb_iters,
        "rounds": st.rounds, "n_rr": store.n_rr,
        "pool_elements": store.n_elems, "pool_capacity": store.capacity,
        "mean_rr_size": store.n_elems / store.n_rr,
        "max_in_degree": int(csr.degrees(g)[1].max()),
        "sampling_steps": st.sampling_steps,
        "overflow_fraction": st.overflow_fraction,
        "bit_matrix_shape": list(m.shape),
        "bit_matrix_bytes": m.numel() * m.element_size(),
        "setup_s": setup_s, "solve_s": solve_s, "stage_s": sec,
        "stage_calls": calls,
        "sampler_share": sec["sampling"] / solve_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "spread": res.spread, "frac": res.frac,
        "history": st.history,
    })
    for name in ("occur_from_bitset", "occur_from_bitset_masked",
                 "queue_bfs"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the exact path")
    pool = {"theta": st.theta, "n_rr": store.n_rr,
            "pool_elements": store.n_elems,
            "sampling_steps": st.sampling_steps}
    if pool != EXACT_POOL:
        raise AssertionError(f"exact pool {pool}, not {EXACT_POOL}")
    say("sampler_round", profile_round(
        make_engine("queue", csr.reverse(g), batch=BATCH), round_seed(0, 0)))
    queue_recs = [queue_record(g_rev, launches, max(
        v["max_abs_err"] for v in queue_check.values()))]
    seeds = res.seeds
    if len(set(seeds.tolist())) != K or not math.isfinite(res.spread):
        raise AssertionError(f"bad result: seeds {seeds}, spread {res.spread}")

    # 6. parity: flat selection == bitset selection on the final pool, and
    # both kernels == plain versions on the final bit matrix
    bit = store.select(K, method="bitset")
    flat = store.select(K, method="flat")
    same = (torch.equal(bit.seeds, flat.seeds)
            and torch.equal(bit.gains, flat.gains)
            and bit.frac.cpu().numpy().tobytes()
            == flat.frac.cpu().numpy().tobytes()
            and bit.seeds.cpu().numpy().tolist() == seeds.tolist())
    say("parity", {"flat_equals_bitset": same,
                   "seeds": seeds.tolist()[:10], "frac": float(flat.frac)})
    if not same:
        raise AssertionError("flat and bitset selections differ")
    args, kw = pool_args(store)
    got, want = ops.greedy_flat(*args, **kw), ref.greedy_flat_ref(*args, **kw)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError("greedy_flat != plain version on the final pool")
    u0 = int(bit.seeds[0])
    first_newly = ((m[:, u0 >> 5] >> (u0 & 31)) & 1) != 0   # the path's bool
    records = kernel_records(m, first_newly, launches=launches)

    # 7. forward Monte-Carlo check of the RIS estimate
    t0 = time.perf_counter()
    mc = forward.ic_spread(g, seeds, n_sims=MC_SIMS, seed=0)
    rel = abs(res.spread - mc) / mc
    say("forward_mc", {"ris_spread": res.spread, "mc_spread": mc,
                       "rel_err": rel, "tol": MC_TOL, "sims": MC_SIMS,
                       "seconds": time.perf_counter() - t0})
    if not rel < MC_TOL:
        raise AssertionError(f"RIS {res.spread} vs MC {mc}: {rel:.3f} >= "
                             f"{MC_TOL}")

    # 8. exact-regime identity on the phase-5 pool, no second sampling
    exact_regime_phase(store, bit)

    # 9. the dense engine's solve: must equal the phase-5 queue solve
    dense_solve_phase(g, res, store)

    # 10. the bit-packed sampler at full width, and its kernels' records
    dense_recs = packed_phase(g)

    # 11. the padded-store greedy on the phase-5 pool
    padded_recs = padded_phase(store, bit)

    # 12. flash attention at full width of three LM configs
    flash_recs = flash_phase(dev)

    # 13. the default-options exact solve: its greedy is greedy_flat
    greedy_recs = default_solve_phase(g, res, store)

    # 14. the same solve with CELF and with the θ early exit
    celf_recs, gate_launches = celf_phase(g, res, store)
    # sketch_union_popcount's record is the CELF path's; the approximate
    # sketch's (no path launches it there) stays on a line of its own
    union_approx = [r for r in approx_records
                    if r["name"] == "sketch_union_popcount"]
    say("sketch_union_popcount_approximate", union_approx)
    approx_records = [r for r in approx_records if r not in union_approx]

    # 15. the problem variants: weighted roots, candidates, the budget
    variant_recs, celf_variant_launches, weighted_spread = variants_phase(g)

    # 16. the LT model and the row-weighted estimator
    lt_recs = lt_phase(g, weighted_spread)

    # 17. the multigraph dedup, the refill engine and MRIM
    t17 = time.perf_counter()
    dedup_recs = dedup_phase(g)
    refill_recs = refill_phase(g, res, store)
    mrim_recs, mrim_launches = mrim_phase(g)
    say("phase17", {"seconds": time.perf_counter() - t17})

    # 18. the stacked selection and the serving batch executor
    stacked_recs = stacked_phase(g, store)

    # 19. durability and streaming
    durable_recs, durable_launches = durability_phase(g, res, solver)
    # sketch_scatter_or's record is the eviction rebuild's; the
    # approximate path's (no path launches it there) stays on a line of
    # its own
    scatter_approx = [r for r in approx_records
                      if r["name"] == "sketch_scatter_or"]
    say("sketch_scatter_or_approximate", scatter_approx)
    approx_records = [r for r in approx_records if r not in scatter_approx]

    # 20. the serving front: registry, cache, service, HTTP and cluster
    serving_phase(g)

    # 21. the sharded pool and its selection protocol
    sharded_recs, sharded_celf_launches = sharded_phase(g, res)
    # the kernels that several paths launch: their launches by path
    paths = {"phase 5's exact solve": launches,
             "phase 10's packed sampler": {r["name"]: r["launches"] or 0
                                           for r in dense_recs},
             "phase 14's early exit gate (16,384 buckets)": gate_launches,
             **celf_variant_launches, **mrim_launches, **durable_launches,
             "phase 21's one-rank CELF solve": sharded_celf_launches}
    kernels = records + approx_records + dense_recs + padded_recs \
        + flash_recs + queue_recs + greedy_recs + celf_recs + variant_recs \
        + lt_recs + dedup_recs + refill_recs + mrim_recs + stacked_recs \
        + durable_recs + sharded_recs
    for rec in kernels:
        if rec["name"] in SHARED_PATH_KERNELS:
            rec["launches_from"] = {path: counts.get(rec["name"], 0)
                                    for path, counts in paths.items()
                                    if counts.get(rec["name"], 0)}
            rec["launches"] = sum(rec["launches_from"].values())

    say("total", {"seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
